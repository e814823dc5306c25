"""Port parity of the fused tree round (``search_wave`` se + b) against the
JAX package's Pallas kernels in interpret mode, on the CPU; the pipeline
tick (bes) is in ``test_torch_search_wave.py``.

Both sides start from the same mid-search arena, carried
across with ``repro_torch.convert``, and take the same JAX-drawn playout
actions.  The port runs its round composition (``ops``, whose
launches take their plain versions on CPU tensors) and its reference
(``ref``).  Integer planes and select buffers must be equal; float planes
within ``torch_parity.FLOAT_TOL`` (the Pallas backup sums through a one-hot
dot, ``repro/kernels/search_wave/kernel.py:28-30``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import stages as JS  # noqa: E402
from repro.core.domains.pgame import PGameDomain as JDom  # noqa: E402
from repro.core.tree import init_tree as j_init_tree  # noqa: E402
from repro.kernels.search_wave import ops as jops  # noqa: E402
from repro_torch.core import stages as TS  # noqa: E402
from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.kernels.search_wave import ops as tops  # noqa: E402
from repro_torch.kernels.search_wave import ref as tref  # noqa: E402
from torch_parity import (assert_arena_equal, assert_buf_equal,  # noqa: E402
                          jax_draws, to_port)

A, D, NODES = 4, 6, 64
JDOM = JDom(num_actions=A, game_depth=D, binary_reward=False, seed=3)
TDOM = PGameDomain(num_actions=A, game_depth=D, binary_reward=False, seed=3)
# lanes 1 / 4 / 8 x vl_mode x level_assign; at one lane the running delta
# is identically zero, so (1, "wu", "running") would repeat (1, "wu", ...)
GRID = ([(lanes, "loss", "independent") for lanes in (1, 4, 8)]
        + [(lanes, "wu", "running") for lanes in (4, 8)]
        + [(1, "wu", "independent"), (4, "loss", "running"),
           (4, "wu", "independent")])
SEL = ("path", "leaf", "depth", "valid", "dup", "dup_within", "dup_cross")


def _params(vl_mode, level_assign):
    kw = dict(cp=0.7, max_depth=D, vl_mode=vl_mode,
              level_assign=level_assign, wave_select="mega")
    return JS.SearchParams(kernels="ref", **kw), \
        TS.SearchParams(kernels="ref", **kw)


def _clone(tree):
    return dataclasses.replace(
        tree, **{f.name: ({k: v.clone() for k, v in tree.state.items()}
                          if f.name == "state" else
                          getattr(tree, f.name).clone())
                 for f in dataclasses.fields(tree)})


@pytest.mark.parametrize("lanes,vl_mode,level_assign", GRID)
def test_tree_round_matches_pallas(lanes, vl_mode, level_assign):
    jsp, tsp = _params(vl_mode, level_assign)
    rnd = jax.jit(lambda t, r: jops.tree_round(
        t, JDOM, jsp, lanes, jnp.asarray(True), r, impl="pallas",
        interpret=True))
    warm, rounds = 2, 4
    rngs = jax.random.split(jax.random.key(10 + lanes), warm + rounds)
    jt = j_init_tree(JDOM, NODES)
    for t in range(warm):
        jt, _ = rnd(jt, rngs[t])
    tts = [to_port(jt), to_port(jt)]
    for t in range(warm, warm + rounds):
        draws = jax_draws(rngs[t], (lanes,), D, A)[None]
        jt, jsel = rnd(jt, rngs[t])
        for i, fn in enumerate((tops.tree_round, tref.tree_round)):
            tts[i], tsel = fn(tts[i], TDOM, tsp, lanes, True, draws)
            assert_arena_equal(jt, tts[i], msg=f"round {t} #{i} ")
            assert_buf_equal(jsel, tsel, SEL, msg=f"round {t} ")


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_tree_round_pops_free_list_then_fills_the_arena(vl_mode):
    """Rows come off the free list (LIFO) before the ``next_free`` bump,
    and the trailing lanes stop expanding once the arena is full."""
    jsp, tsp = _params(vl_mode, "running")
    lanes, nodes = 4, 24
    rnd = jax.jit(lambda t, r: jops.tree_round(
        t, JDOM, jsp, lanes, jnp.asarray(True), r, impl="pallas",
        interpret=True))
    rngs = jax.random.split(jax.random.key(7), 7)
    jt = j_init_tree(JDOM, nodes)
    for t in range(2):
        jt, _ = rnd(jt, rngs[t])
    nf = int(jt.next_free)
    # park three never-used rows on the free list, past the bump mark
    jt = jt.replace(
        free_list=jt.free_list.at[:3].set(
            jnp.asarray([nf + 2, nf, nf + 1], jnp.int32)),
        free_top=jnp.int32(3), next_free=jnp.int32(nf + 3))
    tts = [to_port(jt), to_port(jt)]
    for t in range(2, 7):
        draws = jax_draws(rngs[t], (lanes,), D, A)[None]
        jt, jsel = rnd(jt, rngs[t])
        for i, fn in enumerate((tops.tree_round, tref.tree_round)):
            tts[i], tsel = fn(tts[i], TDOM, tsp, lanes, True, draws)
            assert_arena_equal(jt, tts[i], msg=f"round {t} #{i} ")
            assert_buf_equal(jsel, tsel, SEL, msg=f"round {t} ")
    assert int(jt.free_top) == 0 and int(jt.next_free) == nodes


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_apply_es_completes_the_structural_expand(vl_mode):
    """``_apply_es`` (the kernel path's out-of-launch half) turns a tree
    whose children / in-flight planes the launch already wrote into the
    plain ``expand_wave_struct`` result."""
    _, tsp = _params(vl_mode, "independent")
    tree = to_port(j_init_tree(JDOM, NODES))
    for t in range(3):
        tree, _ = tref.tree_round(tree, TDOM, tsp, 4, True,
                                  TDOM.sample_draws(
                                      (1, 4), torch.Generator()
                                      .manual_seed(t)))
    tree, sel = TS.select_wave_fused(tree, tsp, 4, True)
    want, es = tref.expand_wave_struct(_clone(tree), tsp, sel)
    got = _clone(tree).replace(children=want.children.clone(),
                               vloss=want.vloss.clone(),
                               unobs=want.unobs.clone())
    got, es2 = tops._apply_es(got, sel["path"], sel["depth"], sel["leaf"],
                              es["can"].int(), es["slot"], es["new"],
                              sel["valid"])
    for f in ("parent", "action", "next_free", "free_top", "children"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for k in ("path", "node", "new", "can", "slot"):
        assert torch.equal(es2[k], es[k]), k


def test_wrappers_take_the_plain_version_on_cpu():
    """``se`` / ``bes`` / ``b`` on CPU tensors run their plain versions and
    launch nothing; ``impl="cuda"`` with CPU tensors raises."""
    _, tsp = _params("loss", "independent")
    before = dict(tops.launches)
    tree = to_port(j_init_tree(JDOM, NODES))
    tree, sel, es = tops.se(tree, tsp, 4, True)
    assert bool(es["can"].any()) and tops.launches == before
    with pytest.raises(ValueError):
        tops.se(tree, tsp, 4, True, impl="cuda")
    with pytest.raises(ValueError):
        tops.b(tree, tsp, TS.empty_playout(tsp, 1, 4, A, "cpu"),
               impl="cuda")
    assert np.array_equal(tree.vloss[0, 0].numpy(), np.int32(4))
