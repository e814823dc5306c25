"""Port parity of the fused pipeline tick (``search_wave`` bes) against the
JAX package's Pallas kernel in interpret mode (as ``tests/test_arena.py``
runs it), on the CPU; the tree round (se + b) is in
``test_torch_search_round.py``.

Both sides start from the same mid-search arena and stage buffers, carried
across with ``repro_torch.convert``, and take the same JAX-drawn playout
actions.  The port runs its round / tick compositions (``ops``, whose
launches take their plain versions on CPU tensors) and its reference
(``ref``).  Integer planes and select buffers must be equal; float planes
within ``torch_parity.FLOAT_TOL`` (the Pallas backup sums through a one-hot
dot, ``repro/kernels/search_wave/kernel.py:28-30``).
"""
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
                          buf_to_port, jax_draws, to_port)

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


@pytest.mark.parametrize("lanes,vl_mode,level_assign", GRID)
def test_pipeline_tick_matches_pallas(lanes, vl_mode, level_assign):
    jsp, tsp = _params(vl_mode, level_assign)
    tick = jax.jit(lambda t, wv, se, ep, pb, r: jops.pipeline_tick(
        t, JDOM, jsp, lanes, wv, se, ep, pb, r, impl="pallas",
        interpret=True))
    warm, ticks = 3, 7
    rngs = jax.random.split(jax.random.key(lanes), warm + ticks)
    carry = (j_init_tree(JDOM, NODES), JS.empty_selection(jsp, lanes),
             JS.empty_expansion(jsp, lanes, JDOM),
             JS.empty_playout(jsp, lanes, A))
    for t in range(warm):
        carry = tick(*carry[:1], jnp.asarray(True), *carry[1:], rngs[t])
    # carry the mid-search arena and the three in-flight buffers across
    ports = [(to_port(carry[0]),) + tuple(buf_to_port(b) for b in carry[1:])
             for _ in range(2)]
    for t in range(warm, warm + ticks):
        wv = t < warm + ticks - 3
        draws = jax_draws(rngs[t], (lanes,), D, A)[None]
        carry = tick(*carry[:1], jnp.asarray(wv), *carry[1:], rngs[t])
        for i, fn in enumerate((tops.pipeline_tick, tref.pipeline_tick)):
            ports[i] = fn(ports[i][0], TDOM, tsp, lanes, wv, *ports[i][1:],
                          draws)
            assert_arena_equal(carry[0], ports[i][0], msg=f"tick {t} #{i} ")
            assert_buf_equal(carry[1], ports[i][1], SEL, msg=f"tick {t} ")
            assert_buf_equal(carry[3], ports[i][3],
                             ("path", "node", "is_new", "valid", "value"))
