"""Port parity: ``repro_torch.core.arena`` / ``core.tree`` / ``core.uct`` and
the ``uct_select`` plain version of ``uct_argmax`` against the JAX package
on the CPU (the running variant is in ``test_torch_uct_running.py``).

The UCT boards are those of ``tests/test_kernels.py`` (duplicated parents,
ragged and all-invalid rows, sentinel ties, both vl modes), made with numpy
from a seed; the JAX side runs both its reference (``use_ref``) and its
Pallas kernel in interpret mode.  Decisions must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import arena as JA  # noqa: E402
from repro.core import tree as JT  # noqa: E402
from repro.core.domains.pgame import PGameDomain as JDom  # noqa: E402
from repro.kernels.uct_select import ops as juo  # noqa: E402
from repro.search import SearchConfig as JCfg  # noqa: E402
from repro.search import SearchParams as JParams  # noqa: E402
from repro.search import search as jsearch  # noqa: E402
from repro_torch.convert import arena_from_numpy, arena_to_numpy  # noqa: E402
from repro_torch.core import arena as TA  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.kernels.uct_select import ops as tuo  # noqa: E402
from torch_parity import assert_arena_equal, jax_arena_np, to_port  # noqa: E402


def _mid_search_tree(vl_mode="loss"):
    cfg = JCfg(method="tree", budget=24, lanes=4,
               params=JParams(cp=0.7, max_depth=5, kernels="ref",
                              wave_select="lockstep", vl_mode=vl_mode))
    return jsearch(JDom(num_actions=3, game_depth=5), cfg,
                   jax.random.key(2)).tree


# ---------------------------------------------------------------------------
# arena
# ---------------------------------------------------------------------------
def test_init_arena_matches():
    ja = JA.init_arena({"v": jnp.int32(7)}, 3, 8)
    ta = TA.init_arena({"v": torch.tensor([7], dtype=torch.int32)}, 3, 8)
    assert_arena_equal(ja, ta)
    assert (ta.batch, ta.max_nodes, ta.num_actions) == (1, 8, 3)
    np.testing.assert_array_equal(TA.live_mask(ta)[0].numpy(),
                                  np.asarray(JA.live_mask(ja)))


@pytest.mark.parametrize("released", [0, 2, 3])
def test_alloc_sequence_matches(released):
    """Free-list LIFO pops first, then the next_free bump, then failure
    with the ``max_nodes`` sentinel — row for row against JAX."""
    ja = JA.init_arena({"v": jnp.int32(0)}, 2, 6)
    for _ in range(4):
        ja, row, _ = JA.alloc(ja)
        ja = ja.replace(parent=ja.parent.at[row].set(0))
    ja = JA.release(ja, jnp.asarray([1, 3, 2], jnp.int32)[:released],
                    True) if released else ja
    ta = to_port(ja)
    for i in range(6):
        take = i != 1
        ja, jrow, jok = JA.alloc(ja, take)
        ta, trow, tok = TA.alloc(ta, take)
        assert int(trow[0]) == int(jrow) and bool(tok[0]) == bool(jok)
        assert_arena_equal(ja, ta, msg=f"alloc {i}: ")
        assert int(TA.capacity_left(ta)[0]) == int(JA.capacity_left(ja))
        assert bool(TA.can_alloc(ta)[0]) == bool(JA.can_alloc(ja))


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_arena_stats_and_tree_helpers_match(vl_mode):
    jt = _mid_search_tree(vl_mode)
    tt = to_port(jt)
    for k, v in JA.arena_stats(jt).items():
        assert int(TA.arena_stats(tt)[k][0]) == int(v), k
    jn, jw, jv = JT.root_child_stats(jt)
    tn, tw, tv = TT.root_child_stats(tt)
    np.testing.assert_array_equal(tn[0].numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tw[0].numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    for k, v in JT.check_consistency(jt).items():
        assert int(TT.check_consistency(tt)[k][0]) == int(v), k
    nodes = np.asarray([0, 1, 2, 5], np.int32)
    js = JT.get_state(jt, jnp.asarray(nodes))
    ts = TT.get_state(tt, torch.from_numpy(nodes)[None])
    for k in js:
        np.testing.assert_array_equal(
            ts[k][0].numpy().astype(np.asarray(js[k]).dtype),
            np.asarray(js[k]))


def test_init_tree_matches():
    jd, td = JDom(num_actions=3, game_depth=4, seed=9), \
        PGameDomain(num_actions=3, game_depth=4, seed=9)
    assert_arena_equal(JT.init_tree(jd, 10), TT.init_tree(td, 10))
    tb = TT.init_tree(td, 10, batch=3)
    assert tb.batch == 3 and bool((tb.state["hash"][:, 0]
                                   == tb.state["hash"][0, 0]).all())


def test_convert_round_trip():
    jt = _mid_search_tree("wu")
    planes = jax_arena_np(jt)
    back = arena_to_numpy(arena_from_numpy(planes), batched=False)
    for k, v in planes.items():
        if k == "state":
            for s, x in v.items():
                assert back["state"][s].dtype == x.dtype
                np.testing.assert_array_equal(back["state"][s], x)
        else:
            np.testing.assert_array_equal(back[k], v)


# ---------------------------------------------------------------------------
# uct_select: plain versions vs JAX ref and Pallas (interpret)
# ---------------------------------------------------------------------------
def _both_jax(fn, *args, **kw):
    a1 = np.asarray(fn(*args, use_ref=True, **kw))
    a2 = np.asarray(fn(*args, interpret=True, **kw))
    np.testing.assert_array_equal(a1, a2)
    return a1


def _port_argmax(n, w, vl, pn, **kw):
    t = lambda x: torch.from_numpy(np.asarray(x))
    kw = {k: (t(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return tuo.uct_argmax(t(n), t(w), t(vl), t(pn), **kw).numpy()


def _board(seed, r, a, parents=None, p_valid=0.8):
    rng = np.random.default_rng(seed)
    rows = np.arange(r) % parents if parents else np.arange(r)
    g = parents or r
    n = rng.integers(0, 50, (g, a)).astype(np.float32)[rows]
    w = (rng.normal(size=(g, a)) * 3).astype(np.float32)[rows]
    vl = rng.integers(0, 3, (r, a)).astype(np.float32)
    o = rng.integers(0, 5, (r, a)).astype(np.float32)
    valid = rng.random((r, a)) < p_valid
    valid[:, 0] = True
    return n, w, vl, o, valid


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
@pytest.mark.parametrize("r,a,parents", [(7, 4, None), (300, 8, None),
                                         (64, 130, None), (1, 2, None),
                                         (12, 4, 3), (32, 130, 3)])
def test_uct_argmax_boards(r, a, parents, vl_mode):
    n, w, vl, o, valid = _board(r * 31 + a, r, a, parents)
    pn = n.sum(-1) + 1 + (o.sum(-1) if vl_mode == "wu" else 0)
    kw = dict(cp=1.4, valid=valid, child_o=o, vl_mode=vl_mode)
    want = _both_jax(juo.uct_argmax, jnp.asarray(n), jnp.asarray(w),
                     jnp.asarray(vl), jnp.asarray(pn),
                     **{**kw, "valid": jnp.asarray(valid),
                        "child_o": jnp.asarray(o)})
    np.testing.assert_array_equal(_port_argmax(n, w, vl, pn, **kw), want)


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_uct_argmax_finished_and_all_invalid_rows(vl_mode):
    n, w, vl, o, _ = _board(14, 8, 4)
    pn = n.sum(-1) + 1
    for valid in (np.broadcast_to(np.arange(8)[:, None] < 4, (8, 4)).copy(),
                  np.zeros((8, 4), bool)):
        kw = dict(cp=1.4, valid=valid, child_o=o, vl_mode=vl_mode)
        want = _both_jax(juo.uct_argmax, jnp.asarray(n), jnp.asarray(w),
                         jnp.asarray(vl), jnp.asarray(pn),
                         **{**kw, "valid": jnp.asarray(valid),
                            "child_o": jnp.asarray(o)})
        got = _port_argmax(n, w, vl, pn, **kw)
        np.testing.assert_array_equal(got, want)
        assert (got[~valid.any(-1)] == 0).all()


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
@pytest.mark.parametrize("r,a", [(8, 4), (64, 130)])
def test_uct_argmax_sentinel_ties_first_max(vl_mode, r, a):
    rng = np.random.default_rng(15)
    n = rng.integers(0, 9, (r, a)).astype(np.float32)
    cols = np.argsort(rng.random((r, a)), axis=1)[:, :2]
    n[np.arange(r)[:, None], cols] = 0.0
    w = rng.normal(size=(r, a)).astype(np.float32)
    z = np.zeros((r, a), np.float32)
    pn = n.sum(-1) + 1
    valid = np.ones((r, a), bool)
    kw = dict(cp=1.4, valid=valid, child_o=z, vl_mode=vl_mode)
    want = _both_jax(juo.uct_argmax, jnp.asarray(n), jnp.asarray(w),
                     jnp.asarray(z), jnp.asarray(pn),
                     **{**kw, "valid": jnp.asarray(valid),
                        "child_o": jnp.asarray(z)})
    got = _port_argmax(n, w, z, pn, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argmax(n == 0.0, axis=-1))


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
@pytest.mark.parametrize("r,a,parents", [(7, 4, None), (64, 130, None),
                                         (12, 4, 3)])
def test_uct_argmax_int32_count_planes(r, a, parents, vl_mode):
    """The arena's dtypes: N, the in-flight planes and n_p int32 (the
    plain version converts them as the kernel does), ``child_o`` the same
    plane as ``child_vl`` as the select path passes it, and rows of
    sentinel ties; decisions equal the JAX reference's and its Pallas
    kernel's on the same int32 planes."""
    n, w, vl, o, valid = _board(r * 17 + a, r, a, parents)
    n, vl = n.astype(np.int32), vl.astype(np.int32)
    n[::3], vl[::3] = 0, 0
    pn = (n.sum(-1) + 1 + vl.sum(-1)).astype(np.int32)
    kw = dict(cp=1.4, valid=valid, child_o=vl, vl_mode=vl_mode)
    want = _both_jax(juo.uct_argmax, jnp.asarray(n), jnp.asarray(w),
                     jnp.asarray(vl), jnp.asarray(pn),
                     **{**kw, "valid": jnp.asarray(valid),
                        "child_o": jnp.asarray(vl)})
    np.testing.assert_array_equal(_port_argmax(n, w, vl, pn, **kw), want)
