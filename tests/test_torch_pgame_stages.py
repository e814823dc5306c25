"""Port parity: ``repro_torch.core.domains.pgame`` and ``core.stages``
against the JAX package on the CPU.

P-game states are compared exactly, including hashes near 2^32 where a
plain int64 ``h * MIX`` would overflow.  The stages start from the same
mid-search tree (carried across with ``repro_torch.convert``) and must
leave equal trees and buffers; playout randomness is drawn by JAX along
its own key splits and handed to the port as action tensors.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import stages as JS  # noqa: E402
from repro.core.domains import pgame as jpg  # noqa: E402
from repro.search import SearchConfig as JCfg  # noqa: E402
from repro.search import search as jsearch  # noqa: E402
from repro_torch.core import stages as TS  # noqa: E402
from repro_torch.core.tree import init_tree  # noqa: E402
from repro_torch.core.domains import pgame as tpg  # noqa: E402
from torch_parity import (assert_arena_equal, assert_buf_equal,  # noqa: E402
                          buf_to_port, jax_draws, to_port)

A, D = 4, 6
JDOM = jpg.PGameDomain(num_actions=A, game_depth=D, binary_reward=False,
                       seed=3)
TDOM = tpg.PGameDomain(num_actions=A, game_depth=D, binary_reward=False,
                       seed=3)


# ---------------------------------------------------------------------------
# P-game domain
# ---------------------------------------------------------------------------
def _states(seed, k):
    rng = np.random.default_rng(seed)
    h = np.concatenate([
        np.uint32(0xFFFFFFFF) - rng.integers(0, 64, k // 2).astype(np.uint32),
        rng.integers(0, 2 ** 32, k - k // 2, dtype=np.uint64)
        .astype(np.uint32)])
    depth = rng.integers(0, D + 1, k).astype(np.int32)
    accum = rng.random(k).astype(np.float32)
    return h, depth, accum


def _tstate(h, depth, accum):
    return {"hash": torch.from_numpy(h.astype(np.int64)),
            "depth": torch.from_numpy(depth),
            "accum": torch.from_numpy(accum)}


def test_hash_and_edge_value_near_2_pow_32():
    h, _, _ = _states(0, 64)
    a = np.random.default_rng(1).integers(0, A, 64).astype(np.int32)
    jh = jpg._hash_step(jnp.asarray(h), jnp.asarray(a))
    th = tpg._hash_step(torch.from_numpy(h.astype(np.int64)),
                        torch.from_numpy(a))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    np.testing.assert_array_equal(
        tpg._edge_value(torch.from_numpy(h.astype(np.int64))).numpy(),
        np.asarray(jpg._edge_value(jnp.asarray(h))))
    assert int(th.max()) < 2 ** 32 and int(th.min()) >= 0


def test_step_and_terminal_match():
    h, depth, accum = _states(2, 32)
    a = np.random.default_rng(3).integers(0, A, 32).astype(np.int32)
    js = JDOM.step({"hash": jnp.asarray(h), "depth": jnp.asarray(depth),
                    "accum": jnp.asarray(accum)}, jnp.asarray(a))
    ts = TDOM.step(_tstate(h, depth, accum), torch.from_numpy(a))
    np.testing.assert_array_equal(ts["hash"].numpy(),
                                  np.asarray(js["hash"]).astype(np.int64))
    np.testing.assert_array_equal(ts["depth"].numpy(), np.asarray(js["depth"]))
    np.testing.assert_array_equal(ts["accum"].numpy(), np.asarray(js["accum"]))
    np.testing.assert_array_equal(TDOM.is_terminal(ts).numpy(),
                                  np.asarray(JDOM.is_terminal(js)))


@pytest.mark.parametrize("binary", [True, False])
def test_playout_with_jax_draws(binary):
    jd = jpg.PGameDomain(num_actions=A, game_depth=D, binary_reward=binary)
    td = tpg.PGameDomain(num_actions=A, game_depth=D, binary_reward=binary)
    h, depth, accum = _states(4, 16)
    keys = jax.random.split(jax.random.key(5), 16)
    jv = jax.jit(jax.vmap(jd.playout))({"hash": jnp.asarray(h),
                               "depth": jnp.asarray(depth),
                               "accum": jnp.asarray(accum)}, keys)
    draws = jax_draws(jax.random.key(5), (16,), D, A)
    tv = td.playout(_tstate(h, depth, accum), draws)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_root_values_copy():
    for seed in (0, 7):
        jd = jpg.PGameDomain(num_actions=3, game_depth=5, seed=seed)
        td = tpg.PGameDomain(num_actions=3, game_depth=5, seed=seed)
        np.testing.assert_array_equal(tpg.enumerate_root_values(td),
                                      jpg.enumerate_root_values(jd))
        assert tpg.optimal_root_action(td) == jpg.optimal_root_action(jd)


# ---------------------------------------------------------------------------
# stages, from one mid-search tree
# ---------------------------------------------------------------------------
def _params(**kw):
    base = dict(cp=0.7, max_depth=D)
    base.update(kw)
    return (JS.SearchParams(kernels="ref", **base),
            TS.SearchParams(kernels="ref", **base))


@functools.lru_cache(maxsize=None)
def _mid_tree(vl_mode, lanes=4):
    """A JAX tree mid-search with one wave selected and not yet backed up,
    so its in-flight counts are non-zero."""
    sp, _ = _params(vl_mode=vl_mode, wave_select="lockstep")
    cfg = JCfg(method="tree", budget=20, lanes=lanes, params=sp,
               max_nodes=48)
    tree = jsearch(JDOM, cfg, jax.random.key(11)).tree
    tree, _ = JS.select_wave(tree, sp, lanes, jnp.asarray(True))
    return tree


SEL = ("path", "leaf", "depth", "valid", "dup")


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_select_one_and_expand_one(vl_mode):
    jsp, tsp = _params(vl_mode=vl_mode)
    jt = _mid_tree(vl_mode)
    tt = to_port(jt)
    jt, jsel = jax.jit(lambda t: JS.select_one(t, jsp, jnp.asarray(True)))(jt)
    tt, tsel = TS.select_one(tt, tsp, True)
    assert_arena_equal(jt, tt, msg="select_one ")
    assert_buf_equal({k: v[None] for k, v in jsel.items()},
                     {k: v[:, None] for k, v in tsel.items()}, SEL)
    jt, jexp = jax.jit(lambda t, s: JS.expand_one(t, JDOM, jsp, s))(jt, jsel)
    tt, texp = TS.expand_one(tt, TDOM, tsp, tsel)
    assert_arena_equal(jt, tt, msg="expand_one ")
    for k in ("path", "node", "is_new", "valid"):
        np.testing.assert_array_equal(texp[k][0].numpy(),
                                      np.asarray(jexp[k]), err_msg=k)


@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("mode", ["scan", "lockstep/independent",
                                  "lockstep/running"])
@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_select_expand_playout_backup_wave(vl_mode, mode, lanes):
    ws, _, la = mode.partition("/")
    jsp, tsp = _params(vl_mode=vl_mode, wave_select=ws,
                       level_assign=la or "independent")
    jt = _mid_tree(vl_mode)
    tt = to_port(jt)
    rng = jax.random.key(lanes)

    def jwave(t, r):
        t, sel = JS.select_wave(t, jsp, lanes, jnp.asarray(True))
        t, exp = JS.expand_wave(t, JDOM, jsp, sel)
        po = JS.playout_wave(JDOM, jsp, exp, r)
        return JS.backup_wave(t, po, jsp), sel, exp, po

    jt, jsel, jexp, jpo = jax.jit(jwave)(jt, rng)
    tt, tsel = TS.select_wave(tt, tsp, lanes, True)
    assert_buf_equal(jsel, tsel, SEL + ("dup_within", "dup_cross"))
    tt, texp = TS.expand_wave(tt, TDOM, tsp, tsel)
    assert_buf_equal(jexp, texp, ("path", "node", "is_new", "valid"))
    assert_buf_equal(jexp["state"], texp["state"], ("depth", "accum"))
    tpo = TS.playout_wave(TDOM, tsp, texp,
                          jax_draws(rng, (lanes,), D, A)[None])
    assert_buf_equal(jpo, tpo, ("value", "priors", "node", "is_new"))
    tt = TS.backup_wave(tt, tpo, tsp)
    assert_arena_equal(jt, tt)


def test_empty_buffers_and_params():
    jsp, tsp = _params()
    for jb, tb in ((JS.empty_selection(jsp, 3),
                    TS.empty_selection(tsp, 1, 3, "cpu")),
                   (JS.empty_playout(jsp, 3, A),
                    TS.empty_playout(tsp, 1, 3, A, "cpu"))):
        assert set(jb) == set(tb)
        assert_buf_equal(jb, tb, list(jb))
    je, te = JS.empty_expansion(jsp, 3, JDOM), \
        TS.empty_expansion(tsp, init_tree(TDOM, 8), 3)
    assert_buf_equal(je["state"], te["state"], list(je["state"]))
    assert tsp.path_len == jsp.path_len
    tree = TS.with_infl(to_port(_mid_tree("wu")),
                        TS.SearchParams(vl_mode="wu"),
                        torch.zeros((1, 48), dtype=torch.int32))
    assert int(TS.infl_plane(tree, TS.SearchParams(vl_mode="wu")).sum()) == 0
    assert int(TS.infl_plane(tree, TS.SearchParams()).sum()) == 0
    with pytest.raises(ValueError):
        TS.SearchParams(kernels="pallas")
    assert TS.SearchParams().resolved_kernels("cpu") == "ref"
    assert TS.SearchParams().resolved_wave_select("cpu") == "scan"
    with pytest.raises(ValueError):
        TS.SearchParams(kernels="cuda").resolved_kernels("cpu")


def test_buffers_cross_over():
    """A JAX selection buffer carried into the port expands identically."""
    jsp, tsp = _params(wave_select="lockstep")
    jt = _mid_tree("loss")
    jt2, jsel = JS.select_wave(jt, jsp, 4, jnp.asarray(True))
    tt = to_port(jt2)
    jt2, jexp = jax.jit(lambda t, s: JS.expand_wave(t, JDOM, jsp, s))(
        jt2, jsel)
    tt, texp = TS.expand_wave(tt, TDOM, tsp, buf_to_port(jsel))
    assert_arena_equal(jt2, tt)
    assert_buf_equal(jexp, texp, ("path", "node", "is_new"))
