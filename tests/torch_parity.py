"""Shared helpers of the ``test_torch_*`` parity tests: JAX-drawn playout
randomness, JAX <-> port arena comparison, all through numpy, and the JAX
families' initial weights made once per process."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core.domains.pgame import PGameDomain as JDom
from repro.search import SearchConfig as JCfg
from repro.search import SearchParams as JParams
from repro.search import search as jsearch
from repro_torch.convert import arena_from_numpy
from repro_torch.core.domains.pgame import PGameDomain
from repro_torch.search import SearchConfig, SearchParams, draws_shape, \
    search

INT_PLANES = ("visits", "vloss", "unobs", "parent", "action", "children",
              "terminal", "next_free", "free_list", "free_top")
# Float planes: the fused search-wave Pallas kernel sums a node's same-wave
# contributions through a one-hot dot and may differ from the sequential
# scatter-add in the last ulp (repro/kernels/search_wave/kernel.py:28-30);
# the port adds in the scatter-add's order.  A few ulps of a sum of at most
# `lanes` rewards in [0, 1] bound the difference.
FLOAT_TOL = dict(rtol=1e-6, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_init(cfg, seed: int):
    from repro.models.base import get_family
    jp = jax.jit(get_family(cfg).init, static_argnums=0)(
        cfg, jax.random.key(seed))
    return jax.tree_util.tree_map(np.asarray, jp)


def jax_init(cfg, seed: int = 0):
    """The JAX family's ``init(cfg, jax.random.key(seed))``, jitted (one
    compile, where the eager call dispatches every op), as numpy leaves,
    made once per process for each config and seed.  The tree is shared:
    callers convert it (``jnp.asarray``, ``params_from_numpy``) and never
    write to it."""
    return _jax_init(cfg, seed)


def jax_draws(rng, dims, game_depth: int, num_actions: int) -> torch.Tensor:
    """The P-game playout actions JAX draws along a nested key-split tree:
    ``split(rng, dims[0])``, then each key ``split(., dims[1])``, ...; each
    leaf key plays ``game_depth`` steps of ``split`` + ``randint``
    (``repro/core/domains/pgame.py:53-56``)."""
    def nested(k, ds):
        if not ds:
            return k
        return jax.vmap(lambda kk: nested(kk, ds[1:]))(
            jax.random.split(k, ds[0]))

    def one(r):
        out = []
        for _ in range(game_depth):
            r, sub = jax.random.split(r)
            out.append(jax.random.randint(sub, (), 0, num_actions))
        return jnp.stack(out)

    keys = nested(rng, tuple(dims)).reshape(-1)
    draws = np.array(jax.vmap(one)(keys)).reshape(tuple(dims) + (game_depth,))
    return torch.from_numpy(draws.astype(np.int32))


def jax_arena_np(tree) -> dict:
    """A JAX ``TreeArena``'s leaves as numpy (state dict included)."""
    out = {f.name: np.asarray(getattr(tree, f.name))
           for f in dataclasses.fields(tree) if f.name != "state"}
    out["state"] = {k: np.asarray(v) for k, v in tree.state.items()}
    return out


def to_port(tree):
    """The port's arena (batch of one, or the JAX batch) of a JAX arena."""
    return arena_from_numpy(jax_arena_np(tree))


def assert_arena_equal(jtree, ttree, *, b=None, msg=""):
    """JAX arena == port arena: integer planes and state exactly, float
    planes within FLOAT_TOL.  ``b`` picks one root of a batched port
    arena; by default the JAX arena's batch layout is matched."""
    pick = (lambda t: t[b]) if b is not None else (
        (lambda t: t[0]) if np.asarray(jtree.children).ndim == 2
        else (lambda t: t))
    for f in INT_PLANES:
        np.testing.assert_array_equal(
            pick(getattr(ttree, f)).cpu().numpy(),
            np.asarray(getattr(jtree, f)), err_msg=f"{msg}{f}")
    for k, v in jtree.state.items():
        want = np.asarray(v)
        got = pick(ttree.state[k]).cpu().numpy()
        if k == "accum":
            np.testing.assert_allclose(got, want, err_msg=f"{msg}{k}",
                                       **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got.astype(want.dtype), want,
                                          err_msg=f"{msg}state {k}")
    for f in ("value", "prior"):
        np.testing.assert_allclose(pick(getattr(ttree, f)).cpu().numpy(),
                                   np.asarray(getattr(jtree, f)),
                                   err_msg=f"{msg}{f}", **FLOAT_TOL)


def assert_buf_equal(jbuf, tbuf, keys, *, msg=""):
    """Stage buffers (selection / expansion / playout dicts) equal; the port
    buffer carries a batch axis of one."""
    for k in keys:
        want = np.asarray(jbuf[k])
        got = tbuf[k][0].cpu().numpy()
        if want.dtype == np.float32:
            np.testing.assert_allclose(got, want, err_msg=f"{msg}{k}",
                                       **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got.astype(want.dtype), want,
                                          err_msg=f"{msg}{k}")


def buf_to_port(jbuf) -> dict:
    """A JAX stage buffer as a port buffer with a batch axis of one."""
    out = {}
    for k, v in jbuf.items():
        if isinstance(v, dict):
            out[k] = buf_to_port(v)
            continue
        x = np.asarray(v)
        if x.dtype == np.uint32:
            x = x.astype(np.int64)
        out[k] = torch.from_numpy(np.array(x))[None]
    return out


def assert_search_equal(jres, tres, *, b=None, msg=""):
    """A JAX ``SearchResult`` equals the port's: visits, best action, stats
    and the dup extras exactly; values within FLOAT_TOL; trees as
    ``assert_arena_equal``.  ``b`` picks one root of a batched result."""
    pick = (lambda t: t) if b is None else (lambda t: t[b])
    np.testing.assert_array_equal(pick(tres.action_visits).cpu().numpy(),
                                  np.asarray(jres.action_visits),
                                  err_msg=f"{msg}action_visits")
    assert int(pick(tres.best_action)) == int(jres.best_action), msg
    np.testing.assert_allclose(pick(tres.action_value).cpu().numpy(),
                               np.asarray(jres.action_value),
                               err_msg=f"{msg}action_value", **FLOAT_TOL)
    assert set(tres.stats) == set(jres.stats)
    for k, v in jres.stats.items():
        assert int(pick(tres.stats[k])) == int(v), f"{msg}stats {k}"
    assert set(tres.extras) == set(jres.extras), msg
    for k, v in jres.extras.items():
        got = pick(tres.extras[k]).cpu().numpy()
        if np.asarray(v).dtype.kind == "f":
            np.testing.assert_allclose(got, np.asarray(v), err_msg=k,
                                       **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
    assert (jres.tree is None) == (tres.tree is None)
    if jres.tree is not None:
        assert_arena_equal(jres.tree, tres.tree, b=0 if b is None else b,
                           msg=msg)


def search_grid(wave_selects):
    """(wave_select, vl_mode, level_assign, lanes) cells of the strategy
    grids: level_assign is a documented no-op for "scan", and the running
    delta is identically zero at one lane, so those cells run once."""
    cells = [(ws, vl, "independent", lanes) for ws in wave_selects
             for vl in ("loss", "wu") for lanes in (1, 4)]
    cells += [(ws, vl, "running", 4) for ws in wave_selects if ws != "scan"
              for vl in ("loss", "wu")]
    if "mega" in wave_selects:
        cells.append(("mega", "wu", "running", 1))
    return cells


def redundant_grid_cells():
    """The cells ``search_grid`` leaves out because they repeat another
    cell by construction (running at one lane or under "scan")."""
    full = [(ws, vl, la, lanes) for ws in ("scan", "lockstep", "mega")
            for vl in ("loss", "wu") for la in ("independent", "running")
            for lanes in (1, 4)]
    kept = set(search_grid(("scan", "lockstep", "mega")))
    return [c for c in full if c not in kept]


SEARCH_A, SEARCH_D = 4, 6


def search_domains(binary=True):
    """The (JAX, port) P-game pair of the strategy parity tests."""
    kw = dict(num_actions=SEARCH_A, game_depth=SEARCH_D,
              binary_reward=binary)
    return JDom(**kw), PGameDomain(**kw)


def search_configs(method, lanes, budget, **kw):
    """The (JAX, port) ``SearchConfig`` pair, both on the plain path."""
    kw = dict(cp=0.7, max_depth=SEARCH_D, **kw)
    return (JCfg(method=method, budget=budget, lanes=lanes,
                 params=JParams(kernels="ref", **kw)),
            SearchConfig(method=method, budget=budget, lanes=lanes,
                         params=SearchParams(kernels="ref", **kw)))


def port_search(method, lanes, budget=64, seed=0, binary=True, **kw):
    """The port's search on the CPU under the draws JAX makes from
    ``jax.random.key(seed)``."""
    _, td = search_domains(binary)
    _, tc = search_configs(method, lanes, budget, **kw)
    draws = jax_draws(jax.random.key(seed), draws_shape(td, tc)[:-1],
                      SEARCH_D, SEARCH_A)
    return search(td, tc, draws, device="cpu")


def run_pair(method, lanes, budget=64, seed=0, binary=True, **kw):
    """One JAX search and its port on the CPU under the same JAX draws."""
    jd, _ = search_domains(binary)
    jc, _ = search_configs(method, lanes, budget, **kw)
    jres = jsearch(jd, jc, jax.random.key(seed))
    return jres, port_search(method, lanes, budget, seed, binary, **kw)


def np_tree(x):
    """A JAX pytree (a ``TreeArena``, a carry dict) as nested numpy: an
    arena becomes a dict of its fields, its state nested as it is."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: np_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: np_tree(v) for k, v in x.items()}
    return np.asarray(x)


def assert_nested_equal(want, got, msg=""):
    """Two nested numpy dicts equal: the same keys and shapes, integer and
    bool leaves exactly, float leaves within FLOAT_TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            f"{msg}: keys {sorted(got)} != {sorted(want)}"
        for k in want:
            assert_nested_equal(want[k], got[k], f"{msg}/{k}")
        return
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, f"{msg}: {got.shape} != {want.shape}"
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=msg, **FLOAT_TOL)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want,
                                      err_msg=msg)


def assert_lm_tree_equal(jtree, ttree, *, b=0, msg=""):
    """A JAX LM-decode arena (unbatched) equals root ``b`` of the port's:
    every plane and state leaf, the port's ``plen`` plane aside."""
    from repro_torch.convert import carry_to_numpy
    got = carry_to_numpy({"arena": ttree})["arena"]
    got = {k: ({kk: (vv[b] if not isinstance(vv, dict)
                     else {c: x[b] for c, x in vv.items()})
                for kk, vv in v.items()} if isinstance(v, dict) else v[b])
           for k, v in got.items()}
    assert_nested_equal(np_tree(jtree), got, msg or "tree")


def arena_map(tree, fn):
    """The port's ``TreeArena`` with ``fn`` applied to every plane and
    state leaf."""
    return dataclasses.replace(tree, **{
        f.name: ({k: fn(v) for k, v in tree.state.items()}
                 if f.name == "state" else fn(getattr(tree, f.name)))
        for f in dataclasses.fields(tree)})
