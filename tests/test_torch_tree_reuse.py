"""Port parity of the warm-start trees: ``repro_torch.core.tree``'s
cross-token hooks (``root_warm``, ``root_arena`` / ``root_arena_alive``,
``empty_root_carry``, ``root_carry``, ``reroot``, ``warm_start_root``)
and the strategies that honour them, against ``repro.core.tree`` and
``repro.search`` on the CPU, on the cached LM-decode domain (float32;
weights from the JAX ``init``).

Mirrors ``tests/test_tree_reuse.py``'s tree-level cases: the identity
carry and the dead-arena splice are bit for bit cold, ``root_carry`` and
``reroot`` on a hand-built tree and after a real search, and a search that
starts from a carried arena, through every tree-bearing strategy, makes
the JAX package's decisions with its tree.  Integer planes, decisions and
tokens are exact, floats within ``torch_parity.FLOAT_TOL``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import tree as JT  # noqa: E402
from repro.core.domains import lm_decode as JLM  # noqa: E402
from repro.search import SearchConfig as JCfg  # noqa: E402
from repro.search import SearchParams as JParams  # noqa: E402
from repro.search import search as jsearch  # noqa: E402
from repro_torch.core import tree as TT  # noqa: E402
from repro_torch.core.domains import lm_decode as TLM  # noqa: E402
from repro_torch.search import (SearchConfig, SearchParams,  # noqa: E402
                                search, search_batch, search_stacked)
from test_torch_lm_decode import JCFG, TCFG, params  # noqa: E402,F401
from torch_parity import (FLOAT_TOL, arena_map,  # noqa: E402
                          assert_lm_tree_equal, assert_nested_equal)

jax.config.update("jax_default_matmul_precision", "highest")

A, DEPTH, NODES = 3, 3, 18
PROMPT = [1, 2, 3, 0, 0, 0]


def doms(params, prompt=PROMPT, plen=3, jextra=None, textra=None):
    """The (JAX, port) cached domains of one prompt."""
    jp, tp = params
    kw = dict(num_actions=A, search_depth=DEPTH, rollout_len=2)
    jd = JLM.CachedLMDecodeDomain(
        cfg=JCFG, params=jp, prompt=jnp.asarray(prompt, jnp.int32),
        prompt_len=jnp.int32(plen), **kw, **(jextra or {}))
    td = TLM.CachedLMDecodeDomain(
        cfg=TCFG, params=tp, prompt=torch.tensor(prompt, dtype=torch.int32),
        prompt_len=torch.tensor(plen, dtype=torch.int32), **kw,
        **(textra or {}))
    return jd, td


def cfgs(method="pipeline", wave_select="scan", **kw):
    sp = dict(cp=1.0, max_depth=DEPTH, puct=True, kernels="ref",
              wave_select=wave_select)
    common = dict(method=method, budget=8, lanes=2, keep_tree=True,
                  **{"max_nodes": NODES, **kw})
    return (JCfg(params=JParams(**sp), **common),
            SearchConfig(params=SearchParams(**sp), **common))


def leaves(tree):
    out = [getattr(tree, f.name) for f in dataclasses.fields(tree)
           if f.name != "state"]
    return out + [tree.state[k] for k in sorted(tree.state)]


def assert_bitwise(t1, t2):
    for x, y in zip(leaves(t1), leaves(t2), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_close_trees(t1, t2):
    """Integer and bool planes equal, float planes within FLOAT_TOL (a
    batched search's matrix products may round unlike a single one's)."""
    for x, y in zip(leaves(t1), leaves(t2), strict=True):
        if x.dtype.is_floating_point:
            torch.testing.assert_close(x, y, **FLOAT_TOL)
        else:
            assert torch.equal(x, y)


def assert_result(jres, tres, b=None):
    pick = (lambda x: x) if b is None else (lambda x: x[b])
    np.testing.assert_array_equal(pick(tres.action_visits).numpy(),
                                  np.asarray(jres.action_visits))
    assert int(pick(tres.best_action)) == int(jres.best_action)
    assert_lm_tree_equal(jres.tree, tres.tree, b=0 if b is None else b)


def refresh(tree, plen, dom):
    """A rerooted arena's horizon moved to ``plen``: the ``plen`` plane
    rewritten on every row, then ``terminal`` derived from it."""
    tree.state["plen"] = torch.full_like(tree.state["len"], plen)
    return tree.replace(terminal=dom.is_terminal(tree.state))


@pytest.fixture(scope="module")
def cold(params):
    """One cold pipelined search on both sides (trees kept)."""
    jd, td = doms(params)
    jc, tc = cfgs()
    jres = jsearch(jd, jc, jax.random.key(7))
    tres = search(td, tc, 7, device="cpu")
    assert_result(jres, tres)
    return jres, tres


# -- the identity carry and the dead splice ----------------------------------
def test_identity_carry_is_bitwise_noop(params):
    jd, td = doms(params)
    tree = TT.init_tree(td, 16)
    assert_lm_tree_equal(JT.init_tree(jd, 16), tree)
    assert_bitwise(TT.warm_start_root(tree, TT.empty_root_carry(A)), tree)
    assert_bitwise(TT.warm_start_root(
        tree, TT.empty_root_carry(A, batch=1)), tree)
    warm = dataclasses.replace(td, root_warm=TT.empty_root_carry(A))
    assert_bitwise(TT.init_tree(warm, 16), tree)


def test_identity_warm_search_equals_cold_search(params, cold):
    _, tc = cfgs()
    _, td = doms(params, textra=dict(root_warm=TT.empty_root_carry(A)))
    warm = search(td, tc, 7, device="cpu")
    assert torch.equal(warm.action_visits, cold[1].action_visits)
    assert torch.equal(warm.action_value, cold[1].action_value)
    assert_bitwise(warm.tree, cold[1].tree)


def test_dead_arena_splice_is_bitwise_cold(params, cold):
    """An arena of garbage with ``root_arena_alive`` False searches exactly
    cold; in a batch, a dead root stays cold beside a live one (held to a
    cold batch of the same size: the CPU's matrix products may round a
    batch of two unlike a batch of one)."""
    _, tc = cfgs()
    garbage = arena_map(cold[1].tree, lambda x: torch.full_like(x, 7))
    _, td = doms(params, textra=dict(root_arena=garbage,
                                     root_arena_alive=torch.tensor(False)))
    masked = search(td, tc, 7, device="cpu")
    assert int(masked.best_action) == int(cold[1].best_action)
    assert_bitwise(masked.tree, cold[1].tree)
    _, td = doms(params)
    two = dataclasses.replace(td, prompt=td.prompt.expand(2, -1),
                              prompt_len=td.prompt_len.expand(2))
    cold2 = search_stacked(two, 2, tc, 7, device="cpu")
    mixed = search_stacked(dataclasses.replace(
        two, root_arena=TT.TreeArena.cat([garbage, cold[1].tree]),
        root_arena_alive=torch.tensor([False, True])), 2, tc, 7,
        device="cpu")
    assert_bitwise(arena_map(mixed.tree, lambda x: x[:1]),
                   arena_map(cold2.tree, lambda x: x[:1]))
    assert int(mixed.tree.visits[1, 0]) == int(cold[1].tree.visits[0, 0]) + 8


# -- root_carry, warm_start_root and reroot on a hand-built tree -------------
def hand_trees(params):
    """root -> children [1, 2, -]; node 1 -> child 3, on both sides."""
    jd, td = doms(params, PROMPT[:5])
    jt = JT.init_tree(jd, 8)
    jt = jt.replace(
        children=jt.children.at[0].set(jnp.array([1, 2, -1]))
        .at[1].set(jnp.array([3, -1, -1])),
        parent=jt.parent.at[jnp.array([1, 2, 3])].set(jnp.array([0, 0, 1])),
        action=jt.action.at[jnp.array([1, 2, 3])].set(jnp.array([0, 1, 0])),
        visits=jt.visits.at[jnp.array([1, 2, 3])].set(jnp.array([5, 2, 4])),
        value=jt.value.at[jnp.array([1, 2, 3])].set(
            jnp.array([2.5, 1.0, 2.0])),
        prior=jt.prior.at[1].set(jnp.array([0.5, 0.3, 0.2])),
        next_free=jnp.asarray(4, jnp.int32))
    tt = TT.init_tree(td, 8)
    tt.children[0, 0] = torch.tensor([1, 2, -1])
    tt.children[0, 1] = torch.tensor([3, -1, -1])
    tt.parent[0, 1:4] = torch.tensor([0, 0, 1])
    tt.action[0, 1:4] = torch.tensor([0, 1, 0])
    tt.visits[0, 1:4] = torch.tensor([5, 2, 4])
    tt.value[0, 1:4] = torch.tensor([2.5, 1.0, 2.0])
    tt.prior[0, 1] = torch.tensor([0.5, 0.3, 0.2])
    tt.next_free[0] = 4
    assert_lm_tree_equal(jt, tt)
    return jt, tt


def carry_np(c, b=None):
    return {k: (v.numpy() if b is None else v[b].numpy())
            for k, v in c.items()}


@pytest.mark.parametrize("action", [0, 1, 2])
def test_root_carry_matches_jax(params, action):
    """A child with a grandchild, a leaf child and a missing child (the
    identity carry)."""
    jt, tt = hand_trees(params)
    want = jax.tree_util.tree_map(np.asarray,
                                  JT.root_carry(jt, jnp.int32(action)))
    got = TT.root_carry(tt, torch.tensor([action]))
    assert_nested_equal(want, carry_np(got, 0))
    if action == 0:
        assert int(got["visits"][0]) == 5 and float(got["value"][0]) == 2.5
        assert got["child_visits"][0].tolist() == [4, 0, 0]
    if action == 2:
        assert_nested_equal(carry_np(TT.empty_root_carry(A)),
                            carry_np(got, 0))
    # warm-starting a fresh tree from it, as the JAX package does
    jd, td = doms(params)
    assert_lm_tree_equal(
        JT.warm_start_root(JT.init_tree(jd, 8),
                           JT.root_carry(jt, jnp.int32(action))),
        TT.init_tree(dataclasses.replace(td, root_warm=got), 8))


def test_arena_reroot_promotes_child_and_recycles(params):
    jt, tt = hand_trees(params)
    assert bool(TT.reroot_ok(tt, torch.tensor([0]))[0])
    assert not bool(TT.reroot_ok(tt, torch.tensor([2]))[0])
    r = TT.reroot(tt, torch.tensor([0]))
    assert_lm_tree_equal(JT.reroot(jt, jnp.int32(0)), r)
    assert int(r.visits[0, 0]) == 5 and int(r.parent[0, 0]) == -1
    ch = r.children[0, 0].tolist()
    assert ch[1] == ch[2] == -1 and int(r.visits[0, ch[0]]) == 4
    assert int(TT.root_action_by_visits(tt)[0]) == \
        int(JT.root_action_by_visits(jt)) == 0
    assert (TT.max_nodes(r), TT.num_actions(r)) == (8, A)


def test_reroot_after_real_search_keeps_invariants(cold):
    jres, tres = cold
    act = int(tres.best_action)
    assert bool(TT.reroot_ok(tres.tree, torch.tensor([act]))[0])
    r = TT.reroot(tres.tree, torch.tensor([act]))
    assert_lm_tree_equal(JT.reroot(jres.tree, jnp.int32(act)), r)
    alive = TT.live_mask(r)[0]
    assert int(r.next_free[0]) == int(alive.sum()) and int(r.free_top[0]) == 0
    par = r.parent[0]
    for i in torch.nonzero(alive)[:, 0].tolist():
        assert (par[i] == -1) if i == 0 else bool(alive[par[i]])


# -- searches from a carried arena, every tree-bearing strategy --------------
def token_two(params, cold):
    """The prompt with the committed token appended, the rerooted arenas
    (JAX, port) with the horizon moved, and the domains of token two."""
    jres, tres = cold
    jd, td = doms(params)
    act = int(tres.best_action)
    tok = int(td._token(td.root_state(), torch.tensor(act)))
    prompt = PROMPT[:3] + [tok] + PROMPT[4:]
    jd2, td2 = doms(params, prompt, 4)
    jar = JT.reroot(jres.tree, jnp.int32(act))
    jar = jar.replace(terminal=jax.vmap(jd2.is_terminal)(jar.state))
    tar = refresh(TT.reroot(tres.tree, torch.tensor([act])), 4, td2)
    return jd2, td2, jar, tar


@pytest.mark.parametrize("method,wave_select", [
    ("sequential", "scan"), ("leaf", "scan"), ("tree", "scan"),
    ("tree", "mega"), ("pipeline", "scan"), ("pipeline", "lockstep"),
    ("pipeline", "mega")])
def test_strategies_search_from_the_carried_arena(params, cold, method,
                                                  wave_select):
    jd2, td2, jar, tar = token_two(params, cold)
    jc, tc = cfgs(method, wave_select)
    jres = jsearch(dataclasses.replace(jd2, root_arena=jar,
                                       root_arena_alive=jnp.asarray(True)),
                   jc, jax.random.key(8))
    tres = search(dataclasses.replace(td2, root_arena=tar,
                                      root_arena_alive=torch.tensor(True)),
                  tc, 8, device="cpu")
    assert_result(jres, tres)
    carried = int(tar.visits[0, 0])
    assert carried > 0
    assert int(tres.tree.visits[0, 0]) == carried + 8


def test_search_batch_stacks_carried_arenas_and_warm_carries(params, cold):
    """``search_batch`` concatenates batch-1 arenas and stacks RootCarry
    dicts: each root as its own ``search`` (decisions and integer planes
    exact)."""
    _, td2, _, tar = token_two(params, cold)
    _, tc = cfgs()
    _, td1 = doms(params)
    warm = TT.root_carry(cold[1].tree, cold[1].best_action[None])
    warm = {k: v[0] for k, v in warm.items()}
    ds = [dataclasses.replace(td2, root_arena=tar,
                              root_arena_alive=torch.tensor(True)),
          dataclasses.replace(td1, root_arena=cold[1].tree,
                              root_arena_alive=torch.tensor(False))]
    res = search_batch(ds, tc, 8, device="cpu")
    for i, d in enumerate(ds):
        one = search(d, tc, 8, device="cpu")
        assert torch.equal(res.action_visits[i], one.action_visits)
        assert_close_trees(
            arena_map(res.tree, lambda x, i=i: x[i:i + 1]), one.tree)
    ws = [dataclasses.replace(td1, root_warm=warm),
          dataclasses.replace(td1, root_warm=TT.empty_root_carry(A))]
    res = search_batch(ws, tc, 8, device="cpu")
    for i, d in enumerate(ws):
        one = search(d, tc, 8, device="cpu")
        assert_close_trees(
            arena_map(res.tree, lambda x, i=i: x[i:i + 1]), one.tree)


def test_root_strategy_rejects_the_warm_carry(params, cold):
    """The root strategy's workers' trees start cold: a domain with a
    warm-start hook raises there (no caller pairs them: the serving
    carries reject ``method="root"``), alone and in a batch."""
    _, td = doms(params)
    _, tc = cfgs("root", max_nodes=0)
    for hook in (dict(root_warm=TT.empty_root_carry(A)),
                 dict(root_arena=cold[1].tree)):
        d = dataclasses.replace(td, **hook)
        with pytest.raises(ValueError, match="no warm start"):
            search(d, tc, 2, device="cpu")
        with pytest.raises(ValueError, match="no warm start"):
            search_batch([d, d], tc, 2, device="cpu")


def test_carried_arena_rules(params, cold):
    """A carried arena of another capacity, or asked onto another device,
    raises; by default the tree is built on the carried arena's device."""
    _, td = doms(params)
    dom = dataclasses.replace(td, root_arena=cold[1].tree)
    with pytest.raises(ValueError, match="capacity"):
        TT.init_tree(dom, NODES + 1)
    with pytest.raises(ValueError, match="lies on"):
        TT.init_tree(dom, NODES, device="meta")
    assert TT.init_tree(dom, NODES).device == cold[1].tree.device
