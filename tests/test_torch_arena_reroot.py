"""Port parity of the arena's serving half: ``repro_torch.core.arena``
``release`` / ``compact`` / ``reroot_ok`` / ``reroot`` against
``repro.core.arena`` on the CPU.

Every case builds a JAX arena, hands its numpy planes to the port
(``convert.arena_from_numpy``), applies the same operation on both sides
and requires every plane to be equal (integer planes and state exactly,
float planes within ``torch_parity.FLOAT_TOL``).  The port's planes carry a
batch axis: a batch of B arenas must give, root by root, what the JAX
package gives each arena alone.  Mirrors ``tests/test_arena.py``'s release
and reroot cases and the arena properties of ``tests/test_properties.py``
(hypothesis, small ``max_examples``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import arena as JA  # noqa: E402
from repro.core.tree import check_consistency as j_check  # noqa: E402
from repro_torch.core import arena as TA  # noqa: E402
from repro_torch.core.tree import check_consistency  # noqa: E402
from torch_parity import assert_arena_equal, to_port  # noqa: E402


def grown(seed, n=12, a=3, grows=20, releases=0):
    """A JAX arena with a random tree grown in it (random visits and
    values, a per-node state leaf), then ``releases`` random leaves
    released.  Returns (arena, released rows)."""
    rng = np.random.default_rng(seed)
    ar = JA.init_arena({"v": jnp.int32(7)}, a, n)
    live = [0]
    for _ in range(grows):
        parent = int(rng.choice(live))
        free = np.flatnonzero(np.asarray(ar.children[parent]) == -1)
        if free.size == 0:
            continue
        slot = int(rng.choice(free))
        ar, row, ok = JA.alloc(ar)
        if not bool(ok):
            break
        ar = ar.replace(
            children=ar.children.at[parent, slot].set(row),
            parent=ar.parent.at[row].set(parent),
            action=ar.action.at[row].set(slot),
            visits=ar.visits.at[row].set(int(rng.integers(1, 9))),
            value=ar.value.at[row].set(float(rng.random())),
            prior=ar.prior.at[row].set(
                jnp.asarray(rng.dirichlet(np.ones(a)), jnp.float32)),
            state={"v": ar.state["v"].at[row].set(int(rng.integers(99)))})
        live.append(int(row))
    ch = np.asarray(ar.children)
    leaves = [r for r in live if r != 0 and (ch[r] == -1).all()]
    rng.shuffle(leaves)
    drop = leaves[:releases]
    for r in drop:
        p, s = int(ar.parent[r]), int(ar.action[r])
        ar = ar.replace(children=ar.children.at[p, s].set(-1))
        ar = JA.release(ar, jnp.int32(r))
    return ar, drop


def batch_of(jaxes):
    return TA.TreeArena.cat([to_port(a) for a in jaxes])


def attach(ar, parent, slot):
    ar, row, _ = JA.alloc(ar)
    return ar.replace(children=ar.children.at[parent, slot].set(row),
                      parent=ar.parent.at[row].set(parent),
                      action=ar.action.at[row].set(slot)), row


# -- tests/test_arena.py's release and reroot cases --------------------------
def test_release_resets_planes():
    ar = JA.init_arena({"v": jnp.int32(7)}, 3, 8)
    ar, r, _ = JA.alloc(ar)
    ar = ar.replace(visits=ar.visits.at[r].set(5),
                    parent=ar.parent.at[r].set(0),
                    children=ar.children.at[r, 0].set(2))
    tr = TA.release(to_port(ar), torch.tensor([[int(r)]]))
    jr = JA.release(ar, r)
    assert_arena_equal(jr, tr)
    assert int(tr.visits[0, int(r)]) == 0 and int(tr.parent[0, int(r)]) == -1
    assert bool((tr.children[0, int(r)] == TA.UNEXPANDED).all())
    assert not bool(TA.live_mask(tr)[0, int(r)])
    assert int(TA.arena_stats(tr)["capacity_left"][0]) == 8 - 1


def test_reroot_recycles_into_free_list():
    """root -> c0 -> g0 plus a sibling c1; reroot on action 0 keeps {c0,
    g0} and gives {root, c1} back."""
    ar = JA.init_arena({"v": jnp.int32(7)}, 2, 8)
    ar, c0 = attach(ar, 0, 0)
    ar, _ = attach(ar, 0, 1)
    ar, _ = attach(ar, int(c0), 1)
    ar = ar.replace(visits=ar.visits.at[jnp.array([0, 1, 2, 3])].set(
        jnp.array([9, 5, 3, 2])))
    t = to_port(ar)
    assert bool(TA.reroot_ok(t, torch.tensor([0]))[0])
    r = TA.reroot(t, torch.tensor([0]))
    assert_arena_equal(JA.reroot(ar, jnp.int32(0)), r)
    stats = {k: int(v[0]) for k, v in TA.arena_stats(r).items()}
    assert stats["live"] == 2 and stats["next_free"] == 2
    assert stats["capacity_left"] == 6
    assert int(r.visits[0, TA.ROOT]) == 5                  # c0 promoted
    assert int(r.visits[0, int(r.children[0, TA.ROOT, 1])]) == 2   # g0
    c = check_consistency(r)
    assert bool(c["parents_valid"][0]) and bool(c["vloss_drained"][0])
    # the argument is left as it was
    assert_arena_equal(ar, t)


# -- batched release / compact / reroot against the JAX package --------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_release_batch_matches_jax(seed):
    """Three arenas, each releasing its own masked set of leaves (one
    releases none) in one call, root by root as the JAX package."""
    rng = np.random.default_rng(seed)
    jaxes = [grown(seed * 10 + i)[0] for i in range(3)]
    rows, masks, want = [], [], []
    for i, ar in enumerate(jaxes):
        ch = np.asarray(ar.children)
        alive = np.asarray(JA.live_mask(ar))
        leaves = [r for r in np.flatnonzero(alive)
                  if r != 0 and (ch[r] == -1).all()]
        pick = list(rng.permutation(leaves)[:3]) if i != 1 else []
        mask = np.arange(3) < len(pick)
        pick += [0] * (3 - len(pick))        # masked out: never released
        rows.append(pick)
        masks.append(mask)
        want.append(JA.release(ar, jnp.asarray(pick, jnp.int32),
                               jnp.asarray(mask)))
    got = TA.release(batch_of(jaxes), torch.tensor(rows, dtype=torch.int32),
                     torch.from_numpy(np.stack(masks)))
    for i, w in enumerate(want):
        assert_arena_equal(w, got, b=i, msg=f"root {i}: ")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compact_batch_matches_jax(seed):
    """Random keep masks and new roots per arena (a keep mask that leaves
    pointers at dropped rows included)."""
    rng = np.random.default_rng(seed)
    jaxes = [grown(seed * 10 + i, releases=2)[0] for i in range(3)]
    keeps, roots, want = [], [], []
    for ar in jaxes:
        keep = rng.random(ar.max_nodes) < 0.6
        nr = int(rng.integers(ar.max_nodes))
        keeps.append(keep)
        roots.append(nr)
        want.append(JA.compact(ar, jnp.asarray(keep), jnp.int32(nr)))
    got = TA.compact(batch_of(jaxes), torch.from_numpy(np.stack(keeps)),
                     torch.tensor(roots))
    for i, w in enumerate(want):
        assert_arena_equal(w, got, b=i, msg=f"root {i}: ")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reroot_batch_matches_jax(seed):
    """Each arena reroots on its own action, an unexpanded one included
    (``reroot_ok`` False: the whole live tree compacts under the old
    root)."""
    jaxes = [grown(seed * 10 + i, releases=1)[0] for i in range(4)]
    acts = []
    for i, ar in enumerate(jaxes):
        ch = np.asarray(ar.children[JA.ROOT])
        cand = np.flatnonzero(ch >= 0 if i != 3 else ch < 0)
        acts.append(int(cand[0]) if cand.size else 0)
    t = batch_of(jaxes)
    act = torch.tensor(acts)
    ok = TA.reroot_ok(t, act)
    got = TA.reroot(t, act)
    for i, ar in enumerate(jaxes):
        a = jnp.int32(acts[i])
        assert bool(ok[i]) == bool(JA.reroot_ok(ar, a))
        assert_arena_equal(JA.reroot(ar, a), got, b=i, msg=f"root {i}: ")


def test_reroot_moves_every_state_leaf():
    """A state of several leaves, one of them a per-node cache-like block
    [N, 2, 3] float32: every leaf is renumbered with the rows."""
    rng = np.random.default_rng(5)
    ar, _ = grown(5)
    big = jnp.asarray(rng.normal(size=(ar.max_nodes, 2, 3)), jnp.float32)
    ar = ar.replace(state={"v": ar.state["v"], "kv": big})
    act = int(np.flatnonzero(np.asarray(ar.children[JA.ROOT]) >= 0)[0])
    want = JA.reroot(ar, jnp.int32(act))
    got = TA.reroot(to_port(ar), torch.tensor([act]))
    np.testing.assert_array_equal(got.state["kv"][0].numpy(),
                                  np.asarray(want.state["kv"]))
    assert_arena_equal(want.replace(state={"v": want.state["v"]}),
                       got.replace(state={"v": got.state["v"]}))


# -- tests/test_properties.py's arena properties -----------------------------
@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(4, 24),
       grows=st.integers(0, 30), releases=st.integers(0, 6))
def test_release_history_matches_jax_and_never_aliases(seed, n, grows,
                                                        releases):
    """Any grow / release history gives the JAX planes, and the next
    alloc returns a dead row or the drop sentinel, as the JAX one does."""
    ar, _ = grown(seed, n, 3, grows, 0)
    rng = np.random.default_rng(seed + 1)
    t = to_port(ar)
    for _ in range(releases):
        ch = np.asarray(ar.children)
        alive = np.asarray(JA.live_mask(ar))
        leaves = [r for r in np.flatnonzero(alive)
                  if r != 0 and (ch[r] == -1).all()]
        if not leaves:
            break
        r = int(rng.choice(leaves))
        p, s = int(ar.parent[r]), int(ar.action[r])
        ar = ar.replace(children=ar.children.at[p, s].set(-1))
        ar = JA.release(ar, jnp.int32(r))
        t.children[0, p, s] = -1
        t = TA.release(t, torch.tensor([[r]]))
    assert_arena_equal(ar, t)
    alive = TA.live_mask(t)[0].numpy()
    jar, jrow, jok = JA.alloc(ar)
    t, row, ok = TA.alloc(t, True)
    assert int(row[0]) == int(jrow) and bool(ok[0]) == bool(jok)
    if bool(ok[0]):
        assert 0 < int(row[0]) < n and not alive[int(row[0])]
    else:
        assert int(row[0]) == n
    assert_arena_equal(jar, t)


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(6, 24),
       grows=st.integers(4, 30), releases=st.integers(1, 6))
def test_release_then_alloc_is_lifo_without_corrupting_survivors(
        seed, n, grows, releases):
    ar, dropped = grown(seed, n, 3, grows, releases)
    if not dropped:
        return
    t = to_port(ar)
    survivors = np.flatnonzero(TA.live_mask(t)[0].numpy())
    before = {f: getattr(t, f)[0].clone() for f in
              ("visits", "value", "parent", "action", "children")}
    got = []
    for _ in dropped:
        t, row, ok = TA.alloc(t, True)
        assert bool(ok[0])
        got.append(int(row[0]))
    assert got == dropped[::-1]
    for f, b in before.items():
        np.testing.assert_array_equal(getattr(t, f)[0].numpy()[survivors],
                                      b.numpy()[survivors], err_msg=f)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), steps=st.integers(1, 4))
def test_iterated_reroot_matches_jax_and_stays_bounded(seed, steps):
    """Reroot after reroot: the JAX planes each time, the arena dense
    (next_free == live, empty free-list), occupancy never growing."""
    rng = np.random.default_rng(seed)
    ar, _ = grown(int(rng.integers(2**31)), 24, 3, 40, 0)
    t = to_port(ar)
    for _ in range(steps):
        cand = np.flatnonzero(np.asarray(ar.children[JA.ROOT]) >= 0)
        if cand.size == 0:
            break
        act = int(rng.choice(cand))
        assert bool(TA.reroot_ok(t, torch.tensor([act]))[0])
        prev_live = int(TA.live_mask(t).sum())
        ar = JA.reroot(ar, jnp.int32(act))
        t = TA.reroot(t, torch.tensor([act]))
        assert_arena_equal(ar, t)
        stats = {k: int(v[0]) for k, v in TA.arena_stats(t).items()}
        assert stats["live"] <= prev_live
        assert stats["next_free"] == stats["live"]
        assert stats["free_top"] == 0
        assert stats["live"] + stats["capacity_left"] == t.max_nodes
        c = check_consistency(t)
        jc = j_check(ar)
        assert bool(c["parents_valid"][0]) == bool(jc["parents_valid"])
        assert bool(c["vloss_drained"][0])
