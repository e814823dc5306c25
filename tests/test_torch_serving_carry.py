"""Port parity of the cross-token serving carry: ``repro_torch.serving``'s
``ReusableSearcher`` and ``mcts_decode_batch`` with ``kv_splice`` /
``tree_reuse`` against ``repro.serving``'s on the CPU (the tiny dense
float32 config; weights from the JAX ``init``).

Mirrors ``tests/test_tree_reuse.py``'s searcher cases: token streams equal
the JAX package's exactly; the carry after every token equals the JAX
carry (``convert.carry_to_numpy``; integer planes exactly, floats within
``torch_parity.FLOAT_TOL``); the port's searcher seeded with the JAX carry
after token 1 (``convert.carry_from_numpy``) makes the JAX package's
token 2 and carry; a 50-token soak keeps the arena's occupancy bounded;
``kv_splice`` changes no token, and ``admit`` prefills one row only.  The
``plen`` refresh of a carried arena has its own case.  The engine's carry
is in ``test_torch_engine_carry.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving import MCTSDecodeConfig as JDC  # noqa: E402
from repro.serving import make_batched_searcher as jsearcher  # noqa: E402
from repro.serving import mcts_decode_batch as jdecode  # noqa: E402
from repro_torch.convert import carry_from_numpy, carry_to_numpy  # noqa: E402
from repro_torch.core.arena import arena_stats  # noqa: E402
from repro_torch.core.tree import check_consistency  # noqa: E402
from repro_torch.serving import (MCTSDecodeConfig,  # noqa: E402
                                 ReusableSearcher, make_batched_searcher,
                                 mcts_decode_batch)
from repro_torch.serving.mcts_decode import _domain  # noqa: E402
from test_torch_lm_decode import JCFG, TCFG, params  # noqa: E402,F401
from torch_parity import assert_nested_equal, np_tree  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

A = 3
KNOBS = {"splice": dict(kv_splice=True), "reuse": dict(tree_reuse=True),
         "both": dict(kv_splice=True, tree_reuse=True)}
RAGGED = [np.array([1, 2, 3, 4], np.int32), np.array([9, 8], np.int32)]


def dkw(**kw):
    base = dict(method="pipeline", num_actions=A, budget=8, lanes=2,
                search_depth=3, rollout_len=2, wave_select="scan")
    return {**base, **kw}


def buffers(prompts, n_new):
    lens = np.array([len(p) for p in prompts], np.int32)
    buf = np.zeros((len(prompts), int(lens.max()) + n_new), np.int32)
    for i, p in enumerate(prompts):
        buf[i, :len(p)] = p
    return buf, lens


def pair(params, **kw):
    """(JAX searcher, port searcher) over the two RAGGED prompts."""
    jp, tp = params
    j = jsearcher(JCFG, jp, JDC(**dkw(**kw)), batch=2, mesh=False)
    t = make_batched_searcher(TCFG, tp, MCTSDecodeConfig(**dkw(**kw)), 2,
                              device="cpu")
    assert isinstance(t, ReusableSearcher)
    return j, t


def assert_carry_equal(jcarry, tcarry, msg=""):
    assert_nested_equal(np_tree(jcarry), carry_to_numpy(tcarry), msg)


def test_config_rules(params):
    _, tp = params
    assert not MCTSDecodeConfig().stateful
    assert MCTSDecodeConfig(kv_splice=True).stateful
    d = MCTSDecodeConfig(**dkw(tree_reuse=True))
    assert d.search_config().max_nodes == d.resolved_arena_nodes == 18
    with pytest.raises(ValueError, match="cached"):
        MCTSDecodeConfig(kv_splice=True, cached=False)
    with pytest.raises(ValueError, match="root"):
        MCTSDecodeConfig(tree_reuse=True, method="root")
    with pytest.raises(ValueError, match="kv_splice or"):
        ReusableSearcher(TCFG, tp, MCTSDecodeConfig(), 2, device="cpu")
    s = make_batched_searcher(TCFG, tp, MCTSDecodeConfig(**dkw(
        kv_splice=True)), 2, device="cpu")
    carry = s.init_carry(6)
    d = s.dcfg
    assert carry["cache"]["k"].shape == (
        2, TCFG.n_layers, 6 + d.search_depth + d.rollout_len,
        TCFG.kv_heads, TCFG.head_dim)
    assert carry["logits"].shape == (2, TCFG.vocab_size)
    assert not any(bool(v.any()) for v in carry["cache"].values())
    with pytest.raises(RuntimeError):
        s.admit(carry, 0, np.zeros(7, np.int32), 2)


@pytest.mark.parametrize("knobs,method", [
    (k, "pipeline") for k in KNOBS] + [("both", "tree"),
                                       ("both", "sequential")])
def test_decode_token_for_token(params, knobs, method):
    """``mcts_decode_batch`` with each carry: the JAX package's tokens,
    and (under ``kv_splice`` alone) the cold path's."""
    jp, tp = params
    kw = dkw(method=method, **KNOBS[knobs])
    want = jdecode(JCFG, jp, RAGGED, 4, JDC(**kw), seed=3)
    got = mcts_decode_batch(TCFG, tp, RAGGED, 4, MCTSDecodeConfig(**kw),
                            device="cpu")
    assert got == want
    cold = mcts_decode_batch(TCFG, tp, RAGGED, 4,
                             MCTSDecodeConfig(**dkw(method=method)),
                             device="cpu")
    assert got[0][0] == cold[0][0] and got[1][0] == cold[1][0]
    if knobs == "splice":
        assert got == cold


def test_carry_matches_jax_after_every_token(params):
    """Both carries threaded for three tokens: after each step the carry
    (arenas, committed actions, liveness, cache rows, logits) is the JAX
    package's."""
    j, t = pair(params, kv_splice=True, tree_reuse=True)
    buf, lens = buffers(RAGGED, 3)
    jc, tc = j.init_carry(buf.shape[1]), t.init_carry(buf.shape[1])
    for i in range(2):
        jc = j.admit(jc, i, buf[i], lens[i])
        tc = t.admit(tc, i, buf[i], int(lens[i]))
    rng = jax.random.key(0)
    for step in range(3):
        rng, sub = jax.random.split(rng)
        jt, jc = j.step(buf, lens, sub, jc)
        tt, tc = t.step(buf, lens, step, tc)
        assert tt.tolist() == np.asarray(jt).tolist()
        assert_carry_equal(jc, tc, f"token {step}")
        buf[np.arange(2), lens] = np.asarray(jt)
        lens = lens + 1


@pytest.mark.parametrize("knobs", ["reuse", "both"])
def test_seeded_carry_reproduces_threaded_run(params, knobs):
    """The JAX carry after token 1, handed to the port's searcher, makes
    the JAX package's token 2 and carry: the carry is the whole
    cross-token state, in both implementations."""
    j, t = pair(params, **KNOBS[knobs])
    buf, lens = buffers(RAGGED, 2)
    jc = j.init_carry(buf.shape[1])
    for i in range(2):
        jc = j.admit(jc, i, buf[i], lens[i])
    tok1, jc = j.step(buf, lens, jax.random.key(21), jc)
    buf[np.arange(2), lens] = np.asarray(tok1)
    lens = lens + 1
    seeded = carry_from_numpy(np_tree(jc), lens - 1)
    tok2, tc2 = t.step(buf, lens, 22, seeded)
    jtok2, jc2 = j.step(buf, lens, jax.random.key(22), jc)
    assert tok2.tolist() == np.asarray(jtok2).tolist()
    assert_carry_equal(jc2, tc2)


def test_plen_refresh_reopens_the_carried_horizon(params):
    """A carried row at ``len == old_plen + depth`` was terminal at the
    previous token; once the horizon moves to ``old_plen + 1`` it must be
    open.  The port keeps ``plen`` in every node, so the searcher rewrites
    that plane on all rows (dead ones included) before it derives
    ``terminal``: left as carried, ``is_terminal`` would still say True."""
    _, tp = params
    s = make_batched_searcher(TCFG, tp, MCTSDecodeConfig(**dkw(
        tree_reuse=True)), 2, device="cpu")
    buf, lens = buffers(RAGGED, 2)
    carry = s.init_carry(buf.shape[1])
    _, carry = s.step(buf, lens, 0, carry)
    ar = carry["arena"]
    # plant a row at the old horizon under the committed child
    child = ar.children[:, 0].gather(1, carry["action"].long()[:, None])
    assert bool((child >= 0).all())
    old_plen = torch.from_numpy(lens)
    row = int(ar.next_free[0]) - 1
    ar.state["len"][0, row] = int(old_plen[0]) + 3
    ar.parent[0, row] = int(child[0, 0])
    ar.terminal[0, row] = True
    new = torch.from_numpy(lens + 1)
    dom = _domain(TCFG, tp, torch.from_numpy(buf), s.dcfg, prompt_len=new)
    stale = dom.is_terminal(ar.state)
    assert bool(stale[0, row])
    rerooted, use = s._carried_arena(carry, dom, new)
    assert bool(use.all())
    assert torch.equal(rerooted.state["plen"],
                       new[:, None].expand(2, rerooted.max_nodes).int())
    moved = rerooted.state["len"][0] == int(old_plen[0]) + 3
    assert bool(moved.any()), "the planted row did not survive the reroot"
    assert not bool(rerooted.terminal[0][moved].any())
    assert torch.equal(rerooted.terminal,
                       rerooted.state["len"] >= new[:, None] + 3)


def test_soak_arena_occupancy_bounded_50_tokens(params):
    """50 tokens through one reused slot: cumulative allocations (~8 per
    token) dwarf the capacity (18), so staying under it proves the rows
    recycle; ``next_free`` plateaus and the arena stays consistent."""
    _, tp = params
    n_tok = 50
    d = MCTSDecodeConfig(**dkw(tree_reuse=True, rollout_len=1))
    cap = d.resolved_arena_nodes
    s = make_batched_searcher(TCFG, tp, d, 1, device="cpu")
    buf, lens = buffers([np.array([1, 2, 3], np.int32)], n_tok)
    carry = s.init_carry(buf.shape[1])
    carry = s.admit(carry, 0, buf[0], 3)
    nf, live = [], []
    for t in range(n_tok):
        visits = 0
        if carry["arena"] is not None:
            ar, act = carry["arena"], carry["action"].long()
            child = ar.children[0, 0, act[0]]
            visits = int(ar.visits[0, child]) if child >= 0 else 0
        toks, carry = s.step(buf, lens, t, carry)
        ar = carry["arena"]
        st = {k: int(v[0]) for k, v in arena_stats(ar).items()}
        assert st["next_free"] <= cap and st["live"] <= cap, (st, t)
        assert st["free_top"] >= 0
        assert int(ar.visits[0, 0]) == visits + 8
        cons = check_consistency(ar)
        assert all(bool(cons[k][0]) for k in ("vloss_drained",
                                             "unobs_drained",
                                             "parents_valid"))
        nf.append(st["next_free"])
        live.append(st["live"])
        buf[0, lens[0]] = int(toks[0])
        lens[0] += 1
    assert max(nf[n_tok // 2:]) <= max(nf[:n_tok // 2]), nf
    assert min(live[1:]) >= 1


def test_splice_admit_prefills_one_row_only(params):
    _, tp = params
    s = make_batched_searcher(TCFG, tp, MCTSDecodeConfig(**dkw(
        kv_splice=True)), 2, device="cpu")
    carry = s.init_carry(8)
    row = np.zeros(8, np.int32)
    row[:3] = [1, 2, 3]
    carry = s.admit(carry, 0, row, 3)
    before = {k: v.clone() for k, v in carry["cache"].items()}
    lg0 = carry["logits"].clone()
    row[:4] = [4, 5, 6, 7]
    carry = s.admit(carry, 1, row, 4)
    for k, v in carry["cache"].items():
        assert torch.equal(v[0], before[k][0]), k
        assert not torch.equal(v[1], before[k][1]), k
    assert torch.equal(carry["logits"][0], lg0[0])
    assert not torch.equal(carry["logits"][1], lg0[1])


def test_commit_step_equals_a_prefill_of_the_longer_prefix(params):
    """After a commit the carried logits and cache rows are those a prefill
    of the prefix one token longer gives (the splice invariant that keeps
    ``kv_splice``'s tokens the cold path's)."""
    _, tp = params
    s = make_batched_searcher(TCFG, tp, MCTSDecodeConfig(**dkw(
        kv_splice=True)), 2, device="cpu")
    buf, lens = buffers(RAGGED, 2)
    carry = s.init_carry(buf.shape[1])
    for i in range(2):
        carry = s.admit(carry, i, buf[i], int(lens[i]))
    toks, carry = s.step(buf, lens, 0, carry)
    buf[np.arange(2), lens] = toks.numpy()
    fresh = s.init_carry(buf.shape[1])
    for i in range(2):
        fresh = s.admit(fresh, i, buf[i], int(lens[i]) + 1)
    torch.testing.assert_close(carry["logits"], fresh["logits"], atol=1e-5,
                               rtol=1e-5)
    n = int(lens.min()) + 1
    for k, v in carry["cache"].items():
        torch.testing.assert_close(v[..., :n, :, :], fresh["cache"][k][
            ..., :n, :, :], atol=1e-5, rtol=1e-5)
