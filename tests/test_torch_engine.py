"""Port parity of the serving engine: ``repro_torch.serving.ServingEngine``
against ``repro.serving.ServingEngine`` on the CPU, on the tiny dense
config of ``tests/test_mcts_serving.py`` (weights from the JAX ``init``
through ``convert.params_from_numpy``), in both decode modes.

Each scenario of ``tests/test_mcts_serving.py``'s engine tests runs on
both engines: mixed lengths, refill, EOS mid-budget, the capacity clamps,
the preemption round trip, both admission policies, zero budgets and the
elastic shrink.  Emitted token streams, ``run_until_drained``'s counts
and the per-request summaries' token and preemption counts must be equal
(timings differ by nature).  What the port does not have raises
``NotImplementedError``: explicit meshes.  The cross-token carries are
in ``test_torch_engine_carry.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.base import ModelConfig as JCfg  # noqa: E402
from repro.models.base import get_family  # noqa: E402
from repro import serving as JS  # noqa: E402
from repro_torch import serving as TS  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.base import ModelConfig as TCfg  # noqa: E402
from torch_parity import jax_init  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

KW = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
          n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", ce_chunk=8,
          remat=False)
DCFG = dict(num_actions=3, budget=6, lanes=2, search_depth=2,
            rollout_len=1)


@pytest.fixture(scope="module")
def pair():
    jc, tc = JCfg(**KW), TCfg(**KW)
    jp = jax_init(jc)
    return (jc, jax.tree_util.tree_map(jnp.asarray, jp)), \
        (tc, params_from_numpy(jp))


def engines(pair, **ecfg):
    """(JAX engine, port engine on the CPU) under the same EngineConfig
    fields; ``mcts`` takes the MCTSDecodeConfig fields as a dict."""
    (jc, jp), (tc, tp) = pair
    m = ecfg.pop("mcts", DCFG)
    je = JS.ServingEngine(jc, jp, JS.EngineConfig(
        mcts=JS.MCTSDecodeConfig(**m), **ecfg))
    te = TS.ServingEngine(tc, tp, TS.EngineConfig(
        mcts=TS.MCTSDecodeConfig(**m), **ecfg), device="cpu")
    return je, te


def submit(eng, mod, specs):
    """``specs``: (uid, prompt, max_new_tokens[, priority])."""
    for uid, prompt, n, *pri in specs:
        eng.submit(mod.Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                               max_new_tokens=n,
                               priority=pri[0] if pri else 0))


def summary(eng, out=None):
    """What must be equal between the two engines."""
    reqs = {s.uid: (list(s.out_tokens), s.done) for s in eng.slots if s}
    if out is None:
        return reqs
    per = {u: (r["tokens"], r["preemptions"], r["done"])
           for u, r in out["requests"].items()}
    snap = {k: v for k, v in out["stats"].items()
            if k in ("serving/requests_finished", "serving/tokens",
                     "serving/steps", "serving/searches",
                     "serving/preemptions", "serving/requests_admitted")}
    return reqs, out["steps"], out["tokens"], per, snap


def drain_both(pair, specs, **ecfg):
    je, te = engines(pair, **ecfg)
    submit(je, JS, specs)
    submit(te, TS, specs)
    want = summary(je, je.run_until_drained())
    got = summary(te, te.run_until_drained())
    assert got == want
    return got


@pytest.mark.parametrize("mode", ["greedy", "mcts"])
def test_engine_drains_mixed_lengths_with_refill(pair, mode):
    """Three requests over two slots: the third is admitted when a slot
    frees (refill); streams, counts and summaries equal the JAX engine's
    (greedy's ``tokens`` counts decode steps only, as there)."""
    got = drain_both(pair, [(0, [1, 2, 3], 2), (1, [4, 5], 3),
                            (2, [6, 7, 8, 9], 2)],
                     max_batch=2, max_seq=16, decode=mode)
    assert got[2] == (4 if mode == "greedy" else 7)


@pytest.mark.parametrize("mode", ["greedy", "mcts"])
def test_engine_zero_budget_and_capacity_clamps(pair, mode):
    """Zero max_new_tokens finishes without emitting; a prompt that fills
    max_seq emits one token (greedy: the prefill's; mcts: one search from
    the full prefix); a search prefix that reaches max_seq is closed
    there."""
    drain_both(pair, [(0, [1, 2], 0)], max_batch=1, max_seq=16, decode=mode)
    got = drain_both(pair, [(0, np.arange(8) % 60 + 1, 4)], max_batch=1,
                     max_seq=8, decode=mode)
    assert len(got[0][0][0]) == 1
    if mode == "mcts":
        got = drain_both(pair, [(0, [1, 2, 3, 4], 10)], max_batch=1,
                         max_seq=6, decode=mode)
        assert len(got[0][0][0]) == 3


@pytest.mark.parametrize("rounds", [
    # A fills 14 of 16 positions and is capped to 2 tokens; B decodes on,
    # so A's dead slot keeps stepping past max_seq
    [[(0, np.arange(14) % 60 + 1, 2), (1, [1, 2], 10)]],
    # one request at a time: slot 1 is never admitted and steps 22 times
    [[(0, [1, 2], 12)], [(1, [3, 4], 12)]],
])
def test_engine_dead_slots_keep_stepping_past_max_seq(pair, rounds):
    """Greedy decode steps every slot, live or not; a dead slot's position
    must not run the cache out (the JAX package drops the writes past its
    end) and must not change the live slots' streams."""
    je, te = engines(pair, max_batch=2, max_seq=16, decode="greedy")
    outs = []
    for eng, mod in ((je, JS), (te, TS)):
        done = []
        for specs in rounds:
            submit(eng, mod, specs)
            done.append(summary(eng, eng.run_until_drained()))
        outs.append(done)
    assert outs[1] == outs[0]
    for specs, (_, _, _, per, _) in zip(rounds, outs[1]):
        assert all(per[uid][:2] == (n, 0) and per[uid][2]
                   for uid, _, n in specs)


def test_engine_eos_mid_budget_frees_slot_same_step(pair):
    """EOS retires the slot AND refills it within the same engine step
    (the searcher stubbed to emit the EOS token, as in the JAX test)."""
    je, te = engines(pair, max_batch=1, max_seq=16, eos_token=7,
                     decode="mcts")
    je._mcts_search = lambda buf, lens, rng: jnp.full((1,), 7, jnp.int32)
    te._mcts_search = lambda buf, lens, rng: torch.full((1,), 7,
                                                        dtype=torch.int32)
    for eng, mod in ((je, JS), (te, TS)):
        submit(eng, mod, [(0, [1, 2], 5), (1, [3, 4], 5)])
        assert eng.step() == 1
        assert eng.sched.live() == [0] and eng.sched.request(0).uid == 1
        assert eng.step() == 1
        assert all(s.done for s in eng.slots)
        assert eng.stats.requests[0].tokens == 1


@pytest.mark.parametrize("mode", ["greedy", "mcts"])
def test_engine_preemption_roundtrip_keeps_committed_tokens(pair, mode):
    """A higher-priority arrival evicts the live request; the victim
    resumes with its committed tokens and finishes its budget."""
    je, te = engines(pair, max_batch=1, max_seq=32, decode=mode)
    outs = []
    for eng, mod in ((je, JS), (te, TS)):
        submit(eng, mod, [(0, [1, 2, 3], 4, 0)])
        eng.step()
        first = list(eng.slots[0].out_tokens)
        submit(eng, mod, [(1, [4, 5], 2, 5)])
        out = eng.run_until_drained()
        victim = next(s for s in eng.slots if s and s.uid == 0)
        assert victim.out_tokens[: len(first)] == first
        assert out["requests"][0]["preemptions"] == 1
        outs.append((first, summary(eng, out)))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("mode", ["greedy", "mcts"])
@pytest.mark.parametrize("policy", ["fcfs", "spf"])
def test_engine_admission_policy_wired(pair, mode, policy):
    je, te = engines(pair, max_batch=1, max_seq=16, decode=mode,
                     policy=policy)
    orders = []
    for eng, mod in ((je, JS), (te, TS)):
        submit(eng, mod, [(0, [1, 2, 3, 4], 2), (1, [5], 2)])
        eng.run_until_drained()
        assert eng.stats.finished == 2
        reqs = eng.stats.requests
        orders.append(sorted(reqs, key=lambda u: reqs[u].admit_t))
    assert orders == [[1, 0] if policy == "spf" else [0, 1]] * 2
    assert summary(te) == summary(je)


def test_engine_shrink_requeues_and_keeps_serving(pair):
    """A lost slot's request is requeued with its tokens and finishes on
    the surviving slot."""
    je, te = engines(pair, max_batch=2, max_seq=16, decode="mcts")
    outs = []
    for eng, mod in ((je, JS), (te, TS)):
        submit(eng, mod, [(0, [1, 2, 3], 3), (1, [4, 5], 3)])
        eng.step()
        assert eng.shrink([1]) == [1]
        with pytest.raises(ValueError, match="every slot"):
            eng.shrink([0])
        outs.append(summary(eng, eng.run_until_drained()))
    assert outs[1] == outs[0]


def test_engine_rejects_what_it_cannot_run(pair):
    """Unknown decode modes and oversized prompts raise ValueError, as in
    the JAX package; a mesh that is neither None, False nor a SearchMesh
    raises TypeError."""
    (_, _), (tc, tp) = pair
    mk = lambda **kw: TS.ServingEngine(tc, tp, TS.EngineConfig(**kw),
                                       device="cpu")
    with pytest.raises(ValueError, match="decode mode"):
        mk(max_batch=1, decode="beam")
    eng = mk(max_batch=1, max_seq=8, decode="mcts",
             mcts=TS.MCTSDecodeConfig(**DCFG))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(TS.Request(uid=0, prompt=np.arange(9, dtype=np.int32),
                              max_new_tokens=1))
    with pytest.raises(TypeError, match="SearchMesh"):
        mk(max_batch=2, mesh=object())
    assert mk(max_batch=1, mesh=False).mode == "greedy"
