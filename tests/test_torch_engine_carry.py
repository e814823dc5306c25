"""Port parity of the serving engine with the cross-token carries on:
``repro_torch.serving.ServingEngine(decode="mcts")`` with ``kv_splice`` /
``tree_reuse`` against ``repro.serving.ServingEngine`` on the CPU, on the
tiny dense config of ``tests/test_torch_engine.py`` and on the rwkv6 and
zamba2 smoke configs (float32; weights from the JAX ``init``).

Mirrors ``tests/test_mcts_serving.py``'s ``test_engine_reuse_mode_drains``
and its preemption round trip with the carries on: the engine admits
(one prefill per request under ``kv_splice``), refills freed slots,
evicts a request for a higher-priority arrival and readmits it, and the
token streams, drained counts and per-request summaries equal the JAX
engine's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serving as JS  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro_torch import serving as TS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from torch_parity import jax_init  # noqa: E402
from test_torch_engine import (DCFG, drain_both, engines,  # noqa: E402,F401
                               pair, submit, summary)

jax.config.update("jax_default_matmul_precision", "highest")

CARRIES = {"splice": dict(kv_splice=True), "reuse": dict(tree_reuse=True),
           "both": dict(kv_splice=True, tree_reuse=True)}


@pytest.mark.parametrize("carry", list(CARRIES))
def test_engine_reuse_mode_drains(pair, carry):
    """Three requests over two slots (a refill), as the JAX package's
    reuse-mode test: 7 tokens, every request done, the carry kept."""
    specs = [(uid, list(range(1, plen + 1)), n)
             for uid, (plen, n) in enumerate(((3, 2), (2, 3), (4, 2)))]
    got = drain_both(pair, specs, max_batch=2, max_seq=16, decode="mcts",
                     mcts={**DCFG, **CARRIES[carry]})
    assert got[2] == 7
    assert all(done for _, _, done in got[3].values())


def test_engine_preemption_round_trip_with_carries(pair):
    """A priority arrival evicts the live request; the victim is
    readmitted (a fresh prefill of prompt + committed tokens, a dead
    tree) and finishes its budget, as in the JAX engine."""
    outs = []
    for eng, mod in zip(engines(pair, max_batch=1, max_seq=32,
                                decode="mcts",
                                mcts={**DCFG, **CARRIES["both"]}),
                        (JS, TS)):
        submit(eng, mod, [(0, [1, 2, 3], 4, 0)])
        assert eng.step() == 1
        submit(eng, mod, [(1, [4, 5], 2, 5)])
        outs.append(summary(eng, eng.run_until_drained()))
    assert outs[1] == outs[0]
    _, _, _, per, snap = outs[1]
    assert per[0] == (4, 1, True) and per[1] == (2, 0, True)
    assert snap["serving/preemptions"] == 1.0


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_recurrent_engine_streams_match_jax_with_carries(arch):
    """The recurrent families (their generic incremental fallback: the
    carried "cache" is the token buffer) with both carries on: three
    ragged requests over two slots, then a priority arrival that evicts
    one; streams and counts equal the JAX engine's."""
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    jp = jax_init(jc)
    tp = params_from_numpy(jp)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    dcfg = dict(num_actions=3, budget=6, lanes=2, search_depth=2,
                rollout_len=2, **CARRIES["both"])
    kw = dict(max_batch=2, max_seq=16, decode="mcts")
    je = JS.ServingEngine(jc, jp, JS.EngineConfig(
        mcts=JS.MCTSDecodeConfig(**dcfg), **kw))
    te = TS.ServingEngine(tc, tp, TS.EngineConfig(
        mcts=TS.MCTSDecodeConfig(**dcfg), **kw), device="cpu")
    outs = []
    for eng, mod in ((je, JS), (te, TS)):
        submit(eng, mod, [(0, [3, 1, 4, 1, 5], 3, 0), (1, [9, 2], 2, 0),
                          (2, [6, 5, 3, 5], 2, 0)])
        eng.step()
        submit(eng, mod, [(3, [2, 7], 2, 5)])
        outs.append(summary(eng, eng.run_until_drained()))
    assert outs[1] == outs[0]
    streams = outs[1][0]
    assert all(0 <= t < tc.vocab_size for s, _ in streams.values()
               for t in s)
    assert outs[1][4]["serving/preemptions"] == 1.0
