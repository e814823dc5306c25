"""Port parity of the serving engine on the recurrent families: the port's
``ServingEngine`` against the JAX package's on the rwkv6 and zamba2 smoke
configs (float32; weights from the JAX ``init`` through
``convert.params_from_numpy``), greedy and mcts.

Greedy runs the families' batched ``prefill`` / ``decode_step`` (the WKV6
and SSD recurrences; zamba2's shared attention writes each slot's K/V row
at its own position); mcts runs the stateless searcher over the generic
fallback (a full forward per expand and playout step).  Three ragged
requests over two slots exercise refill; a priority arrival exercises the
preemption round trip.  Emitted token streams and the drained counts must
be equal.  Tokens are compared directly: on these seeds no token flips
between the JAX package's chunked scans and the port's sequential ones
(a near tie there would call for comparing logits instead).
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

jax.config.update("jax_default_matmul_precision", "highest")

DCFG = dict(num_actions=3, budget=6, lanes=2, search_depth=2,
            rollout_len=2)
SPECS = [(0, [3, 1, 4, 1, 5], 3, 0), (1, [9, 2], 2, 0),
         (2, [6, 5, 3, 5, 8, 9, 7], 3, 0)]


def _drain(eng, mod, specs, preempt=None):
    for uid, prompt, n, pri in specs:
        eng.submit(mod.Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                               max_new_tokens=n, priority=pri))
    if preempt is not None:
        eng.step()
        uid, prompt, n, pri = preempt
        eng.submit(mod.Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                               max_new_tokens=n, priority=pri))
    out = eng.run_until_drained()
    streams = {s.uid: list(s.out_tokens) for s in eng.slots if s}
    per = {u: (r["tokens"], r["preemptions"], r["done"])
           for u, r in out["requests"].items()}
    return streams, per, out["steps"], out["tokens"]


@pytest.mark.parametrize("mode", ["greedy", "mcts"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_engine_streams_match_jax(arch, mode):
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    jp = jax_init(jc)
    tp = params_from_numpy(jp)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    kw = dict(max_batch=2, max_seq=16, decode=mode)
    je = JS.ServingEngine(jc, jp, JS.EngineConfig(
        mcts=JS.MCTSDecodeConfig(**DCFG), **kw))
    te = TS.ServingEngine(tc, tp, TS.EngineConfig(
        mcts=TS.MCTSDecodeConfig(**DCFG), **kw), device="cpu")
    preempt = (3, [2, 7], 2, 5) if mode == "greedy" else None
    want = _drain(je, JS, SPECS, preempt)
    got = _drain(te, TS, SPECS, preempt)
    assert got == want
    streams = got[0]
    assert all(0 <= t < tc.vocab_size for s in streams.values() for t in s)
    if preempt is not None:                          # one request evicted
        assert sum(p[1] for p in got[1].values()) == 1


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_engine_dead_slots_keep_stepping_past_max_seq(arch):
    """Greedy decode steps every slot, live or not.  A request that fills
    14 of 16 positions is capped to 2 tokens while its neighbour decodes
    on, then a lone request runs with the other slot idle: the dead
    slots' positions pass max_seq, which must not run zamba2's KV cache
    out (the JAX package drops those writes) nor change any stream."""
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    jp = jax_init(jc)
    tp = params_from_numpy(jp)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    kw = dict(max_batch=2, max_seq=16, decode="greedy")
    je = JS.ServingEngine(jc, jp, JS.EngineConfig(**kw))
    te = TS.ServingEngine(tc, tp, TS.EngineConfig(**kw), device="cpu")
    rounds = [[(0, list(np.arange(14) % 9 + 1), 2, 0), (1, [1, 2], 10, 0)],
              [(2, [3, 4], 12, 0)]]
    outs = [[_drain(eng, mod, specs) for specs in rounds]
            for eng, mod in ((je, JS), (te, TS))]
    assert outs[1] == outs[0]
    for specs, (_, per, _, _) in zip(rounds, outs[1]):
        assert all(per[uid] == (n, 0, True) for uid, _, n, _ in specs)
