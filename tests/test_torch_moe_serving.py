"""Port parity of serving on the MoE and VLM families: the greedy
``ServingEngine`` (deepseek-v2-lite, grok-1 and internvl2 smoke
configurations) and ``mcts_decode_batch`` (deepseek-v2-lite smoke, whose
search takes the generic uncached path of ``models.base``, each row
dispatched to the experts as a sequence of its own) against the JAX
package's engine and decoder on the CPU, float32, weights from the JAX
``init`` through ``convert.params_from_numpy``.  Emitted tokens must be
equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as JS  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models.base import get_family  # noqa: E402
from repro_torch import serving as TS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

# ragged prompts over two slots: the third and fourth requests refill
REQUESTS = ((0, [3, 1, 4, 1, 5], 4), (1, [9, 2, 6], 3),
            (2, [5, 3, 5, 8, 9, 7, 9], 3), (3, [2, 7], 2))


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    jp = jax.jit(get_family(jc).init, static_argnums=0)(jc,
                                                        jax.random.key(0))
    return (jc, jp), (tc, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp)))


def _streams(eng, mod):
    """Every request's emitted tokens after the engine drains."""
    reqs = [mod.Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                        max_new_tokens=n) for uid, prompt, n in REQUESTS]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.uid: list(r.out_tokens) for r in reqs}


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b",
                                  "internvl2-2b"])
def test_greedy_engine_tokens_match_jax(arch):
    (jc, jp), (tc, tp) = _pair(arch)
    ecfg = dict(max_batch=2, max_seq=16, decode="greedy")
    je = JS.ServingEngine(jc, jp, JS.EngineConfig(**ecfg))
    te = TS.ServingEngine(tc, tp, TS.EngineConfig(**ecfg), device="cpu")
    want, got = _streams(je, JS), _streams(te, TS)
    assert got == want
    assert {u: len(t) for u, t in got.items()} \
        == {uid: n for uid, _, n in REQUESTS}


@pytest.mark.parametrize("method,cached", [
    ("pipeline", True), ("pipeline", False), ("sequential", True),
    ("sequential", False)])
def test_mcts_decode_batch_tokens_match_jax(method, cached):
    (jc, jp), (tc, tp) = _pair("deepseek-v2-lite-16b")
    prompts = ([1, 2, 3, 4, 5], [7, 8])
    kw = dict(method=method, num_actions=3, budget=6, lanes=2,
              search_depth=2, rollout_len=2, cached=cached)
    want = JS.mcts_decode_batch(jc, jp, prompts, 2, JS.MCTSDecodeConfig(**kw))
    got = TS.mcts_decode_batch(tc, tp, prompts, 2,
                               TS.MCTSDecodeConfig(**kw), device="cpu")
    assert got == want
