"""Port parity of MCTS-guided decoding: ``repro_torch.serving.
mcts_decode_batch`` against ``repro.serving.mcts_decode_batch`` on the CPU,
token for token, for every method and equal and ragged prompt batches,
with the cached domain (the uncached domain: ``test_torch_lm_serving_
uncached.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving import MCTSDecodeConfig as JDC  # noqa: E402
from repro.serving import mcts_decode_batch as jdecode  # noqa: E402
from repro_torch.serving import (MCTSDecodeConfig,  # noqa: E402
                                 mcts_decode_batch)
from test_torch_lm_decode import JCFG, TCFG, params  # noqa: E402,F401

jax.config.update("jax_default_matmul_precision", "highest")

METHODS = ("sequential", "root", "leaf", "tree", "pipeline")
EQUAL = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
RAGGED = ([1, 2, 3, 4, 5], [7, 8])


def _kw(method, cached):
    return dict(method=method, num_actions=3, budget=6, lanes=2,
                search_depth=2, rollout_len=2, cached=cached,
                wave_select="scan")


def decode_pair(params, method, prompts, cached):
    """(JAX tokens, port tokens) of one ``mcts_decode_batch``."""
    jp, tp = params
    want = jdecode(JCFG, jp, prompts, 2, JDC(**_kw(method, cached)))
    got = mcts_decode_batch(TCFG, tp, prompts, 2,
                            MCTSDecodeConfig(**_kw(method, cached)),
                            device="cpu")
    return want, got


@pytest.mark.parametrize("prompts", [EQUAL, RAGGED], ids=["equal", "ragged"])
@pytest.mark.parametrize("method", METHODS)
def test_decode_token_for_token(params, method, prompts):
    want, got = decode_pair(params, method, prompts, True)
    assert got == want
