"""Port parity of MCTS-guided decoding with the uncached domain
(``MCTSDecodeConfig(cached=False)``, every step a full forward):
``repro_torch.serving.mcts_decode_batch`` against the JAX package's, token
for token, on the CPU, for every method and equal and ragged prompts.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_decode import params  # noqa: E402,F401
from test_torch_lm_serving import (EQUAL, METHODS, RAGGED,  # noqa: E402
                                   decode_pair)


@pytest.mark.parametrize("prompts", [EQUAL, RAGGED], ids=["equal", "ragged"])
@pytest.mark.parametrize("method", METHODS)
def test_uncached_decode_token_for_token(params, method, prompts):
    want, got = decode_pair(params, method, prompts, False)
    assert got == want
