"""Port parity of MCTS-guided decoding through the fused wave and the
lockstep select (``wave_select`` "mega" / "lockstep", ``kernels="ref"``):
``repro_torch.serving`` against ``repro.serving`` token for token on the
CPU, ragged prompts, the cached domain; and ``mcts_decode`` as a batch of
one.
"""
import pytest

torch = pytest.importorskip("torch")

from repro.serving import MCTSDecodeConfig as JDC  # noqa: E402
from repro.serving import mcts_decode_batch as jdecode  # noqa: E402
from repro_torch.serving import (MCTSDecodeConfig, mcts_decode,  # noqa: E402
                                 mcts_decode_batch)
from test_torch_lm_decode import JCFG, TCFG, params  # noqa: E402,F401
from test_torch_lm_serving import RAGGED, _kw  # noqa: E402


@pytest.mark.parametrize("wave_select", ["lockstep", "mega"])
def test_decode_fused_waves_match_jax(params, wave_select):
    jp, tp = params
    kw = dict(_kw("pipeline", True), wave_select=wave_select, lanes=3,
              budget=9, kernels="ref")
    want = jdecode(JCFG, jp, RAGGED, 3, JDC(**kw))
    got = mcts_decode_batch(TCFG, tp, RAGGED, 3, MCTSDecodeConfig(**kw),
                            device="cpu")
    assert got == want
    assert mcts_decode(TCFG, tp, RAGGED[0], 3, MCTSDecodeConfig(**kw),
                       device="cpu") == got[0]
