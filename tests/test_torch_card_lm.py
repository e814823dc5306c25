"""On the card: the LM slice's CUDA kernels against their plain versions,
and MCTS-guided decoding on the card against the CPU.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs on a machine that has none:
``python -m pytest -q -m cuda --noconftest tests/test_torch_card_lm.py``.
Weights are the port's own random ``init``.  Tolerances: float32 1e-5;
bfloat16 per element, 1e-5 plus 2^-7 of |value| against the plain
version's bf16 output and 2^-8 against the plain version run in float32 on
the same inputs: both compute in float32 and round to nearest bf16 once,
so the kernel is at most half an ulp from the float32 result and one ulp
from the plain version's rounding of it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as tda  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.base import ModelConfig  # noqa: E402
from repro_torch.serving import (MCTSDecodeConfig,  # noqa: E402
                                 mcts_decode_batch)

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                  dtype="float32")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda", 0)


F32_TOL = 1e-5


def _hold(got, plain, dtype):
    """``got`` against ``plain(cast)``, the plain version on the kernel's
    inputs passed through ``cast`` (see the module docstring)."""
    want = plain(lambda x: x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)
        return
    torch.testing.assert_close(got.float(), want.float(), atol=F32_TOL,
                               rtol=2.0 ** -7)
    torch.testing.assert_close(got.float(), plain(lambda x: x.float()),
                               atol=F32_TOL, rtol=2.0 ** -8)


def _rand(seed, dtype, dev, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dtype).to(dev) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_match_plain_on_card(dtype):
    dev = _card()
    for (b, sq, sk, h, hkv, d, causal, off, cap) in [
            (2, 100, 100, 4, 1, 64, True, 0, 0.0),
            (1, 96, 160, 2, 2, 128, False, 0, 0.0),
            (2, 7, 20, 6, 2, 16, True, 13, 4.0)]:
        q, k, v = _rand(8, dtype, dev, (b, sq, h, d), (b, sk, hkv, d),
                        (b, sk, hkv, d))
        kw = dict(causal=causal, q_offset=off, logits_soft_cap=cap)
        n = tfa.launches["flash_attention"]
        got = tfa.flash_attention(q, k, v, **kw)
        assert tfa.launches["flash_attention"] == n + 1
        _hold(got, lambda c: tfa.flash_attention(c(q), c(k), c(v),
                                                 impl="ref", **kw), dtype)
    q, kc, vc = _rand(9, dtype, dev, (5, 1, 9, 64), (5, 3, 40, 3, 64),
                      (5, 3, 40, 3, 64))
    vl = torch.tensor([0, 1, 17, 39, 40], dtype=torch.int32, device=dev)
    got = tda.decode_attention(q, kc[:, 1], vc[:, 1], vl)
    _hold(got, lambda c: tda.decode_attention(c(q), c(kc[:, 1]),
                                              c(vc[:, 1]), vl, impl="ref"),
          dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("wave_select", ["mega", "lockstep"])
def test_decode_on_card_equals_cpu(wave_select):
    """The card (flash / flash-decode / search-wave kernels) emits the
    CPU's tokens for ragged prompts."""
    dev = _card()
    params = TT.init(CFG, seed=0, device="cpu")
    dcfg = MCTSDecodeConfig(method="pipeline", num_actions=3, budget=9,
                            lanes=3, search_depth=2, rollout_len=2,
                            wave_select=wave_select)
    prompts = ([1, 2, 3, 4, 5], [7, 8])
    before = (tfa.launches["flash_attention"],
              tda.launches["decode_attention"])
    card = mcts_decode_batch(CFG, params, prompts, 3, dcfg, device=dev)
    assert tfa.launches["flash_attention"] > before[0]
    assert tda.launches["decode_attention"] > before[1]
    cpu = mcts_decode_batch(CFG, params, prompts, 3, dcfg, device="cpu")
    assert card == cpu
