"""On the card: the flash kernel (K4) at MLA's head dims, and the MoE,
VLM and Whisper families on the card against the CPU.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs on a machine that has none:
``python -m pytest -q -m cuda --noconftest tests/test_torch_card_families.py``.
Weights are the port's own random ``init`` on the CPU, copied to the card.
Tolerances: the bf16 tensor-core K4 per element within ``rounded_p_limit``
(it rounds P to bf16 before PV) of the plain version run in float32; the
float32 K4 within 1e-5 of its plain version (the orders of the sums
differ); float32 logits of the smoke stacks, card against CPU, 1e-4
absolute and relative; emitted tokens equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    rounded_p_limit)
from repro_torch.models.base import get_family, tree_to  # noqa: E402
from repro_torch.serving import (EngineConfig, Request,  # noqa: E402
                                 ServingEngine, mcts_decode_batch,
                                 MCTSDecodeConfig)

F32_TOL = 1e-5
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(dev, *shape, dtype=torch.float32, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randn(*shape, generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,causal,q_offset,cap,skv", [
    (1, 65, 16, 16, True, 0, 0.0, None),
    (1, 130, 16, 16, True, 0, 0.0, None),
    (1, 384, 16, 16, True, 0, 0.0, None),
    (2, 100, 16, 16, False, 0, 0.0, 90),
    (2, 70, 16, 8, True, 3, 30.0, None),
    (8, 123, 16, 16, True, 0, 0.0, None),   # a search forward over 8 rows
])
def test_k4_bf16_mla_head_dims_on_card(b, s, h, hkv, causal, q_offset, cap,
                                       skv):
    """K4 bf16 at q/k head dim 192, v head dim 128 within
    ``rounded_p_limit``; the diagonal planted one position late reads above
    it; one launch counted under ``flash_attention_bf16_mla``."""
    dev = _card()
    bf = torch.bfloat16
    q = _rand(dev, b, s, h, 192, dtype=bf, seed=1)
    k = _rand(dev, b, s, hkv, 192, dtype=bf, seed=2)
    v = _rand(dev, b, s, hkv, 128, dtype=bf, seed=3)
    kw = dict(causal=causal, q_offset=q_offset, logits_soft_cap=cap,
              seq_k_valid=skv)
    n = tfa.launches["flash_attention_bf16_mla"]
    got = tfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.launches["flash_attention_bf16_mla"] == n + 1
    assert got.shape == (b, s, h, 128) and got.dtype == bf
    want, lim = rounded_p_limit(q, k, v, atol=F32_TOL, **kw)
    assert float(((got.float() - want).abs() / lim).max()) <= 1.0
    if causal:
        bad = tfa.flash_attention(q, k, v, **dict(kw, q_offset=q_offset + 1))
        assert float(((bad.float() - want).abs() / lim).max()) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,dv,cap", [
    (2, 15, 4, 4, 24, 16, 0.0),     # deepseek-v2-lite smoke prefill
    (2, 150, 4, 2, 24, 16, 30.0),
    (1, 130, 3, 1, 64, 20, 0.0),
    (1, 80, 2, 2, 128, 64, 0.0),
])
def test_k4_f32_value_head_dim_on_card(b, s, h, hkv, d, dv, cap):
    dev = _card()
    q = _rand(dev, b, s, h, d, seed=4)
    k = _rand(dev, b, s, hkv, d, seed=5)
    v = _rand(dev, b, s, hkv, dv, seed=6)
    n = tfa.launches["flash_attention"]
    got = tfa.flash_attention(q, k, v, logits_soft_cap=cap)
    assert tfa.launches["flash_attention"] == n + 1
    want = tfa.flash_attention(q, k, v, logits_soft_cap=cap, impl="ref")
    assert got.shape == (b, s, h, dv)
    assert float((got - want).abs().max()) <= F32_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,dv", [(192, 192), (128, 64), (96, 96)])
def test_k4_bf16_rejects_unsupported_pairs_on_card(d, dv):
    dev = _card()
    q = torch.zeros(1, 8, 2, d, dtype=torch.bfloat16, device=dev)
    v = torch.zeros(1, 8, 2, dv, dtype=torch.bfloat16, device=dev)
    before = dict(tfa.launches)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, v)
    assert tfa.launches == before


def _smoke(arch, dev):
    cfg = get_smoke_config(arch)
    params = get_family(cfg).init(cfg, seed=0, device="cpu")
    return cfg, get_family(cfg), params, tree_to(params, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_moe_smoke_prefill_steps_and_engine_card_equals_cpu(arch):
    dev = _card()
    cfg, fam, cpu_p, card_p = _smoke(arch, dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    out = {}
    for d, p in (("cpu", cpu_p), (dev, card_p)):
        cache = fam.init_cache(cfg, 2, 16, device=d)
        lg, cache = fam.prefill(cfg, p, toks.to(d), cache)
        seq = [lg]
        for i in range(3):
            nxt = torch.full((2, 1), 5 + i, dtype=torch.int32, device=d)
            lg, cache = fam.decode_step(cfg, p, cache, nxt)
            seq.append(lg)
        seq.append(fam.logits_fn(cfg, p, toks.to(d)))
        out[str(d)] = [x.cpu() for x in seq]
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, **LOGIT_TOL)
    streams = []
    for d, p in (("cpu", cpu_p), (dev, card_p)):
        eng = ServingEngine(cfg, p, EngineConfig(max_batch=2, max_seq=16),
                            device=d)
        reqs = [Request(uid=u, prompt=np.arange(1, 3 + 2 * u, dtype=np.int32),
                        max_new_tokens=3) for u in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        streams.append([r.out_tokens for r in reqs])
    assert streams[0] == streams[1]
    dc = MCTSDecodeConfig(num_actions=3, budget=6, lanes=2, search_depth=2,
                          rollout_len=2)
    prompts = ([1, 2, 3, 4, 5], [7, 8])
    assert mcts_decode_batch(cfg, card_p, prompts, 2, dc, device=dev) \
        == mcts_decode_batch(cfg, cpu_p, prompts, 2, dc, device="cpu")


@pytest.mark.cuda
def test_vlm_and_whisper_smoke_card_equals_cpu():
    dev = _card()
    cfg, fam, cpu_p, card_p = _smoke("internvl2-2b", dev)
    g = torch.Generator().manual_seed(2)
    patches = torch.randn(2, cfg.n_patches, cfg.frontend_dim, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=g)
    torch.testing.assert_close(
        fam.multimodal_logits(cfg, card_p, patches.to(dev),
                              toks.to(dev)).cpu(),
        fam.multimodal_logits(cfg, cpu_p, patches, toks), **LOGIT_TOL)
    cfg, fam, cpu_p, card_p = _smoke("whisper-base", dev)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=g)
    toks = torch.randint(0, cfg.vocab_size, (2, 7), generator=g)
    out = {}
    for d, p in (("cpu", cpu_p), (dev, card_p)):
        cache = fam.init_cache(cfg, 2, 12, device=d)
        lg, cache = fam.prefill(cfg, p, {"frames": frames.to(d),
                                         "tokens": toks.to(d)}, cache)
        seq = [lg]
        for i in range(3):
            nxt = torch.full((2, 1), 3 + i, dtype=torch.int32, device=d)
            lg, cache = fam.decode_step(cfg, p, cache, nxt)
            seq.append(lg)
        out[str(d)] = [x.cpu() for x in seq]
    for a, b in zip(out["cpu"], out[str(dev)]):
        torch.testing.assert_close(b, a, **LOGIT_TOL)
