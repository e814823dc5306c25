"""On the card: the LM slice's CUDA kernels against their plain versions,
and MCTS-guided decoding on the card against the CPU.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs on a machine that has none:
``python -m pytest -q -m cuda --noconftest tests/test_torch_card_lm.py``.
Weights are the port's own random ``init``.  Tolerances: float32 1e-5;
bfloat16 flash-decode (K3) per element, 1e-5 plus 2^-7 of |value| against
the plain version's bf16 output and 2^-8 against the plain version run in
float32 on the same inputs: both compute in float32 and round to nearest
bf16 once, so the kernel is at most half an ulp from the float32 result
and one ulp from the plain version's rounding of it.  The bf16 flash
kernel (K4) rounds P to bf16 before PV, as the Pallas kernel does: it is
held per element to ``ref.rounded_p_limit`` (1e-5 + 2^-8 |want| + 2^-8 M,
M = sum_j p_j |v_j| / l) against the plain version run in float32, and a
planted fault must read above that limit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as tda  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfr  # noqa: E402
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


def _limit_share(got, q, k, v, **kw):
    """Largest share of ``rounded_p_limit`` that an element of ``got``
    uses (above 1: outside the limit)."""
    want, lim = tfr.rounded_p_limit(q, k, v, atol=F32_TOL, **kw)
    return float(((got.float() - want).abs() / lim).max())


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
    counter = "flash_attention" if dtype == torch.float32 \
        else "flash_attention_bf16"
    for (b, sq, sk, h, hkv, d, causal, off, cap) in [
            (2, 100, 100, 4, 1, 64, True, 0, 0.0),
            (1, 96, 160, 2, 2, 128, False, 0, 0.0),
            (2, 7, 20, 6, 2, 80, True, 13, 4.0)]:
        q, k, v = _rand(8, dtype, dev, (b, sq, h, d), (b, sk, hkv, d),
                        (b, sk, hkv, d))
        kw = dict(causal=causal, q_offset=off, logits_soft_cap=cap)
        n = tfa.launches[counter]
        got = tfa.flash_attention(q, k, v, **kw)
        assert tfa.launches[counter] == n + 1
        if dtype == torch.float32:
            _hold(got, lambda c: tfa.flash_attention(c(q), c(k), c(v),
                                                     impl="ref", **kw), dtype)
        else:
            assert _limit_share(got, q, k, v, **kw) <= 1.0
    q, kc, vc = _rand(9, dtype, dev, (5, 1, 9, 64), (5, 3, 40, 3, 64),
                      (5, 3, 40, 3, 64))
    vl = torch.tensor([0, 1, 17, 39, 40], dtype=torch.int32, device=dev)
    got = tda.decode_attention(q, kc[:, 1], vc[:, 1], vl)
    _hold(got, lambda c: tda.decode_attention(c(q), c(kc[:, 1]),
                                              c(vc[:, 1]), vl, impl="ref"),
          dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,off,cap,skv", [
    (3, 15, 15, 3, 1, 16, True, 0, 0.0, None),     # the smoke prefill
    (2, 150, 150, 6, 2, 16, True, 0, 0.0, None),   # 3 query tiles, ragged
    (2, 70, 90, 4, 4, 20, True, 20, 0.0, None),    # D 20, q_offset
    (1, 130, 200, 6, 2, 20, False, 0, 3.0, 170),   # non-causal, kv padding
    (2, 65, 65, 3, 1, 100, True, 0, 0.0, 60),      # D 100, seq_k_valid
    (1, 100, 100, 6, 2, 100, False, 0, 0.0, None),
    (1, 9, 12, 3, 1, 16, True, -4, 0.0, None),     # rows with no key
    (1, 40, 40, 3, 3, 20, True, 0, 0.0, 0),        # no key at all
    (2, 28, 28, 4, 4, 16, True, 0, 0.0, None),     # zamba2-smoke search
    (1, 9, 9, 4, 4, 16, True, 0, 0.0, None),       # zamba2-smoke prefill
])
def test_flash_f32_kernel_matches_plain(b, sq, sk, h, hkv, d, causal, off,
                                        cap, skv):
    """The float32 register-blocked K4 against its plain version within
    1e-5 (the order of the float32 sums), through every knob it takes; a
    row with no key to attend gives 0."""
    dev = _card()
    q, k, v = _rand(60 + d, torch.float32, dev, (b, sq, h, d),
                    (b, sk, hkv, d), (b, sk, hkv, d))
    kw = dict(causal=causal, q_offset=off, logits_soft_cap=cap,
              seq_k_valid=skv)
    n = tfa.launches["flash_attention"]
    got = tfa.flash_attention(q, k, v, **kw)
    assert tfa.launches["flash_attention"] == n + 1
    want = tfa.flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    torch.testing.assert_close(got.cpu(), want, atol=F32_TOL, rtol=F32_TOL)
    empty = torch.zeros(sq, dtype=torch.bool)
    if causal and off < 0:
        empty[:-off] = True
    if skv == 0:
        empty[:] = True
    got = got.cpu()[:, empty]
    assert torch.equal(got, torch.zeros_like(got))


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


# K4 bf16 on the tensor cores: ragged lengths (not multiples of 64), a
# shifted diagonal, soft cap, kv padding, rows with no key, G in {1, 3, 7},
# D in {64, 80, 128}
FLASH_BF16_CASES = [
    # b, sq, sk, h, hkv, d, causal, q_offset, cap, seq_k_valid
    (2, 100, 100, 4, 4, 64, True, 0, 0.0, None),
    (1, 37, 150, 9, 3, 64, True, 113, 0.0, None),
    (2, 130, 130, 7, 1, 80, True, 0, 30.0, 97),
    (1, 70, 200, 3, 1, 128, False, 0, 0.0, 171),
    (3, 65, 65, 6, 2, 128, True, -20, 0.0, None),    # 20 rows see no key
    (1, 1, 5, 2, 2, 64, True, 3, 0.0, None),         # one query row
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal,off,cap,skv",
                         FLASH_BF16_CASES)
def test_flash_bf16_tensor_core_kernel_within_rounded_p_limit(
        b, sq, sk, h, hkv, d, causal, off, cap, skv):
    """The wgmma kernel within ``rounded_p_limit`` of the plain version in
    float32; the same inputs with the diagonal one position off (or, non-
    causal, the last valid key dropped) read above it."""
    dev = _card()
    q, k, v = _rand(20 + d, torch.bfloat16, dev, (b, sq, h, d),
                    (b, sk, hkv, d), (b, sk, hkv, d))
    kw = dict(causal=causal, q_offset=off, logits_soft_cap=cap,
              seq_k_valid=sk if skv is None else skv)
    n = tfa.launches["flash_attention_bf16"]
    got = tfa.flash_attention(q, k, v, **kw)
    assert tfa.launches["flash_attention_bf16"] == n + 1
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert _limit_share(got, q, k, v, **kw) <= 1.0
    if causal and off < 0:
        assert torch.equal(got[:, :-off], torch.zeros_like(got[:, :-off]))
    planted = dict(kw)
    if causal:
        planted["q_offset"] = off + 1
    else:
        planted["seq_k_valid"] = kw["seq_k_valid"] - 1
    assert _limit_share(tfa.flash_attention(q, k, v, **planted), q, k, v,
                        **kw) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv", [(4, 4), (6, 2)])
def test_flash_bf16_keeps_each_calls_tensor_maps(h, hkv):
    """One q against a run of new k / v tensors, all alive at once: the
    host keeps the last few TMA maps by pointer, so q's map is found while
    k's and v's are encoded anew and take the oldest slots (q's among
    them).  Every output stays within ``rounded_p_limit``."""
    dev = _card()
    b, s, d = 2, 70, 64
    (q,) = _rand(50, torch.bfloat16, dev, (b, s, h, d))
    kvs = [_rand(51 + i, torch.bfloat16, dev, (b, s, hkv, d), (b, s, hkv, d))
           for i in range(10)]
    for k, v in kvs:
        assert _limit_share(tfa.flash_attention(q, k, v), q, k, v,
                            causal=True) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 96])
def test_flash_bf16_rejects_head_dims_it_does_not_take(d):
    dev = _card()
    q, k, v = _rand(30, torch.bfloat16, dev, (1, 8, 2, d), (1, 8, 2, d),
                    (1, 8, 2, d))
    n = dict(tfa.launches)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, k, v)
    assert tfa.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,d,s", [
    (4, 2, 3, 64, 700),      # 8 blocks: split-K
    (3, 1, 1, 128, 300),     # 3 blocks: split-K
    (96, 3, 3, 64, 90),      # 288 blocks: single pass
    (20, 16, 1, 128, 50),    # 320 blocks: single pass
    (3, 4, 7, 80, 260),      # G 7, D 80: split-K
    (5, 2, 2, 6, 300),       # D 6: padded to 16-byte rows
    (3, 1, 4, 20, 300),      # D 20: padded in bf16
])
def test_decode_kernel_split_and_single_pass_routes(dtype, b, hkv, g, d, s):
    """K3 on strided layer slices of a batched cache, valid_len in {0, 1,
    Sk} and ragged between, on the route its shape picks."""
    dev = _card()
    h = hkv * g
    q, kc, vc = _rand(40 + d, dtype, dev, (b, 1, h, d), (b, 3, s, hkv, d),
                      (b, 3, s, hkv, d))
    k, v = kc[:, 1], vc[:, 1]
    assert not k.is_contiguous()
    splits = tda.split_count(b * hkv, s)
    assert (splits > 1) == (b * hkv < 2 * tda.SMS)
    rng = np.random.default_rng(b)
    vl = rng.integers(2, s, b)
    vl[:3] = (0, 1, s)
    vl = torch.tensor(vl, dtype=torch.int32, device=dev)
    n = tda.launches["decode_attention"]
    got = tda.decode_attention(q, k, v, vl)
    assert tda.launches["decode_attention"] == n + 1
    _hold(got, lambda c: tda.decode_attention(c(q), c(k), c(v), vl,
                                              impl="ref"), dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hkv,g,d,s", [
    (4, 2, 3, 64, 700),      # split-K: the lse from da_combine
    (96, 3, 3, 64, 90),      # single pass: the lse from da_kernel
    (3, 4, 7, 80, 260),      # G 7, D 80
])
def test_decode_kernel_lse_matches_plain(dtype, b, hkv, g, d, s):
    """K3 storing each row's lse (the sequence-sharded decode's partial)
    on both routes: the output bit-equal to the same launch without the
    lse, the lse within 1e-4 of the plain version's run in float32 (the
    kernel sums in float32 in the log2 domain), -inf on exactly the rows
    with valid_len 0."""
    dev = _card()
    h = hkv * g
    q, kc, vc = _rand(60 + d, dtype, dev, (b, 1, h, d), (b, 3, s, hkv, d),
                      (b, 3, s, hkv, d))
    k, v = kc[:, 1], vc[:, 1]
    rng = np.random.default_rng(b + 1)
    vl = rng.integers(2, s, b)
    vl[:3] = (0, 1, s)
    vl = torch.tensor(vl, dtype=torch.int32, device=dev)
    n = tda.launches["decode_attention_lse"]
    out, lse = tda.decode_attention_lse(q, k, v, vl)
    assert tda.launches["decode_attention_lse"] == n + 1
    assert torch.equal(out, tda.decode_attention(q, k, v, vl))
    _, want = tda.decode_attention_lse(q.float(), k.float(), v.float(), vl,
                                       impl="ref")
    empty = torch.isneginf(want)
    assert torch.equal(torch.isneginf(lse), empty)
    assert bool(empty[0].all()) and not bool(empty[1:].any())
    assert float((lse - want)[~empty].abs().max()) < 1e-4
