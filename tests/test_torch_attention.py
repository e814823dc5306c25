"""Port parity of the attention kernels' plain versions (K4 flash attention,
K3 flash-decode) against the JAX package's Pallas kernels in interpret mode
and their jnp oracles, on the CPU (the CUDA kernels against these plain
versions on a card: ``test_torch_card_lm.py``).

Inputs come from numpy under a seed.  Tolerances: float32 1e-5 absolute
and relative (the orders of the sums differ); bfloat16 2e-2 (one bf16 ulp
of outputs of magnitude ~1, as ``tests/test_kernels.py`` uses), and the
per-element limit of a kernel that rounds P to bf16 before PV
(``ref.rounded_p_limit``), held here against the Pallas kernel, which
rounds P so.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as jda  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tda  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfr  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

F32 = dict(atol=1e-5, rtol=1e-5)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


# ---------------------------------------------------------------------------
# K4 flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal", [
    (2, 128, 128, 4, 2, 64, True),
    (1, 64, 64, 3, 3, 32, True),
    (2, 100, 100, 4, 1, 64, True),      # not a block multiple, GQA 4
    (1, 96, 160, 2, 2, 128, False),     # cross-length, non-causal
    (2, 45, 45, 6, 2, 16, True),        # GQA 3, ragged length
    (1, 37, 53, 3, 1, 32, False),
    (2, 70, 70, 4, 4, 20, True),        # D 20, not a power of two
    (3, 15, 15, 3, 1, 16, True),        # the smollm smoke prefill
])
def test_flash_plain_matches_pallas_and_ref(b, sq, sk, h, hkv, d, causal):
    q, k, v = _rand(0, (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))
    want_ker = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True, blk_q=64, blk_k=64))
    want_ref = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        use_ref=True))
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want_ker, **F32)
    np.testing.assert_allclose(got, want_ref, **F32)


def test_flash_plain_bf16_matches_ref():
    q, k, v = _rand(1, (2, 100, 4, 64), (2, 100, 2, 64), (2, 100, 2, 64))
    bf = jnp.bfloat16
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        causal=True, use_ref=True), np.float32)
    got = tfa.flash_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("q_offset,cap", [(0, 5.0), (9, 0.0), (17, 3.0)])
def test_flash_plain_q_offset_and_soft_cap_match_sdpa(q_offset, cap):
    """The knobs the Pallas path drops, against ``layers.sdpa`` of both
    packages (query rows sit at key positions ``i + q_offset``)."""
    sq, sk = 8, 8 + q_offset
    q, k, v = _rand(2, (2, sq, 4, 16), (2, sk, 2, 16), (2, sk, 2, 16))
    want = np.asarray(JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_offset=q_offset,
                              logits_soft_cap=cap))
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = tfa.flash_attention(tq, tk, tv, causal=True, q_offset=q_offset,
                              logits_soft_cap=cap).numpy()
    np.testing.assert_allclose(got, want, **F32)
    port_sdpa = TL.sdpa(tq, tk, tv, causal=True, q_offset=q_offset,
                        logits_soft_cap=cap).numpy()
    np.testing.assert_allclose(port_sdpa, want, **F32)


def test_flash_plain_masks_kv_padding_and_empty_rows():
    q, k, v = _rand(3, (1, 6, 2, 8), (1, 10, 2, 8), (1, 10, 2, 8))
    tq, tk, tv = _t(q), _t(k), _t(v)
    padded = tfa.flash_attention(tq, tk, tv, causal=False, seq_k_valid=7)
    cut = tfa.flash_attention(tq, tk[:, :7], tv[:, :7], causal=False)
    torch.testing.assert_close(padded, cut, rtol=1e-6, atol=1e-6)
    none = tfa.flash_attention(tq, tk, tv, causal=True, q_offset=-6)
    assert torch.equal(none[:, 0], torch.zeros_like(none[:, 0]))
    assert torch.isfinite(none).all()


def _limit_share(got, want, lim):
    return float(((got.float() - want).abs() / lim).max())


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal", [
    (2, 100, 100, 4, 2, 64, True),
    (1, 37, 90, 3, 1, 80, False),
    (1, 70, 70, 2, 2, 128, True),
    (2, 45, 45, 6, 2, 64, True),
])
def test_rounded_p_limit_holds_pallas_bf16_and_rejects_planted_fault(
        b, sq, sk, h, hkv, d, causal):
    """The Pallas kernel in interpret mode on bf16 inputs rounds P to bf16
    before PV: it sits inside ``rounded_p_limit`` of the plain version run
    in float32, while a fault planted in the same inputs (the diagonal one
    position late; non-causal, the last key dropped) reads above it."""
    q, k, v = _rand(10 + d, (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))
    bf = jnp.bfloat16
    got = np.asarray(jfa.flash_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
        causal=causal, interpret=True, blk_q=64, blk_k=64), np.float32)
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    want, lim = tfr.rounded_p_limit(tq, tk, tv, atol=1e-5, causal=causal)
    assert want.dtype == torch.float32 and want.shape == (b, sq, h, d)
    assert _limit_share(torch.from_numpy(got), want, lim) <= 1.0
    # P kept in float32 (the plain version in bf16) sits inside it too
    assert _limit_share(tfa.flash_attention(tq, tk, tv, causal=causal),
                        want, lim) <= 1.0
    if causal:
        planted = tfa.flash_attention(tq, tk, tv, causal=True, q_offset=1)
    else:
        planted = torch.from_numpy(np.asarray(jfa.flash_attention(
            jnp.asarray(q, bf), jnp.asarray(k[:, :-1], bf),
            jnp.asarray(v[:, :-1], bf), causal=False, interpret=True,
            blk_q=64, blk_k=64), np.float32))
    assert _limit_share(planted, want, lim) > 1.0


def test_rounded_p_limit_is_the_derived_bound():
    """limit = atol + 2^-8 |want| + 2^-8 M, with M the plain version run on
    |v|: checked element by element on the formula's own terms."""
    q, k, v = (_t(x) for x in _rand(11, (1, 9, 2, 16), (1, 9, 1, 16),
                                    (1, 9, 1, 16)))
    want, lim = tfr.rounded_p_limit(q, k, v, atol=1e-5, causal=True)
    m = tfa.flash_attention(q, k, v.abs(), causal=True)
    assert torch.equal(want, tfa.flash_attention(q, k, v, causal=True))
    torch.testing.assert_close(lim, 1e-5 + 2.0 ** -8 * (want.abs() + m),
                               rtol=1e-6, atol=0)
    assert bool((m >= want.abs() - 1e-6).all())


@pytest.mark.parametrize("d,dv", [(16, 16), (32, 32), (96, 96), (192, 192),
                                  (128, 64), (64, 128)])
def test_flash_bf16_kernel_wrapper_rejects_head_dims_it_does_not_take(d, dv):
    """The tensor-core kernel takes (q/k, v) head dims (64, 64), (80, 80),
    (128, 128) and MLA's (192, 128); the wrapper raises for any other pair
    before it builds or launches anything."""
    q = torch.zeros(1, 4, 2, d, dtype=torch.bfloat16)
    v = torch.zeros(1, 4, 2, dv, dtype=torch.bfloat16)
    before = dict(tfa.launches)
    with pytest.raises(ValueError, match="head dim"):
        tfa.launch(q, q, v, torch.empty_like(v), causal=True, q_offset=0,
                   logits_soft_cap=0.0, seq_k_valid=4)
    assert tfa.launches == before


def test_flash_f32_kernel_wrapper_rejects_v_wider_than_qk():
    q = torch.zeros(1, 4, 2, 16)
    v = torch.zeros(1, 4, 2, 24)
    with pytest.raises(ValueError, match="head dim"):
        tfa.launch(q, q, v, torch.empty_like(v), causal=True, q_offset=0,
                   logits_soft_cap=0.0, seq_k_valid=4)


# ---------------------------------------------------------------------------
# K4 at MLA's shape: v head dim below q/k's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,s,h,hkv,d,dv,causal,cap", [
    (2, 15, 4, 4, 24, 16, True, 0.0),     # deepseek-v2-lite smoke prefill
    (1, 70, 4, 4, 192, 128, True, 0.0),   # deepseek-v2-lite heads
    (2, 33, 4, 2, 40, 24, False, 0.0),
    (1, 20, 4, 4, 24, 16, True, 30.0),
])
def test_flash_plain_takes_mla_value_head_dim(b, s, h, hkv, d, dv, causal,
                                              cap):
    """The plain K4 at q/k head dim D and v head dim Dv < D, scaled by
    1/sqrt(D), against the JAX package's ``sdpa``, ``blocked_attention``
    (which takes Dv != D) and its ``attention`` dispatch; the port's
    ``attention`` sends the same call to K4."""
    q, k, v = _rand(20 + d, (b, s, h, d), (b, s, hkv, d), (b, s, hkv, dv))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = np.asarray(JL.sdpa(jq, jk, jv, causal=causal,
                              logits_soft_cap=cap))
    assert want.shape == (b, s, h, dv)
    np.testing.assert_allclose(
        np.asarray(JL.blocked_attention(jq, jk, jv, causal=causal, blk_q=16,
                                        blk_k=16, logits_soft_cap=cap)),
        want, **F32)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              logits_soft_cap=cap)
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(
        TL.sdpa(_t(q), _t(k), _t(v), causal=causal,
                logits_soft_cap=cap).numpy(), want, **F32)
    cfg = TL.ModelConfig(name="t", family="moe", n_layers=1, d_model=64,
                         n_heads=h, d_ff=0, vocab_size=8, dtype="float32")
    jcfg = JL.ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "family", "n_layers", "d_model", "n_heads", "d_ff",
        "vocab_size", "dtype")})
    n = dict(tfa.launches)
    np.testing.assert_allclose(
        TL.attention(cfg, _t(q), _t(k), _t(v), causal=causal,
                     logits_soft_cap=cap).numpy(),
        np.asarray(JL.attention(jcfg, jq, jk, jv, causal=causal,
                                logits_soft_cap=cap)), **F32)
    assert tfa.launches == n              # the plain version on the CPU


def test_flash_plain_bf16_mla_within_rounded_p_limit():
    """bf16 at deepseek-v2-lite's heads (192 / 128): the plain version in
    bf16 and the JAX ``sdpa`` in bf16 (P rounded to bf16, as the
    tensor-core kernel rounds it) both sit inside ``rounded_p_limit``."""
    q, k, v = _rand(30, (1, 50, 4, 192), (1, 50, 4, 192), (1, 50, 4, 128))
    tq, tk, tv = (_t(x, torch.bfloat16) for x in (q, k, v))
    want, lim = tfr.rounded_p_limit(tq, tk, tv, atol=1e-5, causal=True)
    assert want.shape == (1, 50, 4, 128)
    assert _limit_share(tfa.flash_attention(tq, tk, tv, causal=True), want,
                        lim) <= 1.0
    bf = jnp.bfloat16
    jax_bf16 = np.asarray(JL.sdpa(jnp.asarray(q, bf), jnp.asarray(k, bf),
                                  jnp.asarray(v, bf), causal=True),
                          np.float32)
    assert _limit_share(torch.from_numpy(jax_bf16), want, lim) <= 1.0


# ---------------------------------------------------------------------------
# K3 flash-decode
# ---------------------------------------------------------------------------
def _decode_pair(q, k, v, vl):
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl))
    want_ker = np.asarray(jda.decode_attention(*args, interpret=True,
                                               blk_k=128))
    want_ref = np.asarray(jda.decode_attention(*args, use_ref=True))
    got = tda.decode_attention(_t(q), _t(k), _t(v),
                               torch.from_numpy(vl)).numpy()
    np.testing.assert_allclose(got, want_ker, **F32)
    np.testing.assert_allclose(got, want_ref, **F32)


@pytest.mark.parametrize("b,sk,h,hkv,d", [
    (2, 256, 4, 2, 64), (3, 1000, 4, 4, 32), (1, 512, 8, 1, 128),
    (4, 28, 4, 2, 8), (2, 44, 4, 2, 16), (3, 27, 3, 1, 32),
])
def test_decode_plain_matches_pallas_and_ref(b, sk, h, hkv, d):
    q, k, v = _rand(4, (b, 1, h, d), (b, sk, hkv, d), (b, sk, hkv, d))
    ragged = np.random.default_rng(5).integers(1, sk + 1, b).astype(np.int32)
    for vl in (ragged, np.linspace(1, sk, b).astype(np.int32),
               np.full(b, 1, np.int32), np.full(b, sk, np.int32)):
        _decode_pair(q, k, v, vl)


def test_decode_plain_reads_strided_layer_slices_and_zero_length():
    """One layer of a batched cache ``[B, L, S, Hkv, D]`` read in place
    equals the same slice copied; ``valid_len == 0`` gives zeros."""
    q, kc, vc = _rand(6, (3, 1, 4, 16), (3, 5, 20, 2, 16), (3, 5, 20, 2, 16))
    vl = torch.tensor([0, 7, 20], dtype=torch.int32)
    tq, tk, tv = _t(q), _t(kc)[:, 2], _t(vc)[:, 2]
    assert not tk.is_contiguous()
    got = tda.decode_attention(tq, tk, tv, vl)
    want = tda.decode_attention(tq, tk.contiguous(), tv.contiguous(), vl)
    assert torch.equal(got, want)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _decode_pair(q, kc[:, 2], vc[:, 2], np.array([1, 7, 20], np.int32))


def test_wrappers_raise_for_cuda_on_cpu_and_count_no_plain_launch():
    q, k, v = (_t(x) for x in _rand(7, (1, 4, 2, 8), (1, 4, 2, 8),
                                    (1, 4, 2, 8)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tda.decode_attention(q[:, :1], k, v, torch.ones(1, dtype=torch.int32),
                             impl="cuda")
    before = (dict(tfa.launches), dict(tda.launches))
    tfa.flash_attention(q, k, v)
    tda.decode_attention(q[:, :1], k, v, torch.ones(1, dtype=torch.int32))
    assert (tfa.launches, tda.launches) == before



@pytest.mark.parametrize("ctas,sk,want", [
    (768, 276, 1),      # smollm-135m decode: 256 sequences x 3 kv heads
    (512, 512, 1),      # zamba2-1.2b decode: 16 slots x 32 kv heads
    (8, 700, 5),        # short batch: splits of >= 128 keys
    (3, 300, 2),
    (15, 40, 1),        # too few keys to split
    (100, 100000, 3),   # two blocks per SM: 264 / 100 rounded up
])
def test_decode_split_count(ctas, sk, want):
    assert tda.split_count(ctas, sk) == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 12),
                                     (torch.float32, 6),
                                     (torch.bfloat16, 136)])
def test_decode_kernel_wrapper_rejects_rows_it_does_not_take(dtype, d):
    """Rows of D * sizeof(T) bytes must be a multiple of 16 and D <= 128;
    the wrapper raises before it builds or launches anything."""
    q = torch.zeros(2, 1, 2, d, dtype=dtype)
    kv = torch.zeros(2, 5, 1, d, dtype=dtype)
    before = dict(tda.launches)
    with pytest.raises(ValueError, match="multiple of 16"):
        tda.launch(q, kv, kv, torch.ones(2, dtype=torch.int32),
                   torch.empty_like(q))
    assert tda.launches == before
