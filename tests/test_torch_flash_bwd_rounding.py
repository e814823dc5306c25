"""The rounding of the bf16 flash backward (kernel B, the wgmma kernels of
``csrc/flash_attention_bwd.cu``) held on the CPU against the JAX package's
custom VJP ``_core_bwd``.

The bf16 kernels feed wgmma bf16 operands: they round P and dS to bf16
before the products dV = P^T dO, dK = dS^T Q and dQ = dS K, sum in float32
and round each gradient to bf16 once.  ``_core_bwd`` keeps P and dS in
float32.  ``_kernel_dataflow`` is a test-local model of the kernels'
dataflow in plain torch (float32 S and dP, P and dS rounded to bf16, float32
sums, dq / dk / dv rounded to bf16); it is held against ``_core_bwd`` run in
float32 on the same bf16-valued inputs (out rounded to bf16, as the forward
writes it), each gradient normwise (``max |got - want| / max |want|``)
within 2^-7, the limit ``chip_smoke.py``'s ``train-kernels`` and
``tests/test_torch_card_train.py`` hold the kernels to on the card.

Also: the bf16 backward's wrapper refuses head dims its kernels do not take
before any build or launch.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

GRAD_TOL = 2.0 ** -7

CASES = [   # b, sq, sk, h, hkv, d, causal, q_offset, cap
    (1, 256, 256, 9, 3, 64, True, 0, 0.0),     # smollm's heads, causal
    (1, 192, 192, 4, 4, 80, True, 0, 0.0),     # stablelm's head dim
    (2, 77, 90, 4, 2, 64, True, 5, 3.0),       # tails, q_offset, soft cap
]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_bwd(q, k, v, dout, causal, q_offset, cap):
    blk_q, blk_k = min(256, q.shape[1]), min(1024, k.shape[1])
    out, lse = JL._blocked_fwd(q, k, v, causal, q_offset, blk_q, blk_k, cap)
    out = out.astype(jnp.bfloat16).astype(jnp.float32)   # as kernel A writes
    grads = JL._core_bwd(causal, q_offset, blk_q, blk_k, cap,
                         (q, k, v, out, lse), dout)
    b, sq, h = q.shape[:3]
    return (out, lse.reshape(b, h, sq)) + tuple(grads)


def _kernel_dataflow(q, k, v, out, lse, dout, causal, q_offset, cap):
    """dq, dk, dv as the bf16 kernels compute them (float32 tensors holding
    bf16 values in, bf16 values out): lse ``[B, H, Sq]``."""
    b, sq, h, d = q.shape
    sk, hkv, dvd = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    kk, vv = k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    keep = torch.ones(sq, sk, dtype=torch.bool)
    if causal:
        keep = (torch.arange(sq)[:, None] + q_offset
                >= torch.arange(sk)[None, :])
    p = torch.exp(s - lse[..., None]) * keep
    dp = torch.einsum("bqhd,bkhd->bhqk", dout, vv)
    delta = (dout * out).sum(-1).permute(0, 2, 1)            # [B, H, Sq]
    ds = p * (dp - delta[..., None])
    if cap > 0.0:
        ds = ds * (1.0 - (s / cap) ** 2)
    pb, dsb = _bf16(p), _bf16(ds)                             # wgmma's A
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, dout)
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, q) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kk) * scale
    dk = dk.reshape(b, sk, hkv, g, d).sum(3)
    dv = dv.reshape(b, sk, hkv, g, dvd).sum(3)
    return _bf16(dq), _bf16(dk), _bf16(dv)


def normwise(got, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(
    map(str, c[:6])) + f"-off{c[7]}-cap{c[8]}")
def test_rounded_p_and_ds_stay_within_the_limit(case):
    b, sq, sk, h, hkv, d, causal, off, cap = case
    rng = np.random.default_rng(22)
    q, k, v, dout = (_bf16(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)))
        for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d),
                  (b, sq, h, d)))
    out, lse, *want = _jax_bwd(*(jnp.asarray(t.numpy())
                                 for t in (q, k, v, dout)), causal, off, cap)
    out, lse = (torch.from_numpy(np.array(t)) for t in (out, lse))
    got = _kernel_dataflow(q, k, v, out, lse, dout, causal, off, cap)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err = normwise(g, w)
        assert 0.0 < err <= GRAD_TOL, (name, err)


@pytest.mark.parametrize("dims", [(16, 16), (192, 128), (96, 96)])
def test_bf16_backward_refuses_other_head_dims(monkeypatch, dims):
    """The CUDA path (forced at the dispatch, CPU tensors) raises for a
    bf16 head-dim pair outside ``BWD_BF16_HEAD_DIMS`` before any build or
    launch; float32 takes any v head dim <= q/k head dim <= 128."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "resolve_impl", lambda impl, t: "cuda")
    d, dv = dims
    assert dims not in tfa.BWD_BF16_HEAD_DIMS
    z = lambda *s: torch.zeros(s, dtype=torch.bfloat16)  # noqa: E731
    q, k, v, out, dout = z(1, 8, 2, d), z(1, 8, 1, d), z(1, 8, 1, dv), \
        z(1, 8, 2, dv), z(1, 8, 2, dv)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    if d <= tfa.MAX_D:       # float32 passes the check, then needs a card
        with pytest.raises(Exception) as err:
            tfa.flash_attention_bwd(*(t.float() for t in (q, k, v, out)),
                                    lse, dout.float())
        assert "head dims" not in str(err.value)
