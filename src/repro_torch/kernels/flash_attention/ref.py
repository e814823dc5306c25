"""Plain PyTorch flash-attention forward — the oracle of the CUDA kernel
``csrc/flash_attention.cu`` and the version the wrapper runs on the CPU.

The counterpart of ``repro.kernels.flash_attention.ref``, extended with the
knobs the kernel implements and the Pallas path drops: ``q_offset``
(query row i sits at key position ``i + q_offset``), ``logits_soft_cap``
(``cap * tanh(s / cap)``) and ``seq_k_valid`` (keys at or beyond it are
padding).  Scores and the softmax are float32; a query row with no key to
attend gives zeros, as the kernel's ``l`` floor does.

``rounded_p_limit`` is the per-element limit of a bf16 kernel that rounds
P to bf16 before PV (the Pallas kernel and the port's tensor-core kernel
both do), held against this plain version run in float32.
"""
from __future__ import annotations

import torch


def masked_softmax_pv(s, keep, v):
    """``softmax(s) @ v`` over the keys ``keep`` allows, in float32; rows
    with no allowed key give 0.  ``s`` / ``keep`` ``[..., q, k]``, ``v``
    ``[..., k, d]``."""
    m = s.masked_fill(~keep, float("-inf")).amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    out = p @ v
    return out / p.sum(-1, keepdim=True).clamp_min(1e-30)


def flash_attention_ref(q, k, v, *, causal: bool = True, q_offset: int = 0,
                        logits_soft_cap: float = 0.0, seq_k_valid=None):
    """q ``[B, Sq, H, D]``; k ``[B, Sk, Hkv, D]``; v ``[B, Sk, Hkv, Dv]``
    (GQA: head h reads kv head ``h // (H // Hkv)``; MLA: Dv may differ
    from D) -> ``[B, Sq, H, Dv]`` in q's dtype, scores scaled by
    ``1 / sqrt(D)``."""
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    qf = q.float().reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]       # [B, Hkv, 1, Sk, D]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / d ** 0.5)   # [B, Hkv, G, Sq, Sk]
    if logits_soft_cap > 0.0:
        s = logits_soft_cap * torch.tanh(s / logits_soft_cap)
    kpos = torch.arange(sk, device=q.device)
    keep = kpos[None, :] < (sk if seq_k_valid is None else seq_k_valid)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        keep = keep & (qpos >= kpos[None, :])
    else:
        keep = keep.expand(sq, sk)
    out = masked_softmax_pv(s, keep, vf)                 # [B, Hkv, G, Sq, Dv]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


BF16_U = 2.0 ** -8   # unit roundoff of bf16 (8 significant bits)


def rounded_p_limit(q, k, v, *, atol: float, **kw):
    """``(want, limit)`` for a bf16 output whose P is rounded to bf16
    before the product with V: ``want`` is this plain version on the
    inputs in float32, and per element

        limit = atol + 2^-8 |want| + 2^-8 M,   M = sum_j p_j |v_j| / l,

    M being this plain version run with |v|.  Each rounded p_j carries a
    relative error <= 2^-8, so P's rounding moves the output by at most
    2^-8 M; rounding the output to bf16 adds 2^-8 |want|; ``atol`` covers
    the order of the float32 sums.  ``kw`` as ``flash_attention_ref``."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = flash_attention_ref(qf, kf, vf, **kw)
    m = flash_attention_ref(qf, kf, vf.abs(), **kw)
    return want, atol + BF16_U * want.abs() + BF16_U * m
