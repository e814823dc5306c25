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


# ---------------------------------------------------------------------------
# training: the blocked forward with its logsumexp and the flash backward,
# plain copies of ``repro.models.layers._blocked_fwd`` / ``_core_bwd``
# ---------------------------------------------------------------------------
def _fa_bias(qi, ki, blk_q, blk_k, sk, q_offset, causal, device):
    """Additive mask bias ``[blk_q, blk_k]`` float32: 0 keep, -1e30 drop
    (keys at or past ``sk``, and above the causal diagonal)."""
    kpos = ki * blk_k + torch.arange(blk_k, device=device)
    keep = (kpos[None, :] < sk).expand(blk_q, blk_k)
    if causal:
        qpos = qi * blk_q + torch.arange(blk_q, device=device) + q_offset
        keep = keep & (qpos[:, None] >= kpos[None, :])
    return torch.where(keep, 0.0, -1e30).float()


def _fa_scores(qb, kb, scale, cap):
    """``[B, blk_q, Hkv, g, D]`` x ``[B, blk_k, Hkv, D]`` -> scores
    ``[B, Hkv, g, blk_q, blk_k]`` float32 (exact products of the inputs,
    float32 sums), soft-capped."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float()) * scale
    if cap > 0.0:
        s = cap * torch.tanh(s / cap)
    return s


def _pad_rows(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n)) if n else x


def blocked_fwd_ref(q, k, v, *, causal: bool, q_offset: int = 0,
                    blk_q: int, blk_k: int, logits_soft_cap: float = 0.0,
                    seq_k_valid=None):
    """``_blocked_fwd``: (out ``[B, Sq, H, Dv]`` in q's dtype, lse ``[B, H,
    Sq]`` float32, the natural-log logsumexp of each row's scaled,
    soft-capped, masked scores).  Double-blocked online softmax with the
    additive -1e30 mask, p cast to v's dtype before PV; keys at or past
    ``seq_k_valid`` (default Sk) are padding."""
    b, sq, h, d = q.shape
    sk, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    seq_k = sk if seq_k_valid is None else int(seq_k_valid)
    scale = 1.0 / d ** 0.5
    pad_q, pad_k = (-sq) % blk_q, (-sk) % blk_k
    qp = _pad_rows(q, pad_q).reshape(b, -1, blk_q, hkv, g, d)
    kp = _pad_rows(k, pad_k).reshape(b, -1, blk_k, hkv, d)
    vp = _pad_rows(v, pad_k).reshape(b, -1, blk_k, hkv, dv)
    nq, nk = qp.shape[1], kp.shape[1]
    outs, lses = [], []
    for qi in range(nq):
        qb = qp[:, qi]
        m = torch.full((b, hkv, g, blk_q), -1e30, device=q.device)
        l = torch.zeros((b, hkv, g, blk_q), device=q.device)
        acc = torch.zeros((b, hkv, g, blk_q, dv), device=q.device)
        for ki in range(nk):
            kb, vb = kp[:, ki], vp[:, ki]
            s = _fa_scores(qb, kb, scale, logits_soft_cap) + _fa_bias(
                qi, ki, blk_q, blk_k, seq_k, q_offset, causal, q.device)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        outs.append((acc / l.clamp_min(1e-30)[..., None])
                    .permute(0, 3, 1, 2, 4).to(q.dtype))
        lses.append(m + torch.log(l.clamp_min(1e-30)))
    out = torch.cat(outs, 1).reshape(b, sq + pad_q, h, dv)[:, :sq]
    lse = torch.cat(lses, -1).reshape(b, h, sq + pad_q)[..., :sq]
    return out.contiguous(), lse.contiguous()


def blocked_bwd_ref(q, k, v, out, lse, dout, *, causal: bool,
                    q_offset: int = 0, blk_q: int, blk_k: int,
                    logits_soft_cap: float = 0.0, seq_k_valid=None):
    """``_core_bwd``: (dq, dk, dv) in the dtypes of q, k, v from the saved
    (q, k, v, out, lse ``[B, H, Sq]``) and ``dout``; p recomputed blockwise
    as ``exp(s - lse)``, ``ds = p (dp - delta)`` with ``delta = sum(dout *
    out)``, the soft cap's derivative ``1 - (s / cap)^2`` and the re-mask
    ``ds * (bias > -1)``; dk / dv summed in float32 over the query blocks
    and the group's query heads."""
    b, sq, h, d = q.shape
    sk, hkv, dv_ = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    seq_k = sk if seq_k_valid is None else int(seq_k_valid)
    cap = logits_soft_cap
    scale = 1.0 / d ** 0.5
    pad_q, pad_k = (-sq) % blk_q, (-sk) % blk_k
    qp = _pad_rows(q, pad_q).reshape(b, -1, blk_q, hkv, g, d)
    dop = _pad_rows(dout, pad_q).reshape(b, -1, blk_q, hkv, g, dv_)
    op = _pad_rows(out, pad_q)
    kp = _pad_rows(k, pad_k).reshape(b, -1, blk_k, hkv, d)
    vp = _pad_rows(v, pad_k).reshape(b, -1, blk_k, hkv, dv_)
    nq, nk = qp.shape[1], kp.shape[1]
    delta = (_pad_rows(dout, pad_q).float() * op.float()).sum(-1)
    delta = delta.reshape(b, nq, blk_q, hkv, g).permute(1, 0, 3, 4, 2)
    lse_b = torch.nn.functional.pad(lse, (0, pad_q)).reshape(
        b, hkv, g, nq, blk_q).permute(3, 0, 1, 2, 4)
    dk = torch.zeros((b, nk, blk_k, hkv, d), device=q.device)
    dv = torch.zeros((b, nk, blk_k, hkv, dv_), device=q.device)
    dqs = []
    for qi in range(nq):
        qb, dob = qp[:, qi], dop[:, qi]
        dq_b = torch.zeros((b, blk_q, hkv, g, d), device=q.device)
        for ki in range(nk):
            kb, vb = kp[:, ki], vp[:, ki]
            bias = _fa_bias(qi, ki, blk_q, blk_k, seq_k, q_offset, causal,
                            q.device)
            s = _fa_scores(qb, kb, scale, cap) + bias
            p = torch.exp(s - lse_b[qi][..., None])
            dv[:, ki] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob.float())
            dp = torch.einsum("bqhgd,bkhd->bhgqk", dob.float(), vb.float())
            ds = p * (dp - delta[qi][..., None])
            if cap > 0.0:
                ds = ds * (1.0 - torch.square((s - bias) / cap))
            ds = ds * (bias > -1.0)
            dq_b = dq_b + torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                       kb.float()) * scale
            dk[:, ki] += torch.einsum("bhgqk,bqhgd->bkhd", ds,
                                      qb.float()) * scale
        dqs.append(dq_b)
    dq = torch.stack(dqs, 1).reshape(b, sq + pad_q, h, d)[:, :sq]
    return (dq.to(q.dtype), dk.reshape(b, -1, hkv, d)[:, :sk].to(k.dtype),
            dv.reshape(b, -1, hkv, dv_)[:, :sk].to(v.dtype))
