"""Plain PyTorch WKV6 recurrence (RWKV-6 "Finch") — the oracle of the
CUDA kernel ``csrc/rwkv6_scan.cu`` and the version the wrapper runs on the
CPU.

The counterpart of ``repro.kernels.rwkv6_scan.ref.wkv6_ref``.  Per head
with key/value width N and data-dependent per-channel decay w:

    y_t[i]   = sum_j r_t[j] * (S[j, i] + u[j] * k_t[j] * v_t[i])
    S[j, i] <- w_t[j] * S[j, i] + k_t[j] * v_t[i]

Shapes: r, k, v, w ``[B, T, H, N]``; u ``[H, N]``; state ``[B, H, N, N]``
(key x value).  ``w`` is the decay factor already in (0, 1).
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, state):
    """Sequential time scan in float32.  Returns (y ``[B, T, H, N]`` in r's
    dtype, final state ``[B, H, N, N]`` float32)."""
    r_, k_, v_, w_ = (x.float() for x in (r, k, v, w))
    u_ = u.float()[None, :, :, None]
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k_[:, t, :, :, None] * v_[:, t, :, None, :]        # [B,H,N,N]
        ys.append(torch.einsum("bhj,bhji->bhi", r_[:, t], s + u_ * kv))
        s = s * w_[:, t, :, :, None] + kv
    y = torch.stack(ys, 1) if ys else r_.new_zeros(r.shape)
    return y.to(r.dtype), s
