"""Plain PyTorch flash-decode — the oracle of the CUDA kernel
``csrc/decode_attention.cu`` and the version the wrapper runs on the CPU.

The counterpart of ``repro.kernels.decode_attention.ref``: one query row
per sequence against its KV cache, keys at or beyond the row's
``valid_len`` masked, softmax in float32.  ``valid_len == 0`` gives zeros,
as the Pallas kernel does (the JAX ref gives NaN there).
``decode_attention_lse_ref`` adds each row's logsumexp, -inf there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import masked_softmax_pv


def decode_attention_ref(q, k, v, valid_len):
    """q ``[B, 1, H, D]``; k, v ``[B, Sk, Hkv, D]`` (any strides);
    ``valid_len [B]`` -> ``[B, 1, H, D]`` in q's dtype."""
    b, _, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, d)
    kf = k.float().permute(0, 2, 1, 3)                   # [B, Hkv, Sk, D]
    vf = v.float().permute(0, 2, 1, 3)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / d ** 0.5)   # [B, Hkv, G, Sk]
    keep = torch.arange(sk, device=q.device)[None, :] \
        < valid_len.to(q.device)[:, None]
    out = masked_softmax_pv(s, keep[:, None, None, :], vf)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_lse_ref(q, k, v, valid_len):
    """``decode_attention_ref`` and each row's float32 logsumexp of its
    scaled scores over the valid keys, ``[B, H]`` (-inf with none)."""
    b, _, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, hkv, h // hkv, d)
    kf = k.float().permute(0, 2, 1, 3)
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / d ** 0.5)   # [B, Hkv, G, Sk]
    keep = torch.arange(sk, device=q.device)[None, :] \
        < valid_len.to(q.device)[:, None]
    lse = s.masked_fill(~keep[:, None, None, :], float("-inf")) \
        .logsumexp(-1).reshape(b, h)
    return decode_attention_ref(q, k, v, valid_len), lse
