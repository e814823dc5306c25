"""Plain PyTorch WKV6 recurrence (RWKV-6 "Finch") — the oracle of the
CUDA kernels ``csrc/rwkv6_scan.cu`` and ``csrc/rwkv6_chunk.cu`` and the
version the wrapper runs on the CPU (``wkv6_ref``); beside it the chunked
arithmetic of ``rwkv6_chunk.cu`` in plain PyTorch (``wkv6_chunked_ref``),
which only the tests and ``chip_smoke.py`` use.

The counterpart of ``repro.kernels.rwkv6_scan.ref.wkv6_ref``.  Per head
with key/value width N and data-dependent per-channel decay w:

    y_t[i]   = sum_j r_t[j] * (S[j, i] + u[j] * k_t[j] * v_t[i])
    S[j, i] <- w_t[j] * S[j, i] + k_t[j] * v_t[i]

Shapes: r, k, v, w ``[B, T, H, N]``; u ``[H, N]``; state ``[B, H, N, N]``
(key x value).  ``w`` is the decay factor already in (0, 1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scan_chunks import (chunks, excl_cumsum,
                                            rev_excl_cumsum)


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



def wkv6_chunked_ref(r, k, v, w, u, state, chunk: int = 64, sub: int = 16):
    """The chunked form of ``csrc/rwkv6_chunk.cu`` in float32: chunks of
    ``chunk`` steps (the tail padded with r = k = v = 0, w = 1), each cut
    into sub-chunks of ``sub``.  With lw = log(max(w, 1e-38)), every
    exponent is a sum of lw between two positions, so it is <= 0, and no
    cumulative decay is divided by:

      y_t  = (r_t o exp(sum_{q0<=i<t} lw_i) o exp(sum_{i<q0} lw_i)) S
                                                              state term
           + sum_{s<q0} [(r_t o exp(sum_{q0<=i<t} lw_i)) .
                         (k_s o exp(sum_{s<i<q0} lw_i))] v_s   earlier sub-chunks
           + sum_{q0<=s<t} [sum_j r_t k_s prod_{s<i<t} w_i] v_s  own sub-chunk
           + (r_t . (u o k_t)) v_t                            bonus
      S   <- exp(sum_i lw_i) o S + sum_s (k_s o exp(sum_{i>s} lw_i))^T v_s

    (sums over one chunk; q0 is the start of t's sub-chunk; within a
    sub-chunk the decays are multiplied as the recurrence multiplies
    them).  Same arguments and results as ``wkv6_ref``."""
    b, t, h, n = r.shape
    if t == 0:
        return r.clone(), state.float().clone()
    tp = -(-t // chunk) * chunk
    rs, ks, vs = (chunks(z.float(), tp, chunk) for z in (r, k, v))
    ws = chunks(w.float(), tp, chunk, 1.0)                # [B, nc, L, H, N]
    lw = torch.log(torch.clamp(ws, min=1e-38))
    u_ = u.float()
    s = state.float()
    ys = []
    for c in range(tp // chunk):
        rc, kc, vc, wc, lc = (z[:, c] for z in (rs, ks, vs, ws, lw))
        cw = excl_cumsum(lc, 1)                            # [B, L, H, N]
        lq = excl_cumsum(lc.reshape(b, chunk // sub, sub, h, n), 2)
        rf = rc * torch.exp(lq.reshape(b, chunk, h, n))
        eq = torch.exp(cw[:, ::sub]).repeat_interleave(sub, 1)
        rdec = rf * eq
        att = rc.new_zeros(b, h, chunk, chunk)               # [B, H, t, s]
        for q0 in range(sub, chunk, sub):
            kf = kc[:, :q0] * torch.exp(rev_excl_cumsum(lc[:, :q0], 1))
            att[:, :, q0:q0 + sub, :q0] = torch.einsum(
                "bthj,bshj->bhts", rf[:, q0:q0 + sub], kf)
        for q0 in range(0, chunk, sub):
            for ti in range(q0 + 1, q0 + sub):
                d = torch.ones_like(wc[:, 0])                  # [B, H, N]
                for si in range(ti - 1, q0 - 1, -1):
                    att[:, :, ti, si] = (rc[:, ti] * kc[:, si] * d).sum(-1)
                    d = d * wc[:, si]
        bonus = (rc * u_ * kc).sum(-1, keepdim=True)         # [B, L, H, 1]
        ys.append(torch.einsum("bthj,bhji->bthi", rdec, s)
                  + torch.einsum("bhts,bshi->bthi", att, vc) + bonus * vc)
        kd = kc * torch.exp(rev_excl_cumsum(lc, 1))
        s = s * torch.exp(torch.cumsum(lc, 1)[:, -1])[..., None] \
            + torch.einsum("bshj,bshi->bhji", kd, vc)
    y = torch.cat(ys, 1)[:, :t]
    return y.to(r.dtype), s
