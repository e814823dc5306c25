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


def wkv6_fwd_ref(r, k, v, w, u, state, chunk: int = 64):
    """``wkv6_ref`` that also keeps the state entering every chunk of
    ``chunk`` steps: (y, final state, states ``[nc, B, H, N, N]`` float32,
    ``states[0]`` the input state) -- what the training forward saves for
    ``wkv6_bwd_ref`` / ``csrc/rwkv6_chunk_bwd.cu``."""
    r_, k_, v_, w_ = (x.float() for x in (r, k, v, w))
    u_ = u.float()[None, :, :, None]
    s = state.float()
    ys, kept = [], []
    for t in range(r.shape[1]):
        if t % chunk == 0:
            kept.append(s)
        kv = k_[:, t, :, :, None] * v_[:, t, :, None, :]
        ys.append(torch.einsum("bhj,bhji->bhi", r_[:, t], s + u_ * kv))
        s = s * w_[:, t, :, :, None] + kv
    y = torch.stack(ys, 1) if ys else r_.new_zeros(r.shape)
    states = torch.stack(kept) if kept else s.new_zeros((0,) + s.shape)
    return y.to(r.dtype), s, states


def _excl_cumprod(z, dim: int):
    """``out[t] = prod_{i < t} z[i]`` along ``dim``: products, no
    division."""
    inc = torch.cumprod(z, dim)
    return torch.cat([torch.ones_like(z.narrow(dim, 0, 1)),
                      inc.narrow(dim, 0, z.shape[dim] - 1)], dim)


def wkv6_bwd_ref(r, k, v, w, u, states, dy, dstate_out=None,
                 chunk: int = 64):
    """The WKV6 backward in plain PyTorch, in the dataflow of
    ``csrc/rwkv6_chunk_bwd.cu``: a reverse scan over chunks of ``chunk``
    steps (the tail padded with r = k = v = dy = 0, w = 1) carrying the
    state gradient dS from chunk c + 1 to c, each chunk recomputed from its
    entering state ``states[c]`` (``wkv6_fwd_ref``'s third result).

    Within a chunk (t, s local; S0 entering state, dSL the gradient of the
    leaving one), with D(a, b) = prod_{a <= i < b} w_i per key channel j --
    running products of w, so every factor is <= 1 and no decay is
    divided by -- and Dsp[t, s] = D(s + 1, t) for s < t:

      P = dY V^T, X = dY S0^T, Y = V dSL^T                  (64 x 64 each)
      dS0  = D(0, L) o dSL + sum_t (r_t o D(0, t))^T dy_t
      A[t, s] = sum_j r_t k_s Dsp[t, s]                     (the scores)
      dv_s = (k_s o D(s+1, L)) dSL + sum_{t>s} A[t, s] dy_t + b_s dy_s
      dr_t = D(0, t) o X_t + sum_{s<t} P[t, s] k_s o Dsp[t, s] + u o k_t P[t, t]
      dk_s = D(s+1, L) o Y_s + sum_{t>s} P[t, s] r_t o Dsp[t, s] + r_s o u P[s, s]
      dw_t = sum_i dS_{t+1}[:, i] S_t[:, i]
           = D(0, t) D(t+1, L) o a + D(0, t) o Z_t + D(t+1, L) o U_t + Q_t
        a = sum_i S0 o dSL, Z_t = sum_{t'>t} Dsp[t', t] r_t' o X_t',
        U_t = sum_{s<t} Dsp[t, s] k_s o Y_s,
        Q_t = sum_{s<t<t'} Dsp[t, s] Dsp[t', t] r_t' o k_s P[t', s]
      du   = sum_t r_t o k_t P[t, t]

    (b_s = r_s . (u o k_s)).  dw is formed without dividing by w, so it
    stays finite where w is down at 1e-38.  Returns (dr, dk, dv in r's
    dtype, dw float32, du in u's dtype, dstate float32)."""
    b, t, h, n = r.shape
    f32 = torch.float32
    tp = max(-(-t // chunk), 1) * chunk
    lay = lambda z: z.permute(0, 3, 1, 2, 4)          # noqa: E731
    rs, ks, vs, dys = (lay(chunks(z.float(), tp, chunk))
                       for z in (r, k, v, dy))         # [B, H, nc, L, N]
    ws = lay(chunks(w.float(), tp, chunk, 1.0))
    u_ = u.float()[None, :, None, :]                   # [1, H, 1, N]
    ds = (torch.zeros_like(states[0]) if dstate_out is None
          else dstate_out.float())
    lo = torch.ones(chunk, chunk, dtype=torch.bool,
                    device=r.device).tril(-1)          # [t, s]: s < t
    outs = {key: [] for key in ("dr", "dk", "dv", "dw")}
    du = torch.zeros(h, n, dtype=f32, device=r.device)
    for c in range(tp // chunk - 1, -1, -1):
        rc, kc, vc, wc, dyc = (z[:, :, c] for z in (rs, ks, vs, ws, dys))
        s0 = states[c].float()
        # Dsp[t, s] = prod_{s < i < t} w_i: for each s a running product
        # over i of (w_i if i > s else 1), read one step late
        idx = torch.arange(chunk, device=r.device)
        fac = torch.where((idx[None, :] > idx[:, None])[None, None, :, :,
                                                        None],
                          wc[:, :, None], torch.ones((), device=r.device))
        dsp = _excl_cumprod(fac, 3).transpose(2, 3)    # [B, H, t, s, N]
        dsp = dsp * lo[None, None, :, :, None]
        dpre = _excl_cumprod(wc, 2)
        dpost = torch.flip(_excl_cumprod(torch.flip(wc, [2]), 2), [2])
        etot = dpre[:, :, -1] * wc[:, :, -1]
        pm = torch.einsum("bhti,bhsi->bhts", dyc, vc)
        x = torch.einsum("bhti,bhji->bhtj", dyc, s0)
        y = torch.einsum("bhsi,bhji->bhsj", vc, ds)
        pd = torch.diagonal(pm, 0, 2, 3)[..., None]    # [B, H, L, 1]
        bonus = (rc * u_ * kc).sum(-1, keepdim=True)
        att = torch.einsum("bhtj,bhsj,bhtsj->bhts", rc, kc, dsp)
        outs["dv"].append(
            torch.einsum("bhsj,bhji->bhsi", kc * dpost, ds)
            + torch.einsum("bhts,bhti->bhsi", att, dyc) + bonus * dyc)
        outs["dr"].append(dpre * x
                          + torch.einsum("bhts,bhsj,bhtsj->bhtj", pm, kc, dsp)
                          + u_ * kc * pd)
        outs["dk"].append(dpost * y
                          + torch.einsum("bhts,bhtj,bhtsj->bhsj", pm, rc, dsp)
                          + rc * u_ * pd)
        a = (s0 * ds).sum(-1)[:, :, None]               # [B, H, 1, N]
        z = torch.einsum("bhutj,bhuj,bhuj->bhtj", dsp, rc, x)
        uu = torch.einsum("bhtsj,bhsj,bhsj->bhtj", dsp, kc, y)
        m = torch.einsum("bhtsj,bhsj,bhus->bhtuj", dsp, kc, pm)
        q = torch.einsum("bhutj,bhuj,bhtuj->bhtj", dsp, rc, m)
        outs["dw"].append(dpre * dpost * a + dpre * z + dpost * uu + q)
        du = du + (rc * kc * pd).sum((0, 2))
        ds = etot[..., None] * ds + torch.einsum("bhtj,bhti->bhji",
                                                 rc * dpre, dyc)
    res = []
    for key in ("dr", "dk", "dv", "dw"):
        g = torch.stack(outs[key][::-1], 2)             # [B, H, nc, L, N]
        g = g.permute(0, 2, 3, 1, 4).reshape(b, tp, h, n)[:, :t]
        res.append(g if key == "dw" else g.to(r.dtype))
    return (*res, du.to(u.dtype), ds)
