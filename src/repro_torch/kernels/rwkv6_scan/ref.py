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


def _between(dtot, qa: int, qb: int):
    """prod_{qa < q < qb} dtot[..., q, :]: the decay across the whole
    sub-chunks strictly between sub-chunks qa and qb (qa may be -1, qb the
    sub-chunk count); ones when none lies between."""
    out = torch.ones_like(dtot[..., 0, :])
    for q in range(qa + 1, qb):
        out = out * dtot[..., q, :]
    return out


def wkv6_bwd_sub_ref(r, k, v, w, u, states, dy, dstate_out=None,
                     chunk: int = 64, sub: int = 16):
    """``wkv6_bwd_ref`` in the sub-chunk form of ``csrc/rwkv6_chunk_bwd.cu``
    (used by the tests only): each chunk cut into sub-chunks of ``sub``,
    every decay between two positions a product of running products that
    start or end at a sub-chunk boundary, each factor <= 1, none divided
    by.  Within a chunk, for sub-chunk q = [q0, q1) (per key channel j):

      DQ_t = prod_{q0<=i<t} w_i, DP_t = prod_{t<i<q1} w_i, T_q = DQ_{q1-1}
      w_{q1-1}; F(a, b) = prod_{a<q<b} T_q (F(-1, q) = D(0, q0), F(q, nq)
      = D(q1, L));  RQ = r o DQ, KQ = k o DP
      X = dY S0^T, Y = V dSL^T, P = dY V^T   (64 x 64 products)
      X'_t = F(-1, q) X_t + sum_{s<q0} P[t, s] KQ_s F(q(s), q)   = dy_t S_{q0}^T
      Y'_s = F(q, nq) Y_s + sum_{t>=q1} P[t, s] RQ_t F(q, q(t)) = v_s dS_{q1}^T
      alpha_q = <S_{q0}, dS_{q1}> summed over i, from F, X, Y and the
        products V_b[s] = sum_{t>=b} P[t, s] RQ_t F(b/sub - 1, q(t)), s < b
      dv   = (KQ o F(q(s), nq)) dSL + A^T dY + bonus o dY, A's cross-sub-chunk
             scores KQ_s F(q(s), q(t)) . RQ_t
      dS0  = D(0, L) o dSL + sum_t (RQ_t F(-1, q(t)))^T dy_t
    and inside each sub-chunk, per channel, the recurrences of one thread
    (M_t[t'] = sum_{q0<=s<t} D(s+1, t) k_s P[t', s]):
      dr_t = DQ_t X'_t + M_t[t] + u k_t P[t, t]
      dk_t = DP_t Y'_t + sum_{t<t'<q1} D(t+1, t') r_t' P[t', t] + r_t u P[t, t]
      dw_t = DQ_t DP_t alpha_q + DQ_t sum_{t<t'<q1} D(t+1, t') r_t' X'_t'
             + DP_t sum_{q0<=s<t} D(s+1, t) k_s Y'_s
             + sum_{t<t'<q1} D(t+1, t') r_t' M_t[t']
    (dw is sum_i dS_{t+1} o S_t with both states written from the boundary
    states S_{q0}, dS_{q1}).  Same arguments and results as
    ``wkv6_bwd_ref``."""
    b, t, h, n = r.shape
    f32 = torch.float32
    nq = chunk // sub
    tp = max(-(-t // chunk), 1) * chunk
    lay = lambda z: z.permute(0, 3, 1, 2, 4)          # noqa: E731
    rs, ks, vs, dys = (lay(chunks(z.float(), tp, chunk))
                       for z in (r, k, v, dy))         # [B, H, nc, L, N]
    ws = lay(chunks(w.float(), tp, chunk, 1.0))
    u_ = u.float()[None, :, None, :]                   # [1, H, 1, N]
    ds = (torch.zeros_like(states[0]) if dstate_out is None
          else dstate_out.float())
    idx = torch.arange(chunk, device=r.device)
    qof = idx // sub                                   # sub-chunk of t
    outs = {key: [] for key in ("dr", "dk", "dv", "dw")}
    du = torch.zeros(h, n, dtype=f32, device=r.device)
    for c in range(tp // chunk - 1, -1, -1):
        rc, kc, vc, wc, dyc = (z[:, :, c] for z in (rs, ks, vs, ws, dys))
        s0 = states[c].float()
        wq = wc.reshape(b, h, nq, sub, n)
        dq = _excl_cumprod(wq, 3)
        dp = torch.flip(_excl_cumprod(torch.flip(wq, [3]), 3), [3])
        dtot = dq[:, :, :, -1] * wq[:, :, :, -1]          # [B, H, nq, N]
        dq, dp = dq.reshape(b, h, chunk, n), dp.reshape(b, h, chunk, n)
        rq, kq = rc * dq, kc * dp

        def fq(qa, qb):
            return _between(dtot, qa, qb)[:, :, None]    # [B, H, 1, N]

        def rows(q):
            return slice(q * sub, (q + 1) * sub)

        pm = torch.einsum("bhti,bhsi->bhts", dyc, vc)
        x = torch.einsum("bhti,bhji->bhtj", dyc, s0)
        y = torch.einsum("bhsi,bhji->bhsj", vc, ds)
        xq, yq = torch.zeros_like(x), torch.zeros_like(y)
        vb = {}                      # V_b for b = 1 .. nq - 1, rows s < b sub
        for q in range(nq):
            acc = fq(-1, q) * x[:, :, rows(q)]
            for qa in range(q):
                acc = acc + torch.einsum(
                    "bhts,bhsj->bhtj", pm[:, :, rows(q), rows(qa)],
                    kq[:, :, rows(qa)] * fq(qa, q))
            xq[:, :, rows(q)] = acc
        for bq in range(1, nq):
            rb = torch.cat([rq[:, :, rows(qt)] * fq(bq - 1, qt)
                            for qt in range(bq, nq)], 2)
            vb[bq] = torch.einsum("bhts,bhtj->bhsj",
                                  pm[:, :, bq * sub:, :bq * sub], rb)
        for q in range(nq):
            own = vb[q + 1][:, :, rows(q)] if q + 1 < nq else 0.0
            yq[:, :, rows(q)] = fq(q, nq) * y[:, :, rows(q)] + own
        a = (s0 * ds).sum(-1)                              # [B, H, N]
        zx = [(rq * x)[:, :, rows(q)].sum(2) for q in range(nq)]
        uy = [(kq * y)[:, :, rows(q)].sum(2) for q in range(nq)]
        alpha = []
        for q in range(nq):
            f0, f4 = fq(-1, q)[:, :, 0], fq(q, nq)[:, :, 0]
            al = f0 * f4 * a
            for q2 in range(q + 1, nq):
                al = al + f0 * fq(q, q2)[:, :, 0] * zx[q2]
            for q2 in range(q):
                al = al + f4 * fq(q2, q)[:, :, 0] * uy[q2]
                if q + 1 < nq:
                    al = al + (kq[:, :, rows(q2)] * fq(q2, q)
                               * vb[q + 1][:, :, rows(q2)]).sum(2)
            alpha.append(al)
        # the scores A[t, s], s < t: across sub-chunks a product, inside one
        # a walk of running products
        att = rc.new_zeros(b, h, chunk, chunk)
        for qt in range(nq):
            for qs in range(qt):
                att[:, :, rows(qt), rows(qs)] = torch.einsum(
                    "bhtj,bhsj->bhts", rq[:, :, rows(qt)],
                    kq[:, :, rows(qs)] * fq(qs, qt))
            for ti in range(qt * sub + 1, (qt + 1) * sub):
                d = torch.ones_like(wc[:, :, 0])
                for si in range(ti - 1, qt * sub - 1, -1):
                    att[:, :, ti, si] = (rc[:, :, ti] * kc[:, :, si]
                                         * d).sum(-1)
                    d = d * wc[:, :, si]
        bonus = (rc * u_ * kc).sum(-1, keepdim=True)
        kd = torch.cat([kq[:, :, rows(q)] * fq(q, nq) for q in range(nq)], 2)
        outs["dv"].append(torch.einsum("bhsj,bhji->bhsi", kd, ds)
                          + torch.einsum("bhts,bhti->bhsi", att, dyc)
                          + bonus * dyc)
        # inside each sub-chunk: the recurrences of one thread per channel
        dr, dk, dw = (torch.zeros_like(rc) for _ in range(3))
        pd = torch.diagonal(pm, 0, 2, 3)[..., None]       # [B, H, L, 1]
        for q in range(nq):
            q0 = q * sub
            m = [torch.zeros_like(rc[:, :, 0]) for _ in range(sub)]
            dqt = torch.ones_like(rc[:, :, 0])
            gam = torch.zeros_like(rc[:, :, 0])
            for ta in range(sub):
                t_ = q0 + ta
                pr = torch.ones_like(dqt)
                qd, nn_, bw = (torch.zeros_like(dqt) for _ in range(3))
                for tb in range(ta + 1, sub):
                    p = pm[:, :, q0 + tb, t_, None]
                    rp = pr * rc[:, :, q0 + tb]
                    qd = qd + rp * m[tb]
                    nn_ = nn_ + rp * p
                    bw = bw + rp * xq[:, :, q0 + tb]
                    m[tb] = wc[:, :, t_] * m[tb] + kc[:, :, t_] * p
                    pr = pr * wc[:, :, q0 + tb]
                ppd = pd[:, :, t_]
                dr[:, :, t_] = dqt * xq[:, :, t_] + m[ta] \
                    + u_[:, :, 0] * kc[:, :, t_] * ppd
                dk[:, :, t_] = pr * yq[:, :, t_] + nn_ \
                    + rc[:, :, t_] * u_[:, :, 0] * ppd
                dw[:, :, t_] = dqt * pr * alpha[q] + dqt * bw \
                    + pr * gam + qd
                gam = wc[:, :, t_] * gam + kc[:, :, t_] * yq[:, :, t_]
                dqt = dqt * wc[:, :, t_]
        outs["dr"].append(dr)
        outs["dk"].append(dk)
        outs["dw"].append(dw)
        du = du + (rc * kc * pd).sum((0, 2))
        g = torch.einsum("bhtj,bhti->bhji",
                         torch.cat([rq[:, :, rows(q)] * fq(-1, q)
                                    for q in range(nq)], 2), dyc)
        ds = fq(-1, nq)[:, :, 0, :, None] * ds + g
    res = []
    for key in ("dr", "dk", "dv", "dw"):
        g = torch.stack(outs[key][::-1], 2)             # [B, H, nc, L, N]
        g = g.permute(0, 2, 3, 1, 4).reshape(b, tp, h, n)[:, :t]
        res.append(g if key == "dw" else g.to(r.dtype))
    return (*res, du.to(u.dtype), ds)
