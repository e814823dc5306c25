"""Plain PyTorch Mamba-2 SSD recurrence — the oracle of the CUDA kernels
``csrc/ssm_scan.cu`` and ``csrc/ssm_chunk.cu`` and the version the wrapper
runs on the CPU (``ssd_ref``); beside it the chunked arithmetic of
``ssm_chunk.cu`` in plain PyTorch (``ssd_chunked_ref``), which only the
tests and ``chip_smoke.py`` use.

The counterpart of ``repro.kernels.ssm_scan.ref.ssd_ref``.  Per head with
head dim P and state dim N:

    a_t = exp(dt_t * A)                     (A < 0, one scalar per head)
    S_t = a_t * S_{t-1} + dt_t * x_t B_t^T  (S in R^{P x N})
    y_t = S_t C_t + D * x_t

Shapes: x ``[B, T, H, P]``; dt ``[B, T, H]``; A, D ``[H]``; Bm, Cm ``[B, T,
N]`` (one group, shared by the heads); state ``[B, H, P, N]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.scan_chunks import chunks, rev_excl_cumsum


def ssd_ref(x, dt, A, Bm, Cm, D, state):
    """Sequential time scan in float32.  Returns (y ``[B, T, H, P]`` in x's
    dtype, final state ``[B, H, P, N]`` float32)."""
    x_, dt_, b_, c_ = (t.float() for t in (x, dt, Bm, Cm))
    a_, d_ = A.float(), D.float()
    s = state.float()
    ys = []
    for t in range(x.shape[1]):
        a_t = torch.exp(dt_[:, t] * a_)                          # [B, H]
        upd = (dt_[:, t, :, None] * x_[:, t])[..., :, None] \
            * b_[:, t, None, None, :]
        s = s * a_t[..., None, None] + upd                       # [B,H,P,N]
        ys.append(torch.einsum("bhpn,bn->bhp", s, c_[:, t])
                  + d_[None, :, None] * x_[:, t])
    y = torch.stack(ys, 1) if ys else x_.new_zeros(x.shape)
    return y.to(x.dtype), s



def ssd_chunked_ref(x, dt, A, Bm, Cm, D, state, chunk: int = 64):
    """The chunked form of ``csrc/ssm_chunk.cu`` in float32: chunks of
    ``chunk`` steps (the tail zero-padded: dt 0 keeps the state), per chunk

        cum_t = sum_{i <= t} dt_i A        rev_s = sum_{i > s} dt_i A
        y_t   = exp(cum_t) C_t S^T + sum_{s <= t} (C_t . B_s)
                exp(cum_t - cum_s) dt_s x_s + D x_t
        S    <- exp(cum_last) S + sum_s dt_s exp(rev_s) x_s B_s^T

    with the mask applied before ``exp``.  Same arguments and results as
    ``ssd_ref``; the tests and the card's checks hold it against that."""
    b, t, h, p = x.shape
    if t == 0:
        return x.clone(), state.float().clone()
    tp = -(-t // chunk) * chunk
    xs, dts = chunks(x.float(), tp, chunk), chunks(dt.float(), tp, chunk)
    bs, cs = chunks(Bm.float(), tp, chunk), chunks(Cm.float(), tp, chunk)
    la = dts * A.float()                                   # [B, nc, L, H]
    cum = torch.cumsum(la, 2)
    rev = rev_excl_cumsum(la, 2)
    tril = torch.ones(chunk, chunk, dtype=torch.bool).tril().to(x.device)
    s = state.float()
    ys = []
    for c in range(tp // chunk):
        seg = cum[:, c, :, None] - cum[:, c, None]          # [B, t, s, H]
        dec = torch.where(tril[None, :, :, None],
                          torch.exp(torch.where(tril[None, :, :, None], seg,
                                                torch.zeros_like(seg))),
                          torch.zeros_like(seg))
        g = torch.einsum("btn,bsn->bts", cs[:, c], bs[:, c])
        m = g[..., None] * dec * dts[:, c, None]            # [B, t, s, H]
        y = torch.einsum("btsh,bshp->bthp", m, xs[:, c]) \
            + torch.einsum("btn,bhpn->bthp", cs[:, c], s) \
            * torch.exp(cum[:, c])[..., None] \
            + D.float()[None, None, :, None] * xs[:, c]
        ys.append(y)
        bw = (dts[:, c] * torch.exp(rev[:, c]))[..., None] \
            * bs[:, c, :, None, :]                          # [B, s, H, N]
        s = s * torch.exp(cum[:, c, -1])[..., None, None] \
            + torch.einsum("bshp,bshn->bhpn", xs[:, c], bw)
    y = torch.cat(ys, 1)[:, :t]
    return y.to(x.dtype), s


def ssd_fwd_ref(x, dt, A, Bm, Cm, D, state, chunk: int = 64):
    """``ssd_ref`` that also keeps the state entering every chunk of
    ``chunk`` steps: (y, final state, states ``[nc, B, H, P, N]`` float32,
    ``states[0]`` the input state) -- what the training forward saves for
    ``ssd_bwd_ref`` / ``csrc/ssm_chunk_bwd.cu``."""
    x_, dt_, b_, c_ = (t.float() for t in (x, dt, Bm, Cm))
    a_, d_ = A.float(), D.float()
    s = state.float()
    ys, kept = [], []
    for t in range(x.shape[1]):
        if t % chunk == 0:
            kept.append(s)
        a_t = torch.exp(dt_[:, t] * a_)
        upd = (dt_[:, t, :, None] * x_[:, t])[..., :, None] \
            * b_[:, t, None, None, :]
        s = s * a_t[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, c_[:, t])
                  + d_[None, :, None] * x_[:, t])
    y = torch.stack(ys, 1) if ys else x_.new_zeros(x.shape)
    states = torch.stack(kept) if kept else s.new_zeros((0,) + s.shape)
    return y.to(x.dtype), s, states


def ssd_bwd_ref(x, dt, A, Bm, Cm, D, states, dy, dstate_out=None,
                chunk: int = 64):
    """The SSD backward in plain PyTorch, in the dataflow of
    ``csrc/ssm_chunk_bwd.cu``: a reverse scan over chunks of ``chunk``
    steps (the tail zero-padded) carrying the state gradient G from chunk
    c + 1 to c, each chunk from its entering state ``states[c]``
    (``ssd_fwd_ref``'s third result).  Per chunk, with cum_t = sum_{i<=t}
    dt_i A, E[t, s] = exp(cum_t - cum_s) for s <= t (masked before exp),
    e1_t = exp(sum_{i>t} dt_i A), G the gradient of the leaving state:

      GB_t  = e1_t G B_t + sum_{t'>=t} (C_t' . B_t) E[t', t] dy_t'
      dx_t  = dt_t GB_t + D dy_t
      dB_t  = sum_h dt_t (e1_t x_t^T G + sum_{t'>=t} (dy_t' . x_t) E[t', t] C_t')
      dC_t  = sum_h (exp(cum_t) dy_t^T S0 + sum_{s<=t} (dy_t . x_s) E[t, s]
                     dt_s B_s)
      G_in  = exp(cum_last) G + sum_t exp(cum_t) dy_t C_t^T
    and the decay's gradient through cum: with Q[t, s] = E[t, s] dt_s
    (C_t . B_s)(dy_t . x_s),
      dcum_m = exp(cum_m) dy_m . (S0 C_m) + sum_s Q[m, s] - sum_t Q[t, m]
               - e1_m dt_m x_m^T G B_m + [m = last] <G, S_leaving>,
      dla_t  = sum_{m>=t} dcum_m,  ddt_t = x_t . GB_t + A dla_t,
      dA     = sum dt_t dla_t,     dD = sum dy_t . x_t.
    Returns (dx in x's dtype, ddt float32, dA, dBm, dCm in their dtypes,
    dD, dstate float32)."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    tp = max(-(-t // chunk), 1) * chunk
    xs, dys = chunks(x.float(), tp, chunk), chunks(dy.float(), tp, chunk)
    dts = chunks(dt.float(), tp, chunk)                  # [B, nc, L, H]
    bs, cs = chunks(Bm.float(), tp, chunk), chunks(Cm.float(), tp, chunk)
    a_, d_ = A.float(), D.float()
    g = (torch.zeros_like(states[0]) if dstate_out is None
         else dstate_out.float())
    tril = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    outs = {key: [] for key in ("dx", "ddt", "dB", "dC")}
    da = torch.zeros(h, dtype=torch.float32, device=x.device)
    dd = torch.zeros(h, dtype=torch.float32, device=x.device)
    for c in range(tp // chunk - 1, -1, -1):
        xc, dyc, dtc, bc, cc = (z[:, c] for z in (xs, dys, dts, bs, cs))
        s0 = states[c].float()
        la = dtc * a_                                    # [B, L, H]
        cum = torch.cumsum(la, 1)
        e1 = torch.exp(rev_excl_cumsum(la, 1))
        ecum = torch.exp(cum)
        seg = cum[:, :, None] - cum[:, None]              # [B, t, s, H]
        e = torch.where(tril, torch.exp(torch.where(tril, seg,
                                                    torch.zeros_like(seg))),
                        torch.zeros_like(seg))
        cb = torch.einsum("btn,bsn->bts", cc, bc)
        dxm = torch.einsum("bthp,bshp->btsh", dyc, xc)    # dy_t . x_s
        dys0 = torch.einsum("bthp,bhpn->bthn", dyc, s0)
        xg = torch.einsum("bthp,bhpn->bthn", xc, g)
        gb = e1[..., None] * torch.einsum("btn,bhpn->bthp", bc, g) \
            + torch.einsum("buth,buhp->bthp", cb[..., None] * e, dyc)
        outs["dx"].append(dtc[..., None] * gb + d_[:, None] * dyc)
        outs["dB"].append((dtc[..., None] * (
            e1[..., None] * xg
            + torch.einsum("buth,bun->bthn", dxm * e, cc))).sum(2))
        outs["dC"].append((ecum[..., None] * dys0 + torch.einsum(
            "btsh,bsh,bsn->bthn", dxm * e, dtc, bc)).sum(2))
        q = e * dtc[:, None] * cb[..., None] * dxm        # [B, t, s, H]
        xgb = (xg * bc[:, :, None]).sum(-1)               # x_m^T G B_m
        dcum = ecum * (dys0 * cc[:, :, None]).sum(-1) + q.sum(2) \
            - q.sum(1) - e1 * dtc * xgb
        s_leave = torch.exp(cum[:, -1])[..., None, None] * s0 \
            + torch.einsum("bsh,bshp,bsn->bhpn", e1 * dtc, xc, bc)
        dcum[:, -1] += (g * s_leave).sum((-2, -1))
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        outs["ddt"].append((xc * gb).sum(-1) + a_ * dla)
        da = da + (dtc * dla).sum((0, 1))
        dd = dd + (dyc * xc).sum((0, 1, 3))
        g = torch.exp(cum[:, -1])[..., None, None] * g \
            + torch.einsum("bth,bthp,btn->bhpn", ecum, dyc, cc)
    res = {key: torch.cat(v[::-1], 1)[:, :t] for key, v in outs.items()}
    return (res["dx"].to(x.dtype), res["ddt"], da.to(A.dtype),
            res["dB"].to(Bm.dtype), res["dC"].to(Cm.dtype), dd.to(D.dtype), g)


def ssd_bwd_grouped_ref(x, dt, A, Bm, Cm, D, states, dy, dstate_out=None,
                        group: int = 1, chunk: int = 64):
    """``ssd_bwd_ref`` in the dataflow of ``csrc/ssm_chunk_bwd.cu`` (used by
    the tests only): the decay matrix E[t, s] = exp(cum_t - cum_s) (s <= t,
    masked before exp) taken once per (head, chunk) and folded into the two
    tiles that use it, M1 = CB o E and M2 = DX o E (CB = C B^T, DX = dY
    X^T); Q = M2 o CB o dt_s summed by rows and by columns; and dB, dC of
    the heads summed first inside each group of ``group`` heads (the heads
    a block of the kernel takes), then over the groups:

      GB  = e1 o (B G^T) + M1^T dY,     dx = dt GB + D dy
      dB  = sum_groups sum_(h in group) dt o (e1 o (X G) + M2^T C)
      dC  = sum_groups sum_(h in group) exp(cum) o (dY S0) + (M2 o dt_s) B
      dcum = exp(cum) o (dY S0) . C + rowsum Q - colsum Q
             - e1 dt (X G) . B + [last] <G, S_leaving>

    Same arguments and results as ``ssd_bwd_ref``; H a multiple of
    ``group``."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    if h % group:
        raise ValueError(f"H={h} is not a multiple of the group {group}")
    tp = max(-(-t // chunk), 1) * chunk
    xs, dys = chunks(x.float(), tp, chunk), chunks(dy.float(), tp, chunk)
    dts = chunks(dt.float(), tp, chunk)                  # [B, nc, L, H]
    bs, cs = chunks(Bm.float(), tp, chunk), chunks(Cm.float(), tp, chunk)
    a_, d_ = A.float(), D.float()
    g = (torch.zeros_like(states[0]) if dstate_out is None
         else dstate_out.float())
    tril = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    outs = {key: [] for key in ("dx", "ddt", "dB", "dC")}
    da = torch.zeros(h, dtype=torch.float32, device=x.device)
    dd = torch.zeros(h, dtype=torch.float32, device=x.device)

    def by_group(z):                                     # [B, L, H, N]
        return z.reshape(b, chunk, h // group, group, n).sum(3).sum(2)

    for c in range(tp // chunk - 1, -1, -1):
        xc, dyc, dtc, bc, cc = (z[:, c] for z in (xs, dys, dts, bs, cs))
        s0 = states[c].float()
        la = dtc * a_
        cum = torch.cumsum(la, 1)
        e1 = torch.exp(rev_excl_cumsum(la, 1))
        ecum = torch.exp(cum)
        seg = cum[:, :, None] - cum[:, None]              # [B, t, s, H]
        e = torch.where(tril, torch.exp(torch.where(tril, seg,
                                                    torch.zeros_like(seg))),
                        torch.zeros_like(seg))
        cb = torch.einsum("btn,bsn->bts", cc, bc)[..., None]
        m1 = cb * e
        m2 = torch.einsum("bthp,bshp->btsh", dyc, xc) * e
        q = m2 * cb * dtc[:, None]
        dys0 = torch.einsum("bthp,bhpn->bthn", dyc, s0)
        xg = torch.einsum("bthp,bhpn->bthn", xc, g)
        gb = e1[..., None] * torch.einsum("btn,bhpn->bthp", bc, g) \
            + torch.einsum("buth,buhp->bthp", m1, dyc)
        outs["dx"].append(dtc[..., None] * gb + d_[:, None] * dyc)
        outs["dB"].append(by_group(dtc[..., None] * (
            e1[..., None] * xg + torch.einsum("buth,bun->bthn", m2, cc))))
        outs["dC"].append(by_group(
            ecum[..., None] * dys0
            + torch.einsum("btsh,bsh,bsn->bthn", m2, dtc, bc)))
        xgb = e1 * dtc * (xg * bc[:, :, None]).sum(-1)
        dcum = ecum * (dys0 * cc[:, :, None]).sum(-1) + q.sum(2) \
            - q.sum(1) - xgb
        dcum[:, -1] += torch.exp(cum[:, -1]) * (g * s0).sum((-2, -1)) \
            + xgb.sum(1)
        dla = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        outs["ddt"].append((xc * gb).sum(-1) + a_ * dla)
        da = da + (dtc * dla).sum((0, 1))
        dd = dd + (dyc * xc).sum((0, 1, 3))
        g = torch.exp(cum[:, -1])[..., None, None] * g \
            + torch.einsum("bth,bthp,btn->bhpn", ecum, dyc, cc)
    res = {key: torch.cat(v[::-1], 1)[:, :t] for key, v in outs.items()}
    return (res["dx"].to(x.dtype), res["ddt"], da.to(A.dtype),
            res["dB"].to(Bm.dtype), res["dC"].to(Cm.dtype), dd.to(D.dtype), g)
