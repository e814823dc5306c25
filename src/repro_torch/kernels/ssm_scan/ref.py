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
