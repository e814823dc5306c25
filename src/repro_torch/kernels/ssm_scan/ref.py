"""Plain PyTorch Mamba-2 SSD recurrence — the oracle of the CUDA kernel
``csrc/ssm_scan.cu`` and the version the wrapper runs on the CPU.

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
