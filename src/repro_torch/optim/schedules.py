"""Learning-rate schedules — the counterpart of ``repro.optim.schedules``.
Each maps the integer step tensor to a float32 learning rate on its
device.  WSD (Warmup-Stable-Decay) per MiniCPM (arXiv:2404.06395)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=torch.as_tensor(step).device)


def cosine(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def f(step):
        s = torch.as_tensor(step).float()
        warm = lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr * 0.5 \
            * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos).float()
    return f


def wsd(lr: float, warmup: int, stable: int, decay: int,
        final_frac: float = 0.01):
    """Warmup -> Stable (flat) -> Decay (exponential, linear in log)."""
    def f(step):
        s = torch.as_tensor(step).float()
        warm = lr * s / max(warmup, 1)
        t = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
        floor = torch.tensor(max(final_frac, 1e-6), device=s.device)
        dec = lr * torch.exp(torch.log(floor) * t)
        lr_t = torch.full_like(s, lr)
        out = torch.where(s < warmup, warm,
                          torch.where(s < warmup + stable, lr_t, dec))
        return out.float()
    return f
