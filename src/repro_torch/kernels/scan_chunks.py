"""What the chunked scans share: the plain versions' sequence helpers
(``ssm_scan/ref.py``, ``rwkv6_scan/ref.py``: cutting ``[B, T, ...]`` into
chunks and the running sums whose order the chunked kernels follow) and
the wrappers' workspace (``ssm_scan/ops.py``, ``rwkv6_scan/ops.py``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_work: Dict[Tuple[torch.device, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def workspace(device, stream: int, n_states: int, n_flags: int):
    """(chunk states: at least ``n_states`` float32, flags: at least
    ``n_flags`` int32 at 0) for the chunked kernels on ``device`` and the
    CUDA stream ``stream``, kept from call to call.  The kernels leave
    their flags and ticket counter at 0, so the flags are zeroed only
    when they are made or grown; calls on one stream run in order and may
    share them."""
    states, flags = _work.get((device, stream), (None, None))
    if states is None or states.numel() < n_states:
        states = torch.empty(max(n_states, 1), dtype=torch.float32,
                             device=device)
    if flags is None or flags.numel() < n_flags:
        flags = torch.zeros(n_flags, dtype=torch.int32, device=device)
    _work[(device, stream)] = (states, flags)
    return states, flags


def chunks(z, t_pad: int, chunk: int, value: float = 0.0):
    """``z`` ``[B, T, ...]`` padded along T to ``t_pad`` with ``value`` and
    cut into ``[B, T_pad / chunk, chunk, ...]``."""
    pad = z.new_full((z.shape[0], t_pad - z.shape[1]) + z.shape[2:], value)
    z = torch.cat([z, pad], 1)
    return z.reshape((z.shape[0], t_pad // chunk, chunk) + z.shape[2:])


def excl_cumsum(z, dim: int):
    """``out[t] = sum_{i < t} z[i]`` along ``dim`` (a running sum)."""
    inc = torch.cumsum(z, dim)
    return torch.cat([torch.zeros_like(z.narrow(dim, 0, 1)),
                      inc.narrow(dim, 0, z.shape[dim] - 1)], dim)


def rev_excl_cumsum(z, dim: int):
    """``out[s] = sum_{i > s} z[i]`` along ``dim``: a running sum from the
    end, not a difference of two long sums."""
    inc = torch.flip(torch.cumsum(torch.flip(z, [dim]), dim), [dim])
    return torch.cat([inc.narrow(dim, 1, z.shape[dim] - 1),
                      torch.zeros_like(z.narrow(dim, 0, 1))], dim)
