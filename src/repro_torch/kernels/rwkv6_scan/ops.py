"""WKV6 recurrence: the CUDA kernel wrapper with its plain version.

``wkv6`` runs the sequential scan of ``csrc/rwkv6_scan.cu`` (kernel
``wkv6_kernel``, replacing the Pallas ``wkv6_bh`` / ``_wkv6_kernel`` of
``repro/kernels/rwkv6_scan/kernel.py``) on CUDA tensors, and the plain
version (``ref.py``) on CPU tensors.  Public layout as the JAX wrapper's:
r, k, v, w ``[B, T, H, N]``, u ``[H, N]``, state ``[B, H, N, N]``.

The kernel computes the recurrence step by step for every T (the JAX
package's ``impl="auto"`` takes a chunked matmul form for T > 1; the two
agree within float32 rounding).  r, k, v and u share a type (float32 or
bfloat16); w and the state are float32, the output state too.

Bound on an H100: bytes at decode, the sequential dependence at prefill;
see the source note.  Dispatch: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel (N <= 64) and a failed build or launch
raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan import ref as R

launches = {"wkv6": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 64


def launch(r, k, v, w, u, state, y, state_out):
    """Launch ``wkv6_kernel`` on checked packed operands."""
    b, t, h, n = r.shape
    dev = r.device
    if r.dtype not in _DTYPE_CODES:
        raise TypeError(f"wkv6 takes float32 or bfloat16, got {r.dtype}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"wkv6 takes N <= {MAX_N}, got N={n}")
    for x, nm in ((r, "r"), (k, "k"), (v, "v"), (y, "y")):
        _build.check_operand(x, nm, r.dtype, (b, t, h, n), dev)
    _build.check_operand(w, "w", torch.float32, (b, t, h, n), dev)
    _build.check_operand(u, "u", r.dtype, (h, n), dev)
    for x, nm in ((state, "state"), (state_out, "state_out")):
        _build.check_operand(x, nm, torch.float32, (b, h, n, n), dev)
    fn = _build.bind("rwkv6_scan", "wkv6_fwd",
                     [_P] * 8 + [_I] * 5 + [_P])
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), state.data_ptr(), y.data_ptr(),
                    state_out.data_ptr(), b, t, h, n, _DTYPE_CODES[r.dtype],
                    torch.cuda.current_stream(dev).cuda_stream), "wkv6")
    launches["wkv6"] += 1
    return y, state_out


def wkv6(r, k, v, w, u, state, *, impl=None):
    """(y ``[B, T, H, N]`` in r's dtype, final state ``[B, H, N, N]``
    float32)."""
    if _build.resolve_impl(impl, r) == "ref":
        return R.wkv6_ref(r, k, v, w, u, state)
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w = w.float().contiguous()
    u = u.to(r.dtype).contiguous()
    state = state.float().contiguous()
    return launch(r, k, v, w, u, state, torch.empty_like(r),
                  torch.empty_like(state))
