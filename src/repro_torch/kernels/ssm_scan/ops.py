"""Mamba-2 SSD recurrence: the CUDA kernel wrapper with its plain version.

``ssd`` runs the sequential scan of ``csrc/ssm_scan.cu`` (kernel
``ssd_kernel``, replacing the Pallas ``ssd_bh`` / ``_ssd_kernel`` of
``repro/kernels/ssm_scan/kernel.py``) on CUDA tensors, and the plain
version (``ref.py``) on CPU tensors.  Public layout as the JAX wrapper's:
x ``[B, T, H, P]``, dt ``[B, T, H]``, A, D ``[H]``, Bm, Cm ``[B, T, N]``,
state ``[B, H, P, N]``.

The kernel computes the recurrence step by step for every T (the JAX
package's ``impl="auto"`` takes a chunked matmul form for T > 1) and adds
the ``D x`` skip in float32, as the plain version does.  x, Bm and Cm
share a type (float32 or bfloat16) and may be strided in batch and time
(last dims packed: the model hands in slices of its conv output); dt, A,
D and the state are float32, the output state too.

Bound on an H100: bytes at decode, the sequential dependence at prefill;
see the source note.  Dispatch: a CPU tensor takes the plain version; a
CUDA tensor launches the kernel (P, N <= 64) and a failed build or launch
raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssm_scan import ref as R

launches = {"ssd": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 64


def launch(x, dt, A, Bm, Cm, D, state, y, state_out):
    """Launch ``ssd_kernel`` on checked operands."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    dev = x.device
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd takes float32 or bfloat16, got {x.dtype}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N):
        raise ValueError(f"ssd takes P, N <= {MAX_P}, got P={p}, N={n}")
    for z, nm, shape in ((x, "x", (b, t, h, p)), (Bm, "Bm", (b, t, n)),
                         (Cm, "Cm", (b, t, n))):
        _build.check_operand(z, nm, x.dtype, shape, dev,
                             packed_trailing=len(shape) - 2)
    _build.check_operand(dt, "dt", torch.float32, (b, t, h), dev)
    _build.check_operand(A, "A", torch.float32, (h,), dev)
    _build.check_operand(D, "D", torch.float32, (h,), dev)
    _build.check_operand(y, "y", x.dtype, (b, t, h, p), dev)
    for z, nm in ((state, "state"), (state_out, "state_out")):
        _build.check_operand(z, nm, torch.float32, (b, h, p, n), dev)
    fn = _build.bind("ssm_scan", "ssd_fwd",
                     [_P] * 9 + [_I] * 5 + [_L] * 6 + [_I, _P])
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
                    state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
                    b, t, h, p, n, x.stride(0), x.stride(1), Bm.stride(0),
                    Bm.stride(1), Cm.stride(0), Cm.stride(1),
                    _DTYPE_CODES[x.dtype],
                    torch.cuda.current_stream(dev).cuda_stream), "ssd")
    launches["ssd"] += 1
    return y, state_out


def ssd(x, dt, A, Bm, Cm, D, state, *, impl=None):
    """(y ``[B, T, H, P]`` in x's dtype, final state ``[B, H, P, N]``
    float32)."""
    if _build.resolve_impl(impl, x) == "ref":
        return R.ssd_ref(x, dt, A, Bm, Cm, D, state)
    x = x if _build.packed(x, 2) else x.contiguous()
    Bm, Cm = ((z if _build.packed(z, 1) else z.contiguous()).to(x.dtype)
              for z in (Bm, Cm))
    dt = dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    state = state.float().contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return launch(x, dt, A, Bm, Cm, D, state, y, torch.empty_like(state))
