"""Mamba-2 SSD recurrence: the CUDA kernel wrapper with its plain version.

``ssd`` runs, on CUDA tensors, one of two kernels replacing the Pallas
``ssd_bh`` / ``_ssd_kernel`` of ``repro/kernels/ssm_scan/kernel.py``:

* ``csrc/ssm_chunk.cu`` (``ssd_chunk_kernel``): bfloat16 with T >=
  ``CHUNKED_MIN_T``, P and N multiples of 8, 16-byte aligned rows — the
  chunked form on the tensor cores (chunks of 64, one block per batch,
  head and chunk);
* ``csrc/ssm_scan.cu`` (``ssd_kernel``): everything else (single steps,
  float32) — the recurrence step by step, bit-equal to the plain version
  in float32;

and the plain version (``ref.py`` ``ssd_ref``) on CPU tensors.  Public
layout as the JAX wrapper's: x ``[B, T, H, P]``, dt ``[B, T, H]``, A, D
``[H]``, Bm, Cm ``[B, T, N]``, state ``[B, H, P, N]``.  Both kernels add
the ``D x`` skip in float32, as the plain version does.  x, Bm and Cm
share a type (float32 or bfloat16) and may be strided in batch and time
(last dims packed: the model hands in slices of its conv output); dt, A,
D and the state are float32, the output state too.

Bound on an H100: bytes at decode, the products at prefill; see the
source notes.  Dispatch: a CPU tensor takes the plain version; a CUDA
tensor launches a kernel (P, N <= 64) and a failed build or launch
raises.  ``launches["ssd"]`` counts wrapper calls that launched (one
each, whichever kernel), ``launches["ssd_chunked"]`` those that took the
chunked kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, scan_chunks
from repro_torch.kernels.ssm_scan import ref as R

launches = {"ssd": 0, "ssd_chunked": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_P, MAX_N = 64, 64
CHUNK = 64
# bf16 sequences from this length on take the chunked kernel.  Both
# routes at zamba2-1.2b's widths, ms per call, chunked / sequential
# (``chip_smoke.py`` phase 5, device-paced, H100 80GB HBM3 at 700 W):
#   batch 1:  T 2 0.0109 / 0.0117, T 16 0.0112 / 0.0231;
#   batch 16: T 8 0.0338 / 0.0288, T 16 0.0359 / 0.0411.
# From 16 the chunked kernel wins at both batch sizes.
CHUNKED_MIN_T = 16


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


def chunked_takes(x, Bm, Cm) -> bool:
    """Whether the chunked kernel takes these operands: bf16, P and N
    multiples of 8 up to 64, rows and strides 16-byte aligned."""
    p, n = x.shape[3], Bm.shape[-1]
    return (x.dtype == torch.bfloat16 and p % 8 == 0 and n % 8 == 0
            and p <= MAX_P and n <= MAX_N and all(z.data_ptr() % 16 == 0 and z.stride(0) % 8 == 0
                    and z.stride(1) % 8 == 0 for z in (x, Bm, Cm)))


def chunked_route(x, Bm, Cm) -> bool:
    """Whether ``ssd`` sends these (CUDA) operands to the chunked kernel."""
    return x.shape[1] >= CHUNKED_MIN_T and chunked_takes(x, Bm, Cm)


def launch_chunked(x, dt, A, Bm, Cm, D, state, y, state_out):
    """Launch ``ssd_chunk_kernel`` on checked operands (bf16)."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    dev = x.device
    if not chunked_takes(x, Bm, Cm):
        raise ValueError("the chunked ssd takes bf16, P and N multiples of "
                         "8 up to 64 and 16-byte aligned rows")
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
    nc = -(-t // CHUNK)
    stream = torch.cuda.current_stream(dev).cuda_stream
    s_mid, flags = scan_chunks.workspace(dev, stream,
                                         (nc - 1) * b * h * p * n,
                                         b * h * nc + 1)
    fn = _build.bind("ssm_chunk", "ssd_chunk_fwd",
                     [_P] * 11 + [_I] * 5 + [_L] * 6 + [_P])
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
                    state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
                    s_mid.data_ptr(), flags.data_ptr(), b, t, h, p, n,
                    x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
                    Cm.stride(0), Cm.stride(1),
                    stream), "ssd_chunked")
    launches["ssd"] += 1
    launches["ssd_chunked"] += 1
    return y, state_out


def ssd(x, dt, A, Bm, Cm, D, state, *, impl=None):
    """(y ``[B, T, H, P]`` in x's dtype, final state ``[B, H, P, N]``
    float32)."""
    if _build.resolve_impl(impl, x) == "ref":
        return R.ssd_ref(x, dt, A, Bm, Cm, D, state)
    _build.refuse_grad("ssd", x, dt, A, Bm, Cm, D, state)
    x = x if _build.packed(x, 2) else x.contiguous()
    Bm, Cm = ((z if _build.packed(z, 1) else z.contiguous()).to(x.dtype)
              for z in (Bm, Cm))
    dt = dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    state = state.float().contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    go = launch_chunked if chunked_route(x, Bm, Cm) else launch
    return go(x, dt, A, Bm, Cm, D, state, y, torch.empty_like(state))
