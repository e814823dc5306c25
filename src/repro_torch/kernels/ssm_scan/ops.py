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

Training: under grad mode with an input that requires grad, ``ssd``
goes through ``_SSD`` (a ``torch.autograd.Function``).  Its forward runs
the same kernel by the same route and also writes the state entering
every chunk of 64 steps into a fresh tensor that the backward keeps; its
backward launches ``csrc/ssm_chunk_bwd.cu`` (``ssd_bwd_kernel``, float32
or bfloat16, any P, N <= 64, x / Bm / Cm strided as the forward reads
them; a block takes ``head_group`` heads of one batch row and chunk) and
the fixed-order sums of its per-group parts of dBm / dCm and its
per-(batch, chunk) parts of dA / dD; the plain version is ``ref.py``
``ssd_bwd_ref``.  On CPU tensors the Function runs ``ssd_fwd_ref`` /
``ssd_bwd_ref``.  The gradients of strided x, Bm, Cm go back to the
tensors they are views of through autograd.

Bound on an H100: bytes at decode, the products at prefill; see the
source notes.  Dispatch: a CPU tensor takes the plain version; a CUDA
tensor launches a kernel (P, N <= 64) and a failed build or launch
raises.  ``launches["ssd"]`` counts wrapper calls that launched (one
each, whichever kernel), ``launches["ssd_chunked"]`` those that took the
chunked kernel, ``launches["ssd_bwd"]`` the backward's calls (one each).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, scan_chunks
from repro_torch.kernels.ssm_scan import ref as R

launches = {"ssd": 0, "ssd_chunked": 0, "ssd_bwd": 0}

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


def _check_mid(s_mid, t: int, shape, dev) -> None:
    if s_mid is not None:
        _build.check_operand(s_mid, "s_mid", torch.float32,
                             (max(-(-t // CHUNK) - 1, 0),) + shape, dev)


def launch(x, dt, A, Bm, Cm, D, state, y, state_out, s_mid=None):
    """Launch ``ssd_kernel`` on checked operands; with ``s_mid``
    (``[ceil(T / 64) - 1, B, H, P, N]`` float32) it also writes the state
    entering every chunk of 64 steps after the first."""
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
    _check_mid(s_mid, t, (b, h, p, n), dev)
    fn = _build.bind("ssm_scan", "ssd_fwd",
                     [_P] * 9 + [_I] * 5 + [_L] * 6 + [_I, _P, _P])
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
                    state.data_ptr(), y.data_ptr(), state_out.data_ptr(),
                    b, t, h, p, n, x.stride(0), x.stride(1), Bm.stride(0),
                    Bm.stride(1), Cm.stride(0), Cm.stride(1),
                    _DTYPE_CODES[x.dtype],
                    torch.cuda.current_stream(dev).cuda_stream,
                    None if s_mid is None else s_mid.data_ptr()), "ssd")
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


def launch_chunked(x, dt, A, Bm, Cm, D, state, y, state_out, s_mid=None):
    """Launch ``ssd_chunk_kernel`` on checked operands (bf16); the chunk
    states go into ``s_mid`` when given (as ``launch``'s), else into the
    shared workspace."""
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
    _check_mid(s_mid, t, (b, h, p, n), dev)
    work, flags = scan_chunks.workspace(dev, stream,
                                        (nc - 1) * b * h * p * n,
                                        b * h * nc + 1)
    s_mid = work if s_mid is None else s_mid
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


def _forward(x, dt, A, Bm, Cm, D, state, keep: bool):
    """(y, final state, the states entering each chunk of 64 steps
    ``[nc, B, H, P, N]`` or None) from the kernel of the operands'
    route."""
    b, t, h, p = x.shape
    states = mid = None
    if keep:
        states = torch.empty((max(-(-t // CHUNK), 1), b, h, p,
                              Bm.shape[-1]),
                             dtype=torch.float32, device=x.device)
        states[0].copy_(state)
        mid = states[1:]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    go = launch_chunked if chunked_route(x, Bm, Cm) else launch
    y, s = go(x, dt, A, Bm, Cm, D, state, y, torch.empty_like(state), mid)
    return y, s, states


def head_group(b: int, h: int, nc: int) -> int:
    """The heads one block of ``ssd_bwd_kernel`` takes: the largest of 8,
    4, 2 that divides H and still leaves two blocks for each of an H100's
    132 SMs (B * H / group * chunks >= 264), else 1.  A group loads B and
    C once and writes one part of dBm / dCm for its heads."""
    for g in (8, 4, 2):
        if h % g == 0 and b * (h // g) * nc >= 2 * 132:
            return g
    return 1


def launch_bwd(x, dt, A, Bm, Cm, D, states, dy, dstate_out, group=None):
    """Launch ``ssd_bwd_kernel`` and the fixed-order sums on checked
    operands: (dx in x's type, ddt, dA, dBm, dCm in their types, dD,
    dstate float32).  ``group``: the heads a block takes (default
    ``head_group``; it must divide H)."""
    b, t, h, p = x.shape
    n = Bm.shape[-1]
    dev = x.device
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd takes float32 or bfloat16, got {x.dtype}")
    if not (1 <= p <= MAX_P and 1 <= n <= MAX_N) or t < 1:
        raise ValueError(f"the ssd backward takes P, N <= {MAX_P} and "
                         f"T >= 1, got P={p}, N={n}, T={t}")
    nc = -(-t // CHUNK)
    hg = head_group(b, h, nc) if group is None else group
    if hg < 1 or h % hg:
        raise ValueError(f"the head group {hg} does not divide H={h}")
    for z, nm, shape in ((x, "x", (b, t, h, p)), (Bm, "Bm", (b, t, n)),
                         (Cm, "Cm", (b, t, n))):
        _build.check_operand(z, nm, x.dtype, shape, dev,
                             packed_trailing=len(shape) - 2)
    _build.check_operand(dy, "dy", x.dtype, (b, t, h, p), dev)
    _build.check_operand(dt, "dt", torch.float32, (b, t, h), dev)
    _build.check_operand(A, "A", torch.float32, (h,), dev)
    _build.check_operand(D, "D", torch.float32, (h,), dev)
    _build.check_operand(states, "states", torch.float32,
                         (nc, b, h, p, n), dev)
    _build.check_operand(dstate_out, "dstate_out", torch.float32,
                         (b, h, p, n), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, t, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, t, h), **f32)
    db_part, dc_part = (torch.empty((b, h // hg, t, n), **f32)
                        for _ in range(2))
    db, dc = (torch.empty((b, t, n), **f32) for _ in range(2))
    da_part, dd_part = (torch.empty((b, nc, h), **f32) for _ in range(2))
    da, dd = (torch.empty((h,), **f32) for _ in range(2))
    dstate = torch.empty_like(dstate_out)
    ds_mid = torch.empty((max(nc - 1, 1), b, h, p, n), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, flags = scan_chunks.workspace(dev, stream, 0, b * h * nc + 1)
    fn = _build.bind("ssm_chunk_bwd", "ssd_chunk_bwd",
                     [_P] * 22 + [_I] * 6 + [_L] * 6 + [_I, _P])
    _build.check(fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
                    states.data_ptr(), dy.data_ptr(), dstate_out.data_ptr(),
                    dx.data_ptr(), ddt.data_ptr(), db_part.data_ptr(),
                    dc_part.data_ptr(), db.data_ptr(), dc.data_ptr(),
                    da_part.data_ptr(), dd_part.data_ptr(), da.data_ptr(),
                    dd.data_ptr(), dstate.data_ptr(), ds_mid.data_ptr(),
                    flags.data_ptr(), b, t, h, p, n, hg, x.stride(0),
                    x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
                    Cm.stride(1), _DTYPE_CODES[x.dtype], stream),
                 "ssd_bwd")
    launches["ssd_bwd"] += 1
    return dx, ddt, da, db.to(Bm.dtype), dc.to(Cm.dtype), dd, dstate


def bwd_occupancy(dtype) -> tuple:
    """(resident blocks an SM, shared memory bytes a block) of
    ``ssd_bwd_kernel`` for ``dtype`` on the current card, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    ptr = ctypes.POINTER(ctypes.c_int)
    fn = _build.bind("ssm_chunk_bwd", "ssd_chunk_bwd_occupancy", [_I, ptr, ptr])
    _build.check(fn(_DTYPE_CODES[dtype], ctypes.byref(blocks),
                    ctypes.byref(smem)), "ssd_chunk_bwd_occupancy")
    return blocks.value, smem.value


class _SSD(torch.autograd.Function):
    """``ssd`` with its backward: the forward keeps the chunk states, the
    backward launches ``ssd_bwd_kernel`` (``ssd_bwd_ref`` on the plain
    route)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, state, impl):
        if impl == "ref":
            y, s, states = R.ssd_fwd_ref(x, dt, A, Bm, Cm, D, state)
        else:
            y, s, states = _forward(x, dt, A, Bm, Cm, D, state, keep=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, states)
        ctx.impl = impl
        return y, s

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, Bm, Cm, D, states = ctx.saved_tensors
        if ctx.impl == "ref":
            grads = R.ssd_bwd_ref(x, dt, A, Bm, Cm, D, states, dy, dstate)
        else:
            grads = launch_bwd(x, dt, A, Bm, Cm, D, states, dy.contiguous(),
                               dstate.float().contiguous())
        return (*grads, None)


def ssd(x, dt, A, Bm, Cm, D, state, *, impl=None):
    """(y ``[B, T, H, P]`` in x's dtype, final state ``[B, H, P, N]``
    float32)."""
    impl = _build.resolve_impl(impl, x)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, A, Bm, Cm, D, state))
    if impl == "ref" and not grad:
        return R.ssd_ref(x, dt, A, Bm, Cm, D, state)
    x = x if _build.packed(x, 2) else x.contiguous()
    Bm, Cm = ((z if _build.packed(z, 1) else z.contiguous()).to(x.dtype)
              for z in (Bm, Cm))
    dt = dt.float().contiguous()
    A, D = A.float().contiguous(), D.float().contiguous()
    state = state.float().contiguous()
    if grad:
        return _SSD.apply(x, dt, A, Bm, Cm, D, state, impl)
    return _forward(x, dt, A, Bm, Cm, D, state, keep=False)[:2]
