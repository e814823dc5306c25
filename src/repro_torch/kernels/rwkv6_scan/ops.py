"""WKV6 recurrence: the CUDA kernel wrappers with their plain version.

``wkv6`` runs, on CUDA tensors, one of two kernels replacing the Pallas
``wkv6_bh`` / ``_wkv6_kernel`` of ``repro/kernels/rwkv6_scan/kernel.py``:

* ``csrc/rwkv6_chunk.cu`` (``wkv6_chunk_kernel``): bfloat16 with T >=
  ``CHUNKED_MIN_T`` and N a multiple of 8 — a chunked form on the tensor
  cores whose exponents are all local sums of log decays (<= 0), so it
  stays exact where the Pallas form, which divides by cumulative decays,
  overflows (chunks of 64, sub-chunks of 16, one block per batch, head and
  chunk);
* ``csrc/rwkv6_scan.cu`` (``wkv6_kernel``): everything else (single
  steps, float32) — the recurrence step by step, bit-equal to the plain
  version in float32;

and the plain version (``ref.py`` ``wkv6_ref``) on CPU tensors.  Public
layout as the JAX wrapper's: r, k, v, w ``[B, T, H, N]``, u ``[H, N]``,
state ``[B, H, N, N]``.  r, k, v and u share a type (float32 or
bfloat16); w and the state are float32, the output state too.

Training: under grad mode with an input that requires grad, ``wkv6`` goes
through ``_WKV6`` (a ``torch.autograd.Function``).  Its forward runs the
same kernel by the same route and also writes the state entering every
chunk of 64 steps into a fresh tensor that the backward keeps (the
chunked kernel's chunk states; the sequential kernel's every 64 steps);
its backward launches ``csrc/rwkv6_chunk_bwd.cu`` (``wkv6_bwd_kernel``,
float32 or bfloat16, any N <= 64), whose plain version is ``ref.py``
``wkv6_bwd_ref``.  On CPU tensors the Function runs ``wkv6_fwd_ref`` /
``wkv6_bwd_ref``.

Bound on an H100: bytes at decode, the products at prefill; see the
source notes.  Dispatch: a CPU tensor takes the plain version; a CUDA
tensor launches a kernel (N <= 64) and a failed build or launch raises.
``launches["wkv6"]`` counts wrapper calls that launched (one each,
whichever kernel), ``launches["wkv6_chunked"]`` those that took the
chunked kernel, ``launches["wkv6_bwd"]`` the backward's launches (one a
call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, scan_chunks
from repro_torch.kernels.rwkv6_scan import ref as R

launches = {"wkv6": 0, "wkv6_chunked": 0, "wkv6_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_N = 64
CHUNK = 64
# bf16 sequences from this length on take the chunked kernel.  Both
# routes at rwkv6-1.6b's widths, ms per call, chunked / sequential
# (``chip_smoke.py`` phase 5, device-paced, H100 80GB HBM3 at 700 W):
#   batch 1:  T 16 0.0172 / 0.0169, T 32 0.0177 / 0.0294;
#   batch 16: T 32 0.0456 / 0.0377, T 64 0.0533 / 0.0840.
# The engine's prefills run at batch 1, so 32.
CHUNKED_MIN_T = 32


def launch(r, k, v, w, u, state, y, state_out, s_mid=None):
    """Launch ``wkv6_kernel`` on checked packed operands; with ``s_mid``
    (``[ceil(T / 64) - 1, B, H, N, N]`` float32) it also writes the state
    entering every chunk of 64 steps after the first."""
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
    _check_mid(s_mid, t, (b, h, n, n), dev)
    fn = _build.bind("rwkv6_scan", "wkv6_fwd",
                     [_P] * 8 + [_I] * 5 + [_P, _P])
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), state.data_ptr(), y.data_ptr(),
                    state_out.data_ptr(), b, t, h, n, _DTYPE_CODES[r.dtype],
                    torch.cuda.current_stream(dev).cuda_stream,
                    None if s_mid is None else s_mid.data_ptr()), "wkv6")
    launches["wkv6"] += 1
    return y, state_out


def _check_mid(s_mid, t: int, shape, dev) -> None:
    if s_mid is not None:
        _build.check_operand(s_mid, "s_mid", torch.float32,
                             (max(-(-t // CHUNK) - 1, 0),) + shape, dev)


def chunked_route(r) -> bool:
    """Whether ``wkv6`` sends this (CUDA, packed) ``r`` to the chunked
    kernel (bf16, T >= CHUNKED_MIN_T, N a multiple of 8 up to 64)."""
    return (r.dtype == torch.bfloat16 and r.shape[1] >= CHUNKED_MIN_T
            and r.shape[3] % 8 == 0 and r.shape[3] <= MAX_N)


def launch_chunked(r, k, v, w, u, state, y, state_out, s_mid=None):
    """Launch ``wkv6_chunk_kernel`` on checked packed operands (bf16, N a
    multiple of 8); the chunk states go into ``s_mid`` when given (as
    ``launch``'s), else into the shared workspace."""
    b, t, h, n = r.shape
    dev = r.device
    if r.dtype != torch.bfloat16 or n % 8 or n > MAX_N:
        raise ValueError("the chunked wkv6 takes bf16 and N a multiple of 8 "
                         "up to 64")
    for x, nm in ((r, "r"), (k, "k"), (v, "v"), (y, "y")):
        _build.check_operand(x, nm, r.dtype, (b, t, h, n), dev)
    _build.check_operand(w, "w", torch.float32, (b, t, h, n), dev)
    _build.check_operand(u, "u", r.dtype, (h, n), dev)
    for x, nm in ((state, "state"), (state_out, "state_out")):
        _build.check_operand(x, nm, torch.float32, (b, h, n, n), dev)
    nc = -(-t // CHUNK)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _check_mid(s_mid, t, (b, h, n, n), dev)
    work, flags = scan_chunks.workspace(dev, stream,
                                        (nc - 1) * b * h * n * n,
                                        b * h * nc + 1)
    s_mid = work if s_mid is None else s_mid
    fn = _build.bind("rwkv6_chunk", "wkv6_chunk_fwd",
                     [_P] * 10 + [_I] * 4 + [_P])
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), state.data_ptr(), y.data_ptr(),
                    state_out.data_ptr(), s_mid.data_ptr(), flags.data_ptr(),
                    b, t, h, n, stream), "wkv6_chunked")
    launches["wkv6"] += 1
    launches["wkv6_chunked"] += 1
    return y, state_out


def _forward(r, k, v, w, u, state, keep: bool):
    """(y, final state, the states entering each chunk of 64 steps
    ``[nc, B, H, N, N]`` or None) from the kernel of ``r``'s route."""
    b, t, h, n = r.shape
    states = mid = None
    if keep:
        states = torch.empty((max(-(-t // CHUNK), 1), b, h, n, n),
                             dtype=torch.float32, device=r.device)
        states[0].copy_(state)
        mid = states[1:]
    go = launch_chunked if chunked_route(r) else launch
    y, s = go(r, k, v, w, u, state, torch.empty_like(r),
              torch.empty_like(state), mid)
    return y, s, states


def launch_bwd(r, k, v, w, u, states, dy, dstate_out):
    """Launch ``wkv6_bwd_kernel`` (and the fixed-order sum of du) on
    checked packed operands: (dr, dk, dv in r's type, dw float32, du in
    u's type, dstate float32)."""
    b, t, h, n = r.shape
    dev = r.device
    if r.dtype not in _DTYPE_CODES:
        raise TypeError(f"wkv6 takes float32 or bfloat16, got {r.dtype}")
    if not 1 <= n <= MAX_N or t < 1:
        raise ValueError(f"the wkv6 backward takes 1 <= N <= {MAX_N} and "
                         f"T >= 1, got N={n}, T={t}")
    nc = -(-t // CHUNK)
    for x, nm in ((r, "r"), (k, "k"), (v, "v"), (dy, "dy")):
        _build.check_operand(x, nm, r.dtype, (b, t, h, n), dev)
    _build.check_operand(w, "w", torch.float32, (b, t, h, n), dev)
    _build.check_operand(u, "u", r.dtype, (h, n), dev)
    _build.check_operand(states, "states", torch.float32,
                         (nc, b, h, n, n), dev)
    _build.check_operand(dstate_out, "dstate_out", torch.float32,
                         (b, h, n, n), dev)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    du = torch.empty((h, n), dtype=torch.float32, device=dev)
    du_part = torch.empty((b, nc, h, n), dtype=torch.float32, device=dev)
    dstate = torch.empty_like(dstate_out)
    ds_mid = torch.empty((max(nc - 1, 1), b, h, n, n), dtype=torch.float32,
                         device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, flags = scan_chunks.workspace(dev, stream, 0, b * h * nc + 1)
    fn = _build.bind("rwkv6_chunk_bwd", "wkv6_chunk_bwd",
                     [_P] * 17 + [_I] * 5 + [_P])
    _build.check(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                    u.data_ptr(), states.data_ptr(), dy.data_ptr(),
                    dstate_out.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
                    du.data_ptr(), dstate.data_ptr(), ds_mid.data_ptr(),
                    flags.data_ptr(), b, t, h, n, _DTYPE_CODES[r.dtype],
                    stream), "wkv6_bwd")
    launches["wkv6_bwd"] += 1
    return dr, dk, dv, dw, du.to(u.dtype), dstate


def bwd_occupancy(dtype) -> tuple:
    """(resident blocks an SM, shared memory bytes a block) of
    ``wkv6_bwd_kernel`` for ``dtype`` on the current card, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives them."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    ptr = ctypes.POINTER(ctypes.c_int)
    fn = _build.bind("rwkv6_chunk_bwd", "wkv6_chunk_bwd_occupancy", [_I, ptr, ptr])
    _build.check(fn(_DTYPE_CODES[dtype], ctypes.byref(blocks),
                    ctypes.byref(smem)), "wkv6_chunk_bwd_occupancy")
    return blocks.value, smem.value


class _WKV6(torch.autograd.Function):
    """``wkv6`` with its backward: the forward keeps the chunk states, the
    backward launches ``wkv6_bwd_kernel`` (``wkv6_bwd_ref`` on the plain
    route)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, impl):
        if impl == "ref":
            y, s, states = R.wkv6_fwd_ref(r, k, v, w, u, state)
        else:
            y, s, states = _forward(r, k, v, w, u, state, keep=True)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.impl = impl
        return y, s

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, states = ctx.saved_tensors
        if ctx.impl == "ref":
            grads = R.wkv6_bwd_ref(r, k, v, w, u, states, dy, dstate)
        else:
            grads = launch_bwd(r, k, v, w, u, states, dy.contiguous(),
                               dstate.float().contiguous())
        return (*grads, None)


def wkv6(r, k, v, w, u, state, *, impl=None):
    """(y ``[B, T, H, N]`` in r's dtype, final state ``[B, H, N, N]``
    float32)."""
    impl = _build.resolve_impl(impl, r)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, w, u, state))
    if impl == "ref" and not grad:
        return R.wkv6_ref(r, k, v, w, u, state)
    r, k, v = r.contiguous(), k.contiguous(), v.contiguous()
    w = w.float().contiguous()
    u = u.to(r.dtype).contiguous()
    state = state.float().contiguous()
    if grad:
        return _WKV6.apply(r, k, v, w, u, state, impl)
    return _forward(r, k, v, w, u, state, keep=False)[:2]
