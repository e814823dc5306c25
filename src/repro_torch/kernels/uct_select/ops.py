"""Fused UCT argmax: CUDA kernel wrappers with the plain version beside them.

``uct_argmax`` scores ``[..., A]`` boards row by row (kernel
``uct_tiles_kernel`` of ``csrc/uct_select.cu``, replacing the Pallas
``uct_argmax_tiles`` / ``_uct_kernel`` of ``repro/kernels/uct_select``);
``uct_argmax_running`` walks each root's ``[lanes, A]`` board in lane order
(``uct_running_kernel``, replacing ``uct_argmax_running_call`` /
``_uct_running_kernel``).

Bound on an H100: launch latency and a dependent chain — a Select level's
board is a few KB.  ``uct_tiles_kernel`` scores a row with a sub-group of
threads, one column each, and reads the count planes (N, the mode's
in-flight plane, n_p) as int32 or float32, so the arena's int32 planes go
in without a copy; the running walk stages each root's board in shared
memory and walks every group of lanes sharing a parent at once, so its
chain is the largest group.  See the source note in
``csrc/uct_select.cu``.

Dispatch: a CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel, and a failed build or launch raises.  ``impl="cuda"``
with CPU tensors raises; ``impl="ref"`` forces the plain version.
``launches`` counts kernel launches per entry point.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uct_select import ref as R

launches = {"uct_argmax_tiles": 0, "uct_argmax_running": 0}
COUNT_DTYPES = (torch.int32, torch.float32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_tiles(n, w, infl, pn, valid, out, *, cp, vl_weight, wu):
    """Launch ``uct_tiles_kernel`` on checked ``[R, A]`` operands; ``infl``
    is the mode's in-flight plane (vl in loss mode, O in wu mode); ``n``,
    ``infl`` and ``pn`` are all int32 or all float32."""
    r, a = n.shape
    dev = n.device
    counts = n.dtype
    if counts not in COUNT_DTYPES:
        raise TypeError(f"uct_argmax_tiles takes int32 or float32 counts, "
                        f"got {counts}")
    for t, nm in ((n, "n"), (infl, "infl")):
        _build.check_operand(t, nm, counts, (r, a), dev)
    _build.check_operand(w, "w", torch.float32, (r, a), dev)
    _build.check_operand(pn, "pn", counts, (r,), dev)
    _build.check_operand(valid, "valid", torch.bool, (r, a), dev)
    _build.check_operand(out, "out", torch.int32, (r,), dev)
    fn = _build.bind("uct_select", "uct_argmax_tiles",
                     [_P] * 6 + [_I, _I, _F, _F, _I, _I, _P])
    _build.check(fn(n.data_ptr(), w.data_ptr(), infl.data_ptr(),
                    pn.data_ptr(), valid.data_ptr(), out.data_ptr(), r, a,
                    float(cp), float(vl_weight), int(wu),
                    int(counts == torch.int32), _stream(dev)),
                 "uct_argmax_tiles")
    launches["uct_argmax_tiles"] += 1
    return out


def launch_running(n, w, vl, o, pn, valid, pid, out, *, cp, vl_weight, wu):
    """Launch ``uct_running_kernel`` on checked ``[B, L, A]`` operands."""
    b, lanes, a = n.shape
    dev = n.device
    for t, nm in ((n, "n"), (w, "w"), (vl, "vl"), (o, "o")):
        _build.check_operand(t, nm, torch.float32, (b, lanes, a), dev)
    _build.check_operand(pn, "pn", torch.float32, (b, lanes), dev)
    _build.check_operand(valid, "valid", torch.bool, (b, lanes, a), dev)
    _build.check_operand(pid, "parent_id", torch.int32, (b, lanes), dev)
    _build.check_operand(out, "out", torch.int32, (b, lanes), dev)
    if lanes > 4096:
        raise ValueError(f"uct_argmax_running takes at most 4096 lanes, "
                         f"got {lanes}")
    need = _build.bind("uct_select", "uct_running_scratch_ints",
                       [_I, _I])(lanes, a)
    scratch = (torch.empty(b * need, dtype=torch.int32, device=dev)
               if need else None)
    fn = _build.bind("uct_select", "uct_argmax_running",
                     [_P] * 9 + [_I, _I, _I, _F, _F, _I, _P])
    _build.check(fn(n.data_ptr(), w.data_ptr(), vl.data_ptr(), o.data_ptr(),
                    pn.data_ptr(), valid.data_ptr(), pid.data_ptr(),
                    out.data_ptr(), scratch.data_ptr() if need else None, b,
                    lanes, a, float(cp), float(vl_weight), int(wu),
                    _stream(dev)),
                 "uct_argmax_running")
    launches["uct_argmax_running"] += 1
    return out


def _as(x, dtype, shape):
    """``x`` as a contiguous ``dtype`` tensor of ``shape``: ``x`` itself
    when it already is one (tested first, to spare the host three calls
    on the hot path)."""
    if x.dtype == dtype and x.shape == shape and x.is_contiguous():
        return x
    return x.to(dtype).expand(shape).contiguous()


def uct_argmax(child_n, child_w, child_vl, parent_n, *, cp, vl_weight=1.0,
               valid=None, child_o=None, vl_mode: str = "loss", impl=None):
    """Best child per row of ``[..., A]`` boards -> ``[...]`` i32.  The
    kernel reads only the mode's in-flight plane (``child_vl`` in "loss"
    mode, ``child_o`` in "wu" mode), and the count planes in their own
    type when all three are int32 (the arena's), else in float32."""
    if _build.resolve_impl(impl, child_n) == "ref":
        return R.uct_argmax_ref(child_n, child_w, child_vl, parent_n, valid,
                                cp=cp, vl_weight=vl_weight, child_o=child_o,
                                vl_mode=vl_mode)
    shape = child_n.shape
    r, a = child_n[..., 0].numel(), shape[-1]
    dev = child_n.device
    if valid is None:
        valid = torch.ones(shape, dtype=torch.bool, device=dev)
    wu = vl_mode == "wu"
    infl = child_o if wu else child_vl
    if infl is None:                        # wu mode without an O plane
        infl = torch.zeros(shape, dtype=child_n.dtype, device=dev)
    pn = torch.as_tensor(parent_n, device=dev)
    counts = torch.int32 if all(x.dtype == torch.int32
                                for x in (child_n, infl, pn)) \
        else torch.float32
    out = torch.empty(shape[:-1], dtype=torch.int32, device=dev)
    launch_tiles(_as(child_n, counts, shape).view(r, a),
                 _as(child_w, torch.float32, shape).view(r, a),
                 _as(infl, counts, shape).view(r, a),
                 _as(pn, counts, shape[:-1]).view(r),
                 _as(valid, torch.bool, shape).view(r, a), out.view(r),
                 cp=cp, vl_weight=vl_weight, wu=wu)
    return out


def uct_argmax_running(child_n, child_w, child_vl, parent_n, parent_id, *,
                       cp, vl_weight=1.0, valid=None, child_o=None,
                       vl_mode: str = "loss", impl=None):
    """Running-assignment argmax over ``[..., lanes, A]`` boards with
    ``parent_id`` ``[..., lanes]`` -> ``[..., lanes]`` i32."""
    if _build.resolve_impl(impl, child_n) == "ref":
        return R.uct_argmax_running_ref(
            child_n, child_w, child_vl, parent_n, parent_id, valid, cp=cp,
            vl_weight=vl_weight, child_o=child_o, vl_mode=vl_mode)
    shape = child_n.shape
    lanes, a = shape[-2:]
    b = child_n[..., 0, 0].numel()
    dev = child_n.device
    if valid is None:
        valid = torch.ones(shape, dtype=torch.bool, device=dev)
    o = child_o if child_o is not None else torch.zeros(shape, device=dev)
    pn = torch.as_tensor(parent_n, device=dev)
    out = torch.empty(shape[:-1], dtype=torch.int32, device=dev)
    board = (b, lanes, a)
    f32 = torch.float32
    launch_running(_as(child_n, f32, shape).view(board),
                   _as(child_w, f32, shape).view(board),
                   _as(child_vl, f32, shape).view(board),
                   _as(o, f32, shape).view(board),
                   _as(pn, f32, shape[:-1]).view(b, lanes),
                   valid.bool().expand(shape).contiguous().view(board),
                   parent_id.to(torch.int32).expand(shape[:-1]).contiguous()
                   .view(b, lanes), out.view(b, lanes),
                   cp=cp, vl_weight=vl_weight, wu=vl_mode == "wu")
    return out

