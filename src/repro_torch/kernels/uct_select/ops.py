"""Fused UCT argmax: CUDA kernel wrappers with the plain version beside them.

``uct_argmax`` scores ``[..., A]`` boards row by row (kernel
``uct_tiles_kernel`` of ``csrc/uct_select.cu``, replacing the Pallas
``uct_argmax_tiles`` / ``_uct_kernel`` of ``repro/kernels/uct_select``);
``uct_argmax_running`` walks each root's ``[lanes, A]`` board in lane order
(``uct_running_kernel``, replacing ``uct_argmax_running_call`` /
``_uct_running_kernel``).

Bound on an H100: launch latency and a dependent chain — a Select level's
board is a few KB.  ``uct_tiles_kernel`` runs one thread per row; the
running walk stages each root's board in shared memory and walks every
group of lanes sharing a parent at once, so its chain is the largest group.
See the source note in ``csrc/uct_select.cu``.

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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch_tiles(n, w, vl, o, pn, valid, out, *, cp, vl_weight, wu):
    """Launch ``uct_tiles_kernel`` on checked ``[R, A]`` operands."""
    r, a = n.shape
    dev = n.device
    for t, nm in ((n, "n"), (w, "w"), (vl, "vl"), (o, "o")):
        _build.check_operand(t, nm, torch.float32, (r, a), dev)
    _build.check_operand(pn, "pn", torch.float32, (r,), dev)
    _build.check_operand(valid, "valid", torch.bool, (r, a), dev)
    _build.check_operand(out, "out", torch.int32, (r,), dev)
    fn = _build.bind("uct_select", "uct_argmax_tiles",
                     [_P] * 7 + [_I, _I, _F, _F, _I, _P])
    _build.check(fn(n.data_ptr(), w.data_ptr(), vl.data_ptr(), o.data_ptr(),
                    pn.data_ptr(), valid.data_ptr(), out.data_ptr(), r, a,
                    float(cp), float(vl_weight), int(wu), _stream(dev)),
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


def _f32(x, shape):
    return x.to(torch.float32).expand(shape).contiguous()


def uct_argmax(child_n, child_w, child_vl, parent_n, *, cp, vl_weight=1.0,
               valid=None, child_o=None, vl_mode: str = "loss", impl=None):
    """Best child per row of ``[..., A]`` boards -> ``[...]`` i32."""
    if _build.resolve_impl(impl, child_n) == "ref":
        return R.uct_argmax_ref(child_n, child_w, child_vl, parent_n, valid,
                                cp=cp, vl_weight=vl_weight, child_o=child_o,
                                vl_mode=vl_mode)
    shape = child_n.shape
    r, a = child_n[..., 0].numel(), shape[-1]
    dev = child_n.device
    if valid is None:
        valid = torch.ones(shape, dtype=torch.bool, device=dev)
    o = child_o if child_o is not None else torch.zeros(shape, device=dev)
    pn = torch.as_tensor(parent_n, device=dev)
    out = torch.empty(shape[:-1], dtype=torch.int32, device=dev)
    launch_tiles(_f32(child_n, shape).view(r, a),
                 _f32(child_w, shape).view(r, a),
                 _f32(child_vl, shape).view(r, a), _f32(o, shape).view(r, a),
                 _f32(pn, shape[:-1]).view(r),
                 valid.bool().expand(shape).contiguous().view(r, a), out.view(r),
                 cp=cp, vl_weight=vl_weight, wu=vl_mode == "wu")
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
    launch_running(_f32(child_n, shape).view(board),
                   _f32(child_w, shape).view(board),
                   _f32(child_vl, shape).view(board),
                   _f32(o, shape).view(board),
                   _f32(pn, shape[:-1]).view(b, lanes),
                   valid.bool().expand(shape).contiguous().view(board),
                   parent_id.to(torch.int32).expand(shape[:-1]).contiguous()
                   .view(b, lanes), out.view(b, lanes),
                   cp=cp, vl_weight=vl_weight, wu=vl_mode == "wu")
    return out

