"""Fused search wave: CUDA kernel wrappers, their plain versions, and the
round / tick compositions that ``stages.mega_round`` / ``mega_tick`` call.

Three wrappers, one per ``__global__`` entry of ``csrc/search_wave.cu``:

* ``se``  — Select(lockstep) -> Expand(structural), replacing the Pallas
  ``se_call`` / ``_se_kernel`` of ``repro/kernels/search_wave/kernel.py``;
* ``bes`` — Backup(wave t-3) -> Expand(t-1) -> Select(t) of one pipeline
  tick, replacing ``bes_call`` / ``_bes_kernel``;
* ``b``   — Backup alone, replacing ``b_call`` / ``_b_kernel``.

Bound on an H100: a dependent chain — a wave is at most max_depth
dependent levels of small gathers per root, plus short walks over the
lanes that share a node, far below the card's byte and operation rates.
The kernels run one block per root, each lane's A children spread over a
sub-group of threads; see the source note in ``csrc/search_wave.cu``.

Each wrapper takes its plain version (``ref.py`` and ``core.stages``) for
CPU tensors or ``impl="ref"``, and launches the kernel for CUDA tensors,
raising on a failed build or launch.  The kernel updates visits / value /
the in-flight plane / prior / children in place; the parent and action
pointers, the free-list bookkeeping and the path append are applied here
(``_apply_es``), as the JAX package's ``ops.py`` does.  The in-flight plane
is ``vloss`` in "loss" mode and ``unobs`` in "wu" mode.  ``launches`` counts
kernel launches per entry point, and ``se_running`` / ``bes_running`` those
of them that walk the running assignment (``level_assign="running"``).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import stages as S
from repro_torch.core.arena import UNEXPANDED, TreeArena, set_rows
from repro_torch.kernels import _build
from repro_torch.kernels.search_wave import ref as R

launches = {"se": 0, "bes": 0, "b": 0, "se_running": 0, "bes_running": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CFG_ARGS = [_I] * 6 + [_F, _F] + [_I] * 4 + [_P]
MAX_SMEM = 227 * 1024


def _plain(sp):
    return dataclasses.replace(sp, kernels="ref")


def _planes(tree: TreeArena, sp):
    """The arena planes the kernel updates in place, checked as they are."""
    b, n, a = tree.batch, tree.max_nodes, tree.num_actions
    dev = tree.device
    planes = (("visits", torch.int32, (b, n)),
              ("value", torch.float32, (b, n)),
              ("unobs" if sp.wu else "vloss", torch.int32, (b, n)),
              ("prior", torch.float32, (b, n, a)),
              ("children", torch.int32, (b, n, a)),
              ("terminal", torch.bool, (b, n)),
              ("free_list", torch.int32, (b, n)),
              ("next_free", torch.int32, (b,)),
              ("free_top", torch.int32, (b,)))
    out = []
    for name, dt, shape in planes:
        t = getattr(tree, name)
        _build.check_operand(t, name, dt, shape, dev)
        out.append(t)
    return out


def _pb(po, b, lanes, p, a, dev):
    """The six Playout->Backup operands, contiguous and typed."""
    return (po["path"].to(torch.int32).expand(b, lanes, p).contiguous(),
            po["value"].to(torch.float32).expand(b, lanes).contiguous(),
            po["priors"].to(torch.float32).expand(b, lanes, a).contiguous(),
            po["node"].to(torch.int32).expand(b, lanes).contiguous(),
            po["is_new"].to(torch.bool).expand(b, lanes).contiguous(),
            po["valid"].to(torch.bool).expand(b, lanes).contiguous())


def _outs(b, lanes, p, dev):
    e = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
    return (e(b, lanes), e(b, lanes), e(b, lanes, p), e(b, lanes, 2),
            e(b, lanes), e(b, lanes), e(b, lanes))


def _check_launch(lanes, a, sp, select=True):
    if not 1 <= lanes <= 1024:
        raise ValueError(f"search_wave kernels take 1..1024 lanes, got {lanes}")
    fn = _build.bind("search_wave", "sw_smem_bytes", [_I] * 5)
    smem = fn(lanes, a, sp.path_len, int(select and sp.puct),
              int(select and sp.running))
    if smem > MAX_SMEM:
        raise ValueError(f"search_wave needs {smem} B of shared memory for "
                         f"lanes={lanes}, A={a}; the card offers {MAX_SMEM}")


def _cfg_args(sp, lanes, b, n, a, wave_valid, dev):
    return (b, n, a, lanes, sp.path_len, sp.max_depth, float(sp.cp),
            float(sp.vl_weight), int(sp.puct), int(sp.wu), int(sp.running),
            int(bool(wave_valid)),
            torch.cuda.current_stream(dev).cuda_stream)


def _unpack_sel(s_leaf, s_depth, s_path, s_dup, valid):
    dup_w, dup_c = s_dup[..., 0] > 0, s_dup[..., 1] > 0
    return {"path": s_path, "leaf": s_leaf, "depth": s_depth, "valid": valid,
            "dup": dup_w | dup_c, "dup_within": dup_w, "dup_cross": dup_c}


def _apply_es(tree: TreeArena, sel_path, sel_depth, leafs, e_can, e_slot,
              e_new, valid):
    """Out-of-launch half of the structural expand: parent/action pointers,
    free-list bookkeeping, path append (mirrors ``ref.expand_wave_struct``;
    ``e_new`` already carries the ``max_nodes`` sentinel)."""
    can = e_can > 0
    r_total = can.sum(-1).int()
    pops = torch.minimum(r_total, tree.free_top)
    path = S.put_col(sel_path, sel_depth + 1,
                     torch.where(can, e_new, UNEXPANDED),
                     torch.ones_like(can))
    set_rows(tree.parent, e_new, leafs, can)
    set_rows(tree.action, e_new, e_slot, can)
    tree.next_free.add_(r_total - pops)
    tree.free_top.sub_(pops)
    return tree, {"leaf": leafs, "slot": e_slot, "new": e_new, "can": can,
                  "path": path, "node": torch.where(can, e_new, leafs),
                  "valid": valid}


def launch_se(tree: TreeArena, sp, lanes: int, wave_valid):
    """Launch ``sw_se_kernel``: updates the in-flight plane and children in
    place; returns ``(s_leaf, s_depth, s_path, s_dup, e_can, e_slot,
    e_new)``."""
    b, n, a, dev = tree.batch, tree.max_nodes, tree.num_actions, tree.device
    _check_launch(lanes, a, sp)
    planes = _planes(tree, sp)
    outs = _outs(b, lanes, sp.path_len, dev)
    fn = _build.bind("search_wave", "sw_se", [_P] * 16 + _CFG_ARGS)
    _build.check(fn(*[t.data_ptr() for t in planes + list(outs)],
                    *_cfg_args(sp, lanes, b, n, a, wave_valid, dev)), "sw_se")
    launches["se"] += 1
    launches["se_running"] += sp.running
    return outs


def launch_bes(tree: TreeArena, sp, lanes: int, wave_valid, se_leaf,
               se_valid, pb):
    """Launch ``sw_bes_kernel`` (``pb`` from ``pack_pb``): updates visits,
    value, the in-flight plane, prior and children in place; returns the
    select and expand outputs as ``launch_se`` does."""
    b, n, a, dev = tree.batch, tree.max_nodes, tree.num_actions, tree.device
    _check_launch(lanes, a, sp)
    planes = _planes(tree, sp)
    _build.check_operand(se_leaf, "se_leaf", torch.int32, (b, lanes), dev)
    _build.check_operand(se_valid, "se_valid", torch.bool, (b, lanes), dev)
    outs = _outs(b, lanes, sp.path_len, dev)
    fn = _build.bind("search_wave", "sw_bes", [_P] * 24 + _CFG_ARGS)
    ptrs = [t.data_ptr() for t in planes + [se_leaf, se_valid] + list(pb)
            + list(outs)]
    _build.check(fn(*ptrs, *_cfg_args(sp, lanes, b, n, a, wave_valid, dev)),
                 "sw_bes")
    launches["bes"] += 1
    launches["bes_running"] += sp.running
    return outs


def launch_b(tree: TreeArena, sp, pb) -> None:
    """Launch ``sw_b_kernel`` (``pb`` from ``pack_pb``): updates visits,
    value, the in-flight plane and prior in place."""
    bsz, n, a, dev = tree.batch, tree.max_nodes, tree.num_actions, tree.device
    lanes, p = pb[0].shape[1], sp.path_len
    _check_launch(lanes, a, sp, select=False)
    planes = _planes(tree, sp)[:4]
    fn = _build.bind("search_wave", "sw_b", [_P] * 10 + [_I] * 5 + [_P])
    _build.check(fn(*[t.data_ptr() for t in planes + list(pb)], bsz, n, a,
                    lanes, p, torch.cuda.current_stream(dev).cuda_stream),
                 "sw_b")
    launches["b"] += 1


def pack_pb(tree: TreeArena, sp, po):
    """The six Playout->Backup operands of a launch, contiguous and typed."""
    b, lanes = po["path"].shape[:2]
    return _pb(po, b, lanes, sp.path_len, tree.num_actions, tree.device)


def se(tree: TreeArena, sp, lanes: int, wave_valid, *, impl=None):
    """Select -> structural Expand of one wave (all lanes valid or none).
    Returns ``(tree, sel, es)``."""
    if _build.resolve_impl(impl, tree.children) == "ref":
        tree, sel = S.select_wave_fused(tree, _plain(sp), lanes, wave_valid)
        tree, es = R.expand_wave_struct(tree, sp, sel)
        return tree, sel, es
    s_leaf, s_depth, s_path, s_dup, e_can, e_slot, e_new = launch_se(
        tree, sp, lanes, wave_valid)
    valid = torch.full((tree.batch, lanes), bool(wave_valid),
                       device=tree.device)
    sel = _unpack_sel(s_leaf, s_depth, s_path, s_dup, valid)
    tree, es = _apply_es(tree, s_path, s_depth, s_leaf, e_can, e_slot, e_new,
                         valid)
    return tree, sel, es


def bes(tree: TreeArena, sp, lanes: int, wave_valid, buf_se, buf_pb, *,
        impl=None):
    """Backup(buf_pb) -> structural Expand(buf_se) -> Select(new wave) of
    one pipeline tick.  Returns ``(tree, new_se, es)``."""
    if _build.resolve_impl(impl, tree.children) == "ref":
        tree = S.backup_wave(tree, buf_pb, sp)
        tree, es = R.expand_wave_struct(tree, sp, buf_se)
        tree, new_se = S.select_wave_fused(tree, _plain(sp), lanes,
                                           wave_valid)
        return tree, new_se, es
    bsz = tree.batch
    se_leaf = buf_se["leaf"].to(torch.int32).contiguous()
    se_valid = buf_se["valid"].to(torch.bool).expand(bsz, lanes).contiguous()
    s_leaf, s_depth, s_path, s_dup, e_can, e_slot, e_new = launch_bes(
        tree, sp, lanes, wave_valid, se_leaf, se_valid,
        pack_pb(tree, sp, buf_pb))
    tree, es = _apply_es(tree, buf_se["path"], buf_se["depth"], se_leaf,
                         e_can, e_slot, e_new, buf_se["valid"])
    valid = torch.full((bsz, lanes), bool(wave_valid), device=tree.device)
    return tree, _unpack_sel(s_leaf, s_depth, s_path, s_dup, valid), es


def b(tree: TreeArena, sp, po, *, impl=None) -> TreeArena:
    """Backup alone: add N/W along ``po``'s paths, drain the in-flight
    plane, write the new rows' priors."""
    if _build.resolve_impl(impl, tree.children) == "ref":
        return S.backup_wave(tree, po, sp)
    launch_b(tree, sp, pack_pb(tree, sp, po))
    return tree


def tree_round(tree: TreeArena, domain, sp, lanes: int, valid, draws, *,
               impl=None):
    """One fused tree-parallel round: launch 1 is Select -> Expand, then
    the out-of-launch domain finish and playout, then launch 2 is Backup.
    Waves are all-or-none.  Returns ``(tree, sel)``."""
    impl = impl or sp.resolved_kernels(tree.device)
    wv = bool(torch.as_tensor(valid).all())
    tree, sel, es = se(tree, sp, lanes, wv, impl=impl)
    tree, exp = R.finish_expand(tree, domain, es)
    po = S.playout_wave(domain, sp, exp, draws)
    tree = b(tree, sp, po, impl=impl)
    return tree, sel


def pipeline_tick(tree: TreeArena, domain, sp, lanes: int, wave_valid,
                  buf_se, buf_ep, buf_pb, draws, *, impl=None):
    """One fused pipeline tick: one Backup -> Expand -> Select launch, then
    the playout of wave t-2 and the domain finish of wave t-1 (Select never
    reads a same-tick row's state or terminal: a new row is not fully
    expanded).  Returns ``(tree, new_se, new_ep, new_pb)``."""
    impl = impl or sp.resolved_kernels(tree.device)
    tree, new_se, es = bes(tree, sp, lanes, wave_valid, buf_se, buf_pb,
                           impl=impl)
    new_pb = S.playout_wave(domain, sp, buf_ep, draws)
    tree, new_ep = R.finish_expand(tree, domain, es)
    return tree, new_se, new_ep, new_pb
