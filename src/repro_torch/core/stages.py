"""The four MCTS operation-level tasks as stage functions on the batched arena.

The PyTorch counterpart of ``repro.core.stages``: Select / Expand / Playout
/ Backup over a ``TreeArena`` whose planes carry a leading batch axis ``B``
(one search per root).  Stage buffers are dicts of ``[B, lanes, ...]``
tensors.  The stages update the arena's planes in place and return it.

Differences from the JAX stages, none of which changes a result:

* the data-dependent ``while_loop`` descents run ``max_depth`` masked
  levels (an all-inactive level is a no-op), so no level needs a host sync;
* ``vmap`` over lanes and roots is written out as the ``[B, lanes]`` axes;
* randomness is an explicit ``draws`` tensor ``[B, lanes, *draw_shape]``.

``SearchParams.kernels`` is "auto" | "cuda" | "ref": "auto" resolves to
"cuda" for an arena on a CUDA device and "ref" on the CPU; "cuda" on the
CPU raises.  ``wave_select="auto"`` resolves to "mega" under "cuda", else
"scan".
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import uct
from repro_torch.core.arena import add_rows, alloc, set_rows
from repro_torch.core.tree import ROOT, UNEXPANDED, Tree, get_state

WAVE_SELECT_MODES = ("auto", "scan", "lockstep", "mega")
KERNEL_MODES = ("auto", "cuda", "ref")
LEVEL_ASSIGN_MODES = ("independent", "running")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    cp: float = 1.414
    vl_weight: float = 1.0
    max_depth: int = 32
    puct: bool = False
    # in-flight statistics: "loss" (virtual loss) or "wu" (WU-UCT counts)
    vl_mode: str = "loss"
    # which implementation backs the kernels: "auto" | "cuda" | "ref"
    kernels: str = "auto"
    # Select-stage iteration order: "auto" | "scan" | "lockstep" | "mega"
    wave_select: str = "auto"
    # within-level lane assignment of the depth-major paths
    level_assign: str = "independent"

    def __post_init__(self):
        for name, modes in (("vl_mode", uct.VL_MODES),
                            ("kernels", KERNEL_MODES),
                            ("wave_select", WAVE_SELECT_MODES),
                            ("level_assign", LEVEL_ASSIGN_MODES)):
            if getattr(self, name) not in modes:
                raise ValueError(f"{name} must be one of {modes}, "
                                 f"got {getattr(self, name)!r}")

    @property
    def wu(self) -> bool:
        return self.vl_mode == "wu"

    @property
    def running(self) -> bool:
        return self.level_assign == "running"

    @property
    def path_len(self) -> int:
        return self.max_depth + 2          # root .. deepest leaf + new child

    def resolved_kernels(self, device) -> str:
        on_cuda = torch.device(device).type == "cuda"
        if self.kernels == "auto":
            return "cuda" if on_cuda else "ref"
        if self.kernels == "cuda" and not on_cuda:
            raise ValueError(f"kernels='cuda' needs CUDA tensors, got {device}")
        return self.kernels

    def resolved_wave_select(self, device) -> str:
        if self.wave_select == "auto":
            return "mega" if self.resolved_kernels(device) == "cuda" \
                else "scan"
        return self.wave_select


def lane_valid(valid, batch: int, lanes: int, device) -> torch.Tensor:
    """Broadcast a wave-validity flag (scalar, ``[B]`` or ``[B, lanes]``)."""
    v = torch.as_tensor(valid, dtype=torch.bool, device=device)
    if v.dim() == 1:
        v = v[:, None]
    return v.expand(batch, lanes)


def _i32(shape, fill, device):
    return torch.full(shape, fill, dtype=torch.int32, device=device)


def empty_selection(sp: SearchParams, batch: int, lanes: int, device):
    f = torch.zeros((batch, lanes), dtype=torch.bool, device=device)
    return {"path": _i32((batch, lanes, sp.path_len), UNEXPANDED, device),
            "leaf": _i32((batch, lanes), 0, device),
            "depth": _i32((batch, lanes), 0, device),
            "valid": f, "dup": f.clone(), "dup_within": f.clone(),
            "dup_cross": f.clone()}


def empty_expansion(sp: SearchParams, tree: Tree, lanes: int):
    """An empty Expand->Playout buffer; its state takes the dtypes and
    trailing shapes of the arena's state planes."""
    batch, device = tree.batch, tree.device
    state = {k: torch.zeros((batch, lanes) + tuple(v.shape[2:]),
                            dtype=v.dtype, device=device)
             for k, v in tree.state.items()}
    return {"path": _i32((batch, lanes, sp.path_len), UNEXPANDED, device),
            "node": _i32((batch, lanes), 0, device),
            "is_new": torch.zeros((batch, lanes), dtype=torch.bool,
                                  device=device),
            "state": state,
            "valid": torch.zeros((batch, lanes), dtype=torch.bool,
                                 device=device)}


def empty_playout(sp: SearchParams, batch: int, lanes: int,
                  num_actions: int, device):
    f = torch.zeros((batch, lanes), dtype=torch.bool, device=device)
    return {"path": _i32((batch, lanes, sp.path_len), UNEXPANDED, device),
            "node": _i32((batch, lanes), 0, device),
            "is_new": f,
            "value": torch.zeros((batch, lanes), dtype=torch.float32,
                                 device=device),
            "priors": torch.zeros((batch, lanes, num_actions),
                                  dtype=torch.float32, device=device),
            "valid": f.clone()}


def infl_plane(tree: Tree, sp: SearchParams) -> torch.Tensor:
    """The mode's in-flight counter plane: ``unobs`` ("wu") / ``vloss``."""
    return tree.unobs if sp.wu else tree.vloss


def with_infl(tree: Tree, sp: SearchParams, plane) -> Tree:
    """Write ``plane`` back to the mode's in-flight field."""
    return tree.replace(unobs=plane) if sp.wu else tree.replace(vloss=plane)


def where_lead(mask, a, b):
    """``torch.where(mask, a, b)`` for state leaves ``lead + S`` under a
    ``lead``-shaped mask (the mask is aligned from the left)."""
    m = mask.view(tuple(mask.shape) + (1,) * (a.dim() - mask.dim()))
    return torch.where(m, a, b)


def put_col(path, col, vals, mask):
    """``path[..., col] = vals`` where ``mask`` (``col`` per row)."""
    cols = torch.arange(path.shape[-1], device=path.device)
    hit = mask[..., None] & (cols == col[..., None])
    return torch.where(hit, vals[..., None], path)


def _lane_active(tree: Tree, sp: SearchParams, bi, node, depth):
    fully = (tree.children[bi, node] >= 0).all(-1)
    return fully & ~tree.terminal[bi, node] & (depth < sp.max_depth)


# ---------------------------------------------------------------------------
# SELECT
# ---------------------------------------------------------------------------
def select_one(tree: Tree, sp: SearchParams, valid):
    """Descend from each root; adds the trajectory's in-flight count.
    ``valid`` is a scalar or ``[B]``; returns ``(tree, sel)`` with ``[B]``
    fields and ``path [B, P]``."""
    dev, bsz = tree.device, tree.batch
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev).expand(bsz)
    kern = sp.resolved_kernels(dev)
    infl = infl_plane(tree, sp)
    b = torch.arange(bsz, device=dev)
    bi = b[:, None]
    node = _i32((bsz,), ROOT, dev)
    depth = _i32((bsz,), 0, dev)
    path = _i32((bsz, sp.path_len), UNEXPANDED, dev)
    path[:, 0] = ROOT
    active = _lane_active(tree, sp, b, node, depth)
    for _ in range(sp.max_depth):
        ch = tree.children[b, node]                          # [B, A]
        idx = ch.clamp_min(0)
        ci = infl[bi, idx]
        a = uct.uct_argmax(
            tree.visits[bi, idx], tree.value[bi, idx], ci,
            tree.visits[b, node] + infl[b, node], sp.cp,
            vl_weight=sp.vl_weight, prior=tree.prior[b, node], puct=sp.puct,
            valid=ch >= 0, kernels=kern, child_o=ci, vl_mode=sp.vl_mode)
        nxt = ch.gather(1, a.long()[:, None])[:, 0]
        path = put_col(path, depth + 1, nxt, active)
        node = torch.where(active, nxt, node)
        depth = depth + active.int()
        active = active & _lane_active(tree, sp, b, node, depth)
    dup = (infl[b, node] > 0) & valid
    mask = (path >= 0) & valid[:, None]
    add_rows(infl, path.clamp_min(0), mask.int())
    sel = {"path": torch.where(valid[:, None], path, UNEXPANDED),
           "leaf": node, "depth": depth, "valid": valid, "dup": dup}
    return tree, sel


def _stack_lanes(dicts):
    return {k: torch.stack([d[k] for d in dicts], dim=1) for k in dicts[0]}


def _dup_within(leaf, valid, mask_earlier):
    """A lower-numbered lane of the same wave selected the same leaf."""
    eq = torch.tril(leaf[..., :, None] == leaf[..., None, :], diagonal=-1)
    if mask_earlier:
        eq = eq & valid[..., None, :]
    return eq.any(-1) & valid


def select_wave_scan(tree: Tree, sp: SearchParams, lanes: int, valid):
    """Lane-major Select: lane i+1 sees lane i's in-flight count."""
    infl_pre = infl_plane(tree, sp).clone()
    sels = _stack_lanes([select_one(tree, sp, valid)[1]
                         for _ in range(lanes)])
    leaf, v = sels["leaf"], sels["valid"]
    sels["dup_within"] = _dup_within(leaf, v, True)
    sels["dup_cross"] = (infl_pre.gather(1, leaf.long()) > 0) & v
    return tree, sels


def select_wave_fused(tree: Tree, sp: SearchParams, lanes: int, valid):
    """Depth-major lockstep Select: each level scores every lane's children
    with one batched ``[B, lanes, A]`` argmax (independent or running), then
    adds +1 in-flight on every selected child.  A lane's own count on its
    current node is excluded from ``parent_n``."""
    dev, bsz = tree.device, tree.batch
    valid = lane_valid(valid, bsz, lanes, dev)
    kern = sp.resolved_kernels(dev)
    infl = infl_plane(tree, sp)
    infl_pre = infl.clone()
    infl[:, ROOT] += valid.sum(-1).int()
    bi = torch.arange(bsz, device=dev)[:, None]
    bia = bi[:, :, None]
    node = _i32((bsz, lanes), ROOT, dev)
    depth = _i32((bsz, lanes), 0, dev)
    path = _i32((bsz, lanes, sp.path_len), UNEXPANDED, dev)
    path[:, :, 0] = ROOT
    active = valid & _lane_active(tree, sp, bi, node, depth)
    for _ in range(sp.max_depth):
        ch = tree.children[bi, node]                         # [B, L, A]
        idx = ch.clamp_min(0)
        own = active.int()
        pn = tree.visits[bi, node] + infl[bi, node] - own
        ci = infl[bia, idx]
        kw = dict(vl_weight=sp.vl_weight, prior=tree.prior[bi, node],
                  puct=sp.puct, valid=(ch >= 0) & active[..., None],
                  kernels=kern, child_o=ci, vl_mode=sp.vl_mode)
        if sp.running:
            a = uct.uct_argmax_running(tree.visits[bia, idx],
                                       tree.value[bia, idx], ci, pn, node,
                                       sp.cp, **kw)
        else:
            a = uct.uct_argmax(tree.visits[bia, idx], tree.value[bia, idx],
                               ci, pn, sp.cp, **kw)
        nxt = ch.gather(2, a.long()[..., None])[..., 0]
        path = put_col(path, depth + 1, nxt, active)
        add_rows(infl, torch.where(active, nxt, 0), own)
        node = torch.where(active, nxt, node)
        depth = depth + own
        active = active & _lane_active(tree, sp, bi, node, depth)
    dup_within = _dup_within(node, valid, False)
    dup_cross = (infl_pre.gather(1, node.long()) > 0) & valid
    sel = {"path": torch.where(valid[..., None], path, UNEXPANDED),
           "leaf": node, "depth": depth, "valid": valid,
           "dup": dup_within | dup_cross,
           "dup_within": dup_within, "dup_cross": dup_cross}
    return tree, sel


def select_wave(tree: Tree, sp: SearchParams, lanes: int, valid):
    """Dispatch on the resolved ``wave_select``; "mega" descends like
    "lockstep" here (the fusion happens in ``mega_round``/``mega_tick``)."""
    if sp.resolved_wave_select(tree.device) in ("lockstep", "mega"):
        return select_wave_fused(tree, sp, lanes, valid)
    return select_wave_scan(tree, sp, lanes, valid)


# ---------------------------------------------------------------------------
# EXPAND
# ---------------------------------------------------------------------------
def expand_one(tree: Tree, domain, sp: SearchParams, sel):
    """Allocate one child per root at the selected leaf (``[B]`` fields)."""
    leaf, depth, valid = sel["leaf"], sel["depth"], sel["valid"]
    b = torch.arange(tree.batch, device=tree.device)
    row = tree.children[b, leaf]
    free = row == UNEXPANDED
    can_try = valid & free.any(-1) & ~tree.terminal[b, leaf]
    tree, new, can = alloc(tree, can_try)
    a = torch.argmax(free.int(), dim=-1).int()
    parent_state = get_state(tree, leaf)
    child_state = domain.step(parent_state, a)
    term = domain.is_terminal(child_state)
    rows = new[:, None]
    for k, buf in tree.state.items():
        set_rows(buf, rows, child_state[k][:, None], can[:, None])
    add_rows(infl_plane(tree, sp), torch.where(can, new, 0)[:, None],
             can.int()[:, None])
    tree.children[b[can], leaf[can], a[can]] = new[can]
    set_rows(tree.parent, rows, leaf[:, None], can[:, None])
    set_rows(tree.action, rows, a[:, None], can[:, None])
    set_rows(tree.terminal, rows, term[:, None], can[:, None])
    node = torch.where(can, new, leaf)
    all_rows = torch.ones_like(can)
    path = put_col(sel["path"], depth + 1,
                   torch.where(can, new, UNEXPANDED), all_rows)
    state = {k: where_lead(can, child_state[k], parent_state[k])
             for k in child_state}
    return tree, {"path": path, "node": node, "is_new": can, "state": state,
                  "valid": valid}


def expand_wave(tree: Tree, domain, sp: SearchParams, sels):
    """Expand the wave's lanes in lane order (serial stage)."""
    lanes = sels["leaf"].shape[1]
    exps = []
    for i in range(lanes):
        tree, exp = expand_one(tree, domain, sp,
                               {k: sels[k][:, i]
                                for k in ("path", "leaf", "depth", "valid")})
        exps.append(exp)
    out = _stack_lanes([{k: v for k, v in e.items() if k != "state"}
                        for e in exps])
    out["state"] = _stack_lanes([e["state"] for e in exps])
    return tree, out


# ---------------------------------------------------------------------------
# PLAYOUT — parallel over roots and lanes
# ---------------------------------------------------------------------------
def playout_wave(domain, sp: SearchParams, exp, draws):
    """Play out every lane's state with its draws ``[B, lanes, ...]``."""
    values = domain.playout(exp["state"], draws)
    if hasattr(domain, "priors"):
        priors = domain.priors(exp["state"])
    else:
        a = domain.num_actions
        priors = torch.full(exp["node"].shape + (a,), 1.0 / a,
                            dtype=torch.float32, device=exp["node"].device)
    return {"path": exp["path"], "node": exp["node"], "is_new": exp["is_new"],
            "value": values.float(), "priors": priors,
            "valid": exp["valid"]}


# ---------------------------------------------------------------------------
# BACKUP
# ---------------------------------------------------------------------------
def backup_wave(tree: Tree, po, sp: SearchParams = None):
    """Add N/W along the paths in lane-major, path-position order, drain
    the mode's in-flight plane, and write the new rows' priors.
    ``sp=None`` means "loss" mode."""
    paths, valid = po["path"], po["valid"]
    bsz = paths.shape[0]
    mask = ((paths >= 0) & valid[..., None]).reshape(bsz, -1)
    idx = paths.clamp_min(0).reshape(bsz, -1)
    vals = po["value"][..., None].expand(paths.shape).reshape(bsz, -1)
    infl = tree.unobs if (sp is not None and sp.wu) else tree.vloss
    add_rows(infl, idx, -mask.int())
    add_rows(tree.visits, idx, mask.int())
    add_rows(tree.value, idx, torch.where(mask, vals, 0.0))
    set_rows(tree.prior, po["node"], po["priors"], po["is_new"] & valid)
    return tree


# ---------------------------------------------------------------------------
# MEGA — fused select→expand(→backup) waves (kernels/search_wave)
# ---------------------------------------------------------------------------
def mega_round(tree: Tree, domain, sp: SearchParams, lanes: int, valid,
               draws):
    """One tree-parallel round as [select→expand] + playout + [backup]."""
    from repro_torch.kernels.search_wave import ops as wave
    return wave.tree_round(tree, domain, sp, lanes, valid, draws)


def mega_tick(tree: Tree, domain, sp: SearchParams, lanes: int, wave_valid,
              buf_se, buf_ep, buf_pb, draws):
    """One pipeline tick as one [backup→expand→select] launch plus the
    out-of-launch playout and expand finish."""
    from repro_torch.kernels.search_wave import ops as wave
    return wave.pipeline_tick(tree, domain, sp, lanes, wave_valid,
                              buf_se, buf_ep, buf_pb, draws)
