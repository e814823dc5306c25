"""Typed structure-of-arrays tree arena over a batch of search roots.

The PyTorch counterpart of ``repro.core.arena``.  Every plane gains a
leading batch axis ``B`` (one independent search tree per root), so one
arena holds a whole ``search_batch``:

    visits    [B, N] i32     visit count n_j
    value     [B, N] f32     reward sum  w_j
    vloss     [B, N] i32     virtual-loss counters (``vl_mode="loss"``)
    unobs     [B, N] i32     WU-UCT unobserved-sample counters O_j
                             (``vl_mode="wu"``)
    parent    [B, N] i32     parent index (-1 for root / unallocated)
    action    [B, N] i32     action taken from parent
    children  [B, N, A] i32  child indices (UNEXPANDED = -1)
    prior     [B, N, A] f32  child priors
    terminal  [B, N] bool    node is a terminal state
    state     dict           per-node domain state, leading dims [B, N]
    next_free [B] i32        bump-allocation high-water mark
    free_list [B, N] i32     LIFO stack of recycled row indices
    free_top  [B] i32        live depth of ``free_list``

Allocation contract: ``alloc`` pops ``free_list[free_top - 1]`` when the
stack is non-empty, else bumps ``next_free``; a failed allocation returns
row ``max_nodes``, which every masked write then drops.  ``release``
pushes rows onto the stack and resets their planes to the unallocated
state; ``compact`` / ``reroot`` renumber the live rows densely from the
(new) root, so ``next_free`` drops to the live count and the stack
empties: occupancy is bounded by the live subtree, not by search history.

Unlike the JAX arena, the planes are updated IN PLACE by the stage
functions and kernels (a search tree is large and each stage touches a few
rows of it).  A caller that needs the planes as they were clones them.
``release``, ``compact`` and ``reroot`` return a new arena and leave their
argument as it was.  None of them reads a value back to the host: the
JAX package's ``mode="drop"`` scatters become scatters into a plane padded
with one sentinel column, then cut back, and ``torch.where`` selects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

UNEXPANDED = -1
ROOT = 0


@dataclasses.dataclass(frozen=True)
class TreeArena:
    """Batched flat SoA search tree (see module docstring for the layout)."""

    visits: torch.Tensor
    value: torch.Tensor
    vloss: torch.Tensor
    unobs: torch.Tensor
    parent: torch.Tensor
    action: torch.Tensor
    children: torch.Tensor
    prior: torch.Tensor
    terminal: torch.Tensor
    state: Dict[str, torch.Tensor]
    next_free: torch.Tensor
    free_list: torch.Tensor
    free_top: torch.Tensor

    @property
    def batch(self) -> int:
        return self.children.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.children.shape[1]

    @property
    def num_actions(self) -> int:
        return self.children.shape[2]

    @property
    def device(self) -> torch.device:
        return self.children.device

    def replace(self, **updates) -> "TreeArena":
        return dataclasses.replace(self, **updates)

    @staticmethod
    def cat(arenas) -> "TreeArena":
        """Arenas concatenated along the batch axis."""
        arenas = list(arenas)
        out = {f.name: torch.cat([getattr(a, f.name) for a in arenas])
               for f in dataclasses.fields(TreeArena) if f.name != "state"}
        out["state"] = {k: torch.cat([a.state[k] for a in arenas])
                        for k in arenas[0].state}
        return TreeArena(**out)


def init_arena(root_state: Dict[str, Any], num_actions: int, max_nodes: int,
               root_terminal=False) -> TreeArena:
    """Fresh arena of B roots: root at row 0, every other row unallocated.
    ``root_state`` leaves are ``[B] + S``, one root each (``B`` from the
    leaves; a root shared by B searches is expanded to that shape by the
    caller); each becomes a plane ``[B, max_nodes] + S`` on the leaves'
    device."""
    leaves = {k: torch.as_tensor(v) for k, v in root_state.items()}
    if not leaves:
        raise ValueError("init_arena needs at least one root state leaf")
    lead = {v.shape[:1] for v in leaves.values()}
    if len(lead) != 1 or () in lead:
        shapes = {k: tuple(v.shape) for k, v in leaves.items()}
        raise ValueError("root state leaves must share a leading batch axis, "
                         f"got shapes {shapes}")
    b, n, a = lead.pop()[0], max_nodes, num_actions
    dev = next(iter(leaves.values())).device
    state = {}
    for k, v in leaves.items():
        buf = torch.zeros((b, n) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=dev)
        buf[:, ROOT] = v
        state[k] = buf
    i32 = dict(dtype=torch.int32, device=dev)
    terminal = torch.zeros((b, n), dtype=torch.bool, device=dev)
    terminal[:, ROOT] = torch.as_tensor(root_terminal).to(dev)
    return TreeArena(
        visits=torch.zeros((b, n), **i32),
        value=torch.zeros((b, n), dtype=torch.float32, device=dev),
        vloss=torch.zeros((b, n), **i32),
        unobs=torch.zeros((b, n), **i32),
        parent=torch.full((b, n), UNEXPANDED, **i32),
        action=torch.full((b, n), UNEXPANDED, **i32),
        children=torch.full((b, n, a), UNEXPANDED, **i32),
        prior=torch.full((b, n, a), 1.0 / a, dtype=torch.float32,
                         device=dev),
        terminal=terminal,
        state=state,
        next_free=torch.ones((b,), **i32),
        free_list=torch.zeros((b, n), **i32),
        free_top=torch.zeros((b,), **i32),
    )


def live_mask(arena: TreeArena) -> torch.Tensor:
    """[B, N] bool — row is allocated (root, or has a parent)."""
    idx = torch.arange(arena.max_nodes, device=arena.device)
    return (idx == ROOT)[None, :] | (arena.parent >= 0)


def capacity_left(arena: TreeArena) -> torch.Tensor:
    """[B] rows still allocatable (stack depth + untouched tail)."""
    return arena.free_top + (arena.max_nodes - arena.next_free)


def can_alloc(arena: TreeArena) -> torch.Tensor:
    return capacity_left(arena) > 0


def alloc(arena: TreeArena, take):
    """Allocate one row per root: ``(arena, row [B] i32, ok [B] bool)``.

    Pops the free-list LIFO first, else bumps ``next_free``.  ``row`` is the
    drop sentinel ``max_nodes`` where ``ok`` is False.  Only the bookkeeping
    moves (in place); the caller writes the row's planes."""
    n = arena.max_nodes
    take = torch.as_tensor(take, device=arena.device).expand(arena.batch)
    ok = take & can_alloc(arena)
    use_stack = ok & (arena.free_top > 0)
    top = (arena.free_top - 1).clamp_min(0).long()
    stack_row = arena.free_list.gather(1, top[:, None])[:, 0]
    row = torch.where(use_stack, stack_row, arena.next_free)
    row = torch.where(ok, row, torch.full_like(row, n))
    arena.next_free.add_((ok & ~use_stack).int())
    arena.free_top.sub_(use_stack.int())
    return arena, row, ok


def arena_stats(arena: TreeArena) -> Dict[str, torch.Tensor]:
    """[B]-shaped occupancy summary (no host sync)."""
    return {
        "live": live_mask(arena).sum(-1).int(),
        "next_free": arena.next_free,
        "free_top": arena.free_top,
        "capacity_left": capacity_left(arena).int(),
    }


# ---------------------------------------------------------------------------
# masked row writes — the counterpart of JAX's ``.at[...].set(mode="drop")``
# ---------------------------------------------------------------------------
def batch_index(rows: torch.Tensor) -> torch.Tensor:
    """The batch coordinate broadcast to ``rows`` ([B, ...] index tensor)."""
    b = torch.arange(rows.shape[0], device=rows.device)
    return b.view((-1,) + (1,) * (rows.dim() - 1)).expand_as(rows)


def set_rows(plane: torch.Tensor, rows: torch.Tensor, vals, mask) -> None:
    """``plane[b, rows[b, ...]] = vals`` where ``mask``; dropped elsewhere
    (rows may hold the out-of-range sentinel there).  In place."""
    mask = torch.as_tensor(mask, device=rows.device).expand_as(rows)
    vals = torch.as_tensor(vals, dtype=plane.dtype, device=plane.device)
    vals = vals.expand(rows.shape + plane.shape[2:])
    b = batch_index(rows)
    plane[b[mask], rows[mask]] = vals[mask]


def add_rows(plane: torch.Tensor, rows: torch.Tensor, vals) -> None:
    """``plane[b, rows[b, k]] += vals[b, k]`` accumulated in flat (b, k)
    order, which is the order of JAX's scatter-add; rows must be in range
    (callers add 0 at a clamped row for masked entries).  In place."""
    n = plane.shape[1]
    flat = (batch_index(rows).long() * n + rows.long()).reshape(-1)
    vals = torch.as_tensor(vals, dtype=plane.dtype, device=plane.device)
    plane.view(-1).index_put_((flat,), vals.expand(rows.shape).reshape(-1),
                              accumulate=True)


# ---------------------------------------------------------------------------
# the serving half: release, compaction and rerooting
# ---------------------------------------------------------------------------
def _lead(mask: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """A ``[B, N]`` mask shaped to broadcast over ``plane [B, N, ...]``."""
    return mask.view(mask.shape + (1,) * (plane.dim() - mask.dim()))


def _per_root(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor, or one Python value for every entry) shaped as
    ``like`` on its device; a Python value is filled in on the device, not
    copied from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(like.device).expand(like.shape)
    return torch.full(like.shape, x, device=like.device)


def _scatter_drop(shape, dtype, idx: torch.Tensor, vals, fill=0):
    """``[B, N]`` plane of ``fill`` with ``vals`` scattered at ``idx [B,
    K]``; entries whose index is the sentinel ``N`` are dropped (they land
    in a padding column that is cut off)."""
    b, n = shape
    out = torch.full((b, n + 1), fill, dtype=dtype, device=idx.device)
    out.scatter_(1, idx.long(), _per_root(vals, idx).to(dtype))
    return out[:, :n]


def release(arena: TreeArena, rows, mask=True) -> TreeArena:
    """Push ``rows [B, K]`` (where ``mask [B, K]``) onto each root's
    free-list and reset their planes to the unallocated state: parent and
    action -1, children UNEXPANDED, uniform prior, zero stats and state.
    Contract (not checked): masked rows are live, non-root and distinct
    within a root."""
    n, a = arena.max_nodes, arena.num_actions
    rows = torch.as_tensor(rows).to(arena.device, torch.int32)
    rows = rows.reshape(arena.batch, -1)
    mask = _per_root(mask, rows).bool()
    sentinel = torch.full_like(rows, n)
    freed = _scatter_drop((arena.batch, n), torch.bool,
                          torch.where(mask, rows, sentinel), True, False)
    rank = torch.cumsum(mask.int(), -1) - 1
    pos = torch.where(mask, arena.free_top[:, None] + rank, sentinel)
    pos = pos.clamp_max(n)
    free_list = torch.cat([arena.free_list, arena.free_list[:, :1]], 1)
    free_list.scatter_(1, pos.long(), rows)

    def reset(plane, fill):
        return plane.masked_fill(_lead(freed, plane), fill)

    return arena.replace(
        visits=reset(arena.visits, 0), value=reset(arena.value, 0.0),
        vloss=reset(arena.vloss, 0), unobs=reset(arena.unobs, 0),
        parent=reset(arena.parent, UNEXPANDED),
        action=reset(arena.action, UNEXPANDED),
        children=reset(arena.children, UNEXPANDED),
        prior=reset(arena.prior, 1.0 / a),
        terminal=reset(arena.terminal, False),
        state={k: reset(v, 0) for k, v in arena.state.items()},
        next_free=arena.next_free.clone(),
        free_list=free_list[:, :n],
        free_top=arena.free_top + mask.sum(-1).int())


def compact(arena: TreeArena, keep, new_root=ROOT) -> TreeArena:
    """Dense renumbering per root: kept rows (``keep [B, N]``, ``new_root
    [B]`` kept implicitly) pack to the front in their old order, with
    ``new_root`` at row 0.  Child and parent pointers are remapped;
    pointers at dropped rows become UNEXPANDED.  ``next_free`` becomes the
    live count and the free-list empties: every dropped row is allocatable
    again.  Every state leaf, a KV cache included, is renumbered."""
    b, n = arena.batch, arena.max_nodes
    dev = arena.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)[None, :]
    new_root = _per_root(new_root, arena.next_free)
    is_nr = idx == new_root[:, None]
    keep = _per_root(keep, arena.parent).bool() | is_nr
    others = keep & ~is_nr
    newidx = torch.where(is_nr, 0, torch.cumsum(others.int(), -1)).int()
    n_live = 1 + others.sum(-1).int()
    # src[b, j] = old index of the row that lands at j (j < n_live)
    src = _scatter_drop((b, n), torch.int32,
                        torch.where(keep, newidx, n), idx.expand(b, n))
    src = src.long()
    dst_live = idx < n_live[:, None]
    remap = torch.where(keep, newidx, UNEXPANDED).int()
    rows = torch.arange(b, device=dev)[:, None]

    def gather(plane, fill):
        out = plane[rows, src]            # a new tensor
        return out.masked_fill_(~_lead(dst_live, out), fill)

    def relink(ptr):
        at = remap.gather(1, ptr.clamp_min(0).long().reshape(b, -1))
        return torch.where(ptr >= 0, at.view_as(ptr), UNEXPANDED).int()

    parent = relink(gather(arena.parent, UNEXPANDED))
    parent[:, ROOT] = UNEXPANDED
    action = gather(arena.action, UNEXPANDED)
    action[:, ROOT] = UNEXPANDED
    return arena.replace(
        visits=gather(arena.visits, 0), value=gather(arena.value, 0.0),
        vloss=gather(arena.vloss, 0), unobs=gather(arena.unobs, 0),
        parent=parent, action=action,
        children=relink(gather(arena.children, UNEXPANDED)),
        prior=gather(arena.prior, 1.0 / arena.num_actions),
        terminal=gather(arena.terminal, False),
        state={k: gather(v, 0) for k, v in arena.state.items()},
        next_free=n_live, free_list=torch.zeros_like(arena.free_list),
        free_top=torch.zeros_like(arena.free_top))


def _root_child(arena: TreeArena, action) -> torch.Tensor:
    action = _per_root(action, arena.next_free).long()
    return arena.children[:, ROOT].gather(1, action[:, None])[:, 0]


def reroot_ok(arena: TreeArena, action) -> torch.Tensor:
    """[B] bool: root child ``action [B]`` exists, so rerooting onto it
    keeps a non-trivial subtree.  ``reroot`` onto a missing child
    compacts the whole live tree under the old root."""
    return _root_child(arena, action) >= 0


def reroot(arena: TreeArena, action) -> TreeArena:
    """Promote root child ``action [B]`` to row 0 of each root's arena and
    recycle everything not under it.  Reachability from the new root takes
    ``ceil(log2 N) + 1`` rounds of parent-pointer doubling (``reach |=
    reach[link]; link = link[link]``), then ``compact`` renumbers the
    subtree densely."""
    n = arena.max_nodes
    child = _root_child(arena, action)
    nr = torch.where(child >= 0, child, ROOT).int()
    idx = torch.arange(n, device=arena.device)[None, :]
    link = torch.where(arena.parent >= 0, arena.parent.long(), idx)
    reach = idx == nr[:, None]
    for _ in range(int(math.ceil(math.log2(max(n, 2)))) + 1):
        reach = reach | reach.gather(1, link)
        link = link.gather(1, link)
    return compact(arena, reach & live_mask(arena), nr)
