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
row ``max_nodes``, which every masked write then drops.

Unlike the JAX arena, the planes are updated IN PLACE by the stage
functions and kernels (a search tree is large and each stage touches a few
rows of it).  A caller that needs the planes as they were clones them.
"""
from __future__ import annotations

import dataclasses
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
