"""Search-tree entry points over the batched ``core.arena.TreeArena``.

The PyTorch counterpart of ``repro.core.tree``: a tree starts from
``domain.root_state()``, or from a root state the caller computed once,
and then takes the cross-token warm-start hooks the domain carries
(``root_warm``, ``root_arena`` / ``root_arena_alive``).  Every function
keeps the arena's leading batch axis (one tree per search root); a
``RootCarry`` dict's leaves may carry it too (``[B]``, ``[B, A]``) or be
one root's (``[]``, ``[A]``), which then applies to every root.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.arena import (ROOT, UNEXPANDED, TreeArena,  # noqa: F401
                                    init_arena, live_mask, reroot_ok)
from repro_torch.core.arena import reroot as _arena_reroot

Tree = TreeArena


def init_tree(domain, max_nodes: int, *, batch: int = 1, device=None,
              root_state=None) -> Tree:
    """Trees for ``domain``: with ``root_state`` (leaves ``[B] + S``,
    computed once by the search entry points) one tree per root on the
    leaves' device; without it, ``batch`` trees rooted at
    ``domain.root_state()`` on ``device`` (by default the carried arena's
    device when the domain carries one, else the CPU).

    Then the domain's optional warm-start hooks apply, as in the JAX
    package:

    * ``domain.root_warm`` -- a ``RootCarry`` seeding each root's N / W /
      prior (``warm_start_root``);
    * ``domain.root_arena`` -- a carried arena of the same capacity,
      spliced in leaf by leaf (bookkeeping and every state leaf) where
      ``domain.root_arena_alive`` (``[B]`` or one flag; None means alive).
      A dead root keeps the cold tree, bit for bit.
    """
    carried = getattr(domain, "root_arena", None)
    if carried is not None and carried.max_nodes != max_nodes:
        raise ValueError(
            f"the carried arena has {carried.max_nodes} rows, the search "
            f"{max_nodes}: a carry splices only into a tree of its own "
            "capacity")
    if root_state is None:
        if device is None:
            device = "cpu" if carried is None else carried.device
        root_state = {}
        for k, v in domain.root_state().items():
            v = torch.as_tensor(v, device=device)
            root_state[k] = v.expand((batch,) + tuple(v.shape))
    tree = init_arena(root_state, domain.num_actions, max_nodes,
                      domain.is_terminal(root_state))
    warm = getattr(domain, "root_warm", None)
    if warm is not None:
        tree = warm_start_root(tree, warm)
    if carried is not None:
        if carried.device != tree.device:
            raise ValueError(f"the carried arena lies on {carried.device}, "
                             f"the tree on {tree.device}")
        alive = getattr(domain, "root_arena_alive", None)
        alive = (torch.ones(1, dtype=torch.bool, device=tree.device)
                 if alive is None else
                 torch.as_tensor(alive).to(tree.device).reshape(-1))
        for f in ("visits", "value", "vloss", "unobs", "parent", "action",
                  "children", "prior", "terminal", "next_free", "free_list",
                  "free_top"):
            _splice(alive, getattr(carried, f), getattr(tree, f))
        for k, v in tree.state.items():
            _splice(alive, carried.state[k], v)
    return tree


def _splice(alive: torch.Tensor, carried: torch.Tensor,
            cold: torch.Tensor) -> None:
    """``cold = where(alive[:, None, ...], carried, cold)``, written into
    ``cold`` (the fresh tree's plane) so no second plane is allocated."""
    mask = alive.view((-1,) + (1,) * (cold.dim() - 1))
    torch.where(mask, carried, cold, out=cold)


def empty_root_carry(num_actions: int, batch=None,
                     device="cpu") -> Dict[str, torch.Tensor]:
    """The identity ``RootCarry``: warm-starting with it is bit for bit a
    cold search (zero visits, uniform prior).  One root's leaves, or with
    ``batch`` a leading axis of that size."""
    a = num_actions
    lead = () if batch is None else (batch,)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {"visits": torch.zeros(lead, **i32),
            "value": torch.zeros(lead, **f32),
            "prior": torch.full(lead + (a,), 1.0 / a, **f32),
            "child_visits": torch.zeros(lead + (a,), **i32),
            "child_value": torch.zeros(lead + (a,), **f32)}


def root_carry(tree: Tree, action) -> Dict[str, torch.Tensor]:
    """Each root's child ``action [B]`` compacted into a ``RootCarry``
    (leaves ``[B]`` / ``[B, A]``): its N / W, its prior row and its
    children's N / W -- the statistic-level warm start.  A missing child
    gives the identity carry."""
    a = tree.num_actions
    rows = torch.arange(tree.batch, device=tree.device)
    action = torch.as_tensor(action, device=tree.device).long() \
        .expand(tree.batch)
    c = tree.children[rows, ROOT, action]
    has = c >= 0
    ci = c.clamp_min(0).long()
    gch = tree.children[rows, ci]                     # grandchildren [B, A]
    gvalid = (gch >= 0) & has[:, None]
    gi = gch.clamp_min(0).long()
    uniform = torch.full((a,), 1.0 / a, dtype=torch.float32,
                         device=tree.device)
    return {
        "visits": torch.where(has, tree.visits[rows, ci], 0).int(),
        "value": torch.where(has, tree.value[rows, ci], 0.0).float(),
        "prior": torch.where(has[:, None], tree.prior[rows, ci], uniform),
        "child_visits": torch.where(gvalid, tree.visits.gather(1, gi),
                                    0).int(),
        "child_value": torch.where(gvalid, tree.value.gather(1, gi),
                                   0.0).float()}


def reroot(tree: Tree, action) -> Tree:
    """Promote each root's child ``action [B]`` to the root and recycle the
    abandoned rows (``core.arena.reroot``): the next search's ready-made
    tree.  Carried ``terminal`` flags reflect the previous horizon; a
    caller that moves the horizon refreshes them."""
    return _arena_reroot(tree, action)


def warm_start_root(tree: Tree, carry: Dict[str, Any]) -> Tree:
    """Seed each root's N / W from a ``RootCarry`` and blend its prior with
    the carried grandchild visit distribution: ``(prior + cv) / (1 +
    sum cv)``, bit for bit the identity for ``empty_root_carry``.  Returns
    a new tree (the other planes shared)."""
    n, w, p, cv = (torch.as_tensor(carry[k]).to(tree.device) for k in
                   ("visits", "value", "prior", "child_visits"))
    cv = cv.float()
    prior = (p.float() + cv) / (1.0 + cv.sum(-1, keepdim=True))
    visits, value, pri = tree.visits.clone(), tree.value.clone(), \
        tree.prior.clone()
    visits[:, ROOT] = n.int()
    value[:, ROOT] = w.float()
    pri[:, ROOT] = prior
    return tree.replace(visits=visits, value=value, prior=pri)


def max_nodes(tree: Tree) -> int:
    return tree.max_nodes


def num_actions(tree: Tree) -> int:
    return tree.num_actions


def root_action_by_visits(tree: Tree) -> torch.Tensor:
    """[B] most-visited root child (the robust child), first on ties."""
    n, _, valid = root_child_stats(tree)
    return torch.argmax(torch.where(valid, n, -1), dim=-1)


def get_state(tree: Tree, node: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Domain state of ``node`` ([B, ...] row indices) in each root's tree."""
    b = torch.arange(tree.batch, device=tree.device)
    b = b.view((-1,) + (1,) * (node.dim() - 1)).expand_as(node)
    return {k: v[b, node] for k, v in tree.state.items()}


def root_child_stats(tree: Tree):
    """Root children's ``(n [B, A] i32, w [B, A] f32, valid [B, A] bool)``."""
    ch = tree.children[:, ROOT]
    valid = ch >= 0
    idx = ch.clamp_min(0).long()
    n = torch.where(valid, tree.visits.gather(1, idx), 0)
    w = torch.where(valid, tree.value.gather(1, idx), 0.0)
    return n, w, valid


def check_consistency(tree: Tree) -> Dict[str, torch.Tensor]:
    """Invariant summary per root ([B] tensors): in-flight planes drained,
    visit flow conserved at the root, parent pointers live."""
    n = tree.max_nodes
    idx = torch.arange(n, device=tree.device)
    alive = live_mask(tree)
    ch = tree.children[:, ROOT]
    child_n = tree.visits.gather(1, ch.clamp_min(0).long())
    child_sum = torch.where(ch >= 0, child_n, 0).sum(-1)
    nonroot = alive & (idx != ROOT)[None, :]
    p = tree.parent
    p_alive = alive.gather(1, p.clamp(0, n - 1).long())
    ok_parent = torch.where(nonroot, (p >= 0) & (p < n) & p_alive,
                            True).all(-1)
    return {"vloss_drained": (tree.vloss == 0).all(-1),
            "unobs_drained": (tree.unobs == 0).all(-1),
            "visit_flow": child_sum <= tree.visits[:, ROOT],
            "parents_valid": ok_parent,
            "nodes": alive.sum(-1)}
