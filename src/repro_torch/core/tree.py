"""Search-tree entry points over the batched ``core.arena.TreeArena``.

The PyTorch counterpart of ``repro.core.tree`` on the cold path: a tree
starts from ``domain.root_state()``, or from a root state the caller
computed once.  Every function keeps the arena's
leading batch axis (one tree per search root).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.arena import (ROOT, UNEXPANDED, TreeArena,  # noqa: F401
                                    init_arena, live_mask)

Tree = TreeArena


def init_tree(domain, max_nodes: int, *, batch: int = 1, device="cpu",
              root_state=None) -> Tree:
    """Cold trees for ``domain``: with ``root_state`` (leaves ``[B] + S``,
    computed once by the search entry points) one tree per root on the
    leaves' device; without it, ``batch`` trees rooted at
    ``domain.root_state()`` on ``device``."""
    if root_state is None:
        root_state = {}
        for k, v in domain.root_state().items():
            v = torch.as_tensor(v, device=device)
            root_state[k] = v.expand((batch,) + tuple(v.shape))
    return init_arena(root_state, domain.num_actions, max_nodes,
                      domain.is_terminal(root_state))


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
