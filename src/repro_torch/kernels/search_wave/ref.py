"""Plain PyTorch fused search wave — the counterpart of
``repro.kernels.search_wave.ref`` and the oracle of the CUDA kernels.

The fused wave replaces Expand's per-lane scan with one structural pass
(``expand_wave_struct``) and keeps Select as the lockstep descent.  It is
constructed to equal scanning ``stages.expand_one`` over the wave:

* slot choice — lane l takes the (k+1)-th UNEXPANDED slot of its leaf's
  pre-wave children row, k counting earlier lanes that expanded that leaf;
* row allocation — lane l's row is the (r+1)-th of the arena's allocation
  order (free-list LIFO first, then the ``next_free`` bump), r counting
  earlier lanes that allocated.

``finish_expand`` is the half that cannot run in a kernel: the domain's
``step`` over the wave and the new rows' state/terminal.  All fields are
``[B, lanes, ...]``; planes are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.core import stages as S
from repro_torch.core.arena import UNEXPANDED, TreeArena, add_rows, set_rows


def expand_wave_struct(tree: TreeArena, sp, sel):
    """Structural Expand for a whole wave: allocate rows and link children.
    Returns ``(tree, es)``; ``es["new"]`` holds the ``max_nodes`` sentinel
    where a lane could not expand."""
    leafs, depth, valid = sel["leaf"], sel["depth"], sel["valid"]
    n, bsz, lanes = tree.max_nodes, tree.batch, leafs.shape[1]
    bi = torch.arange(bsz, device=tree.device)[:, None]
    base_row = tree.children[bi, leafs]                   # [B, L, A] pre-wave
    free_m = base_row == UNEXPANDED
    free_cnt = free_m.sum(-1)
    csum = torch.cumsum(free_m.int(), dim=-1)
    term = tree.terminal[bi, leafs]
    nf0, ft0 = tree.next_free.clone(), tree.free_top.clone()
    cap0 = ft0 + (n - nf0)
    same = leafs[:, :, None] == leafs[:, None, :]         # [B, L, L]
    taken = torch.zeros_like(leafs)
    r = torch.zeros_like(nf0)
    cans, slots, news = [], [], []
    for i in range(lanes):
        can = valid[:, i] & ~term[:, i] & (free_cnt[:, i] > taken[:, i]) \
            & (r < cap0)
        hit = free_m[:, i] & (csum[:, i] == (taken[:, i] + 1)[:, None])
        slot = torch.argmax(hit.int(), dim=-1).int()
        pop = (ft0 - 1 - r).clamp(0, n - 1).long()
        new = torch.where(r < ft0, tree.free_list.gather(1, pop[:, None])[:, 0],
                          nf0 + (r - ft0))
        taken = taken + (same[:, i] & can[:, None]).int()
        r = r + can.int()
        cans.append(can)
        slots.append(slot)
        news.append(new)
    can = torch.stack(cans, 1)
    slot = torch.stack(slots, 1)
    new = torch.stack(news, 1)
    new_s = torch.where(can, new, n).int()
    pops = torch.minimum(r, ft0)
    path = S.put_col(sel["path"], depth + 1,
                     torch.where(can, new, UNEXPANDED).int(),
                     torch.ones_like(can))
    add_rows(S.infl_plane(tree, sp), torch.where(can, new_s, 0), can.int())
    bl = bi.expand_as(leafs)
    tree.children[bl[can], leafs[can], slot[can]] = new_s[can]
    set_rows(tree.parent, new_s, leafs, can)
    set_rows(tree.action, new_s, slot, can)
    tree.next_free.copy_(nf0 + (r - pops))
    tree.free_top.copy_(ft0 - pops)
    es = {"leaf": leafs, "slot": slot, "new": new_s, "can": can,
          "path": path, "node": torch.where(can, new_s, leafs),
          "valid": valid}
    return tree, es


def finish_expand(tree: TreeArena, domain, es):
    """Domain half of Expand (outside any kernel): ``domain.step`` over the
    wave, the new rows' state/terminal, and the Expand->Playout buffer."""
    bi = torch.arange(tree.batch, device=tree.device)[:, None]
    parent_state = {k: v[bi, es["leaf"]] for k, v in tree.state.items()}
    child_state = domain.step(parent_state, es["slot"])
    term = domain.is_terminal(child_state)
    can, new = es["can"], es["new"]
    set_rows(tree.terminal, new, term, can)
    for k, buf in tree.state.items():
        set_rows(buf, new, child_state[k], can)
    state = {k: S.where_lead(can, child_state[k], parent_state[k])
             for k in child_state}
    return tree, {"path": es["path"], "node": es["node"], "is_new": can,
                  "state": state, "valid": es["valid"]}


def tree_round(tree: TreeArena, domain, sp, lanes: int, valid, draws):
    """Fused tree-parallel round: lockstep Select -> structural Expand ->
    domain finish -> Playout -> Backup.  Returns ``(tree, sel)``."""
    tree, sel = S.select_wave_fused(tree, sp, lanes, valid)
    tree, es = expand_wave_struct(tree, sp, sel)
    tree, exp = finish_expand(tree, domain, es)
    po = S.playout_wave(domain, sp, exp, draws)
    tree = S.backup_wave(tree, po, sp)
    return tree, sel


def pipeline_tick(tree: TreeArena, domain, sp, lanes: int, wave_valid,
                  buf_se, buf_ep, buf_pb, draws):
    """Fused pipeline tick: B(wave t-3) -> P(t-2) -> E(t-1, structural +
    finish) -> S(t).  Returns ``(tree, new_se, new_ep, new_pb)``."""
    tree = S.backup_wave(tree, buf_pb, sp)
    new_pb = S.playout_wave(domain, sp, buf_ep, draws)
    tree, es = expand_wave_struct(tree, sp, buf_se)
    tree, new_ep = finish_expand(tree, domain, es)
    tree, new_se = S.select_wave_fused(tree, sp, lanes, wave_valid)
    return tree, new_se, new_ep, new_pb
