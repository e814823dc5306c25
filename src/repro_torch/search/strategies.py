"""The five built-in strategies — the PyTorch counterpart of
``repro.search.strategies``, over a batch of B roots.

Each strategy is ``fn(domain, cfg, draws, root_state)`` with ``draws``
``[B, *draws_shape]`` and ``root_state`` the B roots' state (leaves
``[B] + S``, computed once by the entry point); the draw layout follows
the JAX package's key-split tree, so a parity test can hand both the same
randomness:

  sequential  [budget, 1, *draw_shape]          split(rng, budget), lanes=1
  root        [workers, per, 1, *draw_shape]    split(rng, workers), then as
                                                sequential
  leaf        [iters, workers, *draw_shape]     split(rng, iters), then
                                                split(rng_t, workers)
  tree        [rounds, threads, *draw_shape]    split(rng, rounds), lanes
  pipeline    [n_ticks, lanes, *draw_shape]     split(rng, n_ticks), lanes

Every tree-bearing strategy builds its tree with ``core.tree.init_tree``,
so a domain's warm-start hooks (``root_warm``, ``root_arena``) apply to
each; ``root``, whose workers' trees start cold, rejects them.
Stats schema, ``duplicates`` and the ``extras`` are those of the JAX
package (``dup_within`` / ``dup_cross``; the pipeline's
``mean_occupancy`` and ``dup_per_tick``), each with a leading batch axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import stages as S
from repro_torch.core.arena import add_rows
from repro_torch.core.tree import init_tree, root_child_stats
from repro_torch.search.api import (SearchConfig, SearchResult, make_stats,
                                    register_strategy, result_from_tree)

__all__ = ["PIPE_STAGES", "sequential", "root", "leaf", "tree_parallel",
           "pipeline"]

PIPE_STAGES = 4          # S, E, P, B


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _workers(cfg: SearchConfig) -> int:
    return max(cfg.lanes, 1)


def _one_lane(exp):
    """A single-trajectory Expand buffer as a wave of one lane."""
    out = {k: v[:, None] for k, v in exp.items() if k != "state"}
    out["state"] = {k: v[:, None] for k, v in exp["state"].items()}
    return out


def _sequential_core(domain, sp, budget: int, max_nodes: int, draws,
                     root_state):
    """Shared S→E→P→B loop over ``draws [B, budget, 1, ...]``; returns
    ``(tree, values [B, budget], dups [B, budget])``."""
    tree = init_tree(domain, max_nodes or budget + 2,
                     root_state=root_state)
    values, dups = [], []
    for t in range(budget):
        tree, sel = S.select_one(tree, sp, True)
        tree, exp = S.expand_one(tree, domain, sp, sel)
        po = S.playout_wave(domain, sp, _one_lane(exp), draws[:, t])
        tree = S.backup_wave(tree, po, sp)
        values.append(po["value"][:, 0])
        dups.append(sel["dup"])
    return tree, torch.stack(values, 1), torch.stack(dups, 1)


def _seq_draws(domain, cfg):
    return (cfg.budget, 1) + tuple(domain.draw_shape)


@register_strategy("sequential", draws=_seq_draws)
def sequential(domain, cfg: SearchConfig, draws,
               root_state) -> SearchResult:
    tree, values, dups = _sequential_core(domain, cfg.params, cfg.budget,
                                          cfg.max_nodes, draws, root_state)
    stats = make_stats(tree.batch, cfg.budget, cfg.budget, dups.sum(1),
                       cfg.budget, tree.device)
    return result_from_tree(tree, stats, extras={"values": values})


def _root_draws(domain, cfg):
    w = _workers(cfg)
    return (w, _ceil_div(cfg.budget, w), 1) + tuple(domain.draw_shape)


@register_strategy("root", draws=_root_draws)
def root(domain, cfg: SearchConfig, draws, root_state) -> SearchResult:
    """Root parallelization / Ensemble UCT: ``lanes`` independent
    sequential searches per root (run as B x workers trees), root
    statistics summed.  ``tree`` is None."""
    if any(getattr(domain, h, None) is not None
           for h in ("root_warm", "root_arena")):
        raise ValueError("the root strategy takes no warm start (root_warm /"
                         " root_arena): its workers' trees start cold")
    bsz, workers = draws.shape[0], _workers(cfg)
    per = _ceil_div(cfg.budget, workers)
    tree, _, dups = _sequential_core(
        domain, cfg.params, per, cfg.max_nodes,
        draws.reshape((bsz * workers,) + tuple(draws.shape[2:])),
        {k: v.repeat_interleave(workers, 0) for k, v in root_state.items()})
    n, w, _ = root_child_stats(tree)
    a = n.shape[-1]
    n, w = n.view(bsz, workers, a), w.view(bsz, workers, a)
    visits, value = n[:, 0], w[:, 0]
    for i in range(1, workers):          # worker order, as the reference
        visits, value = visits + n[:, i], value + w[:, i]
    best = torch.argmax(torch.where(visits > 0, visits, -1), dim=-1).int()
    stats = make_stats(bsz, per * workers, per * workers,
                       dups.view(bsz, -1).sum(1), per, tree.device)
    return SearchResult(action_visits=visits.int(), action_value=value,
                        best_action=best, tree=None, stats=stats, extras={})


def _leaf_draws(domain, cfg):
    w = _workers(cfg)
    return (_ceil_div(cfg.budget, w), w) + tuple(domain.draw_shape)


@register_strategy("leaf", draws=_leaf_draws)
def leaf(domain, cfg: SearchConfig, draws,
         root_state) -> SearchResult:
    """Leaf parallelization: sequential S/E, ``lanes`` playouts from the
    selected leaf per iteration, aggregate backup."""
    sp, workers = cfg.params, _workers(cfg)
    iters = _ceil_div(cfg.budget, workers)
    tree = init_tree(domain, cfg.max_nodes or iters + 2,
                     root_state=root_state)
    dups = []
    for t in range(iters):
        tree, sel = S.select_one(tree, sp, True)
        tree, exp = S.expand_one(tree, domain, sp, sel)
        state = {k: v[:, None].expand((v.shape[0], workers) + v.shape[1:])
                 for k, v in exp["state"].items()}
        values = domain.playout(state, draws[:, t])        # [B, workers]
        v_sum = values[:, 0]
        for i in range(1, workers):
            v_sum = v_sum + values[:, i]
        paths = exp["path"]
        mask = paths >= 0
        idx = paths.clamp_min(0)
        add_rows(S.infl_plane(tree, sp), idx, -mask.int())
        add_rows(tree.visits, idx, mask.int() * workers)
        add_rows(tree.value, idx, torch.where(mask, v_sum[:, None], 0.0))
        dups.append(sel["dup"])
    dups = torch.stack(dups, 1)
    stats = make_stats(tree.batch, iters * workers, iters * workers,
                       dups.sum(1), iters, tree.device)
    return result_from_tree(tree, stats)


def _wave_draws(domain, cfg):
    lanes = _workers(cfg)
    return (_ceil_div(cfg.budget, lanes), lanes) + tuple(domain.draw_shape)


def _dup_sums(sels):
    return (sels["dup"].sum(-1), sels["dup_within"].sum(-1),
            sels["dup_cross"].sum(-1))


@register_strategy("tree", draws=_wave_draws)
def tree_parallel(domain, cfg: SearchConfig, draws,
                  root_state) -> SearchResult:
    """Tree parallelization with in-flight counts: per round, ``lanes``
    trajectories selected/expanded/played/backed up together."""
    sp, threads = cfg.params, _workers(cfg)
    rounds = _ceil_div(cfg.budget, threads)
    tree = init_tree(domain, cfg.max_nodes or rounds * threads + 2,
                     root_state=root_state)
    fused = sp.resolved_wave_select(tree.device) == "mega"
    dup = dup_w = dup_c = 0
    for t in range(rounds):
        if fused:
            tree, sels = S.mega_round(tree, domain, sp, threads, True,
                                      draws[:, t])
        else:
            tree, sels = S.select_wave(tree, sp, threads, True)
            tree, exps = S.expand_wave(tree, domain, sp, sels)
            po = S.playout_wave(domain, sp, exps, draws[:, t])
            tree = S.backup_wave(tree, po, sp)
        d, dw, dc = _dup_sums(sels)
        dup, dup_w, dup_c = dup + d, dup_w + dw, dup_c + dc
    stats = make_stats(tree.batch, rounds * threads, rounds * threads, dup,
                       rounds, tree.device)
    extras = {"dup_within": dup_w.int(), "dup_cross": dup_c.int()}
    return result_from_tree(tree, stats, extras)


def _pipe_draws(domain, cfg):
    lanes = _workers(cfg)
    n_ticks = _ceil_div(cfg.budget, lanes) + PIPE_STAGES - 1
    return (n_ticks, lanes) + tuple(domain.draw_shape)


@register_strategy("pipeline", draws=_pipe_draws)
def pipeline(domain, cfg: SearchConfig, draws,
             root_state) -> SearchResult:
    """The paper's contribution: software-pipelined MCTS.  One tick
    co-schedules  B(wave t-3) | P(wave t-2) | E(wave t-1) | S(wave t)."""
    sp, lanes = cfg.params, _workers(cfg)
    bsz = draws.shape[0]
    n_waves = _ceil_div(cfg.budget, lanes)
    tree = init_tree(domain, cfg.max_nodes or n_waves * lanes + 2,
                     root_state=root_state)
    n_ticks = n_waves + PIPE_STAGES - 1                   # fill + drain
    dev = tree.device
    buf_se = S.empty_selection(sp, bsz, lanes, dev)
    buf_ep = S.empty_expansion(sp, tree, lanes)
    buf_pb = S.empty_playout(sp, bsz, lanes, domain.num_actions, dev)
    fused = sp.resolved_wave_select(dev) == "mega"
    dups, dup_w, dup_c, completed, occupancy = [], 0, 0, 0, []
    for t in range(n_ticks):
        wave_valid = t < n_waves                          # drain: no Select
        if fused:
            tree, new_se, new_ep, new_pb = S.mega_tick(
                tree, domain, sp, lanes, wave_valid, buf_se, buf_ep, buf_pb,
                draws[:, t])
        else:
            tree = S.backup_wave(tree, buf_pb, sp)
            new_pb = S.playout_wave(domain, sp, buf_ep, draws[:, t])
            tree, new_ep = S.expand_wave(tree, domain, sp, buf_se)
            tree, new_se = S.select_wave(tree, sp, lanes, wave_valid)
        d, dw, dc = _dup_sums(new_se)
        dups.append(d)
        dup_w, dup_c = dup_w + dw, dup_c + dc
        completed = completed + buf_pb["valid"].sum(-1)
        occupancy.append(sum(buf["valid"].any(-1).int()
                             for buf in (new_se, buf_se, buf_ep, buf_pb)))
        buf_se, buf_ep, buf_pb = new_se, new_ep, new_pb
    dups = torch.stack(dups, 1).int()
    stats = make_stats(bsz, n_waves * lanes, completed, dups.sum(1), n_ticks,
                       dev)
    extras = {
        # mean as sum x float32(1 / n_ticks), the product XLA makes of the
        # JAX package's mean
        "mean_occupancy": torch.stack(occupancy, 1).float().sum(1)
        * float(np.float32(1.0) / np.float32(n_ticks)) / PIPE_STAGES,
        "dup_per_tick": dups,
        "dup_within": dup_w.int(),
        "dup_cross": dup_c.int(),
    }
    return result_from_tree(tree, stats, extras)
