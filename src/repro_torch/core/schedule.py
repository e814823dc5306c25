"""Analytic pipeline-schedule model — reproduces the paper's Figs. 3, 4, 6.

Host-side (numpy) simulation of makespan for a 4-stage MCTS pipeline with
per-stage costs in T units and ``lanes`` replicated Playout servers:

  Fig. 3: costs (1,1,1,1), lanes 1, 4 trajectories   -> 7 T
  Fig. 4: costs (1,1,2,1), lanes 1, 4 trajectories   -> 11 T
  Fig. 6: costs (1,1,2,1), lanes 2, 4 trajectories   -> 8 T

A copy of ``repro.core.schedule`` (numpy only), kept in the port because
``repro.core``'s package imports JAX.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

STAGES = ("select", "expand", "playout", "backup")


def pipeline_makespan(n_items: int, costs: Sequence[float] = (1, 1, 1, 1),
                      lanes: int = 1) -> float:
    """Makespan of n_items trajectories through S→E→P→B.

    Serial stages process items in order; the Playout stage has ``lanes``
    identical servers (the paper's nonlinear parallel stage, which may finish
    items out of order — Backup is commutative so any completion order is
    consumed as it arrives).
    """
    cs, ce, cp, cb = costs
    s_free = e_free = b_free = 0.0
    p_free = np.zeros(lanes)
    s_done = np.zeros(n_items)
    e_done = np.zeros(n_items)
    p_done = np.zeros(n_items)
    for i in range(n_items):
        s_start = max(s_free, 0.0)
        s_done[i] = s_start + cs
        s_free = s_done[i]
        e_start = max(e_free, s_done[i])
        e_done[i] = e_start + ce
        e_free = e_done[i]
        lane = int(np.argmin(p_free))
        p_start = max(p_free[lane], e_done[i])
        p_done[i] = p_start + cp
        p_free[lane] = p_done[i]
    # backup consumes completions in arrival order (out-of-order OK)
    makespan = 0.0
    for t in np.sort(p_done):
        b_start = max(b_free, t)
        b_free = b_start + cb
        makespan = b_free
    return float(makespan)


def sequential_makespan(n_items: int, costs: Sequence[float] = (1, 1, 1, 1)) -> float:
    return float(n_items * sum(costs))


def steady_state_throughput(costs: Sequence[float] = (1, 1, 1, 1),
                            lanes: int = 1) -> float:
    """Trajectories per T unit once the pipeline is full (paper §V-C)."""
    cs, ce, cp, cb = costs
    bottleneck = max(cs, ce, cp / lanes, cb)
    return 1.0 / bottleneck


def occupancy_trace(n_items: int, costs: Sequence[float] = (1, 1, 1, 1),
                    lanes: int = 1, dt: float = 0.25) -> Tuple[np.ndarray, np.ndarray]:
    """(time grid, #busy PEs) — visualizes fill/drain (paper §V-B)."""
    cs, ce, cp, cb = costs
    intervals: List[Tuple[float, float]] = []
    s_free = e_free = b_free = 0.0
    p_free = np.zeros(lanes)
    p_done = np.zeros(n_items)
    for i in range(n_items):
        s0 = s_free
        s_free = s0 + cs
        intervals.append((s0, s_free))
        e0 = max(e_free, s_free)
        e_free = e0 + ce
        intervals.append((e0, e_free))
        lane = int(np.argmin(p_free))
        p0 = max(p_free[lane], e_free)
        p_free[lane] = p0 + cp
        p_done[i] = p_free[lane]
        intervals.append((p0, p_free[lane]))
    for t in np.sort(p_done):
        b0 = max(b_free, t)
        b_free = b0 + cb
        intervals.append((b0, b_free))
    end = max(e for _, e in intervals)
    grid = np.arange(0.0, end + dt, dt)
    busy = np.zeros_like(grid)
    for (a, b) in intervals:
        busy += ((grid >= a) & (grid < b)).astype(float)
    return grid, busy
