"""Straggler mitigation for the nonlinear pipeline's playout lanes — a
copy of ``repro.runtime.straggler`` (numpy only), so that the port imports
nothing of the JAX package.

The paper's parallel playout stages may complete out of order (§V-C); backup
is commutative, so a straggling lane can simply be dropped from its wave and
re-queued without corrupting the tree (its virtual loss is still removed via
the masked backup of the same path).  This module provides the host-side
policy used by the serving engine and by the training-loop collective layer
(deadline-based wave commit), plus a simulator to quantify throughput-vs-
drop-rate under heavy-tailed lane latencies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    deadline_factor: float = 3.0       # x median lane latency
    min_commit_frac: float = 0.75      # never commit a wave below this fill
    requeue: bool = True


def wave_commit_mask(latencies: np.ndarray, policy: StragglerPolicy
                     ) -> Tuple[np.ndarray, float]:
    """latencies [lanes] -> (keep mask, commit time).

    Lanes beyond deadline are dropped (re-queued into the next wave); the
    wave commits at the slowest KEPT lane.
    """
    med = float(np.median(latencies))
    deadline = policy.deadline_factor * med
    keep = latencies <= deadline
    if keep.mean() < policy.min_commit_frac:
        # deadline too aggressive for this wave: keep the fastest fraction
        k = int(np.ceil(policy.min_commit_frac * len(latencies)))
        thresh = np.partition(latencies, k - 1)[k - 1]
        keep = latencies <= thresh
    commit_time = float(latencies[keep].max()) if keep.any() else float(latencies.min())
    return keep, commit_time


def simulate_throughput(policy: StragglerPolicy, lanes: int, waves: int,
                        seed: int = 0, tail: float = 0.1) -> Dict[str, float]:
    """Heavy-tailed lane latency model: lognormal body + pareto stragglers."""
    rng = np.random.default_rng(seed)
    total_time = 0.0
    completed = 0
    dropped = 0
    for _ in range(waves):
        lat = rng.lognormal(0.0, 0.25, lanes)
        stragglers = rng.random(lanes) < tail
        lat = np.where(stragglers, lat * (1 + rng.pareto(1.5, lanes) * 3), lat)
        keep, t = wave_commit_mask(lat, policy)
        total_time += t
        completed += int(keep.sum())
        dropped += int((~keep).sum())
    baseline_time = 0.0
    rng = np.random.default_rng(seed)
    for _ in range(waves):
        lat = rng.lognormal(0.0, 0.25, lanes)
        stragglers = rng.random(lanes) < tail
        lat = np.where(stragglers, lat * (1 + rng.pareto(1.5, lanes) * 3), lat)
        baseline_time += float(lat.max())
    return {
        "throughput": completed / total_time,
        "baseline_throughput": (waves * lanes) / baseline_time,
        "drop_rate": dropped / (waves * lanes),
        "speedup": (completed / total_time) / ((waves * lanes) / baseline_time),
    }
