"""Scalability metrics (paper §II definitions 1 & 2, §III-B overheads).

A copy of ``repro.core.metrics`` (numpy only), kept in the port because
``repro.core``'s package imports JAX.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np


def playout_speedup(t_seq: float, t_par: float) -> float:
    """Definition 1: wall-time speedup at equal playout budget."""
    return t_seq / max(t_par, 1e-12)


def strength(actions: Sequence[int], optimal: int) -> float:
    """Fraction of runs recommending the optimal root action."""
    a = np.asarray(list(actions))
    return float((a == optimal).mean())


def strength_speedup(seq_strength: float, par_strength: float) -> float:
    """Definition 2 proxy: strength retention at equal budget (1.0 = perfect)."""
    return par_strength / max(seq_strength, 1e-12)


def search_overhead(seq_curve: Dict[int, float], par_curve: Dict[int, float],
                    target: float) -> float:
    """SO = budget_par(target) / budget_seq(target), interpolated on
    strength-vs-budget curves. SO = 1 means no wasted playouts; > 1 means the
    parallel search needs proportionally more playouts (paper §III-B)."""
    def budget_for(curve):
        bs = np.array(sorted(curve))
        ss = np.array([curve[b] for b in bs])
        if ss.max() < target:
            return float("inf")
        i = int(np.argmax(ss >= target))
        if i == 0:
            return float(bs[0])
        # linear interpolation in log-budget
        b0, b1, s0, s1 = bs[i - 1], bs[i], ss[i - 1], ss[i]
        if s1 == s0:
            return float(b1)
        f = (target - s0) / (s1 - s0)
        return float(np.exp(np.log(b0) + f * (np.log(b1) - np.log(b0))))

    return budget_for(par_curve) / budget_for(seq_curve)


def duplicate_rate(duplicates: int, playouts: int) -> float:
    """In-flight duplicate-selection fraction — the direct, per-run search
    overhead signal (bounded by pipeline depth; grows with threads in tree
    parallelization)."""
    return duplicates / max(playouts, 1)
