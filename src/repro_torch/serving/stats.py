"""Serving metrics: per-request lifecycle timings + engine-level counters.

A copy of ``repro.serving.stats`` (numpy and the standard
library only): importing the JAX package's own would run
``repro/serving/__init__.py``, which imports JAX.

``ServingStats`` is the metrics half of the request-lifecycle subsystem
(DESIGN.md §12).  The engine calls one hook per lifecycle transition
(``on_submit`` / ``on_admit`` / ``on_token`` / ``on_preempt`` /
``on_finish`` / ``on_step``) and ``snapshot()`` flattens everything into
one ``{"serving/<metric>": float}`` dict — the wandb-log idiom (HomebrewNLP
``wandblog.py``): flat slash-prefixed keys, cheap to compute, safe to call
at any point in the run, ready to hand to any scalar logger.

Tracked per request (keyed by ``Request.uid``):

* ``queue_wait``  — submit -> first admission into a slot
* ``ttft``        — submit -> first emitted token (time to first token)
* ``latency``     — submit -> finish
* per-token gaps  — interval between consecutive emitted tokens
* ``preemptions`` — times the request was evicted and requeued

Engine-level: requests submitted/admitted/finished, preemption events,
tokens, steps, wall tokens/s.  Distributions keep a bounded sample list and
report nearest-rank p50/p95.

All timestamps come from one injectable monotonic ``clock`` so latencies
are well defined; tests may pass a fake clock for determinism.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    if not xs:
        raise ValueError("percentile of an empty sample")
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(-(-q / 100.0 * len(s) // 1)) - 1))
    return float(s[k])


class Series:
    """Bounded sample series: count/sum always exact, percentiles over the
    first ``max_samples`` observations (enough for serving dashboards; exact
    in every test-sized run)."""

    def __init__(self, max_samples: int = 4096):
        self.max_samples = max_samples
        self.samples: List[float] = []
        self.count = 0
        self.total = 0.0

    def add(self, v: float) -> None:
        self.count += 1
        self.total += float(v)
        if len(self.samples) < self.max_samples:
            self.samples.append(float(v))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def p(self, q: float) -> float:
        return percentile(self.samples, q) if self.samples else 0.0

    def summary(self, name: str) -> Dict[str, float]:
        if not self.count:
            return {}
        return {f"{name}_mean": self.mean, f"{name}_p50": self.p(50),
                f"{name}_p95": self.p(95)}


@dataclasses.dataclass
class RequestTiming:
    """Lifecycle timestamps of one request (all from ``ServingStats.now``)."""
    enqueue_t: float
    admit_t: Optional[float] = None        # first admission only
    first_token_t: Optional[float] = None
    last_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    tokens: int = 0
    preemptions: int = 0

    def summary(self) -> Dict[str, Any]:
        done = self.finish_t is not None
        return {
            "queue_wait": (self.admit_t - self.enqueue_t
                           if self.admit_t is not None else None),
            "ttft": (self.first_token_t - self.enqueue_t
                     if self.first_token_t is not None else None),
            "latency": self.finish_t - self.enqueue_t if done else None,
            "tokens": self.tokens,
            "preemptions": self.preemptions,
            "done": done,
        }


class ServingStats:
    """Engine-level counters + per-request timings with a flat snapshot."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 max_samples: int = 4096):
        self._clock = clock
        self.requests: Dict[int, RequestTiming] = {}
        self.queue_wait = Series(max_samples)
        self.ttft = Series(max_samples)
        self.token_latency = Series(max_samples)   # inter-token gaps
        self.request_latency = Series(max_samples)
        self.submitted = 0
        self.admissions = 0
        self.finished = 0
        self.preemptions = 0
        self.tokens = 0
        self.steps = 0
        self.searches = 0
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None

    def now(self) -> float:
        return self._clock()

    # -- lifecycle hooks ----------------------------------------------------
    def on_submit(self, uid: int, t: float) -> None:
        self.submitted += 1
        self.requests[uid] = RequestTiming(enqueue_t=t)
        if self._t0 is None:
            self._t0 = t
        self._t_last = t

    def on_admit(self, uid: int, t: float) -> None:
        self.admissions += 1
        r = self.requests[uid]
        if r.admit_t is None:                      # first admission only
            r.admit_t = t
            self.queue_wait.add(t - r.enqueue_t)
        self._t_last = t

    def on_token(self, uid: int, t: float) -> None:
        r = self.requests[uid]
        r.tokens += 1
        self.tokens += 1
        if r.first_token_t is None:
            r.first_token_t = t
            self.ttft.add(t - r.enqueue_t)
        else:
            self.token_latency.add(t - r.last_token_t)
        r.last_token_t = t
        self._t_last = t

    def on_preempt(self, uid: int, t: float) -> None:
        self.preemptions += 1
        self.requests[uid].preemptions += 1
        self._t_last = t

    def on_finish(self, uid: int, t: float) -> None:
        self.finished += 1
        r = self.requests[uid]
        r.finish_t = t
        self.request_latency.add(t - r.enqueue_t)
        self._t_last = t

    def on_step(self, emitted: int, searched: int = 0) -> None:
        self.steps += 1
        self.searches += searched

    # -- reporting ----------------------------------------------------------
    def request_summaries(self) -> Dict[int, Dict[str, Any]]:
        return {uid: r.summary() for uid, r in self.requests.items()}

    def snapshot(self) -> Dict[str, float]:
        """Flat ``{"serving/<metric>": float}`` dict (wandblog idiom)."""
        out = {
            "serving/requests_submitted": float(self.submitted),
            "serving/requests_admitted": float(self.admissions),
            "serving/requests_finished": float(self.finished),
            "serving/preemptions": float(self.preemptions),
            "serving/tokens": float(self.tokens),
            "serving/steps": float(self.steps),
            "serving/searches": float(self.searches),
        }
        if self._t0 is not None and self._t_last is not None:
            wall = self._t_last - self._t0
            out["serving/wall_s"] = wall
            if wall > 0:
                out["serving/tokens_per_s"] = self.tokens / wall
        for name, series in (("queue_wait", self.queue_wait),
                             ("ttft", self.ttft),
                             ("token_latency", self.token_latency),
                             ("request_latency", self.request_latency)):
            out.update({f"serving/{k}": v
                        for k, v in series.summary(name).items()})
        return out
