"""Request lifecycle scheduling for the serving engine (DESIGN.md §12).

A copy of ``repro.serving.scheduler`` (numpy and the standard
library only): importing the JAX package's own would run
``repro/serving/__init__.py``, which imports JAX.

The paper's pipeline keeps every *stage* busy with useful work; this module
is the same idea one layer up — an explicit task structure the serving loop
schedules against, instead of ad-hoc slot bookkeeping inside the engine.
``RequestScheduler`` owns the admission queue and the per-slot state
machine; the engine owns device state (KV rows, prefix buffers, search
carry) and reacts to the scheduler's events.

State machine per slot::

    free --admit--> live --retire--> free     (finished: budget / EOS / capacity)
                      '--evict--> requeued    (preempted by higher priority,
                                               or forced by an elastic shrink;
                                               ``disable`` then retires the
                                               slot from the pool for good)

* **Admission policy** (``policy=``): ``"fcfs"`` admits in arrival order,
  ``"spf"`` shortest-prompt-first (by *effective* prefix — prompt plus
  committed tokens — so requeued requests are ordered by real prefill
  cost).  Both order by ``Request.priority`` first (higher wins).
* **Preemption**: when every slot is live and a queued request has strictly
  higher priority than the lowest-priority live request, that victim is
  evicted and requeued *with its committed tokens intact* — on readmission
  its prompt + ``out_tokens`` become the prefix and only the remaining
  budget is decoded.  FCFS position is preserved across eviction (the
  request keeps its original arrival sequence number).
* **Budgets**: per-slot ``remaining`` decode budget, derived from
  ``max_new_tokens`` minus committed tokens at admission; the engine may
  clamp it further (KV/sequence capacity) via ``cap_remaining``.

``schedule()`` performs every admission/eviction possible right now and
returns the ordered event list; it is safe to call at any point (idempotent
when nothing can move), which is what lets the engine refill a slot in the
same engine step that freed it (EOS mid-budget, DESIGN.md §12).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

POLICIES = ("fcfs", "spf")


@dataclasses.dataclass
class Request:
    """One decode request.  ``priority`` orders admission and drives
    preemption (higher = more important; default 0).  ``enqueue_t`` /
    ``finish_t`` are populated by the engine from its stats clock."""
    uid: int
    prompt: np.ndarray                 # [len] int32
    max_new_tokens: int = 16
    priority: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    enqueue_t: float = 0.0
    finish_t: float = 0.0

    @property
    def prefix_len(self) -> int:
        """Effective prefix: prompt plus already-committed tokens."""
        return len(self.prompt) + len(self.out_tokens)

    @property
    def budget_left(self) -> int:
        return self.max_new_tokens - len(self.out_tokens)


@dataclasses.dataclass(frozen=True)
class Admit:
    slot: int
    req: Request


@dataclasses.dataclass(frozen=True)
class Evict:
    slot: int
    req: Request


class RequestScheduler:
    """Admission queue + per-slot request state machine."""

    def __init__(self, num_slots: int, policy: str = "fcfs"):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; one of {POLICIES}")
        if num_slots < 1:
            raise ValueError(f"need at least one slot, got {num_slots}")
        self.policy = policy
        self.num_slots = num_slots
        # slot keeps its last request after retire (engine/tests inspect it);
        # _live is the authoritative occupancy bit
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._live = [False] * num_slots
        self._disabled = [False] * num_slots
        self.remaining = np.zeros(num_slots, np.int64)
        self._queue: List[Request] = []
        self._seq = 0
        self._seq_of = {}                  # uid -> arrival sequence number

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.uid not in self._seq_of:    # evictions keep their FCFS spot
            self._seq_of[req.uid] = self._seq
            self._seq += 1
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    def _order_key(self, req: Request):
        if self.policy == "spf":
            return (-req.priority, req.prefix_len, self._seq_of[req.uid])
        return (-req.priority, self._seq_of[req.uid])

    # -- slot views ---------------------------------------------------------
    @property
    def slots(self) -> List[Optional[Request]]:
        """Last request seen by each slot (live or just-finished)."""
        return list(self._slots)

    def request(self, slot: int) -> Optional[Request]:
        return self._slots[slot]

    def is_live(self, slot: int) -> bool:
        return self._live[slot]

    def live(self) -> List[int]:
        return [i for i in range(self.num_slots) if self._live[i]]

    # -- budgets ------------------------------------------------------------
    def cap_remaining(self, slot: int, n: int) -> None:
        self.remaining[slot] = min(int(self.remaining[slot]), n)

    def on_token(self, slot: int) -> None:
        self.remaining[slot] -= 1

    def exhausted(self, slot: int) -> bool:
        return int(self.remaining[slot]) <= 0

    # -- transitions --------------------------------------------------------
    def retire(self, slot: int) -> None:
        """live -> free.  The request object stays visible in ``slots``."""
        self._live[slot] = False
        self.remaining[slot] = 0

    def evict(self, slot: int) -> Optional[Evict]:
        """Forced eviction of one slot (elastic shrink, DESIGN.md §13):
        live -> requeued with committed tokens and FCFS seq intact — the
        same contract as priority preemption, but driven by the world
        changing instead of by a better candidate.  No-op on a free slot."""
        if not self._live[slot]:
            return None
        victim = self._slots[slot]
        self._live[slot] = False
        self.remaining[slot] = 0
        self._queue.append(victim)
        return Evict(slot, victim)

    def disable(self, slots) -> None:
        """Remove slots from the admission pool (a lost host's slots after a
        shrink).  Disabled slots are never admitted to again; live requests
        on them must be ``evict``-ed by the caller first."""
        for s in slots:
            self._disabled[s] = True

    def num_enabled(self) -> int:
        return sum(not d for d in self._disabled)

    def is_disabled(self, slot: int) -> bool:
        return self._disabled[slot]

    def _victim(self) -> Optional[int]:
        """Lowest-priority live slot; ties broken by least progress (fewest
        committed tokens — cheapest to redo), then slot index."""
        live = self.live()
        if not live:
            return None
        return min(live, key=lambda i: (self._slots[i].priority,
                                        len(self._slots[i].out_tokens), i))

    def schedule(self) -> List[object]:
        """Admit every queued request a slot can be found for, evicting
        strictly-lower-priority live requests when the pool is full.
        Returns the ordered ``Admit``/``Evict`` events performed."""
        events: List[object] = []
        while self._queue:
            qi = min(range(len(self._queue)),
                     key=lambda j: self._order_key(self._queue[j]))
            cand = self._queue[qi]
            slot = next((i for i in range(self.num_slots)
                         if not self._live[i] and not self._disabled[i]),
                        None)
            if slot is None:
                v = self._victim()
                # candidates are ordered priority-first, so if the best one
                # cannot preempt, none can — stop
                if v is None or self._slots[v].priority >= cand.priority:
                    break
                victim = self._slots[v]
                self._live[v] = False
                self.remaining[v] = 0
                self._queue.append(victim)     # committed tokens ride along
                events.append(Evict(v, victim))
                slot = v
            self._queue.pop(qi)
            self._slots[slot] = cand
            self._live[slot] = True
            self.remaining[slot] = cand.budget_left
            events.append(Admit(slot, cand))
        return events
