"""Continuous-batching serving engine (prefill/decode interleave).

The PyTorch counterpart of ``repro.serving.engine``: host-side
orchestration over the family's batched ``prefill`` / ``decode_step`` of
any ported architecture.  A fixed pool of ``max_batch`` decode slots;
finished or empty slots are refilled by prefilling queued requests into
the batch position (per-slot cache rows + per-slot positions), so decode
steps always run at full batch.

Request lifecycle: admission order, per-slot budgets and priority
preemption live in ``serving.scheduler.RequestScheduler``; the engine owns
device state (cache rows, prefix buffers) and reacts to the scheduler's
``Admit`` / ``Evict`` events.  ``ServingStats`` records the lifecycle
timings; ``run_until_drained`` returns its per-request summaries and
``ServingEngine.stats.snapshot()`` a flat dict.

Two per-slot decode modes (``EngineConfig.decode``):

* ``"greedy"`` — cached argmax decoding: each admission prefills its
  request alone and splices the cache row into its slot; each step is one
  ``decode_step`` over all slots.
* ``"mcts"``   — every engine step runs ONE batched multi-root search
  (``make_batched_searcher``) over all slots' prefixes and commits each
  live slot's chosen token.  With ``kv_splice`` / ``tree_reuse`` the
  searcher is a ``ReusableSearcher`` and the engine threads its per-slot
  carry: ``init_carry`` at construction, ``admit`` when a request is
  admitted (its only prefill under ``kv_splice``), ``step`` every engine
  step.  Eviction needs no call: readmission overwrites the slot.

Runs on ``cuda:0`` unless ``device`` is given; ``params`` are moved there
once.  ``EngineConfig.mesh`` shards the mcts searcher's slots over a
``repro_torch.parallel.SearchMesh`` (``MeshSearcher``; the engine then
runs on ``mesh.home`` unless ``device`` is given); ``False`` pins it to
one device, and ``None`` shards only inside an initialised process group
of world size > 1.  In a process group every process runs the same
engine in lockstep (the scheduler is deterministic), searches its own
slots and gathers the tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.base import ModelConfig, get_family, tree_to
from repro_torch.parallel.mesh import SearchMesh
from repro_torch.search.api import resolve_device
from repro_torch.serving.mcts_decode import (MCTSDecodeConfig,
                                             make_batched_searcher)
from repro_torch.serving.scheduler import Evict, Request, RequestScheduler
from repro_torch.serving.stats import ServingStats, percentile


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX package's ``EngineConfig``, field for field."""

    max_batch: int = 4
    max_seq: int = 256
    eos_token: int = -1                # -1: never stops early
    decode: str = "greedy"             # "greedy" | "mcts"
    policy: str = "fcfs"               # admission policy: "fcfs" | "spf"
    mcts: Optional[MCTSDecodeConfig] = None   # knobs for decode="mcts"
    # decode="mcts" mesh: None shards inside a process group of world
    # size > 1, False pins one device, or an explicit SearchMesh
    mesh: Any = None


class ServingEngine:
    """Continuous batching over the family's model steps."""

    def __init__(self, cfg: ModelConfig, params, engine_cfg: EngineConfig,
                 stats: Optional[ServingStats] = None, *, device=None):
        mesh = engine_cfg.mesh
        if not (mesh is None or mesh is False
                or isinstance(mesh, SearchMesh)):
            raise TypeError(f"EngineConfig.mesh must be None, False or a "
                            f"SearchMesh, got {type(mesh).__name__}")
        if engine_cfg.decode not in ("greedy", "mcts"):
            raise ValueError(f"unknown decode mode {engine_cfg.decode!r}")
        self.cfg = cfg
        self.ecfg = engine_cfg
        explicit = isinstance(mesh, SearchMesh)
        self.device = (mesh.home if explicit and device is None
                       else resolve_device(device))
        self.params = tree_to(params, self.device)
        self.fam = get_family(cfg)
        b, s = engine_cfg.max_batch, engine_cfg.max_seq
        self.stats = stats if stats is not None else ServingStats()
        self.sched = RequestScheduler(b, policy=engine_cfg.policy)
        self.mode = engine_cfg.decode
        # the persistent [L, B, S, ...] cache backs the greedy path; mcts
        # mode's per-slot caches live inside each per-token search
        self.cache = (self.fam.init_cache(cfg, b, s, device=self.device)
                      if self.mode == "greedy" else None)
        self._carry = None
        if self.mode == "mcts":
            self.mcfg = engine_cfg.mcts or MCTSDecodeConfig()
            # per-slot padded prefix buffers; true lengths ride separately
            self.prefix_buf = np.zeros((b, s), np.int32)
            self.prefix_len = np.zeros((b,), np.int32)
            self._searches = 0         # seeds each search's (empty) draws
            self._mcts_search = make_batched_searcher(
                cfg, self.params, self.mcfg, batch=b,
                device=None if explicit else self.device, mesh=mesh)
            if self.mcfg.stateful:
                self._carry = self._mcts_search.init_carry(s)

    # -- request intake ----------------------------------------------------
    @property
    def slots(self) -> List[Optional[Request]]:
        """Last request seen by each slot (live or just-finished)."""
        return self.sched.slots

    def submit(self, req: Request):
        if len(req.prompt) > self.ecfg.max_seq:
            raise ValueError(
                f"prompt of request {req.uid} has {len(req.prompt)} tokens, "
                f"exceeding max_seq={self.ecfg.max_seq}")
        req.enqueue_t = self.stats.now()
        self.stats.on_submit(req.uid, req.enqueue_t)
        self.sched.submit(req)

    def pending(self) -> int:
        return self.sched.pending()

    # -- scheduler event handlers -------------------------------------------
    def _admit_loop(self):
        """Apply scheduler events until quiescent.  Admissions that finish
        immediately (zero budget, prefill EOS, capacity) retire their slot,
        which can unblock another admission — hence the loop."""
        while True:
            events = self.sched.schedule()
            if not events:
                return
            for ev in events:
                if isinstance(ev, Evict):
                    self._on_evict(ev.slot, ev.req)
                else:
                    self._on_admit(ev.slot, ev.req)

    def _on_evict(self, i: int, req: Request):
        """Device state is dropped: the prefix buffer row is zeroed (mcts)
        or the cache row left dead until the slot is refilled (greedy).
        The request keeps its committed tokens; readmission re-prefills
        prompt + out_tokens."""
        self.stats.on_preempt(req.uid, self.stats.now())
        if self.mode == "mcts":
            self.prefix_buf[i] = 0
            self.prefix_len[i] = 0

    def shrink(self, lost_slots) -> List[int]:
        """Elastic shrink: a lost host's slots are evicted-and-requeued
        through the scheduler (victims keep their committed tokens and FCFS
        position) and removed from the admission pool for good.  Surviving
        slots are refilled immediately.  Returns the slots that held a
        live request."""
        lost = sorted({int(s) for s in lost_slots})
        newly = [s for s in lost if not self.sched.is_disabled(s)]
        if self.sched.num_enabled() - len(newly) < 1:
            raise ValueError("shrink would disable every slot; at least one "
                             "must survive to keep serving")
        evicted = []
        for s in lost:
            ev = self.sched.evict(s)
            if ev is not None:
                self._on_evict(ev.slot, ev.req)
                evicted.append(s)
        self.sched.disable(lost)
        self._admit_loop()
        return evicted

    def _finish(self, i: int, req: Request):
        req.done = True
        req.finish_t = self.stats.now()
        self.stats.on_finish(req.uid, req.finish_t)
        self.sched.retire(i)

    def _on_admit(self, i: int, req: Request):
        self.stats.on_admit(req.uid, self.stats.now())
        if req.budget_left <= 0:
            # nothing to decode: finish without touching device state
            self._finish(i, req)
            return
        # effective prefix = prompt + committed tokens (preemption round trip)
        prefix = np.asarray(list(req.prompt) + req.out_tokens, np.int32)
        plen = len(prefix)
        if self.mode == "mcts":
            # the stateless searcher prefills this slot from the prefix
            # buffer inside each per-token search; writing the row is the
            # slot reset.  A stateful searcher prefills ONCE here instead
            self.prefix_buf[i] = 0
            self.prefix_buf[i, :plen] = prefix
            self.prefix_len[i] = plen
            if self._carry is not None:
                self._carry = self._mcts_search.admit(
                    self._carry, i, self.prefix_buf[i], plen)
            return
        # greedy: prefill this request alone, splice its row into slot i
        one = self.fam.init_cache(self.cfg, 1, self.ecfg.max_seq,
                                  device=self.device)
        logits, one = self.fam.prefill(
            self.cfg, self.params,
            torch.from_numpy(prefix)[None].to(self.device), one)
        tok = int(torch.argmax(logits[0, -1]))
        req.out_tokens.append(tok)
        self.stats.on_token(req.uid, self.stats.now())
        self.sched.on_token(i)
        # each decode step writes one KV entry at position plen, plen+1,
        # ... — clamp so the slot finishes before writing past max_seq
        self.sched.cap_remaining(i, self.ecfg.max_seq - plen)
        for k, full in self.cache.items():
            if full.dim() == 1:
                full[i] = one[k][0]
            else:
                full[:, i] = one[k][:, 0]
        if self.sched.exhausted(i) or tok == self.ecfg.eos_token:
            self._finish(i, req)

    def _next_tokens(self) -> torch.Tensor:
        toks = np.zeros((self.ecfg.max_batch, 1), np.int32)
        for i in self.sched.live():
            req = self.sched.request(i)
            if req.out_tokens:
                toks[i, 0] = req.out_tokens[-1]
        return torch.from_numpy(toks).to(self.device)

    # -- main loop ----------------------------------------------------------
    def step(self):
        """One decode step over all live slots.  Slots freed mid-step (EOS,
        budget, capacity) are refilled before returning, so the NEXT step
        already decodes the replacement — no idle step in between."""
        self._admit_loop()
        live = self.sched.live()
        if not live:
            return 0
        if self.mode == "mcts":
            emitted = self._mcts_step(live)
            self.stats.on_step(emitted, searched=len(live))
        else:
            emitted = self._greedy_step(live)
            self.stats.on_step(emitted)
        self._admit_loop()          # refill freed slots in the same step
        return emitted

    def _greedy_step(self, live: List[int]) -> int:
        # dead slots decode too (one fixed [B] batch) and their outputs are
        # ignored; park their positions at 0 so their K/V writes stay
        # inside the cache (the JAX package drops writes past its end) —
        # an admission splices a whole new row over the slot
        dead = sorted(set(range(self.ecfg.max_batch)) - set(live))
        if dead:
            self.cache["pos"][dead] = 0
        logits, self.cache = self.fam.decode_step(
            self.cfg, self.params, self.cache, self._next_tokens())
        toks = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        now = self.stats.now()
        for i in live:
            req = self.sched.request(i)
            tok = int(toks[i])
            req.out_tokens.append(tok)
            self.stats.on_token(req.uid, now)
            self.sched.on_token(i)
            if self.sched.exhausted(i) or tok == self.ecfg.eos_token:
                self._finish(i, req)
        return len(live)

    def _mcts_step(self, live: List[int]) -> int:
        """One batched multi-root search over every slot; commit one token
        per live slot.  Dead slots are searched too (one fixed [B] batch)
        and their outputs ignored."""
        if self._carry is not None:
            toks, self._carry = self._mcts_search.step(
                self.prefix_buf, self.prefix_len, self._searches,
                self._carry)
        else:
            toks = self._mcts_search(self.prefix_buf, self.prefix_len,
                                     self._searches)
        self._searches += 1
        toks = np.asarray(torch.as_tensor(toks).cpu())
        now = self.stats.now()
        for i in live:
            req = self.sched.request(i)
            tok = int(toks[i])
            req.out_tokens.append(tok)
            self.stats.on_token(req.uid, now)
            at_capacity = self.prefix_len[i] >= self.ecfg.max_seq
            if not at_capacity:
                self.prefix_buf[i, self.prefix_len[i]] = tok
                self.prefix_len[i] += 1
            self.sched.on_token(i)
            # finish at the sequence capacity too — further searches would
            # keep emitting from the same frozen prefix
            if (self.sched.exhausted(i) or tok == self.ecfg.eos_token
                    or at_capacity):
                self._finish(i, req)
        return len(live)

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[str, Any]:
        emitted = 0
        steps = 0
        while steps < max_steps:
            e = self.step()
            steps += 1
            emitted += e
            if e == 0 and self.sched.pending() == 0:
                break
        reqs = self.stats.request_summaries()
        lats = [r["latency"] for r in reqs.values()
                if r["latency"] is not None]
        return {
            "steps": steps,
            "tokens": emitted,
            "requests": reqs,
            "latency_p50": percentile(lats, 50) if lats else 0.0,
            "latency_p95": percentile(lats, 95) if lats else 0.0,
            "stats": self.stats.snapshot(),
        }
