"""Elastic fault-tolerant multi-root search — the counterpart of
``repro.search.ft``.

The paper's root parallelism is naturally failure-tolerant: the B searches
are independent and only merged at the end, so losing a host must cost
only that host's *in-flight* roots, never the job.
``ElasticSearchDriver`` makes that concrete:

* roots are partitioned into per-host work queues (a "host" is a logical
  worker owning a slice of the mesh's entries; in a ``torch.distributed``
  job the slices line up with processes);
* each host runs its queue in chunks through the same per-root program as
  ``search_batch``, under the root's ORIGINAL draws, made for exactly B
  roots before any partitioning, so every committed root repeats its
  uninterrupted run;
* a lost host (``runtime.ft.SimulatedFailure``) or a stalled one (caught
  by ``runtime.ft.Heartbeat``'s watchdog) is removed from the world: its
  in-flight roots are requeued onto survivors, its unstarted queue is
  redistributed, and its entries are dropped from the mesh
  (``runtime.elastic.shrink_mesh``);
* completed roots are committed through ``checkpoint.store`` (atomic
  rename + COMMITTED marker, keep-N): a *driver* restart with the same
  ``ckpt_dir`` resumes from the committed roots and re-runs only the
  rest.

Failure injection is part of the public surface: ``kill_host_at_root=N``
kills the host that owns root N the moment it launches a chunk holding N;
``stall_host_at_root=K`` hangs that host past the watchdog instead.  Each
fires at most once, so a requeued root does not fire it again, and a
failure point already committed (or never launched) is a no-op.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.pytree import flatten, unflatten
from repro_torch.runtime.ft import Heartbeat, SimulatedFailure, \
    WatchdogTimeout

__all__ = ["FTSearchConfig", "FTReport", "ElasticSearchDriver",
           "ft_search_batch"]


@dataclasses.dataclass(frozen=True)
class FTSearchConfig:
    """Elastic-driver knobs and deterministic failure injection (the JAX
    package's ``FTSearchConfig``, field for field).

    hosts:            logical workers the roots are partitioned over
                      (clamped to B).
    chunk:            roots a host launches per round (0 = its whole queue).
    watchdog_s:       per-host heartbeat timeout (runtime.ft.Heartbeat).
    stall_s:          injected stall duration (0 -> 3x watchdog_s).
    ckpt_dir:         commit completed roots here (None = no checkpoints).
    ckpt_keep:        keep-N for committed checkpoints.
    max_requeues:     per-root requeue budget before the driver gives up.
    partition_seed:   None = contiguous blocks; int = seeded shuffle of the
                      root -> host assignment.
    requeue_seed:     None = requeue victims onto survivors round-robin in
                      root order; int = seeded shuffle first.
    kill_host_at_root / stall_host_at_root:  failure injection, see the
                      module docstring.  Each fires at most once per run.
    """

    hosts: int = 1
    chunk: int = 0
    watchdog_s: float = 5.0
    stall_s: float = 0.0
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    max_requeues: int = 2
    partition_seed: Optional[int] = None
    requeue_seed: Optional[int] = None
    kill_host_at_root: Optional[int] = None
    stall_host_at_root: Optional[int] = None


@dataclasses.dataclass
class FTReport:
    """What the run actually did (the fault-injection suite's oracle)."""

    runs: np.ndarray                    # [B] launches per root
    requeued: List[int]                 # in-flight roots re-run after a loss
    lost_hosts: List[int]               # logical hosts removed from the world
    resumed: List[int]                  # roots restored from a checkpoint
    rounds: int = 0
    commits: int = 0


class ElasticSearchDriver:
    """Requeue-and-shrink driver over per-host work queues (see the module
    docstring).

    ``mesh=None`` runs each chunk on ``device`` (default ``cuda:0``; in a
    multi-process job every process then computes the same chunks, which
    keeps the processes in lockstep without collectives); a
    ``SearchMesh`` partitions its entries among the hosts and runs each
    chunk through ``shard_search_keys`` on the owner's entries.  Every
    process of a mesh's group runs the driver in lockstep.  The merged
    result's leaves are CPU tensors.
    """

    def __init__(self, domains, cfg, rng,
                 ft: Optional[FTSearchConfig] = None, *, mesh=None,
                 device=None):
        from repro_torch.parallel.mesh import SearchMesh
        from repro_torch.search.api import _check, _draws, resolve_device
        self.domains = list(domains)
        if not self.domains:
            raise ValueError("ft_search_batch needs at least one domain")
        _check(self.domains[0])
        b = len(self.domains)
        self.cfg = cfg
        self.ft = ft or FTSearchConfig()
        if mesh is not None and not isinstance(mesh, SearchMesh):
            raise TypeError(f"mesh must be None or a SearchMesh, got "
                            f"{type(mesh).__name__}")
        if mesh is not None and device is not None:
            raise ValueError("pass a device or a mesh, not both")
        self.mesh = mesh
        self.device = None if mesh is not None else resolve_device(device)
        # draws for exactly B roots, made before partitioning / placement:
        # the invariant that makes requeue and merge exact
        self.draws = _draws(self.domains[0], cfg, rng, (b,),
                            torch.device("cpu"))
        hosts = max(1, min(self.ft.hosts, b))
        if mesh is not None and mesh.size < hosts:
            # every live host keeps at least one entry through any shrink
            raise ValueError(f"a mesh of {mesh.size} entries cannot serve "
                             f"{hosts} hosts")
        order = np.arange(b)
        if self.ft.partition_seed is not None:
            order = np.random.RandomState(self.ft.partition_seed)\
                .permutation(b)
        self.queues: List[List[int]] = [
            [int(i) for i in q] for q in np.array_split(order, hosts)]
        self.alive = [True] * hosts
        self._host_entries = self._partition_entries(mesh, hosts)
        self._done = np.zeros(b, bool)
        self._acc = None                    # [B, ...] result accumulator
        self._requeues = np.zeros(b, np.int32)
        self._fired = {"kill": False, "stall": False}
        self.report = FTReport(runs=np.zeros(b, np.int64), requeued=[],
                               lost_hosts=[], resumed=[])
        if self.ft.ckpt_dir:
            self._try_resume()

    # -- placement ---------------------------------------------------------
    @staticmethod
    def _partition_entries(mesh, hosts: int):
        if mesh is None:
            return [None] * hosts
        return [list(s) for s in np.array_split(
            np.asarray(mesh.entries, object), hosts)]

    def _host_mesh(self, h: int):
        entries = self._host_entries[h]
        if not entries:
            return None
        return self.mesh.sub(entries)

    def _shrink(self, lost: int) -> None:
        """Drop ``lost``'s entries and re-place the surviving hosts over
        the shrunken world: later chunks target the new meshes; committed
        results already live in the accumulator."""
        if self.mesh is None:
            return
        from repro_torch.runtime.elastic import shrink_mesh
        self.mesh = shrink_mesh(self.mesh, self._host_entries[lost] or [])
        self._host_entries[lost] = []
        survivors = [h for h in range(len(self.alive)) if self.alive[h]]
        keep = np.asarray(self.mesh.entries, object)
        for h, sl in zip(survivors, np.array_split(keep, len(survivors))):
            self._host_entries[h] = list(sl)

    # -- checkpointing -----------------------------------------------------
    def _template(self):
        """A ``[B, ...]`` zero accumulator of the result's structure.  The
        JAX package traces the search for its shapes; the port's search is
        a host loop, so it runs root 0 once (uncounted) instead — only a
        driver that resumes needs it."""
        live = self.alive.index(True)
        return self._zeros_like(self._execute([0], self._host_mesh(live)))

    def _zeros_like(self, res):
        b = len(self.domains)
        leaves, treedef = flatten(res)
        return unflatten(treedef, [torch.zeros((b,) + tuple(x.shape[1:]),
                                               dtype=x.dtype)
                                   for x in leaves])

    def _try_resume(self) -> None:
        from repro_torch.checkpoint import store
        step = store.latest_step(self.ft.ckpt_dir)
        if step is None:
            return
        like = {"done": torch.zeros(len(self.domains), dtype=torch.bool),
                "results": self._template()}
        state = store.restore(self.ft.ckpt_dir, step, like)
        self._done = state["done"].numpy().copy()
        self._acc = state["results"]
        self.report.resumed = [int(i) for i in np.nonzero(self._done)[0]]

    def _commit(self, roots: List[int], res) -> None:
        if self._acc is None:
            self._acc = self._zeros_like(res)
        idx = torch.as_tensor(roots)
        for acc, leaf in zip(flatten(self._acc)[0], flatten(res)[0]):
            acc[idx] = leaf[:len(roots)].cpu()
        self._done[np.asarray(roots)] = True
        self.report.commits += 1
        if self.ft.ckpt_dir:
            from repro_torch.checkpoint import store
            store.save(self.ft.ckpt_dir, self.report.commits,
                       {"done": torch.from_numpy(self._done),
                        "results": self._acc},
                       keep=self.ft.ckpt_keep)

    # -- execution ---------------------------------------------------------
    def _execute(self, roots: List[int], hmesh):
        from repro_torch.search.api import search_batch
        from repro_torch.search.sharding import shard_search_keys
        doms = [self.domains[i] for i in roots]
        draws = self.draws[torch.as_tensor(roots)]
        if hmesh is not None:
            return shard_search_keys(doms, self.cfg, draws, mesh=hmesh)
        return search_batch(doms, self.cfg, draws, device=self.device,
                            mesh=False)

    def _launch(self, h: int, roots: List[int]) -> None:
        ft = self.ft
        self.report.runs[np.asarray(roots)] += 1
        if (not self._fired["kill"] and ft.kill_host_at_root is not None
                and ft.kill_host_at_root in roots):
            self._fired["kill"] = True
            raise SimulatedFailure(
                f"injected kill of host {h} at root {ft.kill_host_at_root}")
        # The watchdog is scoped to this launch (the hosts are simulated
        # on one driver thread, so a long-lived per-host heartbeat would
        # expire on every OTHER host while one stalls) and polices the
        # dispatch window, not device compute: a hung host never issues
        # its launch, a healthy one beats at once.
        hb = Heartbeat(ft.watchdog_s)
        try:
            if (not self._fired["stall"]
                    and ft.stall_host_at_root is not None
                    and ft.stall_host_at_root in roots):
                self._fired["stall"] = True
                time.sleep(ft.stall_s or 3.0 * ft.watchdog_s)
            hb.beat()           # raises WatchdogTimeout if the host stalled
        finally:
            hb.stop()
        self._commit(roots, self._execute(roots, self._host_mesh(h)))

    def _on_host_lost(self, h: int, inflight: List[int]) -> None:
        self.alive[h] = False
        self.report.lost_hosts.append(h)
        survivors = [s for s in range(len(self.alive)) if self.alive[s]]
        if not survivors:
            raise RuntimeError(
                f"all {len(self.alive)} hosts lost; cannot finish "
                f"{int((~self._done).sum())} roots")
        victims = [i for i in inflight if not self._done[i]]
        self._requeues[np.asarray(victims, int)] += 1
        over = [i for i in victims
                if self._requeues[i] > self.ft.max_requeues]
        if over:
            raise RuntimeError(f"roots {over} exceeded max_requeues="
                               f"{self.ft.max_requeues}")
        self.report.requeued.extend(victims)
        # in-flight roots first (launched and lost), then the dead host's
        # unstarted queue; spread over the survivors round-robin
        orphans = victims + [i for i in self.queues[h] if not self._done[i]]
        self.queues[h] = []
        if self.ft.requeue_seed is not None:
            orphans = [orphans[j] for j in np.random.RandomState(
                self.ft.requeue_seed).permutation(len(orphans))]
        for j, i in enumerate(orphans):
            self.queues[survivors[j % len(survivors)]].append(i)
        self._shrink(h)

    # -- main loop ---------------------------------------------------------
    def run(self, max_rounds: Optional[int] = None):
        """Drive every root to a committed result; returns the merged
        ``SearchResult`` (CPU tensors), root for root the uninterrupted
        ``search_batch`` run.  ``max_rounds`` bounds the scheduling rounds
        (for restart tests); when it stops early the partial state is
        committed and ``None`` is returned."""
        rounds = 0
        while not self._done.all():
            if max_rounds is not None and rounds >= max_rounds:
                return None
            progressed = False
            for h in range(len(self.alive)):
                if not self.alive[h]:
                    continue
                queue = [i for i in self.queues[h] if not self._done[i]]
                take = self.ft.chunk or len(queue)
                roots, self.queues[h] = queue[:take], queue[take:]
                if not roots:
                    continue
                progressed = True
                try:
                    self._launch(h, roots)
                except (SimulatedFailure, WatchdogTimeout):
                    self._on_host_lost(h, roots)
            rounds += 1
            self.report.rounds = rounds
            if not progressed:
                raise RuntimeError("no progress: live hosts have empty "
                                   "queues but roots remain")
        return self.result()

    def result(self):
        """Merged result for the committed roots (the full
        ``SearchResult`` once ``run()`` finished)."""
        if self._acc is None:
            raise RuntimeError("no roots committed yet")
        return self._acc


def ft_search_batch(domains, cfg, rng, *,
                    ft: Optional[FTSearchConfig] = None, mesh=None,
                    device=None):
    """``search_batch`` under the elastic driver: the same per-root
    results, even across injected host loss, committed through the
    checkpoint store when ``ft.ckpt_dir`` is set."""
    return ElasticSearchDriver(domains, cfg, rng, ft, mesh=mesh,
                               device=device).run()
