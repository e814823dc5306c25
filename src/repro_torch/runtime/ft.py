"""Fault-tolerant training loop: watchdog, NaN guards, restart from a
checkpoint — the counterpart of ``repro.runtime.ft``, framework-free apart
from the checkpoint manager.

* every state mutation goes through the checkpoint manager (asynchronous,
  atomic);
* a heartbeat watchdog thread detects hangs (e.g. a dead collective) and
  raises in the main thread so that the scheduler can restart the process;
* restart = resume from the latest committed step with the SAME data
  stream (a ``(seed, step)``-deterministic batch factory), so loss curves
  continue bit for bit;
* NaN / inf loss steps are skipped (params / optimizer state not
  committed) with a counter;
* failure injection lets tests drive all of the above deterministically
  (kill at step N, NaN at step M, stall at step K).
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint import CheckpointManager


class SimulatedFailure(RuntimeError):
    pass


class WatchdogTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    watchdog_s: float = 600.0
    max_nan_skips: int = 10
    # failure injection (tests)
    fail_at_step: Optional[int] = None
    nan_at_step: Optional[int] = None
    stall_at_step: Optional[int] = None


class Heartbeat:
    """Raises WatchdogTimeout if no beat arrives within ``timeout_s``."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self.expired = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self):
        self._last = time.monotonic()
        if self.expired.is_set():
            raise WatchdogTimeout("heartbeat expired")

    def _run(self):
        while not self._stop.wait(min(self.timeout_s / 4, 1.0)):
            if time.monotonic() - self._last > self.timeout_s:
                self.expired.set()
                return

    def stop(self):
        self._stop.set()


class TrainerLoop:
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    metrics)``.

    ``batch_iter`` may be an iterator OR a factory ``step -> iterator``;
    the factory form re-seeks the (deterministic) data stream after a
    restore so restarted runs consume exactly the batches the lost run
    would have.  A restore places every leaf on the device of the
    current state's leaf.
    """

    def __init__(self, step_fn: Callable, params: Any, opt_state: Any,
                 batch_iter, ft: FTConfig):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self._batch_src = batch_iter
        self.batch_iter = None if callable(batch_iter) else batch_iter
        self.ft = ft
        self.ckpt = CheckpointManager(ft.ckpt_dir, keep=ft.keep,
                                      every=ft.ckpt_every)
        self.step = 0
        self.nan_skips = 0
        self.history: list = []

    # -- state (de)hydration --------------------------------------------
    def _state(self):
        return {"params": self.params, "opt": self.opt_state}

    def try_restore(self) -> bool:
        step, state = self.ckpt.restore_latest(self._state())
        if state is None:
            return False
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    # -- main loop --------------------------------------------------------
    def run(self, n_steps: int, heartbeat: Optional[Heartbeat] = None
            ) -> Dict:
        if self.batch_iter is None:
            self.batch_iter = self._batch_src(self.step)
        target = self.step + n_steps
        while self.step < target:
            batch = next(self.batch_iter)
            if self.ft.stall_at_step == self.step and heartbeat is not None:
                time.sleep(self.ft.watchdog_s * 1.5)
            if self.ft.fail_at_step == self.step:
                raise SimulatedFailure(
                    f"injected failure at step {self.step}")
            new_params, new_opt, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            if self.ft.nan_at_step == self.step:
                loss = float("nan")
            if not math.isfinite(loss):
                # skip the update: keep the previous params / opt state
                self.nan_skips += 1
                if self.nan_skips > self.ft.max_nan_skips:
                    raise RuntimeError("too many non-finite steps")
                self.step += 1
                continue
            self.params, self.opt_state = new_params, new_opt
            self.step += 1
            self.history.append(loss)
            self.ckpt.maybe_save(self.step, self._state())
            if heartbeat is not None:
                heartbeat.beat()
        self.ckpt.wait()
        return {"step": self.step, "losses": self.history,
                "nan_skips": self.nan_skips}


def train_with_restarts(make_loop: Callable[[], TrainerLoop], n_steps: int,
                        max_restarts: int = 3) -> Dict:
    """Process-level restart simulation: on failure, rebuild the loop (a
    fresh 'process'), restore from the latest checkpoint, continue.  The
    JAX package's ``run_with_restarts``; the repository's API-surface
    policy (``tools/api_surface.py``) keeps module-level ``run_*`` names
    for search entry points."""
    restarts = 0
    loop = make_loop()
    loop.try_restore()
    while True:
        try:
            remaining = n_steps - loop.step
            if remaining <= 0:
                return {"step": loop.step, "restarts": restarts,
                        "losses": loop.history}
            out = loop.run(remaining)
            return {"step": out["step"], "restarts": restarts,
                    "losses": out["losses"]}
        except (SimulatedFailure, WatchdogTimeout):
            restarts += 1
            if restarts > max_restarts:
                raise
            loop = make_loop()
            loop.try_restore()
