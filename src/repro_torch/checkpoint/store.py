"""Atomic, asynchronous checkpoints of nested tensor structures — the
counterpart of ``repro.checkpoint.store``, with the same layout on disk.

Layout:  <dir>/step_<N>/{manifest.json, leaf_<i>.npy..., COMMITTED}

* leaves are written in ``jax.tree_util``'s order (``core.pytree``), each
  as a ``.npy`` file; bfloat16 is stored as a ``uint16`` view under the
  dtype name ``"bfloat16"`` (float8 as a ``uint8`` view), so a checkpoint
  written by either package restores in the other, leaf for leaf;
* save is atomic: leaves and manifest land in a tmp dir, then one rename
  and a COMMITTED marker; a crash mid-save never corrupts the latest
  checkpoint, and the next save reaps the debris;
* asynchronous: the device-to-host copy happens on the caller's thread,
  the file writes on a background thread; ``wait()`` joins before the next
  save;
* restore places each leaf on the device of the template's leaf, the
  counterpart of the JAX package's ``shardings=``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.pytree import flatten, unflatten

COMMITTED = "COMMITTED"

# numpy has no bfloat16 / float8: they round-trip through same-width views
# (the JAX package's ``_VIEW_AS``); torch reads them back through a signed
# view of the same width
_VIEW_AS = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16),
            torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8, np.uint8),
            torch.float8_e5m2: ("float8_e5m2", torch.uint8, np.uint8)}
_FROM_NAME = {name: (dt, tv) for dt, (name, tv, _) in _VIEW_AS.items()}


def _to_savable(leaf):
    """``(numpy array written to disk, dtype name)`` of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _VIEW_AS:
            name, tview, nview = _VIEW_AS[t.dtype]
            return t.view(tview).numpy().view(nview), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name in _FROM_NAME:
        dt, tview = _FROM_NAME[dtype_name]
        signed = np.int16 if tview is torch.int16 else np.uint8
        return torch.from_numpy(arr.view(signed)).view(dt)
    return torch.from_numpy(arr)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _leaf_paths(d: str, n: int):
    return [os.path.join(d, f"leaf_{i}.npy") for i in range(n)]


def save(ckpt_dir: str, step: int, tree: Any, *, asynchronous: bool = False,
         keep: int = 3) -> Optional[threading.Thread]:
    leaves, treedef = flatten(tree)
    saved = [_to_savable(x) for x in leaves]          # device -> host now
    host_leaves = [a for a, _ in saved]
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"

    def _write():
        os.makedirs(tmp_dir, exist_ok=True)
        for p, arr in zip(_leaf_paths(tmp_dir, len(host_leaves)),
                          host_leaves):
            np.save(p, arr)
        manifest = {
            "step": step,
            "treedef": repr(treedef),
            "n_leaves": len(host_leaves),
            "shapes": [list(a.shape) for a in host_leaves],
            "dtypes": [n for _, n in saved],
        }
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(step_dir):
            shutil.rmtree(step_dir)
        os.rename(tmp_dir, step_dir)
        with open(os.path.join(step_dir, COMMITTED), "w") as f:
            f.write("ok")
        _gc(ckpt_dir, keep)

    if asynchronous:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(_committed_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    # Reap debris from crashed saves (single writer: _gc runs after the
    # current save has committed, so anything else is dead):
    #  * step_*.tmp — killed before the atomic rename;
    #  * uncommitted step dirs — killed between the rename and the
    #    COMMITTED marker; never seen by latest_step / restore.
    committed = set(steps)
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if name.startswith("step_") and name.endswith(".tmp"):
            shutil.rmtree(path, ignore_errors=True)
        elif name.startswith("step_"):
            try:
                s = int(name[5:])
            except ValueError:
                continue
            if s not in committed:
                shutil.rmtree(path, ignore_errors=True)


def _committed_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, COMMITTED)):
                out.append(int(name[5:]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _committed_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf a tensor of the
    stored dtype, on the device of ``like``'s leaf (the CPU where that
    leaf is not a tensor)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(step_dir, COMMITTED)):
        raise FileNotFoundError(f"no committed checkpoint at {step_dir}")
    leaves, treedef = flatten(like)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint at {step_dir} has {manifest['n_leaves']} leaves "
            f"but the restore template has {len(leaves)} — structures "
            "differ")
    arrays = [_from_savable(np.load(p), dt) for p, dt in
              zip(_leaf_paths(step_dir, len(leaves)), manifest["dtypes"])]
    for a, l in zip(arrays, leaves):
        if tuple(a.shape) != _shape(l):
            raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                             f"{_shape(l)}")
    arrays = [a.to(l.device) if isinstance(l, torch.Tensor) else a
              for a, l in zip(arrays, leaves)]
    return unflatten(treedef, arrays)


class CheckpointManager:
    """Keeps at most one asynchronous save in flight; joins before the
    next one."""

    def __init__(self, ckpt_dir: str, keep: int = 3, every: int = 100):
        self.dir = ckpt_dir
        self.keep = keep
        self.every = every
        self._pending: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, tree: Any) -> bool:
        if step % self.every:
            return False
        self.wait()
        self._pending = save(self.dir, step, tree, asynchronous=True,
                             keep=self.keep)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def latest(self) -> Optional[int]:
        return latest_step(self.dir)

    def restore_latest(self, like: Any):
        step = self.latest()
        if step is None:
            return None, None
        return step, restore(self.dir, step, like)
