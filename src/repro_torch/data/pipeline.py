"""Deterministic synthetic data pipeline with packing + host prefetch — a
copy of ``repro.data.pipeline`` (numpy only, so batches equal the JAX
package's bit for bit; the model config is the port's).

Every batch is derived from (seed, step, host_id) so restarts reproduce the
exact token stream (checkpoint/restart correctness is testable), and each
host generates only its shard (data-parallel input pipeline).

``Prefetcher`` overlaps host-side batch synthesis with device compute via a
background thread + bounded queue — the input-pipeline analogue of the
paper's pipeline overlap.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from repro_torch.models.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch_size: int = 8
    seq_len: int = 128
    n_hosts: int = 1
    host_id: int = 0
    pack_documents: bool = True
    mean_doc_len: int = 64


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def _packed_tokens(rng: np.random.Generator, b: int, s: int, vocab: int,
                   mean_doc: int) -> np.ndarray:
    """Documents of ~geometric length packed back-to-back with EOS=0."""
    toks = rng.integers(1, vocab, size=(b, s), dtype=np.int32)
    if mean_doc > 0:
        # place EOS boundaries with prob 1/mean_doc
        eos = rng.random((b, s)) < (1.0 / mean_doc)
        toks = np.where(eos, 0, toks)
    return toks


def synthetic_batch(model_cfg: ModelConfig, data_cfg: DataConfig,
                    step: int) -> Dict[str, np.ndarray]:
    """Batch for any family; labels are next-token shifted."""
    rng = _rng(data_cfg, step)
    b, s = data_cfg.batch_size, data_cfg.seq_len
    if model_cfg.family == "vlm":
        p = model_cfg.n_patches
        s_txt = s - p
        toks = _packed_tokens(rng, b, s_txt, model_cfg.vocab_size,
                              data_cfg.mean_doc_len if data_cfg.pack_documents else 0)
        labels = np.concatenate(
            [np.zeros((b, p), np.int32), np.roll(toks, -1, axis=1)], axis=1)
        patches = rng.normal(size=(b, p, model_cfg.frontend_dim)).astype(np.float32)
        return {"patches": patches, "tokens": toks, "labels": labels}
    toks = _packed_tokens(rng, b, s, model_cfg.vocab_size,
                          data_cfg.mean_doc_len if data_cfg.pack_documents else 0)
    labels = np.roll(toks, -1, axis=1)
    batch = {"tokens": toks, "labels": labels}
    if model_cfg.family == "whisper":
        batch["frames"] = rng.normal(
            size=(b, model_cfg.enc_seq, model_cfg.d_model)).astype(np.float32)
    return batch


def make_batch_iterator(model_cfg: ModelConfig, data_cfg: DataConfig,
                        start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield synthetic_batch(model_cfg, data_cfg, step)
        step += 1


class Prefetcher:
    """Bounded background prefetch (double buffering by default)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
