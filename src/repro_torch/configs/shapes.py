"""Assigned input-shape set (applies to every architecture in the pool)."""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k requires sub-quadratic attention: run only for SSM/hybrid archs
# (rwkv6 O(1)-state; zamba2 Mamba2 + a handful of shared-attn KV caches).
# Pure full-attention archs skip it — recorded per cell in EXPERIMENTS.md.
LONG_CONTEXT_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")


def cell_enabled(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in LONG_CONTEXT_ARCHS
    return True
