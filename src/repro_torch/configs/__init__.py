"""Architecture registry of the port: one module per ported architecture.

``get_config(arch)`` -> full ModelConfig (the published dims);
``get_smoke_config(arch)`` -> reduced same-family config for CPU tests.
Copies of ``repro.configs``: the same ten architectures in the same
order, over the six families (dense, moe, whisper, rwkv6, zamba2, vlm).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.base import ModelConfig

ARCHS: List[str] = [
    "deepseek-v2-lite-16b",
    "grok-1-314b",
    "smollm-135m",
    "qwen2-0.5b",
    "minicpm-2b",
    "stablelm-3b",
    "whisper-base",
    "rwkv6-1.6b",
    "zamba2-1.2b",
    "internvl2-2b",
]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_")
                            for a in ARCHS}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE_CONFIG
