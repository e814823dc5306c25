"""Architecture registry of the port: one module per ported architecture.

``get_config(arch)`` -> full ModelConfig (the published dims);
``get_smoke_config(arch)`` -> reduced same-family config for CPU tests.
Copies of ``repro.configs`` for the ported families: the four dense
architectures, rwkv6-1.6b (``rwkv6``) and zamba2-1.2b (``zamba2``); the
other families come with their models (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.base import ModelConfig

ARCHS: List[str] = ["smollm-135m", "qwen2-0.5b", "minicpm-2b",
                    "stablelm-3b", "rwkv6-1.6b", "zamba2-1.2b"]

_MODULES: Dict[str, str] = {a: a.replace("-", "_").replace(".", "_")
                            for a in ARCHS}


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _mod(arch).SMOKE_CONFIG
