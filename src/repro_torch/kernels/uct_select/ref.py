"""Plain PyTorch versions of the fused UCT argmax kernels — the oracle the
CUDA kernels are held against, and what the wrappers run for CPU tensors.

Shares the kernels' wave contract: rows are independent lanes, duplicated
parents are fine, an all-invalid row returns index 0, and sentinel ties
resolve to the lowest index (first-max argmax).
"""
from __future__ import annotations

from repro_torch.core import uct


def uct_argmax_ref(child_n, child_w, child_vl, parent_n, valid, *, cp: float,
                   vl_weight: float, child_o=None, vl_mode: str = "loss"):
    return uct.uct_argmax(child_n, child_w, child_vl, parent_n, cp,
                          vl_weight=vl_weight, valid=valid, kernels="ref",
                          child_o=child_o, vl_mode=vl_mode)


def uct_argmax_running_ref(child_n, child_w, child_vl, parent_n, parent_id,
                           valid, *, cp: float, vl_weight: float,
                           child_o=None, vl_mode: str = "loss"):
    return uct.uct_argmax_running(child_n, child_w, child_vl, parent_n,
                                  parent_id, cp, vl_weight=vl_weight,
                                  valid=valid, kernels="ref", child_o=child_o,
                                  vl_mode=vl_mode)
