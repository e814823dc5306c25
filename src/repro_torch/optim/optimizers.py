"""Optimizers as (init, update) pairs over parameter trees — the
counterpart of ``repro.optim.optimizers``, with its order of rounding.

The state is a tree like the parameters' (dicts of tensors) plus an int32
``step`` on the parameters' device.  Nothing is updated in place: an
update returns new tensors, so a caller that keeps the old parameters and
state (the training loop skipping a non-finite step) still has them.
Bias corrections are float32 tensors (``b ** step`` in float32, as the JAX
package computes them); updates are computed in ``state_dtype``, cast to
the parameter's dtype, and added in that dtype by ``apply_updates``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.pytree import flatten, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, torch.Tensor], Tuple[Any, Any]]
    # update(grads, state, params, lr) -> (updates, new_state)


def _step0(params) -> torch.Tensor:
    leaves, _ = flatten(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def _zeros(state_dtype):
    return lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros(state_dtype), params),
                "v": tree_map(_zeros(state_dtype), params),
                "step": _step0(params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        t = step.float()
        b1t = 1 - torch.tensor(b1, device=t.device) ** t
        b2t = 1 - torch.tensor(b2, device=t.device) ** t
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(state_dtype),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.to(state_dtype)),
                     state["v"], grads)

        def upd(m_, v_, p):
            mhat = m_ / b1t
            vhat = v_ / b2t
            u = mhat / (torch.sqrt(vhat) + eps) \
                + weight_decay * p.to(state_dtype)
            return (-lr * u).to(p.dtype)
        updates = tree_map(upd, m, v, params)
        return updates, {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


def lion(b1: float = 0.9, b2: float = 0.99, weight_decay: float = 0.1,
         state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros(state_dtype), params),
                "step": _step0(params)}

    def update(grads, state, params, lr):
        def upd(m_, g, p):
            c = b1 * m_ + (1 - b1) * g.to(state_dtype)
            return (-lr * (torch.sign(c) + weight_decay * p.to(state_dtype))
                    ).to(p.dtype)
        updates = tree_map(upd, state["m"], grads, params)
        m = tree_map(lambda m_, g: b2 * m_ + (1 - b2) * g.to(state_dtype),
                     state["m"], grads)
        return updates, {"m": m, "step": state["step"] + 1}

    return Optimizer(init, update)


def sgd(momentum: float = 0.9, state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros(state_dtype), params),
                "step": _step0(params)}

    def update(grads, state, params, lr):
        m = tree_map(lambda m_, g: momentum * m_ + g.to(state_dtype),
                     state["m"], grads)
        updates = tree_map(lambda m_, p: (-lr * m_).to(p.dtype), m, params)
        return updates, {"m": m, "step": state["step"] + 1}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled by min(1, max_norm / |g|), |g|)``, the global norm
    summed leaf by leaf in the JAX package's leaf order, in float32; each
    leaf scaled in float32 and cast back to its dtype."""
    leaves, _ = flatten(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def apply_updates(params, updates):
    """``p + u`` in the parameter's dtype, new tensors."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
