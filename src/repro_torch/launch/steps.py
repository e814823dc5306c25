"""Step factories: train_step / prefill_step / decode_step for a family —
the counterpart of ``repro.launch.steps``.

A train step is a function ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` that does not modify its inputs: the gradient is
taken with ``torch.autograd.grad`` on detached leaves that require grad,
and the optimizer returns new tensors.  ``batch`` holds numpy arrays or
tensors; they are moved to the parameters' device.  The JAX package's
``with_logical_constraint`` is the identity without a mesh and is left
out until the port has ``parallel/sharding.py``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.pytree import flatten, tree_map, unflatten
from repro_torch.models.base import ModelConfig, get_family
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm


def _loss_fn(cfg: ModelConfig):
    fam = get_family(cfg)
    fn = getattr(fam, "loss_fn", None)
    if fn is None:
        raise NotImplementedError(
            f"the port has no loss for the {cfg.family!r} family")
    return fn


def _device(params) -> torch.device:
    return flatten(params)[0][0].device


def _to_device(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, params):
    """``((loss, aux), grads)`` of ``loss_fn(params) -> (loss, aux)``, the
    gradient a tree like ``params`` (zeros for a leaf the loss does not
    reach); ``params`` is left as it is."""
    leaves, treedef = flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, aux = loss_fn(unflatten(treedef, live))
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                   else t, aux)
    return (loss.detach(), aux), unflatten(treedef, grads)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    schedule: Callable, grad_clip: float = 1.0,
                    compress_grads: Optional[Callable] = None):
    loss_fn = _loss_fn(cfg)

    def train_step(params, opt_state, batch):
        batch = _to_device(batch, _device(params))
        (loss, aux), grads = value_and_grad(
            lambda p: loss_fn(cfg, p, batch), params)
        if compress_grads is not None:
            grads = compress_grads(grads)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = schedule(opt_state["step"])
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        params = apply_updates(params, updates)
        metrics = {"loss": aux["loss"], "grad_norm": gnorm, "lr": lr}
        if "aux_loss" in aux:
            metrics["aux_loss"] = aux["aux_loss"]
        return params, opt_state, metrics

    return train_step


def make_grad_accum_train_step(cfg: ModelConfig, optimizer: Optimizer,
                               schedule: Callable, n_micro: int,
                               grad_clip: float = 1.0):
    """Gradient accumulation over ``n_micro`` microbatches (the batch's
    leaves are ``[n_micro, micro_batch, ...]``): gradients summed in
    float32, divided by ``n_micro`` and cast to ``cfg.jdtype``."""
    loss_fn = _loss_fn(cfg)

    def train_step(params, opt_state, batch):
        batch = _to_device(batch, _device(params))
        accum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        losses = []
        for i in range(n_micro):
            mb = {k: v[i] for k, v in batch.items()}
            (loss, _), g = value_and_grad(lambda p: loss_fn(cfg, p, mb),
                                          params)
            accum = tree_map(lambda a, b: a + b, accum, g)
            losses.append(loss)
        grads = tree_map(lambda g: (g / n_micro).to(cfg.jdtype), accum)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        lr = schedule(opt_state["step"])
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        params = apply_updates(params, updates)
        return params, opt_state, {"loss": torch.stack(losses).mean(),
                                   "grad_norm": gnorm, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    fam = get_family(cfg)

    def prefill_step(params, batch, cache):
        if cfg.family == "whisper":
            return fam.prefill(cfg, params, batch, cache)
        return fam.prefill(cfg, params, batch["tokens"], cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    fam = get_family(cfg)

    def decode_step(params, cache, tokens):
        return fam.decode_step(cfg, params, cache, tokens)

    return decode_step
