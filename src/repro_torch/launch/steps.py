"""Step factories: train_step / prefill_step / decode_step for a family —
the counterpart of ``repro.launch.steps``.

A train step is a function ``(params, opt_state, batch) -> (params,
opt_state, metrics)`` that does not modify its inputs: the gradient is
taken with ``torch.autograd.grad`` on detached leaves that require grad,
and the optimizer returns new tensors.  ``batch`` holds numpy arrays or
tensors; they are moved to the parameters' device, and on a mesh each
leaf keeps this rank's rows under the ``("batch", ...)`` spec that
``resolve_spec`` gives under ``DEFAULT_RULES`` (where the JAX step
constrains its batch to that spec).

Given a named mesh (``parallel.make_mesh``) and the state's shardings
(``runtime.elastic.state_shardings``), the train step is ZeRO-3 / FSDP's:
parameters and optimizer state are stored at rest as each rank's slices
under ``resolve_spec`` (``reshard_state`` cuts them), the batch is split
over the batch axes (``pod`` / ``data``), each leaf is gathered whole for
the forward and backward (ring all-gathers), and each gradient is
reduce-scattered back to its slice as the mean over the same batch axes
(ring reduce-scatters, in float32).  The global gradient norm sums each slice's
squares once (a replicated slice divided by its copies) over the mesh,
so ``grad_norm`` is the one-process value up to summation order; the
optimizer updates each rank's slices.  This gives the one-process step's
numbers without tensor-parallel kernels (every rank of a ``model`` line
computes the same batch rows).  The loss is the mean of the data shards'
means, which is the batch mean when the shards weigh the same (the dense
language-model loss); a loss that is not a mean of per-token terms, as
the MoE router's load-balancing term, is averaged over the shards' own
values.  ``compress_grads`` on a mesh is the gradient's all-mean over the
data axis (``parallel.collectives.ErrorFeedback``: int8 with error
feedback), taken on each rank's whole gradient before its slice is kept.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.core.pytree import flatten, tree_map, unflatten
from repro_torch.models.base import ModelConfig, get_family
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.parallel import collectives as C
from repro_torch.parallel.sharding import (NamedSharding, _dim_axes,
                                           local_slices, replicas,
                                           resolve_spec, spec_leaves)


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


def _specs(shardings):
    """The tree of specs of a tree of ``NamedSharding``."""
    if isinstance(shardings, NamedSharding):
        return shardings.spec
    if isinstance(shardings, dict):
        return {k: _specs(v) for k, v in shardings.items()}
    return [_specs(v) for v in shardings]


def _mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over every rank of ``mesh``."""
    for a in mesh.axis_names:
        x = C.psum(x, mesh, a)
    return x


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
                    compress_grads: Optional[Callable] = None, *,
                    mesh=None, shardings=None):
    """The train step; with ``mesh`` (more than one place) the sharded
    step over the state's ``shardings`` (``state_shardings(...)``), which
    takes and returns each rank's slices."""
    loss_fn = _loss_fn(cfg)
    if mesh is not None and mesh.size > 1:
        if shardings is None:
            raise ValueError("a sharded train step needs the state's "
                             "shardings (runtime.elastic.state_shardings)")
        return _sharded_train_step(cfg, loss_fn, optimizer, schedule,
                                   grad_clip, compress_grads, mesh,
                                   _specs(shardings["params"]))

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


def _sharded_train_step(cfg, loss_fn, optimizer, schedule, grad_clip,
                        compress_grads, mesh, specs):
    specs_flat = spec_leaves(specs)

    def train_step(params, opt_state, batch):
        batch = _to_device(batch, mesh.device)
        v = next(iter(batch.values()))
        bspec = resolve_spec(("batch",) + (None,) * (v.ndim - 1),
                             tuple(v.shape), mesh)
        # this rank's rows, and the axes they are split over: the
        # gradient's mean
        batch = {k: t[local_slices(bspec, t.shape, mesh)]
                 for k, t in batch.items()}
        red = list(_dim_axes(bspec[0] if bspec else None))
        n_red = math.prod(mesh.shape[a] for a in red)
        full = C.gather_tree(params, specs, mesh)
        (loss, aux), grads = value_and_grad(
            lambda p: loss_fn(cfg, p, batch), full)
        del full
        treedef, g_red = flatten(grads)[1], red
        if compress_grads is not None:     # its all-mean over its axis
            grads = compress_grads(grads)
            g_red = [a for a in red
                     if a != getattr(compress_grads, "axis", "data")]
        n_g = math.prod(mesh.shape[a] for a in g_red)
        g_leaves = [(C.reduce_scatter(g.float(), sp, mesh, g_red)
                     / n_g).to(g.dtype)
                    for g, sp in zip(flatten(grads)[0], specs_flat)]
        del grads
        sq = sum(torch.sum(torch.square(g.float())) / replicas(sp, mesh)
                 for g, sp in zip(g_leaves, specs_flat))
        gnorm = torch.sqrt(_mesh_sum(sq, mesh))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = unflatten(treedef, [(g.float() * scale).to(g.dtype)
                                    for g in g_leaves])
        lr = schedule(opt_state["step"])
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        params = apply_updates(params, updates)

        def mean(t):
            for a in red:
                t = C.psum(t, mesh, a)
            return t / n_red
        metrics = {"loss": mean(aux["loss"]), "grad_norm": gnorm, "lr": lr}
        if "aux_loss" in aux:
            metrics["aux_loss"] = mean(aux["aux_loss"])
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
