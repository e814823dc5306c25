"""Explicit expert parallelism over a mesh axis — the counterpart of
``repro.parallel.ep_dispatch``.

Plain dispatch cannot shard the experts axis without moving whole
capacity buffers between ranks.  This module expresses EP explicitly:

* tokens replicated across the ``expert_axis`` (the model axis carries no
  activations of its own);
* each rank owns E/n experts, locally dispatches ALL its tokens to ITS
  experts (top-k hits for other ranks' experts simply mask out locally);
* each rank computes partial combine outputs for its experts only;
* one all-reduce over the expert axis sums the partials — the only
  collective, [tokens, D] per MoE layer.

The capacity rule and the slot order are the JAX function's: capacity
``max(8, ceil(cf * n_tok_local * topk / E))`` (not rounded to 8, unlike
the grouped dispatch's), and a token-slot's position in its expert its
rank among ALL top-k slots in token-major, slot-minor order, so the
drops at a real capacity factor are the JAX EP's, on any number of ranks.
The expert products are ``torch.einsum`` (the JAX package computes them
outside any Pallas kernel); as the port's grouped dispatch, the gate
product is rounded to the tokens' dtype before its float32 SiLU.

``ep_moe_ffn`` is differentiable, with Megatron's pair of conjugate
operations around the local body: the inputs every rank of the axis holds
(the tokens, the router, whole expert weights before this rank's slice is
cut) pass through an identity whose backward all-reduces their gradient
over the axis, and the output's all-reduce passes its gradient through.
So every rank gets the one-rank gradient of every input it was given.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.parallel.collectives import psum


class _SumOverAxis(torch.autograd.Function):
    """All-reduce SUM of the ranks' partial outputs.  Its backward passes
    the output's gradient through unchanged: every rank of the axis holds
    the same output and takes the same loss of it, so each partial's
    gradient is the output's."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        return psum(y, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyToAxis(torch.autograd.Function):
    """The identity on an input every rank of the axis holds; its backward
    all-reduces the gradient over the axis, since each rank's partial
    output reaches the input through this rank's experts only."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


def ep_slots(topi: torch.Tensor, lo: int, n_local: int, capacity: int):
    """The slots of this rank's experts ``[lo, lo + n_local)`` for the
    top-k choices ``topi [N, K]``: ``(le, pos, keep)``, each ``[N * K]``
    in token-major order — local expert (``n_local`` for another rank's),
    position in it among all slots, kept where local and ``pos <
    capacity``."""
    e_all = topi.reshape(-1).long()
    local = (e_all >= lo) & (e_all < lo + n_local)
    le = torch.where(local, e_all - lo, n_local)
    onehot = F.one_hot(le, n_local + 1).to(torch.int32)[:, :n_local]
    pos = (onehot.cumsum(0) - onehot).gather(
        1, le.clamp_max(n_local - 1)[:, None])[:, 0].long()
    return le, pos, local & (pos < capacity)


def _local_moe(x2d, router, wg, wu, wd, *, topk: int, lo: int,
               capacity: int):
    """x2d ``[N, D]`` (replicated over the axis); wg / wu / wd local
    ``[E/n, D, F]`` / ``[E/n, F, D]`` -> this rank's partial ``[N, D]``
    float32."""
    n_local = wg.shape[0]
    gates = torch.softmax(x2d.float() @ router.float(), -1)
    topv, topi = torch.topk(gates, topk, dim=-1)                 # [N, K]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    n, d = x2d.shape
    le, pos, keep = ep_slots(topi, lo, n_local, capacity)
    le_c = le.clamp_max(n_local - 1)
    # a dropped slot goes to the spare row ``capacity``, sliced off
    slot = torch.where(keep, pos, capacity)
    buf = x2d.new_zeros((n_local, capacity + 1, d))
    for j in range(topk):
        buf.index_put_((le_c[j::topk], slot[j::topk]), x2d, accumulate=True)
    buf = buf[:, :capacity]
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg).float()).to(x2d.dtype)
    h = h * torch.einsum("ecd,edf->ecf", buf, wu)
    yb = torch.einsum("ecf,efd->ecd", h, wd)                     # [E/n, C, D]

    y = torch.zeros((n, d), dtype=torch.float32, device=x2d.device)
    for j in range(topk):
        got = yb[le_c[j::topk], pos[j::topk].clamp_max(capacity - 1)]
        y = y + torch.where(keep[j::topk, None], got, 0).float() \
            * topv[:, j, None]
    return y


def ep_capacity(n_tok_local: int, topk: int, e_total: int,
                capacity_factor: float) -> int:
    """The JAX EP's capacity per local expert."""
    return max(8, int(math.ceil(
        capacity_factor * n_tok_local * topk / e_total)))


def ep_moe_ffn(x2d, params: Dict[str, Any], mesh, *, topk: int,
               capacity_factor: float = 1.25, expert_axis: str = "model"):
    """x2d ``[N, D]``: this rank's token rows (sharded over the data
    axes, the same on every rank of ``expert_axis``); params {router ``[D,
    E]``, wg / wu ``[E, D, F]``, wd ``[E, F, D]``}, the experts whole (this
    rank's E/n are sliced) or already this rank's E/n.

    Each rank dispatches its tokens to its local experts; one all-reduce
    over ``expert_axis`` combines.  Returns ``[N, D]`` in x's dtype on
    every rank of the axis.  Under autograd each rank's gradient of x, the
    router and whole expert weights is the whole one-rank gradient (an
    all-reduce over the axis in the backward); of weights given as this
    rank's E/n, this rank's experts' gradient."""
    e_total = params["router"].shape[-1]
    n_shards = mesh.shape[expert_axis]
    if e_total % n_shards:
        raise ValueError(f"{e_total} experts do not split over a "
                         f"{n_shards}-way {expert_axis!r} axis")
    n_local = e_total // n_shards
    lo = mesh.coords[expert_axis] * n_local

    def shared(t):
        return _CopyToAxis.apply(t, mesh, expert_axis)
    w = [params[k] for k in ("wg", "wu", "wd")]
    if w[0].shape[0] == e_total and n_shards > 1:
        w = [shared(t)[lo:lo + n_local] for t in w]
    capacity = ep_capacity(x2d.shape[0], topk, e_total, capacity_factor)
    y = _local_moe(shared(x2d), shared(params["router"]), *w, topk=topk,
                   lo=lo, capacity=capacity)
    return _SumOverAxis.apply(y, mesh, expert_axis).to(x2d.dtype)
