"""Microbatch pipeline parallelism over a mesh axis — the counterpart of
``repro.parallel.pipeline`` (the paper's pattern, promoted to the model
layer — see DESIGN.md §2 table).

GPipe's forward schedule: the layer stack is split into S contiguous
stages laid out along the ``stage`` mesh axis; M microbatches stream
through with the classic fill/drain bubble of (S-1)/(M+S-1) — the same
arithmetic as the paper's Fig. 3 (7T for 4 items through 4 stages).
Stage i takes microbatch m from stage i-1 (stage 0 from the input), runs
its L/S layers and sends the result on to stage i+1 without waiting for
it to be taken, so stage i works on m+1 while stage i+1 works on m.  The
last stage's outputs go to every rank.  Only the forward is ported: the
JAX module has no backward either.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.core.pytree import flatten, tree_map
from repro_torch.parallel.collectives import broadcast


def pipeline_forward(block_fn: Callable, params_stacked: Any, x, mesh, *,
                     stage_axis: str = "stage", n_micro: int = None):
    """Run x through L layers laid out as S pipeline stages.

    block_fn(layer_params, x) -> x (same shape and dtype); params_stacked
    has leading layer dim L, L % S == 0, of which this rank runs its L/S
    layers (views).  x [B, ...] with B % n_micro == 0, the same on every
    rank.

    Returns, on every rank, the output of running the layers
    sequentially."""
    s, sid = mesh.shape[stage_axis], mesh.coords[stage_axis]
    n_micro = n_micro or s
    b = x.shape[0]
    lead = flatten(params_stacked)[0][0].shape[0]
    if b % n_micro or lead % s:
        raise ValueError(f"batch {b} over {n_micro} microbatches, {lead} "
                         f"layers over {s} stages: each must divide")
    per = lead // s
    mine = tree_map(lambda a: a[sid * per:(sid + 1) * per], params_stacked)

    def run_stage(h):
        for i in range(per):
            h = block_fn(tree_map(lambda a: a[i], mine), h)
        return h

    micro = x.chunk(n_micro)
    if s == 1:
        return torch.cat([run_stage(m) for m in micro])
    group, line = mesh.groups[stage_axis], mesh.line(stage_axis)
    wire = mesh.wire
    sent, outs = [], []
    for m in range(n_micro):
        if sid == 0:
            h = micro[m]
        else:
            buf = torch.empty(micro[m].shape, dtype=x.dtype, device=wire)
            dist.recv(buf, line[sid - 1], group=group)
            h = buf.to(x.device)
        y = run_stage(h)
        if sid < s - 1:
            out = y.detach().to(wire).contiguous()
            if out.data_ptr() == y.data_ptr():
                out = out.clone()
            if out.is_cuda:                # the send reads it on its own
                torch.cuda.current_stream(out.device).synchronize()
            sent.append((dist.isend(out, line[sid + 1], group=group), out))
        else:
            outs.append(y)
    for work, _ in sent:
        work.wait()
    done = torch.cat(outs) if sid == s - 1 else x.new_empty(x.shape)
    return broadcast(done, mesh, stage_axis, s - 1)


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble = (S-1)/(M+S-1) — the paper's fill/drain arithmetic."""
    return (n_stages - 1) / (n_micro + n_stages - 1)
