"""Helpers of the model-parallel parity tests (``test_torch_parallel_*``):
a gloo group of CPU ranks started once with ``spawn`` (``start_group`` /
``join_group``), the rank programs it runs, and a subprocess running JAX
on forced host devices (``start_jax`` / ``finish_jax``).  This module
imports no JAX: the ranks import it."""
from __future__ import annotations

import multiprocessing as mp
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the group and the JAX subprocess
# ---------------------------------------------------------------------------
def _entry(target, rank: int, world: int, init: str, out: str):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.parallel import init_distributed
    args = torch.load(f"{out}/args.pt", weights_only=False)
    init_distributed("gloo", init, world, rank)
    res = target(rank, world, *args)
    torch.save(res, f"{out}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def start_group(target, world: int, tmp, *args):
    """Start ``target(rank, world, *args)`` on ``world`` spawned ranks of
    one gloo group; ``join_group`` collects them.  The arguments go
    through a file: a spawned child reads what it is handed only after
    its imports, so a large pickle in the pipe would make each start wait
    for the child before it."""
    ctx = mp.get_context("spawn")
    os.makedirs(tmp, exist_ok=True)
    torch.save(args, f"{tmp}/args.pt")
    init = f"file://{tmp}/rendezvous"
    procs = [ctx.Process(target=_entry,
                         args=(target, r, world, init, str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmp


def join_group(group, timeout: float = 600):
    """Each rank's return value (tensors, numbers, dicts), in rank order.
    A rank that fails fails the call at once (the others would wait in a
    collective), and so does the group still running after ``timeout``
    seconds (generous: a loaded machine runs the ranks many times
    slower)."""
    procs, tmp = group
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs) \
                and time.monotonic() < deadline \
                and all(p.exitcode in (None, 0) for p in procs):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"ranks exited {codes}"
    return [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
            for r in range(len(procs))]




def start_jax(code: str, out: str, devices: int = 8):
    """Start ``code`` (which writes ``OUT``, an ``.npz`` path) in a
    subprocess on ``devices`` forced host devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}")
    src = f"OUT = {out!r}\n" + textwrap.dedent(code)
    return subprocess.Popen([sys.executable, "-c", src], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_jax(proc, out: str, timeout: float = 600):
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stdout[-2000:] + stderr[-2000:]
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------
def ops_ranks(rank: int, world: int, inp: dict, cfg_kw: dict) -> dict:
    """``collectives_ranks`` and ``moe_pipe_ranks`` in one group."""
    out = collectives_ranks(rank, world, inp)
    out.update(moe_pipe_ranks(rank, world, inp, cfg_kw))
    return out


def collectives_ranks(rank: int, world: int, inp: dict) -> dict:
    """Ring all-gather / reduce-scatter, ``compressed_psum``, two EF steps
    and ``dist_decode_attention`` on a ``(4,)`` data mesh."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel.dist_attention import dist_decode_attention
    mesh = make_mesh((world,), ("data",), device="cpu")
    out = {}
    x = torch.from_numpy(inp["ring"])                  # [world * 8, 3]
    s = x.shape[0] // world
    out["ag"] = C.ring_all_gather(x[rank * s:(rank + 1) * s], mesh, "data")
    out["rs"] = C.ring_reduce_scatter(x * (rank + 1), mesh, "data")
    y = torch.from_numpy(inp["psum"][rank])
    out["q"], out["scale"], _ = C._quantize_int8(y)
    out["cpsum"] = C.compressed_psum(y, mesh, "data")
    one, init_error = C.make_ef_compressor({"w": y}, mesh)
    g = torch.from_numpy(inp["ef"][rank])
    err = init_error({"w": g})["w"]
    red1, err1 = one(g, err)
    red2, err2 = one(g * 0.5, err1)
    out.update(red1=red1, err1=err1, red2=red2, err2=err2)
    s_loc = inp["k"].shape[1] // world
    kv = [torch.from_numpy(inp[n][:, rank * s_loc:(rank + 1) * s_loc])
          for n in ("k", "v")]
    q = torch.from_numpy(inp["q"])
    for name in ("vl", "vl0"):
        vl = torch.from_numpy(inp[name])
        out["att_" + name] = dist_decode_attention(q, *kv, vl, mesh)
    return out


def moe_pipe_ranks(rank: int, world: int, inp: dict, cfg_kw: dict) -> dict:
    """``ep_moe_ffn`` at two capacity factors, ``moe_ffn`` with
    ``moe_impl="ep"`` under the mesh and without it, the EP gradient of x
    and the whole parameters (capacity factor 100), and
    ``pipeline_forward`` over a stage axis."""
    from repro_torch.models import moe as M
    from repro_torch.models.base import ModelConfig
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel.ep_dispatch import ep_moe_ffn
    from repro_torch.parallel.pipeline import pipeline_forward
    mesh = make_mesh((world,), ("model",), device="cpu")
    p = {k: torch.from_numpy(v) for k, v in inp["moe"].items()}
    x = torch.from_numpy(inp["x"])
    out = {f"ep_{cf}": ep_moe_ffn(x, p, mesh, topk=2, capacity_factor=cf)
           for cf in (100.0, 1.25)}
    cfg = ModelConfig(**cfg_kw)
    with mesh:
        out["moe_ep_mesh"], _ = M.moe_ffn(cfg, p, x)
    out["moe_ep_nomesh"], _ = M.moe_ffn(cfg, p, x)
    out["grouped"], _ = M.moe_ffn(cfg.replace(moe_impl="gather"), p, x)
    pl = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xl = x.clone().requires_grad_(True)
    (ep_moe_ffn(xl, pl, mesh, topk=2, capacity_factor=100.0)
     * torch.from_numpy(inp["ct"])).sum().backward()
    out["ep_grads"] = {"x": xl.grad, **{k: v.grad for k, v in pl.items()}}
    stage = make_mesh((world,), ("stage",), device="cpu")
    ws = torch.from_numpy(inp["ws"])
    out["pipe"] = pipeline_forward(lambda w, h: torch.tanh(h @ w), ws,
                                   torch.from_numpy(inp["xp"]), stage,
                                   n_micro=4)
    return out


def train_ranks(rank: int, world: int, cfg_kw: dict, params_np: dict,
                batches: list, lr: float, moe_kw: dict,
                moe_batches: list) -> dict:
    """The sharded train step of a dense smoke config on a (data 2, model
    2) mesh (``make_host_mesh``) for two steps, its state gathered; one
    step with the EF compressor; a run on ranks 0 and 1 for two steps
    whose gathered state rank 0 resumes alone (``reshard_state`` to one
    place) for a third; and an MoE smoke config with ``moe_impl="ep"``
    stepped twice under ``with mesh:`` on the (data 2, model 2) mesh (its
    weights the port's ``init`` at seed 0)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.base import ModelConfig, get_family
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import make_host_mesh, make_mesh
    from repro_torch.parallel.collectives import ErrorFeedback
    from repro_torch.runtime.elastic import (gather_state, reshard_state,
                                             state_shardings)
    cfg = ModelConfig(**cfg_kw)
    full = params_from_numpy(params_np)
    opt = adamw()
    whole = {"params": full, "opt": opt.init(full)}

    def run(mesh, state, steps, compress=None, cfg=cfg, whole=whole):
        sh = state_shardings(cfg, whole, mesh)
        step = make_train_step(cfg, opt, constant(lr), mesh=mesh,
                               shardings=sh, compress_grads=compress)
        p, o = state["params"], state["opt"]
        metrics = []
        for b in steps:
            p, o, m = step(p, o, b)
            metrics.append({k: float(v) for k, v in m.items()})
        return {"params": p, "opt": o}, metrics, sh

    out = {}
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    local = reshard_state(cfg, whole, mesh)
    out["at_rest"] = sum(t.numel() for t in _leaves(local))
    st, out["metrics"], sh = run(mesh, local, batches[:2])
    out["state"] = gather_state(st, sh)
    _, out["ef_metrics"], _ = run(
        mesh, local, batches[:1], ErrorFeedback(full, mesh, "data"))
    mcfg = ModelConfig(**moe_kw)
    mp = get_family(mcfg).init(mcfg, seed=0, device="cpu")
    mwhole = {"params": mp, "opt": opt.init(mp)}
    with mesh:
        st, out["moe_metrics"], sh = run(
            mesh, reshard_state(mcfg, mwhole, mesh), moe_batches,
            cfg=mcfg, whole=mwhole)
    out["moe_state"] = gather_state(st, sh)
    pair = make_mesh((2,), ("data",), device="cpu", ranks=[0, 1])
    if pair is not None:
        st, out["pair_metrics"], sh = run(
            pair, reshard_state(cfg, whole, pair), batches[:2])
        resumed = gather_state(st, sh)
    alone = make_mesh((1,), ("data",), device="cpu", ranks=[0])
    if alone is not None:
        st, out["resumed_metrics"], _ = run(
            alone, reshard_state(cfg, resumed, alone), batches[2:3])
        out["resumed_state"] = st
    return out


def _leaves(tree):
    from repro_torch.core.pytree import flatten
    return flatten(tree)[0]
