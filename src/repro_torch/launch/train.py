"""Training driver: data pipeline + optimizer + fault-tolerant loop +
checkpoints — the counterpart of ``repro.launch.train``.

Runs on ``cuda:0`` unless ``--device`` says otherwise; ``--smoke`` takes
the reduced same-family config (``--device cpu`` runs it on the CPU with
the kernels' plain versions):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --smoke --steps 20 --device cpu --ckpt-dir /tmp/ckpt

AdamW or Lion; MiniCPM pairs with WSD (its paper's schedule), the others
with cosine; gradients clipped to a global norm of 1.0.  The family's
``init(cfg, seed=0, device=...)`` gives the weights.  Every family trains
(dense, moe, rwkv6, zamba2, vlm, whisper): the MoE's loss adds the
routers' load-balancing loss (``--arch deepseek-v2-lite-16b`` or
``grok-1-314b``; at the published widths only on a card, and deepseek's
AdamW state fits one H100 only cut in depth); the data pipeline's
batches carry the VLM's ``patches`` (``--seq`` counts the patches and the
text) and Whisper's ``frames`` (``enc_seq`` of them; ``--seq`` is the
decoder's length).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, Prefetcher, make_batch_iterator
from repro_torch.launch.steps import make_train_step
from repro_torch.models.base import count_params, get_family
from repro_torch.optim import adamw, lion
from repro_torch.optim.schedules import cosine, wsd
from repro_torch.runtime.ft import FTConfig, TrainerLoop
from repro_torch.search.api import resolve_device


def schedule(arch: str, lr: float, steps: int):
    """MiniCPM pairs with WSD (its paper's contribution); others cosine."""
    if arch.startswith("minicpm"):
        return wsd(lr, warmup=max(steps // 20, 1), stable=steps // 2,
                   decay=max(steps // 3, 1))
    return cosine(lr, warmup=max(steps // 20, 1), total=steps)


def build(arch: str, smoke: bool, batch: int, seq: int, lr: float,
          steps: int, optimizer: str = "adamw", device=None):
    """``(cfg, step_fn, params, opt_state, data_cfg)`` on ``device``
    (``cuda:0`` by default)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.family == "vlm" and seq <= cfg.n_patches:
        raise ValueError(f"{cfg.name}: seq ({seq}) counts the "
                         f"{cfg.n_patches} image patches and the text; "
                         "it must exceed the patches")
    fam = get_family(cfg)
    opt = {"adamw": adamw, "lion": lion}[optimizer]()
    step_fn = make_train_step(cfg, opt, schedule(arch, lr, steps))
    params = fam.init(cfg, seed=0, device=resolve_device(device))
    opt_state = opt.init(params)
    dcfg = DataConfig(seed=0, batch_size=batch, seq_len=seq)
    return cfg, step_fn, params, opt_state, dcfg


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv``), train, print; returns the
    last step and the losses of the steps run (after any restore)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg, step_fn, params, opt_state, dcfg = build(
        args.arch, args.smoke, args.batch, args.seq, args.lr, args.steps,
        args.optimizer, args.device)
    print(f"arch={cfg.name} params={count_params(params):,} "
          f"batch={args.batch}x{args.seq} device={resolve_device(args.device)}")

    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    loop = TrainerLoop(
        step_fn, params, opt_state,
        lambda start: Prefetcher(make_batch_iterator(cfg, dcfg, start)), ft)
    if loop.try_restore():
        print(f"restored from step {loop.step}")

    t0 = time.time()
    last = t0
    start = loop.step
    while loop.step < args.steps:
        n = min(args.log_every, args.steps - loop.step)
        out = loop.run(n)
        now = time.time()
        tput = n * args.batch * args.seq / (now - last)
        last = now
        print(f"step {loop.step:5d} loss {out['losses'][-1]:.4f} "
              f"tok/s {tput:,.0f}")
    wall = time.time() - t0
    final = f"{loop.history[-1]:.4f}" if loop.history else "-"
    print(f"done: {loop.step - start} steps in {wall:.1f}s; "
          f"final loss {final}")
    return {"step": loop.step, "losses": list(loop.history)}


if __name__ == "__main__":
    main()
