"""Serving driver: the continuous-batching engine (greedy) or MCTS-guided
decoding of one prompt — the counterpart of ``repro.launch.serve``.

Runs on ``cuda:0`` unless ``--device`` says otherwise:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --mcts --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.base import count_params, get_family
from repro_torch.search.api import resolve_device
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.serving.scheduler import Request


def main(argv=None) -> dict:
    """Parse ``argv`` (default ``sys.argv``), serve, print; returns the
    engine's summary with each request's prompt and tokens under
    ``"prompts"`` / ``"outputs"``, or ``{"tokens", "prompt"}`` with
    ``--mcts``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--mcts", action="store_true")
    ap.add_argument("--mcts-budget", type=int, default=16)
    ap.add_argument("--mcts-lanes", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("whisper",):
        raise SystemExit("serve driver targets decoder-only archs; "
                         "whisper decoding runs via examples/")
    dev = resolve_device(args.device)
    fam = get_family(cfg)
    params = fam.init(cfg, seed=0, device=dev)
    print(f"arch={cfg.name} params={count_params(params):,} device={dev}")
    rng = np.random.default_rng(0)

    if args.mcts:
        from repro_torch.serving.mcts_decode import (MCTSDecodeConfig,
                                                     mcts_decode)
        prompt = rng.integers(1, cfg.vocab_size, size=args.prompt_len)
        dcfg = MCTSDecodeConfig(budget=args.mcts_budget,
                                lanes=args.mcts_lanes)
        t0 = time.time()
        toks = mcts_decode(cfg, params, prompt, args.max_new, dcfg,
                           device=dev)
        dt = time.time() - t0
        print(f"mcts-decode: {toks}")
        print(f"{args.max_new} tokens in {dt:.1f}s "
              f"({args.max_new * dcfg.budget} playouts, "
              f"{args.max_new * dcfg.budget / dt:.1f} playouts/s)")
        return {"tokens": toks, "prompt": [int(t) for t in prompt]}

    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=args.max_batch, max_seq=args.max_seq), device=dev)
    t0 = time.time()
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        reqs.append(Request(uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                                       size=plen),
                            max_new_tokens=args.max_new))
        eng.submit(reqs[-1])
    out = eng.run_until_drained()
    out["prompts"] = {r.uid: [int(t) for t in r.prompt] for r in reqs}
    out["outputs"] = {r.uid: list(r.out_tokens) for r in reqs}
    dt = time.time() - t0
    print(f"served {args.requests} requests, {out['tokens']} tokens "
          f"in {dt:.1f}s ({out['tokens']/dt:,.1f} tok/s, "
          f"{out['steps']} engine steps)")
    print(f"latency p50={out['latency_p50']:.3f}s "
          f"p95={out['latency_p95']:.3f}s")
    for k, v in sorted(out["stats"].items()):
        print(f"  {k}={v:.4g}")
    return out


if __name__ == "__main__":
    main()
