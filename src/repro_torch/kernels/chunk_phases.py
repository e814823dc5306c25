"""Where a block of the chunked scan kernels spends its time, on an H100.

Builds ``csrc/ssm_chunk.cu`` and ``csrc/rwkv6_chunk.cu`` with
``-DCHUNK_PROF`` into ``build/chunk_phases/`` (thread 0 of each block
writes the global timer at the ``CHUNK_MARK(k)`` points, after a barrier;
the normal build compiles the marks to nothing), runs each
kernel through its wrapper's ``launch_chunked`` at the serving engine's
prefill ``[1, 384]`` and mcts-forward ``[16, 166]`` shapes (zamba2-1.2b: 64
heads of 64 x 64; rwkv6-1.6b: 32 heads of 64; bf16, random inputs from
seed 0) and prints, per shape, the span of the launch and each phase's
mean and largest time over the blocks:

    PYTHONPATH=src python3 -m repro_torch.kernels.chunk_phases

Phases.  SSD: 0 loads, 1 decay sums and the split of diag(..) B, 2 the
products before the hand-over (C B^T, M x, x^T (..) B), 3 the wait for
the previous chunk, 4 the hand-over (state in, state out, flag), 5 C S^T
and y.  WKV6: 0 loads, 1 bonus and own-sub-chunk scores, 2 log decays, 3
the running sums (rf, kd, kf), 4 the products before the hand-over, 5 the
wait, 6 the hand-over, 7 the state term and y.  Blocks share their SM
with others (3-4 SSD, 2 WKV6), so a phase's time includes theirs.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build

PHASES = {"ssm_chunk": ["loads", "sums+split", "products", "wait",
                        "hand-over", "state term+y"],
          "rwkv6_chunk": ["loads", "bonus+pairs", "log", "running sums",
                          "products", "wait", "hand-over", "state term+y"]}
MAX_BLOCKS, MAX_MARKS = 4096, 16     # chunk_mma.cuh's chunk_prof


def marks(name: str, blocks: int) -> torch.Tensor:
    """The last launch's marks ``[blocks, phases + 1]`` (ns) of
    ``csrc/<name>.cu``."""
    buf = torch.zeros(MAX_BLOCKS * MAX_MARKS, dtype=torch.int64)
    _build.check(_build.bind(name, "chunk_prof_read", [ctypes.c_void_p])(
        buf.data_ptr()), "chunk_prof_read")
    return buf.view(MAX_BLOCKS, MAX_MARKS)[:min(blocks, MAX_BLOCKS),
                                           :len(PHASES[name]) + 1].double()


def report(what: str, name: str, m: torch.Tensor) -> None:
    d = (m[:, 1:] - m[:, :-1]) / 1e3
    print(f"{what}: {m.shape[0]} blocks, span "
          f"{float(m.max() - m.min()) / 1e3:.2f} us, block "
          f"{float((m[:, -1] - m[:, 0]).mean()) / 1e3:.2f} us; phase us "
          "(mean / max): " + ", ".join(
              f"{p} {float(a):.2f} / {float(b):.2f}" for p, a, b in
              zip(PHASES[name], d.mean(0), d.max(0).values)), flush=True)


def run(name: str, what: str, launch, args, blocks: int) -> None:
    """Three launches (the last one's marks are read), then the report."""
    for _ in range(3):
        launch(*args, torch.empty_like(args[0]), torch.empty_like(args[-1]))
        torch.cuda.synchronize()
    report(what, name, marks(name, blocks))


def main() -> int:
    if not torch.cuda.is_available():
        print("chunk_phases: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    _build.use_defines(["-DCHUNK_PROF"],
                       _build.BUILD_DIR.parent / "chunk_phases")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for b, t in ((1, 384), (16, 166)):
        h, p, n = 64, 64, 64
        buf = rnd(b, t, h * p + 2 * n).mul(0.5).bfloat16()
        x = buf[..., :h * p].reshape(b, t, h, p)
        bm, cm = buf[..., h * p: h * p + n], buf[..., h * p + n:]
        dt = torch.nn.functional.softplus(rnd(b, t, h) - 2.0)
        a, d = -torch.exp(rnd(h) * 0.3), torch.ones(h, device=dev)
        run("ssm_chunk", f"ssd [{b}, {t}]", SS.launch_chunked,
            (x, dt, a, bm, cm, d, rnd(b, h, p, n) * 0.1),
            b * h * -(-t // SS.CHUNK))
    for b, t in ((1, 384), (16, 166)):
        h, n = 32, 64
        r, k, v = (rnd(b, t, h, n).mul(0.5).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(rnd(b, t, h, n) * 0.5 - 6.0))
        u = rnd(h, n).mul(0.3).bfloat16()
        run("rwkv6_chunk", f"wkv6 [{b}, {t}]", WK.launch_chunked,
            (r, k, v, w, u, rnd(b, h, n, n) * 0.1),
            b * h * -(-t // WK.CHUNK))
    return 0


if __name__ == "__main__":
    sys.exit(main())
