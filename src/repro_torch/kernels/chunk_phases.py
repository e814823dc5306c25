"""Where a block of the chunked scan kernels spends its time, on an H100.

Builds the ``csrc/`` sources with ``-DCHUNK_PROF`` into
``build/chunk_phases/`` (thread 0 of each block writes the global timer at
the ``CHUNK_MARK(k)`` points, after a barrier, or sums each phase's time
at the backward kernels' ``CHUNK_PHASE(k)`` points; the normal build
compiles the marks to nothing), runs the forward kernels through their
wrappers' ``launch_chunked`` at the serving engine's prefill ``[1, 384]``
and mcts-forward ``[16, 166]`` shapes (zamba2-1.2b: 64 heads of 64 x 64;
rwkv6-1.6b: 32 heads of 64; bf16, random inputs from seed 0) and the
backward kernels through ``launch_bwd`` at the training shapes (8 x 2048
steps, bf16), and prints, per shape, the span of the launch and each
phase's mean and largest time over the blocks:

    PYTHONPATH=src python3 -m repro_torch.kernels.chunk_phases [--before DIR]

With ``--before DIR`` (the root of a checkout of a commit whose backward
kernels have the earlier design, one block of float tiles an SM) it also
runs that checkout's two backward kernels, in a process of its own, with ``CHUNK_MARK(k)`` points
put into copies of their sources before the lines ``BEFORE_MARKS`` names,
and prints their phases the same way.

Phases.  SSD: 0 loads, 1 decay sums and the split of diag(..) B, 2 the
products before the hand-over (C B^T, M x, x^T (..) B), 3 the wait for
the previous chunk, 4 the hand-over (state in, state out, flag), 5 C S^T
and y.  WKV6: 0 loads, 1 bonus and own-sub-chunk scores, 2 log decays, 3
the running sums (rf, kd, kf), 4 the products before the hand-over, 5 the
wait, 6 the hand-over, 7 the state term and y.  The backward kernels:
``PHASES["ssm_chunk_bwd"]`` / ``["rwkv6_chunk_bwd"]`` (summed over a
block's heads in the SSD backward).  Blocks share their SM with others
(3-4 SSD, 2 WKV6, 2 of each backward), so a phase's time includes theirs.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build

PHASES = {"ssm_chunk": ["loads", "sums+split", "products", "wait",
                        "hand-over", "state term+y"],
          "rwkv6_chunk": ["loads", "bonus+pairs", "log", "running sums",
                          "products", "wait", "hand-over", "state term+y"],
          "ssm_chunk_bwd": ["B, C, C B^T", "head loads+scans",
                            "pre-wait products", "wait", "hand-over",
                            "post-wait products", "sums", "part stores"],
          "rwkv6_chunk_bwd": ["loads+decays", "bonus+own scores", "P, X",
                              "X', V", "A^T, dv part, G", "wait",
                              "hand-over", "Y', dv", "recurrences"]}
# the backward kernels' earlier design (one block of float tiles an SM):
# (phase, the source line before which its closing mark goes); the first
# mark goes before the loads
BEFORE_MARKS = {
    "ssm_chunk_bwd": [
        ("start", "  // this chunk's rows (zeros past the end, past P and "
                  "past N) and S0"),
        ("loads", "  // running sums of dt A: forward (cum) and from the "
                  "end (e1)"),
        ("running sums", "  // CB, DX, DYS; the chunk's part of G_in "
                         "stays in registers"),
        ("pre-wait products", "  // the chain: G in, G_in = exp(cum_last) "
                              "G + (dY o exp(cum))^T C out"),
        ("wait", "  for (int e = tid; e < L * L; e += NT) {\n"
                 "    const int r = e >> 6, c = e & 63;\n    sm.gend"),
        ("hand-over", "  // <G, S0> (S0's tile is free after this)"),
        ("post-wait products", "  // per step m (thread m): dcum, the "
                               "direct part of ddt"),
        ("per-step sums (64 threads)", "  // the leaving state's part, dla "
                                       "= the reverse running sum, ddt, dA"),
        ("dla (one thread), dD", None)],
    "rwkv6_chunk_bwd": [
        ("start", "  // this chunk's rows (zeros past the end and past N; "
                  "w ones) and S0"),
        ("loads", "  // running products of w, one thread per channel; the "
                  "bonus per step"),
        ("running products", "  // P = dY V^T, X = dY S0^T; G = (R o D(0, "
                             "t))^T dY stays in registers"),
        ("pre-wait products", "  // the chain: dSL in, dS0 = D(0, L) o dSL "
                              "+ G out, then the flag"),
        ("wait", "  for (int e = tid; e < L * L; e += NT) {\n"
                 "    const int j = e >> 6, i = e & 63;\n    sm.sd"),
        ("hand-over", "  // a = sum_i S0 o dSL (S0's tile is free after "
                      "this)"),
        ("a, Y, scores", "  // dv = (K o D(s+1, L)) dSL + A^T dY + b o dY"),
        ("dv", "  // Z_t = sum_{t'>t} Dsp[t', t] r_t' X_t', a reverse scan "
               "per channel,"),
        ("Z scan", "  // dr, dk, dw step by step: thread (j, q) keeps M_t[t'] "
                   "for t' in"),
        ("M / N / Q scans", None)]}
MAX_BLOCKS, MAX_MARKS = 4096, 16     # chunk_mma.cuh's chunk_prof


def marks(name: str, blocks: int, phases: int = 0) -> torch.Tensor:
    """The last launch's marks ``[blocks, phases + 1]`` (ns) of
    ``csrc/<name>.cu`` (``phases``: default ``PHASES[name]``'s count)."""
    buf = torch.zeros(MAX_BLOCKS * MAX_MARKS, dtype=torch.int64)
    _build.check(_build.bind(name, "chunk_prof_read", [ctypes.c_void_p])(
        buf.data_ptr()), "chunk_prof_read")
    k = phases or len(PHASES[name])
    return buf.view(MAX_BLOCKS, MAX_MARKS)[:min(blocks, MAX_BLOCKS),
                                           :k + 1].double()


def report(what: str, phases, m: torch.Tensor) -> dict:
    """Print (and return) the launch's span, the mean block time and each
    phase's mean / largest time over the blocks from absolute marks ``m``
    ``[blocks, phases + 1]`` (ns)."""
    d = (m[:, 1:] - m[:, :-1]) / 1e3
    res = {"what": what, "blocks": m.shape[0],
           "span_us": float(m.max() - m.min()) / 1e3,
           "block_us": float((m[:, -1] - m[:, 0]).mean()) / 1e3,
           "phase_us": {p: [float(a), float(b)] for p, a, b in
                        zip(phases, d.mean(0), d.max(0).values)}}
    print(f"{what}: {res['blocks']} blocks, span {res['span_us']:.2f} us, "
          f"block {res['block_us']:.2f} us; phase us (mean / max): "
          + ", ".join(f"{p} {a:.2f} / {b:.2f}"
                      for p, (a, b) in res["phase_us"].items()), flush=True)
    return res


def spans(m: torch.Tensor) -> torch.Tensor:
    """Absolute marks from a backward kernel's summed phases: slot 0 the
    start, slot k the time of phase k."""
    return torch.cat([m[:, :1], m[:, :1] + torch.cumsum(m[:, 1:], 1)], 1)


def run(name: str, what: str, launch, args, blocks: int) -> None:
    """Three launches (the last one's marks are read), then the report."""
    for _ in range(3):
        launch(*args, torch.empty_like(args[0]), torch.empty_like(args[-1]))
        torch.cuda.synchronize()
    report(what, PHASES[name], marks(name, blocks))


def bwd_cases(dev):
    """(name, kind, module, forward arguments, dy, dstate_out, blocks) of
    the two training shapes: rwkv6-1.6b [8, 2048, 32, 64], zamba2-1.2b
    [8, 2048, 64, 64] N 64 (x, B, C slices of one tensor), bf16, seed 0."""
    import torch.nn.functional as F
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    gen = torch.Generator(dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa
    b, t = 8, 2048
    h, n = 32, 64
    r, k, v = (rnd(b, t, h, n).bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(rnd(b, t, h, n) - 3.0))
    wk = ("rwkv6_chunk_bwd", "wkv6 bwd [8, 2048, 32, 64]", WK,
          (r, k, v, w, rnd(h, n).bfloat16(), rnd(b, h, n, n)),
          rnd(b, t, h, n).bfloat16(), rnd(b, h, n, n),
          b * h * -(-t // WK.CHUNK))
    h, p = 64, 64
    xbc = rnd(b, t, h * p + 2 * n).bfloat16()
    ss = ("ssm_chunk_bwd", "ssd bwd [8, 2048, 64, 64] N 64", SS,
          (xbc[..., :h * p].reshape(b, t, h, p),
           F.softplus(rnd(b, t, h) - 1.0), -torch.exp(0.5 * rnd(h)),
           xbc[..., h * p:h * p + n], xbc[..., h * p + n:], rnd(h),
           rnd(b, h, p, n)),
          rnd(b, t, h, p).bfloat16(), rnd(b, h, p, n),
          b * h * -(-t // SS.CHUNK))
    return wk, ss


def phases_bwd(case, summed: bool) -> dict:
    """Three backward launches at one case (the last one's marks are
    read), then the report; ``summed``: the marks are CHUNK_PHASE sums."""
    name, what, mod, args, dy, ds, blocks = case
    _, _, states = mod._forward(*args, keep=True)
    for _ in range(3):
        mod.launch_bwd(*args[:-1], states, dy, ds)
        torch.cuda.synchronize()
    if summed:
        m = marks(name, blocks, len(PHASES[name]))
        grid = blocks // (mod.head_group(8, 64, 32) if name == "ssm_chunk_bwd"
                          else 1)
        return report(what, PHASES[name], spans(m[:grid]))
    phases = [p for p, _ in BEFORE_MARKS[name][1:]]
    return report(what + " (before)", phases,
                  marks(name, blocks, len(phases)))


BEFORE = r"""
import json, shutil, sys, torch
from pathlib import Path
root, out = sys.argv[1], Path(sys.argv[2])
sys.path[:0] = [root + "/src", {here!r}]
from repro_torch.kernels import _build
import chunk_phases_marks as CP
csrc = out / "csrc"
shutil.rmtree(csrc, ignore_errors=True)
shutil.copytree(_build.CSRC, csrc)
for name, marks in CP.BEFORE_MARKS.items():
    src = (csrc / (name + ".cu")).read_text()
    for k, (_, line) in enumerate(marks):
        if line is None:
            cut = src.rindex("}}", 0, src.index("template <typename T>\nint launch"))
            src = src[:cut] + "  CHUNK_MARK(%d);\n" % k + src[cut:]
        else:
            assert src.count(line) == 1, line
            src = src.replace(line, "  CHUNK_MARK(%d);\n" % k + line)
    (csrc / (name + ".cu")).write_text(src)
_build.CSRC = csrc
_build.use_defines(["-DCHUNK_PROF"], out / "lib")
dev = torch.device("cuda", 0)
for case in CP.bwd_cases(dev):
    print("BEFORE " + json.dumps(CP.phases_bwd(case, summed=False)), flush=True)
"""


def main() -> int:
    before = None
    if len(sys.argv) == 3 and sys.argv[1] == "--before":
        before = str(Path(sys.argv[2]).resolve())
    elif len(sys.argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
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
    out = {"after": [phases_bwd(c, summed=True) for c in bwd_cases(dev)]}
    if before is not None:
        # this module under another name in the child: the parent's
        # package is repro_torch there
        here = _build.BUILD_DIR.parent / "chunk_phases_before"
        here.mkdir(parents=True, exist_ok=True)
        (here / "chunk_phases_marks.py").write_text(
            Path(__file__).read_text())
        got = subprocess.run(
            [sys.executable, "-c", BEFORE.format(here=str(here)), before,
             str(here)], capture_output=True, text=True)
        lines = [x for x in got.stdout.splitlines()
                 if x.startswith("BEFORE ")]
        print(got.stdout[-4000:], got.stderr[-4000:], flush=True)
        if got.returncode != 0 or len(lines) != 2:
            return 1
        out["before"] = [json.loads(x[7:]) for x in lines]
    dest = Path("chiprun_out")
    dest.mkdir(exist_ok=True)
    (dest / "chunk_phases.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
