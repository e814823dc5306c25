#!/usr/bin/env python3
"""The K5 / K6 chunked-scan backward kernels and the rwkv6-1.6b and
zamba2-1.2b training steps of two checkouts of the port, timed in turns on
one card.

Run from the repository root on a machine with an H100 (sm_90a) and the
CUDA toolkit:

    python3 tools/scan_turns.py BEFORE [AFTER]

BEFORE and AFTER (default: this checkout) are roots of checkouts, e.g. of
the parent commit: ``mkdir -p build/parent && git archive <commit> | tar
-x -C build/parent`` (``.gitignore`` covers ``build/``).  Each turn runs,
in a process of its own (both checkouts' packages are named
``repro_torch``), that checkout's ``chip_smoke.py`` ``scan_bwd_case`` at
the two training shapes of ``SCAN_BWD_CASES`` (rwkv6-1.6b ``[8, 2048, 32,
64]``, zamba2-1.2b ``[8, 2048, 64, 64]`` N 64, bf16: checked against the
plain version, then the kernel and the plain version timed in turns,
device-paced) and then, for each of the two models at its
``TRAIN_FAM_FULL`` batch (8 x 2048, bf16, remat), ``launch.train.build``
and one warm and three timed steps (host clock, synchronised; the median).
The turns go BEFORE, AFTER, AFTER, BEFORE, BEFORE, AFTER, so that a drift
of the card or the host over the run weighs on both alike.  Prints the
card's name and power limit, then one JSON line a turn; exits non-zero
when a turn fails.
"""
import json
import subprocess
import sys
from pathlib import Path

ORDER = (0, 1, 1, 0, 0, 1)     # 0: BEFORE, 1: AFTER
ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
STEPS = 3                      # timed steps, after a warm one

TURN = """
import json, statistics, sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
import chip_smoke as C
from repro_torch.data import synthetic_batch
from repro_torch.launch import train
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
out = {{}}
for spec in C.SCAN_BWD_CASES[:2]:
    case = C.scan_bwd_case(dev, spec)
    out[spec[1] + "_bwd_ms"] = case["ms"]
    out[spec[1] + "_bwd_bound_ms"] = case["bound"][0]
for arch in {archs!r}:
    bsz, seq = C.TRAIN_FAM_FULL[arch]
    cfg, step_fn, p, o, dcfg = train.build(arch, False, bsz, seq, 3e-4, 10,
                                           device=dev)
    secs = []
    for i in range({steps} + 1):
        bt = synthetic_batch(cfg, dcfg, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, o, m = step_fn(p, o, bt)
        float(m["loss"])
        torch.cuda.synchronize()
        if i:
            secs.append(time.perf_counter() - t0)
    out[arch + "_step_ms"] = 1e3 * statistics.median(secs)
    out[arch + "_steps_ms"] = [1e3 * x for x in secs]
    del p, o
    torch.cuda.empty_cache()
print("TURN " + json.dumps(out))
"""


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    roots = [str(Path(a).resolve()) for a in sys.argv[1:]]
    if len(roots) == 1:
        roots.append(str(Path(__file__).resolve().parents[1]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for side in ORDER:
        root = roots[side]
        code = TURN.format(root=root, archs=ARCHS, steps=STEPS)
        got = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True)
        line = [x for x in got.stdout.splitlines() if x.startswith("TURN ")]
        if got.returncode != 0 or not line:
            print(got.stdout[-4000:], got.stderr[-4000:], file=sys.stderr)
            return 1
        turn = dict(json.loads(line[0][5:]),
                    side=("before", "after")[side], root=root)
        print(json.dumps(turn), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
