#!/usr/bin/env python3
"""The flash backward (kernel B) and the smollm-135m training step of two
checkouts of the port, timed in turns on one card.

Run from the repository root on a machine with an H100 (sm_90a) and the
CUDA toolkit:

    python3 tools/train_turns.py BEFORE [AFTER]

BEFORE and AFTER (default: this checkout) are roots of checkouts, e.g. of
the parent commit: ``mkdir -p build/parent && git archive <commit> | tar
-x -C build/parent`` (``.gitignore`` covers ``build/``).  Each turn runs,
in a process of its own (both checkouts' packages are named
``repro_torch``), that checkout's ``chip_smoke.py`` ``train_kernel_case``
at smollm-135m's training shape (kernel B and SDPA's backward timed in
turns) and ``phase_train_full`` (smollm-135m at 8 x 2048 in bf16: the
checks of step 0 and of the restart, the timed steps, one traced step:
its wall and device-busy seconds).
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

TURN = """
import json, sys
sys.path[:0] = [{root!r}, {root!r} + "/src"]
import torch
import chip_smoke as C
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
case = C.train_kernel_case(dev, C.TRAIN_KERNEL_SHAPES[0])
C.reset_launches()
full = C.phase_train_full(dev, {{}})
print("TURN " + json.dumps({{
    "kernel_b_ms": case["b"]["ms"], "sdpa_bwd_ms": case["b"]["sdpa_ms"],
    "step_ms": full["step_ms"], "median_step_ms": full["median_step_ms"],
    "tokens_per_s": full["tokens_per_s"],
    "traced_step": full["profile"] and {{
        k: full["profile"][k] for k in ("wall_s", "busy_s")}}}}))
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
        got = subprocess.run([sys.executable, "-c", TURN.format(root=root)],
                             cwd=root, capture_output=True, text=True)
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
