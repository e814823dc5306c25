"""The K5 / K6 backward kernels on the card, quickly: build every kernel,
print the ptxas registers and spills of the two backward sources, hold
``wkv6_bwd_kernel`` / ``ssd_bwd_kernel`` against ``wkv6_bwd_ref`` /
``ssd_bwd_ref`` (normwise, two launches bit-equal) at small shapes in
bf16 and float32 (K5 also with decays down to 1e-20, K6 on strided
slices), then at rwkv6-1.6b's / zamba2-1.2b's training shapes with the
kernel's time (5 launches between two CUDA events) and one plain call.

    python3 tools/scan_bwd_check.py        # from the repository root
"""
import re
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import _build
    t0 = time.time()
    try:
        logs = _build.build_all()
    except RuntimeError as e:
        print(str(e)[-6000:]); return 1
    print('build s', time.time() - t0)
    for nm in ('rwkv6_chunk_bwd', 'ssm_chunk_bwd'):
        for line in logs.get(nm, "").splitlines():
            if re.search(r'registers|spill|error|warning', line) and 'group_sum' not in line:
                print(nm, line.strip()[:200])
    from repro_torch.kernels.rwkv6_scan import ops as W, ref as WR
    from repro_torch.kernels.ssm_scan import ops as S, ref as SR
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(dev).manual_seed(0)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    def nw(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    def ev(fn, reps=5):
        fn(); torch.cuda.synchronize()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        for _ in range(reps): fn()
        e.record(); torch.cuda.synchronize()
        return s.elapsed_time(e) / reps
    def wkv(b, t, h, n, dt, strong=False, timed=False):
        r, k, v = (rn(b, t, h, n).to(dt) for _ in range(3))
        w = torch.exp(-torch.exp(rn(b, t, h, n) - (0 if strong else 3)))
        if strong: w[:, 3:9] = 1e-20
        u = rn(h, n).to(dt); s0 = rn(b, h, n, n); dy = rn(b, t, h, n).to(dt); ds = rn(b, h, n, n)
        y, s, states = W._forward(r, k, v, w, u, s0, keep=True)
        yr, sr, str_ = WR.wkv6_fwd_ref(r.float(), k.float(), v.float(), w, u.float(), s0)
        fe = (nw(y, yr), nw(s, sr), nw(states, str_))
        got = W.launch_bwd(r, k, v, w, u, states, dy, ds)
        again = W.launch_bwd(r, k, v, w, u, states, dy, ds)
        torch.cuda.synchronize()
        want = WR.wkv6_bwd_ref(r.float(), k.float(), v.float(), w, u.float(), states, dy.float(), ds)
        errs = {nm: nw(a, b_) for nm, a, b_ in zip(('dr','dk','dv','dw','du','ds'), got, want)}
        eq = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        fin = all(bool(torch.isfinite(a).all()) for a in got)
        tm = ''
        if timed:
            tm = f"ms {ev(lambda: W.launch_bwd(r, k, v, w, u, states, dy, ds)):.4f} plain {ev(lambda: WR.wkv6_bwd_ref(r, k, v, w, u, states, dy, ds), 1):.1f}"
        print('wkv6', (b, t, h, n), dt, 'strong' if strong else '', 'fwd', ['%.1e' % x for x in fe], {k_: '%.1e' % e for k_, e in errs.items()}, 'biteq', eq, 'finite', fin, tm, flush=True)
    def ssd(b, t, h, p, n, dt, timed=False):
        xbc = rn(b, t, h * p + 2 * n).to(dt)
        x = xbc[..., :h * p].reshape(b, t, h, p); bm = xbc[..., h * p:h * p + n]; cm = xbc[..., h * p + n:]
        dtt = torch.nn.functional.softplus(rn(b, t, h) - 1); A = -torch.exp(rn(h) * 0.5); D = rn(h)
        s0 = rn(b, h, p, n); dy = rn(b, t, h, p).to(dt); ds = rn(b, h, p, n)
        y, s, states = S._forward(x, dtt, A, bm, cm, D, s0, keep=True)
        yr, sr, str_ = SR.ssd_fwd_ref(x.float(), dtt, A, bm.float(), cm.float(), D, s0)
        fe = (nw(y, yr), nw(s, sr), nw(states, str_))
        got = S.launch_bwd(x, dtt, A, bm, cm, D, states, dy, ds)
        again = S.launch_bwd(x, dtt, A, bm, cm, D, states, dy, ds)
        torch.cuda.synchronize()
        want = SR.ssd_bwd_ref(x.float(), dtt, A, bm.float(), cm.float(), D, states, dy.float(), ds)
        errs = {nm: nw(a, b_) for nm, a, b_ in zip(('dx','ddt','dA','dB','dC','dD','ds'), got, want)}
        eq = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        tm = ''
        if timed:
            tm = f"ms {ev(lambda: S.launch_bwd(x, dtt, A, bm, cm, D, states, dy, ds)):.4f} plain {ev(lambda: SR.ssd_bwd_ref(x, dtt, A, bm, cm, D, states, dy, ds), 1):.1f}"
        print('ssd', (b, t, h, p, n), dt, 'fwd', ['%.1e' % x_ for x_ in fe], {k_: '%.1e' % e for k_, e in errs.items()}, 'biteq', eq, tm, flush=True)
    for a in [(2, 130, 2, 64, torch.bfloat16), (2, 130, 2, 64, torch.float32), (1, 70, 3, 8, torch.float32), (2, 20, 2, 64, torch.bfloat16)]:
        wkv(*a); wkv(*a, strong=True)
    for a in [(2, 130, 3, 64, 64, torch.bfloat16), (2, 130, 3, 64, 64, torch.float32), (1, 70, 3, 8, 5, torch.float32), (2, 10, 2, 64, 64, torch.bfloat16)]:
        ssd(*a)
    wkv(8, 2048, 32, 64, torch.bfloat16, timed=True)
    ssd(8, 2048, 64, 64, 64, torch.bfloat16, timed=True)
    print('peak GiB', torch.cuda.max_memory_allocated() / 2**30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
