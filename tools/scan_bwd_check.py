"""The K5 / K6 backward kernels on the card, quickly: build every kernel,
print the ptxas registers and spills of the two backward sources and each
backward kernel's shared memory bytes and resident blocks an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, in both dtypes), hold
``wkv6_bwd_kernel`` / ``ssd_bwd_kernel`` against ``wkv6_bwd_ref`` /
``ssd_bwd_ref`` (normwise, two launches bit-equal) at small shapes in
bf16 and float32 (K5 also with decays down to 1e-20, K6 on strided
slices and with 1, 2 and 4 heads a block), then at rwkv6-1.6b's /
zamba2-1.2b's training shapes with the kernel's time (5 launches between
two CUDA events) and one plain call.

    python3 tools/scan_bwd_check.py        # from the repository root

``--leaf`` runs instead, for rwkv6-1.6b and zamba2-1.2b, ``chip_smoke.py``'s
step-0 check of ``train-full-*`` (the first TRAIN_FAM_LAYERS layers at full
width, TRAIN_FAM_FULL batch, bf16) three ways: the kernels; the kernels
with the scan backward replaced by its plain version run in float32 on the
same operands and cast to the kernel's output types (a float32-exact
backward); and the plain versions everywhere (the check's reference), with
a float32 run of them.  It prints each arch's leaves of largest excess
(the check's measure) for the first two, so that a move of the check can
be laid at the backward kernel's arithmetic or at the model's own bf16
rounding.
"""
import re
import sys
import time
from pathlib import Path

import torch


def leaf_variants(arch: str) -> None:
    import dataclasses
    import functools
    import chip_smoke as C
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.base import get_family
    dev = torch.device("cuda", 0)
    bsz, seq = C.TRAIN_FAM_FULL[arch]
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=C.TRAIN_FAM_LAYERS[arch])
    fam = get_family(cfg)
    params = fam.init(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in synthetic_batch(
        cfg, DataConfig(seed=0, batch_size=bsz, seq_len=seq), 0).items()}

    def grads(c=cfg, p=params):
        return value_and_grad(lambda q: fam.loss_fn(c, q, batch), p)[1]

    mod = WK if cfg.family == "rwkv6" else SS
    plain = mod.R.wkv6_bwd_ref if mod is WK else mod.R.ssd_bwd_ref

    def f32_bwd(*args, group=None):
        """the plain backward in float32, cast as the kernel's results"""
        out = list(plain(*(z.float() for z in args[:-3]), *args[-3:-2],
                         args[-2].float(), args[-1]))
        if mod is WK:
            out[:3] = [z.to(args[0].dtype) for z in out[:3]]
            out[4] = out[4].to(args[4].dtype)
        else:
            out[0] = out[0].to(args[0].dtype)
            out[3] = out[3].to(args[3].dtype)
            out[4] = out[4].to(args[4].dtype)
        return tuple(out)

    g_k = grads()
    with C.patched_attrs([(mod, "launch_bwd", f32_bwd)]):
        g_x = grads()
    ref = lambda f: functools.partial(f, impl="ref")  # noqa: E731
    with C.patched_attrs([
            (FA, "flash_attention_lse", ref(FA.flash_attention_lse)),
            (FA, "flash_attention_bwd", ref(FA.flash_attention_bwd)),
            (WK, "wkv6", ref(WK.wkv6)), (SS, "ssd", ref(SS.ssd))]):
        g_p = grads()
        g_32 = grads(dataclasses.replace(cfg, dtype="float32"),
                     tree_map(lambda z: z.float(), params))
    lerr = lambda a, b: C.leaf_errors(a, b, C.STACKED,  # noqa: E731
                                      C.SHIFT_INVARIANT)
    e_kp, e_xp, e_p32 = lerr(g_k, g_p), lerr(g_x, g_p), lerr(g_p, g_32)
    e_k32, e_x32, e_kx = lerr(g_k, g_32), lerr(g_x, g_32), lerr(g_k, g_x)
    # chip_smoke's measure: a leaf's excess is the smaller of its error
    # against the plain versions over TRAIN_FULL_TOL["leaf"] and its error
    # against float32 over FAM_F32_RATIO times the plain versions'
    ex = {what: {k: min(e1[k] / C.TRAIN_FULL_TOL["leaf"],
                        e2[k] / (C.FAM_F32_RATIO * max(e_p32[k], 1e-30)))
                 for k in e1}
          for what, e1, e2 in (("kernels", e_kp, e_k32),
                               ("f32 backward", e_xp, e_x32))}
    for what in ex:
        for leaf in sorted(ex[what], key=ex[what].get, reverse=True)[:3]:
            print(f"leaf {arch} {what}: {leaf} excess kernels "
                  f"{ex['kernels'][leaf]:.3f}, f32 backward "
                  f"{ex['f32 backward'][leaf]:.3f}; vs plain: kernels "
                  f"{e_kp[leaf]:.3e}, f32 backward {e_xp[leaf]:.3e}; vs "
                  f"float32: kernels {e_k32[leaf]:.3e}, f32 backward "
                  f"{e_x32[leaf]:.3e}, plain {e_p32[leaf]:.3e}; kernels vs "
                  f"f32 backward {e_kx[leaf]:.3e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    if sys.argv[1:] == ["--leaf"]:
        sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for arch in ("zamba2-1.2b", "rwkv6-1.6b"):
            leaf_variants(arch)
            torch.cuda.empty_cache()
        return 0
    from repro_torch.kernels import _build
    t0 = time.time()
    try:
        logs = _build.build_all()
    except RuntimeError as e:
        print(str(e)[-6000:]); return 1
    print('build s', time.time() - t0)
    for nm in ('rwkv6_chunk_bwd', 'ssm_chunk_bwd'):
        for line in logs.get(nm, "").splitlines():
            if re.search(r'registers|spill|error|warning|entry function', line):
                print(nm, line.strip()[:200])
    from repro_torch.kernels.rwkv6_scan import ops as W, ref as WR
    from repro_torch.kernels.ssm_scan import ops as S, ref as SR
    for nm, mod in (('wkv6_bwd_kernel', W), ('ssd_bwd_kernel', S)):
        for dt in (torch.bfloat16, torch.float32):
            blocks, smem = mod.bwd_occupancy(dt)
            print(nm, dt, 'smem bytes', smem, 'blocks/SM', blocks, flush=True)
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
    def ssd(b, t, h, p, n, dt, timed=False, group=None):
        xbc = rn(b, t, h * p + 2 * n).to(dt)
        x = xbc[..., :h * p].reshape(b, t, h, p); bm = xbc[..., h * p:h * p + n]; cm = xbc[..., h * p + n:]
        dtt = torch.nn.functional.softplus(rn(b, t, h) - 1); A = -torch.exp(rn(h) * 0.5); D = rn(h)
        s0 = rn(b, h, p, n); dy = rn(b, t, h, p).to(dt); ds = rn(b, h, p, n)
        y, s, states = S._forward(x, dtt, A, bm, cm, D, s0, keep=True)
        yr, sr, str_ = SR.ssd_fwd_ref(x.float(), dtt, A, bm.float(), cm.float(), D, s0)
        fe = (nw(y, yr), nw(s, sr), nw(states, str_))
        got = S.launch_bwd(x, dtt, A, bm, cm, D, states, dy, ds, group=group)
        again = S.launch_bwd(x, dtt, A, bm, cm, D, states, dy, ds, group=group)
        torch.cuda.synchronize()
        want = SR.ssd_bwd_ref(x.float(), dtt, A, bm.float(), cm.float(), D, states, dy.float(), ds)
        errs = {nm: nw(a, b_) for nm, a, b_ in zip(('dx','ddt','dA','dB','dC','dD','ds'), got, want)}
        eq = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        tm = ''
        if timed:
            tm = f"ms {ev(lambda: S.launch_bwd(x, dtt, A, bm, cm, D, states, dy, ds)):.4f} plain {ev(lambda: SR.ssd_bwd_ref(x, dtt, A, bm, cm, D, states, dy, ds), 1):.1f}"
        print('ssd', (b, t, h, p, n), dt, 'group', group, 'fwd', ['%.1e' % x_ for x_ in fe], {k_: '%.1e' % e for k_, e in errs.items()}, 'biteq', eq, tm, flush=True)
    for a in [(2, 130, 2, 64, torch.bfloat16), (2, 130, 2, 64, torch.float32), (1, 70, 3, 8, torch.float32), (2, 20, 2, 64, torch.bfloat16)]:
        wkv(*a); wkv(*a, strong=True)
    for a in [(2, 130, 3, 64, 64, torch.bfloat16), (2, 130, 3, 64, 64, torch.float32), (1, 70, 3, 8, 5, torch.float32), (2, 10, 2, 64, 64, torch.bfloat16)]:
        ssd(*a)
    for grp in (2, 4):
        ssd(2, 130, 4, 64, 64, torch.bfloat16, group=grp)
        ssd(1, 70, 4, 8, 5, torch.float32, group=grp)
    wkv(8, 2048, 32, 64, torch.bfloat16, timed=True)
    ssd(8, 2048, 64, 64, 64, torch.bfloat16, timed=True)
    print('peak GiB', torch.cuda.max_memory_allocated() / 2**30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
