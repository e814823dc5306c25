#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an H100 (sm_90a) and the
CUDA toolkit:

    python3 chip_smoke.py

Phases; each prints one line and any mismatch or error exits non-zero:

  1. env      the card's name and power limit, torch's device name
  2. build    nvcc of every ``src/repro_torch/csrc/*.cu``, in parallel
  3. kernels  each kernel wrapper against its plain PyTorch version on the
              same full-size arena snapshots, taken mid-search from a run of
              the plain path; integers must be equal, ``value`` within
              VALUE_RTOL; CUDA-event times of kernel and plain version
  4. small    ``search_batch`` through the kernels on the card equals the
              plain versions on the CPU under the same draws
  5. full     the main path at full size (FULL below): pipeline / tree with
              the fused wave and the lockstep select, both vl_modes and
              both level_assigns; invariants, launch counts, playouts/s
  6. profile  device busy share and time by kernel of the fused full-size
              runs (torch.profiler), table in ``chiprun_out/profile.txt``
  7. report   the kernels' JSON line, the card line, the last line

Details go to ``chiprun_out/chip_smoke.json``.  Imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
VALUE_RTOL = 1e-5     # relative, on the float planes.  The kernel adds a
                      # node's contributions in lane order, as the plain
                      # version does on the CPU (0 difference expected
                      # there); PyTorch's scatter-add on the card sums a
                      # node's duplicates first, then adds them, which
                      # differs in the last ulps of a sum of <= lanes terms
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
F32_FLOPS = 67e12            # H100 SXM f32 outside the tensor cores
FULL = dict(batch=128, num_actions=16, game_depth=12, budget=4096, lanes=32,
            max_depth=12, cp=0.7)
SMALL = dict(batch=4, num_actions=4, game_depth=6, budget=64, lanes=8,
             max_depth=6, cp=0.7)
SNAPSHOT_TICKS = 24
TIMING_REPS = 20


def fail(msg: str) -> None:
    print(f"FAIL {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def clone_tree(t):
    from repro_torch.core.arena import TreeArena
    import dataclasses
    return TreeArena(**{f.name: (
        {k: v.clone() for k, v in getattr(t, f.name).items()}
        if f.name == "state" else getattr(t, f.name).clone())
        for f in dataclasses.fields(t)})


def max_diff(a, b) -> float:
    """Largest |a - b| over two tensors (compared on the CPU)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape:
        fail(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0.0
    if a.dtype == torch.bool:
        return float((a != b).any())
    return float((a.double() - b.double()).abs().max())


INT_PLANES = ("visits", "vloss", "unobs", "parent", "action", "children",
              "terminal", "next_free", "free_list", "free_top")


def compare_trees(what, t1, t2) -> float:
    for f in INT_PLANES:
        d = max_diff(getattr(t1, f), getattr(t2, f))
        if d != 0:
            fail(f"{what}: plane {f} differs (max |diff| {d})")
    for k in t1.state:
        if k != "accum" and max_diff(t1.state[k], t2.state[k]) != 0:
            fail(f"{what}: state {k} differs")
    dv = 0.0
    for a, b in ((t1.value, t2.value), (t1.prior, t2.prior),
                 (t1.state["accum"], t2.state["accum"])):
        d = max_diff(a, b)
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        if not bool(((a - b).abs() <= VALUE_RTOL * b.abs().clamp_min(1.0))
                    .all()):
            fail(f"{what}: float planes differ beyond {VALUE_RTOL} relative "
                 f"(max |diff| {d})")
        dv = max(dv, d)
    return dv


def compare_bufs(what, d1, d2, keys) -> None:
    for k in keys:
        if max_diff(d1[k], d2[k]) != 0:
            fail(f"{what}: {k} differs")


SEL_KEYS = ("path", "leaf", "depth", "valid", "dup", "dup_within",
            "dup_cross")
ES_KEYS = ("leaf", "new", "can", "path", "node", "valid")


def cuda_time(fn, reps=TIMING_REPS, setup=None) -> float:
    """Mean ms of ``fn(setup())`` over ``reps`` runs, CUDA events around
    ``fn`` only (``setup`` runs outside the timed span)."""
    total = 0.0
    for _ in range(reps + 2):
        arg = setup() if setup else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        if _ == 1:                         # two warm-up runs
            total = 0.0
    return total / reps


def bound_ms(nbytes: float, flops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def phase_env():
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()
    card = q[0].strip()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    say(f"env card={card} torch_device={name} capability={cap} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    if cap != (9, 0):
        fail(f"the kernels are built for sm_90a, the card is sm_{cap[0]}{cap[1]}")
    return card, name


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all(force=True)
    secs = time.perf_counter() - t0
    regs = []
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                regs.append(f"{name}: {line.strip()}")
    say(f"build {len(logs)} sources in {secs:.2f} s (parallel nvcc)")
    return secs, regs


def make_domain(cfg):
    from repro_torch.core.domains.pgame import PGameDomain
    return PGameDomain(num_actions=cfg["num_actions"],
                       game_depth=cfg["game_depth"], binary_reward=False)


def search_params(cfg, **kw):
    from repro_torch.search import SearchParams
    return SearchParams(cp=cfg["cp"], max_depth=cfg["max_depth"], **kw)


def snapshot(dev, sp, ticks, seed):
    """A full-size batch of arenas mid-search, advanced by the plain path:
    ``(domain, tree, buf_se, buf_ep, buf_pb)``."""
    from repro_torch.core import stages as S
    from repro_torch.core.tree import init_tree
    from repro_torch.kernels.search_wave import ops as W
    dom = make_domain(FULL)
    bsz, lanes = FULL["batch"], FULL["lanes"]
    n = FULL["budget"] + 2
    tree = init_tree(dom, n, batch=bsz, device=dev)
    se = S.empty_selection(sp, bsz, lanes, dev)
    ep = S.empty_expansion(sp, bsz, lanes, dom, dev)
    pb = S.empty_playout(sp, bsz, lanes, dom.num_actions, dev)
    gen = torch.Generator().manual_seed(seed)
    draws = dom.sample_draws((bsz, ticks, lanes), gen).to(dev)
    for t in range(ticks):
        tree, se, ep, pb = W.pipeline_tick(tree, dom, sp, lanes, True, se, ep,
                                           pb, draws[:, t], impl="ref")
    torch.cuda.synchronize()
    return dom, tree, se, ep, pb


def wave_bytes(tree, paths, a, extra_rows=0) -> float:
    """Bytes a wave must move: each distinct row on the paths read once
    (children + child N/W/in-flight = 16 B per slot, plus its own stats),
    plus ``extra_rows`` rows written."""
    rows = 0
    for b in range(paths.shape[0]):
        p = paths[b]
        rows += int(torch.unique(p[p >= 0]).numel())
    return rows * (a * 16 + 12) + extra_rows


def phase_kernels(dev):
    from repro_torch.kernels.search_wave import ops as W
    from repro_torch.kernels.uct_select import ops as U
    results = {}
    lanes, a = FULL["lanes"], FULL["num_actions"]
    reset_launches()
    for mode, assign in (("loss", "independent"), ("wu", "running")):
        sp = search_params(FULL, vl_mode=mode, level_assign=assign,
                           kernels="cuda")
        dom, tree, se, ep, pb = snapshot(dev, sp, SNAPSHOT_TICKS, 7)
        tag = f"{mode}/{assign}"
        # K1a se
        t1, sel1, es1 = W.se(clone_tree(tree), sp, lanes, True, impl="cuda")
        t2, sel2, es2 = W.se(clone_tree(tree), sp, lanes, True, impl="ref")
        torch.cuda.synchronize()
        err_se = compare_trees(f"se {tag}", t1, t2)
        compare_bufs(f"se {tag} sel", sel1, sel2, SEL_KEYS)
        compare_bufs(f"se {tag} es", es1, es2, ES_KEYS)
        # K1b bes
        t1, nse1, es1 = W.bes(clone_tree(tree), sp, lanes, True, se, pb,
                              impl="cuda")
        t2, nse2, es2 = W.bes(clone_tree(tree), sp, lanes, True, se, pb,
                              impl="ref")
        torch.cuda.synchronize()
        err_bes = compare_trees(f"bes {tag}", t1, t2)
        compare_bufs(f"bes {tag} sel", nse1, nse2, SEL_KEYS)
        compare_bufs(f"bes {tag} es", es1, es2, ES_KEYS)
        # K1c b
        t1 = W.b(clone_tree(tree), sp, pb, impl="cuda")
        t2 = W.b(clone_tree(tree), sp, pb, impl="ref")
        torch.cuda.synchronize()
        err_b = compare_trees(f"b {tag}", t1, t2)
        # K2a / K2b on the boards the lockstep select builds: level 1 of
        # every lane of the last wave (ragged rows, duplicated parents)
        infl = tree.unobs if sp.wu else tree.vloss
        bi = torch.arange(tree.batch, device=dev)[:, None]
        node = se["path"][:, :, 1].clamp_min(0)
        ch = tree.children[bi, node]
        idx = ch.clamp_min(0)
        bia = bi[:, :, None]
        n_, w_, v_ = (tree.visits[bia, idx], tree.value[bia, idx],
                      infl[bia, idx])
        pn = tree.visits[bi, node] + infl[bi, node]
        valid = ch >= 0
        kw = dict(cp=sp.cp, vl_weight=sp.vl_weight, valid=valid, child_o=v_,
                  vl_mode=mode)
        k_t = U.uct_argmax(n_, w_, v_, pn, impl="cuda", **kw)
        r_t = U.uct_argmax(n_, w_, v_, pn, impl="ref", **kw)
        k_r = U.uct_argmax_running(n_, w_, v_, pn, node, impl="cuda", **kw)
        r_r = U.uct_argmax_running(n_, w_, v_, pn, node, impl="ref", **kw)
        torch.cuda.synchronize()
        err_t, err_r = max_diff(k_t, r_t), max_diff(k_r, r_r)
        if err_t or err_r:
            fail(f"uct_select {tag}: kernel picks differ from the plain "
                 f"version (tiles {err_t}, running {err_r})")
        # timings at these shapes (fresh clones outside the timed span)
        se_leaf = se["leaf"].to(torch.int32).contiguous()
        se_valid = se["valid"].contiguous()
        pbk = W.pack_pb(tree, sp, pb)
        fresh = lambda: clone_tree(tree)
        t_se = cuda_time(lambda t: W.launch_se(t, sp, lanes, True),
                         setup=fresh)
        p_se = cuda_time(lambda t: W.se(t, sp, lanes, True, impl="ref"),
                         setup=fresh)
        t_bes = cuda_time(lambda t: W.launch_bes(t, sp, lanes, True,
                                                 se_leaf, se_valid, pbk),
                          setup=fresh)
        p_bes = cuda_time(lambda t: W.bes(t, sp, lanes, True, se, pb,
                                          impl="ref"), setup=fresh)
        t_b = cuda_time(lambda t: W.launch_b(t, sp, pbk), setup=fresh)
        p_b = cuda_time(lambda t: W.b(t, sp, pb, impl="ref"), setup=fresh)
        rows = node.numel()
        flat = [x.reshape(rows, a).float().contiguous() for x in (n_, w_, v_)]
        pnf = pn.reshape(rows).float().contiguous()
        vf = valid.reshape(rows, a).contiguous()
        out = torch.empty(rows, dtype=torch.int32, device=dev)
        wu = mode == "wu"
        t_t = cuda_time(lambda _: U.launch_tiles(
            flat[0], flat[1], flat[2], flat[2], pnf, vf, out, cp=sp.cp,
            vl_weight=sp.vl_weight, wu=wu))
        p_t = cuda_time(lambda _: U.uct_argmax(n_, w_, v_, pn, impl="ref",
                                               **kw))
        board = (tree.batch, lanes, a)
        out2 = torch.empty(tree.batch, lanes, dtype=torch.int32, device=dev)
        pid = node.to(torch.int32).contiguous()
        t_r = cuda_time(lambda _: U.launch_running(
            flat[0].view(board), flat[1].view(board), flat[2].view(board),
            flat[2].view(board), pnf.view(tree.batch, lanes),
            vf.view(board), pid, out2, cp=sp.cp, vl_weight=sp.vl_weight,
            wu=wu))
        p_r = cuda_time(lambda _: U.uct_argmax_running(
            n_, w_, v_, pn, node, impl="ref", **kw))
        # bounds from this snapshot's data
        sel_paths = sel1["path"]
        b_sel = wave_bytes(tree, sel_paths, a) + sel_paths.numel() * 4 * 2
        f_sel = float((sel1["depth"].sum() * a * 15).item())
        pb_paths = torch.where(pb["valid"][..., None], pb["path"], -1)
        b_pb = wave_bytes(tree, pb_paths, a,
                          extra_rows=int(pb["is_new"].sum()) * a * 4)
        board_bytes = rows * a * 13 + rows * 8
        board_flops = rows * a * 15
        results[tag] = {
            "se": (err_se, t_se, p_se, bound_ms(b_sel, f_sel)),
            "bes": (err_bes, t_bes, p_bes, bound_ms(b_sel + b_pb, f_sel)),
            "b": (err_b, t_b, p_b, bound_ms(b_pb, 0.0)),
            "uct_argmax_tiles": (float(err_t), t_t, p_t,
                                 bound_ms(board_bytes, board_flops)),
            "uct_argmax_running": (float(err_r), t_r, p_r,
                                   bound_ms(board_bytes + rows * 4,
                                            board_flops)),
        }
        del dom, tree, se, ep, pb
    worst = {k: max(results[t][k][0] for t in results)
             for k in results["loss/independent"]}
    counts = all_launches()
    say("kernels " + " ".join(f"{k}:max_abs_err={v},launches={counts[k]}"
                              for k, v in worst.items())
        + " (vs plain at full size; launches of this phase)")
    return results


def run_batch(dev, cfg, method, wave_select, vl_mode, level_assign, draws,
              puct=False):
    from repro_torch.search import SearchConfig, search_batch
    dom = make_domain(cfg)
    sc = SearchConfig(method=method, budget=cfg["budget"], lanes=cfg["lanes"],
                      params=search_params(cfg, wave_select=wave_select,
                                           vl_mode=vl_mode,
                                           level_assign=level_assign,
                                           puct=puct))
    return search_batch([dom] * cfg["batch"], sc, draws, device=dev)


def draws_for(cfg, method, seed):
    from repro_torch.search import SearchConfig, draws_shape
    dom = make_domain(cfg)
    sc = SearchConfig(method=method, budget=cfg["budget"], lanes=cfg["lanes"])
    shape = (cfg["batch"],) + draws_shape(dom, sc)
    gen = torch.Generator().manual_seed(seed)
    return dom.sample_draws(shape[:-1], gen)


SMALL_RUNS = ([(m, ws, vl, la, False) for m in ("pipeline", "tree")
               for ws in ("mega", "lockstep") for vl in ("loss", "wu")
               for la in ("independent", "running")]
              + [("pipeline", "mega", "wu", "running", True),
                 ("tree", "mega", "loss", "independent", True)]
              + [(m, "scan", vl, "independent", False)
                 for m, vl in (("tree", "loss"), ("pipeline", "wu"),
                               ("sequential", "loss"), ("root", "wu"),
                               ("leaf", "loss"))])


def phase_small(dev):
    worst, per_run = 0.0, {}
    for i, (m, ws, vl, la, puct) in enumerate(SMALL_RUNS):
        draws = draws_for(SMALL, m, 100 + i)
        rg = run_batch(dev, SMALL, m, ws, vl, la, draws, puct)
        rc = run_batch("cpu", SMALL, m, ws, vl, la, draws, puct)
        what = f"small {m}/{ws}/{vl}/{la}" + ("/puct" if puct else "")
        for f in ("action_visits", "best_action"):
            if max_diff(getattr(rg, f), getattr(rc, f)) != 0:
                fail(f"{what}: {f} differs card vs CPU")
        for k in rg.stats:
            if max_diff(rg.stats[k], rc.stats[k]) != 0:
                fail(f"{what}: stats {k} differs card vs CPU")
        for k in rg.extras:
            if k != "values" and max_diff(rg.extras[k], rc.extras[k]) != 0:
                fail(f"{what}: extras {k} differs card vs CPU")
        d = max_diff(rg.action_value, rc.action_value)
        if rg.tree is not None:
            d = max(d, compare_trees(what, rg.tree, rc.tree))
        per_run[what] = d
        worst = max(worst, d)
    say(f"small {len(SMALL_RUNS)} configs card == CPU "
        f"(B={SMALL['batch']} A={SMALL['num_actions']} "
        f"depth={SMALL['game_depth']} budget={SMALL['budget']} "
        f"lanes={SMALL['lanes']}; max float diff {worst})")
    return per_run


FULL_RUNS = [("pipeline", "mega", "loss", "independent"),
             ("pipeline", "mega", "wu", "running"),
             ("tree", "mega", "loss", "independent"),
             ("pipeline", "lockstep", "loss", "independent"),
             ("pipeline", "lockstep", "wu", "running")]
# the kernels each full-size run must launch
RUN_KERNELS = {("pipeline", "mega"): ("bes",), ("tree", "mega"): ("se", "b"),
               ("pipeline", "lockstep", "independent"): ("uct_argmax_tiles",),
               ("pipeline", "lockstep", "running"): ("uct_argmax_running",)}


def all_launches():
    from repro_torch.kernels.search_wave import ops as W
    from repro_torch.kernels.uct_select import ops as U
    return {**W.launches, **U.launches}


def reset_launches():
    from repro_torch.kernels.search_wave import ops as W
    from repro_torch.kernels.uct_select import ops as U
    for d in (W.launches, U.launches):
        for k in d:
            d[k] = 0


def phase_full(dev):
    from repro_torch.core.tree import check_consistency
    draws = {m: draws_for(FULL, m, 1000 + i)
             for i, m in enumerate(("pipeline", "tree"))}
    runs = []
    torch.cuda.synchronize()
    reset_launches()                       # the main path starts here
    for m, ws, vl, la in FULL_RUNS:
        before = all_launches()
        d = draws[m].to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_batch(dev, FULL, m, ws, vl, la, d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = all_launches()
        what = f"full {m}/{ws}/{vl}/{la}"
        tree = res.tree
        if not bool((tree.visits[:, 0] == FULL["budget"]).all()):
            fail(f"{what}: root visits != {FULL['budget']}")
        if not bool((res.stats["playouts_completed"]
                     == FULL["budget"]).all()):
            fail(f"{what}: playouts_completed != {FULL['budget']}")
        cons = check_consistency(tree)
        for k in ("vloss_drained", "unobs_drained", "parents_valid",
                  "visit_flow"):
            if not bool(cons[k].all()):
                fail(f"{what}: invariant {k} broken")
        launched = {k: after[k] - before[k] for k in after}
        need = RUN_KERNELS.get((m, ws)) or RUN_KERNELS[(m, ws, la)]
        for k in need:
            if launched[k] == 0:
                fail(f"{what}: kernel {k} was not launched")
        rate = FULL["batch"] * FULL["budget"] / secs
        runs.append({"run": what, "seconds": secs, "playouts_per_s": rate,
                     "launches": launched,
                     "nodes_mean": float(cons["nodes"].float().mean()),
                     "dup_mean": float(res.stats["duplicates"]
                                       .float().mean())})
    counts = all_launches()                # read just after the main path
    for k, v in counts.items():
        if v == 0:
            fail(f"kernel {k} was not launched on the main path")
    say("full " + "; ".join(f"{r['run'][5:]} {r['playouts_per_s']:.0f} "
                            f"playouts/s" for r in runs)
        + f" (B={FULL['batch']} x {FULL['budget']} playouts, "
        f"A={FULL['num_actions']} depth={FULL['game_depth']} "
        f"lanes={FULL['lanes']})")
    return runs, counts


def phase_profile(dev):
    """Where the time goes on the fused full-size runs: one traced run of
    each, device time by kernel (torch.profiler over CUPTI) against the
    untraced wall time; the table goes to ``chiprun_out/profile.txt``.  The
    lockstep runs are left out: tracing their ~10^5 small launches takes
    minutes."""
    from torch.profiler import ProfilerActivity, profile
    lines, shares = [], {}
    for m, ws, vl, la in FULL_RUNS:
        if ws != "mega":
            continue
        d = draws_for(FULL, m, 1000).to(dev)
        run_batch(dev, FULL, m, ws, vl, la, d)           # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_batch(dev, FULL, m, ws, vl, la, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_batch(dev, FULL, m, ws, vl, la, d)
            torch.cuda.synchronize()
        dev_us = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                dev_us[e.key] = (us, e.count)
        busy = sum(us for us, _ in dev_us.values()) / 1e6
        top = sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:8]
        what = f"{m}/{ws}/{vl}/{la}"
        if not top:
            say(f"profile {what}: device time not measured (no CUDA events)")
            continue
        shares[what] = {"wall_s": wall, "busy_s": busy,
                        "top": [(k, us, c) for k, (us, c) in top]}
        lines.append(f"{what}: wall {wall:.4f} s untraced, device busy "
                     f"{busy:.4f} s ({100 * busy / wall:.1f}% of wall), "
                     f"{sum(c for _, c in dev_us.values())} device ops")
        for k, (us, c) in top:
            lines.append(f"    {us / 1e3:10.3f} ms  {c:7d}x  {k[:90]}")
        say(f"profile {what} wall={wall:.3f}s busy={busy:.3f}s "
            f"idle={100 * (1 - busy / wall):.1f}% top={top[0][0][:40]}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile.txt").write_text("\n".join(lines) + "\n")
    return shares


SOURCES = {
    "se": ("src/repro_torch/csrc/search_wave.cu",
           "src/repro/kernels/search_wave/kernel.py:403"),
    "bes": ("src/repro_torch/csrc/search_wave.cu",
            "src/repro/kernels/search_wave/kernel.py:415"),
    "b": ("src/repro_torch/csrc/search_wave.cu",
          "src/repro/kernels/search_wave/kernel.py:427"),
    "uct_argmax_tiles": ("src/repro_torch/csrc/uct_select.cu",
                         "src/repro/kernels/uct_select/kernel.py:51"),
    "uct_argmax_running": ("src/repro_torch/csrc/uct_select.cu",
                           "src/repro/kernels/uct_select/kernel.py:133"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card, name = phase_env()
    build_s, ptxas = phase_build()
    kern = phase_kernels(dev)
    small = phase_small(dev)
    runs, counts = phase_full(dev)
    prof = phase_profile(dev)
    kernels = []
    for k, (src, repl) in SOURCES.items():
        err, ms, pms, (bms, by) = kern["loss/independent"][k]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": repl, "launches": counts[k],
                        "max_abs_err": max(kern[t][k][0] for t in kern),
                        "ms": ms, "plain_ms": pms, "bound_ms": bms,
                        "bound_by": by, "library_ms": None})
    detail = {"card": card, "device": name, "build_s": build_s,
              "ptxas": ptxas, "kernels": kern, "small_float_diff": small,
              "full_runs": runs, "launch_counts": counts, "profile": prof,
              "seconds": time.perf_counter() - t_start,
              "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
