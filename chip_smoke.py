#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with an H100 (sm_90a) and the
CUDA toolkit:

    python3 chip_smoke.py [--before DIR]

Phases; each prints one line and any mismatch or error exits non-zero:

  1. env      the card's name and power limit, torch's device name
  2. build    nvcc of every ``src/repro_torch/csrc/*.cu``, in parallel
              (with ``--before DIR``, a checkout of an earlier commit,
              also its K4, K3 and K2a sources by its own ``_build``; its
              wrappers are timed beside the port's); SASS checks: HGMMA
              and UTMALDG in the bf16 K4 and the bf16 flash backward
              (kernel B), 16-byte LDGSTS and no HMMA in the float32 K4,
              no HMMA in the float32 kernel B, 16-byte LDGSTS in K3, HMMA
              (tensor-core mma.sync) in the chunked scans, REDUX in K2a;
              a ``ptxas`` line with the registers and spills of every
              instantiation of kernel B
  3. kernels  K2a against its plain version on synthetic boards (A 1-130,
              finished rows, sentinel ties, int32 and float32 counts); the
              search kernels (K1, K2) against their plain PyTorch
              versions on the same full-size arena snapshots, taken
              mid-search from a run of the plain path (loss/independent
              and wu/running); integers must be equal, ``value`` within
              VALUE_RTOL; K2b on the level-1 board and on a level-0 one
              (every lane at the root); kernel, plain and wrapper host
              times in ROUNDS rounds (K2a through its wrapper on the
              arena's int32 planes, and on the float32 board)
  4. attn     the attention kernels (K4 bf16 on the tensor cores and
              float32, K3 flash-decode) against their plain versions at the
              LM path's full-size shapes in bf16 and small shapes in
              float32 (the float32 K4 also at D 16 / 20, ragged Sq,
              ``seq_k_valid`` < Sk, rows with no key); times beside
              PyTorch's SDPA.  Line ``attn-mla``: K4 at deepseek-v2-lite's
              MLA prefill shape (q/k head dim 192, v 128; the bf16 row
              ``flash_attention_bf16_mla``) at S 65 / 130 / 384, each
              within ``rounded_p_limit`` with a planted fault above it,
              and in float32 at the smoke shape (24 / 16); timed at S 384
              beside SDPA
  5. rec-kernels  the recurrent kernels (K5 WKV6, K6 SSD) against their
              sequential plain versions at rwkv6-1.6b / zamba2-1.2b widths
              in bf16 at the engine's prefill, decode and mcts-forward
              shapes (bf16 sequences take the chunked tensor-core kernels,
              single steps the sequential ones, timed beside them as
              ``before_ms``), at ragged T (65, 130), K5 with decays down to
              0, a state carried across two calls split mid-chunk (with a
              planted fault), both routes at short T, and in float32 at
              the smoke shapes; K3 / K4 at zamba2's attention shapes (32
              heads of 128)
  6. small    P-game ``search_batch``, LM ``mcts_decode_batch`` and the
              serving engine (rwkv6 / zamba2 smoke configs, greedy and
              mcts), float32, through the kernels on the card equal the
              plain versions on the CPU; the cross-token carries
              (``kv_splice``, ``tree_reuse``, both) on smollm-smoke's
              searcher and ``mcts_decode_batch`` (tokens and carried
              integer planes) and the mcts engine with both carries on
              smollm / rwkv6 / zamba2 smoke, card == CPU (line
              ``carry-small``); the float32 K4's main path:
              its launches tallied by path, shape and knobs, each shape
              held to the plain version, each path's busiest timed;
              ``families-small``: the MoE (deepseek-v2-lite, grok-1),
              VLM (internvl2) and Whisper smoke configs, card == CPU
              (prefill + 3 decode_steps, logits_fn / multimodal_logits,
              the greedy engine, the MoE's mcts_decode_batch through the
              generic fallback), each card call's K4 / K3 launches held
              to what its path implies
  7. full     the P-game main path at full size (FULL below; the
              lockstep runs at a quarter budget, LOCKSTEP): pipeline /
              tree with the fused wave and the lockstep select, both
              vl_modes and both level_assigns; the LM main path (LM_FULL:
              smollm-135m, 16 ragged prompts, 8 tokens each); the serving
              engine at full width on rwkv6-1.6b and zamba2-1.2b, greedy
              (REC_GREEDY) and mcts (REC_MCTS); invariants, launch counts
              against those each path implies, playouts/s, tokens/s; K1b
              against its plain version at the LM path's shapes; the LM
              path with the carries (``ServingEngine(decode="mcts")``,
              ``kv_splice`` and ``kv_splice`` + ``tree_reuse``): launch
              counts per admission and per token, the first token
              against the cold run's, the carried logits after each
              commit against a prefill of the longer prefix (a commit
              planted one position off must fail that), the arena
              invariants per token, K1b on the rerooted arena after
              token 1; tokens/s, TTFT, the batched reroot's and the
              commit step's times (lines ``lm-carry``,
              ``lm-carry-reroot``)
  7b. shard  after ``full`` and before any tracing, each its own line:
              ``shard``: the P-game runs (SHARDED: FULL at a quarter
              budget) pipeline/mega loss/independent
              and tree/mega wu/running through ``search_batch(mesh=)`` over
              an in-process mesh of SHARD_ENTRIES entries on ``cuda:0``
              (and over every card when there are two or more), at B = 128
              and 126 (padding), every root held to the single-device run
              (integers exact, ``value`` bit-equal or within VALUE_RTOL:
              the line says which), playouts/s of both; ``shard-mp``: two
              processes started with ``spawn`` on ``cuda:0`` under gloo
              (NCCL refuses two ranks on one card), or one rank per card
              under NCCL, ``shard_search_batch`` at SHARDED under
              ``make_search_mesh()``, each rank's gathered result written
              through ``repro_torch.checkpoint`` and held here against
              this process's run; ``ft``: ``ft_search_batch`` at SHARDED
              (4 hosts, chunks of 16) without failure, with a killed and a
              stalled host, and stopped after one round then resumed from
              the checkpoint store by a fresh driver, each merged result
              held per root to ``search_batch`` and each report to what
              the injection implies; ``lm-shard``: smollm-135m's 16 slots
              through ``make_batched_searcher`` over 3 entries on
              ``cuda:0`` (padded to 18, two dead), stateless and with
              ``kv_splice`` + ``tree_reuse``, 2 tokens each, equal to the
              unsharded searcher at batch 18 with two zero rows.  Their
              launches join the kernels line's totals
  7c. families  after the engines, each its own line: ``moe-full``:
              deepseek-v2-lite-16b at its published width (random bf16
              weights drawn on the card), the greedy engine (MOE_GREEDY)
              and ``mcts_decode_batch`` (MOE_MCTS), launches held (27 MLA
              K4 a prefill), the admissions' K4 launches and those of the
              search's first forward at each [rows, S] (B > 1) held to
              ``rounded_p_limit`` on their own operands, prefill-then-step
              at moe_capacity 100 within FAM_STEP_TOL (zeroed latents and
              a step one position late or early above it; the routing of
              both paths compared layer by layer), tokens/s, TTFT, peak
              memory; ``vlm-full``:
              internvl2-2b's ``multimodal_logits`` (4 x (256 patches + 128
              tokens)) and greedy engine, K4 / K3 held to their plain
              versions on their own operands; ``whisper-full``:
              whisper-base prefill on 4 x 1500 frames + 32 decode_steps,
              K4 (encoder, decoder, cross) and K3 held likewise,
              prefill-then-step within FAM_STEP_TOL (planted faults as
              for the MoE above it).  grok-1-314b runs at
              its smoke config only (~628 GB of bf16 weights)
  7d. train  after the families, each its own line: ``train-kernels``:
              the flash forward writing its logsumexp (kernel A,
              ``flash_attention_lse``: output equal to the serving K4's,
              lse within LSE_TOL of the plain ``blocked_fwd_ref``) and
              the flash backward (kernel B, ``flash_attention_bwd``:
              dq / dk / dv within TRAIN_GRAD_TOL normwise of the plain
              ``blocked_bwd_ref``) at smollm-135m's and stablelm-3b's
              training shapes in bf16, the bf16 tails and knobs (Sq, Sk
              not multiples of 64, q_offset, seq_k_valid, soft caps,
              non-causal, D = 128), deepseek-v2-lite's MLA (192, 128) at
              4 x 4096 and with tails (B's two-warpgroup kernels,
              row ``flash_attention_bwd_mla``, SDPA's kernels there
              named) and a float32 shape with every knob,
              planted faults above both limits, two launches of B
              bit-equal, timed at smollm's beside SDPA's forward and
              backward; ``train-small``: the
              four dense smoke configs' ``make_train_step`` (and one
              grad-accumulation step), then the other families' and
              both MoE smoke configs, card == CPU within
              TRAIN_SMALL_TOL; ``train-full``: smollm-135m at its
              published width through ``launch.train.build`` (bf16,
              remat, 8 x 2048 tokens a step), step 0 with the kernels
              against the plain versions within TRAIN_FULL_TOL (a zeroed
              dK planted above it), tokens/s, step ms, peak memory, 60
              A and 30 B launches a step, one step traced
              (``chiprun_out/profile_train.txt``), then 12 steps under
              ``TrainerLoop`` with a failure at step 7 and a restart
              from step 5 whose losses equal an uninterrupted run's bit
              for bit; ``train-full-rwkv6`` / ``-zamba2`` / ``-vlm`` /
              ``-whisper`` / ``-deepseek``: each family at its published
              widths (deepseek-v2-lite-16b at 4 x 4096 cut to its dense
              layer + 3 MoE layers, TRAIN_FAM_DEPTH), step 0 on its
              first layers against the plain versions (deepseek's plain
              runs take the kernel run's expert choices) with a planted
              fault, timed steps, one traced; ``serve-launch``:
              ``launch.serve.main`` greedy and ``--mcts`` on
              smollm-smoke, card == CPU
  7e. parallel  after ``serve-launch``, line ``parallel``: the
              model-parallel layer (``src/repro_torch/parallel``) in two
              processes on ``cuda:0`` under gloo (one rank per card under
              NCCL where there are two or more), each counting its own
              launches around each main path: (a) ``dist_decode_attention``
              at qwen2-0.5b's decode heads (B 8, H 14 / 2, D 64, bf16) on
              a 65,536-token cache split over the ranks, ragged valid
              lengths (one row ending inside the first shard), each
              rank's partial K3 with its lse store, held to one K3 call
              over the whole cache and to the plain version (output and
              lse), an lse shifted by 1 on one rank above the limit, the
              partial timed beside its plain version and SDPA; (b)
              ``ep_moe_ffn`` at deepseek-v2-lite-16b's MoE widths on 4,096
              bf16 tokens over a model axis, held to the grouped dispatch
              at a capacity with no drops and to one rank's EP at the
              config's capacity and at 90% of the largest expert load
              (which must drop slots); (c) smollm-135m's sharded train
              step (8 x 2048 tokens over a data axis, state at rest as
              each rank's slices) for 3 steps, held to the one-process
              step (loss, grad_norm, every leaf after step 3), a planted
              fault (no sum over data in the gradient's reduce-scatter)
              above a limit, the farthest leaf no farther from a float32
              one-process run than FAM_F32_RATIO times the one-process
              bf16 run, bytes at rest a rank (with the EF residuals)
              against the whole state's, once more with the int8 EF
              compressor; (d) ``pipeline_forward`` of smollm-135m's 30
              blocks as 2 stages of 15, held to ``hidden_states``
  8. profile  device busy share and time by kernel of the fused P-game
              runs (at a quarter of FULL's budget, PROFILED), one LM
              token's search and one engine step of each
              recurrent run (torch.profiler), tables in
              ``chiprun_out/profile.txt``, ``profile_lm.txt`` and
              ``profile_rec.txt``; deepseek-v2-lite-16b's engine step and
              384-token prefill (traced inside ``moe-full``) in
              ``profile_fam.txt``
  9. report   the wrappers' host cost, the kernels' JSON line, the card
              line, the last line.  K1a / K1b have two rows each: ``se`` /
              ``bes`` timed on the loss/independent snapshot and
              ``se_wu_running`` / ``bes_wu_running`` on the wu/running one,
              each with its own variant's launches.  K5 / K6 have two: the
              sequential kernels (``wkv6_step`` / ``ssd_step``) timed at
              decode, the chunked ones at prefill, each against the bound
              of its own work (``bound_ms`` / ``chunk_bound``)

Kernel times (``cuda_time``): ``TIMING_REPS`` back-to-back calls between
two CUDA events and one synchronise, after two warm-up calls and queued
behind a spin kernel, so that the device, not the host, sets the pace;
operands the real caller finds cold (K3's cache slices) rotate so that
together they exceed the 50 MB L2; kernel, plain version, SDPA and the
earlier kernel timed in turns, the median of ``TURNS`` (a plain version
``PLAIN_REPS`` calls a turn).  Host cost
(``host_us``): a wrapper's microseconds per call on the host clock over
many calls with no synchronise; for the search wrappers the median of
ROUNDS rounds taken in turns with their kernel timing.

Details go to ``chiprun_out/chip_smoke.json``.  Imports no JAX.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
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
# a quarter of FULL's budget, where the budget is depth only: the traced
# runs, the lockstep runs (a tenth of the fused runs' rate) and the
# sharded / FT runs (each root held to its single-device run)
PROFILED = LOCKSTEP = SHARDED = dict(FULL, budget=FULL["budget"] // 4)
SMALL = dict(batch=4, num_actions=4, game_depth=6, budget=64, lanes=8,
             max_depth=6, cp=0.7)
SNAPSHOT_TICKS = 24
TIMING_REPS = 20      # back-to-back calls between two CUDA events
PLAIN_REPS = 2        # ... of a plain version (it repeats the kernel's
                      # arithmetic and is no yardstick of speed)
TURNS = 3             # kernel / plain / library timed in turns; the median
ROUNDS = 5            # the search kernels: kernel, plain and host rounds
HOST_CALLS = 200      # wrapper calls timed on the host clock
HOLD_CYCLES = 20_000_000   # ~10 ms spin before a timed run (see cuda_time)
HOST: dict = {}       # kernel -> host microseconds per wrapper call
HOST_SPREAD: dict = {}  # search kernels: (min, max) of HOST's rounds
CHAINS: dict = {}     # snapshot -> the search kernels' chain lengths
K2A: dict = {}        # snapshot -> K2a on the float32 board, the parent's
                      # (--before) and an empty launch (torch.cuda._sleep)
BEFORE: dict = {}     # the parent's K4, K3 and K2a wrappers (--before)


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


def clone_planes(t):
    """A copy of an arena's planes that shares its ``state`` leaves (the
    search kernels and their plain versions never write them; an LM
    arena's are its KV caches, gigabytes a copy)."""
    from repro_torch.core.arena import TreeArena
    import dataclasses
    return TreeArena(**{f.name: getattr(t, f.name) if f.name == "state"
                        else getattr(t, f.name).clone()
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
    floats = [(t1.value, t2.value), (t1.prior, t2.prior)]
    if "accum" in t1.state:                # the P-game's float state leaf
        floats.append((t1.state["accum"], t2.state["accum"]))
    for a, b in floats:
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


def cuda_time(fn, reps=TIMING_REPS, setup=None, args=None) -> float:
    """Mean ms per call: ``reps`` back-to-back calls of ``fn(arg)`` between
    two CUDA events and one synchronise, after two warm-up calls.  A spin
    kernel holds the device before the first event while the host queues
    the calls, so a kernel faster than its wrapper's host cost is timed
    back to back, not at the host's pace (calls that synchronise inside,
    as some plain versions do, stay host-paced).
    ``setup()`` makes each call's argument, all before the timed span (for
    kernels that update their operands in place); ``args`` is a list the
    calls rotate through (operands the real caller finds cold: together
    they exceed the 50 MB L2)."""
    n = reps + 2
    if setup is not None:
        arg = [setup() for _ in range(n)]
    elif args is not None:
        arg = [args[i % len(args)] for i in range(n)]
    else:
        arg = [None] * n
    fn(arg[0])
    fn(arg[1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)   # the host queues the calls meanwhile
    start.record()
    for a in arg[2:]:
        fn(a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(cases: dict, turns: int = TURNS) -> dict:
    """``cases`` = ``{name: (fn, cuda_time kwargs)}``, each timed by
    ``cuda_time`` in turns (in order, then reversed, ...), ``turns`` times
    round inside this one process; the median per name."""
    return time_rounds(cases, {}, turns)[0]


def time_rounds(cases: dict, host_cases: dict, rounds: int = ROUNDS):
    """``time_turns`` over ``rounds`` rounds, each followed by every
    ``host_cases`` entry (``{name: (fn, host_us kwargs)}``) timed by
    ``host_us``.  Returns the median per case, and per host case its
    median, min and max over the rounds."""
    got = {k: [] for k in cases}
    hosts = {k: [] for k in host_cases}
    for r in range(rounds):
        for k in (list(cases) if r % 2 == 0 else list(cases)[::-1]):
            fn, kw = cases[k]
            got[k].append(cuda_time(fn, **kw))
        for k, (fn, kw) in host_cases.items():
            hosts[k].append(host_us(fn, **kw))
    return ({k: statistics.median(v) for k, v in got.items()},
            {k: (statistics.median(v), min(v), max(v))
             for k, v in hosts.items()})


def host_us(fn, setup=None, calls=HOST_CALLS) -> float:
    """Host microseconds per call of a kernel wrapper: ``calls`` calls on
    the host clock with no synchronise inside the span (the wrapper's own
    cost: operand checks, binding, allocation, the enqueue).  ``setup()``
    makes each call's argument before the span."""
    args = [setup() if setup else None for _ in range(calls + 1)]
    fn(args[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in args[1:]:
        fn(a)
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def bound_ms(nbytes: float, flops: float,
             peak_flops: float = F32_FLOPS):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak_flops
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


def phase_build(before=None):
    """nvcc of every source in parallel (and, with ``--before DIR``, of
    the parent's ``BEFORE_SOURCES`` by the parent's own ``_build``, into
    DIR's build directory); then the SASS checks of ``sass_check``."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    if before:
        BEFORE.update(load_before(before))
    logs = _build.build_all(force=True)
    if before:
        BEFORE["_thread"].join()
        if BEFORE["_thread"].err:
            fail(f"the parent's build failed: {BEFORE['_thread'].err[0]}")
    secs = time.perf_counter() - t0
    regs, bwd = [], {}
    for name, log in logs.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                regs.append(f"{name}: {fn[:100]}: {line.strip()}")
                if name == "flash_attention_bwd":
                    got = re.search(r"Used (\d+) registers", line) or \
                        re.search(r"(\d+) bytes spill stores", line)
                    key = "regs" if "registers" in line else "spill"
                    bwd.setdefault(kernel_label(fn), {})[key] = \
                        int(got.group(1))
    say(f"build {len(logs)} sources in {secs:.2f} s (parallel nvcc)"
        + (f" and the parent's {list(BEFORE_SOURCES)} from {before}"
           if before else ""))
    say("ptxas kernel B (flash_attention_bwd.cu), registers / spill-store "
        "bytes: " + ", ".join(f"{k} {v.get('regs')}/{v.get('spill')}"
                              for k, v in sorted(bwd.items())))
    spilled = [k for k, v in bwd.items() if "wgmma" in k and v.get("spill")]
    if spilled or not all(any(k.startswith(n) for k in bwd) for n in (
            "fa_bwd_dkdv_wgmma2_kernel", "fa_bwd_dq_wgmma2_kernel")):
        fail(f"ptxas: kernel B's bf16 instantiations {spilled} spill, or "
             "a two-warpgroup kernel was not built")
    return secs, regs, sass_check(_build.BUILD_DIR)


def kernel_label(mangled: str) -> str:
    """``name<args>`` of a kernel's mangled name from the anonymous
    namespace of a csrc source (``_ZN<n>_GLOBAL__N__<id>_cu_<8 hex><len>
    <name>I<args>E...``): int args as numbers, float / bf16 by name."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if not m:
        return mangled[:60]
    at = m.end()
    name = mangled[at:at + int(m.group(1))]
    rest, args = mangled[at + int(m.group(1)):], []
    if rest.startswith("I"):
        for tok in re.finditer(r"Li(\d+)E|f|13__nv_bfloat16|E", rest[1:]):
            if tok.group(0) == "E":
                break
            args.append(tok.group(1) or ("float" if tok.group(0) == "f"
                                         else "bf16"))
    return name + (f"<{','.join(args)}>" if args else "")


SASS_NEEDS = (("flash_attention", "fa_wgmma_kernel", "HGMMA"),
              ("flash_attention", "fa_wgmma_kernel", "UTMALDG"),
              ("flash_attention", "fa_kernel", "LDGSTS"),
              ("flash_attention_bwd", "fa_bwd_dkdv_wgmma_kernel", "HGMMA"),
              ("flash_attention_bwd", "fa_bwd_dkdv_wgmma_kernel", "UTMALDG"),
              ("flash_attention_bwd", "fa_bwd_dq_wgmma_kernel", "HGMMA"),
              ("flash_attention_bwd", "fa_bwd_dq_wgmma_kernel", "UTMALDG"),
              ("flash_attention_bwd", "fa_bwd_dkdv_wgmma2_kernel", "HGMMA"),
              ("flash_attention_bwd", "fa_bwd_dkdv_wgmma2_kernel",
               "UTMALDG"),
              ("flash_attention_bwd", "fa_bwd_dq_wgmma2_kernel", "HGMMA"),
              ("flash_attention_bwd", "fa_bwd_dq_wgmma2_kernel", "UTMALDG"),
              ("decode_attention", "da_kernel", "LDGSTS"),
              ("ssm_chunk", "ssd_chunk_kernel", "HMMA"),
              ("rwkv6_chunk", "wkv6_chunk_kernel", "HMMA"),
              ("rwkv6_chunk_bwd", "wkv6_bwd_kernel", "HMMA"),
              ("ssm_chunk_bwd", "ssd_bwd_kernel", "HMMA"),
              ("uct_select", "uct_tiles_kernel", "REDUX"))
# instructions a kernel must not hold: the float32 K4 and kernel B stay
# IEEE float32 FFMA, off the tensor cores
SASS_FORBIDS = (("flash_attention", "fa_kernel", "HMMA"),
                ("flash_attention_bwd", "fa_bwd_dkdv_kernel", "HMMA"),
                ("flash_attention_bwd", "fa_bwd_dq_kernel", "HMMA"))


def sass_check(build_dir) -> dict:
    """Count, in each instantiation of a kernel of the built libraries
    (``cuobjdump -sass``), the instructions ``SASS_NEEDS`` asks of it:
    HGMMA (wgmma) and UTMALDG (TMA loads) in ``fa_wgmma_kernel`` and the
    bf16 backward's ``fa_bwd_*_wgmma_kernel``, 16-byte
    LDGSTS (cp.async) in ``fa_kernel`` and ``da_kernel``, HMMA (mma.sync)
    in the chunked scans, REDUX (the first-max) in ``uct_tiles_kernel``;
    fail where one is missing, or where one of ``SASS_FORBIDS`` (HMMA in
    ``fa_kernel`` and the float32 backward) is present."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        say("sass not measured (no cuobjdump)")
        return {}
    counts, dumps = {}, {}
    for lib, fn, what in SASS_NEEDS + SASS_FORBIDS:
        if lib not in dumps:
            dumps[lib] = subprocess.run(
                [tool, "-sass", str(build_dir / f"lib{lib}.so")],
                capture_output=True, text=True, check=True).stdout
        found = 0
        for chunk in dumps[lib].split("Function : ")[1:]:
            head = chunk.split("\n", 1)[0]
            if fn not in head:
                continue
            found += 1
            n = sum(1 for line in chunk.splitlines() if what in line
                    and (what != "LDGSTS" or ".128" in line))
            if (lib, fn, what) in SASS_FORBIDS:
                if n:
                    fail(f"{lib}: {head[:90]} holds {n} {what} "
                         f"instructions")
                continue
            if n == 0:
                fail(f"{lib}: {head[:90]} has no {what} instruction")
            counts[f"{what} {head.strip()[:120]}"] = n
        if found == 0:
            fail(f"{lib}: no {fn} in the SASS")
    say("sass " + ", ".join(
        f"{fn}: {sum(v for k, v in counts.items() if k.startswith(what) and fn in k)} "
        f"{what} in {sum(1 for k in counts if k.startswith(what) and fn in k)} "
        f"instantiations" for _, fn, what in SASS_NEEDS)
        + ", " + ", ".join(f"{fn}: no {what}" for _, fn, what in SASS_FORBIDS))
    return counts


# the parent's kernel layer (``--before``): its own ``_build`` (its
# sources, flags and build directory) and its own wrappers of the attention
# kernels and K2a, loaded under other names and timed beside the redesigned
# kernels in one process through their public entry points
BEFORE_SOURCES = ("flash_attention", "decode_attention", "uct_select")


def load_before(root) -> dict:
    """The kernel layer of the checkout at ``root`` (``src/repro_torch``):
    its ``kernels/_build.py`` and the ``ops.py`` of ``BEFORE_SOURCES``,
    each wrapper bound to that ``_build``, so the parent's own code names
    its C entry points and their arguments.  Returns the modules and the
    thread that builds the parent's sources (started here)."""
    import importlib.util
    import threading
    pkg = Path(root).resolve() / "src" / "repro_torch" / "kernels"

    def load(name, path):
        if not path.exists():
            fail(f"--before: no {path}")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    build = load("before_build", pkg / "_build.py")
    build.SOURCES = BEFORE_SOURCES
    mods = {s: load(f"before_{s}", pkg / s / "ops.py")
            for s in BEFORE_SOURCES}
    for mod in mods.values():
        mod._build = build
    err = []

    def run():
        try:
            build.build_all(force=True)
        except Exception as e:      # reported by the caller's join
            err.append(e)
    thread = threading.Thread(target=run)
    thread.start()
    thread.err = err
    return dict(mods, _build=build, _thread=thread)


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
    ep = S.empty_expansion(sp, tree, lanes)
    pb = S.empty_playout(sp, bsz, lanes, dom.num_actions, dev)
    gen = torch.Generator().manual_seed(seed)
    draws = dom.sample_draws((bsz, ticks, lanes), gen).to(dev)
    for t in range(ticks):
        tree, se, ep, pb = W.pipeline_tick(tree, dom, sp, lanes, True, se, ep,
                                           pb, draws[:, t], impl="ref")
    torch.cuda.synchronize()
    return dom, tree, se, ep, pb


def max_group(keys, member) -> int:
    """The largest number of ``member`` entries of one row of ``keys``
    ``[B, L]`` that share a key: the longest walk over a group of lanes."""
    best = 0
    for k, m in zip(keys.cpu(), member.cpu()):
        if bool(m.any()):
            best = max(best, int(torch.unique(k[m], return_counts=True)[1]
                                 .max()))
    return best


def chain_lengths(sel, pb) -> dict:
    """The dependent chains of one launch on a snapshot (see the source
    note in ``csrc/search_wave.cu``): Select's levels (one past the deepest
    lane, where the walk stops, at most max_depth), the running walk's
    steps summed over those levels (the largest group of lanes leaving one
    node), Expand's walk (the largest group of lanes on one leaf) and
    Backup's (the largest group of lanes holding one node in a column of
    ``pb``'s paths: all valid lanes at the root)."""
    path, depth, valid = sel["path"], sel["depth"], sel["valid"]
    deep = int(depth.max())
    steps = [max_group(path[:, :, d], valid & (depth > d))
             for d in range(deep)]
    pbv = pb["valid"][..., None] & (pb["path"] >= 0)
    return {"levels": min(deep + 1, FULL["max_depth"]),
            "running_steps": sum(steps), "running_steps_by_level": steps,
            "expand_walk": max_group(sel["leaf"], valid),
            "backup_walk": max(max_group(pb["path"][:, :, c], pbv[:, :, c])
                               for c in range(pb["path"].shape[2]))}


def wave_bytes(tree, paths, a, extra_rows=0) -> float:
    """Bytes a wave must move: each distinct row on the paths read once
    (children + child N/W/in-flight = 16 B per slot, plus its own stats),
    plus ``extra_rows`` rows written."""
    rows = 0
    for b in range(paths.shape[0]):
        p = paths[b]
        rows += int(torch.unique(p[p >= 0]).numel())
    return rows * (a * 16 + 12) + extra_rows


def k2a_boards(dev) -> None:
    """K2a against its plain version (on the card, same inputs) on
    synthetic boards of 300 rows, A in {1, 4, 16, 33, 130}: finished rows
    (every column invalid, index 0), rows whose every column scores the
    sentinel (a tie, the lowest column), both modes, int32 and float32
    count planes, and ``child_o`` the same tensor as ``child_vl``.
    Decisions must be equal."""
    from repro_torch.kernels.uct_select import ops as U
    gen = torch.Generator().manual_seed(17)
    i32 = torch.int32
    for a in (1, 4, 16, 33, 130):
        rows = 300
        cnt = lambda hi: torch.randint(0, hi, (rows, a), generator=gen,
                                       dtype=i32)
        n, vl, o = cnt(40), cnt(3), cnt(4)
        w = torch.randn(rows, a, generator=gen) * 3
        fresh = torch.rand(rows, generator=gen) < 0.2
        n[fresh], vl[fresh], o[fresh] = 0, 0, 0
        valid = torch.rand(rows, a, generator=gen) < 0.8
        valid[torch.rand(rows, generator=gen) < 0.15] = False
        pn = torch.randint(0, 300, (rows,), generator=gen, dtype=i32)
        for counts in (i32, torch.float32):
            x = [t.to(counts).to(dev) for t in (n, vl, o, pn)]
            wd, vd = w.to(dev), valid.to(dev)
            for mode in ("loss", "wu"):
                for infl in (x[2], x[1]):   # O; O the same tensor as vl
                    kw = dict(cp=0.7, vl_weight=1.0, valid=vd, child_o=infl,
                              vl_mode=mode)
                    got = U.uct_argmax(x[0], wd, x[1], x[3], impl="cuda",
                                       **kw)
                    want = U.uct_argmax(x[0], wd, x[1], x[3], impl="ref",
                                        **kw)
                    if max_diff(got, want) != 0:
                        fail(f"uct_argmax_tiles A={a} {counts} {mode}: "
                             f"kernel picks differ from the plain version")
    say("k2a boards A 1/4/16/33/130 x int32/float32 x loss/wu kernel == "
        "plain (finished rows, sentinel ties, O is vl)")


def phase_kernels(dev):
    """K1 / K2 against their plain versions on full-size snapshots; times
    in turns; the wrappers' host cost (``HOST``)."""
    from repro_torch.kernels.search_wave import ops as W
    from repro_torch.kernels.uct_select import ops as U
    results, host = {}, HOST
    lanes, a = FULL["lanes"], FULL["num_actions"]
    reset_launches()
    k2a_boards(dev)
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
        # K2b on a level-0 board too: every lane at the root, one group,
        # the walk's longest chain (L steps)
        node0 = torch.zeros_like(node)
        ch0 = tree.children[bi, node0]
        idx0 = ch0.clamp_min(0)
        n0_, w0_, v0_ = (tree.visits[bia, idx0], tree.value[bia, idx0],
                         infl[bia, idx0])
        pn0 = tree.visits[bi, node0] + infl[bi, node0]
        kw0 = dict(kw, valid=ch0 >= 0, child_o=v0_)
        k_r0 = U.uct_argmax_running(n0_, w0_, v0_, pn0, node0, impl="cuda",
                                    **kw0)
        r_r0 = U.uct_argmax_running(n0_, w0_, v0_, pn0, node0, impl="ref",
                                    **kw0)
        torch.cuda.synchronize()
        err_t, err_r = max_diff(k_t, r_t), max_diff(k_r, r_r)
        err_r0 = max_diff(k_r0, r_r0)
        if err_t or err_r or err_r0:
            fail(f"uct_select {tag}: kernel picks differ from the plain "
                 f"version (tiles {err_t}, running {err_r}, running on the "
                 f"level-0 board {err_r0})")
        # timings at these shapes, kernel and plain version in turns
        # (fresh clones made outside the timed span)
        se_leaf = se["leaf"].to(torch.int32).contiguous()
        se_valid = se["valid"].contiguous()
        pbk = W.pack_pb(tree, sp, pb)
        fresh = dict(setup=lambda: clone_tree(tree))
        rows = node.numel()
        flat = [x.reshape(rows, a).float().contiguous() for x in (n_, w_, v_)]
        pnf = pn.reshape(rows).float().contiguous()
        vf = valid.reshape(rows, a).contiguous()
        kwf = dict(kw, valid=vf, child_o=flat[2])
        wu = mode == "wu"
        board = (tree.batch, lanes, a)
        out2 = torch.empty(tree.batch, lanes, dtype=torch.int32, device=dev)
        pid = node.to(torch.int32).contiguous()
        flat0 = [x.reshape(board).float().contiguous()
                 for x in (n0_, w0_, v0_)]
        pnf0 = pn0.float().contiguous()
        vf0 = (ch0 >= 0).contiguous()
        pid0 = node0.to(torch.int32).contiguous()
        cases = {
            "se": (lambda t: W.launch_se(t, sp, lanes, True), fresh),
            "se/plain": (lambda t: W.se(t, sp, lanes, True, impl="ref"),
                         dict(fresh, reps=PLAIN_REPS)),
            "bes": (lambda t: W.launch_bes(t, sp, lanes, True, se_leaf,
                                           se_valid, pbk), fresh),
            "bes/plain": (lambda t: W.bes(t, sp, lanes, True, se, pb,
                                          impl="ref"),
                          dict(fresh, reps=PLAIN_REPS)),
            "b": (lambda t: W.launch_b(t, sp, pbk), fresh),
            "b/plain": (lambda t: W.b(t, sp, pb, impl="ref"),
                        dict(fresh, reps=PLAIN_REPS)),
            # K2a through its wrapper on the arena's int32 planes and on
            # the float32 board (no copy on either)
            "uct_argmax_tiles": (lambda _: U.uct_argmax(
                n_, w_, v_, pn, impl="cuda", **kw), {}),
            "uct_argmax_tiles/f32": (lambda _: U.uct_argmax(
                flat[0], flat[1], flat[2], pnf, impl="cuda", **kwf), {}),
            "uct_argmax_tiles/plain": (lambda _: U.uct_argmax(
                n_, w_, v_, pn, impl="ref", **kw), {"reps": PLAIN_REPS}),
            "launch_floor": (lambda _: torch.cuda._sleep(0), {}),
            "uct_argmax_running": (lambda _: U.launch_running(
                flat[0].view(board), flat[1].view(board),
                flat[2].view(board), flat[2].view(board),
                pnf.view(tree.batch, lanes), vf.view(board), pid, out2,
                cp=sp.cp, vl_weight=sp.vl_weight, wu=wu), {}),
            "uct_argmax_running/plain": (lambda _: U.uct_argmax_running(
                n_, w_, v_, pn, node, impl="ref", **kw),
                {"reps": PLAIN_REPS}),
            "uct_argmax_running_l0": (lambda _: U.launch_running(
                flat0[0], flat0[1], flat0[2], flat0[2], pnf0, vf0, pid0,
                out2, cp=sp.cp, vl_weight=sp.vl_weight, wu=wu), {}),
            "uct_argmax_running_l0/plain": (lambda _: U.uct_argmax_running(
                n0_, w0_, v0_, pn0, node0, impl="ref", **kw0),
                {"reps": PLAIN_REPS})}
        if BEFORE:    # the parent's wrapper on the float32 board: no copy
            cases["uct_argmax_tiles/before"] = (
                lambda _: BEFORE["uct_select"].uct_argmax(
                    flat[0], flat[1], flat[2], pnf, impl="cuda", **kwf), {})
        hosts = {}
        if tag == "loss/independent":     # the wrappers the paths call
            few = dict(calls=30, **fresh)
            hosts = {
                "se": (lambda t: W.se(t, sp, lanes, True, impl="cuda"), few),
                "bes": (lambda t: W.bes(t, sp, lanes, True, se, pb,
                                        impl="cuda"), few),
                "b": (lambda t: W.b(t, sp, pb, impl="cuda"), few),
                "uct_argmax_tiles": (lambda _: U.uct_argmax(
                    n_, w_, v_, pn, impl="cuda", **kw), {}),
                "uct_argmax_running": (lambda _: U.uct_argmax_running(
                    n_, w_, v_, pn, node, impl="cuda", **kw), {})}
            if BEFORE:     # the parent's wrapper on the int32 planes
                hosts["uct_argmax_tiles/before"] = (
                    lambda _: BEFORE["uct_select"].uct_argmax(
                        n_, w_, v_, pn, impl="cuda", **kw), {})
        tm, hs = time_rounds(cases, hosts)
        for k, (med, lo, hi) in hs.items():
            host[k] = med
            HOST_SPREAD[k] = (lo, hi)
        # bounds from this snapshot's data
        sel_paths = sel1["path"]
        b_sel = wave_bytes(tree, sel_paths, a) + sel_paths.numel() * 4 * 2
        f_sel = float((sel1["depth"].sum() * a * 15).item())
        pb_paths = torch.where(pb["valid"][..., None], pb["path"], -1)
        b_pb = wave_bytes(tree, pb_paths, a,
                          extra_rows=int(pb["is_new"].sum()) * a * 4)
        board_bytes = rows * a * 13 + rows * 8
        board_flops = rows * a * 15
        bounds = {"se": bound_ms(b_sel, f_sel),
                  "bes": bound_ms(b_sel + b_pb, f_sel),
                  "b": bound_ms(b_pb, 0.0),
                  "uct_argmax_tiles": bound_ms(board_bytes, board_flops),
                  "uct_argmax_running": bound_ms(board_bytes + rows * 4,
                                                 board_flops),
                  "uct_argmax_running_l0": bound_ms(board_bytes + rows * 4,
                                                    board_flops)}
        errs = {"se": err_se, "bes": err_bes, "b": err_b,
                "uct_argmax_tiles": float(err_t),
                "uct_argmax_running": float(err_r),
                "uct_argmax_running_l0": float(err_r0)}
        results[tag] = {k: (errs[k], tm[k], tm[k + "/plain"], bounds[k])
                        for k in bounds}
        K2A[tag] = {k: tm[n] for k, n in (
            ("f32_ms", "uct_argmax_tiles/f32"),
            ("before_ms", "uct_argmax_tiles/before"),
            ("launch_floor_ms", "launch_floor")) if n in tm}
        CHAINS[tag] = {"se": chain_lengths(sel1, pb),
                       "bes": chain_lengths(nse1, pb),
                       "uct_argmax_running": max_group(node, valid.any(-1)),
                       "uct_argmax_running_l0": max_group(node0,
                                                          vf0.any(-1))}
        del dom, tree, se, ep, pb
    worst = {k: max(results[t][k][0] for t in results)
             for k in results["loss/independent"]}
    counts = all_launches()
    say("kernels " + " ".join(f"{k}:max_abs_err={v},launches="
                              f"{counts.get(k, '-')}"
                              for k, v in worst.items())
        + " (vs plain at full size; launches of this phase)")
    for tag, res in results.items():
        c = CHAINS[tag]
        say(f"chains {tag} se={c['se']} bes={c['bes']} "
            f"k2b={c['uct_argmax_running']} "
            f"k2b_l0={c['uct_argmax_running_l0']}")
        say(f"kernel-ms {tag} " + " ".join(
            f"{k}={v[1]:.5f}(plain {v[2]:.4f},bound {v[3][0]:.6f})"
            for k, v in res.items()) + " uct_argmax_tiles " + ",".join(
                f"{k}={v:.5f}" for k, v in K2A[tag].items()))
    return results


def run_batch(dev, cfg, method, wave_select, vl_mode, level_assign, draws,
              puct=False, mesh=None):
    from repro_torch.search import SearchConfig, search_batch
    dom = make_domain(cfg)
    sc = SearchConfig(method=method, budget=cfg["budget"], lanes=cfg["lanes"],
                      params=search_params(cfg, wave_select=wave_select,
                                           vl_mode=vl_mode,
                                           level_assign=level_assign,
                                           puct=puct))
    return search_batch([dom] * cfg["batch"], sc, draws, device=dev,
                        mesh=mesh)


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
RUN_KERNELS = {("pipeline", "mega", "independent"): ("bes",),
               ("pipeline", "mega", "running"): ("bes", "bes_running"),
               ("tree", "mega"): ("se", "b"),
               ("pipeline", "lockstep", "independent"): ("uct_argmax_tiles",),
               ("pipeline", "lockstep", "running"): ("uct_argmax_running",)}


def _launch_counters():
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.search_wave import ops as W
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.kernels.uct_select import ops as U
    return (W.launches, U.launches, FA.launches, DA.launches, WK.launches,
            SS.launches)


def all_launches():
    return {k: v for d in _launch_counters() for k, v in d.items()}


def reset_launches():
    for d in _launch_counters():
        for k in d:
            d[k] = 0


def phase_full(dev):
    """FULL_RUNS at FULL, the lockstep ones at LOCKSTEP: root visits and
    completed playouts equal to the budget, the tree invariants, each
    run's kernels launched."""
    from repro_torch.core.tree import check_consistency
    draws = {(m, c["budget"]): draws_for(c, m, 1000 + i)
             for i, m in enumerate(("pipeline", "tree"))
             for c in (FULL, LOCKSTEP)}
    runs = []
    torch.cuda.synchronize()
    reset_launches()                       # the main path starts here
    for m, ws, vl, la in FULL_RUNS:
        cfg = FULL if ws == "mega" else LOCKSTEP
        before = all_launches()
        d = draws[(m, cfg["budget"])].to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_batch(dev, cfg, m, ws, vl, la, d)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        after = all_launches()
        what = f"full {m}/{ws}/{vl}/{la}"
        tree = res.tree
        if not bool((tree.visits[:, 0] == cfg["budget"]).all()):
            fail(f"{what}: root visits != {cfg['budget']}")
        if not bool((res.stats["playouts_completed"]
                     == cfg["budget"]).all()):
            fail(f"{what}: playouts_completed != {cfg['budget']}")
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
        rate = cfg["batch"] * cfg["budget"] / secs
        runs.append({"run": what, "seconds": secs, "playouts_per_s": rate,
                     "launches": launched,
                     "nodes_mean": float(cons["nodes"].float().mean()),
                     "dup_mean": float(res.stats["duplicates"]
                                       .float().mean())})
    counts = all_launches()                # read just after the main path
    for k, v in counts.items():
        if v == 0 and k in SOURCES \
                and k not in LM_KERNELS + REC_KERNELS + FAM_KERNELS \
                + TRAIN_KERNELS + PAR_KERNELS:
            fail(f"kernel {k} was not launched on the main path")
    say("full " + "; ".join(f"{r['run'][5:]} {r['playouts_per_s']:.0f} "
                            f"playouts/s" for r in runs)
        + f" (B={FULL['batch']} x {FULL['budget']} playouts, lockstep "
        f"{LOCKSTEP['budget']}, A={FULL['num_actions']} "
        f"depth={FULL['game_depth']} lanes={FULL['lanes']})")
    return runs, counts


# the port's kernels as the trace names them (a prefix each, so that
# PyTorch's own "..._cuda_kernel" names do not match)
PORT_KERNELS = ("::fa_wgmma_kernel<", "::fa_kernel(", "::da_kernel<",
                "::da_combine<", "sw_se_kernel", "sw_bes_kernel",
                "sw_b_kernel", "uct_tiles_kernel", "uct_running_kernel",
                "::wkv6_kernel<", "::ssd_kernel<", "::wkv6_chunk_kernel(",
                "::ssd_chunk_kernel(", "::fa_bwd_delta_kernel<",
                "::fa_bwd_dkdv_kernel<", "::fa_bwd_dq_kernel<",
                "::fa_bwd_dkdv_wgmma_kernel<", "::fa_bwd_dq_wgmma_kernel<",
                "::fa_bwd_dkdv_wgmma2_kernel<", "::fa_bwd_dq_wgmma2_kernel<",
                "::wkv6_bwd_kernel<", "::ssd_bwd_kernel<",
                "group_sum_kernel")


def profile_one(what: str, run, warm: bool = True):
    """Wall time of ``run()`` untraced (after a warm run unless ``warm`` is
    False: the caller ran the same shapes earlier), then one run
    traced by torch.profiler (CUPTI).  Device busy time is the sum over
    the device's own events (kernels, copies, sets); an operator's self
    device time repeats its kernels' and is listed beside them, not summed
    (PyTorch's own table sums the same way).  Returns ``(summary, table
    lines)``, or ``(None, [])`` when the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warm:
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern, ops = {}, {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            side = ops if e.device_type == DeviceType.CPU else kern
            side[e.key] = (e.self_device_time_total, e.count)
    if not kern:
        say(f"profile {what}: device time not measured (no CUDA events)")
        return None, []
    busy = sum(us for us, _ in kern.values()) / 1e6
    top_k = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    top_o = sorted(ops.items(), key=lambda kv: -kv[1][0])[:8]
    lines = [f"{what}: wall {wall:.4f} s untraced, device busy {busy:.4f} s "
             f"({100 * busy / wall:.1f}% of wall), "
             f"{sum(c for _, c in kern.values())} device events",
             "  top device events:"]
    lines += [f"    {us / 1e3:10.3f} ms  {c:7d}x  {k[:90]}"
              for k, (us, c) in top_k]
    lines.append("  top operators by self device time (their kernels are "
                 "among the events above):")
    lines += [f"    {us / 1e3:10.3f} ms  {c:7d}x  {k[:90]}"
              for k, (us, c) in top_o]
    port = sorted(((k, v) for k, v in kern.items()
                   if any(n in k for n in PORT_KERNELS)),
                  key=lambda kv: -kv[1][0])
    lines.append("  the port's kernels (share of device busy time):")
    lines += [f"    {us / 1e3:10.3f} ms  {c:7d}x  "
              f"{100 * us / 1e6 / busy:5.1f}%  {k[:80]}"
              for k, (us, c) in port]
    say(f"profile {what} wall={wall:.3f}s busy={busy:.3f}s "
        f"idle={100 * (1 - busy / wall):.1f}% top={top_k[0][0][:40]}")
    return {"wall_s": wall, "busy_s": busy,
            "port_kernels": [(k, us, c) for k, (us, c) in port],
            "device_events": sum(c for _, c in kern.values()),
            "top_events": [(k, us, c) for k, (us, c) in top_k],
            "top_ops": [(k, us, c) for k, (us, c) in top_o]}, lines


def write_out(name: str, lines) -> None:
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / name).write_text("\n".join(lines) + "\n")


def phase_profile(dev):
    """Where the time goes on the fused P-game runs at FULL's width and a
    quarter of its budget (PROFILED; table in ``chiprun_out/profile.txt``):
    the trace of a full-budget run takes most of a minute to read.  The
    lockstep runs are left out: tracing their ~10^5 small launches takes
    minutes."""
    lines, shares = [], {}
    for m, ws, vl, la in FULL_RUNS:
        if ws != "mega":
            continue
        d = draws_for(PROFILED, m, 1000).to(dev)
        what = f"{m}/{ws}/{vl}/{la} budget {PROFILED['budget']}"
        summary, table = profile_one(
            what, lambda: run_batch(dev, PROFILED, m, ws, vl, la, d))
        if summary:
            shares[what] = summary
            lines += table
    write_out("profile.txt", lines)
    return shares


# ---------------------------------------------------------------------------
# the LM-decode path: MCTS-guided decoding on smollm-135m
# ---------------------------------------------------------------------------
LM_ARCH = "smollm-135m"
# full size: 16 requests with ragged prompts of 64-256 tokens, 8 new
# tokens each, every token chosen by a 64-playout pipelined search
LM_FULL = dict(batch=16, prompt_min=64, prompt_max=256, new_tokens=8,
               method="pipeline", num_actions=4, budget=64, lanes=16,
               search_depth=8, rollout_len=4, cp=1.0)
LM_SMALL = dict(batch=3, prompt_min=3, prompt_max=9, new_tokens=3,
                method="pipeline", num_actions=3, budget=16, lanes=4,
                search_depth=3, rollout_len=2, cp=1.0)
LM_KERNELS = ("flash_attention", "flash_attention_bf16", "decode_attention")
LM_SEED = 0
LM_BES_TICKS = 3  # K1b's check snapshot: waves 0-2 in flight, so the tick
                  # checked backs up wave 0, expands wave 2, selects wave 3
F32_TOL = 1e-5    # kernel vs plain in float32: the order of the sums alone
# bf16, held per element as |got - want| <= F32_TOL + rtol * |want|.  Kernel
# and plain version both compute in float32 from the same bf16 inputs and
# round the output to nearest bf16 once, so against the plain version run
# in float32 on those inputs the kernel is at most half a bf16 ulp off
# (<= 2^-8 of |value|), and against its bf16 output at most one ulp
# (<= 2^-7), where the two float32 sums straddle a rounding boundary
BF16_RTOL_F32 = 2.0 ** -8
BF16_RTOL = 2.0 ** -7
STEP_TOL = 0.08   # prefill-then-step vs a prefill of the longer prompt,
                  # max |diff| over the bf16 model's f32 logits (|max| ~2.4,
                  # typical ~0.5): the two paths round bf16 activations
                  # differently (other GEMM shapes and attention kernels)
                  # over 30 layers; the sound path read 0.0332 on an H100.
                  # A step planted one position late or early must read
                  # above it (checked on every run)
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak


def lm_prompts(vocab: int, lm) -> list:
    gen = torch.Generator().manual_seed(LM_SEED + 1)
    lens = torch.randint(lm["prompt_min"], lm["prompt_max"] + 1,
                         (lm["batch"],), generator=gen)
    return [torch.randint(0, vocab, (int(n),), generator=gen).tolist()
            for n in lens]


def lm_dcfg(lm, **kw):
    from repro_torch.serving import MCTSDecodeConfig
    return MCTSDecodeConfig(method=lm["method"],
                            num_actions=lm["num_actions"],
                            budget=lm["budget"], lanes=lm["lanes"],
                            search_depth=lm["search_depth"],
                            rollout_len=lm["rollout_len"], cp=lm["cp"], **kw)


def lm_max_len(lm) -> int:
    return lm["prompt_max"] + lm["new_tokens"] + lm["search_depth"] \
        + lm["rollout_len"]


def bf16_check(what, got, plain, plain32, atol=F32_TOL):
    """Hold a bf16 kernel output against its plain version's bf16 output
    (within BF16_RTOL) and against the plain version run in float32 on the
    same inputs (within BF16_RTOL_F32), each plus ``atol``.  Returns the
    max |diff| to each and the largest share of its limit that any element
    used."""
    g = got.detach().cpu().double()
    out = {}
    for name, want, rtol in (("bf16", plain, BF16_RTOL),
                             ("f32", plain32, BF16_RTOL_F32)):
        w = want.detach().cpu().double()
        d, lim = (g - w).abs(), atol + rtol * w.abs()
        share = d / lim
        i = int(share.argmax())
        if float(share.flatten()[i]) > 1.0:
            fail(f"{what}: the kernel's bf16 output differs from the plain "
                 f"version in {name} by {float(d.flatten()[i])} where "
                 f"|want| is {float(w.abs().flatten()[i])} (limit "
                 f"{atol} + {rtol} |want|)")
        out[name] = float(d.max())
        out[name + "_limit_share"] = float(share.flatten()[i])
    return out


def rounded_check(what, got, q, k, v, planted=None, **kw):
    """Hold the bf16 tensor-core K4 per element to ``rounded_p_limit``
    (the plain version run in float32; the kernel rounds P to bf16 before
    PV) and check that ``planted`` (the kernel's output for the same
    inputs with a planted fault) reads above it.  Returns the largest
    share of the limit used, and the planted output's."""
    from repro_torch.kernels.flash_attention.ref import rounded_p_limit
    want, lim = rounded_p_limit(q, k, v, atol=F32_TOL, **kw)
    share = ((got.float() - want).abs() / lim).flatten()
    i = int(share.argmax())
    if float(share[i]) > 1.0:
        fail(f"{what}: the bf16 kernel differs from the plain version in "
             f"float32 by {float((got.float() - want).abs().flatten()[i])} "
             f"where the limit is {float(lim.flatten()[i])}")
    out = {"limit_share": float(share[i]),
           "vs_f32_max_abs": float((got.float() - want).abs().max())}
    if planted is not None:
        ps = float(((planted.float() - want).abs() / lim).max())
        if ps <= 1.0:
            fail(f"{what}: a planted fault reads {ps} of the limit: the "
                 f"check cannot see it")
        out["planted_share"] = ps
    return out


def sdpa_fn(q, k, v, **kw):
    """PyTorch's SDPA on the port's [B, S, H, D] operands (the yardstick;
    the port never calls it)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend PyTorch's SDPA dispatch picks for these [B, S, H, D]
    operands (``torch._fused_sdp_choice``; its backward is that
    backend's)."""
    from torch.nn.attention import SDPBackend
    choice = getattr(torch, "_fused_sdp_choice", None)
    if choice is None:
        return "not named (no torch._fused_sdp_choice)"
    i = choice(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               **kw)
    return {int(b): n for n, b in SDPBackend.__members__.items()}.get(
        int(i), str(i))


def device_kernels(fn) -> list:
    """The names of the device kernels one call of ``fn(None)`` launches
    (torch.profiler): which backend a PyTorch call chose."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(None)
        torch.cuda.synchronize()
    return sorted({e.key[:90] for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0})


def fa_cases(q, k, v, causal=True, before=True):
    """K4 at one shape: the kernel, its plain version, SDPA and (with
    ``--before``, unless ``before`` is False: a shape the parent's kernel
    does not take) the parent's kernel, for ``time_turns``.  Prefill's q,
    k and v are written by the projection just before, so they are not
    rotated."""
    from repro_torch.kernels.flash_attention import ops as FA
    cases = {"ms": (lambda _: FA.flash_attention(q, k, v, causal=causal),
                    {}),
             "plain_ms": (lambda _: FA.flash_attention(
                 q, k, v, causal=causal, impl="ref"), {}),
             "sdpa_ms": (lambda _: sdpa_fn(
                 q, k, v, is_causal=causal,
                 enable_gqa=k.shape[2] != q.shape[2]), {})}
    if BEFORE and before:
        cases["before_ms"] = (lambda _: BEFORE[
            "flash_attention"].flash_attention(q, k, v, causal=causal), {})
    return cases


def da_cases(q, ks, vs, vl):
    """K3 over the layer slices ``ks`` / ``vs`` of a decode cache, read in
    turn as ``step_fn`` reads them (cold: together they exceed L2)."""
    from repro_torch.kernels.decode_attention import ops as DA
    rot = dict(args=list(zip(ks, vs)))
    s = ks[0].shape[1]
    mask = (torch.arange(s, device=q.device)[None, :] < vl[:, None])[
        :, None, None, :]
    cases = {"ms": (lambda a: DA.decode_attention(q, a[0], a[1], vl), rot),
             "plain_ms": (lambda a: DA.decode_attention(q, a[0], a[1], vl,
                                                        impl="ref"), rot),
             "sdpa_ms": (lambda a: sdpa_fn(
                 q, a[0], a[1], attn_mask=mask,
                 enable_gqa=ks[0].shape[2] != q.shape[2]), rot)}
    if BEFORE:
        cases["before_ms"] = (lambda a: BEFORE[
            "decode_attention"].decode_attention(q, a[0], a[1], vl), rot)
    return cases


def fa_bound(q, k):
    b, s, h, d = q.shape
    return bound_ms(2 * (2 * q.numel() + 2 * k.numel()),
                    4 * d * h * b * s * (s + 1) / 2, BF16_FLOPS)


def da_bound(q, hkv, vl):
    keys, d = int(vl.sum()), q.shape[-1]
    return bound_ms(2 * (2 * q.numel() + 2 * keys * hkv * d)
                    + 4 * q.shape[0], 4 * d * q.shape[2] * keys, BF16_FLOPS)


def f32_cases(rnd, h, hkv, d):
    """The float32 K4's check cases, ``((q, k, v), kwargs)``: the knobs at
    the LM's heads (q_offset, soft cap, non-causal), the smoke models'
    D 16, D 20 (not a power of two), a ragged Sq over three query tiles,
    ``seq_k_valid`` below Sk, and rows with no key (a negative q_offset),
    which must give 0."""
    f32 = torch.float32
    out = []
    for (b, sq, sk, hh, hk, dd, off, cap, causal, skv) in (
            (2, 37, 37, h, hkv, d, 0, 0.0, True, None),
            (2, 9, 30, h, hkv, d, 21, 4.0, True, None),
            (1, 40, 50, h, hkv, d, 0, 0.0, False, None),
            (3, 15, 15, 3, 1, 16, 0, 0.0, True, None),
            (2, 70, 70, 4, 4, 20, 0, 0.0, True, None),
            (1, 150, 150, 6, 2, 16, 0, 0.0, True, None),
            (2, 130, 150, 6, 2, 20, 0, 2.0, False, 140),
            (1, 200, 200, 3, 1, 64, 5, 0.0, True, 190),
            (1, 5, 8, 2, 1, 16, -3, 0.0, True, None)):
        x = (rnd(b, sq, hh, dd, dt=f32), rnd(b, sk, hk, dd, dt=f32),
             rnd(b, sk, hk, dd, dt=f32))
        out.append((x, dict(causal=causal, q_offset=off,
                            logits_soft_cap=cap, seq_k_valid=skv)))
    return out


def f32_tile_flops(s: int, d: int) -> float:
    """Flops the float32 K4 issues for one (sequence, head) of a causal
    prefill of ``s`` positions: its 64 x 64 tiles at D padded to 16, 32, 64
    or 128, less the warps it skips (rows past Sq, tiles above a warp's
    rows) and the keys P V skips (past the warp's last row, to a multiple
    of 4).  Set against the exact causal count, it shows how much of the
    gap to the bound is tiling."""
    dp = next(p for p in (16, 32, 64, 128) if d <= p)
    flops = 0
    for q0 in range(0, s, 64):
        k_end = min(q0 + 64, s)
        for k0 in range(0, k_end, 64):
            for w in range(8):
                last = q0 + 8 * w + 7
                if q0 + 8 * w >= s or last < k0:
                    continue
                kn = min(64, k_end - k0, last - k0 + 1)
                flops += 2 * 8 * dp * (64 + (kn + 3) // 4 * 4)
    return flops


def f32_row(q, k, v, err):
    """The float32 K4 timed (causal) at one shape in turns with its plain
    version, SDPA in float32 and (``--before``) the parent's kernel, with
    the bound of the exact causal work: every q, k, v read and out written
    once, 4 D flops per (row, key) pair at the float32 FFMA peak; and the
    flops the kernel's tiling issues (``f32_tile_flops``)."""
    b, s, h, d = q.shape
    return dict(time_turns(fa_cases(q, k, v)), max_abs_err=err,
                shape=[b, s, h, d],
                bound=bound_ms(4 * (2 * q.numel() + 2 * k.numel()),
                               4 * d * h * b * s * (s + 1) / 2, F32_FLOPS),
                tile_flops=b * h * f32_tile_flops(s, d),
                exact_flops=4 * d * h * b * s * (s + 1) / 2)


def phase_attn_kernels(dev):
    """K4 and K3 against their plain versions on the card: at the main
    path's full-size shapes in bf16 (the 16-prompt prefill; the 30 layer
    slices of the 256-lane decode cache, read in place) and at small
    shapes in float32; the bf16 K4 held to ``rounded_p_limit`` with a
    planted fault (the diagonal one position late) above it.  Times in
    turns beside PyTorch's SDPA (the yardstick, unused by the port) and,
    with ``--before``, the parent's kernels."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    cfg, lm = get_config(LM_ARCH), LM_FULL
    h, hkv, d, nl = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.n_layers
    b, s = lm["batch"], lm_max_len(lm)
    gen = torch.Generator(dev).manual_seed(11)
    rnd = lambda *shape, dt: torch.randn(*shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
    bf, f32 = torch.bfloat16, torch.float32
    res, checks = {}, {}
    # K4 at the prefill shape, bf16 (tensor cores), with a planted fault
    q, k, v = rnd(b, s, h, d, dt=bf), rnd(b, s, hkv, d, dt=bf), \
        rnd(b, s, hkv, d, dt=bf)
    got = FA.flash_attention(q, k, v)
    checks["flash_attention_bf16"] = rounded_check(
        "flash_attention_bf16", got, q, k, v,
        planted=FA.flash_attention(q, k, v, q_offset=1))
    err_bf = max_diff(got, FA.flash_attention(q, k, v, impl="ref"))
    # one q against ten new k / v pairs, all alive: the host's cache of TMA
    # maps finds q's while k's and v's are encoded into the oldest slots
    kvs = [(rnd(2, 70, hkv, d, dt=bf), rnd(2, 70, hkv, d, dt=bf))
           for _ in range(10)]
    qm = rnd(2, 70, h, d, dt=bf)
    checks["flash_attention_bf16"]["map_cache_share"] = max(
        rounded_check("flash_attention_bf16 map cache",
                      FA.flash_attention(qm, km, vm), qm, km, vm)[
                          "limit_share"] for km, vm in kvs)
    del kvs, qm
    tm = time_turns(fa_cases(q, k, v))
    res["flash_attention_bf16"] = dict(
        tm, max_abs_err=err_bf, bound=fa_bound(q, k), shape=[b, s, h, d])
    HOST["flash_attention_bf16"] = host_us(
        lambda _: FA.flash_attention(q, k, v))
    # float32 (register-blocked FFMA kernel): small cases with the knobs,
    # times at this shape (the shapes of its main-path launches are checked
    # and timed by phase_f32_paths)
    f32e = max(max_diff(FA.flash_attention(*x, **kw),
                        FA.flash_attention(*x, impl="ref", **kw))
               for x, kw in f32_cases(rnd, h, hkv, d))
    if f32e > F32_TOL:
        fail(f"flash_attention differs from its plain version in float32 "
             f"by {f32e} (> {F32_TOL})")
    qf, kf, vf = q.float(), k.float(), v.float()
    res["flash_attention"] = f32_row(qf, kf, vf, f32e)
    HOST["flash_attention"] = host_us(
        lambda _: FA.flash_attention(qf, kf, vf))
    del q, k, v, qf, kf, vf, got
    # K3 on the decode cache of 16 roots x 16 lanes, one layer checked,
    # all 30 layer slices timed in turn
    n = b * lm["lanes"]
    qd = rnd(n, 1, h, d, dt=bf)
    kc, vc = rnd(n, nl, s, hkv, d, dt=bf), rnd(n, nl, s, hkv, d, dt=bf)
    vl = torch.randint(lm["prompt_min"] + 1, s + 1, (n,), device=dev,
                       generator=gen).to(torch.int32)
    ks_, vs_ = kc[:, nl // 2], vc[:, nl // 2]
    checks["decode_attention"] = bf16_check(
        "decode_attention", DA.decode_attention(qd, ks_, vs_, vl),
        DA.decode_attention(qd, ks_, vs_, vl, impl="ref"),
        DA.decode_attention(qd.float(), ks_.float(), vs_.float(), vl,
                            impl="ref"))
    qs, kcs, vcs = rnd(5, 1, h, d, dt=f32), rnd(5, 2, 40, hkv, d, dt=f32), \
        rnd(5, 2, 40, hkv, d, dt=f32)
    vls = torch.tensor([0, 1, 17, 39, 40], dtype=torch.int32, device=dev)
    f32d = max_diff(DA.decode_attention(qs, kcs[:, 1], vcs[:, 1], vls),
                    DA.decode_attention(qs, kcs[:, 1], vcs[:, 1], vls,
                                        impl="ref"))
    if f32d > F32_TOL:
        fail(f"decode_attention differs from its plain version in float32 "
             f"by {f32d} (> {F32_TOL})")
    tm = time_turns(da_cases(qd, [kc[:, i] for i in range(nl)],
                             [vc[:, i] for i in range(nl)], vl))
    res["decode_attention"] = dict(
        tm, max_abs_err=checks["decode_attention"]["bf16"], f32_err=f32d,
        bound=da_bound(qd, hkv, vl), shape=[n, s, h, d],
        splits=DA.split_count(n * hkv, s))
    HOST["decode_attention"] = host_us(
        lambda _: DA.decode_attention(qd, ks_, vs_, vl))
    del kc, vc
    # a short batch takes the split-K route: 2 sequences of 2048 keys,
    # 6 (sequence, kv head) blocks, over 30 cold layer slices
    ns, ss = 2, 2048
    qd = rnd(ns, 1, h, d, dt=bf)
    kc, vc = rnd(ns, nl, ss, hkv, d, dt=bf), rnd(ns, nl, ss, hkv, d, dt=bf)
    vl = torch.tensor([ss, ss - 301], dtype=torch.int32, device=dev)
    ks_, vs_ = kc[:, nl // 2], vc[:, nl // 2]
    checks["decode_attention_split"] = bf16_check(
        "decode_attention split-K", DA.decode_attention(qd, ks_, vs_, vl),
        DA.decode_attention(qd, ks_, vs_, vl, impl="ref"),
        DA.decode_attention(qd.float(), ks_.float(), vs_.float(), vl,
                            impl="ref"))
    tm = time_turns(da_cases(qd, [kc[:, i] for i in range(nl)],
                             [vc[:, i] for i in range(nl)], vl))
    res["decode_attention"]["short_batch"] = dict(
        tm, max_abs_err=checks["decode_attention_split"]["bf16"],
        bound=da_bound(qd, hkv, vl), shape=[ns, ss, h, d],
        splits=DA.split_count(ns * hkv, ss))
    del kc, vc
    say("attn " + " ".join(
        f"{k}:err={v['max_abs_err']},ms={v['ms']:.5f},"
        f"plain_ms={v['plain_ms']:.5f},bound_ms={v['bound'][0]:.5f},"
        f"sdpa_ms={v['sdpa_ms']:.5f}"
        + (f",before_ms={v['before_ms']:.5f}" if "before_ms" in v else "")
        + f",host_us={HOST[k]:.1f}" for k, v in res.items())
        + "; K4 bf16 "
        f"{100 * checks['flash_attention_bf16']['limit_share']:.1f}% of its "
        f"limit (planted fault "
        f"{checks['flash_attention_bf16']['planted_share']:.1f}x); K3 bf16 "
        f"{100 * checks['decode_attention']['f32_limit_share']:.1f}% "
        f"(prefill [{b}, {s}], decode {n} x {s} keys over {nl} layers)")
    fa = res["flash_attention"]
    say(f"attn flash_attention f32 issues {fa['tile_flops'] / 1e9:.4f} "
        f"GFLOP, {fa['tile_flops'] / fa['exact_flops']:.3f}x the exact "
        f"causal count, at {fa['tile_flops'] / fa['ms'] / 1e9:.2f} TFLOP/s "
        f"({100 * fa['tile_flops'] / fa['ms'] / 1e-3 / F32_FLOPS:.1f}% of "
        f"the float32 peak)")
    sb = res["decode_attention"]["short_batch"]
    say(f"attn decode_attention short batch [{ns} x {ss} keys, "
        f"{sb['splits']} splits]: ms={sb['ms']:.5f},"
        f"plain_ms={sb['plain_ms']:.5f},bound_ms={sb['bound'][0]:.5f},"
        f"sdpa_ms={sb['sdpa_ms']:.5f}"
        + (f",before_ms={sb['before_ms']:.5f}" if "before_ms" in sb else "")
        + f"; K4 bf16 map cache "
        f"{100 * checks['flash_attention_bf16']['map_cache_share']:.1f}% of "
        f"its limit")
    return res, checks


@contextlib.contextmanager
def f32_census(tally: dict, path: str):
    """Tallies the float32 K4's launches inside the span by ``(path, q
    shape, k shape, knobs)``: ``FA.launch`` is wrapped for the span and
    calls through, so its own counter counts as ever."""
    from repro_torch.kernels.flash_attention import ops as FA
    launch = FA.launch

    def counted(q, k, v, out, **kw):
        if q.dtype == torch.float32:
            key = (path, tuple(q.shape), tuple(k.shape),
                   tuple(sorted(kw.items())))
            tally[key] = tally.get(key, 0) + 1
        return launch(q, k, v, out, **kw)
    FA.launch = counted
    try:
        yield
    finally:
        FA.launch = launch


def phase_f32_paths(dev, tally: dict, launched: int) -> dict:
    """The float32 K4 at every shape and knob set of its main-path
    launches (``f32_census`` over the float32 smoke paths): held against
    its plain version within F32_TOL on random inputs of that shape, and
    the shape with the most launches of each path timed (``f32_row``)."""
    from repro_torch.kernels.flash_attention import ops as FA
    if sum(tally.values()) != launched:
        fail(f"the census saw {sum(tally.values())} float32 flash_attention "
             f"launches, its counter {launched}")
    gen = torch.Generator(dev).manual_seed(13)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    out = dict(launches={}, shapes=[], timed={})
    for (path, qs, ks, knobs), n in sorted(tally.items(),
                                           key=lambda x: -x[1]):
        kw = dict(knobs)
        q, k, v = rnd(*qs), rnd(*ks), rnd(*ks)
        err = max_diff(FA.flash_attention(q, k, v, **kw),
                       FA.flash_attention(q, k, v, impl="ref", **kw))
        if err > F32_TOL:
            fail(f"flash_attention differs from its plain version in "
                 f"float32 by {err} (> {F32_TOL}) at {path}'s {qs} / {ks} "
                 f"{kw}")
        out["launches"][path] = out["launches"].get(path, 0) + n
        out["shapes"].append(dict(path=path, q=list(qs), k=list(ks), **kw,
                                  launches=n, max_abs_err=err))
        if path in out["timed"]:
            continue
        if not (kw["causal"] and kw["q_offset"] == 0
                and not kw["logits_soft_cap"] and qs[1] == ks[1]
                == kw["seq_k_valid"]):
            fail(f"{path}'s busiest float32 flash_attention shape {qs} "
                 f"{kw} is not a full causal prefill, which f32_row times")
        out["timed"][path] = f32_row(q, k, v, err)
    out["max_abs_err"] = max(x["max_abs_err"] for x in out["shapes"])
    say("f32-paths flash_attention float32 launches " + " ".join(
        f"{p}={n}" for p, n in out["launches"].items())
        + f", {len(out['shapes'])} shapes held to the plain version (worst "
        f"{out['max_abs_err']}); busiest: " + "; ".join(
            f"{p} {r['shape']} Hkv {t['k'][2]} x{t['launches']} "
            f"ms={r['ms']:.5f},plain_ms={r['plain_ms']:.5f},"
            f"bound_ms={r['bound'][0]:.6f},sdpa_ms={r['sdpa_ms']:.5f}"
            + (f",before_ms={r['before_ms']:.5f}" if "before_ms" in r
               else "")
            for p, r in out["timed"].items()
            for t in [next(x for x in out["shapes"] if x["path"] == p)]))
    return out


def phase_lm_small(dev):
    """``mcts_decode_batch`` on the float32 smoke config: the card's tokens
    equal the CPU's, for the fused wave and the lockstep select."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as TT
    from repro_torch.serving import mcts_decode_batch
    cfg = get_smoke_config(LM_ARCH)
    params = TT.init(cfg, seed=LM_SEED, device="cpu")
    prompts = lm_prompts(cfg.vocab_size, LM_SMALL)
    out = {}
    for ws in ("mega", "lockstep"):
        dc = lm_dcfg(LM_SMALL, wave_select=ws)
        card = mcts_decode_batch(cfg, params, prompts,
                                 LM_SMALL["new_tokens"], dc, device=dev)
        cpu = mcts_decode_batch(cfg, params, prompts,
                                LM_SMALL["new_tokens"], dc, device="cpu")
        if card != cpu:
            fail(f"lm small {ws}: card tokens {card} != CPU {cpu}")
        out[ws] = card
    say(f"lm-small {cfg.name} card == CPU tokens ({len(prompts)} ragged "
        f"prompts, {LM_SMALL['new_tokens']} tokens, mega and lockstep)")
    return out


def lm_buffers(cfg, lm, dev):
    from repro_torch.serving.mcts_decode import _pad_prompts
    prompts = lm_prompts(cfg.vocab_size, lm)
    buf, lens = _pad_prompts(prompts, lm["new_tokens"])
    return prompts, torch.from_numpy(buf).to(dev), \
        torch.from_numpy(lens).to(dev)


def lm_bes_check(cfg, params, buf, lens, dc, dev, warm=None) -> dict:
    """K1b at the LM path's shapes: the 16 roots' pipelined search (PUCT
    rows, A=4, 16 lanes, depth 8, 66-row arena) advanced LM_BES_TICKS ticks
    by the plain path, then one Backup -> Expand -> Select tick by the
    kernel and by its plain version on clones of that snapshot.  Integer
    planes and states must be equal, ``value`` / ``prior`` within
    VALUE_RTOL.  With ``warm = (arena, alive)`` the search starts from
    that carried arena (``tree_reuse``: its capacity, ``next_free > 1``),
    and the clones share the state planes (~13 GB of KV caches a copy;
    neither side writes them).  Returns the largest float difference, the
    kernel's and the plain version's times on that snapshot (in turns)
    and the snapshot's largest ``next_free``."""
    import dataclasses
    from repro_torch.core import stages as S
    from repro_torch.core.tree import init_tree
    from repro_torch.kernels.search_wave import ops as W
    from repro_torch.serving.mcts_decode import _domain
    b, lanes = LM_FULL["batch"], LM_FULL["lanes"]
    sp = dc.search_config().params
    dom = _domain(cfg, params, buf, dc, prompt_len=lens)
    n_waves = -(-LM_FULL["budget"] // lanes)
    nodes, clone = n_waves * lanes + 2, clone_tree
    if warm is not None:
        nodes, clone = warm[0].max_nodes, clone_planes
        dom = dataclasses.replace(dom, root_arena=warm[0],
                                  root_arena_alive=warm[1])
    tree = init_tree(dom, nodes, root_state=dom.root_state())
    dom = dataclasses.replace(dom, root_arena=None, root_arena_alive=None)
    se = S.empty_selection(sp, b, lanes, dev)
    ep = S.empty_expansion(sp, tree, lanes)
    pb = S.empty_playout(sp, b, lanes, dom.num_actions, dev)
    draws = dom.sample_draws((b, LM_BES_TICKS, lanes), device=dev)
    for t in range(LM_BES_TICKS):
        tree, se, ep, pb = W.pipeline_tick(tree, dom, sp, lanes, True, se, ep,
                                           pb, draws[:, t], impl="ref")
    del ep
    if not (sp.puct and bool(pb["valid"].all()) and bool(se["valid"].all())):
        fail("lm bes: the snapshot has no full PUCT backup and expand wave")
    t1, nse1, es1 = W.bes(clone(tree), sp, lanes, True, se, pb,
                          impl="cuda")
    t2, nse2, es2 = W.bes(clone(tree), sp, lanes, True, se, pb,
                          impl="ref")
    torch.cuda.synchronize()
    err = compare_trees("lm bes", t1, t2)
    compare_bufs("lm bes sel", nse1, nse2, SEL_KEYS)
    compare_bufs("lm bes es", es1, es2, ES_KEYS)
    se_leaf = se["leaf"].to(torch.int32).contiguous()
    se_valid = se["valid"].contiguous()
    pbk = W.pack_pb(tree, sp, pb)
    fresh = dict(setup=lambda: clone_planes(tree))
    tm = time_turns({
        "bes": (lambda t: W.launch_bes(t, sp, lanes, True, se_leaf,
                                       se_valid, pbk), fresh),
        "bes/plain": (lambda t: W.bes(t, sp, lanes, True, se, pb,
                                      impl="ref"), fresh)})
    return {"max_abs_err": err, "ms": tm["bes"], "plain_ms": tm["bes/plain"],
            "next_free": int(tree.next_free.max())}


def phase_lm_full(dev):
    """The LM main path at full width: smollm-135m (random bf16 weights)
    decoding 16 ragged prompts, every token by a 64-playout search.
    Checks launch counts, tokens, one search's invariants,
    prefill-then-step against a prefill of the longer prompt (and that a
    step planted one position off fails that check), and K1b against its
    plain version at this path's shapes."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.tree import check_consistency
    from repro_torch.models import transformer as TT
    from repro_torch.models.base import seq_prefill, seq_step
    from repro_torch.search import search_batch
    from repro_torch.serving import mcts_decode_batch
    from repro_torch.serving.mcts_decode import _domain
    cfg, lm = get_config(LM_ARCH), LM_FULL
    params = TT.init(cfg, seed=LM_SEED, device=dev)
    prompts, buf, lens = lm_buffers(cfg, lm, dev)
    dc = lm_dcfg(lm)
    n_new, b = lm["new_tokens"], lm["batch"]
    mcts_decode_batch(cfg, params, prompts, 1, dc, device=dev)     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                       # the LM main path starts here
    t0 = time.perf_counter()
    toks = mcts_decode_batch(cfg, params, prompts, n_new, dc, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_launches()                # read just after it
    peak = torch.cuda.max_memory_allocated()
    ticks = -(-lm["budget"] // lm["lanes"]) + 3
    want = {"flash_attention_bf16": n_new * cfg.n_layers,
            "decode_attention": n_new * ticks * lm["rollout_len"]
            * cfg.n_layers,
            "bes": n_new * ticks}
    for k, w in want.items():
        if counts[k] != w:
            fail(f"lm full: kernel {k} launched {counts[k]} times, the "
                 f"path implies {w}")
    if any(len(t) != n_new or not all(0 <= x < cfg.vocab_size for x in t)
           for t in toks):
        fail("lm full: tokens missing or outside the vocabulary")
    # one search of the first token, kept: visits, drained planes
    scfg = dataclasses.replace(dc.search_config(), keep_tree=True)
    res = search_batch([_domain(cfg, params, buf[i], dc, prompt_len=lens[i])
                        for i in range(b)], scfg, 0, device=dev)
    tree = res.tree
    if not bool((tree.visits[:, 0] == lm["budget"]).all()):
        fail(f"lm full: root visits != {lm['budget']}")
    cons = check_consistency(tree)
    for k in ("vloss_drained", "unobs_drained", "parents_valid",
              "visit_flow"):
        if not bool(cons[k].all()):
            fail(f"lm full: invariant {k} broken")
    top = torch.sort(tree.state["logits"][:, 0], dim=-1, descending=True,
                     stable=True)[1][:, :lm["num_actions"]]
    first = top.gather(1, res.best_action.long()[:, None])[:, 0]
    if first.tolist() != [t[0] for t in toks]:
        fail("lm full: the kept search chose other first tokens")
    nodes_mean = float(cons["nodes"].float().mean())
    first_planes = {f: getattr(tree, f).cpu() for f in INT_PLANES}
    del res, tree
    # prefill-then-step == a prefill of the prompt one token longer
    s = lm_max_len(lm)
    full = torch.zeros((b, s), dtype=torch.int32, device=dev)
    full[:, :buf.shape[1]] = buf
    lg, cache = seq_prefill(cfg, params, full, lens)
    tok = first.to(torch.int32)
    # planted faults first (on clones: the step writes K/V in place): the
    # new token's K/V and angle one position late, or one early
    planted = {}
    for name, pos in (("late", lens + 1), ("early", lens - 1)):
        lgp, _ = seq_step(cfg, params, {k: v.clone() for k, v in
                                        cache.items()}, tok, pos)
        planted[name] = lgp
    lg1, _ = seq_step(cfg, params, cache, tok, lens)
    rows = torch.arange(b, device=dev)
    full[rows, lens.long()] = tok
    lg2, _ = seq_prefill(cfg, params, full, lens + 1)
    step_err = max_diff(lg1, lg2)
    if step_err > STEP_TOL:
        fail(f"lm full: prefill-then-step differs from the longer prefill "
             f"by {step_err} (> {STEP_TOL})")
    planted = {k: max_diff(v, lg2) for k, v in planted.items()}
    if min(planted.values()) <= STEP_TOL:
        fail(f"lm full: a step planted one position off reads {planted}, "
             f"within STEP_TOL {STEP_TOL}: the check cannot see it")
    del cache
    lm_bes = lm_bes_check(cfg, params, buf, lens, dc, dev)
    bes_err = lm_bes["max_abs_err"]
    run = {"seconds": secs, "tokens_per_s": b * n_new / secs,
           "playouts_per_s": b * n_new * lm["budget"] / secs,
           "peak_mem_bytes": peak, "launches": counts,
           "launches_expected": want, "step_vs_prefill_max_abs": step_err,
           "planted_step_max_abs": planted,
           "logit_abs_max": float(lg2.abs().max()),
           "logit_abs_mean": float(lg2.abs().mean()),
           "bes_max_abs_err": bes_err, "bes_ms": lm_bes["ms"],
           "bes_plain_ms": lm_bes["plain_ms"], "nodes_mean": nodes_mean,
           "tokens": toks}
    say(f"lm-full {cfg.name} {b} prompts x {n_new} tokens in {secs:.3f} s: "
        f"{run['tokens_per_s']:.2f} tokens/s, {run['playouts_per_s']:.1f} "
        f"playouts/s, peak {peak / 2**30:.2f} GiB; launches "
        + ",".join(f"{k}={counts[k]}" for k in want)
        + f"; step vs prefill {step_err} (planted one off: "
        f"{planted['late']} late, {planted['early']} early); bes at these "
        f"shapes == plain (max float diff {bes_err}), {lm_bes['ms']:.5f} ms "
        f"(plain {lm_bes['plain_ms']:.3f})")
    return run, params, first_planes


def phase_lm_profile(dev, params):
    """Where one token's search goes on the LM path (table in
    ``chiprun_out/profile_lm.txt``)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import make_batched_searcher
    cfg, lm = get_config(LM_ARCH), LM_FULL
    _, buf, lens = lm_buffers(cfg, lm, dev)
    step = make_batched_searcher(cfg, params, lm_dcfg(lm), lm["batch"],
                                 device=dev)
    summary, table = profile_one(
        f"lm {cfg.name}, one token's search over {lm['batch']} prompts",
        lambda: step(buf, lens))
    write_out("profile_lm.txt", table)
    return summary or {}


# ---------------------------------------------------------------------------
# the cross-token serving carry: kv_splice and tree_reuse
# ---------------------------------------------------------------------------
CARRIES = {"splice": dict(kv_splice=True), "reuse": dict(tree_reuse=True),
           "both": dict(kv_splice=True, tree_reuse=True)}
CARRY_REPS = 5    # the reroot's and the commit step's timed calls (median)


def carry_trace(cfg, params, prompts, dc, device, n_new) -> list:
    """The ``ReusableSearcher`` threaded over ``n_new`` tokens: each
    token's choices and the carried arena's integer planes after it."""
    import numpy as np
    from repro_torch.serving import make_batched_searcher
    from repro_torch.serving.mcts_decode import _pad_prompts
    buf, lens = _pad_prompts(prompts, n_new)
    rows = np.arange(len(prompts))
    s = make_batched_searcher(cfg, params, dc, len(prompts), device=device)
    c = s.init_carry(buf.shape[1])
    for i in rows:
        c = s.admit(c, int(i), buf[i], int(lens[i]))
    out = []
    for t in range(n_new):
        toks, c = s.step(buf, lens, t, c)
        toks = toks.cpu()
        ar = c.get("arena")
        out.append((toks.tolist(), {} if ar is None else {
            f: getattr(ar, f).cpu() for f in INT_PLANES}))
        buf[rows, lens] = toks.numpy()
        lens = lens + 1
    return out


def phase_carry_small(dev):
    """The carries on the float32 smoke configs: on smollm-smoke the
    searcher (``kv_splice``, ``tree_reuse``, both) and ``mcts_decode_batch``
    make the CPU's tokens on the card, the carried integer planes equal
    after every token; the mcts engine with both carries on smollm-smoke,
    rwkv6-smoke and zamba2-smoke emits the CPU's token streams."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.base import get_family
    from repro_torch.serving import mcts_decode_batch
    cfg = get_smoke_config(LM_ARCH)
    params = get_family(cfg).init(cfg, seed=LM_SEED, device="cpu")
    prompts = lm_prompts(cfg.vocab_size, LM_SMALL)
    n_new = LM_SMALL["new_tokens"]
    out = {}
    for name, knobs in CARRIES.items():
        dc = lm_dcfg(LM_SMALL, wave_select="mega", **knobs)
        card, cpu = (carry_trace(cfg, params, prompts, dc, d, n_new)
                     for d in (dev, "cpu"))
        for t, ((tk, pk), (tc, pc)) in enumerate(zip(card, cpu)):
            if tk != tc:
                fail(f"carry small {name} token {t}: card {tk} != CPU {tc}")
            for f in pc:
                if not torch.equal(pk[f], pc[f]):
                    fail(f"carry small {name} token {t}: carried plane {f} "
                         "differs between the card and the CPU")
        toks = mcts_decode_batch(cfg, params, prompts, n_new, dc, device=dev)
        if toks != [list(x) for x in zip(*(tk for tk, _ in card))]:
            fail(f"carry small {name}: mcts_decode_batch {toks} != the "
                 "searcher's tokens")
        out[name] = toks
    for arch in (LM_ARCH,) + REC_ARCHS:
        cfg = get_smoke_config(arch)
        params = get_family(cfg).init(cfg, seed=REC_SEED, device="cpu")
        streams = []
        for device in (dev, "cpu"):
            eng, reqs = rec_engine(cfg, params, REC_SMALL, "mcts", device,
                                   **CARRIES["both"])
            eng.run_until_drained()
            streams.append({r.uid: r.out_tokens for r in reqs})
        if streams[0] != streams[1]:
            fail(f"carry small {arch} engine: card {streams[0]} != CPU "
                 f"{streams[1]}")
        out[f"engine/{arch}"] = streams[0]
    say(f"carry-small card == CPU: {LM_ARCH} smoke searcher and "
        f"mcts_decode_batch ({len(prompts)} ragged prompts x {n_new} "
        "tokens; kv_splice, tree_reuse, both; tokens and carried integer "
        f"planes), mcts engine with both carries on {LM_ARCH}, "
        f"{', '.join(REC_ARCHS)} smoke ({REC_SMALL['requests']} requests "
        f"over {REC_SMALL['max_batch']} slots)")
    return out


def carried_visits(carry) -> torch.Tensor:
    """[B] visits of the child each slot committed, where the carry makes
    it the next root (alive, child expanded), else 0."""
    ar, act = carry["arena"], carry["action"].long()
    child = ar.children[:, 0].gather(1, act[:, None])[:, 0]
    n = ar.visits.gather(1, child.clamp_min(0).long()[:, None])[:, 0]
    return torch.where(carry["alive"] & (child >= 0), n, 0)


def fresh_logits(cfg, params, eng, extra: int):
    """Next-token logits of a prefill of every slot's current prefix."""
    from repro_torch.models.base import seq_prefill
    dev = eng.device
    full = torch.zeros((eng.prefix_buf.shape[0],
                        eng.prefix_buf.shape[1] + extra), dtype=torch.int32,
                       device=dev)
    full[:, :eng.prefix_buf.shape[1]] = torch.from_numpy(eng.prefix_buf)
    lens = torch.from_numpy(eng.prefix_len).to(dev)
    return seq_prefill(cfg, params, full, lens)[0]


def event_ms(fn, reps=CARRY_REPS, setup=None):
    """Median device time of ``fn(setup())`` between two CUDA events, and
    the median host time of the call (no synchronise inside), ms."""
    dev_ms, host_ms = [], []
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        t0 = time.perf_counter()
        out = fn(arg)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        b.record()
        torch.cuda.synchronize()
        dev_ms.append(a.elapsed_time(b))
        del out, arg
    return statistics.median(dev_ms), statistics.median(host_ms)


@contextlib.contextmanager
def attn_capture(calls: list, keep):
    """Keeps the operands and knobs of every K3 / K4 wrapper call inside
    the span for which ``keep(name, q, args)`` holds, and a copy of its
    output: the wrappers are wrapped for the span and call through, so
    their counters count as ever.  The operands are kept as they are, not
    copied: each is a fresh activation or, for K3, a layer slice of a
    cache that no later call of the span writes (a change would show as a
    disagreement in the check, never hide one)."""
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA
    mods = ((DA, "decode_attention"), (FA, "flash_attention"))
    fns = [getattr(m, n) for m, n in mods]
    def wrap(name, fn):
        def call(q, *args, **kw):
            out = fn(q, *args, **kw)
            if keep(name, q, args):
                calls.append((q, args, kw, out.clone()))
            return out
        return call
    for (m, n), fn in zip(mods, fns):
        setattr(m, n, wrap(n, fn))
    try:
        yield
    finally:
        for (m, n), fn in zip(mods, fns):
            setattr(m, n, fn)


def carry_k4_check(what, calls) -> dict:
    """The bf16 K4's launches of the admission prefills (``attn_capture``),
    each output held to ``rounded_p_limit`` on its own operands and knobs
    and set beside the plain version in bf16; on the first causal one, a
    planted fault (the diagonal one position late) must read above the
    limit."""
    from repro_torch.kernels.flash_attention import ops as FA
    out = {"calls": len(calls), "limit_share": 0.0, "max_abs_err": 0.0,
           "shapes": sorted({str(list(q.shape)) for q, *_ in calls})}
    first = next(i for i, c in enumerate(calls) if c[2].get("causal", True))
    for i, (q, (k, v), kw, got) in enumerate(calls):
        planted = None if i != first else FA.flash_attention(
            q, k, v, **dict(kw, q_offset=kw.get("q_offset", 0) + 1))
        r = rounded_check(what, got, q, k, v, planted=planted, **kw)
        out["limit_share"] = max(out["limit_share"], r["limit_share"])
        if planted is not None:
            out["planted_share"] = r["planted_share"]
        out["max_abs_err"] = max(out["max_abs_err"], max_diff(
            got, FA.flash_attention(q, k, v, impl="ref", **kw)))
    return out


def carry_k3_check(what, calls) -> dict:
    """K3's launches of one step (``attn_capture``), each output held
    against the plain version on its own operands in bf16 and in float32
    (``bf16_check``); then the first layer's operands again with valid
    lengths from 0 to Sk, so that the split-K route meets empty and
    one-tile splits at the step's shape."""
    from repro_torch.kernels.decode_attention import ops as DA
    out = {"calls": len(calls), "bf16": 0.0, "f32_limit_share": 0.0}
    for q, (k, v, vl), _, got in calls:
        r = bf16_check(what, got, DA.decode_attention(q, k, v, vl,
                                                      impl="ref"),
                       DA.decode_attention(q.float(), k.float(), v.float(),
                                           vl, impl="ref"))
        out["bf16"] = max(out["bf16"], r["bf16"])
        out["f32_limit_share"] = max(out["f32_limit_share"],
                                     r["f32_limit_share"])
    q, (k, v, vl), _, _ = calls[0]
    n, s = q.shape[0], k.shape[1]
    edge = [e for e in (0, 1, 2, 31, 32, 33, 63, 64, 65, 95, 137, 138, 139,
                        200) if e < s - 1] + [s - 1, s]
    ve = torch.tensor((edge * -(-n // len(edge)))[:n], dtype=torch.int32,
                      device=q.device)
    r = bf16_check(what + " edge lengths", DA.decode_attention(q, k, v, ve),
                   DA.decode_attention(q, k, v, ve, impl="ref"),
                   DA.decode_attention(q.float(), k.float(), v.float(), ve,
                                       impl="ref"))
    out.update(shape=list(q.shape), keys=s,
               splits=DA.split_count(n * k.shape[2], s),
               valid=[int(vl.min()), int(vl.max())], edge_bf16=r["bf16"])
    out["bf16"] = max(out["bf16"], r["bf16"])
    return out


def phase_lm_carry(dev, params, cold: dict, card: str) -> dict:
    """The LM main path through ``ServingEngine(decode="mcts")`` at full
    width: smollm-135m (random bf16 weights, seed 0) serving LM_FULL's 16
    ragged prompts x 8 tokens cold, with ``kv_splice``, and with
    ``kv_splice`` + ``tree_reuse``, one run each in that order.  Each run
    is one main path: counts set to 0 just before the admissions, and
    summed over the admissions and the engine steps only (the checks
    between steps launch kernels that do not count).  Holds the launch
    counts the path implies (under ``kv_splice`` K4 bf16 once per layer
    per admission and never per token, K3 one commit step per token on
    top of the search's); the first token against the cold
    ``mcts_decode_batch`` run's and, under ``kv_splice``, against a cold
    search from the admitted roots (integer planes too, with
    ``tree_reuse``); after every commit the carried logits against a
    prefill of the longer prefix (a commit planted one position off must
    read above STEP_TOL); the arena invariants per token; K1b against its
    plain version on the rerooted arena after token 1.  Under
    ``kv_splice`` the main path's own K4 launches of the admissions
    (``[1, S, H, D]``) and K3 launches of every commit step (``[B, 1, H,
    D]`` over each layer's cache slice at ``prefix_len + 1``) are kept
    (``attn_capture``: the operands by reference, one copy of the output
    inside the timed spans) and held against the plain versions on the
    same operands (``carry_k4_check`` after the run, ``carry_k3_check``
    after each step).  Times: tokens/s and each step's seconds, the
    admissions', TTFT, one batched reroot (host and device) and the
    commit step."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.arena import reroot
    from repro_torch.core.domains.lm_decode import top_k
    from repro_torch.core.tree import check_consistency
    from repro_torch.models.base import seq_step
    from repro_torch.search import search_stacked
    from repro_torch.serving import EngineConfig, Request, ServingEngine
    from repro_torch.serving.mcts_decode import _domain
    cfg, lm = get_config(LM_ARCH), LM_FULL
    prompts, buf, _ = lm_buffers(cfg, lm, dev)
    plens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                         device=dev)
    n_new, b, L = lm["new_tokens"], lm["batch"], cfg.n_layers
    ticks = -(-lm["budget"] // lm["lanes"]) + 3
    extra = lm["search_depth"] + lm["rollout_len"]
    search_k3 = ticks * lm["rollout_len"] * L
    runs, total = {}, {}
    for name, knobs in (("cold", {}), ("splice", CARRIES["splice"]),
                        ("both", CARRIES["both"])):
        what = f"lm carry {name}"
        dc = lm_dcfg(lm, **knobs)
        splice, reuse = dc.kv_splice, dc.tree_reuse
        want_step = {"flash_attention_bf16": 0 if splice else L,
                     "decode_attention": search_k3 + (L if splice else 0),
                     "bes": ticks}
        eng = ServingEngine(cfg, params, EngineConfig(
            max_batch=b, max_seq=buf.shape[1], decode="mcts", mcts=dc),
            device=dev)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=np.asarray(p, np.int32),
                               max_new_tokens=n_new))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        adm, k3 = [], []
        reset_launches()                   # this main path starts here
        t0 = time.perf_counter()
        with attn_capture(adm, lambda n, q, a: n == "flash_attention"):
            eng._admit_loop()              # the 16 admissions
        torch.cuda.synchronize()
        admit_s = time.perf_counter() - t0
        counts = all_launches()            # read just after them
        if counts["flash_attention_bf16"] != (b * L if splice else 0) \
                or len(adm) != counts["flash_attention_bf16"]:
            fail(f"{what}: admissions launched flash_attention_bf16 "
                 f"{counts['flash_attention_bf16']} times ({len(adm)} "
                 "captured)")
        s = eng._mcts_search
        if splice:
            root = {k: v.clone() for k, v in eng._carry["cache"].items()}
            root_logits = eng._carry["logits"].clone()
        step_s, step_err, reused, per_token = [], [], [], []
        nf_max, planted, bes, pre_cache = 0, None, None, None
        for t in range(n_new):
            carried = torch.zeros(b, dtype=torch.int32, device=dev)
            if reuse and eng._carry["arena"] is not None:
                carried = carried_visits(eng._carry)
            lens = torch.from_numpy(eng.prefix_len.copy()).to(dev)
            kv_ptr = eng._carry["cache"]["k"].untyped_storage().data_ptr() \
                if splice else None
            before = all_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            com = []    # the commit step's K3 calls: on the carried cache
            with attn_capture(com, lambda n, q, a: splice
                              and n == "decode_attention"
                              and a[0].untyped_storage().data_ptr()
                              == kv_ptr):
                eng.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            after = all_launches()         # read just after the step
            delta = {k: after[k] - before[k] for k in after}
            for k in counts:
                counts[k] += delta[k]
            per_token.append({k: delta[k] for k in want_step})
            for k, w in want_step.items():
                if delta[k] != w:
                    fail(f"{what} token {t}: kernel {k} launched {delta[k]} "
                         f"times, the path implies {w}")
            # -- checks beside the main path (not counted) ---------------
            if len(com) != (L if splice else 0):
                fail(f"{what} token {t}: {len(com)} decode_attention calls "
                     f"on the carried cache, the commit step makes {L}")
            if com:
                k3.append(carry_k3_check(
                    f"{what} token {t} commit decode_attention", com))
            del com
            carry = eng._carry
            if t == 0:
                first = [eng.slots[i].out_tokens[0] for i in range(b)]
                if first != [x[0] for x in cold["tokens"]]:
                    fail(f"{what}: first tokens {first} != the cold run's "
                         f"{[x[0] for x in cold['tokens']]}")
            if splice and t == 0:
                # a cold search from the admitted roots, this arena size
                dom = _domain(cfg, params, buf, dc, prompt_len=plens,
                              root_cache=root, root_logits=root_logits)
                ref = search_stacked(dom, b, dataclasses.replace(
                    dc.search_config(), keep_tree=True), 0, device=dev)
                _, top = top_k(root_logits, lm["num_actions"])
                if top.gather(1, ref.best_action.long()[:, None])[:, 0] \
                        .tolist() != first:
                    fail(f"{what}: the first tokens differ from a cold "
                         "search's from the admitted roots")
                for f in INT_PLANES if reuse else ():
                    got = getattr(carry["arena"], f)
                    cf = cold["first_planes"][f].to(dev)
                    if not torch.equal(got, getattr(ref.tree, f)):
                        fail(f"{what}: the first search's plane {f} "
                             "differs from a cold search's")
                    if not torch.equal(got if got.dim() == 1
                                       else got[:, :cf.shape[1]], cf):
                        fail(f"{what}: the first search's plane {f} "
                             "differs from the cold run's")
                del ref, dom, root, root_logits
            if splice:
                toks = torch.tensor([eng.slots[i].out_tokens[-1]
                                     for i in range(b)], dtype=torch.int32,
                                    device=dev)
                fresh = fresh_logits(cfg, params, eng, extra)
                step_err.append(max_diff(carry["logits"], fresh))
                if step_err[-1] > STEP_TOL:
                    fail(f"{what} token {t}: the carried logits differ from "
                         f"a prefill of the longer prefix by {step_err[-1]} "
                         f"(> {STEP_TOL})")
                if t == 1:                 # a commit planted one off
                    planted = {}
                    for k, pos in (("late", lens + 1), ("early", lens - 1)):
                        lg, _ = seq_step(cfg, params, {
                            kk: v.clone() for kk, v in pre_cache.items()},
                            toks, pos)
                        planted[k] = max_diff(lg, fresh)
                    if min(planted.values()) <= STEP_TOL:
                        fail(f"{what}: a commit planted one position off "
                             f"reads {planted}, within STEP_TOL {STEP_TOL}")
                    pre_cache = None
                if t == 0:
                    pre_cache = {k: v.clone()
                                 for k, v in carry["cache"].items()}
            if reuse:
                ar = carry["arena"]
                cons = check_consistency(ar)
                for k in ("vloss_drained", "unobs_drained", "parents_valid"):
                    if not bool(cons[k].all()):
                        fail(f"{what} token {t}: invariant {k} broken")
                nf_max = max(nf_max, int(ar.next_free.max()))
                if nf_max > dc.resolved_arena_nodes:
                    fail(f"{what} token {t}: next_free {nf_max} > "
                         f"{dc.resolved_arena_nodes}")
                reused.append(int((carried > 0).sum()))
                if not torch.equal(ar.visits[:, 0], carried + lm["budget"]):
                    fail(f"{what} token {t}: root visits "
                         f"{ar.visits[:, 0].tolist()} != carried "
                         f"{carried.tolist()} + {lm['budget']}")
                if t == 0:                 # K1b from the rerooted arena
                    lens1 = torch.from_numpy(eng.prefix_len.copy()).to(dev)
                    bufs = torch.from_numpy(eng.prefix_buf.copy()).to(dev)
                    warm_dom = _domain(cfg, params, bufs, dc,
                                       prompt_len=lens1)
                    ar, use = s._carried_arena(dict(carry), warm_dom, lens1)
                    bes = lm_bes_check(cfg, params, bufs, lens1, dc, dev,
                                       warm=(ar, use))
                del ar
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        # after the run, so that TTFT does not include it
        k4 = carry_k4_check(f"{what} admission flash_attention_bf16",
                            adm) if splice else None
        del adm
        stats = eng.stats.snapshot()
        if any(len(eng.slots[i].out_tokens) != n_new
               or not eng.slots[i].done for i in range(b)):
            fail(f"{what}: a request ended short of its budget")
        secs = admit_s + sum(step_s)
        run = {"seconds": secs, "tokens_per_s": b * n_new / secs,
               "admit_s": admit_s, "step_s": step_s,
               "ttft_p50_s": stats.get("serving/ttft_p50"),
               "peak_mem_bytes": peak, "launches": counts,
               "launches_per_token": per_token,
               "tokens": [list(eng.slots[i].out_tokens) for i in range(b)]}
        if splice:
            # the commit step alone, on a copy of the carried rows
            lens = torch.from_numpy(eng.prefix_len.copy()).to(dev)
            toks = torch.tensor([eng.slots[i].out_tokens[-1]
                                 for i in range(b)], dtype=torch.int32,
                                device=dev)
            cache = eng._carry["cache"]
            run["commit_step_ms"], run["commit_step_host_ms"] = event_ms(
                lambda c: seq_step(cfg, params, c, toks, lens),
                setup=lambda: {k: v.clone() for k, v in cache.items()})
            run.update(commit_vs_prefill_max_abs=step_err,
                       planted_commit_max_abs=planted,
                       k4_admission=k4, k3_commit=k3)
            del cache
        if reuse:
            ar, act = eng._carry["arena"], eng._carry["action"]
            run["reroot_ms"], run["reroot_host_ms"] = event_ms(
                lambda _: reroot(ar, act))
            run["arena_state_bytes"] = sum(v.numel() * v.element_size()
                                           for v in ar.state.values())
            run.update(arena_nodes=dc.resolved_arena_nodes,
                       next_free_max=nf_max, reused_slots=reused,
                       bes_max_abs_err=bes["max_abs_err"],
                       bes_ms=bes["ms"], bes_plain_ms=bes["plain_ms"],
                       bes_next_free=bes["next_free"])
            del ar, act
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        runs[name] = run
        del eng, s, carry
        torch.cuda.empty_cache()
    say("lm-carry " + "; ".join(
        f"{k}: {v['tokens_per_s']:.2f} tokens/s (admissions "
        f"{v['admit_s']:.3f} s, step median "
        f"{statistics.median(v['step_s']):.3f} s), TTFT p50 "
        f"{v['ttft_p50_s']:.3f} s, peak {v['peak_mem_bytes'] / 2**30:.2f} "
        "GiB, launches " + ",".join(f"{a}={n}" for a, n in
                                    v["launches"].items() if n)
        + (f", commit step {v['commit_step_ms']:.3f} ms (host "
           f"{v['commit_step_host_ms']:.3f}), commit vs prefill max "
           f"{max(v['commit_vs_prefill_max_abs'])} (planted "
           f"{v['planted_commit_max_abs']})" if "commit_step_ms" in v
           else "")
        for k, v in runs.items())
        + f"; mcts_decode_batch cold {cold['tokens_per_s']:.2f} tokens/s; "
        f"card {card}")
    attn_err = {
        "flash_attention_bf16": max(runs[k]["k4_admission"]["max_abs_err"]
                                    for k in ("splice", "both")),
        "decode_attention": max(x["bf16"] for k in ("splice", "both")
                                for x in runs[k]["k3_commit"])}
    say("lm-carry-attn " + "; ".join(
        f"{k}: K4 bf16 at admission {a['calls']} launches {a['shapes']} "
        f"held to the plain version ({100 * a['limit_share']:.1f}% of its "
        f"limit, planted fault {a['planted_share']:.1f}x, max abs vs bf16 "
        f"plain {a['max_abs_err']}); K3 at commit {len(c)} x "
        f"{c[0]['calls']} launches {c[0]['shape']} over {c[0]['keys']} "
        f"keys, {c[0]['splits']} splits, valid {c[0]['valid']} at token 0 "
        f"(max abs vs bf16 plain {max(x['bf16'] for x in c)}, "
        f"{100 * max(x['f32_limit_share'] for x in c):.1f}% of the f32 "
        f"limit; valid 0-{c[0]['keys']} "
        f"{max(x['edge_bf16'] for x in c)})"
        for k in ("splice", "both")
        for a, c in [(runs[k]["k4_admission"], runs[k]["k3_commit"])]))
    r = runs["both"]
    say(f"lm-carry-reroot one batched reroot of {b} x {r['arena_nodes']} "
        f"rows ({r['arena_state_bytes'] / 1e9:.2f} GB of state planes) "
        f"{r['reroot_ms']:.3f} ms device, {r['reroot_host_ms']:.3f} ms host; "
        f"next_free max {r['next_free_max']}; reused slots per token "
        f"{r['reused_slots']}; bes on the rerooted arena after token 1 "
        f"(next_free up to {r['bes_next_free']}) == plain (max float diff "
        f"{r['bes_max_abs_err']}), {r['bes_ms']:.5f} ms (plain "
        f"{r['bes_plain_ms']:.3f}); card {card}")
    return {"runs": runs, "launches": total, "attn_err": attn_err}


# ---------------------------------------------------------------------------
# the sharded paths: root-parallel search over a mesh of devices and
# processes, the elastic fault-tolerant driver, the LM searcher's mesh
# ---------------------------------------------------------------------------
SHARD_RUNS = [("pipeline", "mega", "loss", "independent"),
              ("tree", "mega", "wu", "running")]
SHARD_ENTRIES = 4     # in-process mesh entries on cuda:0
SHARD_SEED = 2000
FT_HOSTS, FT_CHUNK = 4, 16
FT_WATCHDOG_S = 0.5   # the stall run's watchdog (the stall lasts 3x)
LM_SHARD_ENTRIES = 3  # 16 slots padded to 18: two dead pad rows
LM_SHARD_TOKENS = 2


def hold_roots(what, got, want) -> str:
    """Every root of ``got`` against ``want``: visits, best action, stats,
    integer extras and the trees' integer planes exact; ``value`` (and the
    float extras and planes) bit-equal or within VALUE_RTOL.  Returns
    which."""
    for f in ("action_visits", "best_action"):
        if max_diff(getattr(got, f), getattr(want, f)) != 0:
            fail(f"{what}: {f} differs from the single-device run")
    for k in want.stats:
        if max_diff(got.stats[k], want.stats[k]) != 0:
            fail(f"{what}: stats {k} differs from the single-device run")
    floats = [(got.action_value, want.action_value)]
    for k, v in want.extras.items():
        if v.dtype.is_floating_point:
            floats.append((got.extras[k], v))
        elif max_diff(got.extras[k], v) != 0:
            fail(f"{what}: extras {k} differs from the single-device run")
    if (got.tree is None) != (want.tree is None):
        fail(f"{what}: tree kept on one side only")
    tree_d = 0.0 if want.tree is None else \
        compare_trees(what, got.tree, want.tree)
    rel = 0.0
    for a, b in floats:
        a, b = a.detach().cpu().double(), b.detach().cpu().double()
        r = float(((a - b).abs() / b.abs().clamp_min(1.0)).max()) \
            if b.numel() else 0.0
        if r > VALUE_RTOL:
            fail(f"{what}: value differs by {r} relative (> {VALUE_RTOL})")
        rel = max(rel, r)
    if rel == 0 and tree_d == 0:
        return "bit-equal"
    return f"within VALUE_RTOL (max rel {rel:.3g}, tree {tree_d:.3g})"


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_shard(dev):
    """``shard_search_batch`` (through ``search_batch(mesh=)``) at SHARDED
    over an in-process mesh of SHARD_ENTRIES entries on ``cuda:0`` (and
    over every card when there are two or more), at B = 128 and at 126
    (padding), each root held to the single-device ``search_batch`` of
    the same run.  One thread drives the entries in turn, so an
    in-process mesh on one card is expected to be slower."""
    from repro_torch.parallel import mesh_from_devices
    meshes = {f"{SHARD_ENTRIES}x{dev}": mesh_from_devices(
        [dev] * SHARD_ENTRIES)}
    n = torch.cuda.device_count()
    if n >= 2:
        meshes[f"{n}-cards"] = mesh_from_devices(
            [torch.device("cuda", i) for i in range(n)])
    out = []
    for i, (m, ws, vl, la) in enumerate(SHARD_RUNS):
        draws = draws_for(SHARDED, m, SHARD_SEED + i).to(dev)
        for b in (SHARDED["batch"], SHARDED["batch"] - 2):
            cfg = dict(SHARDED, batch=b)
            want, secs = timed(lambda: run_batch(dev, cfg, m, ws, vl, la,
                                                 draws[:b]))
            for name, mesh in meshes.items():
                what = f"shard {m}/{ws}/{vl}/{la} B={b} {name}"
                got, gsecs = timed(lambda: run_batch(
                    None, cfg, m, ws, vl, la, draws[:b], mesh=mesh))
                if got.tree.batch != b:
                    fail(f"{what}: tree batch {got.tree.batch} != {b}")
                how = hold_roots(what, got, want)
                out.append({"run": what, "equal": how,
                            "playouts_per_s":
                                b * SHARDED["budget"] / gsecs,
                            "single_playouts_per_s":
                                b * SHARDED["budget"] / secs})
                say(f"shard {m}/{ws}/{vl}/{la} B={b} mesh {name}: every "
                    f"root == single device (integers exact, value {how}); "
                    f"{out[-1]['playouts_per_s']:.0f} playouts/s sharded, "
                    f"{out[-1]['single_playouts_per_s']:.0f} single")
    del want, got
    return out


def shard_mp_worker(rank: int, world: int, backend: str, init: str,
                    out: str, seed: int, device: str, cfg: dict) -> None:
    """One rank of the ``shard-mp`` line (started with ``spawn``): join
    the group, shard the pipeline run at ``cfg`` over
    ``make_search_mesh(device=device)`` and write the gathered result
    through the checkpoint store."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.checkpoint import store
    from repro_torch.parallel import init_distributed, make_search_mesh
    from repro_torch.search import SearchConfig, shard_search_batch
    import torch.distributed as dist
    init_distributed(backend, init, world, rank)
    m, ws, vl, la = SHARD_RUNS[0]
    sc = SearchConfig(method=m, budget=cfg["budget"], lanes=cfg["lanes"],
                      keep_tree=False,
                      params=search_params(cfg, wave_select=ws,
                                           vl_mode=vl, level_assign=la))
    mesh = make_search_mesh(device=device)
    res = shard_search_batch([make_domain(cfg)] * cfg["batch"], sc,
                             draws_for(cfg, m, seed), mesh=mesh)
    store.save(f"{out}/rank{rank}", 1, res)
    dist.barrier()
    dist.destroy_process_group()


def phase_shard_mp(dev):
    """Two processes on ``cuda:0`` under gloo (NCCL refuses two ranks on
    one card), or one rank per card under NCCL where there are two or
    more, run ``shard_search_batch`` at SHARDED under ``make_search_mesh()``;
    each writes its gathered result through ``repro_torch.checkpoint``,
    held here against this process's own single-device run."""
    import multiprocessing
    import shutil
    from repro_torch.checkpoint import store
    from repro_torch.search import SearchConfig, search_batch
    n = torch.cuda.device_count()
    world, backend = (n, "nccl") if n >= 2 else (2, "gloo")
    base = ROOT / "chiprun_out" / "shard_mp"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    seed = SHARD_SEED + 7
    ctx = multiprocessing.get_context("spawn")
    devs = [f"cuda:{r}" if backend == "nccl" else str(dev)
            for r in range(world)]
    procs = [ctx.Process(target=shard_mp_worker,
                         args=(r, world, backend, f"file://{base}/rdv",
                               str(base), seed, devs[r], SHARDED))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    secs = time.perf_counter() - t0
    if [p.exitcode for p in procs] != [0] * world:
        fail(f"shard-mp: ranks exited {[p.exitcode for p in procs]}")
    m, ws, vl, la = SHARD_RUNS[0]
    sc = SearchConfig(method=m, budget=SHARDED["budget"],
                      lanes=SHARDED["lanes"],
                      keep_tree=False,
                      params=search_params(SHARDED, wave_select=ws,
                                           vl_mode=vl,
                                           level_assign=la))
    want = search_batch([make_domain(SHARDED)] * SHARDED["batch"], sc,
                        draws_for(SHARDED, m, seed), device=dev)
    how = []
    for r in range(world):
        got = store.restore(f"{base}/rank{r}", 1, want)
        how.append(hold_roots(f"shard-mp rank {r}", got, want))
    say(f"shard-mp {world} processes under {backend} "
        + ("(each on cuda:0, gathered through host copies)"
           if backend == "gloo" else "(one rank per card)")
        + f", {m}/{ws}/{vl}/{la} B={SHARDED['batch']} x "
        f"{SHARDED['budget']}: every rank's gathered "
        f"result == this process's single-device run (integers exact, "
        f"value {'; '.join(sorted(set(how)))}); {secs:.1f} s for the ranks "
        f"from spawn to exit")
    return {"world": world, "backend": backend, "seconds": secs,
            "equal": how}


def phase_ft(dev):
    """``ft_search_batch`` at SHARDED (pipeline/mega, FT_HOSTS hosts, chunks
    of FT_CHUNK) without failure, with a killed host, a stalled host and a
    driver stopped after one round and resumed from the checkpoint store
    by a fresh driver; each merged result held per root to the
    uninterrupted ``search_batch``, each report to what the injection
    implies."""
    import shutil
    import numpy as np
    from repro_torch.search import (ElasticSearchDriver, FTSearchConfig,
                                    SearchConfig, search_batch)
    m, ws, vl, la = SHARD_RUNS[0]
    b, hosts, chunk = SHARDED["batch"], FT_HOSTS, FT_CHUNK
    sc = SearchConfig(method=m, budget=SHARDED["budget"],
                      lanes=SHARDED["lanes"],
                      keep_tree=False,
                      params=search_params(SHARDED, wave_select=ws,
                                           vl_mode=vl,
                                           level_assign=la))
    doms = [make_domain(SHARDED)] * b
    draws = draws_for(SHARDED, m, SHARD_SEED + 11)
    want, base_s = timed(lambda: search_batch(doms, sc, draws, device=dev))
    per = b // hosts
    ckpt = ROOT / "chiprun_out" / "ft_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def drive(what, ft, expect, max_rounds=None):
        drv = ElasticSearchDriver(doms, sc, draws, ft, device=dev)
        res, secs = timed(lambda: drv.run(max_rounds))
        rep = drv.report
        got = {"lost": rep.lost_hosts, "requeued": sorted(rep.requeued),
               "resumed": sorted(rep.resumed),
               "twice": [int(i) for i in np.nonzero(rep.runs == 2)[0]],
               "never": [int(i) for i in np.nonzero(rep.runs == 0)[0]]}
        for k, v in expect.items():
            if got[k] != v:
                fail(f"ft {what}: report {k} {got[k]}, the injection "
                     f"implies {v}")
        if res is None:
            return drv, None, secs, None
        return drv, res, secs, hold_roots(f"ft {what}", res, want)

    stall_chunk = list(range(80, 96))       # host 2's second chunk
    kill_chunk = list(range(per, per + chunk))    # host 1's first chunk
    runs = {}
    _, _, runs["none"], how = drive(
        "no failure", FTSearchConfig(hosts=hosts, chunk=chunk),
        {"lost": [], "requeued": [], "twice": [], "never": []})
    hows = [how]
    _, _, runs["kill"], how = drive(
        "kill 37", FTSearchConfig(hosts=hosts, chunk=chunk,
                                  kill_host_at_root=37),
        {"lost": [1], "requeued": kill_chunk, "twice": kill_chunk})
    hows.append(how)
    _, _, runs["stall"], how = drive(
        "stall 90", FTSearchConfig(hosts=hosts, chunk=chunk,
                                   stall_host_at_root=90,
                                   watchdog_s=FT_WATCHDOG_S),
        {"lost": [2], "requeued": stall_chunk, "twice": stall_chunk})
    hows.append(how)
    # two rounds of 4 hosts x 16 finish all 128 roots: stop after one
    ft = FTSearchConfig(hosts=hosts, chunk=chunk, ckpt_dir=str(ckpt),
                        ckpt_keep=2)
    first = [i for h in range(hosts) for i in range(h * per, h * per + chunk)]
    d1, res1, runs["stopped"], _ = drive("stopped", ft, {"lost": []}, 1)
    if res1 is not None or sorted(np.nonzero(d1._done)[0].tolist()) != first:
        fail("ft stopped: max_rounds=1 did not stop after one round")
    _, _, runs["resumed"], how = drive(
        "resumed", ft, {"resumed": first, "never": first, "twice": []})
    hows.append(how)
    say(f"ft hosts={hosts} chunk={chunk} {m}/{ws}/{vl}/{la} "
        f"B={b}: no failure, kill at root 37 (host 1 lost, its chunk "
        f"32-47 requeued), stall at root 90 (watchdog {FT_WATCHDOG_S} s; "
        f"host 2 lost, 80-95 requeued), stopped after 1 round and resumed "
        f"by a fresh driver ({len(first)} roots from the checkpoint): every "
        f"merged root == search_batch (integers exact, value "
        f"{'; '.join(sorted(set(hows)))}); driver {runs['none']:.3f} s "
        f"without failure vs search_batch {base_s:.3f} s")
    return {"seconds": runs, "search_batch_s": base_s, "equal": hows}


def phase_lm_shard(dev, params):
    """smollm-135m at LM_FULL through ``make_batched_searcher`` over an
    in-process mesh of LM_SHARD_ENTRIES entries on ``cuda:0``: 16 slots
    padded to 18, two dead.  Stateless and with ``kv_splice`` +
    ``tree_reuse``, LM_SHARD_TOKENS tokens each; the tokens must equal
    the unsharded searcher's at batch 18 whose two extra rows are zero
    (length 0, never admitted), in this run."""
    from repro_torch.configs import get_config
    from repro_torch.parallel import mesh_from_devices
    from repro_torch.serving import make_batched_searcher
    cfg, lm = get_config(LM_ARCH), LM_FULL
    _, buf, lens = lm_buffers(cfg, lm, dev)
    b = lm["batch"]
    pad = (-b) % LM_SHARD_ENTRIES
    mesh = mesh_from_devices([dev] * LM_SHARD_ENTRIES)
    out = {}
    for name, knobs in (("stateless", {}),
                        ("kv_splice+tree_reuse",
                         dict(kv_splice=True, tree_reuse=True))):
        dc = lm_dcfg(lm, **knobs)
        sh = make_batched_searcher(cfg, params, dc, b, mesh=mesh)
        one = make_batched_searcher(cfg, params, dc, b + pad, device=dev)
        sbuf, slens = buf.clone(), lens.clone()
        obuf = torch.cat([buf, buf.new_zeros((pad, buf.shape[1]))])
        olens = torch.cat([lens, lens.new_zeros((pad,))])
        carries = None
        if knobs:
            carries = [sh.init_carry(buf.shape[1]),
                       one.init_carry(buf.shape[1])]
            for i in range(b):
                carries = [s.admit(c, i, buf[i], int(lens[i]))
                           for s, c in zip((sh, one), carries)]
        times = [0.0, 0.0]
        rows = torch.arange(b, device=dev)
        for t in range(LM_SHARD_TOKENS):
            if knobs:
                (st, carries[0]), ss = timed(
                    lambda: sh.step(sbuf, slens, t, carries[0]))
                (ot, carries[1]), os_ = timed(
                    lambda: one.step(obuf, olens, t, carries[1]))
            else:
                st, ss = timed(lambda: sh(sbuf, slens, t))
                ot, os_ = timed(lambda: one(obuf, olens, t))
            times[0] += ss
            times[1] += os_
            if st.tolist() != ot[:b].tolist():
                fail(f"lm-shard {name} token {t}: sharded {st.tolist()} != "
                     f"unsharded {ot[:b].tolist()}")
            sbuf[rows, slens.long()] = st
            obuf[rows, olens[:b].long()] = st
            slens = slens + 1
            olens = torch.cat([olens[:b] + 1, olens[b:]])
        out[name] = {"seconds_sharded": times[0], "seconds_single": times[1]}
        del sh, one, carries
    say(f"lm-shard {cfg.name} {b} slots padded to {b + pad} over "
        f"{LM_SHARD_ENTRIES}x{dev} ({pad} dead): stateless and "
        f"kv_splice+tree_reuse, {LM_SHARD_TOKENS} tokens each == the "
        f"unsharded searcher at batch {b + pad}; " + "; ".join(
            f"{k} {v['seconds_sharded']:.2f} s sharded vs "
            f"{v['seconds_single']:.2f} s" for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# the serving engine on the recurrent families: rwkv6-1.6b and zamba2-1.2b
# ---------------------------------------------------------------------------
REC_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b")
REC_KERNELS = ("wkv6", "ssd", "wkv6_chunked", "ssd_chunked")
REC_SEED = 0
# greedy: 32 requests over 16 slots (refill), ragged prompts of 64-384
# tokens, 32 new tokens each
REC_GREEDY = dict(max_batch=16, max_seq=512, requests=32, prompt_min=64,
                  prompt_max=384, new_tokens=32, policy="fcfs")
# mcts: 4 requests, one pipelined search of 16 playouts per token
REC_MCTS = dict(max_batch=4, max_seq=160, requests=4, prompt_min=32,
                prompt_max=96, new_tokens=4, method="pipeline",
                num_actions=4, budget=16, lanes=4, search_depth=4,
                rollout_len=2, cp=1.0)
REC_SMALL = dict(max_batch=2, max_seq=24, requests=3, prompt_min=2,
                 prompt_max=9, new_tokens=3, method="pipeline",
                 num_actions=3, budget=8, lanes=2, search_depth=2,
                 rollout_len=2, cp=1.0)
REC_STATE_RTOL = 1e-5   # float32 states under bf16 inputs, relative (+
                        # F32_TOL): the update is elementwise and rounds as
                        # the plain version's separate ops (-fmad=false)
REC_STEP_TOL = {"rwkv6": 1.0, "zamba2": 0.25}
# prefill-then-decode_step vs a prefill of the longer prompt, max |diff| of
# the bf16 model's logits (|max| ~4.6, mean ~0.8): the two paths round bf16
# activations in other GEMM shapes over 24 / 38 blocks.  The sound paths
# read 0.193 (rwkv6) and 0.078 (zamba2) on an H100; a step from a zeroed
# recurrent state read 6.19 / 4.69 and, for zamba2, from zeroed K/V caches
# 0.559.  Each limit sits between the two (checked on every run)


def rec_mcts_ticks(m) -> int:
    return -(-m["budget"] // m["lanes"]) + 3


def rec_prompts(vocab: int, spec, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(spec["prompt_min"], spec["prompt_max"] + 1,
                         (spec["requests"],), generator=gen)
    return [torch.randint(0, vocab, (int(n),), generator=gen).tolist()
            for n in lens]


def rec_engine(cfg, params, spec, mode, dev, **knobs):
    """The engine of ``spec`` with its requests submitted; ``knobs`` go to
    the mcts mode's ``MCTSDecodeConfig`` (the cross-token carries)."""
    import numpy as np
    from repro_torch.serving import (EngineConfig, MCTSDecodeConfig,
                                     Request, ServingEngine)
    m = None
    if mode == "mcts":
        m = MCTSDecodeConfig(**{k: spec[k] for k in (
            "method", "num_actions", "budget", "lanes", "search_depth",
            "rollout_len", "cp")}, **knobs)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_batch=spec["max_batch"], max_seq=spec["max_seq"], decode=mode,
        policy=spec.get("policy", "fcfs"), mcts=m), device=dev)
    reqs = [Request(uid=uid, prompt=np.asarray(p, np.int32),
                    max_new_tokens=spec["new_tokens"])
            for uid, p in enumerate(rec_prompts(cfg.vocab_size, spec,
                                                REC_SEED + 7))]
    for r in reqs:
        eng.submit(r)
    return eng, reqs


def rec_inputs_wkv6(b, t, h, n, dt, dev, gen, strong=False):
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    r, k, v = (rnd(b, t, h, n).mul(0.5).to(dt) for _ in range(3))
    # the model's decays: exp(-exp(w_raw)), w_raw around the init's -6;
    # strong: uniform squared, a twentieth set to exactly 0
    w = torch.exp(-torch.exp(rnd(b, t, h, n) * 0.5 - 6.0))
    if strong:
        w = torch.rand(b, t, h, n, generator=gen, device=dev)
        w = torch.where(w < 0.05, torch.zeros_like(w), w * w)
    return r, k, v, w, rnd(h, n).mul(0.3).to(dt), rnd(b, h, n, n) * 0.1


def rec_inputs_ssd(b, t, h, p, n, dt, dev, gen):
    """x, Bm, Cm as slices of one packed conv output, as the model has."""
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    buf = rnd(b, t, h * p + 2 * n).mul(0.5).to(dt)
    x = buf[..., :h * p].reshape(b, t, h, p)
    dts = torch.nn.functional.softplus(rnd(b, t, h) - 2.0)
    a = -torch.exp(rnd(h) * 0.3)
    return (x, dts, a, buf[..., h * p: h * p + n], buf[..., h * p + n:],
            torch.ones(h, device=dev), rnd(b, h, p, n) * 0.1)


def rec_shares(got, plain, plain32, n_terms: int) -> dict:
    """(y, state) of a kernel against its plain version, as shares of
    their limits (a share above 1 fails): y as ``bf16_check``, its absolute
    part widened by ``n_terms`` float32 ulps of the largest output (kernel
    and plain version sum each output's ``n_terms`` terms in other orders,
    so near-cancelling outputs differ by up to that much before the bf16
    rounding); the float32 state within F32_TOL + REC_STATE_RTOL relative
    of the plain version run in float32."""
    atol = F32_TOL + n_terms * 2.0 ** -24 * float(plain32[0].abs().max())
    g = got[0].detach().double()
    out = {}
    for name, want, rtol in (("bf16", plain[0], BF16_RTOL),
                             ("f32", plain32[0], BF16_RTOL_F32)):
        w = want.detach().double()
        d = (g - w).abs()
        out[name] = float(d.max())
        out[name + "_limit_share"] = float((d / (atol + rtol * w.abs()))
                                           .max())
    gs, ws = got[1].double(), plain32[1].double()
    d = (gs - ws).abs()
    out.update(state=float(d.max()), state_limit_share=float(
        (d / (F32_TOL + REC_STATE_RTOL * ws.abs())).max()), atol=atol)
    return out


def rec_check(what, got, plain, plain32, n_terms: int, planted=None):
    """Fail unless ``got`` is within ``rec_shares``' limits and, when a
    ``planted`` result (the same call with a planted fault) is given,
    unless that one reads above them.  Returns the shares."""
    out = rec_shares(got, plain, plain32, n_terms)
    worst = max(out["bf16_limit_share"], out["f32_limit_share"],
                out["state_limit_share"])
    if worst > 1.0:
        fail(f"{what}: differs from the plain version beyond its limits "
             f"(y {out['bf16']} / {out['f32']}, state {out['state']}; "
             f"shares {out['bf16_limit_share']:.3f} / "
             f"{out['f32_limit_share']:.3f} / "
             f"{out['state_limit_share']:.3f}; atol {out['atol']}, "
             f"REC_STATE_RTOL {REC_STATE_RTOL})")
    if planted is not None:
        pl = rec_shares(planted, plain, plain32, n_terms)
        out["planted_share"] = max(pl["f32_limit_share"],
                                   pl["state_limit_share"])
        if out["planted_share"] <= 1.0:
            fail(f"{what}: the planted fault reads {pl}, within the limits: "
                 f"the check cannot see it")
    return out


def chunk_bound(kind: str, b, t, h, n, p=None):
    """Least time of the chunked route's own work (ms, by): its products
    once each at the bf16 tensor-core rate plus its elementwise work at
    the float32 rate, or its bytes, whichever is larger.  Per step and
    head (chunk L = 64, widths 64): SSD C B^T and M x over the chunk (2 L
    N + 2 L P flops) and C S^T and x^T B (2 P N each); WKV6 the scores and
    A v (2 L N each) and the state term and update (2 N N each).
    Elementwise: SSD the mask exp(cum_t - cum_s) dt_s and the split of M
    (~8 L), of B (~8 N) and of S (~8 P N / L); WKV6 per channel a log,
    four exps and their products and splits (~40 N), the own-sub-chunk
    pairs (16 / 2 x 3 N), the split of the scores (~8 L) and of S (~8 N N
    / L).  Bytes as the recurrence's bound (each operand once)."""
    L = 64
    if kind == "ssd":
        mm = 2 * L * n + 2 * L * p + 4 * p * n
        ew = 8 * L + 8 * n + 8 * p * n / L
        nb = 2 * 2 * b * t * h * p + 2 * 2 * b * t * n + 4 * b * t * h \
            + 2 * 4 * b * h * p * n
    else:
        mm = 4 * L * n + 4 * n * n
        ew = 40 * n + 24 * n + 8 * L + 8 * n * n / L
        nb = 4 * 2 * b * t * h * n + 4 * b * t * h * n + 2 * h * n \
            + 2 * 4 * b * h * n * n
    steps = b * t * h
    t_o = steps * mm / BF16_FLOPS + steps * ew / F32_FLOPS
    t_b = nb / HBM_BYTES_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def rec_bufs(args, y_dim: int):
    """A kernel's operands and fresh outputs (y like ``args[y_dim]``, the
    state like ``args[-1]``), for its launch function."""
    return (*args, torch.empty(args[y_dim].shape, dtype=args[y_dim].dtype,
                               device=args[y_dim].device),
            torch.empty_like(args[-1]))


def rec_case(what, name, fn, launch, chunked_ref, args, cast, n_seq,
             counter, timed, host):
    """One shape of K5 / K6: the wrapper's result held to the sequential
    plain version (bf16 and float32 inputs) with the route's term count
    (and, on the chunked route, its max |diff| from the plain chunked
    arithmetic, reported); with ``timed``, the wrapper, its plain version
    and (for T > 1) the sequential kernel through its launch function as
    ``before_ms``, in turns; the bounds of the recurrence and of the
    chunked route."""
    before = counter[name + "_chunked"]
    got = fn(*args)
    torch.cuda.synchronize()
    chunked = counter[name + "_chunked"] > before
    plain32 = fn(*cast(args), impl="ref")
    out = rec_check(what, got, fn(*args, impl="ref"), plain32,
                    n_seq + (64 + 1 if chunked else 0))
    out["route"] = "chunked" if chunked else "sequential"
    if chunked:
        cref = chunked_ref(*cast(args))
        out.update(vs_chunked_plain=max_diff(got[0].float(), cref[0]),
                   state_vs_chunked_plain=max_diff(got[1], cref[1]),
                   chunked_plain_vs_plain=max_diff(cref[1], plain32[1]))
    if not timed:
        return out
    cases = {"ms": (lambda _: fn(*args), {}),
             "plain_ms": (lambda _: fn(*args, impl="ref"), dict(reps=3))}
    if chunked:
        cases["before_ms"] = (lambda _: launch(*rec_bufs(args, 0)), {})
    out.update(time_turns(cases))
    if host:
        HOST[name + ("_chunked" if chunked else "_step")] = host_us(
            lambda _: fn(*args))
    return out


def rec_case_wkv6(what, a5, timed=False, host=False):
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.rwkv6_scan import ref as WR
    b, t, h, n = a5[0].shape
    c5 = lambda a: (a[0].float(), a[1].float(), a[2].float(), a[3],
                    a[4].float(), a[5])
    out = rec_case(what, "wkv6", WK.wkv6, WK.launch, WR.wkv6_chunked_ref,
                   a5, c5, n, WK.launches, timed, host)
    if timed:
        # r, k, v in and y out (bf16), w in (f32), u, state in and out
        nb = 2 * 4 * a5[0].numel() + 4 * a5[3].numel() \
            + 2 * a5[4].numel() + 2 * 4 * a5[5].numel()
        # per step and head: y = r^T S (2 N^2), S <- S w + k v^T (3 N^2),
        # and the bonus v_i * sum_j r_j u_j k_j (5 N)
        out.update(bound=bound_ms(nb, 5.0 * b * t * h * n * (n + 1)),
                   chunk_bound=chunk_bound("wkv6", b, t, h, n),
                   shape=[b, t, h, n])
    return out


def rec_case_ssd(what, a6, timed=False, host=False):
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.kernels.ssm_scan import ref as SR
    b, t, h, p = a6[0].shape
    n = a6[3].shape[-1]
    c6 = lambda a: (a[0].float(), a[1], a[2], a[3].float(), a[4].float(),
                    a[5], a[6])
    out = rec_case(what, "ssd", SS.ssd, SS.launch, SR.ssd_chunked_ref, a6,
                   c6, n + 1, SS.launches, timed, host)
    if timed:
        # x in and y out, B and C in (bf16), dt in, state in and out
        nb = 2 * 2 * a6[0].numel() + 2 * 2 * a6[3].numel() \
            + 4 * a6[1].numel() + 2 * 4 * a6[6].numel()
        out.update(bound=bound_ms(nb, 5.0 * b * t * h * p * n),
                   chunk_bound=chunk_bound("ssd", b, t, h, n, p),
                   shape=[b, t, h, p, n])
    return out


def rec_carry(what, fn, args, seq_dims, n_terms: int) -> dict:
    """Two calls split mid-chunk (100 = 64 + 36 steps, then 66) held to
    one call's plain version; the second call from a zeroed state must
    read above the limits."""
    part = lambda lo, hi, st: [z[:, lo:hi] if i in seq_dims else z
                               for i, z in enumerate(args[:-1])] + [st]
    y1, s1 = fn(*part(0, 100, args[-1]))
    y2, s2 = fn(*part(100, 166, s1))
    z2, zs = fn(*part(100, 166, torch.zeros_like(s1)))
    torch.cuda.synchronize()
    cast = [z.float() if z.dtype == torch.bfloat16 else z for z in args]
    return rec_check(f"{what} carried across two calls",
                     (torch.cat([y1, y2], 1), s2), fn(*args, impl="ref"),
                     fn(*cast, impl="ref"), n_terms,
                     planted=(torch.cat([y1, z2], 1), zs))


def phase_rec_kernels(dev):
    """K5 and K6 against their sequential plain versions at full width
    (rwkv6-1.6b: 32 heads of 64; zamba2-1.2b: 64 heads of 64 x 64, one B /
    C group) in bf16 with float32 decays / dt and states, at the engine's
    three shapes (prefill: batch 1, T 384; decode: batch 16, T 1; the mcts
    generic forward: batch 16, T = the search buffer), where a chunk has a
    tail (T 65, 130), with strong decays (K5), across two calls split
    mid-chunk, plus float32 at the smoke shapes; K3 and K4 at zamba2's
    attention shapes (32 heads of 128).  CUDA-event times of each kernel
    (and, at T > 1, of the sequential kernel it replaces) and its plain
    version, and of both routes at short T."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels import scan_chunks
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    gen = torch.Generator(dev).manual_seed(13)
    bf, f32 = torch.bfloat16, torch.float32
    buf_len = REC_MCTS["max_seq"] + REC_MCTS["search_depth"] \
        + REC_MCTS["rollout_len"]
    shapes = {"prefill": (1, REC_GREEDY["prompt_max"]),
              "decode": (REC_GREEDY["max_batch"], 1),
              "mcts": (REC_MCTS["max_batch"] * REC_MCTS["lanes"], buf_len)}
    rw, zb = get_config("rwkv6-1.6b"), get_config("zamba2-1.2b")
    h5, n5 = rw.d_model // rw.rwkv_head_dim, rw.rwkv_head_dim
    d_in = zb.ssm_expand * zb.d_model
    h6, p6, n6 = d_in // zb.ssm_head_dim, zb.ssm_head_dim, zb.ssm_state
    res = {"wkv6": {}, "ssd": {}}
    for tag, (b, t) in shapes.items():
        a5 = rec_inputs_wkv6(b, t, h5, n5, bf, dev, gen)
        res["wkv6"][tag] = rec_case_wkv6(f"wkv6 {tag}", a5, timed=True,
                                         host=tag in REC_TIMED.values())
        a6 = rec_inputs_ssd(b, t, h6, p6, n6, bf, dev, gen)
        res["ssd"][tag] = rec_case_ssd(f"ssd {tag}", a6, timed=True,
                                       host=tag in REC_TIMED.values())
        del a5, a6
    # the chunked kernels where a chunk has a tail, K5 with strong decays
    # (down to exactly 0), and a state carried across two calls split
    # mid-chunk (a planted fault: the second call from a zeroed state)
    for t in (65, 130):
        res["wkv6"][f"ragged{t}"] = rec_case_wkv6(
            f"wkv6 T={t}", rec_inputs_wkv6(2, t, h5, n5, bf, dev, gen))
        res["ssd"][f"ragged{t}"] = rec_case_ssd(
            f"ssd T={t}", rec_inputs_ssd(2, t, h6, p6, n6, bf, dev, gen))
    for b, t in ((1, REC_GREEDY["prompt_max"]), (2, 130)):
        a5 = rec_inputs_wkv6(b, t, h5, n5, bf, dev, gen, strong=True)
        res["wkv6"][f"strong{t}"] = rec_case_wkv6(f"wkv6 strong T={t}", a5)
    carry = {"wkv6": rec_carry(
        "wkv6", WK.wkv6, rec_inputs_wkv6(2, 166, h5, n5, bf, dev, gen),
        (0, 1, 2, 3), n5 + WK.CHUNK + 1), "ssd": rec_carry(
        "ssd", SS.ssd, rec_inputs_ssd(2, 166, h6, p6, n6, bf, dev, gen),
        (0, 1, 3, 4), n6 + SS.CHUNK + 1)}
    # the chunked kernels leave the flags they keep between calls at 0
    torch.cuda.synchronize()
    flags = scan_chunks.workspace(
        dev, torch.cuda.current_stream(dev).cuda_stream, 0, 0)[1]
    if int(flags.count_nonzero()):
        fail(f"the chunked scans left {int(flags.count_nonzero())} of "
             f"their flags raised")
    # where the chunked route starts to pay: both routes at short T
    cross = {}
    for b in (1, REC_GREEDY["max_batch"]):
        for t in (2, 4, 8, 16, 32, 64):
            a5 = rec_inputs_wkv6(b, t, h5, n5, bf, dev, gen)
            a6 = rec_inputs_ssd(b, t, h6, p6, n6, bf, dev, gen)
            cross[f"wkv6 [{b}, {t}]"] = time_turns({
                "chunked": (lambda _: WK.launch_chunked(*rec_bufs(a5, 0)),
                            {}),
                "sequential": (lambda _: WK.launch(*rec_bufs(a5, 0)), {})})
            cross[f"ssd [{b}, {t}]"] = time_turns({
                "chunked": (lambda _: SS.launch_chunked(*rec_bufs(a6, 0)),
                            {}),
                "sequential": (lambda _: SS.launch(*rec_bufs(a6, 0)), {})})
    # float32 at the smoke shapes, T = 37 and T = 1
    f32_err = 0.0
    rs, zs = get_smoke_config("rwkv6-1.6b"), get_smoke_config("zamba2-1.2b")
    zd = zs.ssm_expand * zs.d_model
    for t in (37, 1):
        a5 = rec_inputs_wkv6(2, t, rs.d_model // rs.rwkv_head_dim,
                             rs.rwkv_head_dim, f32, dev, gen)
        a6 = rec_inputs_ssd(2, t, zd // zs.ssm_head_dim, zs.ssm_head_dim,
                            zs.ssm_state, f32, dev, gen)
        for got, want in ((WK.wkv6(*a5), WK.wkv6(*a5, impl="ref")),
                          (SS.ssd(*a6), SS.ssd(*a6, impl="ref"))):
            f32_err = max(f32_err, max_diff(got[0], want[0]),
                          max_diff(got[1], want[1]))
    if f32_err > F32_TOL:
        fail(f"recurrent kernels differ from their plain versions in "
             f"float32 by {f32_err} (> {F32_TOL})")
    # K4 and K3 at zamba2's shared attention (H = Hkv = 32, D = 128),
    # beside PyTorch's SDPA on the same inputs
    h, hkv, d = zb.n_heads, zb.kv_heads, zb.head_dim
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(bf)
    attn = {}
    for tag, (b, s) in (("prefill", shapes["prefill"]),
                        ("mcts", shapes["mcts"])):
        q, k, v = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)
        chk = rounded_check(f"flash_attention_bf16 zamba2 {tag}",
                            FA.flash_attention(q, k, v), q, k, v,
                            planted=FA.flash_attention(q, k, v, q_offset=1))
        attn[f"flash_attention_bf16/{tag}"] = dict(
            chk, **time_turns(fa_cases(q, k, v)), bound=fa_bound(q, k),
            max_abs_err=max_diff(FA.flash_attention(q, k, v),
                                 FA.flash_attention(q, k, v, impl="ref")),
            shape=[b, s, h, d])
    b, s = REC_GREEDY["max_batch"], REC_GREEDY["max_seq"]
    n_apps = zb.n_layers // zb.shared_attn_every
    qd = rnd(b, 1, h, d)
    kc, vc = rnd(n_apps, b, s, hkv, d), rnd(n_apps, b, s, hkv, d)
    vl = torch.randint(REC_GREEDY["prompt_min"] + 1,
                       REC_GREEDY["prompt_max"] + REC_GREEDY["new_tokens"]
                       + 1, (b,), device=dev, generator=gen).to(torch.int32)
    ks_, vs_ = kc[n_apps // 2], vc[n_apps // 2]
    chk = bf16_check("decode_attention zamba2",
                     DA.decode_attention(qd, ks_, vs_, vl),
                     DA.decode_attention(qd, ks_, vs_, vl, impl="ref"),
                     DA.decode_attention(qd.float(), ks_.float(),
                                         vs_.float(), vl, impl="ref"))
    attn["decode_attention/decode"] = dict(
        chk, **time_turns(da_cases(qd, list(kc), list(vc), vl)),
        bound=da_bound(qd, hkv, vl), shape=[b, s, h, d],
        splits=DA.split_count(b * hkv, s))
    del kc, vc
    say("rec-kernels " + " ".join(
        f"{k}/{tag}[{v['route']}]:y_err={v['bf16']},vs_f32={v['f32']}"
        f"({100 * v['f32_limit_share']:.1f}%),state_err={v['state']}"
        f"({100 * v['state_limit_share']:.1f}%)"
        + (f",ms={v['ms']:.5f},plain_ms={v['plain_ms']:.5f},"
           f"bound_ms={v['bound'][0]:.5f},"
           f"chunk_bound_ms={v['chunk_bound'][0]:.5f}" if "ms" in v else "")
        + (f",before_ms={v['before_ms']:.5f}" if "before_ms" in v else "")
        for k in res for tag, v in res[k].items())
        + " carry " + " ".join(
            f"{k}:share={100 * max(v['f32_limit_share'], v['state_limit_share']):.1f}%,"
            f"planted={v['planted_share']:.3g}x" for k, v in carry.items())
        + " crossover(ms chunked/sequential) " + " ".join(
            f"{k}:{v['chunked']:.5f}/{v['sequential']:.5f}"
            for k, v in cross.items())
        + f" f32_err={f32_err}; zamba2 attention "
        + " ".join(f"{k}:limit_share="
                   f"{v.get('limit_share', v.get('f32_limit_share'))},"
                   f"ms={v['ms']:.5f},plain_ms={v['plain_ms']:.5f},"
                   f"bound_ms={v['bound'][0]:.5f},sdpa_ms={v['sdpa_ms']:.5f}"
                   + (f",before_ms={v['before_ms']:.5f}"
                      if "before_ms" in v else "")
                   for k, v in attn.items()))
    return res, attn, f32_err, carry, cross


def phase_rec_small(dev):
    """The engine on the float32 smoke configs, greedy and mcts: the
    card's token streams equal the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.base import get_family
    out = {}
    for arch in REC_ARCHS:
        cfg = get_smoke_config(arch)
        params = get_family(cfg).init(cfg, seed=REC_SEED, device="cpu")
        for mode in ("greedy", "mcts"):
            streams = []
            for device in (dev, "cpu"):
                eng, reqs = rec_engine(cfg, params, REC_SMALL, mode, device)
                eng.run_until_drained()
                streams.append({r.uid: r.out_tokens for r in reqs})
            if streams[0] != streams[1]:
                fail(f"rec small {arch} {mode}: card {streams[0]} != CPU "
                     f"{streams[1]}")
            out[f"{arch}/{mode}"] = streams[0]
    say(f"rec-small engine card == CPU tokens ({', '.join(REC_ARCHS)} smoke "
        f"configs, greedy and mcts, {REC_SMALL['requests']} ragged requests "
        f"over {REC_SMALL['max_batch']} slots)")
    return out


def rec_expected(cfg, eng, mode) -> dict:
    """The kernel launches a drained engine run implies, from its own
    counts of admissions (one prefill each, greedy) and steps (one
    decode_step, or one search, each)."""
    st = eng.stats
    zamba = cfg.family == "zamba2"
    n_apps = cfg.n_layers // cfg.shared_attn_every if zamba else 0
    scan = "ssd" if zamba else "wkv6"
    if mode == "greedy":
        # every prefill (prompts of 64-384 tokens) takes the chunked
        # route, every decode step (T = 1) the sequential one
        want = {scan: cfg.n_layers * (st.admissions + st.steps),
                f"{scan}_chunked": cfg.n_layers * st.admissions}
        if zamba:
            want.update(flash_attention_bf16=n_apps * st.admissions,
                        decode_attention=n_apps * st.steps)
        return want
    ticks = rec_mcts_ticks(REC_MCTS)
    # per search: one root forward, then per tick one expand step and
    # rollout_len - 1 playout steps, each a full forward (generic fallback)
    fwd = st.steps * (1 + ticks * REC_MCTS["rollout_len"])
    want = {scan: cfg.n_layers * fwd, f"{scan}_chunked": cfg.n_layers * fwd,
            "bes": st.steps * ticks}
    if zamba:
        want.update(flash_attention_bf16=n_apps * fwd, decode_attention=0)
    return want


def rec_step_check(cfg, params, fam, dev) -> dict:
    """prefill(prompt) then decode_step(token) against a prefill of the
    prompt one token longer, at full width; a step from a zeroed
    recurrent state (and, for zamba2, from zeroed K/V caches) must read
    above the family's REC_STEP_TOL."""
    gen = torch.Generator().manual_seed(REC_SEED + 3)
    b, s = 4, 128
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         dtype=torch.int32).to(dev)
    state = "ssd" if cfg.family == "zamba2" else "wkv"
    _, cache = fam.prefill(cfg, params, toks[:, :s],
                           fam.init_cache(cfg, b, s + 8, device=dev))
    full, _ = fam.prefill(cfg, params, toks,
                          fam.init_cache(cfg, b, s + 8, device=dev))
    planted = {}
    clone = lambda c: {k: v.clone() for k, v in c.items()}
    c0 = clone(cache)
    c0[state] = torch.zeros_like(c0[state])
    planted["zero_state"] = fam.decode_step(cfg, params, c0,
                                            toks[:, s:])[0]
    if cfg.family == "zamba2":
        c1 = clone(cache)
        c1["k"].zero_()
        c1["v"].zero_()
        planted["zero_kv"] = fam.decode_step(cfg, params, c1,
                                             toks[:, s:])[0]
    sound = fam.decode_step(cfg, params, cache, toks[:, s:])[0]
    err = max_diff(sound.float(), full.float())
    planted = {k: max_diff(v.float(), full.float())
               for k, v in planted.items()}
    tol = REC_STEP_TOL[cfg.family]
    if err > tol:
        fail(f"rec full {cfg.name}: prefill-then-decode_step differs from "
             f"the longer prefill by {err} (> {tol})")
    if min(planted.values()) <= tol:
        fail(f"rec full {cfg.name}: planted faults read {planted}, within "
             f"REC_STEP_TOL {tol}: the check cannot see them")
    return {"step_vs_prefill_max_abs": err, "planted": planted,
            "logit_abs_max": float(full.float().abs().max()),
            "logit_abs_mean": float(full.float().abs().mean())}


def phase_rec_full(dev):
    """The serving engine at the published widths (random bf16 weights
    from the port's ``init``, seed 0) for rwkv6-1.6b and zamba2-1.2b:
    greedy (REC_GREEDY) and mcts (REC_MCTS).  Each run is one main path:
    counts set to 0 just before, read just after, and held to the counts
    the run implies; every request ends with its budget of tokens in the
    vocabulary; prefill-then-step agrees with the longer prefill.  Then
    one engine step of each mode is profiled (``chiprun_out/
    profile_rec.txt``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.base import get_family
    runs, total, prof, lines = {}, {}, {}, []
    for arch in REC_ARCHS:
        cfg = get_config(arch)
        fam = get_family(cfg)
        params = fam.init(cfg, seed=REC_SEED, device=dev)
        for mode, spec in (("greedy", REC_GREEDY), ("mcts", REC_MCTS)):
            eng, reqs = rec_engine(cfg, params, spec, mode, dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()               # this main path starts here
            t0 = time.perf_counter()
            out = eng.run_until_drained()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = all_launches()        # read just after it
            peak = torch.cuda.max_memory_allocated()
            what = f"rec full {arch} {mode}"
            want = rec_expected(cfg, eng, mode)
            for k, w in want.items():
                if counts[k] != w:
                    fail(f"{what}: kernel {k} launched {counts[k]} times, "
                         f"the run implies {w}")
            summ = out["requests"]
            if len(summ) != spec["requests"] or any(
                    v["tokens"] != spec["new_tokens"] or not v["done"]
                    for v in summ.values()):
                fail(f"{what}: a request ended short of its budget")
            for r in reqs:                 # every submitted request
                if len(r.out_tokens) != spec["new_tokens"] or not all(
                        0 <= t < cfg.vocab_size for t in r.out_tokens):
                    fail(f"{what}: request {r.uid} emitted {r.out_tokens}")
            n_tok = sum(v["tokens"] for v in summ.values())
            runs[f"{arch}/{mode}"] = {
                "seconds": secs, "tokens": n_tok,
                "tokens_per_s": n_tok / secs, "steps": eng.stats.steps,
                "admissions": eng.stats.admissions, "peak_mem_bytes": peak,
                "launches": {k: counts[k] for k in want},
                "ttft_p50_s": out["stats"].get("serving/ttft_p50"),
                "latency_p50_s": out["latency_p50"]}
            for k in want:
                total[k] = total.get(k, 0) + counts[k]
            del eng
        runs[f"{arch}/step_check"] = rec_step_check(cfg, params, fam, dev)
        prof[arch] = rec_profile(cfg, params, dev, lines)
        del params
        torch.cuda.empty_cache()
    say("rec-full " + "; ".join(
        f"{k} {v['tokens']} tokens in {v['seconds']:.3f} s = "
        f"{v['tokens_per_s']:.2f} tokens/s, peak "
        f"{v['peak_mem_bytes'] / 2**30:.2f} GiB, launches "
        + ",".join(f"{a}={b}" for a, b in v["launches"].items())
        for k, v in runs.items() if "step_check" not in k)
        + "; step vs prefill " + ", ".join(
            f"{k.split('/')[0]} {v['step_vs_prefill_max_abs']} (planted "
            f"{v['planted']})" for k, v in runs.items()
            if "step_check" in k))
    write_out("profile_rec.txt", lines)
    return runs, total, prof


def rec_profile(cfg, params, dev, lines) -> dict:
    """Where a greedy decode step (16 live slots) and one mcts search go
    (tables appended to ``lines``)."""
    out = {}
    for mode, spec in (("greedy", REC_GREEDY), ("mcts", REC_MCTS)):
        eng, _ = rec_engine(cfg, params, spec, mode, dev)
        eng.step()                         # admits and prefills all slots
        summary, table = profile_one(
            f"{cfg.name} {mode}: one engine step over {spec['max_batch']} "
            f"live slots", eng.step)
        if summary:
            out[mode] = summary
            lines += table
        del eng
    return out


# ---------------------------------------------------------------------------
# the other families: MoE (MLA; soft-capped GQA), VLM, Whisper
# ---------------------------------------------------------------------------
MOE_ARCH = "deepseek-v2-lite-16b"
VLM_ARCH = "internvl2-2b"
WHISPER_ARCH = "whisper-base"
FAM_SMALL_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b", "internvl2-2b",
                   "whisper-base")
FAM_SEED = 0
FAM_KERNELS = ("flash_attention_bf16_mla",)   # run by the MoE paths only
PAR_KERNELS = ("decode_attention_lse",)  # run by the parallel phase only
# deepseek-v2-lite-16b at its published width: 16 requests with ragged
# prompts of 64-384 tokens over 8 slots (refill), 16 new tokens each
MOE_GREEDY = dict(max_batch=8, max_seq=512, requests=16, prompt_min=64,
                  prompt_max=384, new_tokens=16, policy="fcfs")
# mcts_decode_batch: 2 prompts, 2 tokens, every step a full forward
# prefill-then-step at capacity 100: token draws [4, 129], each checked
MOE_STEP_DRAWS = 5
MOE_MCTS = dict(requests=2, prompt_min=64, prompt_max=128, new_tokens=2,
                num_actions=4, budget=8, lanes=4, search_depth=2,
                rollout_len=2)
# internvl2-2b: multimodal_logits on 4 x (256 patches + 128 tokens); the
# greedy engine on 8 requests x 16 tokens
VLM_MM = dict(batch=4, text=128)
VLM_GREEDY = dict(max_batch=8, max_seq=512, requests=8, prompt_min=64,
                  prompt_max=256, new_tokens=16, policy="fcfs")
# whisper-base: 4 x 1500 frames and 32-token prompts, then 32 greedy
# decode_steps
WHISPER_RUN = dict(batch=4, prompt=32, new_tokens=32)
FAM_LOGIT_TOL = 1e-4   # float32 smoke logits, card vs CPU: the orders of
                       # the sums differ over 2-3 layers (magnitude ~4)
# prefill-then-decode_step vs a prefill of the longer prompt, max |diff|
# of the bf16 model's logits; a step from a zeroed cache and a step one
# position late or early must read above it (checked on every run).
# whisper-base: 0.0156 against 0.315-1.79 planted (|logits| up to 2.11).
# deepseek-v2-lite at moe_capacity 100 (no slot dropped on either path,
# as tests/test_archs_smoke.py runs it), on an H100: the sound path reads
# 0.5625 (|logits| up to 5.09), one position late 1.42, early 1.80,
# zeroed latents 7.09; over four more token draws 0.23-0.90 against
# 1.26-1.86 planted.  The limit sits between them (it was 0.5 until the
# first full-width reading of 0.5625).  The gap is the routing's: bf16
# rounds other products on the two paths (the absorbed decode q W_uk^T,
# the prefill c_kv W_uk), and a row's top-6 set flips where two gates are
# 4e-6 to 2e-3 apart, after which the rows part (router input max |diff|
# 0.078-0.094 up to each row's first flip, up to 0.74 after);
# tests/test_torch_moe.py shows the JAX package's own bf16 gap as large.
FAM_STEP_TOL = {"moe": 1.0, "whisper": 0.1}
# MoE: up to each row's first top-k flip, the step's router input against
# the prefill's (max |diff|).  Sound 0.078-0.094 over five token draws;
# planted faults 0.63-1.02 (one position late or early) and 5.3-6.1
# (zeroed latents): the limit sits between them
FAM_ROUTE_TOL = 0.25


def counted(fn):
    """``fn()`` and the launches it made, by counter (nonzero only)."""
    before = all_launches()
    out = fn()
    torch.cuda.synchronize()
    after = all_launches()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def hold_counts(what, got: dict, want: dict) -> None:
    """Every counter ``want`` names at its value, and no other counter
    moved."""
    for k in set(got) | set(want):
        if got.get(k, 0) != want.get(k, 0):
            fail(f"{what}: kernel {k} launched {got.get(k, 0)} times, the "
                 f"path implies {want.get(k, 0)}")


def mla_bound(q, k, v):
    """The least time of a causal K4 at q/k head dim D, v head dim Dv:
    q, k, v read and out written once (bf16) against 2 (D + Dv) flops a
    (row, key) pair at the bf16 tensor-core peak."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    return bound_ms(2 * (q.numel() + k.numel() + v.numel() + b * s * h * dv),
                    2 * b * h * s * (s + 1) / 2 * (d + dv), BF16_FLOPS)


def phase_attn_mla(dev):
    """K4 at deepseek-v2-lite's MLA prefill shape (q/k head dim 192, v
    128, 16 heads, causal, bf16) at S 65 / 130 / 384, each held to
    ``rounded_p_limit`` with a planted fault above it, and at the smoke
    shape in float32 ([2, 15, 4, 24 / 16]) against the plain version;
    timed at S 384 beside the plain version and SDPA (which takes the
    separate value head dim)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import ops as FA
    cfg, sm = get_config(MOE_ARCH), get_smoke_config(MOE_ARCH)
    h, d, dv = cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    gen = torch.Generator(dev).manual_seed(17)
    rnd = lambda *shape, dt: torch.randn(*shape, generator=gen, device=dev,
                                         dtype=torch.float32).to(dt)
    bf, f32 = torch.bfloat16, torch.float32
    checks, err = {}, 0.0
    for s in (65, 130, 384):
        q, k, v = rnd(1, s, h, d, dt=bf), rnd(1, s, h, d, dt=bf), \
            rnd(1, s, h, dv, dt=bf)
        got = FA.flash_attention(q, k, v)
        checks[s] = rounded_check(
            f"flash_attention_bf16_mla S={s}", got, q, k, v,
            planted=FA.flash_attention(q, k, v, q_offset=1))
        err = max(err, max_diff(got, FA.flash_attention(q, k, v,
                                                        impl="ref")))
    hs, ds, dvs = sm.n_heads, sm.qk_nope_dim + sm.qk_rope_dim, sm.v_head_dim
    qf, kf, vf = rnd(2, 15, hs, ds, dt=f32), rnd(2, 15, hs, ds, dt=f32), \
        rnd(2, 15, hs, dvs, dt=f32)
    f32e = max_diff(FA.flash_attention(qf, kf, vf),
                    FA.flash_attention(qf, kf, vf, impl="ref"))
    if f32e > F32_TOL:
        fail(f"flash_attention at ({ds}, {dvs}) differs from its plain "
             f"version in float32 by {f32e} (> {F32_TOL})")
    res = dict(time_turns(fa_cases(q, k, v, before=False)),
               max_abs_err=err, f32_err=f32e, bound=mla_bound(q, k, v),
               shape=[1, 384, h, d, dv], checks=checks)
    HOST["flash_attention_bf16_mla"] = host_us(
        lambda _: FA.flash_attention(q, k, v))
    say("attn-mla flash_attention_bf16_mla [1, S, 16, 192 / 128] causal: "
        + ", ".join(f"S={s} {100 * c['limit_share']:.1f}% of its limit "
                    f"(planted {c['planted_share']:.1f}x)"
                    for s, c in checks.items())
        + f"; at S=384 ms={res['ms']:.5f},plain_ms={res['plain_ms']:.5f},"
        f"bound_ms={res['bound'][0]:.5f} ({res['bound'][1]}),"
        f"sdpa_ms={res['sdpa_ms']:.5f},host_us="
        f"{HOST['flash_attention_bf16_mla']:.1f}; float32 [2, 15, {hs}, "
        f"{ds} / {dvs}] err={f32e}")
    return res


def fam_logits_check(what, got, want):
    """Card logits against the CPU's (float32 smoke models): within
    FAM_LOGIT_TOL and the same argmax."""
    d = max_diff(got, want)
    if d > FAM_LOGIT_TOL * max(1.0, float(want.abs().max())):
        fail(f"{what}: card logits differ from the CPU's by {d}")
    if not torch.equal(got.cpu().argmax(-1), want.cpu().argmax(-1)):
        fail(f"{what}: card argmax differs from the CPU's")
    return d


def phase_families_small(dev):
    """The MoE (deepseek-v2-lite, grok-1), VLM (internvl2) and Whisper
    smoke configs in float32, card == CPU: MoE ``prefill`` + 3
    ``decode_step``s and ``logits_fn``, the greedy engine and
    ``mcts_decode_batch`` (the generic fallback); internvl2's
    ``multimodal_logits`` and greedy engine; Whisper's ``prefill`` with
    frames + 3 ``decode_step``s.  Each card call's K4 / K3 launches held to
    the count its path implies.  Returns the details and the launches of
    the whole phase (counts set to 0 just before, read just after)."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.base import get_family, tree_to
    from repro_torch.serving import MCTSDecodeConfig, mcts_decode_batch
    out = {}
    reset_launches()
    gen = torch.Generator().manual_seed(FAM_SEED + 5)
    for arch in FAM_SMALL_ARCHS:
        cfg = get_smoke_config(arch)
        fam = get_family(cfg)
        cpu = fam.init(cfg, seed=FAM_SEED, device="cpu")
        card = tree_to(cpu, dev)
        nl, r = cfg.n_layers, {}
        what = f"families-small {cfg.name}"
        toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen,
                             dtype=torch.int32)
        if cfg.family == "whisper":
            frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen)
            runs = {}
            for d, p in (("cpu", cpu), (dev, card)):
                cache = fam.init_cache(cfg, 2, 16, device=d)
                batch = {"frames": frames.to(d), "tokens": toks.to(d)}
                (lg, cache), n = counted(
                    lambda: fam.prefill(cfg, p, batch, cache))
                seq, ns = [lg], [n]
                for i in range(3):
                    nxt = torch.full((2, 1), 3 + i, dtype=torch.int32,
                                     device=d)
                    (lg, cache), n = counted(
                        lambda: fam.decode_step(cfg, p, cache, nxt))
                    seq.append(lg)
                    ns.append(n)
                runs[str(d)] = (seq, ns)
            hold_counts(what + " prefill", runs[str(dev)][1][0],
                        {"flash_attention": cfg.n_enc_layers + 2 * nl})
            for n in runs[str(dev)][1][1:]:
                hold_counts(what + " decode_step", n,
                            {"decode_attention": nl})
            r["logits_max_diff"] = max(
                fam_logits_check(what, a, b)
                for a, b in zip(runs[str(dev)][0], runs["cpu"][0]))
            out[arch] = r
            continue
        if cfg.family == "moe":
            runs = {}
            for d, p in (("cpu", cpu), (dev, card)):
                cache = fam.init_cache(cfg, 2, 16, device=d)
                (lg, cache), n = counted(
                    lambda: fam.prefill(cfg, p, toks.to(d), cache))
                seq, ns = [lg], [n]
                for i in range(3):
                    nxt = torch.full((2, 1), 5 + i, dtype=torch.int32,
                                     device=d)
                    (lg, cache), n = counted(
                        lambda: fam.decode_step(cfg, p, cache, nxt))
                    seq.append(lg)
                    ns.append(n)
                lg, n = counted(lambda: fam.logits_fn(cfg, p, toks.to(d)))
                runs[str(d)] = (seq + [lg], ns + [n])
            got, ns = runs[str(dev)]
            # prefill and logits_fn: one K4 a layer; the MLA decode is
            # einsums, grok's soft-capped one goes to sdpa
            for n, want in zip(ns, [nl, 0, 0, 0, nl]):
                hold_counts(what, n, {"flash_attention": want} if want
                            else {})
            r["logits_max_diff"] = max(
                fam_logits_check(what, a, b)
                for a, b in zip(got, runs["cpu"][0]))
            dc = MCTSDecodeConfig(num_actions=3, budget=8, lanes=2,
                                  search_depth=2, rollout_len=2)
            prompts = ([1, 2, 3, 4, 5], [7, 8])
            tc, n = counted(lambda: mcts_decode_batch(cfg, card, prompts, 2,
                                                      dc, device=dev))
            if tc != mcts_decode_batch(cfg, cpu, prompts, 2, dc,
                                       device="cpu"):
                fail(f"{what}: mcts_decode_batch card tokens differ from "
                     f"the CPU's")
            fwd = n.get("flash_attention", 0)
            if fwd == 0 or fwd % nl or n.get("decode_attention", 0):
                fail(f"{what}: mcts_decode_batch launched {n}: every "
                     f"generic step is a forward of {nl} K4 launches")
            r["mcts_tokens"], r["mcts_launches"] = tc, n
        else:                                  # vlm
            patches = torch.randn(2, cfg.n_patches, cfg.frontend_dim,
                                  generator=gen)
            lg, n = counted(lambda: fam.multimodal_logits(
                cfg, card, patches.to(dev), toks.to(dev)))
            hold_counts(what + " multimodal_logits", n,
                        {"flash_attention": nl})
            r["logits_max_diff"] = fam_logits_check(
                what, lg, fam.multimodal_logits(cfg, cpu, patches, toks))
        streams = []
        for d, p in (("cpu", cpu), (dev, card)):
            eng, reqs = rec_engine(cfg, p, REC_SMALL, "greedy", d)
            _, n = counted(eng.run_until_drained)
            streams.append({q.uid: q.out_tokens for q in reqs})
        want = {"flash_attention": nl * eng.stats.admissions}
        if cfg.family == "vlm":
            want["decode_attention"] = nl * eng.stats.steps
        hold_counts(what + " engine", n, want)
        if streams[0] != streams[1]:
            fail(f"{what}: engine card tokens {streams[1]} != CPU "
                 f"{streams[0]}")
        r["engine_tokens"] = streams[1]
        out[arch] = r
    counts = all_launches()                # read just after the phase
    say("families-small card == CPU (float32): " + "; ".join(
        f"{a} logits {v['logits_max_diff']:.2e}"
        + (" engine tokens" if "engine_tokens" in v else "")
        + (" mcts tokens" if "mcts_tokens" in v else "")
        for a, v in out.items())
        + "; launches " + ",".join(f"{k}={v}" for k, v in counts.items()
                                   if v))
    return out, counts


def k4_shapes(calls) -> dict:
    """K4 launches by q shape and v head dim."""
    out = {}
    for q, (k, v), kw, _ in calls:
        key = f"{list(q.shape)}/{v.shape[-1]}" + ("" if kw.get(
            "causal", True) else " non-causal") + (
            f" Sk {k.shape[1]}" if k.shape[1] != q.shape[1] else "")
        out[key] = out.get(key, 0) + 1
    return out


def engine_run(cfg, params, spec, dev, what, want_fn, calls=None,
               keep=None):
    """The greedy engine of ``spec`` driven to the end as one main path
    (counts set to 0 just before, read just after, held to ``want_fn(eng)``),
    the first step's attention calls kept in ``calls`` (``keep``).  Every
    request must emit its budget of tokens in the vocabulary."""
    eng, reqs = rec_engine(cfg, params, spec, "greedy", dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    if calls is not None:
        with attn_capture(calls, keep):
            eng.step()                     # the admissions and one step
    out = eng.run_until_drained()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_launches()                # read just after it
    hold_counts(what, {k: v for k, v in counts.items() if v},
                want_fn(eng))
    for q in reqs:
        if len(q.out_tokens) != spec["new_tokens"] or not all(
                0 <= t < cfg.vocab_size for t in q.out_tokens):
            fail(f"{what}: request {q.uid} emitted {q.out_tokens}")
    n_tok = sum(len(q.out_tokens) for q in reqs)
    return {"seconds": secs, "tokens": n_tok, "tokens_per_s": n_tok / secs,
            "steps": eng.stats.steps, "admissions": eng.stats.admissions,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "ttft_p50_s": out["stats"].get("serving/ttft_p50"),
            "latency_p50_s": out["latency_p50"], "launches": {
                k: v for k, v in counts.items() if v}}, counts


@contextlib.contextmanager
def route_capture(calls: list):
    """Keeps the router's input and result ``(x2d, gates, topi)`` of every
    ``moe.top_experts`` call inside the span (wrapped for the span, calls
    through)."""
    from repro_torch.models import moe as M
    fn = M.top_experts

    def call(cfg, p, x2d):
        out = fn(cfg, p, x2d)
        calls.append((x2d, out[0], out[1]))
        return out
    M.top_experts = call
    try:
        yield
    finally:
        M.top_experts = fn


def route_flips(pre, stp, b: int) -> dict:
    """The step's routing (``stp``, one token a row) against the longer
    prefill's at its last position (``pre``), MoE layer by layer: the
    (layer, row) pairs whose top-k expert sets differ; for each row its
    first such layer, the prefill's gap there between its k-th and
    (k+1)-th gate (a near tie when small), and the max |diff| of the
    router's input up to that layer (inclusive) and after it."""
    n = len(stp)
    first, flips, gaps, dx = [n] * b, 0, [], []
    for li, ((xp, gp, tp), (xs, _, ts)) in enumerate(zip(pre, stp)):
        xp, gp, tp = (t.view(b, -1, t.shape[-1])[:, -1] for t in (xp, gp, tp))
        differ = (ts.sort(-1).values != tp.sort(-1).values).any(-1).tolist()
        dx.append((xs.float() - xp.float()).abs().amax(-1).tolist())
        k = tp.shape[-1]
        top = gp.float().topk(k + 1, -1).values
        for r in range(b):
            flips += differ[r]
            if differ[r] and first[r] == n:
                first[r] = li
                gaps.append(float(top[r, k - 1] - top[r, k]))
    upto = max(dx[li][r] for r in range(b) for li in range(n)
               if li <= first[r])
    after = max((dx[li][r] for r in range(b) for li in range(n)
                 if li > first[r]), default=0.0)
    return {"layers": n, "flips": flips, "first_flip_layer": first,
            "first_flip_gate_gap": gaps, "router_in_upto_first_flip": upto,
            "router_in_after_first_flip": after}


def step_check(what, fam, cfg, params, toks, tol, zero, extra=None):
    """``prefill(prompt)`` then ``decode_step(token)`` against a prefill of
    the prompt one token longer (max |diff| of the logits within ``tol``);
    planted faults must read above it: the same step from a cache whose
    ``zero`` entries are zeroed, and the step one position late or early
    (the new token's cache row and angle).  ``extra`` adds the family's
    other prefill inputs.  For the MoE, the routing of each step is set
    beside the prefill's layer by layer (``route_flips``): up to each
    row's first top-k flip the router's input must agree within
    FAM_ROUTE_TOL, and each planted fault's must not."""
    b, s = toks.shape[0], toks.shape[1] - 1
    dev = toks.device
    moe = hasattr(fam, "top_experts")

    def batch(t):
        return t if extra is None else dict(extra, tokens=t)

    def routed(calls):
        return route_capture(calls) if moe else contextlib.nullcontext()
    _, cache = fam.prefill(cfg, params, batch(toks[:, :s]),
                           fam.init_cache(cfg, b, s + 8, device=dev))
    pre = []
    with routed(pre):
        full, _ = fam.prefill(cfg, params, batch(toks),
                              fam.init_cache(cfg, b, s + 8, device=dev))
    full = full.float()
    planted, planted_routes = {}, {}
    for name, off in (("zeroed " + "/".join(zero), 0), ("late", 1),
                      ("early", -1)):
        bad = {k: v.clone() for k, v in cache.items()}
        if off:
            bad["pos"] += off
        else:
            for k in zero:
                bad[k].zero_()
        stp = []
        with routed(stp):
            lg = fam.decode_step(cfg, params, bad, toks[:, s:])[0]
        planted[name] = max_diff(lg.float(), full)
        if moe:
            planted_routes[name] = route_flips(pre, stp, b)
    stp = []
    with routed(stp):
        got = fam.decode_step(cfg, params, cache, toks[:, s:])[0].float()
    rows = (got - full).abs().flatten(1).amax(1).tolist()
    err = max(rows)
    out = {"step_vs_prefill_max_abs": err, "rows": rows,
           "planted": planted, "tol": tol,
           "logit_abs_max": float(full.abs().max())}
    if err > tol:
        fail(f"{what}: prefill-then-decode_step differs from the longer "
             f"prefill by {err} (> {tol}; planted faults read {planted})")
    if min(planted.values()) <= tol:
        fail(f"{what}: planted faults read {planted}, one within {tol}: "
             f"the check cannot see it")
    if moe:
        out["routing"] = r = route_flips(pre, stp, b)
        out["planted_routing"] = {
            k: v["router_in_upto_first_flip"]
            for k, v in planted_routes.items()}
        if r["router_in_upto_first_flip"] > FAM_ROUTE_TOL:
            fail(f"{what}: up to each row's first routing flip the step's "
                 f"router input differs from the prefill's by "
                 f"{r['router_in_upto_first_flip']} (> {FAM_ROUTE_TOL}; "
                 f"{r})")
        if min(out["planted_routing"].values()) <= FAM_ROUTE_TOL:
            fail(f"{what}: planted faults' router inputs read "
                 f"{out['planted_routing']}, one within {FAM_ROUTE_TOL}: "
                 f"the check cannot see it")
    return out


def steps_summary(checks) -> str:
    """The MoE step checks of several token draws, in one phrase."""
    sound = max(r["step_vs_prefill_max_abs"] for r in checks)
    planted = min(min(r["planted"].values()) for r in checks)
    route = max(r["routing"]["router_in_upto_first_flip"] for r in checks)
    route_planted = min(min(r["planted_routing"].values()) for r in checks)
    gaps = [g for r in checks for g in r["routing"]["first_flip_gate_gap"]]
    return (f"sound max {sound} against planted min {planted} (limit "
            f"{FAM_STEP_TOL['moe']}); router input up to the first flip max "
            f"{route} against planted min {route_planted} (limit "
            f"{FAM_ROUTE_TOL}); gate gaps at first flips <= "
            f"{max(gaps, default=None)}")


def step_line(r: dict) -> str:
    """``step_check``'s result for a summary line."""
    out = (f"step vs prefill {r['step_vs_prefill_max_abs']} (limit "
           f"{r['tol']}; rows {r['rows']}; planted " + ", ".join(
               f"{k} {v}" for k, v in r["planted"].items()) + ")")
    if "routing" in r:
        x = r["routing"]
        out += (f"; routing vs prefill: {x['flips']} of {x['layers']} x "
                f"{len(r['rows'])} (layer, row) top-k sets differ, first at "
                f"layers {x['first_flip_layer']} (gate gaps there "
                f"{x['first_flip_gate_gap']}); router input max |diff| "
                f"{x['router_in_upto_first_flip']} up to each row's first "
                f"flip (limit {FAM_ROUTE_TOL}; planted " + ", ".join(
                    f"{k} {v}" for k, v in r["planted_routing"].items())
                + f"), {x['router_in_after_first_flip']} after")
    return out


def phase_moe_full(dev):
    """deepseek-v2-lite-16b at its published width (27 layers, 64 routed
    experts top-6 + 2 shared, MLA rank 512), bf16, random weights drawn
    on the card (seed 0): the greedy engine (MOE_GREEDY) and
    ``mcts_decode_batch`` (MOE_MCTS), each one main path with its launches
    held to what it implies (27 MLA K4 launches a prefill; the generic
    search's every step a forward of 27); the engine's K4 launches of its
    first step (the admissions) held to ``rounded_p_limit`` on their own
    operands; prefill-then-step against the longer prefill at
    moe_capacity 100.  Returns the run and the two paths' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.models.base import count_params
    from repro_torch.serving import MCTSDecodeConfig, mcts_decode_batch
    cfg = get_config(MOE_ARCH)
    nl, what = cfg.n_layers, f"moe-full {cfg.name}"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init(cfg, seed=FAM_SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    weight_bytes = torch.cuda.memory_allocated()
    # warm: the kernels' and GEMMs' first calls outside the timed run
    M.prefill(cfg, params, torch.zeros((1, 64), dtype=torch.int32,
                                       device=dev),
              M.init_cache(cfg, 1, 72, device=dev))
    calls: list = []
    run, counts = engine_run(
        cfg, params, MOE_GREEDY, dev, what + " engine",
        lambda e: {"flash_attention_bf16_mla": nl * e.stats.admissions},
        calls, lambda name, q, args: name == "flash_attention")
    run["k4_shapes"] = k4_shapes(calls)
    run["k4_check"] = carry_k4_check(what + " engine K4", calls)
    del calls
    # mcts_decode_batch through the generic fallback
    prompts = rec_prompts(cfg.vocab_size, MOE_MCTS, FAM_SEED + 9)
    dc = MCTSDecodeConfig(**{k: MOE_MCTS[k] for k in (
        "num_actions", "budget", "lanes", "search_depth", "rollout_len")})
    seen: dict = {}

    def first_forwards(name, q, args):
        # the first forward (nl launches) at each [rows, S] of the search's
        # batched forwards over several rows
        if name != "flash_attention" or q.shape[0] < 2:
            return False
        seen[q.shape] = seen.get(q.shape, 0) + 1
        return seen[q.shape] <= nl
    calls = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with attn_capture(calls, first_forwards):
        toks = mcts_decode_batch(cfg, params, prompts,
                                 MOE_MCTS["new_tokens"], dc, device=dev)
    torch.cuda.synchronize()
    msecs = time.perf_counter() - t0
    mcounts = all_launches()               # read just after it
    m = {k: v for k, v in mcounts.items() if v}
    fwd = m.get("flash_attention_bf16_mla", 0)
    if fwd == 0 or fwd % nl or any(m.get(k, 0) for k in (
            "flash_attention", "flash_attention_bf16", "decode_attention")):
        fail(f"{what} mcts: launched {m}: every generic step is a forward "
             f"of {nl} MLA K4 launches")
    if any(len(t) != MOE_MCTS["new_tokens"] or not all(
            0 <= x < cfg.vocab_size for x in t) for t in toks):
        fail(f"{what} mcts: tokens missing or outside the vocabulary")
    if not calls:
        fail(f"{what} mcts: no forward over several rows was launched")
    run["mcts"] = {"seconds": msecs, "tokens": toks, "launches": m,
                   "forwards": m["flash_attention_bf16_mla"] // nl,
                   "tokens_per_s": len(prompts) * MOE_MCTS["new_tokens"]
                   / msecs, "k4_shapes": k4_shapes(calls),
                   "k4_check": carry_k4_check(what + " mcts K4", calls)}
    del calls
    gens = [torch.Generator().manual_seed(FAM_SEED + 3 + i)
            for i in range(MOE_STEP_DRAWS)]
    run["step_checks"] = [step_check(
        f"{what} (draw {i})", M, cfg.replace(moe_capacity=100.0), params,
        torch.randint(0, cfg.vocab_size, (4, 129), generator=g,
                      dtype=torch.int32).to(dev),
        FAM_STEP_TOL["moe"], ("ckv", "krope")) for i, g in enumerate(gens)]
    gen = gens[0]
    run.update(init_s=init_s, n_params=n_params, weight_bytes=weight_bytes)
    # where the time goes: one engine step over 8 live slots, one prefill
    # of 384 tokens (chiprun_out/profile_fam.txt)
    lines, run["profile"] = [], {}
    eng, _ = rec_engine(cfg, params, MOE_GREEDY, "greedy", dev)
    eng.step()                             # admits and prefills all slots
    pt = torch.randint(0, cfg.vocab_size, (1, MOE_GREEDY["prompt_max"]),
                       generator=gen, dtype=torch.int32).to(dev)
    for key, label, fn in (
            ("step", f"one engine step over {MOE_GREEDY['max_batch']} live "
             f"slots", eng.step),
            ("prefill", f"one prefill of {pt.shape[1]} tokens",
             lambda: M.prefill(cfg, params, pt, M.init_cache(
                 cfg, 1, pt.shape[1], device=dev)))):
        summary, table = profile_one(f"{cfg.name} greedy: {label}", fn)
        if summary:
            run["profile"][key] = summary
            lines += table
    write_out("profile_fam.txt", lines)
    del eng
    say(f"moe-full {cfg.name} ({n_params / 1e9:.3f} B parameters, "
        f"{weight_bytes / 2**30:.2f} GiB, drawn on the card in {init_s:.2f} "
        f"s): engine {run['tokens']} tokens in {run['seconds']:.3f} s = "
        f"{run['tokens_per_s']:.2f} tokens/s, TTFT p50 "
        f"{run['ttft_p50_s']}, peak {run['peak_mem_bytes'] / 2**30:.2f} "
        f"GiB, launches {run['launches']} ({run['admissions']} prefills x "
        f"{nl}); K4 {run['k4_check']['calls']} launches of the admissions "
        f"{100 * run['k4_check']['limit_share']:.1f}% of their limit "
        f"(planted {run['k4_check']['planted_share']:.1f}x), shapes "
        f"{run['k4_shapes']}; mcts {run['mcts']['tokens']} in {msecs:.3f} "
        f"s, launches {m} ({run['mcts']['forwards']} forwards), K4 "
        f"{run['mcts']['k4_check']['calls']} launches of its first forwards "
        f"{100 * run['mcts']['k4_check']['limit_share']:.1f}% of their "
        f"limit (planted {run['mcts']['k4_check']['planted_share']:.1f}x), "
        f"shapes {run['mcts']['k4_shapes']}; draw 0 "
        f"{step_line(run['step_checks'][0])}; over {MOE_STEP_DRAWS} draws "
        f"{steps_summary(run['step_checks'])}")
    del params
    torch.cuda.empty_cache()
    return run, (counts, mcounts)


def phase_vlm_full(dev):
    """internvl2-2b at its published width (random bf16 weights, seed 0):
    ``multimodal_logits`` on 4 x (256 patches + 128 tokens) (24 K4 launches
    [4, 384, 16, 128], GQA 16 / 8) and the greedy engine (VLM_GREEDY: 24
    K4 a prefill, 24 K3 a step), each one main path; the K4 launches of
    ``multimodal_logits`` held to ``rounded_p_limit`` and the K3 launches
    of the engine's first step to the plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models import vlm as V
    from repro_torch.models.base import count_params
    cfg = get_config(VLM_ARCH)
    nl, what = cfg.n_layers, f"vlm-full {cfg.name}"
    params = V.init(cfg, seed=FAM_SEED, device=dev)
    n_params = count_params(params)
    gen = torch.Generator(dev).manual_seed(FAM_SEED + 11)
    b, st = VLM_MM["batch"], VLM_MM["text"]
    patches = torch.randn(b, cfg.n_patches, cfg.frontend_dim, generator=gen,
                          device=dev).to(cfg.jdtype)
    text = torch.randint(0, cfg.vocab_size, (b, st), generator=gen,
                         device=dev)
    V.multimodal_logits(cfg, params, patches, text)            # warm
    calls: list = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with attn_capture(calls, lambda name, q, args: True):
        lg = V.multimodal_logits(cfg, params, patches, text)
    torch.cuda.synchronize()
    mm_s = time.perf_counter() - t0
    mm_counts = all_launches()             # read just after it
    hold_counts(what + " multimodal_logits",
                {k: v for k, v in mm_counts.items() if v},
                {"flash_attention_bf16": nl})
    if tuple(lg.shape) != (b, cfg.n_patches + st, cfg.vocab_size) \
            or not bool(torch.isfinite(lg).all()):
        fail(f"{what}: multimodal_logits gave {tuple(lg.shape)} or "
             f"non-finite values")
    run = {"multimodal": {"seconds": mm_s, "k4_shapes": k4_shapes(calls),
                          "k4_check": carry_k4_check(what + " K4", calls)}}
    del calls, lg
    calls = []
    er, counts = engine_run(
        cfg, params, VLM_GREEDY, dev, what + " engine",
        lambda e: {"flash_attention_bf16": nl * e.stats.admissions,
                   "decode_attention": nl * e.stats.steps}, calls,
        lambda name, q, args: name == "decode_attention")
    run.update(er)
    run["k3_check"] = carry_k3_check(what + " engine K3", calls[:nl])
    run["n_params"] = n_params
    say(f"vlm-full {cfg.name} ({n_params / 1e9:.3f} B parameters): "
        f"multimodal_logits [{b}, {cfg.n_patches} + {st}] in {mm_s:.4f} s, "
        f"K4 {run['multimodal']['k4_shapes']} "
        f"{100 * run['multimodal']['k4_check']['limit_share']:.1f}% of its "
        f"limit; engine {run['tokens']} tokens in {run['seconds']:.3f} s = "
        f"{run['tokens_per_s']:.2f} tokens/s, TTFT p50 {run['ttft_p50_s']}, "
        f"peak {run['peak_mem_bytes'] / 2**30:.2f} GiB, launches "
        f"{run['launches']}; K3 first step bf16 {run['k3_check']['bf16']} "
        f"({100 * run['k3_check']['f32_limit_share']:.1f}% of its limit)")
    del params, calls
    torch.cuda.empty_cache()
    return run, (mm_counts, counts)


def phase_whisper_full(dev):
    """whisper-base at its published width (random bf16 weights, seed 0):
    ``prefill`` on 4 x 1500 frames and 32-token prompts (K4: 6 encoder
    launches [4, 1500, 8, 64] non-causal, 6 decoder causal, 6 cross with
    Sk 1500), then 32 greedy ``decode_step``s, 33 tokens a row with the
    prefill's (K3: 6 a step; the one-query
    cross attention goes to sdpa), one main path; its K4 launches held to
    ``rounded_p_limit`` and the first step's K3 to the plain version;
    prefill-then-step against the longer prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import whisper as W
    from repro_torch.models.base import count_params
    cfg = get_config(WHISPER_ARCH)
    nl, what = cfg.n_layers, f"whisper-full {cfg.name}"
    params = W.init(cfg, seed=FAM_SEED, device=dev)
    gen = torch.Generator(dev).manual_seed(FAM_SEED + 13)
    b, s, n_new = WHISPER_RUN["batch"], WHISPER_RUN["prompt"], \
        WHISPER_RUN["new_tokens"]
    frames = torch.randn(b, cfg.enc_seq, cfg.d_model, generator=gen,
                         device=dev).to(cfg.jdtype)
    toks = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    W.prefill(cfg, params, {"frames": frames, "tokens": toks[:, :s]},
              W.init_cache(cfg, b, s + n_new, device=dev))       # warm
    calls: list = []
    cache = W.init_cache(cfg, b, s + n_new, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with attn_capture(calls, lambda name, q, args: True):
        lg, cache = W.prefill(cfg, params, {"frames": frames,
                                            "tokens": toks[:, :s]}, cache)
        nxt = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        out = [nxt]
        lg, cache = W.decode_step(cfg, params, cache, nxt)
    for _ in range(n_new - 1):
        nxt = lg[:, -1].argmax(-1)[:, None].to(torch.int32)
        out.append(nxt)
        lg, cache = W.decode_step(cfg, params, cache, nxt)
    out.append(lg[:, -1].argmax(-1)[:, None].to(torch.int32))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = all_launches()                # read just after it
    peak = torch.cuda.max_memory_allocated()
    hold_counts(what, {k: v for k, v in counts.items() if v},
                {"flash_attention_bf16": cfg.n_enc_layers + 2 * nl,
                 "decode_attention": nl * n_new})
    gen_toks = torch.cat(out, 1)
    if tuple(gen_toks.shape) != (b, n_new + 1) or not bool(
            ((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()):
        fail(f"{what}: tokens missing or outside the vocabulary")
    k4 = [c for c in calls if len(c[1]) == 2]
    k3 = [c for c in calls if len(c[1]) == 3]
    run = {"seconds": secs, "ttft_s": ttft,
           "tokens_per_s": b * (n_new + 1) / secs,
           "peak_mem_bytes": peak, "n_params": count_params(params),
           "launches": {k: v for k, v in counts.items() if v},
           "k4_shapes": k4_shapes(k4),
           "k4_check": carry_k4_check(what + " K4", k4),
           "k3_check": carry_k3_check(what + " K3", k3)}
    del calls, k4, k3
    run["step_check"] = step_check(
        what, W, cfg, params, toks, FAM_STEP_TOL["whisper"], ("k", "v"),
        extra={"frames": frames})
    say(f"whisper-full {cfg.name} ({run['n_params'] / 1e6:.1f} M "
        f"parameters): prefill [{b} x {cfg.enc_seq} frames, {s} tokens] + "
        f"{n_new} steps in {secs:.3f} s = {run['tokens_per_s']:.2f} "
        f"tokens/s, TTFT {ttft:.4f} s, peak {peak / 2**30:.2f} GiB, "
        f"launches {run['launches']}; K4 {run['k4_shapes']} "
        f"{100 * run['k4_check']['limit_share']:.1f}% of its limit "
        f"(planted {run['k4_check']['planted_share']:.1f}x); K3 bf16 "
        f"{run['k3_check']['bf16']}; {step_line(run['step_check'])}")
    del params
    torch.cuda.empty_cache()
    return run, (counts,)


# ---------------------------------------------------------------------------
# training (the dense family): kernel A (K4 writing its logsumexp) and
# kernel B (the flash backward) against their plain versions, smoke-config
# steps card == CPU, smollm-135m at its published width under the
# fault-tolerant loop, and the serving driver
# ---------------------------------------------------------------------------
TRAIN_ARCH = "smollm-135m"
TRAIN_KERNELS = ("flash_attention_lse", "flash_attention_bwd", "wkv6_bwd",
                 "ssd_bwd", "flash_attention_bwd_mla")     # training
TRAIN_SMALL_ARCHS = ("smollm-135m", "qwen2-0.5b", "minicpm-2b",
                     "stablelm-3b")
TRAIN_SMALL = dict(batch=2, seq=40, steps=3, lr=1e-3)
# smollm's pre-training context: 8 x 2048 = 16,384 tokens a step
TRAIN_FULL = dict(batch=8, seq=2048, steps=12, ckpt_every=5, fail_at=7,
                  lr=3e-4, timed=5)
# the train-kernels shapes (name, B, Sq, Sk, H, Hkv, D, dtype, knobs[, Dv]):
# smollm-135m's and stablelm-3b's training attention in bf16; the bf16
# kernels' tails and knobs (Sq, Sk not multiples of the 64 tile, q_offset,
# seq_k_valid < Sk, a soft cap, GQA, non-causal) and grok's soft cap at its
# head dim, 128; the float32 knobs at the smoke head dim
TRAIN_KERNEL_SHAPES = (
    ("smollm", 8, 2048, 2048, 9, 3, 64, "bf16", dict(causal=True)),
    ("stablelm", 2, 1024, 1024, 32, 32, 80, "bf16", dict(causal=True)),
    ("bf16-knobs", 2, 77, 77, 4, 2, 64, "bf16",
     dict(causal=True, q_offset=5, seq_k_valid=70, logits_soft_cap=3.0)),
    ("bf16-noncausal", 2, 77, 90, 4, 2, 64, "bf16", dict(causal=False)),
    ("grok-cap", 1, 512, 512, 8, 2, 128, "bf16",
     dict(causal=True, logits_soft_cap=30.0)),
    ("f32-knobs", 2, 77, 77, 4, 2, 16, "f32",
     dict(causal=True, q_offset=5, seq_k_valid=70, logits_soft_cap=3.0)),
    # the other families' training attention: zamba2-1.2b's shared block,
    # internvl2-2b's GQA, whisper-base's encoder (Sq = Sk = 1500, not a
    # multiple of 64) and cross attention (non-causal) and decoder
    ("zamba2", 8, 2048, 2048, 32, 32, 128, "bf16", dict(causal=True)),
    ("internvl2", 8, 2048, 2048, 16, 8, 128, "bf16", dict(causal=True)),
    ("whisper-enc", 16, 1500, 1500, 8, 8, 64, "bf16", dict(causal=False)),
    ("whisper-cross", 16, 448, 1500, 8, 8, 64, "bf16", dict(causal=False)),
    ("whisper-dec", 16, 448, 448, 8, 8, 64, "bf16", dict(causal=True)),
    # deepseek-v2-lite's MLA at its training shape (DeepSeek-V2's 4K
    # context, 4 x 4096 tokens), (192, 128) on the two-warpgroup dK / dV
    # kernel; then its tails with q_offset, seq_k_valid and GQA, and the
    # non-causal route
    ("deepseek", 4, 4096, 4096, 16, 16, 192, "bf16", dict(causal=True), 128),
    ("mla-knobs", 2, 77, 77, 4, 2, 192, "bf16",
     dict(causal=True, q_offset=5, seq_k_valid=70), 128),
    ("mla-noncausal", 2, 77, 90, 4, 4, 192, "bf16",
     dict(causal=False, seq_k_valid=83), 128))
# kernel A's lse against the plain version in float32 on the same inputs,
# absolute: the scores summed in another order, exp2 / log2 against exp /
# log, of values up to log(2048) + max score
LSE_TOL = 1e-4
# kernel B's dq / dk / dv against the plain version run in float32 on the
# same operands, normwise (max |got - want| / max |want|): float32, the
# order of the sums; bf16, the kernel rounds each gradient to bf16 once
# (half a bf16 ulp of the largest element), doubled for the sums
TRAIN_GRAD_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
# the float32 smoke steps, card against CPU (the kernels against the plain
# versions and cuBLAS against the CPU's float32 products, no TF32): loss
# and lr relative, grad_norm relative, parameters absolute + relative
TRAIN_SMALL_TOL = dict(loss=1e-5, grad_norm=1e-4, atol=2e-5, rtol=1e-4)
# smollm-135m's step 0 in bf16, the kernels against the plain versions on
# the card: the bf16 forward's roundings (P before PV, the activations)
# flip where the float32 sums differ and spread through 30 layers; held
# per stacked leaf and layer normwise
TRAIN_FULL_TOL = dict(loss=2e-3, grad_norm=2e-2, leaf=5e-2)


def visible_pairs(b, sq, sk, h, causal=True, q_offset=0, seq_k_valid=None,
                  **_):
    """(row, key) pairs an attention call computes: keys below
    seq_k_valid and, causal, at or below the row's position."""
    kv = sk if seq_k_valid is None else min(seq_k_valid, sk)
    if not causal:
        return b * h * sq * kv
    n = sum(max(0, min(kv, i + q_offset + 1)) for i in range(sq))
    return b * h * n


def train_bounds(q, k, v, kw):
    """(kernel A's bound, kernel B's bound): every operand read and result
    written once (lse float32), against 2 D flops per visible pair for
    each product over the q/k head dim and 2 Dv for each over the v head
    dim (A: QK^T and PV, 2 (D + Dv); B: QK^T, dK and dQ over D, dO V^T and
    dV over Dv, 2 (3 D + 2 Dv)) at the peak of the inputs' type."""
    b, sq, h, d = q.shape
    sk, dv = k.shape[1], v.shape[-1]
    es = q.element_size()
    peak = BF16_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    pairs = visible_pairs(b, sq, sk, h, **kw)
    io = q.numel() + k.numel() + v.numel() + b * sq * h * v.shape[-1]
    lse = 4 * b * h * sq
    # A: q, k, v in, out and lse out; B: q, k, v, out, dout and lse in,
    # dq, dk, dv out
    return (bound_ms(es * io + lse, 2 * (d + dv) * pairs, peak),
            bound_ms(es * 2 * io + lse, 2 * (3 * d + 2 * dv) * pairs, peak))


def normwise(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def train_kernel_case(dev, spec):
    """Kernels A and B at one shape against their plain versions: A's
    output equal to the serving kernel's bit for bit and its lse within
    LSE_TOL (a planted fault, the diagonal one position late or, without
    causal, the last valid key dropped, above it); B
    within TRAIN_GRAD_TOL normwise (a planted fault, one kv head's dk
    zeroed, far above it).  Then the times of A, B and their plain
    versions, in turns with SDPA's forward / backward where SDPA computes
    the same function (causal, no offset, cap or padding)."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as R
    name, b, sq, sk, h, hkv, d, dts, kw = spec[:9]
    dv = spec[9] if len(spec) > 9 else d
    dt = torch.bfloat16 if dts == "bf16" else torch.float32
    gen = torch.Generator(dev).manual_seed(31)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).to(dt)  # noqa
    q, k, v, dout = rnd(b, sq, h, d), rnd(b, sk, hkv, d), \
        rnd(b, sk, hkv, dv), rnd(b, sq, h, dv)
    out, lse = FA.flash_attention_lse(q, k, v, **kw)
    if not torch.equal(out, FA.flash_attention(q, k, v, **kw)):
        fail(f"train-kernels {name}: kernel A's output differs from the "
             "serving kernel's on the same inputs")
    f32 = [t.float() for t in (q, k, v)]
    blk = dict(blk_q=min(256, sq), blk_k=min(1024, sk))
    out_ref, lse_ref = R.blocked_fwd_ref(*f32, **blk, **kw)
    lse_err = max_diff(lse, lse_ref)
    # planted: the diagonal one position late, or without causal the last
    # valid key dropped
    bad_kw = (dict(kw, q_offset=kw.get("q_offset", 0) + 1) if kw["causal"]
              else dict(kw, seq_k_valid=kw.get("seq_k_valid", sk) - 1))
    _, lse_bad = FA.flash_attention_lse(q, k, v, **bad_kw)
    planted_lse = max_diff(lse_bad, lse_ref)
    if lse_err > LSE_TOL or planted_lse <= LSE_TOL:
        fail(f"train-kernels {name}: kernel A's lse differs from the plain "
             f"version by {lse_err} (limit {LSE_TOL}; planted fault "
             f"{planted_lse})")
    grads = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = R.blocked_bwd_ref(*f32, out.float(), lse, dout.float(), **blk,
                             **kw)
    tol = TRAIN_GRAD_TOL[dts]
    errs = {n: normwise(g, w) for n, g, w in zip(("dq", "dk", "dv"), grads,
                                                  want)}
    bad = grads[1].clone()
    bad[:, :, 0] = 0
    planted = normwise(bad, want[1])
    if max(errs.values()) > tol or planted <= 10 * tol:
        fail(f"train-kernels {name}: kernel B's gradients differ from the "
             f"plain version normwise by {errs} (limit {tol}; planted fault "
             f"{planted})")
    again = FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    if not all(torch.equal(x, y) for x, y in zip(grads, again)):
        fail(f"train-kernels {name}: two launches of kernel B on the same "
             "inputs differ")
    res = {"shape": [b, sq, sk, h, hkv, d, dv], "dtype": dts, "knobs": kw,
           "lse_err": lse_err, "lse_planted": planted_lse,
           "out_abs_err": max_diff(out, out_ref),
           "grad_normwise": errs, "grad_planted": planted,
           "grad_abs_err": max(max_diff(g, w) for g, w in zip(grads, want))}
    torch.cuda.synchronize()
    import torch.nn.functional as F
    ca = {"ms": (lambda _: FA.flash_attention_lse(q, k, v, **kw), {}),
          "plain_ms": (lambda _: FA.flash_attention_lse(q, k, v, impl="ref",
                                                        **kw),
                       {"reps": PLAIN_REPS})}
    cb = {"ms": (lambda _: FA.flash_attention_bwd(q, k, v, out, lse, dout,
                                                  **kw), {}),
          "plain_ms": (lambda _: FA.flash_attention_bwd(
              q, k, v, out, lse, dout, impl="ref", **kw),
              {"reps": PLAIN_REPS})}
    if set(kw) == {"causal"} and (sq == sk or not kw["causal"]):
        # SDPA computes the same function (no offset, cap or padding)
        gqa, causal = hkv != h, kw["causal"]
        qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                            enable_gqa=gqa)
        do = dout.transpose(1, 2)
        ca["sdpa_ms"] = (lambda _: sdpa_fn(q, k, v, is_causal=causal,
                                           enable_gqa=gqa), {})
        cb["sdpa_ms"] = (lambda _: torch.autograd.grad(
            so, (qs, ks, vs), do, retain_graph=True), {})
        if dv != d:      # which of SDPA's backends takes D != Dv
            res["sdpa_backend"] = sdpa_backend(q, k, v, is_causal=causal,
                                               enable_gqa=gqa)
            res["sdpa_kernels"] = device_kernels(ca["sdpa_ms"][0])
    ba, bb = train_bounds(q, k, v, kw)
    res["a"] = dict({"sdpa_ms": None}, **time_turns(ca), bound=ba)
    res["b"] = dict({"sdpa_ms": None}, **time_turns(cb), bound=bb)
    if name == "smollm":                 # the main path's shape
        HOST["flash_attention_lse"] = host_us(
            lambda _: FA.flash_attention_lse(q, k, v, **kw))
        HOST["flash_attention_bwd"] = host_us(
            lambda _: FA.flash_attention_bwd(q, k, v, out, lse, dout, **kw))
    return res


def phase_train_kernels(dev):
    """Kernels A and B at TRAIN_KERNEL_SHAPES (see ``train_kernel_case``),
    each timed; the kernels line's rows carry smollm-135m's training
    shape (the main path's).  Returns those rows for
    ``flash_attention_lse`` and ``flash_attention_bwd`` (less their
    launches) and the checks."""
    cases = {spec[0]: train_kernel_case(dev, spec)
             for spec in TRAIN_KERNEL_SHAPES}
    mla = lambda c: (c["dtype"] == "bf16"                       # noqa: E731
                     and c["shape"][5] != c["shape"][6])
    rows = {}
    for key, part, name, err in (
            ("flash_attention_lse", "a", "smollm",
             max(c["lse_err"] for c in cases.values())),
            ("flash_attention_bwd", "b", "smollm",
             max(c["grad_abs_err"] for c in cases.values() if not mla(c))),
            ("flash_attention_bwd_mla", "b", "deepseek",
             max(c["grad_abs_err"] for c in cases.values() if mla(c)))):
        p = cases[name][part]
        rows[key] = {"max_abs_err": err, "ms": p["ms"],
                     "plain_ms": p["plain_ms"], "bound": p["bound"],
                     "sdpa_ms": p["sdpa_ms"]}
    say("train-kernels " + "; ".join(
        f"{n} {c['dtype']} {c['shape']}: lse err {c['lse_err']:.2e} "
        f"(planted {c['lse_planted']:.2e}), grads normwise "
        + ",".join(f"{g}={e:.2e}" for g, e in c["grad_normwise"].items())
        + f" (planted {c['grad_planted']:.2e}), B twice bit-equal; "
        + ", ".join(
            f"{x} ms={c[x]['ms']:.4f},plain_ms={c[x]['plain_ms']:.4f},"
            f"sdpa_ms={c[x]['sdpa_ms']},bound_ms={c[x]['bound'][0]:.5f} "
            f"({c[x]['bound'][1]})" for x in ("a", "b"))
        for n, c in cases.items())
        + f"; host_us A={HOST['flash_attention_lse']:.1f} "
        f"B={HOST['flash_attention_bwd']:.1f} (A: flash_attention_lse, B: "
        "flash_attention_bwd, sdpa_ms of B: SDPA's backward); SDPA's "
        f"backend at (192, 128): {cases['deepseek'].get('sdpa_backend')} "
        "(forward and backward), its forward's kernels "
        + json.dumps(cases["deepseek"].get("sdpa_kernels")))
    return rows, cases


def add_counts(total: dict, got: dict) -> None:
    for k, n in got.items():
        total[k] = total.get(k, 0) + n


def hold_trees(what, got, want, atol, rtol) -> float:
    """Every leaf of ``got`` within ``atol + rtol |want|`` of ``want``'s;
    returns the largest |diff|."""
    from repro_torch.core.pytree import flatten
    worst = 0.0
    for g, w in zip(flatten(got)[0], flatten(want)[0]):
        g, w = g.detach().cpu().double(), w.detach().cpu().double()
        d = (g - w).abs()
        if bool((d > atol + rtol * w.abs()).any()):
            fail(f"{what}: a leaf differs by {float(d.max())} (limit {atol} "
                 f"+ {rtol} |want|)")
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def phase_train_small(dev, counts: dict):
    """``make_train_step`` for TRAIN_SMALL["steps"] steps on each dense
    smoke config (AdamW; WSD for minicpm, cosine otherwise), on the card
    from the port's ``init`` against the same on the CPU: losses, lr,
    grad_norm and the parameters within TRAIN_SMALL_TOL; each card step
    launches the kernels ``train_launches`` names (no remat at smoke
    size).  Then one 2-microbatch ``make_grad_accum_train_step`` on
    smollm, then the smoke configs of TRAIN_FAM_ARCHS (rwkv6, zamba2, the
    VLM, Whisper: the K5 / K6 forward and backward kernels in float32 and
    kernels A / B), whose attention key biases are left out of the
    parameters held (SHIFT_INVARIANT), and of TRAIN_MOE_ARCHS (deepseek's
    MLA, grok's soft-capped GQA: kernels A / B in float32 with the MoE
    dispatch; grok trains at this size only).  The card steps' launches add to
    ``counts``."""
    import functools
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.steps import (make_grad_accum_train_step,
                                          make_train_step)
    from repro_torch.launch.train import schedule
    from repro_torch.models.base import get_family, tree_to
    from repro_torch.optim import adamw
    tol = TRAIN_SMALL_TOL
    sp = TRAIN_SMALL
    out = {}
    for arch in TRAIN_SMALL_ARCHS + ("accum",) + TRAIN_FAM_ARCHS \
            + TRAIN_MOE_ARCHS:
        cfg = get_smoke_config(TRAIN_ARCH if arch == "accum" else arch)
        opt = adamw()
        sched = schedule(cfg.name, sp["lr"], 10)
        n_micro = 2 if arch == "accum" else 0
        step = make_grad_accum_train_step(cfg, opt, sched, n_micro) \
            if n_micro else make_train_step(cfg, opt, sched)
        pc = get_family(cfg).init(cfg, seed=0, device="cpu")
        oc = opt.init(pc)
        pd, od = tree_to(pc, dev), tree_to(oc, dev)
        dcfg = DataConfig(batch_size=sp["batch"] * max(n_micro, 1),
                          seq_len=sp["seq"])
        worst = {"loss": 0.0, "grad_norm": 0.0}
        for s in range(1 if n_micro else sp["steps"]):
            batch = synthetic_batch(cfg, dcfg, s)
            if n_micro:
                batch = {k: v.reshape((n_micro, -1) + v.shape[1:])
                         for k, v in batch.items()}
            (pd, od, md), c = counted(lambda: step(pd, od, batch))
            hold_counts(f"train-small {arch} step {s}", c, {
                k: n * max(n_micro, 1)
                for k, n in train_launches(cfg, sp["seq"]).items()})
            add_counts(counts, c)
            pc, oc, mc = step(pc, oc, batch)
            for key in ("loss", "lr", "grad_norm"):
                a, w = float(md[key]), float(mc[key])
                r = abs(a - w) / max(abs(w), 1e-30)
                if r > tol["grad_norm" if key == "grad_norm" else "loss"]:
                    fail(f"train-small {arch} step {s}: {key} {a} on the "
                         f"card, {w} on the CPU")
                if key in worst:
                    worst[key] = max(worst[key], r)
        if int(od["step"]) != int(oc["step"]):
            fail(f"train-small {arch}: optimizer steps differ")
        keep = (lambda t: t) if arch in TRAIN_SMALL_ARCHS + ("accum",) \
            else functools.partial(drop_leaves, names=SHIFT_INVARIANT)
        worst["params"] = hold_trees(f"train-small {arch} parameters",
                                     keep(pd), keep(pc), tol["atol"],
                                     tol["rtol"])
        worst["adam_m"] = hold_trees(f"train-small {arch} Adam m", od["m"],
                                     oc["m"], tol["atol"], tol["rtol"])
        out[arch] = worst
    say("train-small " + "; ".join(
        f"{a}: loss rel {w['loss']:.1e}, grad_norm rel {w['grad_norm']:.1e},"
        f" params max |diff| {w['params']:.1e}" for a, w in out.items())
        + f" (card == CPU over {sp['steps']} steps, 1 for the 2-microbatch "
        "accum step; limits " + json.dumps(tol) + ")")
    return out


def leaf_errors(got, want, stacked=("layers",), skip=()) -> dict:
    """Normwise error of every stacked leaf's layer slice (leaves under a
    root in ``stacked``) and of every other leaf, by path; leaves named in
    ``skip`` and empty leaves are left out."""
    out = {}

    def walk(g, w, path):
        if isinstance(g, dict):
            for k in g:
                walk(g[k], w[k], path + (k,))
        elif isinstance(g, list):         # the MoE's dense_layers
            for i, (gi, wi) in enumerate(zip(g, w)):
                walk(gi, wi, path + (str(i),))
        elif path[-1] in skip or g.numel() == 0:
            return
        elif path[0] in stacked:
            for i in range(g.shape[0]):
                out["/".join(path) + f"[{i}]"] = normwise(g[i], w[i])
        else:
            out["/".join(path)] = normwise(g, w)
    walk(got, want, ())
    return out


def phase_train_full(dev, counts: dict):
    """smollm-135m at its published width (bf16, remat, ce_chunk 512)
    through ``launch.train.build`` (AdamW + cosine, clip 1.0) at
    TRAIN_FULL: step 0's loss, grad norm and every leaf's gradient with
    the kernels against the plain versions on the card within
    TRAIN_FULL_TOL, a planted fault (one layer's dK zeroed) above it;
    kernel A / B launches a step (remat: two forwards and one backward a
    layer); TRAIN_FULL["timed"] steps timed and one traced
    (``profile_train.txt``); then TRAIN_FULL["steps"]
    steps under ``TrainerLoop`` with a checkpoint every ``ckpt_every``,
    uninterrupted and with a transient failure at ``fail_at`` restarted
    by ``train_with_restarts``: the losses after the restart equal the
    uninterrupted run's bit for bit."""
    import contextlib
    import functools
    import shutil
    from repro_torch.data import Prefetcher, make_batch_iterator
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import train
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.base import count_params, get_family
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.runtime.ft import (FTConfig, TrainerLoop,
                                        train_with_restarts)
    tf = TRAIN_FULL
    cfg, step_fn, params, opt0, dcfg = train.build(
        TRAIN_ARCH, False, tf["batch"], tf["seq"], tf["lr"], tf["steps"],
        device=dev)
    if not (cfg.remat and cfg.jdtype == torch.bfloat16
            and cfg.ce_chunk == 512):
        fail(f"train-full: {cfg.name} is not bf16 / remat / ce_chunk 512")
    fam = get_family(cfg)
    batch0 = {k: torch.as_tensor(v).to(dev)
              for k, v in synthetic_batch(cfg, dcfg, 0).items()}

    def grads_of():
        (loss, _), g = value_and_grad(
            lambda p: fam.loss_fn(cfg, p, batch0), params)
        return float(loss), g, float(clip_by_global_norm(g, 1.0)[1])

    @contextlib.contextmanager
    def patched(**fns):
        old = {k: getattr(FA, k) for k in fns}
        for k, f in fns.items():
            setattr(FA, k, f)
        try:
            yield
        finally:
            for k, f in old.items():
                setattr(FA, k, f)

    (loss_k, g_k, gn_k), c0 = counted(grads_of)
    want0 = {"flash_attention_lse": 2 * cfg.n_layers,
             "flash_attention_bwd": cfg.n_layers}
    hold_counts("train-full step 0's gradient", c0, want0)
    with patched(flash_attention_lse=functools.partial(
            FA.flash_attention_lse, impl="ref"),
            flash_attention_bwd=functools.partial(
                FA.flash_attention_bwd, impl="ref")):
        loss_p, g_p, gn_p = grads_of()
    real_bwd, calls = FA.flash_attention_bwd, []

    def zero_dk_once(*a, **kw):           # layer 15's dK (backward order)
        dq, dk, dv = real_bwd(*a, **kw)
        calls.append(1)
        return (dq, torch.zeros_like(dk), dv) if len(calls) == 15 \
            else (dq, dk, dv)
    with patched(flash_attention_bwd=zero_dk_once):
        _, g_bad, _ = grads_of()
    errs = leaf_errors(g_k, g_p)
    worst = max(errs, key=errs.get)
    planted = max(leaf_errors(g_bad, g_p).values())
    tol = TRAIN_FULL_TOL
    loss_r = abs(loss_k - loss_p) / abs(loss_p)
    gn_r = abs(gn_k - gn_p) / abs(gn_p)
    if loss_r > tol["loss"] or gn_r > tol["grad_norm"] \
            or errs[worst] > tol["leaf"] or planted <= tol["leaf"]:
        fail(f"train-full step 0, kernels vs plain versions: loss {loss_k} "
             f"vs {loss_p}, grad norm {gn_k} vs {gn_p}, worst leaf {worst} "
             f"{errs[worst]}, planted fault {planted} (limits "
             f"{json.dumps(tol)})")
    del g_k, g_p, g_bad

    # steps timed on the card (the step synchronises on its loss)
    batches = [synthetic_batch(cfg, dcfg, s) for s in range(tf["timed"])]
    p, o = params, opt0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for bt in batches:
        t0 = time.perf_counter()
        (p, o, m), c = counted(lambda: step_fn(p, o, bt))
        secs.append(time.perf_counter() - t0)
        hold_counts("train-full timed step", c, want0)
        add_counts(counts, c)
    peak = torch.cuda.max_memory_allocated()
    # one step traced (after a warm and an untraced one): where it goes
    prof, lines = profile_one(f"train step {cfg.name} {tf['batch']} x "
                              f"{tf['seq']}",
                              lambda: step_fn(p, o, batches[0]))
    write_out("profile_train.txt", lines)
    del p, o
    step_s = statistics.median(secs)

    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def factory(sub, fail_at):
        built = []

        def make():
            if built:                     # the crashed loop's save commits
                built[-1].ckpt.wait()
            ft = FTConfig(ckpt_dir=str(ckpt / sub),
                          ckpt_every=tf["ckpt_every"],
                          fail_at_step=None if built else fail_at)
            built.append(TrainerLoop(
                step_fn, params, opt0,
                lambda s: Prefetcher(make_batch_iterator(cfg, dcfg, s)), ft))
            return built[-1]
        return make

    t0 = time.perf_counter()
    ref, c1 = counted(lambda: factory("ref", None)().run(tf["steps"]))
    ref_s = time.perf_counter() - t0
    out, c2 = counted(lambda: train_with_restarts(
        factory("ft", tf["fail_at"]), tf["steps"], max_restarts=1))
    for c in (c1, c2):
        add_counts(counts, c)
    resumed = (tf["fail_at"] // tf["ckpt_every"]) * tf["ckpt_every"]
    if out["restarts"] != 1 or out["step"] != tf["steps"] \
            or out["losses"] != ref["losses"][resumed:]:
        fail(f"train-full: the restarted run's losses {out['losses']} are "
             f"not the uninterrupted run's {ref['losses'][resumed:]} "
             f"(restarts {out['restarts']}, step {out['step']})")
    shutil.rmtree(ckpt, ignore_errors=True)
    toks = tf["batch"] * tf["seq"]
    res = {"params": count_params(params), "step0": {
               "loss": loss_k, "loss_plain": loss_p, "grad_norm": gn_k,
               "grad_norm_plain": gn_p, "worst_leaf": worst,
               "worst_leaf_err": errs[worst], "planted": planted},
           "step_ms": [1e3 * s for s in secs],
           "median_step_ms": 1e3 * step_s,
           "tokens_per_s": toks / step_s, "peak_mem_bytes": peak,
           "launches_per_step": want0, "losses": ref["losses"],
           "resumed_losses": out["losses"], "run_s": ref_s,
           "profile": prof}
    say(f"train-full {cfg.name} ({res['params']:,} parameters, bf16, remat, "
        f"ce_chunk {cfg.ce_chunk}) batch {tf['batch']} x {tf['seq']}: step "
        f"0 kernels vs plain loss {loss_k:.6f} / {loss_p:.6f}, grad norm "
        f"{gn_k:.5f} / {gn_p:.5f}, worst leaf {worst} {errs[worst]:.2e} "
        f"(planted {planted:.2f}; limits {json.dumps(tol)}); median step "
        f"{res['median_step_ms']:.1f} ms, {res['tokens_per_s']:,.0f} "
        f"tokens/s, peak {peak / 2**30:.2f} GiB; K4 A {want0['flash_attention_lse']} "
        f"/ B {want0['flash_attention_bwd']} a step; {tf['steps']} steps "
        f"under TrainerLoop (losses {ref['losses'][0]:.4f} -> "
        f"{ref['losses'][-1]:.4f}), failure at {tf['fail_at']}, restart from "
        f"{resumed}: {len(out['losses'])} losses bit-equal")
    return res


# training the other families (rwkv6, zamba2, the VLM, Whisper): the K5 /
# K6 backward kernels against their plain versions, then each family at its
# published width through ``launch.train.build``
TRAIN_FAM_ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "internvl2-2b",
                   "whisper-base")
# the MoE family: both smoke configs in train-small; deepseek-v2-lite-16b at
# its published widths in train-full-deepseek (grok-1's one MoE layer alone
# is 4.8 B parameters: its smoke config only)
TRAIN_MOE_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")
TRAIN_MOE_FULL = "deepseek-v2-lite-16b"
SCAN_BWD_SOURCES = {"wkv6_bwd": "wkv6", "ssd_bwd": "ssd"}
# (name, kind, B, T, H, N (K5) or P (K6), N (K6), dtype, strong decays[,
# K6's heads a block]): the two main paths' training shapes (zamba2's with
# 8 heads a block, ``SS.head_group``), then T not a multiple of the 64-step
# chunk with a non-zero entering state in both dtypes (K5 with decays down
# to 1e-20; K6 also with 2 and 4 heads a block), and float32 at small
# widths
SCAN_BWD_CASES = (
    ("rwkv6", "wkv6", 8, 2048, 32, 64, None, "bf16", False),
    ("zamba2", "ssd", 8, 2048, 64, 64, 64, "bf16", False),
    ("wkv6-ragged", "wkv6", 2, 130, 4, 64, None, "bf16", True),
    ("wkv6-ragged-f32", "wkv6", 2, 130, 4, 64, None, "f32", True),
    ("wkv6-n8-f32", "wkv6", 1, 70, 3, 8, None, "f32", False),
    ("ssd-ragged", "ssd", 2, 130, 4, 64, 64, "bf16", False),
    ("ssd-ragged-g4", "ssd", 2, 130, 4, 64, 64, "bf16", False, 4),
    ("ssd-ragged-f32", "ssd", 2, 130, 4, 64, 64, "f32", False),
    ("ssd-ragged-f32-g2", "ssd", 2, 130, 4, 64, 64, "f32", False, 2),
    ("ssd-small-f32", "ssd", 1, 70, 3, 8, 5, "f32", False))
SCAN_BWD_NAMES = {"wkv6": ("dr", "dk", "dv", "dw", "du", "dstate"),
                  "ssd": ("dx", "ddt", "dA", "dBm", "dCm", "dD", "dstate")}
# the K5 / K6 backward against its plain version run in float32 on the same
# operands and saved states, normwise: kernel B's TRAIN_GRAD_TOL, for the
# same reason (each gradient rounded to its type once, float32 sums)
SCAN_BWD_TOL = TRAIN_GRAD_TOL
# published-width training, (batch, sequence) a step: 8 x 2048 tokens;
# the VLM's sequence is 256 patches + 1792 tokens; Whisper's 448 decoder
# tokens a row after its 1500 frames; deepseek 4 x 4096 (DeepSeek-V2's
# 4K pre-training context)
TRAIN_FAM_FULL = {"deepseek-v2-lite-16b": (4, 4096),
                  "rwkv6-1.6b": (8, 2048), "zamba2-1.2b": (8, 2048),
                  "internvl2-2b": (8, 2048), "whisper-base": (16, 448)}
TRAIN_FAM_TIMED = 3         # full-depth steps timed, after a warm one
# step 0 against the plain versions on the first layers at full width
# (the plain scans step through time one step at a time): two, and for
# zamba2 its first segment, six Mamba blocks and the shared attention's
# first application (two blocks would have none); deepseek its dense
# layer and one MoE layer
TRAIN_FAM_LAYERS = {"deepseek-v2-lite-16b": 2,
                    "rwkv6-1.6b": 2, "zamba2-1.2b": 6, "internvl2-2b": 2,
                    "whisper-base": 2}
# the full-depth steps' depth where the full depth does not fit one card:
# deepseek's dense layer + 3 of its 26 MoE layers (~2.25 B parameters).
# The port's AdamW builds new m and v trees a step, ~22 bytes a parameter
# at its peak: 15.7 B parameters would take ~345 GB, 4 MoE layers ~74 GB
# before activations (full depth waits for parameter sharding)
TRAIN_FAM_DEPTH = {"deepseek-v2-lite-16b": 4}
# step 0's leaf check (kernels vs plain versions, both bf16) also holds
# each leaf to a float32 run of the plain versions: a leaf passes within
# TRAIN_FULL_TOL["leaf"] of the plain bf16 gradient, or when the kernels'
# gradient is no farther from the float32 one than FAM_F32_RATIO times the
# plain bf16 gradient is: the bf16 model's own rounding can put a leaf
# past the first limit while the kernels' gradient is as near float32 as
# the plain path's (the ``train-full-*`` lines print the leaf farthest
# from the plain bf16 gradient with its two float32 readings)
FAM_F32_RATIO = 1.5
# attention key biases: their gradient is zero in exact arithmetic (the
# same bias on every key shifts a softmax row by a constant), so both sides
# hold rounding noise there, which Adam turns into lr-sized steps; left out
# of the parameters and gradients held
SHIFT_INVARIANT = ("bk",)
STACKED = ("layers", "mamba", "enc_layers", "dec_layers")


def drop_leaves(tree, names):
    """``tree`` without the leaves whose key is in ``names``."""
    if isinstance(tree, dict):
        return {k: drop_leaves(v, names) for k, v in tree.items()
                if not (k in names and not isinstance(v, dict))}
    return tree


def train_launches(cfg, seq: int) -> dict:
    """The launches one ``make_train_step`` step of ``cfg`` makes at
    sequence length ``seq``: kernel A once a forward and kernel B once for
    each attention layer (Whisper: the encoder's, and the decoder's self
    and cross attention), the K5 / K6 forward once a forward and the
    backward once for each scan layer; with ``cfg.remat`` every
    checkpointed block's forward runs twice (zamba2's shared attention and
    the MoE's leading dense layers are not checkpointed; bf16 MLA's
    backward counts under ``flash_attention_bwd_mla``).  bf16 scans at
    ``seq`` from CHUNKED_MIN_T on take the chunked forward."""
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.models import zamba2
    fwd = 2 if cfg.remat else 1
    bf16 = cfg.jdtype == torch.bfloat16
    if cfg.family in ("dense", "vlm"):
        return {"flash_attention_lse": fwd * cfg.n_layers,
                "flash_attention_bwd": cfg.n_layers}
    if cfg.family == "whisper":
        n = cfg.n_enc_layers + 2 * cfg.n_layers
        return {"flash_attention_lse": fwd * n, "flash_attention_bwd": n}
    if cfg.family == "rwkv6":
        out = {"wkv6": fwd * cfg.n_layers, "wkv6_bwd": cfg.n_layers}
        if bf16 and seq >= WK.CHUNKED_MIN_T:
            out["wkv6_chunked"] = out["wkv6"]
        return out
    if cfg.family == "zamba2":
        apps = zamba2._n_apps(cfg)
        out = {"ssd": fwd * cfg.n_layers, "ssd_bwd": cfg.n_layers,
               "flash_attention_lse": apps, "flash_attention_bwd": apps}
        if bf16 and seq >= SS.CHUNKED_MIN_T:
            out["ssd_chunked"] = out["ssd"]
        return out
    if cfg.family == "moe":
        from repro_torch.kernels.flash_attention import ops as FA
        dense = cfg.first_dense_layers       # not checkpointed
        d = cfg.qk_nope_dim + cfg.qk_rope_dim if cfg.use_mla \
            else cfg.head_dim
        dv = cfg.v_head_dim if cfg.use_mla else cfg.head_dim
        return {"flash_attention_lse": dense + fwd * (cfg.n_layers - dense),
                FA.bwd_counter(cfg.jdtype, d, dv): cfg.n_layers}
    fail(f"train_launches: no training path for the {cfg.family} family")


def scan_bwd_inputs(kind, b, t, h, c, n, dt, strong, dev, gen):
    """(forward arguments, dy, dstate_out) of a K5 (c = N) or K6 (c = P)
    case; K6's x, Bm and Cm are slices of one tensor, as the model hands
    in its conv output."""
    import torch.nn.functional as F
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa
    if kind == "wkv6":
        r, k, v = (rnd(b, t, h, c).to(dt) for _ in range(3))
        w = torch.exp(-torch.exp(rnd(b, t, h, c) - (0.0 if strong else 3.0)))
        if strong:
            w[:, 3:9] = 1e-20
        return ((r, k, v, w, rnd(h, c).to(dt), rnd(b, h, c, c)),
                rnd(b, t, h, c).to(dt), rnd(b, h, c, c))
    xbc = rnd(b, t, h * c + 2 * n).to(dt)
    args = (xbc[..., :h * c].reshape(b, t, h, c),
            F.softplus(rnd(b, t, h) - 1.0), -torch.exp(0.5 * rnd(h)),
            xbc[..., h * c:h * c + n], xbc[..., h * c + n:], rnd(h),
            rnd(b, h, c, n))
    return args, rnd(b, t, h, c).to(dt), rnd(b, h, c, n)


def scan_bwd_bound(kind, ins, grads):
    """The least time of a K5 / K6 backward: ``ins`` (the operands, the
    saved states, dy, dstate_out) read once and ``grads`` written once,
    against its chunk products (K5: P, X, Y, G, K dSL and A^T dY; K6: CB,
    DX, DYS, G_in, XG, BG and the three intra-chunk sums), 2 x 64^3 flops
    each a (batch, head, chunk), at the peak of the inputs' type."""
    nbytes = sum(z.numel() * z.element_size() for z in (*ins, *grads))
    dy = ins[-2]
    b, t, h = dy.shape[:3]
    flops = (6 if kind == "wkv6" else 9) * 2 * 64 ** 3 * b * h * -(-t // 64)
    peak = BF16_FLOPS if dy.dtype == torch.bfloat16 else F32_FLOPS
    return bound_ms(nbytes, flops, peak)


def scan_bwd_case(dev, spec):
    """The K5 or K6 backward at one shape against its plain version run in
    float32 on the same operands and the same saved chunk states (from the
    forward kernel, under grad): every gradient within SCAN_BWD_TOL
    normwise, a planted fault (head 0 of the second gradient zeroed) above
    ten times it, two launches bit-equal; timed (with the plain version in
    turns) at the main paths' shapes."""
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    name, kind, b, t, h, c, n, dts, strong = spec[:9]
    dt = torch.bfloat16 if dts == "bf16" else torch.float32
    gen = torch.Generator(dev).manual_seed(37)
    args, dy, ds = scan_bwd_inputs(kind, b, t, h, c, n, dt, strong, dev, gen)
    mod = WK if kind == "wkv6" else SS
    plain = mod.R.wkv6_bwd_ref if kind == "wkv6" else mod.R.ssd_bwd_ref
    _, _, states = mod._forward(*args, keep=True)
    ops_in = args[:-1]
    kw = {"group": spec[9]} if len(spec) > 9 else {}
    got = mod.launch_bwd(*ops_in, states, dy, ds, **kw)
    again = mod.launch_bwd(*ops_in, states, dy, ds, **kw)
    want = plain(*(z.float() for z in ops_in), states, dy.float(), ds)
    torch.cuda.synchronize()
    tol = SCAN_BWD_TOL[dts]
    errs = {nm: normwise(g, w) for nm, g, w in
            zip(SCAN_BWD_NAMES[kind], got, want)}
    bad = got[1].clone()
    bad[:, :, 0] = 0
    planted = normwise(bad, want[1])
    if max(errs.values()) > tol or planted <= 10 * tol \
            or not all(bool(torch.isfinite(g).all()) for g in got):
        fail(f"train-kernels {name}: the {kind} backward differs from the "
             f"plain version normwise by {errs} (limit {tol}; planted "
             f"fault {planted})")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail(f"train-kernels {name}: two launches of the {kind} backward "
             "on the same inputs differ")
    res = {"kind": kind, "shape": [b, t, h, c] + ([n] if n else []),
           "dtype": dts, "strong_decays": strong, "grad_normwise": errs,
           "heads_a_block": (kw.get("group") or SS.head_group(
               b, h, -(-t // SS.CHUNK))) if kind == "ssd" else 1,
           "planted": planted,
           "max_abs_err": max(max_diff(g, w) for g, w in zip(got, want)),
           "bound": scan_bwd_bound(kind, (*ops_in, states, dy, ds), got)}
    if name in ("rwkv6", "zamba2"):
        res.update(time_turns({
            "ms": (lambda _: mod.launch_bwd(*ops_in, states, dy, ds), {}),
            "plain_ms": (lambda _: plain(*ops_in, states, dy, ds),
                         {"reps": 1})}))
        HOST[kind + "_bwd"] = host_us(
            lambda _: mod.launch_bwd(*ops_in, states, dy, ds))
    return res


def phase_train_scan_kernels(dev):
    """The K5 / K6 backward kernels at SCAN_BWD_CASES (see
    ``scan_bwd_case``); the kernels line's rows ``wkv6_bwd`` / ``ssd_bwd``
    carry rwkv6-1.6b's / zamba2-1.2b's training shape and the largest
    error of every case.  Returns those rows (less their launches) and the
    cases."""
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    cases = {spec[0]: scan_bwd_case(dev, spec) for spec in SCAN_BWD_CASES}
    occ = {k: [m.bwd_occupancy(d) for d in (torch.bfloat16, torch.float32)]
           for k, m in (("wkv6_bwd", WK), ("ssd_bwd", SS))}
    if min(occ[k][0][0] for k in occ) < 2:
        fail(f"train-kernels-scan: a backward kernel keeps fewer than two "
             f"blocks an SM in bf16: {occ}")
    rows = {}
    for key, kind in SCAN_BWD_SOURCES.items():
        t = cases["rwkv6" if kind == "wkv6" else "zamba2"]
        rows[key] = {"max_abs_err": max(c["max_abs_err"] for c in
                                        cases.values() if c["kind"] == kind),
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound": t["bound"], "sdpa_ms": None}
    say("train-kernels-scan " + "; ".join(
        f"{nm} {c['kind']} {c['dtype']} {c['shape']}"
        + (" decays to 1e-20" if c["strong_decays"] else "")
        + (f" {c['heads_a_block']} heads a block"
           if c["heads_a_block"] > 1 else "")
        + ": normwise " + ",".join(f"{g}={e:.2e}"
                                   for g, e in c["grad_normwise"].items())
        + f" (planted {c['planted']:.2e}; limit "
        f"{SCAN_BWD_TOL[c['dtype']]:.2e}), twice bit-equal"
        + (f", ms={c['ms']:.4f} plain_ms={c['plain_ms']:.1f} "
           f"bound_ms={c['bound'][0]:.5f} ({c['bound'][1]})"
           if "ms" in c else "")
        for nm, c in cases.items())
        + f"; host_us wkv6_bwd={HOST['wkv6_bwd']:.1f} "
        f"ssd_bwd={HOST['ssd_bwd']:.1f}; resident blocks an SM (shared "
        "bytes) bf16 / float32: " + ", ".join(
            f"{k} " + " / ".join("%d (%d)" % occ[k][d] for d in (0, 1))
            for k in occ))
    return rows, cases


@contextlib.contextmanager
def patched_attrs(pairs):
    """Each ``(module, name, fn)`` in ``pairs`` set for the span."""
    old = [(m, k, getattr(m, k)) for m, k, _ in pairs]
    for m, k, f in pairs:
        setattr(m, k, f)
    try:
        yield
    finally:
        for m, k, f in old:
            setattr(m, k, f)


def phase_train_family_full(dev, arch: str, counts: dict):
    """``arch`` (one of TRAIN_FAM_ARCHS) trained at its published width
    (bf16, remat) at TRAIN_FAM_FULL.  Step 0 first on a copy cut to its
    first TRAIN_FAM_LAYERS[arch] layers (encoder and decoder for Whisper)
    at full width: loss, grad norm and every leaf's gradient with the kernels
    against the plain versions on the card (``impl="ref"``: the plain
    scans under their Functions, ``blocked_*_ref`` for attention) within
    TRAIN_FULL_TOL, or each leaf no farther from a float32 run of the
    plain versions than FAM_F32_RATIO times the plain bf16 gradient, and
    a planted fault (the first backward launch of the family's own kernel
    returning a zeroed dk, or dx for zamba2) above both.
    The MoE (deepseek): its plain runs take the kernel run's expert
    choices (``moe.top_experts`` patched for the span: the gates and the
    renormalised weights from the run's own router input, the top-k
    indices the kernel run's, call by call), since a bf16 near tie routed
    otherwise would move whole experts' gradients; the choices the plain
    runs' own routers would have flipped are counted.
    Then the full-depth model through ``launch.train.build`` (AdamW +
    cosine, clip 1.0), cut to TRAIN_FAM_DEPTH[arch] layers where listed
    (``launch.train.get_config`` patched for the span): one warm step and
    TRAIN_FAM_TIMED timed steps, each step's launches held to
    ``train_launches``; median step ms, tokens/s, peak memory; one more
    step traced (``chiprun_out/profile_train_<family>.txt``, deepseek's
    ``profile_train_deepseek.txt``)."""
    import dataclasses
    import functools
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_map
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.rwkv6_scan import ops as WK
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.launch import train
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import moe as MO
    from repro_torch.models.base import count_params, get_family
    from repro_torch.optim import clip_by_global_norm
    bsz, seq = TRAIN_FAM_FULL[arch]
    n_cut = TRAIN_FAM_LAYERS[arch]
    tol = TRAIN_FULL_TOL
    full = get_config(arch)
    cut = {"n_layers": n_cut}
    if full.family == "whisper":
        cut["n_enc_layers"] = n_cut
    cfg2 = dataclasses.replace(full, **cut)
    fam = get_family(cfg2)
    dcfg = DataConfig(seed=0, batch_size=bsz, seq_len=seq)
    p2 = fam.init(cfg2, seed=0, device=dev)
    b0 = {k: torch.as_tensor(v).to(dev)
          for k, v in synthetic_batch(cfg2, dcfg, 0).items()}

    def grads_of():
        (loss, _), g = value_and_grad(
            lambda p: fam.loss_fn(cfg2, p, b0), p2)
        return float(loss), g, float(clip_by_global_norm(g, 1.0)[1])

    moe = full.family == "moe"
    routes, flips = [], {"plain": 0, "f32": 0, "choices": 0}
    real_top = MO.top_experts

    def keep_route(cfg, p, x2d):          # the kernel run's choices
        out = real_top(cfg, p, x2d)
        routes.append(out[1])
        return out

    def forced(run: str):
        """``top_experts`` with the kernel run's indices, call by call;
        counts the (layer, token) choices of the forward whose own top-k
        set differs."""
        calls = []

        def top(cfg, p, x2d):
            gates, own, _ = real_top(cfg, p, x2d)
            topi = routes[len(calls)]
            if len(calls) < n_moe:        # the forward's calls come first
                differ = (own.sort(-1).values
                          != topi.sort(-1).values).any(-1)
                flips[run] += int(differ.sum())
                flips["choices"] += int(differ.numel()) if run == "plain" \
                    else 0
            calls.append(1)
            topv = gates.gather(-1, topi)
            return gates, topi, topv / topv.sum(-1, keepdim=True) \
                .clamp_min(1e-9)
        return [(MO, "top_experts", top)] if moe else []
    n_moe = cfg2.n_layers - cfg2.first_dense_layers if moe else 0

    with patched_attrs([(MO, "top_experts", keep_route)] if moe else []):
        (loss_k, g_k, gn_k), c0 = counted(grads_of)
    hold_counts(f"train-full {arch} step 0 ({n_cut} layers)", c0,
                train_launches(cfg2, seq))
    ref = lambda f: functools.partial(f, impl="ref")  # noqa: E731
    plain = [(FA, "flash_attention_lse", ref(FA.flash_attention_lse)),
             (FA, "flash_attention_bwd", ref(FA.flash_attention_bwd)),
             (WK, "wkv6", ref(WK.wkv6)), (SS, "ssd", ref(SS.ssd))]
    with patched_attrs(plain + forced("plain")):
        loss_p, g_p, gn_p = grads_of()
    with patched_attrs(plain + forced("f32")):
        c32 = dataclasses.replace(cfg2, dtype="float32")
        p32 = tree_map(lambda z: z.float(), p2)
        g_32 = value_and_grad(lambda p: fam.loss_fn(c32, p, b0), p32)[1]
        del p32
    mod, fn, idx = {"rwkv6": (WK, "launch_bwd", 1),
                    "zamba2": (SS, "launch_bwd", 0)}.get(
        full.family, (FA, "flash_attention_bwd", 1))
    real, calls = getattr(mod, fn), []

    def zero_once(*a, **kw):              # the last layer's, in backward
        out = list(real(*a, **kw))
        calls.append(1)
        if len(calls) == 1:
            out[idx] = torch.zeros_like(out[idx])
        return tuple(out)
    with patched_attrs([(mod, fn, zero_once)]):
        _, g_bad, _ = grads_of()
    lerr = lambda a, b: leaf_errors(a, b, STACKED, SHIFT_INVARIANT)  # noqa
    e_p32 = lerr(g_p, g_32)

    def excess(g):
        """Per leaf, the smaller of its two readings over its limit."""
        e_kp, e_k32 = lerr(g, g_p), lerr(g, g_32)
        return {k: min(e_kp[k] / tol["leaf"],
                       e_k32[k] / (FAM_F32_RATIO * max(e_p32[k], 1e-30)))
                for k in e_kp}
    ex = excess(g_k)
    worst = max(ex, key=ex.get)
    e_kp, e_k32 = lerr(g_k, g_p), lerr(g_k, g_32)
    errs = {"vs_plain": e_kp[worst], "vs_f32": e_k32[worst],
            "plain_vs_f32": e_p32[worst]}
    far = max(e_kp, key=e_kp.get)       # the leaf farthest from plain bf16
    far_errs = {"leaf": far, "vs_plain": e_kp[far], "vs_f32": e_k32[far],
                "plain_vs_f32": e_p32[far]}
    planted = max(excess(g_bad).values())
    loss_r = abs(loss_k - loss_p) / abs(loss_p)
    gn_r = abs(gn_k - gn_p) / abs(gn_p)
    if loss_r > tol["loss"] or gn_r > tol["grad_norm"] \
            or ex[worst] > 1.0 or planted <= 1.0:
        fail(f"train-full {arch} step 0 ({n_cut} layers), kernels "
             f"vs plain versions: loss {loss_k} vs {loss_p}, grad norm "
             f"{gn_k} vs {gn_p}, worst leaf {worst} {errs} (excess "
             f"{ex[worst]}), planted fault's excess {planted} (limits "
             f"{json.dumps(tol)}, FAM_F32_RATIO {FAM_F32_RATIO})")
    del p2, g_k, g_p, g_bad, g_32, b0
    torch.cuda.empty_cache()

    depth = TRAIN_FAM_DEPTH.get(arch, full.n_layers)
    cut_cfg = lambda a: dataclasses.replace(get_config(a),  # noqa: E731
                                            n_layers=depth)
    with patched_attrs([(train, "get_config", cut_cfg)]):
        cfg, step_fn, params, opt0, dcfg = train.build(
            arch, False, bsz, seq, 3e-4, 10, device=dev)
    if not (cfg.remat and cfg.jdtype == torch.bfloat16
            and cfg.n_layers == depth):
        fail(f"train-full {arch}: {cfg.name} is not bf16 / remat at "
             f"{depth} layers")
    want = train_launches(cfg, seq)
    batches = [synthetic_batch(cfg, dcfg, s)
               for s in range(TRAIN_FAM_TIMED + 1)]
    n_params = count_params(params)
    p, o = params, opt0
    del params, opt0                  # each step's inputs go when it ends
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs, losses = [], []
    for i, bt in enumerate(batches):
        t0 = time.perf_counter()
        (p, o, m), c = counted(lambda: step_fn(p, o, bt))
        if i:
            secs.append(time.perf_counter() - t0)
        hold_counts(f"train-full {arch} step {i}", c, want)
        add_counts(counts, c)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        fail(f"train-full {arch}: losses {losses}")
    # one step traced (after the timed ones): where it goes
    tag = "deepseek" if moe else cfg.family
    prof, lines = profile_one(f"train step {cfg.name} {bsz} x {seq}",
                              lambda: step_fn(p, o, batches[0]), warm=False)
    write_out(f"profile_train_{tag}.txt", lines)
    del p, o
    torch.cuda.empty_cache()
    step_s = statistics.median(secs)
    toks = bsz * seq
    res = {"params": n_params, "batch": [bsz, seq], "layers": depth,
           "step0_layers": n_cut, "step0_route_flips": flips, "step0": {
               "loss": loss_k, "loss_plain": loss_p, "grad_norm": gn_k,
               "grad_norm_plain": gn_p, "worst_leaf": worst,
               "worst_leaf_err": errs, "worst_leaf_excess": ex[worst],
               "farthest_from_plain": far_errs, "planted_excess": planted},
           "step_ms": [1e3 * x for x in secs],
           "median_step_ms": 1e3 * step_s, "tokens_per_s": toks / step_s,
           "peak_mem_bytes": peak, "launches_per_step": want,
           "losses": losses, "profile": prof}
    say(f"train-full-{tag} {cfg.name} ({n_params:,} parameters, "
        f"bf16, remat) batch {bsz} x {seq}"
        + (f", {depth} of {full.n_layers} layers (the dense layer + "
           f"{depth - full.first_dense_layers} MoE; full depth does not "
           "fit one card)" if depth != full.n_layers else "")
        + (f" after {cfg.enc_seq} frames" if cfg.family == "whisper" else "")
        + (f" ({cfg.n_patches} patches + {seq - cfg.n_patches} tokens)"
           if cfg.family == "vlm" else "")
        + (f": step 0 on {n_cut} layers with the kernel run's expert "
           f"choices forced in the plain runs (their own routers would "
           f"have flipped {flips['plain']} (bf16) / {flips['f32']} "
           f"(float32) of {flips['choices']} (layer, token) choices)"
           if moe else f": step 0 on {n_cut} layers")
        + " kernels vs plain loss "
        f"{loss_k:.6f} / {loss_p:.6f}, grad norm {gn_k:.5f} / {gn_p:.5f}, "
        f"worst leaf {worst} vs plain {errs['vs_plain']:.2e}, vs float32 "
        f"{errs['vs_f32']:.2e} (plain {errs['plain_vs_f32']:.2e}), excess "
        f"{ex[worst]:.2f}, farthest from plain {far} "
        f"{far_errs['vs_plain']:.2e} (vs float32 {far_errs['vs_f32']:.2e}, "
        f"plain {far_errs['plain_vs_f32']:.2e}) (planted {planted:.2f}; limits "
        f"{json.dumps(tol)}, FAM_F32_RATIO {FAM_F32_RATIO}); "
        + ("full depth" if depth == full.n_layers else f"{depth} layers")
        + ": median step "
        f"{res['median_step_ms']:.1f} ms, {res['tokens_per_s']:,.0f} "
        f"tokens/s, peak {peak / 2**30:.2f} GiB"
        + (f" (AdamW over {n_params:,} parameters)" if moe else "")
        + ", losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; launches a step {json.dumps(want)}")
    return res


GREEDY_TOL = 1e-4   # a card token's logit below the CPU's best, float32


def phase_serve_launch(dev):
    """The serving entry point ``launch.serve.main`` on smollm-smoke, greedy
    and ``--mcts``, on the card (its default device).  Greedy: every
    request's max_new tokens, each an argmax of the CPU's teacher-forced
    logits within GREEDY_TOL (float32 sums in other orders may flip a
    near tie, so the token streams are compared, not required equal);
    ``--mcts``: the tokens equal ``mcts_decode`` on the CPU with the
    wave select that "auto" takes on the card ("mega"; on the CPU it takes
    "scan", another order of the wave's selections, so serve's own
    CPU run differs).  Its CPU runs are printed beside.  Output
    in ``chiprun_out/serve_launch.txt``.  Returns the card runs'
    launches."""
    import contextlib
    import io
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.mcts_decode import MCTSDecodeConfig, mcts_decode
    argv = ["--arch", TRAIN_ARCH, "--smoke"]
    buf = io.StringIO()
    counts = {}
    with contextlib.redirect_stdout(buf):
        g, c = counted(lambda: serve.main(argv))
        add_counts(counts, c)
        m, c = counted(lambda: serve.main(argv + ["--mcts"]))
        add_counts(counts, c)
        g_cpu = serve.main(argv + ["--device", "cpu"])
        m_cpu = serve.main(argv + ["--mcts", "--device", "cpu"])
    write_out("serve_launch.txt", buf.getvalue().splitlines())
    cfg = get_smoke_config(TRAIN_ARCH)
    params = T.init(cfg, seed=0, device="cpu")
    gap = 0.0
    for uid, toks in g["outputs"].items():
        prompt = g["prompts"][uid]
        if len(toks) != 16:
            fail(f"serve-launch: request {uid} got {len(toks)} tokens")
        seq = torch.tensor([prompt + toks[:-1]])
        with torch.no_grad():
            lg = T.logits_fn(cfg, params, seq)[0, len(prompt) - 1:].float()
        picked = lg.gather(-1, torch.tensor(toks)[:, None])[:, 0]
        gap = max(gap, float((lg.max(-1).values - picked).max()))
    if gap > GREEDY_TOL:
        fail(f"serve-launch: a greedy token on the card is {gap} below the "
             f"CPU's best logit (limit {GREEDY_TOL})")
    want = mcts_decode(cfg, params, m["prompt"], 16, MCTSDecodeConfig(
        budget=16, lanes=2, wave_select="mega"), device="cpu")
    if m["tokens"] != want:
        fail(f"serve-launch: --mcts gave {m['tokens']} on the card, "
             f"{want} on the CPU (mega)")
    for k in ("flash_attention", "decode_attention", "bes"):
        if counts.get(k, 0) == 0:
            fail(f"serve-launch: kernel {k} was not launched")
    same = sum(g["outputs"][u] == g_cpu["outputs"][u] for u in g["outputs"])
    say(f"serve-launch smollm-smoke: greedy {len(g['outputs'])} requests x "
        f"16 tokens, each within {gap:.2e} of the CPU's best logit (limit "
        f"{GREEDY_TOL}), {same} of {len(g['outputs'])} streams equal to the "
        f"CPU run's; --mcts 16 tokens == the CPU's with the fused wave "
        f"(the driver on the CPU, wave select scan: "
        f"{'equal' if m['tokens'] == m_cpu['tokens'] else 'other'} tokens); "
        f"launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# the model-parallel layer (parallel/*): two ranks on cuda:0 under gloo
# ---------------------------------------------------------------------------
# (a) the sequence-sharded flash-decode at qwen2-0.5b's decode heads, bf16,
# a 65,536-token cache over the ranks; row 0 ends inside the first shard,
# row 2 at the shard boundary
PAR_DECODE = dict(b=8, h=14, hkv=2, d=64, s=65536,
                  valid=(1000, 65536, 32768, 40001, 65535, 12345, 50000,
                         32769))
# (b) EP at deepseek-v2-lite-16b's MoE widths (64 experts, D 2048, F 1408,
# top-6), 4,096 bf16 tokens on a model axis of the ranks; random tokens
# load the experts evenly, so the config's capacity drops nothing, and a
# capacity at PAR_MOE_DROP of the largest load makes EP drop slots
PAR_MOE_TOKENS = 4096
PAR_MOE_DROP = 0.9
# (c) smollm-135m's sharded train step, 8 x 2048 tokens over a data axis
PAR_TRAIN = dict(batch=8, seq=2048, steps=3, lr=3e-4)
# (d) smollm-135m's 30 blocks as one stage a rank, 4 microbatches
PAR_PIPE = dict(batch=8, seq=512, micro=4)
PAR_SEED = 26
# normwise (max |diff| / max |want|) limits, each above what bf16 rounding
# alone gives:
#  decode: each rank's partial is rounded to bf16 once and the combined
#    output once more (<= 2 x 2^-9 of the larger of them); planted: one
#    rank's lse shifted by 1 must read above it
PAR_DECODE_TOL = 2.0 ** -7
#  lse: float32 from bf16 inputs, the kernel's exp2 / log2 vs the plain
#    logsumexp (absolute, as LSE_TOL)
#  moe: the grouped dispatch adds its k = 6 weighted slots in bf16 (a
#    rounding each), EP in float32 and rounds once; the expert GEMMs of
#    other batch shapes may sum in another order (an ulp of each product)
PAR_MOE_TOL = 2.0 ** -6
#  train: the data shards' bf16 gradients, averaged in float32, against
#    the one-process bf16 gradient of the whole batch (GEMMs of other
#    shapes, the embedding's bf16 sums grouped otherwise) spread through
#    30 layers and 3 AdamW steps: train-full's limits for a bf16 step
#    (TRAIN_FULL_TOL: loss, grad_norm relative; every leaf normwise, the
#    second moments squaring the gradients' differences)
#    The leaf farthest from the one-process step is also read against a
#    float32 one-process run: the sharded run may be no farther from it
#    than FAM_F32_RATIO times the one-process bf16 run is (the gap being
#    the bf16 rounding of both, not the sharding)
#  the EF run: its loss at step 0 is the uncompressed one (taken before
#    the gradient), bit for bit; later losses relative to the uncompressed
#    run's.  Its grad_norm is reported, not held: the compressed all-mean
#    (the JAX package's) scales the summed int8 payloads by the ranks'
#    mean block scale, which misses where the ranks' scales differ (it
#    read 8.5% under the exact norm at step 0 on an H100)
PAR_EF_TOL = 2e-3
#  pipeline: microbatches of 2 rows against the whole batch of 8 (GEMMs of
#    other shapes) over 30 bf16 blocks
PAR_PIPE_TOL = 2.0 ** -6


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def par_decode(rank, world, mesh, dev, timing: bool) -> dict:
    """(a): ``dist_decode_attention`` on this rank's slice of the cache,
    counted; then the holds (outside the count) and, on rank 0, the K3
    partial timed beside its plain version and SDPA."""
    import torch.distributed as dist
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.parallel.dist_attention import (combine_partials,
                                                     dist_decode_attention,
                                                     local_valid_len)
    c = PAR_DECODE
    b, h, hkv, d, s = c["b"], c["h"], c["hkv"], c["d"], c["s"]
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    bf = torch.bfloat16
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(bf)
    k = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(bf)
    v = torch.randn((b, s, hkv, d), generator=gen, device=dev).to(bf)
    vl = torch.tensor(c["valid"], dtype=torch.int32, device=dev)
    sl = s // world
    lo = rank * sl
    kl, vl_ = k[:, lo:lo + sl], v[:, lo:lo + sl]
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    out = dist_decode_attention(q, kl, vl_, vl, mesh)
    torch.cuda.synchronize()
    counts = _nonzero(all_launches())
    hold_counts(f"parallel decode rank {rank}", counts,
                {"decode_attention_lse": 1})
    lvl = local_valid_len(vl, lo, sl)
    o, lse = DA.decode_attention_lse(q, kl, vl_, lvl)
    planted = combine_partials(o, lse + (1.0 if rank == 0 else 0.0), vl,
                               vl_, mesh, "data")
    f32 = [t.float() for t in (q, kl, vl_)]
    o32, lse32 = DA.decode_attention_lse(*f32, lvl, impl="ref")
    o_pl, _ = DA.decode_attention_lse(q, kl, vl_, lvl, impl="ref")
    check = bf16_check(f"parallel decode rank {rank} K3 partial", o, o_pl,
                       o32)
    empty = torch.isneginf(lse32)
    if not torch.equal(torch.isneginf(lse), empty):
        fail(f"parallel decode rank {rank}: the kernel's lse is -inf on "
             f"other rows than the plain version's")
    lse_err = float((lse - lse32)[~empty].abs().max()) if bool(
        (~empty).any()) else 0.0
    if lse_err > LSE_TOL:
        fail(f"parallel decode rank {rank}: lse off the plain version's by "
             f"{lse_err} (limit {LSE_TOL})")
    want32 = DA.decode_attention(q.float(), k.float(), v.float(), vl,
                                 impl="ref")
    full = DA.decode_attention(q, k, v, vl)
    errs = {"vs_plain32": normwise(out, want32),
            "vs_one_k3": normwise(out, full),
            "planted": normwise(planted, want32)}
    if max(errs["vs_plain32"], errs["vs_one_k3"]) > PAR_DECODE_TOL:
        fail(f"parallel decode rank {rank}: {errs} (limit "
             f"{PAR_DECODE_TOL})")
    if errs["planted"] <= PAR_DECODE_TOL:
        fail(f"parallel decode rank {rank}: an lse shifted by 1 on rank 0 "
             f"read {errs['planted']}, not above {PAR_DECODE_TOL}")
    res = {"errs": errs, "lse_err": lse_err, "counts": counts,
           "empty_rows": int(empty.sum()),
           "max_abs_err": max(check["f32"], lse_err),
           "bound": da_bound(q, hkv, lvl)}
    del want32, full, f32
    dist.barrier()
    if timing:
        mask = (torch.arange(sl, device=dev)[None, :] < lvl[:, None])[
            :, None, None, :]
        res.update(time_turns({
            "ms": (lambda _: DA.decode_attention_lse(q, kl, vl_, lvl), {}),
            "plain_ms": (lambda _: DA.decode_attention_lse(
                q, kl, vl_, lvl, impl="ref"), dict(reps=PLAIN_REPS)),
            "sdpa_ms": (lambda _: sdpa_fn(q, kl, vl_, attn_mask=mask,
                                          enable_gqa=True), {})}))
    dist.barrier()
    return res


def par_moe(rank, world, mesh, dev) -> dict:
    """(b): ``ep_moe_ffn`` at a capacity with no drops (held to the
    grouped dispatch), at the config's and at PAR_MOE_DROP of the largest
    expert load (each held to one rank's EP: the second must drop slots,
    as many as the loads say)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.parallel.ep_dispatch import (ep_capacity, ep_moe_ffn,
                                                  ep_slots)
    from repro_torch.parallel.mesh import Mesh
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED + 1)
    p = M.init_moe_ffn(cfg, gen)
    p.pop("shared", None)
    n, e, k = PAR_MOE_TOKENS, cfg.n_experts, cfg.moe_topk
    x = torch.randn((n, cfg.d_model), generator=gen, device=dev) \
        .to(cfg.jdtype)
    _, topi, _ = M.top_experts(cfg, p, x)
    load = torch.bincount(topi.reshape(-1), minlength=e)
    cf_nodrop = int(load.max()) * e / (n * k)
    cap = ep_capacity(n, k, e, cfg.moe_capacity)
    dropped = int((load - cap).clamp_min(0).sum())
    cf_drop = int(PAR_MOE_DROP * int(load.max())) * e / (n * k)
    cap_drop = ep_capacity(n, k, e, cf_drop)
    dropped_drop = int((load - cap_drop).clamp_min(0).sum())
    kept = int(ep_slots(topi, 0, e, cap_drop)[2].sum())
    if dropped_drop == 0 or kept != n * k - dropped_drop:
        fail(f"parallel moe rank {rank}: capacity {cap_drop} drops "
             f"{dropped_drop} slots by the loads, keeps {kept} of {n * k} "
             f"by ep_slots")
    reset_launches()
    y_free, t_free = timed(lambda: ep_moe_ffn(x, p, mesh, topk=k,
                                              capacity_factor=cf_nodrop))
    y_cfg, t_cfg = timed(lambda: ep_moe_ffn(
        x, p, mesh, topk=k, capacity_factor=cfg.moe_capacity))
    y_drop = ep_moe_ffn(x, p, mesh, topk=k, capacity_factor=cf_drop)
    counts = _nonzero(all_launches())
    one = Mesh(np.array([rank]), ("model",), rank, device=dev)
    y_one = ep_moe_ffn(x, p, one, topk=k, capacity_factor=cfg.moe_capacity)
    y_one_drop = ep_moe_ffn(x, p, one, topk=k, capacity_factor=cf_drop)
    y_grp, _ = M.moe_ffn(cfg.replace(moe_capacity=cf_nodrop, moe_groups=1,
                                     moe_impl="gather"), p, x)
    errs = {"nodrop_vs_grouped": normwise(y_free, y_grp),
            "cfg_vs_one_rank": normwise(y_cfg, y_one),
            "drop_vs_one_rank": normwise(y_drop, y_one_drop)}
    if max(errs.values()) > PAR_MOE_TOL:
        fail(f"parallel moe rank {rank}: {errs} (limit {PAR_MOE_TOL})")
    return {"errs": errs, "counts": counts, "cf_nodrop": cf_nodrop,
            "max_load": int(load.max()), "capacity": cap,
            "dropped_slots": dropped, "drop_capacity": cap_drop,
            "drop_dropped_slots": dropped_drop, "ep_s": t_cfg,
            "ep_nodrop_s": t_free}


def _bytes(tree) -> int:
    from repro_torch.core.pytree import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree)[0])


def par_train(rank, world, mesh, dev) -> dict:
    """(c): smollm-135m's sharded train step at PAR_TRAIN over a data axis
    (its state at rest as each rank's slices), counted; once more with
    the EF compressor; once more, uncounted, with a planted fault (the
    gradient's reduce-scatter skips its sum over ``data``, so each rank
    steps on its own half of the batch); then, on rank 0, the one-process
    step from the same state, which the sharded run is held to step by
    step and leaf by leaf and the faulted run must miss, and a float32
    one-process run (the witness of which side a leaf's gap comes
    from)."""
    import torch.distributed as dist
    from repro_torch.core.pytree import tree_map
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.collectives import ErrorFeedback
    from repro_torch.runtime.elastic import (gather_state, reshard_state,
                                             state_shardings)
    c = PAR_TRAIN
    cfg, step_one, params, opt0, dcfg = train.build(
        TRAIN_ARCH, False, c["batch"], c["seq"], c["lr"], c["steps"],
        device=dev)
    whole = {"params": params, "opt": opt0}
    sh = state_shardings(cfg, whole, mesh)
    local = reshard_state(cfg, whole, mesh)
    sched = train.schedule(TRAIN_ARCH, c["lr"], c["steps"])
    batches = [synthetic_batch(cfg, dcfg, i) for i in range(c["steps"])]

    def run(step, state):
        p, o = state["params"], state["opt"]
        ms = []
        for bt in batches:
            p, o, m = step(p, o, bt)
            ms.append({k: float(v) for k, v in m.items()})
        return {"params": p, "opt": o}, ms

    res = {"bytes_at_rest": {"params": _bytes(local["params"]),
                             "opt": _bytes(local["opt"])},
           "bytes_whole": {"params": _bytes(params), "opt": _bytes(opt0)}}
    counts = {}
    ef = ErrorFeedback(params, mesh, "data")
    for name, comp in (("sharded", None), ("ef", ef)):
        step = make_train_step(cfg, adamw(), sched, compress_grads=comp,
                               mesh=mesh, shardings=sh)
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        (st, ms), secs = timed(lambda: run(step, local))
        counts[name] = _nonzero(all_launches())
        res[name] = {"metrics": ms, "seconds": secs}
        if name == "sharded":
            gathered = gather_state(st, sh)
        del st
    # the EF residuals: float32, each rank's whole gradient tree
    res["bytes_at_rest"]["ef_residual"] = _bytes(ef.err)
    del ef
    want = {"flash_attention_lse": 2 * cfg.n_layers * c["steps"],
            "flash_attention_bwd": cfg.n_layers * c["steps"]}
    for name in counts:
        hold_counts(f"parallel train {name} rank {rank}", counts[name],
                    want)
    res["counts"] = counts
    real_rs = C.reduce_scatter

    def own_half(x, spec, mesh_, axes):   # this rank's slice, not summed;
        n = math.prod(mesh_.shape[a] for a in axes)   # the step divides
        return real_rs(x, spec, mesh_, ()) * n        # by n
    with patched_attrs([(C, "reduce_scatter", own_half)]):
        step = make_train_step(cfg, adamw(), sched, mesh=mesh, shardings=sh)
        st, res["fault"] = run(step, local)
    fault = gather_state(st, sh)
    del st
    efm, plain = res["ef"]["metrics"], res["sharded"]["metrics"]
    if efm[0]["loss"] != plain[0]["loss"]:
        fail(f"parallel train rank {rank}: the EF run's step-0 loss "
             f"{efm[0]['loss']} != the uncompressed {plain[0]['loss']}")
    for i, (a, b) in enumerate(zip(efm, plain)):
        if not (math.isfinite(a["loss"]) and math.isfinite(a["grad_norm"])
                and abs(a["loss"] - b["loss"]) <= PAR_EF_TOL * b["loss"]):
            fail(f"parallel train rank {rank}: EF step {i} {a} vs the "
                 f"uncompressed {b} (loss limit {PAR_EF_TOL} relative)")
    dist.barrier()
    if rank == 0:           # the one-process steps, uncounted; held by the
        st1, ms1 = run(step_one, whole)                 # parent

        def metric_err(ms):
            return {key: max(abs(a[key] - b[key]) / abs(b[key])
                             for a, b in zip(ms, ms1))
                    for key in ("loss", "grad_norm")}
        worst = leaf_errors(gathered, st1, stacked=())
        res["one_process"] = ms1
        res["metric_err"] = metric_err(res["sharded"]["metrics"])
        top = max(worst, key=worst.get)
        res["leaf_err_max"] = (top, worst[top])
        bad = leaf_errors(fault, st1, stacked=())
        res["fault_err"] = {**metric_err(res["fault"]),
                            "leaf": max(bad.values()),
                            "leaf_name": max(bad, key=bad.get)}
        del fault
        c32 = cfg.replace(dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        st32, ms32 = run(make_train_step(c32, adamw(), sched),
                         {"params": p32, "opt": adamw().init(p32)})
        del p32
        e_sh = leaf_errors(gathered, st32, stacked=())
        e_one = leaf_errors(st1, st32, stacked=())
        res["f32_witness"] = {
            "leaf": top, "sharded_vs_f32": e_sh[top],
            "one_process_vs_f32": e_one[top],
            "losses_f32": [m["loss"] for m in ms32],
            "leaves_sharded_farther": sum(e_sh[k] > e_one[k]
                                          for k in e_sh),
            "leaves": len(e_sh)}
        del st1, st32
    del gathered
    dist.barrier()
    return res


def par_pipe(rank, world, dev) -> dict:
    """(d): smollm-135m's blocks as one stage a rank through
    ``pipeline_forward``, counted, held to ``hidden_states``."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel.pipeline import pipeline_forward
    c = PAR_PIPE
    stage = make_mesh((world,), ("stage",), device=dev)
    cfg = get_config(TRAIN_ARCH)
    params = T.init(cfg, seed=PAR_SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (c["batch"], c["seq"]),
                           generator=gen, device=dev)
    with torch.no_grad():
        x0 = L.embed_tokens(cfg, params["embed"], tokens)
        cos, sin = L.rope_freqs(cfg, torch.arange(c["seq"], device=dev))
        reset_launches()
        out, secs = timed(lambda: pipeline_forward(
            lambda lp, hs: T._block_out(cfg, lp, hs, cos, sin),
            params["layers"], x0, stage, n_micro=c["micro"]))
        counts = _nonzero(all_launches())
        got = L.apply_norm(cfg, params["final_norm"], out)
        want = T.hidden_states(cfg, params, tokens=tokens)
    per = cfg.n_layers // world
    hold_counts(f"parallel pipeline rank {rank}", counts,
                {"flash_attention_bf16": per * c["micro"]})
    err = normwise(got, want)
    if err > PAR_PIPE_TOL:
        fail(f"parallel pipeline rank {rank}: {err} normwise off the "
             f"sequential hidden_states (limit {PAR_PIPE_TOL})")
    return {"err": err, "counts": counts, "seconds": secs,
            "layers_here": per}


def parallel_worker(rank: int, world: int, backend: str, init: str,
                    out: str, device: str) -> None:
    """One rank of the ``parallel`` line (started with ``spawn``): (a)-(d)
    in order, each part's launches counted around its main path; the
    results as JSON in ``out/rank{rank}.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.parallel import init_distributed, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(backend, init, world, rank)
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    res = {"rank": rank, "seconds": {}}
    parts = (("decode", lambda: par_decode(
                 rank, world, make_mesh((world,), ("data",), device=dev),
                 dev, rank == 0)),
             ("moe", lambda: par_moe(
                 rank, world, make_mesh((world,), ("model",), device=dev),
                 dev)),
             ("train", lambda: par_train(
                 rank, world, make_mesh((world,), ("data",), device=dev),
                 dev)),
             ("pipe", lambda: par_pipe(rank, world, dev)))
    for name, fn in parts:
        t1 = time.perf_counter()
        res[name] = fn()
        res["seconds"][name] = time.perf_counter() - t1
        torch.cuda.empty_cache()
    res["seconds"]["all"] = time.perf_counter() - t0
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def phase_parallel(dev):
    """The model-parallel layer: two processes on ``cuda:0`` under gloo
    (NCCL refuses two ranks on one card), or one rank per card under NCCL
    where there are two or more, run (a)-(d) (``parallel_worker``); each
    writes its holds, launches and times, read back here."""
    import multiprocessing
    import shutil
    n = torch.cuda.device_count()
    world, backend = (n, "nccl") if n >= 2 else (2, "gloo")
    base = ROOT / "chiprun_out" / "parallel"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    ctx = multiprocessing.get_context("spawn")
    devs = [f"cuda:{r}" if backend == "nccl" else str(dev)
            for r in range(world)]
    procs = [ctx.Process(target=parallel_worker,
                         args=(r, world, backend, f"file://{base}/rdv",
                               str(base), devs[r]))
             for r in range(world)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:                    # a rank that fails leaves the other waiting
        while any(p.is_alive() for p in procs) \
                and time.perf_counter() - t0 < 600:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    secs = time.perf_counter() - t0
    if [p.exitcode for p in procs] != [0] * world:
        fail(f"parallel: ranks exited {[p.exitcode for p in procs]}")
    ranks = [json.loads((base / f"rank{r}.json").read_text())
             for r in range(world)]
    counts: dict = {}           # every rank's main-path launches
    for r in ranks:
        for c in ([r["decode"]["counts"], r["moe"]["counts"],
                   r["pipe"]["counts"]]
                  + list(r["train"]["counts"].values())):
            add_counts(counts, c)
    dec, moe, tr, pp = (ranks[0][k] for k in ("decode", "moe", "train",
                                               "pipe"))
    for key in ("loss", "grad_norm"):
        if tr["metric_err"][key] > TRAIN_FULL_TOL[key]:
            fail(f"parallel train: sharded {key} {tr['metric_err'][key]} "
                 f"relative off the one-process step's (limit "
                 f"{TRAIN_FULL_TOL[key]}); {tr['sharded']['metrics']} vs "
                 f"{tr['one_process']}")
    if tr["leaf_err_max"][1] > TRAIN_FULL_TOL["leaf"]:
        fail(f"parallel train: leaf {tr['leaf_err_max'][0]} after "
             f"{PAR_TRAIN['steps']} steps {tr['leaf_err_max'][1]} normwise "
             f"off the one-process step's (limit {TRAIN_FULL_TOL['leaf']})")
    fe = tr["fault_err"]
    fault_excess = max(fe[k] / TRAIN_FULL_TOL[k]
                       for k in ("loss", "grad_norm", "leaf"))
    if fault_excess <= 1.0:
        fail(f"parallel train: the planted fault (no sum over data in the "
             f"gradient's reduce-scatter) read {fe}, within the limits "
             f"{TRAIN_FULL_TOL}")
    w32 = tr["f32_witness"]
    if w32["sharded_vs_f32"] > FAM_F32_RATIO * w32["one_process_vs_f32"]:
        fail(f"parallel train: leaf {w32['leaf']} of the sharded run is "
             f"{w32['sharded_vs_f32']} normwise off a float32 one-process "
             f"run, more than FAM_F32_RATIO ({FAM_F32_RATIO}) times the "
             f"one-process bf16 run's {w32['one_process_vs_f32']}")
    at_rest = [[r["train"]["bytes_at_rest"][k]
                for k in ("params", "opt", "ef_residual")] for r in ranks]
    whole = [tr["bytes_whole"][k] for k in ("params", "opt")]
    say(f"parallel {world} processes under {backend}: (a) "
        f"dist_decode_attention B {PAR_DECODE['b']} H {PAR_DECODE['h']} / "
        f"{PAR_DECODE['hkv']} D {PAR_DECODE['d']} bf16 over "
        f"{PAR_DECODE['s']} keys: vs the plain version "
        f"{max(r['decode']['errs']['vs_plain32'] for r in ranks):.3e}, vs "
        f"one K3 call {max(r['decode']['errs']['vs_one_k3'] for r in ranks):.3e}"
        f", planted lse+1 {min(r['decode']['errs']['planted'] for r in ranks):.3e}"
        f" (limit {PAR_DECODE_TOL:.3e}), lse {max(r['decode']['lse_err'] for r in ranks):.2e}"
        f", K3 partial {dec['ms']:.4f} ms plain {dec['plain_ms']:.4f} sdpa "
        f"{dec['sdpa_ms']:.4f} bound {dec['bound'][0]:.4f} ms; (b) "
        f"ep_moe_ffn {PAR_MOE_TOKENS} tokens x 64 experts top-6: no-drop "
        f"capacity vs grouped {max(r['moe']['errs']['nodrop_vs_grouped'] for r in ranks):.3e}"
        f", config capacity {moe['capacity']} ({moe['dropped_slots']} "
        f"slots dropped) vs one rank "
        f"{max(r['moe']['errs']['cfg_vs_one_rank'] for r in ranks):.3e}, "
        f"capacity {moe['drop_capacity']} of the largest load "
        f"{moe['max_load']} ({moe['drop_dropped_slots']} slots dropped) vs "
        f"one rank "
        f"{max(r['moe']['errs']['drop_vs_one_rank'] for r in ranks):.3e} "
        f"(limit {PAR_MOE_TOL:.3e}); (c) smollm-135m sharded step x "
        f"{PAR_TRAIN['steps']}: losses "
        f"{[round(m['loss'], 5) for m in tr['sharded']['metrics']]} vs "
        f"{[round(m['loss'], 5) for m in tr['one_process']]} (relative "
        f"{tr['metric_err']['loss']:.2e}, grad_norm "
        f"{tr['metric_err']['grad_norm']:.2e}), worst leaf "
        f"{tr['leaf_err_max'][0]} {tr['leaf_err_max'][1]:.3e} (limits "
        f"{TRAIN_FULL_TOL}), EF grad_norms "
        f"{[round(m['grad_norm'], 4) for m in tr['ef']['metrics']]} vs "
        f"{[round(m['grad_norm'], 4) for m in tr['sharded']['metrics']]}, "
        f"bytes at rest a rank [params, opt, EF residuals] {at_rest} of "
        f"the whole "
        f"state's {whole}, "
        f"planted no-sum-over-data {fe} (excess {fault_excess:.3g}), "
        f"float32 witness {tr['f32_witness']}, "
        f"{tr['sharded']['seconds']:.2f} s sharded / "
        f"{tr['ef']['seconds']:.2f} s EF; (d) pipeline 2 x "
        f"{pp['layers_here']} blocks, {PAR_PIPE['micro']} microbatches: "
        f"{max(r['pipe']['err'] for r in ranks):.3e} (limit "
        f"{PAR_PIPE_TOL:.3e}); {secs:.1f} s from spawn to exit")
    if secs > 90:
        say(f"parallel: WARNING {secs:.1f} s from spawn to exit, over the "
            f"90 s budget")
    row = {"ms": dec["ms"], "plain_ms": dec["plain_ms"],
           "bound": tuple(dec["bound"]), "sdpa_ms": dec["sdpa_ms"],
           "max_abs_err": max(r["decode"]["max_abs_err"] for r in ranks)}
    return {"world": world, "backend": backend, "seconds": secs,
            "ranks": ranks}, counts, row


SOURCES = {
    "se": ("src/repro_torch/csrc/search_wave.cu",
           "src/repro/kernels/search_wave/kernel.py:403"),
    "bes": ("src/repro_torch/csrc/search_wave.cu",
            "src/repro/kernels/search_wave/kernel.py:415"),
    "se_wu_running": ("src/repro_torch/csrc/search_wave.cu",
                      "src/repro/kernels/search_wave/kernel.py:403"),
    "bes_wu_running": ("src/repro_torch/csrc/search_wave.cu",
                       "src/repro/kernels/search_wave/kernel.py:415"),
    "b": ("src/repro_torch/csrc/search_wave.cu",
          "src/repro/kernels/search_wave/kernel.py:427"),
    "uct_argmax_tiles": ("src/repro_torch/csrc/uct_select.cu",
                         "src/repro/kernels/uct_select/kernel.py:51"),
    "uct_argmax_running": ("src/repro_torch/csrc/uct_select.cu",
                           "src/repro/kernels/uct_select/kernel.py:133"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:74"),
    "flash_attention_bf16": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:74"),
    "flash_attention_bf16_mla": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:74"),
    "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:61"),
    # K3 storing each row's lse: the sequence-sharded decode's partial
    "decode_attention_lse": (
        "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention/kernel.py:61"),
    "flash_attention_lse": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:74"),
    "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/layers.py:211"),
    # kernel B at MLA's (192, 128): the two-warpgroup dK / dV kernel
    "flash_attention_bwd_mla": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/models/layers.py:211"),
    "wkv6_step": ("src/repro_torch/csrc/rwkv6_scan.cu",
                  "src/repro/kernels/rwkv6_scan/kernel.py:69"),
    "ssd_step": ("src/repro_torch/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan/kernel.py:65"),
    "wkv6_chunked": ("src/repro_torch/csrc/rwkv6_chunk.cu",
                     "src/repro/kernels/rwkv6_scan/kernel.py:69"),
    "ssd_chunked": ("src/repro_torch/csrc/ssm_chunk.cu",
                    "src/repro/kernels/ssm_scan/kernel.py:65"),
    # the backward of the chunked scans: the counterparts of the autodiff
    # of the JAX package's jnp training scans (its Pallas kernels have no
    # VJP)
    "wkv6_bwd": ("src/repro_torch/csrc/rwkv6_chunk_bwd.cu",
                 "src/repro/kernels/rwkv6_scan/ops.py:23"),
    "ssd_bwd": ("src/repro_torch/csrc/ssm_chunk_bwd.cu",
                "src/repro/kernels/ssm_scan/ops.py:15"),
}
# the shape whose times the kernels line carries: the sequential kernels
# (rows ``*_step``: they walk the steps one by one) serve single steps,
# the chunked ones sequences
REC_TIMED = {"wkv6_step": "decode", "ssd_step": "decode",
             "wkv6_chunked": "prefill", "ssd_chunked": "prefill"}


PHASE_S: dict = {}    # phase function -> seconds spent in it (all calls)


@contextlib.contextmanager
def clock(name: str):
    """Adds the span's seconds to PHASE_S[name] (the ``phase-s`` line:
    where the script's time limit goes)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--before", metavar="DIR", help="the root of a "
                    "checkout of an earlier commit (e.g. a git archive of "
                    "the parent): its flash_attention, decode_attention "
                    "and uct_select kernels are built by its own _build "
                    "and timed through its own wrappers in turns beside "
                    "the port's")
    before = ap.parse_args().before
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    with clock("env"):
        card, name = phase_env()
    with clock("build"):
        build_s, ptxas, sass = phase_build(before)
    with clock("kernels"):
        kern = phase_kernels(dev)
    with clock("attn_kernels"):
        attn, attn_bf16 = phase_attn_kernels(dev)
    with clock("attn_mla"):
        attn["flash_attention_bf16_mla"] = phase_attn_mla(dev)
    attn["flash_attention"]["max_abs_err"] = max(
        attn["flash_attention"]["max_abs_err"],
        attn["flash_attention_bf16_mla"]["f32_err"])
    with clock("rec_kernels"):
        rec_kern, rec_attn, rec_f32, rec_carry_, rec_cross = \
            phase_rec_kernels(dev)
    torch.cuda.synchronize()
    census: dict = {}
    reset_launches()        # the small main paths (float32 smoke models)
    with clock("small"):
        small = phase_small(dev)
    with f32_census(census, "smollm-smoke decode"), clock("lm_small"):
        lm_small = phase_lm_small(dev)
    with f32_census(census, "smoke engines (zamba2)"), \
            clock("rec_small"):
        rec_small = phase_rec_small(dev)
    with f32_census(census, "smoke carries"), clock("carry_small"):
        carry_small = phase_carry_small(dev)
    torch.cuda.synchronize()
    small_counts = all_launches()          # read just after them
    if small_counts["flash_attention"] == 0:
        fail("the float32 flash_attention kernel was not launched on the "
             "float32 smoke models' paths")
    with clock("f32_paths"):
        f32_paths = phase_f32_paths(dev, census,
                                    small_counts["flash_attention"])
    attn["flash_attention"]["main_path"] = f32_paths
    attn["flash_attention"]["max_abs_err"] = max(
        attn["flash_attention"]["max_abs_err"], f32_paths["max_abs_err"])
    # the other families' smoke configs (their own main path, counted
    # outside the float32 census: its timed shapes are the dense paths')
    with clock("families_small"):
        fam_small, fam_small_counts = phase_families_small(dev)
    with clock("full"):
        runs, counts = phase_full(dev)
    with clock("lm_full"):
        lm_run, lm_params, lm_first = phase_lm_full(dev)
    # the carry runs before any tracing: their steps are timed beside the
    # cold mcts_decode_batch run's
    with clock("lm_carry"):
        lm_carry = phase_lm_carry(dev, lm_params, {
            "tokens": lm_run["tokens"], "first_planes": lm_first,
            "tokens_per_s": lm_run["tokens_per_s"]}, card)
    for k, e in lm_carry["attn_err"].items():
        attn[k]["max_abs_err"] = max(attn[k]["max_abs_err"], e)
    # the sharded paths, before any tracing
    torch.cuda.synchronize()
    reset_launches()
    shard = {}
    for key, fn, args in (("shard", phase_shard, ()),
                          ("shard_mp", phase_shard_mp, ()),
                          ("ft", phase_ft, ()),
                          ("lm_shard", phase_lm_shard, (lm_params,))):
        with clock(key):
            shard[key] = fn(dev, *args)
    torch.cuda.synchronize()
    shard_counts = all_launches()          # read just after them
    for k in ("bes", "se", "se_running", "b", "decode_attention",
              "flash_attention_bf16"):
        if shard_counts[k] == 0:
            fail(f"kernel {k} was not launched on the sharded paths")
    with clock("lm_profile"):
        lm_prof = phase_lm_profile(dev, lm_params)
    del lm_params, lm_first
    torch.cuda.empty_cache()
    with clock("rec_full"):
        rec_runs, rec_counts, rec_prof = phase_rec_full(dev)
    # the other families at their published widths, each path counted
    fam_full, fam_counts = {}, []
    for name, fn in (("moe", phase_moe_full), ("vlm", phase_vlm_full),
                     ("whisper", phase_whisper_full)):
        with clock(name + "_full"):
            fam_full[name], c = fn(dev)
        fam_counts += list(c)
    for k, e in (("flash_attention_bf16_mla",
                  fam_full["moe"]["k4_check"]["max_abs_err"]),
                 ("flash_attention_bf16_mla",
                  fam_full["moe"]["mcts"]["k4_check"]["max_abs_err"]),
                 ("flash_attention_bf16",
                  fam_full["vlm"]["multimodal"]["k4_check"]["max_abs_err"]),
                 ("flash_attention_bf16",
                  fam_full["whisper"]["k4_check"]["max_abs_err"]),
                 ("decode_attention", fam_full["vlm"]["k3_check"]["bf16"]),
                 ("decode_attention",
                  fam_full["whisper"]["k3_check"]["bf16"])):
        attn[k]["max_abs_err"] = max(attn[k]["max_abs_err"], e)
    # training: kernels A / B, the dense smoke steps and smollm-135m at its
    # published width (one main path), then the serving driver (another)
    with clock("train_kernels"):
        train_rows, train_kern = phase_train_kernels(dev)
        scan_rows, scan_kern = phase_train_scan_kernels(dev)
    attn.update(train_rows)
    attn.update(scan_rows)
    torch.cuda.synchronize()
    reset_launches()
    train_counts: dict = {}
    with clock("train_small"):
        train_small = phase_train_small(dev, train_counts)
    with clock("train_full"):
        train_full = phase_train_full(dev, train_counts)
    train_fam = {}
    for arch in TRAIN_FAM_ARCHS + (TRAIN_MOE_FULL,):   # at full width
        with clock("train_full_" + arch.split("-")[0]):
            train_fam[arch] = phase_train_family_full(dev, arch,
                                                      train_counts)
    torch.cuda.synchronize()
    reset_launches()
    with clock("serve_launch"):
        serve_counts = phase_serve_launch(dev)
    # the model-parallel layer: its ranks count their own main paths
    with clock("parallel"):
        par, par_counts, attn["decode_attention_lse"] = phase_parallel(dev)
    with clock("profile"):
        prof = phase_profile(dev)
    # launches on the main paths: the float32 smoke runs, P-game, LM
    # decode cold and with the carries, the sharded paths, the engines,
    # the other families (smoke and full width)
    paths = (small_counts, counts, lm_run["launches"], lm_carry["launches"],
             shard_counts, rec_counts, fam_small_counts, *fam_counts,
             train_counts, serve_counts, par_counts)
    total = {k: sum(p.get(k, 0) for p in paths) for k in all_launches()}
    for k in ("wkv6", "ssd"):     # the counters count calls of both routes
        total[k + "_step"] = total.pop(k) - total[k + "_chunked"]
    for k in ("se", "bes"):       # and of both level assignments
        total[k + "_wu_running"] = total.pop(k + "_running")
        total[k] -= total[k + "_wu_running"]
    idle = [k for k in SOURCES if total[k] == 0]
    if idle:
        fail(f"kernels {idle} were launched on no main path")
    kernels = []
    for k, (src, repl) in SOURCES.items():
        if k in attn:
            a = attn[k]
            err = max([a["max_abs_err"]] + [
                v.get("max_abs_err", v.get("bf16"))
                for t, v in rec_attn.items() if t.split("/")[0] == k])
            ms, pms, (bms, by), lib = a["ms"], a["plain_ms"], a["bound"], \
                a["sdpa_ms"]
        elif k.split("_")[0] in rec_kern:
            cases = rec_kern[k.split("_")[0]]
            route = "chunked" if k.endswith("_chunked") else "sequential"
            t = cases[REC_TIMED[k]]
            err = max(v["bf16"] for v in cases.values()
                      if v["route"] == route)
            # each route against the least time of its own work: the
            # chunked kernels run their products on the bf16 tensor cores
            ms, pms, lib = t["ms"], t["plain_ms"], None
            bms, by = t["chunk_bound" if route == "chunked" else "bound"]
        else:
            # K1 / K2 on the P-game snapshots: the running rows on the
            # wu/running one, the others on loss/independent
            tag = "wu/running" if k.endswith("_wu_running") \
                else "loss/independent"
            base = k.replace("_wu_running", "")
            err, ms, pms, (bms, by) = kern[tag][base]
            lib = None
            if base == "bes":
                err = max(err, lm_run["bes_max_abs_err"],
                          lm_carry["runs"]["both"]["bes_max_abs_err"])
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": repl, "launches": total[k],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by, "library_ms": lib})
    say("phase-s " + " ".join(f"{k}={v:.1f}" for k, v in PHASE_S.items())
        + f" (seconds in each phase; {time.perf_counter() - t_start:.1f} in "
        f"all)")
    say("host-us " + " ".join(
        f"{k}={v:.1f}" + ("[{:.1f}-{:.1f}]".format(*HOST_SPREAD[k])
                          if k in HOST_SPREAD else "")
        for k, v in HOST.items())
        + " (host microseconds per wrapper call, no synchronise; search "
        f"wrappers: median [min-max] of {ROUNDS} rounds)")
    detail = {"card": card, "device": name, "build_s": build_s,
              "ptxas": ptxas, "sass": sass, "kernels": kern,
              "attn_kernels": attn,
              "attn_bf16_checks": attn_bf16,
              "small_float_diff": small, "lm_small_tokens": lm_small,
              "full_runs": runs, "launch_counts": counts, "profile": prof,
              "lm_full": lm_run, "lm_profile": lm_prof,
              "carry_small": carry_small, "lm_carry": lm_carry,
              "shard": shard, "launches_shard": shard_counts,
              "rec_kernels": rec_kern, "rec_attn_zamba2": rec_attn,
              "rec_carry": rec_carry_, "rec_crossover": rec_cross,
              "rec_f32_err": rec_f32, "rec_small_tokens": rec_small,
              "rec_full": rec_runs, "rec_launches": rec_counts,
              "rec_profile": rec_prof, "families_small": fam_small,
              "families_full": fam_full, "train_kernels": train_kern,
              "train_small": train_small, "train_full": train_full,
              "train_scan_kernels": scan_kern,
              "train_families_full": train_fam,
              "launches_train": train_counts,
              "launches_serve_launch": serve_counts,
              "parallel": par, "launches_parallel": par_counts,
              "launches_total": total,
              "launches_small": small_counts, "host_us": HOST,
              "host_us_spread": HOST_SPREAD, "chains": CHAINS,
              "k2a": K2A, "phase_s": PHASE_S,
              "seconds": time.perf_counter() - t_start,
              "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    write_out("chip_smoke.json", [json.dumps(detail, indent=1)])
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
