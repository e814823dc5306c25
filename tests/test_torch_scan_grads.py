"""Port parity of the K5 / K6 backward on the CPU: the plain backward
(``wkv6_bwd_ref`` / ``ssd_bwd_ref``, the dataflow of the CUDA kernels
``csrc/rwkv6_chunk_bwd.cu`` / ``ssm_chunk_bwd.cu``) against ``jax.vjp`` of
the JAX package's sequential oracles (``wkv6_ref`` / ``ssd_ref``) and of
its chunked training scans (``wkv6_chunked`` / ``ssd_chunked``), and the
autograd Functions behind ``wkv6`` / ``ssd`` on CPU tensors.

Inputs come from numpy with a seed; T is ragged (not a multiple of the
64-step chunk) and the entering state and the output state's gradient are
non-zero.  Tolerance: float32 both sides, the same sums in other orders,
so each gradient within 1e-5 of the largest element of the JAX one
(normwise).  One exception: ``dA`` against ``ssd_chunked`` within 1e-4,
since the JAX package's own two paths give ``dA`` (a sum over batch and
time of terms of both signs) 2.8e-5 apart on the ragged draw.
``wkv6_chunked`` clamps its cumulative log-decay at -30
inside a 32-step chunk (``LOG_CLAMP``, the reference's behaviour): the
draws compared with it print their most negative 32-step cumulative
log-decay and assert that it stays above the clamp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan import ops as jwops  # noqa: E402
from repro.kernels.rwkv6_scan import ref as jwref  # noqa: E402
from repro.kernels.ssm_scan import ops as jsops  # noqa: E402
from repro.kernels.ssm_scan import ref as jsref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as twops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as twref  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as tsops  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as tsref  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = 1e-5          # normwise: max |got - want| / max |want|
DA_CHUNKED_TOL = 1e-4   # dA against ssd_chunked (see the docstring)
LOG_CLAMP = jwops.LOG_CLAMP
WKV_NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")
SSD_NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dD", "dstate")


def normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def wkv_inputs(seed, b, t, h, n, decay):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    r, k, v = f(b, t, h, n), f(b, t, h, n), f(b, t, h, n)
    if decay == "strong":      # down to 1e-20, some steps at it
        w = np.exp(-np.exp(rng.uniform(-3, 3.8, (b, t, h, n))))
        w[:, 3:7] = 1e-20
    else:                      # the model's range near its init
        w = np.exp(-np.exp(rng.uniform(-7, -1, (b, t, h, n))))
    return (r, k, v, w.astype(np.float32), f(h, n), f(b, h, n, n),
            f(b, t, h, n), f(b, h, n, n))


def ssd_inputs(seed, b, t, h, p, n):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(b, t, h) - 1.0)).astype(np.float32)
    a = -np.exp(rng.uniform(-1, 1, h)).astype(np.float32)
    return (f(b, t, h, p), dt, a, f(b, t, n), f(b, t, n), f(h),
            f(b, h, p, n), f(b, t, h, p), f(b, h, p, n))


def most_negative_log_decay(w, chunk=32):
    """The most negative sum of log w over any 32-step chunk of the JAX
    chunked scan (its padded tail counts w = 1)."""
    lw = np.log(np.maximum(w.astype(np.float64), 1e-38))
    t = lw.shape[1]
    pad = (-t) % chunk
    lw = np.pad(lw, ((0, 0), (0, pad), (0, 0), (0, 0)))
    return float(lw.reshape(lw.shape[0], -1, chunk, *lw.shape[2:])
                 .sum(2).min())


def jax_vjp(fn, primals, cot):
    return jax.vjp(fn, *primals)[1](cot)


def t_(a):
    return torch.tensor(np.asarray(a))


WKV_CASES = {"ragged": (0, 2, 70, 2, 8, "model"),
             "strong": (1, 2, 70, 2, 8, "strong"),
             "three_chunks": (2, 1, 150, 3, 16, "model"),
             "short": (3, 2, 5, 2, 8, "strong")}


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_bwd_ref_vs_jax_sequential(case):
    seed, b, t, h, n, decay = WKV_CASES[case]
    r, k, v, w, u, s0, dy, ds = wkv_inputs(seed, b, t, h, n, decay)
    want = jax_vjp(jax.jit(jwref.wkv6_ref), (r, k, v, w, u, s0), (dy, ds))
    y, s, states = twref.wkv6_fwd_ref(*map(t_, (r, k, v, w, u, s0)))
    y_j, s_j = jwref.wkv6_ref(r, k, v, w, u, s0)
    assert normwise(y, y_j) < TOL and normwise(s, s_j) < TOL
    assert states.shape == (-(-t // 64), b, h, n, n)
    got = twref.wkv6_bwd_ref(*map(t_, (r, k, v, w, u)), states, t_(dy),
                             t_(ds))
    for name, g, wt in zip(WKV_NAMES, got, want):
        assert g.dtype == torch.float32
        assert bool(torch.isfinite(g).all()), name
        assert normwise(g, wt) < TOL, (case, name, normwise(g, wt))


@pytest.mark.parametrize("case", ["ragged", "three_chunks"])
def test_wkv6_bwd_ref_vs_jax_chunked(case):
    seed, b, t, h, n, decay = WKV_CASES[case]
    r, k, v, w, u, s0, dy, ds = wkv_inputs(seed, b, t, h, n, decay)
    low = most_negative_log_decay(w)
    print(f"most negative 32-step cumulative log-decay: {low:.3f} "
          f"(LOG_CLAMP {LOG_CLAMP})")
    assert low > LOG_CLAMP
    want = jax_vjp(jax.jit(jwops.wkv6_chunked), (r, k, v, w, u, s0),
                   (dy, ds))
    _, _, states = twref.wkv6_fwd_ref(*map(t_, (r, k, v, w, u, s0)))
    got = twref.wkv6_bwd_ref(*map(t_, (r, k, v, w, u)), states, t_(dy),
                             t_(ds))
    for name, g, wt in zip(WKV_NAMES, got, want):
        assert normwise(g, wt) < TOL, (case, name, normwise(g, wt))


@pytest.mark.parametrize("case", ["ragged", "strong"])
def test_wkv6_function_on_cpu(case):
    """``wkv6`` under grad goes through its Function (plain route on the
    CPU): the same y and the same gradients as autograd through the
    sequential ``wkv6_ref``; bf16 inputs give bf16 gradients for r, k, v,
    u."""
    seed, b, t, h, n, decay = WKV_CASES[case]
    r, k, v, w, u, s0, dy, ds = wkv_inputs(seed, b, t, h, n, decay)
    leaves = [t_(z).requires_grad_(True) for z in (r, k, v, w, u, s0)]
    y, s = twops.wkv6(*leaves)
    assert type(y.grad_fn).__name__ == "_WKV6Backward"
    got = torch.autograd.grad((y, s), leaves, (t_(dy), t_(ds)))
    leaves2 = [t_(z).requires_grad_(True) for z in (r, k, v, w, u, s0)]
    y2, s2 = twref.wkv6_ref(*leaves2)
    want = torch.autograd.grad((y2, s2), leaves2, (t_(dy), t_(ds)))
    assert normwise(y.detach(), y2.detach()) < TOL
    for name, g, wt in zip(WKV_NAMES, got, want):
        assert normwise(g, wt) < TOL, (name, normwise(g, wt))
    lb = [t_(z).to(torch.bfloat16).requires_grad_(True)
          for z in (r, k, v)]
    yb, _ = twops.wkv6(*lb, t_(w), t_(u).to(torch.bfloat16), t_(s0))
    gb = torch.autograd.grad(yb.float().sum(), lb)
    assert yb.dtype == torch.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in gb)


SSD_CASES = {"ragged": (0, 2, 70, 3, 4, 5),
             "three_chunks": (1, 1, 150, 2, 8, 8),
             "short": (2, 2, 5, 2, 4, 3)}


@pytest.mark.parametrize("oracle", ["sequential", "chunked"])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_bwd_ref_vs_jax(case, oracle):
    seed, b, t, h, p, n = SSD_CASES[case]
    x, dt, a, bm, cm, d, s0, dy, ds = ssd_inputs(seed, b, t, h, p, n)
    fn = jsref.ssd_ref if oracle == "sequential" else jsops.ssd_chunked
    want = jax_vjp(jax.jit(fn), (x, dt, a, bm, cm, d, s0), (dy, ds))
    y, s, states = tsref.ssd_fwd_ref(*map(t_, (x, dt, a, bm, cm, d, s0)))
    y_j, s_j = jsref.ssd_ref(x, dt, a, bm, cm, d, s0)
    assert normwise(y, y_j) < TOL and normwise(s, s_j) < TOL
    got = tsref.ssd_bwd_ref(*map(t_, (x, dt, a, bm, cm, d)), states,
                            t_(dy), t_(ds))
    for name, g, wt in zip(SSD_NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        tol = DA_CHUNKED_TOL if (name, oracle) == ("dA", "chunked") else TOL
        assert normwise(g, wt) < tol, (case, oracle, name, normwise(g, wt))


def test_ssd_function_on_cpu_strided():
    """``ssd`` under grad goes through its Function with x, Bm and Cm as
    slices of one tensor (as the model hands in its conv output): the
    gradients land in that tensor, equal to autograd through the
    sequential ``ssd_ref``."""
    seed, b, t, h, p, n = SSD_CASES["ragged"]
    x, dt, a, bm, cm, d, s0, dy, ds = ssd_inputs(seed, b, t, h, p, n)
    xbc = np.concatenate([x.reshape(b, t, h * p), bm, cm], -1)

    def run(fn):
        base = t_(xbc).requires_grad_(True)
        rest = [t_(z).requires_grad_(True) for z in (dt, a, d, s0)]
        xs = base[..., :h * p].reshape(b, t, h, p)
        y, s = fn(xs, rest[0], rest[1], base[..., h * p:h * p + n],
                  base[..., h * p + n:], rest[2], rest[3])
        grads = torch.autograd.grad((y, s), [base] + rest, (t_(dy), t_(ds)))
        return y, grads

    y, got = run(tsops.ssd)
    assert type(y.grad_fn).__name__ == "_SSDBackward"
    _, want = run(tsref.ssd_ref)
    for name, g, wt in zip(("xbc", "ddt", "dA", "dD", "dstate"), got, want):
        assert normwise(g, wt) < TOL, (name, normwise(g, wt))


@pytest.mark.parametrize("case", sorted(WKV_CASES))
def test_wkv6_bwd_sub_ref_vs_jax_sequential(case):
    """The sub-chunk form of the K5 backward kernel (``wkv6_bwd_sub_ref``:
    sub-chunks of 16, the states at their boundaries, the recurrences of
    one thread per channel and sub-chunk) against ``jax.vjp`` of the
    sequential ``wkv6_ref``; decays down to 1e-20 in the strong draws."""
    seed, b, t, h, n, decay = WKV_CASES[case]
    r, k, v, w, u, s0, dy, ds = wkv_inputs(seed, b, t, h, n, decay)
    want = jax_vjp(jax.jit(jwref.wkv6_ref), (r, k, v, w, u, s0), (dy, ds))
    _, _, states = twref.wkv6_fwd_ref(*map(t_, (r, k, v, w, u, s0)))
    got = twref.wkv6_bwd_sub_ref(*map(t_, (r, k, v, w, u)), states, t_(dy),
                                 t_(ds))
    for name, g, wt in zip(WKV_NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert normwise(g, wt) < TOL, (case, name, normwise(g, wt))


SSD_GROUPED = {"ragged-1": ("ragged", 1), "ragged-3": ("ragged", 3),
               "three_chunks-2": ("three_chunks", 2),
               "short-2": ("short", 2)}


@pytest.mark.parametrize("case", sorted(SSD_GROUPED))
def test_ssd_bwd_grouped_ref_vs_jax(case):
    """The K6 backward kernel's dataflow (``ssd_bwd_grouped_ref``: E folded
    into M1 = CB o E and M2 = DX o E, Q's row and column sums, dB and dC
    summed inside groups of heads, then over the groups) against
    ``jax.vjp`` of the sequential ``ssd_ref``."""
    name, group = SSD_GROUPED[case]
    seed, b, t, h, p, n = SSD_CASES[name]
    x, dt, a, bm, cm, d, s0, dy, ds = ssd_inputs(seed, b, t, h, p, n)
    want = jax_vjp(jax.jit(jsref.ssd_ref), (x, dt, a, bm, cm, d, s0),
                   (dy, ds))
    _, _, states = tsref.ssd_fwd_ref(*map(t_, (x, dt, a, bm, cm, d, s0)))
    got = tsref.ssd_bwd_grouped_ref(*map(t_, (x, dt, a, bm, cm, d)), states,
                                    t_(dy), t_(ds), group=group)
    for nm, g, wt in zip(SSD_NAMES, got, want):
        assert bool(torch.isfinite(g).all()), nm
        assert normwise(g, wt) < TOL, (case, nm, normwise(g, wt))


@pytest.mark.parametrize("b,h,nc,want", [(8, 64, 32, 8), (8, 32, 32, 8),
                                         (1, 64, 6, 1), (2, 4, 3, 1),
                                         (4, 12, 32, 4), (3, 6, 64, 2)])
def test_ssd_head_group(b, h, nc, want):
    """The heads a block of the K6 backward takes: the largest of 8, 4, 2
    dividing H that leaves two blocks for each of the H100's 132 SMs."""
    assert tsops.head_group(b, h, nc) == want
