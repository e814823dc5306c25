"""Port parity of the recurrent kernels' plain versions (K5 WKV6, K6 SSD)
against the JAX package's oracles (``wkv6_ref`` / ``ssd_ref``) and its
Pallas kernels in interpret mode, on the CPU (the CUDA kernels against
these plain versions on a card: ``test_torch_card_recurrent.py``).  Both
plain versions of each kernel are held: the sequential one (``ssd_ref`` /
``wkv6_ref``, what the wrapper runs on the CPU) and the chunked one
(``ssd_chunked_ref`` / ``wkv6_chunked_ref``, the arithmetic of the
tensor-core kernels), the latter at T = 1 and at lengths that leave a
chunk of 64 with a tail (65, 130).

Inputs come from numpy under a seed, at the shapes of
``tests/test_kernels.py`` plus T = 1 (every decode step).  Tolerance 2e-4
absolute and relative, as ``tests/test_kernels.py`` uses: the Pallas
kernels compute the chunked matmul form, whose sums run in another order
than the sequential scan.  With strong decays (w down to 0) the chunked
WKV6 is held to ``wkv6_ref`` only: the JAX package's chunked forms divide
by cumulative decays (the Pallas kernel) or clamp them (``wkv6_chunked``)
and are no oracle there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6_scan import kernel as jwk  # noqa: E402
from repro.kernels.rwkv6_scan import ops as jwo  # noqa: E402
from repro.kernels.rwkv6_scan import ref as jwr  # noqa: E402
from repro.kernels.ssm_scan import kernel as jsk  # noqa: E402
from repro.kernels.ssm_scan import ref as jsr  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as two  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref as twr  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as tso  # noqa: E402
from repro_torch.kernels.ssm_scan import ref as tsr  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=2e-4, rtol=2e-4)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def wkv6_inputs(seed, b, t, h, n):
    """r, k, v, w, u, state as numpy float32 (decays in (0.8, 1.0))."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (g(b, t, h, n) * 0.5, g(b, t, h, n) * 0.5, g(b, t, h, n) * 0.5,
            (_sigmoid(g(b, t, h, n)) * 0.2 + 0.8).astype(np.float32),
            g(h, n) * 0.3, g(b, h, n, n) * 0.1)


def ssd_inputs(seed, b, t, h, p, n):
    """x, dt, A, Bm, Cm, D, state as numpy float32 (A < 0, dt > 0)."""
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (g(b, t, h, p) * 0.5, np.log1p(np.exp(g(b, t, h))),
            -np.exp(g(h) * 0.3), g(b, t, n) * 0.5, g(b, t, n) * 0.5,
            np.full((h,), 0.5, np.float32), g(b, h, p, n) * 0.1)


def _t(xs):
    return [torch.from_numpy(np.ascontiguousarray(x, np.float32))
            for x in xs]


@pytest.mark.parametrize("b,t,h,n,chunk", [
    (2, 64, 2, 16, 16), (1, 100, 3, 8, 32), (2, 48, 4, 32, 16),
    (3, 1, 2, 8, 16), (2, 1, 4, 64, 16),
])
def test_wkv6_plain_matches_jax_ref_and_pallas(b, t, h, n, chunk):
    args = wkv6_inputs(t * 7 + n, b, t, h, n)
    y, s = two.wkv6(*_t(args))
    jy, js = jwr.wkv6_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    ky, ks = jwk.wkv6_pallas(*map(jnp.asarray, args), chunk=chunk,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), **TOL)
    assert y.dtype == torch.float32 and s.dtype == torch.float32


@pytest.mark.parametrize("t", [1, 40])
def test_wkv6_plain_matches_jax_dispatch(t):
    """The JAX model's own dispatch (``impl="auto"``: chunked for T > 1,
    sequential for T = 1) against the port's sequential scan."""
    args = wkv6_inputs(5, 2, t, 2, 8)
    args = args[:5] + (np.zeros_like(args[5]),)
    y, s = two.wkv6(*_t(args))
    jy, js = jwo.wkv6(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


def test_wkv6_plain_keeps_types_and_recurs():
    """y in r's dtype, the state float32; two halves carried through the
    state equal one pass."""
    args = _t(wkv6_inputs(9, 2, 10, 2, 8))
    r, k, v, w, u, st = args
    y16, s16 = two.wkv6(r.bfloat16(), k.bfloat16(), v.bfloat16(), w,
                        u.bfloat16(), st)
    assert y16.dtype == torch.bfloat16 and s16.dtype == torch.float32
    y, s = two.wkv6(*args)
    ya, sa = two.wkv6(r[:, :4], k[:, :4], v[:, :4], w[:, :4], u, st)
    yb, sb = two.wkv6(r[:, 4:], k[:, 4:], v[:, 4:], w[:, 4:], u, sa)
    torch.testing.assert_close(torch.cat([ya, yb], 1), y, atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(sb, s, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("b,t,h,p,n,chunk", [
    (2, 64, 2, 16, 8, 16), (1, 96, 4, 8, 16, 32), (2, 80, 2, 32, 64, 16),
    (3, 1, 2, 8, 8, 16), (2, 1, 4, 64, 64, 16),
])
def test_ssd_plain_matches_jax_ref_and_pallas(b, t, h, p, n, chunk):
    args = ssd_inputs(t * 5 + n, b, t, h, p, n)
    y, s = tso.ssd(*_t(args))
    jy, js = jsr.ssd_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    ky, ks = jsk.ssd_pallas(*map(jnp.asarray, args), chunk=chunk,
                            interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), **TOL)


def test_ssd_plain_reads_strided_slices():
    """x, Bm, Cm as slices of one packed buffer (the model's conv output)
    give the same result as packed copies."""
    x, dt, a, bm, cm, d, st = _t(ssd_inputs(3, 2, 12, 4, 8, 8))
    buf = torch.cat([x.reshape(2, 12, 32), bm, cm], -1)
    xs = buf[..., :32].reshape(2, 12, 4, 8)
    assert not xs.is_contiguous()
    y1, s1 = tso.ssd(xs, dt, a, buf[..., 32:40], buf[..., 40:], d, st)
    y2, s2 = tso.ssd(x, dt, a, bm, cm, d, st)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.parametrize("fn,args", [
    (two.wkv6, lambda: _t(wkv6_inputs(0, 1, 3, 2, 8))),
    (tso.ssd, lambda: _t(ssd_inputs(0, 1, 3, 2, 8, 8))),
])
def test_cpu_tensors_take_the_plain_version(fn, args):
    """On CPU tensors the wrapper runs its plain version and launches
    nothing; asking for the kernel there raises."""
    counts = (dict(two.launches), dict(tso.launches))
    fn(*args())
    assert (two.launches, tso.launches) == counts
    with pytest.raises(ValueError, match="CUDA tensors"):
        fn(*args(), impl="cuda")


@pytest.mark.parametrize("b,t,h,n", [(3, 1, 2, 8), (2, 64, 2, 16),
                                     (2, 65, 2, 16), (1, 130, 3, 8)])
def test_wkv6_chunked_plain_matches_jax_ref_and_pallas(b, t, h, n):
    args = wkv6_inputs(t * 3 + n, b, t, h, n)
    y, s = twr.wkv6_chunked_ref(*_t(args))
    assert y.shape == (b, t, h, n) and s.shape == (b, h, n, n)
    jy, js = jwr.wkv6_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    ky, ks = jwk.wkv6_pallas(*map(jnp.asarray, args), chunk=64,
                             interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), **TOL)


@pytest.mark.parametrize("t", [20, 65, 130])
def test_wkv6_chunked_plain_holds_strong_decays(t):
    """Decays down to exactly 0 (a fifth of them below 0.05): every
    exponent of the chunked form is a local sum of log decays, so it
    stays finite and agrees with the sequential oracle."""
    r, k, v, w, u, st = wkv6_inputs(t, 2, t, 2, 16)
    rng = np.random.default_rng(t + 1)
    w = (rng.random(w.shape) ** 3).astype(np.float32)
    w[w < 1e-4] = 0.0
    assert (w == 0).any()
    args = (r, k, v, w, u, st)
    y, s = twr.wkv6_chunked_ref(*_t(args))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    jy, js = jwr.wkv6_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("b,t,h,p,n", [(3, 1, 2, 8, 8), (2, 64, 2, 16, 8),
                                       (2, 65, 2, 16, 8),
                                       (1, 130, 3, 8, 16)])
def test_ssd_chunked_plain_matches_jax_ref_and_pallas(b, t, h, p, n):
    args = ssd_inputs(t * 3 + n, b, t, h, p, n)
    y, s = tsr.ssd_chunked_ref(*_t(args))
    assert y.shape == (b, t, h, p) and s.shape == (b, h, p, n)
    jy, js = jsr.ssd_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    ky, ks = jsk.ssd_pallas(*map(jnp.asarray, args), chunk=64,
                            interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(ky), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(ks), **TOL)


@pytest.mark.parametrize("fn,args", [
    (twr.wkv6_chunked_ref, lambda: _t(wkv6_inputs(4, 2, 100, 2, 8))),
    (tsr.ssd_chunked_ref, lambda: _t(ssd_inputs(4, 2, 100, 2, 8, 8))),
])
def test_chunked_plain_carries_state_mid_chunk(fn, args):
    """Two calls split mid-chunk (at 37 of 100) equal one call; the
    second call started from a zeroed state does not."""
    a = args()
    seq = lambda lo, hi: [z[:, lo:hi] if z.dim() > 2 and z.shape[1] == 100
                          else z for z in a[:-1]]
    y, s = fn(*a)
    y1, s1 = fn(*seq(0, 37), a[-1])
    y2, s2 = fn(*seq(37, 100), s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(s2, s, atol=1e-5, rtol=1e-5)
    y0, _ = fn(*seq(37, 100), torch.zeros_like(s1))
    assert float((y0 - y[:, 37:]).abs().max()) > 1e-3


def test_chunked_route_takes_bf16_sequences():
    """The wrappers' dispatch: bf16 with T >= CHUNKED_MIN_T (and widths a
    multiple of 8) to the chunked kernels; float32, single steps and
    other widths to the sequential ones."""
    bf = torch.bfloat16
    for t, dt, n, want in ((2, bf, 64, True), (384, bf, 64, True),
                           (1, bf, 64, False), (384, torch.float32, 64,
                                                False), (40, bf, 12, False)):
        r = torch.zeros(2, t, 3, n, dtype=dt)
        assert two.chunked_route(r) == (want and t >= two.CHUNKED_MIN_T)
        buf = torch.zeros(2, t, 3 * n + 2 * n, dtype=dt)
        x = buf[..., :3 * n].reshape(2, t, 3, n)
        got = tso.chunked_route(x, buf[..., 3 * n:4 * n], buf[..., 4 * n:])
        assert got == (want and t >= tso.CHUNKED_MIN_T)
