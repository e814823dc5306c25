"""On the card: the recurrent kernels (K5 WKV6, K6 SSD) against their plain
versions, and the serving engine on the card against the CPU.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs on a machine that has none:
``python -m pytest -q -m cuda --noconftest tests/test_torch_card_recurrent.py``.
Weights are the port's own random ``init``.  Tolerances: float32 1e-5
(the kernel sums each output's N terms in another order than the plain
version's einsum; the state update is elementwise and rounds alike);
bfloat16 outputs per element, 1e-5 plus 2^-7 of |value| against the plain
version's bf16 output and 2^-8 against the plain version run in float32 on
the same inputs (both compute in float32 and round to bf16 once); the
float32 states within 1e-5.  bf16 sequences (T >= CHUNKED_MIN_T) take
the chunked tensor-core kernels, whose sums run in another order over N
+ 64 + 1 terms: their absolute allowance adds that many float32 ulps of
the largest output (as ``chip_smoke.py``'s ``rec_check``), and their states
are held to the plain version in float32 within 1e-5 + 1e-5 |value|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as two  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as tso  # noqa: E402
from repro_torch.models.base import get_family  # noqa: E402
from repro_torch.serving import (EngineConfig, MCTSDecodeConfig,  # noqa: E402
                                 Request, ServingEngine)

F32_TOL = 1e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda", 0)


def _hold(got, plain, low: bool, n_terms: int = 0):
    """``got`` against ``plain(cast)``: the plain version on the kernel's
    inputs passed through ``cast`` (see the module docstring);
    ``n_terms`` the chunked route's count of summed terms."""
    want = plain(lambda x: x)
    want32 = plain(lambda x: x.float())
    atol = F32_TOL + n_terms * 2.0 ** -24 * float(want32[0].abs().max())
    for g, w, w32 in zip(got, want, want32):
        if g.dtype == torch.float32 and not low:
            torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
            continue
        if g.dtype == torch.float32:            # the state under bf16 inputs
            torch.testing.assert_close(g, w32, atol=F32_TOL, rtol=F32_TOL)
            continue
        torch.testing.assert_close(g.float(), w.float(), atol=atol,
                                   rtol=2.0 ** -7)
        torch.testing.assert_close(g.float(), w32.float(), atol=atol,
                                   rtol=2.0 ** -8)


def _rand(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,n", [(2, 37, 3, 8), (1, 100, 2, 64),
                                     (3, 1, 4, 64), (2, 20, 2, 24)])
def test_wkv6_kernel_matches_plain_on_card(dtype, b, t, h, n):
    dev = _card()
    rng = np.random.default_rng(t * 10 + n)
    r, k, v = (_rand(rng, b, t, h, n).mul(0.5).to(dev) for _ in range(3))
    w = torch.sigmoid(_rand(rng, b, t, h, n)).mul(0.2).add(0.8).to(dev)
    u = _rand(rng, h, n).mul(0.3).to(dev)
    st = _rand(rng, b, h, n, n).mul(0.1).to(dev)
    before = two.launches["wkv6"]
    got = two.wkv6(r.to(dtype), k.to(dtype), v.to(dtype), w, u.to(dtype),
                   st)
    torch.cuda.synchronize()
    assert two.launches["wkv6"] == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    chunked = two.chunked_route(r.to(dtype))
    _hold(got, lambda c: two.wkv6(c(r.to(dtype)), c(k.to(dtype)),
                                  c(v.to(dtype)), w, c(u.to(dtype)), st,
                                  impl="ref"), dtype != torch.float32,
          n + two.CHUNK + 1 if chunked else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,h,p,n", [(2, 37, 3, 8, 8), (1, 70, 2, 64, 64),
                                       (4, 1, 3, 16, 32), (2, 19, 2, 24, 40)])
def test_ssd_kernel_matches_plain_on_card(dtype, b, t, h, p, n):
    """x, Bm and Cm are slices of one packed buffer, as the model hands
    them in (read through their strides)."""
    dev = _card()
    rng = np.random.default_rng(t * 10 + n)
    buf = _rand(rng, b, t, h * p + 2 * n).mul(0.5).to(dev).to(dtype)
    x = buf[..., :h * p].reshape(b, t, h, p)
    bm, cm = buf[..., h * p: h * p + n], buf[..., h * p + n:]
    dt = torch.nn.functional.softplus(_rand(rng, b, t, h)).to(dev)
    a = -torch.exp(_rand(rng, h) * 0.3).to(dev)
    d = torch.full((h,), 0.5, device=dev)
    st = _rand(rng, b, h, p, n).mul(0.1).to(dev)
    before = tso.launches["ssd"]
    got = tso.ssd(x, dt, a, bm, cm, d, st)
    torch.cuda.synchronize()
    assert tso.launches["ssd"] == before + 1
    chunked = tso.chunked_route(x, bm, cm)
    _hold(got, lambda c: tso.ssd(c(x), dt, a, c(bm), c(cm), d, st,
                                 impl="ref"), dtype != torch.float32,
          n + tso.CHUNK + 1 if chunked else 0)


def _wkv6_args(dev, b, t, h, n, decays, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (_rand(rng, b, t, h, n).mul(0.5).to(dev).bfloat16()
               for _ in range(3))
    if decays == "model":          # exp(-exp(w_raw)), w_raw near -6
        w = torch.exp(-torch.exp(_rand(rng, b, t, h, n) * 0.5 - 6.0))
    else:                          # strong, down to exactly 0
        w = torch.from_numpy(rng.random((b, t, h, n)).astype(np.float32))
        w = torch.where(w < 0.05, torch.zeros(()), w ** 2)
    return (r, k, v, w.to(dev), _rand(rng, h, n).mul(0.3).to(dev).bfloat16(),
            _rand(rng, b, h, n, n).mul(0.1).to(dev))


def _ssd_args(dev, b, t, h, p, n, seed):
    rng = np.random.default_rng(seed)
    buf = _rand(rng, b, t, h * p + 2 * n).mul(0.5).to(dev).bfloat16()
    return (buf[..., :h * p].reshape(b, t, h, p),
            torch.nn.functional.softplus(_rand(rng, b, t, h) - 1.0).to(dev),
            -torch.exp(_rand(rng, h) * 0.3).to(dev),
            buf[..., h * p: h * p + n], buf[..., h * p + n:],
            torch.ones(h, device=dev), _rand(rng, b, h, p, n).mul(0.1).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("decays", ["model", "strong"])
@pytest.mark.parametrize("t", [1, 2, 40, 65, 130])
def test_wkv6_chunked_route_matches_plain_on_card(t, decays):
    """bf16 at rwkv6's head width: T >= CHUNKED_MIN_T launches the chunked
    kernel (T = 1 the sequential one), held to the sequential plain
    version, with decays like the model's and down to 0."""
    dev = _card()
    args = _wkv6_args(dev, 2, t, 3, 64, decays, t)
    before = dict(two.launches)
    got = two.wkv6(*args)
    torch.cuda.synchronize()
    chunked = t >= two.CHUNKED_MIN_T
    assert two.launches["wkv6"] == before["wkv6"] + 1
    assert two.launches["wkv6_chunked"] == before["wkv6_chunked"] + chunked
    r, k, v, w, u, st = args
    _hold(got, lambda c: two.wkv6(c(r), c(k), c(v), w, c(u), st,
                                  impl="ref"), True,
          64 + two.CHUNK + 1 if chunked else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 40, 65, 130])
def test_ssd_chunked_route_matches_plain_on_card(t):
    """bf16 at zamba2's head shape (64 x 64), x / B / C strided slices:
    T >= CHUNKED_MIN_T launches the chunked kernel, held to the sequential
    plain version."""
    dev = _card()
    args = _ssd_args(dev, 2, t, 3, 64, 64, t)
    before = dict(tso.launches)
    got = tso.ssd(*args)
    torch.cuda.synchronize()
    chunked = t >= tso.CHUNKED_MIN_T
    assert tso.launches["ssd"] == before["ssd"] + 1
    assert tso.launches["ssd_chunked"] == before["ssd_chunked"] + chunked
    x, dt, a, bm, cm, d, st = args
    _hold(got, lambda c: tso.ssd(c(x), dt, a, c(bm), c(cm), d, st,
                                 impl="ref"), True,
          64 + tso.CHUNK + 1 if chunked else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_chunked_route_carries_state_mid_chunk(scan):
    """Two calls split mid-chunk (100 = 64 + 36 steps, then 66) equal one
    call of 166 within the chunked route's limits."""
    dev = _card()
    if scan == "wkv6":
        args, fn = _wkv6_args(dev, 2, 166, 2, 64, "model", 7), two.wkv6
        seqd = (0, 1, 2, 3)
    else:
        args, fn = _ssd_args(dev, 2, 166, 2, 64, 64, 7), tso.ssd
        seqd = (0, 1, 3, 4)
    part = lambda lo, hi, st: [z[:, lo:hi] if i in seqd else z
                               for i, z in enumerate(args[:-1])] + [st]
    y1, s1 = fn(*part(0, 100, args[-1]))
    y2, s2 = fn(*part(100, 166, s1))
    torch.cuda.synchronize()
    _hold((torch.cat([y1, y2], 1), s2),
          lambda c: fn(*[c(z) if z.dtype == torch.bfloat16 else z
                         for z in args], impl="ref"), True,
          64 + two.CHUNK + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["wkv6", "ssd"])
def test_chunked_kernels_leave_their_flags_at_zero(scan):
    """The chunked kernels reset their flags and ticket counter, so the
    wrappers' kept workspace is all zeros after each call, and a call
    repeated after a call of another shape gives the same result."""
    from repro_torch.kernels import scan_chunks
    dev = _card()
    if scan == "wkv6":
        mk = lambda t, seed: _wkv6_args(dev, 2, t, 3, 64, "model", seed)
        fn = two.wkv6
    else:
        mk = lambda t, seed: _ssd_args(dev, 2, t, 3, 64, 64, seed)
        fn = tso.ssd
    stream = torch.cuda.current_stream(dev).cuda_stream
    first = mk(166, 3)
    runs = [fn(*first), fn(*mk(384, 4)), fn(*first)]
    torch.cuda.synchronize()
    flags = scan_chunks.workspace(dev, stream, 0, 0)[1]
    assert int(flags.abs().sum()) == 0
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "mcts"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b"])
def test_engine_on_card_equals_cpu(arch, mode):
    """The engine through the recurrent kernels (and, for zamba2, the
    attention kernels) emits the CPU's tokens: three ragged requests over
    two slots, float32 smoke config."""
    dev = _card()
    cfg = get_smoke_config(arch)
    params = get_family(cfg).init(cfg, seed=0, device="cpu")
    dcfg = MCTSDecodeConfig(num_actions=3, budget=8, lanes=2,
                            search_depth=2, rollout_len=2)
    streams = []
    for device in (dev, "cpu"):
        eng = ServingEngine(cfg, params, EngineConfig(
            max_batch=2, max_seq=24, decode=mode, mcts=dcfg), device=device)
        for uid, plen in enumerate((5, 2, 9)):
            eng.submit(Request(uid=uid, prompt=np.arange(
                1, plen + 1, dtype=np.int32) * 11 % cfg.vocab_size,
                max_new_tokens=3))
        before = dict(two.launches, **tso.launches)
        eng.run_until_drained()
        after = dict(two.launches, **tso.launches)
        key = "wkv6" if arch.startswith("rwkv6") else "ssd"
        assert (after[key] > before[key]) == (device == dev)
        streams.append({s.uid: s.out_tokens for s in eng.slots if s})
    assert streams[0] == streams[1]
