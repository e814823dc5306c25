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
float32 states within 1e-5.
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


def _hold(got, plain, low: bool):
    """``got`` against ``plain(cast)``: the plain version on the kernel's
    inputs passed through ``cast`` (see the module docstring)."""
    want = plain(lambda x: x)
    for g, w, w32 in zip(got, want, plain(lambda x: x.float())):
        if g.dtype == torch.float32 and not low:
            torch.testing.assert_close(g, w, atol=F32_TOL, rtol=F32_TOL)
            continue
        if g.dtype == torch.float32:            # the state under bf16 inputs
            torch.testing.assert_close(g, w32, atol=F32_TOL, rtol=F32_TOL)
            continue
        torch.testing.assert_close(g.float(), w.float(), atol=F32_TOL,
                                   rtol=2.0 ** -7)
        torch.testing.assert_close(g.float(), w32.float(), atol=F32_TOL,
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
    _hold(got, lambda c: two.wkv6(c(r.to(dtype)), c(k.to(dtype)),
                                  c(v.to(dtype)), w, c(u.to(dtype)), st,
                                  impl="ref"), dtype != torch.float32)


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
    _hold(got, lambda c: tso.ssd(c(x), dt, a, c(bm), c(cm), d, st,
                                 impl="ref"), dtype != torch.float32)


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
