"""Port parity of the optimizers, schedules and data pipeline on the CPU —
the twins of ``tests/test_substrate.py``'s optimizer, schedule and
prefetcher tests, held against the JAX package's ``repro.optim`` and
``repro.data``.

Tolerances: the optimizers' parameters and states over 20 steps on
float32 and bfloat16 leaves, 1e-6 relative plus 1e-7 absolute in float32
(the same elementwise arithmetic, in the same order; the bias corrections
``b ** step`` may round one ulp apart between the two libraries' ``pow``)
and one bf16 ulp (2^-7 relative) for bf16 leaves; the schedules 1e-6
relative; the global norm 1e-6 relative.  Batches, integer step counters
and the prefetched order are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.data import Prefetcher as JPrefetcher  # noqa: E402
from repro.data import make_batch_iterator as jiter  # noqa: E402
from repro.data import synthetic_batch as jbatch  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.data import (DataConfig, Prefetcher,  # noqa: E402
                              make_batch_iterator, synthetic_batch)
from repro_torch.optim import schedules  # noqa: E402

F32 = dict(rtol=1e-6, atol=1e-7)
BF16 = dict(rtol=2.0 ** -7, atol=1e-7)


def _params(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blk": {"b": rng.standard_normal(5).astype(np.float32),
                    "h": rng.standard_normal((3, 4)).astype(np.float32)}}


def _grads(rng, like):
    return jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, like)


def _close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(convert.tree_to_numpy(got)),
                    jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        tol = BF16 if w.dtype.name == "bfloat16" else F32
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   w.astype(np.float32), **tol)


@pytest.mark.parametrize("name", ["adamw", "lion", "sgd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_matches_jax_over_20_steps(name, dtype):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), p0)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jo_, to_ = getattr(jopt, name)(), getattr(optim, name)()
    js, ts = jo_.init(jp), to_.init(tp)
    jupd = jax.jit(jo_.update)
    for step in range(20):
        g = _grads(rng, p0)
        jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), g)
        tg = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jg))
        lr = 0.05 * (1 + step % 3)
        ju, js = jupd(jg, js, jp, jnp.float32(lr))
        tu, ts = to_.update(tg, ts, tp, torch.tensor(lr))
        jp = jopt.apply_updates(jp, ju)
        tp = optim.apply_updates(tp, tu)
        assert int(ts["step"]) == int(js["step"]) == step + 1
    _close(tp, jp)
    _close({k: v for k, v in ts.items() if k != "step"},
           {k: v for k, v in js.items() if k != "step"})
    assert ts["step"].dtype == torch.int32


@pytest.mark.parametrize("make_opt", ["adamw", "lion", "sgd"])
def test_optimizer_descends_quadratic(make_opt):
    opt = getattr(optim, make_opt)()
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        upd, state = opt.update(g, state, params, torch.tensor(0.05))
        params = optim.apply_updates(params, upd)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    g = _params(rng)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    jg["blk"]["h"] = jg["blk"]["h"].astype(jnp.bfloat16)
    tg = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jg))
    jout, jn = jopt.clip_by_global_norm(jg, max_norm)
    tout, tn = optim.clip_by_global_norm(tg, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    assert tout["blk"]["h"].dtype == torch.bfloat16
    _close(tout, jout)


@pytest.mark.parametrize("sched", [
    ("constant", (3e-4,), {}),
    ("cosine", (1e-3, 10, 100), {}),
    ("cosine", (1.0, 0, 7), {"final_frac": 0.2}),
    ("wsd", (1.0, 10, 20, 10), {}),
    ("wsd", (2e-3, 3, 5, 7), {"final_frac": 0.05}),
])
def test_schedules_match_jax(sched):
    name, args, kw = sched
    jf, tf = getattr(jsched, name)(*args, **kw), \
        getattr(schedules, name)(*args, **kw)
    for s in range(0, 120, 1):
        want = float(jf(jnp.asarray(s, jnp.int32)))
        got = tf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12,
                                   err_msg=f"step {s}")


def test_wsd_schedule_phases():
    f = schedules.wsd(1.0, warmup=10, stable=20, decay=10)
    t = lambda s: float(f(torch.tensor(s)))  # noqa: E731
    assert t(0) == 0.0
    assert abs(t(10) - 1.0) < 1e-6
    assert abs(t(25) - 1.0) < 1e-6
    assert t(40) <= 0.02


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-2b",
                                  "whisper-base"])
@pytest.mark.parametrize("pack", [True, False])
def test_synthetic_batch_bit_equal(arch, pack):
    kw = dict(seed=3, batch_size=2, seq_len=40, pack_documents=pack,
              mean_doc_len=8, n_hosts=2, host_id=1)
    tcfg, jcfg = tget(arch), jget(arch)
    if arch == "internvl2-2b":
        assert tcfg.n_patches < 40
    for step in (0, 5):
        got = synthetic_batch(tcfg, DataConfig(**kw), step)
        want = jbatch(jcfg, JData(**kw), step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it, jit_ = make_batch_iterator(tcfg, DataConfig(**kw), 4), \
        jiter(jcfg, JData(**kw), 4)
    for _ in range(3):
        a, b = next(it), next(jit_)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_order():
    it = Prefetcher(iter(range(10)), depth=3)
    assert list(it) == list(range(10))
    assert list(Prefetcher(iter(range(7)), depth=1)) == \
        list(JPrefetcher(iter(range(7)), depth=1))


def test_prefetcher_feeds_batches_and_closes():
    cfg = tget("smollm-135m")
    dcfg = DataConfig(batch_size=2, seq_len=16)
    pf = Prefetcher(make_batch_iterator(cfg, dcfg, 2), depth=2)
    for step in (2, 3, 4):
        np.testing.assert_array_equal(next(pf)["tokens"],
                                      synthetic_batch(cfg, dcfg, step)
                                      ["tokens"])
    pf.close()
