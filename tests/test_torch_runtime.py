"""Port parity of the fault-tolerant runtime: ``repro_torch.runtime``'s
``TrainerLoop`` / ``train_with_restarts`` (the JAX package's
``run_with_restarts``) / NaN skip / watchdog and the
straggler policy against ``repro.runtime``'s on the CPU — the cases of
``tests/test_substrate.py`` (the elastic reshard of training state comes
with the port of training).

The loop takes any step function, so both packages train one toy model
(least squares on a ``(seed, step)``-deterministic batch stream) with the
same plain-gradient step written in each framework; their loss
histories agree within float32 rounding, and the steps, restarts and
skips are equal.  ``wave_commit_mask`` and ``simulate_throughput`` equal
the JAX package's exactly on the same seeds.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.runtime import ft as jft  # noqa: E402
from repro.runtime import straggler as jstrag  # noqa: E402
from repro_torch.runtime import ft as tft  # noqa: E402
from repro_torch.runtime.ft import (FTConfig, Heartbeat,  # noqa: E402
                                    SimulatedFailure, TrainerLoop,
                                    WatchdogTimeout, train_with_restarts)
from repro_torch.runtime.straggler import (StragglerPolicy,  # noqa: E402
                                           simulate_throughput,
                                           wave_commit_mask)

LR, DIM, ROWS = 0.05, 4, 8
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def batches(start):
    """The batch of step s, for s = start, start + 1, ... (numpy)."""
    s = start
    while True:
        r = np.random.RandomState(1000 + s)
        x = r.standard_normal((ROWS, DIM)).astype(np.float32)
        y = (x @ np.arange(1, DIM + 1, dtype=np.float32)
             + 0.1 * r.standard_normal(ROWS).astype(np.float32))
        yield x, y
        s += 1


def torch_step(params, opt, batch):
    x, y = (torch.from_numpy(b) for b in batch)
    err = x @ params["w"] - y
    grad = 2.0 * (x.T @ err) / ROWS
    return ({"w": params["w"] - LR * grad}, {"step": opt["step"] + 1},
            {"loss": (err * err).mean()})


def jax_step(params, opt, batch):
    x, y = (jnp.asarray(b) for b in batch)
    err = x @ params["w"] - y
    grad = 2.0 * (x.T @ err) / ROWS
    return ({"w": params["w"] - LR * grad}, {"step": opt["step"] + 1},
            {"loss": (err * err).mean()})


def loops(tmp_path, transient=False, **ft_kw):
    """``(port factory, JAX factory)`` of loops over the toy model.  Each
    factory keeps the loops it built (``factory.built``) and, before it
    builds the next, waits for the last one's checkpoint save: a loop that
    "crashed" may have left a save in flight on its thread (step 10, when
    the fault comes at step 12), and the rebuilt loop must find it
    committed, not restore an older step."""
    def make(mod, step, init, sub):
        built = []

        def factory():
            if built:
                built[-1].ckpt.wait()
            kw = dict(ft_kw)
            if transient and built:
                kw.pop("fail_at_step", None)   # a fault that does not recur
            ft = mod.FTConfig(ckpt_dir=str(tmp_path / sub), ckpt_every=5,
                              **kw)
            loop = mod.TrainerLoop(step, *init(), batches, ft)
            built.append(loop)
            return loop
        factory.built = built
        return factory

    port = make(tft, torch_step, lambda: ({"w": torch.zeros(DIM)},
                                     {"step": torch.tensor(0)}), "port")
    jax_ = make(jft, jax_step, lambda: ({"w": jnp.zeros(DIM)},
                                        {"step": jnp.int32(0)}), "jax")
    return port, jax_


def test_ft_restart_resumes_same_stream(tmp_path):
    port, jax_ = loops(tmp_path, transient=True, fail_at_step=12)
    out = train_with_restarts(port, n_steps=20, max_restarts=2)
    jout = jft.run_with_restarts(jax_, n_steps=20, max_restarts=2)
    assert out["step"] == jout["step"] == 20
    assert out["restarts"] == jout["restarts"] == 1
    # both rebuilt loops restored the save of step 10 and ran 10 steps
    for f in (port, jax_):
        assert len(f.built) == 2
        assert f.built[1].step - len(f.built[1].history) == 10
    np.testing.assert_allclose(out["losses"], jout["losses"], **LOSS_TOL)
    ref, _ = loops(tmp_path / "ref")
    full = ref().run(20)
    assert abs(out["losses"][-1] - full["losses"][-1]) < 1e-4
    with pytest.raises(SimulatedFailure):
        loops(tmp_path / "hard", fail_at_step=3)[0]().run(6)


def test_ft_nan_skip(tmp_path):
    port, jax_ = loops(tmp_path, nan_at_step=3)
    out, jout = port().run(6), jax_().run(6)
    assert out["nan_skips"] == jout["nan_skips"] == 1
    assert out["step"] == jout["step"] == 6
    assert all(np.isfinite(l) for l in out["losses"])
    np.testing.assert_allclose(out["losses"], jout["losses"], **LOSS_TOL)


def test_restore_places_state_like_the_template(tmp_path):
    port, _ = loops(tmp_path)
    loop = port()
    loop.run(10)
    again = port()
    assert again.try_restore() and again.step == 10
    assert torch.equal(again.params["w"], loop.params["w"])
    assert int(again.opt_state["step"]) == 10


def test_watchdog_expires_on_a_stall(tmp_path):
    hb = Heartbeat(0.05)
    try:
        hb.beat()
        time.sleep(0.3)
        with pytest.raises(WatchdogTimeout):
            hb.beat()
    finally:
        hb.stop()
    loop = TrainerLoop(torch_step, {"w": torch.zeros(DIM)},
                       {"step": torch.tensor(0)}, batches,
                       FTConfig(ckpt_dir=str(tmp_path), watchdog_s=0.05,
                                stall_at_step=2))
    hb = Heartbeat(0.05)
    try:
        with pytest.raises(WatchdogTimeout):
            loop.run(5, heartbeat=hb)
    finally:
        hb.stop()
    assert loop.step == 3


def test_straggler_commit_mask():
    lat = np.array([1.0, 1.1, 0.9, 25.0])
    keep, t = wave_commit_mask(lat, StragglerPolicy(deadline_factor=3.0))
    assert keep.tolist() == [True, True, True, False]
    assert t == 1.1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_policy_equals_jax(seed):
    r = np.random.default_rng(seed)
    lat = r.lognormal(0.0, 0.5, 16) * np.where(r.random(16) < 0.3, 8, 1)
    for pol, jpol in ((StragglerPolicy(), jstrag.StragglerPolicy()),
                      (StragglerPolicy(deadline_factor=1.2,
                                       min_commit_frac=0.9),
                       jstrag.StragglerPolicy(deadline_factor=1.2,
                                              min_commit_frac=0.9))):
        keep, t = wave_commit_mask(lat, pol)
        jkeep, jt = jstrag.wave_commit_mask(lat, jpol)
        np.testing.assert_array_equal(keep, jkeep)
        assert t == jt
    out = simulate_throughput(StragglerPolicy(), lanes=16, waves=50,
                              seed=seed, tail=0.15)
    assert out == jstrag.simulate_throughput(
        jstrag.StragglerPolicy(), lanes=16, waves=50, seed=seed, tail=0.15)


def test_straggler_speedup_under_heavy_tail():
    out = simulate_throughput(StragglerPolicy(), lanes=16, waves=200,
                              tail=0.15)
    assert out["speedup"] > 1.3
    assert out["drop_rate"] < 0.25
