"""Port parity of the training step on the CPU: ``make_train_step`` and
``make_grad_accum_train_step`` on the four dense smoke configs (smollm,
qwen2, minicpm with WSD, stablelm) against the JAX package's, with the
weights and the optimizer state carried across by ``convert``; and the
fault-tolerant ``TrainerLoop`` restart on the real step (the twin of
``tests/test_substrate.py``'s).

Both sides train from the same JAX ``init`` weights on the same synthetic
batches (the port's copy of the pipeline, held bit-equal here too); the
JAX step is ``jax.jit``ted with the config static.  The JAX smoke configs
take ``sdpa`` for attention and the port its blocked flash path, the same
softmax summed in other orders, so the float32 numbers agree to rounding:
losses and learning rates 1e-5 relative, grad norms 1e-4 relative, and
the parameters and Adam's first moments after 3 steps within 2e-5
absolute plus 1e-4 relative.  The optimizer's integer step counter is
equal.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.data import DataConfig as JData  # noqa: E402
from repro.data import synthetic_batch as jbatch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.base import get_family as jfamily  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedules import cosine as jcosine  # noqa: E402
from repro.optim.schedules import wsd as jwsd  # noqa: E402
from repro.runtime import ft as jft  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.data import DataConfig, make_batch_iterator  # noqa: E402
from repro_torch.data import synthetic_batch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedules import cosine, wsd  # noqa: E402
from repro_torch.runtime import ft as tft  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = ("smollm-135m", "qwen2-0.5b", "minicpm-2b", "stablelm-3b")
LR = 1e-3
N_STEPS = 3
LOSS_RTOL, GN_RTOL = 1e-5, 1e-4
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)


def _schedules(arch):
    if arch.startswith("minicpm"):
        return (wsd(LR, warmup=1, stable=1, decay=2),
                jwsd(LR, warmup=1, stable=1, decay=2))
    return cosine(LR, warmup=1, total=10), jcosine(LR, warmup=1, total=10)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def _jax_step(arch, n_micro):
    cfg = jget(arch)
    sched = _schedules(arch)[1]
    if n_micro:
        fn = jsteps.make_grad_accum_train_step(cfg, jadamw(), sched, n_micro)
    else:
        fn = jsteps.make_train_step(cfg, jadamw(), sched)
    return jax.jit(fn)


def _start(arch):
    """JAX and port (params, opt_state) from the JAX ``init``."""
    jcfg = jget(arch)
    jp = jfamily(jcfg).init(jcfg, jax.random.key(0))
    jo = jadamw().init(jp)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    to = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jo))
    return (jp, jo), (tp, to)


def _hold(got, want):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   err_msg=str(path), **PARAM_TOL)


def _run(arch, n_micro=0):
    tcfg = tget(arch)
    (jp, jo), (tp, to) = _start(arch)
    sched = _schedules(arch)[0]
    tstep = (tsteps.make_grad_accum_train_step(tcfg, adamw(), sched, n_micro)
             if n_micro else tsteps.make_train_step(tcfg, adamw(), sched))
    jstep = _jax_step(arch, n_micro)
    dcfg = DataConfig(seed=0, batch_size=2 * max(n_micro, 1), seq_len=24)
    for s in range(N_STEPS):
        batch = synthetic_batch(tcfg, dcfg, s)
        jb = jbatch(jget(arch), JData(seed=0, batch_size=dcfg.batch_size,
                                      seq_len=24), s)
        for k in jb:
            np.testing.assert_array_equal(batch[k], jb[k])
        if n_micro:
            batch = {k: v.reshape((n_micro, -1) + v.shape[1:])
                     for k, v in batch.items()}
        tp, to, m = tstep(tp, to, batch)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        for k, rtol in (("loss", LOSS_RTOL), ("lr", LOSS_RTOL),
                        ("grad_norm", GN_RTOL)):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"{arch} step {s} {k}")
    assert int(to["step"]) == int(jo["step"]) == N_STEPS
    _hold(tp, jp)
    _hold(to["m"], jo["m"])
    return tp, to


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    _run(arch)


@pytest.mark.parametrize("arch", ("smollm-135m", "qwen2-0.5b"))
def test_grad_accum_step_matches_jax(arch):
    _run(arch, n_micro=2)


def test_train_step_leaves_its_inputs():
    tcfg = tget("smollm-135m")
    _, (tp, to) = _start("smollm-135m")
    before = [t.clone() for _, t in _leaves(tp)] + \
        [t.clone() for _, t in _leaves(to["m"])]
    step = tsteps.make_train_step(tcfg, adamw(), cosine(LR, 1, 10))
    batch = synthetic_batch(tcfg, DataConfig(batch_size=2, seq_len=16), 0)
    step(tp, to, batch)
    step(tp, to, batch)
    after = [t for _, t in _leaves(tp)] + [t for _, t in _leaves(to["m"])]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(to["step"]) == 0


def _loops(tmp_path, arch="smollm-135m", **ft_kw):
    """(port factory, JAX factory) of loops training the smoke model from
    the JAX ``init``; the fault is transient (only the first build)."""
    tcfg, jcfg = tget(arch), jget(arch)
    (jp, jo), (tp, to) = _start(arch)
    tstep = tsteps.make_train_step(tcfg, adamw(), cosine(LR, 2, 50))
    jstep = jax.jit(jsteps.make_train_step(jcfg, jadamw(),
                                           jcosine(LR, 2, 50)))

    def make(mod, step, init, data_iter, sub):
        built = []

        def factory():
            if built:                     # the crashed loop's save commits
                built[-1].ckpt.wait()
            kw = dict(ft_kw)
            if built:
                kw.pop("fail_at_step", None)
            ft = mod.FTConfig(ckpt_dir=str(tmp_path / sub), ckpt_every=5,
                              **kw)
            loop = mod.TrainerLoop(step, *init, data_iter, ft)
            built.append(loop)
            return loop
        return factory

    from repro.data import make_batch_iterator as jiter
    port = make(tft, tstep, (tp, to), lambda s: make_batch_iterator(
        tcfg, DataConfig(batch_size=2, seq_len=16), s), "port")
    jaxf = make(jft, jstep, (jp, jo), lambda s: jiter(
        jcfg, JData(batch_size=2, seq_len=16), s), "jax")
    return port, jaxf


def test_trainer_loop_restart_on_the_real_step(tmp_path):
    port, jaxf = _loops(tmp_path, fail_at_step=12)
    out = tft.train_with_restarts(port, n_steps=20, max_restarts=2)
    jout = jft.run_with_restarts(jaxf, n_steps=20, max_restarts=2)
    assert out["step"] == jout["step"] == 20
    assert out["restarts"] == jout["restarts"] == 1
    # both rebuilt loops resumed from the save of step 10
    assert len(out["losses"]) == len(jout["losses"]) == 10
    np.testing.assert_allclose(out["losses"], jout["losses"], rtol=1e-4)
    # an uninterrupted run repeats the resumed losses bit for bit
    ref, _ = _loops(tmp_path / "ref")
    full = ref().run(20)
    assert full["losses"][10:] == out["losses"]
