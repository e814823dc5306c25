"""Port parity of 3 ``make_train_step`` steps (AdamW + cosine, clip 1.0)
on the deepseek-v2-lite and grok-1 smoke configs against the JAX
package's, from the JAX ``init`` weights and optimizer state carried
across by ``convert``: losses, aux losses, learning rates and grad norms
every step, the parameters and Adam's first moment after the last, at the
tolerances of ``test_torch_train_moe.py``.  Cases: each arch's default
dispatch (deepseek with ``remat`` on the port's side), deepseek with
slots dropped (``moe_capacity=0.25``) and grok with ``moe_impl="ragged"``.
A file of its own so that each file's JAX compiles stay inside a minute
on one worker.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_moe import (GN_RTOL, LOSS_RTOL, LR,  # noqa: E402
                                  N_STEPS, _batch, _hold, _jax_step, _start,
                                  cfgs)
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedules import cosine  # noqa: E402


@pytest.mark.parametrize("arch, variant, remat", [
    ("deepseek-v2-lite-16b", "default", True),
    ("grok-1-314b", "default", False),
    ("deepseek-v2-lite-16b", "drop", False),
    ("grok-1-314b", "ragged", False)])
def test_train_steps_match_jax(arch, variant, remat):
    tcfg = cfgs(arch, variant)[1].replace(remat=remat)
    (jp, jo), (tp, to) = _start(arch)
    tstep = tsteps.make_train_step(tcfg, adamw(),
                                   cosine(LR, warmup=1, total=10))
    jstep = _jax_step(arch, variant)
    for s in range(N_STEPS):
        batch = _batch(arch, s)
        tp, to, m = tstep(tp, to, batch)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        for k, rtol in (("loss", LOSS_RTOL), ("aux_loss", LOSS_RTOL),
                        ("lr", LOSS_RTOL), ("grad_norm", GN_RTOL)):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"{arch} step {s} {k}")
    assert int(to["step"]) == int(jo["step"]) == N_STEPS
    _hold(tp, jp, f"{arch} {variant} parameters")
    _hold(to["m"], jo["m"], f"{arch} {variant} Adam m")
