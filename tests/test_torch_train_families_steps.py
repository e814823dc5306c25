"""Port parity of 3 ``make_train_step`` steps (AdamW + cosine, clip 1.0)
on the rwkv6, zamba2, VLM and Whisper smoke configs against the JAX
package's, from the JAX ``init`` weights and optimizer state carried
across by ``convert``: losses, learning rates and grad norms every step,
the parameters (less the key biases, see ``test_torch_train_families.py``)
and Adam's first moment after the last, at the tolerances stated there.
A file of its own so that each file's JAX compiles stay well inside a
minute on one worker.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_train_families import (ARCHS, GN_RTOL, LOSS_RTOL,  # noqa: E402
                                       LR, N_STEPS, SHIFT_INVARIANT,
                                       _batch, _hold, _jax_fns, _start)
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.schedules import cosine  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    tcfg = tget(arch)
    (jp, jo), (tp, to) = _start(arch)
    tstep = tsteps.make_train_step(tcfg, adamw(),
                                   cosine(LR, warmup=1, total=10))
    jstep = _jax_fns(arch)[1]
    for s in range(N_STEPS):
        batch = _batch(arch, s)
        tp, to, m = tstep(tp, to, batch)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        for k, rtol in (("loss", LOSS_RTOL), ("lr", LOSS_RTOL),
                        ("grad_norm", GN_RTOL)):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                       err_msg=f"{arch} step {s} {k}")
    assert int(to["step"]) == int(jo["step"]) == N_STEPS
    _hold(tp, jp, f"{arch} parameters", skip=SHIFT_INVARIANT)
    _hold(to["m"], jo["m"], f"{arch} Adam m")
