"""Port parity of training the rwkv6, zamba2, VLM and Whisper families on
the CPU: each family's ``loss_fn`` and its gradient (here) and 3
``make_train_step`` steps (AdamW + cosine, clip 1.0;
``test_torch_train_families_steps.py``), at the smoke configs
of rwkv6-1.6b, zamba2-1.2b, internvl2-2b and whisper-base, against the JAX
package's, from the JAX ``init`` weights and optimizer state carried
across by ``convert``, on the same synthetic batches.

The port's recurrent scans run their autograd Functions (the plain
versions ``wkv6_fwd_ref`` / ``wkv6_bwd_ref``, ``ssd_fwd_ref`` /
``ssd_bwd_ref`` on the CPU) and attention its blocked flash path; the JAX
side differentiates its chunked jnp scans and ``sdpa``.  Float32 on both
sides, the same sums in other orders, so the tolerances are those of
``tests/test_torch_train_step.py``: losses and learning rates 1e-5
relative, grad norms 1e-4 relative, every gradient leaf and, after 3
steps, every parameter and Adam's first moment within 2e-5 absolute plus
1e-4 relative.  One leaf kind is left out of the parameters after the
steps: the attention key biases ``bk`` (whisper).  Their gradient is
zero in exact arithmetic (the same bias on every key shifts a softmax
row by a constant), so each side computes rounding noise there, which
Adam divides by its own square root into steps of the learning rate's
size; those leaves are held through their gradient (within the absolute
tolerance, in the loss-and-gradient cases) and their Adam first moment.
Each loss-and-gradient case also runs with ``remat`` on
the port's side (``torch.utils.checkpoint`` per block).  The rwkv6 cases
print the most negative cumulative log-decay that the model's draw puts
in a 32-step chunk and assert that it is above the JAX chunked scan's
clamp (``LOG_CLAMP``, -30): the reference is exact there.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.kernels.rwkv6_scan import ops as jwops  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.base import get_family as jfamily  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedules import cosine as jcosine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as twops  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models.base import get_family as tfamily  # noqa: E402
from torch_parity import jax_init  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = ("rwkv6-1.6b", "zamba2-1.2b", "internvl2-2b", "whisper-base")
LR = 1e-3
N_STEPS = 3
SEQ = 24
LOSS_RTOL, GN_RTOL = 1e-5, 1e-4
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


SHIFT_INVARIANT = ("bk",)     # leaves whose exact gradient is zero


def _hold(got, want, what, skip=()):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        if path[-1] in skip:
            continue
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"{what} {path}", **PARAM_TOL)


@functools.lru_cache(maxsize=None)
def _jax_fns(arch):
    cfg = jget(arch)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: jfamily(cfg).loss_fn(cfg, p, b)[0]))
    step = jax.jit(jsteps.make_train_step(cfg, jadamw(),
                                          jcosine(LR, warmup=1, total=10)))
    return grad, step


def _start(arch):
    jcfg = jget(arch)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_init(jcfg))
    jo = jadamw().init(jp)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    to = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jo))
    return (jp, jo), (tp, to)


def _batch(arch, step):
    return synthetic_batch(tget(arch), DataConfig(seed=0, batch_size=2,
                                                   seq_len=SEQ), step)


@pytest.fixture
def decay_probe(monkeypatch):
    """Records the most negative 32-step cumulative log-decay of every
    ``wkv6`` call's w."""
    low = []
    real = twops.wkv6

    def probe(r, k, v, w, u, state, **kw):
        lw = torch.log(torch.clamp(w.detach().double(), min=1e-38))
        t = lw.shape[1]
        lw = torch.nn.functional.pad(lw, (0, 0, 0, 0, 0, (-t) % 32))
        low.append(float(lw.reshape(lw.shape[0], -1, 32, *lw.shape[2:])
                         .sum(2).min()))
        return real(r, k, v, w, u, state, **kw)
    monkeypatch.setattr(twops, "wkv6", probe)
    return low


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, remat, decay_probe):
    tcfg = dataclasses.replace(tget(arch), remat=remat)
    (jp, _), (tp, _) = _start(arch)
    batch = _batch(arch, 0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, aux), grads = tsteps.value_and_grad(
        lambda p: tfamily(tcfg).loss_fn(tcfg, p, tb), tp)
    jloss, jgrads = _jax_fns(arch)[0](
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    assert float(aux["loss"]) == float(loss)
    _hold(grads, jgrads, f"{arch} gradient")
    if arch.startswith("rwkv6"):
        print(f"most negative 32-step cumulative log-decay: "
              f"{min(decay_probe):.4f} (LOG_CLAMP {jwops.LOG_CLAMP})")
        # remat runs each block's forward again in the backward
        assert len(decay_probe) == tcfg.n_layers * (2 if remat else 1)
        assert min(decay_probe) > jwops.LOG_CLAMP


def test_vlm_loss_masks_the_image_positions():
    """Labels at the image positions do not move the VLM's loss, and the
    projector gets a gradient."""
    arch = "internvl2-2b"
    tcfg = tget(arch)
    _, (tp, _) = _start(arch)
    batch = {k: torch.as_tensor(v) for k, v in _batch(arch, 0).items()}
    other = dict(batch, labels=batch["labels"].clone())
    other["labels"][:, :tcfg.n_patches] = 7
    fam = tfamily(tcfg)
    with torch.no_grad():
        a = fam.loss_fn(tcfg, tp, batch)[0]
        b = fam.loss_fn(tcfg, tp, other)[0]
    assert float(a) == float(b)
    (_, _), grads = tsteps.value_and_grad(
        lambda p: fam.loss_fn(tcfg, p, batch), tp)
    assert all(float(g.abs().max()) > 0
               for _, g in _leaves(grads["projector"]) if g.dim() == 2)
