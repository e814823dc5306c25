"""Port parity of training the MoE family on the CPU: ``moe.loss_fn`` and
its gradient (here) and 3 ``make_train_step`` steps (AdamW + cosine, clip
1.0; ``test_torch_train_moe_steps.py``), at the smoke configs of
deepseek-v2-lite-16b (MLA, a leading dense layer, shared experts) and
grok-1-314b (soft-capped GQA), against the JAX package's ``loss_fn`` /
``make_train_step``, from the JAX ``init`` weights and optimizer state
carried across by ``convert``, on the same synthetic batches.

Variants: the default grouped dispatch, ``moe_capacity=0.25`` (slots
drop: their gradient is zero on both sides) and ``moe_impl="ragged"``
(the JAX ``lax.ragged_dot``); each loss-and-gradient case also runs with
``remat`` on the port's side (``torch.utils.checkpoint`` per MoE block).
The routing decisions (``topi``) of step 0 must be equal at every MoE
layer: the JAX side's are read from an unscanned copy of its forward
(``_jax_routes``).  Float32 on both sides, the same sums in other orders,
so the tolerances are those of ``tests/test_torch_train_step.py``: losses,
aux losses and learning rates 1e-5 relative, grad norms 1e-4 relative,
every gradient leaf and, after 3 steps, every parameter and Adam's first
moment within 2e-5 absolute plus 1e-4 relative.  ``test_dispatch_
gradients_match_jax`` holds the gradient of one ``moe_ffn`` (output and
aux loss) to ``jax.grad``'s and checks that a token whose every slot
dropped gets an exactly zero gradient through the experts.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.schedules import cosine as jcosine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config as tget  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")
VARIANTS = {"default": (), "drop": (("moe_capacity", 0.25),),
            "ragged": (("moe_impl", "ragged"),)}
LR = 1e-3
N_STEPS = 3
SEQ = 24
LOSS_RTOL, GN_RTOL = 1e-5, 1e-4
PARAM_TOL = dict(atol=2e-5, rtol=1e-4)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, path + (i,))
    else:
        yield path, tree


def _hold(got, want, what):
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want)))
    for (path, g), (wpath, w) in pairs:
        assert path == wpath, (path, wpath)
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32),
                                   err_msg=f"{what} {path}", **PARAM_TOL)


def cfgs(arch, variant):
    over = dict(VARIANTS[variant])
    return jget(arch).replace(**over), tget(arch).replace(**over)


@functools.lru_cache(maxsize=None)
def _jax_step(arch, variant):
    cfg = cfgs(arch, variant)[0]
    return jax.jit(jsteps.make_train_step(cfg, jadamw(),
                                          jcosine(LR, warmup=1, total=10)))


@functools.lru_cache(maxsize=None)
def _jax_start(arch):
    jcfg = jget(arch)
    jp = jax.jit(JM.init, static_argnums=0)(jcfg, jax.random.key(0))
    jo = jadamw().init(jp)
    return jp, jo


def _start(arch):
    """(JAX params, JAX Adam state), (the port's copies)."""
    jp, jo = _jax_start(arch)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    to = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jo))
    return (jp, jo), (tp, to)


def _batch(arch, step):
    return synthetic_batch(tget(arch), DataConfig(seed=0, batch_size=2,
                                                   seq_len=SEQ), step)


def _routes(cfg, p, tokens):
    """The JAX forward's top-k choices at each MoE layer, from an
    unscanned copy of ``repro.models.moe.hidden_states`` (its blocks
    called one by one, each MoE block's router read on its normed
    input)."""
    x = JL.embed_tokens(cfg, p["embed"], tokens)
    pos = jnp.arange(x.shape[1])
    for lp in p.get("dense_layers", []):
        x = JM._dense_block_fwd(cfg, lp, x, pos)
    out = []
    for i in range(cfg.n_layers - cfg.first_dense_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], p["layers"])
        h = JL.apply_norm(cfg, lp["ln1"], x)
        h = JL.apply_norm(cfg, lp["ln2"],
                          x + JM._attn_full(cfg, lp["attn"], h, pos))
        gates = JM.router_probs(cfg, lp["moe"], h.reshape(-1, cfg.d_model))
        out.append(jax.lax.top_k(gates, cfg.moe_topk)[1])
        x, _ = JM._moe_block_fwd(cfg, lp, x, pos)
    return out


@functools.lru_cache(maxsize=None)
def _jax_grad(arch, variant):
    """``((loss, aux), grads), routes`` of the JAX ``loss_fn``, one
    compile."""
    cfg = cfgs(arch, variant)[0]
    grad = jax.value_and_grad(lambda p, b: JM.loss_fn(cfg, p, b),
                              has_aux=True)
    return jax.jit(lambda p, b: (grad(p, b), _routes(cfg, p, b["tokens"])))


@pytest.fixture
def routes(monkeypatch):
    """The port's ``topi`` of every ``top_experts`` call, in order."""
    got = []
    real = TM.top_experts

    def probe(cfg, p, x2d):
        out = real(cfg, p, x2d)
        got.append(out[1].detach().clone())
        return out
    monkeypatch.setattr(TM, "top_experts", probe)
    return got


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, variant, remat, routes):
    jcfg, tcfg = cfgs(arch, variant)
    tcfg = tcfg.replace(remat=remat)
    (jp, _), (tp, _) = _start(arch)
    batch = _batch(arch, 0)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, aux), grads = tsteps.value_and_grad(
        lambda p: TM.loss_fn(tcfg, p, tb), tp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ((jloss, jaux), jgrads), want = _jax_grad(arch, variant)(jp, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["aux_loss"]),
                               float(jaux["aux_loss"]), rtol=LOSS_RTOL)
    assert float(aux["aux_loss"]) > 0
    _hold(grads, jgrads, f"{arch} {variant} gradient")
    # routing: the port's choices at each MoE layer equal the JAX
    # forward's (remat recomputes each MoE block in the backward, last
    # block first: its calls come twice)
    n_moe = tcfg.n_layers - tcfg.first_dense_layers
    assert len(routes) == n_moe * (2 if remat else 1)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(routes[i].numpy(), np.asarray(w),
                                      err_msg=f"{arch} MoE layer {i}")
        if remat:
            assert torch.equal(routes[2 * n_moe - 1 - i], routes[i])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_gradients_match_jax(arch, variant):
    """The gradient of ``sum(moe_ffn(x) * r) + aux`` with respect to x and
    the expert and router weights equals ``jax.grad``'s; with slots
    dropped, a token whose every slot dropped gets exactly zero from the
    experts' term (its output is zero and its router gradient too: the
    counts ``f_e`` carry none, the dropped slots' weights get none)."""
    jcfg, tcfg = cfgs(arch, variant)
    (jp, _), (tp, _) = _start(arch)
    jmoe = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    jmoe = {k: v for k, v in jmoe.items() if k != "shared"}
    tmoe = {k: v for k, v in layer_params(tp, 0)["moe"].items()
            if k != "shared"}
    rng = np.random.default_rng(5)
    n = 64
    x = rng.standard_normal((n, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((n, jcfg.d_model)).astype(np.float32)

    def jloss(p, x, with_aux):
        y, aux = JM.moe_ffn(jcfg, p, x)
        return jnp.sum(y * r) + (aux if with_aux else 0.0)

    jg, jdx = jax.jit(lambda p, x: (
        jax.grad(jloss, argnums=(0, 1))(p, x, True),
        jax.grad(jloss, argnums=1)(p, x, False)))(jmoe, jnp.asarray(x))
    live = {k: v.detach().requires_grad_(True) for k, v in tmoe.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_ffn(tcfg, live, tx)
    tg = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                             [tx] + [live[k] for k in sorted(live)])
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[1]),
                               **PARAM_TOL)
    for k, g in zip(sorted(live), tg[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[0][k]),
                                   err_msg=f"{arch} {variant} {k}",
                                   **PARAM_TOL)
    if variant != "drop":
        return
    # tokens with every slot dropped: no gradient through the experts
    _, topi, _ = TM.top_experts(tcfg, tmoe, torch.from_numpy(x))
    _, _, _, keep = TM.dispatch_slots(tcfg, topi)
    gone = ~keep.reshape(n, -1).any(-1)
    assert bool(gone.any()), "no token lost every slot"
    y, _ = TM.moe_ffn(tcfg, live, tx)
    dx = torch.autograd.grad((y * torch.from_numpy(r)).sum(), tx)[0]
    assert bool((dx[gone] == 0).all()) and bool((y[gone] == 0).all())
    assert bool((np.asarray(jdx)[gone.numpy()] == 0).all())
