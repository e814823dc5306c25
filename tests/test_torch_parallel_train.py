"""Port parity of the sharded train step and of resuming on another mesh,
on a gloo group of four CPU ranks: ``launch.steps.make_train_step(...,
mesh=, shardings=)`` on qwen2-0.5b's smoke config (float32) over a (data
2, model 2) mesh, its state at rest as each rank's slices
(``runtime.elastic.reshard_state``) and gathered back (``gather_state``);
one step with the int8 EF compressor; a run on ranks 0 and 1 (a data
axis of 2) whose gathered state rank 0 resumes alone for a third step;
and deepseek-v2-lite's smoke config (float32) with ``moe_impl="ep"``
under ``with mesh:`` on the (data 2, model 2) mesh for two steps, so
that the expert-parallel dispatch's gradients feed the sharded step.

The ranks start once for the file, while this process computes the
oracles.  The oracle is the JAX package's unsharded ``make_train_step`` in this
process from the same weights (the JAX ``init``), as the JAX package's
own sharded-step test holds its mesh run to it, with the limits of the
port's unsharded parity test (``tests/test_torch_train_step.py``: loss
within 1e-5 and ``grad_norm`` within 1e-4 relative, every parameter and
moment within atol 2e-5 + rtol 1e-4).  The port's own unsharded step on
the same inputs is held tighter, since only the order of the sums
differs (the data shards' gradients averaged, the norm's squares summed
slice by slice): loss and ``grad_norm`` within 2e-6 relative, each
parameter and moment within 1e-4 normwise of its leaf (most leaves
within 2e-6; the attention biases' moments, whose gradients sum every
token's term and so round differently in the two shards' partial sums,
within 2e-5).  The EF step's loss is the uncompressed one (taken before
the gradient), and its ``grad_norm`` within 5% of the exact one: int8
rounds each element by at most 1/254 of its block's largest, and the
payloads summed over the ranks are scaled back by the ranks' mean block
scale, which misses where the ranks' scales differ (2.5% on these
gradients).  The MoE run is held to the port's unsharded step with the
grouped dispatch (itself held to the JAX package's by
``tests/test_torch_train_families.py``) at a capacity factor of 100,
where neither dispatch drops a slot, and with the router's
load-balancing term off (``router_aux_coef`` 0: it is not a mean of
per-token terms, so the data shards' mean of it is not the batch's),
within the dense run's limits against the port: 2e-6 relative, leaves
1e-4 normwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_gloo import join_group, start_group, train_ranks  # noqa: E402

WORLD = 4
LR = 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.launch.steps import make_train_step
    from repro.optim import adamw
    from repro.optim.schedules import constant
    from torch_parity import jax_init
    cfg = get_smoke_config("qwen2-0.5b").replace(dtype="float32")
    params = jax_init(cfg)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    mcfg = _moe_cfg()
    moe_batches = []
    for _ in range(2):
        toks = rng.integers(0, mcfg.vocab_size, (4, 16)).astype(np.int32)
        moe_batches.append({"tokens": toks, "labels": np.roll(toks, -1, 1)})
    group = start_group(train_ranks, WORLD, tmp_path_factory.mktemp("train"),
                        dataclasses.asdict(cfg), params, batches, LR,
                        dataclasses.asdict(mcfg), moe_batches)
    step = jax.jit(make_train_step(cfg, adamw(), constant(LR)))
    p = jax.tree_util.tree_map(jnp.asarray, params)
    o = adamw().init(p)
    want = []
    for b in batches:
        p, o, m = step(p, o, b)
        want.append(({k: float(v) for k, v in m.items()},
                     jax.tree_util.tree_map(np.asarray, {"params": p,
                                                         "opt": o})))
    port = _port_run(dataclasses.asdict(cfg), params, batches)
    moe_port = _port_run(dataclasses.asdict(mcfg.replace(moe_impl="gather")),
                         None, moe_batches)
    return want, port, join_group(group), moe_port


def _moe_cfg():
    from repro_torch.configs import get_smoke_config
    return get_smoke_config("deepseek-v2-lite-16b").replace(
        dtype="float32", moe_impl="ep", moe_capacity=100.0,
        router_aux_coef=0.0)


def _port_run(cfg_kw, params, batches):
    """The port's unsharded step on the same inputs (``params`` None: the
    port's ``init`` at seed 0)."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.base import ModelConfig, get_family
    from repro_torch.optim import adamw
    from repro_torch.optim.schedules import constant
    cfg = ModelConfig(**cfg_kw)
    step = make_train_step(cfg, adamw(), constant(LR))
    p = get_family(cfg).init(cfg, seed=0, device="cpu") if params is None \
        else params_from_numpy(params)
    o = adamw().init(p)
    out = []
    for b in batches:
        p, o, m = step(p, o, b)
        out.append(({k: float(v) for k, v in m.items()},
                    {"params": p, "opt": o}))
    return out


def _hold_metrics(got, want, port):
    for w, rtol in ((want, 1e-5), (port, 2e-6)):
        assert got["loss"] == pytest.approx(w["loss"], rel=rtol)
    for w, rtol in ((want, 1e-4), (port, 2e-6)):
        assert got["grad_norm"] == pytest.approx(w["grad_norm"], rel=rtol)
    assert got["lr"] == pytest.approx(want["lr"])


def _hold_state(got, want, port):
    from repro_torch.convert import tree_to_numpy
    from repro_torch.core.pytree import flatten
    g, _ = flatten(tree_to_numpy(got))
    w, _ = flatten(want)
    t, _ = flatten(tree_to_numpy(port))
    assert len(g) == len(w) == len(t)
    for a, b, c in zip(g, w, t):
        assert a.shape == np.shape(b) == c.shape
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=2e-5,
                                   rtol=1e-4)
        assert np.linalg.norm(a - c) <= 1e-4 * np.linalg.norm(c)


def test_sharded_train_step_matches_one_device(runs):
    want, port, ranks, _ = runs
    for got in ranks:
        for m, (w, _), (t, _) in zip(got["metrics"], want, port):
            _hold_metrics(m, w, t)
        _hold_state(got["state"], want[1][1], port[1][1])


def test_state_at_rest_is_sliced(runs):
    """On (data 2, model 2) the slices at rest hold less than the whole
    state; the ranks' slices cover each leaf as its spec says."""
    _, _, ranks, _ = runs
    whole = sum(a.numel() for a in _leaves(ranks[0]["state"]))
    for got in ranks:
        assert got["at_rest"] < 0.5 * whole


def _leaves(tree):
    from repro_torch.core.pytree import flatten
    return flatten(tree)[0]


def test_ef_compressed_step(runs):
    """One step with ``ErrorFeedback``: the loss is the uncompressed one
    (taken before the gradient), the norm within the module's limit."""
    want, _, ranks, _ = runs
    for got in ranks:
        m, w = got["ef_metrics"][0], want[0][0]
        assert abs(m["loss"] - w["loss"]) < 1e-5
        assert abs(m["grad_norm"] - w["grad_norm"]) < 0.05 * w["grad_norm"]


def test_reshard_two_ranks_to_one_continues(runs):
    """Two steps on ranks 0 and 1, the state gathered and resharded onto
    rank 0 alone, a third step there: the losses and the state are the
    unsharded run's."""
    want, port, ranks, _ = runs
    for got in ranks[:2]:
        for m, (w, _), (t, _) in zip(got["pair_metrics"], want, port):
            _hold_metrics(m, w, t)
    _hold_metrics(ranks[0]["resumed_metrics"][0], want[2][0], port[2][0])
    _hold_state(ranks[0]["resumed_state"], want[2][1], port[2][1])
    assert "resumed_metrics" not in ranks[1]


def test_moe_ep_sharded_step_matches_one_device(runs):
    """Two steps of the MoE smoke config with ``moe_impl="ep"`` under the
    (data 2, model 2) mesh: every rank's loss, ``grad_norm`` and gathered
    state are the port's unsharded step's with the grouped dispatch (no
    slot dropped on either side)."""
    _, _, ranks, moe_port = runs
    for got in ranks:
        for m, (t, _) in zip(got["moe_metrics"], moe_port):
            for key in ("loss", "grad_norm"):
                assert m[key] == pytest.approx(t[key], rel=2e-6), key
        g = _leaves(got["moe_state"])
        t = _leaves(moe_port[-1][1])
        assert len(g) == len(t)
        for a, c in zip(g, t):
            a, c = a.double(), c.double()
            assert torch.linalg.vector_norm(a - c) \
                <= 1e-4 * torch.linalg.vector_norm(c)
