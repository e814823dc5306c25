"""Port parity of the model-parallel operations on a gloo group of four
CPU ranks, against the JAX package: the collectives
(``repro_torch.parallel.collectives``: ring all-gather / reduce-scatter,
``_quantize_int8``, ``compressed_psum``, the EF compressor), the
sequence-sharded flash-decode (``parallel.dist_attention``), expert-
parallel MoE (``parallel.ep_dispatch.ep_moe_ffn`` on a (4,) ``model`` mesh:
8 experts, two a rank, top-2, 48 tokens; the port's ``moe_ffn`` with
``moe_impl="ep"`` under the mesh and without one) and the GPipe forward
(``parallel.pipeline.pipeline_forward``: 8 layers as 4 stages, 4
microbatches).

The ranks start once for the file (``torch_gloo.start_group``) and run
every check; each test reads its own.  Oracles: the single-device
functions in this process (the ring identities, ``_quantize_int8``,
``decode_attention(use_ref=True)``, the JAX ``moe_ffn`` at capacity
factor 100 and its ``jax.grad``, the sequential layers); where the numbers are the parallel
function's own (the int8 sums, the EF residuals, the mean of v that a
row with ``valid_len`` 0 gets, the EP's drops at capacity factor 1.25),
the JAX function on 8 forced host devices in one subprocess, its (4,)
meshes on the first four.

Limits: integer payloads, residuals and expert choices exact; the
all-reduced sums of the float32 scales may differ from XLA's in their
order only, so a sum of n = 4 scales is within 3 roundings (relative
2^-24 each), and the dequantized sum within 1e-6 of its largest
magnitude; attention and MoE outputs within 2e-5, the MoE gradients
within 2e-5 of each one's largest, and the pipeline within 1e-5 (the
JAX tests' limits; float32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_gloo import (finish_jax, join_group, ops_ranks,  # noqa: E402
                        start_group, start_jax)

WORLD = 4
JAX_CODE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.parallel.compat import make_mesh, shard_map
from repro.parallel.collectives import compressed_psum, make_ef_compressor
from repro.parallel.dist_attention import dist_decode_attention
from repro.parallel.ep_dispatch import ep_moe_ffn
inp = np.load(INP)
mesh = make_mesh((4,), ("data",))
y = jnp.asarray(inp["psum"].reshape(-1))
cps = jax.jit(shard_map(lambda u: compressed_psum(u, "data"), mesh=mesh,
                        in_specs=P("data"), out_specs=P("data"),
                        check_vma=False))(y)
one, init_err = make_ef_compressor(None, mesh)
g = jnp.asarray(inp["ef"].reshape(-1))
red1, err1 = one(g, jnp.zeros_like(g), P("data"))
red2, err2 = one(g * 0.5, err1, P("data"))
att = dist_decode_attention(*(jnp.asarray(inp[n]) for n in ("q", "k", "v")),
                            jnp.asarray(inp["vl0"]), mesh)
emesh = make_mesh((4,), ("model",))
p = {k: jnp.asarray(inp["moe_" + k]) for k in ("router", "wg", "wu", "wd")}
ep = jax.jit(lambda x: ep_moe_ffn(x, p, emesh, topk=2,
                                  capacity_factor=1.25))(jnp.asarray(inp["x"]))
np.savez(OUT, cpsum=np.asarray(cps).reshape(4, -1),
         red1=np.asarray(red1).reshape(4, -1),
         err1=np.asarray(err1).reshape(4, -1),
         red2=np.asarray(red2).reshape(4, -1),
         err2=np.asarray(err2).reshape(4, -1), att_vl0=np.asarray(att),
         ep_125=np.asarray(ep))
"""


CFG = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
           d_ff=0, vocab_size=64, dtype="float32", n_experts=8, moe_topk=2,
           d_ff_expert=16, moe_capacity=1.25, moe_groups=1, moe_impl="ep")


def _inputs():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    b, s, h, hkv, d = 2, 256, 4, 2, 32
    psum = f(WORLD, 1000) * np.float32(3.0)
    psum[1, :256] *= np.float32(1e-3)            # blocks of other scales
    e, dm, fe = CFG["n_experts"], CFG["d_model"], CFG["d_ff_expert"]
    moe = {"router": f(dm, e) / np.float32(dm ** 0.5),  # init_moe_ffn's
           "wg": f(e, dm, fe) / np.float32(dm ** 0.5),  # 1/sqrt(fan_in)
           "wu": f(e, dm, fe) / np.float32(dm ** 0.5),
           "wd": f(e, fe, dm) / np.float32(fe ** 0.5)}
    return {"ring": f(WORLD * 8, 3), "psum": psum, "ef": f(WORLD, 512),
            "q": f(b, 1, h, d), "k": f(b, s, hkv, d), "v": f(b, s, hkv, d),
            "vl": np.array([200, 97], np.int32),
            "vl0": np.array([0, 97], np.int32),
            "moe": moe, "x": f(48, 32), "ws": f(8, 16, 16) * np.float32(0.2),
            "xp": f(8, 16), "ct": f(48, 32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_ops")
    inp = _inputs()
    np.savez(tmp / "inp.npz", **{k: v for k, v in inp.items() if k != "moe"},
             **{"moe_" + k: v for k, v in inp["moe"].items()})
    out = str(tmp / "jax.npz")
    proc = start_jax(f"INP = {str(tmp / 'inp.npz')!r}\n" + JAX_CODE, out)
    group = start_group(ops_ranks, WORLD, tmp / "group", inp, CFG)
    return inp, join_group(group), finish_jax(proc, out)


def test_ring_all_gather_and_reduce_scatter(runs):
    inp, ranks, _ = runs
    x = inp["ring"]
    s = x.shape[0] // WORLD
    total = x * sum(r + 1 for r in range(WORLD))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ag"].numpy(), x)
        np.testing.assert_allclose(got["rs"].numpy(),
                                   total[r * s:(r + 1) * s], rtol=1e-6)


def test_quantize_int8_payloads_are_bit_equal(runs):
    import jax.numpy as jnp

    from repro.parallel.collectives import _quantize_int8
    inp, ranks, _ = runs
    for r, got in enumerate(ranks):
        q, scale, pad = _quantize_int8(jnp.asarray(inp["psum"][r]))
        assert pad == 24
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(q))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(scale))


def _close_sum(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_compressed_psum_matches_jax(runs):
    _, ranks, jx = runs
    for r, got in enumerate(ranks):
        _close_sum(got["cpsum"].numpy(), jx["cpsum"][r])


def test_error_feedback_steps_match_jax(runs):
    _, ranks, jx = runs
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["err1"].numpy(), jx["err1"][r])
        np.testing.assert_array_equal(got["err2"].numpy(), jx["err2"][r])
        assert np.abs(got["err1"].numpy()).max() > 0
        for k in ("red1", "red2"):
            _close_sum(got[k].numpy(), jx[k][r])


def test_dist_decode_attention_matches_one_device(runs):
    import jax.numpy as jnp

    from repro.kernels.decode_attention import ops as da
    inp, ranks, _ = runs
    want = np.asarray(da.decode_attention(
        *(jnp.asarray(inp[n]) for n in ("q", "k", "v", "vl")), use_ref=True))
    for got in ranks:
        assert np.abs(got["att_vl"].numpy() - want).max() < 2e-5


def test_dist_decode_attention_row_without_keys_matches_jax(runs):
    """valid_len [0, 97]: the row with no key gets the JAX function's mean
    of v (every shard's scores at its -1e30 fill), never NaN; the shards
    past 97 weigh 0."""
    inp, ranks, jx = runs
    v = inp["v"][0].mean(0)                          # [Hkv, D]
    np.testing.assert_allclose(jx["att_vl0"][0, 0],
                               np.repeat(v, 2, 0), atol=2e-6)
    for got in ranks:
        out = got["att_vl0"].numpy()
        assert np.isfinite(out).all()
        assert np.abs(out - jx["att_vl0"]).max() < 2e-5


def test_ep_matches_spmd_moe_without_drops(runs):
    import jax
    import jax.numpy as jnp

    from repro.models import moe as JM
    from repro.models.base import ModelConfig
    inp, ranks, _ = runs
    jcfg = ModelConfig(**CFG)
    cfg = jcfg.replace(moe_capacity=100.0, moe_impl="gather")
    want, _ = jax.jit(lambda p, x: JM.moe_ffn(cfg, p, x))(
        {k: jnp.asarray(v) for k, v in inp["moe"].items()},
        jnp.asarray(inp["x"]))
    for got in ranks:
        assert np.abs(got["ep_100.0"].numpy() - np.asarray(want)).max() \
            < 2e-5


def test_ep_drops_match_jax_ep(runs):
    """Capacity 1.25: the JAX EP's capacity max(8, ceil(1.25 * 48 * 2 /
    8)) = 15 a local expert drops slots here, and the port drops the same
    ones (a slot dropped on one side only moves its row by O(1))."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as JM
    from repro.models.base import ModelConfig
    from repro_torch.parallel.ep_dispatch import ep_capacity, ep_slots
    inp, ranks, jx = runs
    jcfg = ModelConfig(**CFG)
    gates = JM.router_probs(jcfg, {"router": jnp.asarray(inp["moe"]["router"])},
                            jnp.asarray(inp["x"]))
    jtopi = np.asarray(jax.lax.top_k(gates, 2)[1])
    tgates = torch.softmax(torch.tensor(inp["x"])
                           @ torch.tensor(inp["moe"]["router"]), -1)
    np.testing.assert_array_equal(torch.topk(tgates, 2, -1)[1].numpy(),
                                  jtopi)
    cap = ep_capacity(48, 2, 8, 1.25)
    assert cap == 15
    kept = sum(int(ep_slots(torch.from_numpy(jtopi), lo, 2, cap)[2].sum())
               for lo in range(0, 8, 2))
    assert kept < 48 * 2                             # some slots dropped
    for got in ranks:
        assert np.abs(got["ep_1.25"].numpy() - jx["ep_125"]).max() < 2e-5


def test_moe_impl_ep_takes_the_mesh(runs):
    """``moe_impl="ep"`` under ``with mesh:`` is ``ep_moe_ffn`` at the
    config's capacity; without a mesh it is the grouped dispatch, as the
    JAX package falls through."""
    _, ranks, _ = runs
    for got in ranks:
        assert torch.equal(got["moe_ep_mesh"], got["ep_1.25"])
        assert torch.equal(got["moe_ep_nomesh"], got["grouped"])


def test_ep_dispatch_differentiable(runs):
    """The gradient of sum(ct * ep_moe_ffn(x)) at capacity factor 100 on
    every rank: x's, the router's and every expert's (the whole weights,
    each rank's experts' gradient all-reduced over the axis) == ``jax.grad``
    of the JAX ``moe_ffn`` at capacity 100, normwise within 2e-5."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as JM
    from repro.models.base import ModelConfig
    inp, ranks, _ = runs
    cfg = ModelConfig(**CFG).replace(moe_capacity=100.0, moe_impl="gather")
    ct = jnp.asarray(inp["ct"])
    gp, gx = jax.jit(jax.grad(
        lambda p, x: (JM.moe_ffn(cfg, p, x)[0] * ct).sum(), (0, 1)))(
        {k: jnp.asarray(v) for k, v in inp["moe"].items()},
        jnp.asarray(inp["x"]))
    want = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gp.items()}}
    for got in ranks:
        assert set(got["ep_grads"]) == set(want)
        for k, w in want.items():
            assert np.abs(w).max() > 0
            assert np.abs(got["ep_grads"][k].numpy() - w).max() \
                <= 2e-5 * np.abs(w).max(), k


def test_pipeline_parallel_matches_sequential(runs):
    import jax.numpy as jnp
    _, ranks, _ = runs
    inp = runs[0]
    seq = jnp.asarray(inp["xp"])
    for w in inp["ws"]:
        seq = jnp.tanh(seq @ jnp.asarray(w))
    for got in ranks:
        assert np.abs(got["pipe"].numpy() - np.asarray(seq)).max() < 1e-5


def test_pipeline_bubble_fraction_matches_jax():
    from repro.parallel.pipeline import pipeline_bubble_fraction as jbf
    from repro_torch.parallel.pipeline import pipeline_bubble_fraction
    for s, m in ((4, 4), (2, 8), (8, 1), (1, 5)):
        assert pipeline_bubble_fraction(s, m) == jbf(s, m)
