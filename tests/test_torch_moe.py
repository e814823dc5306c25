"""Port parity of the MoE family: ``repro_torch.models.moe`` against
``repro.models.moe`` on the CPU, float32, on the deepseek-v2-lite and
grok-1 smoke configurations (weights from the JAX ``init`` through
``convert.params_from_numpy``, inputs from numpy under a seed).

The expert dispatch (router, top-k, grouped dropped-token slots) at the
default capacity and at a capacity of 0.25 that drops tokens, the
``ragged`` and ``ep`` impls, MLA's full and absorbed attention,
``logits_fn``, and ``prefill`` then three ``decode_step``s.  Expert
choices and kept slots must be equal, save a top-k tie within TIE_ULPS
ulps, which ``jax.lax.top_k`` and ``torch.topk`` may order differently.
Tolerance: 1e-5 absolute and relative on float32 outputs of magnitude ~1
(the orders of the sums differ); the logits of the stacks (up to 3
layers, magnitude ~4) 1e-4.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import base as JB  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import base as TB  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=1e-5, rtol=1e-5)
STACK_TOL = dict(atol=1e-4, rtol=1e-4)
TIE_ULPS = 4
ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")


@functools.lru_cache(maxsize=None)
def _params(arch):
    jp = _jit(JM.init)(jsmoke(arch), jax.random.key(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


def _pair(arch, **over):
    """(JAX cfg, port cfg, JAX params, port params); the weights do not
    depend on ``over`` (dispatch knobs), so they are drawn once."""
    jc, tc = jsmoke(arch).replace(**over), get_smoke_config(arch).replace(
        **over)
    return (jc, tc) + _params(arch)


def _jit(fn):
    """``fn`` jitted with its config static (one compile, not one per
    eager op)."""
    return jax.jit(fn, static_argnums=0)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _moe_params(jp, tp, i=0):
    return (jax.tree_util.tree_map(lambda a: a[i], jp["layers"]["moe"]),
            layer_params(tp, i)["moe"])


def _jax_slots(jc, topi, n):
    """The JAX reference's grouped position-in-expert and kept mask
    (``repro/models/moe.py``: groups, capacity, one-hot cumsum)."""
    k = jc.moe_topk
    g = max(1, min(jc.moe_groups, n))
    while n % g:
        g //= 2
    c = JM._capacity(jc, n // g)
    e_flat = topi.reshape(g, n // g * k)
    onehot = jax.nn.one_hot(e_flat, jc.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 1) - onehot,
                              e_flat[..., None], axis=2)[..., 0]
    return np.asarray(pos), np.asarray(pos < c)


def _assert_same_experts(gates, jtopi, ttopi):
    """Equal top-k choices, save swaps within a tie of TIE_ULPS ulps."""
    ttopi = ttopi.numpy()
    jtopi = np.asarray(jtopi)
    for r in np.nonzero((jtopi != ttopi).any(-1))[0]:
        a = np.sort(gates[r, jtopi[r]])
        b = np.sort(gates[r, ttopi[r]])
        np.testing.assert_allclose(a, b, rtol=TIE_ULPS * 2.0 ** -23, atol=0)
    return (jtopi != ttopi).any(-1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("over", [{}, {"moe_capacity": 0.25},
                                  {"moe_impl": "ragged"},
                                  {"moe_impl": "ep"},
                                  {"moe_groups": 4}],
                         ids=["default", "drop", "ragged", "ep", "groups4"])
def test_moe_ffn_matches_jax(arch, over):
    jc, tc, jp, tp = _pair(arch, **over)
    pj, pt = _moe_params(jp, tp)
    n = 64
    x = _x(1, n, jc.d_model)
    jy, jaux = _jit(JM.moe_ffn)(jc, pj, jnp.asarray(x))
    ty, taux = TM.moe_ffn(tc, pt, torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    # the routing decisions, exactly
    gates, topi, topv = TM.top_experts(tc, pt, torch.from_numpy(x))
    jgates = JM.router_probs(jc, pj, jnp.asarray(x))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **TOL)
    jtopv, jtopi = jax.lax.top_k(jgates, jc.moe_topk)
    tied = _assert_same_experts(np.asarray(jgates), jtopi, topi)
    g, c, pos, keep = TM.dispatch_slots(tc, topi)
    jpos, jkeep = _jax_slots(jc, jtopi, n)
    if not tied.any():
        np.testing.assert_array_equal(pos.numpy(), jpos)
        np.testing.assert_array_equal(keep.numpy(), jkeep)
    if over.get("moe_capacity") == 0.25:
        assert not bool(keep.all()), "no token dropped"


def test_moe_ffn_rows_dispatch_each_sequence_alone():
    """``rows=B`` gives each sequence's own dispatch: equal to running the
    rows one at a time (the JAX package's ``vmap`` over sequences), and
    unequal to the joint dispatch when capacity binds."""
    jc, tc, jp, tp = _pair("deepseek-v2-lite-16b", moe_capacity=0.25)
    _, pt = _moe_params(jp, tp)
    x = torch.from_numpy(_x(2, 3, 16, tc.d_model))
    rows, _ = TM.moe_ffn(tc, pt, x.reshape(48, -1), rows=3)
    one = torch.cat([TM.moe_ffn(tc, pt, x[i])[0] for i in range(3)])
    torch.testing.assert_close(rows, one, rtol=0, atol=0)
    joint, _ = TM.moe_ffn(tc, pt, x.reshape(48, -1))
    assert not torch.allclose(joint, one)
    want = jax.jit(jax.vmap(lambda r: JM.moe_ffn(jc, jax.tree_util.tree_map(
        lambda a: a[0], jp["layers"]["moe"]), r)[0]))(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(rows.numpy(), np.asarray(want).reshape(48, -1),
                               **TOL)


def test_mla_attention_full_and_absorbed_match_jax():
    jc, tc, jp, tp = _pair("deepseek-v2-lite-16b")
    aj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    at = layer_params(tp, 0)["attn"]
    b, s = 2, 11
    x = _x(3, b, s, jc.d_model)
    pos = np.arange(s)
    (jo, (jc_kv, jk_rope)) = _jit(JM.mla_attention_full)(
        jc, aj, jnp.asarray(x), jnp.asarray(pos))
    (to, (tc_kv, tk_rope)) = TM.mla_attention_full(
        tc, at, torch.from_numpy(x), torch.from_numpy(pos))
    for a, w in ((to, jo), (tc_kv, jc_kv), (tk_rope, jk_rope)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    # absorbed decode over a latent cache with ragged valid lengths
    ckv = _x(4, b, s, jc.kv_lora_rank)
    kr = _x(5, b, s, jc.qk_rope_dim)
    xd = _x(6, b, 1, jc.d_model)
    p = np.array([4, 9], np.int32)
    want = _jit(JM.mla_attention_absorbed)(
        jc, aj, jnp.asarray(xd), jnp.asarray(p), jnp.asarray(ckv),
        jnp.asarray(kr), jnp.asarray(p + 1))
    got = TM.mla_attention_absorbed(tc, at, torch.from_numpy(xd),
                                    torch.from_numpy(p),
                                    torch.from_numpy(ckv),
                                    torch.from_numpy(kr),
                                    torch.from_numpy(p + 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_hidden_states_match_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    toks = np.random.default_rng(7).integers(0, jc.vocab_size,
                                             (2, 13)).astype(np.int32)
    want = _jit(JM.logits_fn)(jc, jp, jnp.asarray(toks))
    got = TM.logits_fn(tc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STACK_TOL)
    jx, jaux = _jit(JM.hidden_states)(jc, jp, jnp.asarray(toks))
    tx, taux = TM.hidden_states(tc, tp, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **STACK_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    assert TM.inactive_expert_params(tc) == JM.inactive_expert_params(jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """prefill then three decode_steps on both packages: logits each step
    and the whole cache after each (the port writes it in place)."""
    jc, tc, jp, tp = _pair(arch)
    b, s, max_seq = 2, 9, 16
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jc.vocab_size, (b, s)).astype(np.int32)
    jcache = JM.init_cache(jc, b, max_seq)
    tcache = TM.init_cache(tc, b, max_seq, device="cpu")
    assert set(tcache) == set(jcache)
    jl, jcache = _jit(JM.prefill)(jc, jp, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tc, tp, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STACK_TOL)
    for step in range(3):
        for name, v in jcache.items():
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(v),
                                       **TOL, err_msg=f"{name} @ {step}")
        nxt = rng.integers(0, jc.vocab_size, (b, 1)).astype(np.int32)
        jl, jcache = _jit(JM.decode_step)(jc, jp, jcache,
                                           jnp.asarray(nxt))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STACK_TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


def test_generic_seq_prefill_and_step_dispatch_rows_alone():
    """The generic decode path (``seq_prefill`` / ``seq_step``, MoE has no
    ``prefill_fn``) on four padded rows at a capacity that binds: equal to
    the JAX package's, which ``vmap``s it over the rows, and so unequal to
    a joint dispatch of the rows (``logits_fn`` on the batch)."""
    jc, tc, jp, tp = _pair("deepseek-v2-lite-16b", moe_capacity=0.25)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jc.vocab_size, (4, 16)).astype(np.int32)
    plen = np.array([16, 9, 12, 5], np.int32)
    jl, jcache = jax.jit(jax.vmap(lambda t, n: JB.seq_prefill(jc, jp, t, n)))(
        jnp.asarray(toks), jnp.asarray(plen))
    tl, tcache = TB.seq_prefill(tc, tp, torch.from_numpy(toks),
                                torch.from_numpy(plen))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STACK_TOL)
    joint = TM.logits_fn(tc, tp, torch.from_numpy(toks))[
        torch.arange(4), torch.from_numpy(plen).long() - 1]
    assert not torch.allclose(joint, tl, atol=1e-2)
    tok = np.array([1, 2, 3, 4], np.int32)
    pos = np.array([15, 9, 12, 5], np.int32)
    jl, _ = jax.jit(jax.vmap(lambda c, t, p: JB.seq_step(jc, jp, c, t, p)))(
        jcache, jnp.asarray(tok), jnp.asarray(pos))
    tl, _ = TB.seq_step(tc, tp, tcache, torch.from_numpy(tok),
                        torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STACK_TOL)


def test_bf16_step_gap_is_the_jax_packages():
    """In bf16 the step after a prefill differs from a prefill one token
    longer in both packages alike, even at capacity 100 (nothing dropped):
    the absorbed decode and the full prefill round other products, and a
    top-6 choice near a tie can flip.  At deepseek-v2-lite smoke over
    eight token draws the JAX package's own gap exceeds 0.5 (logits up
    to ~4) at least once, and the port's gap on each draw is within twice
    the JAX package's, or 0.1 where that is smaller."""
    over = dict(dtype="bfloat16", moe_capacity=100.0)
    arch = "deepseek-v2-lite-16b"
    jc, tc = jsmoke(arch).replace(**over), get_smoke_config(arch).replace(
        **over)
    jp = _jit(JM.init)(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    b, s = 4, 24
    gaps = []
    for seed in range(8):
        toks = np.random.default_rng(seed).integers(
            0, jc.vocab_size, (b, s + 1)).astype(np.int32)
        _, jcache = _jit(JM.prefill)(jc, jp, jnp.asarray(toks[:, :s]),
                                     JM.init_cache(jc, b, s + 8))
        jfull, _ = _jit(JM.prefill)(jc, jp, jnp.asarray(toks),
                                    JM.init_cache(jc, b, s + 8))
        jstep, _ = _jit(JM.decode_step)(jc, jp, jcache,
                                        jnp.asarray(toks[:, s:]))
        _, tcache = TM.prefill(tc, tp, torch.from_numpy(toks[:, :s]),
                               TM.init_cache(tc, b, s + 8, device="cpu"))
        tfull, _ = TM.prefill(tc, tp, torch.from_numpy(toks),
                              TM.init_cache(tc, b, s + 8, device="cpu"))
        tstep, _ = TM.decode_step(tc, tp, tcache,
                                  torch.from_numpy(toks[:, s:]))
        jgap = float(np.abs(np.asarray(jstep, np.float32)
                            - np.asarray(jfull, np.float32)).max())
        tgap = float((tstep.float() - tfull.float()).abs().max())
        gaps.append((jgap, tgap))
        assert tgap <= max(2 * jgap, 0.1), (seed, jgap, tgap)
    assert max(j for j, _ in gaps) > 0.5, gaps
