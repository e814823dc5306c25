"""Port parity of the recurrent families (``rwkv6``, ``zamba2``) and of the
dense family's batched serving trio: ``repro_torch.models`` against
``repro.models`` on the CPU, float32, weights from the JAX ``init``
carried across by ``convert.params_from_numpy``.

Every float leaf of the JAX weights gets a little seeded noise first, so
the leaves ``init`` sets to constants (decays, bonuses, mixing
coefficients, the zero LoRA ``B`` of the shared block, ``A_log``) are
exercised too.  Tolerance 2e-4 absolute and relative: the JAX package
scans sequences in chunked matmul form, the port step by step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import base as JB  # noqa: E402
from repro.models import zamba2 as JZ  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import base as TB  # noqa: E402
from repro_torch.models import zamba2 as TZ  # noqa: E402
from torch_parity import jax_init  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=2e-4, rtol=2e-4)
ARCHS = ("smollm-135m", "rwkv6-1.6b", "zamba2-1.2b")


def _noisy(tree, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)

    def f(x):
        x = np.asarray(x)
        if x.dtype.kind != "f":
            return x
        return (x + scale * rng.standard_normal(x.shape)).astype(x.dtype)
    return jax.tree_util.tree_map(f, tree)


def _pair(arch, **over):
    """(JAX cfg, port cfg, JAX params, port params), noisy weights."""
    jc, tc = jsmoke(arch).replace(**over), get_smoke_config(arch) \
        .replace(**over)
    jp = _noisy(jax_init(jc))
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, jp), \
        params_from_numpy(jp)


def _jit(fam, name, cfg):
    """The JAX family's ``name`` with ``cfg`` bound, jitted (one compile
    instead of eager dispatch of every op)."""
    fn = getattr(fam, name)
    return jax.jit(lambda *a: fn(cfg, *a))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), err_msg=what,
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_prefill_and_decode_match_jax(arch):
    """``logits_fn``; ``prefill`` of a batch of two; two ``decode_step``s;
    every cache leaf after each."""
    jc, tc, jp, tp = _pair(arch)
    jf, tf = JB.get_family(jc), TB.get_family(tc)
    toks = np.random.default_rng(1).integers(
        0, jc.vocab_size, (2, 11)).astype(np.int32)
    _close(tf.logits_fn(tc, tp, torch.from_numpy(toks)),
           _jit(jf, "logits_fn", jc)(jp, jnp.asarray(toks)), "logits_fn")
    jcache = jf.init_cache(jc, 2, 16)
    tcache = tf.init_cache(tc, 2, 16, device="cpu")
    assert set(tcache) == set(jcache)
    jdecode = _jit(jf, "decode_step", jc)
    jl, jcache = _jit(jf, "prefill", jc)(jp, jnp.asarray(toks[:, :9]),
                                         jcache)
    tl, tcache = tf.prefill(tc, tp, torch.from_numpy(toks[:, :9]), tcache)
    _close(tl, jl, "prefill logits")
    for step in (9, 10):
        tok = toks[:, step: step + 1]
        jl, jcache = jdecode(jp, jcache, jnp.asarray(tok))
        tl, tcache = tf.decode_step(tc, tp, tcache, torch.from_numpy(tok))
        _close(tl, jl, f"decode logits at {step}")
        for k in jcache:
            _close(tcache[k].float(), np.asarray(jcache[k], np.float32),
                   f"cache {k} at {step}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(arch):
    """decode(prefill(prompt)) logits == full-forward logits, as
    ``tests/test_archs_smoke.py`` checks in the JAX package."""
    cfg = get_smoke_config(arch)
    fam = TB.get_family(cfg)
    params = fam.init(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (2, 16), generator=gen,
                         dtype=torch.int32)
    cache = fam.init_cache(cfg, 2, 20, device="cpu")
    lp, cache = fam.prefill(cfg, params, toks, cache)
    full = fam.logits_fn(cfg, params, toks)
    torch.testing.assert_close(lp[:, 0], full[:, -1], **TOL)
    nxt = torch.argmax(lp[:, 0], -1)[:, None].to(torch.int32)
    ld, cache = fam.decode_step(cfg, params, cache, nxt)
    full2 = fam.logits_fn(cfg, params, torch.cat([toks, nxt], 1))
    torch.testing.assert_close(ld[:, 0].float(), full2[:, -1], **TOL)
    assert cache["pos"].tolist() == [17, 17]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_at_ragged_positions_matches_jax(arch):
    """Rows at different positions, as the engine's slots are: two
    prompts prefilled alone and spliced into one batch cache, then a
    decode step writes each row's K/V at its own ``pos``."""
    jc, tc, jp, tp = _pair(arch)
    jf, tf = JB.get_family(jc), TB.get_family(tc)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, jc.vocab_size, (1, n)).astype(np.int32)
               for n in (7, 4)]
    jbat, tbat = jf.init_cache(jc, 2, 12), tf.init_cache(tc, 2, 12,
                                                         device="cpu")
    jprefill = _jit(jf, "prefill", jc)
    for i, p in enumerate(prompts):
        _, jone = jprefill(jp, jnp.asarray(p), jf.init_cache(jc, 1, 12))
        _, tone = tf.prefill(tc, tp, torch.from_numpy(p),
                             tf.init_cache(tc, 1, 12, device="cpu"))
        jbat = {k: (v.at[i].set(jone[k][0]) if v.ndim == 1
                    else v.at[:, i].set(jone[k][:, 0]))
                for k, v in jbat.items()}
        for k, v in tbat.items():
            if v.dim() == 1:
                v[i] = tone[k][0]
            else:
                v[:, i] = tone[k][:, 0]
    tok = np.array([[3], [5]], np.int32)
    jl, jbat = _jit(jf, "decode_step", jc)(jp, jbat, jnp.asarray(tok))
    tl, tbat = tf.decode_step(tc, tp, tbat, torch.from_numpy(tok))
    _close(tl, jl, "ragged decode logits")
    for k in jbat:
        _close(tbat[k].float(), np.asarray(jbat[k], np.float32), k)


def test_zamba2_parts_match_jax():
    """The causal conv with a carried state, the segment plan of the full
    config (38 blocks, a shared application every 6, none after the last
    two) and the LoRA'd QKV at GQA widths (k / v deltas sliced)."""
    rng = np.random.default_rng(3)
    x, w, b, st = (rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 5, 6), (4, 6), (6,), (2, 3, 6)))
    jy, jst = JZ._causal_conv(*map(jnp.asarray, (x, w, b, st)))
    ty, tst = TZ._causal_conv(*map(torch.from_numpy, (x, w, b, st)))
    _close(ty, jy, "conv y")
    _close(tst, jst, "conv state")
    arch = "zamba2-1.2b"
    assert TZ._segments(get_config(arch)) == JZ._segments(jget(arch))
    assert TZ._segments(get_smoke_config(arch)) == JZ._segments(jsmoke(arch))
    assert TZ._segments(get_config("zamba2-1.2b"))[-1] == (36, 38, None)
    jc, tc, jp, tp = _pair("zamba2-1.2b", n_kv_heads=2)
    h2 = rng.standard_normal((2, 3, 2 * jc.d_model)).astype(np.float32)
    for app in range(JZ._n_apps(jc)):
        for a, want in zip(
                TZ._shared_qkv(tc, tp["shared"], torch.from_numpy(h2), app),
                JZ._shared_qkv(jc, jp["shared"], jnp.asarray(h2), app)):
            _close(a, want, f"qkv app {app}")


def test_decode_step_steps_from_the_state_it_is_given():
    """The rwkv6 state carries the context: a decode step from the state
    of a prefill differs from a step from the zero state."""
    cfg = get_smoke_config("rwkv6-1.6b")
    fam = TB.get_family(cfg)
    params = fam.init(cfg, seed=0, device="cpu")
    toks = torch.arange(1, 9, dtype=torch.int32)[None]
    _, cache = fam.prefill(cfg, params, toks,
                           fam.init_cache(cfg, 1, 12, device="cpu"))
    tok = torch.tensor([[4]], dtype=torch.int32)
    warm, _ = fam.decode_step(cfg, params, cache, tok)
    cold, _ = fam.decode_step(cfg, params,
                              fam.init_cache(cfg, 1, 12, device="cpu"), tok)
    assert float((warm - cold).abs().max()) > 1e-3
