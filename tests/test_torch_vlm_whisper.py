"""Port parity of the VLM and Whisper families: ``repro_torch.models.vlm``
/ ``whisper`` against ``repro.models.vlm`` / ``whisper`` on the CPU,
float32, on the internvl2 and whisper smoke configurations (weights from
the JAX ``init`` through ``convert.params_from_numpy``, inputs from numpy
under a seed).

VLM: the projector, the image-then-text embeddings, ``multimodal_logits``,
``logits_fn`` and the dense backbone's ``prefill`` / ``decode_step``.
Whisper: the sinusoid, ``encode``, ``decode_states``, ``logits_fn``, and
``prefill`` with frames then three ``decode_step``s, caches compared after
each.  Tolerance: 1e-5 absolute and relative on float32 outputs of
magnitude ~1 (the orders of the sums differ); the logits of the stacks
1e-4.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import vlm as JV  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import vlm as TV  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=1e-5, rtol=1e-5)
STACK_TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(JAX cfg, port cfg, JAX params, port params)."""
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    fam = JV if jc.family == "vlm" else JW
    jp = jax.jit(fam.init, static_argnums=0)(jc, jax.random.key(0))
    return jc, tc, jp, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                                jp))


def _jit(fn):
    return jax.jit(fn, static_argnums=0)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _toks(seed, vocab, *shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# VLM
# ---------------------------------------------------------------------------
def test_vlm_projector_and_multimodal_logits_match_jax():
    jc, tc, jp, tp = _pair("internvl2-2b")
    patches = _x(1, 2, jc.n_patches, jc.frontend_dim)
    toks = _toks(2, jc.vocab_size, 2, 7)
    jpt, tpt = jnp.asarray(patches), torch.from_numpy(patches)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    np.testing.assert_allclose(
        TV.project_patches(tc, tp, tpt).numpy(),
        np.asarray(_jit(JV.project_patches)(jc, jp, jpt)), **TOL)
    emb = TV.multimodal_embeds(tc, tp, tpt, tt)
    assert emb.shape == (2, jc.n_patches + 7, jc.d_model)
    np.testing.assert_allclose(
        emb.numpy(), np.asarray(_jit(JV.multimodal_embeds)(jc, jp, jpt, jt)),
        **TOL)
    np.testing.assert_allclose(
        TV.multimodal_logits(tc, tp, tpt, tt).numpy(),
        np.asarray(_jit(JV.multimodal_logits)(jc, jp, jpt, jt)), **STACK_TOL)
    np.testing.assert_allclose(
        TV.logits_fn(tc, tp, tt).numpy(),
        np.asarray(_jit(JV.logits_fn)(jc, jp, jt)), **STACK_TOL)


def test_vlm_prefill_and_decode_steps_match_jax():
    jc, tc, jp, tp = _pair("internvl2-2b")
    b, s, max_seq = 2, 6, 12
    toks = _toks(3, jc.vocab_size, b, s)
    jcache = JV.init_cache(jc, b, max_seq)
    tcache = TV.init_cache(tc, b, max_seq, device="cpu")
    jl, jcache = _jit(JV.prefill)(jc, jp, jnp.asarray(toks), jcache)
    tl, tcache = TV.prefill(tc, tp, torch.from_numpy(toks), tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STACK_TOL)
    for step in range(3):
        nxt = _toks(4 + step, jc.vocab_size, b, 1)
        jl, jcache = _jit(JV.decode_step)(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TV.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jl)[:, 0],
                                   **STACK_TOL)
    for name, v in jcache.items():
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(v),
                                   **TOL, err_msg=name)


# ---------------------------------------------------------------------------
# Whisper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("length,d", [(16, 48), (1500, 512)])
def test_whisper_sinusoid_matches_jax(length, d):
    """The angles reach ``length`` radians, whose float32 ulp is ``length
    * 2^-23``: XLA's and PyTorch's ``exp`` of the frequencies may differ by
    an ulp, which the position multiplies, so the allowance is two ulps of
    the largest angle (3.6e-4 at whisper-base's 1500 frames)."""
    np.testing.assert_allclose(
        TW._sinusoid(length, d, torch.float32).numpy(),
        np.asarray(JW._sinusoid(length, d, jnp.float32)),
        atol=max(TOL["atol"], 2 * length * 2.0 ** -23), rtol=0)


def test_whisper_encode_decode_states_and_logits_match_jax():
    jc, tc, jp, tp = _pair("whisper-base")
    frames = _x(5, 2, jc.enc_seq, jc.d_model)
    toks = _toks(6, jc.vocab_size, 2, 9)
    jf, tf = jnp.asarray(frames), torch.from_numpy(frames)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks)
    jenc = _jit(JW.encode)(jc, jp, jf)
    tenc = TW.encode(tc, tp, tf)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **TOL)
    np.testing.assert_allclose(
        TW.decode_states(tc, tp, tt, tenc).numpy(),
        np.asarray(_jit(JW.decode_states)(jc, jp, jt, jenc)), **TOL)
    np.testing.assert_allclose(
        TW.logits_fn(tc, tp, tt, tf).numpy(),
        np.asarray(_jit(JW.logits_fn)(jc, jp, jt, jf)), **STACK_TOL)


def test_whisper_prefill_and_decode_steps_match_jax():
    """prefill with frames then three decode_steps: logits each step and
    the whole cache (self K/V, cross xk / xv, pos) after each."""
    jc, tc, jp, tp = _pair("whisper-base")
    b, s, max_seq = 2, 7, 12
    frames = _x(7, b, jc.enc_seq, jc.d_model)
    toks = _toks(8, jc.vocab_size, b, s)
    jcache = JW.init_cache(jc, b, max_seq)
    tcache = TW.init_cache(tc, b, max_seq, device="cpu")
    assert set(tcache) == set(jcache)
    jl, jcache = _jit(JW.prefill)(
        jc, jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
        jcache)
    tl, tcache = TW.prefill(tc, tp, {"frames": torch.from_numpy(frames),
                                     "tokens": torch.from_numpy(toks)},
                            tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STACK_TOL)
    for step in range(3):
        for name, v in jcache.items():
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(v),
                                       **TOL, err_msg=f"{name} @ {step}")
        nxt = _toks(9 + step, jc.vocab_size, b, 1)
        jl, jcache = _jit(JW.decode_step)(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TW.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **STACK_TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
