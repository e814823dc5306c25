"""Port parity of the dense model: ``repro_torch.models`` against
``repro.models`` on the CPU, float32, weights from the JAX ``init``
carried across by ``convert.params_from_numpy``.

Layers one by one, then ``logits_fn`` / ``prefill_fn`` / ``step_fn`` for
each dense smoke configuration (qkv bias, layernorm, partial rotary,
residual and logit scale), and the generic fallback.  Tolerance: 1e-5
absolute on float32 outputs of magnitude ~1.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import get_smoke_config as jsmoke  # noqa: E402
from repro.models import base as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import (ARCHS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import base as TB  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from torch_parity import jax_init  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=1e-5, rtol=1e-5)
DENSE_ARCHS = [a for a in ARCHS if get_config(a).family == "dense"]
CFG_KW = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
              ce_chunk=8, remat=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch=None, **over):
    """(JAX cfg, port cfg, JAX params, port params)."""
    if arch is None:
        jc, tc = JB.ModelConfig(**CFG_KW), TB.ModelConfig(**CFG_KW)
    else:
        jc, tc = jsmoke(arch), get_smoke_config(arch)
    jc, tc = jc.replace(**over), tc.replace(**over)
    jp = jax_init(jc)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, jp), \
        params_from_numpy(jp)


def test_configs_and_model_config_match_jax():
    assert [f.name for f in dataclasses.fields(TB.ModelConfig)] \
        == [f.name for f in dataclasses.fields(JB.ModelConfig)]
    for arch in ARCHS:
        for j, t in ((jget(arch), get_config(arch)),
                     (jsmoke(arch), get_smoke_config(arch))):
            assert dataclasses.asdict(j) == dataclasses.asdict(t), arch
            assert (t.kv_heads, t.head_dim) == (j.kv_heads, j.head_dim)
    assert get_config("smollm-135m").jdtype == torch.bfloat16
    for fam in ("dense", "moe", "whisper", "rwkv6", "zamba2", "vlm"):
        assert TB.get_family(fam).__name__.startswith("repro_torch.models.")
    with pytest.raises(KeyError, match="unknown model family"):
        TB.get_family("no-such-family")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_dtypes_and_scales_match_jax(arch):
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    jp = _np(jax.jit(JB.get_family(jc).init, static_argnums=0)(
        jc, jax.random.key(0)))
    init = TB.get_family(tc).init
    tp = init(tc, seed=3, device="cpu")
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert TB.count_params(tp) == sum(x.size for x in flat_j.values())
    want = {jax.tree_util.keystr(k): v for k, v in flat_j.items()}
    got = {}

    def walk(t, path):
        items = t.items() if isinstance(t, dict) else enumerate(t)
        for k, v in items:
            p = path + (f"['{k}']" if isinstance(t, dict) else f"[{k}]")
            walk(v, p) if isinstance(v, (dict, list)) \
                else got.__setitem__(p, v)
    walk(tp, "")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        if v.std() > 0:                     # random leaves: same scale
            assert abs(float(got[k].float().std()) / float(v.std()) - 1) \
                < 0.2, k
    again = init(tc, seed=3, device="cpu")
    assert torch.equal(again["embed"]["tok"], tp["embed"]["tok"])


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(TL.rmsnorm(t(x), t(s)).numpy(),
                               np.asarray(JL.rmsnorm(x, s)), **TOL)
    np.testing.assert_allclose(TL.layernorm(t(x), t(s), t(bias)).numpy(),
                               np.asarray(JL.layernorm(x, s, bias)), **TOL)
    for frac, hd in ((1.0, 16), (0.25, 16), (0.3, 10)):
        jc = JB.ModelConfig(**{**CFG_KW, "d_model": hd * 4,
                               "rope_frac": frac})
        tc = TB.ModelConfig(**{**CFG_KW, "d_model": hd * 4,
                               "rope_frac": frac})
        pos = np.arange(5)
        jcs, jsn = JL.rope_freqs(jc, jnp.asarray(pos))
        tcs, tsn = TL.rope_freqs(tc, t(pos))
        np.testing.assert_allclose(tcs.numpy(), np.asarray(jcs), **TOL)
        q = rng.standard_normal((2, 5, 3, hd)).astype(np.float32)
        np.testing.assert_allclose(
            TL.apply_rope(t(q), tcs, tsn).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(q), jcs, jsn)), **TOL)
    k = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    np.testing.assert_array_equal(TL._repeat_kv(t(k), 3).numpy(),
                                  np.asarray(JL._repeat_kv(jnp.asarray(k),
                                                           3)))
    for act in ("silu", "gelu"):
        jc, tc, jp, tp = _pair(act=act)
        mj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["mlp"])
        mt = TT.layer_params(tp, 0)["mlp"]
        xm = rng.standard_normal((2, 3, 32)).astype(np.float32)
        np.testing.assert_allclose(TL.apply_mlp(tc, mt, t(xm)).numpy(),
                                   np.asarray(JL.apply_mlp(jc, mj, xm)),
                                   **TOL)
    jc, tc, jp, tp = _pair(qkv_bias=True, logit_scale=0.5)
    aj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["attn"])
    xa = rng.standard_normal((2, 3, 32)).astype(np.float32)
    for a, b in zip(TL.gqa_project_qkv(tc, TT.layer_params(tp, 0)["attn"],
                                       t(xa)),
                    JL.gqa_project_qkv(jc, aj, jnp.asarray(xa))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(
        TL.lm_head(tc, tp["embed"], t(xa)).numpy(),
        np.asarray(JL.lm_head(jc, jp["embed"], jnp.asarray(xa))), **TOL)
    toks = np.array([[1, 5, 63]], np.int32)
    np.testing.assert_array_equal(
        TL.embed_tokens(tc, tp["embed"], t(toks)).numpy(),
        np.asarray(jp["embed"]["tok"])[toks])


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_forward_prefill_and_step_match_jax(arch):
    jc, tc, jp, tp = _pair(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (2, 9)).astype(np.int32)
    fam_j, fam_t = JB.get_family(jc), TB.get_family(tc)
    np.testing.assert_allclose(
        fam_t.logits_fn(tc, tp, torch.from_numpy(toks)).numpy(),
        np.asarray(fam_j.logits_fn(jc, jp, jnp.asarray(toks))), **TOL)
    # prefill two padded rows of different lengths at once, then two steps
    buf = np.zeros((2, 12), np.int32)
    buf[:, :9] = toks
    plen = np.array([5, 9], np.int32)
    tl, tcache = TB.seq_prefill(tc, tp, torch.from_numpy(buf),
                                torch.from_numpy(plen))
    assert tcache["k"].shape == (2, jc.n_layers, 12, jc.kv_heads,
                                 jc.head_dim)
    want = []
    for i in range(2):
        jl, jcache = JB.seq_prefill(jc, jp, jnp.asarray(buf[i]),
                                    jnp.int32(plen[i]))
        np.testing.assert_allclose(tl[i].numpy(), np.asarray(jl), **TOL)
        n = plen[i]
        np.testing.assert_allclose(tcache["k"][i][:, :n].numpy(),
                                   np.asarray(jcache["k"])[:, :n], **TOL)
        for step, tok in enumerate((7, 11)):
            jl, jcache = JB.seq_step(jc, jp, jcache, jnp.int32(tok),
                                     jnp.int32(n + step))
        want.append(np.asarray(jl))
    pos = torch.from_numpy(plen)
    for tok in (7, 11):
        tl, tcache = TB.seq_step(tc, tp, tcache,
                                 torch.full((2,), tok, dtype=torch.int32),
                                 pos)
        pos = pos + 1
    for i in range(2):
        np.testing.assert_allclose(tl[i].numpy(), want[i], **TOL)
        # prefill-then-step == a full forward of the longer prefix
        full = np.r_[buf[i, :plen[i]], [7, 11]].astype(np.int32)
        np.testing.assert_allclose(
            tl[i].numpy(),
            fam_t.logits_fn(tc, tp, torch.from_numpy(full)[None])[0, -1]
            .numpy(), atol=1e-4)


def test_generic_fallback_matches_family_step(monkeypatch):
    """Without the family's prefill_fn / step_fn the generic path (full
    forward from a token-buffer cache) gives the same logits, as in the
    JAX package."""
    jc, tc, jp, tp = _pair()
    buf = torch.zeros(10, dtype=torch.int32)
    buf[:4] = torch.tensor([1, 2, 3, 4])
    plen = torch.tensor(4)
    lg_f, cache_f = TB.seq_prefill(tc, tp, buf, plen)
    jl, _ = JB.seq_prefill(jc, jp, jnp.asarray(buf.numpy()), jnp.int32(4))
    np.testing.assert_allclose(lg_f.numpy(), np.asarray(jl), **TOL)
    monkeypatch.delattr(TT, "prefill_fn")
    monkeypatch.delattr(TT, "step_fn")
    lg_g, cache_g = TB.seq_prefill(tc, tp, buf, plen)
    assert set(cache_g) == {"toks"}
    np.testing.assert_allclose(lg_g.numpy(), lg_f.numpy(), **TOL)
    lg_g2, cache_g = TB.seq_step(tc, tp, cache_g, torch.tensor(9), plen)
    assert int(cache_g["toks"][4]) == 9
    monkeypatch.undo()
    lg_f2, _ = TB.seq_step(tc, tp, cache_f, torch.tensor(9), plen)
    np.testing.assert_allclose(lg_g2.numpy(), lg_f2.numpy(), **TOL)
