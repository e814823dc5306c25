"""Port parity of the training layers on the CPU: ``blocked_attention``
(the plain copies of ``_blocked_fwd`` / ``_core_bwd`` behind the port's
``torch.autograd.Function``) against the JAX package's custom VJP, and
``chunked_softmax_xent`` against ``jax.value_and_grad``.

Inputs come from numpy under a seed; the JAX side is ``jax.jit``ted with
its configuration static.  Tolerances: float32 outputs, logsumexps and
gradients 2e-5 absolute and relative (the same blocked arithmetic, summed
in other orders); bfloat16 outputs and gradients one bf16 ulp, 2^-7
relative, plus 2e-2 absolute for elements that cancel to near zero (both
round at the same places: p to v's dtype before PV, the gradients once at
the end); the cross-entropy loss 1e-6 relative and its gradients 1e-5.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models.base import ModelConfig as JConfig  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.base import ModelConfig as TConfig  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2.0 ** -7)


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _jax_vjp(q, k, v, dout, causal, q_offset, blk_q, blk_k, cap):
    def f(q, k, v):
        return JL.blocked_attention(q, k, v, causal=causal, q_offset=q_offset,
                                    blk_q=blk_q, blk_k=blk_k,
                                    logits_soft_cap=cap)
    out, vjp = jax.vjp(f, q, k, v)
    _, lse = JL._blocked_fwd(q, k, v, causal, q_offset, min(blk_q, q.shape[1]),
                             min(blk_k, k.shape[1]), cap)
    return (out, lse) + vjp(dout)


CASES = [
    # b, sq, sk, h, hkv, d, dv, causal, q_offset, blk_q, blk_k, cap
    (2, 16, 16, 4, 2, 8, 8, True, 0, 4, 8, 0.0),        # GQA 2, causal
    (1, 13, 21, 3, 3, 8, 8, False, 0, 4, 8, 0.0),       # padding both ways
    (2, 11, 19, 6, 2, 16, 16, True, 8, 4, 4, 0.0),      # q_offset, padding
    (1, 12, 12, 4, 1, 8, 8, True, 0, 8, 4, 30.0),       # soft cap, GQA 4
    (2, 10, 14, 4, 2, 12, 8, False, 0, 4, 8, 5.0),      # Dv != D, cap
    (1, 9, 15, 2, 1, 12, 8, True, 6, 4, 8, 0.0),        # Dv != D, offset
]


def _port(q, k, v, dout, dtype, causal, q_offset, blk_q, blk_k, cap):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_(True)
                  for x in (q, k, v))
    out = TL.blocked_attention(qt, kt, vt, causal=causal, q_offset=q_offset,
                               blk_q=blk_q, blk_k=blk_k, logits_soft_cap=cap)
    out.backward(torch.from_numpy(dout).to(dtype))
    _, lse = tfa.flash_attention_lse(qt.detach(), kt.detach(), vt.detach(),
                                     causal=causal, q_offset=q_offset,
                                     logits_soft_cap=cap, blk_q=blk_q,
                                     blk_k=blk_k)
    return [t.float().numpy() for t in (out.detach(), lse, qt.grad, kt.grad,
                                        vt.grad)]


@pytest.mark.parametrize("case", CASES)
def test_blocked_attention_matches_custom_vjp(case):
    b, sq, sk, h, hkv, d, dv, causal, off, bq, bk, cap = case
    q, k, v, dout = _rand(1, (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, dv),
                          (b, sq, h, dv))
    want = _jax_vjp(*(jnp.asarray(x) for x in (q, k, v, dout)), causal, off,
                    bq, bk, cap)
    got = _port(q, k, v, dout, torch.float32, causal, off, bq, bk, cap)
    names = ("out", "lse", "dq", "dk", "dv")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        if name == "lse":                       # JAX: [B, Hkv, g, Sq]
            w = w.reshape(b, h, sq)
        np.testing.assert_allclose(g, w, err_msg=name, **F32)


def test_blocked_attention_bf16_matches_custom_vjp():
    b, sq, sk, h, hkv, d, dv, causal, off, bq, bk, cap = CASES[2]
    q, k, v, dout = _rand(2, (b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, dv),
                          (b, sq, h, dv))
    bf = jnp.bfloat16
    want = _jax_vjp(*(jnp.asarray(x, bf) for x in (q, k, v, dout)), causal,
                    off, bq, bk, cap)
    got = _port(q, k, v, dout, torch.bfloat16, causal, off, bq, bk, cap)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        if name == "lse":
            np.testing.assert_allclose(g, w.reshape(b, h, sq), err_msg=name,
                                       **F32)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **BF16)


def test_attention_takes_blocked_path_under_grad():
    cfg = TConfig(name="t", family="dense", n_layers=1, d_model=16,
                  n_heads=2, n_kv_heads=1, d_ff=16, vocab_size=8,
                  dtype="float32", attn_blk_q=4, attn_blk_k=8)
    q, k, v = (torch.from_numpy(x) for x in _rand(
        3, (1, 10, 2, 8), (1, 10, 1, 8), (1, 10, 1, 8)))
    with torch.no_grad():
        plain = TL.attention(cfg, q, k, v, causal=True)
    q.requires_grad_(True)
    out = TL.attention(cfg, q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "_BlockedAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, atol=1e-6, rtol=1e-6)
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()


def _xent_cfgs(tie, scale, chunk):
    kw = dict(name="x", family="dense", n_layers=1, d_model=16, n_heads=2,
              d_ff=16, vocab_size=40, tie_embeddings=tie, logit_scale=scale,
              dtype="float32", ce_chunk=chunk)
    return JConfig(**kw), TConfig(**kw)


@pytest.mark.parametrize("tie,scale,chunk,masked", [
    (True, 1.0, 4, False),       # tied, 13 = 3 x 4 + a remainder of 1
    (False, 0.5, 5, True),       # untied, logit scale, mask, remainder 3
    (True, 0.25, 16, True),      # one chunk shorter than ce_chunk
])
def test_chunked_softmax_xent_matches_jax(tie, scale, chunk, masked):
    jcfg, tcfg = _xent_cfgs(tie, scale, chunk)
    rng = np.random.default_rng(4)
    b, s, d, vocab = 2, 13, 16, 40
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.7).astype(np.float32) if masked else None
    p = {"tok": rng.standard_normal((vocab, d)).astype(np.float32) * 0.3}
    if not tie:
        p["head"] = rng.standard_normal((d, vocab)).astype(np.float32) * 0.3

    def jloss(x, p):
        return JL.chunked_softmax_xent(jcfg, p, x, jnp.asarray(labels),
                                       None if mask is None
                                       else jnp.asarray(mask))
    want, (wgx, wgp) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})

    xt = torch.from_numpy(x).requires_grad_(True)
    pt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    got = TL.chunked_softmax_xent(tcfg, pt, xt, torch.from_numpy(labels),
                                  None if mask is None
                                  else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wgx), atol=1e-5,
                               rtol=1e-5)
    for k in p:                 # an untied head leaves "tok" unused
        g = pt[k].grad if pt[k].grad is not None else torch.zeros_like(pt[k])
        np.testing.assert_allclose(g.numpy(), np.asarray(wgp[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# kernels with no backward refuse to run under grad on the card; K5 / K6
# take their autograd Functions
# ---------------------------------------------------------------------------
def _kernel_call(which, grad):
    from repro_torch.kernels.decode_attention import ops as tda
    from repro_torch.kernels.rwkv6_scan import ops as twk
    from repro_torch.kernels.ssm_scan import ops as tss
    r = torch.randn

    def g(*shape):
        return r(*shape).requires_grad_(grad)
    if which == "k4":
        return lambda: tfa.flash_attention(g(1, 4, 2, 16), g(1, 4, 1, 16),
                                           g(1, 4, 1, 16))
    if which == "k3":
        return lambda: tda.decode_attention(g(1, 1, 2, 16), g(1, 8, 1, 16),
                                            g(1, 8, 1, 16),
                                            torch.tensor([5]))
    if which == "k5":
        return lambda: twk.wkv6(g(1, 4, 2, 8), g(1, 4, 2, 8), g(1, 4, 2, 8),
                                g(1, 4, 2, 8), g(2, 8), r(1, 2, 8, 8))
    return lambda: tss.ssd(g(1, 4, 2, 8), g(1, 4, 2), g(2), g(1, 4, 4),
                           g(1, 4, 4), g(2), r(1, 2, 8, 4))


@pytest.mark.parametrize("which", ["k4", "k3", "k5", "k6"])
def test_kernels_without_backward_raise_under_grad(monkeypatch, which):
    """The CUDA path (``impl="cuda"`` forced at the dispatch, CPU tensors).
    K4 and K3 have no backward: they raise before any launch when an input
    requires grad, rather than return a result with no ``grad_fn``.  K5
    and K6 have one (``csrc/rwkv6_chunk_bwd.cu``, ``ssm_chunk_bwd.cu``):
    under grad they go through their autograd Function, on to the
    forward's launch (which fails here: no nvcc, no card), and with that
    launch stood in for by the plain version with its chunk states, the
    output carries the Function's ``grad_fn``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_scan import ops as twk
    from repro_torch.kernels.ssm_scan import ops as tss
    monkeypatch.setattr(_build, "resolve_impl", lambda impl, t: "cuda")
    if which in ("k5", "k6"):
        ops, plain, node = ((twk, twk.R.wkv6_fwd_ref, "_WKV6Backward")
                            if which == "k5" else
                            (tss, tss.R.ssd_fwd_ref, "_SSDBackward"))
        with pytest.raises(Exception) as err:
            _kernel_call(which, grad=True)()   # goes on to the launch
        assert "has no backward" not in str(err.value)
        monkeypatch.setattr(ops, "_forward",
                            lambda *a, keep: plain(*a) if keep else None)
        y, _ = _kernel_call(which, grad=True)()
        assert type(y.grad_fn).__name__ == node
        assert y.requires_grad
        return
    with pytest.raises(RuntimeError, match="has no backward"):
        _kernel_call(which, grad=True)()
    with torch.no_grad(), pytest.raises(Exception) as err:
        _kernel_call(which, grad=True)()       # goes on to the launch
    assert "has no backward" not in str(err.value)
    with pytest.raises(Exception) as err:
        _kernel_call(which, grad=False)()
    assert "has no backward" not in str(err.value)
