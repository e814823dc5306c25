"""On the card: the training kernels against their plain versions, and
training through ``attention()`` on the card against the plain path.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX: ``python -m pytest -q -m cuda --noconftest
tests/test_torch_card_train.py``.

* kernel A (the flash forward writing its logsumexp): its output equals
  the serving kernel's on the same inputs bit for bit (the same kernel,
  one more store), and its lse is within 1e-4 absolute of the plain
  ``blocked_fwd_ref`` in float32 (scores summed in other orders; exp2 /
  log2 against exp / log);
* kernel B (the flash backward): dq, dk, dv against ``blocked_bwd_ref``
  run in float32 on the same operands (lse and out from kernel A), each
  held normwise, ``max |got - want| / max |want|``: 1e-5 in float32 (the
  sums' order), 2^-7 in bf16 (the kernel rounds each gradient to bf16
  once: half a bf16 ulp of the largest element, doubled for the float32
  sums); a planted fault (one head's dk zeroed) reads far above that;
  the bf16 kernels (wgmma) at every head dim they take, with the tails and
  knobs; two launches on the same inputs bit-equal (no atomics);
* the autograd path: the smoke model's loss backed through ``attention``
  on the card gives every attention weight a gradient, equal to the plain
  path's on the CPU within 1e-5 normwise per leaf (float32).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfr  # noqa: E402

pytestmark = pytest.mark.cuda

LSE_TOL = 1e-4
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

SHAPES = [   # b, sq, sk, h, hkv, d, dtype, knobs
    (8, 2048, 2048, 9, 3, 64, torch.bfloat16, dict(causal=True)),
    (2, 1024, 1024, 32, 32, 80, torch.bfloat16, dict(causal=True)),
    # the bf16 kernels' tails and knobs: Sq, Sk not multiples of 64,
    # q_offset, seq_k_valid < Sk, a soft cap, GQA; grok's cap and head dim
    (2, 77, 77, 4, 2, 64, torch.bfloat16,
     dict(causal=True, q_offset=5, seq_k_valid=70, logits_soft_cap=3.0)),
    (2, 77, 90, 4, 2, 64, torch.bfloat16, dict(causal=False)),
    (1, 512, 512, 8, 2, 128, torch.bfloat16,
     dict(causal=True, logits_soft_cap=30.0)),
    (2, 77, 77, 4, 2, 16, torch.float32,
     dict(causal=True, q_offset=5, seq_k_valid=70, logits_soft_cap=3.0)),
    (2, 77, 90, 4, 2, 16, torch.float32, dict(causal=False)),
    (1, 130, 130, 3, 1, 64, torch.float32, dict(causal=True)),
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda", 0)


def _inputs(dev, b, sq, sk, h, hkv, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    return r(b, sq, h, d), r(b, sk, hkv, d), r(b, sk, hkv, d), \
        r(b, sq, h, d)


def normwise(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    map(str, s[:6])) + str(s[6])[-4:])
def test_kernels_a_and_b_match_plain(shape):
    dev = _card()
    b, sq, sk, h, hkv, d, dt, kw = shape
    q, k, v, dout = _inputs(dev, b, sq, sk, h, hkv, d, dt)
    with torch.no_grad():
        out, lse = tfa.flash_attention_lse(q, k, v, **kw)
        serve = tfa.flash_attention(q, k, v, **kw)
        assert torch.equal(out, serve)
        f32 = [t.float() for t in (q, k, v)]
        _, lse_ref = tfr.blocked_fwd_ref(*f32, blk_q=min(256, sq),
                                         blk_k=min(1024, sk), **kw)
        assert float((lse - lse_ref).abs().max()) <= LSE_TOL
        dq, dk, dv = tfa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        again = tfa.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = tfr.blocked_bwd_ref(*f32, out.float(), lse, dout.float(),
                                   blk_q=min(256, sq), blk_k=min(1024, sk),
                                   **kw)
    torch.cuda.synchronize()
    for name, got, w, rep in zip(("dq", "dk", "dv"), (dq, dk, dv), want,
                                 again):
        assert torch.equal(got, rep), name      # no atomics
        assert got.dtype == dt
        err = normwise(got, w)
        assert err <= GRAD_TOL[dt], (name, err)
    bad = dk.clone()
    bad[:, :, 0] = 0
    assert normwise(bad, want[1]) > 10 * GRAD_TOL[dt]


def test_attention_on_the_card_gives_gradients():
    dev = _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import transformer as T
    from repro_torch.models.base import tree_to
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config("smollm-135m")
    params = T.init(cfg, seed=0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        cfg, DataConfig(batch_size=2, seq_len=40), 0).items()}
    before = tfa.launches["flash_attention_bwd"]
    (loss, _), grads = value_and_grad(
        lambda p: T.loss_fn(cfg, p, tree_to(batch, dev)),
        tree_to(params, dev))
    torch.cuda.synchronize()
    assert tfa.launches["flash_attention_bwd"] - before == cfg.n_layers
    (loss_c, _), grads_c = value_and_grad(
        lambda p: T.loss_fn(cfg, p, batch), params)
    assert abs(float(loss) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for name in ("wq", "wk", "wv", "wo"):
        g = grads["layers"]["attn"][name]
        assert g is not None and float(g.abs().max()) > 0
        assert normwise(g.cpu(), grads_c["layers"]["attn"][name]) <= 1e-5
