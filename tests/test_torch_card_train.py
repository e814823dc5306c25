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
  the bf16 kernels (wgmma) at every head dim they take, MLA's (192, 128)
  with tails, with the tails and knobs; two launches on the same inputs
  bit-equal (no atomics);
* the autograd path: the smoke model's loss backed through ``attention``
  on the card gives every attention weight a gradient, equal to the plain
  path's on the CPU within 1e-5 normwise per leaf (float32);
* the K5 / K6 backward kernels (``csrc/rwkv6_chunk_bwd.cu``,
  ``ssm_chunk_bwd.cu``) against ``wkv6_bwd_ref`` / ``ssd_bwd_ref`` run in
  float32 on the same operands and the saved chunk states of the forward
  kernel, at T not a multiple of 64 with a non-zero entering state, in
  bf16 (the chunked forward) and float32 (the sequential one), K5 with
  decays down to 1e-20, K6 on strided slices: normwise within the limits
  above, a planted fault far above, two launches bit-equal;
* the rwkv6, zamba2, VLM, Whisper and MoE (deepseek-v2-lite) smoke
  losses: gradients on the card (the scans' Functions, kernels A / B)
  equal the CPU's within 1e-5 normwise per leaf, and each card step
  launches the kernels its path implies.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as tfa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as tfr  # noqa: E402

pytestmark = pytest.mark.cuda

LSE_TOL = 1e-4
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}

SHAPES = [   # b, sq, sk, h, hkv, d, dtype, knobs[, v head dim]
    (8, 2048, 2048, 9, 3, 64, torch.bfloat16, dict(causal=True)),
    # MLA's (192, 128) on the two-warpgroup dK / dV kernel, with tails
    (1, 300, 300, 4, 4, 192, torch.bfloat16, dict(causal=True), 128),
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


def _inputs(dev, b, sq, sk, h, hkv, d, dtype, seed=0, dv=None):
    dv = dv or d
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    return r(b, sq, h, d), r(b, sk, hkv, d), r(b, sk, hkv, dv), \
        r(b, sq, h, dv)


def normwise(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    map(str, s[:6])) + "".join(f"-dv{x}" for x in s[8:]) + str(s[6])[-4:])
def test_kernels_a_and_b_match_plain(shape):
    dev = _card()
    b, sq, sk, h, hkv, d, dt, kw = shape[:8]
    q, k, v, dout = _inputs(dev, b, sq, sk, h, hkv, d, dt,
                            dv=shape[8] if len(shape) > 8 else None)
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


SCAN_SHAPES = [   # kind, b, t, h, n (K5) or p (K6), n (K6), dtype
    ("wkv6", 2, 130, 4, 64, None, torch.bfloat16),
    ("wkv6", 2, 130, 4, 64, None, torch.float32),
    ("wkv6", 1, 70, 3, 8, None, torch.float32),
    ("ssd", 2, 130, 4, 64, 64, torch.bfloat16),
    ("ssd", 2, 130, 4, 64, 64, torch.float32),
    ("ssd", 1, 70, 3, 8, 5, torch.float32),
]


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=lambda s: "x".join(
    str(x) for x in s[:6] if x is not None) + "-" + str(s[6])[6:])
def test_scan_backward_kernels_match_plain(shape):
    import torch.nn.functional as F
    from repro_torch.kernels.rwkv6_scan import ops as twk
    from repro_torch.kernels.ssm_scan import ops as tss
    dev = _card()
    kind, b, t, h, c, n, dt = shape
    gen = torch.Generator(dev).manual_seed(3)
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa
    if kind == "wkv6":
        w = torch.exp(-torch.exp(rnd(b, t, h, c)))
        w[:, 3:9] = 1e-20
        args = ((rnd(b, t, h, c).to(dt), rnd(b, t, h, c).to(dt),
                 rnd(b, t, h, c).to(dt), w, rnd(h, c).to(dt)),
                rnd(b, h, c, c))
        mod, plain, sd = twk, twk.R.wkv6_bwd_ref, (b, h, c, c)
    else:
        xbc = rnd(b, t, h * c + 2 * n).to(dt)
        args = ((xbc[..., :h * c].reshape(b, t, h, c),
                 F.softplus(rnd(b, t, h) - 1), -torch.exp(0.5 * rnd(h)),
                 xbc[..., h * c:h * c + n], xbc[..., h * c + n:], rnd(h)),
                rnd(b, h, c, n))
        mod, plain, sd = tss, tss.R.ssd_bwd_ref, (b, h, c, n)
    ops_in, s0 = args
    dy, ds = rnd(b, t, h, c).to(dt), rnd(*sd)
    _, _, states = mod._forward(*ops_in, s0, keep=True)
    got = mod.launch_bwd(*ops_in, states, dy, ds)
    again = mod.launch_bwd(*ops_in, states, dy, ds)
    want = plain(*(z.float() for z in ops_in), states, dy.float(), ds)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert normwise(g, w_) <= GRAD_TOL[dt]
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    bad = got[1].clone()
    bad[:, :, 0] = 0
    assert normwise(bad, want[1]) > 10 * GRAD_TOL[dt]


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_ssd_backward_head_groups_match_plain(group, dt):
    """``ssd_bwd_kernel`` with 1, 2 and 4 heads a block (ragged T, x / B /
    C slices of one tensor) against ``ssd_bwd_ref``: the same gradients
    within GRAD_TOL, and dB / dC bit-equal across two launches."""
    import torch.nn.functional as F
    from repro_torch.kernels.ssm_scan import ops as tss
    dev = _card()
    b, t, h, p, n = (2, 130, 4, 64, 64) if dt == torch.bfloat16 \
        else (1, 70, 4, 8, 5)
    gen = torch.Generator(dev).manual_seed(5)
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa
    xbc = rnd(b, t, h * p + 2 * n).to(dt)
    ops_in = (xbc[..., :h * p].reshape(b, t, h, p),
              F.softplus(rnd(b, t, h) - 1), -torch.exp(0.5 * rnd(h)),
              xbc[..., h * p:h * p + n], xbc[..., h * p + n:], rnd(h))
    dy, ds = rnd(b, t, h, p).to(dt), rnd(b, h, p, n)
    _, _, states = tss._forward(*ops_in, rnd(b, h, p, n), keep=True)
    got = tss.launch_bwd(*ops_in, states, dy, ds, group=group)
    again = tss.launch_bwd(*ops_in, states, dy, ds, group=group)
    want = tss.R.ssd_bwd_ref(*(z.float() for z in ops_in), states,
                             dy.float(), ds)
    torch.cuda.synchronize()
    for g, w_ in zip(got, want):
        assert normwise(g, w_) <= GRAD_TOL[dt]
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-1.2b",
                                  "internvl2-2b", "whisper-base",
                                  "deepseek-v2-lite-16b"])
def test_family_losses_on_the_card_match_the_cpu(arch):
    dev = _card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.kernels.rwkv6_scan import ops as twk
    from repro_torch.kernels.ssm_scan import ops as tss
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.base import get_family, tree_to
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke_config(arch)
    fam = get_family(cfg)
    params = fam.init(cfg, seed=0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        cfg, DataConfig(batch_size=2, seq_len=40), 0).items()}
    counters = (tfa.launches, twk.launches, tss.launches)
    before = [dict(c) for c in counters]
    (loss, _), grads = value_and_grad(
        lambda p: fam.loss_fn(cfg, p, tree_to(batch, dev)),
        tree_to(params, dev))
    torch.cuda.synchronize()
    moved = {k: c[k] - b[k] for c, b in zip(counters, before) for k in c
             if c[k] != b[k]}
    bwd = {"rwkv6": "wkv6_bwd", "zamba2": "ssd_bwd"}.get(
        cfg.family, "flash_attention_bwd")
    assert moved.get(bwd, 0) > 0
    (loss_c, _), grads_c = value_and_grad(
        lambda p: fam.loss_fn(cfg, p, batch), params)
    assert abs(float(loss) - float(loss_c)) <= 1e-5 * abs(float(loss_c))

    def leaves(t, path=()):
        if isinstance(t, dict):
            for k in sorted(t):
                yield from leaves(t[k], path + (k,))
        elif isinstance(t, list):
            for i, x in enumerate(t):
                yield from leaves(x, path + (i,))
        else:
            yield path, t
    for (path, g), (_, gc) in zip(leaves(grads), leaves(grads_c)):
        if path[-1] == "bk":          # an exactly zero gradient: noise
            continue
        if float(gc.abs().max()) > 0:
            assert normwise(g.cpu(), gc) <= 1e-5, path
