"""Shared neural-net building blocks (plain functions over parameter dicts).

The PyTorch counterpart of ``repro.models.layers``: the dense forward and
its training pieces, ``blocked_attention`` (a ``torch.autograd.Function``:
the flash kernel with its logsumexp forward, the flash backward kernel
backward; the JAX package's custom VJP) and ``chunked_softmax_xent``.

Conventions: activations are ``cfg.jdtype``, norms and softmax accumulate
in float32; attention layouts are ``[B, S, H, D]``; per-layer parameters
are stacked on a leading ``layers`` axis.  Initialisers draw from a
``torch.Generator`` on its own device (the dense families pass one on the
CPU, the same weights on every device; the MoE family one on the target
device) with the JAX package's scales.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.base import ModelConfig


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def dense_init(gen, shape, dtype, in_axis: int = 0):
    std = 1.0 / math.sqrt(shape[in_axis])
    return (torch.randn(shape, generator=gen, device=gen.device)
            * std).to(dtype)


def embed_init(gen, shape, dtype, std: float = 0.02):
    return (torch.randn(shape, generator=gen, device=gen.device)
            * std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def init_norm(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((d,), dtype=cfg.jdtype),
                "bias": torch.zeros((d,), dtype=cfg.jdtype)}
    return {"scale": torch.ones((d,), dtype=cfg.jdtype)}


def apply_norm(cfg: ModelConfig, p, x):
    if "bias" in p:
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# rotary position embedding (partial rotary, stablelm-2 style)
# ---------------------------------------------------------------------------
def rope_freqs(cfg: ModelConfig, positions, rot_dim: Optional[int] = None):
    """positions ``[..., S]`` -> (cos, sin), each ``[..., S, rot/2]`` f32."""
    rot = rot_dim or int(cfg.head_dim * cfg.rope_frac)
    rot = max(rot - rot % 2, 2)
    exps = torch.arange(0, rot, 2, dtype=torch.float32,
                        device=positions.device) / rot
    inv = 1.0 / torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x ``[..., S, H, D]``; cos / sin ``[..., S, R/2]`` (broadcast over the
    heads).  Rotates the leading R features of D in the rotate-half
    layout."""
    r2 = cos.shape[-1]
    x1, x2, x_pass = x[..., :r2], x[..., r2:2 * r2], x[..., 2 * r2:]
    c, s = cos.unsqueeze(-2), sin.unsqueeze(-2)
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], -1).to(x.dtype)
    return torch.cat([out, x_pass], -1) if x_pass.shape[-1] else out


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _repeat_kv(k, n_rep: int):
    """``[B, S, Hkv, D]`` -> ``[B, S, Hkv * n_rep, D]``, each kv head
    repeated for its ``n_rep`` query heads."""
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def sdpa(q, k, v, *, causal: bool, q_offset=0, bias=None,
         logits_soft_cap: float = 0.0):
    """Reference scaled-dot-product attention: q ``[B, Sq, H, D]``, k / v
    ``[B, Sk, Hkv, D]``; scores in float32, probabilities cast to q's dtype
    before the product with v, -inf masks."""
    d, h, hkv = q.shape[-1], q.shape[2], k.shape[2]
    k = _repeat_kv(k, h // hkv)
    v = _repeat_kv(v, h // hkv)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(d))
    if logits_soft_cap > 0.0:
        logits = logits_soft_cap * torch.tanh(logits / logits_soft_cap)
    if bias is not None:
        logits = logits + bias
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = logits.masked_fill(~(qpos >= kpos), float("-inf"))
    probs = torch.softmax(logits, -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class _BlockedAttention(torch.autograd.Function):
    """``_blocked_attention_core`` with its custom VJP: the forward keeps
    (q, k, v, out, lse), the backward recomputes p blockwise from them (no
    ``[Sq, Sk]`` matrix is stored).  CUDA tensors run the flash kernel
    with its logsumexp and the flash backward kernels; CPU tensors the
    plain copies of ``_blocked_fwd`` / ``_core_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, blk_q, blk_k, cap):
        from repro_torch.kernels.flash_attention import ops as fa
        kw = dict(causal=causal, q_offset=q_offset, logits_soft_cap=cap,
                  blk_q=blk_q, blk_k=blk_k)
        out, lse = fa.flash_attention_lse(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.flash_attention import ops as fa
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout,
                                            **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def blocked_attention(q, k, v, *, causal: bool, q_offset=0, blk_q=256,
                      blk_k=1024, logits_soft_cap: float = 0.0):
    """Memory-efficient attention with a flash backward: q ``[B, Sq, H,
    D]``, k ``[B, Sk, Hkv, D]``, v ``[B, Sk, Hkv, Dv]`` -> ``[B, Sq, H,
    Dv]``; GQA grouped, no kv-head repetition.  ``blk_q`` / ``blk_k`` are
    the plain version's blocks (the kernels tile for the card)."""
    return _BlockedAttention.apply(q, k, v, causal, int(q_offset),
                                   int(blk_q), int(blk_k),
                                   float(logits_soft_cap))


def attention(cfg: ModelConfig, q, k, v, *, causal: bool, q_offset=0,
              kv_valid_len=None, logits_soft_cap: float = 0.0):
    """Dispatch: for a multi-row query without a valid-length mask,
    ``blocked_attention`` when grad mode is on and q, k or v requires grad
    (training), the flash kernel (K4) otherwise; the flash-decode kernel
    (K3) for one query row against a cache with one; ``sdpa`` otherwise.
    Each kernel wrapper runs its CUDA kernel on CUDA tensors and its plain
    version on the CPU, whatever ``cfg.use_pallas`` / ``cfg.attn_impl``
    say."""
    if kv_valid_len is None and q.shape[1] > 1:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return blocked_attention(q, k, v, causal=causal,
                                     q_offset=q_offset, blk_q=cfg.attn_blk_q,
                                     blk_k=cfg.attn_blk_k,
                                     logits_soft_cap=logits_soft_cap)
        from repro_torch.kernels.flash_attention import ops as fa
        return fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                  logits_soft_cap=logits_soft_cap)
    if q.shape[1] == 1 and kv_valid_len is not None \
            and logits_soft_cap == 0.0:
        from repro_torch.kernels.decode_attention import ops as da
        return da.decode_attention(q, k, v, kv_valid_len)
    bias = None
    if kv_valid_len is not None:
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        keep = kpos < kv_valid_len[:, None]
        bias = torch.where(keep, 0.0, float("-inf"))[:, None, None, :]
    return sdpa(q, k, v, causal=causal, q_offset=q_offset, bias=bias,
                logits_soft_cap=logits_soft_cap)


def init_gqa(cfg: ModelConfig, gen):
    """GQA projection params (qkv biases for qwen2)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    dt = cfg.jdtype
    p = {"wq": dense_init(gen, (d, h * hd), dt),
         "wk": dense_init(gen, (d, hkv * hd), dt),
         "wv": dense_init(gen, (d, hkv * hd), dt),
         "wo": dense_init(gen, (h * hd, d), dt)}
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt)
    return p


def gqa_project_qkv(cfg: ModelConfig, p, x):
    """x ``[..., S, d_model]`` -> q ``[..., S, H, D]``, k / v
    ``[..., S, Hkv, D]``."""
    h, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    lead = x.shape[:-1]
    return (q.reshape(lead + (h, hd)), k.reshape(lead + (hkv, hd)),
            v.reshape(lead + (hkv, hd)))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, gen, d_ff: Optional[int] = None):
    d, f, dt = cfg.d_model, d_ff or cfg.d_ff, cfg.jdtype
    if cfg.act == "gelu":
        return {"wi": dense_init(gen, (d, f), dt),
                "bi": torch.zeros((f,), dtype=dt),
                "wo": dense_init(gen, (f, d), dt),
                "bo": torch.zeros((d,), dtype=dt)}
    return {"wg": dense_init(gen, (d, f), dt),
            "wu": dense_init(gen, (d, f), dt),
            "wd": dense_init(gen, (f, d), dt)}


def apply_mlp(cfg: ModelConfig, p, x):
    if "wi" in p:
        # jax.nn.gelu defaults to the tanh approximation
        hid = F.gelu((x @ p["wi"] + p["bi"]).float(), approximate="tanh")
        return hid.to(x.dtype) @ p["wo"] + p["bo"]
    return (F.silu((x @ p["wg"]).float()).to(x.dtype) * (x @ p["wu"])) \
        @ p["wd"]


# ---------------------------------------------------------------------------
# embedding, head and chunked cross-entropy (never the whole [B, S, V]
# logits in float32 at once)
# ---------------------------------------------------------------------------
def init_embed(cfg: ModelConfig, gen):
    p = {"tok": embed_init(gen, (cfg.vocab_size, cfg.d_model), cfg.jdtype)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                               cfg.jdtype)
    return p


def embed_tokens(cfg: ModelConfig, p, tokens):
    return p["tok"][tokens.long()]


def lm_head(cfg: ModelConfig, p, x):
    """Logits in x's dtype (bf16 on the full-size path; callers cast)."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return (x @ w) * cfg.logit_scale


def _xent_chunk(xc, yc, mc, w, logit_scale: float):
    """One chunk's (sum of masked token losses, sum of the mask)."""
    logits = (xc @ w).float() * logit_scale             # [B, c, V]
    lse = torch.logsumexp(logits, -1)
    tgt = logits.gather(-1, yc.long()[..., None])[..., 0]
    return ((lse - tgt) * mc).sum(), mc.sum()


def chunked_softmax_xent(cfg: ModelConfig, p, x, labels, mask=None):
    """Mean next-token cross-entropy over ``x [B, S, D]`` (pre-head
    hidden), ``labels [B, S]``, ``mask [B, S]`` {0, 1}, in sequence chunks
    of ``cfg.ce_chunk`` (and a remainder chunk).  Under grad each chunk
    runs in ``torch.utils.checkpoint``, so its ``[B, chunk, V]`` float32
    logits are recomputed in the backward and never saved across chunks
    (the JAX package's ``jax.checkpoint(nothing_saveable)``)."""
    from torch.utils.checkpoint import checkpoint
    b, s, _ = x.shape
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    chunk = min(cfg.ce_chunk, s)
    n = s // chunk
    mask = torch.ones((b, s), device=x.device) if mask is None \
        else torch.as_tensor(mask, device=x.device).float()
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if s > n * chunk:
        bounds.append((n * chunk, s))
    remat = torch.is_grad_enabled()
    for lo, hi in bounds:
        args = (x[:, lo:hi], labels[:, lo:hi], mask[:, lo:hi], w,
                cfg.logit_scale)
        l, c = checkpoint(_xent_chunk, *args, use_reentrant=False) \
            if remat else _xent_chunk(*args)
        tot, cnt = tot + l, cnt + c
    return tot / cnt.clamp_min(1.0)
