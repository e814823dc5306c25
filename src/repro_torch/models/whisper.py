"""Whisper-style encoder-decoder (arXiv:2212.04356), transformer backbone.

The PyTorch counterpart of ``repro.models.whisper``.  The conv audio
frontend is a stub: callers pass precomputed frame embeddings ``[B,
enc_seq, D]``.  Encoder: bidirectional transformer with sinusoidal
positions; decoder: causal transformer with learned positions and
cross-attention; LayerNorm, GELU, pre-LN, tied decoder embeddings.

Attention: every multi-row attention runs the flash kernel (K4) through
``layers.attention`` (the encoder's and the cross attention's without a
mask, the decoder prefill's causal); the decoder's one-token
self-attention runs the flash-decode kernel (K3) on one layer's slice of
the cache, read in place; its one-token cross attention, which has no
mask, goes to ``sdpa`` as in the JAX package.  The cache holds the
decoder's self K/V and the cross K/V of the encoder output, written in
place by ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

import math
import sys

import torch

from repro_torch.models import layers as L
from repro_torch.models.base import (ModelConfig, register_family,
                                     stack_layers, tree_to)
from repro_torch.models.transformer import layer_params
from repro_torch.parallel.sharding import prefix_axes
from repro_torch.search.api import resolve_device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _ln(cfg: ModelConfig, d=None):
    d = d or cfg.d_model
    return {"scale": torch.ones((d,), dtype=cfg.jdtype),
            "bias": torch.zeros((d,), dtype=cfg.jdtype)}


def _init_enc_block(cfg: ModelConfig, gen):
    return {"ln1": _ln(cfg), "attn": L.init_gqa(cfg, gen),
            "ln2": _ln(cfg), "mlp": L.init_mlp(cfg, gen)}


def _init_dec_block(cfg: ModelConfig, gen):
    return {"ln1": _ln(cfg), "self_attn": L.init_gqa(cfg, gen),
            "ln_x": _ln(cfg), "cross_attn": L.init_gqa(cfg, gen),
            "ln2": _ln(cfg), "mlp": L.init_mlp(cfg, gen)}


def init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights with the JAX ``init``'s tree, dtypes and scales, drawn
    from a ``torch.Generator`` on the CPU seeded with ``seed`` and placed on
    ``device`` (``cuda:0`` by default; raises without a card unless asked
    for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.jdtype
    params = {
        "embed": {"tok": L.embed_init(gen, (cfg.vocab_size, cfg.d_model),
                                      dt)},
        "pos_dec": L.embed_init(gen, (cfg.max_seq, cfg.d_model), dt),
        "enc_layers": stack_layers(cfg.n_enc_layers,
                                   lambda: _init_enc_block(cfg, gen)),
        "ln_enc": _ln(cfg),
        "dec_layers": stack_layers(cfg.n_layers,
                                   lambda: _init_dec_block(cfg, gen)),
        "ln_dec": _ln(cfg),
    }
    return tree_to(params, dev)


def param_axes(cfg: ModelConfig):
    """Logical-axis names, same tree structure as ``init()`` (the JAX
    ``param_axes``)."""
    ln = {"scale": (None,), "bias": (None,)}
    attn = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
            "wv": ("embed", "kv"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        attn.update({"bq": ("heads",), "bk": ("kv",), "bv": ("kv",)})
    mlp = {"wi": ("embed", "mlp"), "bi": ("mlp",), "wo": ("mlp", "embed"),
           "bo": ("embed",)}
    enc_blk = {"ln1": dict(ln), "attn": dict(attn), "ln2": dict(ln),
               "mlp": dict(mlp)}
    dec_blk = {"ln1": dict(ln), "self_attn": dict(attn), "ln_x": dict(ln),
               "cross_attn": dict(attn), "ln2": dict(ln), "mlp": dict(mlp)}
    return {"embed": {"tok": ("vocab", "embed")}, "pos_dec": (None, "embed"),
            "enc_layers": prefix_axes(enc_blk), "ln_enc": dict(ln),
            "dec_layers": prefix_axes(dec_blk), "ln_dec": dict(ln)}


def _layer(params, stack: str, i: int):
    """Layer ``i``'s slice (views) of the stacked ``params[stack]``."""
    return layer_params({"layers": params[stack]}, i)


def _layernorm(x, p):
    return L.layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _sinusoid(length: int, d: int, dtype, device=None):
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


def _enc_block(cfg: ModelConfig, lp, x):
    b, s, _ = x.shape
    h = _layernorm(x, lp["ln1"])
    q, k, v = L.gqa_project_qkv(cfg, lp["attn"], h)
    a = L.attention(cfg, q, k, v, causal=False)
    x = x + a.reshape(b, s, -1) @ lp["attn"]["wo"]
    h = _layernorm(x, lp["ln2"])
    return x + L.apply_mlp(cfg, lp["mlp"], h)


def _remat(cfg: ModelConfig) -> bool:
    """Whether the blocks run in ``torch.utils.checkpoint``: under grad
    mode with ``cfg.remat``, as the JAX ``encode`` / ``decode_states``
    checkpoint their scan bodies."""
    return cfg.remat and torch.is_grad_enabled()


def encode(cfg: ModelConfig, params, frames):
    """frames ``[B, enc_seq, D]`` (stub conv output) -> encoder states."""
    from torch.utils.checkpoint import checkpoint
    b, s, d = frames.shape
    x = frames + _sinusoid(s, d, frames.dtype, frames.device)[None]
    remat = _remat(cfg)
    for i in range(cfg.n_enc_layers):
        lp = _layer(params, "enc_layers", i)
        x = checkpoint(_enc_block, cfg, lp, x, use_reentrant=False) \
            if remat else _enc_block(cfg, lp, x)
    return _layernorm(x, params["ln_enc"])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def _dec_block(cfg: ModelConfig, lp, x, enc, *, self_kv=None, pos=None,
               kv_valid_len=None):
    """Full sequence (``self_kv`` None) or one cached token per row:
    ``self_kv = (k, v)`` are the layer's cache slices ``[B, S, Hkv, D]``,
    whose rows at ``pos`` are written in place.  ``enc`` is the encoder
    output, or the precomputed cross ``(k, v)``.  Returns ``(x, the self
    attention's new (k, v), the cross attention's (k, v))``."""
    b, s, _ = x.shape
    h = _layernorm(x, lp["ln1"])
    q, k, v = L.gqa_project_qkv(cfg, lp["self_attn"], h)
    if self_kv is not None:
        ck, cv = self_kv
        rows, posl = torch.arange(b, device=x.device), pos.long()
        ck[rows, posl] = k[:, 0].to(ck.dtype)
        cv[rows, posl] = v[:, 0].to(cv.dtype)
        a = L.attention(cfg, q, ck, cv, causal=False,
                        kv_valid_len=kv_valid_len)
    else:
        a = L.attention(cfg, q, k, v, causal=True)
    x = x + a.reshape(b, s, -1) @ lp["self_attn"]["wo"]
    h = _layernorm(x, lp["ln_x"])
    if isinstance(enc, tuple):                       # precomputed cross k, v
        qx = h @ lp["cross_attn"]["wq"]
        if "bq" in lp["cross_attn"]:
            qx = qx + lp["cross_attn"]["bq"]
        qx = qx.reshape(b, s, cfg.n_heads, cfg.head_dim)
        kx, vx = enc
    else:
        qx, kx, vx = _cross_qkv(cfg, lp["cross_attn"], h, enc)
    a = L.attention(cfg, qx, kx, vx, causal=False)
    x = x + a.reshape(b, s, -1) @ lp["cross_attn"]["wo"]
    h = _layernorm(x, lp["ln2"])
    return x + L.apply_mlp(cfg, lp["mlp"], h), (k, v), (kx, vx)


def _cross_qkv(cfg: ModelConfig, p, x, enc):
    b, s, _ = x.shape
    se = enc.shape[1]
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (enc @ p["wk"]).reshape(b, se, cfg.kv_heads, cfg.head_dim)
    v = (enc @ p["wv"]).reshape(b, se, cfg.kv_heads, cfg.head_dim)
    if "bq" in p:
        q = q + p["bq"].reshape(cfg.n_heads, cfg.head_dim)
        k = k + p["bk"].reshape(cfg.kv_heads, cfg.head_dim)
        v = v + p["bv"].reshape(cfg.kv_heads, cfg.head_dim)
    return q, k, v


def _embed_dec(params, tokens, positions):
    return params["embed"]["tok"][tokens.long()] \
        + params["pos_dec"][positions.long()]


def _dec_block_out(cfg: ModelConfig, lp, x, enc):
    return _dec_block(cfg, lp, x, enc)[0]


def decode_states(cfg: ModelConfig, params, tokens, enc, positions=None):
    from torch.utils.checkpoint import checkpoint
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    x = _embed_dec(params, tokens, positions)
    remat = _remat(cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params, "dec_layers", i)
        x = checkpoint(_dec_block_out, cfg, lp, x, enc, use_reentrant=False) \
            if remat else _dec_block_out(cfg, lp, x, enc)
    return _layernorm(x, params["ln_dec"])


def loss_fn(cfg: ModelConfig, params, batch, rng=None):
    """Mean next-token cross-entropy of ``batch`` (``frames [B, enc_seq,
    D]`` in the model's dtype, ``tokens``, ``labels``, optional ``mask``)
    -> ``(loss, {"loss": loss})``; tied head.  Under grad the encoder's and
    the cross attention's K4 run non-causal through
    ``layers.blocked_attention`` (kernels A / B), the decoder's causal."""
    enc = encode(cfg, params, batch["frames"].to(cfg.jdtype))
    x = decode_states(cfg, params, batch["tokens"], enc)
    loss = L.chunked_softmax_xent(cfg, params["embed"], x, batch["labels"],
                                  batch.get("mask"))
    return loss, {"loss": loss}


def logits_fn(cfg: ModelConfig, params, tokens, frames):
    enc = encode(cfg, params, frames)
    x = decode_states(cfg, params, tokens, enc)
    return x @ params["embed"]["tok"].T          # tied head


# ---------------------------------------------------------------------------
# inference (cache: decoder self-attn KV + precomputed cross KV)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """Zero ``{k, v: [L, B, max_seq, Hkv, D], xk, xv: [L, B, enc_seq, Hkv,
    D], pos: [B] i32}`` on ``device`` (``cuda:0`` by default)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.jdtype
    kv = (cfg.n_layers, batch_size, max_seq, cfg.kv_heads, cfg.head_dim)
    xkv = (cfg.n_layers, batch_size, cfg.enc_seq, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=dtype, device=dev),
            "v": torch.zeros(kv, dtype=dtype, device=dev),
            "xk": torch.zeros(xkv, dtype=dtype, device=dev),
            "xv": torch.zeros(xkv, dtype=dtype, device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=dev)}


def cache_axes(cfg: ModelConfig):
    """Logical axes of ``init_cache``'s tree (the JAX ``cache_axes``)."""
    return {"k": ("layers", "batch", "kv_seq", "kv", None),
            "v": ("layers", "batch", "kv_seq", "kv", None),
            "xk": ("layers", "batch", None, "kv", None),
            "xv": ("layers", "batch", None, "kv", None),
            "pos": ("batch",)}


def prefill(cfg: ModelConfig, params, batch, cache):
    """batch ``{frames [B, enc_seq, D], tokens [B, S]}`` -> (last logits
    ``[B, 1, V]``, cache): the decoder's K/V go into positions ``[0, S)``
    and the cross K/V fill ``xk`` / ``xv``, in place."""
    frames, tokens = batch["frames"], batch["tokens"]
    b, s = tokens.shape
    enc = encode(cfg, params, frames)
    x = _embed_dec(params, tokens, torch.arange(s, device=tokens.device))
    for i in range(cfg.n_layers):
        x, (k, v), (kx, vx) = _dec_block(
            cfg, _layer(params, "dec_layers", i), x, enc)
        cache["k"][i, :, :s] = k.to(cache["k"].dtype)
        cache["v"][i, :, :s] = v.to(cache["v"].dtype)
        cache["xk"][i] = kx.to(cache["xk"].dtype)
        cache["xv"][i] = vx.to(cache["xv"].dtype)
    out = dict(cache)
    out["pos"] = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    x = _layernorm(x, params["ln_dec"])
    return x[:, -1:] @ params["embed"]["tok"].T, out


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """``tokens [B, 1]`` -> (logits ``[B, 1, V]``, cache): each row appends
    its token at its own ``pos``, written into the cache in place."""
    pos = cache["pos"]
    torch._assert_async((pos < cache["k"].shape[2]).all(),
                        "decode_step: pos beyond the cache")
    x = _embed_dec(params, tokens, pos[:, None])
    for i in range(cfg.n_layers):
        x, _, _ = _dec_block(
            cfg, _layer(params, "dec_layers", i), x,
            (cache["xk"][i], cache["xv"][i]),
            self_kv=(cache["k"][i], cache["v"][i]), pos=pos,
            kv_valid_len=pos + 1)
    out = dict(cache)
    out["pos"] = pos + 1
    x = _layernorm(x, params["ln_dec"])
    return x @ params["embed"]["tok"].T, out


register_family("whisper")(sys.modules[__name__])
