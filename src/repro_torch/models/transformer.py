"""Dense decoder-only transformer family.

The PyTorch counterpart of ``repro.models.transformer``: smollm-135m,
qwen2-0.5b, minicpm-2b and stablelm-3b through ``ModelConfig`` flags (norm
type, partial rotary, qkv bias, residual / logit scaling, GQA widths).
Parameters are a dict of tensors with the JAX package's keys; per-layer
weights are stacked on a leading ``[L]`` axis and a Python loop over the
layers takes the place of ``lax.scan``.

Training: ``loss_fn`` (``hidden_states`` + ``layers.chunked_softmax_xent``)
under autograd, each block rematerialised when ``cfg.remat``; attention
then runs ``layers.blocked_attention`` (the flash kernel with its
logsumexp, and the flash backward kernel).

Attention: the prompt prefill runs the flash kernel (K4) through
``layers.attention``; every incremental token runs the flash-decode kernel
(K3) on one layer's slice of the cache, read in place.  Two decode
interfaces: ``prefill_fn`` / ``step_fn`` over any leading shape (MCTS
decode) and the batched ``init_cache`` / ``prefill`` / ``decode_step``
with a ``[L, B, S, Hkv, D]`` cache (the serving engine's greedy mode).
"""
from __future__ import annotations

import sys

import torch

from repro_torch.models import layers as L
from repro_torch.models.base import (ModelConfig, register_family,
                                     stack_layers, tree_to)
from repro_torch.parallel.sharding import prefix_axes
from repro_torch.search.api import resolve_device


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_block(cfg: ModelConfig, gen):
    return {"ln1": L.init_norm(cfg), "attn": L.init_gqa(cfg, gen),
            "ln2": L.init_norm(cfg), "mlp": L.init_mlp(cfg, gen)}


def init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights with the JAX ``init``'s tree, dtypes and scales
    (``dense_init`` 1/sqrt(fan_in), ``embed_init`` 0.02), drawn from a
    ``torch.Generator`` seeded with ``seed`` on the CPU and placed on
    ``device`` (``cuda:0`` by default; raises without a card unless
    asked for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": L.init_embed(cfg, gen),
              "layers": stack_layers(cfg.n_layers,
                                      lambda: _init_block(cfg, gen)),
              "final_norm": L.init_norm(cfg)}
    return tree_to(params, dev)


def _norm_axes(cfg: ModelConfig):
    return ({"scale": (None,), "bias": (None,)} if cfg.norm == "layernorm"
            else {"scale": (None,)})


def block_axes(cfg: ModelConfig):
    """One block's logical axes (``param_axes`` stacks them)."""
    attn = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
            "wv": ("embed", "kv"), "wo": ("heads", "embed")}
    if cfg.qkv_bias:
        attn.update({"bq": ("heads",), "bk": ("kv",), "bv": ("kv",)})
    mlp = ({"wi": ("embed", "mlp"), "bi": ("mlp",),
            "wo": ("mlp", "embed"), "bo": ("embed",)}
           if cfg.act == "gelu" else
           {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
            "wd": ("mlp", "embed")})
    return {"ln1": _norm_axes(cfg), "attn": attn, "ln2": _norm_axes(cfg),
            "mlp": mlp}


def param_axes(cfg: ModelConfig):
    """Logical-axis names, same tree structure as ``init()`` (the JAX
    ``param_axes``)."""
    emb = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        emb["head"] = ("embed", "vocab")
    return {"embed": emb, "layers": prefix_axes(block_axes(cfg)),
            "final_norm": _norm_axes(cfg)}


def layer_params(params, i: int):
    """Layer ``i``'s slice of the stacked ``params["layers"]`` (views)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


def unstack_layers(params, n: int) -> list:
    """The ``n`` layers' parameter dicts of ``params["layers"]``, each
    stacked leaf split once by ``unbind(0)``: under autograd the backward
    then stacks each leaf's gradient once, where indexing layer by layer
    would add a full-size zero gradient per layer and leaf."""
    def split(t):
        if isinstance(t, dict):
            parts = {k: split(v) for k, v in t.items()}
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return t.unbind(0)
    return split(params["layers"])


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _block(cfg: ModelConfig, p, x, cos, sin):
    """One causal transformer block over ``x [B, S, d]``; returns
    ``(x, k, v)`` with the block's rotated keys and values."""
    h = L.apply_norm(cfg, p["ln1"], x)
    q, k, v = L.gqa_project_qkv(cfg, p["attn"], h)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    attn = L.attention(cfg, q, k, v, causal=True)
    x = x + (attn.flatten(-2) @ p["attn"]["wo"]) * cfg.residual_scale
    h = L.apply_norm(cfg, p["ln2"], x)
    return x + L.apply_mlp(cfg, p["mlp"], h) * cfg.residual_scale, k, v


def _block_out(cfg: ModelConfig, p, x, cos, sin):
    return _block(cfg, p, x, cos, sin)[0]


def hidden_states(cfg: ModelConfig, params, tokens=None, inputs_embeds=None,
                  positions=None):
    """Full-sequence forward of ``tokens [B, S]`` or of ``inputs_embeds
    [B, S, d]`` (the VLM's image-then-text sequence) at ``positions``
    (default ``0 .. S-1``) -> final hidden ``[B, S, d]``.  Under grad mode
    with ``cfg.remat`` each block runs in ``torch.utils.checkpoint``
    (non-reentrant): only its input is kept, and the backward recomputes
    the block (the JAX package's ``jax.checkpoint(nothing_saveable)``)."""
    from torch.utils.checkpoint import checkpoint
    x = inputs_embeds if inputs_embeds is not None \
        else L.embed_tokens(cfg, params["embed"], tokens)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    cos, sin = L.rope_freqs(cfg, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    for p in unstack_layers(params, cfg.n_layers):
        x = checkpoint(_block_out, cfg, p, x, cos, sin, use_reentrant=False) \
            if remat else _block_out(cfg, p, x, cos, sin)
    return L.apply_norm(cfg, params["final_norm"], x)


def loss_fn(cfg: ModelConfig, params, batch, rng=None):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``mask``, each ``[B, S]``) -> ``(loss, {"loss": loss})``."""
    x = hidden_states(cfg, params, tokens=batch["tokens"])
    loss = L.chunked_softmax_xent(cfg, params["embed"], x, batch["labels"],
                                  batch.get("mask"))
    return loss, {"loss": loss}


def logits_fn(cfg: ModelConfig, params, tokens):
    return L.lm_head(cfg, params["embed"], hidden_states(cfg, params, tokens))


def _prefill_stack(cfg: ModelConfig, params, tokens):
    """Prompt pass ``tokens [B, S]`` -> (final-normed hidden ``[B, S, d]``,
    cache ``{k, v: [B, L, S, Hkv, D]}``)."""
    b, s = tokens.shape
    x = L.embed_tokens(cfg, params["embed"], tokens)
    cos, sin = L.rope_freqs(cfg, torch.arange(s, device=tokens.device))
    shape = (b, cfg.n_layers, s, cfg.kv_heads, cfg.head_dim)
    ks = torch.empty(shape, dtype=x.dtype, device=x.device)
    vs = torch.empty_like(ks)
    for i in range(cfg.n_layers):
        x, ks[:, i], vs[:, i] = _block(cfg, layer_params(params, i), x, cos,
                                       sin)
    return L.apply_norm(cfg, params["final_norm"], x), {"k": ks, "v": vs}


# ---------------------------------------------------------------------------
# incremental decode over any leading shape (models.base)
# ---------------------------------------------------------------------------
def prefill_fn(cfg: ModelConfig, params, toks, plen):
    """``toks [*lead, S]`` padded buffers with true lengths ``plen
    [*lead]`` -> (logits ``[*lead, V]`` f32 at ``plen - 1``, cache ``{k, v:
    [*lead, L, S, Hkv, D]}``).  Positions ``>= plen`` of the cache hold
    padding K/V, masked by ``step_fn``'s valid length until overwritten."""
    lead, s = toks.shape[:-1], toks.shape[-1]
    x, cache = _prefill_stack(cfg, params, toks.reshape(-1, s))
    last = torch.as_tensor(plen, device=toks.device).expand(lead) \
        .reshape(-1).long() - 1
    h_last = x[torch.arange(x.shape[0], device=x.device), last]
    # lm_head in the activation dtype, then float32, as the JAX package
    logits = L.lm_head(cfg, params["embed"], h_last).float()
    return (logits.reshape(lead + logits.shape[-1:]),
            {k: v.reshape(lead + v.shape[1:]) for k, v in cache.items()})


def step_fn(cfg: ModelConfig, params, cache, tok, pos):
    """One incremental token per row: cache ``{k, v: [*lead, L, S, Hkv,
    D]}``, ``tok`` / ``pos [*lead]`` -> (logits ``[*lead, V]`` f32 for
    ``pos + 1``, cache).  Writes the new K/V row at ``pos`` of ``cache``
    IN PLACE (callers that keep the old state pass a copy); attention reads
    each layer's slice of the cache in place through the decode kernel."""
    from repro_torch.kernels.decode_attention import ops as da
    kc, vc = cache["k"], cache["v"]
    lead = tuple(tok.shape)
    n = int(torch.Size(lead).numel())
    s = kc.shape[-3]
    kf, vf = kc.view((n,) + kc.shape[-4:]), vc.view((n,) + vc.shape[-4:])
    pos = torch.as_tensor(pos, device=kc.device).expand(lead).reshape(n)
    torch._assert_async((pos < s).all(), "step_fn: pos beyond the cache")
    rows = torch.arange(n, device=kc.device)
    posl = pos.long()
    x = L.embed_tokens(cfg, params["embed"], tok.reshape(n, 1))
    cos, sin = L.rope_freqs(cfg, pos.reshape(n, 1))
    valid = (pos + 1).to(torch.int32)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        h = L.apply_norm(cfg, p["ln1"], x)
        q, k, v = L.gqa_project_qkv(cfg, p["attn"], h)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
        kf[rows, i, posl] = k[:, 0].to(kf.dtype)
        vf[rows, i, posl] = v[:, 0].to(vf.dtype)
        attn = da.decode_attention(q, kf[:, i], vf[:, i], valid)
        x = x + (attn.flatten(-2) @ p["attn"]["wo"]) * cfg.residual_scale
        h = L.apply_norm(cfg, p["ln2"], x)
        x = x + L.apply_mlp(cfg, p["mlp"], h) * cfg.residual_scale
    x = L.apply_norm(cfg, params["final_norm"], x)
    logits = L.lm_head(cfg, params["embed"], x)[:, 0].float()
    return logits.reshape(lead + logits.shape[-1:]), cache


# ---------------------------------------------------------------------------
# batched serving decode: prefill + one token per row with a [L, B, ...]
# cache (the serving engine's greedy mode)
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """Zero ``{k, v: [L, B, max_seq, Hkv, D], pos: [B] i32}`` on
    ``device`` (``cuda:0`` by default)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.jdtype
    shape = (cfg.n_layers, batch_size, max_seq, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=dev)}


def cache_axes(cfg: ModelConfig):
    """Logical axes of ``init_cache``'s tree (the JAX ``cache_axes``).
    The searcher's flat carry state ``{"len", "plen", "logits",
    **cache}`` (``convert.py``) holds per-node rows of this cache: its
    ``k`` / ``v`` take these axes with the node rows as ``batch``."""
    return {"k": ("layers", "batch", "kv_seq", "kv", None),
            "v": ("layers", "batch", "kv_seq", "kv", None),
            "pos": ("batch",)}


def prefill(cfg: ModelConfig, params, tokens, cache):
    """``tokens [B, S]`` -> (logits ``[B, 1, V]`` at the last position,
    cache): the prompt's K/V go into positions ``[0, S)`` of
    ``cache["k"]`` / ``["v"]`` in place."""
    b, s = tokens.shape
    x, kv = _prefill_stack(cfg, params, tokens)
    for name in ("k", "v"):
        cache[name][:, :, :s] = kv[name].transpose(0, 1) \
            .to(cache[name].dtype)
    out = {"k": cache["k"], "v": cache["v"],
           "pos": torch.full((b,), s, dtype=torch.int32,
                             device=tokens.device)}
    return L.lm_head(cfg, params["embed"], x[:, -1:]), out


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """``tokens [B, 1]`` -> (logits ``[B, 1, V]`` f32, cache): each row
    appends its token at its own ``pos`` — ``step_fn`` on the batch-major
    view of the ``[L, B, ...]`` cache, written in place."""
    view = {name: cache[name].transpose(0, 1) for name in ("k", "v")}
    logits, _ = step_fn(cfg, params, view, tokens[:, 0], cache["pos"])
    out = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"] + 1}
    return logits[:, None], out


register_family("dense")(sys.modules[__name__])
