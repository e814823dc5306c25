"""Zamba2 hybrid (arXiv:2411.15242): Mamba-2 backbone + shared attention.

The PyTorch counterpart of ``repro.models.zamba2``:

* ``cfg.n_layers`` Mamba-2 (SSD) blocks at width D, each running the SSD
  kernel (K6) through ``kernels.ssm_scan.ops.ssd``;
* one **shared** transformer block (attention + MLP) at width 2D, applied
  after every ``cfg.shared_attn_every`` Mamba blocks on ``concat(hidden,
  embed0)`` with per-application LoRA deltas on the QKV projections,
  projected back to D.  Its attention goes through ``layers.attention``:
  the flash kernel (K4) on sequences, the flash-decode kernel (K3) on
  decode steps;
* decode state: per-block conv and SSD states (O(1) in context) plus one
  KV cache per shared-block application.

Per-layer Mamba weights are stacked on a leading ``[L]`` axis; Python
loops take the place of ``lax.scan``.  ``prefill`` and ``decode_step``
write the shared block's K/V rows into ``cache["k"]`` / ``cache["v"]`` IN
PLACE and return those tensors in the new cache.  The family has no
``prefill_fn`` / ``step_fn``: MCTS decode takes the generic fallback of
``models.base``.  ``loss_fn`` trains it: under grad K6 runs its autograd
Function (backward ``csrc/ssm_chunk_bwd.cu``) and the shared attention
``layers.blocked_attention`` (kernels A / B).
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_scan import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.models.base import (ModelConfig, register_family,
                                     stack_layers, tree_to)
from repro_torch.models.transformer import layer_params
from repro_torch.parallel.sharding import prefix_axes
from repro_torch.search.api import resolve_device

LORA_RANK = 64


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    h_ssm = d_inner // cfg.ssm_head_dim
    d_conv = d_inner + 2 * cfg.ssm_state          # conv covers x, B, C
    return d_inner, h_ssm, d_conv


def _n_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_mamba_block(cfg: ModelConfig, gen):
    d = cfg.d_model
    d_inner, h_ssm, d_conv = _dims(cfg)
    n = cfg.ssm_state
    dt = cfg.jdtype
    return {
        "norm": {"scale": torch.ones((d,), dtype=dt)},
        "in_proj": L.dense_init(gen, (d, 2 * d_inner + 2 * n + h_ssm), dt),
        "conv_w": L.dense_init(gen, (cfg.ssm_conv_width, d_conv), dt),
        "conv_b": torch.zeros((d_conv,), dtype=dt),
        "dt_bias": torch.zeros((h_ssm,), dtype=dt),
        "A_log": torch.zeros((h_ssm,), dtype=torch.float32),  # A=-exp(A_log)
        "D": torch.ones((h_ssm,), dtype=torch.float32),
        "gate_norm": {"scale": torch.ones((d_inner,), dtype=dt)},
        "out_proj": L.dense_init(gen, (d_inner, d), dt),
    }


def _init_shared_block(cfg: ModelConfig, gen):
    d2 = 2 * cfg.d_model
    h, hd = cfg.n_heads, cfg.head_dim                     # at width 2D
    dt = cfg.jdtype
    napps = _n_apps(cfg)
    return {
        "ln1": {"scale": torch.ones((d2,), dtype=dt)},
        "wq": L.dense_init(gen, (d2, h * hd), dt),
        "wk": L.dense_init(gen, (d2, cfg.kv_heads * hd), dt),
        "wv": L.dense_init(gen, (d2, cfg.kv_heads * hd), dt),
        "wo": L.dense_init(gen, (h * hd, d2), dt),
        "lora_a": (torch.randn((napps, 3, d2, LORA_RANK), generator=gen)
                   * 0.02).to(dt),
        "lora_b": torch.zeros((napps, 3, LORA_RANK, h * hd), dtype=dt),
        "ln2": {"scale": torch.ones((d2,), dtype=dt)},
        "mlp": {"wg": L.dense_init(gen, (d2, cfg.d_ff), dt),
                "wu": L.dense_init(gen, (d2, cfg.d_ff), dt),
                "wd": L.dense_init(gen, (cfg.d_ff, d2), dt)},
        "out": L.dense_init(gen, (d2, cfg.d_model), dt),
    }


def init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights with the JAX ``init``'s tree, dtypes and scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on the CPU and
    placed on ``device`` (``cuda:0`` by default; raises without a card
    unless asked for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {"embed": L.init_embed(cfg, gen),
              "mamba": stack_layers(cfg.n_layers,
                                     lambda: _init_mamba_block(cfg, gen)),
              "shared": _init_shared_block(cfg, gen),
              "final_norm": {"scale": torch.ones((cfg.d_model,),
                                                 dtype=cfg.jdtype)}}
    return tree_to(params, dev)


def param_axes(cfg: ModelConfig):
    """Logical-axis names, same tree structure as ``init()`` (the JAX
    ``param_axes``)."""
    mb = {"norm": {"scale": (None,)},
          "in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
          "conv_b": ("mlp",), "dt_bias": (None,), "A_log": (None,),
          "D": (None,), "gate_norm": {"scale": ("mlp",)},
          "out_proj": ("mlp", "embed")}
    sh = {"ln1": {"scale": (None,)},
          "wq": ("embed", "heads"), "wk": ("embed", "kv"),
          "wv": ("embed", "kv"), "wo": ("heads", "embed"),
          "lora_a": (None, None, "embed", None),
          "lora_b": (None, None, None, "heads"),
          "ln2": {"scale": (None,)},
          "mlp": {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
                  "wd": ("mlp", "embed")},
          "out": ("embed", None)}
    emb = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        emb["head"] = ("embed", "vocab")
    return {"embed": emb, "mamba": prefix_axes(mb), "shared": sh,
            "final_norm": {"scale": (None,)}}


# ---------------------------------------------------------------------------
# mamba block forward
# ---------------------------------------------------------------------------
def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv of width W: x ``[B, S, C]``; w ``[W, C]``;
    conv_state ``[B, W - 1, C]`` -> (y ``[B, S, C]``, new conv state)."""
    width = w.shape[0]
    if conv_state is None:
        conv_state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([conv_state, x], 1)                    # [B, S+W-1, C]
    y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(width)) + b
    new_state = xp[:, -(width - 1):]
    return F.silu(y.float()).to(x.dtype), new_state


def _mamba_block(cfg: ModelConfig, p, x, state):
    """x ``[B, S, D]``; state {conv ``[B, W-1, Cc]``, ssd ``[B, H, P,
    N]``}."""
    b, s, _ = x.shape
    d_inner, h_ssm, d_conv = _dims(cfg)
    n = cfg.ssm_state
    hres = x
    x = L.rmsnorm(x, p["norm"]["scale"])
    proj = x @ p["in_proj"]
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: d_inner + d_conv]
    dt_raw = proj[..., d_inner + d_conv:]
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state["conv"])
    xs = xbc[..., :d_inner].reshape(b, s, h_ssm, cfg.ssm_head_dim)
    bm = xbc[..., d_inner: d_inner + n]
    cm = xbc[..., d_inner + n:]
    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"].float(),
                         torch.zeros((), device=x.device))   # softplus
    a = -torch.exp(p["A_log"])
    y, new_ssd = ssd_ops.ssd(xs, dt, a, bm, cm, p["D"], state["ssd"])
    y = y.reshape(b, s, d_inner)
    y = L.rmsnorm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"]["scale"])
    return hres + y @ p["out_proj"], {"conv": new_conv, "ssd": new_ssd}


def init_mamba_states(cfg: ModelConfig, batch_size: int, device=None):
    """Zero ``{conv [L, B, W-1, Cc], ssd [L, B, H, P, N] f32}``."""
    dev = resolve_device(device)
    _, h_ssm, d_conv = _dims(cfg)
    lb = (cfg.n_layers, batch_size)
    return {
        "conv": torch.zeros(lb + (cfg.ssm_conv_width - 1, d_conv),
                            dtype=cfg.jdtype, device=dev),
        "ssd": torch.zeros(lb + (h_ssm, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
    }


# ---------------------------------------------------------------------------
# shared attention block (width 2D), per-application LoRA
# ---------------------------------------------------------------------------
def _shared_qkv(cfg: ModelConfig, p, h2, app_idx: int):
    b, s, _ = h2.shape
    hn, hkv, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    la, lb = p["lora_a"][app_idx], p["lora_b"][app_idx]  # [3,2D,r],[3,r,H*hd]
    q = h2 @ p["wq"] + (h2 @ la[0]) @ lb[0]
    k = h2 @ p["wk"] + ((h2 @ la[1]) @ lb[1])[..., : hkv * hd]
    v = h2 @ p["wv"] + ((h2 @ la[2]) @ lb[2])[..., : hkv * hd]
    return (q.reshape(b, s, hn, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def _shared_block(cfg: ModelConfig, p, h, emb0, app_idx: int, *, positions,
                  cache_kv=None, pos=None, kv_valid_len=None):
    """h, emb0 ``[B, S, D]`` -> (delta ``[B, S, D]``, K/V).  With
    ``cache_kv`` (one query row per sequence) the new K/V row goes into
    the caches at ``pos`` in place and attention reads ``kv_valid_len``
    keys of them; without, attention is causal over the sequence and the
    sequence's K/V come back."""
    b, s, _ = h.shape
    x2 = torch.cat([h, emb0], -1)                         # [B, S, 2D]
    y = L.rmsnorm(x2, p["ln1"]["scale"])
    q, k, v = _shared_qkv(cfg, p, y, app_idx)
    cos, sin = L.rope_freqs(cfg, positions)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    if cache_kv is not None:
        ck, cv = cache_kv
        rows = torch.arange(b, device=h.device)
        ck[rows, pos.long()] = k[:, 0].to(ck.dtype)
        cv[rows, pos.long()] = v[:, 0].to(cv.dtype)
        new_kv = (ck, cv)
        attn = L.attention(cfg, q, ck, cv, causal=False,
                           kv_valid_len=kv_valid_len)
    else:
        new_kv = (k, v)          # full-sequence K/V (prefill collects them)
        attn = L.attention(cfg, q, k, v, causal=True)
    x2 = x2 + attn.reshape(b, s, -1) @ p["wo"]
    y = L.rmsnorm(x2, p["ln2"]["scale"])
    x2 = x2 + L.apply_mlp(cfg, p["mlp"], y)
    return x2 @ p["out"], new_kv


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------
def _segments(cfg: ModelConfig):
    """[(start, end, application index or None)] covering the blocks."""
    segs = []
    step = cfg.shared_attn_every
    i = 0
    app = 0
    while i < cfg.n_layers:
        j = min(i + step, cfg.n_layers)
        has_app = (j - i == step) and (app < _n_apps(cfg))
        segs.append((i, j, app if has_app else None))
        if has_app:
            app += 1
        i = j
    return segs


def _mamba_params(params, i: int):
    return layer_params({"layers": params["mamba"]}, i)


def _run(cfg: ModelConfig, params, x, emb0, states, *, positions,
         shared_caches=None, pos=None, kv_valid_len=None):
    """states: stacked Mamba states; shared_caches: {k, v} ``[n_apps,
    ...]`` or None.  Returns (x, new stacked states, per-application
    K/V).  Under grad mode with ``cfg.remat`` each Mamba block of a
    segment runs in ``torch.utils.checkpoint`` (non-reentrant), as the JAX
    ``_run``'s segment scan checkpoints its body: K6's forward runs twice
    a block and its backward once; the shared attention is not
    checkpointed."""
    from torch.utils.checkpoint import checkpoint
    remat = cfg.remat and torch.is_grad_enabled()
    new_states = {"conv": [], "ssd": []}
    new_shared = []
    for lo, hi, app in _segments(cfg):
        for i in range(lo, hi):
            args = (cfg, _mamba_params(params, i), x,
                    {k: states[k][i] for k in new_states})
            x, st = checkpoint(_mamba_block, *args, use_reentrant=False) \
                if remat else _mamba_block(*args)
            for k in new_states:
                new_states[k].append(st[k])
        if app is not None:
            ckv = None if shared_caches is None else \
                (shared_caches["k"][app], shared_caches["v"][app])
            delta, kv = _shared_block(
                cfg, params["shared"], x, emb0, app, positions=positions,
                cache_kv=ckv, pos=pos, kv_valid_len=kv_valid_len)
            new_shared.append(kv)
            x = x + delta
    return x, {k: torch.stack(v) for k, v in new_states.items()}, new_shared


def hidden_states(cfg: ModelConfig, params, tokens, states=None):
    """``tokens [B, S]`` -> (final hidden ``[B, S, D]``, new Mamba
    states)."""
    b, s = tokens.shape
    emb0 = L.embed_tokens(cfg, params["embed"], tokens)
    if states is None:
        states = init_mamba_states(cfg, b, device=tokens.device)
    x, new_states, _ = _run(cfg, params, emb0, emb0, states,
                            positions=torch.arange(s, device=tokens.device))
    return L.rmsnorm(x, params["final_norm"]["scale"]), new_states


def loss_fn(cfg: ModelConfig, params, batch, rng=None):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``mask``, each ``[B, S]``) -> ``(loss, {"loss": loss})``."""
    x, _ = hidden_states(cfg, params, batch["tokens"])
    loss = L.chunked_softmax_xent(cfg, params["embed"], x, batch["labels"],
                                  batch.get("mask"))
    return loss, {"loss": loss}


def logits_fn(cfg: ModelConfig, params, tokens):
    x, _ = hidden_states(cfg, params, tokens)
    return L.lm_head(cfg, params["embed"], x)


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """Zero Mamba states plus ``k`` / ``v`` ``[n_apps, B, max_seq, Hkv,
    hd]`` and ``pos [B]`` on ``device`` (``cuda:0`` by default)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.jdtype
    kv = (_n_apps(cfg), batch_size, max_seq, cfg.kv_heads, cfg.head_dim)
    cache = init_mamba_states(cfg, batch_size, device=dev)
    cache.update({"k": torch.zeros(kv, dtype=dtype, device=dev),
                  "v": torch.zeros(kv, dtype=dtype, device=dev),
                  "pos": torch.zeros((batch_size,), dtype=torch.int32,
                                     device=dev)})
    return cache


def cache_axes(cfg: ModelConfig):
    """Logical axes of ``init_cache``'s tree (the JAX ``cache_axes``:
    the shared block's K/V stack its applications, not layers)."""
    return {"conv": ("layers", "batch", None, "mlp"),
            "ssd": ("layers", "batch", "heads", None, None),
            "k": (None, "batch", "kv_seq", "kv", None),
            "v": (None, "batch", "kv_seq", "kv", None),
            "pos": ("batch",)}


def prefill(cfg: ModelConfig, params, tokens, cache):
    """``tokens [B, S]`` -> (logits ``[B, 1, V]`` at the last position,
    cache).  Starts from the cache's Mamba states; writes the prompt's
    K/V into positions ``[0, S)`` of ``cache["k"]`` / ``["v"]`` in
    place."""
    b, s = tokens.shape
    emb0 = L.embed_tokens(cfg, params["embed"], tokens)
    states = {k: cache[k] for k in ("conv", "ssd")}
    x, new_cache, shared_kvs = _run(
        cfg, params, emb0, emb0, states,
        positions=torch.arange(s, device=tokens.device))
    for j, (k, v) in enumerate(shared_kvs):
        cache["k"][j, :, :s] = k.to(cache["k"].dtype)
        cache["v"][j, :, :s] = v.to(cache["v"].dtype)
    new_cache.update(k=cache["k"], v=cache["v"],
                     pos=torch.full((b,), s, dtype=torch.int32,
                                    device=tokens.device))
    x = L.rmsnorm(x, params["final_norm"]["scale"])
    return L.lm_head(cfg, params["embed"], x[:, -1:]), new_cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """``tokens [B, 1]`` -> (logits ``[B, 1, V]``, cache): each row's new
    K/V go in at its own ``pos`` (in place) and attention reads ``pos +
    1`` keys."""
    pos = cache["pos"]
    emb0 = L.embed_tokens(cfg, params["embed"], tokens)
    states = {k: cache[k] for k in ("conv", "ssd")}
    x, new_cache, _ = _run(cfg, params, emb0, emb0, states,
                           positions=pos[:, None],
                           shared_caches={"k": cache["k"], "v": cache["v"]},
                           pos=pos, kv_valid_len=pos + 1)
    new_cache.update(k=cache["k"], v=cache["v"], pos=pos + 1)
    x = L.rmsnorm(x, params["final_norm"]["scale"])
    return L.lm_head(cfg, params["embed"], x), new_cache


register_family("zamba2")(sys.modules[__name__])
