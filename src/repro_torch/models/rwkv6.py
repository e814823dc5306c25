"""RWKV-6 "Finch" (arXiv:2404.05892) — attention-free RNN LM.

The PyTorch counterpart of ``repro.models.rwkv6``.  Block = TimeMix (the
WKV6 recurrence with a data-dependent per-channel decay through LoRA) +
ChannelMix (squared-ReLU FFN with token shift).  Per-layer weights are
stacked on a leading ``[L]`` axis; a Python loop over the layers takes the
place of ``lax.scan``.

State per layer: the WKV state ``[B, H, N, N]`` float32 and two
token-shift slots ``[B, D]`` (time mix and channel mix).  Decode is O(1)
in the context length.  Every sequence and decode step runs the WKV6 kernel
(K5) through ``kernels.rwkv6_scan.ops.wkv6``: the CUDA kernel on CUDA
tensors, its plain version on the CPU; under grad its autograd Function,
whose backward is ``csrc/rwkv6_chunk_bwd.cu``.  ``loss_fn`` trains it.

The family has no ``prefill_fn`` / ``step_fn``: MCTS decode takes the
generic fallback of ``models.base`` (a full forward per step), and the
serving engine's greedy mode the batched ``init_cache`` / ``prefill`` /
``decode_step``.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models import layers as L
from repro_torch.models.base import (ModelConfig, register_family,
                                     stack_layers, tree_to)
from repro_torch.models.transformer import layer_params
from repro_torch.parallel.sharding import prefix_axes
from repro_torch.search.api import resolve_device


def _heads(cfg: ModelConfig):
    n = cfg.rwkv_head_dim
    return cfg.d_model // n, n


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _ln(d: int, dt):
    return {"scale": torch.ones((d,), dtype=dt),
            "bias": torch.zeros((d,), dtype=dt)}


def _init_block(cfg: ModelConfig, gen):
    d = cfg.d_model
    h, n = _heads(cfg)
    lm, ld = cfg.rwkv_mix_lora, cfg.rwkv_decay_lora
    dt = cfg.jdtype
    tm = {
        "maa_x": torch.zeros((d,), dtype=dt),
        "maa_rkvwg": torch.zeros((5, d), dtype=dt),
        "maa_w1": L.dense_init(gen, (d, 5 * lm), dt),
        "maa_w2": L.dense_init(gen, (5, lm, d), dt, in_axis=1),
        "decay": torch.full((d,), -6.0, dtype=dt),
        "decay_w1": L.dense_init(gen, (d, ld), dt),
        "decay_w2": L.dense_init(gen, (ld, d), dt),
        "faaaa": torch.full((h, n), 0.5, dtype=dt),
        "wr": L.dense_init(gen, (d, d), dt),
        "wk": L.dense_init(gen, (d, d), dt),
        "wv": L.dense_init(gen, (d, d), dt),
        "wg": L.dense_init(gen, (d, d), dt),
        "wo": L.dense_init(gen, (d, d), dt),
        "ln_x_scale": torch.ones((d,), dtype=dt),
        "ln_x_bias": torch.zeros((d,), dtype=dt),
    }
    cm = {
        "maa_k": torch.zeros((d,), dtype=dt),
        "maa_r": torch.zeros((d,), dtype=dt),
        "wk": L.dense_init(gen, (d, cfg.d_ff), dt),
        "wv": L.dense_init(gen, (cfg.d_ff, d), dt),
        "wr": L.dense_init(gen, (d, d), dt),
    }
    return {"ln1": _ln(d, dt), "time_mix": tm, "ln2": _ln(d, dt),
            "channel_mix": cm}


def init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights with the JAX ``init``'s tree, dtypes and scales,
    drawn from a ``torch.Generator`` seeded with ``seed`` on the CPU and
    placed on ``device`` (``cuda:0`` by default; raises without a card
    unless asked for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d, dt = cfg.d_model, cfg.jdtype
    params = {"embed": L.init_embed(cfg, gen), "ln0": _ln(d, dt),
              "layers": stack_layers(cfg.n_layers,
                                      lambda: _init_block(cfg, gen)),
              "final_norm": _ln(d, dt)}
    return tree_to(params, dev)


def param_axes(cfg: ModelConfig):
    """Logical-axis names, same tree structure as ``init()`` (the JAX
    ``param_axes``)."""
    ln = {"scale": (None,), "bias": (None,)}
    tm = {"maa_x": (None,), "maa_rkvwg": (None, None),
          "maa_w1": ("embed", None), "maa_w2": (None, None, "embed"),
          "decay": (None,), "decay_w1": ("embed", None),
          "decay_w2": (None, "embed"), "faaaa": ("heads", None),
          "wr": ("embed", "heads"), "wk": ("embed", "heads"),
          "wv": ("embed", "heads"), "wg": ("embed", "heads"),
          "wo": ("heads", "embed"), "ln_x_scale": (None,),
          "ln_x_bias": (None,)}
    cm = {"maa_k": (None,), "maa_r": (None,), "wk": ("embed", "mlp"),
          "wv": ("mlp", "embed"), "wr": ("embed", "heads")}
    blk = {"ln1": dict(ln), "time_mix": tm, "ln2": dict(ln),
           "channel_mix": cm}
    emb = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        emb["head"] = ("embed", "vocab")
    return {"embed": emb, "ln0": dict(ln), "layers": prefix_axes(blk),
            "final_norm": dict(ln)}


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------
def _ddlerp(p, x, x_prev):
    """Data-dependent lerp producing the 5 mixed inputs (r, k, v, w, g)."""
    xx = x_prev - x
    xxx = x + xx * p["maa_x"]
    b, s, _ = x.shape
    lo = torch.tanh(xxx @ p["maa_w1"]).reshape(b, s, 5, -1)   # [B,S,5,lm]
    mods = torch.einsum("bsfl,fld->fbsd", lo, p["maa_w2"])     # [5,B,S,D]
    mix = p["maa_rkvwg"][:, None, None, :] + mods
    return x[None] + xx[None] * mix                            # [5,B,S,D]


def _time_mix(cfg: ModelConfig, p, x, x_prev, wkv_state):
    """x, x_prev ``[B, S, D]`` (x_prev token-shifted); wkv_state ``[B, H,
    N, N]`` -> (out ``[B, S, D]``, new wkv state)."""
    b, s, d = x.shape
    h, n = _heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    r = (xr @ p["wr"]).reshape(b, s, h, n)
    k = (xk @ p["wk"]).reshape(b, s, h, n)
    v = (xv @ p["wv"]).reshape(b, s, h, n)
    g = F.silu((xg @ p["wg"]).float()).to(x.dtype)
    w_raw = p["decay"].float() \
        + (torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]).float()
    w = torch.exp(-torch.exp(w_raw)).reshape(b, s, h, n)      # decay in (0,1)
    y, new_state = wkv_ops.wkv6(r, k, v, w, p["faaaa"], wkv_state)
    # per-head group norm (population variance, as jnp.var)
    y32 = y.float().reshape(b, s, h, n)
    mu = y32.mean(-1, keepdim=True)
    var = y32.var(-1, keepdim=True, correction=0)
    y32 = (y32 - mu) * torch.rsqrt(var + 1e-5)
    y = (y32.reshape(b, s, d) * p["ln_x_scale"].float()
         + p["ln_x_bias"].float()).to(x.dtype)
    return (y * g) @ p["wo"], new_state


def _channel_mix(p, x, x_prev):
    xx = x_prev - x
    xk = x + xx * p["maa_k"]
    xr = x + xx * p["maa_r"]
    k = torch.square(torch.relu((xk @ p["wk"]).float())).to(x.dtype)
    return torch.sigmoid((xr @ p["wr"]).float()).to(x.dtype) * (k @ p["wv"])


def _shift_seq(x, first):
    """Token shift: x_prev[t] = x[t-1]; x_prev[0] = first (carried)."""
    return torch.cat([first[:, None], x[:, :-1]], 1)


def _block_seq(cfg: ModelConfig, lp, x, state):
    """Full-sequence block; state = {wkv, tm_prev [B, D], cm_prev [B, D]}."""
    h1 = L.layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
    out, wkv = _time_mix(cfg, lp["time_mix"], h1,
                         _shift_seq(h1, state["tm_prev"]), state["wkv"])
    x = x + out
    h2 = L.layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
    x = x + _channel_mix(lp["channel_mix"], h2,
                         _shift_seq(h2, state["cm_prev"]))
    return x, {"wkv": wkv, "tm_prev": h1[:, -1], "cm_prev": h2[:, -1]}


_STATE_KEYS = ("wkv", "tm_prev", "cm_prev")


def init_state(cfg: ModelConfig, batch_size: int, dtype=None, device=None):
    """Zero state ``{wkv [L, B, H, N, N] f32, tm_prev / cm_prev [L, B, D],
    pos [B] i32}`` on ``device`` (``cuda:0`` by default)."""
    dev = resolve_device(device)
    h, n = _heads(cfg)
    lb = (cfg.n_layers, batch_size)
    return {
        "wkv": torch.zeros(lb + (h, n, n), dtype=torch.float32, device=dev),
        "tm_prev": torch.zeros(lb + (cfg.d_model,), dtype=cfg.jdtype,
                               device=dev),
        "cm_prev": torch.zeros(lb + (cfg.d_model,), dtype=cfg.jdtype,
                               device=dev),
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
    }


def cache_axes(cfg: ModelConfig):
    """Logical axes of ``init_state``'s tree (the JAX ``cache_axes``)."""
    return {"wkv": ("layers", "batch", "heads", None, None),
            "tm_prev": ("layers", "batch", None),
            "cm_prev": ("layers", "batch", None),
            "pos": ("batch",)}


def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """The decode state; O(1) in ``max_seq``."""
    return init_state(cfg, batch_size, dtype, device)


def _run(cfg: ModelConfig, params, x, state):
    """The blocks in order.  Under grad mode with ``cfg.remat`` each block
    runs in ``torch.utils.checkpoint`` (non-reentrant): only its input is
    kept and the backward recomputes it, so K5's forward runs twice a
    layer and its backward once (the JAX ``_run``'s
    ``jax.checkpoint(nothing_saveable)``)."""
    from torch.utils.checkpoint import checkpoint
    remat = cfg.remat and torch.is_grad_enabled()
    outs = {k: [] for k in _STATE_KEYS}
    for i in range(cfg.n_layers):
        args = (cfg, layer_params(params, i), x,
                {k: state[k][i] for k in _STATE_KEYS})
        x, st = checkpoint(_block_seq, *args, use_reentrant=False) \
            if remat else _block_seq(*args)
        for k in _STATE_KEYS:
            outs[k].append(st[k])
    return x, {k: torch.stack(v) for k, v in outs.items()}


def hidden_states(cfg: ModelConfig, params, tokens, state=None):
    """``tokens [B, S]`` -> (final hidden ``[B, S, D]``, new state
    without ``pos``); ``state`` defaults to zeros."""
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = L.layernorm(x, params["ln0"]["scale"], params["ln0"]["bias"])
    if state is None:
        state = init_state(cfg, tokens.shape[0], device=tokens.device)
    x, new_states = _run(cfg, params, x, state)
    return L.layernorm(x, params["final_norm"]["scale"],
                       params["final_norm"]["bias"]), new_states


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


def prefill(cfg: ModelConfig, params, tokens, cache):
    """``tokens [B, S]`` -> (logits ``[B, 1, V]`` at the last position,
    state).  Starts from the zero state whatever ``cache`` holds, as the
    JAX package does."""
    b, s = tokens.shape
    x, new_cache = hidden_states(cfg, params, tokens)
    new_cache["pos"] = torch.full((b,), s, dtype=torch.int32,
                                  device=tokens.device)
    return L.lm_head(cfg, params["embed"], x[:, -1:]), new_cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """``tokens [B, 1]`` -> (logits ``[B, 1, V]``, state).  O(1) per
    token."""
    x = L.embed_tokens(cfg, params["embed"], tokens)
    x = L.layernorm(x, params["ln0"]["scale"], params["ln0"]["bias"])
    x, out = _run(cfg, params, x, cache)
    x = L.layernorm(x, params["final_norm"]["scale"],
                    params["final_norm"]["bias"])
    out["pos"] = cache["pos"] + 1
    return L.lm_head(cfg, params["embed"], x), out


register_family("rwkv6")(sys.modules[__name__])
