"""Mixture-of-Experts transformer family.

The PyTorch counterpart of ``repro.models.moe``:

* deepseek-v2-lite-16b — MLA attention (kv_lora latent cache, decoupled
  rope), 64 routed experts top-6 + 2 shared experts, a leading dense layer;
* grok-1-314b         — GQA attention with a tanh logit soft cap, 8
  experts top-2.

Expert dispatch is the JAX package's dropped-token grouped ``(G, E, C)``
buffer: tokens split into G groups, each token-slot's position in its
expert by a cumsum per group in token-major, slot-minor order, slots at or
past the capacity C dropped, and the scatter and gather taken one top-k
slot at a time.  ``moe_impl="ragged"`` is the dropless sort-by-expert path
(a loop over the experts, where the JAX package calls ``lax.ragged_dot``);
``moe_impl="ep"`` under an ambient mesh (``with mesh:``) whose ``model``
axis divides the experts takes the explicit expert-parallel dispatch of
``parallel/ep_dispatch.py``, and the grouped dispatch elsewhere, as in
the JAX package.

Attention: the prefill runs the flash kernel (K4) through
``layers.attention``, MLA's at q/k head dim 192 and v head dim 128; the MLA
decode attends in the latent space (weight-absorbed einsums, no kernel),
grok's soft-capped decode goes to ``sdpa``.  The batched trio
``init_cache`` / ``prefill`` / ``decode_step`` writes the ``[L, B, ...]``
cache in place.  No ``prefill_fn`` / ``step_fn``: MCTS decode takes the
generic fallback of ``models.base``, whose forward is ``seq_logits_fn``
(each row dispatched as a sequence of its own, as the JAX package's
``vmap`` over rows sees it).

Training: ``loss_fn`` is the chunked cross-entropy plus the routers'
load-balancing loss, over one dispatch of all B x S tokens.  Under grad
attention takes ``layers.blocked_attention`` (kernel A and the flash
backward kernel B, MLA's at (192, 128)); the dispatch's gradient is that
of its gathers and scatters: a dropped slot (sent to the spare row C,
sliced off) gets none, the expert counts ``f_e`` carry none, the
renormalised ``topv`` carries the router's.
"""
from __future__ import annotations

import math
import sys

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.base import (ModelConfig, register_family,
                                     stack_layers, tree_to)
from repro_torch.models.transformer import unstack_layers
from repro_torch.parallel.sharding import prefix_axes
from repro_torch.search.api import resolve_device


# ---------------------------------------------------------------------------
# router + expert FFN
# ---------------------------------------------------------------------------
def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(cfg.moe_capacity * n_tokens * cfg.moe_topk
                      / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8


def router_probs(cfg: ModelConfig, p, x2d):
    return torch.softmax(x2d.float() @ p["router"].float(), -1)  # [N, E]


def _groups(cfg: ModelConfig, n: int) -> int:
    g = max(1, min(cfg.moe_groups, n))
    while n % g:
        g //= 2
    return g


def top_experts(cfg: ModelConfig, p, x2d):
    """x2d ``[N, D]`` -> (gates ``[N, E]`` f32, topi ``[N, K]``, topv ``[N,
    K]`` renormalised to sum 1)."""
    gates = router_probs(cfg, p, x2d)
    topv, topi = torch.topk(gates, cfg.moe_topk, dim=-1)
    return gates, topi, topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)


def dispatch_slots(cfg: ModelConfig, topi, rows: int = 1):
    """The grouped dispatch's slots for the top-k choices ``topi [N, K]``:
    ``(g, c, pos, keep)`` with ``g`` groups of ``N / g`` tokens (``rows``
    equal runs of tokens, each grouped as if alone), capacity ``c`` a group
    and expert, and each token-slot's position in its expert ``pos [g,
    N / g * K]`` (a cumsum per group in token-major, slot-minor order),
    kept where ``pos < c``."""
    n, k = topi.shape
    g = rows * _groups(cfg, n // rows)
    c = _capacity(cfg, n // g)
    e_flat = topi.reshape(g, n // g * k)                         # [G, Nk]
    onehot = F.one_hot(e_flat, cfg.n_experts).to(torch.int32)    # [G, Nk, E]
    pos = (onehot.cumsum(1) - onehot).gather(2, e_flat[..., None])[..., 0] \
        .long()
    return g, c, pos, pos < c


def moe_ffn(cfg: ModelConfig, p, x2d, rows: int = 1):
    """x2d ``[N, D]`` -> (y ``[N, D]``, aux_loss scalar): dropped-token
    dispatch.  ``rows > 1`` dispatches each of ``rows`` equal runs of
    tokens as if alone (its own groups and capacity), as the JAX package
    does under a ``vmap`` over sequences; the aux loss is over all N."""
    n, d = x2d.shape
    e, k = cfg.n_experts, cfg.moe_topk
    gates, topi, topv = top_experts(cfg, p, x2d)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    p_mean = gates.mean(0)                                       # [E]
    f_e = torch.zeros((e,), dtype=torch.float32, device=x2d.device) \
        .index_add_(0, topi.reshape(-1),
                    torch.full((n * k,), 1.0 / n / k, device=x2d.device))
    aux = cfg.router_aux_coef * e * (f_e * p_mean).sum()

    if cfg.moe_impl == "ragged":
        return _ragged_ffn(cfg, p, x2d, topi, topv), aux
    if cfg.moe_impl == "ep":
        from repro_torch.parallel.ep_dispatch import ep_moe_ffn
        from repro_torch.parallel.mesh import current_mesh
        mesh = current_mesh()
        if mesh is not None and "model" in mesh.axis_names \
                and cfg.n_experts % mesh.shape["model"] == 0:
            runs = x2d.reshape(rows, n // rows, d)
            y = torch.cat([ep_moe_ffn(xr, p, mesh, topk=k,
                                      capacity_factor=cfg.moe_capacity)
                           for xr in runs])
            return y, aux
        # no usable mesh: fall through to the grouped dispatch

    # ---- grouped (G, E, C) buffer dispatch (GShard-style) ----
    g, c, pos, keep = dispatch_slots(cfg, topi, rows)
    ng = n // g                                                  # tokens/group
    e_flat = topi.reshape(g, ng * k)
    w_flat = topv.reshape(g, ng * k).to(x2d.dtype)
    xg = x2d.reshape(g, ng, d)

    # one top-k slot at a time; a dropped slot goes to the spare row C
    gi = torch.arange(g, device=x2d.device)[:, None].expand(g, ng)
    buf = x2d.new_zeros((g, e, c + 1, d))
    for j in range(k):
        e_j, pos_j, keep_j = e_flat[:, j::k], pos[:, j::k], keep[:, j::k]
        buf.index_put_((gi, e_j, torch.where(keep_j, pos_j, c)), xg)
    buf = buf[:, :, :c]

    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["wg"]).float()) \
        .to(x2d.dtype)
    h = h * torch.einsum("gecd,edf->gecf", buf, p["wu"])
    y_buf = torch.einsum("gecf,efd->gecd", h, p["wd"])           # [G, E, C, D]

    y = x2d.new_zeros((g, ng, d))
    for j in range(k):
        e_j, pos_j, keep_j = e_flat[:, j::k], pos[:, j::k], keep[:, j::k]
        got = y_buf[gi, e_j, pos_j.clamp_max(c - 1)]             # [G, ng, D]
        y = y + torch.where(keep_j[..., None], got, 0) \
            * w_flat[:, j::k, None]
    return y.reshape(n, d), aux


def _ragged_ffn(cfg: ModelConfig, p, x2d, topi, topv):
    """Dropless dispatch: token-slots sorted by expert, each expert's run
    through its FFN (the JAX package's ``lax.ragged_dot``)."""
    n, d = x2d.shape
    e, k = cfg.n_experts, cfg.moe_topk
    e_flat = topi.reshape(-1)
    order = torch.argsort(e_flat, stable=True)                   # [NK]
    tok_sorted = (torch.arange(n * k, device=x2d.device) // k)[order]
    xs = x2d[tok_sorted]                                         # [NK, D]
    sizes = torch.bincount(e_flat, minlength=e).tolist()
    ys, start = [], 0
    for ei, sz in enumerate(sizes):
        xe = xs[start:start + sz]
        start += sz
        h = F.silu((xe @ p["wg"][ei]).float()).to(x2d.dtype) \
            * (xe @ p["wu"][ei])
        ys.append(h @ p["wd"][ei])
    w_sorted = topv.reshape(-1)[order].to(x2d.dtype)
    return x2d.new_zeros((n, d)).index_add_(
        0, tok_sorted, torch.cat(ys) * w_sorted[:, None])


def apply_moe_block_ffn(cfg: ModelConfig, p, x, rows: int = 1):
    b, s, d = x.shape
    y, aux = moe_ffn(cfg, p, x.reshape(b * s, d), rows=rows)
    if "shared" in p:
        y = y + L.apply_mlp(cfg, p["shared"], x).reshape(b * s, d)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v2)
# ---------------------------------------------------------------------------
def init_mla(cfg: ModelConfig, gen):
    d, h, dt = cfg.d_model, cfg.n_heads, cfg.jdtype
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": L.dense_init(gen, (d, h * qd), dt),
        "wdkv": L.dense_init(gen, (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
                             dt),
        "kv_norm": torch.ones((cfg.kv_lora_rank,), dtype=dt),
        "wuk": L.dense_init(gen, (cfg.kv_lora_rank, h * cfg.qk_nope_dim),
                            dt),
        "wuv": L.dense_init(gen, (cfg.kv_lora_rank, h * cfg.v_head_dim), dt),
        "wo": L.dense_init(gen, (h * cfg.v_head_dim, d), dt),
    }


def mla_latents(cfg: ModelConfig, p, x, positions):
    """x ``[B, S, D]`` -> (c_kv ``[B, S, R]``, k_rope ``[B, S, 1, rope]``)
    with rope applied."""
    b, s, _ = x.shape
    dkv = x @ p["wdkv"]
    c_kv = L.rmsnorm(dkv[..., :cfg.kv_lora_rank], p["kv_norm"])
    k_rope = dkv[..., cfg.kv_lora_rank:].reshape(b, s, 1, cfg.qk_rope_dim)
    cos, sin = L.rope_freqs(cfg, positions, rot_dim=cfg.qk_rope_dim)
    return c_kv, L.apply_rope(k_rope, cos, sin)


def mla_queries(cfg: ModelConfig, p, x, positions):
    b, s, _ = x.shape
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, qd)
    q_nope, q_rope = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    cos, sin = L.rope_freqs(cfg, positions, rot_dim=cfg.qk_rope_dim)
    return q_nope, L.apply_rope(q_rope, cos, sin)


def mla_attention_full(cfg: ModelConfig, p, x, positions, *, causal=True):
    """Prefill path: per-head K, V materialised from the latent; K4 at
    q/k head dim ``qk_nope + qk_rope``, v head dim ``v_head_dim``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = mla_queries(cfg, p, x, positions)
    c_kv, k_rope = mla_latents(cfg, p, x, positions)
    k_nope = (c_kv @ p["wuk"]).reshape(b, s, h, cfg.qk_nope_dim)
    v = (c_kv @ p["wuv"]).reshape(b, s, h, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, cfg.qk_rope_dim)], -1)
    attn = L.attention(cfg, q, k, v, causal=causal,
                       logits_soft_cap=cfg.logits_soft_cap)
    return attn.reshape(b, s, h * cfg.v_head_dim) @ p["wo"], (c_kv, k_rope)


def mla_attention_absorbed(cfg: ModelConfig, p, x, pos, c_kv_cache,
                           k_rope_cache, kv_valid_len):
    """Decode path: attend in the latent space (weight-absorbed, O(R)
    cache).  x ``[B, 1, D]``; c_kv_cache ``[B, S, R]``; k_rope_cache
    ``[B, S, rope]``.  Scores in float32, probabilities cast to x's dtype
    before the product with the latent."""
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    q_nope, q_rope = mla_queries(cfg, p, x, pos[:, None])        # [B,1,H,*]
    # absorb W_uk into the query: score_nope = (q_nope W_uk^T) . c_kv
    wuk = p["wuk"].reshape(r, h, cfg.qk_nope_dim)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wuk)          # [B,1,H,R]
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    s_nope = torch.einsum("bqhr,bkr->bhqk", q_lat.float(),
                          c_kv_cache.float())
    s_rope = torch.einsum("bqhe,bke->bhqk", q_rope.float(),
                          k_rope_cache.float())
    logits = (s_nope + s_rope) * scale
    if cfg.logits_soft_cap > 0:
        logits = cfg.logits_soft_cap * torch.tanh(
            logits / cfg.logits_soft_cap)
    kpos = torch.arange(c_kv_cache.shape[1], device=x.device)[None, :]
    keep = kpos < kv_valid_len[:, None]
    logits = logits.masked_fill(~keep[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, -1).to(x.dtype)
    o_lat = torch.einsum("bhqk,bkr->bqhr", probs, c_kv_cache)    # [B,1,H,R]
    wuv = p["wuv"].reshape(r, h, cfg.v_head_dim)
    o = torch.einsum("bqhr,rhv->bqhv", o_lat, wuv)               # [B,1,H,V]
    return o.reshape(b, 1, h * cfg.v_head_dim) @ p["wo"]


# ---------------------------------------------------------------------------
# blocks / init
# ---------------------------------------------------------------------------
def init_moe_ffn(cfg: ModelConfig, gen):
    d, f, e, dt = cfg.d_model, cfg.d_ff_expert, cfg.n_experts, cfg.jdtype
    p = {"router": L.dense_init(gen, (d, e), torch.float32),
         "wg": L.dense_init(gen, (e, d, f), dt, in_axis=1),
         "wu": L.dense_init(gen, (e, d, f), dt, in_axis=1),
         "wd": L.dense_init(gen, (e, f, d), dt, in_axis=1)}
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(cfg, gen,
                                 d_ff=cfg.d_ff_expert * cfg.n_shared_experts)
    return p


def _init_attn(cfg: ModelConfig, gen):
    return init_mla(cfg, gen) if cfg.use_mla else L.init_gqa(cfg, gen)


def _init_moe_block(cfg: ModelConfig, gen):
    return {"ln1": L.init_norm(cfg), "attn": _init_attn(cfg, gen),
            "ln2": L.init_norm(cfg), "moe": init_moe_ffn(cfg, gen)}


def _init_dense_block(cfg: ModelConfig, gen):
    return {"ln1": L.init_norm(cfg), "attn": _init_attn(cfg, gen),
            "ln2": L.init_norm(cfg),
            "mlp": L.init_mlp(cfg, gen, d_ff=cfg.d_ff_dense or cfg.d_ff)}


def init(cfg: ModelConfig, seed: int = 0, device=None):
    """Random weights with the JAX ``init``'s tree, dtypes and scales, drawn
    on ``device`` (``cuda:0`` by default; raises without a card unless
    asked for the CPU) from a ``torch.Generator`` there seeded with
    ``seed``: the stacked layer planes are allocated on the device and
    filled one layer at a time, never held on the host."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {"embed": tree_to(L.init_embed(cfg, gen), dev),
         "layers": stack_layers(cfg.n_layers - cfg.first_dense_layers,
                            lambda: _init_moe_block(cfg, gen), dev),
         "final_norm": tree_to(L.init_norm(cfg), dev)}
    if cfg.first_dense_layers:
        p["dense_layers"] = [tree_to(_init_dense_block(cfg, gen), dev)
                             for _ in range(cfg.first_dense_layers)]
    return p


def param_axes(cfg: ModelConfig):
    """Logical-axis names, same tree structure as ``init()`` (the JAX
    ``param_axes``; ``dense_layers`` a list of one tree per layer)."""
    if cfg.use_mla:
        attn = {"wq": ("embed", "heads"), "wdkv": ("embed", None),
                "kv_norm": (None,), "wuk": (None, "heads"),
                "wuv": (None, "heads"), "wo": ("heads", "embed")}
    else:
        attn = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
                "wv": ("embed", "kv"), "wo": ("heads", "embed")}
        if cfg.qkv_bias:
            attn.update({"bq": ("heads",), "bk": ("kv",), "bv": ("kv",)})
    moe = {"router": ("embed", None),
           "wg": ("experts", "embed", "mlp"), "wu": ("experts", "embed", "mlp"),
           "wd": ("experts", "mlp", "embed")}
    if cfg.n_shared_experts:
        moe["shared"] = {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
                         "wd": ("mlp", "embed")}
    norm = {"scale": (None,)}
    blk = {"ln1": dict(norm), "attn": attn, "ln2": dict(norm), "moe": moe}
    emb = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        emb["head"] = ("embed", "vocab")
    out = {"embed": emb, "layers": prefix_axes(blk), "final_norm": dict(norm)}
    if cfg.first_dense_layers:
        dblk = {"ln1": dict(norm), "attn": dict(attn), "ln2": dict(norm),
                "mlp": {"wg": ("embed", "mlp"), "wu": ("embed", "mlp"),
                        "wd": ("mlp", "embed")}}
        out["dense_layers"] = [dblk for _ in range(cfg.first_dense_layers)]
    return out


def inactive_expert_params(cfg: ModelConfig) -> int:
    """Params NOT activated per token (for 6*N_active*D accounting)."""
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = cfg.n_layers - cfg.first_dense_layers
    return n_moe_layers * (cfg.n_experts - cfg.moe_topk) * per_expert


def _layers(cfg: ModelConfig, params):
    """``(layer params, is_moe)`` for every layer in order: the leading
    dense layers, then the stacked MoE layers' slices (``unstack_layers``:
    under autograd each stacked leaf's gradient is stacked once)."""
    for lp in params.get("dense_layers", []):
        yield lp, False
    for lp in unstack_layers(params, cfg.n_layers - cfg.first_dense_layers):
        yield lp, True


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _attn_full(cfg: ModelConfig, p, x, positions):
    """A block's prefill attention; returns (output, the layer's cache
    entries ``{ckv, krope}`` (MLA) or ``{k, v}``)."""
    if cfg.use_mla:
        out, (ckv, krope) = mla_attention_full(cfg, p, x, positions)
        return out, {"ckv": ckv, "krope": krope[:, :, 0]}
    b, s, _ = x.shape
    q, k, v = L.gqa_project_qkv(cfg, p, x)
    cos, sin = L.rope_freqs(cfg, positions)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    attn = L.attention(cfg, q, k, v, causal=True,
                       logits_soft_cap=cfg.logits_soft_cap)
    return attn.reshape(b, s, -1) @ p["wo"], {"k": k, "v": v}


def _block(cfg: ModelConfig, lp, is_moe, x, positions, rows=1):
    """One block; returns (x, aux, the layer's cache entries)."""
    h = L.apply_norm(cfg, lp["ln1"], x)
    out, kv = _attn_full(cfg, lp["attn"], h, positions)
    x = x + out
    h = L.apply_norm(cfg, lp["ln2"], x)
    if not is_moe:
        return x + L.apply_mlp(cfg, lp["mlp"], h), 0.0, kv
    y, aux = apply_moe_block_ffn(cfg, lp["moe"], h, rows=rows)
    return x + y, aux, kv


def _moe_block_out(cfg: ModelConfig, lp, x, positions, rows):
    return _block(cfg, lp, True, x, positions, rows=rows)[:2]


def hidden_states(cfg: ModelConfig, params, tokens=None, inputs_embeds=None,
                  rows: int = 1):
    """Full-sequence forward -> (final hidden ``[B, S, D]``, aux loss).
    ``rows=B`` dispatches each sequence's tokens as if alone (training
    takes ``rows=1``: one dispatch over all B x S tokens, as the JAX
    ``moe_ffn``).  Under grad mode with ``cfg.remat`` each MoE block runs
    in ``torch.utils.checkpoint`` (non-reentrant), as the JAX package
    checkpoints its scan over the MoE blocks; the leading dense layers are
    not checkpointed."""
    from torch.utils.checkpoint import checkpoint
    x = inputs_embeds if inputs_embeds is not None \
        else L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp, is_moe in _layers(cfg, params):
        if is_moe and remat:
            x, a = checkpoint(_moe_block_out, cfg, lp, x, positions, rows,
                              use_reentrant=False)
        else:
            x, a, _ = _block(cfg, lp, is_moe, x, positions, rows=rows)
        aux = aux + a
    return L.apply_norm(cfg, params["final_norm"], x), aux


def loss_fn(cfg: ModelConfig, params, batch, rng=None):
    """Mean next-token cross-entropy of ``batch`` (``tokens``, ``labels``,
    optional ``mask``, each ``[B, S]``) plus the routers' load-balancing
    loss -> ``(ce + aux, {"loss": ce, "aux_loss": aux})``."""
    x, aux = hidden_states(cfg, params, tokens=batch["tokens"])
    ce = L.chunked_softmax_xent(cfg, params["embed"], x, batch["labels"],
                                batch.get("mask"))
    return ce + aux, {"loss": ce, "aux_loss": aux}


def logits_fn(cfg: ModelConfig, params, tokens):
    x, _ = hidden_states(cfg, params, tokens=tokens)
    return L.lm_head(cfg, params["embed"], x)


def seq_logits_fn(cfg: ModelConfig, params, tokens):
    """``logits_fn`` with each row of ``tokens [B, S]`` dispatched to the
    experts as a sequence of its own: the generic decode path's forward
    (the JAX package runs it under a ``vmap`` over rows)."""
    x, _ = hidden_states(cfg, params, tokens=tokens, rows=tokens.shape[0])
    return L.lm_head(cfg, params["embed"], x)


# ---------------------------------------------------------------------------
# inference: prefill + single-token decode with a pre-allocated cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch_size: int, max_seq: int, dtype=None,
               device=None):
    """Zero ``{ckv: [L, B, S, R], krope: [L, B, S, rope]}`` (MLA) or ``{k,
    v: [L, B, S, Hkv, D]}``, with ``pos: [B] i32``, on ``device``
    (``cuda:0`` by default)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.jdtype
    lb = (cfg.n_layers, batch_size, max_seq)
    if cfg.use_mla:
        cache = {"ckv": torch.zeros(lb + (cfg.kv_lora_rank,), dtype=dtype,
                                    device=dev),
                 "krope": torch.zeros(lb + (cfg.qk_rope_dim,), dtype=dtype,
                                      device=dev)}
    else:
        kv = lb + (cfg.kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(kv, dtype=dtype, device=dev),
                 "v": torch.zeros(kv, dtype=dtype, device=dev)}
    cache["pos"] = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    return cache


def cache_axes(cfg: ModelConfig):
    """Logical axes of ``init_cache``'s tree (the JAX ``cache_axes``)."""
    if cfg.use_mla:
        return {"ckv": ("layers", "batch", "kv_seq", None),
                "krope": ("layers", "batch", "kv_seq", None),
                "pos": ("batch",)}
    return {"k": ("layers", "batch", "kv_seq", "kv", None),
            "v": ("layers", "batch", "kv_seq", "kv", None),
            "pos": ("batch",)}


def prefill(cfg: ModelConfig, params, tokens, cache):
    """``tokens [B, S]`` -> (logits ``[B, 1, V]`` at the last position,
    cache): each layer's latents (or K/V) go into positions ``[0, S)`` of
    the cache in place."""
    b, s = tokens.shape
    x = L.embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device)
    for i, (lp, is_moe) in enumerate(_layers(cfg, params)):
        x, _, kv = _block(cfg, lp, is_moe, x, positions)
        for name, t in kv.items():
            cache[name][i, :, :s] = t.to(cache[name].dtype)
    out = dict(cache)
    out["pos"] = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_head(cfg, params["embed"], x[:, -1:]), out


def _decode_attn(cfg: ModelConfig, p, x, pos, cache, i, valid):
    """One-token attention against layer ``i``'s cache slice, whose row
    at ``pos`` is written in place first."""
    b = x.shape[0]
    rows, posl = torch.arange(b, device=x.device), pos.long()
    if cfg.use_mla:
        dkv = x @ p["wdkv"]
        ckv_new = L.rmsnorm(dkv[..., :cfg.kv_lora_rank], p["kv_norm"])
        kr = dkv[..., cfg.kv_lora_rank:].reshape(b, 1, 1, cfg.qk_rope_dim)
        cos, sin = L.rope_freqs(cfg, pos[:, None], rot_dim=cfg.qk_rope_dim)
        kr = L.apply_rope(kr, cos, sin)[:, 0, 0]
        ckv, krope = cache["ckv"][i], cache["krope"][i]
        ckv[rows, posl] = ckv_new[:, 0].to(ckv.dtype)
        krope[rows, posl] = kr.to(krope.dtype)
        return mla_attention_absorbed(cfg, p, x, pos, ckv, krope, valid)
    q, k, v = L.gqa_project_qkv(cfg, p, x)
    cos, sin = L.rope_freqs(cfg, pos[:, None])
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    ck, cv = cache["k"][i], cache["v"][i]
    ck[rows, posl] = k[:, 0].to(ck.dtype)
    cv[rows, posl] = v[:, 0].to(cv.dtype)
    attn = L.attention(cfg, q, ck, cv, causal=False, kv_valid_len=valid,
                       logits_soft_cap=cfg.logits_soft_cap)
    return attn.reshape(b, 1, -1) @ p["wo"]


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """``tokens [B, 1]`` -> (logits ``[B, 1, V]``, cache): each row appends
    its token at its own ``pos``, written into the cache in place."""
    pos = cache["pos"]
    s = cache["ckv" if cfg.use_mla else "k"].shape[2]
    torch._assert_async((pos < s).all(), "decode_step: pos beyond the cache")
    valid = pos + 1
    x = L.embed_tokens(cfg, params["embed"], tokens)
    for i, (lp, is_moe) in enumerate(_layers(cfg, params)):
        h = L.apply_norm(cfg, lp["ln1"], x)
        x = x + _decode_attn(cfg, lp["attn"], h, pos, cache, i, valid)
        h = L.apply_norm(cfg, lp["ln2"], x)
        if is_moe:
            x = x + apply_moe_block_ffn(cfg, lp["moe"], h)[0]
        else:
            x = x + L.apply_mlp(cfg, lp["mlp"], h)
    out = dict(cache)
    out["pos"] = pos + 1
    x = L.apply_norm(cfg, params["final_norm"], x)
    return L.lm_head(cfg, params["embed"], x), out


register_family("moe")(sys.modules[__name__])
