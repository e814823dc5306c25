"""InternVL2-style VLM (arXiv:2404.16821): stub ViT frontend + LM backbone.

The PyTorch counterpart of ``repro.models.vlm``.  The vision tower is a
stub: callers pass precomputed patch features ``[B, n_patches,
frontend_dim]`` (InternViT outputs).  This module owns the LM-side pieces:
the 2-layer MLP projector ("mlp1") and the InternLM2 decoder backbone (the
dense family).  ``loss_fn`` trains both, the image positions masked.
Inference delegates to the dense backbone; as in the JAX package there is
no ``prefill_fn`` / ``step_fn``, so MCTS decode takes the generic
fallback of ``models.base``.
"""
from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as dense
from repro_torch.models.base import ModelConfig, register_family, tree_to
from repro_torch.search.api import resolve_device


def init(cfg: ModelConfig, seed: int = 0, device=None):
    """The dense backbone's weights (``transformer.init``) plus the
    projector's, drawn from a CPU ``torch.Generator`` seeded with
    ``seed + 1`` and placed on ``device`` (``cuda:0`` by default)."""
    dev = resolve_device(device)
    p = dense.init(cfg, seed=seed, device=dev)
    gen = torch.Generator().manual_seed(seed + 1)
    fd, d, dt = cfg.frontend_dim or cfg.d_model, cfg.d_model, cfg.jdtype
    p["projector"] = tree_to({
        "ln": {"scale": torch.ones((fd,), dtype=dt),
               "bias": torch.zeros((fd,), dtype=dt)},
        "w1": L.dense_init(gen, (fd, d), dt),
        "b1": torch.zeros((d,), dtype=dt),
        "w2": L.dense_init(gen, (d, d), dt),
        "b2": torch.zeros((d,), dtype=dt),
    }, dev)
    return p


def param_axes(cfg: ModelConfig):
    """The dense backbone's axes plus the projector's (the JAX
    ``param_axes``)."""
    ax = dense.param_axes(cfg)
    ax["projector"] = {
        "ln": {"scale": (None,), "bias": (None,)},
        "w1": (None, "embed"), "b1": ("embed",),
        "w2": ("embed", "embed"), "b2": ("embed",),
    }
    return ax


def project_patches(cfg: ModelConfig, params, patches):
    p = params["projector"]
    x = L.layernorm(patches, p["ln"]["scale"], p["ln"]["bias"])
    # jax.nn.gelu defaults to the tanh approximation
    x = F.gelu((x @ p["w1"] + p["b1"]).float(), approximate="tanh") \
        .to(patches.dtype)
    return x @ p["w2"] + p["b2"]


def multimodal_embeds(cfg: ModelConfig, params, patches, tokens):
    img = project_patches(cfg, params, patches)              # [B, P, D]
    txt = L.embed_tokens(cfg, params["embed"], tokens)       # [B, St, D]
    return torch.cat([img, txt], 1)


def loss_fn(cfg: ModelConfig, params, batch, rng=None):
    """Mean next-token cross-entropy over the text positions of
    ``batch``: ``patches [B, P, fd]`` (in the model's dtype), ``tokens [B,
    St]``, ``labels [B, P + St]`` (the image positions' masked out unless
    ``mask`` says otherwise) -> ``(loss, {"loss": loss})``.  The
    projector ("mlp1") and the backbone get their gradients; the backbone
    runs ``transformer.hidden_states`` (remat per block)."""
    patches = batch["patches"].to(cfg.jdtype)
    embeds = multimodal_embeds(cfg, params, patches, batch["tokens"])
    x = dense.hidden_states(cfg, params, inputs_embeds=embeds)
    n_img = patches.shape[1]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.cat([
            torch.zeros((x.shape[0], n_img), dtype=torch.float32,
                        device=x.device),
            torch.ones((x.shape[0], x.shape[1] - n_img),
                       dtype=torch.float32, device=x.device)], 1)
    loss = L.chunked_softmax_xent(cfg, params["embed"], x, batch["labels"],
                                  mask)
    return loss, {"loss": loss}


def logits_fn(cfg: ModelConfig, params, tokens):
    return dense.logits_fn(cfg, params, tokens)


def multimodal_logits(cfg: ModelConfig, params, patches, tokens):
    embeds = multimodal_embeds(cfg, params, patches, tokens)
    x = dense.hidden_states(cfg, params, inputs_embeds=embeds)
    return L.lm_head(cfg, params["embed"], x)


# inference delegates to the dense backbone (image prefix enters via prefill)
init_cache = dense.init_cache
cache_axes = dense.cache_axes
decode_step = dense.decode_step


def prefill(cfg: ModelConfig, params, tokens, cache):
    return dense.prefill(cfg, params, tokens, cache)


register_family("vlm")(sys.modules[__name__])
