"""Model-zoo base: config dataclass, family registry, incremental decode.

The PyTorch counterpart of ``repro.models.base``.  A family module
implements plain functions over a parameter dict of tensors:

    init(cfg, seed, device)              -> params dict
    logits_fn(cfg, params, tokens)       -> logits [B, S, V]

and, optionally, the incremental pair that KV-cache-aware MCTS decode
uses:

    prefill_fn(cfg, params, toks, plen)  -> (logits, cache)
    step_fn(cfg, params, cache, tok, pos) -> (logits, cache)

Unlike the JAX package's unbatched pair (which the search ``vmap``s), these
take any leading shape ``lead``: ``toks [*lead, S]`` with ``plen [*lead]``
gives ``logits [*lead, V]`` float32 at position ``plen - 1`` and a cache
dict whose leaves are ``[*lead, ...]``; ``step_fn`` appends ``tok
[*lead]`` at ``pos [*lead]`` and returns the logits for ``pos + 1``.
``step_fn`` writes the new position into ``cache`` IN PLACE and returns
it: a caller that still needs the old cache passes a copy.  Cache entries
at positions ``>= pos`` are never read before they are written.

For the serving engine's greedy mode a family also provides the batched
trio of the JAX package, ``init_cache(cfg, batch, max_seq, device=)``,
``prefill(cfg, params, tokens, cache)`` and ``decode_step(cfg, params,
cache, tokens)``, whose cache leaves are ``[L, B, ...]`` (or ``[B]``).

Families without the pair fall back to ``seq_prefill``/``seq_step``'s
generic path: the "cache" is the token buffer, and each step re-runs the
full forward — correct for every family, just uncached.  The forward is
the family's ``seq_logits_fn`` when it has one, else ``logits_fn``: the
JAX package runs the fallback row by row (``vmap``), and a family whose
batched forward couples its rows (MoE's capacity-limited dispatch) gives
``seq_logits_fn``, which treats each row as a sequence of its own.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, Dict

import torch

Params = Any

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | whisper | rwkv6 |
                                     # zamba2 | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab_size: int
    n_kv_heads: int = 0              # 0 -> = n_heads (MHA)
    d_head: int = 0                  # 0 -> d_model // n_heads

    # --- dense-family variants ---
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    qkv_bias: bool = False           # qwen2
    rope_frac: float = 1.0           # stablelm-2 partial rotary (0.25)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    residual_scale: float = 1.0      # minicpm depth-scaled residuals
    logit_scale: float = 1.0         # minicpm mup output scaling

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    d_ff_dense: int = 0
    router_aux_coef: float = 0.001
    moe_capacity: float = 1.25
    moe_impl: str = "gather"
    moe_groups: int = 1
    scan_chunk: int = 64
    logits_soft_cap: float = 0.0     # grok-1 tanh attention-logit cap

    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # --- zamba2 / mamba2 ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    shared_attn_every: int = 6

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # --- modality stubs ---
    n_patches: int = 0
    frontend_dim: int = 0

    # --- numerics / compile strategy (the JAX package's; the port's
    # attention takes its kernels by device, see models.layers) ---
    attn_impl: str = "sdpa"
    seq_shard_carry: bool = False
    attn_blk_q: int = 256
    attn_blk_k: int = 1024
    dtype: str = "bfloat16"
    remat: bool = True
    use_scan: bool = True
    ce_chunk: int = 512
    use_pallas: bool = False
    max_seq: int = 8192

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def jdtype(self) -> torch.dtype:
        """The activation and weight dtype as a ``torch.dtype`` (the JAX
        package's property name)."""
        return _DTYPES[self.dtype]


# ---------------------------------------------------------------------------
# family registry
# ---------------------------------------------------------------------------
_FAMILIES: Dict[str, Any] = {}

_FAMILY_MODULES = {"dense": "transformer", "moe": "moe",
                   "whisper": "whisper", "rwkv6": "rwkv6",
                   "zamba2": "zamba2", "vlm": "vlm"}


def register_family(name: str):
    def deco(mod):
        _FAMILIES[name] = mod
        return mod
    return deco


def get_family(cfg_or_name):
    name = cfg_or_name.family if isinstance(cfg_or_name, ModelConfig) \
        else cfg_or_name
    if name not in _FAMILIES:
        if name not in _FAMILY_MODULES:
            raise KeyError(f"unknown model family {name!r}; known: "
                           f"{sorted(_FAMILY_MODULES)}")
        importlib.import_module(f"repro_torch.models.{_FAMILY_MODULES[name]}")
    return _FAMILIES[name]


# ---------------------------------------------------------------------------
# incremental decode over any leading shape (see module docstring)
# ---------------------------------------------------------------------------
def _at(x, idx):
    """``x[..., idx[...], :]``: one position per row of ``x [*lead, S, F]``."""
    return x.gather(-2, idx.long()[..., None, None]
                    .expand(idx.shape + (1, x.shape[-1])))[..., 0, :]


def row_logits(cfg: ModelConfig, params, toks):
    """The generic path's forward over rows ``toks [N, S]``, each row a
    sequence of its own (see the module docstring)."""
    fam = get_family(cfg)
    return getattr(fam, "seq_logits_fn", fam.logits_fn)(cfg, params, toks)


def _generic_prefill(cfg: ModelConfig, params, toks, plen):
    """Fallback prefill: the "cache" is the token buffer itself."""
    lead, s = toks.shape[:-1], toks.shape[-1]
    logits = row_logits(cfg, params, toks.reshape(-1, s))
    last = _at(logits.view(lead + logits.shape[1:]),
               torch.as_tensor(plen, device=toks.device) - 1)
    return last.float(), {"toks": toks.to(torch.int32)}


def _generic_step(cfg: ModelConfig, params, cache, tok, pos):
    """Fallback step: write ``tok`` at ``pos`` (in place) and re-run the
    full forward — the same logits as the cached path, no amortisation."""
    toks = cache["toks"]
    lead, s = toks.shape[:-1], toks.shape[-1]
    pos = torch.as_tensor(pos, device=toks.device).expand(lead)
    torch._assert_async((pos < s).all(), "seq_step: pos beyond the buffer")
    toks.scatter_(-1, pos.long()[..., None],
                  torch.as_tensor(tok, dtype=toks.dtype,
                                  device=toks.device).expand(lead)[..., None])
    logits = row_logits(cfg, params, toks.reshape(-1, s))
    out = _at(logits.view(lead + logits.shape[1:]), pos)
    return out.float(), cache


def seq_prefill(cfg: ModelConfig, params, toks, plen):
    """Prefill ``toks [*lead, S]`` (padded buffers) with true lengths
    ``plen [*lead]`` -> ``(logits [*lead, V] f32 at plen - 1, cache)``; the
    family's ``prefill_fn`` when present, else the generic fallback."""
    fn = getattr(get_family(cfg), "prefill_fn", None)
    if fn is None:
        return _generic_prefill(cfg, params, toks, plen)
    return fn(cfg, params, toks, plen)


def seq_step(cfg: ModelConfig, params, cache, tok, pos):
    """Append ``tok [*lead]`` at ``pos [*lead]`` -> ``(logits [*lead, V] f32
    for pos + 1, cache)``; ``cache`` (from ``seq_prefill`` or an earlier
    step) is updated in place."""
    fn = getattr(get_family(cfg), "step_fn", None)
    if fn is None:
        return _generic_step(cfg, params, cache, tok, pos)
    return fn(cfg, params, cache, tok, pos)


def tree_to(tree, device):
    """A (nested) parameter tree of dicts and lists with every tensor on
    ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def stack_layers(n: int, make, device=None):
    """``n`` blocks from ``make()`` (a nested dict of tensors each) stacked
    on a leading ``[n]`` axis, on ``device`` (by default where ``make``
    puts them): the stack is allocated once and filled block by block, so
    that no more than one block is held beside it."""
    def alloc(t):
        return {k: alloc(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.new_empty((n,) + t.shape)

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    def block():
        return make() if device is None else tree_to(make(), device)
    first = block()
    out = alloc(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, block(), i)
    return out


def count_params(tree) -> int:
    """Number of scalars in a (nested) parameter tree of dicts and
    lists."""
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return int(tree.numel())
