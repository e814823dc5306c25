"""MCTS-guided decoding on ``repro_torch.search`` — the stateless half of
``repro.serving.mcts_decode``.

For each emitted token, one search (any registered strategy, default the
paper's pipeline) explores the top-A continuations: Select / Expand /
Backup walk the token tree while the Playout stage evaluates LM rollouts in
``lanes`` parallel lanes.  The chosen root action's token is committed and
the next token's search starts from the extended prefix.

* ``mcts_decode``        — one request.
* ``mcts_decode_batch``  — B requests; every decode step is ONE batched
  search over all of them (``search_stacked`` on one domain whose
  ``prompt`` / ``prompt_len`` hold the B requests).  Prompts may be
  ragged: they share a padded token buffer, and the true lengths ride
  along as ``LMDecodeDomain.prompt_len``.

KV-cache-aware by default (``MCTSDecodeConfig.cached``): the searcher
prefills every request's prefix ONCE per token, as one batched prefill,
takes the root top-k from those logits and hands the cache to the search
as its roots (``CachedLMDecodeDomain.root_cache`` / ``root_logits``).

Not ported yet: the cross-token carries ``kv_splice`` and ``tree_reuse``
(``ReusableSearcher``, ROADMAP Queue 1 item 10) and multi-device meshes
(item 12).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.domains.lm_decode import (CachedLMDecodeDomain,
                                                LMDecodeDomain, top_k)
from repro_torch.models.base import ModelConfig, tree_to
from repro_torch.search import SearchConfig, SearchParams, search_stacked
from repro_torch.search.api import resolve_device

__all__ = ["MCTSDecodeConfig", "make_batched_searcher", "mcts_decode",
           "mcts_decode_batch"]

_NOT_PORTED = ("{} carries state across tokens, which the port does not "
               "have yet (ROADMAP Queue 1 item 10: ReusableSearcher)")


@dataclasses.dataclass(frozen=True)
class MCTSDecodeConfig:
    """The JAX package's ``MCTSDecodeConfig``, field for field."""

    method: str = "pipeline"   # any registered strategy
    num_actions: int = 4
    budget: int = 32           # playouts per emitted token
    lanes: int = 4             # parallel playout stages
    search_depth: int = 8
    rollout_len: int = 4
    cp: float = 1.0
    temperature: float = 1.0
    cached: bool = True        # CachedLMDecodeDomain (one prefill/token)
    kv_splice: bool = False    # cross-token root-cache carry (not ported)
    tree_reuse: bool = False   # cross-token subtree reuse (not ported)
    wave_select: str = "auto"
    kernels: str = "auto"
    vl_mode: str = "loss"
    level_assign: str = "independent"
    arena_nodes: int = 0

    def __post_init__(self):
        if self.kv_splice and not self.cached:
            raise ValueError("kv_splice carries KV rows across tokens and "
                             "therefore requires cached=True")
        if self.tree_reuse and self.method == "root":
            raise ValueError(
                "tree_reuse reroots the search tree across tokens, but the "
                "'root' strategy keeps no shared tree; pick a tree-bearing "
                "method")

    @property
    def stateful(self) -> bool:
        return self.kv_splice or self.tree_reuse

    @property
    def resolved_arena_nodes(self) -> int:
        return self.arena_nodes or 2 * self.budget + 2

    def search_config(self) -> SearchConfig:
        return SearchConfig(
            method=self.method, budget=self.budget, lanes=self.lanes,
            keep_tree=self.tree_reuse,
            max_nodes=self.resolved_arena_nodes if self.tree_reuse else 0,
            kernels=self.kernels, wave_select=self.wave_select,
            vl_mode=self.vl_mode, level_assign=self.level_assign,
            params=SearchParams(cp=self.cp, max_depth=self.search_depth,
                                puct=True))


def _domain(cfg: ModelConfig, params, prompt, dcfg: MCTSDecodeConfig,
            prompt_len=None, **extra) -> LMDecodeDomain:
    cls = CachedLMDecodeDomain if dcfg.cached else LMDecodeDomain
    return cls(cfg=cfg, params=params, prompt=prompt,
               num_actions=dcfg.num_actions, search_depth=dcfg.search_depth,
               rollout_len=dcfg.rollout_len, temperature=dcfg.temperature,
               prompt_len=prompt_len, **extra)


def make_batched_searcher(cfg: ModelConfig, params, dcfg: MCTSDecodeConfig,
                          batch: int, *, device=None):
    """The per-token batched searcher: ``step(buf [B, buf_len] i32, lens
    [B] i32, rng=0) -> [B] i32``, each slot's chosen next token.  ``rng``
    seeds the playout draws (the LM playout is greedy and draws none).
    Runs on ``cuda:0`` unless ``device`` is given; ``params`` are moved
    there once."""
    if dcfg.stateful:
        raise NotImplementedError(_NOT_PORTED.format(
            "kv_splice" if dcfg.kv_splice else "tree_reuse"))
    dev = resolve_device(device)
    params = tree_to(params, dev)
    scfg = dcfg.search_config()

    def step(buf, lens, rng=0):
        buf = torch.as_tensor(buf, device=dev).to(torch.int32)
        lens = torch.as_tensor(lens, device=dev).to(torch.int32)
        if buf.shape[0] != batch:
            raise ValueError(f"searcher built for {batch} slots, got "
                             f"{buf.shape[0]}")
        dom = _domain(cfg, params, buf, dcfg, prompt_len=lens)
        root = dom.root_state()             # one batched prefill
        if dcfg.cached:
            dom = dataclasses.replace(
                dom, root_cache=dom.cache_leaves(root),
                root_logits=root["logits"])
        res = search_stacked(dom, batch, scfg, rng, device=dev)
        _, top = top_k(dom._state_logits(root), dcfg.num_actions)
        return top.gather(1, res.best_action.long()[:, None])[:, 0] \
            .to(torch.int32)

    return step


def _pad_prompts(prompts, n_tokens: int):
    """Equal-length ``[B, plen]`` or ragged list-of-sequences prompts ->
    (padded buffer ``[B, max_plen + n_tokens]`` i32, true lengths ``[B]``
    i32), numpy."""
    if isinstance(prompts, (list, tuple)):
        rows = [np.asarray(p, np.int32) for p in prompts]
        if any(r.ndim != 1 for r in rows):
            raise ValueError("ragged prompts must be a list of 1-D token "
                             f"sequences, got ndims {[r.ndim for r in rows]}")
    else:
        arr = np.asarray(prompts, np.int32)
        if arr.ndim != 2:
            raise ValueError("prompts must be [B, plen] or a (ragged) list "
                             f"of 1-D sequences, got shape {arr.shape}")
        rows = list(arr)
    if not rows:
        raise ValueError("prompts must contain at least one request")
    lens = np.array([len(r) for r in rows], np.int32)
    if (lens == 0).any():
        raise ValueError("every prompt needs at least one token, got "
                         f"lengths {lens.tolist()}")
    buf = np.zeros((len(rows), int(lens.max()) + n_tokens), np.int32)
    for i, r in enumerate(rows):
        buf[i, : len(r)] = r
    return buf, lens


def mcts_decode_batch(cfg: ModelConfig, params, prompts, n_tokens: int,
                      dcfg: MCTSDecodeConfig, seed: int = 0, *,
                      device=None) -> List[List[int]]:
    """Decode B prompts together: each of the ``n_tokens`` steps is one
    batched multi-root search over all requests.  ``prompts`` is ``[B,
    plen]`` or a ragged list of 1-D token sequences."""
    buf, lens = _pad_prompts(prompts, n_tokens)
    b = buf.shape[0]
    searcher = make_batched_searcher(cfg, params, dcfg, b, device=device)
    dev = resolve_device(device)
    buf_t = torch.from_numpy(buf).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    rows = torch.arange(b, device=dev)
    out: List[List[int]] = [[] for _ in range(b)]
    for t in range(n_tokens):
        toks = searcher(buf_t, lens_t, seed + t)
        buf_t[rows, lens_t.long()] = toks
        lens_t = lens_t + 1
        for i, tok in enumerate(toks.cpu().tolist()):
            out[i].append(int(tok))
    return out


def mcts_decode(cfg: ModelConfig, params, prompt, n_tokens: int,
                dcfg: MCTSDecodeConfig, seed: int = 0, *,
                device=None) -> List[int]:
    """Emit ``n_tokens`` tokens for one prompt, one search per token."""
    prompt = np.asarray(prompt, np.int32).reshape(1, -1)
    return mcts_decode_batch(cfg, params, prompt, n_tokens, dcfg, seed,
                             device=device)[0]
