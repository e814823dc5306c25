"""MCTS-guided LM decoding domains — the PyTorch counterpart of
``repro.core.domains.lm_decode``.

State = the prefix.  Actions = the top-A next tokens under the policy LM
(ties broken towards the lower token id, as ``lax.top_k`` does).  Playout =
greedy rollout of ``rollout_len`` tokens; reward = exp(mean logprob) in
(0, 1].  Priors = the renormalised top-A probabilities (PUCT).  The playout
draws nothing: ``draw_shape`` is ``(0,)``.

* ``LMDecodeDomain`` — uncached: every step and playout token re-runs the
  whole prefix.  State ``{"toks" [max_len], "len", "plen"}``.
* ``CachedLMDecodeDomain`` — the prompt is prefilled once per search, in
  ``root_state``, and the per-sequence KV cache rides in the tree state,
  so an expand costs one incremental token and a playout ``rollout_len -
  1`` (the JAX package's last step computes logits no one reads).  State
  ``{"len", "plen", "logits" [V] f32}`` plus the family's cache leaves
  (``"k"``, ``"v"`` ``[L, max_len, Hkv, D]`` for the dense family,
  ``"toks"`` for the generic fallback).  With ``root_cache`` /
  ``root_logits`` set, ``root_state`` returns them instead of prefilling.

Cross-token hooks (read by ``core.tree.init_tree``): ``root_warm``, a
``RootCarry`` for the root's statistics, and ``root_arena`` /
``root_arena_alive``, a carried arena spliced in whole.  A carried arena's
``plen`` plane holds the previous token's prompt length; the serving
searcher rewrites it, and ``terminal`` after it, before splicing.

Every method takes states of any leading shape.  ``plen`` (the root's
prompt length) is carried in the state so that one domain whose
``prompt`` / ``prompt_len`` were stacked by ``search_batch`` decides
``is_terminal`` per root; ``root_state`` then returns ``[B] + S`` leaves.

Aliasing: the search hands ``step`` gathered copies of tree rows, but
``step`` still writes the new K/V row into a clone of the cache (the model's
``step_fn`` updates in place), so a state it is given is never modified;
``playout`` clones the cache once into scratch and advances the scratch in
place.  Memory: every tree node and pipeline lane carries a full cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.base import (ModelConfig, row_logits, seq_prefill,
                                     seq_step)

_META = ("len", "plen", "logits")


def top_k(logits, k: int):
    """``lax.top_k`` order: descending, equal values by ascending index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _f32_reciprocal(d: int) -> float:
    # a division by a constant, as XLA compiles it in the JAX package
    return float(np.float32(1.0) / np.float32(d))


@dataclasses.dataclass(frozen=True)
class LMDecodeDomain:
    cfg: ModelConfig
    params: Any
    prompt: Any                       # [buf_len] i32 (or [B, buf_len])
    num_actions: int = 4
    search_depth: int = 8             # max new tokens explored by the tree
    rollout_len: int = 4
    temperature: float = 1.0
    prompt_len: Any = None            # true prefix length (tensor, [] or
                                      # [B]); None -> prompt.shape[-1]
    root_warm: Any = None             # optional RootCarry (core.tree)
                                      # seeding the root's N / W / prior;
                                      # None searches cold
    root_arena: Any = None            # optional carried TreeArena (the
                                      # search's capacity): the previous
                                      # token's rerooted subtree, spliced in
                                      # whole by core.tree.init_tree
    root_arena_alive: Any = None      # bool ([] or [B]) gating root_arena
                                      # per root; None means alive

    @property
    def max_len(self) -> int:
        return int(self.prompt.shape[-1]) + self.search_depth \
            + self.rollout_len

    @property
    def draw_shape(self):
        return (0,)

    def sample_draws(self, shape, generator=None, device="cpu"):
        return torch.zeros(tuple(shape) + (0,), dtype=torch.int32,
                           device=device)

    def _plen(self):
        dev = self.prompt.device
        if self.prompt_len is None:
            return torch.tensor(self.prompt.shape[-1], dtype=torch.int32,
                                device=dev)
        return torch.as_tensor(self.prompt_len, device=dev).to(torch.int32)

    def _root_toks(self):
        """``(toks [*lead, max_len], plen [*lead])``, ``lead`` the shape
        of the (possibly stacked) prompt rows and lengths."""
        plen = self._plen()
        lead = torch.broadcast_shapes(tuple(self.prompt.shape[:-1]),
                                      tuple(plen.shape))
        toks = torch.zeros(lead + (self.max_len,), dtype=torch.int32,
                           device=self.prompt.device)
        toks[..., :self.prompt.shape[-1]] = self.prompt.to(torch.int32)
        return toks, plen.expand(lead).clone()

    def root_state(self):
        toks, plen = self._root_toks()
        return {"toks": toks, "len": plen, "plen": plen.clone()}

    # -- internals ----------------------------------------------------------
    def _last_logits(self, toks, ln):
        lead, m = toks.shape[:-1], toks.shape[-1]
        logits = row_logits(self.cfg, self.params, toks.reshape(-1, m))
        rows = torch.arange(logits.shape[0], device=toks.device)
        last = logits[rows, ln.reshape(-1).long() - 1].float()
        return last.reshape(lead + last.shape[-1:]) / self.temperature

    def _state_logits(self, state):
        return self._last_logits(state["toks"], state["len"])

    def _token(self, state, action):
        _, top = top_k(self._state_logits(state), self.num_actions)
        return top.gather(-1, action.long()[..., None])[..., 0] \
            .to(torch.int32)

    # -- domain API ----------------------------------------------------------
    def step(self, state, action):
        tok = self._token(state, action)
        toks = state["toks"].clone()
        torch._assert_async((state["len"] < toks.shape[-1]).all(),
                            "LMDecodeDomain.step: buffer full")
        toks.scatter_(-1, state["len"].long()[..., None], tok[..., None])
        return {"toks": toks, "len": state["len"] + 1, "plen": state["plen"]}

    def is_terminal(self, state):
        return state["len"] >= state["plen"] + self.search_depth

    def playout(self, state, draws):
        """Greedy rollout; reward = exp(mean next-token logprob)."""
        toks, ln = state["toks"].clone(), state["len"]
        acc = torch.zeros(ln.shape, dtype=torch.float32, device=ln.device)
        for _ in range(self.rollout_len):
            logits = self._last_logits(toks, ln)
            tok = logits.argmax(-1, keepdim=True)
            acc = acc + torch.log_softmax(logits, -1).gather(-1, tok)[..., 0]
            toks.scatter_(-1, ln.long()[..., None], tok.to(toks.dtype))
            ln = ln + 1
        return torch.exp(acc * _f32_reciprocal(self.rollout_len))

    def priors(self, state):
        vals, _ = top_k(self._state_logits(state), self.num_actions)
        return torch.softmax(vals, -1)


@dataclasses.dataclass(frozen=True)
class CachedLMDecodeDomain(LMDecodeDomain):
    """KV-cache-aware variant: the decisions of ``LMDecodeDomain`` (up to
    float noise), one prefill per search (see the module docstring)."""

    root_cache: Any = None            # spliced root cache (dict of tensors
                                      # in seq_prefill's layout at max_len);
                                      # None prefills the prompt
    root_logits: Any = None           # next-token logits paired with it

    def root_state(self):
        if self.root_cache is not None:
            plen = self._plen()
            lead = self.root_logits.shape[:-1]
            plen = plen.expand(lead).clone()
            return {"len": plen, "plen": plen.clone(),
                    "logits": self.root_logits, **self.root_cache}
        toks, plen = self._root_toks()
        logits, cache = seq_prefill(self.cfg, self.params, toks, plen)
        return {"len": plen, "plen": plen.clone(), "logits": logits,
                **cache}

    # -- internals ----------------------------------------------------------
    def _state_logits(self, state):
        return state["logits"].float() / self.temperature

    @staticmethod
    def cache_leaves(state):
        """The model cache's leaves of a state (all but len / plen /
        logits)."""
        return {k: v for k, v in state.items() if k not in _META}

    # -- domain API ----------------------------------------------------------
    def step(self, state, action):
        tok = self._token(state, action)
        cache = {k: v.clone() for k, v in self.cache_leaves(state).items()}
        logits, cache = seq_step(self.cfg, self.params, cache, tok,
                                 state["len"])
        return {"len": state["len"] + 1, "plen": state["plen"],
                "logits": logits, **cache}

    def playout(self, state, draws):
        """Greedy rollout; reward = exp(mean next-token logprob).  Token t
        consumes the logits step t - 1 produced; the cache is advanced in
        a scratch copy."""
        cache = {k: v.clone() for k, v in self.cache_leaves(state).items()}
        logits, ln = state["logits"], state["len"]
        acc = torch.zeros(ln.shape, dtype=torch.float32, device=ln.device)
        for t in range(self.rollout_len):
            scaled = logits.float() / self.temperature
            tok = scaled.argmax(-1, keepdim=True)
            acc = acc + torch.log_softmax(scaled, -1).gather(-1, tok)[..., 0]
            if t + 1 < self.rollout_len:
                logits, cache = seq_step(self.cfg, self.params, cache,
                                         tok[..., 0].to(torch.int32), ln)
                ln = ln + 1
        return torch.exp(acc * _f32_reciprocal(self.rollout_len))
