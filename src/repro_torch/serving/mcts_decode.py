"""MCTS-guided decoding on ``repro_torch.search`` — the counterpart of
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

KV-cache-aware by default (``MCTSDecodeConfig.cached``): the stateless
searcher prefills every request's prefix ONCE per token, as one batched
prefill, takes the root top-k from those logits and hands the cache to the
search as its roots (``CachedLMDecodeDomain.root_cache`` /
``root_logits``).

Cross-token carries (``ReusableSearcher``, returned by
``make_batched_searcher`` when ``kv_splice`` or ``tree_reuse`` is on):

* ``kv_splice`` — each slot's root cache row and next-token logits are
  carried: a request is prefilled once, at admission, and each committed
  token costs one batched ``seq_step`` over all slots;
* ``tree_reuse`` — each slot's searched arena is rerooted on the
  committed child and spliced in as the next search's starting tree.

Multi-device (``mesh=``, a ``repro_torch.parallel.SearchMesh``): the
slots are padded to a multiple of the mesh's entries, and the pad rows
ride along as permanently dead slots (length 0).  Each entry searches
its own contiguous block of slots on its device (``MeshSearcher``), with
``params`` placed once on each distinct device; every carry leaf stays
with the entry that owns its slots, and only the chosen tokens are
gathered.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.domains.lm_decode import (CachedLMDecodeDomain,
                                                LMDecodeDomain, top_k)
from repro_torch.core.tree import reroot, reroot_ok
from repro_torch.models.base import (ModelConfig, seq_prefill, seq_step,
                                     tree_to)
from repro_torch.parallel.mesh import SearchMesh, gather_rows
from repro_torch.search import SearchConfig, SearchParams, search_stacked
from repro_torch.search.api import _draws, resolve_device, resolve_mesh

__all__ = ["MCTSDecodeConfig", "MeshSearcher", "ReusableSearcher",
           "make_batched_searcher", "mcts_decode", "mcts_decode_batch"]


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
    kv_splice: bool = False    # cross-token root-cache carry
    tree_reuse: bool = False   # cross-token subtree reuse
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


def _cold_roots(dom, dcfg: MCTSDecodeConfig):
    """One batched prefill of the roots: the domain with them spliced in
    (cached) and each root's top-A tokens ``[B, A]``."""
    root = dom.root_state()
    if dcfg.cached:
        dom = dataclasses.replace(dom, root_cache=dom.cache_leaves(root),
                                  root_logits=root["logits"])
    return dom, top_k(dom._state_logits(root), dcfg.num_actions)[1]


def _buffers(buf, lens, batch: int, dev):
    buf = torch.as_tensor(buf, device=dev).to(torch.int32)
    lens = torch.as_tensor(lens, device=dev).to(torch.int32)
    if buf.shape[0] != batch:
        raise ValueError(f"searcher built for {batch} slots, got "
                         f"{buf.shape[0]}")
    return buf, lens


class ReusableSearcher:
    """Batched per-token searcher with an explicit cross-token carry, the
    JAX package's ``ReusableSearcher`` on one device.  The carry is a dict
    of per-slot tensors:

    * ``"cache"`` / ``"logits"`` (``kv_splice``) — each slot's root cache
      row (the family's cache leaves at ``max_len``, ``[B, ...]``) and its
      next-token logits ``[B, V]``, advanced by one ``seq_step`` when a
      token commits;
    * ``"arena"`` / ``"action"`` / ``"alive"`` (``tree_reuse``) — the
      previous token's searched arena (batch B), the actions committed
      and a liveness flag per slot.  The next step reroots the arena on
      the committed child and splices it in as the search's starting tree
      (``LMDecodeDomain.root_arena``); a dead or unreusable slot searches
      cold, bit for bit.

    ``init_carry`` zeroes the cache rows and logits (dead until ``admit``
    prefills them) and leaves ``"arena"`` None: the first ``step``
    searches every slot cold, as the JAX package's all-dead identity carry
    does, without a zero arena the size of a searched one.

    Protocol::

        carry = s.init_carry(buf_len)            # engine start
        carry = s.admit(carry, slot, row, plen)  # request admitted
        toks, carry = s.step(buf, lens, rng, carry)   # one token, B slots

    ``admit`` is a request's only prefill; eviction needs no call
    (readmission overwrites the slot).  ``admit`` and ``step`` update the
    carry's tensors in place and return it: a caller that needs a carry
    as it was clones it first.
    """

    def __init__(self, cfg: ModelConfig, params, dcfg: MCTSDecodeConfig,
                 batch: int, *, device=None):
        if not dcfg.stateful:
            raise ValueError("ReusableSearcher needs kv_splice or "
                             "tree_reuse; the stateless searcher is "
                             "make_batched_searcher's")
        self.dev = resolve_device(device)
        self.cfg, self.dcfg, self.batch = cfg, dcfg, batch
        self.params = tree_to(params, self.dev)
        self.scfg = dcfg.search_config()

    # -- carry lifecycle ----------------------------------------------------
    def _max_len(self, buf_len: int) -> int:
        return buf_len + self.dcfg.search_depth + self.dcfg.rollout_len

    def init_carry(self, buf_len: int) -> dict:
        """The identity carry for ``batch`` slots sharing a ``[*,
        buf_len]`` token buffer: every slot dead, its cache row and logits
        zero."""
        carry = {}
        if self.dcfg.tree_reuse:
            carry["arena"] = None
            carry["action"] = torch.zeros((self.batch,), dtype=torch.int32,
                                          device=self.dev)
            carry["alive"] = torch.zeros((self.batch,), dtype=torch.bool,
                                         device=self.dev)
        if self.dcfg.kv_splice:
            # the prefill's shapes, as the JAX package's eval_shape gives
            # them: on the meta device it computes nothing
            meta = torch.device("meta")
            logits, cache = seq_prefill(
                self.cfg, tree_to(self.params, meta),
                torch.zeros((1, self._max_len(buf_len)), dtype=torch.int32,
                            device=meta),
                torch.ones((1,), dtype=torch.int32, device=meta))
            zeros = lambda v: torch.zeros((self.batch,) + v.shape[1:],
                                          dtype=v.dtype, device=self.dev)
            carry["cache"] = {k: zeros(v) for k, v in cache.items()}
            carry["logits"] = zeros(logits)
        return carry

    def admit(self, carry: dict, slot: int, buf_row, plen: int) -> dict:
        """Reset ``slot`` for a fresh request whose padded prefix is
        ``buf_row`` (``[buf_len]``) with true length ``plen``: the carried
        tree dies, and the root cache row is prefilled ONCE."""
        if self.dcfg.tree_reuse:
            carry["alive"][slot] = False
        if self.dcfg.kv_splice:
            row = torch.as_tensor(buf_row, device=self.dev).to(torch.int32)
            toks = torch.zeros((1, self._max_len(row.shape[-1])),
                               dtype=torch.int32, device=self.dev)
            toks[0, :row.shape[-1]] = row
            plen_t = torch.full((1,), int(plen), dtype=torch.int32,
                                device=self.dev)
            logits, cache = seq_prefill(self.cfg, self.params, toks, plen_t)
            for k, v in cache.items():
                carry["cache"][k][slot] = v[0]
            carry["logits"][slot] = logits[0]
        return carry

    # -- per-token step -----------------------------------------------------
    def _carried_arena(self, carry: dict, dom, lens):
        """The previous arenas rerooted on the committed actions, with the
        horizon moved to this token's prompt lengths, and the slots whose
        carry is reusable: alive, and the committed child expanded."""
        arena, carry["arena"] = carry["arena"], None
        use = carry["alive"] & reroot_ok(arena, carry["action"])
        ar = reroot(arena, carry["action"])
        del arena
        # every carried row's plen is the previous token's; rewrite it on
        # all N rows, then derive terminal from it (len >= plen + depth)
        ar.state["plen"] = lens[:, None].expand(ar.parent.shape).clone()
        return ar.replace(terminal=dom.is_terminal(ar.state)), use

    def step(self, buf, lens, rng, carry: dict):
        """One batched search over all slots -> (each slot's chosen token
        ``[B]`` i32, the carry advanced by the committed tokens)."""
        d = self.dcfg
        buf, lens = _buffers(buf, lens, self.batch, self.dev)
        extra = {}
        if d.kv_splice:
            extra = dict(root_cache=carry["cache"],
                         root_logits=carry["logits"])
        dom = _domain(self.cfg, self.params, buf, d, prompt_len=lens,
                      **extra)
        if d.kv_splice:
            # the carried logits ARE the roots' next-token distributions
            _, tops = top_k(carry["logits"], d.num_actions)
        else:
            dom, tops = _cold_roots(dom, d)
        if d.tree_reuse and carry["arena"] is not None:
            ar, use = self._carried_arena(carry, dom, lens)
            dom = dataclasses.replace(dom, root_arena=ar,
                                      root_arena_alive=use)
            del ar
        res = search_stacked(dom, self.batch, self.scfg, rng,
                             device=self.dev)
        del dom
        toks = tops.gather(1, res.best_action.long()[:, None])[:, 0] \
            .to(torch.int32)
        if d.tree_reuse:
            carry["arena"] = res.tree
            carry["action"] = res.best_action.to(torch.int32)
            carry["alive"] = torch.ones_like(carry["alive"])
        if d.kv_splice:
            # every slot's root row advanced by its committed token at its
            # length: one step, where the cold path prefills the prefix
            logits, carry["cache"] = seq_step(self.cfg, self.params,
                                              carry["cache"], toks, lens)
            carry["logits"] = logits
        return toks, carry


def make_batched_searcher(cfg: ModelConfig, params, dcfg: MCTSDecodeConfig,
                          batch: int, *, device=None, mesh=None):
    """The per-token batched searcher.  Stateless (default): ``step(buf [B,
    buf_len] i32, lens [B] i32, rng=0) -> [B] i32``, each slot's chosen
    next token.  With ``dcfg.kv_splice`` or ``dcfg.tree_reuse``: a
    ``ReusableSearcher``, whose ``step`` also threads the carry.  ``rng``
    seeds the playout draws (the LM playout is greedy and draws none).
    Runs on ``cuda:0`` unless ``device`` is given; ``params`` are moved
    there once.  ``mesh`` as for ``search_batch`` (``resolve_mesh``): a
    ``SearchMesh`` gives a ``MeshSearcher`` with the same interface."""
    mesh = resolve_mesh(mesh, batch, device)
    if mesh is not None:
        return MeshSearcher(cfg, params, dcfg, batch, mesh)
    if dcfg.stateful:
        return ReusableSearcher(cfg, params, dcfg, batch, device=device)
    dev = resolve_device(device)
    params = tree_to(params, dev)
    scfg = dcfg.search_config()

    def step(buf, lens, rng=0):
        buf, lens = _buffers(buf, lens, batch, dev)
        dom, top = _cold_roots(_domain(cfg, params, buf, dcfg,
                                       prompt_len=lens), dcfg)
        res = search_stacked(dom, batch, scfg, rng, device=dev)
        return top.gather(1, res.best_action.long()[:, None])[:, 0] \
            .to(torch.int32)

    return step


class MeshSearcher:
    """The per-token searcher over a ``SearchMesh``, stateless or with the
    carry (``init_carry`` / ``admit`` / ``step``, as ``ReusableSearcher``).

    The ``batch`` slots are padded to ``padded``, a multiple of the
    mesh's entries; pad rows are searched as dead slots (length 0, never
    admitted) and their tokens dropped.  Entry i owns slots ``[i * blk,
    (i + 1) * blk)`` and searches them with its own single-device searcher
    on its device; the parameters are placed once per distinct device.
    The carry maps each of this process's entries to that searcher's
    carry, which stays on the entry's device.  Draws are made for the
    ``padded`` rows from ``rng`` and split by block, so pad rows consume
    their own (as in the JAX package).  Only the tokens are gathered, to
    ``mesh.home`` in every process of the mesh.
    """

    def __init__(self, cfg: ModelConfig, params, dcfg: MCTSDecodeConfig,
                 batch: int, mesh: SearchMesh):
        self.cfg, self.params, self.dcfg, self.batch = cfg, params, dcfg, \
            batch
        self.mesh = mesh
        self.padded = batch + (-batch) % mesh.size
        self.blk = self.padded // mesh.size
        self.scfg = dcfg.search_config()
        placed = {}
        self.parts = {}
        for i, e in mesh.local():
            if e.device not in placed:
                placed[e.device] = tree_to(params, e.device)
            self.parts[i] = make_batched_searcher(
                cfg, placed[e.device], dcfg, self.blk, device=e.device,
                mesh=False)

    def _blocks(self, buf, lens, rng):
        """Per local entry: ``(entry device, rows, buf, lens, draws)`` of
        its block of the padded slots."""
        buf = torch.as_tensor(buf).to(torch.int32)
        lens = torch.as_tensor(lens).to(torch.int32)
        if buf.shape[0] != self.batch:
            raise ValueError(f"searcher built for {self.batch} slots, got "
                             f"{buf.shape[0]}")
        extra = self.padded - self.batch
        if extra:
            buf = torch.cat([buf, buf.new_zeros((extra, buf.shape[1]))])
            lens = torch.cat([lens, lens.new_zeros((extra,))])
        dom = _domain(self.cfg, self.params, buf, self.dcfg,
                      prompt_len=lens)
        draws = _draws(dom, self.scfg, rng, (self.padded,),
                       torch.device("cpu"))
        for i in self.parts:
            dev = self.mesh.entries[i].device
            rows = slice(i * self.blk, (i + 1) * self.blk)
            yield i, buf[rows].to(dev), lens[rows].to(dev), draws[rows]

    def __call__(self, buf, lens, rng=0):
        local = {i: self.parts[i](b, n, d)
                 for i, b, n, d in self._blocks(buf, lens, rng)}
        return gather_rows(self.mesh, local, self.batch)

    def init_carry(self, buf_len: int) -> dict:
        return {i: p.init_carry(buf_len) for i, p in self.parts.items()}

    def admit(self, carry: dict, slot: int, buf_row, plen: int) -> dict:
        i, j = divmod(int(slot), self.blk)
        if i in self.parts:
            carry[i] = self.parts[i].admit(carry[i], j, buf_row, plen)
        return carry

    def step(self, buf, lens, rng, carry: dict):
        local = {}
        for i, b, n, d in self._blocks(buf, lens, rng):
            local[i], carry[i] = self.parts[i].step(b, n, d, carry[i])
        return gather_rows(self.mesh, local, self.batch), carry


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
                      device=None, mesh=None) -> List[List[int]]:
    """Decode B prompts together: each of the ``n_tokens`` steps is one
    batched multi-root search over all requests.  ``prompts`` is ``[B,
    plen]`` or a ragged list of 1-D token sequences.  With ``kv_splice`` /
    ``tree_reuse`` the carry is threaded across the tokens: every prompt
    is admitted (prefilled once) up front.  ``mesh`` as in
    ``make_batched_searcher``; the buffers then live on ``mesh.home``."""
    buf, lens = _pad_prompts(prompts, n_tokens)
    b = buf.shape[0]
    mesh = resolve_mesh(mesh, b, device)
    dev = mesh.home if mesh is not None else resolve_device(device)
    searcher = make_batched_searcher(
        cfg, params, dcfg, b, device=None if mesh is not None else dev,
        mesh=mesh if mesh is not None else False)
    buf_t = torch.from_numpy(buf).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    rows = torch.arange(b, device=dev)
    carry = None
    if dcfg.stateful:
        carry = searcher.init_carry(buf.shape[1])
        for i in range(b):
            carry = searcher.admit(carry, i, buf[i], int(lens[i]))
    out: List[List[int]] = [[] for _ in range(b)]
    for t in range(n_tokens):
        if carry is None:
            toks = searcher(buf_t, lens_t, seed + t)
        else:
            toks, carry = searcher.step(buf_t, lens_t, seed + t, carry)
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
