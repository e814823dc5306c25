"""The public search API — the PyTorch counterpart of ``repro.search.api``.

    from repro_torch.search import SearchConfig, search, search_batch

    res = search(domain, SearchConfig(method="pipeline", budget=256,
                                      lanes=8), rng=0)
    res.best_action          # recommended root action (robust child)
    res.action_visits        # [A] root child visit counts
    res.stats                # common schema, identical keys for all methods

Device: the entry points run on ``cuda:0`` unless the caller passes
``device=`` (``device="cpu"`` runs the plain PyTorch versions of the
kernels).  With no CUDA device and no explicit device they raise; they
never fall back to the CPU.

Randomness: every playout's randomness is an explicit draw tensor.  ``rng``
is either such a tensor, shaped ``draws_shape(domain, cfg)`` for ``search``
and ``(B,) + draws_shape(domain, cfg)`` for ``search_batch``, or a seed /
``torch.Generator`` from which the draws are made on the CPU (so the same
seed gives the same search on every device).

``search_batch`` runs B searches (each under its own draws) as one batched
program: every arena plane carries a leading batch axis; with a mesh
(``repro_torch.parallel.mesh``) the batch is split over its devices and
processes (``search.sharding``).  The B domains are
of one class and may differ in tensor-valued fields only (a decode
request's prompt and its length); those are stacked, as the JAX package
stacks them, into ONE domain whose ``root_state()`` returns the B roots'
states.  The root state is computed once per call.  A caller that already
holds such a stacked domain passes it to ``search_stacked``.  Strategies
register ``fn(domain, cfg, draws, root_state)`` with the trailing draw
shape they consume, and return batched ``SearchResult``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.arena import TreeArena
from repro_torch.core.stages import SearchParams
from repro_torch.core.tree import Tree, root_child_stats
from repro_torch.search.domain import Domain, missing_members

__all__ = [
    "STATS_KEYS", "SearchConfig", "SearchResult", "StrategyFn",
    "register_strategy", "get_strategy", "list_strategies", "draws_shape",
    "make_stats", "result_from_tree", "resolve_device", "resolve_mesh",
    "search",
    "search_batch", "search_stacked",
]

STATS_KEYS = ("playouts", "playouts_requested", "playouts_completed",
              "duplicates", "ticks")

StrategyFn = Callable[..., "SearchResult"]

_STRATEGIES: Dict[str, StrategyFn] = {}
_DRAWS: Dict[str, Callable[[Any, "SearchConfig"], tuple]] = {}


class SearchResult(NamedTuple):
    """Standardized result — identical field set for every strategy.

    ``tree`` is the batched arena for single-tree strategies, ``None`` for
    root parallelization or when ``keep_tree`` is False.  ``stats`` carries
    exactly ``STATS_KEYS`` (int32); ``extras`` holds per-strategy
    diagnostics."""

    action_visits: torch.Tensor        # [(B,) A] i32
    action_value: torch.Tensor         # [(B,) A] f32
    best_action: torch.Tensor          # [(B,)] i32
    tree: Optional[Tree]
    stats: Dict[str, torch.Tensor]
    extras: Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """One config for all strategies (see ``repro.search.api.SearchConfig``).
    ``kernels`` / ``wave_select`` / ``vl_mode`` / ``level_assign`` other
    than their defaults are forwarded into ``params``."""

    method: str = "sequential"
    budget: int = 256
    lanes: int = 1
    max_nodes: int = 0
    keep_tree: bool = True
    params: SearchParams = dataclasses.field(default_factory=SearchParams)
    kernels: str = "auto"
    wave_select: str = "auto"
    vl_mode: str = "loss"
    level_assign: str = "independent"

    def __post_init__(self):
        upd = {}
        if self.kernels != "auto" and self.params.kernels == "auto":
            upd["kernels"] = self.kernels
        if self.wave_select != "auto" and self.params.wave_select == "auto":
            upd["wave_select"] = self.wave_select
        if self.vl_mode != "loss" and self.params.vl_mode == "loss":
            upd["vl_mode"] = self.vl_mode
        if self.level_assign != "independent" \
                and self.params.level_assign == "independent":
            upd["level_assign"] = self.level_assign
        if upd:
            object.__setattr__(
                self, "params", dataclasses.replace(self.params, **upd))


# ---------------------------------------------------------------------------
# strategy registry
# ---------------------------------------------------------------------------
def register_strategy(name: str, *, draws: Callable[[Any, SearchConfig],
                                                    tuple]):
    """Decorator: register ``fn(domain, cfg, draws, device)`` under
    ``name``; ``draws(domain, cfg)`` gives the shape of one search's draw
    tensor.  Re-registering a name overwrites it."""
    def deco(fn: StrategyFn) -> StrategyFn:
        _STRATEGIES[name] = fn
        _DRAWS[name] = draws
        return fn
    return deco


def get_strategy(name: str) -> StrategyFn:
    _ensure_builtin_strategies()
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown search method {name!r}; "
                         f"registered: {list_strategies()}") from None


def list_strategies() -> List[str]:
    _ensure_builtin_strategies()
    return sorted(_STRATEGIES)


def draws_shape(domain, cfg: SearchConfig) -> tuple:
    """Shape of one search's draw tensor under ``cfg.method``."""
    get_strategy(cfg.method)
    return tuple(_DRAWS[cfg.method](domain, cfg))


def _ensure_builtin_strategies() -> None:
    from repro_torch.search import strategies  # noqa: F401


# ---------------------------------------------------------------------------
# result assembly helpers (used by strategies.py)
# ---------------------------------------------------------------------------
def make_stats(batch: int, requested, completed, duplicates, ticks,
               device) -> Dict[str, torch.Tensor]:
    as_b = lambda x: torch.as_tensor(x, device=device).to(torch.int32) \
        .expand(batch).clone()
    completed = as_b(completed)
    return {"playouts": completed, "playouts_requested": as_b(requested),
            "playouts_completed": completed.clone(),
            "duplicates": as_b(duplicates), "ticks": as_b(ticks)}


def result_from_tree(tree: Tree, stats, extras=None) -> SearchResult:
    n, w, valid = root_child_stats(tree)
    best = torch.argmax(torch.where(valid, n, -1), dim=-1).int()
    return SearchResult(action_visits=n.int(), action_value=w,
                        best_action=best, tree=tree, stats=stats,
                        extras=extras or {})


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def resolve_device(device=None) -> torch.device:
    """``cuda:0`` by default, or inside an initialised process group of
    world size > 1 the rank's own card, ``cuda:$LOCAL_RANK`` (default:
    the rank); raises when there is no such CUDA device and the caller
    did not ask for one explicitly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device by default and "
                           "none is available; pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    from repro_torch.parallel.mesh import local_rank
    idx = local_rank()
    if idx >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {idx} has no card of its own "
                           f"({torch.cuda.device_count()} visible); pass "
                           "device= explicitly")
    return torch.device("cuda", idx)


def _draws(domain, cfg, rng, lead: tuple, device) -> torch.Tensor:
    shape = lead + draws_shape(domain, cfg)
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != shape:
            raise ValueError(f"draws for method {cfg.method!r} must have "
                             f"shape {shape}, got {tuple(rng.shape)}")
        return rng.to(device)
    gen = rng
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(rng))
    lead_shape = shape[:len(shape) - len(domain.draw_shape)]
    return domain.sample_draws(lead_shape, gen, "cpu").to(device)


def _root_state(domain, stacked: bool, batch: int, device):
    """The B roots' state (leaves ``[B] + S`` on ``device``) from ONE call
    of ``domain.root_state()``; an unstacked domain's root is shared."""
    out = {}
    for k, v in domain.root_state().items():
        v = torch.as_tensor(v, device=device)
        if stacked and (v.dim() == 0 or v.shape[0] != batch):
            raise TypeError(f"root_state() of a domain stacked over {batch} "
                            f"roots returned leaf {k!r} of shape "
                            f"{tuple(v.shape)}")
        out[k] = v if stacked else v.expand((batch,) + tuple(v.shape))
    return out


def _run(domain, cfg: SearchConfig, draws, root_state) -> SearchResult:
    res = get_strategy(cfg.method)(domain, cfg, draws, root_state)
    missing = set(STATS_KEYS) ^ set(res.stats)
    if missing:
        raise RuntimeError(f"strategy {cfg.method!r} broke the common stats "
                           f"schema (symmetric difference: {sorted(missing)})")
    if not cfg.keep_tree:
        res = res._replace(tree=None)
    return res


def _check(domain) -> None:
    if not isinstance(domain, Domain):
        raise TypeError(
            f"{type(domain).__name__} does not satisfy the Domain protocol "
            f"(missing {missing_members(domain)}); see repro_torch.search."
            "domain")


def search(domain, cfg: SearchConfig, rng, *, device=None) -> SearchResult:
    """Run one search.  The result has no batch axis, except ``tree``,
    which is the arena with a batch of one; a carried ``root_arena`` on
    the domain has a batch of one too."""
    _check(domain)
    dev = resolve_device(device)
    draws = _draws(domain, cfg, rng, (), dev)[None]
    res = _run(domain, cfg, draws, _root_state(domain, False, 1, dev))
    first = lambda d: {k: v[0] if isinstance(v, torch.Tensor) else v
                       for k, v in d.items()}
    return res._replace(action_visits=res.action_visits[0],
                        action_value=res.action_value[0],
                        best_action=res.best_action[0],
                        stats=first(res.stats), extras=first(res.extras))


def search_batch(domains: Sequence[Any], cfg: SearchConfig, rng, *,
                 device=None, mesh=None) -> SearchResult:
    """B searches, each under its own draws, as one batched program; every
    result leaf gains a leading batch axis.  With draw tensors,
    ``search_batch(ds, cfg, draws)[i] == search(ds[i], cfg, draws[i])``.

    The domains share one dataclass and differ, if at all, in tensor-valued
    fields (or dicts of tensors, as a ``root_warm`` carry), which are
    stacked on a new leading axis, and in carried ``TreeArena``s of batch
    one (``root_arena``), which are concatenated along their batch axis;
    fields that differ otherwise (``num_actions``, depths, seeds) raise
    TypeError.

    Mesh: a ``SearchMesh`` (``repro_torch.parallel.mesh``) shards the
    batch over its entries (``shard_search_batch``); ``False`` forces one
    device; ``None`` shards only inside an initialised process group of
    world size > 1 with B > 1, over ``make_search_mesh(device=device)``.
    The JAX package auto-shards whenever ``jax.device_count() > 1``, the
    devices its one program drives; the devices this program drives are
    those of its process group, one process per device, since one
    process driving several devices in turn pays each one's host time."""
    domains = list(domains)
    if not domains:
        raise ValueError("search_batch needs at least one domain")
    _check(domains[0])
    mesh = resolve_mesh(mesh, len(domains), device)
    if mesh is not None:
        from repro_torch.search.sharding import shard_search_batch
        return shard_search_batch(domains, cfg, rng, mesh=mesh)
    dom, stacked = _batch_domains(domains)
    return _search_b(dom, stacked, len(domains), cfg, rng, device)


def resolve_mesh(mesh, batch: int, device=None):
    """The mesh rule shared by ``search_batch`` and the serving searchers:
    ``None`` auto-shards over ``make_search_mesh(device=device)`` inside
    an initialised process group of world size > 1 when ``batch > 1``,
    ``False`` forces one device (returns None), a ``SearchMesh`` is
    returned as it is; anything else raises TypeError."""
    from repro_torch.parallel.mesh import (SearchMesh, make_search_mesh,
                                           process_count)
    if mesh is None:
        if batch > 1 and process_count() > 1:
            return make_search_mesh(device=device)
        return None
    if mesh is False:
        return None
    if not isinstance(mesh, SearchMesh):
        raise TypeError(f"mesh must be None, False or a SearchMesh, got "
                        f"{type(mesh).__name__}")
    if device is not None:
        raise ValueError("pass a device or a mesh, not both: a mesh names "
                         "its own devices")
    return mesh


def search_stacked(domain, batch: int, cfg: SearchConfig, rng, *,
                   device=None) -> SearchResult:
    """``search_batch`` over a domain whose tensor fields already carry the
    batch axis, as ``search_batch`` stacks B domains: its ``root_state()``
    returns ``[batch] + S`` leaves, and a carried ``root_arena`` has
    batch ``batch``.  For a caller that holds the batch already (the
    batched decode searcher), with no split and restack."""
    _check(domain)
    return _search_b(domain, True, batch, cfg, rng, device)


def _search_b(dom, stacked: bool, b: int, cfg, rng, device) -> SearchResult:
    dev = resolve_device(device)
    draws = _draws(dom, cfg, rng, (b,), dev)
    return _run(dom, cfg, draws, _root_state(dom, stacked, b, dev))


_TREE_HOOKS = ("root_warm", "root_arena", "root_arena_alive")


def _same(a, b) -> bool:
    """Two field values are interchangeable: the same object, equal
    tensors, dicts of such, or equal plain values."""
    if a is b:
        return True
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))
    if isinstance(a, TreeArena) or isinstance(b, TreeArena):
        return (isinstance(a, TreeArena) and isinstance(b, TreeArena)
                and all(_same(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a)))
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(_same(a[k], b[k]) for k in a))
    return type(a) is type(b) and a == b


def _stackable(v) -> bool:
    if isinstance(v, dict):
        return all(_stackable(x) for x in v.values())
    return isinstance(v, (torch.Tensor, TreeArena))


def _stack(vals):
    if isinstance(vals[0], TreeArena):    # batch-1 arenas: concatenated
        return TreeArena.cat(vals)
    if isinstance(vals[0], dict):
        return {k: _stack([v[k] for v in vals]) for k in vals[0]}
    return torch.stack(vals)


def _batch_domains(domains):
    """``(domain, stacked)``: the first domain when all are the same, else
    one domain whose differing tensor fields are stacked over the batch."""
    d0 = domains[0]
    if all(d is d0 for d in domains[1:]):
        return d0, False
    if any(type(d) is not type(d0) for d in domains[1:]):
        raise TypeError("search_batch domains must all share one type; got "
                        f"{sorted({type(d).__name__ for d in domains})}")
    if not dataclasses.is_dataclass(d0):
        raise TypeError(f"search_batch over distinct {type(d0).__name__} "
                        "instances needs a dataclass domain")
    varying = {}
    for f in dataclasses.fields(d0):
        vals = [getattr(d, f.name) for d in domains]
        if all(_same(v, vals[0]) for v in vals[1:]):
            continue
        if not all(_stackable(v) for v in vals):
            raise TypeError(f"search_batch domains differ in field "
                            f"{f.name!r}; only tensor-valued fields may "
                            "differ across the batch")
        try:
            varying[f.name] = _stack(vals)
        except (RuntimeError, KeyError) as e:
            raise TypeError(f"search_batch cannot stack field {f.name!r}: "
                            f"{e}") from e
    if not varying:
        return d0, False
    # the warm-start hooks reach the trees (core.tree.init_tree), not the
    # root state: domains that differ only there share one root
    stacked = not set(varying) <= set(_TREE_HOOKS)
    return dataclasses.replace(d0, **varying), stacked
