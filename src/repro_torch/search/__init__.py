"""repro_torch.search — the public search API of the PyTorch port.

    from repro_torch.search import SearchConfig, search, search_batch

    res = search(domain, SearchConfig(method="pipeline", budget=256,
                                      lanes=8), rng=0)

Entry points
    search(domain, cfg, rng, device=None)          one search
    search_batch(domains, cfg, rng, device=None)   B searches of one domain
                                                   as one batched program
    search_stacked(domain, B, cfg, rng, device=None)
                                                   the same over one domain
                                                   already stacked over B
    search_batch(..., mesh=)                       sharded over a SearchMesh
                                                   (repro_torch.parallel)
    shard_search_batch / shard_search_keys         the explicit sharded form
                                                   (in-process or across
                                                   processes)
    ft_search_batch / ElasticSearchDriver          the elastic fault-tolerant
                                                   driver (requeue-and-shrink)
Configuration
    SearchConfig    method/budget/lanes/max_nodes/keep_tree + ``params``
    SearchParams    cp, vl_weight, max_depth, puct, vl_mode, kernels
                    ("auto" | "cuda" | "ref"), wave_select, level_assign
Extension points
    Domain, SupportsPriors, check_domain(d); register_strategy(name,
    draws=...), list_strategies(): sequential, root, leaf, tree, pipeline
Results
    SearchResult    action_visits / action_value / best_action / tree /
                    stats (always exactly STATS_KEYS) / extras
"""
from repro_torch.core.stages import SearchParams  # noqa: F401  (re-export)
from repro_torch.search.api import (STATS_KEYS, SearchConfig,  # noqa: F401
                                    SearchResult, draws_shape, get_strategy,
                                    list_strategies, register_strategy,
                                    search, search_batch, search_stacked)
from repro_torch.search.domain import (Domain, SupportsPriors,  # noqa: F401
                                       check_domain)
from repro_torch.search.sharding import (shard_search_batch,  # noqa: F401
                                         shard_search_keys)
from repro_torch.search.ft import (ElasticSearchDriver,  # noqa: F401
                                   FTReport, FTSearchConfig, ft_search_batch)
from repro_torch.search import strategies  # noqa: F401  (built-ins)

__all__ = [
    "STATS_KEYS", "SearchConfig", "SearchParams", "SearchResult",
    "Domain", "SupportsPriors", "check_domain", "draws_shape",
    "search", "search_batch", "search_stacked", "shard_search_batch",
    "shard_search_keys", "ElasticSearchDriver", "FTReport",
    "FTSearchConfig", "ft_search_batch",
    "get_strategy", "list_strategies", "register_strategy",
    "strategies",
]
