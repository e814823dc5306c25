"""repro_torch.serving — MCTS-guided LM decoding and the serving engine.

The counterpart of ``repro.serving``: the batched searchers
(``mcts_decode``, ``mcts_decode_batch``, ``make_batched_searcher``, and
the cross-token ``ReusableSearcher`` behind ``kv_splice`` /
``tree_reuse``, and ``MeshSearcher`` over a ``SearchMesh``), the
continuous-batching ``ServingEngine`` in its greedy
and mcts modes, and copies of the request scheduler and serving stats.
"""
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.mcts_decode import (  # noqa: F401
    MCTSDecodeConfig, MeshSearcher, ReusableSearcher, make_batched_searcher,
    mcts_decode, mcts_decode_batch)
from repro_torch.serving.scheduler import (POLICIES, Admit,  # noqa: F401
                                           Evict, Request, RequestScheduler)
from repro_torch.serving.stats import ServingStats, percentile  # noqa: F401

__all__ = ["Admit", "EngineConfig", "Evict", "MCTSDecodeConfig",
           "MeshSearcher", "POLICIES",
           "Request", "RequestScheduler", "ReusableSearcher",
           "ServingEngine", "ServingStats",
           "make_batched_searcher", "mcts_decode", "mcts_decode_batch",
           "percentile"]
