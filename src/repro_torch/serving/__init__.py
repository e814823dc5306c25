"""repro_torch.serving — MCTS-guided LM decoding (the stateless searcher).

The request-lifecycle half of ``repro.serving`` (``ReusableSearcher``,
``ServingEngine``, the scheduler and its stats) is ROADMAP Queue 1 item
10.
"""
from repro_torch.serving.mcts_decode import (  # noqa: F401
    MCTSDecodeConfig, make_batched_searcher, mcts_decode, mcts_decode_batch)

__all__ = ["MCTSDecodeConfig", "make_batched_searcher", "mcts_decode",
           "mcts_decode_batch"]
