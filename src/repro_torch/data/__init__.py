"""The synthetic data pipeline — the counterpart of ``repro.data``."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, Prefetcher, make_batch_iterator, synthetic_batch,
)
