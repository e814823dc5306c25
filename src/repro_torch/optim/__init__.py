"""Optimizers and learning-rate schedules — the counterpart of
``repro.optim``."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, apply_updates, clip_by_global_norm, lion, sgd,
)
from repro_torch.optim.schedules import constant, cosine, wsd  # noqa: F401
