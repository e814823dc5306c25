"""The Domain contract for all search strategies — the PyTorch counterpart
of ``repro.search.domain``.

A domain's state is a dict of tensors, each of some trailing shape S
(0-d, a vector, a cache) behind a leading batch shape; every method works
on whole batches (roots x lanes) at once:

``num_actions : int``
    Static branching factor A (> 0).
``root_state() -> dict``
    The search root's state: leaves of shape S.  When ``search_batch``
    stacked differing tensor fields of B domains into one, the leaves are
    ``[B] + S``, one root each; per-root data that ``step`` /
    ``is_terminal`` / ``playout`` need then travels in the state.
``step(state, action) -> state``
    Apply integer actions of the state's leading shape; keeps the keys,
    dtypes and trailing shapes.
``is_terminal(state) -> bool tensor`` of the leading shape.
``playout(state, draws) -> float tensor`` of the leading shape, reward in
    [0, 1].  ``draws`` holds the rollout's randomness as a tensor of shape
    ``leading + draw_shape``: the port takes no random generator inside a
    playout, so a run is reproducible from its draws.
``draw_shape : tuple`` and ``sample_draws(shape, generator, device)``
    The trailing shape of one playout's draws, and a sampler for them.

Optional: ``priors(state) -> [..., num_actions]`` float tensor (PUCT).
"""
from __future__ import annotations

from typing import Any, List, Protocol, runtime_checkable

import torch

__all__ = ["Domain", "SupportsPriors", "check_domain", "missing_members"]

_REQUIRED = ("num_actions", "root_state", "step", "is_terminal", "playout",
             "draw_shape", "sample_draws")


@runtime_checkable
class Domain(Protocol):
    """Structural type every search strategy accepts."""

    num_actions: int

    def root_state(self) -> Any: ...

    def step(self, state: Any, action: Any) -> Any: ...

    def is_terminal(self, state: Any) -> Any: ...

    def playout(self, state: Any, draws: Any) -> Any: ...

    @property
    def draw_shape(self) -> Any: ...

    def sample_draws(self, shape: Any, generator: Any = None,
                     device: Any = "cpu") -> Any: ...


@runtime_checkable
class SupportsPriors(Protocol):
    """Optional extension: domains that provide PUCT priors."""

    def priors(self, state: Any) -> Any: ...


def missing_members(domain: Any) -> List[str]:
    """Required Domain members ``domain`` lacks (empty = structurally OK)."""
    return [m for m in _REQUIRED if not hasattr(domain, m)]


def _describe(state) -> str:
    return repr({k: (tuple(v.shape), v.dtype) for k, v in state.items()})


def check_domain(domain: Any) -> bool:
    """Validate ``domain`` against the contract by evaluating its methods on
    a batch of one root state (leaves ``[1] + S``); raise TypeError listing
    violations."""
    if not isinstance(domain, Domain):
        raise TypeError(f"{type(domain).__name__} is not a Domain: "
                        f"missing {missing_members(domain)}")
    problems: List[str] = []
    a = domain.num_actions
    if not isinstance(a, int) or isinstance(a, bool) or a <= 0:
        problems.append(f"num_actions must be a positive int, got {a!r}")
    try:
        s0 = {k: torch.as_tensor(v)[None]
              for k, v in domain.root_state().items()}
    except Exception as e:  # noqa: BLE001 — report, cannot go on
        raise TypeError(f"root_state() failed: {e}") from e

    try:
        s1 = domain.step(s0, torch.zeros((1,), dtype=torch.int32))
        if _describe(s1) != _describe(s0):
            problems.append("step() must preserve the state's keys, shapes "
                            f"and dtypes (got {_describe(s1)}, want "
                            f"{_describe(s0)})")
    except Exception as e:  # noqa: BLE001 — collect into the report
        problems.append(f"step() failed: {e}")

    try:
        t = domain.is_terminal(s0)
        if tuple(t.shape) != (1,) or t.dtype != torch.bool:
            problems.append("is_terminal() must return a bool per state, got "
                            f"shape={tuple(t.shape)} dtype={t.dtype}")
    except Exception as e:  # noqa: BLE001
        problems.append(f"is_terminal() failed: {e}")

    try:
        draws = domain.sample_draws((1,))
        v = domain.playout(s0, draws)
        if tuple(v.shape) != (1,):
            problems.append("playout() must return one value per state, "
                            f"got shape={tuple(v.shape)}")
    except Exception as e:  # noqa: BLE001
        problems.append(f"playout() failed: {e}")

    if isinstance(domain, SupportsPriors):
        try:
            p = domain.priors(s0)
            if tuple(p.shape) != (1, a):
                problems.append(f"priors() must return shape (..., {a}), got "
                                f"{tuple(p.shape)}")
        except Exception as e:  # noqa: BLE001
            problems.append(f"priors() failed: {e}")

    if problems:
        raise TypeError(f"{type(domain).__name__} violates the Domain "
                        "contract:\n  - " + "\n  - ".join(problems))
    return True
