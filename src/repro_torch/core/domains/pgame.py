"""Synthetic P-game trees — the PyTorch counterpart of
``repro.core.domains.pgame``.

A uniform tree of branching ``num_actions`` and depth ``game_depth``; each
edge carries a pseudo-random value in [0, 1) derived from a 32-bit path
hash.  The state is a dict of tensors with any leading shape:

    hash  i64   the uint32 path hash, held in int64 (torch's uint32 lacks
                most arithmetic); every value stays in [0, 2^32)
    depth i32
    accum f32   sum of edge values along the path

Randomness enters only as explicit action draws: ``playout`` takes a
``[..., game_depth]`` integer tensor of uniform actions, one per rollout
step, and ``sample_draws`` makes such a tensor from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

FNV = 16777619
MIX = 2654435761
_MASK32 = 0xFFFFFFFF
_MIX_LO, _MIX_HI = MIX & 0xFFFF, MIX >> 16


def _hash_step(h, a):
    """``(h ^ (a + 1)) * FNV mod 2^32`` — the product stays below 2^57."""
    return ((h ^ (a.long() + 1)) * FNV) & _MASK32


def _mul_mix(h):
    """``h * MIX mod 2^32`` for ``h < 2^32`` without int64 overflow: the
    multiplier is split in 16-bit halves, each partial product < 2^48."""
    hi = ((h * _MIX_HI) & 0xFFFF) << 16
    return (h * _MIX_LO + hi) & _MASK32


def _f32_reciprocal(d: int) -> float:
    return float(np.float32(1.0) / np.float32(d))


def _edge_value(h):
    return _mul_mix(h).float() / float(2 ** 32)


@dataclasses.dataclass(frozen=True)
class PGameDomain:
    num_actions: int = 4
    game_depth: int = 8
    threshold: float = 0.5
    binary_reward: bool = True
    seed: int = 0

    @property
    def draw_shape(self):
        """Trailing shape of the draws one ``playout`` consumes."""
        return (self.game_depth,)

    def root_state(self):
        h0 = int(np.uint32(2166136261) ^ np.uint32(self.seed))
        return {"hash": torch.tensor(h0, dtype=torch.int64),
                "depth": torch.tensor(0, dtype=torch.int32),
                "accum": torch.tensor(0.0, dtype=torch.float32)}

    def step(self, state, action):
        h = _hash_step(state["hash"], action)
        return {"hash": h, "depth": state["depth"] + 1,
                "accum": state["accum"] + _edge_value(h)}

    def is_terminal(self, state):
        return state["depth"] >= self.game_depth

    def playout(self, state, draws):
        """Uniform-random rollout to terminal; reward in [0, 1].  ``draws``
        is ``[..., game_depth]``: step ``i`` plays ``draws[..., i]`` when the
        rollout covers level ``i`` (``i >= depth``) and skips it otherwise."""
        h, d, acc = state["hash"], state["depth"], state["accum"]
        for i in range(self.game_depth):
            do = i >= d
            h2 = _hash_step(h, draws[..., i])
            acc2 = acc + _edge_value(h2)
            h = torch.where(do, h2, h)
            acc = torch.where(do, acc2, acc)
        # times the float32 reciprocal, as the JAX package computes it under
        # jit (XLA turns a division by a constant into this product)
        total = acc * _f32_reciprocal(self.game_depth)
        if self.binary_reward:
            return (total > self.threshold).float()
        return total.clamp(0.0, 1.0)

    def priors(self, state):
        shape = state["depth"].shape + (self.num_actions,)
        return torch.full(shape, 1.0 / self.num_actions, dtype=torch.float32,
                          device=state["depth"].device)

    def sample_draws(self, shape, generator=None, device="cpu"):
        """Uniform action draws ``shape + draw_shape`` (int32)."""
        return torch.randint(0, self.num_actions,
                             tuple(shape) + self.draw_shape,
                             generator=generator, dtype=torch.int32,
                             device=device)


def enumerate_root_values(domain: PGameDomain) -> np.ndarray:
    """Exact E[reward | root action, uniform play] per action (host, numpy).

    Feasible for num_actions**game_depth up to a few million.
    """
    a, d = domain.num_actions, domain.game_depth
    fnv, mix = np.uint32(FNV), np.uint32(MIX)
    h0 = np.uint32(2166136261) ^ np.uint32(domain.seed)
    hashes = np.array([h0], dtype=np.uint32)
    accums = np.array([0.0], dtype=np.float64)
    first_action = np.zeros(1, dtype=np.int64)
    for level in range(d):
        acts = np.arange(a, dtype=np.uint32)
        h = ((hashes[:, None] ^ (acts[None, :] + 1)) * fnv).astype(np.uint32)
        ev = ((h * mix).astype(np.uint32)).astype(np.float64) / float(2 ** 32)
        accums = (accums[:, None] + ev).reshape(-1)
        hashes = h.reshape(-1)
        first_action = (np.arange(a)[None, :] + 0 * first_action[:, None]) \
            .reshape(-1) if level == 0 else np.repeat(first_action, a)
    total = accums / d
    if domain.binary_reward:
        rewards = (total > domain.threshold).astype(np.float64)
    else:
        rewards = np.clip(total, 0.0, 1.0)
    out = np.zeros(a)
    for i in range(a):
        out[i] = rewards[first_action == i].mean()
    return out


def optimal_root_action(domain: PGameDomain) -> int:
    return int(np.argmax(enumerate_root_values(domain)))
