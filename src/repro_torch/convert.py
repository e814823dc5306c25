"""The state carry between the JAX package's ``TreeArena`` and the port's,
the JAX model parameters and optimizer state as the port's and back, and
the serving searcher's cross-token carry in both layouts.

A search tree is this system's state, as weights are a model's: to start
both implementations from the same mid-search tree, a JAX arena's leaves
are taken as numpy arrays (``{field: np.asarray(...)}``, with ``state`` a
dict of the domain state's leaves) and turned into the port's arena, and
back.  Only numpy crosses the boundary, so this module imports no JAX.

Field layout: the JAX arena's planes are ``[N]`` / ``[N, A]`` with scalar
``next_free`` / ``free_top``; a ``search_batch`` result adds a leading
batch axis.  The port's planes always carry the batch axis.  The P-game
``hash`` is uint32 in JAX and int64 in the port.

The cross-token carry of ``ReusableSearcher`` (``carry_from_numpy`` /
``carry_to_numpy``): the JAX cached LM state ``{"len", "cache": {...},
"logits"}`` is the port's flat ``{"len", "plen", "logits", **cache}``
(the uncached ``{"toks", "len"}`` is ``{"toks", "len", "plen"}``).  The
port keeps each node's prompt length ``plen``, which the JAX state does
not: going to the port the caller supplies it, going back it is dropped.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.core.arena import TreeArena

PLANES = ("visits", "value", "vloss", "unobs", "parent", "action",
          "children", "prior", "terminal", "next_free", "free_list",
          "free_top")

_UINT32_STATE = ("hash",)      # uint32 state leaves, held in int64 here
_DTYPES = {"visits": torch.int32, "value": torch.float32,
           "vloss": torch.int32, "unobs": torch.int32,
           "parent": torch.int32, "action": torch.int32,
           "children": torch.int32, "prior": torch.float32,
           "terminal": torch.bool, "next_free": torch.int32,
           "free_list": torch.int32, "free_top": torch.int32}


def _state_to_torch(x: np.ndarray) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.astype(np.int64)
    return torch.from_numpy(np.array(x))


def _field(planes, name: str):
    if isinstance(planes, Mapping):
        return planes[name]
    return getattr(planes, name)


def arena_from_numpy(planes, device="cpu") -> TreeArena:
    """The port's arena from numpy planes — a mapping of field names, or an
    object with those attributes (a JAX ``TreeArena`` whose leaves are numpy
    arrays).  Unbatched planes (``children`` ``[N, A]``) get a batch axis of
    one."""
    batched = np.asarray(_field(planes, "children")).ndim == 3
    lift = (lambda t: t) if batched else (lambda t: t[None])
    fields = {f: lift(torch.from_numpy(np.array(_field(planes, f)))
                      .to(_DTYPES[f])).to(device)
              for f in PLANES}
    state = {k: lift(_state_to_torch(v)).to(device)
             for k, v in _field(planes, "state").items()}
    return TreeArena(state=state, **fields)


def arena_to_numpy(arena: TreeArena, *,
                   batched: bool = True) -> Dict[str, Any]:
    """Numpy planes of the port's arena.  ``batched=False`` drops the batch
    axis of a one-root arena; the P-game ``hash`` goes back to uint32."""
    if not batched and arena.batch != 1:
        raise ValueError(f"batched=False needs one root, got {arena.batch}")
    take = (lambda t: t) if batched else (lambda t: t[0])
    out = {f: take(getattr(arena, f)).cpu().numpy() for f in PLANES}
    state = {}
    for k, v in arena.state.items():
        x = take(v).cpu().numpy()
        state[k] = x.astype(np.uint32) if k in _UINT32_STATE else x
    out["state"] = state
    return out


def params_from_numpy(tree, device="cpu"):
    """The port's parameter tree from a JAX parameter pytree whose leaves
    were taken with ``np.asarray`` (same keys, lists stay lists; bfloat16
    leaves, which numpy holds as ``ml_dtypes.bfloat16``, become
    ``torch.bfloat16``).  An optimizer state of ``repro.optim`` (``{"m",
    "v", "step"}``: trees like the parameters' and an int32 scalar, a
    0-dim tensor here) converts the same way; ``tree_to_numpy`` goes
    back."""
    if isinstance(tree, Mapping):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    x = np.asarray(tree)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(x.view(np.uint16)).astype(np.int32))
        return (t << 16).view(torch.float32).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x)).to(device)


def tree_to_numpy(tree):
    """Numpy leaves of a port tree (parameters, optimizer state) in the
    JAX package's layout, for ``jnp.asarray`` there; bfloat16 leaves come
    back as float32 (exact: cast them back with ``.astype``)."""
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to_numpy(v) for v in tree]
    return _to_numpy(tree)


_META = ("len", "plen", "logits")


def _flat_state(state, plen, shape) -> Dict[str, Any]:
    """A JAX LM state's numpy leaves in the port's flat layout, with the
    ``plen`` plane (``plen`` broadcast to ``shape``) added."""
    out = {}
    for k, v in state.items():
        if isinstance(v, Mapping):
            out.update({kk: np.asarray(vv) for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v)
    out["plen"] = np.broadcast_to(
        np.asarray(plen, np.int32).reshape(
            (-1,) + (1,) * (len(shape) - 1)), shape).copy()
    return out


def _nested_state(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The port's flat LM state as the JAX layout (``plen`` dropped)."""
    if "logits" not in state:
        return {k: v for k, v in state.items() if k != "plen"}
    return {"len": state["len"], "logits": state["logits"],
            "cache": {k: v for k, v in state.items() if k not in _META}}


def carry_from_numpy(carry, plen, device="cpu") -> Dict[str, Any]:
    """The port's ``ReusableSearcher`` carry from a JAX one whose leaves
    were taken with ``np.asarray`` (``"arena"`` a mapping of planes or an
    object with them; the batch axis leads every leaf).  ``plen [B]``
    fills the port's ``plen`` plane of the carried arena."""
    out: Dict[str, Any] = {}
    if "arena" in carry:
        ar = carry["arena"]
        planes = {f: np.asarray(_field(ar, f)) for f in PLANES}
        planes["state"] = _flat_state(_field(ar, "state"), plen,
                                      planes["parent"].shape)
        out["arena"] = arena_from_numpy(planes, device)
        out["action"] = torch.from_numpy(
            np.array(carry["action"], np.int32)).to(device)
        out["alive"] = torch.from_numpy(
            np.array(carry["alive"], bool)).to(device)
    if "cache" in carry:
        out["cache"] = {k: params_from_numpy(v, device)
                        for k, v in carry["cache"].items()}
        out["logits"] = params_from_numpy(carry["logits"], device)
    return out


def carry_to_numpy(carry) -> Dict[str, Any]:
    """The JAX layout of the port's carry, numpy leaves (``"arena"`` as a
    mapping of planes, ``plen`` dropped, bfloat16 as float32).  Entries
    still None (before the first admission or step) are left out."""
    out: Dict[str, Any] = {}
    for k, v in carry.items():
        if v is None:
            continue
        if k == "arena":
            planes = arena_to_numpy(v)
            planes["state"] = _nested_state(planes["state"])
            out[k] = planes
        elif isinstance(v, dict):
            out[k] = {kk: _to_numpy(vv) for kk, vv in v.items()}
        else:
            out[k] = _to_numpy(v)
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: those leaves come back as float32 (exact)
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
