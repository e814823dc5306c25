"""Logical-axis sharding rules with divisibility-aware fallback — the
counterpart of ``repro.parallel.sharding``.

Every param/cache tensor carries a tuple of logical axis names (see each
family's ``param_axes`` / ``cache_axes``).  A rules table maps logical axes to
candidate mesh axes *in priority order*; resolution walks each tensor's dims,
assigning the first candidate mesh axis (or axis tuple) that (a) is still
unused by this tensor and (b) divides the dim size.  Indivisible dims fall
back to replication — e.g. smollm's 9 heads on a 16-way model axis — instead
of failing, which is what lets one rules table drive all 10 architectures.

``resolve_spec`` is the JAX function's arithmetic, tuple for tuple; it
reads only a mesh's ``axis_names`` and ``devices.shape``.  A spec here
says where each rank's piece of a tensor lies: the port stores a sharded
tensor as each rank's plain local slice (``shard``), and the collectives
of ``parallel/collectives.py`` gather and reduce-scatter those slices.
There is no SPMD compiler to place activations, so
``with_logical_constraint`` is the identity, on a mesh and off it, and
the models call it nowhere.  ``active_rules`` (per-arch rule overrides
made visible to the constraints the JAX dry run traces) waits for the
port of the launch tooling that would use it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

# logical axis -> candidate mesh-axis assignments, best first.
# each candidate is a tuple of mesh axes used together for that dim.
DEFAULT_RULES: Dict[str, Tuple[Tuple[str, ...], ...]] = {
    "batch":   (("pod", "data"), ("data",)),
    "vocab":   (("model",),),
    "embed":   (("data",),),          # FSDP / ZeRO-3 storage sharding
    "heads":   (("model",),),
    "kv":      (("model",),),
    "mlp":     (("model",),),
    # experts stay replicated under the rules: expert parallelism is the
    # explicit dispatch of ``parallel/ep_dispatch.py``
    "experts": (),
    # decode/long cells: shard the KV-cache sequence axis over whatever is
    # left after batch/kv-heads claim their axes (``dist_attention.py``)
    "kv_seq":  (("model", "data"), ("model",), ("data",)),
    "layers":  (),
    "seq":     (),
    # saved layer-boundary activations (remat carries) shard their seq dim
    # over the model axis (Megatron sequence parallelism)
    "act_seq": (("model",),),
}


class PartitionSpec(tuple):
    """Per-dim mesh axes (a name, a tuple of names, or ``None``), trailing
    ``None`` dropped: ``jax.sharding.PartitionSpec``'s tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _mesh_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_spec(axes: Optional[Tuple], shape: Tuple[int, ...], mesh,
                 rules: Dict[str, Tuple] = None) -> PartitionSpec:
    """(logical axes, shape) -> PartitionSpec under the rules table."""
    rules = rules or DEFAULT_RULES
    sizes = _mesh_sizes(mesh)
    if axes is None:
        return P()
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not name the dims of {shape}")
    used: set = set()
    parts = []
    for name, dim in zip(axes, shape):
        assigned = None
        if name is not None:
            for cand in rules.get(name, ()):
                cand = tuple(a for a in cand if a in sizes)
                if not cand or any(a in used for a in cand):
                    continue
                total = math.prod(sizes[a] for a in cand)
                if total > 1 and dim % total == 0:
                    assigned = cand if len(cand) > 1 else cand[0]
                    used.update(cand)
                    break
        parts.append(assigned)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def is_axes(x) -> bool:
    """A leaf of an axes tree: ``None`` or a tuple of names / ``None``."""
    return x is None or (isinstance(x, tuple)
                         and all(a is None or isinstance(a, str) for a in x))


def map_axes(fn, axes_tree: Any, tree: Any) -> Any:
    """``fn(axes, leaf)`` over an axes tree and a tree of the same
    structure (dicts, lists), the axes' tuples taken as leaves."""
    if is_axes(axes_tree):
        return fn(axes_tree, tree)
    if isinstance(axes_tree, dict):
        if set(axes_tree) != set(tree):
            raise ValueError(f"axes keys {sorted(axes_tree)} != tree keys "
                             f"{sorted(tree)}")
        return {k: map_axes(fn, axes_tree[k], tree[k]) for k in tree}
    if isinstance(axes_tree, list) and len(axes_tree) == len(tree):
        return [map_axes(fn, a, t) for a, t in zip(axes_tree, tree)]
    raise ValueError(f"axes tree {axes_tree!r} does not match the tree")


def prefix_axes(tree: Any, name: str = "layers") -> Any:
    """Every axes tuple of ``tree`` with ``name`` put in front (a stacked
    layer axis)."""
    if is_axes(tree):
        return (name,) + tree
    if isinstance(tree, dict):
        return {k: prefix_axes(v, name) for k, v in tree.items()}
    return [prefix_axes(v, name) for v in tree]


def _spec_of(ax, leaf, mesh, rules) -> PartitionSpec:
    ndim = len(leaf.shape)
    return resolve_spec(ax if ax is not None else (None,) * ndim,
                        tuple(leaf.shape), mesh, rules)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: where this rank's piece of a tensor lies."""

    mesh: Any
    spec: PartitionSpec

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        return shard(x, self.spec, self.mesh)


def make_shardings(axes_tree: Any, abstract_tree: Any, mesh,
                   rules: Dict[str, Tuple] = None) -> Any:
    """Tree of ``NamedSharding`` matching ``abstract_tree``'s structure
    (its leaves need only a ``shape``)."""
    return map_axes(lambda ax, leaf: NamedSharding(
        mesh, _spec_of(ax, leaf, mesh, rules)), axes_tree, abstract_tree)


def spec_tree(axes_tree: Any, abstract_tree: Any, mesh,
              rules: Dict[str, Tuple] = None) -> Any:
    return map_axes(lambda ax, leaf: _spec_of(ax, leaf, mesh, rules),
                    axes_tree, abstract_tree)


# ---------------------------------------------------------------------------
# local slices
# ---------------------------------------------------------------------------
def _dim_axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def dim_shards(part, mesh) -> Tuple[int, int]:
    """``(index, count)`` of this rank's piece along a dim whose spec
    entry is ``part``: the axes of a tuple row-major, the first major."""
    idx, n = 0, 1
    for a in _dim_axes(part):
        size = mesh.shape[a]
        idx, n = idx * size + mesh.coords[a], n * size
    return idx, n


def local_slices(spec: PartitionSpec, shape, mesh) -> Tuple[slice, ...]:
    out = []
    for i, dim in enumerate(shape):
        idx, n = dim_shards(spec[i] if i < len(spec) else None, mesh)
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def replicas(spec: PartitionSpec, mesh) -> int:
    """How many ranks hold the same piece: the mesh's size over the
    product of the axes the spec shards over."""
    used = [a for part in spec for a in _dim_axes(part)]
    return mesh.size // math.prod(mesh.shape[a] for a in used)


def shard(x: torch.Tensor, spec: PartitionSpec, mesh) -> torch.Tensor:
    """This rank's piece of the whole ``x``, in memory of its own."""
    if not any(spec):
        return x
    return x[local_slices(spec, x.shape, mesh)].clone()


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in ``core.pytree.flatten``'s leaf order
    (dict keys sorted), each ``PartitionSpec`` one leaf."""
    if isinstance(specs, PartitionSpec):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for t in specs for s in spec_leaves(t)]


def with_logical_constraint(x, axes: Tuple, mesh=None,
                            rules: Dict[str, Tuple] = None):
    """``x`` itself.  The JAX function asks the SPMD compiler to place a
    value under its logical axes and keeps the value; the port has no
    such compiler (every rank computes on whole activations), so the
    annotation has nothing to do.  A caller that wants this rank's piece
    of a value cuts it with ``local_slices``."""
    return x
