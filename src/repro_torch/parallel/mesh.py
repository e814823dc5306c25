"""Meshes over devices and processes: the 1-D search meshes, the PyTorch
counterpart of ``repro.launch.mesh.make_search_mesh``, and the named N-D
meshes of the model-parallel layer (``Mesh``, ``make_mesh``,
``make_host_mesh``), the counterparts of ``repro.parallel.compat.
make_mesh`` and ``repro.launch.mesh.make_host_mesh``.  A named mesh is
one rank a place, with a process group per line of each axis; the
collectives over those groups are ``parallel/collectives.py``.

JAX's mesh is single-controller: one program, compiled once, runs on
every device.  The port's search is a host loop of many small device
operations, so one Python thread driving N devices in turn pays N times
the host time.  Its mesh is therefore PyTorch's own idiom: one process per
device under ``torch.distributed``, each process running only its own
entries.  A ``SearchMesh`` is an ordered tuple of entries, each a
``torch.device`` and the rank of the process that drives it, plus the
process group its results are gathered over:

* ``make_search_mesh()`` inside an initialised group of world size W: W
  entries (or ``n``, a multiple of W), rank r's on rank r's own card
  (``cuda:$LOCAL_RANK``), or on the CPU for gloo runs;
* ``make_search_mesh(n)`` outside a group, and ``mesh_from_devices``: an
  in-process mesh driven by this process alone, one thread, entries in
  turn; a device may repeat (on one card, the stand-in for the JAX tests'
  forced host devices).

Results are gathered to every process by ``gather_rows``: through
host copies under gloo (which two ranks on one card must use: NCCL
refuses two ranks on one GPU), on the card under NCCL.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
import os
from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.pytree import flatten, unflatten

__all__ = ["Mesh", "MeshEntry", "SearchMesh", "current_mesh", "gather_rows",
           "init_distributed", "local_rank", "make_host_mesh", "make_mesh",
           "make_search_mesh", "mesh_from_devices", "mesh_is_multihost",
           "mesh_num_devices", "process_count"]


@dataclasses.dataclass(frozen=True, eq=False)
class MeshEntry:
    """One place of a mesh: a device and the rank that drives it.  Entries
    compare by identity, so that a mesh may name one device twice."""

    device: torch.device
    rank: int


class SearchMesh:
    """An ordered 1-D tuple of entries and the process group (``None``:
    this process alone) over which results are gathered.  ``rank`` is
    this process's rank in that group."""

    def __init__(self, entries: Sequence[MeshEntry], group=None,
                 rank: int = 0):
        if not entries:
            raise ValueError("a search mesh needs at least one entry")
        self.entries = tuple(entries)
        self.group = group
        self.rank = rank

    @property
    def size(self) -> int:
        return len(self.entries)

    def local(self) -> List[tuple]:
        """``(index, entry)`` of the entries this process drives."""
        return [(i, e) for i, e in enumerate(self.entries)
                if e.rank == self.rank]

    @property
    def home(self) -> torch.device:
        """Where gathered results land in this process: its first entry's
        device (the CPU when it drives none of this mesh)."""
        mine = self.local()
        return mine[0][1].device if mine else torch.device("cpu")

    def sub(self, entries: Sequence[MeshEntry]) -> "SearchMesh":
        """A mesh over some of these entries, in the same group."""
        return SearchMesh(entries, self.group, self.rank)


def mesh_num_devices(mesh: SearchMesh) -> int:
    """The number of entries of ``mesh``."""
    return mesh.size


def mesh_is_multihost(mesh: SearchMesh) -> bool:
    """True when ``mesh``'s entries are driven by more than one process."""
    return len({e.rank for e in mesh.entries}) > 1


def process_count() -> int:
    """The world size of the initialised process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def local_rank() -> int:
    """This process's card index inside an initialised process group of
    world size > 1: ``$LOCAL_RANK``, else its rank; 0 outside one."""
    if process_count() == 1:
        return 0
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def init_distributed(backend: str, init_method: str, world_size: int,
                     rank: int) -> None:
    """``torch.distributed.init_process_group`` with every coordinate
    given (nothing on the machine tells a program of a cluster).  Under
    NCCL the rank's card, ``cuda:$LOCAL_RANK`` (default: the rank), is
    made current first."""
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def make_search_mesh(n: int = 0, device=None) -> SearchMesh:
    """The 1-D mesh ``shard_search_batch`` partitions roots over.

    Inside an initialised process group of world size W > 1: ``n`` entries
    (default W, else a multiple of W), ``n / W`` per rank in rank order,
    each on its rank's ``device`` (default its own card); every rank must
    call it, as the devices are exchanged.  Outside one: ``n`` entries
    (default 1) on this process's ``device`` (default ``cuda:0``).
    Without a card and without ``device`` it raises."""
    from repro_torch.search.api import resolve_device
    w = process_count()
    dev = resolve_device(device)
    if w == 1:
        return mesh_from_devices([dev] * (n or 1))
    n = n or w
    if n % w:
        raise ValueError(f"a mesh over {w} processes needs a multiple of "
                         f"{w} entries, got {n}")
    devs: List[Any] = [None] * w
    dist.all_gather_object(devs, str(dev))
    per = n // w
    return SearchMesh([MeshEntry(torch.device(devs[r]), r)
                       for r in range(w) for _ in range(per)],
                      dist.group.WORLD, dist.get_rank())


def mesh_from_devices(devices: Sequence[Any]) -> SearchMesh:
    """An in-process mesh over ``devices`` (a device may repeat), driven
    by this process alone."""
    rank = dist.get_rank() if process_count() > 1 else 0
    return SearchMesh([MeshEntry(torch.device(d), rank) for d in devices],
                      None, rank)


def _as_bytes(x: torch.Tensor, on: torch.device) -> torch.Tensor:
    """``x``'s elements in a fresh packed buffer on ``on``, as bytes (an
    expanded leaf has stride 0, which no byte view takes)."""
    flat = torch.empty(x.numel(), dtype=x.dtype, device=on)
    flat.copy_(x.detach().reshape(-1))
    return flat.view(torch.uint8)


def _all_gather_blocks(mesh: SearchMesh, local: Dict[int, Any]
                      ) -> List[Any]:
    """Every entry's result, in entry order, in every process: ``local``
    maps the indices of this process's entries to their results (nested
    structures of tensors).  With no process group the results are this
    process's own.  Otherwise each rank packs its results' leaves into one
    byte buffer, and one ``all_gather`` of the structures and one of the
    buffers (padded to the longest) exchange them: on the CPU under gloo,
    on the rank's card under NCCL.  Leaves land on ``mesh.home``."""
    home = mesh.home
    if mesh.group is None:
        return [local[i] for i in range(mesh.size)]
    group = mesh.group
    on = (torch.device("cpu") if dist.get_backend(group) == "gloo"
          else torch.device("cuda", torch.cuda.current_device()))
    meta, chunks = [], []
    for i in sorted(local):
        leaves, treedef = flatten(local[i])
        meta.append((i, treedef, [(tuple(x.shape), x.dtype)
                                  for x in leaves]))
        chunks += [_as_bytes(x, on) for x in leaves]
    buf = (torch.cat(chunks) if chunks
           else torch.zeros(0, dtype=torch.uint8, device=on))
    world = dist.get_world_size(group)
    metas: List[Any] = [None] * world
    dist.all_gather_object(metas, (meta, buf.numel()), group=group)
    size = max(n for _, n in metas)
    if size > buf.numel():
        buf = torch.cat([buf, buf.new_zeros(size - buf.numel())])
    bufs = [torch.empty(size, dtype=torch.uint8, device=on)
            for _ in range(world)]
    dist.all_gather(bufs, buf, group=group)
    out: List[Any] = [None] * mesh.size
    for (rmeta, _), rbuf in zip(metas, bufs):
        off = 0
        for i, treedef, specs in rmeta:
            leaves = []
            for shape, dtype in specs:
                nbytes = math.prod(shape) * dtype.itemsize
                leaves.append(rbuf[off:off + nbytes].clone().view(dtype)
                              .reshape(shape).to(home))
                off += nbytes
            out[i] = unflatten(treedef, leaves)
    missing = [i for i, r in enumerate(out) if r is None]
    if missing:
        raise RuntimeError(f"no rank returned the results of mesh entries "
                           f"{missing}")
    return out


def gather_rows(mesh: SearchMesh, local: Dict[int, Any], rows: int):
    """``_all_gather_blocks``, the blocks concatenated along their leading
    (batch) axis on ``mesh.home`` and cut to the first ``rows``."""
    flat = [flatten(p) for p in _all_gather_blocks(mesh, local)]
    leaves = [torch.cat([x.to(mesh.home) for x in xs])[:rows]
              for xs in zip(*(f[0] for f in flat))]
    return unflatten(flat[0][1], leaves)


# ---------------------------------------------------------------------------
# named N-D meshes: the counterpart of ``compat.make_mesh`` /
# ``launch.mesh.make_host_mesh`` for the model-parallel layer
# ---------------------------------------------------------------------------
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


class Mesh:
    """A named N-D mesh over the ranks of a process group, one rank a
    place: ``devices`` is the array of global ranks in mesh order (its
    shape the axes' sizes, as a JAX mesh's ``devices``), ``coords`` this
    rank's index on each axis, and ``line(axis)`` the ranks of the line
    through this rank along ``axis``, with the process group
    ``groups[axis]`` over them (``None`` for an axis of size 1: a mesh
    of one place needs no group).

    A rank computes on ``device``; ``wire`` is where tensors cross to
    other ranks: the CPU under gloo (which two ranks on one card must
    use: NCCL refuses two ranks on one GPU), ``device`` under NCCL.

    ``with mesh:`` makes it the ambient mesh (JAX's ``with mesh:``),
    which ``current_mesh()`` returns; ``moe_ffn`` reads it."""

    def __init__(self, ranks, axis_names: Sequence[str], rank: int = 0,
                 groups: Dict[str, Any] = None, device=None,
                 backend: str = "gloo"):
        import numpy as np
        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not once in the mesh "
                             f"{self.devices.tolist()}")
        self.rank = rank
        self.coords = dict(zip(self.axis_names, map(int, where[0])))
        self.groups = dict(groups or {})
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.backend = backend
        self._tokens: List[Any] = []

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}`` in axis order, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def wire(self) -> torch.device:
        return self.device if self.backend == "nccl" \
            else torch.device("cpu")

    def line(self, axis: str) -> List[int]:
        """The global ranks along ``axis`` through this rank, in order."""
        i = self.axis_names.index(axis)
        idx = tuple(slice(None) if j == i else self.coords[a]
                    for j, a in enumerate(self.axis_names))
        return [int(r) for r in self.devices[idx]]

    def __enter__(self) -> "Mesh":
        self._tokens.append(_CURRENT.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._tokens.pop())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"coords={self.coords}, device={self.device})")


def current_mesh():
    """The ambient mesh (set by ``with mesh:``), or ``None``."""
    return _CURRENT.get()


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None,
              ranks: Sequence[int] = None):
    """A named mesh of ``shape`` over ``ranks`` (default: every rank of
    the initialised group, or this process alone outside one), laid out
    in rank order, row-major, as ``jax.make_mesh`` lays out devices.

    Inside a group of world size W every rank must call it (each line of
    each axis becomes a process group, and ``new_group`` is collective):
    a rank outside ``ranks`` gets ``None``.  ``device`` is where this
    rank computes: default its own card (``cuda:$LOCAL_RANK``), or the
    CPU without a card.  Outside a group the mesh must have one place."""
    import numpy as np
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    w = process_count()
    rank = dist.get_rank() if w > 1 else 0
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != n or len(set(ranks)) != n \
            or not all(0 <= r < w for r in ranks):
        raise ValueError(f"a mesh of shape {shape} needs {n} distinct "
                         f"ranks of the {w} there are, got {ranks}")
    grid = np.asarray(ranks, dtype=np.int64).reshape(shape)
    if device is None:
        device = f"cuda:{local_rank()}" if torch.cuda.is_available() \
            else "cpu"
    if w == 1:
        return Mesh(grid, axes, 0, device=device)
    backend = dist.get_backend()
    groups: Dict[str, Any] = {}
    for i, ax in enumerate(axes):
        if shape[i] == 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for members in lines.tolist():
            g = dist.new_group(members)
            if rank in members:
                groups[ax] = g
    if rank not in ranks:
        return None
    return Mesh(grid, axes, rank, groups, device, backend)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh over however many ranks there are, each
    axis cut to fit (``repro.launch.mesh.make_host_mesh``)."""
    n = process_count()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return make_mesh((data, model), ("data", "model"), device=device,
                     ranks=range(data * model))
