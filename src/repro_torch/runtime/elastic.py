"""Elastic scaling: resume a checkpoint on a different mesh, and shrink a
search mesh — the counterpart of ``repro.runtime.elastic``.

The checkpoint stores full (unsharded) leaves; ``reshard_state`` cuts
them into this rank's slices on the new mesh, with shardings re-resolved
from the same logical-axis rules — so a job can shrink from 2 ranks to 1
(or grow) and continue, which is the practical response to losing a pod in
a 1000+-node run.  ``gather_state`` is the way back: the full leaves from
every rank's slices, to checkpoint.  After a host loss the elastic
search driver (``search/ft.py``) re-places later work onto the surviving
search-mesh entries (``shrink_mesh``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

from repro_torch.models.base import ModelConfig, get_family
from repro_torch.parallel.collectives import gather
from repro_torch.parallel.mesh import MeshEntry, SearchMesh
from repro_torch.parallel.sharding import (DEFAULT_RULES, NamedSharding,
                                           make_shardings)


def state_shardings(cfg: ModelConfig, state: Dict[str, Any], mesh,
                    rules=None) -> Dict[str, Any]:
    """Shardings for a {'params':…, 'opt':…} training state on ``mesh``
    (``state``'s leaves whole, or anything with their ``shape``):
    optimizer leaves take their parameter's axes, ``step`` is
    replicated."""
    fam = get_family(cfg)
    axes = fam.param_axes(cfg)
    out: Dict[str, Any] = {}
    out["params"] = make_shardings(axes, state["params"], mesh, rules)
    opt_axes = {}
    for k in state["opt"]:
        opt_axes[k] = None if k == "step" else axes
    out["opt"] = make_shardings(opt_axes, state["opt"], mesh, rules)
    return out


def _over(fn, sh, tree):
    if isinstance(sh, NamedSharding):
        return fn(sh, tree)
    if isinstance(sh, dict):
        return {k: _over(fn, sh[k], tree[k]) for k in tree}
    return [_over(fn, s, t) for s, t in zip(sh, tree)]


def reshard_state(cfg: ModelConfig, state: Dict[str, Any], new_mesh,
                  rules=None) -> Dict[str, Any]:
    """This rank's slices on ``new_mesh`` of a whole state (a restored
    checkpoint), each in memory of its own on the mesh's device."""
    sh = state_shardings(cfg, state, new_mesh, rules or DEFAULT_RULES)
    return _over(lambda s, x: s.shard(x.to(new_mesh.device)), sh, state)


def gather_state(state: Dict[str, Any], shardings: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """The whole state from every rank's slices (``state_shardings`` of
    the whole state); every rank of the mesh must call it."""
    return _over(lambda s, x: gather(x, s.spec, s.mesh), shardings, state)


def shrink_mesh(mesh: SearchMesh, lost_entries: Iterable[MeshEntry]
                ) -> Optional[SearchMesh]:
    """``mesh`` without ``lost_entries`` (compared by identity: a mesh may
    name one device several times), in the same order and process group;
    ``None`` when no entry survives."""
    lost = {id(e) for e in lost_entries}
    keep = [e for e in mesh.entries if id(e) not in lost]
    if not keep:
        return None
    return mesh.sub(keep)
