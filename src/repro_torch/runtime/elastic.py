"""Elastic scaling of a search mesh: ``shrink_mesh``, the counterpart of
``repro.runtime.elastic.shrink_mesh``.

After a host loss the elastic search driver (``search/ft.py``) re-places
later work onto the surviving mesh entries only.  The training half
(``state_shardings`` / ``reshard_state``) comes with the port of training
and its parameter layouts.
"""
from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.parallel.mesh import MeshEntry, SearchMesh


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
