"""Batch-axis sharding of batched multi-root search — the counterpart of
``repro.search.sharding``.

``search_batch`` runs B independent searches as one batched program on
one device.  ``shard_search_batch`` runs the same per-root computation
over a 1-D ``SearchMesh`` (``repro_torch.parallel.mesh``): the roots are
split into contiguous blocks, one per mesh entry, and each process runs
only its own entries, each block through the batched path of
``search_batch`` on that entry's device.  Every block is enqueued before
any result is read.  The results are gathered to every process
(``gather_rows``) and concatenated along the batch, the searched
``tree`` included when ``keep_tree``.

Contracts (tests/test_torch_sharding.py, test_torch_multihost.py):

* **per-root semantics** are those of ``search_batch``: draws are made for
  exactly B roots *before* any padding, so root i of the result equals
  ``search(domains[i], cfg, draws[i])``;
* **padding**: B is padded to a multiple of the mesh's entries by
  repeating row 0 (its domain and its draws); the pad rows run a real
  search whose results are sliced off.
"""
from __future__ import annotations

import torch

from repro_torch.parallel.mesh import SearchMesh, gather_rows, \
    make_search_mesh

__all__ = ["shard_search_batch", "shard_search_keys"]


def shard_search_batch(domains, cfg, rng, *, mesh: SearchMesh = None):
    """``search_batch`` with the batch split over ``mesh`` (default:
    ``make_search_mesh()``).  ``rng`` is a draw tensor ``(B,) +
    draws_shape`` or a seed, as for ``search_batch``; draws for exactly B
    roots are made from it before padding.  Returns the same
    ``SearchResult`` as ``search_batch``, on ``mesh.home``, in every
    process of the mesh."""
    from repro_torch.search.api import _check, _draws
    domains = list(domains)
    if not domains:
        raise ValueError("shard_search_batch needs at least one domain")
    _check(domains[0])
    draws = _draws(domains[0], cfg, rng, (len(domains),),
                   torch.device("cpu"))
    return shard_search_keys(domains, cfg, draws, mesh=mesh)


def shard_search_keys(domains, cfg, draws, *, mesh: SearchMesh = None):
    """``shard_search_batch`` with the B roots' draws already made.  The
    elastic driver (``search/ft.py``) re-runs arbitrary subsets of roots
    under their ORIGINAL draws through it: a requeued root repeats its
    uninterrupted run."""
    from repro_torch.search.api import _batch_domains, _search_b
    domains = list(domains)
    if mesh is None:
        mesh = make_search_mesh()
    if not isinstance(mesh, SearchMesh):
        raise TypeError(f"mesh must be a SearchMesh, got "
                        f"{type(mesh).__name__}")
    b = len(domains)
    if draws.shape[0] != b:
        raise ValueError(f"{b} domains but draws for {draws.shape[0]}")
    pad = (-b) % mesh.size
    blk = (b + pad) // mesh.size
    domains = domains + [domains[0]] * pad
    if pad:
        draws = torch.cat([draws, draws[:1].expand((pad,)
                                                    + draws.shape[1:])])
    local = {}
    for i, entry in mesh.local():
        rows = slice(i * blk, (i + 1) * blk)
        dom, stacked = _batch_domains(domains[rows])
        local[i] = _search_b(dom, stacked, blk, cfg, draws[rows],
                             entry.device)
    return gather_rows(mesh, local, b)
