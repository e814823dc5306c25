"""Port parity of batch-sharded multi-root search: ``repro_torch.search.
shard_search_batch`` / ``shard_search_keys`` and ``search_batch(mesh=)``
against ``repro.search.search_batch(..., mesh=False)`` on the CPU.

The port's mesh is a ``repro_torch.parallel.SearchMesh``; here it is an
in-process mesh of 1, 3 or 8 CPU entries (``mesh_from_devices``), the
stand-in for the JAX tests' forced host devices.  Every root of the
sharded result equals the JAX package's root under the same JAX-drawn
playouts (integer planes, visits, best action and stats exactly, floats
within ``torch_parity.FLOAT_TOL``), at B divisible by the entries and not
(the pad rows repeat row 0 and are sliced off).  The two-process mesh is
in ``test_torch_multihost.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.domains.pgame import PGameDomain as JDom  # noqa: E402
from repro.search import SearchConfig as JCfg  # noqa: E402
from repro.search import SearchParams as JParams  # noqa: E402
from repro.search import search_batch as jsearch_batch  # noqa: E402
from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.parallel import (make_search_mesh,  # noqa: E402
                                  mesh_from_devices, mesh_is_multihost,
                                  mesh_num_devices)
from repro_torch.runtime.elastic import shrink_mesh  # noqa: E402
from repro_torch.search import (SearchConfig, SearchParams,  # noqa: E402
                                draws_shape, ft_search_batch, search_batch,
                                shard_search_batch, shard_search_keys)
from test_torch_search_state import (STARTS, JaxVec, PortVec,  # noqa: E402
                                     _cfgs)
from torch_parity import assert_search_equal, jax_draws  # noqa: E402

A, D = 4, 6
JD = JDom(num_actions=A, game_depth=D, binary_reward=False, seed=3)
TD = PGameDomain(num_actions=A, game_depth=D, binary_reward=False, seed=3)
METHODS = ("sequential", "root", "leaf", "tree", "pipeline")
B = 6


def cfgs(method, **kw):
    p = dict(cp=0.7, max_depth=D, kernels="ref", wave_select="mega", **kw)
    return (JCfg(method=method, budget=24, lanes=4, params=JParams(**p)),
            SearchConfig(method=method, budget=24, lanes=4,
                         params=SearchParams(**p)))


def batch_draws(tc, rng, b):
    """The draws JAX's ``search_batch`` makes for b roots from ``rng``."""
    return jax_draws(rng, (b,) + draws_shape(TD, tc)[:-1], D, A)


def cpu_mesh(n):
    return mesh_from_devices(["cpu"] * n)


@pytest.mark.parametrize("method", METHODS)
def test_sharded_roots_match_jax_on_1_3_8_entries(method):
    """B = 6 and B = 5 (the first five roots' draws) over meshes of 1, 3
    and 8 entries: every root equals the JAX package's."""
    jc, tc = cfgs(method)
    rng = jax.random.key(7)
    jres = jsearch_batch([JD] * B, jc, rng, mesh=False)
    draws = batch_draws(tc, rng, B)
    for n in (1, 3, 8):
        for b in (B, B - 1):
            res = shard_search_keys([TD] * b, tc, draws[:b],
                                    mesh=cpu_mesh(n))
            assert res.action_visits.shape == (b, A)
            assert (res.tree is None) == (method == "root")
            if res.tree is not None:
                assert res.tree.batch == b
            for i in range(b):
                one = jax.tree_util.tree_map(lambda x: x[i], jres)
                assert_search_equal(one, res, b=i,
                                    msg=f"{method} n={n} B={b} root {i} ")


def test_shard_search_batch_draws_b_roots_before_padding():
    """A seed's draws are made for exactly B roots before padding: the
    sharded result is ``search_batch``'s under the same seed, tree and
    all, and ``search_batch(mesh=...)`` shards the same way."""
    _, tc = cfgs("pipeline", vl_mode="wu", level_assign="running")
    base = search_batch([TD] * 5, tc, 11, device="cpu")
    for n in (2, 3):
        mesh = cpu_mesh(n)
        for res in (shard_search_batch([TD] * 5, tc, 11, mesh=mesh),
                    search_batch([TD] * 5, tc, 11, mesh=mesh)):
            assert torch.equal(res.action_visits, base.action_visits)
            assert torch.equal(res.action_value, base.action_value)
            for f in dataclasses.fields(base.tree):
                if f.name != "state":
                    assert torch.equal(getattr(res.tree, f.name),
                                       getattr(base.tree, f.name)), f.name


def test_sharded_varying_fields_match_jax():
    """Domains that differ in a tensor field are stacked per block."""
    jc, tc = _cfgs("pipeline", "mega", 3)
    jres = jsearch_batch([JaxVec(start=jax.numpy.asarray(s))
                          for s in STARTS], jc, jax.random.key(1),
                         mesh=False)
    calls = []
    doms = [PortVec(start=torch.from_numpy(s), calls=calls) for s in STARTS]
    for n in (2, 8):
        res = shard_search_batch(doms, tc, 1, mesh=cpu_mesh(n))
        for i in range(len(doms)):
            one = jax.tree_util.tree_map(lambda x: x[i], jres)
            assert_search_equal(one, res, b=i, msg=f"n={n} root {i} ")


def test_search_batch_mesh_none_outside_a_group_is_one_device():
    """Outside a process group ``mesh=None`` runs on one device, as
    ``mesh=False`` does; a mesh and a device together, or a mesh of
    another type, raise."""
    _, tc = cfgs("tree")
    auto = search_batch([TD] * 5, tc, 3, device="cpu")
    one = search_batch([TD] * 5, tc, 3, device="cpu", mesh=False)
    for f in ("action_visits", "action_value", "best_action"):
        assert torch.equal(getattr(auto, f), getattr(one, f))
    assert auto.tree.batch == 5
    with pytest.raises(ValueError, match="not both"):
        search_batch([TD] * 2, tc, 3, device="cpu", mesh=cpu_mesh(2))
    with pytest.raises(TypeError, match="SearchMesh"):
        search_batch([TD] * 2, tc, 3, device="cpu", mesh="cpu")


def test_mesh_helpers():
    mesh = make_search_mesh(3, device="cpu")
    assert mesh_num_devices(mesh) == 3 and not mesh_is_multihost(mesh)
    assert mesh.home == torch.device("cpu")
    assert [i for i, _ in mesh.local()] == [0, 1, 2]
    assert mesh.group is None
    small = shrink_mesh(mesh, mesh.entries[:2])
    assert small.entries == mesh.entries[2:]
    assert shrink_mesh(mesh, mesh.entries) is None


def test_mesh_paths_raise_without_a_card(monkeypatch):
    """No fallback: without a card and without a CPU device or mesh, the
    mesh, the sharded and fault-tolerant searches and the mesh searcher
    raise."""
    from repro_torch.serving import MCTSDecodeConfig, make_batched_searcher
    from test_torch_lm_decode import TCFG
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = cfgs("sequential")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_search_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_search_mesh(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shard_search_batch([TD] * 2, tc, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft_search_batch([TD] * 2, tc, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_searcher(TCFG, {}, MCTSDecodeConfig(), 4)
    res = shard_search_batch([TD] * 2, tc, 0, mesh=cpu_mesh(2))
    assert res.action_visits.device.type == "cpu"
