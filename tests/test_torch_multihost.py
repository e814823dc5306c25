"""Two-process ``torch.distributed`` CPU test of the port's sharded search
(the counterpart of ``tests/test_multihost.py``).

Two worker processes, started with the ``spawn`` method, join one gloo
group through a ``file://`` rendezvous in ``tmp_path`` and build one
mesh of four CPU entries, two per process (``make_search_mesh(4,
device="cpu")``).  Each runs ``shard_search_batch`` at B = 5 (padding
across the process boundary: blocks of two, the last half padding), then
the killed-worker elastic driver in lockstep, locally (``mesh=None``) and
over the mesh (each logical host one process's entries, gathered to
both).  Each worker writes what it gathered through the checkpoint store
(a directory of its own: the store has one writer per directory);
the parent holds both against the JAX package per root and against the
port's own single-process run.
"""
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

A, D, B = 4, 6, 5


def _setup():
    from repro_torch.core.domains.pgame import PGameDomain
    from repro_torch.search import SearchConfig, SearchParams
    dom = PGameDomain(num_actions=A, game_depth=D, binary_reward=False,
                      seed=3)
    cfg = SearchConfig(method="pipeline", budget=24, lanes=4,
                       keep_tree=False,
                       params=SearchParams(cp=0.7, max_depth=D,
                                           kernels="ref"))
    return dom, cfg


def _worker(rank: int, init: str, out: str, draws5, draws6) -> None:
    torch.set_num_threads(1)
    from repro_torch.checkpoint import store
    from repro_torch.parallel import (init_distributed, make_search_mesh,
                                      mesh_is_multihost)
    from repro_torch.search import (ElasticSearchDriver, FTSearchConfig,
                                    search_batch, shard_search_batch)
    init_distributed("gloo", init, 2, rank)
    dom, cfg = _setup()
    mesh = make_search_mesh(4, device="cpu")
    assert mesh_is_multihost(mesh) and [e.rank for e in mesh.entries] \
        == [0, 0, 1, 1]
    sharded = shard_search_batch([dom] * B, cfg, draws5, mesh=mesh)
    auto = search_batch([dom] * B, cfg, draws5, device="cpu")  # in a group
    ft = FTSearchConfig(hosts=2, chunk=2, watchdog_s=0.5,
                        kill_host_at_root=4)
    reports = []
    merged = []
    for m, dev in ((None, "cpu"), (mesh, None)):
        drv = ElasticSearchDriver([dom] * 6, cfg, draws6, ft, mesh=m,
                                  device=dev)
        merged.append(drv.run())
        reports.append({"runs": torch.from_numpy(drv.report.runs),
                        "requeued": torch.tensor(drv.report.requeued),
                        "lost": torch.tensor(drv.report.lost_hosts)})
    store.save(f"{out}/rank{rank}", 1, {"sharded": sharded, "auto": auto,
                           "ft_local": merged[0], "ft_mesh": merged[1],
                           "reports": reports})
    import torch.distributed as dist
    dist.destroy_process_group()


def test_two_process_gloo_search(tmp_path):
    import jax

    from repro.core.domains.pgame import PGameDomain as JDom
    from repro.search import SearchConfig as JCfg
    from repro.search import SearchParams as JParams
    from repro.search import search_batch as jsearch_batch
    from repro_torch.checkpoint import store
    from repro_torch.core.pytree import flatten, tree_map
    from repro_torch.search import draws_shape, search_batch
    from torch_parity import assert_search_equal, jax_draws

    dom, cfg = _setup()
    jdom = JDom(num_actions=A, game_depth=D, binary_reward=False, seed=3)
    jcfg = JCfg(method="pipeline", budget=24, lanes=4, keep_tree=False,
                params=JParams(cp=0.7, max_depth=D, kernels="ref"))
    per = draws_shape(dom, cfg)[:-1]
    rng = jax.random.key(7)
    draws5, draws6 = (jax_draws(rng, (b,) + per, D, A) for b in (5, 6))
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "out")
    procs = [ctx.Process(target=_worker,
                         args=(r, f"file://{tmp_path}/rendezvous", out,
                               draws5, draws6)) for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=240)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]

    base5 = search_batch([dom] * B, cfg, draws5, device="cpu")
    base6 = search_batch([dom] * 6, cfg, draws6, device="cpu")
    jres5 = jsearch_batch([jdom] * B, jcfg, rng, mesh=False)
    like = {"sharded": base5, "auto": base5, "ft_local": base6,
            "ft_mesh": base6,
            "reports": [{"runs": torch.zeros(6, dtype=torch.int64),
                         "requeued": torch.zeros(2, dtype=torch.int64),
                         "lost": torch.zeros(1, dtype=torch.int64)}] * 2}
    for rank in (0, 1):
        got = store.restore(f"{out}/rank{rank}", 1,
                            tree_map(torch.zeros_like, like))
        for k, base in (("sharded", base5), ("auto", base5),
                        ("ft_local", base6), ("ft_mesh", base6)):
            for x, y in zip(flatten(got[k])[0], flatten(base)[0]):
                assert torch.equal(x, y), (rank, k)
        for i in range(B):
            one = jax.tree_util.tree_map(lambda x: x[i], jres5)
            assert_search_equal(one, got["sharded"], b=i,
                                msg=f"rank {rank} root {i} ")
        for rep in got["reports"]:
            assert rep["lost"].tolist() == [1]
            assert sorted(rep["requeued"].tolist()) == [3, 4]
            np.testing.assert_array_equal(rep["runs"].numpy(),
                                          [1, 1, 1, 2, 2, 1])
