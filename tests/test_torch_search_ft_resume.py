"""Port parity of the elastic search driver's checkpoints, restarts and
mesh shrink: ``repro_torch.search.ElasticSearchDriver`` against
``repro.search``'s on the CPU (the rest of ``tests/test_search_ft.py``'s
scenarios; kill, stall and requeue are in ``test_torch_search_ft.py``).

A failure after the last commit and a driver restart resume from the
checkpoint store; losing every host raises; varying domains ride through
requeue; a host owning half an 8-entry in-process mesh is killed and the
survivor's shrunken mesh finishes.  Each merged result is held bitwise to
the port's own uninterrupted ``search_batch`` and to the JAX package per
root; each ``FTReport`` to the JAX driver's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.search import ElasticSearchDriver as JDriver  # noqa: E402
from repro.search import FTSearchConfig as JFT  # noqa: E402
from repro.search import search_batch as jsearch_batch  # noqa: E402
from repro_torch.parallel import mesh_from_devices  # noqa: E402
from repro_torch.search import (ElasticSearchDriver,  # noqa: E402
                                FTSearchConfig, ft_search_batch,
                                search_batch)
from test_torch_search_ft import (B, FAST, JD, TD, assert_bitwise,  # noqa: E402
                                  assert_matches_jax, assert_same_report,
                                  baseline, cfgs, pair)
from test_torch_search_state import JaxVec, PortVec, _cfgs  # noqa: E402


def test_failure_after_last_commit_is_noop(tmp_path):
    """A restarted driver whose roots are all committed launches nothing
    (its structure template aside, which is no launch of a root)."""
    jc, tc = cfgs("tree")
    jres, draws, tres = baseline("tree")
    ckpt = dict(ckpt_dir=str(tmp_path / "port"), **FAST)
    res1 = ElasticSearchDriver([TD] * B, tc, draws,
                               FTSearchConfig(hosts=2, **ckpt),
                               device="cpu").run()
    again = ElasticSearchDriver(
        [TD] * B, tc, draws,
        FTSearchConfig(hosts=2, kill_host_at_root=2, **ckpt), device="cpu")
    res2 = again.run()
    assert_bitwise(res2, res1)
    assert_bitwise(res2, tres)
    jckpt = dict(ckpt_dir=str(tmp_path / "jax"), **FAST)
    JDriver([JD] * B, jc, jax.random.key(7), JFT(hosts=2, **jckpt)).run()
    jagain = JDriver([JD] * B, jc, jax.random.key(7),
                     JFT(hosts=2, kill_host_at_root=2, **jckpt))
    jagain.run()
    assert_same_report(again, jagain)
    assert again.report.resumed == list(range(B))
    assert all(again.report.runs == 0)


def test_driver_restart_resumes_from_committed_roots(tmp_path):
    jc, tc = cfgs("pipeline")
    jres, draws, tres = baseline("pipeline")
    ft = FTSearchConfig(hosts=2, chunk=2, ckpt_dir=str(tmp_path / "p"),
                        **FAST)
    d1 = ElasticSearchDriver([TD] * B, tc, draws, ft, device="cpu")
    assert d1.run(max_rounds=1) is None            # "crash" after a round
    committed = set(np.nonzero(d1._done)[0].tolist())
    assert 0 < len(committed) < B
    d2 = ElasticSearchDriver([TD] * B, tc, draws, ft, device="cpu")
    res = d2.run()
    assert_bitwise(res, tres)
    assert_matches_jax(res, jres)
    assert set(d2.report.resumed) == committed
    jft = JFT(hosts=2, chunk=2, ckpt_dir=str(tmp_path / "j"), **FAST)
    JDriver([JD] * B, jc, jax.random.key(7), jft).run(max_rounds=1)
    j2 = JDriver([JD] * B, jc, jax.random.key(7), jft)
    j2.run()
    assert_same_report(d2, j2)


def test_losing_every_host_raises():
    _, tc = cfgs("sequential")
    with pytest.raises(RuntimeError, match="hosts lost"):
        ft_search_batch([TD] * 2, tc, 7, device="cpu",
                        ft=FTSearchConfig(hosts=1, kill_host_at_root=0,
                                          **FAST))


def test_varying_domains_and_stats_survive_failure():
    """Per-root varying fields ride through requeue and merge."""
    starts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 2.0], [0.5, 3.0, 0.0],
                       [2.0, 1.0, 0.5], [0.0, 0.25, 4.0]], np.float32)
    jc, tc = _cfgs("root", "scan", 2)
    jdoms = [JaxVec(start=jax.numpy.asarray(s)) for s in starts]
    jbase = jsearch_batch(jdoms, jc, jax.random.key(11), mesh=False)
    calls = []
    doms = [PortVec(start=torch.from_numpy(s), calls=calls) for s in starts]
    base = search_batch(doms, tc, 11, device="cpu")
    ft = dict(hosts=2, chunk=2, kill_host_at_root=3, **FAST)
    drv = ElasticSearchDriver(doms, tc, 11, FTSearchConfig(**ft),
                              device="cpu")
    res = drv.run()
    assert_bitwise(res, base)
    assert_matches_jax(res, jbase)
    jdrv = JDriver(jdoms, jc, jax.random.key(11), JFT(**ft))
    jdrv.run()
    assert_same_report(drv, jdrv)
    assert sorted(drv.report.requeued) == [3, 4]


def test_mesh_shrink_on_8_entries():
    """Kill a host owning half an 8-entry mesh: the survivor's shrunken
    world still merges bitwise, and the lost host's entries are gone."""
    mesh = mesh_from_devices(["cpu"] * 8)
    drv = pair("pipeline", dict(hosts=2, chunk=2, kill_host_at_root=4),
               device=None, mesh=mesh)
    assert drv.report.lost_hosts == [1]
    assert [len(e or []) for e in drv._host_entries] == [4, 0]
    assert drv.mesh.entries == mesh.entries[:4]
    assert sorted(drv.report.requeued) == [3, 4]
    with pytest.raises(ValueError, match="cannot serve"):
        ElasticSearchDriver([TD] * 4, cfgs("pipeline")[1], 0,
                            FTSearchConfig(hosts=3),
                            mesh=mesh_from_devices(["cpu"] * 2))
