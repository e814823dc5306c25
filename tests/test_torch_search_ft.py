"""Port parity of the elastic fault-tolerant search driver:
``repro_torch.search.ElasticSearchDriver`` / ``ft_search_batch`` against
``repro.search``'s on the CPU.

The kill, whole-queue requeue and never-reached scenarios of
``tests/test_search_ft.py`` run through the port's injection knobs (the
stalls are in ``test_torch_search_ft_stall.py``; the checkpoint, restart
and mesh-shrink scenarios in ``test_torch_search_ft_resume.py``).  The merged result is held bitwise to the port's own
uninterrupted ``search_batch`` and, root for root, to the JAX package's
(floats within ``torch_parity.FLOAT_TOL``); the ``FTReport`` (runs per
root, requeued roots, lost hosts, resumed roots, rounds, commits) equals
the JAX driver's under the same configuration.  The engine's shrink
cases are in ``test_torch_engine.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.search import ElasticSearchDriver as JDriver  # noqa: E402
from repro.search import FTSearchConfig as JFT  # noqa: E402
from repro.search import search_batch as jsearch_batch  # noqa: E402
from repro_torch.search import (STATS_KEYS, ElasticSearchDriver,  # noqa: E402
                                FTSearchConfig, search_batch)
from test_torch_sharding import (JD, TD, batch_draws,  # noqa: E402
                                 cfgs as _pcfgs)
from torch_parity import assert_search_equal  # noqa: E402

METHODS = ("sequential", "root", "leaf", "tree", "pipeline")
B = 6
# a healthy launch beats within microseconds, but a loaded test host can
# stall a thread for tens of ms: the watchdog is 0.5 s (the stall 3x that)
FAST = dict(watchdog_s=0.5)


def cfgs(method):
    jc, tc = _pcfgs(method)
    return (dataclasses.replace(jc, keep_tree=False),
            dataclasses.replace(tc, keep_tree=False))


_runs = {}


def baseline(method):
    """(JAX search_batch, the port's draws, the port's search_batch)."""
    if method not in _runs:
        jc, tc = cfgs(method)
        rng = jax.random.key(7)
        draws = batch_draws(tc, rng, B)
        _runs[method] = (jsearch_batch([JD] * B, jc, rng, mesh=False),
                         draws, search_batch([TD] * B, tc, draws,
                                             device="cpu"))
    return _runs[method]


def assert_bitwise(res, ref):
    for f in ("action_visits", "action_value", "best_action"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    for k in STATS_KEYS:
        assert torch.equal(res.stats[k], ref.stats[k]), k
    assert set(res.extras) == set(ref.extras)
    for k in ref.extras:
        assert torch.equal(res.extras[k], ref.extras[k]), k


def assert_matches_jax(res, jres):
    for i in range(res.action_visits.shape[0]):
        one = jax.tree_util.tree_map(lambda x: x[i], jres)
        assert_search_equal(one, res, b=i, msg=f"root {i} ")


def assert_same_report(drv, jdrv):
    r, j = drv.report, jdrv.report
    np.testing.assert_array_equal(r.runs, j.runs)
    assert (r.requeued, r.lost_hosts, r.resumed, r.rounds, r.commits) == \
        (j.requeued, j.lost_hosts, j.resumed, j.rounds, j.commits)
    assert drv.alive == jdrv.alive


def pair(method, ft_kw, jax_too=True, **kw):
    """Run the port's driver (and the JAX driver) under one config."""
    jc, tc = cfgs(method)
    jres, draws, tres = baseline(method)
    drv = ElasticSearchDriver([TD] * B, tc, draws,
                              FTSearchConfig(**ft_kw, **FAST),
                              device=kw.pop("device", "cpu"), **kw)
    res = drv.run()
    assert res.action_visits.device.type == "cpu"
    assert_bitwise(res, tres)
    assert_matches_jax(res, jres)
    if jax_too:
        jdrv = JDriver([JD] * B, jc, jax.random.key(7), JFT(**ft_kw, **FAST))
        jdrv.run()
        assert_same_report(drv, jdrv)
    return drv


@pytest.mark.parametrize("method", METHODS)
def test_killed_host_merges_bitwise(method):
    drv = pair(method, dict(hosts=3, chunk=1, kill_host_at_root=4),
               jax_too=method == "sequential")
    assert drv.report.lost_hosts == [2] and drv.report.requeued == [4]
    runs = drv.report.runs
    assert runs[4] == 2 and all(runs[i] == 1 for i in range(B) if i != 4)
    assert drv.alive == [True, True, False]


def test_requeued_roots_run_at_most_once_extra():
    drv = pair("pipeline", dict(hosts=2, chunk=0, kill_host_at_root=3))
    assert set(drv.report.requeued) == {3, 4, 5}
    assert int(drv.report.runs.max()) == 2


def test_failure_point_never_reached_is_noop():
    drv = pair("sequential", dict(hosts=2, kill_host_at_root=B + 17))
    assert drv.report.lost_hosts == [] and drv.report.requeued == []
    assert all(drv.report.runs == 1)
