"""Port parity of the elastic search driver under a stalled host:
``repro_torch.search.ElasticSearchDriver`` against ``repro.search``'s on
the CPU, for every method (the stall scenario of
``tests/test_search_ft.py``; the rest is in ``test_torch_search_ft.py``
and ``test_torch_search_ft_resume.py``).

A host hung past the watchdog is declared lost by the ``Heartbeat`` and
treated as a kill: its in-flight chunk is requeued, and the merge is
bitwise the uninterrupted ``search_batch`` run and, root for root, the
JAX package's; the report equals the JAX driver's.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_search_ft import B, METHODS, pair  # noqa: E402


@pytest.mark.parametrize("method", METHODS)
def test_stalled_host_merges_bitwise(method):
    drv = pair(method, dict(hosts=2, chunk=2, stall_host_at_root=1),
               jax_too=method == "sequential")
    assert drv.report.lost_hosts == [0]
    assert sorted(drv.report.requeued) == [0, 1]
    runs = drv.report.runs
    assert runs[0] == 2 and runs[1] == 2
    assert all(runs[i] == 1 for i in range(2, B))
