"""Port parity of searches over the LM-decode domains, on the CPU:
``repro_torch.search.search`` against ``repro.search.search`` with the
cached domain of the JAX package, the port's cached and uncached domains
(float32; weights from the JAX ``init``).  ``action_visits``,
``best_action`` and stats are compared exactly, ``action_value`` within
1e-5, for all five methods and, for ``tree`` / ``pipeline``, every
``wave_select``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.search import SearchConfig as JCfg  # noqa: E402
from repro.search import SearchParams as JParams  # noqa: E402
from repro.search import search as jsearch  # noqa: E402
from repro_torch.search import SearchConfig, SearchParams, search  # noqa: E402
from test_torch_lm_decode import TOL, _domains, params  # noqa: E402,F401


_SEARCH_CELLS = [("sequential", "scan"), ("root", "scan"), ("leaf", "scan")] \
    + [(m, ws) for m in ("tree", "pipeline")
       for ws in ("scan", "lockstep", "mega")]


@pytest.mark.parametrize("method,wave_select", _SEARCH_CELLS)
def test_search_level_parity(params, method, wave_select):
    """One search over the LM domain: the port (cached and uncached) makes
    the JAX package's decisions with its values."""
    jd, td = _domains(params, True)
    _, tdu = _domains(params, False)
    kw = dict(cp=1.0, max_depth=2, puct=True, kernels="ref",
              wave_select=wave_select)
    jres = jsearch(jd, JCfg(method=method, budget=6, lanes=2,
                            keep_tree=False, params=JParams(**kw)),
                   jax.random.key(3))
    tcfg = SearchConfig(method=method, budget=6, lanes=2, keep_tree=False,
                        params=SearchParams(**kw))
    for dom in (td, tdu):
        tres = search(dom, tcfg, 3, device="cpu")
        np.testing.assert_array_equal(tres.action_visits.numpy(),
                                      np.asarray(jres.action_visits))
        np.testing.assert_allclose(tres.action_value.numpy(),
                                   np.asarray(jres.action_value), **TOL)
        assert int(tres.best_action) == int(jres.best_action)
        for k, v in jres.stats.items():
            assert int(tres.stats[k]) == int(v), k
