"""Port parity: ``repro_torch.search`` against ``repro.search`` on the CPU.

The single-trajectory strategies, ``search_batch`` and the API contract;
the ``tree`` and ``pipeline`` strategies over ``wave_select`` x
``vl_mode`` x ``level_assign`` are in ``test_torch_search_{tree,pipeline}``
and ``..._mega``.  Every search takes JAX-drawn playout
actions along the JAX strategy's own key splits; results must be equal
(float sums within ``torch_parity.FLOAT_TOL``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.search import search_batch as jsearch_batch  # noqa: E402
from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.search import (STATS_KEYS, SearchConfig,  # noqa: E402
                                SearchParams, check_domain, draws_shape,
                                list_strategies, search, search_batch)
from torch_parity import (SEARCH_A, SEARCH_D,  # noqa: E402
                          assert_search_equal, jax_draws, run_pair,
                          search_configs, search_domains)

A, D = SEARCH_A, SEARCH_D


@pytest.mark.parametrize("method,lanes,binary,vl_mode", [
    ("sequential", 1, False, "wu"), ("root", 3, True, "wu"),
    ("leaf", 4, True, "loss"), ("leaf", 4, False, "wu")])
def test_single_trajectory_strategies_match(method, lanes, binary, vl_mode):
    jres, tres = run_pair(method, lanes, budget=48, seed=1, binary=binary,
                          vl_mode=vl_mode)
    assert_search_equal(jres, tres, msg=f"{method} ")
    assert int(tres.stats["duplicates"]) == 0


def test_search_batch_matches_jax_and_per_root_search():
    jd, td = search_domains(False)
    jc, tc = search_configs("pipeline", 4, 32, wave_select="mega", vl_mode="wu",
                   level_assign="running")
    rng = jax.random.key(5)
    jres = jsearch_batch([jd] * 3, jc, rng, mesh=False)
    keys = jax.random.split(rng, 3)
    per = draws_shape(td, tc)[:-1]
    draws = torch.stack([jax_draws(k, per, D, A) for k in keys])
    tres = search_batch([td] * 3, tc, draws, device="cpu")
    assert tres.tree.batch == 3
    for i in range(3):
        one = jax.tree_util.tree_map(lambda x: x[i], jres)
        assert_search_equal(one, tres, b=i, msg=f"root {i} ")
        single = search(td, tc, draws[i], device="cpu")
        assert torch.equal(single.action_visits, tres.action_visits[i])
        assert torch.equal(single.tree.visits[0], tres.tree.visits[i])


def test_api_surface_and_contract():
    _, td = search_domains()
    assert list_strategies() == ["leaf", "pipeline", "root", "sequential",
                                 "tree"]
    assert check_domain(td)
    for m in list_strategies():
        cfg = SearchConfig(method=m, budget=16, lanes=2,
                           params=SearchParams(max_depth=D))
        res = search(td, cfg, 3, device="cpu")
        assert set(res.stats) == set(STATS_KEYS)
        assert res.action_visits.shape == (A,)
        assert int(res.stats["playouts_completed"]) \
            == int(res.stats["playouts_requested"])
    with pytest.raises(ValueError):
        search(td, SearchConfig(method="nope"), 0, device="cpu")
    with pytest.raises(ValueError):
        search(td, SearchConfig(budget=4), torch.zeros(3, dtype=torch.int32),
               device="cpu")
    with pytest.raises(TypeError):
        search_batch([td, PGameDomain(num_actions=A, game_depth=D, seed=1)],
                     SearchConfig(budget=4), 0, device="cpu")
    cfg = SearchConfig(kernels="ref", wave_select="mega", vl_mode="wu",
                       level_assign="running")
    assert (cfg.params.kernels, cfg.params.wave_select, cfg.params.vl_mode,
            cfg.params.level_assign) == ("ref", "mega", "wu", "running")


def test_seeded_searches_are_reproducible_and_strong():
    """The same seed gives the same search; with enough budget the robust
    child is the exact optimum of a small game."""
    from repro_torch.core.domains.pgame import optimal_root_action
    td = PGameDomain(num_actions=3, game_depth=4, binary_reward=False,
                     seed=4)
    cfg = SearchConfig(method="pipeline", budget=256, lanes=4,
                       params=SearchParams(cp=0.7, max_depth=4,
                                           wave_select="mega"))
    r1 = search(td, cfg, 11, device="cpu")
    r2 = search(td, cfg, torch.Generator().manual_seed(11), device="cpu")
    assert torch.equal(r1.action_visits, r2.action_visits)
    assert int(r1.best_action) == optimal_root_action(td)
    assert np.isfinite(r1.action_value.numpy()).all()

