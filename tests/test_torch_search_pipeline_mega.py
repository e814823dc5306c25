"""Port parity of the ``pipeline`` strategy with the fused wave
(``wave_select="mega"``) over ``vl_mode`` x ``level_assign`` at lanes 1
and 4, against ``repro.search`` on the CPU with JAX-drawn playout
actions."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (assert_search_equal, run_pair,  # noqa: E402
                          search_grid)


@pytest.mark.parametrize("wave_select,vl_mode,level_assign,lanes",
                         search_grid(("mega",)))
def test_pipeline_mega_strategy_matches(wave_select, vl_mode, level_assign,
                                        lanes):
    jres, tres = run_pair("pipeline", lanes, budget=48, seed=2, binary=False,
                          wave_select=wave_select, vl_mode=vl_mode,
                          level_assign=level_assign)
    assert_search_equal(jres, tres, msg=f"pipeline {wave_select} ")


@pytest.mark.parametrize("wave_select", ["mega"])
def test_pipeline_puct_scoring_matches(wave_select):
    """PUCT rows (uniform P-game priors) take the plain scoring path in the
    JAX package and the prior-weighted formula in the fused wave."""
    jres, tres = run_pair("pipeline", 4, budget=32, seed=3, binary=False,
                          wave_select=wave_select, puct=True)
    assert_search_equal(jres, tres, msg=f"puct pipeline {wave_select} ")
