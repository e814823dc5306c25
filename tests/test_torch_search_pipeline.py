"""Port parity of the ``pipeline`` strategy with ``wave_select`` "scan" or "lockstep"
over ``vl_mode`` x ``level_assign`` at lanes 1 and 4, against
``repro.search`` on the CPU with JAX-drawn playout actions."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (assert_search_equal, run_pair,  # noqa: E402
                          search_grid)


@pytest.mark.parametrize("wave_select,vl_mode,level_assign,lanes",
                         search_grid(("scan", "lockstep")))
def test_pipeline_strategy_matches(wave_select, vl_mode, level_assign,
                                   lanes):
    jres, tres = run_pair("pipeline", lanes, budget=48, seed=2, binary=False,
                          wave_select=wave_select, vl_mode=vl_mode,
                          level_assign=level_assign)
    assert_search_equal(jres, tres, msg=f"pipeline {wave_select} ")
