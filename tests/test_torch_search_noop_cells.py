"""Port parity of the ``tree`` and ``pipeline`` strategies on the grid cells
that repeat another cell by construction: ``level_assign="running"`` under
``wave_select="scan"`` (a documented no-op) and at one lane (the running
delta is identically zero).  Each must equal the JAX package, and its
``"independent"`` twin."""
import pytest

torch = pytest.importorskip("torch")

from torch_parity import (assert_search_equal, port_search,  # noqa: E402
                          redundant_grid_cells, run_pair)


@pytest.mark.parametrize("method", ["tree", "pipeline"])
@pytest.mark.parametrize("wave_select,vl_mode,level_assign,lanes",
                         redundant_grid_cells())
def test_redundant_cell_matches(method, wave_select, vl_mode, level_assign,
                                lanes):
    kw = dict(budget=48, seed=2, binary=False, wave_select=wave_select,
              vl_mode=vl_mode)
    jres, tres = run_pair(method, lanes, level_assign=level_assign, **kw)
    assert_search_equal(jres, tres, msg=f"{method} {wave_select} ")
    twin = port_search(method, lanes, level_assign="independent", **kw)
    assert torch.equal(twin.action_visits, tres.action_visits)
    assert torch.equal(twin.tree.children, tres.tree.children)
