"""The search's state contract beyond 0-d leaves, port against JAX on the CPU.

* State leaves of any trailing shape: a toy domain with a ``[3]`` vector
  leaf and a ``[2, 2]`` matrix leaf searches equal to the JAX package
  under all five strategies (trees compared plane for plane).
* ``search_batch`` over domains that differ in a tensor field: the field
  is stacked, as the JAX package stacks it, and each root equals its own
  ``search``; a differing static field raises TypeError.
* ``search_stacked`` over one domain already stacked over the batch
  equals ``search_batch`` over the domains it stacks.
* ``root_state()`` is called once per ``search`` / ``search_batch``.

The toy's playout is deterministic (it reads no draws), and its values
are exact binary fractions, so integer planes, values and states compare
exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.search import SearchConfig as JCfg  # noqa: E402
from repro.search import SearchParams as JParams  # noqa: E402
from repro.search import search as jsearch  # noqa: E402
from repro.search import search_batch as jsearch_batch  # noqa: E402
from repro_torch.search import (SearchConfig, SearchParams,  # noqa: E402
                                check_domain, search, search_batch,
                                search_stacked)
from torch_parity import assert_search_equal  # noqa: E402

A, DEPTH = 3, 4


@dataclasses.dataclass(frozen=True)
class JaxVec:
    start: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.zeros((3,), jnp.float32))
    num_actions: int = A

    def root_state(self):
        return {"vec": self.start.astype(jnp.float32),
                "mat": jnp.zeros((2, 2), jnp.int32),
                "depth": jnp.int32(0)}

    def step(self, s, a):
        a = jnp.asarray(a, jnp.int32)
        hot = (jnp.arange(3) == a).astype(jnp.float32)
        mat = s["mat"] + jnp.array([[1, 0], [0, 0]], jnp.int32) * (a + 1) \
            + jnp.array([[0, 0], [0, 1]], jnp.int32) * s["depth"]
        return {"vec": s["vec"] * 0.5 + hot, "mat": mat,
                "depth": s["depth"] + 1}

    def is_terminal(self, s):
        return s["depth"] >= DEPTH

    def playout(self, s, rng):
        m = s["mat"]
        k = (m[0, 0] * 7 + m[1, 1] * 3 + s["depth"] * 5) % 16
        return k.astype(jnp.float32) * 0.0625 \
            + s["vec"][0] * 0.001953125 + s["vec"][2] * 0.0009765625


@dataclasses.dataclass(frozen=True)
class PortVec:
    start: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros(3))
    num_actions: int = A
    calls: list = dataclasses.field(default_factory=list)

    draw_shape = (0,)

    def sample_draws(self, shape, generator=None, device="cpu"):
        return torch.zeros(tuple(shape) + (0,), dtype=torch.int32,
                           device=device)

    def root_state(self):
        self.calls.append(1)
        lead = self.start.shape[:-1]
        return {"vec": self.start.float(),
                "mat": torch.zeros(lead + (2, 2), dtype=torch.int32),
                "depth": torch.zeros(lead, dtype=torch.int32)}

    def step(self, s, a):
        a = a.to(torch.int32)
        hot = (torch.arange(3, device=a.device) == a[..., None]).float()
        mat = s["mat"].clone()
        mat[..., 0, 0] += a + 1
        mat[..., 1, 1] += s["depth"]
        return {"vec": s["vec"] * 0.5 + hot, "mat": mat,
                "depth": s["depth"] + 1}

    def is_terminal(self, s):
        return s["depth"] >= DEPTH

    def playout(self, s, draws):
        m = s["mat"]
        k = (m[..., 0, 0] * 7 + m[..., 1, 1] * 3 + s["depth"] * 5) % 16
        return k.float() * 0.0625 + s["vec"][..., 0] * 0.001953125 \
            + s["vec"][..., 2] * 0.0009765625


CELLS = [("sequential", "scan", 1), ("root", "scan", 2), ("leaf", "scan", 2)]\
    + [(m, ws, 3) for m in ("tree", "pipeline")
       for ws in ("scan", "lockstep", "mega")]


def _cfgs(method, wave_select, lanes, budget=12):
    kw = dict(cp=0.7, max_depth=DEPTH, kernels="ref", wave_select=wave_select)
    return (JCfg(method=method, budget=budget, lanes=lanes,
                 params=JParams(**kw)),
            SearchConfig(method=method, budget=budget, lanes=lanes,
                         params=SearchParams(**kw)))


@pytest.mark.parametrize("method,wave_select,lanes", CELLS)
def test_vector_and_matrix_state_leaves_match_jax(method, wave_select,
                                                  lanes):
    jc, tc = _cfgs(method, wave_select, lanes)
    jres = jsearch(JaxVec(), jc, jax.random.key(0))
    dom = PortVec()
    assert check_domain(dom)
    tres = search(dom, tc, 0, device="cpu")
    assert_search_equal(jres, tres, msg=f"{method}/{wave_select} ")
    if tres.tree is not None:
        assert tres.tree.state["vec"].shape == (1, tres.tree.max_nodes, 3)
        assert tres.tree.state["mat"].shape == (1, tres.tree.max_nodes, 2, 2)


STARTS = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 2.0], [0.5, 3.0, 0.0]],
                  np.float32)


@pytest.mark.parametrize("method,wave_select,lanes",
                         [("pipeline", "mega", 3), ("root", "scan", 2)])
def test_search_batch_stacks_differing_tensor_fields(method, wave_select,
                                                     lanes):
    jc, tc = _cfgs(method, wave_select, lanes)
    jres = jsearch_batch([JaxVec(start=jnp.asarray(s)) for s in STARTS], jc,
                         jax.random.key(1), mesh=False)
    calls = []
    doms = [PortVec(start=torch.from_numpy(s), calls=calls) for s in STARTS]
    tres = search_batch(doms, tc, 1, device="cpu")
    assert len(calls) == 1
    for i, d in enumerate(doms):
        one = jax.tree_util.tree_map(lambda x: x[i], jres)
        assert_search_equal(one, tres, b=i, msg=f"root {i} ")
        single = search(PortVec(start=d.start), tc, 1, device="cpu")
        assert torch.equal(single.action_visits, tres.action_visits[i])
        assert torch.equal(single.action_value, tres.action_value[i])
    assert not torch.equal(tres.action_value[0], tres.action_value[1])
    with pytest.raises(TypeError, match="num_actions"):
        search_batch([PortVec(), PortVec(num_actions=2)], tc, 0,
                     device="cpu")


@pytest.mark.parametrize("method,wave_select,lanes",
                         [("pipeline", "mega", 3), ("root", "scan", 2)])
def test_search_stacked_equals_search_batch(method, wave_select, lanes):
    """A domain already stacked over the batch searches as ``search_batch``
    over the B domains it stacks, with one ``root_state()`` call."""
    _, tc = _cfgs(method, wave_select, lanes)
    ref = search_batch([PortVec(start=torch.from_numpy(s)) for s in STARTS],
                       tc, 1, device="cpu")
    calls = []
    res = search_stacked(PortVec(start=torch.from_numpy(STARTS), calls=calls),
                         len(STARTS), tc, 1, device="cpu")
    assert len(calls) == 1
    for f in ("action_visits", "action_value", "best_action"):
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    for k in ref.stats:
        assert torch.equal(res.stats[k], ref.stats[k]), k
    if ref.tree is not None:
        for f in dataclasses.fields(ref.tree):
            a, b = getattr(res.tree, f.name), getattr(ref.tree, f.name)
            if f.name == "state":
                assert all(torch.equal(a[k], b[k]) for k in b), f.name
            else:
                assert torch.equal(a, b), f.name
    with pytest.raises(TypeError, match="stacked over 3"):
        search_stacked(PortVec(), 3, tc, 0, device="cpu")


@pytest.mark.parametrize("method", ["sequential", "root", "leaf", "tree",
                                    "pipeline"])
def test_root_state_is_computed_once_per_search(method):
    calls = []
    _, tc = _cfgs(method, "mega" if method in ("tree", "pipeline")
                  else "scan", 2)
    dom = PortVec(calls=calls)
    search(dom, tc, 0, device="cpu")
    assert len(calls) == 1
    search_batch([dom] * 3, tc, 0, device="cpu")
    assert len(calls) == 2
    search_batch([PortVec(start=torch.full((3,), float(i)), calls=calls)
                  for i in range(2)], tc, 0, device="cpu")
    assert len(calls) == 3
