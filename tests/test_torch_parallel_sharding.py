"""Port parity of the logical-axis sharding rules and the pure-Python
``core`` copies: ``repro_torch.parallel.sharding.resolve_spec`` and every
family's ``param_axes`` / ``cache_axes`` against the JAX package's, and
``repro_torch.core.schedule`` / ``core.metrics`` on the cases of the JAX
package's own tests (``tests/test_mcts_core.py``,
``tests/test_properties.py``).

``resolve_spec`` reads only a mesh's ``axis_names`` and
``devices.shape``, so a stand-in with those two serves both functions on
the production meshes (2, 4), (16, 16) and (2, 16, 16) without devices;
the shapes are the JAX ``init`` / ``init_cache``'s at each architecture's
full config (``jax.eval_shape``: nothing is allocated).  Specs must be
equal tuple for tuple, the axes trees equal, and each family's axes tree
must match the port's own ``init`` / ``init_cache`` leaf for leaf (smoke
configs, on the CPU).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import ARCHS, get_config  # noqa: E402
from repro.core import metrics as jmetrics  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.models.base import get_family as jfamily  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import get_smoke_config as tsmoke  # noqa: E402
from repro_torch.core import metrics, schedule  # noqa: E402
from repro_torch.models.base import get_family as tfamily  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402

settings.register_profile("parallel_sharding", max_examples=30,
                          deadline=None)


@dataclasses.dataclass
class StandIn:
    """A mesh as ``resolve_spec`` reads one."""
    axis_names: tuple
    devices: np.ndarray


MESHES = [StandIn(("data", "model"), np.empty((2, 4))),
          StandIn(("data", "model"), np.empty((16, 16))),
          StandIn(("pod", "data", "model"), np.empty((2, 16, 16)))]


def _specs(arch):
    cfg, tcfg = get_config(arch), tget(arch)
    jf, tf = jfamily(cfg), tfamily(tcfg)
    shapes = {"param": jax.eval_shape(lambda: jf.init(cfg,
                                                      jax.random.key(0))),
              "cache": jax.eval_shape(lambda: jf.init_cache(cfg, 32, 4096))}
    axes = {"param": (jf.param_axes(cfg), tf.param_axes(tcfg)),
            "cache": (jf.cache_axes(cfg), tf.cache_axes(tcfg))}
    return shapes, axes


@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_matches_jax(arch):
    shapes, axes = _specs(arch)
    fell_back = 0
    for kind in ("param", "cache"):
        jax_axes, port_axes = axes[kind]
        assert port_axes == jax_axes
        for mesh in MESHES:
            want = JS.spec_tree(jax_axes, shapes[kind], mesh)
            got = TS.spec_tree(port_axes, shapes[kind], mesh)
            w = jax.tree_util.tree_leaves(
                want, is_leaf=lambda x: isinstance(x, tuple))
            g = jax.tree_util.tree_leaves(
                got, is_leaf=lambda x: isinstance(x, tuple))
            assert len(g) == len(w) > 0
            for a, b in zip(g, w):
                assert isinstance(a, TS.PartitionSpec)
                assert tuple(a) == tuple(b)

            def count(ax, leaf):
                nonlocal fell_back
                spec = TS.resolve_spec(ax, tuple(leaf.shape), mesh)
                fell_back += sum(
                    1 for i, n in enumerate(ax or ())
                    if n and TS.DEFAULT_RULES.get(n)
                    and (i >= len(spec) or spec[i] is None))
            TS.map_axes(count, port_axes, shapes[kind])
    if arch == "smollm-135m":     # 3 kv heads on a 2- or 16-way model axis
        assert fell_back > 0      # take the replication fallback


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_trees_match_the_ports_own_trees(arch):
    cfg = tsmoke(arch)
    fam = tfamily(cfg)
    trees = ((fam.param_axes(cfg), fam.init(cfg, device="cpu")),
             (fam.cache_axes(cfg), fam.init_cache(cfg, 2, 8, device="cpu")))
    for axes, tree in trees:
        got = TS.map_axes(lambda ax, t: (len(ax), t.ndim), axes, tree)
        pairs = jax.tree_util.tree_leaves(
            got, is_leaf=lambda x: isinstance(x, tuple))
        assert pairs and all(a == b for a, b in pairs)


def test_local_slices_cover_each_leaf():
    """The ranks' slices of a (pod 2, data 2, model 2) spec tile the
    tensor once; ``replicas`` counts the ranks holding each slice."""
    from repro_torch.parallel.mesh import Mesh
    ranks = np.arange(8).reshape(2, 2, 2)
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    for spec in (TS.P(("pod", "data"), "model"), TS.P(None, "data"),
                 TS.P()):
        seen = torch.zeros_like(x)
        for r in range(8):
            m = Mesh(ranks, ("pod", "data", "model"), r)
            seen[TS.local_slices(spec, x.shape, m)] += 1
            assert torch.equal(TS.shard(x, spec, m),
                               x[TS.local_slices(spec, x.shape, m)])
        assert torch.equal(seen, torch.full_like(x, TS.replicas(spec, m)))


# ---------------------------------------------------------------------------
# the core copies: the JAX package's test cases
# ---------------------------------------------------------------------------
def test_schedule_paper_figures():
    assert schedule.pipeline_makespan(4, (1, 1, 1, 1), lanes=1) == 7.0
    assert schedule.sequential_makespan(4) == 16.0
    assert schedule.pipeline_makespan(4, (1, 1, 2, 1), lanes=1) == 11.0
    assert schedule.pipeline_makespan(4, (1, 1, 2, 1), lanes=2) == 8.0
    assert schedule.steady_state_throughput((1, 1, 2, 1), 1) == 0.5
    assert schedule.steady_state_throughput((1, 1, 2, 1), 2) == 1.0
    base = schedule.pipeline_makespan(32, (1, 1, 4, 1), lanes=1)
    for lanes in (2, 4, 8):
        t = schedule.pipeline_makespan(32, (1, 1, 4, 1), lanes=lanes)
        assert t <= base
        base = t


@settings(settings.get_profile("parallel_sharding"))
@given(n=st.integers(1, 64),
       costs=st.tuples(*[st.floats(0.25, 4.0) for _ in range(4)]),
       lanes=st.integers(1, 8))
def test_schedule_properties_and_jax_equality(n, costs, lanes):
    p = schedule.pipeline_makespan(n, costs, lanes)
    assert p == jschedule.pipeline_makespan(n, costs, lanes)
    assert p <= schedule.sequential_makespan(n, costs) + 1e-9
    assert schedule.pipeline_makespan(n, costs, lanes=1) \
        >= n * max(costs) - 1e-9
    assert schedule.pipeline_makespan(n, costs, lanes + 1) <= p + 1e-9
    assert schedule.steady_state_throughput(costs, lanes) \
        == jschedule.steady_state_throughput(costs, lanes)
    g, b = schedule.occupancy_trace(min(n, 8), costs, lanes)
    jg, jb = jschedule.occupancy_trace(min(n, 8), costs, lanes)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(b, jb)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    seq = {b: float(s) for b, s in zip((8, 16, 32, 64),
                                       np.sort(rng.random(4)))}
    par = {b: float(s) * 0.9 for b, s in seq.items()}
    for fn, args in ((metrics.playout_speedup, (3.0, 0.5)),
                     (metrics.playout_speedup, (1.0, 0.0)),
                     (metrics.strength, ([1, 2, 1, 1], 1)),
                     (metrics.strength_speedup, (0.8, 0.6)),
                     (metrics.search_overhead, (seq, par, 0.3)),
                     (metrics.search_overhead, (seq, par, 2.0)),
                     (metrics.duplicate_rate, (3, 0))):
        np.testing.assert_equal(fn(*args),
                                getattr(jmetrics, fn.__name__)(*args))
