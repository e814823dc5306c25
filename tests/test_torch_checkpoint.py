"""Port parity of the checkpoint store: ``repro_torch.checkpoint.store``
runs the cases of ``tests/test_checkpoint.py`` and the checkpoint tests of
``tests/test_substrate.py`` on trees of tensors, and checkpoints cross
between the packages: a ``SearchResult`` with a bf16 leaf written by
``repro.checkpoint.store`` restores in the port, and one the port wrote
restores in the JAX package, leaf for leaf (the same layout on disk, the
leaves in ``jax.tree_util``'s order)."""
import builtins
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core.domains.pgame import PGameDomain as JDom  # noqa: E402
from repro.search import SearchConfig as JCfg  # noqa: E402
from repro.search import search_batch as jsearch_batch  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core.pytree import flatten, tree_map  # noqa: E402
from repro_torch.search import SearchResult  # noqa: E402


def _result_tree(b=4, a=3, scale=1.0):
    """A search-result-shaped tree (the elastic driver's commit payload)."""
    return {
        "done": torch.tensor([True, False, True, False][:b]),
        "results": {
            "action_visits": (torch.arange(b * a).reshape(b, a) * scale)
            .to(torch.int32),
            "action_value": torch.linspace(0, scale, b * a).reshape(b, a),
            "best_action": torch.arange(b, dtype=torch.int32),
            "stats": {"playouts": torch.full((b,), 32, dtype=torch.int32),
                      "ticks": torch.full((b,), 9, dtype=torch.int32)},
        },
    }


def _like(tree):
    return tree_map(torch.zeros_like, tree)


def _assert_tree_equal(a, b):
    la, lb = flatten(a)[0], flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    tree = _result_tree()
    store.save(d, 1, tree)
    assert store.latest_step(d) == 1
    _assert_tree_equal(store.restore(d, 1, _like(tree)), tree)


def test_bf16_and_0d_leaves_roundtrip(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(10.0), "step": torch.tensor(3),
            "b": {"c": torch.arange(6.0).to(torch.bfloat16).reshape(2, 3)}}
    store.save(d, 7, tree)
    out = store.restore(d, 7, _like(tree))
    assert out["b"]["c"].dtype == torch.bfloat16
    _assert_tree_equal(out, tree)


def test_kill_mid_write_never_tears_the_latest(tmp_path, monkeypatch):
    d = str(tmp_path)
    t1, t2 = _result_tree(scale=1.0), _result_tree(scale=2.0)
    store.save(d, 1, t1)
    real_save = np.save
    calls = {"n": 0}

    def dying_save(path, arr, **kw):
        calls["n"] += 1
        if calls["n"] == 2:                 # die after the first leaf lands
            raise KeyboardInterrupt("injected kill mid-write")
        return real_save(path, arr, **kw)

    monkeypatch.setattr(np, "save", dying_save)
    with pytest.raises(KeyboardInterrupt):
        store.save(d, 2, t2)
    monkeypatch.setattr(np, "save", real_save)
    assert store.latest_step(d) == 1
    _assert_tree_equal(store.restore(d, 1, _like(t1)), t1)
    with pytest.raises(FileNotFoundError):
        store.restore(d, 2, _like(t2))
    store.save(d, 2, t2)                    # a retry commits over the tmp
    assert store.latest_step(d) == 2
    _assert_tree_equal(store.restore(d, 2, _like(t2)), t2)


def test_kill_between_rename_and_commit_marker(tmp_path, monkeypatch):
    d = str(tmp_path)
    store.save(d, 1, _result_tree())
    real_open = open
    step2 = os.path.join(d, "step_00000002")

    def dying_open(path, *a, **kw):
        if isinstance(path, str) and path == os.path.join(step2,
                                                          store.COMMITTED):
            raise KeyboardInterrupt("injected kill before commit marker")
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", dying_open)
    with pytest.raises(KeyboardInterrupt):
        store.save(d, 2, _result_tree(scale=2.0))
    monkeypatch.setattr(builtins, "open", real_open)
    assert os.path.isdir(step2)
    assert store.latest_step(d) == 1
    store.save(d, 3, _result_tree(scale=3.0))    # reaps the debris
    assert not os.path.isdir(step2)
    assert store.latest_step(d) == 3


def test_keep_n_pruning_and_async_saves(tmp_path):
    d = str(tmp_path)
    for s in range(1, 6):
        store.save(d, s, _result_tree(scale=float(s)), keep=2)
    assert sorted(store._committed_steps(d)) == [4, 5]
    _assert_tree_equal(store.restore(d, 4, _like(_result_tree())),
                       _result_tree(scale=4.0))
    d2 = str(tmp_path / "async")
    for s in (1, 2, 3, 4):
        store.save(d2, s, {"x": torch.zeros(4)}, asynchronous=True,
                   keep=2).join()
    assert sorted(int(n[5:]) for n in os.listdir(d2)
                  if n.startswith("step_")) == [3, 4]


def test_stale_tmp_dirs_are_invisible_then_reaped(tmp_path):
    d = str(tmp_path)
    store.save(d, 1, {"x": torch.zeros(4)})
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    os.makedirs(os.path.join(d, "step_00000007.tmp"))
    assert store.latest_step(d) == 1
    store.save(d, 3, {"x": torch.zeros(4)})
    assert not any(n.endswith(".tmp") for n in os.listdir(d))


def test_restore_structure_mismatch_raises(tmp_path):
    d = str(tmp_path)
    store.save(d, 1, _result_tree())
    with pytest.raises(ValueError, match="leaves"):
        store.restore(d, 1, {"just_one": torch.zeros(4, 3)})
    bad = _result_tree()
    bad["results"]["action_visits"] = torch.zeros(9, 9, dtype=torch.int32)
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(d, 1, bad)


def test_manager_restore_latest(tmp_path):
    mgr = store.CheckpointManager(str(tmp_path), keep=3, every=1)
    tree = _result_tree()
    assert mgr.latest() is None
    assert mgr.restore_latest(_like(tree)) == (None, None)
    assert mgr.maybe_save(5, tree)
    mgr.wait()
    step, state = mgr.restore_latest(_like(tree))
    assert step == 5
    _assert_tree_equal(state, tree)


def _jax_result():
    """A JAX ``SearchResult`` (no tree) plus a bf16 leaf."""
    cfg = JCfg(method="pipeline", budget=16, lanes=4, keep_tree=False)
    res = jsearch_batch([JDom(num_actions=4, game_depth=5)] * 3, cfg,
                        jax.random.key(0), mesh=False)
    return {"res": res, "w": jnp.arange(6.0, dtype=jnp.bfloat16) / 3}


def _to_port(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _port_like(jtree):
    """The same values in the port's structure: a port ``SearchResult``."""
    return {"res": SearchResult(*[jax.tree_util.tree_map(_to_port, f)
                                  for f in jtree["res"]]),
            "w": _to_port(jtree["w"])}


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jt = _jax_result()
    jstore.save(str(tmp_path), 3, jt)
    like = _port_like(jt)
    out = store.restore(str(tmp_path), 3, tree_map(torch.zeros_like, like))
    assert isinstance(out["res"], SearchResult) and out["res"].tree is None
    assert out["w"].dtype == torch.bfloat16
    _assert_tree_equal(out, like)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jt = _jax_result()
    port = _port_like(jt)
    store.save(str(tmp_path), 4, port)
    out = jstore.restore(str(tmp_path), 4,
                         jax.tree_util.tree_map(jnp.zeros_like, jt))
    assert out["w"].dtype == ml_dtypes.bfloat16
    jl, ol = jax.tree_util.tree_leaves(jt), jax.tree_util.tree_leaves(out)
    assert len(jl) == len(ol) == len(flatten(port)[0])
    for a, b in zip(jl, ol):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a).astype(np.float32),
                                      np.asarray(b).astype(np.float32))
