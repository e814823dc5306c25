"""Port parity of the running-assignment UCT argmax (``uct_select``'s
``uct_argmax_running``) against the JAX package on the CPU: its reference
(``use_ref``) and its Pallas kernel in interpret mode, on the boards of
``tests/test_kernels.py`` (duplicated parents, finished lanes, sentinel
rotation), made with numpy from a seed.  Decisions must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.uct_select import ops as juo  # noqa: E402
from repro_torch.kernels.uct_select import ops as tuo  # noqa: E402


def _both_jax(fn, *args, **kw):
    a1 = np.asarray(fn(*args, use_ref=True, **kw))
    a2 = np.asarray(fn(*args, interpret=True, **kw))
    np.testing.assert_array_equal(a1, a2)
    return a1


def _board(seed, r, a, parents):
    rng = np.random.default_rng(seed)
    rows = np.arange(r) % parents
    n = rng.integers(0, 50, (parents, a)).astype(np.float32)[rows]
    w = (rng.normal(size=(parents, a)) * 3).astype(np.float32)[rows]
    vl = rng.integers(0, 3, (r, a)).astype(np.float32)
    o = rng.integers(0, 5, (r, a)).astype(np.float32)
    valid = rng.random((r, a)) < 0.8
    valid[:, 0] = True
    return n, w, vl, o, valid


def _port_running(n, w, vl, pn, pid, **kw):
    t = lambda x: torch.from_numpy(np.asarray(x))
    kw = {k: (t(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return tuo.uct_argmax_running(t(n), t(w), t(vl), t(pn), t(pid),
                                  **kw).numpy()


def _jax_running(n, w, vl, pn, pid, **kw):
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in kw.items()}
    return _both_jax(juo.uct_argmax_running, jnp.asarray(n), jnp.asarray(w),
                     jnp.asarray(vl), jnp.asarray(pn), jnp.asarray(pid), **j)


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
@pytest.mark.parametrize("lanes,a", [(7, 4), (8, 4), (12, 8), (16, 130)])
def test_uct_argmax_running_duplicated_parents(vl_mode, lanes, a):
    rng = np.random.default_rng(18 + lanes)
    rows = (np.arange(lanes) % 3).astype(np.int32)
    gn = rng.integers(0, 50, (3, a)).astype(np.float32)
    gw = (rng.normal(size=(3, a)) * 3).astype(np.float32)
    gv = rng.integers(0, 3, (3, a)).astype(np.float32)
    go = rng.integers(0, 4, (3, a)).astype(np.float32)
    n, w, vl, o = gn[rows], gw[rows], gv[rows], go[rows]
    pn = n.sum(-1) + vl.sum(-1) + o.sum(-1) + 1
    gvalid = rng.random((3, a)) < 0.7
    gvalid[:, 0] = True
    kw = dict(cp=1.4, valid=gvalid[rows], child_o=o, vl_mode=vl_mode)
    want = _jax_running(n, w, vl, pn, rows, **kw)
    np.testing.assert_array_equal(_port_running(n, w, vl, pn, rows, **kw),
                                  want)


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_uct_argmax_running_skips_finished_lanes(vl_mode):
    lanes, a = 8, 6
    z = np.zeros((lanes, a), np.float32)
    pn = np.ones((lanes,), np.float32)
    act = (np.arange(lanes) % 2) == 0
    rows = np.zeros((lanes,), np.int32)
    for valid in (np.broadcast_to(act[:, None], (lanes, a)).copy(),
                  np.zeros((lanes, a), bool)):
        kw = dict(cp=0.7, valid=valid, child_o=z, vl_mode=vl_mode)
        want = _jax_running(z, z, z, pn, rows, **kw)
        got = _port_running(z, z, z, pn, rows, **kw)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _port_running(z, z, z, pn, rows, cp=0.7, vl_mode=vl_mode, child_o=z,
                      valid=np.broadcast_to(act[:, None], (lanes, a))
                      .copy())[::2], [0, 1, 2, 3])


@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_uct_argmax_running_sentinel_rotates(vl_mode):
    a = 5
    gn = np.full((2, a), 7.0, np.float32)
    gn[0, [1, 3]] = 0.0
    gn[1, [0, 4]] = 0.0
    rows = np.asarray([0, 0, 1, 1], np.int32)
    n = gn[rows]
    w = np.random.default_rng(19).normal(size=(2, a)).astype(np.float32)[rows]
    z = np.zeros((4, a), np.float32)
    pn = n.sum(-1) + 1
    kw = dict(cp=1.4, valid=np.ones((4, a), bool), child_o=z,
              vl_mode=vl_mode)
    want = _jax_running(n, w, z, pn, rows, **kw)
    got = _port_running(n, w, z, pn, rows, **kw)
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [1, 3, 0, 4]


def test_uct_running_batched_rows_equal_per_root():
    """The port's running argmax takes a batch of roots ``[B, L, A]``; each
    root's walk equals the unbatched walk."""
    n, w, vl, o, valid = _board(3, 12, 5, parents=3)
    pid = (np.arange(12) % 3).astype(np.int32)
    pn = n.sum(-1) + 1
    kw = dict(cp=0.9, child_o=o, vl_mode="loss")
    single = _port_running(n, w, vl, pn, pid, valid=valid, **kw)
    stack = lambda x: np.stack([x, x[::-1].copy()])
    both = _port_running(stack(n), stack(w), stack(vl), stack(pn),
                         stack(pid), valid=stack(valid),
                         **{**kw, "child_o": stack(o)})
    np.testing.assert_array_equal(both[0], single)
    np.testing.assert_array_equal(
        both[1], _port_running(n[::-1].copy(), w[::-1].copy(),
                               vl[::-1].copy(), pn[::-1].copy(),
                               pid[::-1].copy(), valid=valid[::-1].copy(),
                               **{**kw, "child_o": o[::-1].copy()}))
