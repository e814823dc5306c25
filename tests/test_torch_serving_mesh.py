"""Port parity of the serving mesh path: ``repro_torch.serving``'s
``MeshSearcher`` (``make_batched_searcher(..., mesh=)``), the sharded
``mcts_decode_batch`` and the engine with ``EngineConfig.mesh``, on an
in-process mesh of three CPU entries.

Four slots are padded to six; the two pad rows ride along as dead slots
(length 0, never admitted).  The JAX package's searcher at batch 6 with
``mesh=False``, on the same buffers with two zero rows appended and the
same four slots admitted, emits the port's tokens for the first four
slots, token for token over six tokens, stateless and with both carries
(the tiny dense float32 config; weights from the JAX ``init``).  The
engine with a mesh drains to the JAX engine's tokens and counts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving import MCTSDecodeConfig as JDC  # noqa: E402
from repro.serving import make_batched_searcher as jsearcher  # noqa: E402
from repro.serving import mcts_decode_batch as jdecode  # noqa: E402
from repro import serving as JS  # noqa: E402
from repro_torch import serving as TS  # noqa: E402
from repro_torch.parallel import mesh_from_devices  # noqa: E402
from repro_torch.serving import (MCTSDecodeConfig,  # noqa: E402
                                 MeshSearcher, make_batched_searcher,
                                 mcts_decode_batch)
from test_torch_engine import DCFG, pair, submit, summary  # noqa: E402,F401
from test_torch_lm_decode import JCFG, TCFG, params  # noqa: E402,F401

jax.config.update("jax_default_matmul_precision", "highest")

KNOBS = {"stateless": {}, "both": dict(kv_splice=True, tree_reuse=True)}
PROMPTS = [[1, 2, 3, 4], [9, 8], [5, 6, 7], [3]]
N_NEW = 6


def dkw(**kw):
    return dict(method="pipeline", num_actions=3, budget=8, lanes=2,
                search_depth=3, rollout_len=2, wave_select="scan", **kw)


def mesh3():
    return mesh_from_devices(["cpu"] * 3)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_mesh_searcher_matches_jax_on_the_padded_batch(params, knobs):
    jp, tp = params
    kw = dkw(**KNOBS[knobs])
    buf = np.zeros((6, 4 + N_NEW), np.int32)
    for i, p in enumerate(PROMPTS):
        buf[i, :len(p)] = p
    lens = np.array([len(p) for p in PROMPTS] + [0, 0], np.int32)
    js = jsearcher(JCFG, jp, JDC(**kw), batch=6, mesh=False)
    ts = make_batched_searcher(TCFG, tp, MCTSDecodeConfig(**kw), 4,
                               mesh=mesh3())
    assert isinstance(ts, MeshSearcher)
    assert (ts.padded, ts.blk, sorted(ts.parts)) == (6, 2, [0, 1, 2])
    jc = tc = None
    if KNOBS[knobs]:
        jc, tc = js.init_carry(buf.shape[1]), ts.init_carry(buf.shape[1])
        for i in range(4):
            jc = js.admit(jc, i, buf[i], int(lens[i]))
            tc = ts.admit(tc, i, buf[i], int(lens[i]))
        # the pad rows' carry stays dead: entry 2 holds slot 4 and 5
        assert not bool(tc[2]["alive"].any())
        assert not bool(tc[2]["logits"][1].any())
    jb, jl = buf.copy(), lens.copy()
    tb, tl = buf[:4].copy(), lens[:4].copy()
    for t in range(N_NEW):
        if KNOBS[knobs]:
            jt, jc = js.step(jb, jl, jax.random.key(t), jc)
            tt, tc = ts.step(tb, tl, t, tc)
        else:
            jt, tt = js(jb, jl, jax.random.key(t)), ts(tb, tl, t)
        jt = np.asarray(jt)[:4]
        assert tt.shape == (4,) and tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), jt, err_msg=f"token {t}")
        for i in range(4):
            jb[i, jl[i]], tb[i, tl[i]] = jt[i], jt[i]
            jl[i] += 1
            tl[i] += 1


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_sharded_decode_batch_equals_unsharded(params, knobs):
    """``mcts_decode_batch(mesh=)`` emits the unsharded port's tokens,
    which are the JAX package's."""
    jp, tp = params
    kw = dkw(**KNOBS[knobs])
    got = mcts_decode_batch(TCFG, tp, PROMPTS, 3, MCTSDecodeConfig(**kw),
                            seed=2, mesh=mesh3())
    one = mcts_decode_batch(TCFG, tp, PROMPTS, 3, MCTSDecodeConfig(**kw),
                            seed=2, device="cpu")
    assert got == one == jdecode(JCFG, jp, PROMPTS, 3, JDC(**kw), seed=2)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_engine_with_a_mesh_drains_like_jax(pair, knobs):
    (jc, jp), (tc, tp) = pair
    m = {**DCFG, **KNOBS[knobs]}
    je = JS.ServingEngine(jc, jp, JS.EngineConfig(
        max_batch=4, max_seq=16, decode="mcts",
        mcts=JS.MCTSDecodeConfig(**m), mesh=False))
    te = TS.ServingEngine(tc, tp, TS.EngineConfig(
        max_batch=4, max_seq=16, decode="mcts",
        mcts=TS.MCTSDecodeConfig(**m), mesh=mesh3()))
    assert te.device == torch.device("cpu")
    assert isinstance(te._mcts_search, MeshSearcher)
    specs = [(0, [1, 2, 3], 3), (1, [4, 5], 4), (2, [7], 2), (3, [2, 9], 3),
             (4, [6, 1, 1], 2)]
    submit(je, JS, specs)
    submit(te, TS, specs)
    assert summary(te, te.run_until_drained()) == \
        summary(je, je.run_until_drained())
