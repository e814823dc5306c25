"""On the card: the sharded, fault-tolerant and two-process search paths
and the serving mesh at a small size, equal to the CPU.

* ``shard_search_batch`` over an in-process mesh of three entries on
  ``cuda:0`` (B = 5, padded to 6) against ``search_batch`` on the CPU;
* ``ft_search_batch`` on ``cuda:0`` with a killed host against the same;
* two processes, started with ``spawn``, in one gloo group (NCCL refuses
  two ranks on one card), each driving ``cuda:0``, gathering through host
  copies;
* the mesh searcher (three entries on ``cuda:0``) against the unsharded
  searcher on the CPU, token for token.

Every test is marked ``cuda`` and skips without a card; the file imports
no JAX: ``python -m pytest -q -m cuda --noconftest
tests/test_torch_card_shard.py``.  Integers, decisions and tokens must be
equal; ``value`` within ``VALUE_RTOL`` (relative: PyTorch's own
scatter-adds on the card may sum in another order).
"""
import multiprocessing as mp

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.base import ModelConfig  # noqa: E402
from repro_torch.parallel import mesh_from_devices  # noqa: E402
from repro_torch.search import (FTSearchConfig, SearchConfig,  # noqa: E402
                                SearchParams, ft_search_batch, search_batch,
                                shard_search_batch)
from repro_torch.serving import (MCTSDecodeConfig,  # noqa: E402
                                 make_batched_searcher)

VALUE_RTOL = 1e-5
DOM = PGameDomain(num_actions=4, game_depth=6, binary_reward=False, seed=3)
RUNS = [("pipeline", "mega", "loss", "independent"),
        ("tree", "mega", "wu", "running")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda", 0)


def _cfg(method, ws, vl, la, keep_tree=True):
    return SearchConfig(method=method, budget=64, lanes=8,
                        keep_tree=keep_tree,
                        params=SearchParams(cp=0.7, max_depth=6,
                                            wave_select=ws, vl_mode=vl,
                                            level_assign=la))


def _same(got, want):
    for f in ("action_visits", "best_action"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for k in want.stats:
        assert torch.equal(got.stats[k].cpu(), want.stats[k]), k
    torch.testing.assert_close(got.action_value.cpu(), want.action_value,
                               rtol=VALUE_RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("run", RUNS, ids=["/".join(r) for r in RUNS])
def test_sharded_search_on_card_equals_cpu(run):
    dev = _card()
    cfg = _cfg(*run)
    want = search_batch([DOM] * 5, cfg, 3, device="cpu")
    got = shard_search_batch([DOM] * 5, cfg, 3,
                             mesh=mesh_from_devices([dev] * 3))
    assert got.action_visits.device == dev and got.tree.batch == 5
    _same(got, want)
    assert torch.equal(got.tree.visits.cpu(), want.tree.visits)


@pytest.mark.cuda
def test_ft_on_card_equals_cpu():
    _card()
    cfg = _cfg(*RUNS[0], keep_tree=False)
    want = search_batch([DOM] * 6, cfg, 5, device="cpu")
    got = ft_search_batch([DOM] * 6, cfg, 5, device="cuda:0",
                          ft=FTSearchConfig(hosts=3, chunk=1,
                                            kill_host_at_root=4,
                                            watchdog_s=5.0))
    assert got.action_visits.device.type == "cpu"
    _same(got, want)


def _worker(rank, init, q):
    from repro_torch.parallel import init_distributed, make_search_mesh
    init_distributed("gloo", init, 2, rank)
    res = shard_search_batch([DOM] * 5, _cfg(*RUNS[0], keep_tree=False), 3,
                             mesh=make_search_mesh(device="cuda:0"))
    q.put((rank, res.action_visits.cpu().numpy(),
           res.action_value.cpu().numpy()))
    import torch.distributed as dist
    dist.destroy_process_group()


@pytest.mark.cuda
def test_two_processes_on_one_card_equal_cpu(tmp_path):
    _card()
    from repro_torch.kernels import _build
    _build.build_all()                  # once, before the ranks start
    want = search_batch([DOM] * 5, _cfg(*RUNS[0], keep_tree=False), 3,
                        device="cpu")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, f"file://{tmp_path}/rdv", q))
             for r in (0, 1)]
    for p in procs:
        p.start()
    try:
        got = [q.get(timeout=300) for _ in procs]
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    for _, visits, value in got:
        np.testing.assert_array_equal(visits, want.action_visits.numpy())
        np.testing.assert_allclose(value, want.action_value.numpy(),
                                   rtol=VALUE_RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [{}, dict(kv_splice=True,
                                            tree_reuse=True)])
def test_mesh_searcher_on_card_equals_cpu(knobs):
    dev = _card()
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                      dtype="float32", ce_chunk=8, remat=False)
    params = TT.init(cfg, seed=0, device="cpu")
    dc = MCTSDecodeConfig(num_actions=3, budget=8, lanes=2, search_depth=3,
                          rollout_len=2, **knobs)
    buf = np.zeros((4, 10), np.int32)
    for i, p in enumerate([[1, 2, 3, 4], [9, 8], [5, 6, 7], [3]]):
        buf[i, :len(p)] = p
    lens = np.array([4, 2, 3, 1], np.int32)
    ts = make_batched_searcher(cfg, params, dc, 4,
                               mesh=mesh_from_devices([dev] * 3))
    cs = make_batched_searcher(cfg, params, dc, 4, device="cpu")
    carries = None
    if knobs:
        carries = [ts.init_carry(10), cs.init_carry(10)]
        for i in range(4):
            carries = [s.admit(c, i, buf[i], int(lens[i]))
                       for s, c in zip((ts, cs), carries)]
    for t in range(3):
        if knobs:
            (tt, carries[0]), (ct, carries[1]) = (
                s.step(buf, lens, t, c) for s, c in zip((ts, cs), carries))
        else:
            tt, ct = ts(buf, lens, t), cs(buf, lens, t)
        assert torch.equal(tt.cpu(), ct), t
        buf[np.arange(4), lens] = ct.numpy()
        lens = lens + 1
