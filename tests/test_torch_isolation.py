"""Guards of the PyTorch port: it stands alone, it never falls back to the
CPU on its own, and its kernels hold against their plain versions on a card.

Tests marked ``cuda`` need an NVIDIA GPU (sm_90a) and the CUDA toolkit;
they decide inside the test whether a card is present and skip otherwise,
so every worker collects the same tests.  On a card (where JAX need not
be installed, so the repository's ``conftest.py`` is skipped), run them
with ``python -m pytest -q -m cuda --noconftest tests/test_torch_isolation.py``.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.kernels.uct_select import ops as uops  # noqa: E402
from repro_torch.search import (SearchConfig, SearchParams,  # noqa: E402
                                search, search_batch)

ROOT = Path(__file__).resolve().parents[1]
DOM = PGameDomain(num_actions=4, game_depth=5, binary_reward=False)


def test_port_imports_without_jax_or_repro():
    """Every module of ``repro_torch`` imports in a process where ``jax``
    and ``repro`` cannot be imported."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[m] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_search_without_device_raises_when_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search(DOM, SearchConfig(budget=8), 0)
    with pytest.raises(RuntimeError):
        search_batch([DOM, DOM], SearchConfig(budget=8), 0)
    res = search(DOM, SearchConfig(budget=8), 0, device="cpu")
    assert res.action_visits.device.type == "cpu"


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-1.6b",
                                  "zamba2-1.2b", "deepseek-v2-lite-16b",
                                  "grok-1-314b", "internvl2-2b"])
def test_model_init_and_engine_without_device_raise_when_no_cuda(
        arch, monkeypatch):
    """A family's ``init`` / ``init_cache`` and the serving engine run on
    ``cuda:0`` by default, as ``search`` does: without a card they raise
    unless asked for the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.base import get_family
    from repro_torch.serving import (EngineConfig, MCTSDecodeConfig,
                                     ServingEngine)
    cfg = get_smoke_config(arch)
    fam = get_family(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fam.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fam.init_cache(cfg, 1, 8)
    params = fam.init(cfg, seed=0, device="cpu")
    assert {t.device.type for t in _leaves(params)} == {"cpu"}
    for mode in ("greedy", "mcts"):
        ecfg = EngineConfig(max_batch=1, max_seq=8, decode=mode,
                            mcts=MCTSDecodeConfig(budget=4, lanes=2))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(cfg, params, ecfg)
        assert ServingEngine(cfg, params, ecfg, device="cpu").mode == mode


def test_reusable_searcher_without_device_raises_when_no_cuda(monkeypatch):
    """The cross-token searcher resolves its device as the stateless one
    does: ``cuda:0``, a raise without a card, the CPU only when asked; its
    carry lives on that device."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.base import get_family
    from repro_torch.serving import (MCTSDecodeConfig, ReusableSearcher,
                                     make_batched_searcher)
    cfg = get_smoke_config("smollm-135m")
    params = get_family(cfg).init(cfg, seed=0, device="cpu")
    dcfg = MCTSDecodeConfig(budget=4, lanes=2, kv_splice=True,
                            tree_reuse=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_batched_searcher(cfg, params, dcfg, 2)
    s = make_batched_searcher(cfg, params, dcfg, 2, device="cpu")
    assert isinstance(s, ReusableSearcher)
    carry = s.admit(s.init_carry(4), 0, np.array([1, 2, 0, 0]), 2)
    assert {v.device.type for v in carry["cache"].values()} == {"cpu"}
    assert carry["alive"].device.type == "cpu"


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_cuda_request_with_cpu_tensors_raises():
    n = torch.ones(3, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        uops.uct_argmax(n, n, n, n.sum(-1), cp=1.0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        uops.uct_argmax_running(n, n, n, n.sum(-1),
                                torch.zeros(3, dtype=torch.int32), cp=1.0,
                                impl="cuda")
    for ws in ("mega", "lockstep", "scan"):
        cfg = SearchConfig(method="pipeline", budget=8, lanes=2,
                           kernels="cuda", wave_select=ws)
        with pytest.raises(ValueError, match="CUDA tensors"):
            search(DOM, cfg, 0, device="cpu")
    before = dict(uops.launches)
    uops.uct_argmax(n, n, n, n.sum(-1), cp=1.0)     # CPU: the plain version
    assert uops.launches == before


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """``chip_smoke.py`` in a directory with nothing else of the repository
    exits non-zero and prints no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version at small shapes
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_uct_kernels_match_plain_on_card(vl_mode):
    dev = _card()
    rng = np.random.default_rng(0)
    b, lanes, a = 3, 8, 6
    n = torch.from_numpy(rng.integers(0, 9, (b, lanes, a))).float().to(dev)
    w = torch.from_numpy(rng.normal(size=(b, lanes, a))).float().to(dev)
    v = torch.from_numpy(rng.integers(0, 3, (b, lanes, a))).float().to(dev)
    valid = torch.from_numpy(rng.random((b, lanes, a)) < 0.8).to(dev)
    pid = torch.from_numpy(rng.integers(0, 3, (b, lanes))).int().to(dev)
    pn = n.sum(-1) + 1
    kw = dict(cp=1.1, valid=valid, child_o=v, vl_mode=vl_mode)
    for fn, args in ((uops.uct_argmax, (n, w, v, pn)),
                     (uops.uct_argmax_running, (n, w, v, pn, pid))):
        got = fn(*args, impl="cuda", **kw)
        want = fn(*args, impl="ref", **kw)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("method,wave_select,vl_mode,level_assign", [
    ("pipeline", "mega", "loss", "independent"),
    ("pipeline", "mega", "wu", "running"),
    ("tree", "mega", "loss", "running"),
    ("pipeline", "lockstep", "wu", "running"),
    ("tree", "scan", "loss", "independent")])
def test_search_batch_on_card_equals_cpu(method, wave_select, vl_mode,
                                         level_assign):
    dev = _card()
    cfg = SearchConfig(method=method, budget=32, lanes=4,
                       params=SearchParams(cp=0.7, max_depth=5,
                                           wave_select=wave_select,
                                           vl_mode=vl_mode,
                                           level_assign=level_assign))
    g = search_batch([DOM] * 3, cfg, 5, device=dev)
    c = search_batch([DOM] * 3, cfg, 5, device="cpu")
    assert torch.equal(g.action_visits.cpu(), c.action_visits)
    for f in dataclasses.fields(c.tree):
        if f.name not in ("state", "value", "prior"):
            assert torch.equal(getattr(g.tree, f.name).cpu(),
                               getattr(c.tree, f.name)), f.name
    torch.testing.assert_close(g.tree.value.cpu(), c.tree.value,
                               rtol=1e-6, atol=1e-5)


def _copy_to(tree, dev):
    return dataclasses.replace(
        tree, **{f.name: ({k: v.to(dev, copy=True)
                           for k, v in tree.state.items()}
                          if f.name == "state" else
                          getattr(tree, f.name).to(dev, copy=True))
                 for f in dataclasses.fields(tree)})


@pytest.mark.cuda
@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
def test_free_list_pops_and_full_arena_on_card(vl_mode):
    """The kernels pop parked free-list rows before the bump and stop
    expanding in a full arena exactly as the plain version does."""
    from repro_torch.core.tree import init_tree
    from repro_torch.kernels.search_wave import ops as wops
    dev = _card()
    sp = SearchParams(cp=0.7, max_depth=5, vl_mode=vl_mode,
                      level_assign="running", wave_select="mega")
    gen = torch.Generator().manual_seed(0)
    tree = init_tree(DOM, 24)
    for _ in range(2):
        tree, _ = wops.tree_round(tree, DOM, sp, 4, True,
                                  DOM.sample_draws((1, 4), gen))
    nf = int(tree.next_free[0])
    tree.free_list[0, :3] = torch.tensor([nf + 2, nf, nf + 1])
    tree.free_top.fill_(3)
    tree.next_free.fill_(nf + 3)
    kern, plain = _copy_to(tree, dev), _copy_to(tree, dev)
    for _ in range(5):
        draws = DOM.sample_draws((1, 4), gen).to(dev)
        kern, ks = wops.tree_round(kern, DOM, sp, 4, True, draws)
        plain, ps = wops.tree_round(plain, DOM, sp, 4, True, draws,
                                    impl="ref")
        for f in dataclasses.fields(kern):
            if f.name not in ("state", "value", "prior"):
                assert torch.equal(getattr(kern, f.name),
                                   getattr(plain, f.name)), f.name
        assert torch.equal(ks["path"], ps["path"])
    assert int(kern.free_top[0]) == 0 and int(kern.next_free[0]) == 24


@pytest.mark.cuda
@pytest.mark.parametrize("method,wave_select,vl_mode,level_assign", [
    ("pipeline", "mega", "wu", "running"),
    ("tree", "mega", "loss", "independent"),
    ("pipeline", "lockstep", "loss", "running")])
def test_wide_waves_on_card_equal_cpu(method, wave_select, vl_mode,
                                      level_assign):
    """More than a warp of lanes and of children, terminal leaves within
    max_depth, and an arena that fills up mid-search."""
    dev = _card()
    dom = PGameDomain(num_actions=40, game_depth=4, binary_reward=False)
    cfg = SearchConfig(method=method, budget=200, lanes=40, max_nodes=90,
                       params=SearchParams(cp=0.7, max_depth=6,
                                           wave_select=wave_select,
                                           vl_mode=vl_mode,
                                           level_assign=level_assign))
    g = search_batch([dom] * 2, cfg, 3, device=dev)
    c = search_batch([dom] * 2, cfg, 3, device="cpu")
    assert torch.equal(g.action_visits.cpu(), c.action_visits)
    assert torch.equal(g.tree.children.cpu(), c.tree.children)
    assert torch.equal(g.tree.visits.cpu(), c.tree.visits)
    assert int(c.tree.next_free.min()) == 90


def test_whisper_init_and_cache_without_device_raise_when_no_cuda(
        monkeypatch):
    """Whisper (no engine: its prefill takes frames) resolves its device
    as every family does."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import whisper
    cfg = get_smoke_config("whisper-base")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        whisper.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        whisper.init_cache(cfg, 1, 8)
    params = whisper.init(cfg, seed=0, device="cpu")
    assert {t.device.type for t in _leaves(params)} == {"cpu"}
    cache = whisper.init_cache(cfg, 1, 8, device="cpu")
    assert {t.device.type for t in cache.values()} == {"cpu"}
