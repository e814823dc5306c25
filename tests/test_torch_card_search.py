"""On the card: the search kernels (K2a ``uct_tiles_kernel``, K2b
``uct_running_kernel``, K1 ``sw_se_kernel`` / ``sw_bes_kernel`` /
``sw_b_kernel``) against their plain versions run on the CPU from the same
inputs.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX, so it runs on a machine that has none:
``python -m pytest -q -m cuda --noconftest tests/test_torch_card_search.py``.
Tolerance: none.  Decisions and integer planes must be equal, and the
float planes (``value``, ``prior``) bit-equal: the kernels add a node's
value contributions in lane order, the order of the plain version's
scatter-add on the CPU.

K2a boards are made with numpy from a seed: A 1-130, 1-4,096 rows, int32
and float32 count planes, finished rows and sentinel ties.  K2b boards are
made with numpy from a seed: every lane on one parent,
every parent distinct, and parents drawn from a few; finished lanes (all
columns invalid), rows whose every column scores the must-explore
sentinel, and rows of exact score ties.  K1 runs on P-game arenas
advanced by the plain pipeline: loss / wu, independent / running, with
and without PUCT, finished (terminal) lanes, and an Expand whose free list
and arena run out mid-wave.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import stages as S  # noqa: E402
from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.core.tree import init_tree  # noqa: E402
from repro_torch.kernels.search_wave import ops as W  # noqa: E402
from repro_torch.kernels.uct_select import ops as U  # noqa: E402
from repro_torch.search import SearchParams  # noqa: E402


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda", 0)


# ---------------------------------------------------------------------------
# K2b: the running-assignment walk
# ---------------------------------------------------------------------------
def _board(seed, b, lanes, a, kind, copies=False):
    """``[b, lanes, a]`` boards; lanes with one parent see one board's
    statistics, and with ``copies`` the same row altogether (valid mask,
    finished, sentinel and tie rows, parent count), as on the select
    path."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        pid = np.zeros((b, lanes), np.int32)
    elif kind == "distinct":
        pid = np.tile(np.arange(lanes, dtype=np.int32) * 7 - 3, (b, 1))
    else:
        pid = rng.integers(-2, max(2, lanes // 4),
                           (b, lanes)).astype(np.int32)
    rows = np.unique(pid, return_inverse=True)[1].reshape(b, lanes)
    np_ = rows.max() + 1
    take = lambda x: np.take_along_axis(x, rows[..., None], axis=1)
    n = take(rng.integers(0, 40, (b, np_, a)).astype(np.float32))
    w = take((rng.normal(size=(b, np_, a)) * 3).astype(np.float32))
    vl = take(rng.integers(0, 3, (b, np_, a)).astype(np.float32))
    o = take(rng.integers(0, 4, (b, np_, a)).astype(np.float32))
    pn = rng.integers(0, 300, (b, lanes)).astype(np.float32)
    valid = rng.random((b, lanes, a)) < 0.8
    valid[..., 0] = True
    valid[rng.random((b, lanes)) < 0.15] = False        # finished lanes
    fresh = rng.random((b, lanes)) < 0.2                 # every column
    n[fresh], vl[fresh], o[fresh] = 0.0, 0.0, 0.0        # the sentinel
    tie = rng.random((b, lanes)) < 0.2                   # exact ties
    for x in (n, w, vl, o):
        x[tie] = x[tie][:, :1]
    xs = [n, w, vl, o, pn, valid]
    if copies:          # every lane takes its parent's first lane's row
        first = np.stack([u[1][u[2]] for u in (
            np.unique(q, return_index=True, return_inverse=True)
            for q in pid)])
        xs = [np.take_along_axis(x, first.reshape(
            (b, lanes) + (1,) * (x.ndim - 2)), axis=1) for x in xs]
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in xs + [pid]]


def _running_both(dev, board, vl_mode):
    n, w, vl, o, pn, valid, pid = board
    kw = dict(cp=0.7, vl_weight=1.0, vl_mode=vl_mode)
    want = U.uct_argmax_running(n, w, vl, pn, pid, valid=valid, child_o=o,
                                **kw)
    c = [x.to(dev) for x in board]
    before = U.launches["uct_argmax_running"]
    got = U.uct_argmax_running(c[0], c[1], c[2], c[4], c[6], valid=c[5],
                               child_o=c[3], **kw)
    assert U.launches["uct_argmax_running"] == before + 1
    return got.cpu(), want


@pytest.mark.cuda
@pytest.mark.parametrize("vl_mode", ["loss", "wu"])
@pytest.mark.parametrize("a", [1, 4, 16, 33])
@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 64, 256])
def test_running_walk_equals_plain(lanes, a, vl_mode):
    dev = _card()
    for i, kind in enumerate(("one", "distinct", "few")):
        for copies in (False, True):
            board = _board(100 * lanes + 10 * a + i, 3, lanes, a, kind,
                           copies)
            got, want = _running_both(dev, board, vl_mode)
            assert torch.equal(got, want), (kind, copies, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("a,kind,copies", [(4, "one", True),
                                           (16, "few", False),
                                           (33, "distinct", False)])
def test_running_walk_at_the_most_lanes(a, kind, copies):
    """4,096 lanes, the most the wrapper takes: a board of this size does
    not fit in shared memory, so its later rows are read in place."""
    dev = _card()
    board = _board(7 + a, 1, 4096, a, kind, copies)
    got, want = _running_both(dev, board, "wu")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_running_walk_with_counts_in_device_scratch():
    """A so wide that one walker's running counts exceed shared memory:
    the wrapper hands the kernel device scratch for them."""
    dev = _card()
    board = _board(5, 2, 6, 70_000, "one")
    got, want = _running_both(dev, board, "loss")
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K2a: the independent argmax
# ---------------------------------------------------------------------------
def _tiles_board(seed, rows, a):
    """``[rows, a]`` int32 count planes (N, vl, O, n_p), float32 W and a
    valid mask, with finished rows (every column invalid) and rows whose
    every column scores the must-explore sentinel."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 40, (rows, a)).astype(np.int32)
    vl = rng.integers(0, 3, (rows, a)).astype(np.int32)
    o = rng.integers(0, 4, (rows, a)).astype(np.int32)
    w = (rng.normal(size=(rows, a)) * 3).astype(np.float32)
    pn = rng.integers(0, 300, rows).astype(np.int32)
    fresh = rng.random(rows) < 0.2
    n[fresh], vl[fresh], o[fresh] = 0, 0, 0
    valid = rng.random((rows, a)) < 0.8
    valid[rng.random(rows) < 0.15] = False
    return [torch.from_numpy(x) for x in (n, w, vl, o, pn, valid)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 4096])
@pytest.mark.parametrize("a", [1, 2, 16, 33, 130])
def test_tiles_argmax_equals_plain(rows, a):
    """K2a's picks equal its plain version's on the CPU, in both modes,
    with int32 and float32 count planes, and with ``child_o`` the same
    tensor as ``child_vl``; a finished row picks 0, a row of sentinel ties
    its lowest column."""
    dev = _card()
    n, w, vl, o, pn, valid = _tiles_board(rows * 1000 + a, rows, a)
    for counts in (torch.int32, torch.float32):
        c = [x.to(counts) for x in (n, vl, o, pn)]
        for mode in ("loss", "wu"):
            for infl in (c[2], c[1]):
                kw = dict(cp=0.7, vl_weight=1.0, vl_mode=mode)
                want = U.uct_argmax(c[0], w, c[1], c[3], valid=valid,
                                    child_o=infl, **kw)
                before = U.launches["uct_argmax_tiles"]
                got = U.uct_argmax(c[0].to(dev), w.to(dev), c[1].to(dev),
                                   c[3].to(dev), valid=valid.to(dev),
                                   child_o=infl.to(dev), **kw)
                assert U.launches["uct_argmax_tiles"] == before + 1
                assert torch.equal(got.cpu(), want), (counts, mode)
                assert (want[~valid.any(-1)] == 0).all()


@pytest.mark.cuda
def test_tiles_argmax_copies_no_int32_plane(monkeypatch):
    """On the arena's int32 planes the wrapper hands the kernel the
    tensors themselves: no float32 copy is made."""
    dev = _card()
    n, w, vl, o, pn, valid = (x.to(dev) for x in _tiles_board(3, 64, 16))
    seen = []
    real = U.launch_tiles

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)
    monkeypatch.setattr(U, "launch_tiles", spy)
    U.uct_argmax(n, w, vl, pn, cp=0.7, valid=valid, child_o=vl)
    (args,) = seen
    assert [t.data_ptr() for t in args[:5]] == [
        x.data_ptr() for x in (n, w, vl, pn, valid)]
    assert args[0].dtype == args[2].dtype == args[3].dtype == torch.int32


# ---------------------------------------------------------------------------
# K1: the fused search wave
# ---------------------------------------------------------------------------
MODES = [("loss", "independent", False), ("wu", "running", False),
         ("loss", "running", True), ("wu", "independent", True)]
INT_PLANES = ("visits", "vloss", "unobs", "parent", "action", "children",
              "terminal", "next_free", "free_list", "free_top")


def _copy(tree, dev):
    return type(tree)(**{f.name: (
        {k: v.to(dev, copy=True) for k, v in getattr(tree, f.name).items()}
        if f.name == "state" else getattr(tree, f.name).to(dev, copy=True))
        for f in dataclasses.fields(tree)})


def _same_tree(got, want, what):
    for f in INT_PLANES + ("value", "prior"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), \
            f"{what}: plane {f}"
    for k in want.state:
        assert torch.equal(got.state[k].cpu(), want.state[k]), \
            f"{what}: state {k}"


def _same_bufs(got, want, what):
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), f"{what}: {k}"


def _snapshot(lanes, a, depth, nodes, ticks, mode, seed, batch=2):
    """A mid-search arena and its in-flight buffers, advanced on the CPU by
    the plain pipeline."""
    vl_mode, assign, puct = mode
    dom = PGameDomain(num_actions=a, game_depth=depth, binary_reward=False,
                      seed=seed)
    sp = SearchParams(cp=0.7, max_depth=depth, vl_mode=vl_mode,
                      level_assign=assign, puct=puct, kernels="ref",
                      wave_select="mega")
    tree = init_tree(dom, nodes, batch=batch)
    se = S.empty_selection(sp, batch, lanes, "cpu")
    ep = S.empty_expansion(sp, tree, lanes)
    pb = S.empty_playout(sp, batch, lanes, a, "cpu")
    gen = torch.Generator().manual_seed(seed)
    draws = dom.sample_draws((batch, ticks, lanes), gen)
    for t in range(ticks):
        tree, se, ep, pb = W.pipeline_tick(tree, dom, sp, lanes, True, se,
                                           ep, pb, draws[:, t], impl="ref")
    return sp, tree, se, pb


def _wave_both(dev, sp, tree, se, pb, lanes, what, wave_valid=True):
    """se, bes and b by the kernels on the card and by their plain
    versions on the CPU, from copies of one snapshot."""
    sel = {k: v.to(dev) for k, v in se.items()}
    pbd = {k: v.to(dev) for k, v in pb.items()}
    n0 = dict(W.launches)
    t1, s1, e1 = W.se(_copy(tree, dev), sp, lanes, wave_valid, impl="cuda")
    t2, s2, e2 = W.se(_copy(tree, "cpu"), sp, lanes, wave_valid, impl="ref")
    _same_tree(t1, t2, f"se {what}")
    _same_bufs(s1, s2, f"se {what} sel")
    _same_bufs(e1, e2, f"se {what} es")
    t1, s1, e1 = W.bes(_copy(tree, dev), sp, lanes, wave_valid, sel, pbd,
                       impl="cuda")
    t2, s2, e2 = W.bes(_copy(tree, "cpu"), sp, lanes, wave_valid, se, pb,
                       impl="ref")
    _same_tree(t1, t2, f"bes {what}")
    _same_bufs(s1, s2, f"bes {what} sel")
    _same_bufs(e1, e2, f"bes {what} es")
    t1 = W.b(_copy(tree, dev), sp, pbd, impl="cuda")
    t2 = W.b(_copy(tree, "cpu"), sp, pb, impl="ref")
    _same_tree(t1, t2, f"b {what}")
    run = int(sp.running)
    assert {k: W.launches[k] - n0[k] for k in n0} == {
        "se": 1, "bes": 1, "b": 1, "se_running": run, "bes_running": run}
    return e2


@pytest.mark.cuda
@pytest.mark.parametrize("a", [1, 4, 16, 33])
@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 64, 256])
def test_search_wave_equals_plain(lanes, a):
    """Two of the four modes per (lanes, A), in turn, so that each mode
    meets every lane count and every A; game depth 4 (terminal leaves:
    finished lanes) and 6."""
    dev = _card()
    k = (lanes + a) % 4
    for mode in (MODES[k], MODES[(k + 2) % 4]):
        depth = 4 if lanes % 2 else 6
        sp, tree, se, pb = _snapshot(lanes, a, depth, 8 * lanes + 2, 5,
                                     mode, seed=lanes + a)
        _wave_both(dev, sp, tree, se, pb, lanes, f"{mode} L={lanes} A={a}")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_search_wave_at_the_most_lanes(mode):
    """1,024 lanes, the most the wrappers take, at A = 16."""
    dev = _card()
    sp, tree, se, pb = _snapshot(1024, 16, 5, 5 * 1024 + 2, 4, mode, seed=3,
                                 batch=1)
    _wave_both(dev, sp, tree, se, pb, 1024, f"{mode} L=1024")


@pytest.mark.cuda
def test_search_wave_invalid_wave():
    """A wave that is not valid selects nothing and expands nothing."""
    dev = _card()
    sp, tree, se, pb = _snapshot(32, 4, 5, 130, 4, MODES[1], seed=9)
    _wave_both(dev, sp, tree, se, pb, 32, "invalid wave", wave_valid=False)


def _cut(tree, n):
    """The same arena cut to its first ``n`` rows."""
    def cut(name, x):
        return x.clone() if name in ("next_free", "free_top") \
            else x[:, :n].clone()
    return type(tree)(**{f.name: (
        {k: v[:, :n].clone() for k, v in getattr(tree, f.name).items()}
        if f.name == "state" else cut(f.name, getattr(tree, f.name)))
        for f in dataclasses.fields(tree)})


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [MODES[0], MODES[1]])
def test_expand_free_list_runs_out_mid_wave(mode):
    """cap0 binds: two rows on the free list and three left to the bump
    (cap0 = 5) against more lanes that can expand, so the later lanes are
    cut while their `taken` and slot still come from the lanes before
    them."""
    dev = _card()
    lanes = 32
    sp, tree, se, pb = _snapshot(lanes, 16, 6, 400, 5, mode, seed=21,
                                 batch=1)
    _, _, es = W.bes(_copy(tree, "cpu"), sp, lanes, True, se, pb,
                     impl="ref")
    wanted = int(es["can"].sum())
    nf = int(tree.next_free[0])
    tree = _cut(tree, nf + 5)
    tree.free_list[0, :2] = torch.tensor([nf, nf + 1], dtype=torch.int32)
    tree.free_top.fill_(2)
    tree.next_free.fill_(nf + 2)
    es = _wave_both(dev, sp, tree, se, pb, lanes, f"{mode} cap0")
    assert wanted > 5 and int(es["can"].sum()) == 5
