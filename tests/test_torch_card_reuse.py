"""On the card: the cross-token carry.  K1 (``sw_se_kernel`` /
``sw_bes_kernel`` / ``sw_b_kernel``) on rerooted arenas, which start from
``next_free > 1`` with an empty free-list, and on arenas that fill up
mid-search, against the plain versions run on the CPU from the same
snapshot; the arena's ``release`` / ``compact`` / ``reroot`` and the
warm-start splice on the card with no host round trip, equal to the CPU's;
and the reuse searcher on the card equal to the CPU at smoke size.

Every test here is marked ``cuda`` and skips without a card; the file
imports no JAX:
``python -m pytest -q -m cuda --noconftest tests/test_torch_card_reuse.py``.
Tolerance: none.  Decisions, tokens and integer planes must be equal, and
the float planes bit-equal (the kernels add in the plain version's
order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import arena as TA  # noqa: E402
from repro_torch.core import stages as S  # noqa: E402
from repro_torch.core.domains.pgame import PGameDomain  # noqa: E402
from repro_torch.core.tree import (init_tree,  # noqa: E402
                                   root_action_by_visits)
from repro_torch.kernels.search_wave import ops as W  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.base import ModelConfig  # noqa: E402
from repro_torch.search import SearchParams  # noqa: E402
from repro_torch.serving import (MCTSDecodeConfig,  # noqa: E402
                                 make_batched_searcher, mcts_decode_batch)

CFG = ModelConfig(name="t", family="dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                  dtype="float32", ce_chunk=8, remat=False)
MODES = [("loss", "independent"), ("wu", "running")]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda", 0)


def _to(tree, dev):
    to = lambda x: x.to(dev, copy=True)
    return dataclasses.replace(tree, state={
        k: to(v) for k, v in tree.state.items()}, **{
        f.name: to(getattr(tree, f.name)) for f in dataclasses.fields(tree)
        if f.name != "state"})


def _same(got, want, what):
    for f in dataclasses.fields(want):
        if f.name == "state":
            for k in want.state:
                assert torch.equal(got.state[k].cpu(), want.state[k]), \
                    f"{what}: state {k}"
        else:
            assert torch.equal(getattr(got, f.name).cpu(),
                               getattr(want, f.name)), f"{what}: {f.name}"


def _warm(mode, nodes, a=6, lanes=8, batch=3, seed=0):
    """A P-game arena searched by the plain pipeline on the CPU, then
    rerooted on each root's most visited child."""
    vl, assign = mode
    dom = PGameDomain(num_actions=a, game_depth=6, binary_reward=False,
                      seed=seed)
    sp = SearchParams(cp=0.7, max_depth=6, vl_mode=vl, level_assign=assign,
                      kernels="ref", wave_select="mega")
    tree = init_tree(dom, nodes, batch=batch)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(4):
        tree, _ = W.tree_round(tree, dom, sp, lanes, True,
                               dom.sample_draws((batch, lanes), gen))
    return dom, sp, TA.reroot(tree, root_action_by_visits(tree)), gen


def _buf_to(buf, dev):
    return {k: _buf_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in buf.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nodes", [80, 40])
def test_search_wave_on_rerooted_arenas_equals_plain(mode, nodes):
    """Rounds of se / b (tree) and ticks of bes (pipeline) from a rerooted
    arena: the kernels start at ``next_free > 1``, and at 40 rows the
    arena fills up mid-search and the Expand stops, as the plain one."""
    dev = _card()
    dom, sp, tree, gen = _warm(mode, nodes)
    assert int(tree.next_free.min()) > 1
    lanes, b = 8, tree.batch
    kern, plain = _to(tree, dev), _to(tree, "cpu")
    for r in range(6):
        draws = dom.sample_draws((b, lanes), gen)
        kern, ks = W.tree_round(kern, dom, sp, lanes, True, draws.to(dev),
                                impl="cuda")
        plain, ps = W.tree_round(plain, dom, sp, lanes, True, draws,
                                 impl="ref")
        _same(kern, plain, f"tree round {r}")
        assert torch.equal(ks["path"].cpu(), ps["path"])
    if nodes == 40:
        assert bool((plain.next_free == nodes).all())
    se = S.empty_selection(sp, b, lanes, "cpu")
    ep = S.empty_expansion(sp, tree, lanes)
    pb = S.empty_playout(sp, b, lanes, dom.num_actions, "cpu")
    kern, plain = _to(tree, dev), _to(tree, "cpu")
    pbufs = [se, ep, pb]
    kb = [_buf_to(x, dev) for x in pbufs]
    for t in range(6):
        draws = dom.sample_draws((b, lanes), gen)
        kern, *kb = W.pipeline_tick(kern, dom, sp, lanes, t < 4, *kb,
                                    draws.to(dev), impl="cuda")
        plain, *pbufs = W.pipeline_tick(plain, dom, sp, lanes, t < 4,
                                        *pbufs, draws, impl="ref")
        _same(kern, plain, f"pipeline tick {t}")


@pytest.mark.cuda
def test_arena_serving_ops_on_card_equal_cpu_without_sync():
    """release / compact / reroot and the carried-arena splice run on the
    card without reading a value back, and give the CPU's planes."""
    dev = _card()
    dom, _, tree, _ = _warm(MODES[0], 80, seed=3)
    rows = torch.tensor([[1, 2], [3, 0], [2, 1]], dtype=torch.int32)
    mask = torch.tensor([[True, False], [True, False], [False, False]])
    keep = TA.live_mask(tree) & (torch.arange(80) % 3 != 1)
    act = torch.tensor([0, 1, 2])
    nr = torch.tensor([0, 2, 1])
    alive = torch.tensor([True, False, True])
    root = {k: v.expand((3,) + v.shape).to(dev)
            for k, v in dom.root_state().items()}
    g, dv = _to(tree, dev), [x.to(dev) for x in (rows, mask, keep, nr, act,
                                                  alive)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")      # raises on a host sync
    try:
        out = (TA.release(g, dv[0], dv[1]), TA.compact(g, dv[2], dv[3]),
               TA.reroot(g, dv[4]), TA.reroot_ok(g, dv[4]))
        spliced = init_tree(_Carried(dom, g, dv[5]), 80, root_state=root)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = (TA.release(tree, rows, mask),
            TA.compact(tree, keep, nr),
            TA.reroot(tree, act))
    for got, w, what in zip(out, want, ("release", "compact", "reroot")):
        _same(got, w, what)
    assert torch.equal(out[3].cpu(), TA.reroot_ok(tree, act))
    cold = init_tree(dom, 80, batch=3)
    assert spliced.device == dev
    for f in ("visits", "children", "next_free", "parent"):
        got = getattr(spliced, f).cpu()
        assert torch.equal(got[0], getattr(tree, f)[0])
        assert torch.equal(got[1], getattr(cold, f)[1])


class _Carried:
    """A P-game domain carrying an arena (the P-game dataclass has no
    hook fields; ``init_tree`` reads them with ``getattr``)."""

    def __init__(self, dom, arena, alive):
        self._dom, self.root_arena, self.root_arena_alive = dom, arena, alive
        self.num_actions = dom.num_actions

    def root_state(self):
        return self._dom.root_state()

    def is_terminal(self, state):
        return self._dom.is_terminal(state)


@pytest.mark.cuda
@pytest.mark.parametrize("wave_select", ["mega", "lockstep"])
def test_reuse_decode_on_card_equals_cpu(wave_select):
    """Both carries on: the card's tokens and carried integer planes are
    the CPU's, token by token."""
    dev = _card()
    params = TT.init(CFG, seed=0, device="cpu")
    dcfg = MCTSDecodeConfig(method="pipeline", num_actions=3, budget=9,
                            lanes=3, search_depth=2, rollout_len=2,
                            wave_select=wave_select, kv_splice=True,
                            tree_reuse=True)
    prompts = ([1, 2, 3, 4, 5], [7, 8])
    assert mcts_decode_batch(CFG, params, prompts, 4, dcfg, device=dev) \
        == mcts_decode_batch(CFG, params, prompts, 4, dcfg, device="cpu")
    buf = np.zeros((2, 9), np.int32)
    buf[0, :5], buf[1, :2] = prompts
    lens = np.array([5, 2], np.int32)
    sides = []
    for device in (dev, "cpu"):
        s = make_batched_searcher(CFG, params, dcfg, 2, device=device)
        c = s.init_carry(9)
        for i in range(2):
            c = s.admit(c, i, buf[i], int(lens[i]))
        b, ln, trace = buf.copy(), lens.copy(), []
        for t in range(3):
            toks, c = s.step(b, ln, t, c)
            trace.append((toks.cpu(), {f: getattr(c["arena"], f).cpu()
                                       for f in ("visits", "children",
                                                 "parent", "next_free")}))
            b[np.arange(2), ln] = toks.cpu().numpy()
            ln = ln + 1
        sides.append(trace)
    for (tk, pk), (tc, pc) in zip(*sides):
        assert torch.equal(tk, tc)
        for f in pk:
            assert torch.equal(pk[f], pc[f]), f
