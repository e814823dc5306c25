"""The port's copies of the request scheduler and the serving stats
(``repro_torch.serving.scheduler`` / ``.stats``) against the JAX
package's: every test of ``tests/test_scheduler.py`` runs again with the
port's classes in place of the JAX package's, and random operation
sequences drive both schedulers side by side to the same events.
"""
import inspect

import numpy as np
import pytest

import test_scheduler as J
from repro.serving import scheduler as js
from repro_torch.serving import scheduler as ts
from repro_torch.serving import stats as tst

NAMES = ("POLICIES", "Admit", "Evict", "Request", "RequestScheduler",
         "RequestTiming", "Series", "ServingStats", "percentile")
CASES = [(name, kw) for name, fn in sorted(vars(J).items())
         if name.startswith("test_") and callable(fn)
         for kw in ([{"policy": p} for p in ts.POLICIES]
                    if "policy" in inspect.signature(fn).parameters
                    else [{}])]


@pytest.mark.parametrize("name,kw", CASES,
                         ids=[f"{n}{kw.get('policy', '')}" for n, kw in CASES])
def test_port_passes_the_jax_scheduler_suite(name, kw, monkeypatch):
    for n in NAMES:
        port = getattr(ts, n) if hasattr(ts, n) else getattr(tst, n)
        monkeypatch.setattr(J, n, port)
    getattr(J, name)(**kw)


def _events(evs):
    return [(type(e).__name__, e.slot, e.req.uid) for e in evs]


@pytest.mark.parametrize("policy", ["fcfs", "spf"])
@pytest.mark.parametrize("seed", range(4))
def test_random_operation_sequences_give_the_same_events(policy, seed):
    """Submissions of random priorities and lengths, tokens, retirements,
    evictions and disabled slots, applied to both schedulers: the same
    events, budgets and live slots after every operation."""
    rng = np.random.default_rng(seed)
    n_slots = 3
    scheds = [m.RequestScheduler(n_slots, policy=policy) for m in (js, ts)]
    uid = 0
    for _ in range(60):
        op = rng.integers(0, 5)
        slot = int(rng.integers(0, n_slots))
        outs = [None, None]
        if op == 0:
            plen = int(rng.integers(1, 6))
            pri = int(rng.integers(0, 3))
            for s, m in zip(scheds, (js, ts)):
                s.submit(m.Request(uid=uid, prompt=np.arange(plen,
                                                             dtype=np.int32),
                                   max_new_tokens=1 + uid % 4, priority=pri))
            uid += 1
        elif op == 1:
            for s in scheds:
                if s.is_live(slot):
                    s.request(slot).out_tokens.append(1)
                    s.on_token(slot)
                    if s.exhausted(slot):
                        s.retire(slot)
        elif op == 2:
            outs = [s.evict(slot) for s in scheds]
            outs = [None if e is None else _events([e]) for e in outs]
        elif op == 3 and scheds[0].num_enabled() > 1:
            for s in scheds:
                s.disable([slot])
        got = [_events(s.schedule()) for s in scheds]
        assert got[0] == got[1]
        assert outs[0] == outs[1]
        assert scheds[0].live() == scheds[1].live()
        assert scheds[0].remaining.tolist() == scheds[1].remaining.tolist()
        assert scheds[0].pending() == scheds[1].pending()
