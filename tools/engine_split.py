#!/usr/bin/env python3
"""How the engine parity tests' time splits between the JAX package and
the port: the zamba2 cases of ``tests/test_torch_engine_recurrent.py``
(mcts) and ``tests/test_torch_engine_carry.py`` (mcts with both carries),
timed part by part on the CPU, in one process.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/engine_split.py

Prints one JSON line a case: seconds of the JAX ``init`` eager (the
first in the process, then again) and jitted, of the JAX engine draining
the test's requests (tracing and compiling included) and of the port's
engine on the CPU.  The requests, configs and weights are the tests'
own.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import test_torch_engine_carry as C
    import test_torch_engine_recurrent as R
    from repro import serving as JS
    from repro.configs import get_smoke_config as jsmoke
    from repro.models.base import get_family
    from repro_torch import serving as TS
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from torch_parity import jax_init
    arch = "zamba2-1.2b"
    jc, tc = jsmoke(arch), get_smoke_config(arch)
    init = lambda: jax.block_until_ready(  # noqa: E731
        get_family(jc).init(jc, jax.random.key(0)))
    _, eager_first = timed(init)
    _, eager_again = timed(init)
    jp, jitted = timed(lambda: jax_init(jc))
    tp = params_from_numpy(jp)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)

    def recurrent(mod, eng):
        return R._drain(eng, mod, R.SPECS)

    def carry(mod, eng):
        C.submit(eng, mod, [(0, [3, 1, 4, 1, 5], 3, 0), (1, [9, 2], 2, 0),
                            (2, [6, 5, 3, 5], 2, 0)])
        eng.step()
        C.submit(eng, mod, [(3, [2, 7], 2, 5)])
        return C.summary(eng, eng.run_until_drained())

    cases = (("engine_recurrent mcts", R.DCFG, recurrent),
             ("engine_carry mcts both carries",
              dict(num_actions=3, budget=6, lanes=2, search_depth=2,
                   rollout_len=2, **C.CARRIES["both"]), carry))
    for name, dcfg, drive in cases:
        kw = dict(max_batch=2, max_seq=16, decode="mcts")
        je = JS.ServingEngine(jc, jp, JS.EngineConfig(
            mcts=JS.MCTSDecodeConfig(**dcfg), **kw))
        te = TS.ServingEngine(tc, tp, TS.EngineConfig(
            mcts=TS.MCTSDecodeConfig(**dcfg), **kw), device="cpu")
        want, jax_s = timed(lambda: drive(JS, je))
        got, port_s = timed(lambda: drive(TS, te))
        print(json.dumps({
            "case": f"{arch} {name}", "equal": got == want,
            "jax_init_eager_first_s": round(eager_first, 2),
            "jax_init_eager_again_s": round(eager_again, 2),
            "jax_init_jitted_s": round(jitted, 2),
            "jax_engine_s": round(jax_s, 2),
            "port_engine_s": round(port_s, 2)}), flush=True)
        if got != want:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
