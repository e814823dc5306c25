"""Port parity of the LM-decode domains:
``repro_torch.core.domains.lm_decode`` against ``repro.core.domains.
lm_decode`` on the CPU (float32; weights from the JAX ``init``).

Domain methods compare within 1e-5 (logits, values, priors) and exactly
(tokens, lengths).  Searches over these domains are in
``test_torch_lm_search.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.domains import lm_decode as JD  # noqa: E402
from repro.models.base import ModelConfig as JMC  # noqa: E402
from repro.models.base import get_family  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.domains import lm_decode as TD  # noqa: E402
from repro_torch.models.base import ModelConfig as TMC  # noqa: E402
from repro_torch.search import check_domain  # noqa: E402
from torch_parity import jax_init  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")

TOL = dict(atol=1e-5, rtol=1e-5)
CFG_KW = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
              ce_chunk=8, remat=False)
JCFG, TCFG = JMC(**CFG_KW), TMC(**CFG_KW)
PROMPT = np.array([1, 2, 3, 4], np.int32)
DOM_KW = dict(num_actions=3, search_depth=2, rollout_len=2)


@pytest.fixture(scope="module")
def params():
    jp = jax_init(JCFG)
    return jax.tree_util.tree_map(jnp.asarray, jp), params_from_numpy(jp)


def _domains(params, cached, **kw):
    jp, tp = params
    jcls = JD.CachedLMDecodeDomain if cached else JD.LMDecodeDomain
    tcls = TD.CachedLMDecodeDomain if cached else TD.LMDecodeDomain
    kw = {**DOM_KW, **kw}
    return (jcls(cfg=JCFG, params=jp, prompt=jnp.asarray(PROMPT), **kw),
            tcls(cfg=TCFG, params=tp, prompt=torch.from_numpy(PROMPT), **kw))


def _batched(state):
    return {k: v[None] for k, v in state.items()}


@pytest.mark.parametrize("cached", [True, False])
def test_domain_methods_match_jax(params, cached):
    jd, td = _domains(params, cached)
    assert check_domain(td)
    assert td.draw_shape == (0,)
    js, ts = jd.root_state(), _batched(td.root_state())
    assert int(ts["len"][0]) == int(js["len"]) == 4
    assert int(ts["plen"][0]) == 4
    if cached:
        np.testing.assert_allclose(ts["logits"][0].numpy(),
                                   np.asarray(js["logits"]), **TOL)
        np.testing.assert_allclose(ts["k"][0][:, :4].numpy(),
                                   np.asarray(js["cache"]["k"])[:, :4], **TOL)
    else:
        np.testing.assert_array_equal(ts["toks"][0].numpy(),
                                      np.asarray(js["toks"]))
    np.testing.assert_allclose(td.priors(ts)[0].numpy(),
                               np.asarray(jd.priors(js)), **TOL)
    draws = td.sample_draws((1,))
    before = {k: v.clone() for k, v in ts.items()}
    for a in range(3):
        jn = jd.step(js, jnp.int32(a))
        tn = td.step(ts, torch.tensor([a], dtype=torch.int32))
        assert all(torch.equal(before[k], ts[k]) for k in ts), \
            "step modified its input state"
        assert int(tn["len"][0]) == int(jn["len"]) == 5
        if cached:
            np.testing.assert_allclose(tn["logits"][0].numpy(),
                                       np.asarray(jn["logits"]), **TOL)
        else:
            np.testing.assert_array_equal(tn["toks"][0].numpy(),
                                          np.asarray(jn["toks"]))
        assert bool(td.is_terminal(tn)[0]) == bool(jd.is_terminal(jn))
        np.testing.assert_allclose(
            td.playout(tn, draws).numpy()[0],
            np.asarray(jd.playout(jn, jax.random.key(0))), **TOL)
        assert all(torch.equal(before[k], ts[k]) for k in ts), \
            "playout modified its input state"
        js2 = jd.step(jn, jnp.int32(0))
        ts2 = td.step(tn, torch.tensor([0], dtype=torch.int32))
        assert bool(td.is_terminal(ts2)[0]) and bool(jd.is_terminal(js2))


def test_top_k_breaks_ties_toward_lower_ids():
    logits = torch.tensor([[0.5, 2.0, 2.0, 0.5, 2.0]])
    vals, idx = TD.top_k(logits, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()[0]), 4)
    assert idx[0].tolist() == np.asarray(ji).tolist() == [1, 2, 4, 0]
    np.testing.assert_array_equal(vals[0].numpy(), np.asarray(jv))


def test_spliced_root_and_stacked_prompts(params):
    """``root_cache`` / ``root_logits`` are returned verbatim; a domain
    whose prompt and length are stacked over B roots prefills them at once
    and equals the per-row domains."""
    jp, tp = params
    rows = torch.tensor([[1, 2, 3, 4], [7, 8, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([4, 2], dtype=torch.int32)
    stacked = TD.CachedLMDecodeDomain(cfg=TCFG, params=tp, prompt=rows,
                                      prompt_len=lens, **DOM_KW)
    rs = stacked.root_state()
    assert rs["k"].shape[:2] == (2, 1) and rs["len"].tolist() == [4, 2]
    for i in range(2):
        one = TD.CachedLMDecodeDomain(cfg=TCFG, params=tp, prompt=rows[i],
                                      prompt_len=lens[i], **DOM_KW)
        r1 = one.root_state()
        torch.testing.assert_close(rs["logits"][i], r1["logits"], **TOL)
        spliced = TD.CachedLMDecodeDomain(
            cfg=TCFG, params=tp, prompt=rows[i], prompt_len=lens[i],
            root_cache={"k": r1["k"], "v": r1["v"]},
            root_logits=r1["logits"], **DOM_KW).root_state()
        assert spliced["k"] is r1["k"] and spliced["logits"] is r1["logits"]
