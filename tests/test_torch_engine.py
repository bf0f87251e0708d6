"""lapha_tpu_torch.engine against lapha_tpu.engine on the tiny config (CPU, f32).

Both engines get the same JAX-initialised weights (through numpy) and the
same token-id prompts. Greedy token ids must be equal exactly, with and
without a prefix-cache hit; pooled_hidden (collect_h0) agrees to atol 1e-4
(f32 summation order). The JAX engine runs with approx_top_k=False: the
port's top-k is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.engine import sampling as jsampling
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import qwen2 as jq
from lapha_tpu_torch.engine import Engine, SamplingParams, sampling
from lapha_tpu_torch.models import loader, qwen2

V = 300


class IdTok:
    """Prompts are space-separated token ids."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


KW = dict(max_model_len=256, max_batch=8, decode_chunk=8, pad_multiple=32,
          batch_bucket=2, eos_token_ids=[1], prefix_cache_min_reuse=16,
          collect_h0=True)


@pytest.fixture(scope="module")
def engines():
    jcfg = JCfg.tiny(vocab_size=V)
    jp = jq.init_params(jcfg, jax.random.key(5))
    tp = loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    jeng = JEngine(jp, jcfg, IdTok(), approx_top_k=False, **KW)
    teng = Engine(tp, qwen2.Qwen2Config.tiny(vocab_size=V), IdTok(), **KW)
    return jeng, teng


def _prompt(rng, n):
    return " ".join(str(t) for t in rng.integers(2, V, n))


def _same_greedy(jout, tout):
    for jr, tr in zip(jout, tout):
        assert [o.token_ids for o in tr.outputs] == [o.token_ids for o in jr.outputs]
        for jo, to in zip(jr.outputs, tr.outputs):
            assert to.finish_reason == jo.finish_reason
            np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                       atol=1e-4, rtol=0)
            assert abs(to.cumulative_logprob - sum(to.token_logprobs)) < 1e-4


def test_greedy_tokens_match_jax_engine_with_and_without_prefix_hit(engines):
    jeng, teng = engines
    rng = np.random.default_rng(0)
    parents = [_prompt(rng, 40), _prompt(rng, 23)]
    sp = dict(n=2, temperature=0.0, max_tokens=12)
    _same_greedy(jeng.generate(parents, JSP(**sp)), teng.generate(parents, SamplingParams(**sp)))
    assert teng.prefix_cache.hits == 0

    # children extend the parents: both rows take the prefix-hit suffix
    # prefill; a fresh prompt in the same call takes the full prefill
    children = [parents[0] + " " + _prompt(rng, 9), parents[1] + " " + _prompt(rng, 30),
                _prompt(rng, 17)]
    hits0 = teng.prefix_cache.hits
    _same_greedy(jeng.generate(children, JSP(**sp)), teng.generate(children, SamplingParams(**sp)))
    assert teng.prefix_cache.hits - hits0 == 2
    assert teng.prefix_cache.stats()["hits"] == jeng.prefix_cache.stats()["hits"]


def test_greedy_eos_stops_rows_like_jax(engines):
    """A token the model emits early is made the EOS: rows stop there
    (finish_reason "stop", pooled h0 over prompt + tokens up to the EOS)
    while the others run on, exactly as in the JAX engine."""
    jeng, teng = engines
    rng = np.random.default_rng(3)
    prompts = [_prompt(rng, 30), _prompt(rng, 45)]
    sp = dict(n=1, temperature=0.0, max_tokens=10)
    first = teng.generate(prompts, SamplingParams(**sp))
    eos = first[0].outputs[0].token_ids[2]
    kw = dict(KW, eos_token_ids=[eos])
    jeng2 = JEngine(jeng.params, jeng.cfg, IdTok(), approx_top_k=False, **kw)
    teng2 = Engine(teng.params, teng.cfg, IdTok(), **kw)
    tout = teng2.generate(prompts, SamplingParams(**sp))
    _same_greedy(jeng2.generate(prompts, JSP(**sp)), tout)
    assert tout[0].outputs[0].token_ids[-1] == eos
    assert tout[0].outputs[0].finish_reason == "stop"


def test_sampled_generation_is_seeded_and_consistent(engines):
    _, teng = engines
    rng = np.random.default_rng(1)
    prompt = [_prompt(rng, 20)]
    sp = SamplingParams(n=4, temperature=1.0, top_p=0.95, top_k=20, max_tokens=10, seed=7)
    a = teng.generate(prompt, sp)[0]
    b = teng.generate(prompt, sp)[0]
    assert [o.token_ids for o in a.outputs] == [o.token_ids for o in b.outputs]
    assert len({tuple(o.token_ids) for o in a.outputs}) > 1
    for o in a.outputs:
        assert 1 <= len(o.token_ids) <= 10
        assert len(o.token_logprobs) == len(o.token_ids)
        assert all(lp <= 0.0 for lp in o.token_logprobs)
        assert abs(o.cumulative_logprob - sum(o.token_logprobs)) < 1e-4


@pytest.mark.parametrize("ps", [
    dict(temperature=0.8, top_p=0.95, top_k=20, repetition_penalty=1.0, min_p=0.0),
    dict(temperature=0.3, top_p=0.8, top_k=20, repetition_penalty=1.05, min_p=0.0),
    dict(temperature=0.7, top_p=0.9, top_k=-1, repetition_penalty=1.05, min_p=0.05),
])
def test_process_logits_matches_jax(ps):
    """Same keep set and processed values as the JAX pipeline (which
    tests/test_sampler_parity.py pins to vLLM's), full-sort and top-k paths."""
    rng = np.random.default_rng(17)
    B, Vs = 8, 503
    logits = (rng.normal(size=(B, Vs)) * 3).astype(np.float32)
    presence = (rng.uniform(size=(B, Vs)) < 0.05).astype(np.int8)
    tk = ps["top_k"]
    for static in ((0, 64) if tk > 0 else (0,)):
        def vec(v):
            return np.full((B,), v, np.float32)

        jout = np.asarray(jsampling.process_logits(
            jnp.asarray(logits), presence=jnp.asarray(presence),
            repetition_penalty=jnp.asarray(vec(ps["repetition_penalty"])),
            temperature=jnp.asarray(vec(ps["temperature"])),
            top_k=None if tk <= 0 else jnp.full((B,), tk, jnp.int32),
            top_p=jnp.asarray(vec(ps["top_p"])),
            min_p=jnp.asarray(vec(ps["min_p"])) if ps["min_p"] > 0 else None,
            static_top_k=static, approx_top_k=False))
        tout = sampling.process_logits(
            torch.from_numpy(logits), presence=torch.from_numpy(presence),
            repetition_penalty=torch.from_numpy(vec(ps["repetition_penalty"])),
            temperature=torch.from_numpy(vec(ps["temperature"])),
            top_k=None if tk <= 0 else torch.full((B,), tk),
            top_p=torch.from_numpy(vec(ps["top_p"])),
            min_p=torch.from_numpy(vec(ps["min_p"])) if ps["min_p"] > 0 else None,
            static_top_k=static).numpy()
        keep = jout > sampling.NEG_INF / 2
        np.testing.assert_array_equal(tout > sampling.NEG_INF / 2, keep)
        np.testing.assert_allclose(tout[keep], jout[keep], rtol=1e-6, atol=1e-6)


def test_sampled_tokens_inside_keep_set_with_softmax_frequencies():
    rng = np.random.default_rng(41)
    B, Vs, N = 4, 331, 4000
    logits = (rng.normal(size=(B, Vs)) * 2).astype(np.float32)
    temp, top_k, top_p = 0.3, 20, 0.8
    jproc = np.asarray(jsampling.process_logits(
        jnp.asarray(logits), temperature=jnp.full((B,), temp), top_k=jnp.full((B,), top_k),
        top_p=jnp.full((B,), top_p), approx_top_k=False))
    keep = jproc > jsampling.NEG_INF / 2
    probs = np.asarray(jax.nn.softmax(jnp.asarray(jproc), axis=-1))
    big = torch.from_numpy(np.repeat(logits, N, axis=0))  # row b repeated N times
    gen = torch.Generator().manual_seed(3)
    tok, lp = sampling.sample(big, gen, temperature=torch.full((B * N,), temp),
                              top_k=torch.full((B * N,), top_k),
                              top_p=torch.full((B * N,), top_p), static_top_k=64)
    tok = tok.numpy().reshape(B, N)
    assert np.isfinite(lp.numpy()).all()
    for b in range(B):
        assert keep[b, tok[b]].all(), "sampled token outside the keep set"
        emp = np.bincount(tok[b], minlength=Vs) / N
        np.testing.assert_allclose(emp[keep[b]], probs[b, keep[b]], atol=0.03)
    # temperature 0: argmax of the (penalized) logits
    t0, _ = sampling.sample(torch.from_numpy(logits), gen, temperature=torch.zeros(B))
    np.testing.assert_array_equal(t0.numpy(), logits.argmax(-1))


def test_unported_engine_knobs_raise(engines):
    """seq_mesh is not ported (auto_continuous is: see
    tests/test_torch_scheduler.py; spec_decode="pld" is: see
    tests/test_torch_spec_engine.py); spec_decode takes "pld" only, as the
    JAX engine."""
    _, teng = engines
    with pytest.raises(ValueError, match="not yet ported"):
        Engine(teng.params, teng.cfg, IdTok(), seq_mesh=object())
    assert Engine(teng.params, teng.cfg, IdTok(), spec_decode="pld").spec_decode == "pld"
    with pytest.raises(ValueError, match="spec_decode"):
        Engine(teng.params, teng.cfg, IdTok(), spec_decode="eagle")
    # kv_quant takes "int8" only, as the JAX engine
    with pytest.raises(ValueError, match="kv_quant"):
        Engine(teng.params, teng.cfg, IdTok(), kv_quant="fp4")
