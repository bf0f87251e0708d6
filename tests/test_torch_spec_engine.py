"""Speculative decoding in lapha_tpu_torch against lapha_tpu (CPU, f32): the
engine, on the same weights (JAX's, carried across) and
JAX's tests/test_spec.py prompts.

- ``Engine(spec_decode="pld")`` greedy: tokens, finish reasons and
  ``last_spec_stats`` equal JAX's ``Engine(spec_decode="pld",
  approx_top_k=False)``, logprobs and pooled h0 to 1e-4, and the tokens
  equal the port's own non-speculative greedy: an EOS inside the stream
  with pooled h0, the int8 KV cache, a GPT-OSS-style stack (mixed windows,
  sinks, MoE) over an int8 cache, a repetitive row whose drafts are
  accepted, DeepSeek.
- Sampled spec tokens stay inside their truncation's keep set.
- ``auto_continuous`` under spec falls back to waves.

The pieces (spec.py, both decode_step_multi) are in
``tests/test_torch_spec.py``, the entries in
``tests/test_torch_spec_entries.py``.
"""

import numpy as np
import pytest
import torch

from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu_torch.engine import Engine, SamplingParams, sampling
from lapha_tpu_torch.models import qwen2

from test_torch_deepseek import _pair
from test_torch_spec import _qwen_pair


class IdTok:
    """Prompts are space-separated token ids (JAX's tests/test_spec.py)."""

    eos_token_id = 1
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


BASE = dict(max_model_len=256, max_batch=8, decode_chunk=8, pad_multiple=16, batch_bucket=1,
            eos_token_ids=[], seed=0, prefix_cache_bytes=0)


def _prompts():
    """A repetitive prompt (n-gram lookup has material) and a random one."""
    rng = np.random.default_rng(3)
    base = rng.integers(2, 290, 24).tolist()
    rep = base + base[-8:] + base[-8:]
    return [" ".join(map(str, rep)), " ".join(map(str, rng.integers(2, 290, 31)))]


# ---------------------------------------------------------------- the engine

def _run_both(jcfg, jp, tcfg, tp, sp_kw, prompts, **kw):
    """JAX's and the port's spec engines and the port's non-spec engine."""
    jeng = JEngine(jp, jcfg, IdTok(), approx_top_k=False, spec_decode="pld", spec_k=3,
                   **{**BASE, **kw})
    teng = Engine(tp, tcfg, IdTok(), spec_decode="pld", spec_k=3, **{**BASE, **kw})
    plain = Engine(tp, tcfg, IdTok(), **{**BASE, **kw})
    return (jeng, jeng.generate(prompts, JSP(**sp_kw)), teng,
            teng.generate(prompts, SamplingParams(**sp_kw)),
            plain.generate(prompts, SamplingParams(**sp_kw)))


ENGINE_CASES = {
    # an EOS the stream emits, greedy with a repetition penalty, pooled h0
    "eos_h0": dict(kw=dict(collect_h0=True), sp=dict(n=2, repetition_penalty=1.05)),
    "int8kv": dict(kw=dict(kv_quant="int8"), sp=dict(n=2, repetition_penalty=1.05)),
    # GPT-OSS's layer: alternating windows (by position here), sinks, o_proj
    # bias, its MoE; with the int8 cache
    "gptoss_moe_windows_int8kv": dict(
        cfg=dict(layer_windows=(8, 0), attn_sinks=True, o_proj_bias=True, num_experts=4,
                 num_experts_per_tok=2, moe_intermediate_size=32, moe_style="gptoss"),
        kw=dict(kv_quant="int8"), sp=dict(n=2)),
    # one repetitive row with no penalty: drafts are accepted
    "accepting": dict(sp=dict(n=1, max_tokens=96), prompts=1),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_spec_greedy_matches_jax(case):
    c = ENGINE_CASES[case]
    jcfg, jp, tcfg, tp = _qwen_pair(7, **c.get("cfg", {}))
    prompts = _prompts()[:c.get("prompts", 2)]
    sp = {"temperature": 0.0, "max_tokens": 40, "seed": 5, **c["sp"]}
    kw = dict(c.get("kw", {}))
    if case == "eos_h0":
        # an EOS that the first row's greedy stream emits at its 6th token
        probe = Engine(tp, tcfg, IdTok(), **BASE).generate(prompts, SamplingParams(**sp))
        kw["eos_token_ids"] = [probe[0].outputs[0].token_ids[5]]
    jeng, jout, teng, tout, plain = _run_both(jcfg, jp, tcfg, tp, sp, prompts, **kw)
    assert teng.last_spec_stats == jeng.last_spec_stats
    for jr, tr, pr in zip(jout, tout, plain):
        for jo, to, po in zip(jr.outputs, tr.outputs, pr.outputs):
            assert to.token_ids == jo.token_ids == po.token_ids
            assert to.finish_reason == jo.finish_reason == po.finish_reason
            np.testing.assert_allclose(to.token_logprobs, jo.token_logprobs, atol=1e-4, rtol=0)
            if "collect_h0" in kw:
                np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                           atol=1e-4, rtol=0)
                np.testing.assert_allclose(to.pooled_hidden, po.pooled_hidden, atol=1e-4,
                                           rtol=0)
    if case == "eos_h0":
        assert tout[0].outputs[0].finish_reason == "stop"
    if case == "accepting":
        assert teng.last_spec_stats["tokens_per_iteration"] > 1.1, teng.last_spec_stats


def test_engine_spec_deepseek_matches_jax():
    # two layers: the dense one and an MoE one (the JAX spec loop's compile
    # grows with the layers)
    jcfg, jp, tcfg, tp = _pair(0, num_hidden_layers=2)
    sp = dict(n=2, temperature=0.0, max_tokens=24, seed=5)
    jeng, jout, teng, tout, plain = _run_both(jcfg, jp, tcfg, tp, sp, _prompts(),
                                              collect_h0=True)
    assert teng.last_spec_stats == jeng.last_spec_stats
    for jr, tr, pr in zip(jout, tout, plain):
        for jo, to, po in zip(jr.outputs, tr.outputs, pr.outputs):
            assert to.token_ids == jo.token_ids == po.token_ids
            np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                       atol=1e-4, rtol=0)


def test_sampled_spec_tokens_inside_keep_set():
    """Every sampled token lies inside its position's top-k / top-p keep
    set, replayed through one forward over prompt + stream (JAX's
    test_sampled_tokens_respect_truncation)."""
    _, _, tcfg, tp = _qwen_pair(7)
    sp = SamplingParams(n=2, temperature=0.8, top_k=12, top_p=0.9, max_tokens=16, seed=11)
    eng = Engine(tp, tcfg, IdTok(), spec_decode="pld", spec_k=3, **BASE)
    outs = eng.generate(_prompts(), sp)
    assert eng.last_spec_stats["tokens"] == sum(len(o.token_ids) for r in outs for o in r.outputs)
    for ro in outs:
        for o in ro.outputs:
            ids, T, Lp = list(ro.prompt_token_ids) + list(o.token_ids), len(o.token_ids), len(
                ro.prompt_token_ids)
            logits, _, _ = qwen2.forward(tp, tcfg, torch.tensor([ids]))
            rows = logits[0, Lp - 1:Lp - 1 + T]
            keep = sampling.process_logits(rows, top_k=torch.full((T,), 12),
                                           top_p=torch.full((T,), 0.9),
                                           temperature=torch.full((T,), 0.8)) > -1e29
            assert all(bool(keep[t, tok]) for t, tok in enumerate(o.token_ids))


def test_auto_continuous_falls_back_to_waves():
    """Under spec the scheduler is never built: a call larger than one wave
    runs as waves, with the non-spec engine's greedy tokens."""
    _, _, tcfg, tp = _qwen_pair(7)
    prompts = _prompts() * 3
    sp = SamplingParams(n=2, temperature=0.0, max_tokens=12)
    kw = {**BASE, "max_batch": 4}
    eng = Engine(tp, tcfg, IdTok(), spec_decode="pld", auto_continuous=True, **kw)
    out = eng.generate(prompts, sp)
    assert eng._continuous() is None and eng._auto_sched is None
    ref = Engine(tp, tcfg, IdTok(), **kw).generate(prompts, sp)
    assert [o.token_ids for r in out for o in r.outputs] == \
        [o.token_ids for r in ref for o in r.outputs]
    assert eng.last_spec_stats["tokens"] == 6 * 2 * 12
