"""Block diffusion in lapha_tpu_torch against lapha_tpu (CPU, f32), on the
tiny Qwen2 config with vocabulary 300 and [MASK] = 299, as
``tests/test_diffusion.py`` has it; the weights are JAX's, carried across.

- ``qwen2.forward(block_bidir=True)``: its logits within 1e-4 of JAX's over
  a cache with holes and garbage in invalid slots; the block-causal
  semantics (later in-block tokens seen, invalid slots never read); the
  kernel's route (``block_attention`` with kv_valid as it is); the
  refusals.
- ``DiffusionEngine``: greedy tokens, finish reasons, forwards and
  ``last_diffusion_stats`` equal JAX's for the three strategies, logprobs
  to 1e-4; a straight-line replay; batch against single; forward counts;
  greedy confidence 1.0; EOS truncation (equal to JAX's); the per-request
  threshold; each guard raising on both sides; the jet adapter.
- Sampled rounds (the random streams differ from JAX's): the same seed
  gives the same tokens, [MASK] never comes out, every token lies in its
  truncation's keep set.
- The scheduler's diffusion branch: greedy equal to the sync loop, a late
  request finishing first, a budget trimmed mid-block, ``auto_continuous``
  with an oversized batch.
- The new modules import no jax.
"""

import dataclasses
import math
import os
import subprocess
import sys
import threading

os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow import costs ~10 s

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lapha_tpu.models.deepseek as jds  # noqa: E402
import lapha_tpu_torch.engine.diffusion as tdiff  # noqa: E402
import lapha_tpu_torch.models.deepseek as tds  # noqa: E402
from lapha_tpu.engine import DiffusionEngine as JDiff  # noqa: E402
from lapha_tpu.engine import SamplingParams as JSP  # noqa: E402
from lapha_tpu.models import Qwen2Config as JCfg  # noqa: E402
from lapha_tpu.models import qwen2 as jq  # noqa: E402
from lapha_tpu_torch.engine import ContinuousEngine, DiffusionEngine, SamplingParams  # noqa: E402
from lapha_tpu_torch.engine import sampling  # noqa: E402
from lapha_tpu_torch.evalsuite.adapters import GenParams, build_engine_adapter  # noqa: E402
from lapha_tpu_torch.models import loader, qwen2  # noqa: E402

MASK = 299  # reserved id in the 300-vocab tiny config (ByteTok uses 1..256)
V = 300
TOL = 1e-4


class ByteTok:
    eos_token_id = 0
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [min(b, 255) + 1 for b in text.encode()]}

    def decode(self, ids, skip_special_tokens=True, **kw):
        return bytes((i - 1) % 256 for i in ids if i > 0).decode(errors="replace")


@pytest.fixture(scope="module")
def tiny():
    jcfg = JCfg.tiny(vocab_size=V)
    jp = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.key(3))
    tp = loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, qwen2.Qwen2Config.tiny(vocab_size=V), tp


BASE = dict(eos_token_ids=[], max_model_len=128, max_batch=8, pad_multiple=32, batch_bucket=2)


def make_engine(tiny, **kw):
    _, _, tcfg, tp = tiny
    return DiffusionEngine(tp, tcfg, ByteTok(), mask_token_id=MASK, **{**BASE, **kw})


def make_jax_engine(tiny, **kw):
    jcfg, jp, _, _ = tiny
    return JDiff(jp, jcfg, ByteTok(), mask_token_id=MASK, approx_top_k=False, **{**BASE, **kw})


def _greedy(n=1, max_tokens=8, **kw):
    return dict(n=n, temperature=0.0, max_tokens=max_tokens, **kw)


# ------------------------------------------------------- block_bidir forward

def _bidir_case(seed=0, B=2, T=4, S=32, cp=20, Lp=16):
    """Prompts of lens < Lp, holes up to Lp, the block at cp; the cache
    filled with noise everywhere (invalid slots hold garbage)."""
    rng = np.random.default_rng(seed)
    lens = np.array([11, 7])[:B]
    j = np.arange(S)[None, :]
    kvv = (j < lens[:, None]) | ((j >= Lp) & (j < cp + T))
    ids = rng.integers(1, V - 1, (B, T))
    pos = lens[:, None] + (cp - Lp) + np.arange(T)[None, :]
    shape = (2, B, S, 2, 16)
    ck = rng.normal(size=shape).astype(np.float32)
    cv = rng.normal(size=shape).astype(np.float32)
    return ids, pos, kvv, ck, cv, cp


def test_block_bidir_forward_matches_jax(tiny, monkeypatch):
    jcfg, jp, tcfg, tp = tiny
    ids, pos, kvv, ck, cv, cp = _bidir_case()
    jl, _, (jk, jv) = jax.jit(
        lambda p, i, q, k, v, m: jq.forward(p, jcfg, i, positions=q, kv_cache=(k, v),
                                            cache_pos=cp, kv_valid=m, block_bidir=True))(
        jp, jnp.asarray(ids), jnp.asarray(pos), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(kvv))
    calls = []
    real = qwen2.block_attention

    def spy(q, k, v, kv_valid, *a, **kw):
        calls.append((kv_valid, kv_valid.clone()))
        return real(q, k, v, kv_valid, *a, **kw)

    monkeypatch.setattr(qwen2, "block_attention", spy)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tkvv = torch.from_numpy(kvv)
    tl, _, _ = qwen2.forward(tp, tcfg, torch.from_numpy(ids), positions=torch.from_numpy(pos),
                             kv_cache=(tck, tcv), cache_pos=cp, kv_valid=tkvv, block_bidir=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tck.numpy(), np.asarray(jk), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    # the kernel's route: every layer's attention is the block attention,
    # given kv_valid as it is (the same tensor, unchanged)
    assert len(calls) == tcfg.num_hidden_layers
    for km, seen in calls:
        assert km is tkvv
        assert torch.equal(seen, tkvv)
    # the causal forward differs from it
    cl, _, _ = qwen2.forward(tp, tcfg, torch.from_numpy(ids), positions=torch.from_numpy(pos),
                             kv_cache=(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())),
                             cache_pos=cp, kv_valid=torch.from_numpy(kvv))
    assert float((cl - tl).abs().max()) > 1e-3


def test_block_bidir_mask_semantics(tiny):
    """The causal cached forward ignores later in-block tokens; block_bidir
    makes earlier positions see them; neither reads an invalid slot."""
    _, _, tcfg, tp = tiny
    S = 32
    ids = torch.tensor([[5, 6, 7, 8]])
    kvv = torch.arange(S)[None, :] < 4

    def logits_at0(block_bidir, last_tok, cache_fill=0.0):
        ck, cv = qwen2.init_kv_cache(tcfg, 1, S)
        ck += cache_fill
        cv += cache_fill
        x = ids.clone()
        x[0, 3] = last_tok
        lg, _, _ = qwen2.forward(tp, tcfg, x, kv_cache=(ck, cv), cache_pos=0, kv_valid=kvv,
                                 block_bidir=block_bidir)
        return lg[0, 0].numpy()

    np.testing.assert_array_equal(logits_at0(False, 8), logits_at0(False, 99))
    bidir_a = logits_at0(True, 8)
    assert np.abs(bidir_a - logits_at0(True, 99)).max() > 0  # position 0 sees position 3
    np.testing.assert_array_equal(bidir_a, logits_at0(True, 8, cache_fill=7.0))
    ck, cv = qwen2.init_kv_cache(tcfg, 1, S)
    with pytest.raises(ValueError, match="needs kv_valid"):
        qwen2.forward(tp, tcfg, ids, kv_cache=(ck, cv), cache_pos=0, block_bidir=True)
    wcfg = dataclasses.replace(tcfg, sliding_window=8)
    with pytest.raises(ValueError, match="windowed layers"):
        qwen2.forward(tp, wcfg, ids, kv_cache=(ck, cv), cache_pos=0, kv_valid=kvv,
                      block_bidir=True)


# -------------------------------------------------------- the engine vs JAX

STRATEGY_CASES = {
    "sequential": dict(remasking_strategy="sequential", denoising_steps=4),
    "low_confidence_static": dict(remasking_strategy="low_confidence_static",
                                  denoising_steps=2),
    # above 1 only the forced top-1 reveals (greedy confidence is 1.0)
    "low_confidence_dynamic": dict(remasking_strategy="low_confidence_dynamic",
                                   denoising_steps=8, dynamic_threshold=1.1),
}
PROMPTS = ["hello world, this is long enough to pass a pad", "hi"]


def _outs(results):
    return [[(o.token_ids, o.finish_reason) for o in r.outputs] for r in results]


def _lps(results):
    return np.concatenate([o.token_logprobs for r in results for o in r.outputs])


@pytest.mark.parametrize("case", sorted(STRATEGY_CASES))
def test_greedy_matches_jax(tiny, case):
    kw = STRATEGY_CASES[case]
    jeng, teng = make_jax_engine(tiny, **kw), make_engine(tiny, **kw)
    jr = jeng.generate(PROMPTS, JSP(**_greedy(n=2, max_tokens=10)))
    tr = teng.generate(PROMPTS, SamplingParams(**_greedy(n=2, max_tokens=10)))
    assert _outs(tr) == _outs(jr)
    np.testing.assert_allclose(_lps(tr), _lps(jr), atol=TOL)
    assert teng.last_diffusion_stats == jeng.last_diffusion_stats
    assert teng.last_diffusion_stats["tokens"] == 40


def manual_diffusion(params, cfg, ids, *, max_new, Tb, steps, mask_id, eos_set):
    """Straight-line greedy replay of the loop ("sequential") with exact-length
    slots: no Lp padding, no slot-uniform batch (JAX's test's replay, on the
    port's forward)."""
    L = len(ids)
    nblocks = math.ceil(max_new / Tb)
    S = L + nblocks * Tb
    k_reveal = max(1, math.ceil(Tb / steps))
    ck, cv = qwen2.init_kv_cache(cfg, 1, S)
    qwen2.forward(params, cfg, torch.tensor([ids]), kv_cache=(ck, cv), cache_pos=0,
                  kv_valid=torch.arange(S)[None, :] < L)
    out = []
    for b in range(nblocks):
        cp = L + b * Tb
        blk, masked = [mask_id] * Tb, [True] * Tb
        pos = torch.tensor([[cp + t for t in range(Tb)]])
        kvv = torch.arange(S)[None, :] < cp + Tb
        while any(masked):
            lg, _, _ = qwen2.forward(params, cfg, torch.tensor([blk]), positions=pos,
                                     kv_cache=(ck, cv), cache_pos=cp, kv_valid=kvv,
                                     block_bidir=True)
            lg = lg[0].clone()
            lg[:, mask_id] = -torch.inf
            cand = lg.argmax(-1)
            for i in [i for i in range(Tb) if masked[i]][:k_reveal]:
                blk[i], masked[i] = int(cand[i]), False
        # the commit forward rewrites the block's K/V from the clean tokens
        qwen2.forward(params, cfg, torch.tensor([blk]), positions=pos, kv_cache=(ck, cv),
                      cache_pos=cp, kv_valid=kvv, block_bidir=True)
        out.extend(blk)
        if any(t in eos_set for t in blk):
            break
    final = []
    for t in out[:max_new]:
        final.append(t)
        if t in eos_set:
            break
    return final


def test_matches_manual_replay(tiny):
    _, _, tcfg, tp = tiny
    eng = make_engine(tiny, block_length=4, denoising_steps=4, remasking_strategy="sequential",
                      eos_token_ids=[0])
    for prompt in ("hello world", "abc"):
        got = eng.generate([prompt], SamplingParams(**_greedy()))[0].outputs[0].token_ids
        want = manual_diffusion(tp, tcfg, eng.tokenizer(prompt)["input_ids"], max_new=8, Tb=4,
                                steps=4, mask_id=MASK, eos_set={0})
        assert got == want, (prompt, got, want)


def test_batch_matches_single(tiny):
    """A ragged batch emits the greedy streams of each prompt alone."""
    eng = make_engine(tiny, block_length=4, denoising_steps=2)
    sp = SamplingParams(**_greedy())
    batched = [r.outputs[0].token_ids for r in eng.generate(PROMPTS, sp)]
    assert batched == [eng.generate([p], sp)[0].outputs[0].token_ids for p in PROMPTS]


def test_forward_counts_per_strategy(tiny):
    """forwards = blocks x (denoise passes + 1 commit)."""
    sp = SamplingParams(**_greedy())  # 2 blocks of 4
    for kw, forwards in ((dict(denoising_steps=4, remasking_strategy="sequential"), 10),
                         (dict(denoising_steps=1, remasking_strategy="low_confidence_static"), 4),
                         (dict(denoising_steps=4, dynamic_threshold=0.0), 4),
                         (dict(denoising_steps=8, dynamic_threshold=1.1), 10)):
        eng = make_engine(tiny, block_length=4, **kw)
        eng.generate(["hello"], sp)
        assert eng.last_diffusion_stats["forwards"] == forwards, kw
        assert eng.last_diffusion_stats["tokens"] == 8
        assert eng.last_timings["decode_steps"] == forwards


def test_greedy_threshold_one_confidence(tiny):
    """Greedy rows have confidence exactly 1.0 (log-probability 0), so the
    dynamic strategy reveals a whole block in one pass at 0.99."""
    eng = make_engine(tiny, block_length=4, denoising_steps=4, dynamic_threshold=0.99)
    out = eng.generate(["hello"], SamplingParams(**_greedy(max_tokens=4)))[0].outputs[0]
    assert eng.last_diffusion_stats["forwards"] == 2
    assert out.token_logprobs == [0.0] * 4


def test_sampled_determinism_mask_and_keep_set(tiny, monkeypatch):
    seen = []
    real = sampling.sample

    def spy(logits, generator, **kw):
        tok, lp = real(logits, generator, **kw)
        kept = sampling.process_logits(logits, **kw) > sampling.NEG_INF
        seen.append(bool(kept.gather(1, tok[:, None]).all()))
        return tok, lp

    monkeypatch.setattr(tdiff.sampling, "sample", spy)
    eng = make_engine(tiny, block_length=4, denoising_steps=2)
    sp = SamplingParams(n=2, temperature=1.0, top_k=40, top_p=0.9, max_tokens=8, seed=11)
    a = [o.token_ids for o in eng.generate(["hi"], sp)[0].outputs]
    b = [o.token_ids for o in eng.generate(["hi"], sp)[0].outputs]
    assert a == b
    assert all(MASK not in ids for ids in a)
    assert a[0] != a[1]  # a stream a sample
    assert seen and all(seen)


def test_eos_truncation_and_finish_reason(tiny):
    """Blocks stop once every row committed an EOS; the host truncates at
    the first one. Tokens and forwards equal JAX's."""
    sp = _greedy(max_tokens=16)
    eng = make_engine(tiny, block_length=4, denoising_steps=1)
    full = eng.generate(["hello"], SamplingParams(**sp))[0].outputs[0]
    assert full.finish_reason == "length" and len(full.token_ids) == 16
    eos = full.token_ids[5]
    eng2 = make_engine(tiny, block_length=4, denoising_steps=1, eos_token_ids=[eos])
    out = eng2.generate(["hello"], SamplingParams(**sp))[0].outputs[0]
    assert out.finish_reason == "stop"
    assert out.token_ids == full.token_ids[:6]
    assert eng2.last_diffusion_stats["forwards"] < eng.last_diffusion_stats["forwards"]
    jeng = make_jax_engine(tiny, block_length=4, denoising_steps=1, eos_token_ids=[eos])
    jout = jeng.generate(["hello"], JSP(**sp))[0].outputs[0]
    assert (out.token_ids, out.finish_reason) == (jout.token_ids, jout.finish_reason)
    assert eng2.last_diffusion_stats == jeng.last_diffusion_stats


def test_per_request_dynamic_threshold(tiny):
    """GenParams.dynamic_threshold overrides the engine's default."""
    eng = make_engine(tiny, block_length=4, denoising_steps=4, dynamic_threshold=1.1)
    eng.generate(["hello"], GenParams(**_greedy(max_tokens=4), dynamic_threshold=0.0))
    assert eng.last_diffusion_stats["forwards"] == 2  # one pass + commit
    eng.generate(["hello"], GenParams(**_greedy(max_tokens=4)))  # the GenParams default 0.9
    assert eng.last_diffusion_stats["forwards"] == 2
    eng.generate(["hello"], SamplingParams(**_greedy(max_tokens=4)))  # the engine's 1.1
    assert eng.last_diffusion_stats["forwards"] == 5


GUARDS = {
    "collect h0": dict(kw=dict(collect_h0=True)),
    "kv_quant": dict(kw=dict(kv_quant="int8")),
    "spec_decode|seq_mesh": dict(kw=dict(spec_decode="pld")),
    "remasking_strategy": dict(kw=dict(remasking_strategy="nope")),
    "outside vocab": dict(kw=dict(mask_token_id=V)),
    "block_length and denoising_steps": dict(kw=dict(block_length=0)),
    "must be >= 1": dict(kw=dict(denoising_steps=0)),
    "windowed/sink": dict(cfg=dict(sliding_window=8)),
    "windowed/sink ": dict(cfg=dict(attn_sinks=True)),
    "qwen2-family only": dict(deepseek=True),
}


@pytest.mark.parametrize("what", sorted(GUARDS))
def test_guards_raise_on_both_sides(tiny, what):
    jcfg, jp, tcfg, tp = tiny
    g = GUARDS[what]
    kw = {**BASE, "mask_token_id": MASK, **g.get("kw", {})}
    if g.get("deepseek"):
        jcfg, tcfg = jds.DeepseekConfig(dtype=jnp.float32), tds.DeepseekConfig(dtype=torch.float32)
    else:
        jcfg = dataclasses.replace(jcfg, **g.get("cfg", {}))
        tcfg = dataclasses.replace(tcfg, **g.get("cfg", {}))
    for cls, params, cfg in ((JDiff, jp, jcfg), (DiffusionEngine, tp, tcfg)):
        with pytest.raises(ValueError, match=what.strip()):
            cls(params, cfg, ByteTok(), **kw)


def test_jet_adapter_builds_diffusion_engine(tmp_path, monkeypatch):
    from transformers import AutoTokenizer

    from model_fixtures import build_tiny_model_dir

    d = build_tiny_model_dir(str(tmp_path / "m"))
    tok = AutoTokenizer.from_pretrained(d)
    with pytest.raises(ValueError, match="needs a \\[MASK\\] token id"):
        build_engine_adapter("jet", tokenizer=tok, model_path=d, device="cpu")
    monkeypatch.setenv("SDAR_MASK_TOKEN_ID", "7")
    monkeypatch.setenv("SDAR_BLOCK_LENGTH", "2")
    eng = build_engine_adapter("jet", tokenizer=tok, model_path=d, device="cpu",
                               max_model_len=128, max_batch=4)
    assert isinstance(eng, DiffusionEngine) and eng.device.type == "cpu"
    assert (eng.mask_token_id, eng.block_length, eng.denoising_steps,
            eng.remasking_strategy) == (7, 2, 4, "low_confidence_dynamic")
    out = eng.generate(["hello"], GenParams(**_greedy(max_tokens=4)))[0]
    assert len(out.outputs[0].token_ids) >= 1
    eng = build_engine_adapter("jet", tokenizer=tok, model_path=d, device="cpu",
                               mask_token_id=9, block_length=3, denoising_steps=2,
                               remasking_strategy="sequential", dynamic_threshold=0.5,
                               max_model_len=128)
    assert (eng.mask_token_id, eng.block_length, eng.denoising_steps, eng.remasking_strategy,
            eng.dynamic_threshold) == (9, 3, 2, "sequential", 0.5)


# -------------------------------------------------------------- the scheduler

def test_scheduler_greedy_matches_sync(tiny):
    eng = make_engine(tiny, block_length=4, denoising_steps=4)
    sp = SamplingParams(**_greedy(max_tokens=12))
    prompts = ["hello there general", "a different prompt entirely"]
    ref = [r.outputs[0].token_ids for r in eng.generate(prompts, sp)]
    ce = ContinuousEngine(eng, prompt_slab=64)
    assert ce.diffusion and ce.chunk == 4
    ce.start()
    try:
        got = [r.outputs[0].token_ids for r in ce.generate(prompts, sp)]
    finally:
        ce.stop()
    assert got == ref
    assert all(len(t) == 12 for t in got)
    assert ce._state["ck"].shape == (2, 8, 128, 2, 16)  # the prefill layout


def test_scheduler_late_request_interleaves(tiny):
    """A short request admitted mid-wave of a long one finishes first."""
    eng = make_engine(tiny, block_length=4, denoising_steps=2)
    first, go = threading.Event(), threading.Event()
    chunk = eng._diff_chunk_impl

    def paused_after_first(*a, **kw):  # the loop waits after its first block
        out = chunk(*a, **kw)
        if not first.is_set():
            first.set()
            go.wait(60)
        return out

    eng._diff_chunk_impl = paused_after_first
    ce = ContinuousEngine(eng, prompt_slab=64)
    order = []
    ce.start()
    try:
        fa = ce.submit("long running request", SamplingParams(**_greedy(max_tokens=48)))
        fa.add_done_callback(lambda f: order.append("long"))
        assert first.wait(60)
        fb = ce.submit("short", SamplingParams(**_greedy(max_tokens=4)))
        fb.add_done_callback(lambda f: order.append("short"))
        go.set()
        rb, ra = fb.result(timeout=120), fa.result(timeout=120)
    finally:
        go.set()
        ce.stop()
    assert ce.steps_executed == 12 * 3  # the short rode the long's second chunk
    assert len(rb.outputs[0].token_ids) == 4 and len(ra.outputs[0].token_ids) == 48
    assert order == ["short", "long"]
    ref = eng.generate(["long running request"], SamplingParams(**_greedy(max_tokens=48)))
    assert ra.outputs[0].token_ids == ref[0].outputs[0].token_ids


def test_scheduler_budget_trims_mid_block(tiny):
    """max_tokens not a block multiple: whole blocks on the device, the
    host trims to the budget."""
    eng = make_engine(tiny, block_length=4, denoising_steps=2)
    ce = ContinuousEngine(eng, prompt_slab=64)
    ce.start()
    try:
        out = ce.generate(["trim me"], SamplingParams(**_greedy(max_tokens=6)))[0]
    finally:
        ce.stop()
    assert len(out.outputs[0].token_ids) == 6
    assert out.outputs[0].finish_reason == "length"
    assert ce._budget_cols(SamplingParams(max_tokens=6)) == 8
    ref = eng.generate(["trim me"], SamplingParams(**_greedy(max_tokens=6)))[0]
    assert out.outputs[0].token_ids == ref.outputs[0].token_ids


def test_scheduler_compaction_mid_wave(tiny):
    """A (80 tokens) has run 16 blocks to column 96 of 128 when B (40)
    arrives: B no longer fits, so the scheduler folds A's committed columns
    into its prefix (the gather over the prefill layout's column axis) and
    admits B; both answers equal the sync loop's."""
    eng = make_engine(tiny, block_length=4, denoising_steps=2)
    calls, paused, go = [0], threading.Event(), threading.Event()
    chunk = eng._diff_chunk_impl

    def pause_after_16(*a, **kw):  # the loop waits once A's 16th block is committed
        out = chunk(*a, **kw)
        calls[0] += 1
        if calls[0] == 16:
            paused.set()
            go.wait(60)
        return out

    eng._diff_chunk_impl = pause_after_16
    ce = ContinuousEngine(eng, prompt_slab=32)
    spA, spB = SamplingParams(**_greedy(max_tokens=80)), SamplingParams(**_greedy(max_tokens=40))
    a, b = "long running request", "late one"
    ce.start()
    try:
        fa = ce.submit(a, spA)
        assert paused.wait(60)
        assert ce._state["col"] == 32 + 15 * 4  # the 16th chunk's columns not yet counted
        fb = ce.submit(b, spB)
        go.set()
        ra, rb = fa.result(timeout=120), fb.result(timeout=120)
    finally:
        go.set()
        ce.stop()
    assert ce.compactions == 1, "compaction never triggered"
    assert len(ra.outputs[0].token_ids) == 80 and len(rb.outputs[0].token_ids) == 40
    del eng._diff_chunk_impl
    assert ra.outputs[0].token_ids == eng.generate([a], spA)[0].outputs[0].token_ids
    assert rb.outputs[0].token_ids == eng.generate([b], spB)[0].outputs[0].token_ids


def test_auto_continuous_oversized_batch(tiny):
    """A batch larger than max_batch goes through the internal scheduler
    and matches the sync waves greedily."""
    eng_sync = make_engine(tiny, block_length=4, denoising_steps=2, max_batch=2)
    eng_auto = make_engine(tiny, block_length=4, denoising_steps=2, max_batch=2,
                           auto_continuous=True)
    sp = SamplingParams(**_greedy())
    prompts = ["first prompt", "second one", "third entry", "and a fourth"]
    ref = [r.outputs[0].token_ids for r in eng_sync.generate(prompts, sp)]
    try:
        got = [r.outputs[0].token_ids for r in eng_auto.generate(prompts, sp)]
        assert eng_auto._auto_sched is not None and eng_auto._auto_sched.diffusion
    finally:
        if eng_auto._auto_sched is not None:
            eng_auto._auto_sched.stop()
    assert got == ref


def test_new_modules_import_no_jax():
    """The diffusion engine and the adapters import neither jax nor the JAX
    package (a fresh interpreter)."""
    code = ("import sys, lapha_tpu_torch.engine.diffusion, lapha_tpu_torch.evalsuite.adapters; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lapha_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
