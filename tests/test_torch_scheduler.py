"""lapha_tpu_torch.engine.scheduler against lapha_tpu.engine.scheduler (CPU, f32).

Both sides get the same JAX-initialised weights (through numpy) and the same
token ids; the JAX engine runs with approx_top_k=False. The step-driven test
holds the two schedulers' host state, caches and greedy tokens equal after
every admission, chunk and compaction; the others are tests/test_continuous.py
on the port, with greedy tokens held to the JAX sync engine's (sampled tokens
differ: the two sides draw from different generators). Every result() has a
timeout, so a hung scheduler fails the test instead of stalling it.
"""

import threading
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.engine import scheduler as jsched
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.native import PySlotAllocator as JSlots
from lapha_tpu_torch.engine import ContinuousEngine, Engine, SamplingParams
from lapha_tpu_torch.engine import scheduler as tsched
from lapha_tpu_torch.models import loader, qwen2
from lapha_tpu_torch.native import PySlotAllocator

V = 300
ATOL = 1e-4
WAIT = 120  # seconds any one result may take


class ByteTok:
    eos_token_id = 0
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [min(b, 255) + 1 for b in text.encode()]}

    def decode(self, ids, **kw):
        return bytes((i - 1) % 256 for i in ids if i > 0).decode(errors="replace")


class IdTok:
    """Prompts are space-separated token ids."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


KW = dict(max_model_len=96, max_batch=4, decode_chunk=4, pad_multiple=16, batch_bucket=1,
          eos_token_ids=[], prefix_cache_bytes=0)


# eager JAX compiles every op: the JAX side's one-off functions are jitted
_jit_init = jax.jit(jq.init_params, static_argnums=0)


def _pair(seed: int, **kw):
    """(jcfg, jparams, tcfg, tparams) of the tiny qwen2-family model."""
    jcfg = JCfg.tiny(vocab_size=V, **kw)
    jp = _jit_init(jcfg, jax.random.key(seed))
    return (jcfg, jp, qwen2.Qwen2Config.tiny(vocab_size=V, **kw),
            loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))


def _jax_greedy(jcfg, jp, prompts, max_tokens, tok=None, **kw):
    jeng = JEngine(jp, jcfg, tok or ByteTok(), approx_top_k=False, **{**KW, **kw})
    sp = JSP(n=1, temperature=0.0, max_tokens=max_tokens)
    return [r.outputs[0].token_ids for r in jeng.generate(prompts, sp)]


def _long_then_late(ce, spA, spB, a="long A", b="short b", after=30):
    """Submit A, wait until it has run `after` steps, submit B; both outputs."""
    futA = ce.submit(a, spA)
    t0 = time.time()
    while ce.steps_executed < after and time.time() - t0 < 60:
        time.sleep(0.005)
    futB = ce.submit(b, spB)
    return futA.result(timeout=WAIT), futB.result(timeout=WAIT)


# ---------------------------------------------------------------- step-driven

def _req(mod, prompt, sp, tok):
    return mod._Request(prompt, list(tok(prompt)["input_ids"]), sp, sp.n, Future())


def _same_state(jce, tce, what, h_atol=ATOL):
    js, ts = jce._state, tce._state
    for k in ("lens", "dstart", "pos", "emitted", "fin", "budget"):
        np.testing.assert_array_equal(ts[k], np.asarray(js[k]), err_msg=f"{what}: {k}")
    assert ts["col"] == int(js["col"]), what
    assert sorted(tce._rows) == sorted(jce._rows), what
    for r, jrow in jce._rows.items():
        trow = tce._rows[r]
        assert len(trow.toks) == len(jrow.toks), (what, r)
        if trow.req.sp.temperature == 0.0:
            assert trow.toks == jrow.toks, (what, r)
            # the pooled mean so far
            n_tok = len(trow.req.enc) + len(trow.toks)
            np.testing.assert_allclose(trow.h_gen / n_tok, np.asarray(jrow.h_gen) / n_tok,
                                       atol=h_atol, rtol=0, err_msg=f"{what}: row {r}")


def _jax_logprobs(jcfg, jp, prompt, completion, sp):
    """JAX's logprob of each completion token: a teacher-forced forward over
    prompt + completion, the logits through JAX's processing with the
    request's temperature and top_p, then log-softmax."""
    from lapha_tpu.engine import sampling as jsampling

    @jax.jit
    def lps(jp, ids, comp, temp, top_p):
        logits = jq.forward(jp, jcfg, ids)[0][0, len(prompt) - 1:-1]
        T = logits.shape[0]
        proc = jsampling.process_logits(logits, temperature=jnp.full((T,), temp),
                                        top_p=jnp.full((T,), top_p), approx_top_k=False)
        return jax.nn.log_softmax(proc, axis=-1)[jnp.arange(T), comp]

    ids = jnp.asarray([list(prompt) + list(completion)], jnp.int32)
    return np.asarray(lps(jp, ids, jnp.asarray(completion), jnp.float32(sp["temperature"]),
                          jnp.float32(sp.get("top_p", 1.0))))


def _same_caches(jce, tce, what, exact: bool, rows=None):
    """The caches of ``rows`` (every row by default): f32 values within
    1e-5; int8 values equal but for a rare rounding step and the scales
    within 1e-5 relative. The prefills' K/V differ by f32 rounding, so a
    value on a .5 boundary may round the other way and an amax may move
    some ulps; on equal inputs the install is bit-equal, scales within 1
    ulp (test_device_helpers_match_jax)."""
    js, ts = jce._state, tce._state
    rows = list(range(tce.B)) if rows is None else rows
    for k in ("ck", "cv"):
        t, j = ts[k].numpy()[:, rows], np.asarray(js[k])[:, rows]
        if exact:
            diff = np.abs(t.astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, (what, k, diff.max(),
                                                                   (diff > 0).sum())
        else:
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=0, err_msg=what)
    if ts["scale"] is not None:
        for t, j in zip(ts["scale"], js["scale"]):
            np.testing.assert_allclose(t.numpy()[:, rows], np.asarray(j)[:, rows], rtol=1e-5,
                                       atol=0, err_msg=what)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_step_driven_matches_jax_scheduler(kv_quant):
    """Both schedulers unstarted, both on PySlotAllocator: admissions (a
    prefix hit among them), chunks, a compaction forced by a budget that no
    longer fits, and the drain, in the same order on each. After every call
    the host state (lens, dstart, pos, emitted, fin, budget, col) is equal,
    greedy tokens are equal exactly (a repetition-penalised greedy row
    included) and the pooled h0 within 1e-4 (1e-3 with int8 KV). The
    sampled row draws other tokens on each side: its logprobs are held
    within 1e-4 to JAX's processed log-softmax over the same tokens (a
    teacher-forced JAX forward; with int8 KV within 1e-2, that forward's
    cache being unquantized: ~4e-3 of int8 rounding shows). A greedy
    logprob is that of logits divided by the 1e-6 temperature floor, so it
    moves 1e6 times a logit's f32 difference near a tie and is not
    compared. With int8 KV the installed cache equals JAX's up to f32
    rounding of the prefills (see _same_caches)."""
    jcfg, jp, tcfg, tp = _pair(21)
    kw = dict(KW, max_model_len=128, prefix_cache_bytes=10**8, prefix_cache_min_reuse=16,
              collect_h0=True, kv_quant=kv_quant)
    tok = IdTok()
    # int8 KV: a cached value may round one step apart (see _same_caches)
    h_atol = ATOL if kv_quant is None else 1e-3
    jeng = JEngine(jp, jcfg, tok, approx_top_k=False, **kw)
    teng = Engine(tp, tcfg, tok, **kw)
    jce = jsched.ContinuousEngine(jeng, prompt_slab=64, chunk=4)
    tce = ContinuousEngine(teng, prompt_slab=64, chunk=4)
    jce.slots, tce.slots = JSlots(4), PySlotAllocator(4)
    jce._init_state()
    tce._init_state()
    rng = np.random.default_rng(4)

    def prompt(n):
        return " ".join(str(t) for t in rng.integers(2, V, n))

    pa = prompt(30)
    reqs = [  # (prompt, sampling params): A n=2 greedy; B sampled; then C, D
        (pa, dict(n=2, temperature=0.0, max_tokens=40)),
        (prompt(20), dict(n=1, temperature=0.7, top_p=0.9, max_tokens=20)),
        (pa + " " + prompt(12), dict(n=1, temperature=0.0, repetition_penalty=1.1,
                                     max_tokens=30)),
        (prompt(25), dict(n=1, temperature=0.0, top_k=5, max_tokens=40)),
    ]
    pend = {}

    def admit(i):
        p, sp = reqs[i]
        pend[i] = (_req(jsched, p, JSP(**sp), tok), _req(tsched, p, SamplingParams(**sp), tok))
        admissible = (jce._admissible(pend[i][0]), tce._admissible(pend[i][1]))
        assert admissible[0] == admissible[1]
        if not admissible[0]:
            return False
        jce._admit([pend[i][0]])
        tce._admit([pend[i][1]])
        _same_state(jce, tce, f"admit {i}", h_atol)
        return True

    def chunk(what):
        jce._decode_chunk()
        tce._decode_chunk()
        _same_state(jce, tce, what, h_atol)

    assert admit(0) and admit(1)
    # the installed caches: int8 bit-equal, f32 equal to rounding
    _same_caches(jce, tce, "after the first installs", exact=kv_quant == "int8")
    for c in range(3):
        chunk(f"chunk {c}")
    hits = teng.prefix_cache.hits
    assert admit(2)  # a prefix hit: A's prompt + 12 tokens
    assert teng.prefix_cache.hits == hits + 1 == jeng.prefix_cache.stats()["hits"]
    for c in range(3, 8):
        chunk(f"chunk {c}")
    # D (40 columns) no longer fits: both compact, then admit it
    assert not admit(3)
    assert jce._compact() and tce._compact()
    _same_state(jce, tce, "compaction", h_atol)
    # the greedy rows' caches (the sampled row's tokens, and so its K/V, differ)
    greedy = [r for r, row in tce._rows.items() if row.req.sp.temperature == 0.0]
    _same_caches(jce, tce, "compaction", exact=kv_quant == "int8", rows=greedy)
    assert tce.compactions == 1 and admit(3)
    c = 8
    while tce._rows:
        chunk(f"chunk {c}")
        c += 1
        assert c < 60
    assert jce.waves == tce.waves == 1 and jce.steps_executed == tce.steps_executed
    for i, (jr, tr) in pend.items():
        jout, tout = jr.future.result(timeout=0), tr.future.result(timeout=0)
        assert [len(o.token_ids) for o in tout.outputs] == [len(o.token_ids)
                                                            for o in jout.outputs]
        for jo, to in zip(jout.outputs, tout.outputs):
            if reqs[i][1]["temperature"] == 0.0:
                assert to.token_ids == jo.token_ids, i
                np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                           atol=h_atol, rtol=0)
            else:
                np.testing.assert_allclose(
                    to.token_logprobs, _jax_logprobs(jcfg, jp, tout.prompt_token_ids,
                                                     to.token_ids, reqs[i][1]),
                    atol=ATOL if kv_quant is None else 1e-2, rtol=0)


def test_device_helpers_match_jax():
    """The scheduler's device helpers on one input, tensor for tensor: the
    row installs (the int8 one quantizing: values bit-equal, scales within
    1 f32 ulp) and the compaction gathers."""
    rng = np.random.default_rng(8)
    L, B, P, nkv, S, dh = 2, 3, 2, 2, 16, 8
    ck, cv = (rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32) for _ in range(2))
    sc = tuple(rng.uniform(size=(L, B, nkv, S)).astype(np.float32) for _ in range(2))
    gk, gv = (rng.normal(size=(L, P, S, nkv, dh)).astype(np.float32) for _ in range(2))
    group, rows = np.asarray([1, 0, 1], np.int32), np.asarray([2, 0, 1], np.int32)
    idx = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    idx[1, 4:9] = np.arange(10, 15)
    idx[2, 2:4] = np.arange(12, 14)
    J, T = jnp.asarray, torch.from_numpy

    def t_args(*a):
        return [T(x.copy()) if x.dtype != np.int32 else T(x).long() for x in a]

    got = [tsched._install_rows(*t_args(ck, cv, gk, gv, group, rows))]
    want = [jsched._install_rows(J(ck), J(cv), J(gk), J(gv), J(group), J(rows))]
    q8 = (np.zeros_like(ck, np.int8), np.zeros_like(cv, np.int8))
    tk, tv, ts = tsched._install_rows_q(T(q8[0].copy()), T(q8[1].copy()),
                                        tuple(T(x.copy()) for x in sc),
                                        *t_args(gk, gv, group, rows))
    jk, jv, js = jsched._install_rows_q(J(q8[0]), J(q8[1]), tuple(J(x) for x in sc), J(gk),
                                        J(gv), J(group), J(rows))
    got.append((tk, tv))
    want.append((jk, jv))
    for t, j in zip(ts, js):
        np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j), maxulp=1)
    ti = T(idx).long()
    got += [tsched._gather_columns(T(ck.copy()), T(cv.copy()), ti),
            tsched._gather_scale_columns(tuple(T(x.copy()) for x in sc), ti)]
    want += [jsched._gather_columns(J(ck), J(cv), J(idx)),
             jsched._gather_scale_columns(tuple(J(x) for x in sc), J(idx))]
    for tt, jj in zip(got, want):
        for t, j in zip(tt, jj):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------- tests/test_continuous.py

@pytest.fixture(scope="module")
def setup():
    jcfg, jp, tcfg, tp = _pair(3)
    eng = Engine(tp, tcfg, ByteTok(), **dict(KW, max_model_len=256, max_batch=8))
    ce = ContinuousEngine(eng, prompt_slab=128, chunk=4)
    ce.start()
    yield eng, ce, jcfg, jp
    ce.stop()


def test_greedy_matches_sync_engine(setup):
    eng, ce, jcfg, jp = setup
    sp = SamplingParams(n=1, temperature=0.0, max_tokens=8)
    prompts = ["hello there general", "another prompt entirely different"]
    ref = [r.outputs[0].token_ids for r in eng.generate(prompts, sp)]
    futs = [ce.submit(p, sp) for p in prompts]
    got = [f.result(timeout=WAIT).outputs[0].token_ids for f in futs]
    assert got == ref == _jax_greedy(jcfg, jp, prompts, 8, max_model_len=256, max_batch=8)


def test_n_samples_and_schema(setup):
    _, ce, _, _ = setup
    sp = SamplingParams(n=3, temperature=0.7, max_tokens=6, seed=5)
    out = ce.submit("sample me plenty", sp).result(timeout=WAIT)
    assert len(out.outputs) == 3
    for o in out.outputs:
        assert len(o.token_ids) == len(o.token_logprobs) <= 6
        assert np.isfinite(o.cumulative_logprob)
        assert all(lp <= 0.0 for lp in o.token_logprobs)


def test_late_request_does_not_wait_for_long_one(setup):
    """B (budget 6), submitted while A (budget 96) decodes, finishes long
    before A does."""
    _, ce, _, _ = setup
    spA = SamplingParams(n=1, temperature=0.9, max_tokens=96, seed=1)
    spB = SamplingParams(n=1, temperature=0.9, max_tokens=6, seed=2)
    futA = ce.submit("a very long running request", spA)
    t0 = time.time()
    while ce.steps_executed == 0 and time.time() - t0 < 60:
        time.sleep(0.005)
    assert not futA.done()
    outB = ce.submit("tiny one", spB).result(timeout=WAIT)
    done_A_when_B_finished = futA.done()
    outA = futA.result(timeout=WAIT)
    assert len(outB.outputs[0].token_ids) == 6
    assert len(outA.outputs[0].token_ids) == 96
    assert not done_A_when_B_finished, "B should finish while A still runs"


def test_many_concurrent_requests(setup):
    """More requests than rows: later ones queue and still complete."""
    _, ce, _, _ = setup
    sp = SamplingParams(n=1, temperature=0.5, max_tokens=5, seed=9)
    futs = [ce.submit(f"prompt number {i} with some words", sp) for i in range(20)]
    outs = [f.result(timeout=WAIT) for f in futs]
    assert all(len(o.outputs[0].token_ids) == 5 for o in outs)


def _compaction_case(jcfg, jp, tcfg, tp, tok=None):
    """A (60 tokens) runs past column 56 of 96, so B (40) no longer fits and
    the scheduler compacts; both answers equal the JAX sync engine's."""
    tok = tok or ByteTok()
    eng = Engine(tp, tcfg, tok, **KW)
    ce = ContinuousEngine(eng, prompt_slab=32, chunk=4)
    ce.start()
    try:
        spA = SamplingParams(n=1, temperature=0.0, max_tokens=60)
        spB = SamplingParams(n=1, temperature=0.0, max_tokens=40)
        a, b = ("long A", "short b") if isinstance(tok, ByteTok) else ("5 9 77 4 21 8",
                                                                       "3 250 7")
        outA, outB = _long_then_late(ce, spA, spB, a, b)
        assert len(outA.outputs[0].token_ids) == 60
        assert len(outB.outputs[0].token_ids) == 40
        assert ce.compactions >= 1, "compaction never triggered"
        # one JAX call: B's 40 greedy tokens are the first 40 of its 60
        ref = _jax_greedy(jcfg, jp, [a, b], 60, tok)
        assert outA.outputs[0].token_ids == ref[0]
        assert outB.outputs[0].token_ids == ref[1][:40]
        return ce
    finally:
        ce.stop()


def test_compaction_reclaims_columns():
    _compaction_case(*_pair(5))


def test_moe_model_through_scheduler():
    """A sparse-MoE model: greedy through the scheduler equals JAX's."""
    jcfg, jp, tcfg, tp = _pair(11, num_experts=4, num_experts_per_tok=2,
                               moe_intermediate_size=32, shared_expert_intermediate_size=48,
                               tie_word_embeddings=False)
    eng = Engine(tp, tcfg, ByteTok(), **dict(KW, max_model_len=128))
    ce = ContinuousEngine(eng, prompt_slab=64, chunk=4)
    ce.start()
    try:
        sp = SamplingParams(n=1, temperature=0.0, max_tokens=6)
        prompts = ["moe scheduling", "expert routing request"]
        futs = [ce.submit(p, sp) for p in prompts]
        got = [f.result(timeout=WAIT).outputs[0].token_ids for f in futs]
        assert got == _jax_greedy(jcfg, jp, prompts, 6, max_model_len=128)
    finally:
        ce.stop()


def test_sliding_window_model_through_scheduler_with_compaction():
    """Banding survives compaction: the relocated decode columns continue
    the prompt's positions, so slot == position holds for the prefix."""
    _compaction_case(*_pair(9, sliding_window=6))


def test_gemma_style_mixed_window_model_through_scheduler():
    """Alternating sliding/full layers, sandwich norms, softcaps, GeGLU."""
    _compaction_case(*_pair(12, layer_windows=(6, 0), sandwich_norms=True,
                            hidden_act="gelu_pytorch_tanh", embed_normalizer=True,
                            query_pre_attn_scalar=24.0, attn_softcap=50.0,
                            final_softcap=30.0))


def test_deepseek_mla_through_scheduler():
    """MLA's latent cache (MQA-shaped) through the scheduler with mid-wave
    admission and compaction, greedy equal to JAX's sync engine."""
    from lapha_tpu.models import deepseek as jd
    from lapha_tpu_torch.models import deepseek as td

    dims = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
                num_attention_heads=4, q_lora_rank=24, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
                moe_intermediate_size=24, n_shared_experts=1, first_k_dense_replace=1,
                scoring_func="sigmoid", topk_method="noaux_tc", n_group=4, topk_group=2,
                norm_topk_prob=True)
    jcfg = jd.DeepseekConfig(**dims, dtype=jnp.float32)
    jp = jax.jit(jd.init_params, static_argnums=0)(jcfg, jax.random.key(14))
    tp = loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    _compaction_case(jcfg, jp, td.DeepseekConfig(**dims, dtype=torch.float32), tp)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_sink_model_through_scheduler(kv_quant):
    """A GPT-OSS-style model (sinks, a 16-token window layer, MoE): the
    decode's sink entries run under the scheduler (K5s's plain path with
    int8 KV), with compaction; greedy equal to JAX's sync engine."""
    gp = dict(vocab_size=V, intermediate_size=32, head_dim=16, layer_windows=(16, 0),
              num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
              tie_word_embeddings=False, attn_sinks=True, o_proj_bias=True,
              moe_style="gptoss", rms_norm_eps=1e-5)
    jcfg, tcfg = JCfg.tiny(**gp), qwen2.Qwen2Config.tiny(**gp)
    tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                  qwen2.init_params(tcfg, torch.Generator().manual_seed(3)))
    a = tree["layers"]["attn"]
    a["sinks"] = (np.random.default_rng(30).normal(size=a["sinks"].shape) * 2.0).astype(
        np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = loader.params_from_numpy(tree)
    tok = IdTok()
    eng = Engine(tp, tcfg, tok, **dict(KW, kv_quant=kv_quant))
    ce = ContinuousEngine(eng, prompt_slab=32, chunk=4)
    ce.start()
    try:
        a_, b_ = "5 9 77 4 21 8 " * 3, "3 250 7"
        outA, outB = _long_then_late(ce, SamplingParams(n=1, temperature=0.0, max_tokens=60),
                                     SamplingParams(n=1, temperature=0.0, max_tokens=40),
                                     a_, b_)
        assert ce.compactions >= 1
        ref = _jax_greedy(jcfg, jp, [a_, b_], 60, tok, kv_quant=kv_quant)
        assert outA.outputs[0].token_ids == ref[0]
        assert outB.outputs[0].token_ids == ref[1][:40]
    finally:
        ce.stop()


def _skewed(params, cfg):
    """12 prompts and an EOS set that stops about half the greedy streams
    early, ordered so every wave of 4 holds one long row."""
    rng = np.random.default_rng(5)
    prompts = ["".join(chr(97 + c) for c in rng.integers(0, 26, 12)) for _ in range(12)]
    probe = Engine(params, cfg, ByteTok(), **dict(KW, max_model_len=128, decode_chunk=8))
    sp0 = SamplingParams(n=1, temperature=0.0, max_tokens=32)
    streams = [r.outputs[0].token_ids for r in probe.generate(prompts, sp0)]

    def lengths_for(eos_set):
        return [next((i + 1 for i, t in enumerate(s) if t in eos_set), len(s))
                for s in streams]

    eos_set: set = set()
    for s in streams:
        if sum(n < 32 for n in lengths_for(eos_set)) >= 8:
            break
        eos_set.add(s[7])
    L = lengths_for(eos_set)
    by_len = sorted(range(12), key=lambda i: -L[i])
    order = []
    for w in range(3):
        order.append(by_len[w])
        order.extend(by_len[3:][w * 3:w * 3 + 3])
    return [prompts[i] for i in order], sorted(eos_set), sp0


def test_auto_continuous_overlaps_waves():
    """Engine(auto_continuous=True): a batch larger than one wave goes
    through the scheduler and takes fewer decode steps than the sum of the
    per-wave maxima; greedy answers equal the sync engine's."""
    _, _, tcfg, tp = _pair(9)
    prompts, eos, sp0 = _skewed(tp, tcfg)
    kw = dict(KW, max_model_len=128, decode_chunk=8, eos_token_ids=eos)
    eng = Engine(tp, tcfg, ByteTok(), auto_continuous=True, **kw)
    try:
        outs = eng.generate(prompts, sp0)
        assert eng._auto_sched is not None, "batch did not route to the scheduler"
        d_cont = eng._auto_sched.steps_executed
        lengths = [len(r.outputs[0].token_ids) for r in outs]
        assert len(set(lengths)) > 1, f"need skewed lengths, got {lengths}"
        d_sync = sum(max(lengths[lo:lo + 4]) for lo in range(0, 12, 4))
        assert d_cont < d_sync, (d_cont, d_sync, lengths)
        ref = Engine(tp, tcfg, ByteTok(), **kw)
        for r, o in zip(ref.generate(prompts, sp0), outs):
            assert r.outputs[0].token_ids == o.outputs[0].token_ids
        # small batches stay on the sync path
        before = eng._auto_sched.steps_executed
        eng.generate(prompts[:2], sp0)
        assert eng._auto_sched.steps_executed == before
    finally:
        eng._auto_sched.stop()


def test_auto_continuous_falls_back_when_semantics_would_change():
    """n beyond the scheduler's rows, a budget beyond its decode region and
    a prompt beyond its slab take the waves instead."""
    _, _, tcfg, tp = _pair(9)
    eng = Engine(tp, tcfg, ByteTok(), auto_continuous=True, **dict(KW, decode_chunk=8))
    try:
        prompts = [f"pp {i}" for i in range(6)]
        outs = eng.generate(prompts[:2], SamplingParams(n=8, temperature=0.0, max_tokens=4))
        assert all(len(r.outputs) == 8 for r in outs)
        outs = eng.generate(prompts, SamplingParams(n=1, temperature=0.0, max_tokens=80))
        assert [len(r.outputs[0].token_ids) for r in outs] == [80] * 6
        assert eng._auto_sched.steps_executed == 0
        # a prompt longer than the slab (48): waves, untruncated
        long = "x" * 60
        ref = Engine(tp, tcfg, ByteTok(), **dict(KW, decode_chunk=8))
        sp = SamplingParams(n=1, temperature=0.0, max_tokens=4)
        outs = eng.generate([long] + prompts, sp)
        assert eng._auto_sched.steps_executed == 0
        assert outs[0].prompt_token_ids == ByteTok()(long)["input_ids"]
        assert [r.outputs[0].token_ids for r in outs] == [
            r.outputs[0].token_ids for r in ref.generate([long] + prompts, sp)]
    finally:
        eng._auto_sched.stop()


@pytest.mark.parametrize("where", ["engine._decode_impl", "engine._prefill_rows",
                                   "scheduler._init_state"])
def test_scheduler_failure_resolves_futures(where):
    """An exception in the scheduler's device work, in a chunk, in an
    admission's prefill (before the request holds rows) or in setting up
    the batch state, fails the requests it concerns (their futures raise),
    and the scheduler serves the next."""
    _, _, tcfg, tp = _pair(3)
    eng = Engine(tp, tcfg, ByteTok(), **KW)
    ce = ContinuousEngine(eng, prompt_slab=32, chunk=4)
    obj, name = (eng if where.startswith("engine") else ce), where.split(".")[1]
    ce.start()
    try:
        setattr(obj, name, lambda *a, **k: (_ for _ in ()).throw(RuntimeError("planted")))
        fut = ce.submit("boom", SamplingParams(n=2, temperature=0.0, max_tokens=4))
        with pytest.raises(RuntimeError, match="planted"):
            fut.result(timeout=WAIT)
        delattr(obj, name)
        out = ce.submit("fine", SamplingParams(n=1, temperature=0.0, max_tokens=4))
        assert len(out.result(timeout=WAIT).outputs[0].token_ids) == 4
    finally:
        obj.__dict__.pop(name, None)
        ce.stop()


def test_cuda_library_builds_once_from_two_threads(monkeypatch):
    """ops._cuda.lib() builds under a lock: threads that launch first (16,
    more than the cores, switching every microsecond) build and load the
    library once (the build and the loader stubbed)."""
    import sys

    from lapha_tpu_torch.ops import _cuda

    n = 16
    calls, gate = [], threading.Barrier(n)

    def build():
        calls.append(threading.get_ident())
        time.sleep(0.2)  # the other thread arrives while this one builds
        return "stub.so"

    class FakeDll:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = type("Entry", (), {})()
            self.__dict__[name] = fn
            return fn

    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "build", build)
    monkeypatch.setattr(_cuda.ctypes, "CDLL", FakeDll)
    got = []

    def first_launch():
        gate.wait()
        got.append(_cuda.lib())

    ts = [threading.Thread(target=first_launch) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert len(calls) == 1 and len(got) == n and all(g is got[0] for g in got)
