"""Speculative decoding in lapha_tpu_torch against lapha_tpu (CPU, f32): the
pieces. The same numpy-made inputs go through both packages, the JAX side
jitted:

- ``spec.ngram_propose`` and ``spec.scatter_emit`` equal JAX's exactly;
  ``pick_with_draft``'s greedy rows give JAX's token and its logprob to
  1e-5; its sampled rows keep each position's marginal (JAX's statistical
  test: the random streams differ, so tokens are not compared there).
- ``qwen2.decode_step_multi`` on one cache with holes and ``deepseek.
  decode_step_multi`` on one latent cache: logits, hidden and the written
  cache columns to 1e-4 at T = 1 and 4, int8 cache bytes equal and their
  scales to f32 ulps, over the families the port loads (windows by
  position, sinks, softcap and sandwich norms, dual rope and q/k norms, a
  GQA group of 12).
- The verify kernel's wrapper up to its C call (a recorded stand-in
  library): the entry, the argument order and one count.

The engine and the entries are in ``tests/test_torch_spec_engine.py``.
"""

import itertools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.engine import spec as jspec
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import deepseek as jd
from lapha_tpu.models import qwen2 as jq
from lapha_tpu_torch.engine import sampling, spec
from lapha_tpu_torch.models import deepseek as td
from lapha_tpu_torch.models import loader, qwen2

from test_torch_deepseek import _pair
from verify_smem import PIECE, WARPS
from verify_smem import FakeLib as _FakeLib
from verify_smem import kernel_smem as _kernel_smem

V = 300


def _qwen_pair(seed=7, **kw):
    jcfg = JCfg.tiny(vocab_size=V, **kw)
    jp = jax.jit(jq.init_params, static_argnums=0)(jcfg, jax.random.key(seed))
    if kw.get("attn_sinks"):  # zero-init sinks would hide a head mix-up
        s = jp["layers"]["attn"]["sinks"]
        jp["layers"]["attn"]["sinks"] = jnp.asarray(
            np.random.default_rng(seed).normal(size=s.shape), s.dtype)
    return (jcfg, jp, qwen2.Qwen2Config.tiny(vocab_size=V, **kw),
            loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))


# ---------------------------------------------------------------- spec.py

@pytest.mark.parametrize("B,H,K,M", [(3, 40, 3, 2), (4, 64, 4, 3), (2, 17, 2, 1), (5, 33, 7, 2)])
def test_ngram_propose_matches_jax(B, H, K, M):
    rng = np.random.default_rng(B * 100 + H)
    # a small alphabet, so that n-grams repeat; cur from 0 (nothing) to H
    seq = rng.integers(2, 6, (B, H)).astype(np.int32)
    cur = rng.integers(0, H + 1, B).astype(np.int32)
    cur[0] = H
    jd_, jl = jax.jit(jspec.ngram_propose, static_argnums=(2, 3))(jnp.asarray(seq),
                                                                  jnp.asarray(cur), K, M)
    td_, tl = spec.ngram_propose(torch.from_numpy(seq).long(), torch.from_numpy(cur), K, M)
    np.testing.assert_array_equal(td_.numpy(), np.asarray(jd_))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(tl.sum()) > 0  # some row found a match


@pytest.mark.parametrize("B,T,W", [(3, 10, 4), (4, 6, 3), (2, 5, 1)])
def test_scatter_emit_matches_jax(B, T, W):
    rng = np.random.default_rng(T * 10 + W)
    buf = rng.integers(0, 50, (B, T)).astype(np.int32)
    em = rng.integers(0, T, B).astype(np.int32)
    em[0] = T - 1  # part of the window falls past the buffer
    toks = rng.integers(100, 200, (B, W)).astype(np.int32)
    mask = rng.random((B, W)) < 0.6
    emit = jax.jit(jspec.scatter_emit)
    want = np.asarray(emit(jnp.asarray(buf), jnp.asarray(em), jnp.asarray(toks),
                           jnp.asarray(mask)))
    got = spec.scatter_emit(torch.from_numpy(buf).long(), torch.from_numpy(em),
                            torch.from_numpy(toks), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    lps = rng.normal(size=(B, T)).astype(np.float32)
    vals = rng.normal(size=(B, W)).astype(np.float32)
    want = np.asarray(emit(jnp.asarray(lps), jnp.asarray(em), jnp.asarray(vals),
                           jnp.asarray(mask)))
    got = spec.scatter_emit(torch.from_numpy(lps), torch.from_numpy(em), torch.from_numpy(vals),
                            torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def _pick_kw(B, V_, temp, top_k=None, top_p=None, rep=1.2, presence=None):
    return dict(presence=presence, repetition_penalty=np.full(B, rep, np.float32),
                temperature=np.full(B, temp, np.float32),
                top_k=None if top_k is None else np.full(B, top_k, np.int32),
                top_p=None if top_p is None else np.full(B, top_p, np.float32), min_p=None)


def test_pick_with_draft_greedy_matches_jax():
    """Greedy rows: the penalised argmax and its logprob, with and without a
    draft (a draft never changes a greedy token)."""
    B, V_ = 6, 40
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(B, V_)) * 2).astype(np.float32)
    presence = (rng.random((B, V_)) < 0.3).astype(np.int8)
    draft = rng.integers(0, V_, B).astype(np.int32)
    has = np.array([True, False, True, True, False, True])
    kw = _pick_kw(B, V_, 0.0, top_k=8, top_p=0.9, presence=presence)
    pick = jax.jit(lambda lg, d, h, kw: jspec.pick_with_draft(
        lg, jax.random.key(0), d, h, static_top_k=0, approx_top_k=False, **kw))
    jt, jl = pick(jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(has),
                  {k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    tt, tl = spec.pick_with_draft(
        torch.from_numpy(logits), torch.Generator().manual_seed(0), torch.from_numpy(draft),
        torch.from_numpy(has), **{k: None if v is None else torch.from_numpy(v)
                                  for k, v in kw.items()})
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


def test_pick_with_draft_marginal_exact():
    """Delta-proposal rejection (JAX's test_pick_with_draft_marginal_exact):
    with the likely token drafted, the empirical marginal of 20000 draws
    equals the no-draft distribution, the processed softmax."""
    V_, N = 24, 20000
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.normal(size=(1, V_)) * 2).astype(np.float32)).expand(N, V_)
    kw = {k: None if v is None else torch.from_numpy(v)
          for k, v in _pick_kw(N, V_, 1.0, top_k=8, top_p=0.95, rep=1.0).items()}
    kw["presence"] = torch.zeros((N, V_), dtype=torch.int8)
    draft = torch.full((N,), int(logits[0].argmax()))
    gen = torch.Generator().manual_seed(42)
    with_d = spec.pick_with_draft(logits, gen, draft, torch.ones(N, dtype=torch.bool), **kw)[0]
    no_d = spec.pick_with_draft(logits, gen, draft, torch.zeros(N, dtype=torch.bool), **kw)[0]
    f_with = np.bincount(with_d.numpy(), minlength=V_) / N
    f_no = np.bincount(no_d.numpy(), minlength=V_) / N
    np.testing.assert_allclose(f_with, f_no, atol=0.015)
    p = torch.softmax(sampling.process_logits(logits[:1], **kw | {"presence": None}), -1)[0]
    np.testing.assert_allclose(f_with, p.numpy(), atol=0.015)


# ---------------------------------------------------------------- decode_step_multi

MULTI_CONFIGS = {
    "qwen2": {},
    "qwen2_int8kv": {},
    "gptoss_windows_sinks": dict(layer_windows=(8, 0), attn_sinks=True, o_proj_bias=True),
    "gemma2_softcap_sandwich": dict(hidden_act="gelu_pytorch_tanh", sandwich_norms=True,
                                    embed_normalizer=True, query_pre_attn_scalar=24.0,
                                    attn_softcap=5.0, final_softcap=8.0, layer_windows=(8, 0)),
    "gemma3_dual_rope_qknorm": dict(hidden_act="gelu_pytorch_tanh", sandwich_norms=True,
                                    embed_normalizer=True, qk_norm=True, rope_local_theta=500.0,
                                    layer_windows=(8, 0)),
    "phi3_window": dict(sliding_window=8),
    "starcoder2_group12": dict(num_attention_heads=12, num_key_value_heads=1, hidden_size=96,
                               norm_style="layernorm", mlp_style="plain", o_proj_bias=True),
}


def _holey_cache(rng, B, L, nkv, dh, S, slot, T):
    """A decode cache with holes: prompts of 7-10 columns, decode columns
    [12, slot) with rejected drafts' holes, their position map, and the
    block's T positions after each row's tokens."""
    lens = rng.integers(7, 11, B)
    ar = np.arange(S)[None, :]
    dec = (ar >= 12) & (ar < slot)
    kept = rng.random((B, S)) < 0.6
    valid = (ar < lens[:, None]) | (dec & kept)
    before = np.cumsum(dec & kept, axis=1) - (dec & kept)
    pos_map = np.where(ar < 12, ar, lens[:, None] + before).astype(np.int32)
    positions = ((lens + (dec & kept).sum(1))[:, None] + np.arange(T)[None, :]).astype(np.int32)
    ck = (rng.normal(size=(L, B, nkv, S, dh)) * 0.5).astype(np.float32)
    cv = (rng.normal(size=(L, B, nkv, S, dh)) * 0.5).astype(np.float32)
    return valid, pos_map, positions, ck, cv


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("name", sorted(MULTI_CONFIGS))
def test_qwen2_decode_step_multi_matches_jax(name, T):
    jcfg, jp, tcfg, tp = _qwen_pair(11, **MULTI_CONFIGS[name])
    rng = np.random.default_rng(len(name) + T)
    B, S, slot = 3, 40, 30
    L, nkv, dh = tcfg.num_hidden_layers, tcfg.num_key_value_heads, tcfg.head_dim_
    valid, pos_map, positions, ck, cv = _holey_cache(rng, B, L, nkv, dh, S, slot, T)
    toks = rng.integers(2, V, (B, T)).astype(np.int32)
    q8 = name.endswith("int8kv")
    jargs = [jnp.asarray(a) for a in (toks, positions, ck, cv)]
    targs = [torch.from_numpy(a) for a in (toks, positions, ck, cv)]
    kw_j, kw_t = {}, {}
    if q8:
        kq, ks = jq._quantize_kv(jnp.asarray(ck))
        vq, vs = jq._quantize_kv(jnp.asarray(cv))
        jargs[2:] = [kq, vq]
        targs[2:] = [torch.from_numpy(np.array(kq)), torch.from_numpy(np.array(vq))]
        kw_j["cache_scale"] = (ks, vs)
        kw_t["cache_scale"] = (torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)))
    step = jax.jit(jq.decode_step_multi, static_argnums=(1,), static_argnames=("return_hidden",))
    want = step(jp, jcfg, *jargs, jnp.asarray(slot, jnp.int32), jnp.asarray(valid),
                return_hidden=True, pos_map=jnp.asarray(pos_map), **kw_j)
    got = qwen2.decode_step_multi(tp, tcfg, *targs, slot, torch.from_numpy(valid),
                                  return_hidden=True, pos_map=torch.from_numpy(pos_map), **kw_t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=1e-4)
    cols = slice(slot, slot + T)
    for g, w in zip(got[2:4], want[2:4]):
        w = np.asarray(w)
        if q8:  # the int8 columns bit for bit, and nothing else written
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy()[..., cols, :], w[..., cols, :], atol=1e-4,
                                       rtol=1e-4)
            np.testing.assert_array_equal(np.delete(g.numpy(), np.s_[slot:slot + T], axis=3),
                                          np.delete(w, np.s_[slot:slot + T], axis=3))
    if q8:  # a scale is amax/127 of K or V, which the two frameworks compute in f32 ulps apart
        for g, w in zip(got[4], want[4]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_deepseek_decode_step_multi_matches_jax(kv, T):
    jcfg, jp, tcfg, tp = _pair(0)
    rng = np.random.default_rng(T)
    B, S, slot = 3, 40, 30
    L, W = tcfg.num_hidden_layers, tcfg.cache_width_
    valid, pos_map, positions, ck, cv = _holey_cache(rng, B, L, 1, W, S, slot, T)
    toks = rng.integers(2, tcfg.vocab_size, (B, T)).astype(np.int32)
    jargs = [jnp.asarray(a) for a in (toks, positions, ck, cv)]
    targs = [torch.from_numpy(a) for a in (toks, positions, ck, cv)]
    kw_j, kw_t = {}, {}
    if kv == "int8":
        kq, ks = jq._quantize_kv(jnp.asarray(ck))
        jargs[2] = kq
        targs[2] = torch.from_numpy(np.array(kq))
        vs = jnp.ones_like(ks)
        kw_j["cache_scale"] = (ks, vs)
        kw_t["cache_scale"] = (torch.from_numpy(np.array(ks)), torch.from_numpy(np.array(vs)))
    step = jax.jit(jd.decode_step_multi, static_argnums=(1,), static_argnames=("return_hidden",))
    want = step(jp, jcfg, *jargs, jnp.asarray(slot, jnp.int32), jnp.asarray(valid),
                return_hidden=True, pos_map=jnp.asarray(pos_map), **kw_j)
    got = td.decode_step_multi(tp, tcfg, *targs, slot, torch.from_numpy(valid),
                               return_hidden=True, pos_map=torch.from_numpy(pos_map), **kw_t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-4, rtol=1e-4)
    if kv == "int8":
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[4][0].numpy(), np.asarray(want[4][0]), rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- the verify wrapper's host path

@pytest.mark.parametrize("int8,sinks,softcap,window", [(False, False, 0.0, 0), (True, False, 0.0, 0),
                                                       (False, True, 0.0, 128), (True, True, 0.0, 128),
                                                       (False, False, 50.0, 0)])
def test_verify_wrapper_calls_its_entry(monkeypatch, int8, sinks, softcap, window):
    """The CUDA path up to the C call, on CPU tensors with the device checks
    stubbed: the entry of the cache kind and sinks, called once with its
    pointers (pos_map only for a windowed layer), then layer, slot, T,
    window, out, B nh nkv S dh, scale, softcap, ``verify_plan``'s qtiles,
    splits and stages, and the stream (the C entries' and ``_cuda.lib``'s
    argument order), counted once under its name."""
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    fake = _FakeLib()
    for stub in ("require_cuda_bf16", "require_cuda"):
        monkeypatch.setattr(_cuda, stub, lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 7)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: SMS)
    B, T, nh, nkv, dh, S, slot = 24, 4, 12, 2, 128, 1152, 1100
    q = torch.zeros(B, T, nh, dh, dtype=torch.bfloat16)
    kc = torch.zeros(2, B, nkv, S, dh, dtype=torch.int8 if int8 else torch.bfloat16)
    scl = (torch.ones(2, B, nkv, S), torch.ones(2, B, nkv, S)) if int8 else None
    valid = torch.zeros(B, S, dtype=torch.bool)
    pos = torch.zeros(B, T, dtype=torch.int64)
    pos_map = torch.zeros(B, S, dtype=torch.int64)
    before = dict(_cuda.LAUNCHES)
    out = sva._verify_cuda(q, kc, kc, 1, slot, valid, pos, pos_map, window, 0.125, scl,
                           torch.zeros(nh) if sinks else None, softcap)
    assert out.shape == (B, T, nh, dh)
    (entry, args), = fake.calls
    name = sva.launch_name(int8, sinks, 0.0)
    assert entry == sva._ENTRIES[name]
    ptrs = 6 + 2 * int8 + int(sinks)
    assert len(args) == ptrs + 16
    assert (args[ptrs - 1 - int(sinks)] is None) == (window == 0)  # pos_map
    assert args[ptrs:ptrs + 4] == (1, slot, T, window)
    assert args[ptrs + 5:ptrs + 10] == (B, nh, nkv, S, dh)
    assert args[ptrs + 10:ptrs + 12] == (0.125, softcap)
    plan = sva.verify_plan(B, nkv, nh // nkv, T, S, SMS, dh=dh, int8=int8, smem=_kernel_smem,
                           window=window)
    assert args[-4:] == (*plan, 7)
    counted = sva.launch_name(int8, sinks, softcap)
    assert {k: v - before[k] for k, v in _cuda.LAUNCHES.items() if v != before[k]} == {counted: 1}


# ---------------------------------------------------------------- the verify kernel's plan and split

SMS = 132               # an H100 SXM's SMs
CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                  "lapha_tpu_torch", "csrc", "spec_verify_attention.cuh")
# (nkv, group, dh) of phase 1m's five models: Qwen2.5, GPT-OSS, Gemma-2, Phi-3, StarCoder2
PLAN_MODELS = ((2, 6, 128), (8, 8, 64), (4, 2, 256), (32, 1, 96), (2, 12, 128))


def _plan(*args, **kw):
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    return sva.verify_plan(*args, smem=_kernel_smem, **kw)


def _cu_const(name: str) -> int:
    import re

    with open(CU) as f:
        m = re.search(rf"constexpr int {name} = ([0-9 *]+);", f.read())
    return eval(m.group(1))  # noqa: S307 (a product of literals from the source)


def test_verify_plan_constants_match_the_kernel():
    """The host's copies of the kernel's constants, and one instance a
    (head dim, n8 tiles) pair the plan can give."""
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    assert (_cu_const("PIECE"), _cu_const("NW"), _cu_const("MAX_SPLITS"),
            _cu_const("MAX_STAGES"), _cu_const("SMEM_LIMIT")) == (
        sva.PIECE, sva.CHUNK // sva.PIECE, sva.MAX_SPLITS, sva.MAX_STAGES, sva.SMEM_LIMIT)
    with open(CU) as f:
        src = f.read()
    for dh, rows in sva.MAX_ROWS.items():
        for ntw in (1, 2, 3, 4):
            assert (f"LAPHA_SV({dh}, {ntw})" in src) == (8 * ntw <= rows), (dh, ntw)


@pytest.mark.parametrize("nkv,group,dh", PLAN_MODELS)
@pytest.mark.parametrize("int8,window", [(False, 0), (True, 0), (False, 128)])
def test_verify_plan_bounds(nkv, group, dh, int8, window):
    """At B 1-64, T 1-8 and caches of 64 to 32768 columns: splits a power of
    two up to 8 and no more than the live columns have 64-column chunks
    (unless the list needs them to fit), 1-4 stages, one split where the
    CTAs already fill the card, query rows a CTA within the instance's, no
    empty query tile, and the CTA's shared memory within 227 KB."""
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    for B, T, S in itertools.product((1, 4, 8, 24, 64), (1, 2, 4, 8), (64, 1152, 32768)):
        plan = _plan(B, nkv, group, T, S, SMS, dh=dh, int8=int8, window=window)
        assert plan.splits in (1, 2, 4, 8) and 1 <= plan.stages <= sva.MAX_STAGES
        rows = sva.cta_rows(group, T, plan.qtiles)
        assert math.ceil(group * T / plan.qtiles) <= rows <= sva.MAX_ROWS[dh]
        assert (plan.qtiles - 1) * math.ceil(group * T / plan.qtiles) < group * T
        assert _kernel_smem(dh, int8, rows, S, plan.stages, plan.splits) <= 227 * 1024
        if _kernel_smem(dh, int8, rows, S, plan.stages, 1) <= 227 * 1024:
            live = min(S, window + T) if window else S
            assert plan.splits <= max(1, math.ceil(live / 64)), (B, T, S)
            if B * nkv * plan.qtiles >= SMS:
                assert plan.splits == 1, (B, T, S)


@pytest.mark.parametrize("B,nkv,group,T,dh,int8,window,plan", [
    (24, 2, 6, 1, 128, False, 0, (1, 4, 2)),      # Qwen2.5 at T = 1: 48 CTAs, two an SM
    (24, 2, 6, 4, 128, False, 0, (1, 4, 2)),      # 24 rows: one CTA a KV head
    (24, 2, 12, 4, 128, False, 4096, (2, 2, 2)),  # StarCoder2's 48 rows: two
    (24, 8, 8, 4, 64, True, 128, (1, 1, 2)),      # GPT-OSS: 192 CTAs fill the card
    (4, 8, 8, 1, 64, False, 128, (1, 2, 2)),      # a window of 128: 3 chunks live at most
    (24, 32, 1, 4, 96, False, 2047, (1, 1, 2)),   # Phi-3: 768
    (24, 4, 2, 4, 256, False, 0, (1, 1, 2)),      # Gemma-2: one 150 KB CTA an SM
    (8, 4, 2, 1, 256, False, 0, (1, 4, 1)),       # one stage: two CTAs an SM
    (4, 4, 2, 1, 256, False, 0, (1, 8, 1)),
    (1, 2, 6, 4, 128, False, 0, (1, 8, 2)),       # one row
])
def test_verify_plan_at_the_served_shapes(B, nkv, group, T, dh, int8, window, plan):
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    assert tuple(_plan(B, nkv, group, T, 1152, SMS, dh=dh, int8=int8, window=window)) == plan


def test_verify_plan_refuses_what_it_cannot_hold():
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    for bad in ((0, 2, 6, 4, 1152), (24, 2, 6, 0, 1152), (24, 2, 6, 4, 0)):
        with pytest.raises(ValueError):
            _plan(*bad, SMS, dh=128, int8=False)
    with pytest.raises(ValueError):
        _plan(24, 2, 6, 4, 1152, SMS, dh=80, int8=False)
    with pytest.raises(ValueError):
        _plan(24, 2, 6, 4, 1152, SMS, dh=128, int8=False, window=-1)
    with pytest.raises(ValueError):  # a list of 10^6 columns fits no 8 CTAs
        _plan(1, 1, 1, 1, 10 ** 6, SMS, dh=256, int8=False)
    with pytest.raises(ValueError):  # an instance the kernel does not have
        sva.verify_plan(24, 2, 6, 4, 1152, SMS, dh=128, int8=False, smem=lambda *a: -1)


def test_verify_plan_independent_of_slot(monkeypatch):
    """The wrapper's plan arguments are the same whatever the slot and the
    maps (a captured launch keeps them)."""
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    fake = _FakeLib()
    for stub in ("require_cuda_bf16", "require_cuda"):
        monkeypatch.setattr(_cuda, stub, lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 7)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: SMS)
    B, T, nh, nkv, dh, S = 4, 4, 12, 2, 128, 1152
    q = torch.zeros(B, T, nh, dh, dtype=torch.bfloat16)
    kc = torch.zeros(2, B, nkv, S, dh, dtype=torch.bfloat16)
    pos = torch.zeros(B, T, dtype=torch.int32)
    for slot, density in ((0, 0.0), (600, 0.5), (S - T, 1.0)):
        valid = torch.rand(B, S) < density
        sva._verify_cuda(q, kc, kc, 1, slot, valid, pos, None, 0, 0.125, None, None, 0.0)
    assert len({args[-4:-1] for _, args in fake.calls}) == 1


def _live_entries(valid, positions, pos_map, slot: int, T: int, window: int):
    """The kernel's list of row b's live columns, in column order: (column,
    the first query t that sees it, its position). Live: a new column, or a
    valid one inside the window of the block's earliest query."""
    out = []
    wmin = int(positions.min()) - window
    for j in range(valid.shape[0]):
        c = j - slot
        fresh = 0 <= c < T
        pos = int(positions[c]) if fresh else (int(pos_map[j]) if window > 0 else 0)
        if fresh or (valid[j] and (window <= 0 or pos > wmin)):
            out.append((j, c if fresh and not valid[j] else 0, pos))
    return out


def _partial(s, v):
    """(m, l, acc) of logits s (n, R) over values v (n, R, dh) (the V scale
    already in v), masked logits at NEG; an empty set is (NEG, 0, 0)."""
    R, dh = s.shape[1], v.shape[-1]
    if s.shape[0] == 0:
        return torch.full((R,), NEG), torch.zeros(R), torch.zeros(R, dh)
    m = s.amax(0)
    p = torch.where(s > 0.5 * NEG, torch.exp(s - m), torch.zeros(()))
    return m, p.sum(0), torch.einsum("nr,nrd->rd", p, v)


def _merge(parts, sink=None):
    """Merge (m, l, acc) partials in order; the sink column joins once."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    if sink is not None:
        M = torch.maximum(M, sink)
    w = [torch.exp(m - M) for m, _, _ in parts]
    l_ = sum(l * f for (_, l, _), f in zip(parts, w))
    acc = sum(a * f[:, None] for (_, _, a), f in zip(parts, w))
    if sink is not None:
        l_ = l_ + torch.exp(sink - M)
    return M, l_, acc


NEG = -1e30


def verify_split_reference(q, kc, vc, layer, slot, valid, positions, pos_map, window, scale,
                           splits, qtiles=1, *, cache_scale=None, sinks=None, softcap=0.0,
                           fault=""):
    """The kernel's algorithm in f32 torch ops; the arguments and result of
    ``spec_verify_plain`` but ``splits`` (CTAs a row's live columns) and
    ``qtiles`` (CTAs a KV head's group·T query rows). Each CTA takes its
    share [n·r/splits, n·(r+1)/splits) of the row's live list, deals its
    16-column pieces to 4 warps in turn, keeps a partial per warp, merges
    the warps, then the ranks in order, and adds the sink once. ``fault``
    plants "sink_per_split" (the sink in every CTA's partial) or
    "drop_last_rank" (the last rank's partial left out of the merge)."""
    B, T, nh, dh = q.shape
    nkv = kc.shape[2]
    G = nh // nkv
    per_tile = math.ceil(G * T / qtiles)
    out = torch.zeros(B, T, nh, dh)
    for b in range(B):
        ents = _live_entries(valid[b], positions[b], pos_map[b] if window else None, slot, T,
                             window)
        n = len(ents)
        cols = torch.tensor([e[0] for e in ents], dtype=torch.long)
        first = torch.tensor([e[1] for e in ents])
        cpos = torch.tensor([e[2] for e in ents])
        for hk in range(nkv):
            k, v = kc[layer, b, hk].float(), vc[layer, b, hk].float()
            for qt in range(qtiles):
                rows = range(qt * per_tile, min(G * T, (qt + 1) * per_tile))
                ts = torch.tensor([r // G for r in rows])
                hs = [hk * G + r % G for r in rows]
                qr = torch.stack([q[b, r // G, hk * G + r % G].float() for r in rows])  # (R, dh)
                s = (k[cols] @ qr.T) * scale                                          # (n, R)
                vv = v[cols][:, None, :].expand(n, len(rows), dh)
                if cache_scale is not None:
                    s = s * cache_scale[0][layer, b, hk][cols][:, None]
                    vv = vv * cache_scale[1][layer, b, hk][cols][:, None, None]
                if softcap:
                    s = softcap * torch.tanh(s / softcap)
                ok = first[:, None] <= ts[None, :]
                if window:
                    ok = ok & (cpos[:, None] > positions[b, ts][None, :] - window)
                s = torch.where(ok, s, torch.full((), NEG))
                sink = None if sinks is None else sinks[hs].float()
                ctas = []
                for r in range(splits):
                    lo, hi = n * r // splits, n * (r + 1) // splits
                    pieces = [np.arange(lo + PIECE * j, min(lo + PIECE * (j + 1), hi))
                              for j in range((hi - lo + PIECE - 1) // PIECE)]
                    warps = []
                    for w in range(WARPS):
                        mine = torch.from_numpy(np.concatenate(pieces[w::WARPS] or [[]])).long()
                        warps.append(_partial(s[mine], vv[mine]))
                    ctas.append(_merge(warps, sink if fault == "sink_per_split" else None))
                if fault == "drop_last_rank" and splits > 1:
                    ctas = ctas[:-1]
                _, l_, acc = _merge(ctas, None if fault == "sink_per_split" else sink)
                o = torch.where(l_[:, None] > 0, acc / l_[:, None], torch.zeros(()))
                for i, r in enumerate(rows):
                    out[b, r // G, hk * G + r % G] = o[i]
    return out


def _verify_inputs(int8, sinks, window, T, seed=5):
    """Four rows of a 96-column cache at slot 80 with holes: a prompt and
    decode columns; a row whose only live columns are the block's new ones;
    a row with no hole; a row with the new column slot valid (it is seen by
    every query)."""
    from lapha_tpu_torch.models.qwen2 import _quantize_kv

    rng = np.random.default_rng(seed)
    B, S, slot, nh, nkv, dh = 4, 96, 80, 6, 2, 16
    valid, pos_map, positions, ck, cv = _holey_cache(rng, B, 2, nkv, dh, S, slot, T)
    valid[1] = False
    valid[2, :slot] = True
    valid[3, slot] = True
    q = torch.from_numpy(rng.normal(size=(B, T, nh, dh)).astype(np.float32))
    kc, vc = torch.from_numpy(ck), torch.from_numpy(cv)
    scl = None
    if int8:
        (kc, ks), (vc, vs) = _quantize_kv(kc), _quantize_kv(vc)
        scl = (ks, vs)
    sk = (torch.from_numpy(rng.normal(size=nh).astype(np.float32))
          + torch.tensor([8.0, -8.0] * (nh // 2))) if sinks else None
    return (q, kc, vc, 1, slot, torch.from_numpy(valid), torch.from_numpy(positions),
            torch.from_numpy(pos_map), window, dh ** -0.5), dict(cache_scale=scl, sinks=sk)


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("int8,sinks,window,softcap,T,qtiles", [
    (False, False, 0, 0.0, 1, 1), (False, False, 0, 0.0, 4, 2), (True, False, 0, 0.0, 4, 1),
    (False, True, 6, 0.0, 4, 1), (True, True, 6, 0.0, 1, 1), (False, False, 0, 2.0, 3, 3)])
def test_verify_split_matches_plain(splits, int8, sinks, window, softcap, T, qtiles):
    """The kernel's split of the live columns, and of the query rows, gives
    the plain version's result (to f32 order of sums), and dropping the
    last rank's partial or counting the sink in every split does not."""
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    args, kw = _verify_inputs(int8, sinks, window, T)
    plain = sva.spec_verify_plain(*args, softcap=softcap, **kw).float()
    got = verify_split_reference(*args, splits, qtiles, softcap=softcap, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)
    def rel(bad):  # the largest error of a (row, query, head) output, relative to its norm
        return float(((bad - plain).norm(dim=-1) / plain.norm(dim=-1).clamp(min=1e-6)).max())

    if splits > 1:
        assert rel(verify_split_reference(*args, splits, qtiles, softcap=softcap,
                                          fault="drop_last_rank", **kw)) > 0.05
        if sinks:
            assert rel(verify_split_reference(*args, splits, qtiles, softcap=softcap,
                                              fault="sink_per_split", **kw)) > 0.05


def test_verify_live_list_skips_what_no_query_sees():
    """The list holds the new columns and the valid ones in the earliest
    query's window, nothing else: holes, padding, columns past the block and
    (windowed) columns out of every query's window are not read."""
    args, _ = _verify_inputs(False, False, 6, 4)
    _, _, _, _, slot, valid, positions, pos_map, window, _ = args
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    vis = sva.verify_visible(valid, positions, slot, pos_map, window)
    for b in range(valid.shape[0]):
        cols = [e[0] for e in _live_entries(valid[b], positions[b], pos_map[b], slot, 4, window)]
        seen = torch.nonzero(vis[b].any(0)).flatten().tolist()
        assert set(seen) <= set(cols)
        assert set(cols) - set(seen) <= set(range(slot, slot + 4))  # new columns always listed
    row1 = [e for e in _live_entries(valid[1], positions[1], pos_map[1], slot, 4, 0)]
    assert row1 == [(slot + c, c, int(positions[1, c])) for c in range(4)]
