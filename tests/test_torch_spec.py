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

class _FakeLib:
    """Records the C entry called and its arguments; returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("int8,sinks,softcap,window", [(False, False, 0.0, 0), (True, False, 0.0, 0),
                                                       (False, True, 0.0, 128), (True, True, 0.0, 128),
                                                       (False, False, 50.0, 0)])
def test_verify_wrapper_calls_its_entry(monkeypatch, int8, sinks, softcap, window):
    """The CUDA path up to the C call, on CPU tensors with the device checks
    stubbed: the entry of the cache kind and sinks, called once with its
    pointers (pos_map only for a windowed layer), then layer, slot, T,
    window, out, B nh nkv S dh, scale, softcap and the stream (the C
    entries' and ``_cuda.lib``'s argument order), counted once under its
    name."""
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    fake = _FakeLib()
    for stub in ("require_cuda_bf16", "require_cuda"):
        monkeypatch.setattr(_cuda, stub, lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 7)
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
    assert len(args) == ptrs + 13
    assert (args[ptrs - 1 - int(sinks)] is None) == (window == 0)  # pos_map
    assert args[ptrs:ptrs + 4] == (1, slot, T, window)
    assert args[ptrs + 5:ptrs + 10] == (B, nh, nkv, S, dh)
    assert args[-3:] == (0.125, softcap, 7)
    counted = sva.launch_name(int8, sinks, softcap)
    assert {k: v - before[k] for k, v in _cuda.LAUNCHES.items() if v != before[k]} == {counted: 1}
