"""lapha_tpu_torch's GPT-OSS serving path against lapha_tpu (CPU, f32, a
tiny gpt_oss config): the config from HF (GPT-OSS-20B's published dict),
YaRN rope, windowed attention with sinks (no-cache and cached, forward and
gradients), the sink entries of the ragged decode attention (bf16 and int8
caches, window-clipped ranges), the GPT-OSS MoE block, the model (logits,
decode_step, the windowed-short decode cache), the loader on a tiny HF
``GptOssForCausalLM`` checkpoint, greedy engine tokens and ValueFunction.

The tiny config: 2 layers with ``layer_windows=(16, 0)`` (sliding, then
full), H 64, 4/2 heads of dim 16, 4 experts top-2, YaRN rope; sinks,
q/k/v/o biases, router and expert biases random, written into both trees
from numpy. The JAX side runs as its own tests run it on the CPU: Pallas
kernels in interpret mode, the model's dense attention, jitted.

Tolerances: the attention plain versions within 1e-5 of the interpret-mode
kernels (the same f32 softmax summed in another order), the MoE block
within 1e-5, logits and hidden states within 1e-4 (as the dense model's
tests), gradients within 1e-4, YaRN cos/sin within 1e-5 (f32 angles of up
to 100 rad, scaled by 1.35), routing weights within 1e-6 with equal
expert ids, loaded leaves equal bit for bit, greedy token ids exactly equal.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GPTOSS_20B_CONFIG
from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import loader as jloader
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import flash_attention as jfa
from lapha_tpu.ops import moe as jmoe
from lapha_tpu.ops.ragged_decode_attention import ragged_decode_attention as j_ragged
from lapha_tpu.search.value_fn import ValueFunction as JValueFunction
from lapha_tpu_torch.engine import Engine, SamplingParams
from lapha_tpu_torch.models import loader, quant, qwen2
from lapha_tpu_torch.ops import flash_attention as tfa
from lapha_tpu_torch.ops import moe
from lapha_tpu_torch.ops.ragged_decode_attention import ragged_decode_plain
from lapha_tpu_torch.search import ValueFunction

ATOL = 1e-4
OP_ATOL = 1e-5
V = 300
YARN = {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
        "original_max_position_embeddings": 4096, "truncate": False}
GP = dict(vocab_size=V, hidden_size=64, intermediate_size=32, num_hidden_layers=2,
          num_attention_heads=4, num_key_value_heads=2, head_dim=16, layer_windows=(16, 0),
          num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
          tie_word_embeddings=False, attn_sinks=True, o_proj_bias=True, moe_style="gptoss",
          rms_norm_eps=1e-5, rope_theta=150000.0,
          rope_scaling=JCfg._parse_rope_scaling({"rope_scaling": YARN}))


class IdTok:
    """Prompts are space-separated token ids."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(t_out, j_out, atol):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=0)


def _jit(fn, **static):
    """A JAX function with its static arguments bound, compiled once."""
    return jax.jit(functools.partial(fn, **static))


def _assert_trees_equal(jtree, ttree, path=""):
    """Every leaf of the JAX tree equals the port's, dtype and value."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _assert_trees_equal(jtree[k], ttree[k], f"{path}/{k}")
        return
    a = np.asarray(jtree)
    if ttree.dtype == torch.bfloat16:  # compare the bit patterns
        assert a.dtype == jnp.bfloat16, (path, a.dtype)
        a, b = a.view(np.int16), ttree.view(torch.int16).numpy()
    else:
        b = ttree.numpy()
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=path)


@pytest.fixture(scope="module")
def tiny():
    """The tiny gpt_oss model, the same numpy tree on both sides: the port's
    init, then random sinks and biases (the init's are zero)."""
    jcfg, tcfg = JCfg.tiny(**GP), qwen2.Qwen2Config.tiny(**GP)
    tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                  qwen2.init_params(tcfg, torch.Generator().manual_seed(3)))
    rng = np.random.default_rng(30)
    a, m = tree["layers"]["attn"], tree["layers"]["moe"]
    a["sinks"] = (rng.normal(size=a["sinks"].shape) * 2.0).astype(np.float32)
    for leaf in (a["q_proj"], a["k_proj"], a["v_proj"], a["o_proj"], m["experts"]["gate_up"],
                 m["experts"]["down"]):
        leaf["b"] = (rng.normal(size=leaf["b"].shape) * 0.1).astype(np.float32)
    m["router"]["b"] = (rng.normal(size=m["router"]["b"].shape) * 0.5).astype(np.float32)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg, loader.params_from_numpy(tree)


# ---------------------------------------------------------------- config, rope

def test_from_hf_gptoss_20b_matches_jax():
    """GPT-OSS-20B's published config.json (chip_smoke's dict) parses to the
    JAX config's fields: alternating 128-token windows, YaRN x32, sinks,
    o_proj bias, 32 experts top-4 in the gptoss style."""
    j, t = JCfg.from_hf(GPTOSS_20B_CONFIG), qwen2.Qwen2Config.from_hf(GPTOSS_20B_CONFIG)
    for f in ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
              "num_attention_heads", "num_key_value_heads", "head_dim_", "max_position_embeddings",
              "rope_theta", "rope_scaling", "sliding_window", "layer_windows", "rms_norm_eps",
              "tie_word_embeddings", "attention_bias", "o_proj_bias", "attn_sinks", "num_experts",
              "num_experts_per_tok", "moe_intermediate_size", "moe_style", "max_window_",
              "attn_scale_"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.layer_windows == (128, 0) * 12 and t.head_dim_ == 64
    assert t.rope_scaling[0] == "yarn" and t.rope_scaling[-1] is False
    assert [t.window_for_layer(l) for l in range(24)] == [j.window_for_layer(l) for l in range(24)]
    with pytest.raises(ValueError, match="mutually exclusive"):
        qwen2.Qwen2Config.tiny(sliding_window=8, layer_windows=(8, 0))


@pytest.mark.parametrize("truncate", [True, False])
def test_rope_freqs_yarn_matches_jax(truncate):
    scaling = JCfg._parse_rope_scaling({"rope_scaling": dict(YARN, truncate=truncate)})
    assert scaling == qwen2.Qwen2Config._parse_rope_scaling(
        {"rope_scaling": dict(YARN, truncate=truncate)})
    pos = np.asarray([[0, 1, 2, 17, 100]])
    for dh in (16, 64):
        jc, js = jq.rope_freqs(jnp.asarray(pos), dh, 150000.0, scaling)
        tc, ts = qwen2.rope_freqs(_t(pos), dh, 150000.0, scaling)
        # the f32 angle of 100 rad is rounded to ~4e-6 rad (pow and cos/sin
        # differ between the libraries by about an ulp), times 1.35
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)


# ---------------------------------------------------------------- attention

def _qkv(rng, B, T, S, nh, nkv, dh):
    return (rng.normal(size=(B, T, nh, dh)).astype(np.float32),
            rng.normal(size=(B, S, nkv, dh)).astype(np.float32),
            rng.normal(size=(B, S, nkv, dh)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 16])
def test_flash_window_and_sinks_match_jax(window):
    """No-cache (padded rows) and cached (per-row qstart, a suffix prefill)
    attention with the window and the sinks, against the interpret-mode
    kernels with JAX's sink fold; rows with no key give 0 on both sides."""
    rng = np.random.default_rng(40 + window)
    B, T, nh, nkv, dh = 3, 40, 4, 2, 16
    q, k, v = _qkv(rng, B, T, T, nh, nkv, dh)
    sinks = (rng.normal(size=nh) * 2).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :9] = 0
    mask[2, 30:] = 0
    j_out = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                window=window, sinks=jnp.asarray(sinks), block_q=16, block_k=16,
                                interpret=True)
    t_out = tfa.flash_attention(_t(q), _t(k), _t(v), _t(mask), window=window, sinks=_t(sinks))
    _close(t_out, j_out, OP_ATOL)

    S, Tn = 72, 24
    q, k, v = _qkv(rng, B, Tn, S, nh, nkv, dh)
    qs = np.asarray([40, 0, 13], np.int32)
    kv_valid = (np.arange(S)[None, :] < (qs + Tn)[:, None]).astype(np.int32)
    kv_valid[2, 5:9] = 0
    j_out = jfa.flash_attention_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(kv_valid), jnp.asarray(qs), window=window,
                                       sinks=jnp.asarray(sinks), block_q=16, block_k=16,
                                       interpret=True)
    t_out = tfa.flash_attention_cached(_t(q), _t(k), _t(v), _t(kv_valid), _t(qs), window=window,
                                       sinks=_t(sinks))
    _close(t_out, j_out, OP_ATOL)
    # the plain version alone: a row that sees no key is 0 with its mass on the sink
    out, lse = tfa.attention_plain(_t(q), _t(k), _t(v), torch.zeros(B, S, dtype=torch.int32),
                                   _t(qs), 0.25, window, _t(sinks))
    assert not out.any() and torch.equal(lse, _t(sinks)[None, :, None].expand(B, nh, Tn))


@pytest.mark.parametrize("window", [0, 16])
def test_flash_sink_gradients_match_jax(window):
    """dq, dk, dv and dsink through the sink fold (the plain backward on the
    CPU) against jax.grad of the Pallas custom_vjp in interpret mode."""
    rng = np.random.default_rng(50 + window)
    B, T, nh, nkv, dh = 2, 36, 4, 2, 16
    q, k, v = _qkv(rng, B, T, T, nh, nkv, dh)
    sinks = (rng.normal(size=nh) * 2).astype(np.float32)
    do = rng.normal(size=(B, T, nh, dh)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :5] = 0

    def jloss(q_, k_, v_, s_):
        out = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), window=window, sinks=s_,
                                  block_q=16, block_k=16, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, sinks)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v, sinks)]
    out = tfa.flash_attention(*leaves[:3], _t(mask), window=window, sinks=leaves[3])
    tg = torch.autograd.grad(out, leaves, _t(do))
    for name, a, b in zip(("dq", "dk", "dv", "dsink"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("int8", [False, True])
def test_ragged_decode_sinks_match_jax(int8):
    """The sink entries (bf16 and int8 caches) over window-clipped ranges:
    pstart = clip(positions - W + 1, 0, lens) (one row's window past its
    whole prompt) and dstart' = max(dstart, slot - W + 1)."""
    rng = np.random.default_rng(60 + int8)
    L, B, nkv, S, nh, dh, W, slot = 2, 4, 2, 96, 4, 16, 16, 70
    q = rng.normal(size=(B, nh, dh)).astype(np.float32)
    k = rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32)
    v = rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32)
    sinks = (rng.normal(size=nh) * 2).astype(np.float32)
    lens = np.asarray([40, 64, 10, 33], np.int32)
    dstart = np.full(B, 64, np.int32)
    positions = lens + (slot - 64)
    pstart = np.clip(positions - W + 1, 0, lens).astype(np.int32)
    dstart_w = np.maximum(dstart, slot - W + 1).astype(np.int32)
    scl = None
    if int8:
        kq, ks = qwen2._quantize_kv(_t(k))
        vq, vs = qwen2._quantize_kv(_t(v))
        k, v, scl = kq.numpy(), vq.numpy(), (ks.numpy(), vs.numpy())
    for ps, ds in ((None, dstart), (pstart, dstart_w)):
        for layer in range(L):
            j_out = j_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer,
                             jnp.asarray(lens), jnp.asarray(ds), jnp.asarray(slot, jnp.int32),
                             cache_scale=None if scl is None else tuple(map(jnp.asarray, scl)),
                             pstart=None if ps is None else jnp.asarray(ps),
                             sinks=jnp.asarray(sinks), block_k=32, block_rows=2, interpret=True)
            t_out = ragged_decode_plain(_t(q), _t(k), _t(v), layer, _t(lens), _t(ds), slot,
                                        None if ps is None else _t(ps),
                                        cache_scale=None if scl is None else tuple(map(_t, scl)),
                                        sinks=_t(sinks))
            _close(t_out, j_out, OP_ATOL)


# ---------------------------------------------------------------- the MoE block

def test_moe_block_gptoss_matches_jax(tiny):
    jcfg, jp, _, tp = tiny
    jm = jax.tree_util.tree_map(lambda w: w[0], jp["layers"])["moe"]
    tm = qwen2._layer_stack(tp)[0]["moe"]
    x = np.random.default_rng(70).normal(size=(29, jcfg.hidden_size)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    jw, ji = _jit(jmoe.route_topk_softmax, top_k=2)(jx, jm["router"]["w"], jm["router"]["b"])
    tw, ti = moe.route_topk_softmax(tx, tm["router"]["w"], tm["router"]["b"], 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, 1e-6)
    gu = np.random.default_rng(71).normal(size=(5, 64)).astype(np.float32) * 6
    _close(moe._gptoss_glu(_t(gu), 7.0, 1.702), jmoe._gptoss_glu(jnp.asarray(gu), 7.0, 1.702),
           1e-6)
    for impl in ("auto", "gather", "dense"):
        _close(moe.moe_block_gptoss(tx, tm, top_k=2, impl=impl),
               _jit(jmoe.moe_block_gptoss, top_k=2, impl=impl)(jx, jm), OP_ATOL)
    with pytest.raises(NotImplementedError, match="not yet ported.*A11"):
        moe.moe_block_gptoss(tx, tm, top_k=2, impl="dispatch")


# ---------------------------------------------------------------- the model

def test_gptoss_params_have_the_jax_layout(tiny):
    """The port's init builds the JAX init's tree (keys, shapes), and a JAX
    gpt_oss tree converts through params_from_numpy unchanged."""
    jcfg, jp, tcfg, tp = tiny
    _assert_trees_equal(jp, tp)
    jtree = jax.tree_util.tree_map(np.asarray, jq.init_params(jcfg, jax.random.key(0)))
    own = qwen2.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype), jtree)
    got = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.numpy().dtype), own)
    assert shapes == got
    _assert_trees_equal(jtree, loader.params_from_numpy(jtree))


def test_gptoss_forward_matches_jax(tiny):
    """Logits of padded rows longer than the window (the sliding layer
    bands), f32, within 1e-4."""
    jcfg, jp, tcfg, tp = tiny
    ids = np.random.default_rng(80).integers(0, V, (3, 40))
    mask = np.ones((3, 40), np.int32)
    mask[1, :7] = 0
    jl, _, _ = _jit(jq.forward, cfg=jcfg)(jp, input_ids=jnp.asarray(ids),
                                          attention_mask=jnp.asarray(mask))
    tl, _, _ = qwen2.forward(tp, tcfg, _t(ids), attention_mask=_t(mask))
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=ATOL, rtol=0)


def _prefill_decode_layout(tp, tcfg, ids, lens, S):
    """Cached prefill of right-padded prompts; the caches in the decode layout."""
    B, Lp = ids.shape
    mask = (np.arange(Lp)[None, :] < lens[:, None]).astype(np.int32)
    kvv = np.zeros((B, S), bool)
    kvv[:, :Lp] = mask > 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    tc = qwen2.init_kv_cache(tcfg, B, S)
    _, _, tc = qwen2.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0,
                             kv_valid=_t(kvv))
    return tc, tuple(c.permute(0, 1, 3, 2, 4).contiguous() for c in tc)


def test_gptoss_decode_step_matches_jax_and_forward(tiny):
    """Two decode steps over the full-S cache (the sliding layer through
    window-clipped ranges) against JAX's decode_step and the full forward."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(81)
    B, Lp, S = 2, 32, 40
    lens = np.asarray([32, 21], np.int32)
    ids = rng.integers(0, V, (B, Lp))
    _, (ck, cv) = _prefill_decode_layout(tp, tcfg, ids, lens, S)
    jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    jstep = _jit(jq.decode_step, cfg=jcfg, return_hidden=True)
    seq = [list(ids[b, :lens[b]]) for b in range(B)]
    for t in range(2):
        nxt = rng.integers(0, V, (B,))
        pos = lens + t
        tl, th, ck, cv = qwen2.decode_step(tp, tcfg, _t(nxt), _t(pos.astype(np.int64)), ck, cv,
                                           Lp + t, _t(lens), torch.full((B,), Lp, dtype=torch.int32),
                                           return_hidden=True)
        jl, jh, jck, jcv = jstep(jp, tok=jnp.asarray(nxt), positions=jnp.asarray(pos),
                                 cache_k=jck, cache_v=jcv, slot=jnp.asarray(Lp + t, jnp.int32),
                                 lens=jnp.asarray(lens), dstart=jnp.full((B,), Lp, jnp.int32))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
        for b in range(B):
            seq[b].append(nxt[b])
            fl, _, _ = qwen2.forward(tp, tcfg, _t(np.asarray(seq[b])[None]))
            np.testing.assert_allclose(tl.numpy()[b], fl.numpy()[0, -1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_gptoss_decode_step_win_cache_matches_jax(tiny, int8):
    """decode_step over the windowed-short install (the engine's): the short
    panels through the kernel's ranges (lens_s = Wpad, clipped pstart_s,
    dstart_s = max(Wpad, wslot - W + 1)) against JAX's dense wvalid, for
    prompts shorter and longer than the window, over several steps."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(82 + int8)
    B, Lp, S, Wpad = 3, 48, 64, 16
    lens = np.asarray([48, 11, 30], np.int32)
    ids = rng.integers(0, V, (B, Lp))
    pc, _ = _prefill_decode_layout(tp, tcfg, ids, lens, S)
    eng = Engine(tp, tcfg, IdTok(), device="cpu")
    Sw = Wpad + S - Lp
    ck, cv, wc = eng._install_win(*pc, _t(lens.astype(np.int64)), Lp, Sw, Wpad)
    jck, jcv, jwc = JEngine._install_win_impl(
        eng_statics(jcfg), jnp.asarray(pc[0].numpy()), jnp.asarray(pc[1].numpy()),
        jnp.asarray(lens), jnp.asarray(Lp, jnp.int32), Sw=Sw, Wpad=Wpad)
    np.testing.assert_array_equal(wc["k"].numpy(), np.asarray(jwc["k"]))
    np.testing.assert_array_equal(ck.numpy(), np.asarray(jck))
    scl = jscl = None
    if int8:
        ck, cv, scl = Engine._quantize_cache(ck, cv)
        wk, wv, (wks, wvs) = Engine._quantize_cache(wc["k"], wc["v"])
        wc.update(k=wk, v=wv, ks=wks, vs=wvs)
        jck, jcv, jscl = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()), tuple(
            jnp.asarray(s.numpy()) for s in scl)
        jwc = dict(jwc, k=jnp.asarray(wk.numpy()), v=jnp.asarray(wv.numpy()),
                   ks=jnp.asarray(wks.numpy()), vs=jnp.asarray(wvs.numpy()))
    jstep = _jit(jq.decode_step, cfg=jcfg, win_pad=Wpad)
    dstart = torch.full((B,), Lp, dtype=torch.int32)
    for t in range(3):
        nxt = rng.integers(0, V, (B,))
        pos = lens + t
        out = qwen2.decode_step(tp, tcfg, _t(nxt), _t(pos.astype(np.int64)), ck, cv, Lp + t,
                                _t(lens), dstart, cache_scale=scl, win_cache=wc, win_pad=Wpad)
        jout = jstep(jp, tok=jnp.asarray(nxt), positions=jnp.asarray(pos), cache_k=jck,
                     cache_v=jcv, slot=jnp.asarray(Lp + t, jnp.int32), lens=jnp.asarray(lens),
                     dstart=jnp.full((B,), Lp, jnp.int32), cache_scale=jscl, win_cache=jwc)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]), atol=ATOL, rtol=0)
        jck, jcv, jwc = jout[2], jout[3], jout[-1]
        if int8:
            jscl = jout[4]


def eng_statics(jcfg):
    """The statics the JAX engine's install reads (its layer split)."""
    lw = [jcfg.window_for_layer(l) for l in range(jcfg.num_hidden_layers)]

    class Statics:
        win_split = (tuple(l for l, w in enumerate(lw) if not w),
                     tuple(l for l, w in enumerate(lw) if w), max(lw))

    return Statics


KW = dict(max_model_len=256, max_batch=4, decode_chunk=8, pad_multiple=32, batch_bucket=2,
          eos_token_ids=[1], prefix_cache_min_reuse=16, collect_h0=True)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_gptoss_engine_greedy_tokens_match_jax_engine(tiny, kv_quant, monkeypatch):
    """Greedy token ids equal the JAX engine's exactly: prompts of 70 tokens
    (the windowed-short install engaged, then prefix-hit children) and of
    20 (not engaged), decoding past the 16-token window; pooled h0 within
    1e-4."""
    jcfg, jp, tcfg, tp = tiny
    jeng = JEngine(jp, jcfg, IdTok(), approx_top_k=False, kv_quant=kv_quant, **KW)
    teng = Engine(tp, tcfg, IdTok(), kv_quant=kv_quant, **KW)
    installs = []
    install = Engine._install_win
    monkeypatch.setattr(Engine, "_install_win",
                        lambda self, *a: installs.append(a[-1]) or install(self, *a))
    rng = np.random.default_rng(90)

    def prompt(n):
        return " ".join(str(t) for t in rng.integers(2, V, n))

    long = [prompt(70), prompt(75)]
    rounds = ((long, 1), ([long[0] + " " + prompt(9), prompt(20)], 1), ([prompt(20)], 0))
    sp = dict(n=2, temperature=0.0, max_tokens=12)
    for prompts, engaged in rounds:
        before = len(installs)
        jout = jeng.generate(prompts, JSP(**sp))
        tout = teng.generate(prompts, SamplingParams(**sp))
        assert len(installs) - before == engaged
        for jr, tr in zip(jout, tout):
            assert [o.token_ids for o in tr.outputs] == [o.token_ids for o in jr.outputs]
            for jo, to in zip(jr.outputs, tr.outputs):
                np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                           atol=ATOL, rtol=0)
    assert installs and all(w == 32 for w in installs)
    assert teng.prefix_cache.hits == jeng.prefix_cache.stats()["hits"] == 1


def test_gptoss_value_function_matches_jax(tiny):
    """ValueFunction scores a GPT-OSS tree unchanged: values, h0 and the
    pooled scoring within 1e-4."""
    jcfg, jp, tcfg, tp = tiny
    jhead = jvm.init_value_head(jcfg.hidden_size, jax.random.key(3))
    thead = loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jhead))
    kw = dict(pad_multiple=32, batch_bucket=4)
    jvf, tvf = JValueFunction(jp, jhead, jcfg, **kw), ValueFunction(tp, thead, tcfg, **kw)
    ids = np.random.default_rng(91).integers(0, V, (3, 45))
    attn = np.ones((3, 45), np.int32)
    attn[1, 30:] = 0
    jy, jv, jh0 = jvf(ids, attn, return_h0=True)
    ty, tv, th0 = tvf(ids, attn, return_h0=True)
    for a, b in ((th0, jh0), (ty, jy), (tv, jv)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    jyc, jvc = jvf.from_pooled(th0[1:], root_h0=th0[0])
    tyc, tvc = tvf.from_pooled(th0[1:], root_h0=th0[0])
    np.testing.assert_allclose(tyc, jyc, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tvc, jvc, atol=ATOL, rtol=0)


# ---------------------------------------------------------------- the HF loader

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny random GptOssForCausalLM saved with transformers (the
    tests/test_gptoss.py fixture, with YaRN rope)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers would import TensorFlow (~10 s), unused
        transformers = pytest.importorskip("transformers")
    d = str(tmp_path_factory.mktemp("tiny_gptoss"))
    cfg = transformers.GptOssConfig(
        vocab_size=V, hidden_size=64, intermediate_size=48, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=16, layer_types=["sliding_attention", "full_attention"],
        rope_scaling=dict(YARN), rope_theta=150000.0, max_position_embeddings=256,
        tie_word_embeddings=False, torch_dtype="float32")
    torch.manual_seed(7)
    model = transformers.GptOssForCausalLM(cfg).eval()
    for layer in model.model.layers:  # random sinks and biases, not the init's
        layer.self_attn.sinks.data = torch.randn(4) * 2.0
        layer.mlp.router.bias.data = torch.randn(4) * 0.5
        layer.mlp.experts.gate_up_proj_bias.data = torch.randn(4, 96) * 0.1
        layer.mlp.experts.down_proj_bias.data = torch.randn(4, 64) * 0.1
    model.save_pretrained(d, safe_serialization=True)
    return d


@pytest.mark.parametrize("dtype,mode", [("float32", None), ("bfloat16", None),
                                        ("float32", "int8")])
def test_gptoss_checkpoint_loads_like_jax(hf_dir, dtype, mode):
    """Both loaders give the same config fields and the same leaves, bit for
    bit, in f32 and bf16 (sinks f32, de-interleaved gate_up, int8 expert
    stacks under quantize, router unquantized); f32, logits within 1e-4."""
    jp, jcfg = jloader.load_params(hf_dir, dtype=getattr(jnp, dtype), quantize=mode)
    tp, tcfg = loader.load_params(hf_dir, dtype=getattr(torch, dtype), device="cpu",
                                  quantize=mode)
    with open(os.path.join(hf_dir, "config.json")) as f:
        assert qwen2.Qwen2Config.from_hf(json.load(f)).layer_windows == (16, 0)
    for f in ("layer_windows", "rope_scaling", "attn_sinks", "o_proj_bias", "moe_style",
              "num_experts", "moe_intermediate_size", "head_dim_", "tie_word_embeddings"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    _assert_trees_equal(jp, tp)
    assert tp["layers"]["attn"]["sinks"].dtype == torch.float32
    e = tp["layers"]["moe"]["experts"]
    assert quant.is_quantized(e["gate_up"]["w"]) == quant.is_quantized(e["down"]["w"]) == (
        mode == "int8")
    assert not quant.is_quantized(tp["layers"]["moe"]["router"]["w"])
    if mode is None and dtype == "float32":
        ids = np.random.default_rng(92).integers(0, V, (2, 30))
        jl, _, _ = _jit(jq.forward, cfg=jcfg)(jp, input_ids=jnp.asarray(ids))
        tl, _, _ = qwen2.forward(tp, tcfg, _t(ids))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
