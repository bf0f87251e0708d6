"""lapha_tpu_torch's Gemma-2 / Gemma-3 serving path against lapha_tpu (CPU,
f32): the config from HF (the published Gemma-2-2B and Gemma-3-1B dicts and
tiny checkpoints), the loader's (1 + w) norm folds, the logit softcap in the
flash attention (no-cache and cached, windowed and full, forward and
gradients) and in the ragged decode attention (bf16 and int8 caches), the
model (logits, hidden, decode_step over the full-S cache and over Gemma-3's
windowed-short install), greedy engine tokens and ValueFunction.

The tiny checkpoints (``Gemma2ForCausalLM`` / ``Gemma3ForCausalLM`` written
by transformers): 4 layers, H 64, 4/2 heads of dim 16, window 8,
``query_pre_attn_scalar`` 24 (not the head dim). Gemma-2's caps are 5 on
the attention logits and 2 on the final ones, and its q/k projections and
embedding are scaled up (x8, x10) so that the logits reach 1-3x the caps:
with the init's scales a cap of 50 moves a logit of ~0.1 by ~1e-7 and a
missing softcap would pass every tolerance. Each softcap check is run once
more with the softcap planted off and must then fail.

The JAX side runs as its own tests run it on the CPU, jitted: the Pallas
kernels in interpret mode (softcap passed), the model's dense attention and
dense decode (its ragged kernel has no softcap).

Tolerances: the attention plain versions within 1e-5 of the interpret-mode
kernels (the same f32 softmax summed in another order), logits and hidden
states within 1e-4 (as the dense model's tests), gradients within 1e-4,
loaded leaves equal bit for bit, greedy token ids exactly equal.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GEMMA2_2B_CONFIG, GEMMA3_1B_CONFIG
from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import loader as jloader
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import flash_attention as jfa
from lapha_tpu.search.value_fn import ValueFunction as JValueFunction
from lapha_tpu_torch.engine import Engine, SamplingParams
from lapha_tpu_torch.models import loader, qwen2
from lapha_tpu_torch.ops import flash_attention as tfa
from lapha_tpu_torch.ops.ragged_decode_attention import ragged_decode_plain
from lapha_tpu_torch.search import ValueFunction

ATOL = 1e-4
OP_ATOL = 1e-5
V = 512
CAP = 5.0        # the tiny Gemma-2's attention softcap
FINAL_CAP = 2.0  # and its final one


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


def _far(t_out, j_out, atol):
    """The planted fault shows: the two differ by more than ``atol``."""
    assert np.abs(t_out.detach().numpy() - np.asarray(j_out)).max() > atol


def _jit(fn, **static):
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


# ---------------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Tiny random Gemma2ForCausalLM / Gemma3ForCausalLM checkpoints (the
    tests/test_gemma.py fixtures; Gemma-2 with small caps that bite)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers would import TensorFlow (~10 s), unused
        transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=V, hidden_size=64, intermediate_size=128, num_hidden_layers=4,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                  max_position_embeddings=256, sliding_window=8, query_pre_attn_scalar=24.0,
                  tie_word_embeddings=True, torch_dtype="float32")
    dirs = {}
    torch.manual_seed(5)
    g2 = transformers.Gemma2ForCausalLM(transformers.Gemma2Config(
        rope_theta=10000.0, attn_logit_softcapping=CAP, final_logit_softcapping=FINAL_CAP,
        **common)).eval()
    with torch.no_grad():
        g2.model.embed_tokens.weight.mul_(10.0)
        for layer in g2.model.layers:
            layer.self_attn.q_proj.weight.mul_(8.0)
            layer.self_attn.k_proj.weight.mul_(8.0)
    torch.manual_seed(7)
    g3 = transformers.Gemma3ForCausalLM(transformers.Gemma3TextConfig(
        rope_theta=1000000.0, rope_local_base_freq=10000.0, sliding_window_pattern=2,
        **common)).eval()
    with torch.no_grad():  # random norm weights, so that the (1 + w) folds show
        for model in (g2, g3):
            for name, w in model.named_parameters():
                if name.endswith("norm.weight"):
                    w.normal_(0.0, 0.3)
    for name, model in (("gemma2", g2), ("gemma3", g3)):
        d = str(tmp_path_factory.mktemp(f"tiny_{name}"))
        model.save_pretrained(d, safe_serialization=True)
        dirs[name] = d
    return dirs


@pytest.fixture(scope="module")
def models(hf_dirs):
    """family -> (jcfg, jparams, tcfg, tparams), both loaded in f32 from the
    same checkpoint."""
    out = {}
    for fam, d in hf_dirs.items():
        jp, jcfg = jloader.load_params(d, dtype=jnp.float32)
        tp, tcfg = loader.load_params(d, dtype=torch.float32, device="cpu")
        out[fam] = (jcfg, jp, tcfg, tp)
    return out


# ---------------------------------------------------------------- config

FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
          "num_attention_heads", "num_key_value_heads", "head_dim_", "max_position_embeddings",
          "rope_theta", "rope_scaling", "sliding_window", "layer_windows", "rms_norm_eps",
          "tie_word_embeddings", "attention_bias", "qk_norm", "hidden_act", "sandwich_norms",
          "embed_normalizer", "query_pre_attn_scalar", "attn_softcap", "final_softcap",
          "rope_local_theta", "max_window_", "attn_scale_")


@pytest.mark.parametrize("name", ["gemma2_2b", "gemma3_1b"])
def test_from_hf_published_configs_match_jax(name):
    """The published config.json of Gemma-2-2B and Gemma-3-1B (chip_smoke's
    dicts) parse to the JAX config's fields, and the windows are as
    published: alternating 4096 from layer 0, or 512 with every 6th global."""
    cfg = GEMMA2_2B_CONFIG if name == "gemma2_2b" else GEMMA3_1B_CONFIG
    j, t = JCfg.from_hf(cfg), qwen2.Qwen2Config.from_hf(cfg)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    if name == "gemma2_2b":
        assert t.layer_windows == (4096, 0) * 13 and t.attn_softcap == 50.0
    else:
        assert t.layer_windows == ((512,) * 5 + (0,)) * 4 + (512, 512)
        assert t.rope_local_theta == 10000.0 and t.final_softcap == 0.0
    assert t.head_dim_ == 256 and t.attn_scale_ == 1 / 16
    with pytest.raises(ValueError, match="multimodal"):
        qwen2.Qwen2Config.from_hf(dict(cfg, model_type="gemma3", text_config={}))


@pytest.mark.parametrize("fam", ["gemma2", "gemma3"])
def test_tiny_checkpoint_config_parses_like_jax(hf_dirs, fam):
    j, t = jloader.load_config(hf_dirs[fam]), loader.load_config(hf_dirs[fam])
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.layer_windows == (8, 0, 8, 0) and abs(t.attn_scale_ - 24.0 ** -0.5) < 1e-12


@pytest.mark.parametrize("fam,dtype", [("gemma2", "float32"), ("gemma3", "float32"),
                                       ("gemma2", "bfloat16")])
def test_checkpoint_loads_like_jax(hf_dirs, fam, dtype):
    """Both loaders give the same leaves, bit for bit: the (1 + w) folds in
    f32 of the four norms a layer, the q/k norms and the final norm; and
    params_from_numpy carries the JAX gemma tree across unchanged."""
    jp, _ = jloader.load_params(hf_dirs[fam], dtype=getattr(jnp, dtype))
    tp, _ = loader.load_params(hf_dirs[fam], dtype=getattr(torch, dtype), device="cpu")
    _assert_trees_equal(jp, tp)
    assert tp["layers"]["pre_feedforward_layernorm"]["scale"].dtype == torch.float32
    assert tp["norm"]["scale"].dtype == torch.float32
    assert ("q_norm" in tp["layers"]["attn"]) == (fam == "gemma3")
    _assert_trees_equal(jp, loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))


def test_gemma_params_have_the_jax_layout():
    """The port's init builds the JAX init's tree (keys, shapes, dtypes)
    for both families."""
    for cfg in (GEMMA2_2B_CONFIG, GEMMA3_1B_CONFIG):
        small = dict(cfg, num_hidden_layers=2, hidden_size=32, intermediate_size=48,
                     vocab_size=64, head_dim=16)
        jcfg = dataclasses.replace(JCfg.from_hf(small), dtype=jnp.float32)
        tcfg = dataclasses.replace(qwen2.Qwen2Config.from_hf(small), dtype=torch.float32)
        jtree = jax.tree_util.tree_map(np.asarray, jq.init_params(jcfg, jax.random.key(0)))
        own = qwen2.init_params(tcfg, torch.Generator().manual_seed(0))
        shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype), jtree)
        assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.numpy().dtype), own)


# ---------------------------------------------------------------- attention

def _qkv(rng, B, T, S, nh, nkv, dh, q_scale):
    return ((rng.normal(size=(B, T, nh, dh)) * q_scale).astype(np.float32),
            rng.normal(size=(B, S, nkv, dh)).astype(np.float32),
            rng.normal(size=(B, S, nkv, dh)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 8])
def test_flash_softcap_matches_jax(window):
    """No-cache (padded rows) and cached (per-row qstart, a suffix prefill)
    attention with the softcap, |s| up to ~3x the cap, against the
    interpret-mode Pallas K1/K3; with the softcap planted off the plain
    version fails the same check."""
    rng = np.random.default_rng(10 + window)
    B, T, nh, nkv, dh = 3, 40, 4, 2, 16
    # q·k/4 ~ N(0, 6^2): |s| reaches 3x a cap of 5
    q, k, v = _qkv(rng, B, T, T, nh, nkv, dh, 6.0)
    mask = np.ones((B, T), np.int32)
    mask[1, :9] = 0
    mask[2, 30:] = 0
    j_out = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                                window=window, softcap=CAP, block_q=16, block_k=16,
                                interpret=True)
    real = mask[:, :, None, None] > 0
    t_out = tfa.flash_attention(_t(q), _t(k), _t(v), _t(mask), window=window, softcap=CAP)
    _close(t_out * _t(real), np.asarray(j_out) * real, OP_ATOL)
    _far(tfa.flash_attention(_t(q), _t(k), _t(v), _t(mask), window=window) * _t(real),
         np.asarray(j_out) * real, 100 * OP_ATOL)

    S, Tn = 72, 24
    q, k, v = _qkv(rng, B, Tn, S, nh, nkv, dh, 6.0)
    qs = np.asarray([40, 0, 13], np.int32)
    kv_valid = (np.arange(S)[None, :] < (qs + Tn)[:, None]).astype(np.int32)
    kv_valid[2, 5:9] = 0
    j_out = jfa.flash_attention_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(kv_valid), jnp.asarray(qs), window=window,
                                       softcap=CAP, block_q=16, block_k=16, interpret=True)
    args = (_t(q), _t(k), _t(v), _t(kv_valid), _t(qs))
    _close(tfa.flash_attention_cached(*args, window=window, softcap=CAP), j_out, OP_ATOL)
    _far(tfa.flash_attention_cached(*args, window=window), j_out, 100 * OP_ATOL)
    s = np.einsum("btkgd,bskd->bkgts", q.reshape(B, Tn, nkv, 2, dh), k) * dh ** -0.5
    assert np.abs(s).max() > 2 * CAP  # the cap bites


@pytest.mark.parametrize("window", [0, 8])
def test_flash_softcap_gradients_match_jax(window):
    """dq, dk, dv through the softcap (the plain backward's chain rule
    dc/ds = 1 - (c/cap)^2 on the CPU) against jax.grad of the Pallas
    custom_vjp in interpret mode."""
    rng = np.random.default_rng(20 + window)
    B, T, nh, nkv, dh = 2, 36, 4, 2, 16
    q, k, v = _qkv(rng, B, T, T, nh, nkv, dh, 6.0)
    do = rng.normal(size=(B, T, nh, dh)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, :5] = 0
    real = mask[:, :, None, None].astype(np.float32)

    def jloss(q_, k_, v_):
        out = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), window=window, softcap=CAP,
                                  block_q=16, block_k=16, interpret=True)
        return jnp.sum(out * jnp.asarray(do * real))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, _t(mask), window=window, softcap=CAP)
    tg = torch.autograd.grad(out, leaves, _t(do * real))
    for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=name)
    out = tfa.flash_attention(*leaves, _t(mask), window=window)
    _far(torch.autograd.grad(out, leaves[0], _t(do * real))[0], jg[0], 100 * ATOL)


@pytest.mark.parametrize("int8", [False, True])
def test_ragged_decode_softcap_matches_jax(int8):
    """ragged_decode_plain with the softcap (bf16 and int8 caches, full and
    window-clipped ranges) against the interpret-mode Pallas K3 with the
    softcap, one query at qstart = slot over the same validity (the int8
    cache dequantized for K3: the K scale folds into the logit before the
    cap, the V scale into p); with the softcap planted off it fails."""
    rng = np.random.default_rng(30 + int8)
    L, B, nkv, S, nh, dh, W, slot = 2, 4, 2, 96, 4, 16, 16, 70
    q = (rng.normal(size=(B, nh, dh)) * 6.0).astype(np.float32)
    k = rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32)
    v = rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32)
    lens = np.asarray([40, 64, 10, 33], np.int32)
    dstart = np.full(B, 64, np.int32)
    positions = lens + (slot - 64)
    pstart = np.clip(positions - W + 1, 0, lens).astype(np.int32)
    dstart_w = np.maximum(dstart, slot - W + 1).astype(np.int32)
    scl, kd, vd = None, k, v
    if int8:
        kq, ks = qwen2._quantize_kv(_t(k))
        vq, vs = qwen2._quantize_kv(_t(v))
        k, v, scl = kq.numpy(), vq.numpy(), (ks.numpy(), vs.numpy())
        kd, vd = k * scl[0][..., None], v * scl[1][..., None]
    ar = np.arange(S)[None, :]
    for ps, ds in ((None, dstart), (pstart, dstart_w)):
        p0 = 0 if ps is None else ps[:, None]
        valid = (((ar >= p0) & (ar < lens[:, None])) | ((ar >= ds[:, None]) & (ar <= slot)))
        for layer in range(L):
            j_out = jfa.flash_attention_cached(
                jnp.asarray(q[:, None]), jnp.asarray(kd[layer].transpose(0, 2, 1, 3)),
                jnp.asarray(vd[layer].transpose(0, 2, 1, 3)), jnp.asarray(valid.astype(np.int32)),
                jnp.full((B,), slot, jnp.int32), softcap=CAP, block_q=16, block_k=16,
                interpret=True)[:, 0]
            args = (_t(q), _t(k), _t(v), layer, _t(lens), _t(ds), slot,
                    None if ps is None else _t(ps))
            kw = dict(cache_scale=None if scl is None else tuple(map(_t, scl)))
            _close(ragged_decode_plain(*args, softcap=CAP, **kw), j_out, OP_ATOL)
            _far(ragged_decode_plain(*args, **kw), j_out, 100 * OP_ATOL)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("fam", ["gemma2", "gemma3"])
def test_forward_matches_jax(models, fam):
    """Logits and final hidden of padded rows longer than the window, f32,
    within 1e-4 (Gemma-2 also through the interpret-mode Pallas K1 with its
    softcap); each of Gemma-2's softcaps, Gemma-3's local rope and the
    sandwich norms planted off fails the check."""
    jcfg, jp, tcfg, tp = models[fam]
    ids = np.random.default_rng(40).integers(0, V, (3, 24))
    mask = np.ones((3, 24), np.int32)
    mask[1, :7] = 0
    real = mask > 0
    jl, jh, _ = _jit(jq.forward, cfg=jcfg, return_hidden=True)(
        jp, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    tl, th, _ = qwen2.forward(tp, tcfg, _t(ids), attention_mask=_t(mask), return_hidden=True)
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], atol=ATOL, rtol=0)
    if fam == "gemma2":
        assert np.abs(np.asarray(jl)).max() > 0.9 * FINAL_CAP  # the final cap bites
        pallas = dataclasses.replace(jcfg, attn_impl="pallas")
        jpl, _, _ = _jit(jq.forward, cfg=pallas)(jp, input_ids=jnp.asarray(ids),
                                                 attention_mask=jnp.asarray(mask))
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jpl)[real], atol=ATOL, rtol=0)
        faults = ({"attn_softcap": 0.0}, {"final_softcap": 0.0})
    else:
        faults = ({"rope_local_theta": 0.0},)
    for fault in faults:
        bad, _, _ = qwen2.forward(tp, dataclasses.replace(tcfg, **fault), _t(ids),
                                  attention_mask=_t(mask))
        assert np.abs(bad.numpy()[real] - np.asarray(jl)[real]).max() > 100 * ATOL, fault


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


@pytest.mark.parametrize("int8", [False, True])
def test_gemma2_decode_step_matches_jax_and_forward(models, int8):
    """Gemma-2 decode over the full-S cache (the sliding layers through
    window-clipped ranges, the softcap inside the decode attention) against
    JAX's dense decode_step for three steps past the window; the bf16
    cache's steps also against the full forward."""
    jcfg, jp, tcfg, tp = models["gemma2"]
    rng = np.random.default_rng(50 + int8)
    B, Lp, S = 2, 16, 24
    lens = np.asarray([16, 11], np.int32)
    ids = rng.integers(0, V, (B, Lp))
    _, (ck, cv) = _prefill_decode_layout(tp, tcfg, ids, lens, S)
    scl = jscl = None
    if int8:
        ck, cv, scl = Engine._quantize_cache(ck, cv)
        jscl = tuple(jnp.asarray(s.numpy()) for s in scl)
    jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    jstep = _jit(jq.decode_step, cfg=jcfg, return_hidden=True, ragged=False)
    seq = [list(ids[b, :lens[b]]) for b in range(B)]
    dstart = torch.full((B,), Lp, dtype=torch.int32)
    for t in range(3):
        nxt = rng.integers(0, V, (B,))
        pos = lens + t
        out = qwen2.decode_step(tp, tcfg, _t(nxt), _t(pos.astype(np.int64)), ck, cv, Lp + t,
                                _t(lens), dstart, return_hidden=True, cache_scale=scl)
        jout = jstep(jp, tok=jnp.asarray(nxt), positions=jnp.asarray(pos), cache_k=jck,
                     cache_v=jcv, slot=jnp.asarray(Lp + t, jnp.int32), lens=jnp.asarray(lens),
                     dstart=jnp.full((B,), Lp, jnp.int32), cache_scale=jscl)
        _close(out[0], jout[0], ATOL)
        _close(out[1], jout[1], ATOL)
        jck, jcv = jout[2], jout[3]
        if int8:
            jscl = jout[4]
            continue
        for b in range(B):
            seq[b].append(nxt[b])
            fl, _, _ = qwen2.forward(tp, tcfg, _t(np.asarray(seq[b])[None]))
            np.testing.assert_allclose(out[0].numpy()[b], fl.numpy()[0, -1], atol=ATOL, rtol=0)


def eng_statics(jcfg):
    """The statics the JAX engine's install reads (its layer split)."""
    lw = [jcfg.window_for_layer(l) for l in range(jcfg.num_hidden_layers)]

    class Statics:
        win_split = (tuple(l for l, w in enumerate(lw) if not w),
                     tuple(l for l, w in enumerate(lw) if w), max(lw))

    return Statics


@pytest.mark.parametrize("int8", [False, True])
def test_gemma3_decode_step_win_cache_matches_jax(models, int8):
    """Gemma-3 decode over the windowed-short install (the engine's; local
    rope on the sliding layers, q/k norms): the short panels through the
    kernel's ranges against JAX's dense decode, for prompts shorter and
    longer than the window, over three steps; the bf16 steps also against
    the full forward."""
    jcfg, jp, tcfg, tp = models["gemma3"]
    rng = np.random.default_rng(60 + int8)
    B, Lp, S, Wpad = 3, 24, 32, 8
    lens = np.asarray([24, 5, 15], np.int32)
    ids = rng.integers(0, V, (B, Lp))
    pc, _ = _prefill_decode_layout(tp, tcfg, ids, lens, S)
    eng = Engine(tp, tcfg, IdTok(), device="cpu")
    Sw = Wpad + S - Lp
    ck, cv, wc = eng._install_win(*pc, _t(lens.astype(np.int64)), Lp, Sw, Wpad)
    jck, jcv, jwc = JEngine._install_win_impl(
        eng_statics(jcfg), jnp.asarray(pc[0].numpy()), jnp.asarray(pc[1].numpy()),
        jnp.asarray(lens), jnp.asarray(Lp, jnp.int32), Sw=Sw, Wpad=Wpad)
    np.testing.assert_array_equal(wc["k"].numpy(), np.asarray(jwc["k"]))
    scl = jscl = None
    if int8:
        ck, cv, scl = Engine._quantize_cache(ck, cv)
        wk, wv, (wks, wvs) = Engine._quantize_cache(wc["k"], wc["v"])
        wc.update(k=wk, v=wv, ks=wks, vs=wvs)
        jck, jcv, jscl = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()), tuple(
            jnp.asarray(s.numpy()) for s in scl)
        jwc = dict(jwc, k=jnp.asarray(wk.numpy()), v=jnp.asarray(wv.numpy()),
                   ks=jnp.asarray(wks.numpy()), vs=jnp.asarray(wvs.numpy()))
    jstep = _jit(jq.decode_step, cfg=jcfg, win_pad=Wpad, ragged=False)
    seq = [list(ids[b, :lens[b]]) for b in range(B)]
    dstart = torch.full((B,), Lp, dtype=torch.int32)
    for t in range(3):
        nxt = rng.integers(0, V, (B,))
        pos = lens + t
        out = qwen2.decode_step(tp, tcfg, _t(nxt), _t(pos.astype(np.int64)), ck, cv, Lp + t,
                                _t(lens), dstart, cache_scale=scl, win_cache=wc, win_pad=Wpad)
        jout = jstep(jp, tok=jnp.asarray(nxt), positions=jnp.asarray(pos), cache_k=jck,
                     cache_v=jcv, slot=jnp.asarray(Lp + t, jnp.int32), lens=jnp.asarray(lens),
                     dstart=jnp.full((B,), Lp, jnp.int32), cache_scale=jscl, win_cache=jwc)
        _close(out[0], jout[0], ATOL)
        jck, jcv, jwc = jout[2], jout[3], jout[-1]
        if int8:
            jscl = jout[4]
            continue
        for b in range(B):
            seq[b].append(nxt[b])
            fl, _, _ = qwen2.forward(tp, tcfg, _t(np.asarray(seq[b])[None]))
            np.testing.assert_allclose(out[0].numpy()[b], fl.numpy()[0, -1], atol=ATOL, rtol=0)


KW = dict(max_model_len=128, max_batch=4, decode_chunk=8, pad_multiple=32, batch_bucket=2,
          eos_token_ids=[1], prefix_cache_min_reuse=16, collect_h0=True)


@pytest.mark.parametrize("fam,kv_quant", [("gemma2", None), ("gemma2", "int8"),
                                          ("gemma3", None)])
def test_engine_greedy_tokens_match_jax_engine(models, fam, kv_quant, monkeypatch):
    """Greedy token ids equal the JAX engine's exactly (sampling reads the
    final-softcapped logits): prompts of 70 tokens (the windowed-short
    install engaged) with prefix-hit children, decoding past the 8-token
    window; logprobs and pooled h0 within 1e-4."""
    jcfg, jp, tcfg, tp = models[fam]
    jeng = JEngine(jp, jcfg, IdTok(), approx_top_k=False, kv_quant=kv_quant, **KW)
    teng = Engine(tp, tcfg, IdTok(), kv_quant=kv_quant, **KW)
    installs = []
    install = Engine._install_win
    monkeypatch.setattr(Engine, "_install_win",
                        lambda self, *a: installs.append(a[-1]) or install(self, *a))
    rng = np.random.default_rng(70)

    def prompt(n):
        return " ".join(str(t) for t in rng.integers(2, V, n))

    long = [prompt(70), prompt(45)]
    sp = dict(n=2, temperature=0.0, max_tokens=10)
    for prompts in (long, [long[0] + " " + prompt(9), prompt(20)]):
        jout = jeng.generate(prompts, JSP(**sp))
        tout = teng.generate(prompts, SamplingParams(**sp))
        for jr, tr in zip(jout, tout):
            assert [o.token_ids for o in tr.outputs] == [o.token_ids for o in jr.outputs]
            for jo, to in zip(jr.outputs, tr.outputs):
                np.testing.assert_allclose(to.token_logprobs, np.asarray(jo.token_logprobs),
                                           atol=ATOL, rtol=0)
                np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                           atol=ATOL, rtol=0)
    assert installs == [32, 32]
    assert teng.prefix_cache.hits == jeng.prefix_cache.stats()["hits"] == 1


def test_value_function_matches_jax(models):
    """ValueFunction scores a Gemma-2 policy unchanged: values, h0 and the
    pooled scoring within 1e-4."""
    jcfg, jp, tcfg, tp = models["gemma2"]
    jhead = jvm.init_value_head(jcfg.hidden_size, jax.random.key(3))
    thead = loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jhead))
    kw = dict(pad_multiple=32, batch_bucket=4)
    jvf, tvf = JValueFunction(jp, jhead, jcfg, **kw), ValueFunction(tp, thead, tcfg, **kw)
    ids = np.random.default_rng(80).integers(0, V, (3, 45))
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


def test_hf_config_files_parse(hf_dirs):
    """The config.json transformers wrote names the layer types; the port's
    parse of it equals the parse without them (the family defaults)."""
    for fam, d in hf_dirs.items():
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        bare = {k: v for k, v in cfg.items() if k != "layer_types"}
        assert (qwen2.Qwen2Config.from_hf(cfg).layer_windows
                == qwen2.Qwen2Config.from_hf(bare).layer_windows == (8, 0, 8, 0)), fam
