"""lapha_tpu_torch's StarCoder2 serving and training path against lapha_tpu
(CPU, f32): a GQA group above 8 in the ragged decode attention (the Pallas
kernel takes any group >= 8, the port's kernel splits it into blocks of at
most 8), the biased LayerNorm on the residual stream, the plain biased
``c_fc -> gelu_tanh -> c_proj`` FFN, the loader (bf16, int8, int4), the model
(logits, decode over the full-S cache), greedy engine tokens past the window
(every layer sliding), int8 weights and int8 KV, and one ``make_update_fn``
step.

The tiny checkpoint (``Starcoder2ForCausalLM`` written by transformers): 2
layers, H 192, 12 query heads over 1 KV head (a group of 12, StarCoder2-3B's
24/2), I 256, a 16-token sliding window, biases everywhere, tied; the
LayerNorm weights, the LayerNorm biases and the projection biases are
random, so that each shows.

The JAX side runs as its own tests run it on the CPU (tests/test_torch_phi3.py
has the details), with the tolerances stated there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import STARCODER2_3B_CONFIG
from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import loader as jloader
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.ops.ragged_decode_attention import ragged_decode_attention as j_ragged
from lapha_tpu_torch.engine import Engine, SamplingParams
from lapha_tpu_torch.models import loader, qwen2
from lapha_tpu_torch.ops.ragged_decode_attention import ragged_decode_attention as t_ragged
from test_torch_phi3 import (ATOL, FIELDS, KW, OP_ATOL, IdTok, _assert_trees_equal, _jit,
                             _packed, _t, check_update_step_matches_jax)

V = 512
W = 16  # the tiny checkpoint's sliding window
TINY = dict(vocab_size=V, hidden_size=192, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=12, num_key_value_heads=1, max_position_embeddings=256,
            sliding_window=W)


# ---------------------------------------------------------------- the decode kernel at group > 8

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nh,nkv", [(12, 1), (18, 2), (24, 2), (32, 1)])
def test_ragged_decode_large_groups_match_jax(nh, nkv, int8):
    """ragged_decode_plain at GQA groups 12, 9, 12 (StarCoder2-3B's 24/2)
    and 32, full and window-clipped ranges, f32 and int8 caches, against
    the interpret-mode Pallas ragged kernel (which takes a group of 8 or
    more as it is)."""
    rng = np.random.default_rng(5 + nh + int8)
    L, B, S, dh, slot = 2, 3, 128, 16, 90
    q = rng.normal(size=(B, nh, dh)).astype(np.float32)
    k, v = (rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32) for _ in range(2))
    scl = jscl = None
    if int8:
        (kq, ks), (vq, vs) = qwen2._quantize_kv(_t(k)), qwen2._quantize_kv(_t(v))
        k, v, scl = kq.numpy(), vq.numpy(), (ks, vs)
        jscl = (jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()))
    lens = np.asarray([40, 64, 10], np.int32)
    dstart = np.full(B, 64, np.int32)
    pstart = np.clip(lens + (slot - 64) - W + 1, 0, lens).astype(np.int32)
    dstart_w = np.maximum(dstart, slot - W + 1).astype(np.int32)
    for ps, ds in ((None, dstart), (pstart, dstart_w)):
        j_out = j_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1,
                         jnp.asarray(lens), jnp.asarray(ds), jnp.asarray(slot, jnp.int32),
                         cache_scale=jscl, pstart=None if ps is None else jnp.asarray(ps),
                         block_k=32, interpret=True)
        t_out = t_ragged(_t(q), _t(k), _t(v), 1, _t(lens), _t(ds), slot,
                         None if ps is None else _t(ps), cache_scale=scl)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=OP_ATOL, rtol=0)


# ---------------------------------------------------------------- config, checkpoint, layers

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny random Starcoder2ForCausalLM checkpoint with a group of 12."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers would import TensorFlow (~10 s), unused
        transformers = pytest.importorskip("transformers")
    torch.manual_seed(13)
    model = transformers.Starcoder2ForCausalLM(transformers.Starcoder2Config(
        rope_theta=10000.0, use_bias=True, tie_word_embeddings=True, torch_dtype="float32",
        **TINY)).eval()
    with torch.no_grad():  # HF zeroes biases and sets LayerNorm weights to 1
        for name, w in model.named_parameters():
            if name.endswith("bias"):
                w.uniform_(-0.3, 0.3)
            elif "norm" in name:
                w.normal_(1.0, 0.3)
    d = str(tmp_path_factory.mktemp("tiny_starcoder2"))
    model.save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def model(hf_dir):
    jp, jcfg = jloader.load_params(hf_dir, dtype=jnp.float32)
    tp, tcfg = loader.load_params(hf_dir, dtype=torch.float32, device="cpu")
    return jcfg, jp, tcfg, tp


def test_checkpoint_config_parses_like_jax(hf_dir):
    j, t = jloader.load_config(hf_dir), loader.load_config(hf_dir)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.num_attention_heads // t.num_key_value_heads == 12 and t.sliding_window == W
    assert (t.norm_style, t.mlp_style, t.hidden_act) == ("layernorm", "plain",
                                                         "gelu_pytorch_tanh")


@pytest.mark.parametrize("dtype,quantize", [("float32", None), ("bfloat16", None),
                                            ("bfloat16", "int8"), ("bfloat16", "int4")])
def test_checkpoint_loads_like_jax(hf_dir, dtype, quantize):
    """Both loaders give the same leaves, bit for bit: the LayerNorm
    biases, every projection's bias (o_proj's too) and c_fc / c_proj with
    their biases (int4 where the in-dim splits into whole group-128 halves:
    c_proj)."""
    jp, _ = jloader.load_params(hf_dir, dtype=getattr(jnp, dtype), quantize=quantize)
    tp, _ = loader.load_params(hf_dir, dtype=getattr(torch, dtype), device="cpu",
                               quantize=quantize)
    _assert_trees_equal(jp, tp)
    layers = tp["layers"]
    assert set(layers["input_layernorm"]) == {"scale", "bias"} and "bias" in tp["norm"]
    assert "b" in layers["attn"]["o_proj"] and set(layers["mlp"]) == {"c_fc", "c_proj"}
    c_proj = layers["mlp"]["c_proj"]["w"]
    assert (isinstance(c_proj, dict) and "s4" in c_proj) == (quantize == "int4")
    _assert_trees_equal(jp, loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))


def test_params_have_the_jax_layout():
    """The port's init builds the JAX init's tree (keys, shapes, dtypes):
    the LayerNorm biases, o_proj's bias, c_fc / c_proj."""
    small = dict(STARCODER2_3B_CONFIG, **TINY)
    jcfg = dataclasses.replace(JCfg.from_hf(small), dtype=jnp.float32)
    tcfg = dataclasses.replace(qwen2.Qwen2Config.from_hf(small), dtype=torch.float32)
    jtree = jax.tree_util.tree_map(np.asarray, jq.init_params(jcfg, jax.random.key(0)))
    own = qwen2.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype), jtree)
    assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.numpy().dtype), own)


def test_layernorm_and_plain_mlp_match_jax(model):
    """The biased LayerNorm (mean-centred, f32 inside) and the plain FFN
    (f32 products, f32 bias adds, gelu_tanh) of layer 0, on the same
    hidden states, within 1e-5; an RMS norm in the LayerNorm's place
    fails."""
    jcfg, jp, tcfg, tp = model
    x = (np.random.default_rng(6).normal(size=(3, 7, 192)) * 2.0 + 0.5).astype(np.float32)
    jlayer = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    tlayer = qwen2._layer_stack(tp)[0]
    jn = jq._norm(jnp.asarray(x), jlayer["input_layernorm"], jcfg)
    tn = qwen2._norm(_t(x), tlayer["input_layernorm"], tcfg)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=OP_ATOL, rtol=0)
    bad = qwen2._norm(_t(x), tlayer["input_layernorm"], dataclasses.replace(tcfg,
                                                                            norm_style="rms"))
    assert np.abs(bad.numpy() - np.asarray(jn)).max() > 100 * OP_ATOL
    jm, tm = jq._mlp(jcfg, jlayer, jn), qwen2._mlp(tcfg, tlayer, tn)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=ATOL, rtol=0)


def test_forward_matches_jax(model):
    """Logits and final hidden of padded rows longer than the window (every
    layer banded), f32, within 1e-4; the window planted off fails."""
    jcfg, jp, tcfg, tp = model
    ids = np.random.default_rng(40).integers(0, V, (3, 40))
    mask = np.ones((3, 40), np.int32)
    mask[1, 31:] = 0
    real = mask > 0
    jlg, jh, _ = _jit(jq.forward, cfg=jcfg, return_hidden=True)(
        jp, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    tlg, th, _ = qwen2.forward(tp, tcfg, _t(ids), attention_mask=_t(mask), return_hidden=True)
    np.testing.assert_allclose(tlg.numpy()[real], np.asarray(jlg)[real], atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], atol=ATOL, rtol=0)
    bad, _, _ = qwen2.forward(tp, dataclasses.replace(tcfg, sliding_window=0), _t(ids),
                              attention_mask=_t(mask))
    assert np.abs(bad.numpy()[real] - np.asarray(jlg)[real]).max() > 100 * ATOL


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_matches_jax(model, int8):
    """decode_step over the full-S cache with the group of 12 (every layer
    through the window's clipped ranges), f32 and int8 caches, against
    JAX's dense decode_step for three steps past the window."""
    jcfg, jp, tcfg, tp = model
    rng = np.random.default_rng(50 + int8)
    B, Lp, S = 2, 24, 32
    lens = np.asarray([24, 13], np.int32)
    ids = rng.integers(0, V, (B, Lp))
    mask = (np.arange(Lp)[None, :] < lens[:, None]).astype(np.int32)
    kvv = np.zeros((B, S), bool)
    kvv[:, :Lp] = mask > 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    tc = qwen2.init_kv_cache(tcfg, B, S)
    _, _, tc = qwen2.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0,
                             kv_valid=_t(kvv))
    ck, cv = (c.permute(0, 1, 3, 2, 4).contiguous() for c in tc)
    scl = jscl = None
    if int8:
        ck, cv, scl = Engine._quantize_cache(ck, cv)
        jscl = tuple(jnp.asarray(s.numpy()) for s in scl)
    jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    jstep = _jit(jq.decode_step, cfg=jcfg, return_hidden=True, ragged=False)
    dstart = torch.full((B,), Lp, dtype=torch.int32)
    for t in range(3):
        nxt = rng.integers(0, V, (B,))
        p = lens + t
        out = qwen2.decode_step(tp, tcfg, _t(nxt), _t(p.astype(np.int64)), ck, cv, Lp + t,
                                _t(lens), dstart, return_hidden=True, cache_scale=scl)
        jout = jstep(jp, tok=jnp.asarray(nxt), positions=jnp.asarray(p), cache_k=jck,
                     cache_v=jcv, slot=jnp.asarray(Lp + t, jnp.int32), lens=jnp.asarray(lens),
                     dstart=jnp.full((B,), Lp, jnp.int32), cache_scale=jscl)
        np.testing.assert_allclose(out[0].numpy(), np.asarray(jout[0]), atol=ATOL, rtol=0)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(jout[1]), atol=ATOL, rtol=0)
        jck, jcv = jout[2], jout[3]
        if int8:
            jscl = jout[4]


@pytest.mark.parametrize("weights,kv_quant", [(None, None), (None, "int8"), ("int8", None)])
def test_engine_greedy_tokens_match_jax_engine(hf_dir, model, weights, kv_quant, monkeypatch):
    """Greedy token ids equal the JAX engine's exactly: prompts past the
    16-token window (the windowed-short install with an empty full stack),
    prefix-hit children, f32 weights with f32 and int8 KV and int8 weights;
    logprobs and pooled h0 within 1e-4."""
    jcfg, jp, tcfg, tp = model
    if weights is not None:
        jp, jcfg = jloader.load_params(hf_dir, dtype=jnp.float32, quantize=weights)
        tp, tcfg = loader.load_params(hf_dir, dtype=torch.float32, device="cpu",
                                      quantize=weights)
    jeng = JEngine(jp, jcfg, IdTok(), approx_top_k=False, kv_quant=kv_quant, **KW)
    teng = Engine(tp, tcfg, IdTok(), kv_quant=kv_quant, **KW)
    full_layers = []
    install = Engine._install_win

    def spy(self, *a):
        out = install(self, *a)
        full_layers.append(out[0].shape[0])
        return out

    monkeypatch.setattr(Engine, "_install_win", spy)
    rng = np.random.default_rng(71)

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
    assert full_layers == [0, 0]  # the full-attention stack is empty
    assert teng.prefix_cache.hits == jeng.prefix_cache.stats()["hits"] == 1


def test_update_step_matches_jax():
    """StarCoder2 with the group of 12, the window biting in the 32-column
    batch: every leaf's gradient (the LayerNorm biases, c_fc / c_proj and
    their biases, o_proj's bias among them) and one make_update_fn step."""
    packed = _packed()
    assert packed["ids"].shape[1] > W
    check_update_step_matches_jax(STARCODER2_3B_CONFIG, TINY, packed)
