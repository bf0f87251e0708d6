"""lapha_tpu_torch's Phi-3 serving and training path against lapha_tpu (CPU,
f32): head dim 96 in the flash attention (forward and backward) and the
ragged decode attention, the config parse of every dense family whose
windows the port now takes, the loader's split of the fused ``qkv_proj`` /
``gate_up_proj`` mats (bf16, int8, int4), the model (logits, decode over
the full-S cache), greedy engine tokens with a prompt past the window (the
windowed-short install with every layer sliding, so the full-attention
stack is empty), int8 weights and int8 KV, and one ``make_update_fn`` step.

The tiny checkpoint (``Phi3ForCausalLM`` written by transformers): 2 layers,
H 192, 2/2 heads of dim 96 (Phi-3-mini's head dim and MHA layout), I 256,
a 16-token sliding window, random RMS scales.

The JAX side runs as its own tests run it on the CPU, jitted: the Pallas
kernels in interpret mode (``attn_impl="pallas"`` for the training forward
and its K2 backward), the model's dense paths elsewhere.

Tolerances: the attention plain versions within 1e-5 of the interpret-mode
kernels (the same f32 softmax summed in another order); logits, hidden
states and log-probs within 1e-4; gradients, loss and the update within
atol 1e-4 + rtol 1e-4 (tests/test_torch_gemma_train.py, with its allowance
for Adam's first step on gradients that are f32 noise near 0); loaded
leaves equal bit for bit; greedy token ids exactly equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import PHI3_MINI_4K_CONFIG, STARCODER2_3B_CONFIG
from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import loader as jloader
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import flash_attention as jfa
from lapha_tpu.ops.ragged_decode_attention import ragged_decode_attention as j_ragged
from lapha_tpu.train import losses as jl
from lapha_tpu_torch.engine import Engine, SamplingParams
from lapha_tpu_torch.models import loader, qwen2
from lapha_tpu_torch.ops import flash_attention as tfa
from lapha_tpu_torch.ops.ragged_decode_attention import ragged_decode_attention as t_ragged
from lapha_tpu_torch.train import losses as tl
from lapha_tpu_torch.train import optim as topt

ATOL = 1e-4
OP_ATOL = 1e-5
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
V = 512
W = 16  # the tiny checkpoint's sliding window
TINY = dict(vocab_size=V, hidden_size=192, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256,
            sliding_window=W)


class IdTok:
    """Prompts are space-separated token ids."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static))


def _assert_trees_equal(jtree, ttree, path=""):
    """Every leaf of the JAX tree equals the port's, dtype and bit pattern."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _assert_trees_equal(jtree[k], ttree[k], f"{path}/{k}")
        return
    a = np.asarray(jtree)
    if ttree.dtype == torch.bfloat16:
        assert a.dtype == jnp.bfloat16, (path, a.dtype)
        a, b = a.view(np.int16), ttree.view(torch.int16).numpy()
    else:
        b = ttree.numpy()
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=path)


# ---------------------------------------------------------------- config parse

_BASE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_hidden_layers=4,
             num_attention_heads=4, num_key_value_heads=2)
PARSE_CASES = {
    "qwen2_window_off": dict(_BASE, model_type="qwen2", sliding_window=32,
                             use_sliding_window=False),
    "qwen2_window_on": dict(_BASE, model_type="qwen2", sliding_window=32,
                            use_sliding_window=True, max_window_layers=0),
    "qwen2_window_mixed": dict(_BASE, model_type="qwen2", sliding_window=32,
                               use_sliding_window=True, max_window_layers=2),
    "qwen2_window_default_layers": dict(_BASE, model_type="qwen2", sliding_window=32,
                                        use_sliding_window=True),
    "qwen3": dict(_BASE, model_type="qwen3", head_dim=24, sliding_window=None,
                  rope_theta=1000000.0),
    "llama": dict(_BASE, model_type="llama", tie_word_embeddings=False, rope_theta=500000.0,
                  rope_scaling={"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192}),
    "mistral": dict(_BASE, model_type="mistral", sliding_window=4096, rms_norm_eps=1e-5),
    "mixtral": dict(_BASE, model_type="mixtral", sliding_window=4096, num_local_experts=8,
                    num_experts_per_tok=2),
    "phi3": PHI3_MINI_4K_CONFIG,
    "starcoder2": STARCODER2_3B_CONFIG,
}
FIELDS = [f.name for f in dataclasses.fields(qwen2.Qwen2Config) if f.name != "dtype"]


@pytest.mark.parametrize("name", list(PARSE_CASES))
def test_from_hf_parses_like_jax(name):
    """``Qwen2Config.from_hf`` of the port equals JAX's, field for field,
    for qwen2 (use_sliding_window off, on for every layer, mixed by
    max_window_layers, and on with the HF default of 28 window-free layers),
    qwen3, llama, mistral, mixtral and the published Phi-3-mini-4k and
    StarCoder2-3B configs; the port refuses none of them."""
    hf = PARSE_CASES[name]
    j, t = JCfg.from_hf(hf), qwen2.Qwen2Config.from_hf(hf)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    assert t.head_dim_ == j.head_dim_ and t.max_window_ == j.max_window_
    expected = {"qwen2_window_off": (0, ()), "qwen2_window_on": (32, ()),
                "qwen2_window_mixed": (0, (0, 0, 32, 32)),
                "qwen2_window_default_layers": (0, ()), "mistral": (4096, ()),
                "mixtral": (4096, ()), "phi3": (2047, ()), "starcoder2": (4096, ())}
    if name in expected:
        assert (t.sliding_window, t.layer_windows) == expected[name]
    if name == "phi3":
        assert t.fused_qkv and t.head_dim_ == 96 and not t.tie_word_embeddings
    if name == "starcoder2":
        assert (t.norm_style, t.mlp_style, t.o_proj_bias, t.attention_bias) == (
            "layernorm", "plain", True, True)
        assert t.num_attention_heads // t.num_key_value_heads == 12 and t.tie_word_embeddings


def test_phi3_refusals_are_jax_s():
    """Partial rotary (phi-4-mini) and longrope (the 128k variants) are
    refused by both packages."""
    for extra, what in (({"partial_rotary_factor": 0.75}, "partial_rotary_factor"),
                        ({"rope_scaling": {"type": "longrope", "long_factor": [1.0],
                                           "short_factor": [1.0]}}, "longrope")):
        hf = dict(PHI3_MINI_4K_CONFIG, **extra)
        for cls in (JCfg, qwen2.Qwen2Config):
            with pytest.raises(ValueError, match=what):
                cls.from_hf(hf)


# ---------------------------------------------------------------- kernels at head dim 96

def test_flash_dh96_forward_and_backward_match_jax():
    """The flash attention's plain versions at head dim 96 (no-cache with
    a padded row, banded and full; cached with per-row qstart) and the
    gradients through the autograd Function, against the interpret-mode
    Pallas K1 / K3 / K2."""
    rng = np.random.default_rng(3)
    B, T, nh, nkv, dh = 2, 40, 4, 2, 96
    q = rng.normal(size=(B, T, nh, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, T, nkv, dh)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(B, T, nh, dh)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 30:] = 0
    real = mask[:, :, None, None].astype(np.float32)
    for window in (0, W):
        def jloss(q_, k_, v_):
            out = jfa.flash_attention(q_, k_, v_, jnp.asarray(mask), window=window, block_q=16,
                                      block_k=16, interpret=True)
            return jnp.sum(out * jnp.asarray(do * real)), out

        (_, j_out), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
        leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
        out = tfa.flash_attention(*leaves, _t(mask), window=window)
        np.testing.assert_allclose((out * _t(real)).detach().numpy(), np.asarray(j_out) * real,
                                   atol=OP_ATOL, rtol=0)
        tg = torch.autograd.grad(out, leaves, _t(do * real))
        for name, a, b in zip(("dq", "dk", "dv"), tg, jg):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0,
                                       err_msg=f"{name} W={window}")
    S, Tn = 64, 24
    q = rng.normal(size=(B, Tn, nh, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, nkv, dh)).astype(np.float32) for _ in range(2))
    qs = np.asarray([40, 7], np.int32)
    kv_valid = (np.arange(S)[None, :] < (qs + Tn)[:, None]).astype(np.int32)
    for window in (0, W):
        j_out = jfa.flash_attention_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(kv_valid), jnp.asarray(qs), window=window,
                                           block_q=8, block_k=16, interpret=True)
        t_out = tfa.flash_attention_cached(_t(q), _t(k), _t(v), _t(kv_valid), _t(qs),
                                           window=window)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=OP_ATOL, rtol=0)


def test_ragged_decode_dh96_matches_jax():
    """ragged_decode_plain at head dim 96 (Phi-3's group of 1 and a group
    of 4), full and window-clipped ranges, against the interpret-mode
    Pallas ragged kernel."""
    rng = np.random.default_rng(4)
    L, B, S, dh, slot = 2, 3, 128, 96, 90
    lens = np.asarray([40, 64, 10], np.int32)
    dstart = np.full(B, 64, np.int32)
    pstart = np.clip(lens + (slot - 64) - W + 1, 0, lens).astype(np.int32)
    dstart_w = np.maximum(dstart, slot - W + 1).astype(np.int32)
    for nh, nkv in ((2, 2), (8, 2)):
        q = rng.normal(size=(B, nh, dh)).astype(np.float32)
        k, v = (rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32) for _ in range(2))
        for ps, ds in ((None, dstart), (pstart, dstart_w)):
            j_out = j_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1,
                             jnp.asarray(lens), jnp.asarray(ds), jnp.asarray(slot, jnp.int32),
                             pstart=None if ps is None else jnp.asarray(ps), block_k=32,
                             interpret=True)
            t_out = t_ragged(_t(q), _t(k), _t(v), 1, _t(lens), _t(ds), slot,
                             None if ps is None else _t(ps))
            np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=OP_ATOL,
                                       rtol=0)


# ---------------------------------------------------------------- checkpoint and model

@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A tiny random Phi3ForCausalLM checkpoint at head dim 96."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers would import TensorFlow (~10 s), unused
        transformers = pytest.importorskip("transformers")
    torch.manual_seed(11)
    model = transformers.Phi3ForCausalLM(transformers.Phi3Config(
        rope_theta=10000.0, tie_word_embeddings=False, torch_dtype="float32", pad_token_id=0,
        bos_token_id=1, eos_token_id=2, **TINY)).eval()
    with torch.no_grad():  # random RMS scales, so that a misplaced norm shows
        for name, w in model.named_parameters():
            if name.endswith("norm.weight"):
                w.normal_(1.0, 0.3)
    d = str(tmp_path_factory.mktemp("tiny_phi3"))
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
    assert t.head_dim_ == 96 and t.sliding_window == W and t.fused_qkv


@pytest.mark.parametrize("dtype,quantize", [("float32", None), ("bfloat16", None),
                                            ("bfloat16", "int8"), ("bfloat16", "int4")])
def test_checkpoint_loads_like_jax(hf_dir, dtype, quantize):
    """Both loaders give the same leaves, bit for bit: the fused qkv_proj
    split [q; k; v] and gate_up_proj [gate; up] on the out dim, each piece
    quantized as a per-tensor mat (int4 where the in-dim splits into whole
    group-128 halves: the down projection), zero q/k/v biases."""
    jp, _ = jloader.load_params(hf_dir, dtype=getattr(jnp, dtype), quantize=quantize)
    tp, _ = loader.load_params(hf_dir, dtype=getattr(torch, dtype), device="cpu",
                               quantize=quantize)
    _assert_trees_equal(jp, tp)
    attn, mlp = tp["layers"]["attn"], tp["layers"]["mlp"]
    if quantize is None:
        assert tuple(attn["q_proj"]["w"].shape) == (2, 192, 192)
        assert tuple(attn["k_proj"]["w"].shape) == (2, 192, 192)
        assert tuple(mlp["gate_proj"]["w"].shape) == (2, 192, 256)
    down = mlp["down_proj"]["w"]
    assert (isinstance(down, dict) and "s4" in down) == (quantize == "int4")
    _assert_trees_equal(jp, loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))


def test_params_have_the_jax_layout():
    """The port's init builds the JAX init's tree (keys, shapes, dtypes)."""
    small = dict(PHI3_MINI_4K_CONFIG, **TINY)
    jcfg = dataclasses.replace(JCfg.from_hf(small), dtype=jnp.float32)
    tcfg = dataclasses.replace(qwen2.Qwen2Config.from_hf(small), dtype=torch.float32)
    jtree = jax.tree_util.tree_map(np.asarray, jq.init_params(jcfg, jax.random.key(0)))
    own = qwen2.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype), jtree)
    assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.numpy().dtype), own)


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
def test_decode_step_matches_jax_and_forward(model, int8):
    """decode_step over the full-S cache (every layer through the window's
    clipped ranges) against JAX's dense decode_step, three steps past the
    window, bf16 and int8 caches; the f32 cache's steps also against the
    full forward."""
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
    seq = [list(ids[b, :lens[b]]) for b in range(B)]
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
            continue
        for b in range(B):
            seq[b].append(nxt[b])
            fl, _, _ = qwen2.forward(tp, tcfg, _t(np.asarray(seq[b])[None]))
            np.testing.assert_allclose(out[0].numpy()[b], fl.numpy()[0, -1], atol=ATOL, rtol=0)


KW = dict(max_model_len=128, max_batch=4, decode_chunk=8, pad_multiple=32, batch_bucket=2,
          eos_token_ids=[1], prefix_cache_min_reuse=16, collect_h0=True)


@pytest.mark.parametrize("weights,kv_quant", [(None, None), (None, "int8"), ("int8", None)])
def test_engine_greedy_tokens_match_jax_engine(hf_dir, model, weights, kv_quant, monkeypatch):
    """Greedy token ids equal the JAX engine's exactly: prompts of 70 and 45
    tokens, past the 16-token window, so that the windowed-short install
    runs with every layer in the short stack and none in the full one;
    prefix-hit children; f32 weights with f32 and int8 KV, and int8
    weights; logprobs and pooled h0 within 1e-4."""
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
    assert full_layers == [0, 0]  # the full-attention stack is empty
    assert teng.prefix_cache.hits == jeng.prefix_cache.stats()["hits"] == 1


# ---------------------------------------------------------------- training

LOSS_KW = dict(temperature=0.7, eps_low=0.2, eps_high=0.28, loss_type="grpo",
               importance_level="token", value_w=0.5, beta=0.0, max_completion_length=16)


def _packed():
    """4 ragged rows of 12-token prompts and 5-14-token completions (32
    columns: past the 16-token window), advantages and value targets."""
    rng = np.random.default_rng(2)
    samples = [dict(prompt_ids=rng.integers(2, V, 12).tolist(),
                    completion_ids=rng.integers(2, V, 5 + 3 * i).tolist()) for i in range(4)]
    packed = jl.pack_samples(samples, pad_id=0, eos_id=1, max_prompt_length=16,
                             pad_multiple=16, batch_multiple=4)
    packed["advantages"] = np.array([1.0, -0.5, 0.5, -0.2], np.float32)
    packed["v_target"] = np.array([1.0, 0.0, 0.5, 0.2], np.float32)
    return packed


def _trees(hf_config, tiny):
    """(jcfg with the Pallas attention in interpret mode, tcfg, the port's
    init as one numpy tree with random norm scales and biases, a value
    head) for a published config cut to ``tiny``."""
    small = dict(hf_config, **tiny)
    jcfg = dataclasses.replace(JCfg.from_hf(small), dtype=jnp.float32, attn_impl="pallas")
    tcfg = dataclasses.replace(qwen2.Qwen2Config.from_hf(small), dtype=torch.float32)
    tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                  qwen2.init_params(tcfg, torch.Generator().manual_seed(5)))
    rng = np.random.default_rng(41)

    def jitter(node):  # norms about 1 and biases about 0, so that each shows
        for key, val in node.items():
            if isinstance(val, dict):
                jitter(val)
            elif key in ("scale", "b", "bias"):
                node[key] = (val + rng.normal(size=val.shape) * 0.3).astype(np.float32)

    jitter(tree)
    head = jax.tree_util.tree_map(np.asarray,
                                  jvm.init_value_head(tcfg.hidden_size, jax.random.key(1)))
    return jcfg, tcfg, tree, head


def _step_dir(mu):
    """Adam's first step over lr for each element: lr·g/(|g| + 1e-8), g the
    clipped gradient (= 10·mu)."""
    g = 10.0 * np.asarray(mu, np.float64)
    return g / (np.abs(g) + 1e-8)


def check_update_step_matches_jax(hf_config, tiny, packed):
    """Gradients of loss_and_metrics, every leaf (each layer's weights
    non-zero), then one make_update_fn step (clip, Adam with f32 mu, lr
    1e-3) of each side on the same weights and batch: loss, grad norm,
    Adam's mu and the params after the step within GRAD_TOL plus the
    difference the two sides' own gradients make to Adam's first step."""
    jcfg, tcfg, tree, head = _trees(hf_config, tiny)
    jbatch = {k: jnp.asarray(v) for k, v in packed.items() if k != "kept"}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda ph: jl.loss_and_metrics(ph[0], ph[1], jbatch, jcfg, remat=False, **LOSS_KW),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, (tree, head)))
    tp, th = loader.params_from_numpy(tree), loader.params_from_numpy(head)
    leaves = tl._trainable(tp, th)
    tloss, _ = tl.loss_and_metrics(tp, th, tl.batch_to_device(packed, "cpu"), tcfg,
                                   remat="full", logits_chunk=8, **LOSS_KW)
    tg = torch.autograd.grad(tloss, leaves)
    names = [p for p, _ in tl.tree_paths((tp, th))]
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **GRAD_TOL)
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(names) == len(jleaves)
    for name, a, b in zip(names, tg, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **GRAD_TOL)
        if name.startswith("0.layers.") and not name.endswith("k_proj.b"):
            assert (a.flatten(1).abs().amax(1) > 0).all(), name

    lr = 1e-3
    chain = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.scale_by_adam(b1=0.9, b2=0.999, mu_dtype=jnp.float32),
                        optax.scale_by_learning_rate(lr))
    jp, jh = jax.tree_util.tree_map(jnp.asarray, (tree, head))
    jstep = jl.make_update_fn(jcfg, chain, loss_kwargs=dict(LOSS_KW, remat=False))
    jp, jh, jstate, jm = jstep(jp, jh, chain.init((jp, jh)), jbatch)
    opt = topt.AdamChain(topt.constant_schedule(lr), max_grad_norm=1.0)
    tstate = opt.init(tl.tree_leaves((tp, th)))
    tstep = tl.make_update_fn(tcfg, opt, loss_kwargs=dict(LOSS_KW, remat="full"))
    tp, th, tstate, tm = tstep(tp, th, tstate, tl.batch_to_device(packed, "cpu"))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **GRAD_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **GRAD_TOL)
    after = jax.tree_util.tree_leaves((jp, jh))
    mu = jax.tree_util.tree_leaves(jstate[1].mu)
    for name, t, j, tmu, jmu in zip(names, tl.tree_leaves((tp, th)), after, tstate["mu"], mu):
        j, jmu = np.asarray(j), np.asarray(jmu)
        excess = (np.abs(t.detach().numpy() - j) - GRAD_TOL["atol"] - GRAD_TOL["rtol"] * np.abs(j)
                  - lr * np.abs(_step_dir(jmu) - _step_dir(tmu.numpy())))
        assert excess.max() <= 0, (name, float(excess.max()))
        np.testing.assert_allclose(tmu.numpy(), jmu, err_msg=f"mu {name}", **GRAD_TOL)


def test_update_step_matches_jax():
    """Phi-3 at head dim 96, every layer sliding (the 16-token window
    bites in the 32-column batch): the JAX side's flash forward and K2 in
    interpret mode at dh 96."""
    packed = _packed()
    assert packed["ids"].shape[1] > W
    check_update_step_matches_jax(PHI3_MINI_4K_CONFIG, TINY, packed)
