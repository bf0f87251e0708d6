"""lapha_tpu_torch's DeepSeek MLA serving path against lapha_tpu (CPU, f32):
the config from HF (the published DeepSeek-V2-Lite dict and a V3 dict), the
flash attention with V narrower than Q/K (the plain version of K1/K3
against the interpret-mode Pallas kernels), ``route_deepseek`` in its three
modes, the model (no-cache and cache-threaded forward, the absorbed decode
over bf16-layout and int8 latent caches), the loader on tiny HF V2/V3
checkpoints, greedy engine tokens, the value model and ValueFunction, and
the parts that still raise.

The tiny model is tests/test_deepseek.py's: 3 layers (one dense, two MoE),
H 64, 4 heads, kv_lora_rank 32, qk nope 16 + rope 8 (Q/K 24) and V 16, 8
experts top-2 of width 24 and one shared expert. Weights go from the JAX
tree to the port through ``loader.params_from_numpy``.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode (``attn_impl="pallas"``) or the dense attention, jitted.

Tolerances: the attention plain version within 1e-5 of the interpret-mode
kernels (the same f32 softmax summed in another order); routing indices
exactly equal, weights within 1e-6; logits, hidden states and latent caches
within 1e-4 (as the dense model's tests); loaded leaves equal bit for bit;
greedy token ids exactly equal; pooled h0 and values within 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import DEEPSEEK_V2_LITE_CONFIG
from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.models import deepseek as jd
from lapha_tpu.models import loader as jloader
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops import flash_attention as jfa
from lapha_tpu.ops import moe as jmoe
from lapha_tpu.search.value_fn import ValueFunction as JValueFunction
from lapha_tpu_torch.engine import Engine, SamplingParams
from lapha_tpu_torch.models import deepseek as td
from lapha_tpu_torch.models import loader, model_module, qwen2, value_model
from lapha_tpu_torch.ops import flash_attention as tfa
from lapha_tpu_torch.ops import moe
from lapha_tpu_torch.search import ValueFunction

ATOL = 1e-4
OP_ATOL = 1e-5
W_ATOL = 1e-6
V = 512
TINY = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
            num_attention_heads=4, q_lora_rank=0, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, num_experts_per_tok=2,
            moe_intermediate_size=24, n_shared_experts=1, first_k_dense_replace=1)


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


def _pair(seed=0, **kw):
    """(jcfg, jparams, tcfg, tparams): one random JAX tree, carried across."""
    jcfg = jd.DeepseekConfig(**{**TINY, **kw}, dtype=jnp.float32)
    tcfg = td.DeepseekConfig(**{**TINY, **kw}, dtype=torch.float32)
    jp = jax.jit(jd.init_params, static_argnums=0)(jcfg, jax.random.key(seed))
    if "moe_layers" in jp and "bias" in jp["moe_layers"]["moe"]["router"]:
        # a zero correction bias would make noaux_tc unbiased
        b = jp["moe_layers"]["moe"]["router"]["bias"]
        jp["moe_layers"]["moe"]["router"]["bias"] = jnp.asarray(
            np.random.default_rng(seed).normal(size=b.shape) * 0.5, jnp.float32)
    return jcfg, jp, tcfg, loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def v2():
    """V2-Lite-shaped: full q, softmax scores, greedy routing."""
    return _pair(0)


# ---------------------------------------------------------------- config

V3_CONFIG = dict(DEEPSEEK_V2_LITE_CONFIG, model_type="deepseek_v3", q_lora_rank=1536,
                 scoring_func="sigmoid", topk_method="noaux_tc", n_group=8, topk_group=4,
                 norm_topk_prob=True, routed_scaling_factor=2.5, rope_interleave=True,
                 rope_scaling={"type": "yarn", "factor": 40, "mscale": 1.0, "mscale_all_dim": 1.0,
                               "beta_fast": 32, "beta_slow": 1,
                               "original_max_position_embeddings": 4096})
PROPS = ("qk_head_dim_", "cache_width_", "num_dense_layers_", "num_moe_layers_", "attn_scale_",
         "num_key_value_heads", "head_dim_", "max_window_", "embed_normalizer", "final_softcap")


@pytest.mark.parametrize("name", ["v2_lite", "v3"])
def test_from_hf_matches_jax(name):
    """DeepSeek-V2-Lite's published config.json (chip_smoke's dict) and a V3
    dict (q_lora, sigmoid/noaux_tc, YaRN with mscale_all_dim) parse to the
    JAX config field for field; the refusals are JAX's."""
    cfg = DEEPSEEK_V2_LITE_CONFIG if name == "v2_lite" else V3_CONFIG
    j, t = jd.DeepseekConfig.from_hf(cfg), td.DeepseekConfig.from_hf(cfg)
    fields = [f.name for f in dataclasses.fields(t) if f.name != "dtype"]
    assert set(fields) == {f.name for f in dataclasses.fields(j)} - {"dtype", "attn_impl"}
    for f in fields + list(PROPS):
        assert getattr(t, f) == getattr(j, f), f
    if name == "v2_lite":
        assert (t.num_hidden_layers, t.num_dense_layers_, t.n_routed_experts) == (27, 1, 64)
        assert t.qk_head_dim_ == 192 and t.v_head_dim == 128 and t.cache_width_ == 576
        assert t.attn_mscale_sq == 1.0 and t.rope_scaling[:3] == ("yarn", 40.0, 1.0)
    else:
        # (0.1 ln 40 + 1)^2: V3's softmax-scale correction
        assert abs(t.attn_mscale_sq - 1.8738542070926265) < 1e-12 and t.q_lora_rank == 1536
    for bad in ({"attention_bias": True}, {"moe_layer_freq": 2}, {"model_type": "qwen2"}):
        with pytest.raises(ValueError):
            td.DeepseekConfig.from_hf(dict(cfg, **bad))


def test_params_have_the_jax_layout():
    """The port's init builds the JAX init's tree (keys, shapes, dtypes),
    for both q forms and the sigmoid router's bias."""
    for kw in ({}, {"q_lora_rank": 24, "scoring_func": "sigmoid"}):
        jcfg = jd.DeepseekConfig(**{**TINY, **kw}, dtype=jnp.float32)
        tcfg = td.DeepseekConfig(**{**TINY, **kw}, dtype=torch.float32)
        jtree = jax.eval_shape(functools.partial(jd.init_params, jcfg), jax.random.key(0))
        own = td.init_params(tcfg, torch.Generator().manual_seed(0))
        shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), np.dtype(a.dtype)), jtree)
        assert shapes == jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.numpy().dtype), own)
    ck, cv = td.init_kv_cache(tcfg, 4, 32)
    assert ck.shape == cv.shape == (3, 4, 32, 1, 40)
    assert model_module(tcfg) is td and model_module(qwen2.Qwen2Config.tiny()) is qwen2


# ---------------------------------------------------------------- attention

def test_flash_narrow_v_matches_jax():
    """The plain version of K1/K3 with V narrower than Q/K (Q/K 24, V 16,
    MLA's 192/128 scaled down, nh = nkv as MLA expands per head): the
    no-cache forward with padded rows and the cached forward with per-row
    qstart and a hole in kv_valid, against the interpret-mode Pallas
    kernels."""
    rng = np.random.default_rng(1)
    B, T, nh, dh, dv, scale = 3, 40, 4, 24, 16, 0.3
    q, k = (rng.normal(size=(B, T, nh, dh)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, T, nh, dv)).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 30:] = 0
    j_out = jfa.flash_attention(*map(jnp.asarray, (q, k, v, mask)), scale=scale, block_q=16,
                                block_k=16, interpret=True)
    t_out = tfa.flash_attention(_t(q), _t(k), _t(v), _t(mask), scale=scale)
    assert t_out.shape == (B, T, nh, dv)
    real = mask[:, :, None, None] > 0
    _close(t_out * _t(real), np.asarray(j_out) * real, OP_ATOL)

    S, Tn = 72, 24
    q = rng.normal(size=(B, Tn, nh, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, nh, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, nh, dv)).astype(np.float32)
    qs = np.asarray([40, 0, 13], np.int32)
    kv_valid = (np.arange(S)[None, :] < (qs + Tn)[:, None]).astype(np.int32)
    kv_valid[2, 5:9] = 0
    j_out = jfa.flash_attention_cached(*map(jnp.asarray, (q, k, v, kv_valid, qs)), scale=scale,
                                       block_q=16, block_k=16, interpret=True)
    _close(tfa.flash_attention_cached(_t(q), _t(k), _t(v), _t(kv_valid), _t(qs), scale=scale),
           j_out, OP_ATOL)


def test_narrow_v_launch_names():
    """Launches with V narrower than Q/K count under their own names, which
    the launch counters hold."""
    from lapha_tpu_torch.ops import _cuda

    for name in ("flash_attention", "flash_attention_cached"):
        assert tfa.launch_name(name, narrowv=True) == name + "_narrowv"
        for w in (0, 8):
            for cap in (0.0, 5.0):
                assert tfa.launch_name(name, w, cap, narrowv=True) in _cuda.LAUNCHES
    assert (192, 128) in tfa.FWD_HEAD_DIMS


# ---------------------------------------------------------------- routing

ROUTES = {
    "softmax_greedy": dict(scoring="softmax", topk_method="greedy", n_group=1, topk_group=1,
                           norm_topk=False, routed_scaling_factor=1.0),
    "softmax_group_limited": dict(scoring="softmax", topk_method="group_limited_greedy",
                                  n_group=4, topk_group=2, norm_topk=True,
                                  routed_scaling_factor=1.5),
    "sigmoid_noaux_tc": dict(scoring="sigmoid", topk_method="noaux_tc", n_group=4,
                             topk_group=2, norm_topk=True, routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("mode", list(ROUTES))
def test_route_deepseek_matches_jax(mode):
    """route_deepseek against JAX's: indices exactly equal (in order),
    weights within 1e-6. In the sigmoid mode a strongly negative bias on
    some experts puts chosen scores below the 0.0 of the masked groups, so
    the top-k meets exact ties at 0.0, which both sides break by expert
    index."""
    kw = ROUTES[mode]
    rng = np.random.default_rng(2)
    N, H, E = 64, 32, 16
    x = rng.normal(size=(N, H)).astype(np.float32)
    w = (rng.normal(size=(H, E)) * 0.3).astype(np.float32)
    bias = None
    if kw["scoring"] == "sigmoid":
        bias = (rng.normal(size=E) * 0.5).astype(np.float32)
        bias[:6] = -3.0
    jw, ji = jmoe.route_deepseek(jnp.asarray(x), jnp.asarray(w),
                                 None if bias is None else jnp.asarray(bias), top_k=6, **kw)
    tw, ti = moe.route_deepseek(_t(x), _t(w), None if bias is None else _t(bias), top_k=6, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, W_ATOL)
    if bias is not None:  # the masked zeros were chosen: exact ties met
        choice = 1 / (1 + np.exp(-(x @ w))) + bias
        assert (np.take_along_axis(choice, ti.numpy().astype(np.int64), -1) < 0).any()


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("q_lora,interleave", [(0, True), (24, False)])
def test_forward_matches_jax(q_lora, interleave):
    """No-cache forward of padded rows (both q forms, both rope
    conventions, V3's sigmoid router with the q_lora form): logits, final
    hidden and the latent stack within 1e-4, against JAX's interpret-mode
    Pallas K1 (the full-q form) and its dense attention (the q_lora form)."""
    kw = {"q_lora_rank": q_lora, "rope_interleave": interleave}
    if q_lora:
        kw.update(scoring_func="sigmoid", topk_method="noaux_tc", n_group=4, topk_group=2,
                  norm_topk_prob=True, routed_scaling_factor=2.5)
    jcfg, jp, tcfg, tp = _pair(3, **kw)
    ids = np.random.default_rng(4).integers(0, V, (3, 20))
    mask = np.ones((3, 20), np.int32)
    mask[1, 14:] = 0
    real = mask > 0
    impl = "dense" if q_lora else "pallas"
    jl, jh, jlat = _jit(jd.forward, cfg=dataclasses.replace(jcfg, attn_impl=impl),
                        return_hidden=True, return_latent=True)(
        jp, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    tl, th, tlat = td.forward(tp, tcfg, _t(ids), attention_mask=_t(mask), return_hidden=True,
                              return_latent=True)
    for a, b in ((tl, jl), (th, jh)):
        np.testing.assert_allclose(a.numpy()[real], np.asarray(b)[real], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlat.numpy()[:, real], np.asarray(jlat)[:, real], atol=ATOL,
                               rtol=0)
    assert tlat.shape == (3, 3, 20, 40)
    none, _, _ = td.forward(tp, tcfg, _t(ids), attention_mask=_t(mask), compute_logits=False)
    assert none is None


@pytest.mark.parametrize("per_row", [False, True])
def test_cached_forward_matches_jax(v2, per_row):
    """Cache-threaded forward: a fresh prefill at cache_pos 0, then a
    suffix at a scalar or per-row cache_pos over the reused latents;
    logits and the latent cache within 1e-4 of JAX (Pallas K3 in interpret
    mode); the inert second plane untouched."""
    jcfg, jp, tcfg, tp = v2
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas")
    rng = np.random.default_rng(5)
    B, T, S = 2, 12, 32
    ids = rng.integers(0, V, (B, T))
    kvv = np.zeros((B, S), bool)
    kvv[:, :T] = True
    pos = np.broadcast_to(np.arange(T)[None], (B, T))
    jfwd = _jit(jd.forward, cfg=jcfg)
    jl, _, jc = jfwd(jp, input_ids=jnp.asarray(ids), positions=jnp.asarray(pos),
                     kv_cache=jd.init_kv_cache(jcfg, B, S), cache_pos=0, kv_valid=jnp.asarray(kvv))
    tc = td.init_kv_cache(tcfg, B, S)
    tl, _, tc = td.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0,
                           kv_valid=_t(kvv))
    _close(tl, jl, ATOL)
    _close(tc[0], jc[0], ATOL)
    starts = np.asarray([12, 7] if per_row else [12, 12])
    suf = rng.integers(0, V, (B, 4))
    ar = np.arange(S)[None, :]
    kvv2 = (ar < starts[:, None] + 4) & (kvv | (ar >= starts[:, None]))
    pos2 = starts[:, None] + np.arange(4)[None, :]
    cp_j = jnp.asarray(starts, jnp.int32) if per_row else 12
    cp_t = _t(starts) if per_row else 12
    jl, _, jc = jfwd(jp, input_ids=jnp.asarray(suf), positions=jnp.asarray(pos2), kv_cache=jc,
                     cache_pos=cp_j, kv_valid=jnp.asarray(kvv2))
    tl, _, tc = td.forward(tp, tcfg, _t(suf), positions=_t(pos2), kv_cache=tc, cache_pos=cp_t,
                           kv_valid=_t(kvv2))
    _close(tl, jl, ATOL)
    _close(tc[0], jc[0], ATOL)
    assert (tc[1] == 0).all()


@pytest.mark.parametrize("int8", [False, True])
def test_decode_step_matches_jax_and_forward(v2, int8):
    """The absorbed decode over the latent cache for three steps: logits,
    hidden and the cache (and its scales) within 1e-4 of JAX's, with the
    bf16-layout cache also against the full forward; the int8 cache is the
    Engine's quantization of the prefilled cache."""
    jcfg, jp, tcfg, tp = v2
    rng = np.random.default_rng(6)
    B, Lp, S = 2, 12, 20
    lens = np.asarray([12, 9], np.int32)
    ids = rng.integers(0, V, (B, Lp))
    mask = (np.arange(Lp)[None, :] < lens[:, None]).astype(np.int32)
    kvv = np.zeros((B, S), bool)
    kvv[:, :Lp] = mask > 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    tc = td.init_kv_cache(tcfg, B, S)
    td.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0, kv_valid=_t(kvv))
    ck, cv = (c.permute(0, 1, 3, 2, 4).contiguous() for c in tc)
    scl = jscl = None
    if int8:
        ck, cv, scl = Engine._quantize_cache(ck, cv)
        jscl = tuple(jnp.asarray(s.numpy()) for s in scl)
    jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    jstep = _jit(jd.decode_step, cfg=jcfg, return_hidden=True)
    seq = [list(ids[b, :lens[b]]) for b in range(B)]
    dstart = torch.full((B,), Lp, dtype=torch.int32)
    for t in range(3):
        nxt = rng.integers(0, V, (B,))
        p = lens + t
        out = td.decode_step(tp, tcfg, _t(nxt), _t(p.astype(np.int64)), ck, cv, Lp + t,
                             _t(lens), dstart, return_hidden=True, cache_scale=scl)
        jout = jstep(jp, tok=jnp.asarray(nxt), positions=jnp.asarray(p), cache_k=jck,
                     cache_v=jcv, slot=jnp.asarray(Lp + t, jnp.int32), lens=jnp.asarray(lens),
                     dstart=jnp.full((B,), Lp, jnp.int32), cache_scale=jscl)
        _close(out[0], jout[0], ATOL)
        _close(out[1], jout[1], ATOL)
        jck, jcv = jout[2], jout[3]
        _close(out[2].float(), jck.astype(jnp.float32), ATOL)
        if int8:
            jscl = jout[4]
            _close(out[4][0], jscl[0], ATOL)
            assert out[2].dtype == torch.int8
            continue
        for b in range(B):
            seq[b].append(nxt[b])
            fl, _, _ = td.forward(tp, tcfg, _t(np.asarray(seq[b])[None]))
            np.testing.assert_allclose(out[0].numpy()[b], fl.numpy()[0, -1], atol=ATOL, rtol=0)


# ---------------------------------------------------------------- loader

@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Tiny DeepseekV2 (full q, group-limited softmax routing) and
    DeepseekV3 (q_lora, sigmoid + a random correction bias, noaux_tc)
    checkpoints written by transformers (tests/test_deepseek.py's)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers would import TensorFlow (~10 s), unused
        transformers = pytest.importorskip("transformers")
    common = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
                  num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, head_dim=8,
                  n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                  moe_intermediate_size=24, first_k_dense_replace=1, n_group=4, topk_group=2,
                  max_position_embeddings=256, rope_theta=10000.0, tie_word_embeddings=False,
                  torch_dtype="float32", attn_implementation="eager")
    dirs = {}
    torch.manual_seed(5)
    m2 = transformers.DeepseekV2ForCausalLM(transformers.DeepseekV2Config(
        q_lora_rank=None, topk_method="group_limited_greedy", routed_scaling_factor=1.0,
        norm_topk_prob=False, **common)).eval()
    torch.manual_seed(6)
    m3 = transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(
        q_lora_rank=24, routed_scaling_factor=2.5, norm_topk_prob=True, rope_interleave=True,
        **common)).eval()
    for layer in m3.model.layers:
        if hasattr(layer.mlp, "gate"):
            layer.mlp.gate.e_score_correction_bias.data = torch.randn(8) * 0.5
    for name, model in (("v2", m2), ("v3", m3)):
        d = str(tmp_path_factory.mktemp(f"tiny_ds{name}"))
        model.save_pretrained(d, safe_serialization=True)
        dirs[name] = d
    return dirs


@pytest.mark.parametrize("fam", ["v2", "v3"])
def test_checkpoint_loads_like_jax(hf_dirs, fam):
    """Both loaders give the same leaves: bit for bit in bf16 (the router
    bias rounded to bf16, then f32, as JAX has it) and for quantize="int8";
    the config parses alike; params_from_numpy carries the two-group JAX
    tree across unchanged."""
    d = hf_dirs[fam]
    jcfg, tcfg = jloader.load_config(d), loader.load_config(d)
    assert isinstance(tcfg, td.DeepseekConfig)
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    jp, _ = jloader.load_params(d, dtype=jnp.bfloat16)
    tp, cfg = loader.load_params(d, dtype=torch.bfloat16, device="cpu")
    assert cfg.dtype == torch.bfloat16
    _assert_trees_equal(jp, tp)
    _assert_trees_equal(jp, loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    jq, _ = jloader.load_params(d, dtype=jnp.float32, quantize="int8")
    tq, _ = loader.load_params(d, dtype=torch.float32, device="cpu", quantize="int8")
    _assert_trees_equal(jq, tq)
    assert tq["moe_layers"]["moe"]["experts"]["down_proj"]["w"]["q"].dtype == torch.int8
    assert ("bias" in tp["moe_layers"]["moe"]["router"]) == (fam == "v3")
    with pytest.raises(ValueError, match="int8 only"):
        loader.load_params(d, device="cpu", quantize="int4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            td.load_params(d)


# ---------------------------------------------------------------- engine, value

KW = dict(max_model_len=96, max_batch=4, decode_chunk=4, pad_multiple=16, batch_bucket=2,
          eos_token_ids=[], prefix_cache_min_reuse=8, collect_h0=True)


@pytest.fixture(scope="module")
def loaded(hf_dirs):
    """The tiny V3 checkpoint loaded by both packages in f32."""
    jp, jcfg = jloader.load_params(hf_dirs["v3"], dtype=jnp.float32)
    tp, tcfg = loader.load_params(hf_dirs["v3"], dtype=torch.float32, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_engine_greedy_tokens_match_jax_engine(loaded, kv_quant):
    """Greedy token ids equal the JAX engine's exactly, for fresh prompts
    and for prefix-hit children (the per-row suffix prefill into the latent
    plane), over a bf16-layout and an int8 latent cache; logprobs and the
    pooled h0 within 1e-4."""
    jcfg, jp, tcfg, tp = loaded
    jeng = JEngine(jp, jcfg, IdTok(), approx_top_k=False, kv_quant=kv_quant, **KW)
    teng = Engine(tp, tcfg, IdTok(), kv_quant=kv_quant, **KW)
    assert teng._mod is td
    rng = np.random.default_rng(7)

    def prompt(n):
        return " ".join(str(t) for t in rng.integers(2, V, n))

    first = [prompt(20), prompt(13)]
    sp = dict(n=2, temperature=0.0, max_tokens=8)
    for prompts in (first, [first[0] + " " + prompt(5), prompt(9)]):
        jout = jeng.generate(prompts, JSP(**sp))
        tout = teng.generate(prompts, SamplingParams(**sp))
        for jr, tr in zip(jout, tout):
            assert [o.token_ids for o in tr.outputs] == [o.token_ids for o in jr.outputs]
            for jo, to in zip(jr.outputs, tr.outputs):
                np.testing.assert_allclose(to.token_logprobs, np.asarray(jo.token_logprobs),
                                           atol=ATOL, rtol=0)
                np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                           atol=ATOL, rtol=0)
    assert teng.prefix_cache.hits == jeng.prefix_cache.stats()["hits"] == 1


def test_value_model_and_function_match_jax(loaded):
    """value_model.value_forward (through model_module) and ValueFunction
    score a DeepSeek policy as JAX does: y, v and h0 within 1e-4, and the
    pooled scoring."""
    jcfg, jp, tcfg, tp = loaded
    jhead = jvm.init_value_head(jcfg.hidden_size, jax.random.key(3))
    thead = loader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jhead))
    ids = np.random.default_rng(8).integers(2, V, (3, 30))
    attn = np.ones((3, 30), np.int32)
    attn[1, 22:] = 0
    jy, jv, jh = jax.jit(jvm.value_forward, static_argnums=2)(jp, jhead, jcfg, jnp.asarray(ids),
                                                                jnp.asarray(attn))
    ty, tv, th = value_model.value_forward(tp, thead, tcfg, _t(ids), _t(attn))
    for a, b in ((ty, jy), (tv, jv), (th, jh)):
        _close(a, b, ATOL)
    kw = dict(pad_multiple=16, batch_bucket=4)
    jvf, tvf = JValueFunction(jp, jhead, jcfg, **kw), ValueFunction(tp, thead, tcfg, **kw)
    jy, jv, jh0 = jvf(ids, attn, return_h0=True)
    ty, tv, th0 = tvf(ids, attn, return_h0=True)
    for a, b in ((th0, jh0), (ty, jy), (tv, jv)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tvf.from_pooled(th0[1:], root_h0=th0[0])[1],
                               jvf.from_pooled(th0[1:], root_h0=th0[0])[1], atol=ATOL, rtol=0)


# ---------------------------------------------------------------- refusals

def test_unported_parts_raise_naming_their_items(v2, tmp_path):
    """The dispatch impl (A11) and a windowed-short cache raise. export_hf
    and decode_step_multi (A8), which raised here until they were ported,
    now write the tree (the loader reads the export back bit-equal) and
    verify a block (its parity with JAX: tests/test_torch_spec.py)."""
    _, _, tcfg, tp = v2
    ck, cv = (c.permute(0, 1, 3, 2, 4) for c in td.init_kv_cache(tcfg, 1, 8))
    toks, pos = torch.ones((1, 2), dtype=torch.int64), torch.tensor([[0, 1]])
    out = td.decode_step_multi(tp, tcfg, toks, pos, ck, cv, 0, torch.zeros((1, 8), dtype=torch.bool))
    assert out[0].shape == (1, 2, tcfg.vocab_size) and bool(torch.isfinite(out[0]).all())
    td.export_hf(tp, tcfg, str(tmp_path))
    back, _ = loader.load_params(str(tmp_path), cfg=tcfg, dtype=torch.float32, device="cpu")
    assert back.keys() == tp.keys()
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tp)):
        assert torch.equal(a, b)
    ids = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="A11"):
        td.forward(tp, dataclasses.replace(tcfg, moe_impl="dispatch"), ids)
    ck, cv = (c.permute(0, 1, 3, 2, 4) for c in td.init_kv_cache(tcfg, 1, 8))
    one = torch.ones(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="sliding-window"):
        td.decode_step(tp, tcfg, one, one, ck, cv, 2, one, one, win_cache={})
