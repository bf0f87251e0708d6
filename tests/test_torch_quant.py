"""Quantized serving of lapha_tpu_torch against lapha_tpu (CPU, tiny config).

The same inputs, made from numpy seeds, go to both packages; the JAX side
runs as its own tests run it on the CPU (the int4 Pallas kernel in
interpret mode, the dense int8-KV decode path). Tolerances:
- quantized leaves (int8/uint8 values and f32 scales) are EQUAL: both sides
  divide in f32, round half to even and clip in the same order;
- ``int4_matmul_plain`` vs JAX ``int4_matmul``: 5e-3 · max|ref| for both
  kernel versions (version 2 applies the scale before the dot, in bf16), and
  1e-5 relative for version 3 (the same formula, f32 sums in another order);
- logits, hidden states and values in f32: 1e-4 absolute (summation order;
  logits are O(1) at the tiny config) for unquantized and int8 weights.
  With int4 weights the kernel rounds its input to bf16 (JAX's kernel
  does too): an f32 difference of one ulp upstream can move an activation
  across a bf16 rounding boundary, a step of 2^-8 relative, so there the
  bound is 1e-2 absolute (the measured worst is ~3e-3 on per-token hidden
  states, ~2e-4 on pooled ones), while the int4 product itself is held to
  1e-5 relative above;
- greedy engine tokens: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.engine import Engine as JEngine
from lapha_tpu.engine import SamplingParams as JSP
from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import loader as jloader
from lapha_tpu.models import quant as jquant
from lapha_tpu.models import qwen2 as jq
from lapha_tpu.models import value_model as jvm
from lapha_tpu.ops.int4_matmul import int4_matmul as j_int4_matmul
from lapha_tpu.search.value_fn import ValueFunction as JValueFunction
from lapha_tpu_torch.engine import Engine, SamplingParams
from lapha_tpu_torch.models import loader, quant, qwen2
from lapha_tpu_torch.ops import int4_matmul as i4
from lapha_tpu_torch.search import ValueFunction

ATOL = 1e-4
ATOL_INT4 = 1e-2  # bf16 rounding flips of the int4 kernel's input (docstring)
V = 300


def _tol(bits):
    return ATOL_INT4 if bits == 4 else ATOL


class IdTok:
    """Prompts are space-separated token ids."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_trees_equal(jtree, ttree, path=""):
    """Every leaf of the JAX tree equals the port's, dtype and value."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _assert_trees_equal(jtree[k], ttree[k], f"{path}/{k}")
        return
    a, b = np.asarray(jtree), ttree.numpy()
    assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    np.testing.assert_array_equal(b, a, err_msg=path)


@pytest.fixture(scope="module")
def tiny():
    jcfg = JCfg.tiny(vocab_size=V)
    jp = jq.init_params(jcfg, jax.random.key(7))
    tp = loader.params_from_numpy(_np_tree(jp))
    return jcfg, jp, qwen2.Qwen2Config.tiny(vocab_size=V), tp


@pytest.fixture(scope="module")
def quantized(tiny):
    """{bits: (JAX quantized tree, the port's conversion of it)} with int4
    group 32 (the tiny config's H = 64 and I = 128 split into whole groups)."""
    jcfg, jp, tcfg, tp = tiny
    out = {}
    for bits in (4, 8):
        jqp = jquant.quantize_params(jp, bits=bits, group=32)
        out[bits] = (jqp, loader.params_from_numpy(_np_tree(jqp)))
    return out


# ---------------------------------------------------------------- quantization

def test_quantize_weight_equals_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(3, 64, 96)) * 0.3).astype(np.float32)
    w[1, :, 5] = 0.0  # an all-zero channel: the 1e-12 floor scale
    _assert_trees_equal(jquant.quantize_weight(jnp.asarray(w)), quant.quantize_weight(_t(w)))


@pytest.mark.parametrize("group", [16, 32, 64])
def test_quantize_weight_int4_equals_jax(group):
    rng = np.random.default_rng(group)
    w = rng.normal(size=(2, 256, 80)).astype(np.float32)
    jleaf = jquant.quantize_weight_int4(jnp.asarray(w), group)
    tleaf = quant.quantize_weight_int4(_t(w), group)
    _assert_trees_equal(jleaf, tleaf)
    np.testing.assert_array_equal(quant._unpack_int4(tleaf["q"]).numpy(),
                                  np.asarray(jquant._unpack_int4(jleaf["q"])))
    np.testing.assert_array_equal(quant.dequant(tleaf, torch.float32).numpy(),
                                  np.asarray(jquant.dequant(jleaf, jnp.float32)))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_params_equals_jax(tiny, quantized, bits):
    """The whole tree: int4 projections (group 32), int8 embed, untouched
    norms and biases; the JAX side's tree converted by params_from_numpy
    keeps its int8/uint8 values and f32 scales."""
    jcfg, jp, tcfg, tp = tiny
    jqp, converted = quantized[bits]
    tqp = quant.quantize_params(tp, bits=bits, group=32)
    _assert_trees_equal(jqp, tqp)
    _assert_trees_equal(jqp, converted)
    gate = tqp["layers"]["mlp"]["gate_proj"]["w"]
    assert ("s4" in gate) == (bits == 4)
    assert tqp["embed"]["weight"]["q"].dtype == torch.int8
    assert quant.params_nbytes(tqp) == sum(
        leaf.size * leaf.dtype.itemsize for leaf in jax.tree_util.tree_leaves(jqp))
    # a bf16 conversion keeps the scales f32
    bf = loader.params_from_numpy(_np_tree(jqp), dtype=torch.bfloat16)
    assert bf["embed"]["weight"]["s"].dtype == torch.float32
    assert bf["layers"]["input_layernorm"]["scale"].dtype == torch.bfloat16


def test_quantize_host_tree_equals_jax(tiny):
    """Host-side int8 of a numpy tree: the same leaves as the JAX package's,
    placed on the requested device."""
    jcfg, jp, _, _ = tiny
    np_tree = _np_tree(jp)
    jtree = jquant.quantize_host_tree(np_tree)
    ttree = quant.quantize_host_tree(np_tree, device="cpu")
    _assert_trees_equal(jtree, ttree)
    assert ttree["layers"]["attn"]["q_proj"]["w"]["q"].dtype == torch.int8


def test_init_params_quantized_has_the_jax_structure(tiny):
    jcfg, _, tcfg, _ = tiny
    jqp = jquant.init_params_quantized(jcfg, seed=0, bits=4, group=32)
    tqp = quant.init_params_quantized(tcfg, torch.Generator().manual_seed(0), bits=4, group=32)
    jl = jax.tree_util.tree_leaves_with_path(jqp)
    assert len(jl) == len(jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: 0, tqp)))
    for path, leaf in jl:
        node = tqp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
    ids = np.random.default_rng(0).integers(0, V, (2, 9))
    logits, _, _ = qwen2.forward(tqp, tcfg, _t(ids))
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------- the int4 product (K6)

@pytest.mark.parametrize("B,IN,OUT,G", [
    (48, 512, 384, 128),   # decode rows
    (3, 256, 300, 64),     # OUT not a multiple of any block
    (16, 512, 512, 128),
    (1, 256, 256, 128),    # a single row
    (37, 768, 200, 32),    # ragged rows and columns, 12 group pairs: the kernel splits them
])
@pytest.mark.parametrize("version", [2, 3])
def test_int4_matmul_plain_matches_jax_kernel(B, IN, OUT, G, version):
    rng = np.random.default_rng(IN + OUT + B)
    x = rng.normal(size=(B, IN)).astype(np.float32)
    w = rng.normal(size=(IN, OUT)).astype(np.float32)
    jleaf = jquant.quantize_weight_int4(jnp.asarray(w), group=G)
    ref = np.asarray(j_int4_matmul(jnp.asarray(x), jleaf["q"], jleaf["s4"], block_out=256,
                                   interpret=True, version=version))
    leaf = quant.quantize_weight_int4(_t(w), G)
    got = i4.int4_matmul(_t(x), leaf["q"], leaf["s4"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, OUT)
    top = float(np.abs(ref).max())
    assert float(np.abs(got.numpy() - ref).max()) <= 5e-3 * top
    if version == 3:
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * top)


def test_int4_matmul_rounds_x_to_bf16_and_takes_stacked_layers():
    """x enters the product as bf16 even when it is f32 (the JAX kernel's
    cast), and ``layer`` picks one layer of stacked weights."""
    rng = np.random.default_rng(5)
    L, B, IN, OUT, G = 3, 8, 256, 128, 64
    x = _t(rng.normal(size=(B, IN)).astype(np.float32))
    leaf = quant.quantize_weight_int4(_t(rng.normal(size=(L, IN, OUT)).astype(np.float32)), G)
    for layer in range(L):
        got = i4.int4_matmul(x, leaf["q"], leaf["s4"], layer=layer)
        ref = x.to(torch.bfloat16).float() @ quant.dequant(
            {"q": leaf["q"][layer], "s4": leaf["s4"][layer]}, torch.float32)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(
            got.numpy(), i4.int4_matmul(x.to(torch.bfloat16), leaf["q"][layer],
                                        leaf["s4"][layer]).numpy())


def test_q_matmul_switches_to_dequant_above_512_rows(monkeypatch):
    rng = np.random.default_rng(6)
    leaf = quant.quantize_weight_int4(_t(rng.normal(size=(64, 32)).astype(np.float32)), 32)
    calls = []
    real = qwen2.int4_matmul

    def spy(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(qwen2, "int4_matmul", spy)
    for rows in (512, 513):
        h = _t(rng.normal(size=(rows, 64)).astype(np.float32))
        y = qwen2._q_matmul_f32(h, leaf)
        hk = h.to(torch.bfloat16).float() if rows <= 512 else h  # the kernel rounds h
        ref = hk @ quant.dequant(leaf, torch.float32)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-4, rtol=1e-5)
    assert calls == [512]


# ---------------------------------------------------------------- the model

def _prefilled_cache(tcfg, tp, rng, B, Lp, S):
    lens = rng.integers(Lp // 2, Lp + 1, B).astype(np.int32)
    lens[0] = Lp
    ids = rng.integers(0, V, (B, Lp))
    mask = (np.arange(Lp)[None, :] < lens[:, None]).astype(np.int32)
    kvv = np.zeros((B, S), bool)
    kvv[:, :Lp] = mask > 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    tc = qwen2.init_kv_cache(tcfg, B, S)
    _, _, tc = qwen2.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0,
                             kv_valid=_t(kvv))
    return (tc[0].permute(0, 1, 3, 2, 4).contiguous(),
            tc[1].permute(0, 1, 3, 2, 4).contiguous(), lens)


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_decode_step_int8_cache_matches_jax(tiny, quantized, bits):
    """Two decode steps over an int8 cache quantized by the engines'
    install functions: caches and scales equal JAX's, logits and hidden
    within 1e-4 of the JAX dense int8 path, the ragged and dense plain
    versions agree, and the returned scales hold this step's write."""
    jcfg, jp, tcfg, tp = tiny
    if bits is not None:
        jp, tp = quantized[bits]
    rng = np.random.default_rng(11)
    B, Lp, S = 3, 12, 24
    ck, cv, lens = _prefilled_cache(tcfg, tp, rng, B, Lp, S)
    jkq, jvq, jscl = JEngine._quantize_cache_impl(jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()))
    kq, vq, scl = Engine._quantize_cache(ck, cv)
    for a, b in ((kq, jkq), (vq, jvq), (scl[0], jscl[0]), (scl[1], jscl[1])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    dstart = np.full((B,), Lp, np.int32)
    pos = lens.astype(np.int32)
    caches = {r: (kq.clone(), vq.clone(), (scl[0].clone(), scl[1].clone())) for r in (True, False)}
    for step in range(2):
        slot = Lp + step
        tok = rng.integers(0, V, (B,))
        jl, jh, jkq, jvq, jscl = jq.decode_step(
            jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jkq, jvq, jnp.asarray(slot, jnp.int32),
            jnp.asarray(lens), jnp.asarray(dstart), return_hidden=True, cache_scale=jscl)
        outs = {}
        for ragged, (k8, v8, sc) in caches.items():
            outs[ragged] = qwen2.decode_step(tp, tcfg, _t(tok), _t(pos), k8, v8, slot, _t(lens),
                                             _t(dstart), return_hidden=True, ragged=ragged,
                                             cache_scale=sc)
        logits, hidden, k8, v8, sc = outs[True]
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=_tol(bits), rtol=0)
        np.testing.assert_allclose(hidden.numpy(), np.asarray(jh), atol=_tol(bits), rtol=0)
        np.testing.assert_allclose(outs[False][0].numpy(), logits.numpy(), atol=1e-5, rtol=0)
        assert k8.dtype == torch.int8 and v8.dtype == torch.int8
        np.testing.assert_allclose(sc[0][:, :, :, slot].numpy(), np.asarray(jscl[0])[:, :, :, slot],
                                   rtol=1e-5, atol=0)
        assert float(sc[1][:, :, :, slot].min()) > 0
        pos = pos + 1


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_forward_matches_jax(tiny, quantized, bits):
    """No-cache forward with padding and the cache-threaded forward on a
    quantized tree: attention projections dequantized, the int4 MLP through
    the kernel's plain version at <= 512 rows, int8 embed and head."""
    jcfg, _, tcfg, _ = tiny
    jqp, tqp = quantized[bits]
    rng = np.random.default_rng(12)
    ids = rng.integers(0, V, (3, 20))
    mask = np.ones((3, 20), np.int32)
    mask[1, :5] = 0
    jl, jh, _ = jq.forward(jqp, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                           return_hidden=True)
    tl, th, _ = qwen2.forward(tqp, tcfg, _t(ids), attention_mask=_t(mask), return_hidden=True)
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=_tol(bits), rtol=0)
    np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], atol=_tol(bits), rtol=0)


# ---------------------------------------------------------------- engine and value function

KW = dict(max_model_len=256, max_batch=8, decode_chunk=8, pad_multiple=32,
          batch_bucket=2, eos_token_ids=[1], prefix_cache_min_reuse=16,
          collect_h0=True, kv_quant="int8")


@pytest.mark.parametrize("bits", [4, 8])
def test_engine_int8_kv_greedy_tokens_match_jax(tiny, quantized, bits):
    """Engine(kv_quant="int8") on int4 and on int8 weights: greedy token ids
    equal JAX's Engine(kv_quant="int8", approx_top_k=False), with and
    without a prefix-cache hit; pooled h0 within 1e-4."""
    jcfg, _, tcfg, _ = tiny
    jqp, tqp = quantized[bits]
    jeng = JEngine(jqp, jcfg, IdTok(), approx_top_k=False, **KW)
    teng = Engine(tqp, tcfg, IdTok(), **KW)
    assert teng.device == torch.device("cpu")
    rng = np.random.default_rng(bits)

    def prompt(n):
        return " ".join(str(t) for t in rng.integers(2, V, n))

    parents = [prompt(40), prompt(23)]
    children = [parents[0] + " " + prompt(9), parents[1] + " " + prompt(30), prompt(17)]
    sp = dict(n=2, temperature=0.0, max_tokens=10)
    for prompts in (parents, children):
        jout = jeng.generate(prompts, JSP(**sp))
        tout = teng.generate(prompts, SamplingParams(**sp))
        for jr, tr in zip(jout, tout):
            assert [o.token_ids for o in tr.outputs] == [o.token_ids for o in jr.outputs]
            for jo, to in zip(jr.outputs, tr.outputs):
                assert to.finish_reason == jo.finish_reason
                np.testing.assert_allclose(to.pooled_hidden, np.asarray(jo.pooled_hidden),
                                           atol=_tol(bits), rtol=0)
    assert teng.prefix_cache.hits == jeng.prefix_cache.stats()["hits"] == 2


@pytest.mark.parametrize("bits", [4, 8])
def test_value_function_on_quantized_tree_matches_jax(tiny, quantized, bits):
    jcfg, _, tcfg, _ = tiny
    jqp, tqp = quantized[bits]
    jhead = jvm.init_value_head(jcfg.hidden_size, jax.random.key(3))
    thead = loader.params_from_numpy(_np_tree(jhead))
    kw = dict(pad_multiple=32, batch_bucket=4)
    jvf = JValueFunction(jqp, jhead, jcfg, **kw)
    tvf = ValueFunction(tqp, thead, tcfg, **kw)
    rng = np.random.default_rng(13)
    ids = rng.integers(0, V, (3, 45))
    attn = np.ones((3, 45), np.int32)
    attn[1, 30:] = 0
    jy, jv, jh0 = jvf(ids, attn, return_h0=True)
    ty, tv, th0 = tvf(ids, attn, return_h0=True)
    np.testing.assert_allclose(th0, jh0, atol=_tol(bits), rtol=0)
    np.testing.assert_allclose(ty, jy, atol=_tol(bits), rtol=0)
    np.testing.assert_allclose(tv, jv, atol=_tol(bits), rtol=0)


# ---------------------------------------------------------------- loading

@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_load_params_quantized_equals_jax(tmp_path, mode):
    """An HF checkpoint whose projections split into whole group-128 halves
    (H 256, I 512): int4 mode packs them, keeps the embedding int8, and the
    leaves equal the JAX loader's; the logits agree."""
    from model_fixtures import build_tiny_model_dir

    d = build_tiny_model_dir(str(tmp_path / "m"), hidden=256, inter=512, heads=4, kv_heads=2,
                             vocab=400)
    jp, jcfg = jloader.load_params(d, dtype=jnp.float32, quantize=mode)
    tp, tcfg = loader.load_params(d, dtype=torch.float32, device="cpu", quantize=mode)
    _assert_trees_equal(jp, tp)
    assert ("s4" in tp["layers"]["mlp"]["down_proj"]["w"]) == (mode == "int4")
    assert tp["embed"]["weight"]["q"].dtype == torch.int8
    ids = np.random.default_rng(3).integers(0, 400, (2, 10))
    jl, _, _ = jq.forward(jp, jcfg, jnp.asarray(ids))
    tl, _, _ = qwen2.forward(tp, tcfg, _t(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(4 if mode == "int4" else 8),
                               rtol=0)
    with pytest.raises(ValueError, match="quantize"):
        loader.load_params(d, device="cpu", quantize="fp8")


def test_loaders_default_to_the_card(tmp_path):
    """Without a card, load_params and load_value_head raise unless the
    caller asks for the CPU: no silent CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from model_fixtures import build_tiny_model_dir

    d = build_tiny_model_dir(str(tmp_path / "m"), vocab=400)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_params(d)
    np.savez(tmp_path / "h.npz", weight=np.zeros((1, 64), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_value_head(str(tmp_path / "h.npz"), 64)
    params, _ = loader.load_params(d, device="cpu")
    assert params["embed"]["weight"].device.type == "cpu"


def test_trainer_refuses_quantized_params(tiny, quantized):
    from lapha_tpu_torch.train import MTPOConfig, MTPOTrainer

    _, _, tcfg, _ = tiny
    args = MTPOConfig(output_dir="unused", max_model_len=64)
    with pytest.raises(ValueError, match="full-precision"):
        MTPOTrainer(model=(quantized[4][1], tcfg), agent_cls_list=[], args=args,
                    reward_fns=[], train_dataset=[], tokenizer=IdTok())


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("bits", [4, 8])
def test_ref_logps_on_quantized_trees_match_jax(bits, tied):
    """The training log-probs take a quantized LM head as JAX's chunk body
    does (the hidden folded by the int8 head's scale, the table cast, an
    f32 product): ``ref_logps_fn`` of both packages on the same
    ``quantize_params`` tree, tied and untied heads, within 1e-4."""
    from lapha_tpu.train import losses as jlosses
    from lapha_tpu_torch.train import losses

    jcfg = JCfg.tiny(vocab_size=V, tie_word_embeddings=tied)
    jqp = jquant.quantize_params(jq.init_params(jcfg, jax.random.key(11)), bits=bits, group=32)
    tqp = loader.params_from_numpy(_np_tree(jqp))
    head = tqp["embed" if tied else "lm_head"]["weight"]
    assert quant.is_quantized(head) and "s" in head
    tcfg = qwen2.Qwen2Config.tiny(vocab_size=V, tie_word_embeddings=tied)
    ids = np.random.default_rng(12).integers(2, V, (2, 16))
    comp = np.zeros((2, 16), np.int32)
    comp[:, 8:] = 1
    batch = {"ids": ids, "attn": np.ones((2, 16), np.int32), "comp_mask": comp}
    jl = jlosses.ref_logps_fn(jqp, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, 1.0)
    tl = losses.ref_logps_fn(tqp, {k: _t(v) for k, v in batch.items()}, tcfg, 1.0)
    assert tl.shape == (2, 15) and float(tl[:, 8:].abs().min()) > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
