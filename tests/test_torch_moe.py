"""lapha_tpu_torch's MoE family against lapha_tpu (CPU, f32, tiny configs):
the grouped GEMM's plain version, routing, the MoE block's impls and its
quantized trees, the qwen2_moe model (logits, decode_step, greedy engine
tokens with and without a prefix hit, ValueFunction), and the qwen3_moe and
mixtral layouts through both loaders.

The JAX side runs as tests/test_moe.py runs it on the CPU: ``_grouped_gemm``
is ``jax.lax.ragged_dot`` there. Both sides get the same numpy inputs and
JAX-initialised (or HF-saved) weights through numpy. Tolerances: the
grouped GEMM and the MoE block within 1e-5 (the same f32 products summed in
another order; dW of the ragged cases, sums over up to 600 rows, within 1e-5
of its largest entry, as tests/test_torch_moe_train.py holds dW), routing weights within 1e-6 with equal expert ids, logits
and values within 1e-4 (as the dense model's tests), quantized and loaded
leaves equal bit for bit, greedy token ids exactly equal.
"""

import functools
import json
import os

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
from lapha_tpu.ops import moe as jmoe
from lapha_tpu.search.value_fn import ValueFunction as JValueFunction
from lapha_tpu_torch.engine import Engine, SamplingParams
from lapha_tpu_torch.models import loader, quant, qwen2
from lapha_tpu_torch.ops import grouped_gemm as tgg
from lapha_tpu_torch.ops import moe
from lapha_tpu_torch.search import ValueFunction

ATOL = 1e-4
BLOCK_ATOL = 1e-5
V = 300
MOE = dict(num_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
           shared_expert_intermediate_size=48, tie_word_embeddings=False)


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


def _close(t_out, j_out, atol):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=0)


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


def _layer0(jp, tp):
    """Layer 0's MoE subtree on both sides."""
    return (jax.tree_util.tree_map(lambda w: w[0], jp["layers"])["moe"],
            qwen2._layer_stack(tp)[0]["moe"])


@pytest.fixture(scope="module")
def tiny():
    """A qwen2_moe-layout model (shared expert, untied head): random weights
    from a seed, the same numpy tree on both sides."""
    jcfg, tcfg = JCfg.tiny(vocab_size=V, **MOE), qwen2.Qwen2Config.tiny(vocab_size=V, **MOE)
    tree = jax.tree_util.tree_map(lambda t: t.numpy(),
                                  qwen2.init_params(tcfg, torch.Generator().manual_seed(11)))
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), tcfg, loader.params_from_numpy(tree)


def _jit(fn, **static):
    """A JAX function with its static arguments bound, compiled once."""
    return jax.jit(functools.partial(fn, **static))


# ---------------------------------------------------------------- grouped GEMM

def _gmax_sizes():
    """GMAX (1024) groups, most of them empty: 12 take 20-60 rows."""
    rng = np.random.default_rng(1024)
    sizes = np.zeros(tgg.GMAX, np.int64)
    sizes[rng.choice(tgg.GMAX, 12, replace=False)] = rng.integers(20, 61, 12)
    return tuple(int(s) for s in sizes)


# The cases the card's wgmma kernels take at their edges: groups ending off
# the 64- and 128-row tiles; a group starting mid-chunk after an odd-sized
# one; rows past the groups; GMAX groups, most empty; one expert with every
# row. Rows past the groups of a case, where it has them:
RAGGED = [(129, 191, 546), (67, 0, 133, 1, 255, 0), (100, 0, 150, 13), _gmax_sizes(),
          (0, 0, 0, 600, 0)]
ROWS_PAST = {(100, 0, 150, 13): 28}


def _rows(sizes) -> int:
    """M of a case: 16 for the small ones, else the groups' rows and those
    past them."""
    return max(16, sum(sizes) + ROWS_PAST.get(tuple(sizes), 0))


@pytest.mark.parametrize("sizes", [
    (3, 0, 1, 7, 0, 5),      # empty groups and a group of one row
    (0, 0, 16, 0, 0, 0),     # one expert takes every row
    (1, 1, 1, 1, 1, 11),
    (2, 0, 4, 0, 0, 3),      # rows past the groups: zeros
] + RAGGED)
def test_grouped_gemm_plain_matches_jax(sizes):
    rng = np.random.default_rng(sum(sizes))
    M, K, N = _rows(sizes), 24, 40
    xs = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(len(sizes), K, N)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    jout = jmoe._grouped_gemm(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(gs))
    tout = tgg.grouped_gemm(_t(xs), _t(w), _t(gs))
    assert tout.dtype == torch.float32 and tout.shape == (M, N)
    _close(tout, jout, BLOCK_ATOL)
    if sum(sizes) < M:
        assert not tout[sum(sizes):].any()

    # gradients: the CPU backward is the plain dX and tgmm
    dout = rng.normal(size=(M, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jmoe._grouped_gemm(a, b, jnp.asarray(gs)),
                     jnp.asarray(xs), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dout))
    txs, tw = _t(xs).requires_grad_(True), _t(w).requires_grad_(True)
    tdx, tdw = torch.autograd.grad(tgg.grouped_gemm(txs, tw, _t(gs)), (txs, tw), _t(dout))
    _close(tdx, jdx, BLOCK_ATOL)
    # dW of a ragged case sums up to 600 rows: 1e-5 of its largest entry
    scale = float(np.abs(np.asarray(jdw)).max()) if tuple(sizes) in RAGGED else 1.0
    _close(tdw, jdw, BLOCK_ATOL * scale)


@pytest.mark.parametrize("M,G,N,w_ptr,kernel", [
    (96, 60, 1408, 0, "grouped_gemm"),       # decode: 24 tokens x top-4 over 60 experts
    (96, 32, 5760, 0, "grouped_gemm"),       # GPT-OSS's decode
    (144, 64, 1408, 0, "grouped_gemm"),      # DeepSeek-V2-Lite's: 24 tokens x top-6
    (tgg.WG_MIN_ROWS * 60 - 1, 60, 1408, 0, "grouped_gemm"),  # one row short
    (tgg.WG_MIN_ROWS * 60, 60, 1408, 0, "grouped_gemm_wg"),
    (8192, 60, 1408, 0, "grouped_gemm_wg"),  # prefill: 4 x 512 tokens x top-4
    (32768, 60, 2048, 0, "grouped_gemm_wg"),  # training: 8 x 1024 tokens x top-4
    (16384, 32, 5760, 0, "grouped_gemm_wg"),
    (49152, 64, 1408, 0, "grouped_gemm_wg"),
    (8192, 60, 1410, 0, "grouped_gemm"),     # N % 8 != 0: TMA cannot read the rows of w
    (8192, 60, 1408, 8, "grouped_gemm"),     # w not 16-byte aligned
    (tgg.WG_MIN_ROWS * tgg.GMAX, tgg.GMAX, 128, 256, "grouped_gemm_wg"),
])
def test_grouped_gemm_forward_kernel_rule(M, G, N, w_ptr, kernel):
    """The host's choice between the card's two forward kernels, from M, G,
    N and the weights' address alone (the group sizes stay on the device)."""
    assert tgg.forward_kernel(M, G, N, w_ptr) == kernel


def test_grouped_gemm_rejects_bad_shapes():
    xs, w = torch.zeros(4, 8), torch.zeros(3, 8, 5)
    with pytest.raises(ValueError, match="grouped_gemm"):
        tgg.grouped_gemm(xs, w, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="grouped_gemm"):
        tgg.grouped_gemm(xs, torch.zeros(3, 6, 5), torch.zeros(3, dtype=torch.int32))


# ---------------------------------------------------------------- the block

@pytest.mark.parametrize("norm_topk", [False, True])
def test_route_matches_jax(tiny, norm_topk):
    jcfg, jp, _, tp = tiny
    jm, tm = _layer0(jp, tp)
    x = np.random.default_rng(1).normal(size=(33, jcfg.hidden_size)).astype(np.float32)
    jw, ji = _jit(jmoe.route, top_k=2, norm_topk=norm_topk)(jnp.asarray(x), jm["router"]["w"])
    tw, ti = moe.route(_t(x), tm["router"]["w"], 2, norm_topk)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tw, jw, 1e-6)
    if norm_topk:
        np.testing.assert_allclose(tw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("norm_topk", [False, True])
def test_moe_ffns_and_block_match_jax(tiny, norm_topk):
    """gather, dense, the shared expert and the whole block, each against
    its JAX function; gather == dense; the routing= argument bypasses the
    router on both sides."""
    jcfg, jp, _, tp = tiny
    jm, tm = _layer0(jp, tp)
    x = np.random.default_rng(2).normal(size=(17, jcfg.hidden_size)).astype(np.float32)
    jx, tx = jnp.asarray(x), _t(x)
    kw = dict(top_k=2, norm_topk=norm_topk)
    tg = moe.moe_ffn_gather(tx, tm, **kw)
    _close(tg, _jit(jmoe.moe_ffn_gather, **kw)(jx, jm), BLOCK_ATOL)
    _close(moe.moe_ffn_dense(tx, tm, **kw), _jit(jmoe.moe_ffn_dense, **kw)(jx, jm), BLOCK_ATOL)
    _close(tg, moe.moe_ffn_dense(tx, tm, **kw).numpy(), BLOCK_ATOL)
    _close(moe.shared_expert(tx, tm["shared"]), jax.jit(jmoe.shared_expert)(jx, jm["shared"]),
           BLOCK_ATOL)
    for impl in ("auto", "gather", "dense"):
        _close(moe.moe_block(tx, tm, impl=impl, **kw),
               _jit(jmoe.moe_block, impl=impl, **kw)(jx, jm), BLOCK_ATOL)
    # forced routing: every token on experts 5 and 0 with fixed weights
    topi = np.tile(np.asarray([[5, 0]], np.int32), (17, 1))
    topw = np.tile(np.asarray([[0.7, 0.2]], np.float32), (17, 1))
    _close(moe.moe_ffn_gather(tx, tm, routing=(_t(topw), _t(topi)), **kw),
           _jit(jmoe.moe_ffn_gather, **kw)(jx, jm, routing=(jnp.asarray(topw), jnp.asarray(topi))),
           BLOCK_ATOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_moe_block_on_quantized_trees_matches_jax(tiny, bits):
    """quantize_params walks the expert stacks as JAX does (int4 with group
    32: the (L, E, 64, 64) gate/up/down stacks are packed; the shared
    expert's 48-wide down projection stays int8; router and gate untouched);
    leaves equal bit for bit; the block on layer 0 within 1e-5."""
    jcfg, jp, _, tp = tiny
    layers = ({"layers": {"moe": jp["layers"]["moe"]}}, {"layers": {"moe": tp["layers"]["moe"]}})
    # eager, as the JAX loader runs it: under jit XLA may rewrite w / scale
    jqp = jquant.quantize_params(layers[0], bits=bits, group=32)
    tqp = quant.quantize_params(layers[1], bits=bits, group=32)
    _assert_trees_equal(jqp, tqp)
    e = tqp["layers"]["moe"]["experts"]
    assert all(("s4" in e[k]["w"]) == (bits == 4) for k in e)
    assert e["gate_proj"]["w"]["q"].dim() == 4
    assert not quant.is_quantized(tqp["layers"]["moe"]["router"]["w"])
    assert not quant.is_quantized(tqp["layers"]["moe"]["shared"]["gate"]["w"])
    jm = jax.tree_util.tree_map(lambda w: w[0], jqp["layers"]["moe"])
    tm = jax.tree_util.tree_map(lambda w: w[0], tqp["layers"]["moe"])
    x = np.random.default_rng(3).normal(size=(21, jcfg.hidden_size)).astype(np.float32)
    _close(moe.moe_block(_t(x), tm, top_k=2, norm_topk=False),
           _jit(jmoe.moe_block, top_k=2, norm_topk=False)(jnp.asarray(x), jm), BLOCK_ATOL)


def test_unported_moe_paths_raise(tiny):
    _, _, _, tp = tiny
    tm = qwen2._layer_stack(tp)[0]["moe"]
    x = torch.zeros(3, 64)
    with pytest.raises(NotImplementedError, match="not yet ported.*A11"):
        moe.moe_block(x, tm, top_k=2, norm_topk=False, impl="dispatch")
    with pytest.raises(NotImplementedError, match="not yet ported.*A11"):
        moe.dispatch_drop_fraction(x, tm, top_k=2, norm_topk=False)
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_block(x, tm, top_k=2, norm_topk=False, impl="sparse")
    with pytest.raises(ValueError, match="dense qwen-family tree only"):
        quant.init_params_quantized(qwen2.Qwen2Config.tiny(**MOE), torch.Generator())


# ---------------------------------------------------------------- the model

def test_moe_params_have_the_jax_layout(tiny):
    """The port's init builds the JAX init's tree: keys and shapes."""
    jcfg, jp, tcfg, tp = tiny
    assert "mlp" not in tp["layers"]
    _assert_trees_equal(jp, tp)
    own = qwen2.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                    jax.eval_shape(lambda: jq.init_params(jcfg, jax.random.key(0))))

    def walk(j, t):
        if isinstance(j, dict):
            assert set(j) == set(t)
            for k in j:
                walk(j[k], t[k])
        else:
            assert tuple(t.shape) == j

    walk(shapes, own)


def test_moe_forward_and_decode_step_match_jax(tiny):
    """Logits (no cache, padded) and a cached prefill + decode_step against
    JAX; decode_step equals the full forward at the token's position."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V, (3, 20))
    mask = np.ones((3, 20), np.int32)
    mask[1, :5] = 0
    jl, _, _ = _jit(jq.forward, cfg=jcfg)(jp, input_ids=jnp.asarray(ids),
                                          attention_mask=jnp.asarray(mask))
    tl, _, _ = qwen2.forward(tp, tcfg, _t(ids), attention_mask=_t(mask))
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=ATOL, rtol=0)
    _decode_matches(jcfg, jp, tcfg, tp, rng)


def _decode_matches(jcfg, jp, tcfg, tp, rng):
    B, Lp, S = 2, 12, 20
    lens = np.asarray([12, 8], np.int32)
    ids = rng.integers(0, tcfg.vocab_size, (B, Lp))
    mask = (np.arange(Lp)[None, :] < lens[:, None]).astype(np.int32)
    kvv = np.zeros((B, S), bool)
    kvv[:, :Lp] = mask > 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    tc = qwen2.init_kv_cache(tcfg, B, S)
    _, _, tc = qwen2.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0,
                             kv_valid=_t(kvv))
    ck = tc[0].permute(0, 1, 3, 2, 4).contiguous()
    cv = tc[1].permute(0, 1, 3, 2, 4).contiguous()
    jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    nxt = rng.integers(0, tcfg.vocab_size, (B,))
    tl, th, _, _ = qwen2.decode_step(tp, tcfg, _t(nxt), _t(lens.astype(np.int64)), ck, cv, Lp,
                                     _t(lens), torch.full((B,), Lp, dtype=torch.int32),
                                     return_hidden=True)
    jl, jh, _, _ = _jit(jq.decode_step, cfg=jcfg, return_hidden=True)(
        jp, tok=jnp.asarray(nxt), positions=jnp.asarray(lens), cache_k=jck, cache_v=jcv,
        slot=jnp.asarray(Lp, jnp.int32), lens=jnp.asarray(lens),
        dstart=jnp.full((B,), Lp, jnp.int32))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    for b in range(B):
        full = np.concatenate([ids[b, :lens[b]], nxt[b:b + 1]])[None]
        fl, _, _ = qwen2.forward(tp, tcfg, _t(full))
        np.testing.assert_allclose(tl.numpy()[b], fl.numpy()[0, -1], atol=ATOL, rtol=0)


KW = dict(max_model_len=256, max_batch=8, decode_chunk=8, pad_multiple=32,
          batch_bucket=2, eos_token_ids=[1], prefix_cache_min_reuse=16, collect_h0=True)


def test_moe_engine_greedy_tokens_match_jax_engine(tiny):
    """Greedy token ids equal the JAX engine's exactly, with and without a
    prefix-cache hit; pooled h0 within 1e-4."""
    jcfg, jp, tcfg, tp = tiny
    jeng = JEngine(jp, jcfg, IdTok(), approx_top_k=False, **KW)
    teng = Engine(tp, tcfg, IdTok(), **KW)
    rng = np.random.default_rng(5)

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
                                           atol=ATOL, rtol=0)
    assert teng.prefix_cache.hits == jeng.prefix_cache.stats()["hits"] == 2


def test_moe_value_function_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    jhead = jvm.init_value_head(jcfg.hidden_size, jax.random.key(3))
    thead = loader.params_from_numpy(_np_tree(jhead))
    kw = dict(pad_multiple=32, batch_bucket=4)
    jvf = JValueFunction(jp, jhead, jcfg, **kw)
    tvf = ValueFunction(tp, thead, tcfg, **kw)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, V, (3, 45))
    attn = np.ones((3, 45), np.int32)
    attn[1, 30:] = 0
    jy, jv, jh0 = jvf(ids, attn, return_h0=True)
    ty, tv, th0 = tvf(ids, attn, return_h0=True)
    np.testing.assert_allclose(th0, jh0, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv, jv, atol=ATOL, rtol=0)
    jyc, jvc = jvf.from_pooled(th0[1:], root_h0=th0[0])
    tyc, tvc = tvf.from_pooled(th0[1:], root_h0=th0[0])
    np.testing.assert_allclose(tyc, jyc, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tvc, jvc, atol=ATOL, rtol=0)


# ---------------------------------------------------------------- HF layouts

def _hf_dir(root, family):
    """A tiny random checkpoint of ``family`` saved with transformers (the
    tests/test_moe.py fixtures; qwen2_moe at H 256 so that int4 loading
    packs its shared expert)."""
    import transformers

    d = os.path.join(root, family)
    common = dict(vocab_size=V, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=256,
                  tie_word_embeddings=False, torch_dtype="float32")
    if family == "qwen2_moe":
        cfg = transformers.Qwen2MoeConfig(
            hidden_size=256, intermediate_size=512, rope_theta=10000.0, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=64, shared_expert_intermediate_size=256,
            norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[], **common)
        cls = transformers.Qwen2MoeForCausalLM
    elif family == "qwen3_moe":
        cfg = transformers.Qwen3MoeConfig(
            hidden_size=64, intermediate_size=128, head_dim=24, rope_theta=1e6, num_experts=8,
            num_experts_per_tok=2, moe_intermediate_size=32, norm_topk_prob=True,
            decoder_sparse_step=1, mlp_only_layers=[], **common)
        cls = transformers.Qwen3MoeForCausalLM
    else:
        cfg = transformers.MixtralConfig(
            hidden_size=64, intermediate_size=96, rope_theta=1e6, num_local_experts=4,
            num_experts_per_tok=2, **common)
        cls = transformers.MixtralForCausalLM
    torch.manual_seed(len(family))
    cls(cfg).eval().save_pretrained(d, safe_serialization=True)
    return d


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers would import TensorFlow (~10 s), unused
        pytest.importorskip("transformers")
    root = str(tmp_path_factory.mktemp("moe_hf"))
    return {f: _hf_dir(root, f) for f in ("qwen2_moe", "qwen3_moe", "mixtral")}


@pytest.mark.parametrize("family", ["qwen2_moe", "qwen3_moe", "mixtral"])
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_moe_checkpoints_load_like_jax(hf_dirs, family, mode):
    """Both loaders give the same config fields and the same leaves, bit for
    bit (expert stacks int8 in both quantized modes; router and shared gate
    unquantized); unquantized, the port's logits are JAX's within 1e-4."""
    d = hf_dirs[family]
    jp, jcfg = jloader.load_params(d, dtype=jnp.float32, quantize=mode)
    tp, tcfg = loader.load_params(d, dtype=torch.float32, device="cpu", quantize=mode)
    for f in ("num_experts", "num_experts_per_tok", "moe_intermediate_size",
              "shared_expert_intermediate_size", "norm_topk_prob", "moe_layout", "qk_norm",
              "attention_bias", "head_dim_", "rope_theta", "rms_norm_eps", "tie_word_embeddings"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    _assert_trees_equal(jp, tp)
    m = tp["layers"]["moe"]
    if mode is not None:
        assert all(m["experts"][k]["w"]["q"].dtype == torch.int8 and "s" in m["experts"][k]["w"]
                   for k in m["experts"])
        assert not quant.is_quantized(m["router"]["w"])
    if family == "qwen2_moe":
        assert not quant.is_quantized(m["shared"]["gate"]["w"])
        gate = m["shared"]["gate_proj"]["w"]
        assert (quant.is_quantized(gate) and "s4" in gate) == (mode == "int4")
    else:
        assert "shared" not in m
    if mode is None:
        ids = np.random.default_rng(7).integers(0, V, (2, 11))
        jl, _, _ = _jit(jq.forward, cfg=jcfg)(jp, input_ids=jnp.asarray(ids))
        tl, _, _ = qwen2.forward(tp, tcfg, _t(ids))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_qwen3_moe_decode_step_matches_jax(hf_dirs):
    """decode_step with the per-head q/k norm before RoPE, against JAX and
    against the full forward."""
    d = hf_dirs["qwen3_moe"]
    jp, jcfg = jloader.load_params(d, dtype=jnp.float32)
    tp, tcfg = loader.load_params(d, dtype=torch.float32, device="cpu")
    assert tcfg.qk_norm and tcfg.head_dim_ == 24
    _decode_matches(jcfg, jp, tcfg, tp, np.random.default_rng(8))


def test_from_hf_refuses_mixed_dense_sparse_stacks(hf_dirs, tmp_path):
    with open(os.path.join(hf_dirs["qwen2_moe"], "config.json")) as f:
        base = json.load(f)
    for extra in ({"mlp_only_layers": [0]}, {"decoder_sparse_step": 2}):
        with pytest.raises(ValueError, match="dense layers mixed"):
            qwen2.Qwen2Config.from_hf({**base, **extra})
        with pytest.raises(ValueError, match="dense layers mixed"):
            JCfg.from_hf({**base, **extra})
    # mixtral's window (every layer) parses as JAX parses it
    mixtral = {**base, "model_type": "mixtral", "num_local_experts": 4, "sliding_window": 32}
    t, j = qwen2.Qwen2Config.from_hf(mixtral), JCfg.from_hf(mixtral)
    assert (t.sliding_window, t.layer_windows) == (j.sliding_window, j.layer_windows) == (32, ())
