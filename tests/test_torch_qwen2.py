"""lapha_tpu_torch.models.qwen2 against lapha_tpu.models.qwen2 (CPU, f32).

The same JAX-initialised weights go to both sides through numpy
(``params_from_numpy``); inputs are numpy arrays from a seed. Tolerance:
atol 1e-4 on logits (f32 matmul/softmax summation order differs between
XLA and PyTorch; logits are O(1) at the tiny config).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import loader as jloader
from lapha_tpu.models import qwen2 as jq
from lapha_tpu_torch.models import loader as tloader
from lapha_tpu_torch.models import qwen2 as tq

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = JCfg.tiny(vocab_size=300)
    jp = jq.init_params(jcfg, jax.random.key(0))
    tp = tloader.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tq.Qwen2Config.tiny(vocab_size=300), tp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_params_convert_with_the_jax_layout(models):
    jcfg, jp, tcfg, tp = models
    assert tuple(tp["layers"]["attn"]["q_proj"]["w"].shape) == (2, 64, 64)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: 0, tp)))
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_forward_matches_jax_with_padding(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 300, (3, 24))
    mask = np.ones((3, 24), np.int32)
    mask[1, :7] = 0    # left-padded
    mask[2, 15:] = 0   # right-padded
    jl, jh, _ = jq.forward(jp, jcfg, jnp.asarray(ids), attention_mask=jnp.asarray(mask),
                           return_hidden=True)
    tl, th, _ = tq.forward(tp, tcfg, _t(ids), attention_mask=_t(mask), return_hidden=True)
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=ATOL, rtol=0)
    np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], atol=ATOL, rtol=0)
    # no mask at all
    jl0, _, _ = jq.forward(jp, jcfg, jnp.asarray(ids))
    tl0, _, _ = tq.forward(tp, tcfg, _t(ids))
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=ATOL, rtol=0)


def test_forward_with_cache_matches_jax(models):
    """Prefill into a cache, then a per-row-offset suffix over it (the
    engine's prefix-hit shape), against JAX logits and caches."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    B, Lp, S = 2, 16, 48
    ids = rng.integers(0, 300, (B, Lp))
    mask = np.ones((B, Lp), np.int32)
    mask[1, 11:] = 0
    kvv = np.zeros((B, S), bool)
    kvv[:, :Lp] = mask > 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    jc = jq.init_kv_cache(jcfg, B, S)
    jl, _, jc = jq.forward(jp, jcfg, jnp.asarray(ids), positions=jnp.asarray(pos),
                           kv_cache=jc, cache_pos=0, kv_valid=jnp.asarray(kvv))
    tc = tq.init_kv_cache(tcfg, B, S)
    tl, _, tc = tq.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0,
                           kv_valid=_t(kvv))
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc[0].numpy(), np.asarray(jc[0]), atol=ATOL, rtol=0)

    # suffix of 5 tokens written at each row's own length
    starts = np.asarray([16, 11], np.int32)
    suf = rng.integers(0, 300, (B, 5))
    smask = np.ones((B, 5), np.int32)
    skvv = np.arange(S)[None, :] < (starts + 5)[:, None]
    spos = starts[:, None] + np.arange(5)[None, :]
    jl2, _, jc2 = jq.forward(jp, jcfg, jnp.asarray(suf), positions=jnp.asarray(spos),
                             kv_cache=jc, cache_pos=jnp.asarray(starts),
                             kv_valid=jnp.asarray(skvv))
    tl2, _, tc2 = tq.forward(tp, tcfg, _t(suf), positions=_t(spos), kv_cache=tc,
                             cache_pos=_t(starts), kv_valid=_t(skvv))
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tc2[1].numpy(), np.asarray(jc2[1]), atol=ATOL, rtol=0)
    assert smask.all()


def test_decode_step_matches_forward_and_jax(models):
    """decode_step over the slot-uniform layout == the full forward's logits
    for the same token at the same position, and == JAX decode_step."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(2)
    B, Lp, S = 2, 12, 20
    lens = np.asarray([12, 8], np.int32)
    ids = rng.integers(0, 300, (B, Lp))
    mask = (np.arange(Lp)[None, :] < lens[:, None]).astype(np.int32)
    kvv = np.zeros((B, S), bool)
    kvv[:, :Lp] = mask > 0
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    tc = tq.init_kv_cache(tcfg, B, S)
    _, _, tc = tq.forward(tp, tcfg, _t(ids), positions=_t(pos), kv_cache=tc, cache_pos=0,
                          kv_valid=_t(kvv))
    ck = tc[0].permute(0, 1, 3, 2, 4).contiguous()
    cv = tc[1].permute(0, 1, 3, 2, 4).contiguous()
    jck, jcv = jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy())
    nxt = rng.integers(0, 300, (B,))
    outs = {}
    for ragged in (True, False):
        outs[ragged] = tq.decode_step(tp, tcfg, _t(nxt), _t(lens.astype(np.int64)),
                                      ck.clone(), cv.clone(), Lp, _t(lens),
                                      torch.full((B,), Lp, dtype=torch.int32),
                                      return_hidden=True, ragged=ragged)
    np.testing.assert_allclose(outs[True][0].numpy(), outs[False][0].numpy(), atol=1e-5, rtol=0)
    jl, jh, _, _ = jq.decode_step(jp, jcfg, jnp.asarray(nxt), jnp.asarray(lens), jck, jcv,
                                  jnp.asarray(Lp, jnp.int32), jnp.asarray(lens),
                                  jnp.full((B,), Lp, jnp.int32), return_hidden=True)
    np.testing.assert_allclose(outs[True][0].numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(outs[True][1].numpy(), np.asarray(jh), atol=ATOL, rtol=0)
    # the full forward of prompt + token, read at the token's position
    for b in range(B):
        full = np.concatenate([ids[b, :lens[b]], nxt[b:b + 1]])[None]
        fl, _, _ = tq.forward(tp, tcfg, _t(full))
        np.testing.assert_allclose(outs[True][0].numpy()[b], fl.numpy()[0, -1], atol=ATOL, rtol=0)


@pytest.mark.parametrize("scaling", [(), ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 64)])
def test_rope_freqs_match_jax(scaling):
    pos = np.arange(0, 300, 7)[None, :]
    jc, js = jq.rope_freqs(jnp.asarray(pos), 64, 1e6, scaling)
    tc, ts = tq.rope_freqs(_t(pos), 64, 1e6, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)


def test_hf_checkpoint_loads_like_jax(tmp_path):
    """The offline tiny HF checkpoint of tests/model_fixtures.py loads into
    the same config and weights as the JAX loader, and gives its logits."""
    from model_fixtures import build_tiny_model_dir

    d = build_tiny_model_dir(str(tmp_path / "m"), vocab=400)
    jp, jcfg = jloader.load_params(d, dtype=jnp.float32)
    tp, tcfg = tloader.load_params(d, dtype=torch.float32, device="cpu")
    for f in ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "rope_theta", "rms_norm_eps", "tie_word_embeddings",
              "attention_bias"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    ids = np.random.default_rng(3).integers(0, 400, (2, 10))
    jl, _, _ = jq.forward(jp, jcfg, jnp.asarray(ids))
    tl, _, _ = tq.forward(tp, tcfg, _t(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


def test_value_head_artifacts_load(tmp_path):
    w = np.arange(64, dtype=np.float32) / 64
    np.savez(tmp_path / "h.npz", weight=w.reshape(1, -1), bias=np.asarray([0.5], np.float32))
    torch.save({"value_head.weight": torch.from_numpy(w).reshape(1, -1),
                "value_head.bias": torch.tensor([0.25])}, tmp_path / "h.pt")
    for name, b in (("h.npz", 0.5), ("h.pt", 0.25)):
        head = tloader.load_value_head(str(tmp_path / name), 64, device="cpu")
        jhead = jloader.load_value_head(str(tmp_path / name), 64)
        np.testing.assert_array_equal(head["w"].numpy(), np.asarray(jhead["w"]))
        assert float(head["b"]) == float(jhead["b"]) == b
    with pytest.raises(ValueError):
        tloader.load_value_head(str(tmp_path / "h.npz"), 32, device="cpu")


def test_unported_configs_are_refused():
    """OLMo-2 and SmolLM3 (model code not ported yet, ROADMAP A9) and an
    unported rope scaling are refused."""
    for mt in ("olmo2", "smollm3"):
        with pytest.raises(ValueError, match="not yet ported"):
            tq.Qwen2Config.from_hf({"model_type": mt, "vocab_size": 8, "hidden_size": 8,
                                    "intermediate_size": 8, "num_hidden_layers": 1,
                                    "num_attention_heads": 1})
    with pytest.raises(ValueError, match="not yet ported"):
        tq.Qwen2Config.tiny(rope_scaling=("dynamic", 4.0))
