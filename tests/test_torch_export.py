"""The port's checkpoint exports against the JAX package's writers, on the CPU.

For every family the port loads (dense qwen2, llama, qwen3, mistral; gemma2
and gemma3 with the +1 of their RMS scales folded back out; qwen2_moe,
qwen3_moe and mixtral; gpt_oss with its interleaved gate_up; phi3 with the
fused qkv and gate_up; starcoder2; DeepSeek V2 and V3) a tiny random HF
checkpoint written by transformers is loaded by the JAX loader in f32 and
in bf16, and the same tree (through ``params_from_numpy``) is exported by
both packages. Tolerance: none. The two ``model.safetensors`` files are
byte-equal (same keys, shapes, f32 dtype, bit-equal arrays), and so are the
copied config and tokenizer files. The port's ``load_params`` of its
export gives the exported tree back bit for bit, but for the Gemma RMS
scales: they come back as fl(fl(s - 1) + 1) in f32, which is s itself only
where s - 1 is exact (s in [0.5, 2]); they are held to 2^-24 (below one
ulp of 1).

The value head: ``save_value_head`` writes the same ``.npz`` and ``.pt``
arrays as JAX's ({weight (1, H), bias (1,)}), and ``load_value_head``
reads both back bit-equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.models import deepseek as jdeepseek
from lapha_tpu.models import loader as jloader
from lapha_tpu_torch.models import deepseek as tdeepseek
from lapha_tpu_torch.models import loader
from lapha_tpu_torch.models.quant import is_quantized
from lapha_tpu_torch.train import losses

V = 256
DENSE = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
             tie_word_embeddings=False, torch_dtype="float32")
MOE = dict(num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32)
DEEPSEEK = dict(vocab_size=V, hidden_size=64, intermediate_size=96, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, head_dim=8,
                n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
                moe_intermediate_size=24, first_k_dense_replace=1, n_group=4, topk_group=2,
                max_position_embeddings=256, rope_theta=10000.0, tie_word_embeddings=False,
                torch_dtype="float32")
FAMILIES = ("qwen2", "llama", "qwen3", "mistral", "gemma2", "gemma3", "qwen2_moe", "qwen3_moe",
            "mixtral", "gpt_oss", "phi3", "starcoder2", "deepseek_v2", "deepseek_v3")


def _hf_model(transformers, fam: str):
    """A tiny random model of ``fam``; every norm and bias randomized, so a
    scale or bias written in the wrong place shows."""
    tf = transformers
    if fam == "qwen2":
        return tf.Qwen2ForCausalLM(tf.Qwen2Config(**DENSE))
    if fam == "llama":
        return tf.LlamaForCausalLM(tf.LlamaConfig(**DENSE))
    if fam == "qwen3":
        return tf.Qwen3ForCausalLM(tf.Qwen3Config(head_dim=16, **DENSE))
    if fam == "mistral":
        return tf.MistralForCausalLM(tf.MistralConfig(sliding_window=None, **DENSE))
    if fam == "gemma2":
        return tf.Gemma2ForCausalLM(tf.Gemma2Config(
            head_dim=16, attn_logit_softcapping=5.0, final_logit_softcapping=2.0,
            **{**DENSE, "tie_word_embeddings": True}))
    if fam == "gemma3":
        return tf.Gemma3ForCausalLM(tf.Gemma3TextConfig(
            head_dim=16, sliding_window=8, **{**DENSE, "tie_word_embeddings": True}))
    if fam == "qwen2_moe":
        return tf.Qwen2MoeForCausalLM(tf.Qwen2MoeConfig(
            shared_expert_intermediate_size=48, decoder_sparse_step=1, **MOE, **DENSE))
    if fam == "qwen3_moe":
        return tf.Qwen3MoeForCausalLM(tf.Qwen3MoeConfig(head_dim=16, decoder_sparse_step=1,
                                                        **MOE, **DENSE))
    if fam == "mixtral":
        return tf.MixtralForCausalLM(tf.MixtralConfig(num_local_experts=4,
                                                      num_experts_per_tok=2, **DENSE))
    if fam == "gpt_oss":
        model = tf.GptOssForCausalLM(tf.GptOssConfig(
            head_dim=16, num_local_experts=4, num_experts_per_tok=2, sliding_window=16,
            layer_types=["sliding_attention", "full_attention"],
            **{**DENSE, "intermediate_size": 48}))
        for layer in model.model.layers:  # the init leaves sinks and biases at 0
            layer.self_attn.sinks.data = torch.randn(4) * 2.0
            layer.mlp.router.bias.data = torch.randn(4) * 0.5
            layer.mlp.experts.gate_up_proj_bias.data = torch.randn(4, 96) * 0.1
            layer.mlp.experts.down_proj_bias.data = torch.randn(4, 64) * 0.1
        return model
    if fam == "phi3":
        return tf.Phi3ForCausalLM(tf.Phi3Config(pad_token_id=0, bos_token_id=1, eos_token_id=2,
                                                **DENSE))
    if fam == "starcoder2":
        return tf.Starcoder2ForCausalLM(tf.Starcoder2Config(use_bias=True, **DENSE))
    if fam == "deepseek_v2":
        return tf.DeepseekV2ForCausalLM(tf.DeepseekV2Config(
            q_lora_rank=None, topk_method="group_limited_greedy", **DEEPSEEK))
    model = tf.DeepseekV3ForCausalLM(tf.DeepseekV3Config(q_lora_rank=24, **DEEPSEEK))
    for layer in model.model.layers:
        if hasattr(layer.mlp, "gate"):
            layer.mlp.gate.e_score_correction_bias.data = torch.randn(8) * 0.5
    return model


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # transformers would import TensorFlow (~10 s), unused
        transformers = pytest.importorskip("transformers")
    dirs = {}
    for i, fam in enumerate(FAMILIES):
        torch.manual_seed(100 + i)
        model = _hf_model(transformers, fam).eval()
        with torch.no_grad():
            for name, w in model.named_parameters():
                if name.endswith("norm.weight"):
                    w.normal_(0.0 if fam.startswith("gemma") else 1.0, 0.3)
                elif name.endswith("bias") and "correction" not in name:
                    w.uniform_(-0.3, 0.3)
        d = str(tmp_path_factory.mktemp(f"tiny_{fam}"))
        model.save_pretrained(d, safe_serialization=True)
        with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
            f.write('{"model_max_length": 256}')  # a copied file beside config.json
        dirs[fam] = d
    return dirs


def _files(d: str) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _exports(src: str, dtype: str, tmp_path, quantize=None):
    """JAX's loaded tree, exported by JAX and (through params_from_numpy) by
    the port; returns (the port's tree, its config, JAX's dir, the port's dir)."""
    jp, jcfg = jloader.load_params(src, dtype=getattr(jnp, dtype), quantize=quantize)
    tp = loader.params_from_numpy(jax.tree.map(np.asarray, jp))
    tcfg = loader.load_config(src)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jexport = jdeepseek.export_hf if type(jcfg).__name__ == "DeepseekConfig" else jloader.export_hf
    jexport(jp, jcfg, jdir, src_config_dir=src)
    loader.export_hf(tp, tcfg, tdir, src_config_dir=src)
    return tp, tcfg, jdir, tdir


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fam", FAMILIES)
def test_export_hf_matches_jax(hf_dirs, fam, dtype, tmp_path):
    """Byte-equal exports and copies; the port's reload of its export equals
    the tree (module docstring for the Gemma scales)."""
    from safetensors.numpy import load_file

    src = hf_dirs[fam]
    tp, tcfg, jdir, tdir = _exports(src, dtype, tmp_path)
    jfiles, tfiles = _files(jdir), _files(tdir)
    assert set(tfiles) == set(jfiles) >= {"model.safetensors", "config.json",
                                          "tokenizer_config.json"}
    jsd, tsd = load_file(os.path.join(jdir, "model.safetensors")), load_file(
        os.path.join(tdir, "model.safetensors"))
    assert list(tsd) == list(jsd)
    for k, a in jsd.items():
        assert tsd[k].dtype == a.dtype == np.float32 and tsd[k].shape == a.shape, k
        np.testing.assert_array_equal(tsd[k], a, err_msg=k)
    assert tfiles == jfiles
    copied = set(tfiles) - {"model.safetensors"}
    assert copied == {"config.json", "tokenizer_config.json", "generation_config.json"} & set(
        os.listdir(src))
    for name in copied:
        assert tfiles[name] == _files(src)[name]

    back, cfg2 = loader.load_params(tdir, dtype=getattr(torch, dtype), device="cpu")
    assert type(cfg2) is type(tcfg)
    got = dict(losses.tree_paths(back))
    want = dict(losses.tree_paths(tp))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if fam.startswith("gemma") and path.endswith(".scale"):
            torch.testing.assert_close(g, w, atol=2.0 ** -24, rtol=0, msg=path)
        else:
            assert torch.equal(g, w), path


def test_export_hf_of_quantized_leaves(hf_dirs, tmp_path):
    """Dense: JAX's export fails on an int8 leaf ({q, s} has no astype) and
    the port's refuses it by name. DeepSeek: both mean to dequantize, but
    JAX's indexes a quantized expert stack as an array and raises KeyError
    (ROADMAP C2 g); the port's export equals JAX's export of the same tree
    with every quantized leaf dequantized by JAX's ``dequant`` in f32."""
    from lapha_tpu.models import quant as jquant

    src = hf_dirs["qwen2"]
    jp, jcfg = jloader.load_params(src, dtype=jnp.float32, quantize="int8")
    tp = loader.params_from_numpy(jax.tree.map(np.asarray, jp))
    with pytest.raises(AttributeError):
        jloader.export_hf(jp, jcfg, str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="quantized"):
        loader.export_hf(tp, loader.load_config(src), str(tmp_path / "port"))

    src = hf_dirs["deepseek_v2"]
    jq, jcfg = jloader.load_params(src, dtype=jnp.float32, quantize="int8")
    tq = loader.params_from_numpy(jax.tree.map(np.asarray, jq))
    assert is_quantized(tq["moe_layers"]["moe"]["experts"]["up_proj"]["w"])
    with pytest.raises(KeyError):
        jdeepseek.export_hf(jq, jcfg, str(tmp_path / "jax_q"))
    jdense = jax.tree.map(lambda w: jquant.dequant(w, jnp.float32), jq,
                          is_leaf=jquant.is_quantized)
    jdeepseek.export_hf(jdense, jcfg, str(tmp_path / "jax"))
    tdeepseek.export_hf(tq, loader.load_config(src), str(tmp_path / "port"))
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))


def test_value_head_artifacts_match_jax(tmp_path):
    """.npz and .pt: JAX's arrays ({weight (1, H), bias (1,)}, f32); the
    port's loader reads both files of both writers back bit-equal."""
    from lapha_tpu.models import value_model as jvm

    jhead = jvm.init_value_head(48, jax.random.key(3))
    jhead = {"w": jhead["w"], "b": jnp.asarray(0.375, jnp.float32)}
    thead = {k: torch.from_numpy(np.array(v)) for k, v in jhead.items()}
    for ext in ("npz", "pt"):
        jpath, tpath = str(tmp_path / f"j.{ext}"), str(tmp_path / f"t.{ext}")
        jloader.save_value_head(jpath, jhead)
        loader.save_value_head(tpath, thead)
        if ext == "npz":
            j, t = np.load(jpath), np.load(tpath)
            assert sorted(j.files) == sorted(t.files) == ["bias", "weight"]
            pairs = [(t[k], j[k]) for k in ("weight", "bias")]
        else:
            j, t = torch.load(jpath), torch.load(tpath)
            assert list(j) == list(t) == ["weight", "bias"]
            pairs = [(t[k].numpy(), j[k].numpy()) for k in ("weight", "bias")]
        for a, b in pairs:
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        assert pairs[0][0].shape == (1, 48) and pairs[1][0].shape == (1,)
        for path in (jpath, tpath):
            back = loader.load_value_head(path, 48, device="cpu")
            assert torch.equal(back["w"], thead["w"]) and torch.equal(back["b"], thead["b"])
