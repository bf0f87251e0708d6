"""HF checkpoint -> parameter dict, and numpy trees -> tensors.

Port of the qwen2/qwen3/llama/mistral, phi3, starcoder2, MoE (qwen2_moe,
qwen3_moe, mixtral), gpt_oss, gemma2/gemma3 and deepseek_v2/v3 (through
``deepseek.load_params``) part of ``lapha_tpu/models/loader.py``, with its load-time quantization (``quantize="int8"|"int4"``, done on the host by
``quant.quantize_weight``/``quantize_weight_int4``, bit-equal to the JAX
loader's numpy code, so only the quantized weights reach the card), plus ``params_from_numpy``, which turns the JAX package's
parameter pytree after ``tree_map(np.asarray)`` into this package's tensors
(the conversion from jax to numpy is the caller's).

``load_params`` and ``load_value_head`` put the tensors on the card unless
the caller passes ``device="cpu"``; without a card they raise.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from .quant import int4_fits, is_quantized, quantize_weight, quantize_weight_int4
from .qwen2 import Qwen2Config

# wrapper checkpoints (base_lm.model.layers...) load too
_PREFIXES = ("", "model.", "base_lm.model.", "base_lm.")

# MoE tensor names per layout: router, expert gate / up / down (HF Linear
# weights, (out, in)). "qwen": Qwen1.5-MoE / Qwen3-MoE; "mixtral": w1 = gate,
# w3 = up, w2 = down under block_sparse_moe.
_MOE_FMTS = {
    "qwen": ("layers.{i}.mlp.gate.weight",
             "layers.{i}.mlp.experts.{e}.gate_proj.weight",
             "layers.{i}.mlp.experts.{e}.up_proj.weight",
             "layers.{i}.mlp.experts.{e}.down_proj.weight"),
    "mixtral": ("layers.{i}.block_sparse_moe.gate.weight",
                "layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
                "layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
                "layers.{i}.block_sparse_moe.experts.{e}.w2.weight"),
}


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # views of JAX buffers are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu", dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when it is given, except inside a
    quantized leaf (int8/uint8 values and f32 scales are kept as they are)."""
    if is_quantized(tree):
        return {k: _to_tensor(np.asarray(v)).to(device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = _to_tensor(np.asarray(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def load_config(model_dir: str):
    """The checkpoint's config: a ``DeepseekConfig`` for deepseek_v2 /
    deepseek_v3, else a ``Qwen2Config``."""
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    if cfg.get("model_type") in ("deepseek_v2", "deepseek_v3"):  # MLA: its own config
        from .deepseek import DeepseekConfig

        return DeepseekConfig.from_hf(cfg)
    return Qwen2Config.from_hf(cfg)


class _Tensors:
    """Name -> tensor over every *.safetensors file of a checkpoint dir."""

    def __init__(self, model_dir: str):
        from safetensors import safe_open

        files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
        if not files:
            raise FileNotFoundError(f"no .safetensors files in {model_dir}")
        self._where = {}
        for fname in files:
            f = safe_open(os.path.join(model_dir, fname), framework="pt", device="cpu")
            for key in f.keys():
                self._where[key] = f

    def has(self, name: str) -> bool:
        return any(p + name in self._where for p in _PREFIXES)

    def get(self, name: str) -> torch.Tensor:
        for p in _PREFIXES:
            if p + name in self._where:
                return self._where[p + name].get_tensor(p + name)
        raise KeyError(f"{name} not found (tried prefixes {_PREFIXES})")


def _device(device, name: str) -> torch.device:
    """The target device; a CUDA target without a card raises (no silent
    fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA device; pass device='cpu' to load on the CPU")
    return device


def load_params(model_dir: str, cfg: Qwen2Config | None = None,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                quantize: str | None = None) -> tuple[dict, Qwen2Config]:
    """Load a dense HF qwen2/llama checkpoint into the stacked parameter dict
    (linear weights transposed to (in, out), a leading layer axis).

    ``quantize="int8"`` stores the projections and the embedding (and an
    untied LM head) as per-channel int8; ``quantize="int4"`` packs each
    projection whose in-dim splits into whole group-128 halves as int4 and
    keeps the others, the embedding and the head int8 — the JAX loader's
    rules. MoE expert stacks are int8 in both modes, and the router and the
    shared expert's gate stay unquantized, as in JAX. Quantization runs on
    the host; only its result is moved. Expert stacks are built one layer
    at a time into their (L, E, in, out) tensor on ``device``.

    gpt_oss (the dequantized bf16 export, as the JAX loader expects): the
    o_proj bias, the sinks kept in f32, the router bias, and the stacked
    expert tensors (already (E, in, out)) with the gate_up columns
    de-interleaved from [g0, u0, g1, u1, ...] into [gate | up] halves.

    phi3: the fused ``qkv_proj`` is split [q; k; v] and ``gate_up_proj``
    [gate; up] on the out dim at load, each piece stacked (and quantized)
    as a per-tensor mat would be; the q/k/v biases are zeros.

    starcoder2: the LayerNorm biases, the projection biases (o_proj's too)
    and the plain ``c_fc`` / ``c_proj`` FFN with its biases.

    gemma2 / gemma3_text: every RMS scale (the four norms of a layer, the
    q/k norms and the final norm) is stored as w of the (1 + w) scale; the
    +1 is folded in at load, in f32, and the scale kept f32 (JAX
    ``stack_norm``).

    deepseek_v2 / deepseek_v3 (a ``DeepseekConfig``) load through
    ``deepseek.load_params`` (the two stacked layer groups; int8 only)."""
    if cfg is None:
        cfg = load_config(model_dir)
    if type(cfg).__name__ == "DeepseekConfig":
        from . import deepseek

        return deepseek.load_params(model_dir, cfg, dtype=dtype, device=device, quantize=quantize)
    if quantize not in (None, "int8", "int4"):
        raise ValueError(f"unsupported quantize={quantize!r}")
    device = _device(device, "load_params")
    cfg = Qwen2Config(**{**cfg.__dict__, "dtype": dtype})
    ts = _Tensors(model_dir)
    L = cfg.num_hidden_layers
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    q4 = quantize == "int4"
    q8 = quantize is not None  # int4 mode keeps int8 where int4 does not fit

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype).contiguous().to(device)

    def put_quant(leaf: dict) -> dict:
        return {k: v.contiguous().to(device) for k, v in leaf.items()}

    def finish(t: torch.Tensor, transpose: bool = False, quantizable: bool = True):
        """A stacked (L, ...) host tensor -> the leaf on ``device``: the big
        matmul weights, (L, in, out) on the host, quantized under
        ``quantize``, anything else cast. phi3's fused mats are split first
        and each piece comes through here, as a per-tensor mat would."""
        if q8 and transpose and quantizable:
            host = t.float().transpose(-1, -2)
            if q4 and int4_fits(host.shape[-2], 128):
                return put_quant(quantize_weight_int4(host, 128))
            return put_quant(quantize_weight(host))
        return put(t.transpose(-1, -2) if transpose else t)

    def stack_raw(fmt: str) -> torch.Tensor:
        return torch.stack([ts.get(fmt.format(i=i)) for i in range(L)])

    def stack(fmt: str, transpose: bool = False, quantizable: bool = True):
        return finish(stack_raw(fmt), transpose, quantizable)

    def stack_norm(fmt: str) -> torch.Tensor:
        if cfg.sandwich_norms:  # gemma: (1 + w), folded in f32
            return (torch.stack([ts.get(fmt.format(i=i)).float() for i in range(L)])
                    + 1.0).to(device)
        return stack(fmt)

    def table(name: str):
        t = ts.get(name)
        return put_quant(quantize_weight(t, axis=0)) if q8 else put(t)

    def bias(fmt: str, dim: int) -> torch.Tensor:
        # llama has no q/k/v bias: zeros keep the dict uniform
        if ts.has(fmt.format(i=0)):
            return stack(fmt)
        return torch.zeros((L, dim), dtype=dtype, device=device)

    sa = "layers.{i}.self_attn."
    if cfg.fused_qkv:  # phi3: one qkv_proj mat, split [q; k; v] on the out dim
        qkv = stack_raw(sa + "qkv_proj.weight")  # (L, (nh + 2 nkv) dh, H)
        qd, kd = nh * dh, nkv * dh
        attn = {"q_proj": {"w": finish(qkv[:, :qd], True),
                           "b": torch.zeros((L, qd), dtype=dtype, device=device)},
                "k_proj": {"w": finish(qkv[:, qd:qd + kd], True),
                           "b": torch.zeros((L, kd), dtype=dtype, device=device)},
                "v_proj": {"w": finish(qkv[:, qd + kd:], True),
                           "b": torch.zeros((L, kd), dtype=dtype, device=device)}}
        del qkv
    else:
        attn = {"q_proj": {"w": stack(sa + "q_proj.weight", True),
                           "b": bias(sa + "q_proj.bias", nh * dh)},
                "k_proj": {"w": stack(sa + "k_proj.weight", True),
                           "b": bias(sa + "k_proj.bias", nkv * dh)},
                "v_proj": {"w": stack(sa + "v_proj.weight", True),
                           "b": bias(sa + "v_proj.bias", nkv * dh)}}
    attn["o_proj"] = {"w": stack(sa + "o_proj.weight", True)}
    params = {
        "embed": {"weight": table("embed_tokens.weight")},
        "layers": {
            "input_layernorm": {"scale": stack_norm("layers.{i}.input_layernorm.weight")},
            "post_attention_layernorm": {
                "scale": stack_norm("layers.{i}.post_attention_layernorm.weight")},
            "attn": attn,
        },
        "norm": {"scale": ((ts.get("norm.weight").float() + 1.0).to(device) if cfg.sandwich_norms
                           else put(ts.get("norm.weight")))},
    }
    if cfg.norm_style == "layernorm":  # starcoder2: biased LayerNorm
        for key in ("input_layernorm", "post_attention_layernorm"):
            params["layers"][key]["bias"] = stack(f"layers.{{i}}.{key}.bias")
        params["norm"]["bias"] = put(ts.get("norm.bias"))
    def by_layer(host_of, quantizable: bool = True):
        """An (L, ...) expert stack built one layer at a time (``host_of(i)``
        on the host) into tensors on ``device``; int8 per (layer, expert,
        out channel) under ``quantize`` when ``quantizable``."""
        q = q8 and quantizable
        out = None
        for i in range(L):
            host = host_of(i)
            leaf = quantize_weight(host.float()) if q else {"w": host.to(dtype)}
            if out is None:
                out = {k: torch.empty((L, *v.shape), dtype=v.dtype, device=device)
                       for k, v in leaf.items()}
            for k, v in leaf.items():
                out[k][i] = v
        return out if q else out["w"]

    attn = params["layers"]["attn"]
    if cfg.o_proj_bias:
        attn["o_proj"]["b"] = stack(sa + "o_proj.bias")
    if cfg.attn_sinks:  # learned per-head sink logits, kept f32
        attn["sinks"] = torch.stack([ts.get(f"layers.{i}.self_attn.sinks")
                                     for i in range(L)]).float().to(device)
    if cfg.num_experts > 0 and cfg.moe_style == "gptoss":
        def stacked(name: str, deinter: bool = False):
            """layer i's stacked expert tensor, gate_up de-interleaved"""
            def host_of(i):
                t = ts.get(f"layers.{i}.mlp.experts.{name}")
                return torch.cat([t[..., 0::2], t[..., 1::2]], dim=-1) if deinter else t
            return host_of

        params["layers"]["moe"] = {
            "router": {"w": stack("layers.{i}.mlp.router.weight", True, quantizable=False),
                       "b": stack("layers.{i}.mlp.router.bias")},
            "experts": {
                "gate_up": {"w": by_layer(stacked("gate_up_proj", True)),
                            "b": by_layer(stacked("gate_up_proj_bias", True), False)},
                "down": {"w": by_layer(stacked("down_proj")),
                         "b": by_layer(stacked("down_proj_bias"), False)},
            },
        }
    elif cfg.num_experts > 0:
        E = cfg.num_experts

        def experts(fmt: str):
            """(L, E, in, out) from the per-expert HF mats (out, in)."""
            return by_layer(lambda i: torch.stack(
                [ts.get(fmt.format(i=i, e=e)) for e in range(E)]).transpose(-1, -2))

        router, gate, up, down = _MOE_FMTS[cfg.moe_layout]
        moe = {
            # the router and the shared expert's gate stay unquantized: tiny,
            # and routing is precision-sensitive
            "router": {"w": stack(router, True, quantizable=False)},
            "experts": {"gate_proj": {"w": experts(gate)}, "up_proj": {"w": experts(up)},
                        "down_proj": {"w": experts(down)}},
        }
        if cfg.shared_expert_intermediate_size > 0:  # qwen2_moe
            se = "layers.{i}.mlp.shared_expert."
            moe["shared"] = {
                "gate_proj": {"w": stack(se + "gate_proj.weight", True)},
                "up_proj": {"w": stack(se + "up_proj.weight", True)},
                "down_proj": {"w": stack(se + "down_proj.weight", True)},
                "gate": {"w": stack("layers.{i}.mlp.shared_expert_gate.weight", True,
                                    quantizable=False)},
            }
        params["layers"]["moe"] = moe
    elif cfg.mlp_style == "plain":  # starcoder2: c_fc -> act -> c_proj, biased
        params["layers"]["mlp"] = {
            "c_fc": {"w": stack("layers.{i}.mlp.c_fc.weight", True),
                     "b": stack("layers.{i}.mlp.c_fc.bias")},
            "c_proj": {"w": stack("layers.{i}.mlp.c_proj.weight", True),
                       "b": stack("layers.{i}.mlp.c_proj.bias")},
        }
    elif cfg.fused_qkv:  # phi3: gate_up_proj, chunk(2) = [gate; up] on the out dim
        gu = stack_raw("layers.{i}.mlp.gate_up_proj.weight")  # (L, 2I, H)
        I = cfg.intermediate_size
        params["layers"]["mlp"] = {
            "gate_proj": {"w": finish(gu[:, :I], True)},
            "up_proj": {"w": finish(gu[:, I:], True)},
            "down_proj": {"w": stack("layers.{i}.mlp.down_proj.weight", True)},
        }
        del gu
    else:
        params["layers"]["mlp"] = {
            "gate_proj": {"w": stack("layers.{i}.mlp.gate_proj.weight", True)},
            "up_proj": {"w": stack("layers.{i}.mlp.up_proj.weight", True)},
            "down_proj": {"w": stack("layers.{i}.mlp.down_proj.weight", True)},
        }
    if cfg.sandwich_norms:  # gemma: the MLP's pre- and post-norms
        for key in ("pre_feedforward_layernorm", "post_feedforward_layernorm"):
            params["layers"][key] = {"scale": stack_norm(f"layers.{{i}}.{key}.weight")}
    if cfg.qk_norm:
        params["layers"]["attn"]["q_norm"] = {"scale": stack_norm(sa + "q_norm.weight")}
        params["layers"]["attn"]["k_norm"] = {"scale": stack_norm(sa + "k_norm.weight")}
    if not cfg.tie_word_embeddings:
        if ts.has("lm_head.weight"):
            params["lm_head"] = {"weight": table("lm_head.weight")}
        else:  # no separate head in the checkpoint: tie
            cfg = Qwen2Config(**{**cfg.__dict__, "tie_word_embeddings": True})
    return params, cfg


def load_value_head(path: str, hidden_size: int, device="cuda") -> dict:
    """Load a value-head artifact: a torch state dict with ``weight``/``bias``
    (optionally ``value_head.``/``module.``-prefixed, or a full wrapper
    checkpoint), a .npz or a .safetensors file. Returns {"w": (H,), "b": ()}
    float32 on ``device``."""
    device = _device(device, "load_value_head")
    if path.endswith(".npz"):
        z = np.load(path)
        w, b = z["weight"], z["bias"] if "bias" in z else np.zeros(1)
    elif path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        w, b = _pick_head_keys(load_file(path))
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        sd = {k: v.float().numpy() for k, v in sd.items()}
        w, b = _pick_head_keys(sd)
    w = np.asarray(w, np.float32).reshape(-1)
    if w.size != hidden_size:
        raise ValueError(f"value head size {w.size} != hidden {hidden_size}")
    return {"w": torch.from_numpy(w).to(device),
            "b": torch.from_numpy(np.asarray(b, np.float32).reshape(())).to(device)}


def _pick_head_keys(sd: dict):
    for wk in ("weight", "value_head.weight", "module.value_head.weight", "module.weight"):
        if wk in sd:
            return sd[wk], sd.get(wk.replace("weight", "bias"), np.zeros(1))
    for k in sd:
        if re.search(r"value_head\.weight$", k):
            return sd[k], sd.get(k.replace("weight", "bias"), np.zeros(1))
    raise KeyError(f"no value-head weight in keys {list(sd)[:8]}...")
