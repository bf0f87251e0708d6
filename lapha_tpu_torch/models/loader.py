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

The way back: ``export_hf`` writes a tree to an HF-layout f32
``model.safetensors`` for every family the loader takes (DeepSeek through
``deepseek.export_hf``), and ``save_value_head`` writes the value head as
the reference's ``{weight (1, H), bias (1,)}``, the JAX package's writers.
"""

from __future__ import annotations

import json
import os
import re
import shutil

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


def save_value_head(path: str, head: dict) -> None:
    """Write the head artifact. ``.pt``/``.bin`` produce the reference's
    torch state-dict convention ({weight (1,H), bias (1,)}) so its tools
    load it unchanged; anything else writes .npz with the same keys."""
    w = np.ascontiguousarray(head["w"].detach().float().cpu().numpy().reshape(1, -1))
    b = np.ascontiguousarray(head["b"].detach().float().cpu().numpy().reshape(1))
    if path.endswith(".pt") or path.endswith(".bin"):
        torch.save({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}, path)
        return
    np.savez(path if path.endswith(".npz") else path + ".npz", weight=w, bias=b)


def host_f32(name: str, t, transpose: bool = False) -> np.ndarray:
    """A leaf as the C-contiguous f32 host array an export writes (safetensors
    writes raw buffers, so a transposed view must be copied), cast and
    transposed where the leaf lives: on the card that is ~4x faster than a
    host transpose. A quantized leaf raises: the exports write
    full-precision trees."""
    if is_quantized(t):
        raise ValueError(f"{name}: a quantized leaf; export a full-precision tree "
                         "(load with quantize=None)")
    t = t.detach().float()
    if transpose:
        t = t.transpose(-1, -2)
    return t.contiguous().cpu().numpy()


def copy_config_files(src_config_dir: str | None, out_dir: str, names) -> None:
    """Copy the config and tokenizer files ``names`` that ``src_config_dir`` has."""
    if not src_config_dir:
        return
    for fname in names:
        src = os.path.join(src_config_dir, fname)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out_dir, fname))


def export_hf(params: dict, cfg: Qwen2Config, out_dir: str,
              src_config_dir: str | None = None) -> None:
    """Write params back to an HF-layout safetensors dir (policy only), one
    f32 ``model.safetensors`` in the JAX package's key order: dense qwen2 /
    llama / qwen3 / mistral, gemma2 / gemma3 (the +1 folded back out of
    every RMS scale), the MoE families through ``_MOE_FMTS``, gpt_oss (the
    gate_up columns re-interleaved, the biases and sinks), phi3 (fused qkv
    and gate_up) and starcoder2 (plain MLP, LayerNorm biases). The config
    and tokenizer files are copied from ``src_config_dir``. A
    ``DeepseekConfig`` tree goes through ``deepseek.export_hf``."""
    if type(cfg).__name__ == "DeepseekConfig":
        from . import deepseek

        return deepseek.export_hf(params, cfg, out_dir, src_config_dir)
    from safetensors.numpy import save_file

    os.makedirs(out_dir, exist_ok=True)
    sd: dict[str, np.ndarray] = {}

    def put(name: str, t, transpose: bool = False):
        sd[name] = host_f32(name, t, transpose)

    put("model.embed_tokens.weight", params["embed"]["weight"])
    lp = params["layers"]
    # gemma checkpoints store w of the (1 + w) RMS scale; the load folded it in
    nsub = 1.0 if cfg.sandwich_norms else 0.0

    def put_norm(name, t):
        put(name, t - nsub if nsub else t)

    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}."
        put_norm(pre + "input_layernorm.weight", lp["input_layernorm"]["scale"][i])
        put_norm(pre + "post_attention_layernorm.weight",
                 lp["post_attention_layernorm"]["scale"][i])
        if cfg.norm_style == "layernorm":
            put(pre + "input_layernorm.bias", lp["input_layernorm"]["bias"][i])
            put(pre + "post_attention_layernorm.bias", lp["post_attention_layernorm"]["bias"][i])
        if cfg.sandwich_norms:
            put_norm(pre + "pre_feedforward_layernorm.weight",
                     lp["pre_feedforward_layernorm"]["scale"][i])
            put_norm(pre + "post_feedforward_layernorm.weight",
                     lp["post_feedforward_layernorm"]["scale"][i])
        at = lp["attn"]
        if cfg.fused_qkv:  # phi3: the fused [q; k; v] mat
            put(pre + "self_attn.qkv_proj.weight",
                torch.cat([at[f"{p}_proj"]["w"][i] for p in ("q", "k", "v")], dim=-1),
                transpose=True)
        else:
            for proj in ("q", "k", "v"):
                put(pre + f"self_attn.{proj}_proj.weight", at[f"{proj}_proj"]["w"][i],
                    transpose=True)
                if cfg.attention_bias:  # llama/qwen3 store no q/k/v bias
                    put(pre + f"self_attn.{proj}_proj.bias", at[f"{proj}_proj"]["b"][i])
        if cfg.qk_norm:
            put_norm(pre + "self_attn.q_norm.weight", at["q_norm"]["scale"][i])
            put_norm(pre + "self_attn.k_norm.weight", at["k_norm"]["scale"][i])
        put(pre + "self_attn.o_proj.weight", at["o_proj"]["w"][i], transpose=True)
        if cfg.o_proj_bias:
            put(pre + "self_attn.o_proj.bias", at["o_proj"]["b"][i])
        if cfg.attn_sinks:
            put(pre + "self_attn.sinks", at["sinks"][i])
        if "moe" in lp and cfg.moe_style == "gptoss":
            moe = lp["moe"]
            put(pre + "mlp.router.weight", moe["router"]["w"][i], transpose=True)
            put(pre + "mlp.router.bias", moe["router"]["b"][i])

            def reinter(name, t):  # [gate | up] halves -> interleaved columns
                a = host_f32(name, t)
                half = a.shape[-1] // 2
                out = np.empty_like(a)
                out[..., 0::2] = a[..., :half]
                out[..., 1::2] = a[..., half:]
                sd[name] = np.ascontiguousarray(out)

            reinter(pre + "mlp.experts.gate_up_proj", moe["experts"]["gate_up"]["w"][i])
            reinter(pre + "mlp.experts.gate_up_proj_bias", moe["experts"]["gate_up"]["b"][i])
            put(pre + "mlp.experts.down_proj", moe["experts"]["down"]["w"][i])
            put(pre + "mlp.experts.down_proj_bias", moe["experts"]["down"]["b"][i])
        elif "moe" in lp:
            moe = lp["moe"]
            router_fmt, gate_fmt, up_fmt, down_fmt = _MOE_FMTS[cfg.moe_layout]
            # _MOE_FMTS names are loader-relative; the export adds "model."
            put("model." + router_fmt.format(i=i), moe["router"]["w"][i], transpose=True)
            for e in range(moe["experts"]["gate_proj"]["w"].shape[1]):
                for proj, fmt in (("gate", gate_fmt), ("up", up_fmt), ("down", down_fmt)):
                    put("model." + fmt.format(i=i, e=e),
                        moe["experts"][f"{proj}_proj"]["w"][i, e], transpose=True)
            if "shared" in moe:  # qwen2_moe; qwen3_moe has no shared expert
                for proj in ("gate", "up", "down"):
                    put(pre + f"mlp.shared_expert.{proj}_proj.weight",
                        moe["shared"][f"{proj}_proj"]["w"][i], transpose=True)
                put(pre + "mlp.shared_expert_gate.weight", moe["shared"]["gate"]["w"][i],
                    transpose=True)
        elif cfg.mlp_style == "plain":  # starcoder2
            mlp = lp["mlp"]
            put(pre + "mlp.c_fc.weight", mlp["c_fc"]["w"][i], transpose=True)
            put(pre + "mlp.c_fc.bias", mlp["c_fc"]["b"][i])
            put(pre + "mlp.c_proj.weight", mlp["c_proj"]["w"][i], transpose=True)
            put(pre + "mlp.c_proj.bias", mlp["c_proj"]["b"][i])
        elif cfg.fused_qkv:  # phi3: the fused [gate; up] mat
            mlp = lp["mlp"]
            put(pre + "mlp.gate_up_proj.weight",
                torch.cat([mlp["gate_proj"]["w"][i], mlp["up_proj"]["w"][i]], dim=-1),
                transpose=True)
            put(pre + "mlp.down_proj.weight", mlp["down_proj"]["w"][i], transpose=True)
        else:
            for proj in ("gate", "up", "down"):
                put(pre + f"mlp.{proj}_proj.weight", lp["mlp"][f"{proj}_proj"]["w"][i],
                    transpose=True)
    put_norm("model.norm.weight", params["norm"]["scale"])
    if cfg.norm_style == "layernorm":
        put("model.norm.bias", params["norm"]["bias"])
    if not cfg.tie_word_embeddings and "lm_head" in params:
        put("lm_head.weight", params["lm_head"]["weight"])
    save_file(sd, os.path.join(out_dir, "model.safetensors"))
    copy_config_files(src_config_dir, out_dir,
                      ("config.json", "tokenizer.json", "tokenizer_config.json", "vocab.json",
                       "merges.txt", "generation_config.json"))
