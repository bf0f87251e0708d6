"""HF checkpoint -> parameter dict, and numpy trees -> tensors.

Port of the bf16 part of ``lapha_tpu/models/loader.py`` (dense qwen2/llama
checkpoints, no quantization), plus ``params_from_numpy``, which turns the
JAX package's parameter pytree after ``tree_map(np.asarray)`` into this
package's tensors (the conversion from jax to numpy is the caller's).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from .qwen2 import Qwen2Config

# wrapper checkpoints (base_lm.model.layers...) load too
_PREFIXES = ("", "model.", "base_lm.model.", "base_lm.")


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # views of JAX buffers are read-only
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16 from a JAX array
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, device="cpu", dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> the same dict of tensors on ``device``.
    Floating leaves are cast to ``dtype`` when it is given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    t = _to_tensor(np.asarray(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def load_config(model_dir: str) -> Qwen2Config:
    with open(os.path.join(model_dir, "config.json")) as f:
        return Qwen2Config.from_hf(json.load(f))


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


def load_params(model_dir: str, cfg: Qwen2Config | None = None,
                dtype: torch.dtype = torch.bfloat16, device="cpu") -> tuple[dict, Qwen2Config]:
    """Load a dense HF qwen2/llama checkpoint into the stacked parameter dict
    (linear weights transposed to (in, out), a leading layer axis)."""
    if cfg is None:
        cfg = load_config(model_dir)
    cfg = Qwen2Config(**{**cfg.__dict__, "dtype": dtype})
    ts = _Tensors(model_dir)
    L = cfg.num_hidden_layers
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype).contiguous().to(device)

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        t = torch.stack([ts.get(fmt.format(i=i)) for i in range(L)])
        return put(t.transpose(-1, -2) if transpose else t)

    def bias(fmt: str, dim: int) -> torch.Tensor:
        # llama has no q/k/v bias: zeros keep the dict uniform
        if ts.has(fmt.format(i=0)):
            return stack(fmt)
        return torch.zeros((L, dim), dtype=dtype, device=device)

    sa = "layers.{i}.self_attn."
    params = {
        "embed": {"weight": put(ts.get("embed_tokens.weight"))},
        "layers": {
            "input_layernorm": {"scale": stack("layers.{i}.input_layernorm.weight")},
            "post_attention_layernorm": {"scale": stack("layers.{i}.post_attention_layernorm.weight")},
            "attn": {
                "q_proj": {"w": stack(sa + "q_proj.weight", True), "b": bias(sa + "q_proj.bias", nh * dh)},
                "k_proj": {"w": stack(sa + "k_proj.weight", True), "b": bias(sa + "k_proj.bias", nkv * dh)},
                "v_proj": {"w": stack(sa + "v_proj.weight", True), "b": bias(sa + "v_proj.bias", nkv * dh)},
                "o_proj": {"w": stack(sa + "o_proj.weight", True)},
            },
            "mlp": {
                "gate_proj": {"w": stack("layers.{i}.mlp.gate_proj.weight", True)},
                "up_proj": {"w": stack("layers.{i}.mlp.up_proj.weight", True)},
                "down_proj": {"w": stack("layers.{i}.mlp.down_proj.weight", True)},
            },
        },
        "norm": {"scale": put(ts.get("norm.weight"))},
    }
    if not cfg.tie_word_embeddings:
        if ts.has("lm_head.weight"):
            params["lm_head"] = {"weight": put(ts.get("lm_head.weight"))}
        else:  # no separate head in the checkpoint: tie
            cfg = Qwen2Config(**{**cfg.__dict__, "tie_word_embeddings": True})
    return params, cfg


def load_value_head(path: str, hidden_size: int, device="cpu") -> dict:
    """Load a value-head artifact: a torch state dict with ``weight``/``bias``
    (optionally ``value_head.``/``module.``-prefixed, or a full wrapper
    checkpoint), a .npz or a .safetensors file. Returns {"w": (H,), "b": ()}
    float32."""
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
