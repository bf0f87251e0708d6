"""Weight-only quantization for serving — port of ``lapha_tpu/models/quant.py``.

Two leaf layouts, with the JAX package's dict keys so that trees compare
tensor for tensor:

* int8 per output channel: ``{"q": int8 (..., in, out), "s": f32 (..., 1, out)}``;
* int4 group-wise (RTN along the in-dim): ``{"q": uint8 (..., in/2, out),
  "s4": f32 (..., in/group, out)}``. Nibbles are offset-binary (stored
  ``u = v + 8``, u in [1, 15]) and split-half packed:
  ``byte[i] = row i | row i + in/2 << 4``.

The embedding (and an untied LM head) stays int8 with one scale per hidden
channel, ``s`` of shape (1, H): the row gather and the scale fold of
``qwen2._embed`` / ``qwen2._lm_head`` assume it.

Quantizing is bit-exact with the JAX package: f32 ``w / scale``, round half
to even (``torch.round`` and ``jnp.round`` agree), then the same clip.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

_QUANT_PATHS = (
    "q_proj/w", "k_proj/w", "v_proj/w", "o_proj/w",
    "gate_proj/w", "up_proj/w", "down_proj/w",
    "c_fc/w", "c_proj/w",
)


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and ("s" in leaf or "s4" in leaf)


def leaf_device(leaf) -> torch.device:
    """The device of a parameter leaf, plain tensor or quantized dict."""
    return leaf["q"].device if is_quantized(leaf) else leaf.device


def int4_fits(in_dim: int, group: int) -> bool:
    """Split-half packing needs both halves of the in-dim in whole groups."""
    return in_dim % group == 0 and (in_dim // 2) % group == 0


def quantize_weight(w: torch.Tensor, axis: int = -2) -> dict:
    """Symmetric int8 with one scale per channel, reduced over ``axis``: the
    in-dim (-2) of a projection, or the vocabulary (0) of an embedding / LM
    head table (one scale per H channel)."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=axis, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_weight_int4(w: torch.Tensor, group: int = 128) -> dict:
    """Group-wise symmetric int4 (RTN) along the in-dim, offset-binary
    nibbles in split-half packing (module docstring)."""
    *lead, IN, OUT = w.shape
    if not int4_fits(IN, group):
        raise ValueError(f"int4 needs in-dim halves in whole groups: IN={IN}, group={group}")
    wf = w.float().reshape(*lead, IN // group, group, OUT)
    scale = torch.clamp(wf.abs().amax(dim=-2) / 7.0, min=1e-12)  # (..., in/g, out)
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -7, 7)
    u = (q + 8.0).reshape(*lead, IN, OUT).to(torch.uint8)
    half = IN // 2
    return {"q": u[..., :half, :] | (u[..., half:, :] << 4), "s4": scale}


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., in/2, out) -> int8 values in [-7, 7] (..., in, out)."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-2)


def dequant(w: Any, dtype=torch.bfloat16) -> torch.Tensor:
    """Quantized leaf -> dense matrix in ``dtype`` (the scale multiplied in
    ``dtype``, as the JAX package does); plain tensors pass through."""
    if not is_quantized(w):
        return w
    if "s4" in w:
        qi = _unpack_int4(w["q"])
        *lead, IN, OUT = qi.shape
        s = w["s4"]
        groups = s.shape[-2]
        qq = qi.reshape(*lead, groups, IN // groups, OUT).to(dtype)
        return (qq * s[..., :, None, :].to(dtype)).reshape(*lead, IN, OUT)
    return w["q"].to(dtype) * w["s"].to(dtype)


def _is_table(path: str) -> bool:
    return path.endswith("embed/weight") or path.endswith("lm_head/weight")


def quantize_params(params: dict, *, quantize_embed: bool = True, bits: int = 8,
                    group: int = 128) -> dict:
    """A new tree with the large matmul weights quantized (biases, norms and
    small tensors are the same tensors). ``bits=4`` packs each projection
    whose in-dim splits into whole groups as int4 and the others int8; the
    embedding and LM head stay int8."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: 4 or 8")

    def walk(node, path=""):
        if isinstance(node, dict) and not is_quantized(node):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if any(path.endswith("/" + p) for p in _QUANT_PATHS):
            if bits == 4 and int4_fits(node.shape[-2], group):
                return quantize_weight_int4(node, group)
            return quantize_weight(node)
        if quantize_embed and _is_table(path):
            return quantize_weight(node, axis=0)
        return node

    return walk(params)


def quantize_host_tree(params_np: dict, *, quantize_embed: bool = True,
                       device="cuda") -> dict:
    """Quantize a NUMPY param tree to int8 on the host, then move only the
    int8 result (and the other leaves) to ``device``, so the full-precision
    weights never reach the card."""
    from .loader import _to_tensor  # numpy (bf16 too) -> tensor; loader imports this module

    def qw(w, axis):
        leaf = quantize_weight(_to_tensor(np.asarray(w, np.float32)), axis)
        return {k: v.to(device) for k, v in leaf.items()}

    def walk(node, path=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if any(path.endswith("/" + p) for p in _QUANT_PATHS):
            return qw(node, axis=-2)
        if quantize_embed and _is_table(path):
            return qw(node, axis=0)
        return _to_tensor(np.asarray(node)).to(device)

    return walk(params_np)


def init_params_quantized(cfg, generator: torch.Generator, *, quantize_embed: bool = True,
                          bits: int = 8, group: int = 128) -> dict:
    """A random quantized tree of the tied qwen-family layout, made directly
    on the generator's device: int8 (or, with ``bits=4``, packed int4
    projections; the embedding stays int8). No full-precision weight is
    made anywhere. The values are random draws, not the quantization of a
    model: for throughput runs."""
    if (cfg.num_experts > 0 or cfg.qk_norm or cfg.norm_style != "rms"
            or cfg.mlp_style != "swiglu"):
        raise ValueError("init_params_quantized builds the dense qwen-family tree only; "
                         "quantize an MoE, q/k-norm or StarCoder2 tree with quantize_params")
    dev = generator.device
    L, H = cfg.num_hidden_layers, cfg.hidden_size
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    I = cfg.intermediate_size

    def qw(shape, axis=-2):
        in_dim = shape[axis]
        if bits == 4 and axis == -2 and int4_fits(in_dim, group):
            p_shape = list(shape)
            p_shape[axis] = in_dim // 2
            s_shape = list(shape)
            s_shape[axis] = in_dim // group
            q = torch.randint(0, 256, tuple(p_shape), generator=generator, device=dev,
                              dtype=torch.uint8)
            s = torch.full(tuple(s_shape), 1.0 / (7.0 * math.sqrt(in_dim)), device=dev)
            return {"q": q, "s4": s}
        q = torch.randint(-127, 128, tuple(shape), generator=generator, device=dev,
                          dtype=torch.int8)
        s_shape = list(shape)
        s_shape[axis] = 1
        s = torch.full(tuple(s_shape), 1.0 / (127.0 * math.sqrt(in_dim)), device=dev)
        return {"q": q, "s": s}

    def const(value, *shape):
        return torch.full(shape, value, dtype=cfg.dtype, device=dev)

    if quantize_embed:
        embed = qw((cfg.vocab_size, H), axis=0)
    else:
        embed = (torch.randn((cfg.vocab_size, H), generator=generator, device=dev) * 0.02
                 ).to(cfg.dtype)
    params = {
        "embed": {"weight": embed},
        "layers": {
            "input_layernorm": {"scale": const(1.0, L, H)},
            "post_attention_layernorm": {"scale": const(1.0, L, H)},
            "attn": {
                "q_proj": {"w": qw((L, H, nh * dh)), "b": const(0.0, L, nh * dh)},
                "k_proj": {"w": qw((L, H, nkv * dh)), "b": const(0.0, L, nkv * dh)},
                "v_proj": {"w": qw((L, H, nkv * dh)), "b": const(0.0, L, nkv * dh)},
                "o_proj": {"w": qw((L, nh * dh, H))},
            },
            "mlp": {
                "gate_proj": {"w": qw((L, H, I))},
                "up_proj": {"w": qw((L, H, I))},
                "down_proj": {"w": qw((L, I, H))},
            },
        },
        "norm": {"scale": const(1.0, H)},
    }
    return params


def tree_to(params, device, dtype: torch.dtype | None = None):
    """The tree on ``device``; floating leaves outside quantized leaves are
    cast to ``dtype`` when it is given (quantized values and scales keep
    their types)."""
    if is_quantized(params):
        return {k: v.to(device) for k, v in params.items()}
    if isinstance(params, dict):
        return {k: tree_to(v, device, dtype) for k, v in params.items()}
    if dtype is not None and params.is_floating_point():
        return params.to(device, dtype)
    return params.to(device)


def params_nbytes(params) -> int:
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    return params.numel() * params.element_size()
