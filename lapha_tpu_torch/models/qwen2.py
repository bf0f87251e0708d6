"""Dense Qwen2/Llama decoder in PyTorch — the served subset of
``lapha_tpu/models/qwen2.py``.

The model is a set of functions over a parameter dict with the JAX pytree's
stacked layout and key names (``layers.attn.q_proj.w`` is (L, H, nh·dh),
weights are (in, out)), so JAX weights convert one to one
(``loader.params_from_numpy``). The layer loop is a Python loop over static
per-layer views (``_layer_params``), the eager counterpart of ``lax.scan``.

Attention goes through the port's kernels: the no-cache forward through
``flash_attention`` (the value forward), the cache-threaded forward through
``flash_attention_cached`` (every engine prefill) and ``decode_step``
through ``ragged_decode_attention``. On the CPU those are their plain
PyTorch versions.

Matrix products are ``torch.matmul``/``torch.addmm`` in the working dtype
(f32 accumulation inside, one rounding to the dtype at the output). The JAX
model keeps the MLP's gate/up products in f32 before the activation; here
they are rounded to the working dtype first, which only matters in bf16.
The LM head is computed in f32, as in JAX.

Not ported yet: sliding windows, softcaps, sinks, q/k norms, MoE, the other
norm/MLP styles, quantized weights, int8 KV, windowed decode caches and
``decode_step_multi``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention, flash_attention_cached
from ..ops.ragged_decode_attention import ragged_decode_attention, ragged_decode_plain


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: int | None = None
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    # () = none, ("linear", factor), or ("llama3", factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings)
    rope_scaling: tuple = ()
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    attention_bias: bool = True
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.rope_scaling and self.rope_scaling[0] not in ("linear", "llama3"):
            raise ValueError(f"rope_scaling {self.rope_scaling[0]!r}: not yet ported")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def attn_scale_(self) -> float:
        return 1.0 / math.sqrt(self.head_dim_)

    @staticmethod
    def _parse_rope_scaling(cfg: dict) -> tuple:
        """HF config.json ``rope_scaling`` -> the config tuple (new-style
        ``rope_type`` or legacy ``type`` key)."""
        rs = cfg.get("rope_scaling")
        if not rs:
            return ()
        kind = rs.get("rope_type", rs.get("type", "default"))
        if kind == "default":
            return ()
        if kind == "linear":
            return ("linear", float(rs["factor"]))
        if kind == "llama3":
            return ("llama3", float(rs["factor"]),
                    float(rs["low_freq_factor"]), float(rs["high_freq_factor"]),
                    int(rs["original_max_position_embeddings"]))
        raise ValueError(f"rope_scaling type {kind!r}: not yet ported")

    @classmethod
    def from_hf(cls, cfg: dict, dtype: torch.dtype = torch.bfloat16) -> "Qwen2Config":
        """From an HF config.json dict of the dense qwen2 or llama family."""
        mt = cfg.get("model_type", "qwen2")
        if mt not in ("qwen2", "qwen2_5", "llama"):
            raise ValueError(f"model_type {mt!r}: not yet ported")
        if cfg.get("sliding_window") and (mt == "llama" or cfg.get("use_sliding_window")):
            raise ValueError("sliding-window checkpoints: not yet ported")
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            max_position_embeddings=cfg.get("max_position_embeddings", 32768),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=cls._parse_rope_scaling(cfg),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=cfg.get("tie_word_embeddings", True),
            attention_bias=cfg.get("attention_bias", mt.startswith("qwen2")),
            dtype=dtype,
        )

    @classmethod
    def tiny(cls, **kw) -> "Qwen2Config":
        """A toy config for tests (the JAX package's ``tiny``)."""
        base = dict(
            vocab_size=512,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=2,
            max_position_embeddings=256,
            rope_theta=10000.0,
            tie_word_embeddings=True,
            dtype=torch.float32,
        )
        base.update(kw)
        return cls(**base)


# ----------------------------------------------------------------------------
# Parameter init
# ----------------------------------------------------------------------------

def init_params(cfg: Qwen2Config, generator: torch.Generator, device=None) -> dict:
    """Random-init a stacked-parameter dict from ``generator`` (on the
    generator's device unless ``device`` says otherwise)."""
    device = generator.device if device is None else torch.device(device)
    L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def init(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=device)

    params = {
        "embed": {"weight": init((cfg.vocab_size, H), 0.02)},
        "layers": {
            "input_layernorm": {"scale": ones(L, H)},
            "post_attention_layernorm": {"scale": ones(L, H)},
            "attn": {
                "q_proj": {"w": init((L, H, nh * dh)), "b": zeros(L, nh * dh)},
                "k_proj": {"w": init((L, H, nkv * dh)), "b": zeros(L, nkv * dh)},
                "v_proj": {"w": init((L, H, nkv * dh)), "b": zeros(L, nkv * dh)},
                "o_proj": {"w": init((L, nh * dh, H))},
            },
            "mlp": {
                "gate_proj": {"w": init((L, H, I))},
                "up_proj": {"w": init((L, H, I))},
                "down_proj": {"w": init((L, I, H))},
            },
        },
        "norm": {"scale": ones(H)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": init((cfg.vocab_size, H), 0.02)}
    return params


# ----------------------------------------------------------------------------
# Building blocks
# ----------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_freqs(positions: torch.Tensor, dh: int, theta: float,
               scaling: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (…, dh/2) for integer positions (…,). ``scaling``:
    () none, ("linear", factor), or ("llama3", factor, low, high, orig_max)
    — HF's llama-3.1 wavelength-dependent interpolation."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=positions.device) / dh))
    if scaling and scaling[0] == "linear":
        inv = inv / scaling[1]
    elif scaling and scaling[0] == "llama3":
        _, factor, low, high, orig = scaling
        wavelen = 2.0 * math.pi / inv
        smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
        inv = (1.0 - smooth) * (inv / factor) + smooth * inv
    elif scaling:
        raise ValueError(f"unknown rope scaling {scaling!r}")
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE; x is (B, T, n, dh), cos/sin are (B, T, dh/2)."""
    dh = x.shape[-1]
    x1, x2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _proj(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """h (..., IN) @ w (IN, OUT) [+ b] in h's dtype."""
    h2 = h.reshape(-1, h.shape[-1])
    y = torch.addmm(b, h2, w) if b is not None else h2 @ w
    return y.reshape(*h.shape[:-1], w.shape[-1])


def _mlp(cfg: Qwen2Config, p: dict, h: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN on normed hidden h (..., H)."""
    gate = _proj(h, p["mlp"]["gate_proj"]["w"])
    up = _proj(h, p["mlp"]["up_proj"]["w"])
    act = (F.silu(gate.float()) * up.float()).to(h.dtype)
    return _proj(act, p["mlp"]["down_proj"]["w"])


def _embed(params: dict, cfg: Qwen2Config, toks: torch.Tensor) -> torch.Tensor:
    return params["embed"]["weight"][toks].to(cfg.dtype)


def _lm_head(params: dict, cfg: Qwen2Config, x: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden (..., H) -> logits (..., V) in f32."""
    head_w = (params["embed"]["weight"] if cfg.tie_word_embeddings
              else params["lm_head"]["weight"])
    return x.float() @ head_w.float().T


def _dispatch_attend(cfg: Qwen2Config, q, k, v, key_mask):
    """No-cache path: causal flash attention with key-padding mask."""
    return flash_attention(q, k, v, key_mask, causal=True, scale=cfg.attn_scale_)


def _dispatch_attend_cached(cfg: Qwen2Config, q, k, v, key_mask, qstart):
    """Cache-threaded path: T new queries at qstart[b] + t over the whole
    (B, S) cache, ``key_mask`` being the cache-column validity."""
    return flash_attention_cached(q, k, v, key_mask, qstart, scale=cfg.attn_scale_)


def _layer_params(params: dict, l: int) -> dict:
    """Per-layer views of the stacked layer dict (zero-copy)."""

    def slice_node(node):
        if isinstance(node, dict):
            return {k: slice_node(v) for k, v in node.items()}
        return node[l]

    return slice_node(params["layers"])


def _layer_body(cfg: Qwen2Config, p: dict, x, cos, sin, key_mask,
                cache_k=None, cache_v=None, cache_pos=None):
    """One decoder layer. With ``cache_k``/``cache_v`` ((B, S, nkv, dh)
    views of one layer) the new K/V are written at ``cache_pos`` (int or
    (B,) per-row offsets) IN PLACE — the JAX model's dynamic_update_slice /
    scatter — and attention runs over the whole cache."""
    B, T, _ = x.shape
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    a = p["attn"]
    h = rms_norm(x, p["input_layernorm"]["scale"], cfg.rms_norm_eps)
    q = apply_rope(_proj(h, a["q_proj"]["w"], a["q_proj"]["b"]).reshape(B, T, nh, dh), cos, sin)
    k = apply_rope(_proj(h, a["k_proj"]["w"], a["k_proj"]["b"]).reshape(B, T, nkv, dh), cos, sin)
    v = _proj(h, a["v_proj"]["w"], a["v_proj"]["b"]).reshape(B, T, nkv, dh)
    if cache_k is not None:
        if isinstance(cache_pos, int):
            cache_k[:, cache_pos:cache_pos + T] = k
            cache_v[:, cache_pos:cache_pos + T] = v
        else:
            b_idx = torch.arange(B, device=x.device)[:, None]
            t_idx = cache_pos.long()[:, None] + torch.arange(T, device=x.device)[None, :]
            cache_k[b_idx, t_idx] = k
            cache_v[b_idx, t_idx] = v
        att = _dispatch_attend_cached(cfg, q, cache_k, cache_v, key_mask, cache_pos)
    else:
        att = _dispatch_attend(cfg, q, k, v, key_mask)
    x = x + _proj(att.reshape(B, T, nh * dh), a["o_proj"]["w"])
    h = rms_norm(x, p["post_attention_layernorm"]["scale"], cfg.rms_norm_eps)
    return x + _mlp(cfg, p, h)


def forward(
    params: dict,
    cfg: Qwen2Config,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_pos: int | torch.Tensor = 0,
    kv_valid: torch.Tensor | None = None,
    return_hidden: bool = False,
    compute_logits: bool = True,
):
    """Full forward pass.

    * ``kv_cache=None``: causal attention over input_ids (B,T) with optional
      padding ``attention_mask`` (B,T).
    * ``kv_cache=(k, v)`` of shape (L,B,S,nkv,dh): the T new tokens are
      written at ``cache_pos`` (in place) and attend over cache columns
      where ``kv_valid`` (B,S) holds, causally by slot.

    Returns (logits | None, last_hidden | None, kv_cache | None).
    """
    B, T = input_ids.shape
    dev = input_ids.device
    x = _embed(params, cfg, input_ids)
    if positions is None:
        if attention_mask is not None:
            positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp(min=0)
        else:
            positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    cos, sin = rope_freqs(positions, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling)

    L = cfg.num_hidden_layers
    if kv_cache is None:
        key_mask = (attention_mask if attention_mask is not None
                    else torch.ones((B, T), dtype=torch.int32, device=dev))
        for l in range(L):
            x = _layer_body(cfg, _layer_params(params, l), x, cos, sin, key_mask)
    else:
        ck, cv = kv_cache
        key_mask = cached_key_mask(kv_valid, cache_pos, T, B, ck.shape[2], dev)
        for l in range(L):
            x = _layer_body(cfg, _layer_params(params, l), x, cos, sin, key_mask,
                            ck[l], cv[l], cache_pos)

    x = rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps)
    logits = _lm_head(params, cfg, x) if compute_logits else None
    return logits, (x if return_hidden else None), kv_cache


def init_kv_cache(cfg: Qwen2Config, batch: int, max_len: int, device=None):
    shape = (cfg.num_hidden_layers, batch, max_len, cfg.num_key_value_heads, cfg.head_dim_)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def cached_key_mask(kv_valid, cache_pos, T: int, B: int, S: int, device=None) -> torch.Tensor:
    """(B, S) int32 cache-column validity for the rectangular attention:
    explicit ``kv_valid`` wins; otherwise columns [0, cache_pos + T)."""
    if kv_valid is not None:
        if tuple(kv_valid.shape) != (B, S):
            raise ValueError(f"kv_valid shape {tuple(kv_valid.shape)} != {(B, S)}")
        return kv_valid.to(torch.int32)
    end = torch.as_tensor(cache_pos, device=device).reshape(-1, 1) + T
    return (torch.arange(S, device=device)[None, :] < end).expand(B, S).to(torch.int32)


def decode_step(
    params: dict,
    cfg: Qwen2Config,
    tok: torch.Tensor,        # (B,) — the tokens to forward
    positions: torch.Tensor,  # (B,) — true sequence positions (RoPE)
    cache_k: torch.Tensor,    # (L, B, nkv, S, dh) — slot-uniform decode layout
    cache_v: torch.Tensor,
    slot: int,                # the cache column every row writes this step
    lens: torch.Tensor,       # (B,) prompt lengths (prefix validity)
    dstart: torch.Tensor,     # (B,) first valid decode column per row
    return_hidden: bool = False,
    ragged: bool = True,
):
    """One-token decode for all rows over the slot-uniform cache: row b's
    valid columns are [0, lens[b]) ∪ [dstart[b], slot]. Every row writes
    this step's K/V at column ``slot`` IN PLACE (the JAX model's
    dynamic_update_slice). ``ragged=True`` sends attention through the ragged
    decode kernel; ``ragged=False`` is the dense attention of the JAX sync
    engine, kept as the CPU reference only (on the card decode attention is
    the kernel's).

    Returns (logits (B,V) f32, hidden (B,H) | None, cache_k, cache_v)."""
    if not ragged and cache_k.is_cuda:
        raise ValueError("decode_step(ragged=False) is the CPU reference; CUDA "
                         "decode attention runs the ragged kernel")
    attend = ragged_decode_attention if ragged else ragged_decode_plain
    L = cfg.num_hidden_layers
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    B = tok.shape[0]
    x = _embed(params, cfg, tok)  # (B, H)
    cos, sin = rope_freqs(positions, dh, cfg.rope_theta, cfg.rope_scaling)
    cos, sin = cos[:, None], sin[:, None]  # (B, 1, dh/2): one "time" step
    for l in range(L):
        p = _layer_params(params, l)
        a = p["attn"]
        h = rms_norm(x, p["input_layernorm"]["scale"], cfg.rms_norm_eps)
        q = apply_rope(_proj(h, a["q_proj"]["w"], a["q_proj"]["b"]).reshape(B, 1, nh, dh), cos, sin)
        k = apply_rope(_proj(h, a["k_proj"]["w"], a["k_proj"]["b"]).reshape(B, 1, nkv, dh), cos, sin)
        v = _proj(h, a["v_proj"]["w"], a["v_proj"]["b"]).reshape(B, nkv, dh)
        cache_k[l, :, :, slot] = k[:, 0]
        cache_v[l, :, :, slot] = v
        o = attend(q[:, 0], cache_k, cache_v, l, lens, dstart, slot, scale=cfg.attn_scale_)
        x = x + _proj(o.reshape(B, nh * dh), a["o_proj"]["w"])
        h2 = rms_norm(x, p["post_attention_layernorm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h2)
    x = rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps)
    logits = _lm_head(params, cfg, x)
    return logits, (x if return_hidden else None), cache_k, cache_v
