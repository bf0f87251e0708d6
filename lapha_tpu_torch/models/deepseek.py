"""DeepSeek-V2/V3 decoder (Multi-head Latent Attention) in PyTorch — the
served subset of ``lapha_tpu/models/deepseek.py``, with its names.

MLA compresses each token's KV state into one shared latent vector
[c_norm | k_pe] of kv_lora_rank + qk_rope_head_dim values; per-head K/V are
recovered from it through ``kv_b``:

    K_h = [W_UK,h c | k_pe],  V_h = W_UV,h c

Prefill and the value forward expand K/V per head and run the flash kernels
with V narrower than Q/K (scores on the 192-wide nope + rope Q/K, the
combine on the 128-wide V): the no-cache forward through ``flash_attention``
(K1), the cache-threaded forward through ``flash_attention_cached`` (K3,
every engine prefill). On the CPU those are their plain PyTorch versions.
``decode_step`` never expands K/V: it absorbs W_UK into the query and W_UV
into the output and reads the single latent stream with torch products, as
the JAX model's einsums do (no Pallas kernel there)::

    q_lat,h = W_UK,h^T q_nope,h;  s_h = q_lat,h . c_s + q_pe,h . k_pe_s
    ctx_h   = W_UV,h (sum_s softmax(s)_s c_s)

Every product that JAX takes with f32 output (``preferred_element_type``)
is taken with f32 output here too (``qwen2._mm_f32``, ``_bmm_f32``): a
16-bit product on the card, an f32 one on the CPU.

The parameter dict has the JAX pytree's layout: two uniformly stacked layer
groups, ``dense_layers`` (the first ``first_k_dense_replace`` layers, a
SwiGLU MLP) and ``moe_layers`` (``ops.moe.route_deepseek`` + the routed
experts through the grouped GEMM, K8 on the card, + the plain shared
experts). The latent cache is MQA-shaped for the Engine: (L, B, S, 1,
cache_width) in the prefill layout, with a second plane of the same shape
that nothing reads or writes, so that the Engine's layout code stays
model-agnostic (``init_kv_cache``).

Training: the no-cache ``forward`` is differentiable in every leaf of both
groups (the per-layer views of ``_layers`` unbind each stacked leaf, so the
backward stacks its L gradients once): the narrow-V flash kernel's backward
(K2 at Q/K 192, V 128) on the card, the grouped GEMM's backward (dX, tgmm)
under the routed experts, autograd through the router's scores. ``remat``
recomputes each layer body in the backward (``torch.utils.checkpoint``)
whenever it is truthy, as the JAX model checkpoints its layer scan on any
truthy value: a named policy ("save_qkv", ...) means the full recompute
here too.

Not ported yet (they raise ``NotImplementedError`` naming their ROADMAP
item): ``decode_step_multi`` (A8, speculative decoding), ``export_hf`` (A7,
``save_model``) and ``moe_impl="dispatch"`` (A11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention, flash_attention_cached
from . import qwen2
from .qwen2 import (Qwen2Config, _mm_f32, _q_matmul_f32 as _matmul, apply_rope,
                    cached_key_mask, rms_norm, rope_freqs)
from .quant import dequant


@dataclasses.dataclass(frozen=True)
class DeepseekConfig:
    """DeepSeek-V2/V3 architecture (the JAX config's fields, less attn_impl:
    the port picks kernels or plain versions by device)."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944     # dense-layer MLP width
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    # ---- MLA ----
    q_lora_rank: int = 0               # 0 = full q_proj (V2-Lite)
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_interleave: bool = True       # V2 always; V3 config flag
    # ---- rope ----
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rope_scaling: tuple = ()           # Qwen2Config._parse_rope_scaling tuple
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    # ---- MoE ----
    n_routed_experts: int = 0          # 0 = fully dense model
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    n_shared_experts: int = 2          # shared MLP width = n * moe_inter
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    topk_method: str = "greedy"        # greedy|group_limited_greedy|noaux_tc
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"      # softmax (V2) | sigmoid (V3)
    moe_impl: str = "auto"             # ops/moe.py exec strategy
    moe_capacity_factor: float = 2.0
    dtype: Any = torch.bfloat16

    # the knobs qwen2._embed / _lm_head and the Engine read, inert here
    # (plain class attributes, not dataclass fields)
    embed_normalizer = False
    final_softcap = 0.0
    sliding_window = 0
    layer_windows = ()
    max_window_ = 0

    def window_for_layer(self, l: int) -> int:
        return 0

    @property
    def num_key_value_heads(self) -> int:
        """The latent cache is MQA-shaped: one shared "head" per layer (the
        Engine's cache layout reads this with :attr:`head_dim_`)."""
        return 1

    @property
    def head_dim_(self) -> int:
        """The Engine-facing cache vector width."""
        return self.cache_width_

    @property
    def qk_head_dim_(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_width_(self) -> int:
        """Latent cache width per token and layer: c_norm and the roped key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def num_dense_layers_(self) -> int:
        if self.n_routed_experts <= 0:
            return self.num_hidden_layers
        return min(self.first_k_dense_replace, self.num_hidden_layers)

    @property
    def num_moe_layers_(self) -> int:
        return self.num_hidden_layers - self.num_dense_layers_

    # V3 YaRN softmax-scale correction (HF DeepseekV3Attention:
    # yarn_get_mscale(factor, mscale_all_dim)^2; the HF V2 port applies none)
    attn_mscale_sq: float = 1.0

    @property
    def attn_scale_(self) -> float:
        return self.attn_mscale_sq / math.sqrt(self.qk_head_dim_)

    @classmethod
    def from_hf(cls, cfg: dict, dtype: torch.dtype = torch.bfloat16) -> "DeepseekConfig":
        """From an HF config.json dict of model_type deepseek_v2 or
        deepseek_v3, by the JAX package's rules (YaRN through Qwen2Config's
        parser; the V3 mscale_all_dim correction of the softmax scale)."""
        mt = cfg.get("model_type", "deepseek_v2")
        if mt not in ("deepseek_v2", "deepseek_v3"):
            raise ValueError(f"not a deepseek config: model_type={mt!r}")
        v3 = mt == "deepseek_v3"
        mscale_sq = 1.0
        rs = cfg.get("rope_scaling") or {}
        if v3 and rs.get("mscale_all_dim"):
            f = float(rs["factor"])
            ms = 0.1 * float(rs["mscale_all_dim"]) * math.log(f) + 1.0 if f > 1 else 1.0
            mscale_sq = ms * ms
        if cfg.get("attention_bias", False):
            raise ValueError("deepseek attention_bias=True is not supported "
                             "(no released checkpoint sets it)")
        if int(cfg.get("moe_layer_freq", 1) or 1) != 1:
            raise ValueError("moe_layer_freq != 1 is not supported (MoE "
                             "layers must be the contiguous suffix)")
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            q_lora_rank=int(cfg.get("q_lora_rank") or 0),
            kv_lora_rank=cfg["kv_lora_rank"],
            qk_nope_head_dim=cfg["qk_nope_head_dim"],
            qk_rope_head_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"],
            # HF V2 ropes with complex pair math (= interleaved); V3 has the flag
            rope_interleave=bool(cfg.get("rope_interleave", True)),
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rope_scaling=Qwen2Config._parse_rope_scaling(cfg),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
            n_routed_experts=int(cfg.get("n_routed_experts") or 0),
            num_experts_per_tok=int(cfg.get("num_experts_per_tok") or 6),
            moe_intermediate_size=cfg.get("moe_intermediate_size", 1408),
            n_shared_experts=int(cfg.get("n_shared_experts") or 0),
            first_k_dense_replace=int(cfg.get("first_k_dense_replace", 0)),
            routed_scaling_factor=float(cfg.get("routed_scaling_factor", 1.0)),
            topk_method=cfg.get("topk_method", "noaux_tc" if v3 else "greedy"),
            n_group=int(cfg.get("n_group") or 1),
            topk_group=int(cfg.get("topk_group") or 1),
            norm_topk_prob=bool(cfg.get("norm_topk_prob", False)),
            scoring_func=cfg.get("scoring_func", "sigmoid" if v3 else "softmax"),
            attn_mscale_sq=mscale_sq,
            dtype=dtype,
        )


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what}: not yet ported for deepseek (ROADMAP {item})")


# ----------------------------------------------------------------------------
# Building blocks
# ----------------------------------------------------------------------------

def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a (N, I, K) @ b (N, K, J) -> f32, accumulated in f32: 16-bit
    operands on the card stay 16-bit (f32 output), otherwise an f32 product
    (``qwen2._mm_f32``'s rule, inference only)."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _apply_rope_ds(x: torch.Tensor, cos, sin, interleave: bool) -> torch.Tensor:
    """DeepSeek rope on (B, T, n, d). ``interleave`` pairs (x[2i], x[2i+1])
    at frequency i (HF V2's complex math, V3's interleave): de-interleaving
    both q_pe and k_pe and rotating halves is the same rotation, and only
    their inner product enters attention."""
    if interleave:
        x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return apply_rope(x, cos, sin)


def _q_heads(cfg: DeepseekConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """Query projection -> (..., nh, qk_head_dim), [nope | pe] per head."""
    if cfg.q_lora_rank > 0:
        qa = rms_norm(_matmul(h, p["q_a"]["w"]).to(h.dtype), p["q_a_norm"]["scale"],
                      cfg.rms_norm_eps)
        q = _matmul(qa, p["q_b"]["w"])
    else:
        q = _matmul(h, p["q"]["w"])
    return q.to(h.dtype).reshape(*h.shape[:-1], cfg.num_attention_heads, cfg.qk_head_dim_)


def _latent(cfg: DeepseekConfig, p: dict, h: torch.Tensor, cos, sin):
    """kv_a projection of h (B, T, H) -> (c_norm (B, T, r), roped k_pe (B,
    T, 1, rope)): the decode cache's content."""
    ckv = _matmul(h, p["kv_a"]["w"]).to(h.dtype)
    c, k_pe = ckv.split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    c = rms_norm(c, p["kv_a_norm"]["scale"], cfg.rms_norm_eps)
    return c, _apply_rope_ds(k_pe[..., None, :], cos, sin, cfg.rope_interleave)


def _split_kv_b(cfg: DeepseekConfig, p: dict, dtype):
    """kv_b weight (r, nh·(dn+dv)) -> (W_UK (r, nh, dn), W_UV (r, nh, dv))."""
    w = dequant(p["kv_b"]["w"], dtype).reshape(
        cfg.kv_lora_rank, cfg.num_attention_heads, cfg.qk_nope_head_dim + cfg.v_head_dim)
    return w[..., :cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def _expand_kv(cfg: DeepseekConfig, p: dict, c: torch.Tensor, k_pe: torch.Tensor):
    """Per-head K (B, S, nh, dn + rope) and V (B, S, nh, dv) in c's dtype
    from latents c (B, S, r) and shared roped keys k_pe (B, S, rope): one
    product with kv_b (f32 output), then split. Each half is rounded to c's
    dtype right after the product, as JAX's einsums are, so the cotangent
    that reaches the product is already in that dtype and ``_MmF32``'s
    rounding of it to the operands' dtype changes nothing: its backward is
    the JAX einsum's transpose."""
    B, S, r = c.shape
    nh, dn = cfg.num_attention_heads, cfg.qk_nope_head_dim
    kv = _mm_f32(c.reshape(B * S, r), dequant(p["kv_b"]["w"], c.dtype))
    kv = kv.reshape(B, S, nh, dn + cfg.v_head_dim)
    k = torch.cat([kv[..., :dn].to(c.dtype),
                   k_pe[:, :, None, :].expand(B, S, nh, cfg.qk_rope_head_dim)], dim=-1)
    return k, kv[..., dn:].to(c.dtype).contiguous()


def _moe_ffn(cfg: DeepseekConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """The DeepSeek MoE block on (..., H): ``route_deepseek``, the routed
    experts ("auto" = "gather", JAX's choice off the TPU) and the plain
    shared experts."""
    from ..ops import moe as _moe  # lazy: ops.moe imports models.qwen2

    x = h.reshape(-1, h.shape[-1])
    m = p["moe"]
    routing = _moe.route_deepseek(
        x, m["router"]["w"], m["router"].get("bias"), top_k=cfg.num_experts_per_tok,
        scoring=cfg.scoring_func, topk_method=cfg.topk_method, n_group=cfg.n_group,
        topk_group=cfg.topk_group, norm_topk=cfg.norm_topk_prob,
        routed_scaling_factor=cfg.routed_scaling_factor)
    impl = "gather" if cfg.moe_impl == "auto" else cfg.moe_impl
    kw = dict(top_k=cfg.num_experts_per_tok, norm_topk=False, routing=routing)
    if impl == "gather":
        out = _moe.moe_ffn_gather(x, m, **kw)
    elif impl == "dense":
        out = _moe.moe_ffn_dense(x, m, **kw)
    elif impl == "dispatch":
        _not_ported("moe_impl='dispatch' (the capacity-bucketed impl)", "A11")
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    if "shared" in m:
        out = out + _moe.shared_expert(x, m["shared"])
    return out.reshape(h.shape)


def _dense_ffn(p: dict, h: torch.Tensor) -> torch.Tensor:
    gate = _matmul(h, p["mlp"]["gate_proj"]["w"])
    up = _matmul(h, p["mlp"]["up_proj"]["w"])
    act = (F.silu(gate) * up).to(h.dtype)
    return _matmul(act, p["mlp"]["down_proj"]["w"]).to(h.dtype)


def _ffn(cfg: DeepseekConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    return _moe_ffn(cfg, p, h) if "moe" in p else _dense_ffn(p, h)


def _o_proj(cfg: DeepseekConfig, p: dict, att: torch.Tensor) -> torch.Tensor:
    """Attention output (..., nh, dv) -> (..., H) in its dtype (f32 output
    product, then one rounding)."""
    flat = att.reshape(*att.shape[:-2], cfg.num_attention_heads * cfg.v_head_dim)
    return _matmul(flat, p["attn"]["o"]["w"]).to(att.dtype)


def _layers(params: dict) -> list[dict]:
    """Per-layer views of both stacked groups, dense layers first."""
    return [view for group in ("dense_layers", "moe_layers") if group in params
            for view in qwen2._layer_stack({"layers": params[group]})]


def _layer_body(cfg: DeepseekConfig, p: dict, x, cos, sin, key_mask, ck_l=None, cache_pos=0):
    """One decoder layer of the forward; returns (x, latent (B, T, W)).

    Without a cache: causal attention over the T tokens (K1). With ``ck_l``
    (B, S, 1, W), one layer's latent plane: the T latents are written at
    ``cache_pos`` (int, or (B,) per-row offsets) IN PLACE, then K/V are
    expanded from the whole cache and the queries at cache_pos + t attend
    over it where ``key_mask`` (B, S) holds (K3)."""
    B, T, _ = x.shape
    a = p["attn"]
    h = rms_norm(x, p["input_layernorm"]["scale"], cfg.rms_norm_eps)
    q_nope, q_pe = _q_heads(cfg, a, h).split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    q = torch.cat([q_nope, _apply_rope_ds(q_pe, cos, sin, cfg.rope_interleave)], dim=-1)
    c, k_pe = _latent(cfg, a, h, cos, sin)
    lat = torch.cat([c, k_pe[:, :, 0]], dim=-1)
    r = cfg.kv_lora_rank
    if ck_l is None:
        k, v = _expand_kv(cfg, a, c, k_pe[:, :, 0])
        att = flash_attention(q, k, v, key_mask, causal=True, scale=cfg.attn_scale_)
    else:
        if isinstance(cache_pos, int):
            ck_l[:, cache_pos:cache_pos + T, 0] = lat
        else:
            b_idx = torch.arange(B, device=x.device)[:, None]
            t_idx = cache_pos.long()[:, None] + torch.arange(T, device=x.device)[None, :]
            ck_l[b_idx, t_idx, 0] = lat
        k, v = _expand_kv(cfg, a, ck_l[:, :, 0, :r], ck_l[:, :, 0, r:])
        att = flash_attention_cached(q, k, v, key_mask, cache_pos, scale=cfg.attn_scale_)
    x = x + _o_proj(cfg, p, att)
    x = x + _ffn(cfg, p, rms_norm(x, p["post_attention_layernorm"]["scale"],
                                  cfg.rms_norm_eps)).to(x.dtype)
    return x, lat


def forward(
    params: dict,
    cfg: DeepseekConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_pos: int | torch.Tensor = 0,
    kv_valid: torch.Tensor | None = None,
    remat=False,
    return_hidden: bool = False,
    compute_logits: bool = True,
    return_latent: bool = False,
):
    """Full forward pass, qwen2.forward's two modes and contract:

    * ``kv_cache=None``: causal attention over input_ids (B, T) with the
      optional padding ``attention_mask`` (B, T); a truthy ``remat``
      recomputes each layer in the backward when gradients are being
      recorded (JAX's rule: any truthy value, named policies included);
    * ``kv_cache=(ck, cv)`` of shape (L, B, S, 1, cache_width): the T
      tokens' latents are written into ck at ``cache_pos`` (in place) and
      attend where ``kv_valid`` (B, S) holds, causally by slot; ``cv`` is
      carried untouched.

    Returns (logits | None, last_hidden | None, kv_cache | latents), where
    ``latents`` is the (L, B, T, cache_width) stack of the no-cache mode's
    latents when ``return_latent`` (else None)."""
    B, T = input_ids.shape
    dev = input_ids.device
    x = qwen2._embed(params, cfg, input_ids)
    if positions is None:
        if attention_mask is not None:
            positions = (torch.cumsum(attention_mask, dim=1) - 1).clamp(min=0)
        else:
            positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    cos, sin = rope_freqs(positions, cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_scaling)
    lats = []
    if kv_cache is None:
        key_mask = (attention_mask if attention_mask is not None
                    else torch.ones((B, T), dtype=torch.int32, device=dev))
        recompute = bool(remat) and torch.is_grad_enabled()
        for p in _layers(params):
            if recompute:
                x, lat = checkpoint(_layer_body, cfg, p, x, cos, sin, key_mask,
                                    use_reentrant=False)
            else:
                x, lat = _layer_body(cfg, p, x, cos, sin, key_mask)
            if return_latent:
                lats.append(lat)
    else:
        ck = kv_cache[0]
        key_mask = cached_key_mask(kv_valid, cache_pos, T, B, ck.shape[2], dev)
        for l, p in enumerate(_layers(params)):
            x, _ = _layer_body(cfg, p, x, cos, sin, key_mask, ck[l], cache_pos)
    x = rms_norm(x, params["norm"]["scale"], cfg.rms_norm_eps)
    logits = qwen2._lm_head(params, cfg, x) if compute_logits else None
    third = kv_cache if kv_cache is not None else (torch.stack(lats) if return_latent else None)
    return logits, (x if return_hidden else None), third


# ----------------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------------

def init_kv_cache(cfg: DeepseekConfig, batch: int, max_len: int, device=None):
    """The Engine's prefill-layout cache pair, MQA-shaped for MLA: (L, B, S,
    1, kv_lora_rank + qk_rope_head_dim). The first plane holds the latent;
    the second only keeps the Engine's layout code (transpose, gather,
    prefix store, int8 quantization) model-agnostic: compute never reads or
    writes it. It doubles the latent cache's bytes (JAX's contract)."""
    shape = (cfg.num_hidden_layers, batch, max_len, 1, cfg.cache_width_)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def decode_step(
    params: dict,
    cfg: DeepseekConfig,
    tok: torch.Tensor,        # (B,) — the tokens to forward
    positions: torch.Tensor,  # (B,) — true sequence positions (RoPE)
    cache_k: torch.Tensor,    # (L, B, 1, S, cache_width) — decode layout
    cache_v: torch.Tensor,    # carried inert (init_kv_cache)
    slot: int,                # the cache column every row writes this step
    lens: torch.Tensor,       # (B,) prompt lengths (prefix validity)
    dstart: torch.Tensor,     # (B,) first valid decode column per row
    return_hidden: bool = False,
    ragged: bool = True,
    cache_scale: tuple[torch.Tensor, torch.Tensor] | None = None,
    win_cache: dict | None = None,
    win_pad: int = 0,
):
    """One-token MLA decode by weight absorption (qwen2.decode_step's
    contract: row b reads columns [0, lens[b]) ∪ [dstart[b], slot]). Each
    layer writes this step's latent [c_norm | k_pe] at column ``slot`` IN
    PLACE, then attends over the single latent stream (module docstring).
    ``ragged`` is accepted and ignored (this attention is torch products on
    every device); a windowed-short cache does not apply to deepseek.

    ``cache_scale=(ks, vs)`` (each (L, B, 1, S) f32): the latent plane is
    int8 with one per-vector scale shared by its c and k_pe segments; it
    folds once into the summed score and into the attention weights before
    the combine (exact given the quantized values). ``vs`` is carried inert.

    Returns (logits (B, V) f32, hidden (B, H) | None, cache_k, cache_v),
    plus the (ks, vs) tuple when ``cache_scale`` is given."""
    if win_cache is not None:
        raise ValueError("sliding-window caches do not apply to deepseek")
    B, S = tok.shape[0], cache_k.shape[3]
    nh, r = cfg.num_attention_heads, cfg.kv_lora_rank
    q8 = cache_scale is not None
    x = qwen2._embed(params, cfg, tok[:, None])  # (B, 1, H)
    dt = x.dtype
    cos, sin = rope_freqs(positions[:, None], cfg.qk_rope_head_dim, cfg.rope_theta,
                          cfg.rope_scaling)
    ar = torch.arange(S, device=x.device)[None, :]
    valid = (ar < lens[:, None]) | ((ar >= dstart[:, None]) & (ar <= slot))
    for l, p in enumerate(_layers(params)):
        a = p["attn"]
        h = rms_norm(x, p["input_layernorm"]["scale"], cfg.rms_norm_eps)
        q_nope, q_pe = _q_heads(cfg, a, h)[:, 0].split(
            [cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)          # (B, nh, .)
        q_pe = _apply_rope_ds(q_pe[:, None], cos, sin, cfg.rope_interleave)[:, 0]
        c1, kpe1 = _latent(cfg, a, h, cos, sin)
        lat = torch.cat([c1[:, 0], kpe1[:, 0, 0]], dim=-1)            # (B, W)
        if q8:
            lat_q, s_vec = qwen2._quantize_kv(lat)
            cache_k[l, :, 0, slot] = lat_q
            cache_scale[0][l, :, 0, slot] = s_vec
            ks = cache_scale[0][l, :, 0]                                # (B, S)
        else:
            cache_k[l, :, 0, slot] = lat
        cc, kp = cache_k[l, :, 0, :, :r], cache_k[l, :, 0, :, r:]       # (B, S, r), (B, S, rope)
        if q8:
            cc, kp = cc.to(dt), kp.to(dt)
        wk, wv = _split_kv_b(cfg, a, dt)
        # q_lat[b, h] = W_UK,h^T q_nope[b, h]: a product per head
        q_lat = _bmm_f32(q_nope.transpose(0, 1), wk.permute(1, 2, 0)).to(dt).transpose(0, 1)
        scores = (_bmm_f32(q_lat, cc.transpose(1, 2))
                  + _bmm_f32(q_pe, kp.transpose(1, 2)))                 # (B, nh, S) f32
        if q8:
            scores = scores * ks[:, None, :]
        scores = torch.where(valid[:, None, :], scores * cfg.attn_scale_, -1e30)
        attn = torch.softmax(scores, dim=-1)
        if q8:
            attn = attn * ks[:, None, :]
        ctx = _bmm_f32(attn.to(dt), cc).to(dt)                          # (B, nh, r)
        out = _bmm_f32(ctx.transpose(0, 1), wv.transpose(0, 1)).to(dt)  # (nh, B, dv)
        xb = x[:, 0] + _o_proj(cfg, p, out.transpose(0, 1))
        h2 = rms_norm(xb, p["post_attention_layernorm"]["scale"], cfg.rms_norm_eps)
        x = (xb + _ffn(cfg, p, h2).to(dt))[:, None, :]
    hidden = rms_norm(x[:, 0], params["norm"]["scale"], cfg.rms_norm_eps)
    logits = qwen2._lm_head(params, cfg, hidden)
    out = (logits, (hidden if return_hidden else None), cache_k, cache_v)
    return out + (cache_scale,) if q8 else out


def decode_step_multi(*args, **kwargs):
    _not_ported("decode_step_multi (the T-token speculative verify)", "A8, speculative decoding")


# ----------------------------------------------------------------------------
# Init / loading
# ----------------------------------------------------------------------------

def init_params(cfg: DeepseekConfig, generator: torch.Generator, device=None) -> dict:
    """Random-init parameter dict from ``generator`` (on its device unless
    ``device`` says otherwise), the JAX init's layout and scales (N(0, 1)
    x 0.02 for every matrix, ones for the norms, a zero f32 router bias for
    sigmoid scoring). Expert stacks are drawn one layer at a time."""
    device = generator.device if device is None else torch.device(device)
    dt, sc = cfg.dtype, 0.02
    H, nh, r = cfg.hidden_size, cfg.num_attention_heads, cfg.kv_lora_rank

    def mat(*shape):
        if len(shape) == 4:  # an expert stack: one (E, in, out) layer at a time
            out = torch.empty(shape, dtype=dt, device=device)
            for l in range(shape[0]):
                out[l] = mat(*shape[1:])
            return out
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * sc).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def attn_group(L):
        a = {
            "kv_a": {"w": mat(L, H, cfg.cache_width_)},
            "kv_a_norm": {"scale": ones(L, r)},
            "kv_b": {"w": mat(L, r, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim))},
            "o": {"w": mat(L, nh * cfg.v_head_dim, H)},
        }
        if cfg.q_lora_rank > 0:
            a["q_a"] = {"w": mat(L, H, cfg.q_lora_rank)}
            a["q_a_norm"] = {"scale": ones(L, cfg.q_lora_rank)}
            a["q_b"] = {"w": mat(L, cfg.q_lora_rank, nh * cfg.qk_head_dim_)}
        else:
            a["q"] = {"w": mat(L, H, nh * cfg.qk_head_dim_)}
        return a

    def norms(L):
        return {"input_layernorm": {"scale": ones(L, H)},
                "post_attention_layernorm": {"scale": ones(L, H)}}

    params: dict[str, Any] = {"embed": {"weight": mat(cfg.vocab_size, H)},
                              "norm": {"scale": ones(H)}}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": mat(cfg.vocab_size, H)}
    Ld, Lm = cfg.num_dense_layers_, cfg.num_moe_layers_
    I = cfg.intermediate_size
    if Ld:
        params["dense_layers"] = {
            **norms(Ld), "attn": attn_group(Ld),
            "mlp": {"gate_proj": {"w": mat(Ld, H, I)}, "up_proj": {"w": mat(Ld, H, I)},
                    "down_proj": {"w": mat(Ld, I, H)}},
        }
    if Lm:
        E, Im = cfg.n_routed_experts, cfg.moe_intermediate_size
        moe: dict[str, Any] = {
            "router": {"w": mat(Lm, H, E)},
            "experts": {"gate_proj": {"w": mat(Lm, E, H, Im)}, "up_proj": {"w": mat(Lm, E, H, Im)},
                        "down_proj": {"w": mat(Lm, E, Im, H)}},
        }
        if cfg.scoring_func == "sigmoid":
            moe["router"]["bias"] = torch.zeros((Lm, E), dtype=torch.float32, device=device)
        if cfg.n_shared_experts > 0:
            Is = Im * cfg.n_shared_experts
            moe["shared"] = {"gate_proj": {"w": mat(Lm, H, Is)}, "up_proj": {"w": mat(Lm, H, Is)},
                             "down_proj": {"w": mat(Lm, Is, H)}}
        params["moe_layers"] = {**norms(Lm), "attn": attn_group(Lm), "moe": moe}
    return params


def load_params(model_dir: str, cfg: DeepseekConfig | None = None,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                quantize: str | None = None) -> tuple[dict, DeepseekConfig]:
    """Load an HF deepseek_v2/v3 safetensors checkpoint into the two-group
    stacked dict (linear weights transposed to (in, out)), the JAX loader's
    leaves. ``quantize="int8"`` stores the big matrices (q / q_b, kv_b, o,
    the MLPs, the expert and shared-expert stacks) as per-channel int8,
    quantized on the host; kv_a, q_a, the router, the norms, the embedding
    and the LM head stay in ``dtype`` (the router bias in f32, after a
    rounding to ``dtype``, as the JAX loader has it). Expert stacks are built
    one layer at a time on ``device``; a CUDA target without a card raises."""
    from . import loader as _ld
    from .quant import quantize_weight

    device = _ld._device(device, "deepseek.load_params")
    if cfg is None:
        cfg = _ld.load_config(model_dir)
    if not isinstance(cfg, DeepseekConfig):
        raise ValueError("deepseek.load_params needs a DeepseekConfig")
    cfg = dataclasses.replace(cfg, dtype=dtype)
    if quantize not in (None, "int8"):
        raise ValueError(f"unsupported quantize={quantize!r} for deepseek (int8 only)")
    q8 = quantize == "int8"
    ts = _ld._Tensors(model_dir)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype).contiguous().to(device)

    def put_quant(leaf: dict) -> dict:
        return {k: v.contiguous().to(device) for k, v in leaf.items()}

    def get_stack(layers: list[int], fmt: str, transpose=True, quantizable=True):
        t = torch.stack([ts.get(fmt.format(i=i)) for i in layers])
        if q8 and transpose and quantizable:
            return put_quant(quantize_weight(t.float().transpose(-1, -2)))
        return put(t.transpose(-1, -2) if transpose else t)

    def get_experts(layers: list[int], fmt: str):
        out = None
        for n, i in enumerate(layers):
            host = torch.stack([ts.get(fmt.format(i=i, e=e)) for e in range(cfg.n_routed_experts)]
                               ).transpose(-1, -2)
            leaf = quantize_weight(host.float()) if q8 else {"w": host.to(dtype)}
            if out is None:
                out = {k: torch.empty((len(layers), *v.shape), dtype=v.dtype, device=device)
                       for k, v in leaf.items()}
            for k, v in leaf.items():
                out[k][n] = v
        return out if q8 else out["w"]

    sa = "layers.{i}.self_attn."

    def attn_group(layers: list[int]) -> dict:
        a = {
            "kv_a": {"w": get_stack(layers, sa + "kv_a_proj_with_mqa.weight", quantizable=False)},
            "kv_a_norm": {"scale": get_stack(layers, sa + "kv_a_layernorm.weight", False)},
            "kv_b": {"w": get_stack(layers, sa + "kv_b_proj.weight")},
            "o": {"w": get_stack(layers, sa + "o_proj.weight")},
        }
        if cfg.q_lora_rank > 0:
            a["q_a"] = {"w": get_stack(layers, sa + "q_a_proj.weight", quantizable=False)}
            a["q_a_norm"] = {"scale": get_stack(layers, sa + "q_a_layernorm.weight", False)}
            a["q_b"] = {"w": get_stack(layers, sa + "q_b_proj.weight")}
        else:
            a["q"] = {"w": get_stack(layers, sa + "q_proj.weight")}
        return a

    def norms(layers: list[int]) -> dict:
        return {"input_layernorm": {"scale": get_stack(
                    layers, "layers.{i}.input_layernorm.weight", False)},
                "post_attention_layernorm": {"scale": get_stack(
                    layers, "layers.{i}.post_attention_layernorm.weight", False)}}

    params: dict[str, Any] = {"embed": {"weight": put(ts.get("embed_tokens.weight"))},
                              "norm": {"scale": put(ts.get("norm.weight"))}}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"weight": put(ts.get("lm_head.weight"))}
    Ld = cfg.num_dense_layers_
    dense_idx, moe_idx = list(range(Ld)), list(range(Ld, cfg.num_hidden_layers))
    if dense_idx:
        mlp = "layers.{i}.mlp."
        params["dense_layers"] = {
            **norms(dense_idx), "attn": attn_group(dense_idx),
            "mlp": {k: {"w": get_stack(dense_idx, mlp + k + ".weight")}
                    for k in ("gate_proj", "up_proj", "down_proj")},
        }
    if moe_idx:
        mlp = "layers.{i}.mlp."
        moe: dict[str, Any] = {
            "router": {"w": get_stack(moe_idx, mlp + "gate.weight", quantizable=False)},
            "experts": {k: {"w": get_experts(moe_idx, mlp + "experts.{e}." + k + ".weight")}
                        for k in ("gate_proj", "up_proj", "down_proj")},
        }
        if ts.has(f"layers.{moe_idx[0]}.mlp.gate.e_score_correction_bias"):
            moe["router"]["bias"] = get_stack(
                moe_idx, mlp + "gate.e_score_correction_bias", False).float()
        if cfg.n_shared_experts > 0:
            moe["shared"] = {k: {"w": get_stack(moe_idx, mlp + "shared_experts." + k + ".weight")}
                             for k in ("gate_proj", "up_proj", "down_proj")}
        params["moe_layers"] = {**norms(moe_idx), "attn": attn_group(moe_idx), "moe": moe}
    return params, cfg


def export_hf(params: dict, cfg: DeepseekConfig, out_dir: str,
              src_config_dir: str | None = None) -> None:
    _not_ported("export_hf (the HF checkpoint export of save_model)", "A7, save_model")
