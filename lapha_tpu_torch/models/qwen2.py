"""Qwen2/Llama decoder in PyTorch, dense or with a sparse MoE FFN — the
served and trained subset of ``lapha_tpu/models/qwen2.py``.

The model is a set of functions over a parameter dict with the JAX pytree's
stacked layout and key names (``layers.attn.q_proj.w`` is (L, H, nh·dh),
weights are (in, out)), so JAX weights convert one to one
(``loader.params_from_numpy``). The layer loop is a Python loop over static
per-layer views (``_layer_stack``), the eager counterpart of ``lax.scan``.

Attention goes through the port's kernels: the no-cache forward through
``flash_attention`` (the value forward and the training forward, whose
backward is the flash backward pair), the cache-threaded forward through
``flash_attention_cached`` (every engine prefill) and ``decode_step``
through ``ragged_decode_attention``. On the CPU those are their plain
PyTorch versions.

The attention projections are ``torch.matmul``/``torch.addmm`` in the
working dtype (f32 accumulation inside, one rounding to the dtype at the
output). The MLP's products have f32 output (``_mm_f32``, a 16-bit product
with f32 output on the card), so gate/up stay f32 until the activation, as
in JAX. The LM head is computed in f32, as in JAX.

MoE layouts (``num_experts > 0``: qwen2_moe, qwen3_moe, mixtral) replace
the MLP with ``ops.moe.moe_block`` on the flattened tokens (routed experts
through the grouped GEMM, K8 on the card, plus qwen2_moe's shared expert);
``qk_norm`` (qwen3_moe) puts a per-head RMS norm on q and k before RoPE.

GPT-OSS (``from_hf`` of model_type gpt_oss): learned per-head attention
sinks (``attn_sinks``, a (L, nh) f32 leaf) in every attention path, a bias
on o_proj, YaRN rope, alternating sliding/full layers (``layer_windows``,
one static window per layer of the Python layer loop: the flash kernels
band the windowed layers, decode passes window-clipped ranges to the
ragged kernel) and ``ops.moe.moe_block_gptoss`` (``moe_style="gptoss"``).
``decode_step(win_cache=)`` keeps the windowed layers in a short cache of
the prompt tail plus the decode columns (the engine installs it).

Gemma-2 / Gemma-3 (``from_hf`` of gemma2, gemma3_text): GeGLU, the
sandwich norms (the sublayer outputs are normed too: ``post_attention`` /
``post_feedforward``, with ``pre_feedforward`` before the MLP), the sqrt(H)
embedding scale, the attention scale ``query_pre_attn_scalar ** -0.5``,
head dim 256, alternating or 5:1 sliding/full stacks, Gemma-2's logit
softcaps (``attn_softcap`` inside the flash and decode kernels, before the
mask; ``final_softcap`` on the LM head's f32 logits) and Gemma-3's q/k
norms and local rope theta on its sliding layers (one rope table per
window kind, chosen statically per layer). Decode of a softcapped model
goes through the ragged decode kernel with the softcap, where JAX decodes
it dense: the same function (ROADMAP, deliberate deviations).

Quantized weights (``models/quant.py`` leaves, the JAX tree's layout): the
forward's attention projections dequantize to the working dtype, as the JAX
layer body does; the MLP (forward and decode) and decode_step's projections
go through ``_q_matmul_f32`` — the JAX function of the same name — where a
packed-int4 leaf at <= 512 rows runs the int4 dequant-matmul kernel
(``ops.int4_matmul``) and anything else a dequantized matmul; for quantized
MLPs gate/up stay f32 before the activation, as in JAX. The int8 embedding
gathers rows, then scales; the int8 LM head folds its scale into x and
keeps the table int8. ``decode_step(cache_scale=(ks, vs))`` runs over an
int8 KV cache (``_quantize_kv``; attention through the kernel's int8 entry).

Phi-3 (``from_hf`` of phi3): head dim 96, every layer sliding (W 2047 in
Phi-3-mini-4k); the checkpoint's fused ``qkv_proj`` / ``gate_up_proj`` are
split at load (``fused_qkv`` is the loader's flag only). StarCoder2
(starcoder2): the biased LayerNorm on the residual stream (``_norm``,
``norm_style="layernorm"``), the plain biased ``c_fc -> gelu_tanh ->
c_proj`` FFN (``mlp_style="plain"``), biases on every projection, a GQA
group of 12 in the 3B model, every layer sliding. Windows of every family
parse by the JAX rules (``_parse_sliding_window``), qwen3 and mistral
included.

Training: ``forward(..., remat=True | "full")`` recomputes each layer in
the backward (``torch.utils.checkpoint``, saving nothing inside the layer),
the JAX model's ``remat_policy``; gradients reach the stacked parameters
through one ``unbind`` per leaf (``_layer_stack``).

Not ported yet: OLMo-2 (post-norms only, full-width q/k norms) and SmolLM3
(NoPE layers), which ``from_hf`` refuses (ROADMAP A9), ``decode_step_multi``
and the named remat policies (``save_qkv``, ``save_attn``,
``save_qkv_attn``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention, flash_attention_cached
from ..ops.int4_matmul import int4_matmul
from ..ops.ragged_decode_attention import ragged_decode_attention, ragged_decode_plain
from .quant import dequant, is_quantized

# int4 projections with at most this many rows run the int4 kernel; larger
# ones (prefill, the value forward) are compute-bound and take the
# dequantized matmul (the JAX model's switch)
INT4_KERNEL_MAX_ROWS = 512
# vocab rows per slice of an int8 LM head (module docstring, _lm_head)
_HEAD_ROWS = 8192


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
    # () = none, ("linear", factor), ("llama3", factor, low_freq_factor,
    # high_freq_factor, original_max_position_embeddings) or ("yarn",
    # factor, attention_factor, beta_fast, beta_slow, orig_max, truncate)
    rope_scaling: tuple = ()
    # sliding-window width of every layer (0 = full attention), or, for a
    # mixed stack, a length-L tuple of per-layer widths (0 = full); the two
    # are mutually exclusive (_parse_sliding_window emits one)
    sliding_window: int = 0
    layer_windows: tuple = ()
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    attention_bias: bool = True
    # phi3: the checkpoint stores fused qkv_proj / gate_up_proj mats, split
    # at load (the loader only); the parameter dict is the per-tensor one
    fused_qkv: bool = False
    qk_norm: bool = False  # qwen3: per-head RMS norm on q/k before RoPE
    # Mixture-of-experts: num_experts == 0 means dense. Every layer is
    # sparse (mixed dense/sparse stacks are refused by from_hf).
    num_experts: int = 0
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 0
    shared_expert_intermediate_size: int = 0
    norm_topk_prob: bool = False
    # HF tensor layout of the MoE subtree (loader only): "qwen" (mlp.gate /
    # mlp.experts.{e}.{gate,up,down}_proj) or "mixtral" (block_sparse_moe.gate
    # / block_sparse_moe.experts.{e}.{w1,w3,w2})
    moe_layout: str = "qwen"
    moe_impl: str = "auto"  # auto | gather | dense | dispatch (ops/moe.py)
    moe_capacity_factor: float = 2.0  # the dispatch impl's bucket width
    # GPT-OSS: per-head attention sinks, a bias on o_proj, and the
    # topk-then-softmax router with fused clamped-GLU experts ("gptoss")
    attn_sinks: bool = False
    o_proj_bias: bool = False
    moe_style: str = "qwen"
    dtype: torch.dtype = torch.bfloat16
    # Gemma-2 / Gemma-3 (inert at their defaults): GeGLU ("gelu_pytorch_tanh"),
    # the sandwich norms (post-attention / pre- and post-feedforward), the
    # sqrt(H) embedding scale (cast to the dtype first), the attention scale
    # query_pre_attn_scalar ** -0.5 (0 = head_dim), the logit softcaps
    # cap·tanh(s/cap) on the attention logits (before the mask) and on the
    # LM head's, and Gemma-3's rope theta of the sliding layers (0 = one rope)
    hidden_act: str = "silu"
    sandwich_norms: bool = False
    embed_normalizer: bool = False
    query_pre_attn_scalar: float = 0.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_local_theta: float = 0.0
    # StarCoder2 (inert at their defaults): the residual-stream norms
    # ("rms", or "layernorm": mean-centred with a bias, the norm leaves
    # {"scale", "bias"}) and the FFN ("swiglu" gate/up/down, or "plain":
    # c_fc -> activation -> c_proj with biases)
    norm_style: str = "rms"
    mlp_style: str = "swiglu"

    def __post_init__(self):
        if self.rope_scaling and self.rope_scaling[0] not in ("linear", "llama3", "yarn"):
            raise ValueError(f"rope_scaling {self.rope_scaling[0]!r}: not yet ported")
        if self.moe_layout not in ("qwen", "mixtral"):
            raise ValueError(f"moe_layout {self.moe_layout!r} (qwen|mixtral)")
        if self.moe_style not in ("qwen", "gptoss"):
            raise ValueError(f"moe_style {self.moe_style!r} (qwen|gptoss)")
        if self.norm_style not in ("rms", "layernorm"):
            raise ValueError(f"norm_style {self.norm_style!r} (rms|layernorm)")
        if self.mlp_style not in ("swiglu", "plain"):
            raise ValueError(f"mlp_style {self.mlp_style!r} (swiglu|plain)")
        if self.sliding_window and self.layer_windows:
            raise ValueError(
                "sliding_window and layer_windows are mutually exclusive: uniform stacks "
                "use sliding_window, heterogeneous stacks a length-L layer_windows (got "
                f"sliding_window={self.sliding_window}, layer_windows={self.layer_windows})")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def attn_scale_(self) -> float:
        return 1.0 / math.sqrt(self.query_pre_attn_scalar or self.head_dim_)

    @property
    def max_window_(self) -> int:
        """The largest attention window anywhere in the stack (0 = none)."""
        if self.layer_windows:
            return max(self.layer_windows)
        return int(self.sliding_window or 0)

    def window_for_layer(self, l: int) -> int:
        if self.layer_windows:
            return int(self.layer_windows[l])
        return int(self.sliding_window or 0)

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
        if kind == "yarn":
            # transformers' _compute_yarn_parameters: the attention factor
            # resolves here from factor / mscale / mscale_all_dim
            factor = float(rs["factor"])
            att = rs.get("attention_factor")
            mscale, mscale_all = rs.get("mscale"), rs.get("mscale_all_dim")

            def get_mscale(scale: float, m: float = 1.0) -> float:
                return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0

            if att is None:
                att = (get_mscale(factor, mscale) / get_mscale(factor, mscale_all)
                       if mscale and mscale_all else get_mscale(factor))
            orig = int(rs.get("original_max_position_embeddings")
                       or cfg.get("max_position_embeddings", 4096))
            return ("yarn", factor, float(att), float(rs.get("beta_fast") or 32),
                    float(rs.get("beta_slow") or 1), orig, bool(rs.get("truncate", True)))
        raise ValueError(f"rope_scaling type {kind!r}: not yet ported")

    @staticmethod
    def _parse_sliding_window(cfg: dict) -> dict:
        """HF config.json -> {"sliding_window": W, "layer_windows": (...)}, by
        the JAX parser's rules (transformers' per-layer resolution): qwen2 /
        qwen3 / smollm3 take the window only with ``use_sliding_window``;
        the per-layer ``layer_types`` when given, else mistral, mixtral,
        phi3 and starcoder2 slide every layer, gemma2's even-index layers
        slide, gemma3's slide but every ``sliding_window_pattern``-th
        (default 6), and otherwise (qwen2 / qwen3 / llama / gpt_oss) layers
        >= ``max_window_layers`` (default 28, the HF class default) slide.
        Uniform stacks parse into ``sliding_window``, mixed ones into the
        per-layer ``layer_windows``."""
        mt = cfg.get("model_type", "qwen2")
        sw = cfg.get("sliding_window")
        if (mt.startswith("qwen2") or mt.startswith("qwen3")
                or mt == "smollm3") and not cfg.get("use_sliding_window", False):
            sw = None
        if not sw:
            return {"sliding_window": 0, "layer_windows": ()}
        L = cfg["num_hidden_layers"]
        lt = cfg.get("layer_types")
        if lt is None:
            if mt in ("mistral", "mixtral", "phi3", "starcoder2"):
                lt = ["sliding_attention"] * L
            elif mt == "gemma2":
                lt = ["sliding_attention" if (i + 1) % 2 else "full_attention" for i in range(L)]
            elif mt.startswith("gemma3"):
                pat = int(cfg.get("sliding_window_pattern", 6))
                lt = ["full_attention" if (i + 1) % pat == 0 else "sliding_attention"
                      for i in range(L)]
            else:
                mwl = int(cfg.get("max_window_layers", 28))
                lt = ["sliding_attention" if i >= mwl else "full_attention" for i in range(L)]
        if all(t == "full_attention" for t in lt):
            return {"sliding_window": 0, "layer_windows": ()}
        if all(t == "sliding_attention" for t in lt):
            return {"sliding_window": int(sw), "layer_windows": ()}
        return {"sliding_window": 0,
                "layer_windows": tuple(int(sw) if t == "sliding_attention" else 0 for t in lt)}

    @classmethod
    def from_hf(cls, cfg: dict, dtype: torch.dtype = torch.bfloat16) -> "Qwen2Config":
        """From an HF config.json dict: dense qwen2 / qwen3 / llama /
        mistral, phi3, starcoder2, the MoE families qwen2_moe, qwen3_moe and
        mixtral, gpt_oss, and the text models of gemma2 and gemma3 (the JAX
        package's rules, windows by ``_parse_sliding_window``)."""
        mt = cfg.get("model_type", "qwen2")
        if mt not in ("qwen2", "qwen2_5", "qwen3", "llama", "mistral", "phi3", "starcoder2",
                      "qwen2_moe", "qwen3_moe", "mixtral", "gpt_oss", "gemma2", "gemma3_text",
                      "gemma3"):
            raise ValueError(f"model_type {mt!r}: not yet ported")
        if mt in ("gemma2", "gemma3_text", "gemma3"):
            if "text_config" in cfg:
                raise ValueError("multimodal gemma3 checkpoints are not supported; use the "
                                 "text-only model (model_type gemma3_text)")
            # GeGLU, sandwich norms, sqrt(H) embeddings, query_pre_attn_scalar;
            # gemma2: attention and final softcaps; gemma3: per-head q/k norms
            # and the local rope theta of the sliding layers
            g3 = mt.startswith("gemma3")
            return cls(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"],
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
                head_dim=cfg.get("head_dim", 256),
                max_position_embeddings=cfg.get("max_position_embeddings",
                                                131072 if g3 else 8192),
                rope_theta=cfg.get("rope_theta", 1e6 if g3 else 10000.0),
                rope_scaling=cls._parse_rope_scaling(cfg),
                **cls._parse_sliding_window(cfg),
                rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
                tie_word_embeddings=cfg.get("tie_word_embeddings", True),
                attention_bias=cfg.get("attention_bias", False),
                qk_norm=g3,
                hidden_act=cfg.get("hidden_activation", cfg.get("hidden_act", "gelu_pytorch_tanh")),
                sandwich_norms=True,
                embed_normalizer=True,
                query_pre_attn_scalar=float(cfg.get("query_pre_attn_scalar", 256)),
                attn_softcap=0.0 if g3 else float(cfg.get("attn_logit_softcapping") or 0.0),
                final_softcap=0.0 if g3 else float(cfg.get("final_logit_softcapping") or 0.0),
                rope_local_theta=(float(cfg.get("rope_local_base_freq", 10000.0)) if g3
                                  else 0.0),
                dtype=dtype,
            )
        if mt == "gpt_oss":
            # GQA with biases on every projection, learned per-head sinks,
            # alternating sliding/full layers, YaRN rope and a top-k MoE with
            # router bias and clamped-GLU experts; the bf16 export only
            return cls(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"],
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
                head_dim=cfg.get("head_dim", 64),
                max_position_embeddings=cfg.get("max_position_embeddings", 131072),
                rope_theta=cfg.get("rope_theta", 150000.0),
                rope_scaling=cls._parse_rope_scaling(cfg),
                **cls._parse_sliding_window(cfg),
                rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
                attention_bias=cfg.get("attention_bias", True),
                o_proj_bias=cfg.get("attention_bias", True),
                attn_sinks=True,
                num_experts=cfg["num_local_experts"],
                num_experts_per_tok=cfg.get("num_experts_per_tok", 4),
                moe_intermediate_size=cfg["intermediate_size"],
                moe_style="gptoss",
                dtype=dtype,
            )
        if mt == "mixtral":
            # llama-style attention + top-k experts of the full
            # intermediate_size, renormalised (norm_topk_prob), no shared expert
            return cls(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"],
                num_hidden_layers=cfg["num_hidden_layers"],
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
                head_dim=cfg.get("head_dim"),
                max_position_embeddings=cfg.get("max_position_embeddings", 32768),
                rope_theta=cfg.get("rope_theta", 1e6),
                rope_scaling=cls._parse_rope_scaling(cfg),
                **cls._parse_sliding_window(cfg),
                rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
                attention_bias=False,
                num_experts=cfg["num_local_experts"],
                num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
                moe_intermediate_size=cfg["intermediate_size"],
                norm_topk_prob=True,
                moe_layout="mixtral",
                dtype=dtype,
            )
        if mt in ("qwen2_moe", "qwen3_moe"):
            # qwen2_moe: qkv bias + sigmoid-gated shared expert; qwen3_moe:
            # per-head q/k RMS norm, no bias, no shared expert
            L = cfg["num_hidden_layers"]
            step = max(cfg.get("decoder_sparse_step", 1), 1)
            mlp_only = cfg.get("mlp_only_layers", []) or []
            if not all(i not in mlp_only and cfg.get("num_experts", 0) > 0 and (i + 1) % step == 0
                       for i in range(L)):
                raise ValueError(
                    f"{mt} checkpoints with dense layers mixed into the stack are not "
                    f"supported (decoder_sparse_step={step}, mlp_only_layers={mlp_only})")
            q3 = mt == "qwen3_moe"
            return cls(
                vocab_size=cfg["vocab_size"],
                hidden_size=cfg["hidden_size"],
                intermediate_size=cfg["intermediate_size"],
                num_hidden_layers=L,
                num_attention_heads=cfg["num_attention_heads"],
                num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
                head_dim=cfg.get("head_dim"),
                max_position_embeddings=cfg.get("max_position_embeddings", 32768),
                rope_theta=cfg.get("rope_theta", 1e6 if q3 else 10000.0),
                rope_scaling=cls._parse_rope_scaling(cfg),
                **cls._parse_sliding_window(cfg),
                rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
                attention_bias=(cfg.get("attention_bias", False) if q3
                                else cfg.get("qkv_bias", True)),
                qk_norm=q3,
                num_experts=cfg["num_experts"],
                num_experts_per_tok=cfg.get("num_experts_per_tok", 4),
                moe_intermediate_size=cfg.get("moe_intermediate_size", 0),
                shared_expert_intermediate_size=(
                    0 if q3 else cfg.get("shared_expert_intermediate_size", 0)),
                norm_topk_prob=cfg.get("norm_topk_prob", False),
                dtype=dtype,
            )
        common = dict(
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_hidden_layers=cfg["num_hidden_layers"],
            num_attention_heads=cfg["num_attention_heads"],
            num_key_value_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            rope_scaling=cls._parse_rope_scaling(cfg),
            **cls._parse_sliding_window(cfg),
            dtype=dtype,
        )
        if mt == "starcoder2":
            # LayerNorm with bias on the residual stream, the plain biased
            # c_fc -> gelu -> c_proj FFN, biases on every projection, tied
            return cls(
                **common,
                max_position_embeddings=cfg.get("max_position_embeddings", 16384),
                rope_theta=cfg.get("rope_theta", 10000.0),
                rms_norm_eps=cfg.get("norm_epsilon", 1e-5),
                tie_word_embeddings=cfg.get("tie_word_embeddings", True),
                attention_bias=cfg.get("use_bias", True),
                o_proj_bias=cfg.get("use_bias", True),
                norm_style="layernorm",
                mlp_style="plain",
                hidden_act=cfg.get("hidden_act", "gelu_pytorch_tanh"),
            )
        if mt == "phi3":
            # llama-style with fused qkv_proj / gate_up_proj mats (split at
            # load), no biases; the 128k longrope variants are refused by
            # the rope parser, partial rotary (phi-4-mini) here
            prf = float(cfg.get("partial_rotary_factor") or 1.0)
            if prf != 1.0:
                raise ValueError(f"phi3 partial_rotary_factor={prf} is not supported "
                                 "(RoPE is applied to the full head_dim)")
            return cls(
                **common,
                max_position_embeddings=cfg.get("max_position_embeddings", 4096),
                rope_theta=cfg.get("rope_theta", 10000.0),
                rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
                tie_word_embeddings=cfg.get("tie_word_embeddings", False),
                attention_bias=False,
                fused_qkv=True,
            )
        if mt == "qwen3":
            # no q/k/v bias, a per-head q/k RMS norm
            return cls(
                **common,
                max_position_embeddings=cfg.get("max_position_embeddings", 32768),
                rope_theta=cfg.get("rope_theta", 1e6),
                rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
                tie_word_embeddings=cfg.get("tie_word_embeddings", True),
                attention_bias=cfg.get("attention_bias", False),
                qk_norm=True,
            )
        # qwen2 / llama / mistral
        return cls(
            **common,
            max_position_embeddings=cfg.get("max_position_embeddings", 32768),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=cfg.get("tie_word_embeddings", True),
            attention_bias=cfg.get("attention_bias", mt.startswith("qwen2")),
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
    generator's device unless ``device`` says otherwise). The JAX tree's
    layout: a MoE config has ``layers.moe`` (router, expert stacks (L, E,
    in, out), qwen2_moe's shared expert) in place of ``layers.mlp``; GPT-OSS
    adds the o_proj bias, f32 sinks (L, nh), the router bias and the fused
    ``gate_up`` (L, E, H, 2I) / ``down`` stacks with their biases;
    StarCoder2 the LayerNorm biases, o_proj's bias and the ``c_fc`` /
    ``c_proj`` FFN with its biases (biases and sinks zero, as the JAX
    init)."""
    device = generator.device if device is None else torch.device(device)
    L, H, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_

    def init(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2] if len(shape) > 1 else shape[-1])
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(cfg.dtype)

    def init_by_layer(shape):
        # the expert stacks, drawn one layer at a time: the f32 draw of a
        # whole (L, E, in, out) stack would double the weights' peak memory
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        for l in range(shape[0]):
            out[l] = init(shape[1:], 1.0 / math.sqrt(shape[-2]))
        return out

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
        },
        "norm": {"scale": ones(H)},
    }
    if cfg.norm_style == "layernorm":  # StarCoder2: biased LayerNorm
        for key in ("input_layernorm", "post_attention_layernorm"):
            params["layers"][key]["bias"] = zeros(L, H)
        params["norm"]["bias"] = zeros(H)
    if cfg.o_proj_bias:
        params["layers"]["attn"]["o_proj"]["b"] = zeros(L, H)
    if cfg.attn_sinks:
        params["layers"]["attn"]["sinks"] = torch.zeros((L, nh), dtype=torch.float32,
                                                         device=device)
    if cfg.num_experts > 0 and cfg.moe_style == "gptoss":
        E, Im = cfg.num_experts, cfg.moe_intermediate_size
        params["layers"]["moe"] = {
            "router": {"w": init((L, H, E), 0.02), "b": zeros(L, E)},
            "experts": {
                "gate_up": {"w": init_by_layer((L, E, H, 2 * Im)), "b": zeros(L, E, 2 * Im)},
                "down": {"w": init_by_layer((L, E, Im, H)), "b": zeros(L, E, H)},
            },
        }
    elif cfg.num_experts > 0:
        E, Im, Is = cfg.num_experts, cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size
        params["layers"]["moe"] = {
            "router": {"w": init((L, H, E), 0.02)},
            "experts": {
                "gate_proj": {"w": init_by_layer((L, E, H, Im))},
                "up_proj": {"w": init_by_layer((L, E, H, Im))},
                "down_proj": {"w": init_by_layer((L, E, Im, H))},
            },
        }
        if Is > 0:  # qwen2_moe's always-on shared expert
            params["layers"]["moe"]["shared"] = {
                "gate_proj": {"w": init((L, H, Is))},
                "up_proj": {"w": init((L, H, Is))},
                "down_proj": {"w": init((L, Is, H))},
                "gate": {"w": init((L, H, 1), 0.02)},
            }
    elif cfg.mlp_style == "plain":  # StarCoder2
        params["layers"]["mlp"] = {
            "c_fc": {"w": init((L, H, I)), "b": zeros(L, I)},
            "c_proj": {"w": init((L, I, H)), "b": zeros(L, H)},
        }
    else:
        params["layers"]["mlp"] = {
            "gate_proj": {"w": init((L, H, I))},
            "up_proj": {"w": init((L, H, I))},
            "down_proj": {"w": init((L, I, H))},
        }
    if cfg.sandwich_norms:  # gemma: two extra output norms per layer
        params["layers"]["pre_feedforward_layernorm"] = {"scale": ones(L, H)}
        params["layers"]["post_feedforward_layernorm"] = {"scale": ones(L, H)}
    if cfg.qk_norm:
        params["layers"]["attn"]["q_norm"] = {"scale": ones(L, dh)}
        params["layers"]["attn"]["k_norm"] = {"scale": ones(L, dh)}
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


def _norm(x: torch.Tensor, p: dict, cfg: Qwen2Config) -> torch.Tensor:
    """The residual-stream norms (input, post-attention, final): RMS, or
    StarCoder2's mean-centred LayerNorm with bias (``norm_style="layernorm"``,
    ``p`` = {"scale", "bias"}), in f32 with one rounding to x's dtype as JAX's
    ``_norm``. q/k norms and the sandwich norms are always RMS."""
    if cfg.norm_style == "layernorm":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) * (xf - mu)).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.rms_norm_eps)
        return (out * p["scale"].float() + p["bias"].float()).to(x.dtype)
    return rms_norm(x, p["scale"], cfg.rms_norm_eps)


def rope_freqs(positions: torch.Tensor, dh: int, theta: float,
               scaling: tuple = ()) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (…, dh/2) for integer positions (…,). ``scaling``:
    () none, ("linear", factor), ("llama3", factor, low, high, orig_max) —
    HF's llama-3.1 wavelength-dependent interpolation — or ("yarn", factor,
    attention_factor, beta_fast, beta_slow, orig_max, truncate): a
    per-dimension blend of interpolated and extrapolated frequencies along a
    ramp between the correction dims, cos/sin scaled by attention_factor."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=positions.device) / dh))
    att_factor = 1.0
    if scaling and scaling[0] == "yarn":
        _, factor, att_factor, beta_fast, beta_slow, orig, truncate = scaling

        def corr_dim(num_rot: float) -> float:
            return (dh * math.log(orig / (num_rot * 2 * math.pi))) / (2 * math.log(theta))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if truncate:
            low, high = math.floor(low), math.ceil(high)
        low, high = max(low, 0), min(high, dh - 1)
        if low == high:
            high += 0.001  # transformers' singularity guard
        ramp = ((torch.arange(dh // 2, dtype=torch.float32, device=positions.device) - low)
                / (high - low)).clamp(0.0, 1.0)
        extrap = 1.0 - ramp
        inv = (inv / factor) * (1.0 - extrap) + inv * extrap
    elif scaling and scaling[0] == "linear":
        inv = inv / scaling[1]
    elif scaling and scaling[0] == "llama3":
        _, factor, low, high, orig = scaling
        wavelen = 2.0 * math.pi / inv
        smooth = ((orig / wavelen - low) / (high - low)).clamp(0.0, 1.0)
        inv = (1.0 - smooth) * (inv / factor) + smooth * inv
    elif scaling:
        raise ValueError(f"unknown rope scaling {scaling!r}")
    ang = positions.float()[..., None] * inv
    return torch.cos(ang) * att_factor, torch.sin(ang) * att_factor


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE; x is (B, T, n, dh), cos/sin are (B, T, dh/2)."""
    dh = x.shape[-1]
    x1, x2 = x[..., : dh // 2].float(), x[..., dh // 2:].float()
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _proj(h: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """h (..., IN) @ w (IN, OUT) [+ b] in h's dtype; a quantized leaf is
    dequantized to h's dtype first (the JAX forward's attention projections)."""
    w = dequant(w, h.dtype)
    h2 = h.reshape(-1, h.shape[-1])
    y = torch.addmm(b, h2, w) if b is not None else h2 @ w
    return y.reshape(*h.shape[:-1], w.shape[-1])


class _MmF32(torch.autograd.Function):
    """a (N, K) @ b (K, M) of one 16-bit dtype on the card, accumulated and
    returned in f32 without a rounding to the inputs' dtype (JAX's
    ``preferred_element_type=float32``). ``torch.mm(out_dtype=)`` has no
    derivative, so the backward is written out: the f32 gradient is rounded
    to the inputs' dtype and multiplied in it, as a 16-bit product's
    backward would be."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ b.T if ctx.needs_input_grad[0] else None
        gb = a.T @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, K) @ b (K, M) -> f32, accumulated in f32: 16-bit operands on
    the card stay 16-bit (tensor cores, f32 output); otherwise an f32
    product."""
    if a.is_cuda and a.dtype != torch.float32:
        return _MmF32.apply(a, b)
    return a.float() @ b.float()


def _q_matmul_f32(h: torch.Tensor, w) -> torch.Tensor:
    """h (..., IN) @ weight leaf -> (..., OUT) f32. A packed-int4 leaf at <=
    INT4_KERNEL_MAX_ROWS rows runs the int4 kernel (which rounds h to bf16,
    as the JAX kernel does); anything else, a plain leaf too, is a product
    with the leaf dequantized to h's dtype and f32 output."""
    *lead, IN = h.shape
    h2 = h.reshape(-1, IN)
    if is_quantized(w) and "s4" in w and h2.shape[0] <= INT4_KERNEL_MAX_ROWS:
        y = int4_matmul(h2, w["q"], w["s4"])
    else:
        y = _mm_f32(h2, dequant(w, h.dtype))
    return y.reshape(*lead, y.shape[-1])


def _proj_decode(h: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """decode_step's projections: a quantized leaf goes through
    _q_matmul_f32 with the bias added in f32 and one rounding to h's dtype
    (the JAX decode_step's ``proj``); a plain leaf as in _proj."""
    if not is_quantized(w):
        return _proj(h, w, b)
    y = _q_matmul_f32(h, w)
    if b is not None:
        y = y + b.float()
    return y.to(h.dtype)


def _mlp(cfg: Qwen2Config, p: dict, h: torch.Tensor) -> torch.Tensor:
    """Post-attention FFN on normed hidden h (..., H): the MoE block on the
    flattened tokens when the config has experts, StarCoder2's plain biased
    FFN (``mlp_style="plain"``), else SwiGLU (GeGLU for gemma's
    "gelu_pytorch_tanh") with plain or quantized leaves and f32 gate/up
    products before the activation, as the JAX model. One definition for
    the forward and decode_step."""
    if cfg.num_experts > 0 and cfg.moe_style == "gptoss":
        from ..ops.moe import moe_block_gptoss  # lazy: ops.moe imports this module

        out = moe_block_gptoss(h.reshape(-1, h.shape[-1]), p["moe"], top_k=cfg.num_experts_per_tok,
                               impl=cfg.moe_impl, capacity_factor=cfg.moe_capacity_factor)
        return out.reshape(h.shape)
    if cfg.num_experts > 0:
        from ..ops.moe import moe_block  # lazy: ops.moe imports this module

        out = moe_block(h.reshape(-1, h.shape[-1]), p["moe"], top_k=cfg.num_experts_per_tok,
                        norm_topk=cfg.norm_topk_prob, impl=cfg.moe_impl,
                        capacity_factor=cfg.moe_capacity_factor)
        return out.reshape(h.shape)
    m = p["mlp"]
    if cfg.mlp_style == "plain":  # StarCoder2: c_fc -> act -> c_proj, biases added in f32
        y = _q_matmul_f32(h, m["c_fc"]["w"]) + m["c_fc"]["b"].float()
        act = (F.gelu(y, approximate="tanh") if cfg.hidden_act == "gelu_pytorch_tanh"
               else F.silu(y)).to(h.dtype)
        return (_q_matmul_f32(act, m["c_proj"]["w"]) + m["c_proj"]["b"].float()).to(h.dtype)
    gate = _q_matmul_f32(h, m["gate_proj"]["w"])
    up = _q_matmul_f32(h, m["up_proj"]["w"])
    if cfg.hidden_act == "gelu_pytorch_tanh":  # gemma's GeGLU
        act = (F.gelu(gate, approximate="tanh") * up).to(h.dtype)
    else:
        act = (F.silu(gate) * up).to(h.dtype)
    return _q_matmul_f32(act, m["down_proj"]["w"]).to(h.dtype)


def _embed(params: dict, cfg: Qwen2Config, toks: torch.Tensor) -> torch.Tensor:
    """Token ids -> (..., H) in cfg.dtype. An int8 table gathers the rows,
    then scales them; the table is never dequantized. Gemma scales by
    sqrt(H), the constant rounded to the dtype first (as HF and JAX)."""
    emb = params["embed"]["weight"]
    if is_quantized(emb):
        x = emb["q"][toks].to(cfg.dtype) * emb["s"][0].to(cfg.dtype)
    else:
        x = emb[toks].to(cfg.dtype)
    if cfg.embed_normalizer:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=cfg.dtype, device=x.device)
    return x


def _lm_head(params: dict, cfg: Qwen2Config, x: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden (..., H) -> logits (..., V) in f32, Gemma-2's
    final softcap applied to them."""
    head_w = (params["embed"]["weight"] if cfg.tie_word_embeddings
              else params["lm_head"]["weight"])
    logits = _int8_head(x, head_w) if is_quantized(head_w) else x.float() @ head_w.float().T
    if cfg.final_softcap:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _int8_head(x: torch.Tensor, head_w: dict) -> torch.Tensor:
    """Logits through an int8 (V, H) table with one scale per H channel: the
    scale folds into x in x's dtype (as JAX does) and the table stays int8.
    It is multiplied in _HEAD_ROWS-row slices, each cast to x's dtype (an
    L2-sized buffer on the card) with f32 output, so no float copy of the
    whole table is ever made."""
    *lead, H = x.shape
    xs = (x * head_w["s"][0].to(x.dtype)).reshape(-1, H)
    q = head_w["q"]
    out = torch.empty((xs.shape[0], q.shape[0]), dtype=torch.float32, device=x.device)
    for r0 in range(0, q.shape[0], _HEAD_ROWS):
        w = q[r0:r0 + _HEAD_ROWS].to(xs.dtype)
        out[:, r0:r0 + w.shape[0]] = _mm_f32(xs, w.T)
    return out.reshape(*lead, q.shape[0])


def _quantize_kv(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., dh) -> (int8 values, (...,) f32 per-vector scale): symmetric
    amax/127 quantization for the int8 KV cache, bit-equal to the JAX
    model's ``_quantize_kv``."""
    tf = t.float()
    s = torch.clamp(tf.abs().amax(dim=-1) / 127.0, min=1e-12)
    return torch.clamp(torch.round(tf / s[..., None]), -127, 127).to(torch.int8), s


def _dispatch_attend(cfg: Qwen2Config, q, k, v, key_mask, win=0, sinks=None):
    """No-cache path: causal flash attention with key-padding mask, banded
    to the layer's window ``win`` (static: the layer loop is Python), the
    softcap applied, the sinks folded in."""
    return flash_attention(q, k, v, key_mask, causal=True, scale=cfg.attn_scale_, window=win,
                           softcap=cfg.attn_softcap, sinks=sinks)


def _dispatch_attend_cached(cfg: Qwen2Config, q, k, v, key_mask, qstart, win=0, sinks=None):
    """Cache-threaded path: T new queries at qstart[b] + t over the whole
    (B, S) cache, ``key_mask`` being the cache-column validity; window and
    softcap and sinks as in :func:`_dispatch_attend`."""
    return flash_attention_cached(q, k, v, key_mask, qstart, scale=cfg.attn_scale_, window=win,
                                  softcap=cfg.attn_softcap, sinks=sinks)


def _layer_stack(params: dict) -> list[dict]:
    """Per-layer views of the stacked layer dict, one ``unbind`` per leaf:
    the backward then stacks each leaf's L per-layer gradients once, where
    L indexing views would each add a full-size (L, ...) buffer. A quantized
    leaf ({"q", "s"} or {"q", "s4"}) becomes the same dict of per-layer
    views, contiguous and zero-copy, which the int4 kernel takes as it is."""

    def unbind(node):
        if isinstance(node, dict):
            return {k: unbind(v) for k, v in node.items()}
        return node.unbind(0)

    def pick(node, l):
        return {k: pick(v, l) for k, v in node.items()} if isinstance(node, dict) else node[l]

    views = unbind(params["layers"])
    return [pick(views, l) for l in range(len(views["input_layernorm"]["scale"]))]


def remat_policy(remat) -> bool:
    """The JAX model's remat knob: False/None = no recompute; True/"full" =
    recompute the whole layer in the backward. The named policies keep
    chosen intermediates, which the port has not ported."""
    if remat is True or remat == "full":
        return True
    if not remat:
        return False
    if remat in ("save_qkv", "save_attn", "save_qkv_attn"):
        raise NotImplementedError(
            f"remat={remat!r}: the named remat policies are not ported yet "
            "(ROADMAP A7); use 'full'")
    raise ValueError(f"unknown remat policy {remat!r} (expected True, 'full', "
                     "'save_qkv', 'save_attn', 'save_qkv_attn')")


def _o_bias(cfg: Qwen2Config, a: dict):
    """GPT-OSS's o_proj bias, added before the one rounding to the dtype."""
    return a["o_proj"]["b"] if cfg.o_proj_bias else None


def _qk_norm(cfg: Qwen2Config, a: dict, key: str, t: torch.Tensor) -> torch.Tensor:
    """qwen3's per-head RMS norm over dh (q or k, (..., n, dh)), before RoPE."""
    return rms_norm(t, a[key]["scale"], cfg.rms_norm_eps) if cfg.qk_norm else t


def _layer_body(cfg: Qwen2Config, p: dict, x, cos, sin, key_mask,
                cache_k=None, cache_v=None, cache_pos=None, win=0):
    """One decoder layer. With ``cache_k``/``cache_v`` ((B, S, nkv, dh)
    views of one layer) the new K/V are written at ``cache_pos`` (int or
    (B,) per-row offsets) IN PLACE — the JAX model's dynamic_update_slice /
    scatter — and attention runs over the whole cache. ``win`` is the
    layer's attention window (0 = full)."""
    B, T, _ = x.shape
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    a = p["attn"]
    h = _norm(x, p["input_layernorm"], cfg)
    q = _qk_norm(cfg, a, "q_norm", _proj(h, a["q_proj"]["w"], a["q_proj"]["b"]).reshape(B, T, nh, dh))
    k = _qk_norm(cfg, a, "k_norm", _proj(h, a["k_proj"]["w"], a["k_proj"]["b"]).reshape(B, T, nkv, dh))
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    v = _proj(h, a["v_proj"]["w"], a["v_proj"]["b"]).reshape(B, T, nkv, dh)
    sinks = a["sinks"] if cfg.attn_sinks else None
    if cache_k is not None:
        if isinstance(cache_pos, int):
            cache_k[:, cache_pos:cache_pos + T] = k
            cache_v[:, cache_pos:cache_pos + T] = v
        else:
            b_idx = torch.arange(B, device=x.device)[:, None]
            t_idx = cache_pos.long()[:, None] + torch.arange(T, device=x.device)[None, :]
            cache_k[b_idx, t_idx] = k
            cache_v[b_idx, t_idx] = v
        att = _dispatch_attend_cached(cfg, q, cache_k, cache_v, key_mask, cache_pos, win, sinks)
    else:
        att = _dispatch_attend(cfg, q, k, v, key_mask, win, sinks)
    return _residual(cfg, p, x, _proj(att.reshape(B, T, nh * dh), a["o_proj"]["w"],
                                      _o_bias(cfg, a)))


def _residual(cfg: Qwen2Config, p: dict, x, att_out):
    """The layer's two residual adds after attention: x + att_out, then the
    MLP on the post-attention norm; gemma's sandwich norms the attention
    output (post_attention), the MLP input (pre_feedforward) and output
    (post_feedforward). One definition for the forward and decode_step."""
    eps = cfg.rms_norm_eps
    if cfg.sandwich_norms:
        x = x + rms_norm(att_out, p["post_attention_layernorm"]["scale"], eps)
        h = rms_norm(x, p["pre_feedforward_layernorm"]["scale"], eps)
        return x + rms_norm(_mlp(cfg, p, h), p["post_feedforward_layernorm"]["scale"], eps)
    x = x + att_out
    return x + _mlp(cfg, p, _norm(x, p["post_attention_layernorm"], cfg))


def _rope_tables(cfg: Qwen2Config, positions: torch.Tensor):
    """A layer's window -> its (cos, sin) tables for ``positions``: the
    model's rope, or on Gemma-3's sliding layers the local theta without
    scaling (JAX's dual rope). Each table is computed once."""
    glob = rope_freqs(positions, cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling)
    if not (cfg.rope_local_theta and cfg.layer_windows):
        return lambda win: glob
    loc = rope_freqs(positions, cfg.head_dim_, cfg.rope_local_theta, ())
    return lambda win: loc if win else glob


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
    remat=False,
):
    """Full forward pass.

    * ``kv_cache=None``: causal attention over input_ids (B,T) with optional
      padding ``attention_mask`` (B,T). ``remat`` (True/"full") recomputes
      each layer in the backward when gradients are being recorded; under
      it the forward kernel runs twice per layer.
    * ``kv_cache=(k, v)`` of shape (L,B,S,nkv,dh): the T new tokens are
      written at ``cache_pos`` (in place) and attend over cache columns
      where ``kv_valid`` (B,S) holds, causally by slot.

    A windowed layer bands by index without a cache and by slot with one,
    as the JAX forward does.

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
    rope_of = _rope_tables(cfg, positions)

    if kv_cache is None:
        key_mask = (attention_mask if attention_mask is not None
                    else torch.ones((B, T), dtype=torch.int32, device=dev))
        recompute = remat_policy(remat) and torch.is_grad_enabled()
        for l, p in enumerate(_layer_stack(params)):
            win = cfg.window_for_layer(l)
            cos, sin = rope_of(win)
            if recompute:
                x = checkpoint(_layer_body, cfg, p, x, cos, sin, key_mask, None, None, None, win,
                               use_reentrant=False)
            else:
                x = _layer_body(cfg, p, x, cos, sin, key_mask, win=win)
    else:
        ck, cv = kv_cache
        key_mask = cached_key_mask(kv_valid, cache_pos, T, B, ck.shape[2], dev)
        for l, p in enumerate(_layer_stack(params)):
            win = cfg.window_for_layer(l)
            x = _layer_body(cfg, p, x, *rope_of(win), key_mask, ck[l], cv[l], cache_pos, win)

    x = _norm(x, params["norm"], cfg)
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
    cache_scale: tuple[torch.Tensor, torch.Tensor] | None = None,
    win_cache: dict | None = None,
    win_pad: int = 0,
):
    """One-token decode for all rows over the slot-uniform cache: row b's
    valid columns are [0, lens[b]) ∪ [dstart[b], slot]. Every row writes
    this step's K/V at column ``slot`` IN PLACE (the JAX model's
    dynamic_update_slice). ``ragged=True`` sends attention through the ragged
    decode kernel; ``ragged=False`` is the dense attention of the JAX sync
    engine, kept as the CPU reference only (on the card decode attention is
    the kernel's).

    ``cache_scale=(ks, vs)`` (each (L, B, nkv, S) f32) makes the caches int8
    with per-vector scales: this step's K/V are quantized (``_quantize_kv``)
    and written at ``slot`` with their scales, in place, and attention
    reads the int8 cache (the kernel's int8 entry).

    Sliding-window layers (``cfg.window_for_layer``, static per layer) read
    the window as clipped ranges: prompt slots [clip(positions - W + 1, 0,
    lens), lens) and decode slots [max(dstart, slot - W + 1), slot] (JAX
    ``win_ranges``). Sinks go to the kernel's sink entries.

    ``win_cache`` (the engine's windowed-short install, JAX's dict): the
    windowed layers live in a short (Lw, B, nkv, Sw, dh) stack whose columns
    [0, win_pad) hold each row's prompt tail (full slots [woff, woff +
    win_pad), woff = lens - win_pad) and [win_pad, Sw) the decode columns;
    this step writes short column wslot = win_pad + slot - slab. Keys "k",
    "v" (+ "ks", "vs" when int8), "woff" (B,), "slab" (int). ``cache_k``/
    ``cache_v`` (and ``cache_scale``) then hold only the full-attention
    layers, in layer order. The short panels go through the same kernel
    with lens_s = win_pad, pstart_s = clip(positions - W + 1 - woff,
    max(0, -woff), win_pad), dstart_s = max(win_pad, wslot - W + 1). Assumes
    dstart == slab for every row (the engine's geometry).

    Gemma-2's attention softcap goes into the decode kernel, applied to the
    true logit (after an int8 cache's K-scale fold), as JAX's dense decode
    applies it; Gemma-3's sliding layers rope at the local theta.

    Returns (logits (B,V) f32, hidden (B,H) | None, cache_k, cache_v), plus
    the (ks, vs) tuple when ``cache_scale`` is given, plus ``win_cache``
    when it is given."""
    if not ragged and cache_k.is_cuda:
        raise ValueError("decode_step(ragged=False) is the CPU reference; CUDA "
                         "decode attention runs the ragged kernel")
    attend = ragged_decode_attention if ragged else ragged_decode_plain
    L = cfg.num_hidden_layers
    nh, nkv, dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    B = tok.shape[0]
    x = _embed(params, cfg, tok)  # (B, H)
    rope_of = _rope_tables(cfg, positions[:, None])  # (B, 1, dh/2): one "time" step
    W_layers = [cfg.window_for_layer(l) for l in range(L)]
    # static layer -> index of its stack (full-S cache, or the short cache)
    full_map, win_map = {l: l for l in range(L)}, {}
    if win_cache is not None:
        full_map = {}
        for l, w in enumerate(W_layers):
            (win_map if w else full_map)[l] = len(win_map if w else full_map)
    # each window's (lens, pstart, dstart, slot) ranges, per row
    ranges = {}
    for w in sorted(set(W_layers) - {0}):
        if win_cache is None:
            ranges[w] = (lens, torch.minimum(torch.clamp(positions - (w - 1), min=0), lens),
                         torch.clamp(dstart, min=slot - (w - 1)), slot)
        else:
            woff = win_cache["woff"]
            wslot = win_pad + slot - int(win_cache["slab"])
            lo = torch.clamp(-woff, min=0)
            ranges[w] = (torch.full_like(lens, win_pad),
                         torch.maximum(positions - (w - 1) - woff, lo).clamp(max=win_pad),
                         torch.full_like(dstart, max(win_pad, wslot - (w - 1))), wslot)
    for l, p in enumerate(_layer_stack(params)):
        a = p["attn"]
        h = _norm(x, p["input_layernorm"], cfg)
        q = _qk_norm(cfg, a, "q_norm",
                     _proj_decode(h, a["q_proj"]["w"], a["q_proj"]["b"]).reshape(B, 1, nh, dh))
        k = _qk_norm(cfg, a, "k_norm",
                     _proj_decode(h, a["k_proj"]["w"], a["k_proj"]["b"]).reshape(B, 1, nkv, dh))
        W = W_layers[l]
        cos, sin = rope_of(W)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        v = _proj_decode(h, a["v_proj"]["w"], a["v_proj"]["b"]).reshape(B, nkv, dh)
        if l in win_map:
            i, ck, cv = win_map[l], win_cache["k"], win_cache["v"]
            scl = (win_cache["ks"], win_cache["vs"]) if "ks" in win_cache else None
        else:
            i, ck, cv, scl = full_map[l], cache_k, cache_v, cache_scale
        lens_l, pstart_l, dstart_l, slot_l = ranges[W] if W else (lens, None, dstart, slot)
        if scl is not None:
            (kq, sk), (vq, sv) = _quantize_kv(k[:, 0]), _quantize_kv(v)
            ck[i, :, :, slot_l] = kq
            cv[i, :, :, slot_l] = vq
            scl[0][i, :, :, slot_l] = sk
            scl[1][i, :, :, slot_l] = sv
        else:
            ck[i, :, :, slot_l] = k[:, 0]
            cv[i, :, :, slot_l] = v
        o = attend(q[:, 0], ck, cv, i, lens_l, dstart_l, slot_l, pstart_l, scale=cfg.attn_scale_,
                   cache_scale=scl, sinks=a["sinks"] if cfg.attn_sinks else None,
                   softcap=cfg.attn_softcap)
        x = _residual(cfg, p, x, _proj_decode(o.reshape(B, nh * dh), a["o_proj"]["w"],
                                              _o_bias(cfg, a)))
    x = _norm(x, params["norm"], cfg)
    logits = _lm_head(params, cfg, x)
    out = (logits, (x if return_hidden else None), cache_k, cache_v)
    if cache_scale is not None:
        out = out + (cache_scale,)
    return out if win_cache is None else out + (win_cache,)
