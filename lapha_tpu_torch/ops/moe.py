"""Sparse Mixture-of-Experts FFN (the Qwen2-MoE block) — port of
``lapha_tpu/ops/moe.py``.

HF Qwen2MoeSparseMoeBlock semantics: softmax over ALL expert logits in f32,
top-k, optional re-normalisation, plus an always-on sigmoid-gated shared
expert where the layout has one (qwen2_moe; not qwen3_moe or mixtral). The
names, arguments and order of operations are JAX's:

- ``"gather"`` (what ``"auto"`` resolves to off the TPU, as in JAX, so on
  the card too): a stable sort of the token->expert pairs by expert, a
  gather, three grouped GEMMs (``ops.grouped_gemm``, the Hopper kernel K8
  on CUDA tensors), ``silu(g) * u`` in f32 rounded to the dtype, and an f32
  combine. Exact. Nothing in it reads back to the host: the group sizes
  are counted with ``scatter_add_`` (``torch.bincount`` on CUDA reads the
  input's maximum back) and stay on the device, and the combine un-permutes
  with the inverse permutation and sums each token's k pairs in f32 — JAX's
  ``.at[tok].add`` without the nondeterministic order of atomic adds.
- ``"dense"``: every expert computes every token; a (N, E) combine weight
  matrix zeroes the unselected ones. Exact, E/k times the work; a reference.

Expert and shared-expert leaves may be quantized (``models/quant.py``):
they are dequantized to the working dtype at the use site, as JAX does.
The router and the shared-expert gate are never quantized by the loaders.

GPT-OSS (``moe_block_gptoss``, HF GptOssExperts math): top-k over the raw
router logits (with bias), softmax over the k chosen; fused [gate | up]
experts with per-expert biases and the clamped GLU
(up + 1) · gate·sigmoid(1.702·gate). "gather" runs the two products on the
grouped GEMM (K8 on the card) and adds each pair's biases outside it, as
JAX adds them outside ``_grouped_gemm``; "dense" is the reference.

DeepSeek-V2/V3 (``route_deepseek``, HF DeepseekV2MoEGate /
DeepseekV3TopkRouter math): f32 logits, softmax or sigmoid scores, top-k
greedy or within the best groups (group-limited), the V3 correction bias
used for the choice only. The routed experts then run through
``moe_ffn_gather(routing=)`` and the shared experts through
``shared_expert`` without a gate. Its top-k keeps JAX's order among equal
values (the lower expert index first, as ``lax.top_k``): group-limited
routing masks the unchosen groups to 0.0, and a biased sigmoid score can sit
at or below it.

Not ported yet: the capacity-bucketed ``"dispatch"`` impl and its
``dispatch_drop_fraction`` diagnostic (expert-parallel, ROADMAP A11). They
raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.quant import dequant, is_quantized
from ..models.qwen2 import _mm_f32  # qwen2 imports this module inside _mlp only
from .grouped_gemm import grouped_gemm

__all__ = ["route", "moe_ffn_gather", "moe_ffn_dense", "shared_expert", "moe_block",
           "route_topk_softmax", "moe_block_gptoss", "route_deepseek"]


def _n_experts(experts: dict) -> int:
    w = experts["gate_proj"]["w"]
    return (w["q"] if is_quantized(w) else w).shape[0]


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what}: not yet ported (ROADMAP {item})")


def route(x: torch.Tensor, router_w, top_k: int, norm_topk: bool):
    """Token routing, HF Qwen2MoeSparseMoeBlock parity. x (N, H) ->
    (topw (N, k) in x.dtype, topi (N, k) int32): f32 logits, softmax over
    all E first, then top-k of the probabilities (renormalised to sum 1
    only with ``norm_topk``)."""
    logits = _mm_f32(x, dequant(router_w, x.dtype))
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)
    if norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    return topw.to(x.dtype), topi.to(torch.int32)


def moe_ffn_gather(x: torch.Tensor, p: dict, *, top_k: int, norm_topk: bool,
                   routing=None) -> torch.Tensor:
    """Sort + grouped-GEMM execution. x (N, H) -> (N, H), exact.
    ``routing=(topw, topi)`` bypasses the router."""
    N = x.shape[0]
    dtype = x.dtype
    experts = p["experts"]
    E = _n_experts(experts)
    topw, topi = routing if routing is not None else route(
        x, p["router"]["w"], top_k, norm_topk)

    order, tok, _, group_sizes = _sorted_pairs(topi, top_k, E)
    xs = x.index_select(0, tok)                      # (N*k, H)

    g = grouped_gemm(xs, dequant(experts["gate_proj"]["w"], dtype), group_sizes)
    u = grouped_gemm(xs, dequant(experts["up_proj"]["w"], dtype), group_sizes)
    a = (F.silu(g) * u).to(dtype)
    y = grouped_gemm(a, dequant(experts["down_proj"]["w"], dtype), group_sizes)
    # back to (token, choice) order, then each token's k pairs summed in f32
    return _combine(y, topw, order, N, top_k, dtype)


def moe_ffn_dense(x: torch.Tensor, p: dict, *, top_k: int, norm_topk: bool,
                  routing=None) -> torch.Tensor:
    """All-experts execution with sparse combine weights. Exact. The
    products take f32 copies of the dtype's values: exact products summed
    in f32, JAX's ``preferred_element_type=float32``."""
    N, H = x.shape
    dtype = x.dtype
    experts = p["experts"]
    wg = dequant(experts["gate_proj"]["w"], dtype)
    E = wg.shape[0]
    topw, topi = routing if routing is not None else route(
        x, p["router"]["w"], top_k, norm_topk)
    cw = torch.zeros((N, E), dtype=torch.float32, device=x.device).scatter_add_(
        1, topi.long(), topw.float())

    xf = x.float()
    g = torch.einsum("nh,ehi->nei", xf, wg.float())
    u = torch.einsum("nh,ehi->nei", xf, dequant(experts["up_proj"]["w"], dtype).float())
    a = (F.silu(g) * u).to(dtype)
    y = torch.einsum("nei,eio->neo", a.float(),
                     dequant(experts["down_proj"]["w"], dtype).float())
    return torch.einsum("neo,ne->no", y, cw).to(dtype)


def shared_expert(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Always-on shared expert with a sigmoid gate (HF shared_expert +
    shared_expert_gate). x (N, H) -> (N, H)."""
    dtype = x.dtype
    g = _mm_f32(x, dequant(p["gate_proj"]["w"], dtype))
    u = _mm_f32(x, dequant(p["up_proj"]["w"], dtype))
    a = (F.silu(g) * u).to(dtype)
    y = _mm_f32(a, dequant(p["down_proj"]["w"], dtype))
    if "gate" not in p:  # deepseek shared experts: a plain MLP, no gate
        return y.to(dtype)
    gate = torch.sigmoid(_mm_f32(x, dequant(p["gate"]["w"], dtype)))
    return (y * gate).to(dtype)


def moe_block(x: torch.Tensor, p: dict, *, top_k: int, norm_topk: bool,
              impl: str = "auto", capacity_factor: float = 2.0) -> torch.Tensor:
    """The whole MoE FFN block on flat tokens x (N, H): routed experts plus
    the sigmoid-gated shared expert where ``p`` has one. ``impl``: auto |
    gather | dense | dispatch; ``auto`` is ``gather`` (JAX's choice on every
    backend but the TPU). ``capacity_factor`` belongs to dispatch."""
    if impl == "auto":
        impl = "gather"
    if impl == "gather":
        routed = moe_ffn_gather(x, p, top_k=top_k, norm_topk=norm_topk)
    elif impl == "dense":
        routed = moe_ffn_dense(x, p, top_k=top_k, norm_topk=norm_topk)
    elif impl == "dispatch":
        routed = moe_ffn_dispatch(x, p, top_k=top_k, norm_topk=norm_topk,
                                  capacity_factor=capacity_factor)
    else:
        raise ValueError(f"unknown moe impl {impl!r} (gather|dense|dispatch)")
    if "shared" in p:  # qwen2_moe; qwen3_moe and mixtral have none
        routed = routed + shared_expert(x, p["shared"])
    return routed


def moe_ffn_dispatch(x, p, *, top_k, norm_topk, capacity_factor=2.0, group_size=512,
                     routing=None):
    _not_ported("moe_ffn_dispatch (the capacity-bucketed expert-parallel impl)", "A11")


def dispatch_drop_fraction(x, p, *, top_k, norm_topk, capacity_factor=2.0, group_size=512):
    _not_ported("dispatch_drop_fraction (the dispatch impl's diagnostic)", "A11")


def _top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, equal values
    in index order (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_deepseek(x: torch.Tensor, router_w, bias, *, top_k: int, scoring: str,
                   topk_method: str, n_group: int, topk_group: int, norm_topk: bool,
                   routed_scaling_factor: float):
    """DeepSeek-V2/V3 token routing. x (N, H) -> (topw (N, k) in x.dtype,
    topi (N, k) int32).

    - scoring "softmax" (V2): scores = softmax(logits) in f32; top-k of the
      scores ("greedy") or within the best ``topk_group`` of ``n_group``
      expert groups ranked by their max score ("group_limited_greedy").
    - scoring "sigmoid" (V3, "noaux_tc"): the choice is made on scores +
      ``bias`` (e_score_correction_bias), groups ranked by the sum of their
      top-2; the weights are the unbiased scores at the chosen experts.
    ``norm_topk`` renormalises the weights (denominator + 1e-20); all are
    scaled by ``routed_scaling_factor``. The logits are f32 products of
    f32 copies of x and the router."""
    logits = x.float() @ dequant(router_w, torch.float32).float()
    E = logits.shape[-1]
    if scoring == "softmax":
        scores = torch.softmax(logits, dim=-1)
    elif scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        raise ValueError(f"unknown scoring {scoring!r} (softmax|sigmoid)")
    choice = scores if bias is None else scores + bias.float()
    if topk_method == "greedy":
        topw, topi = _top_k(choice, top_k)
    elif topk_method in ("group_limited_greedy", "noaux_tc"):
        g = choice.reshape(-1, n_group, E // n_group)
        if topk_method == "noaux_tc":  # V3: groups ranked by their top-2 sum
            gs = _top_k(g, 2)[0].sum(dim=-1)
        else:                          # V2: groups ranked by their max
            gs = g.amax(dim=-1)
        gidx = _top_k(gs, topk_group)[1]
        gmask = torch.zeros_like(gs).scatter_(1, gidx, 1.0)
        masked = torch.where(gmask.repeat_interleave(E // n_group, dim=-1) > 0, choice, 0.0)
        topw, topi = _top_k(masked, top_k)
    else:
        raise ValueError(f"unknown topk_method {topk_method!r}")
    if bias is not None:  # noaux_tc: the combine weights are the unbiased scores
        topw = torch.gather(scores, -1, topi)
    if norm_topk:
        topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-20)
    topw = topw * routed_scaling_factor
    return topw.to(x.dtype), topi.to(torch.int32)


def _sorted_pairs(topi: torch.Tensor, top_k: int, E: int):
    """The token->expert pairs sorted stably by expert: (order, source
    token, expert of each sorted pair, group sizes (E,) int32 on the device)."""
    flat_e = topi.reshape(-1).long()
    order = torch.argsort(flat_e, stable=True)       # ties keep token order
    group_sizes = torch.zeros(E, dtype=torch.int32, device=topi.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    return order, order // top_k, flat_e.index_select(0, order), group_sizes


def _combine(y: torch.Tensor, topw: torch.Tensor, order: torch.Tensor, N: int, top_k: int,
             dtype) -> torch.Tensor:
    """Weighted pair outputs (sorted order, f32) summed per token in f32."""
    y = y * topw.reshape(N * top_k).index_select(0, order)[:, None].float()
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(N * top_k, device=y.device))
    return y.index_select(0, inv).reshape(N, top_k, -1).sum(dim=1).to(dtype)


def route_topk_softmax(x: torch.Tensor, router_w, router_b: torch.Tensor, top_k: int):
    """GPT-OSS routing (HF GptOssTopKRouter): top-k over the raw router
    logits (f32, with bias), then a softmax over the k chosen values.
    Returns (topw (N, k) in x.dtype, topi (N, k) int32)."""
    logits = _mm_f32(x, dequant(router_w, x.dtype)) + router_b.float()
    topv, topi = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(topv, dim=-1).to(x.dtype), topi.to(torch.int32)


def _gptoss_glu(gu: torch.Tensor, limit: float, alpha: float) -> torch.Tensor:
    """HF GptOssExperts activation on [gate | up] halves (f32): gate clamped
    above, up clamped both ways, (up + 1) · gate·sigmoid(alpha·gate)."""
    I = gu.shape[-1] // 2
    gate, up = gu[..., :I].clamp(max=limit), gu[..., I:].clamp(-limit, limit)
    return (up + 1.0) * (gate * torch.sigmoid(gate * alpha))


def moe_block_gptoss(x: torch.Tensor, p: dict, *, top_k: int, impl: str = "auto",
                     capacity_factor: float = 2.0, group_size: int = 512,
                     limit: float = 7.0, alpha: float = 1.702) -> torch.Tensor:
    """The GPT-OSS MoE block on flat tokens x (N, H) -> (N, H): gate_up (E,
    H, 2I) with [gate | up] columns (de-interleaved at load), down (E, I,
    H), biases (E, 2I) and (E, H) added per (token, expert) pair before the
    GLU and after down. ``impl``: auto (= gather) | gather | dense;
    dispatch raises like the other families'."""
    N = x.shape[0]
    dtype = x.dtype
    e = p["experts"]
    wgu, wd = dequant(e["gate_up"]["w"], dtype), dequant(e["down"]["w"], dtype)
    bgu, bd = e["gate_up"]["b"].float(), e["down"]["b"].float()
    E = wgu.shape[0]
    topw, topi = route_topk_softmax(x, p["router"]["w"], p["router"]["b"], top_k)
    if impl == "auto":
        impl = "gather"
    if impl == "dense":
        cw = torch.zeros((N, E), dtype=torch.float32, device=x.device).scatter_add_(
            1, topi.long(), topw.float())
        gu = torch.einsum("nh,ehi->nei", x.float(), wgu.float()) + bgu[None]
        act = _gptoss_glu(gu, limit, alpha).to(dtype)
        y = torch.einsum("nei,eio->neo", act.float(), wd.float()) + bd[None]
        return torch.einsum("neo,ne->no", y, cw).to(dtype)
    if impl == "dispatch":
        _not_ported("moe_block_gptoss(impl='dispatch') (the capacity-bucketed impl)", "A11")
    if impl != "gather":
        raise ValueError(f"unknown moe impl {impl!r} (gather|dense|dispatch)")
    order, tok, e_sorted, group_sizes = _sorted_pairs(topi, top_k, E)
    gu = grouped_gemm(x.index_select(0, tok), wgu, group_sizes) + bgu.index_select(0, e_sorted)
    act = _gptoss_glu(gu, limit, alpha).to(dtype)
    y = grouped_gemm(act, wd, group_sizes) + bd.index_select(0, e_sorted)
    return _combine(y, topw, order, N, top_k, dtype)
