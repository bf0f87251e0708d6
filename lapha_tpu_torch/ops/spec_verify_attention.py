"""The T-token verify attention of speculative decoding — Hopper kernel +
plain version.

Added by the port; it replaces no Pallas kernel. The JAX package computes
this attention dense, with XLA einsums inside ``qwen2.decode_step_multi``
(``lapha_tpu/models/qwen2.py:1878-1912``). The port runs decode attention
on the card through a kernel, and neither of its others takes this validity:
rejected drafts leave permanent holes in a row's decode columns, so the
columns a row may read are a per-row bitmap ``valid_map`` (B, S), not the
ragged decode kernel's two ranges, and the cached flash kernel reads the
prefill layout and no int8 cache.

Query t of row b (T queries a row, at ``positions[b, t]``) sees
column j of one layer of the (L, B, nkv, S, dh) decode cache iff

    valid_map[b, j]  or  slot <= j <= slot + t

and, for a windowed layer (``window`` W > 0), also pos_col[b, j] >
positions[b, t] - W, where pos_col is ``pos_map`` except that the new
columns [slot, slot + T) take positions[b, j - slot]. ``cache[layer]`` is
read in place (a zero-copy view), bf16, or int8 with ``cache_scale=(ks,
vs)`` (each (L, B, nkv, S) f32): the K scale multiplies the true logits
after the attention scale, the V scale the probabilities after the softmax.
``softcap`` > 0 (Gemma-2) caps the true logit before the mask; ``sinks``
(nh,) f32 (GPT-OSS) fold in as a softmax column of zero value (JAX
``_sink_softmax``). A query that sees nothing gives 0. Head dims 64, 96, 128
and 256 and any GQA group.

A CPU tensor takes the plain version below (dense masked attention in f32); a
CUDA tensor launches the kernel of ``csrc/spec_verify_attention.cuh`` (one C
entry a source, ``csrc/spec_verify_attention{,_q8,_sink,_q8_sink}.cu``) or
raises. The kernel lists each row's live columns on the card and splits them over a
thread-block cluster of ``verify_plan(...).splits`` CTAs, which merge their
partial softmax states in rank order; ``verify_plan`` works from shapes
alone (``slot`` and the maps stay out of it), so a captured launch keeps its
plan. Launches are counted per entry: ``spec_verify_attention``, ``_q8``,
``_sink``, ``_q8_sink``, + ``_softcap`` when capped.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _cuda

NEG_INF = -1e30
VERIFY_HEAD_DIMS = (64, 96, 128, 256)
# query rows a CTA holds: 8 x its n8 tiles (1-4), 4 at most (2 at dh 256),
# where the accumulators fill a lane's registers
MAX_ROWS = {64: 32, 96: 32, 128: 32, 256: 16}
PIECE = 16       # columns a warp takes at a time
CHUNK = 64       # columns a CTA takes at a time: 4 warps x 16
MAX_SPLITS = 8   # a row's splits are one thread-block cluster: at most 8 CTAs (portable)
MAX_STAGES = 4   # ring stages a warp the kernel takes
SMEM_LIMIT = 227 * 1024   # dynamic shared memory a CTA may have
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory; 1 KB of it is reserved a CTA

__all__ = ["VerifyPlan", "spec_verify_attention", "spec_verify_plain", "verify_plan",
           "verify_visible", "launch_name"]

# launch-count name (without "_softcap") -> C entry (csrc/spec_verify_attention*.cu)
_ENTRIES = {"spec_verify_attention": "lapha_spec_verify",
            "spec_verify_attention_q8": "lapha_spec_verify_q8",
            "spec_verify_attention_sink": "lapha_spec_verify_sink",
            "spec_verify_attention_q8_sink": "lapha_spec_verify_q8_sink"}


class VerifyPlan(NamedTuple):
    qtiles: int  # CTAs a KV head's group·T query rows are split over (grid.y)
    splits: int  # CTAs a (row, KV head, qtile): one cluster, each a share of the live columns
    stages: int  # 16-column pieces a warp has in flight


def cta_rows(group: int, T: int, qtiles: int) -> int:
    """Query rows a CTA holds, rounded up to its instance's n8 tiles."""
    return 8 * math.ceil(group * T / qtiles / 8)


def verify_plan(B: int, nkv: int, group: int, T: int, S: int, sms: int, *, dh: int,
                int8: bool, smem, window: int = 0) -> VerifyPlan:
    """The kernel's grid (B, nkv x qtiles, splits) and ring depth for B rows
    of nkv KV heads with ``group`` query heads each, T queries a row, an
    S-column cache, head dim ``dh``, a bf16 or int8 cache and the layer's
    ``window`` (0: none), on a card of ``sms`` SMs. Shapes only: the live
    columns are counted on the card, so the plan of a captured launch holds
    whatever the slot and the maps. ``smem(dh, int8, rows, S, stages,
    splits)`` is a CTA's dynamic shared memory in bytes, the kernel's own
    count (its C entry ``lapha_spec_verify_smem``).

    ``qtiles``: the fewest CTAs a KV head whose query rows (group·T) fit
    ``MAX_ROWS[dh]`` each. ``splits``: one where the B·nkv·qtiles CTAs
    already give every SM one; else about two CTAs an SM, ceil(2·sms /
    CTAs), but no more than 7/8 of a wave of resident CTAs (a cluster's CTAs
    share a GPC, and GPCs fill unevenly), no more than the live columns (at
    most S, or W + T with a window) have 64-column chunks, and a power of
    two up to 8 (clusters of 3, 5 or 6 CTAs fill the GPCs badly); then
    doubled while the share's list does not fit a CTA's shared memory. Two
    ring stages (deeper rings gained nothing in ``bench_verify --sweep``,
    PERF.md §6), one where a warp gets a single piece, or where the CTAs
    fill at most half the card and one stage lets two CTAs share an SM
    that two stages would give to one (dh 256: Gemma-2 at B=8, 4 x 1 0.0184
    ms against 2 x 2 0.0219; at B=24, 96 CTAs, 1 x 2 0.0429 against 2 x 1
    0.0427 at T=4 but 0.0438 against 0.0471 at T=8; NVIDIA H100 80GB HBM3,
    700.00 W)."""
    if min(B, nkv, group, T, S, sms) < 1 or dh not in MAX_ROWS or window < 0:
        raise ValueError(f"verify_plan: B {B}, nkv {nkv}, group {group}, T {T}, S {S}, "
                         f"sms {sms}, dh {dh}, window {window}")
    qtiles = math.ceil(group * T / MAX_ROWS[dh])
    rows = cta_rows(group, T, qtiles)
    tiles = B * nkv * qtiles
    live = S if window <= 0 else min(S, window + T)
    splits, stages = 1, 2
    if tiles < sms:
        def per_sm(st):  # CTAs an SM holds with st ring stages
            return max(1, SMEM_PER_SM // (smem(dh, int8, rows, S, st, 2) + 1024))

        if 2 * tiles <= sms and per_sm(2) == 1 and per_sm(1) > 1:
            stages = 1  # dh 256 at few rows: one stage lets two CTAs share an SM
        want = min(MAX_SPLITS, math.ceil(live / CHUNK), math.ceil(2 * sms / tiles),
                   sms * per_sm(stages) * 7 // 8 // tiles)
        splits = 1 << (max(1, want).bit_length() - 1)  # the power of two at or below
    stages = min(stages, math.ceil(math.ceil(live / splits) / CHUNK))
    while smem(dh, int8, rows, S, stages, splits) > SMEM_LIMIT and splits < MAX_SPLITS:
        splits *= 2
    if not 0 < smem(dh, int8, rows, S, stages, splits) <= SMEM_LIMIT:
        raise ValueError(f"verify_plan: an S of {S} columns does not fit {MAX_SPLITS} CTAs' "
                         f"shared memory at dh {dh} and {rows} query rows a CTA")
    return VerifyPlan(qtiles, splits, stages)


def launch_name(int8: bool, sinks: bool, softcap: float) -> str:
    return ("spec_verify_attention" + ("_q8" if int8 else "") + ("_sink" if sinks else "")
            + ("_softcap" if softcap else ""))


def verify_visible(valid_map, positions, slot: int, pos_map=None, window: int = 0):
    """(B, T, S) bool: the columns each query of the block sees."""
    B, S = valid_map.shape
    T = positions.shape[1]
    dev = valid_map.device
    ar = torch.arange(S, device=dev)
    rel = ar[None, None, :] - slot                                   # new columns: 0..T-1
    causal_new = (rel >= 0) & (rel <= torch.arange(T, device=dev)[None, :, None])
    vis = (valid_map[:, None, :] != 0) | causal_new
    if window > 0:
        in_new = (ar >= slot) & (ar < slot + T)
        new_pos = positions.gather(1, (ar - slot).clamp(0, T - 1)[None, :].expand(B, S).long())
        pos_col = torch.where(in_new[None, :], new_pos, pos_map)
        vis = vis & (pos_col[:, None, :] > positions[:, :, None] - window)
    return vis


def spec_verify_plain(q, k_cache, v_cache, layer, slot, valid_map, positions, pos_map=None,
                      window: int = 0, scale=None, *, cache_scale=None, sinks=None,
                      softcap: float = 0.0):
    """Dense masked verify attention, float32 inside; same arguments and
    result as :func:`spec_verify_attention`."""
    B, T, nh, dh = q.shape
    k, v = k_cache[layer], v_cache[layer]  # (B, nkv, S, dh)
    nkv = k.shape[1]
    G = nh // nkv
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    vis = verify_visible(valid_map, positions, int(slot), pos_map, int(window))
    vis = vis[:, None, :, None, :]                                  # (B, 1, T, 1, S)
    s = torch.einsum("btkgd,bksd->bktgs", q.float().reshape(B, T, nkv, G, dh), k.float()) * scale
    if cache_scale is not None:
        s = s * cache_scale[0][layer].float()[:, :, None, None, :]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(1, nkv, 1, G, 1)
        m = torch.maximum(m, sk)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        den = den + torch.exp(sk - m)
    p = p / den.clamp(min=1e-30)
    if cache_scale is not None:
        p = p * cache_scale[1][layer].float()[:, :, None, None, :]
    o = torch.einsum("bktgs,bksd->btkgd", p, v.float())
    return o.reshape(B, T, nh, dh).to(q.dtype)


def _verify_cuda(q, k_cache, v_cache, layer, slot, valid_map, positions, pos_map, window, scale,
                 cache_scale, sinks, softcap):
    entry = launch_name(cache_scale is not None, sinks is not None, 0.0)
    name = launch_name(cache_scale is not None, sinks is not None, softcap)
    B, T, nh, dh = q.shape
    dev = q.device
    if cache_scale is None:
        _cuda.require_cuda_bf16(name, dev, q=q, k_cache=k_cache, v_cache=v_cache)
    else:
        _cuda.require_cuda_bf16(name, dev, q=q)
        _cuda.require_cuda(name, dev, torch.int8, aligned=True, k_cache=k_cache, v_cache=v_cache)
        _cuda.require_cuda(name, dev, torch.float32, aligned=False, k_scale=cache_scale[0],
                           v_scale=cache_scale[1])
        _cuda.require(tuple(cache_scale[0].shape) == tuple(k_cache.shape[:4])
                      and tuple(cache_scale[1].shape) == tuple(k_cache.shape[:4]), name,
                      f"scales {tuple(cache_scale[0].shape)}, {tuple(cache_scale[1].shape)} "
                      f"for cache {tuple(k_cache.shape)}")
    L, Bc, nkv, S, dhc = k_cache.shape
    _cuda.require(tuple(v_cache.shape) == tuple(k_cache.shape) and Bc == B and dhc == dh, name,
                  f"shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    _cuda.require(dh in VERIFY_HEAD_DIMS, name,
                  f"head dim {dh} (the kernel takes {VERIFY_HEAD_DIMS})")
    _cuda.require(nh % nkv == 0, name, f"{nh} query heads over {nkv} KV heads")
    _cuda.require(softcap >= 0.0 and window >= 0, name, f"softcap {softcap}, window {window}")
    layer, slot = int(layer), int(slot)
    _cuda.require(0 <= layer < L and 0 <= slot and slot + T <= S, name,
                  f"layer {layer} / new columns [{slot}, {slot + T}) outside the cache")
    if sinks is not None:
        _cuda.require_cuda(name, dev, torch.float32, aligned=False, sinks=sinks)
    _cuda.require(valid_map.device == dev and tuple(valid_map.shape) == (B, S)
                  and valid_map.dtype == torch.bool, name,
                  f"valid_map {tuple(valid_map.shape)} {valid_map.dtype} on {valid_map.device}")
    valid_map = valid_map.contiguous()
    positions = _cuda.int32_on(positions, dev, (B, T))
    pos = None
    if window > 0:
        _cuda.require(pos_map is not None, name, "a windowed layer needs pos_map")
        pos = _cuda.int32_on(pos_map, dev, (B, S))
    out = torch.empty((B, T, nh, dh), dtype=q.dtype, device=dev)
    scales = [] if cache_scale is None else [cache_scale[0].data_ptr(), cache_scale[1].data_ptr()]
    sink = [] if sinks is None else [sinks.data_ptr()]
    dll = _cuda.lib()
    plan = verify_plan(B, nkv, nh // nkv, T, S, _cuda.sm_count(dev), dh=dh,
                       int8=cache_scale is not None, smem=dll.lapha_spec_verify_smem,
                       window=int(window))
    err = getattr(dll, _ENTRIES[entry])(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales, valid_map.data_ptr(),
        positions.data_ptr(), None if pos is None else pos.data_ptr(), *sink, layer, slot, T,
        int(window), out.data_ptr(), B, nh, nkv, S, dh, float(scale), float(softcap), *plan,
        _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


def spec_verify_attention(q, k_cache, v_cache, layer, slot, valid_map, positions, pos_map=None,
                          window: int = 0, scale=None, *, cache_scale=None, sinks=None,
                          softcap: float = 0.0):
    """q (B, T, nh, dh); k_cache, v_cache (L, B, nkv, S, dh), bf16 or (with
    ``cache_scale``) int8; layer and slot ints; valid_map (B, S) bool;
    positions (B, T); pos_map (B, S) for a windowed layer (``window`` > 0);
    ``sinks`` (nh,) f32 or None; ``softcap`` > 0 caps the logits. Returns
    (B, T, nh, dh) in q.dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if sinks is not None and tuple(sinks.shape) != (q.shape[2],):
        raise ValueError(f"spec_verify_attention: sinks {tuple(sinks.shape)} for "
                         f"{q.shape[2]} query heads")
    if q.device.type == "cpu":
        return spec_verify_plain(q, k_cache, v_cache, layer, slot, valid_map, positions, pos_map,
                                 window, scale, cache_scale=cache_scale, sinks=sinks,
                                 softcap=softcap)
    if q.device.type == "cuda":
        return _verify_cuda(q, k_cache, v_cache, layer, slot, valid_map, positions, pos_map,
                            int(window), scale, cache_scale, sinks, float(softcap))
    raise ValueError(f"spec_verify_attention: no kernel for device {q.device}")
