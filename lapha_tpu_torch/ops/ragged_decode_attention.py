"""Ragged one-token decode attention — Hopper kernel + plain version.

Port of the four entries of ``lapha_tpu/ops/ragged_decode_attention.py``
(bf16 and int8 caches, each with and without attention sinks): row
b's query group attends to the slots of one layer of the slot-uniform
(L, B, nkv, S, dh) decode cache that lie in

    [pstart[b], lens[b])  ∪  [dstart[b], slot]

(the row's prompt, then its decode columns; ``pstart`` defaults to 0), and
reads nothing else. The CUDA kernel (``csrc/ragged_decode_attention.cu``)
takes the two segments as one list of valid slots, so a chunk shared by the
prompt tail and the decode start is not counted twice, and splits each
row's list over a thread-block cluster of ``split_plan(...).splits`` CTAs
(planned here from shapes alone: ``lens`` stays on the device), which merge
their partial softmax states in rank order. ``cache[layer]`` is a zero-copy
view in PyTorch, so the layer index is only passed to keep the JAX
signature.

``cache_scale=(ks, vs)``, each (L, B, nkv, S) f32, reads an int8 cache
(the Pallas ``_kernel_q8``): the K scale multiplies the logits after the
attention scale, and the V scale multiplies the probabilities, after the
softmax denominator in the kernel and after the normalisation in the plain
version (the JAX dense int8 path, ``qwen2.decode_step``) — the same values.

``sinks`` (nh,) f32, GPT-OSS's learned per-head sink logits (the Pallas
``_kernel_sink`` and ``_kernel_q8_sink``): an extra softmax column of zero
value, which the kernel realises by starting each query head's online
softmax at (max = sink, sum = 1). A sliding-window layer passes the
window-clipped ranges, pstart = clip(positions - W + 1, 0, lens) and
dstart' = max(dstart, slot - W + 1); nothing in the kernel knows the window.

``softcap`` > 0 (Gemma-2) caps each true logit, cap·tanh(s/cap), before
the mask and the softmax: after the attention scale and, on an int8 cache,
after the K scale, as JAX's dense decode (``qwen2.decode_step``
``dense_att``) applies it. It is a runtime argument of every entry (0 =
off); a softcapped launch is counted under its entry's name + "_softcap".

The kernel takes head dims 64, 96, 128 and 256 and any GQA group; a CTA
holds up to 16 query heads of a group over one copy of its KV head's slots
(StarCoder2's 12 read them once), a larger group takes a CTA per 16 heads.
Launches are counted per entry: ``ragged_decode_attention``, ``_q8``,
``_sink`` and ``_q8_sink``. A CPU tensor takes the plain version (dense
masked attention over the same validity); a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _cuda

NEG_INF = -1e30
# head dims the kernel is built for
DECODE_HEAD_DIMS = (64, 96, 128, 256)
CHUNK = 64       # slots a CTA takes at a time: 4 warps x 16
MAX_SPLITS = 8   # a row's splits are one thread-block cluster: at most 8 CTAs (portable)
MAX_STAGES = 4   # ring stages a warp the kernel takes (fewer where they do not fit)
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory; 1 KB of it is reserved a CTA

__all__ = ["Plan", "ragged_decode_attention", "ragged_decode_plain", "split_plan"]

# launch-count name -> C entry of csrc/ragged_decode_attention.cu
_ENTRIES = {"ragged_decode_attention": "lapha_ragged_decode",
            "ragged_decode_attention_q8": "lapha_ragged_decode_q8",
            "ragged_decode_attention_sink": "lapha_ragged_decode_sink",
            "ragged_decode_attention_q8_sink": "lapha_ragged_decode_q8_sink"}


class Plan(NamedTuple):
    splits: int  # CTAs a (row, KV head): one cluster, each a contiguous share of the row's slots
    stages: int  # 16-slot pieces a warp has in flight


def cta_smem(dh: int, int8: bool, group: int, stages: int, splits: int) -> int:
    """Dynamic shared memory of one CTA (the kernel's ``Layout``): 4 warps x
    ``stages`` pieces of 16 K and V rows (padded by 16 bytes; int8 with 32
    scales), or the merge's accumulators if larger, a tail, and with more
    than one split the inbox of the cluster's partials."""
    heads = 8 if group <= 8 else 16  # a CTA
    row = dh + 16 if int8 else 2 * dh + 16
    stage = 2 * 16 * row + (2 * 16 * 4 if int8 else 0)
    inbox = (2 * MAX_SPLITS * heads + heads * dh + MAX_SPLITS) * 4 if splits > 1 else 0
    return (max(4 * stages * stage, 4 * heads * (dh + 4) * 4) + (14 + MAX_SPLITS) * heads * 4
            + inbox)


def split_plan(B: int, nkv: int, group: int, max_len: int, sms: int, *, dh: int,
               int8: bool) -> Plan:
    """The kernel's grid (B, nkv x ceil(group / 16), splits) and ring depth
    for B rows of nkv KV heads with ``group`` query heads each, rows of at
    most ``max_len`` valid slots (slot + 1: the lengths stay on the
    device), head dim ``dh`` and a bf16 or int8 cache, on a card of ``sms``
    SMs.

    One split where the B·nkv·ceil(group / 16) CTAs (a CTA holds up to 16
    heads of a group) already give every SM one. Else about one CTA an SM,
    ceil(sms / CTAs), but no more than one wave of CTAs can be resident (at
    dh 256 a CTA's 133 KB of ring leaves room for one an SM), no more than
    the row has 64-slot chunks, and a power of two up to 8: clusters of 3,
    5 or 6 CTAs fill the card's GPCs badly. Two ring stages, one where a
    warp gets a single piece. Measured on an H100
    (``bench_k4.py --sweep``, CUDA-graph replays, PERF.md §6): a split costs
    a merge, so more CTAs than SMs lose (Qwen2.5's 12/2 heads at B=24: 2 or
    4 splits 0.0095 ms, 8 0.0144); Gemma-3's 4/1 heads: 4 splits 0.0100, 5
    0.0168; stages past two cost CTAs an SM (4 splits x 4 stages 0.0143)."""
    if min(B, nkv, group, max_len, sms) < 1:
        raise ValueError(f"split_plan: B {B}, nkv {nkv}, group {group}, max_len {max_len}, "
                         f"sms {sms}")
    tiles = B * nkv * (1 if group <= 8 else math.ceil(group / 16))
    splits = 1
    if tiles < sms:
        resident = sms * max(1, SMEM_PER_SM // (cta_smem(dh, int8, group, 2, 2) + 1024))
        want = min(MAX_SPLITS, math.ceil(max_len / CHUNK), math.ceil(sms / tiles),
                   resident // tiles)
        splits = 1 << (max(1, want).bit_length() - 1)  # the power of two at or below
    per_warp = math.ceil(math.ceil(max_len / splits) / CHUNK)
    return Plan(splits, min(2, per_warp))


def ragged_decode_plain(q, k_cache, v_cache, layer, lens, dstart, slot,
                        pstart=None, scale=None, *, cache_scale=None, sinks=None, softcap=0.0):
    """Dense masked decode attention, float32 inside; same arguments and
    result as :func:`ragged_decode_attention`. The sink column joins the
    softmax's max and denominator (JAX ``_sink_softmax``)."""
    B, nh, dh = q.shape
    k, v = k_cache[layer], v_cache[layer]  # (B, nkv, S, dh)
    nkv, S = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    ar = torch.arange(S, device=q.device)[None, :]
    p0 = torch.zeros_like(lens) if pstart is None else pstart
    valid = (((ar >= p0[:, None]) & (ar < lens[:, None]))
             | ((ar >= dstart[:, None]) & (ar <= slot)))  # (B, S)
    valid = valid[:, None, None, :]
    qg = q.float().reshape(B, nkv, nh // nkv, dh)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    if cache_scale is not None:
        s = s * cache_scale[0][layer].float()[:, :, None, :]
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    if sinks is not None:
        sk = sinks.float().reshape(1, nkv, nh // nkv, 1)
        m = torch.maximum(m, sk)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    den = p.sum(dim=-1, keepdim=True)
    if sinks is not None:
        den = den + torch.exp(sk - m)
    p = p / den.clamp(min=1e-30)
    if cache_scale is not None:
        p = p * cache_scale[1][layer].float()[:, :, None, :]
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(B, nh, dh).to(q.dtype)


def _ragged_cuda(q, k_cache, v_cache, layer, lens, dstart, slot, pstart, scale, cache_scale,
                 sinks, softcap=0.0):
    entry = ("ragged_decode_attention" + ("" if cache_scale is None else "_q8")
             + ("" if sinks is None else "_sink"))
    name = entry + ("_softcap" if softcap else "")
    B, nh, dh = q.shape
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
    _cuda.require(tuple(v_cache.shape) == tuple(k_cache.shape) and Bc == B
                  and dhc == dh, name,
                  f"shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    _cuda.require(dh in DECODE_HEAD_DIMS, name,
                  f"head dim {dh} (the kernel takes {DECODE_HEAD_DIMS})")
    _cuda.require(softcap >= 0.0, name, f"softcap {softcap} (0 = off)")
    _cuda.require(nh % nkv == 0, name, f"{nh} query heads over {nkv} KV heads")
    if sinks is not None:  # its shape is checked by ragged_decode_attention
        _cuda.require_cuda(name, dev, torch.float32, aligned=False, sinks=sinks)
    layer, slot = int(layer), int(slot)
    _cuda.require(0 <= layer < L and 0 <= slot < S, name,
                  f"layer {layer} / slot {slot} outside the cache")
    lens = _cuda.int32_on(lens, dev, (B,))
    dstart = _cuda.int32_on(dstart, dev, (B,))
    pstart = (torch.zeros((B,), dtype=torch.int32, device=dev) if pstart is None
              else _cuda.int32_on(pstart, dev, (B,)))
    out = torch.empty((B, nh, dh), dtype=q.dtype, device=dev)
    scales = [] if cache_scale is None else [cache_scale[0].data_ptr(), cache_scale[1].data_ptr()]
    sink = [] if sinks is None else [sinks.data_ptr()]
    plan = split_plan(B, nkv, nh // nkv, slot + 1, _cuda.sm_count(dev), dh=dh,
                      int8=cache_scale is not None)
    err = getattr(_cuda.lib(), _ENTRIES[entry])(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales, lens.data_ptr(),
        dstart.data_ptr(), pstart.data_ptr(), *sink, layer, slot, out.data_ptr(),
        B, nh, nkv, S, dh, float(scale), float(softcap), *plan, _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


def ragged_decode_attention(q, k_cache, v_cache, layer, lens, dstart, slot,
                            pstart=None, scale=None, *, cache_scale=None,
                            sinks=None, softcap=0.0):
    """q (B,nh,dh); k_cache, v_cache (L,B,nkv,S,dh), bf16 or (with
    ``cache_scale``) int8; layer and slot ints; lens, dstart, pstart (B,);
    ``sinks`` (nh,) f32 or None; ``softcap`` > 0 caps the logits. Returns
    (B,nh,dh) in q.dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if sinks is not None and tuple(sinks.shape) != (q.shape[1],):
        raise ValueError(f"ragged_decode_attention: sinks {tuple(sinks.shape)} for "
                         f"{q.shape[1]} query heads")
    if q.device.type == "cpu":
        return ragged_decode_plain(q, k_cache, v_cache, layer, lens, dstart, slot, pstart,
                                   scale, cache_scale=cache_scale, sinks=sinks, softcap=softcap)
    if q.device.type == "cuda":
        return _ragged_cuda(q, k_cache, v_cache, layer, lens, dstart, slot,
                            pstart, scale, cache_scale, sinks, float(softcap))
    raise ValueError(f"ragged_decode_attention: no kernel for device {q.device}")
