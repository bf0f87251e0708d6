"""Ragged one-token decode attention — Hopper kernel + plain version.

Port of the bf16 entry of ``lapha_tpu/ops/ragged_decode_attention.py``: row
b's query group attends to the slots of one layer of the slot-uniform
(L, B, nkv, S, dh) decode cache that lie in

    [pstart[b], lens[b])  ∪  [dstart[b], slot]

(the row's prompt, then its decode columns; ``pstart`` defaults to 0), and
reads nothing else. The CUDA kernel (``csrc/ragged_decode_attention.cu``)
walks the two segments separately, so a chunk shared by the prompt tail and
the decode start is not counted twice. ``cache[layer]`` is a zero-copy view
in PyTorch, so the layer index is only passed to keep the JAX signature.

A CPU tensor takes the plain version (dense masked attention over the same
validity); a CUDA tensor launches the kernel or raises. Not ported yet: the
int8-cache and attention-sink variants (Pallas ``_kernel_q8``,
``_kernel_sink``, ``_kernel_q8_sink``).
"""

from __future__ import annotations

import math

import torch

from . import _cuda

NEG_INF = -1e30

__all__ = ["ragged_decode_attention", "ragged_decode_plain"]


def ragged_decode_plain(q, k_cache, v_cache, layer, lens, dstart, slot,
                        pstart=None, scale=None):
    """Dense masked decode attention, float32 inside; same arguments and
    result as :func:`ragged_decode_attention`."""
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
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(B, nh, dh).to(q.dtype)


def _ragged_cuda(q, k_cache, v_cache, layer, lens, dstart, slot, pstart, scale):
    name = "ragged_decode_attention"
    B, nh, dh = q.shape
    dev = q.device
    _cuda.require_cuda_bf16(name, dev, q=q, k_cache=k_cache, v_cache=v_cache)
    L, Bc, nkv, S, dhc = k_cache.shape
    _cuda.require(tuple(v_cache.shape) == tuple(k_cache.shape) and Bc == B
                  and dhc == dh, name,
                  f"shapes q {tuple(q.shape)} cache {tuple(k_cache.shape)}")
    _cuda.require(dh == 128, name, f"head dim {dh} (the kernel takes 128)")
    _cuda.require(nh % nkv == 0 and nh // nkv <= 8, name,
                  f"{nh} query heads over {nkv} KV heads (group <= 8)")
    layer, slot = int(layer), int(slot)
    _cuda.require(0 <= layer < L and 0 <= slot < S, name,
                  f"layer {layer} / slot {slot} outside the cache")
    lens = _cuda.int32_on(lens, dev, (B,))
    dstart = _cuda.int32_on(dstart, dev, (B,))
    pstart = (torch.zeros((B,), dtype=torch.int32, device=dev) if pstart is None
              else _cuda.int32_on(pstart, dev, (B,)))
    out = torch.empty((B, nh, dh), dtype=q.dtype, device=dev)
    err = _cuda.lib().lapha_ragged_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        dstart.data_ptr(), pstart.data_ptr(), layer, slot, out.data_ptr(),
        B, nh, nkv, S, dh, float(scale), _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


def ragged_decode_attention(q, k_cache, v_cache, layer, lens, dstart, slot,
                            pstart=None, scale=None, *, cache_scale=None,
                            sinks=None):
    """q (B,nh,dh); k_cache, v_cache (L,B,nkv,S,dh); layer and slot ints;
    lens, dstart, pstart (B,). Returns (B,nh,dh) in q.dtype."""
    if cache_scale is not None or sinks is not None:
        raise NotImplementedError(
            "ragged_decode_attention: int8 caches and sinks are not ported yet")
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ragged_decode_plain(q, k_cache, v_cache, layer, lens, dstart,
                                   slot, pstart, scale)
    if q.device.type == "cuda":
        return _ragged_cuda(q, k_cache, v_cache, layer, lens, dstart, slot,
                            pstart, scale)
    raise ValueError(f"ragged_decode_attention: no kernel for device {q.device}")
