"""Ragged one-token decode attention — Hopper kernel + plain version.

Port of the four entries of ``lapha_tpu/ops/ragged_decode_attention.py``
(bf16 and int8 caches, each with and without attention sinks): row
b's query group attends to the slots of one layer of the slot-uniform
(L, B, nkv, S, dh) decode cache that lie in

    [pstart[b], lens[b])  ∪  [dstart[b], slot]

(the row's prompt, then its decode columns; ``pstart`` defaults to 0), and
reads nothing else. The CUDA kernel (``csrc/ragged_decode_attention.cu``)
walks the two segments separately, so a chunk shared by the prompt tail and
the decode start is not counted twice. ``cache[layer]`` is a zero-copy view
in PyTorch, so the layer index is only passed to keep the JAX signature.

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

The kernel takes head dims 64, 96, 128 and 256 and any GQA group; a group
above 8 (StarCoder2's 12) runs ceil(group/8) CTAs per KV head, each over a
block of the group. Launches are counted per entry: ``ragged_decode_attention``, ``_q8``,
``_sink`` and ``_q8_sink``. A CPU tensor takes the plain version (dense
masked attention over the same validity); a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

NEG_INF = -1e30
# head dims the kernel is built for
DECODE_HEAD_DIMS = (64, 96, 128, 256)

__all__ = ["ragged_decode_attention", "ragged_decode_plain"]

# launch-count name -> C entry of csrc/ragged_decode_attention.cu
_ENTRIES = {"ragged_decode_attention": "lapha_ragged_decode",
            "ragged_decode_attention_q8": "lapha_ragged_decode_q8",
            "ragged_decode_attention_sink": "lapha_ragged_decode_sink",
            "ragged_decode_attention_q8_sink": "lapha_ragged_decode_q8_sink"}


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
    err = getattr(_cuda.lib(), _ENTRIES[entry])(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales, lens.data_ptr(),
        dstart.data_ptr(), pstart.data_ptr(), *sink, layer, slot, out.data_ptr(),
        B, nh, nkv, S, dh, float(scale), float(softcap), _cuda.stream_of(q))
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
