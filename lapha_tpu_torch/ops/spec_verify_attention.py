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
CUDA tensor launches ``csrc/spec_verify_attention.cu`` or raises. Launches are
counted per entry: ``spec_verify_attention``, ``_q8``, ``_sink``,
``_q8_sink``, + ``_softcap`` when capped.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

NEG_INF = -1e30
VERIFY_HEAD_DIMS = (64, 96, 128, 256)

__all__ = ["spec_verify_attention", "spec_verify_plain", "verify_visible", "launch_name"]

# launch-count name (without "_softcap") -> C entry of csrc/spec_verify_attention.cu
_ENTRIES = {"spec_verify_attention": "lapha_spec_verify",
            "spec_verify_attention_q8": "lapha_spec_verify_q8",
            "spec_verify_attention_sink": "lapha_spec_verify_sink",
            "spec_verify_attention_q8_sink": "lapha_spec_verify_q8_sink"}


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
    err = getattr(_cuda.lib(), _ENTRIES[entry])(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *scales, valid_map.data_ptr(),
        positions.data_ptr(), None if pos is None else pos.data_ptr(), *sink, layer, slot, T,
        int(window), out.data_ptr(), B, nh, nkv, S, dh, float(scale), float(softcap),
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
