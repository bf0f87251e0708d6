"""Block diffusion's block attention — Hopper kernel + plain version.

Added by the port; it replaces no Pallas kernel. The JAX package computes
this attention dense, with XLA einsums, in ``qwen2.forward(block_bidir=True)``
(``lapha_tpu/models/qwen2.py:1314-1322``, the dense ``_attend``; its flash
path cannot take the mask). That mask is ``valid & ((j <= cache_pos + t) |
(j >= cache_pos))``, which is ``valid`` alone: every j < cache_pos is also
<= cache_pos + t. So query t of row b sees every column j with
``kv_valid[b, j]`` and nothing else, whatever the block's column.

The kernel exists because the cached prefill kernel (K3) runs this shape —
T = 4 queries a row — at 128-row strips of which 4 rows are live, reads each
KV head's panel once per query head and loads the holes to mask them. The
verify kernel's design (``ops/spec_verify_attention``) fits it: each row's
valid columns are listed on the card and split over a thread-block cluster,
and a KV head's panel is read once for all group·T query rows. It is that
kernel with two compile-time switches (the prefill layout, no causal new
columns), its C entry ``csrc/block_attention.cu``.

A CPU tensor takes the plain version below (dense masked attention in f32);
a CUDA tensor launches the kernel or raises. Launches are counted as
``block_attention`` (+ ``_softcap`` when capped). The kernel takes no int8
cache, no sinks and no window: the wrapper raises for them, as
``DiffusionEngine`` refuses all three.
"""

from __future__ import annotations

import math

import torch

from . import _cuda
from .spec_verify_attention import VERIFY_HEAD_DIMS, VerifyPlan, verify_plan

NEG_INF = -1e30

__all__ = ["block_attention", "block_attention_plain", "block_plan", "launch_name"]


def block_plan(B: int, nkv: int, group: int, T: int, S: int, sms: int, *, dh: int,
               smem) -> VerifyPlan:
    """The kernel's grid (B, nkv x qtiles, splits) and ring depth for B rows
    of nkv KV heads with ``group`` query heads each, T block queries a row, an
    S-column cache and head dim ``dh``, on a card of ``sms`` SMs: the verify
    kernel's plan for a bf16 cache without a window (the same kernel, the
    same shared-memory ``Layout``, counted by ``lapha_spec_verify_smem``).
    Shapes only: neither ``kv_valid`` nor the block's column enters it, so a
    captured launch keeps its plan."""
    return verify_plan(B, nkv, group, T, S, sms, dh=dh, int8=False, smem=smem)


def launch_name(softcap: float) -> str:
    return "block_attention" + ("_softcap" if softcap else "")


def block_attention_plain(q, k, v, kv_valid, scale=None, *, softcap: float = 0.0):
    """Dense masked attention, float32 inside; same arguments and result as
    :func:`block_attention`."""
    B, T, nh, dh = q.shape
    nkv = k.shape[2]
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    seen = (kv_valid != 0)[:, None, None, None, :]                   # (B, 1, 1, 1, S)
    s = torch.einsum("btkgd,bskd->bkgts", q.float().reshape(B, T, nkv, nh // nkv, dh),
                     k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(seen, s, NEG_INF)
    p = torch.where(seen, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return o.reshape(B, T, nh, dh).to(q.dtype)


def _block_cuda(q, k, v, kv_valid, scale, softcap):
    name = launch_name(softcap)
    B, T, nh, dh = q.shape
    S, nkv = k.shape[1], k.shape[2]
    dev = q.device
    _cuda.require_cuda_bf16(name, dev, q=q, k=k, v=v)
    _cuda.require(dh in VERIFY_HEAD_DIMS, name, f"head dim {dh} (the kernel takes "
                                                f"{VERIFY_HEAD_DIMS})")
    _cuda.require(softcap >= 0.0, name, f"softcap {softcap} (0 = off)")
    _cuda.require(kv_valid.device == dev, name, f"kv_valid is on {kv_valid.device}")
    valid = (kv_valid if kv_valid.dtype == torch.bool else kv_valid != 0).contiguous()
    out = torch.empty_like(q)
    dll = _cuda.lib()
    plan = block_plan(B, nkv, nh // nkv, T, S, _cuda.sm_count(dev), dh=dh,
                      smem=dll.lapha_spec_verify_smem)
    err = dll.lapha_block_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                                    T, out.data_ptr(), B, nh, nkv, S, dh, float(scale),
                                    float(softcap), *plan, _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


def block_attention(q, k, v, kv_valid, scale=None, *, softcap: float = 0.0, sinks=None,
                    window: int = 0):
    """q (B, T, nh, dh): the block's T queries; k, v (B, S, nkv, dh): one
    layer of the prefill-layout cache (``ck[l]``, a zero-copy view), the
    block's own K/V already written; kv_valid (B, S) bool (or 0/1): the
    columns every query of the row sees. ``softcap`` > 0 caps the scaled
    logits. Returns (B, T, nh, dh) in q.dtype. Sinks, a window and an int8
    cache raise: block diffusion refuses them."""
    B, T, nh, dh = q.shape
    if sinks is not None or window:
        raise ValueError("block_attention takes no sinks and no window (block diffusion "
                         "refuses both)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"block_attention: a {k.dtype} cache for {q.dtype} queries (no int8 "
                         "cache: block diffusion refuses kv_quant)")
    if (k.dim() != 4 or tuple(v.shape) != tuple(k.shape) or k.shape[0] != B
            or k.shape[3] != dh or nh % k.shape[2] != 0
            or tuple(kv_valid.shape) != (B, k.shape[1])):
        raise ValueError(f"block_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, kv_valid {tuple(kv_valid.shape)}")
    scale = 1.0 / math.sqrt(dh) if scale is None else float(scale)
    if q.device.type == "cpu":
        return block_attention_plain(q, k, v, kv_valid, scale, softcap=softcap)
    if q.device.type == "cuda":
        return _block_cuda(q, k, v, kv_valid, scale, float(softcap))
    raise ValueError(f"block_attention: no kernel for device {q.device}")
