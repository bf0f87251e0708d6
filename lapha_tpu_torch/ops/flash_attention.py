"""Causal GQA flash attention (forward) — Hopper kernel + plain version.

Port of the forward half of ``lapha_tpu/ops/flash_attention.py``:
``flash_attention`` (the no-cache causal forward, Pallas ``_flash_kernel``)
and ``flash_attention_cached`` (the rectangular cache-threaded prefill,
Pallas ``_flash_cached_kernel``). Both run one CUDA kernel,
``csrc/flash_attention.cu``: the no-cache forward is the cached one with
S = T, qstart = 0 and kv_valid = the key-padding mask.

Dispatch goes by the tensors' device: a CPU tensor takes the plain PyTorch
version below (dense masked attention written from the JAX semantics), a
CUDA tensor launches the kernel or raises. There is no fallback between them.

Semantics: query t of row b sits at absolute position qstart[b] + t and sees
key j iff kv_valid[b, j] and j <= qstart[b] + t. A row that sees no key
gives 0 and LSE -1e30 here, never NaN. The JAX versions give a finite
average of V there (their masked probabilities are exp(0) = 1); such rows
are padding that nothing reads.

Not on the served path yet: sliding windows, logit softcap, attention sinks,
a V narrower than Q/K on the card, and the backward (Pallas
``_dq_kernel``/``_dkv_kernel``).
"""

from __future__ import annotations

import math

import torch

from . import _cuda

NEG_INF = -1e30

__all__ = ["flash_attention", "flash_attention_cached", "attention_plain"]


def attention_plain(q, k, v, kv_valid, qstart, scale):
    """Dense masked attention, float32 inside. q (B,T,nh,dh); k, v (B,S,nkv,dh|dv);
    kv_valid (B,S); qstart (B,). Returns (out (B,T,nh,dv) in q.dtype, lse (B,nh,T) f32)."""
    B, T, nh, dh = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    qg = q.float().reshape(B, T, nkv, group, dh)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * scale
    qpos = qstart.reshape(B, 1).long() + torch.arange(T, device=q.device)[None, :]
    kpos = torch.arange(S, device=q.device)
    valid = (kv_valid[:, None, :] > 0) & (kpos[None, None, :] <= qpos[:, :, None])  # (B,T,S)
    valid = valid[:, None, None]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->btkgd", p / l.clamp(min=1e-30), v.float())
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)), NEG_INF)
    return (o.reshape(B, T, nh, v.shape[-1]).to(q.dtype),
            lse.reshape(B, nh, T))


def _attention_cuda(q, k, v, kv_valid, qstart, scale, name):
    B, T, nh, dh = q.shape
    S, nkv = k.shape[1], k.shape[2]
    dev = q.device
    _cuda.require_cuda_bf16(name, dev, q=q, k=k, v=v)
    _cuda.require(dh == 128, name, f"head dim {dh} (the kernel takes 128)")
    _cuda.require(tuple(v.shape) == tuple(k.shape), name,
                  "v must have k's shape (a narrower V is not ported)")
    _cuda.require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == dh
                  and nh % nkv == 0, name,
                  f"shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    kv_valid = _cuda.int32_on(kv_valid, dev, (B, S))
    qstart = _cuda.int32_on(qstart, dev, (B,))
    out = torch.empty((B, T, nh, dh), dtype=q.dtype, device=dev)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=dev)
    err = _cuda.lib().lapha_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        qstart.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, S, nh, nkv, dh, float(scale), _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out, lse


def _forward(q, k, v, kv_valid, qstart, scale, name):
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_valid, qstart, scale)
    if q.device.type == "cuda":
        return _attention_cuda(q, k, v, kv_valid, qstart, scale, name)
    raise ValueError(f"{name}: no kernel for device {q.device}")


def _not_ported(name, window, softcap, sinks):
    if window or softcap or sinks is not None:
        raise NotImplementedError(f"{name}: window/softcap/sinks are not ported yet")


def flash_attention_lse(q, k, v, mask=None, *, causal=True, scale=None):
    """Returns (out (B,T,nh,dh), lse (B,nh,T) f32); see :func:`flash_attention`."""
    B, T = q.shape[0], q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.int32, device=q.device)
    # non-causal: a query offset at T puts every key behind the frontier
    qstart = torch.full((B,), 0 if causal else T, dtype=torch.int32, device=q.device)
    return _forward(q, k, v, mask, qstart, scale, "flash_attention")


def flash_attention(q, k, v, mask=None, *, causal=True, scale=None, window=0,
                    softcap=0.0, sinks=None):
    """Causal GQA attention. q (B,T,nh,dh); k, v (B,T,nkv,dh); mask (B,T)
    key validity. ``scale`` overrides 1/sqrt(dh). Returns (B,T,nh,dh) in
    q.dtype."""
    _not_ported("flash_attention", window, softcap, sinks)
    return flash_attention_lse(q, k, v, mask, causal=causal, scale=scale)[0]


def flash_attention_cached(q, k, v, kv_valid, qstart, *, scale=None, window=0,
                           softcap=0.0, sinks=None):
    """Rectangular attention of T new queries (B,T,nh,dh) over the whole
    cache k, v (B,S,nkv,dh) with cache-column validity kv_valid (B,S) and
    per-row query offset qstart ((B,) or scalar). Forward only."""
    _not_ported("flash_attention_cached", window, softcap, sinks)
    B = q.shape[0]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    qstart = torch.as_tensor(qstart, device=q.device).reshape(-1).expand(B)
    return _forward(q, k, v, kv_valid, qstart, scale, "flash_attention_cached")[0]
