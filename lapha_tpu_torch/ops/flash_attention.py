"""Causal GQA flash attention, forward and backward — Hopper kernels + plain versions.

Port of ``lapha_tpu/ops/flash_attention.py``: ``flash_attention`` (the
no-cache causal forward, Pallas ``_flash_kernel``, differentiable through
the backward pair ``_dq_kernel``/``_dkv_kernel``) and
``flash_attention_cached`` (the rectangular cache-threaded prefill, Pallas
``_flash_cached_kernel``, forward only as in JAX). Both forwards run one
CUDA kernel, ``csrc/flash_attention.cu``: the no-cache forward is the cached
one with S = T, qstart = 0 and kv_valid = the key-padding mask. The backward
runs two, ``csrc/flash_attention_bwd.cu`` (dq; dk/dv summed over the GQA
group), from the forward's saved LSE.

``flash_attention`` is a ``torch.autograd.Function``: its forward saves
(q, k, v, mask, out, lse) and its backward runs the kernels, so a loss taken
through the model on the card reaches q, k and v of every layer.

Dispatch goes by the tensors' device: a CPU tensor takes the plain PyTorch
version below (dense masked attention written from the JAX semantics, and
the FlashAttention-2 backward formulas from the saved LSE), a CUDA tensor
launches the kernel or raises. There is no fallback between them.

Semantics: query t of row b sits at absolute position qstart[b] + t and sees
key j iff kv_valid[b, j] and j <= qstart[b] + t, and with ``window`` W > 0
(a sliding-window layer) j > qstart[b] + t - W. With ``softcap`` > 0
(Gemma-2) the scaled logit s becomes cap·tanh(s/cap) before the mask, as in
the Pallas kernels. The forward kernel takes head dims (of Q/K, of V) (64,
64), (96, 96) (Phi-3), (128, 128), (256, 256) and (192, 128), the last
DeepSeek MLA's V narrower than Q/K (the Pallas kernels' dv <= dh); a launch
with dv < dh is
counted under its own name (``flash_attention_narrowv``,
``flash_attention_cached_narrowv``), a windowed one adds ``_window``
(``flash_attention_window``, ``flash_attention_cached_window``) and a
softcapped one ``_softcap`` (``flash_attention_cached_window_softcap``, ...).
A row that
sees no key gives 0 and LSE -1e30 here, never NaN. The JAX versions give a
finite average of V there (their masked probabilities are exp(0) = 1); such
rows are padding that nothing reads.

Attention sinks (GPT-OSS: one learned logit per query head, an extra
softmax column of zero value) fold outside the kernel, exactly as JAX folds
them (``_sink_forward``, ``flash_attention_cached``):
lse_t = logaddexp(lse, sink), out_t = out · exp(lse - lse_t). The backward
reruns the backward pair with (out_t, lse_t) and adds
dsink = -Σ exp(sink - lse_t)·D (JAX ``_sink_bwd``).

On the card the backward pair takes the head-dim pairs of the forward
(``BWD_HEAD_DIMS``: DeepSeek's V of 128 beside Q/K of 192 too, dP = dO·Vᵀ
contracting over V's width), the window band and the softcap, in any
combination; a launch is counted under :func:`launch_name`
(``flash_attention_bwd_dq_window``, ``flash_attention_bwd_dkv_narrowv``,
``flash_attention_bwd_dkv_window_softcap``, ...). Both the kernels and the
plain backward on the CPU apply the softcap's chain rule, dc/ds = 1 -
(c/cap)² (the Pallas ``_dq_kernel`` and ``_dkv_kernel``). A pair without an
instance raises in either direction.
"""

from __future__ import annotations

import math

import torch

from . import _cuda

NEG_INF = -1e30

__all__ = ["flash_attention", "flash_attention_cached", "attention_plain",
           "attention_bwd_plain"]


def _sink_fold(out, lse, sinks):
    """The sink column folded into a sink-free result: (out (B,T,nh,dv),
    lse (B,nh,T) f32) -> (out_t in out's dtype, lse_t f32). A row that saw
    no key (lse -1e30) gets lse_t = sink and stays 0."""
    lse_t = torch.logaddexp(lse, sinks.float()[None, :, None])
    factor = torch.exp(lse - lse_t).transpose(1, 2)[..., None]  # (B, T, nh, 1)
    return (out.float() * factor).to(out.dtype), lse_t


def _logits(q, k, scale, softcap):
    """(B, nkv, group, T, S) f32 scaled logits, softcapped when ``softcap`` > 0."""
    B, T, nh, dh = q.shape
    nkv = k.shape[2]
    s = torch.einsum("btkgd,bskd->bkgts", q.float().reshape(B, T, nkv, nh // nkv, dh),
                     k.float()) * scale
    return torch.tanh(s * (1.0 / softcap)) * softcap if softcap else s


def attention_plain(q, k, v, kv_valid, qstart, scale, window=0, sinks=None, softcap=0.0):
    """Dense masked attention, float32 inside. q (B,T,nh,dh); k, v (B,S,nkv,dh|dv);
    kv_valid (B,S); qstart (B,); ``window`` > 0 bands it; ``softcap`` > 0
    caps the scaled logits before the mask; ``sinks`` (nh,) folds the sink
    column in. Returns (out (B,T,nh,dv) in q.dtype, lse (B,nh,T) f32)."""
    B, T, nh, _ = q.shape
    S = k.shape[1]
    s = _logits(q, k, scale, softcap)
    valid = _visible(q, kv_valid, qstart, S, window)[:, None, None]  # (B,1,1,T,S)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->btkgd", p / l.clamp(min=1e-30), v.float())
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-30)), NEG_INF)
    out, lse = o.reshape(B, T, nh, v.shape[-1]).to(q.dtype), lse.reshape(B, nh, T)
    return (out, lse) if sinks is None else _sink_fold(out, lse, sinks)


# (head dim of Q/K, head dim of V) pairs the forward and the backward kernels
# are built for
FWD_HEAD_DIMS = ((64, 64), (96, 96), (128, 128), (256, 256), (192, 128))
BWD_HEAD_DIMS = ((64, 64), (96, 96), (128, 128), (256, 256), (192, 128))


def launch_name(name, window=0, softcap=0.0, narrowv=False):
    """The launch counter of a launch: ``name``, + "_narrowv" when V is
    narrower than Q/K, + "_window" when banded, + "_softcap" when softcapped."""
    return (name + ("_narrowv" if narrowv else "") + ("_window" if window > 0 else "")
            + ("_softcap" if softcap else ""))


def _attention_cuda(q, k, v, kv_valid, qstart, scale, name, window=0, softcap=0.0):
    """The forward kernel, sink-free; counted under :func:`launch_name`."""
    B, T, nh, dh = q.shape
    S, nkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    name = launch_name(name, window, softcap, narrowv=dv < dh)
    _cuda.require_cuda_bf16(name, dev, q=q, k=k, v=v)
    _cuda.require((dh, dv) in FWD_HEAD_DIMS, name,
                  f"head dims (q/k {dh}, v {dv}) (the kernel takes {FWD_HEAD_DIMS})")
    _cuda.require(softcap >= 0.0, name, f"softcap {softcap} (0 = off)")
    _cuda.require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == dh
                  and nh % nkv == 0, name,
                  f"shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    _cuda.require(tuple(v.shape) == (B, S, nkv, dv), name,
                  f"v {tuple(v.shape)} must be k's shape but for its head dim")
    kv_valid = _cuda.int32_on(kv_valid, dev, (B, S))
    qstart = _cuda.int32_on(qstart, dev, (B,))
    out = torch.empty((B, T, nh, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=dev)
    err = _cuda.lib().lapha_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
        qstart.data_ptr(), out.data_ptr(), lse.data_ptr(),
        B, T, S, nh, nkv, dh, dv, int(window), float(scale), float(softcap),
        _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out, lse


def _forward(q, k, v, kv_valid, qstart, scale, name, window=0, sinks=None, softcap=0.0):
    """(out, lse), the sinks folded in: the kernel for CUDA tensors, the
    plain version for CPU ones."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_valid, qstart, scale, window, sinks, softcap)
    if q.device.type == "cuda":
        out, lse = _attention_cuda(q, k, v, kv_valid, qstart, scale, name, window, softcap)
        return (out, lse) if sinks is None else _sink_fold(out, lse, sinks)
    raise ValueError(f"{name}: no kernel for device {q.device}")


def _visible(q, kv_valid, qstart, S, window=0):
    """(B, T, S) bool: query t of row b sees key j."""
    T = q.shape[1]
    qpos = (qstart.reshape(-1, 1).long() + torch.arange(T, device=q.device)[None, :])[:, :, None]
    kpos = torch.arange(S, device=q.device)[None, None, :]
    seen = (kv_valid[:, None, :] > 0) & (kpos <= qpos)
    return seen & (kpos > qpos - window) if window > 0 else seen


def _bwd_plain_ds(q, k, v, kv_valid, qstart, lse, do, delta, scale, window=0, softcap=0.0):
    """P and dS (B, nkv, group, T, S) in f32, recomputed from the LSE as the
    kernels do. Rows whose LSE is the -1e30 sentinel saw no key: P = 0.
    With a softcap P is over the capped logits c and dS carries the chain
    rule dc/ds = 1 - (c/cap)² (Pallas ``_dq_kernel`` :137-147)."""
    B, T, nh, dh = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nh // nkv
    s = _logits(q, k, scale, softcap)
    lse_g = lse.float().reshape(B, nkv, group, T, 1)
    ok = _visible(q, kv_valid, qstart, S, window)[:, None, None] & (lse_g > 0.5 * NEG_INF)
    p = torch.where(ok, torch.exp(s - lse_g), 0.0)
    dp = torch.einsum("btkgd,bskd->bkgts", do.float().reshape(B, T, nkv, group, -1),
                      v.float())
    d = delta.reshape(B, T, nkv, group).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - d)
    return p, ds * (1.0 - (s * (1.0 / softcap)) ** 2) if softcap else ds


def _dq_from(ds, q, k, scale):
    B, T, nh, dh = q.shape
    dq = torch.einsum("bkgts,bskd->btkgd", ds, k.float()) * scale
    return dq.reshape(B, T, nh, dh).to(q.dtype)


def _dkv_from(p, ds, q, k, v, do, scale):
    B, T, nh, dh = q.shape
    nkv = k.shape[2]
    dk = torch.einsum("bkgts,btkgd->bskd", ds, q.float().reshape(B, T, nkv, nh // nkv, dh))
    dv = torch.einsum("bkgts,btkgd->bskd", p, do.float().reshape(B, T, nkv, nh // nkv, -1))
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def attention_bwd_dq_plain(q, k, v, kv_valid, qstart, lse, do, delta, scale, window=0,
                           softcap=0.0):
    """dQ = scale·dS·K (B,T,nh,dh) in q.dtype: the plain version of the dq kernel."""
    _, ds = _bwd_plain_ds(q, k, v, kv_valid, qstart, lse, do, delta, scale, window, softcap)
    return _dq_from(ds, q, k, scale)


def attention_bwd_dkv_plain(q, k, v, kv_valid, qstart, lse, do, delta, scale, window=0,
                            softcap=0.0):
    """(dK = scale·dSᵀ·Q, dV = Pᵀ·dO), each summed over the GQA group, in
    k.dtype/v.dtype: the plain version of the dk/dv kernel."""
    p, ds = _bwd_plain_ds(q, k, v, kv_valid, qstart, lse, do, delta, scale, window, softcap)
    return _dkv_from(p, ds, q, k, v, do, scale)


def attention_bwd_plain(q, k, v, kv_valid, qstart, lse, do, delta, scale, window=0,
                        softcap=0.0):
    """FlashAttention-2 backward from the saved LSE, float32 inside; mirrors
    the Pallas ``_dq_kernel``/``_dkv_kernel``. ``delta`` = rowsum(dO∘O)
    (B,T,nh) f32. Returns (dq, dk, dv) in the inputs' dtypes."""
    p, ds = _bwd_plain_ds(q, k, v, kv_valid, qstart, lse, do, delta, scale, window, softcap)
    return (_dq_from(ds, q, k, scale), *_dkv_from(p, ds, q, k, v, do, scale))


def _bwd_args(name, q, k, v, kv_valid, qstart, lse, do, delta):
    """Checks and converts the kernels' arguments; (kv_valid, qstart, lse,
    delta (B,nh,T)) as the kernels take them."""
    B, T, nh, dh = q.shape
    S, nkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    dev = q.device
    _cuda.require_cuda_bf16(name, dev, q=q, k=k, v=v, do=do)
    _cuda.require((dh, dv) in BWD_HEAD_DIMS, name,
                  f"head dims (q/k {dh}, v {dv}) (the kernels take {BWD_HEAD_DIMS})")
    _cuda.require(k.dim() == 4 and k.shape[0] == B and k.shape[3] == dh and nh % nkv == 0,
                  name, f"shapes q {tuple(q.shape)} k {tuple(k.shape)}")
    _cuda.require(tuple(v.shape) == (B, S, nkv, dv), name,
                  f"v {tuple(v.shape)} must be k's shape but for its head dim")
    _cuda.require(tuple(do.shape) == (B, T, nh, dv), name, "dout must be (B, T, nh, dv)")
    for key, t, shape in (("lse", lse, (B, nh, T)), ("delta", delta, (B, T, nh))):
        _cuda.require(t.device == dev and t.dtype == torch.float32
                      and tuple(t.shape) == shape, name,
                      f"{key} must be f32 {shape} on {dev}")
    return (_cuda.int32_on(kv_valid, dev, (B, S)), _cuda.int32_on(qstart, dev, (B,)),
            lse.contiguous(), delta.transpose(1, 2).contiguous())


def attention_bwd_dq_cuda(q, k, v, kv_valid, qstart, lse, do, delta, scale, window=0,
                          softcap=0.0):
    """The dq kernel (csrc/flash_attention_bwd.cu); arguments as the plain version's."""
    B, T, nh, dh = q.shape
    S, nkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    name = launch_name("flash_attention_bwd_dq", window, softcap, narrowv=dv < dh)
    kv_valid, qstart, lse, delta_t = _bwd_args(name, q, k, v, kv_valid, qstart, lse, do, delta)
    dq = torch.empty_like(q)
    err = _cuda.lib().lapha_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta_t.data_ptr(), kv_valid.data_ptr(), qstart.data_ptr(), dq.data_ptr(),
        B, T, S, nh, nkv, dh, dv, int(window), float(scale), float(softcap),
        _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return dq


def dkv_split(B: int, S: int, nkv: int, group: int, dh: int, sms: int) -> int:
    """How many parts the dk/dv kernel splits each GQA group into: the
    smallest divisor of ``group`` whose CTAs (key blocks x KV heads x rows
    x parts) fill the ``sms`` SMs once, else the whole group. A CTA takes
    128 keys at dh <= 128 (the wgmma kernel), 64 above. Each part sums its
    query heads' dK/dV into f32 partials, added in part order afterwards."""
    ctas = math.ceil(S / (128 if dh <= 128 else 64)) * nkv * B
    return next((d for d in range(1, group + 1) if group % d == 0 and ctas * d >= sms), group)


def split_heads(group: int, splits: int) -> list[tuple[int, int]]:
    """The query heads [h0, h1) of a KV head's group that each part takes,
    in part order (the order their partials are added in)."""
    per = group // splits
    return [(s * per, (s + 1) * per) for s in range(splits)]



def attention_bwd_dkv_cuda(q, k, v, kv_valid, qstart, lse, do, delta, scale, window=0,
                           softcap=0.0):
    """The dk/dv kernel (csrc/flash_attention_bwd.cu); arguments as the plain version's."""
    B, T, nh, dh = q.shape
    S, nkv, dv_w = k.shape[1], k.shape[2], v.shape[-1]
    name = launch_name("flash_attention_bwd_dkv", window, softcap, narrowv=dv_w < dh)
    kv_valid, qstart, lse, delta_t = _bwd_args(name, q, k, v, kv_valid, qstart, lse, do, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    splits = dkv_split(B, S, nkv, nh // nkv, dh, _cuda.sm_count(q.device))
    work = None
    if splits > 1:  # the parts' f32 partials: dK's, then dV's
        work = torch.empty(splits * B * S * nkv * (dh + dv_w), dtype=torch.float32,
                           device=q.device)
    err = _cuda.lib().lapha_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta_t.data_ptr(), kv_valid.data_ptr(), qstart.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if work is None else work.data_ptr(), B, T, S, nh, nkv, dh, dv_w,
        int(window), float(scale), float(softcap), splits, _cuda.stream_of(q))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return dk, dv


def _backward(q, k, v, kv_valid, qstart, out, lse, do, scale, window=0, softcap=0.0):
    """(dq, dk, dv, delta): the kernels for CUDA tensors, the plain version
    for CPU ones. D = rowsum(dO∘O) in f32 is a torch op on both, as JAX
    computes it outside Pallas; it is returned for the sinks' gradient."""
    do = do.contiguous()  # autograd may hand over a strided view
    delta = (do.float() * out.float()).sum(-1)  # (B, T, nh)
    if q.device.type == "cpu":
        return (*attention_bwd_plain(q, k, v, kv_valid, qstart, lse, do, delta, scale, window,
                                     softcap), delta)
    if q.device.type == "cuda":
        args = (q, k, v, kv_valid, qstart, lse, do, delta, scale, window, softcap)
        dq = attention_bwd_dq_cuda(*args)
        dk, dv = attention_bwd_dkv_cuda(*args)
        return dq, dk, dv, delta
    raise ValueError(f"flash_attention backward: no kernel for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """The no-cache forward with its backward pair (JAX ``_flash_attention_vjp``,
    and ``_flash_attention_sink_vjp`` when ``sinks`` is given)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, qstart, sinks, scale, window, softcap):
        out, lse = _forward(q, k, v, kv_valid, qstart, scale, "flash_attention", window, sinks,
                            softcap)
        ctx.save_for_backward(q, k, v, kv_valid, qstart, out, lse, sinks)
        ctx.scale, ctx.window, ctx.softcap = scale, window, softcap
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_valid, qstart, out, lse, sinks = ctx.saved_tensors
        dq, dk, dv, delta = _backward(q, k, v, kv_valid, qstart, out, lse, dout, ctx.scale,
                                      ctx.window, ctx.softcap)
        dsink = None
        if sinks is not None and ctx.needs_input_grad[5]:
            # the sink column's probability, exp(sink - lse_t), times -D
            p_sink = torch.exp(sinks.float()[None, :, None] - lse)  # (B, nh, T)
            dsink = -(p_sink * delta.transpose(1, 2)).sum(dim=(0, 2)).to(sinks.dtype)
        return dq, dk, dv, None, None, dsink, None, None, None


def flash_attention_lse(q, k, v, mask=None, *, causal=True, scale=None, window=0, sinks=None,
                        softcap=0.0):
    """Returns (out (B,T,nh,dv), lse (B,nh,T) f32); see :func:`flash_attention`.
    Differentiable in q, k, v and sinks (lse is not); lse includes the sinks."""
    B, T = q.shape[0], q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    if window > 0 and not causal:
        raise ValueError("flash_attention: a window needs causal attention")
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.int32, device=q.device)
    # non-causal: a query offset at T puts every key behind the frontier
    qstart = torch.full((B,), 0 if causal else T, dtype=torch.int32, device=q.device)
    return _FlashAttention.apply(q, k, v, mask, qstart, sinks, scale, int(window),
                                 float(softcap))


def flash_attention(q, k, v, mask=None, *, causal=True, scale=None, window=0,
                    softcap=0.0, sinks=None):
    """Causal GQA attention, differentiable in q, k, v and sinks. q
    (B,T,nh,dh); k (B,T,nkv,dh), v (B,T,nkv,dv), dv <= dh; mask (B,T) key
    validity. ``scale``
    overrides 1/sqrt(dh); ``window`` > 0 bands the mask to the last
    ``window`` positions (by index, as JAX); ``softcap`` > 0 caps the scaled
    logits to ±softcap (Gemma-2); ``sinks`` (nh,) f32 are GPT-OSS
    attention-sink logits. Returns (B,T,nh,dv) in q.dtype."""
    return flash_attention_lse(q, k, v, mask, causal=causal, scale=scale, window=window,
                               sinks=sinks, softcap=softcap)[0]


def flash_attention_cached(q, k, v, kv_valid, qstart, *, scale=None, window=0,
                           softcap=0.0, sinks=None):
    """Rectangular attention of T new queries (B,T,nh,dh) over the whole
    cache k (B,S,nkv,dh), v (B,S,nkv,dv) with cache-column validity kv_valid (B,S) and
    per-row query offset qstart ((B,) or scalar); ``window`` bands by cache
    slot, ``softcap`` and ``sinks`` as in :func:`flash_attention`. Forward
    only."""
    B = q.shape[0]
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)
    qstart = torch.as_tensor(qstart, device=q.device).reshape(-1).expand(B)
    return _forward(q, k, v, kv_valid, qstart, scale, "flash_attention_cached", int(window),
                    sinks, float(softcap))[0]
