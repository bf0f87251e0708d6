"""Grouped GEMM over contiguous expert row groups — Hopper kernel + plain version.

Port of ``lapha_tpu/ops/moe.py`` ``_grouped_gemm`` (:290; ``megablox.gmm``
on the TPU, ``jax.lax.ragged_dot`` elsewhere), the product behind every MoE
layer: xs (M, K) @ w (G, K, N), rows ``[off_g, off_g + group_sizes[g])``
hitting expert g, with ``off_g`` the exclusive prefix sum of the sizes.
The result is (M, N) f32 (JAX's ``preferred_element_type=float32``); rows
past ``sum(group_sizes)`` are 0, as ragged_dot gives.

The CUDA kernels (``csrc/grouped_gemm.cu``) keep the group sizes on the
device: every block finds its (expert, row tile) from their prefix sums, so
the MoE layer never waits on the host. They take bf16 xs and w and K a
multiple of 8. The forward has two: a wgmma kernel fed by TMA
(``grouped_gemm_wg``, 128-row tiles) where the experts get many rows, and
the decode kernel (``grouped_gemm``) at a few rows an expert and for
weights that TMA cannot read (N % 8 != 0, or not 16-byte aligned).
``forward_kernel`` picks one on the host from M, G, N and the weights'
address, never from the group sizes; each counts its own launches. The
decode kernel streams the touched experts' weights evenly over the card:
items (expert, 16-row pass, 128-column panel) walked by a persistent grid
that :func:`decode_grid` sizes from the shapes alone.

The function is a ``torch.autograd.Function`` whose backward is megablox's
``_gmm_bwd`` (jax 0.9.0 ``megablox/ops.py:63-105``): the f32 cotangent dY
is rounded once to the operands' dtype (as ``qwen2._MmF32``'s backward
rounds it), then

- dX = dY @ w_gᵀ over the same row groups, in xs' dtype
  (``gmm(grad, rhs, transpose_rhs=True)``); rows past the groups get 0;
- dW_g = xs_gᵀ @ dY_g, in w's dtype (``tgmm``); an expert without rows
  gets exact zeros.

On CUDA these are two wgmma kernels of the same source (``grouped_gemm_dx``,
the forward's wgmma kernel reading rows of w_g, and ``grouped_gemm_tgmm``),
the group sizes again never leaving the device; they take N a multiple of 8
too.

A CPU tensor takes the plain versions, per-expert loops of f32 matmuls over
the row groups (they read the sizes to the host). A CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["decode_grid", "forward_kernel", "grouped_gemm", "grouped_gemm_dx_plain",
           "grouped_gemm_plain", "grouped_gemm_tgmm_plain"]

GMAX = 1024  # most groups the kernel's shared prefix sums hold (csrc GMAX)
# the wgmma forward takes over from the decode kernel at this many rows an
# expert on average (M >= WG_MIN_ROWS · G). bench_k8's dispatch sweep
# (NVIDIA H100 80GB HBM3, 700 W, CUDA-graph replays) read the wgmma kernel
# at 1.140x / 1.109x / 1.015x / 0.994x / 0.927x the decode kernel's time at
# 2 / 4 / 8 / 12 / 16 rows an expert on Qwen1.5-MoE's 2048 -> 1408, and at
# 1.261x / 1.195x / 1.111x / 1.031x / 0.933x on GPT-OSS's 2880 -> 5760: the
# narrow experts cross between 8 and 12 rows, the wide ones between 12 and
# 16; below 12 the decode kernel is the faster for both
WG_MIN_ROWS = 12

# the decode kernel (csrc DPW, DXR, DCTAS)
DECODE_COLS = 128        # columns of a panel: two 64-column TMA boxes
DECODE_ROWS = 16         # rows of a pass: two n8 blocks
DECODE_CTAS_PER_SM = 3   # the kernel's launch bound; its shared memory allows it at any G


def decode_grid(M: int, G: int, N: int, sms: int) -> int:
    """The decode kernel's CTAs for xs (M, K) and w (G, K, N) on a card of
    ``sms`` SMs, from the shapes alone (the group sizes stay on the
    device): DECODE_CTAS_PER_SM an SM, no more than the items (expert,
    16-row pass, panel) there can be. ``bench_k8.py --decode --sweep``
    (NVIDIA H100 80GB HBM3, 700 W, 14 decode rows: the six served at 24
    tokens and the rollout's 8 and 16 sequences of Qwen1.5-MoE and
    DeepSeek-V2-Lite) read 128 columns, 3 stages and 3 CTAs an SM within
    0.7% of the best of 16 plans summed over the rows, with the smallest
    worst case (8.8% over a row's best). An in-dim split over 2 or 4 CTAs
    of a cluster, merged in distributed shared memory, was timed by the
    same sweep before it was taken out: it won at none of the 14 rows."""
    if min(M, G, N, sms) <= 0:
        raise ValueError(f"decode_grid: no grid for M={M} G={G} N={N} on {sms} SMs")
    most = (min(G, M) + M // DECODE_ROWS) * -(-N // DECODE_COLS)  # items at most
    return min(sms * DECODE_CTAS_PER_SM, most)


def forward_kernel(M: int, G: int, N: int, w_ptr: int) -> str:
    """The forward kernel for xs (M, K) and w (G, K, N) at address
    ``w_ptr``: "grouped_gemm_wg" (wgmma, 128-row tiles) where the experts
    get WG_MIN_ROWS rows or more on average and TMA can read the weights
    (rows of N a multiple of 8, 16-byte aligned), else "grouped_gemm" (the
    decode kernel). Every input is known on the host."""
    if N % 8 == 0 and w_ptr % 16 == 0 and M >= WG_MIN_ROWS * G:
        return "grouped_gemm_wg"
    return "grouped_gemm"


def grouped_gemm_plain(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """xs (M, K) @ w (G, K, N) over the row groups, one f32 matmul per
    expert; rows past the groups are 0. -> (M, N) f32."""
    out = torch.zeros((xs.shape[0], w.shape[-1]), dtype=torch.float32, device=xs.device)
    for g, start, end in _groups(group_sizes, xs.shape[0]):
        out[start:end] = xs[start:end].float() @ w[g].float()
    return out


def _groups(group_sizes: torch.Tensor, M: int):
    """(g, start, end) of each non-empty group, clipped at M rows."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), M)
        if end > start:
            yield g, start, end
        start = end


def grouped_gemm_dx_plain(dy: torch.Tensor, w: torch.Tensor,
                          group_sizes: torch.Tensor) -> torch.Tensor:
    """dX = dy (M, N) @ w_gᵀ (N, K) over the row groups, one f32 matmul per
    expert; rows past the groups are 0. -> (M, K) in dy's dtype."""
    out = torch.zeros((dy.shape[0], w.shape[1]), dtype=torch.float32, device=dy.device)
    for g, start, end in _groups(group_sizes, dy.shape[0]):
        out[start:end] = dy[start:end].float() @ w[g].float().T
    return out.to(dy.dtype)


def grouped_gemm_tgmm_plain(xs: torch.Tensor, dy: torch.Tensor,
                            group_sizes: torch.Tensor) -> torch.Tensor:
    """dW_g = xs_gᵀ (K, m_g) @ dy_g (m_g, N) per expert, one f32 matmul
    each; an expert without rows gets zeros. -> (G, K, N) in xs' dtype."""
    G = group_sizes.shape[0]
    out = torch.zeros((G, xs.shape[1], dy.shape[1]), dtype=torch.float32, device=xs.device)
    for g, start, end in _groups(group_sizes, xs.shape[0]):
        out[g] = xs[start:end].float().T @ dy[start:end].float()
    return out.to(xs.dtype)


def _check_shapes(xs, w, group_sizes) -> None:
    name = "grouped_gemm"
    _cuda.require(xs.dim() == 2 and w.dim() == 3 and group_sizes.dim() == 1, name,
                  f"xs {tuple(xs.shape)}, w {tuple(w.shape)}, group_sizes "
                  f"{tuple(group_sizes.shape)}")
    _cuda.require(w.shape[1] == xs.shape[1] and group_sizes.shape[0] == w.shape[0], name,
                  f"xs {tuple(xs.shape)} vs w {tuple(w.shape)}, group_sizes "
                  f"{tuple(group_sizes.shape)}")


def _grouped_gemm_cuda(xs, w, group_sizes):
    name = "grouped_gemm"
    dev = xs.device
    M, K = xs.shape
    G, _, N = w.shape
    _cuda.require(K % 8 == 0, name, f"K = {K} (the kernel takes K a multiple of 8)")
    _cuda.require(1 <= G <= GMAX, name, f"{G} groups (the kernel takes 1..{GMAX})")
    _cuda.require_cuda_bf16(name, dev, xs=xs)
    # weight rows are read with 16-byte copies only where they are aligned
    _cuda.require_cuda(name, dev, torch.bfloat16, aligned=False, w=w)
    gs = _cuda.int32_on(group_sizes, dev, (G,))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    kernel = forward_kernel(M, G, N, w.data_ptr())
    wide = kernel == "grouped_gemm_wg"
    # the decode kernel's grid (the wgmma kernel sizes its own)
    grid = 0 if wide else decode_grid(M, G, N, _cuda.sm_count(dev))
    err = _cuda.lib().lapha_grouped_gemm(xs.data_ptr(), w.data_ptr(), gs.data_ptr(),
                                         out.data_ptr(), M, K, N, G, int(wide), grid,
                                         _cuda.stream_of(xs))
    _cuda.check_launch(err, kernel)
    _cuda.LAUNCHES[kernel] += 1
    return out


def _bwd_args(name, dy, other, group_sizes):
    """Checks the backward kernels' operands; the group sizes as int32 on the device."""
    dev = dy.device
    M, N = dy.shape
    G = group_sizes.shape[0]
    _cuda.require(N % 8 == 0, name, f"N = {N} (the backward kernels take N a multiple of 8)")
    _cuda.require(1 <= G <= GMAX, name, f"{G} groups (the kernel takes 1..{GMAX})")
    _cuda.require_cuda_bf16(name, dev, dy=dy, other=other)
    return _cuda.int32_on(group_sizes, dev, (G,))


def grouped_gemm_dx_cuda(dy, w, group_sizes):
    """The dX kernel (csrc/grouped_gemm.cu): dy (M, N) bf16, w (G, K, N) bf16
    -> (M, K) bf16; arguments as the plain version's."""
    name = "grouped_gemm_dx"
    M, N = dy.shape
    G, K, _ = w.shape
    _cuda.require(K % 8 == 0, name, f"K = {K} (the kernel takes K a multiple of 8)")
    gs = _bwd_args(name, dy, w, group_sizes)
    dx = torch.empty((M, K), dtype=dy.dtype, device=dy.device)
    if M == 0:
        return dx
    err = _cuda.lib().lapha_grouped_gemm_dx(dy.data_ptr(), w.data_ptr(), gs.data_ptr(),
                                            dx.data_ptr(), M, K, N, G, _cuda.stream_of(dy))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return dx


def grouped_gemm_tgmm_cuda(xs, dy, group_sizes, out=None):
    """The dW kernel (csrc/grouped_gemm.cu): xs (M, K) bf16, dy (M, N) bf16 ->
    (G, K, N) bf16, written into ``out`` when given (every element is
    written: an expert without rows gets zeros)."""
    name = "grouped_gemm_tgmm"
    M, K = xs.shape
    N = dy.shape[1]
    G = group_sizes.shape[0]
    _cuda.require(K % 8 == 0, name, f"K = {K} (the kernel takes K a multiple of 8)")
    _cuda.require(dy.shape[0] == M, name, f"xs {tuple(xs.shape)} vs dy {tuple(dy.shape)}")
    gs = _bwd_args(name, dy, xs, group_sizes)
    if out is None:
        out = torch.empty((G, K, N), dtype=xs.dtype, device=xs.device)
    _cuda.require(tuple(out.shape) == (G, K, N), name, f"out {tuple(out.shape)}")
    _cuda.require_cuda_bf16(name, xs.device, out=out)
    if M == 0:
        return out.zero_()
    err = _cuda.lib().lapha_grouped_gemm_tgmm(xs.data_ptr(), dy.data_ptr(), gs.data_ptr(),
                                              out.data_ptr(), M, K, N, G, _cuda.stream_of(xs))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


class _GroupedGemm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w, group_sizes):
        ctx.save_for_backward(xs, w, group_sizes)
        if xs.device.type == "cuda":
            return _grouped_gemm_cuda(xs, w, group_sizes)
        return grouped_gemm_plain(xs, w, group_sizes)

    @staticmethod
    def backward(ctx, dout):
        xs, w, group_sizes = ctx.saved_tensors
        dy = dout.to(xs.dtype).contiguous()  # rounded once, as _MmF32's backward
        cuda = xs.device.type == "cuda"
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (grouped_gemm_dx_cuda if cuda else grouped_gemm_dx_plain)(dy, w, group_sizes)
        if ctx.needs_input_grad[1]:
            dw = (grouped_gemm_tgmm_cuda if cuda else grouped_gemm_tgmm_plain)(
                xs, dy, group_sizes).to(w.dtype)
        return dx, dw, None


def grouped_gemm(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """xs (M, K) @ w (G, K, N) with rows [off_g, off_g + group_sizes[g])
    hitting expert g -> (M, N) f32. ``group_sizes`` (G,) integer, on the
    tensors' device."""
    _check_shapes(xs, w, group_sizes)
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_gemm: no kernel for device {xs.device}")
    return _GroupedGemm.apply(xs, w, group_sizes)
