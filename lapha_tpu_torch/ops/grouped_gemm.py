"""Grouped GEMM over contiguous expert row groups — Hopper kernel + plain version.

Port of ``lapha_tpu/ops/moe.py`` ``_grouped_gemm`` (:290; ``megablox.gmm``
on the TPU, ``jax.lax.ragged_dot`` elsewhere), the product behind every MoE
layer: xs (M, K) @ w (G, K, N), rows ``[off_g, off_g + group_sizes[g])``
hitting expert g, with ``off_g`` the exclusive prefix sum of the sizes.
The result is (M, N) f32 (JAX's ``preferred_element_type=float32``); rows
past ``sum(group_sizes)`` are 0, as ragged_dot gives.

The CUDA kernel (``csrc/grouped_gemm.cu``) keeps the group sizes on the
device: every block finds its (expert, row tile) from their prefix sums, so
the MoE layer never waits on the host. It takes bf16 xs and w and K a
multiple of 8.

A CPU tensor takes the plain version, a per-expert loop of f32 matmuls over
the row groups (it reads the sizes to the host). A CUDA tensor launches the
kernel or raises. The function is a ``torch.autograd.Function``: on the CPU
its backward is the plain version's autograd; on CUDA the backward is not
ported yet and raises (ROADMAP B2), so no gradient is ever silently missing.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["grouped_gemm", "grouped_gemm_plain"]

GMAX = 1024  # most groups the kernel's shared prefix sums hold (csrc GMAX)


def grouped_gemm_plain(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """xs (M, K) @ w (G, K, N) over the row groups, one f32 matmul per
    expert; rows past the groups are 0. -> (M, N) f32."""
    M = xs.shape[0]
    out = torch.zeros((M, w.shape[-1]), dtype=torch.float32, device=xs.device)
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), M)
        if end > start:
            out[start:end] = xs[start:end].float() @ w[g].float()
        start = end
    return out


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
    err = _cuda.lib().lapha_grouped_gemm(xs.data_ptr(), w.data_ptr(), gs.data_ptr(),
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
        if xs.device.type == "cuda":
            raise NotImplementedError(
                "grouped_gemm backward on CUDA is not ported yet (ROADMAP B2: dX is K8 on "
                "the transposed weights, dW a transposed grouped GEMM); MoE training on the "
                "card waits for it")
        need = ctx.needs_input_grad[:2]
        leaves = [t.detach().requires_grad_(n) for t, n in zip((xs, w), need)]
        with torch.enable_grad():
            out = grouped_gemm_plain(leaves[0], leaves[1], group_sizes)
            grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dout)
        grads = iter(grads)
        return (*(next(grads) if n else None for n in need), None)


def grouped_gemm(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """xs (M, K) @ w (G, K, N) with rows [off_g, off_g + group_sizes[g])
    hitting expert g -> (M, N) f32. ``group_sizes`` (G,) integer, on the
    tensors' device."""
    _check_shapes(xs, w, group_sizes)
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_gemm: no kernel for device {xs.device}")
    return _GroupedGemm.apply(xs, w, group_sizes)
