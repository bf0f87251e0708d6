"""Packed-int4 dequant-matmul (W4A16) — Hopper kernel + plain version.

Port of ``lapha_tpu/ops/int4_matmul.py`` (version 3, ``_int4_mm_kernel_v3``;
version 2 computes the same function). With ``u`` the stored offset-binary
nibbles (``u = v + 8``, ``models/quant.py`` split-half packing) and ``s_g``
the scale row of in-dim group g:

    out = Σ_g (x_g · u_g − 8 · rowsum(x_g)) · s_g

x is rounded to bf16 first (the JAX kernel feeds the MXU bf16 whatever the
caller's dtype), the products and sums are f32, and the result is
(B, OUT) f32. The CUDA kernel (``csrc/int4_matmul.cu``) reads the packed
bytes and the scale rows once, unpacks the nibbles in registers and runs the
group products on the tensor cores.

``layer`` picks one layer of stacked (L, IN/2, OUT) weights. The JAX wrapper
moves that pick into the kernel's block DMA to avoid an XLA copy; a torch
``packed[layer]`` is already a zero-copy contiguous view, so it is taken
here and the argument only keeps the JAX signature.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["int4_matmul", "int4_matmul_plain"]


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The v3 formula in f32 torch ops: x (B, IN), packed (IN/2, OUT) uint8,
    scales (IN/G, OUT) f32 -> (B, OUT) f32."""
    B, IN = x.shape
    ng, OUT = scales.shape
    G = IN // ng
    xb = x.to(torch.bfloat16).float().reshape(B, ng, G)
    u = torch.cat([packed & 15, packed >> 4], dim=0).float().reshape(ng, G, OUT)
    pg = torch.einsum("bgi,gio->bgo", xb, u)
    corr = pg - 8.0 * xb.sum(-1)[..., None]
    return (corr * scales.float()[None]).sum(1)


def _check_shapes(x, packed, scales) -> None:
    name = "int4_matmul"
    _cuda.require(x.dim() == 2 and packed.dim() == 2 and scales.dim() == 2, name,
                  f"x {tuple(x.shape)}, packed {tuple(packed.shape)}, scales {tuple(scales.shape)}")
    B, IN = x.shape
    half, OUT = packed.shape
    ng = scales.shape[0]
    _cuda.require(2 * half == IN and scales.shape[1] == OUT and ng > 0 and IN % ng == 0,
                  name, f"x {tuple(x.shape)} vs packed {tuple(packed.shape)}, scales "
                  f"{tuple(scales.shape)}")
    _cuda.require(half % (IN // ng) == 0, name, f"group {IN // ng} does not split IN/2 = {half}")


def _int4_cuda(x, packed, scales):
    name = "int4_matmul"
    dev = x.device
    B, IN = x.shape
    half, OUT = packed.shape
    ng = scales.shape[0]
    G = IN // ng
    _cuda.require(G % 16 == 0 and G <= 128, name, f"group {G} (the kernel takes 16..128 in steps of 16)")
    xb = x.to(torch.bfloat16).contiguous()
    _cuda.require_cuda_bf16(name, dev, x=xb)
    # packed rows are read with 16-byte loads only where they are aligned
    _cuda.require_cuda(name, dev, torch.uint8, aligned=False, packed=packed)
    _cuda.require_cuda(name, dev, torch.float32, aligned=False, scales=scales)
    out = torch.empty((B, OUT), dtype=torch.float32, device=dev)
    err = _cuda.lib().lapha_int4_matmul(
        xb.data_ptr(), packed.data_ptr(), scales.data_ptr(), out.data_ptr(),
        B, IN, OUT, G, _cuda.stream_of(xb))
    _cuda.check_launch(err, name)
    _cuda.LAUNCHES[name] += 1
    return out


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
                layer: int | None = None) -> torch.Tensor:
    """x (B, IN) @ unpack(packed, scales) -> (B, OUT) f32. ``packed``
    (IN/2, OUT) uint8 and ``scales`` (IN/G, OUT) f32, or stacked with a
    leading layer axis and ``layer`` set."""
    if layer is not None:
        packed, scales = packed[layer], scales[layer]
    _check_shapes(x, packed, scales)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales)
    if x.device.type == "cuda":
        return _int4_cuda(x, packed, scales)
    raise ValueError(f"int4_matmul: no kernel for device {x.device}")
