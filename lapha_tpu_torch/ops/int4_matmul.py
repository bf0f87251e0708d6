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
group products on the tensor cores. Its grid comes from :func:`split_plan`:
the column tile and how many ranges of group pairs the in-dim is split
into, so that the decode shapes fill the card; a tile's splits run as one
thread-block cluster and add their partial sums in split order
(deterministic, no atomics, no workspace).

``layer`` picks one layer of stacked (L, IN/2, OUT) weights. The JAX wrapper
moves that pick into the kernel's block DMA to avoid an XLA copy; a torch
``packed[layer]`` is already a zero-copy contiguous view, so it is taken
here and the argument only keeps the JAX signature.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _cuda

__all__ = ["Plan", "int4_matmul", "int4_matmul_plain", "split_plan", "split_pairs"]

COLUMN_TILES = (64, 32, 16)  # the kernel's column tiles, widest first
MAX_SPLITS = 8  # a tile's splits are one thread-block cluster: at most 8 CTAs (portable)


class Plan(NamedTuple):
    rows: int    # rows of x a CTA takes: 16, 32, 48 or 64
    cols: int    # output columns a CTA takes: 64, 32 or 16
    splits: int  # ranges of group pairs the in-dim is split into

    def ctas(self, B: int, OUT: int) -> int:
        return math.ceil(B / self.rows) * math.ceil(OUT / self.cols) * self.splits


def split_plan(B: int, IN: int, OUT: int, G: int, sms: int) -> Plan:
    """The kernel's grid for x (B, IN) at group G on a card of ``sms`` SMs:
    (ceil(OUT / cols), ceil(B / rows), splits). The first plan that gives a
    CTA an SM, trying 64-, 32- and 16-column tiles at B's row tile (B rounded
    up to 16, at most 64), then at 16 rows: the tiles alone, or times
    min(8, IN / (2G), ceil(2·sms / tiles)) splits (a group pair each at
    least); else the one with the most CTAs. Measured on an H100 (PERF.md
    §6): wide tiles beat more, narrower CTAs (48 x 8960 -> 1536: 64 columns
    x 8 splits, 192 CTAs, 17.1 us; 32 x 8, 384 CTAs, 24.9 us)."""
    pairs = min(IN // (2 * G), MAX_SPLITS)
    best = None
    for rows in (16 * min(4, math.ceil(B / 16)), 16):
        for cols in COLUMN_TILES:
            tiles = Plan(rows, cols, 1).ctas(B, OUT)
            plan = Plan(rows, cols, 1 if tiles >= sms else min(pairs, math.ceil(2 * sms / tiles)))
            if plan.ctas(B, OUT) >= sms:
                return plan
            if best is None or plan.ctas(B, OUT) > best.ctas(B, OUT):
                best = plan
    return best


def split_pairs(pairs: int, splits: int) -> list[tuple[int, int]]:
    """The group pairs [p0, p1) of each split, in split order, as the kernel
    takes them: split s covers [s·pairs // splits, (s+1)·pairs // splits)."""
    return [(s * pairs // splits, (s + 1) * pairs // splits) for s in range(splits)]



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
        B, IN, OUT, G, *split_plan(B, IN, OUT, G, _cuda.sm_count(dev)), _cuda.stream_of(xb))
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
