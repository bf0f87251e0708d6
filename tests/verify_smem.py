"""A model of the verify kernel's shared memory a CTA (its ``Layout`` in
``lapha_tpu_torch/csrc/spec_verify_attention.cuh``), which the plan tests of
the verify attention and of block diffusion's block attention (the same
kernel) size their plans by on the CPU, and a stand-in for the kernel
library that records the C entries the wrappers call."""

import math

PIECE, WARPS = 16, 4    # the kernel's piece of a warp and warps of a CTA


def _r16(x: int) -> int:
    return (x + 15) // 16 * 16


def kernel_smem(dh: int, int8: bool, rows: int, S: int, stages: int, splits: int) -> int:
    """A model of the kernel's shared memory a CTA (its ``Layout``, counted
    on the card by ``lapha_spec_verify_smem``): the Q tile of ``rows`` rows
    (bf16, padded by 16 bytes) and their four ints, the merge's tail, the
    inbox with more than one split, a region that holds the list build's
    scratch (3 ints a 32-column word), the 4 warps' rings of ``stages``
    16-column K and V pieces (padded rows; int8 with 32 scales) or the
    merge's accumulators, whichever is largest, and the share's list of
    ceil(S / splits) columns and their positions."""
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    row = dh + 16 if int8 else 2 * dh + 16
    stage = 2 * PIECE * row + (2 * PIECE * 4 if int8 else 0)
    words = math.ceil(S / 32)
    region = max(WARPS * stages * stage, WARPS * rows * (dh + 4) * 4, _r16((3 * words + 1) * 4))
    head = (rows * (2 * dh + 16) + 16 * rows + (3 * WARPS + 2 + sva.MAX_SPLITS) * rows * 4
            + ((2 * sva.MAX_SPLITS * rows + rows * dh + sva.MAX_SPLITS) * 4 if splits > 1 else 0))
    return head + region + 2 * _r16(4 * math.ceil(S / splits))


class FakeLib:
    """Records the C entry called and its arguments; returns cudaSuccess.
    Its shared-memory count is the kernel's layout as :func:`kernel_smem`
    models it."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        if entry == "lapha_spec_verify_smem":
            return kernel_smem
        return lambda *args: self.calls.append((entry, args)) or 0
