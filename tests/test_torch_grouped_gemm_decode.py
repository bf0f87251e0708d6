"""The grouped GEMM's decode kernel (K8 at a few rows an expert), on the CPU.

Three things: the host's grid (``ops/grouped_gemm.decode_grid``) at the
decode shapes of the MoE models the repo serves and the constants it
shares with the kernel's source, the kernel's arithmetic (each group's
product in f32, rows past the groups 0) at decode-shaped group sizes, and
the wrapper's host path down to the C entry's arguments through a recorded
stand-in library.

The arithmetic, ``grouped_gemm_plain``, is held against JAX's
``lapha_tpu.ops.moe._grouped_gemm`` (``jax.lax.ragged_dot`` off the TPU) on
the same numpy inputs, rounded to bf16 first as the kernel takes them:
rtol/atol 1e-5 in f32, the same exact products summed in another order.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.ops.moe import _grouped_gemm as j_grouped_gemm
from lapha_tpu_torch.ops import grouped_gemm as gg

TOL = dict(rtol=1e-5, atol=1e-5)
SMS = 132  # an H100 SXM's SMs

# (model, projection, rows = decode tokens x top-k, experts, K, N): the
# expert products of the MoE models chip_smoke.py serves at full width
# (Qwen1.5-MoE-A2.7B, GPT-OSS-20B, DeepSeek-V2-Lite) at 24 tokens, and the
# rollout's 8 sequences and bench.py's 48 rows
DECODE_SHAPES = [
    ("Qwen1.5-MoE", "gate/up", 96, 60, 2048, 1408),
    ("Qwen1.5-MoE", "down", 96, 60, 1408, 2048),
    ("GPT-OSS-20B", "gate_up", 96, 32, 2880, 5760),
    ("GPT-OSS-20B", "down", 96, 32, 2880, 2880),
    ("DeepSeek-V2-Lite", "gate/up", 144, 64, 2048, 1408),
    ("DeepSeek-V2-Lite", "down", 144, 64, 1408, 2048),
    ("Qwen1.5-MoE", "gate/up, rollout", 32, 60, 2048, 1408),
    ("DeepSeek-V2-Lite", "down at 48 rows", 288, 64, 1408, 2048),
]


# ---------------------------------------------------------------- the grid

@pytest.mark.parametrize("model,proj,M,G,K,N", DECODE_SHAPES)
def test_decode_grid_at_the_served_shapes(model, proj, M, G, K, N):
    """At most DECODE_CTAS_PER_SM CTAs an SM, and no fewer CTAs than the
    items that uniform routing gives (about G·(1 − (1 − 1/G)^M) touched
    experts x their panels) unless every SM has its CTAs; the same grid for
    the same shape."""
    grid = gg.decode_grid(M, G, N, SMS)
    full = SMS * gg.DECODE_CTAS_PER_SM
    items = G * (1 - (1 - 1 / G) ** M) * -(-N // gg.DECODE_COLS)
    assert 1 <= grid <= full and (grid == full or grid >= items)
    assert grid == gg.decode_grid(M, G, N, SMS)


@pytest.mark.parametrize("M,G,N,grid", [
    (8, 16, 128, 8),        # 8 rows: at most 8 experts x one panel
    (8, 16, 64, 8),         # a panel wider than N
    (8, 4, 1408, 4 * 11),   # 4 experts x 11 panels
    (40, 2, 200, 2 * 2 + 2 * 2),  # an expert past 16 rows: a pass more a panel
    (6, 1024, 5760, 6 * 45),      # GMAX experts, 6 with rows at most
    (4096, 16, 1404, 396),  # N % 8 != 0 at prefill: the card's CTAs
])
def test_decode_grid_small_shapes(M, G, N, grid):
    assert gg.decode_grid(M, G, N, SMS) == grid


def test_decode_grid_refuses_empty_shapes():
    with pytest.raises(ValueError, match="decode_grid"):
        gg.decode_grid(0, 60, 1408, SMS)


def test_decode_constants_match_the_source():
    """The host's panel width, pass rows, CTAs an SM and GMAX are the
    kernel's (csrc DPW, DXR, DCTAS, GMAX), and its shared memory (1024 bytes
    of alignment, DSTAGES stages of DPW/64 weight boxes of 64 x 128 bytes
    and a 16-row x box of 128-byte rows, the ring's barriers, the prefix
    sums) lets DCTAS CTAs share an SM at GMAX groups."""
    src = os.path.join(os.path.dirname(gg.__file__), "..", "csrc", "grouped_gemm.cu")
    with open(src) as f:
        text = f.read()
    c = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", text)}
    assert (c["DPW"], c["DXR"], c["DCTAS"], c["GMAX"]) == (
        gg.DECODE_COLS, gg.DECODE_ROWS, gg.DECODE_CTAS_PER_SM, gg.GMAX)
    stage = c["DPW"] // 64 * c["DCK"] * 128 + c["DXR"] * 128
    smem = 1024 + c["DSTAGES"] * stage + 16 * c["DSTAGES"] + 8 * (c["GMAX"] + 1)
    assert smem <= 227 * 1024 and c["DCTAS"] * (smem + 1024) <= 228 * 1024


# ---------------------------------------------------------------- the arithmetic

# decode-shaped group sizes: 1-8 rows an expert with empty experts between,
# one expert with every row, rows past the groups, an expert past 16 rows
GROUPS = [
    ((2, 0, 1, 8, 0, 0, 3, 5, 7, 0, 1, 4), None),
    ((0, 0, 0, 23, 0, 0), None),
    ((3, 0, 6, 1, 0, 2), 20),
    ((17, 2, 0, 40, 1), None),
]


def _case(rng, sizes, M, K, N):
    G = len(sizes)
    M = sum(sizes) if M is None else M
    xs = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(G, K, N)) / np.sqrt(K)).astype(np.float32)
    # rounded to bf16 as the kernel takes them
    xs = torch.from_numpy(xs).to(torch.bfloat16).float().numpy()
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    return xs, w, np.asarray(sizes, np.int32)


@pytest.mark.parametrize("sizes,M", GROUPS)
@pytest.mark.parametrize("K,N", [
    (200, 48),   # K % 16 == 8: the last stage ends half-way through a k16 step
    (64, 136),   # one stage; N past one panel by 8 columns
    (136, 256),  # a stage and 8 rows; two whole panels
])
def test_decode_arithmetic_matches_jax(sizes, M, K, N):
    xs, w, gs = _case(np.random.default_rng(len(sizes) + K + N), sizes, M, K, N)
    got = gg.grouped_gemm_plain(torch.from_numpy(xs), torch.from_numpy(w), torch.from_numpy(gs))
    jref = np.asarray(j_grouped_gemm(jnp.asarray(xs), jnp.asarray(w), jnp.asarray(gs)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (xs.shape[0], N)
    np.testing.assert_allclose(got.numpy(), jref, **TOL)
    assert not got[int(gs.sum()):].any()  # rows past the groups are 0


# ---------------------------------------------------------------- the wrapper's host path


class _FakeLib:
    """Records the C entry called and its arguments; returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("M,G,K,N,kernel", [
    (96, 60, 2048, 1408, "grouped_gemm"),      # Qwen1.5-MoE's decode gate/up
    (96, 32, 2880, 5760, "grouped_gemm"),      # GPT-OSS-20B's decode gate_up
    (8192, 60, 2048, 1408, "grouped_gemm_wg"),  # prefill: the wgmma kernel, no grid
    (64, 4, 32, 36, "grouped_gemm"),           # N % 8 != 0 at 16 rows an expert
])
def test_wrapper_passes_the_grid_to_its_entry(monkeypatch, M, G, K, N, kernel):
    """The CUDA path up to the C call, on CPU tensors with the device checks
    stubbed: ``lapha_grouped_gemm`` is called once with M K N G, the kernel
    flag and the decode grid (0 for the wgmma kernel), then the stream;
    counted once under the kernel's name; the group sizes stay a tensor
    (nothing is read back)."""
    from lapha_tpu_torch.ops import _cuda

    fake = _FakeLib()
    for stub in ("require_cuda_bf16", "require_cuda"):
        monkeypatch.setattr(_cuda, stub, lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 7)
    monkeypatch.setattr(_cuda, "int32_on", lambda t, dev, shape: t)
    xs = torch.zeros(M, K, dtype=torch.bfloat16)
    w = torch.zeros(G, K, N, dtype=torch.bfloat16)
    gs = torch.full((G,), M // G, dtype=torch.int32)
    assert gg.forward_kernel(M, G, N, w.data_ptr()) == kernel
    before = dict(_cuda.LAUNCHES)
    out = gg._grouped_gemm_cuda(xs, w, gs)
    assert out.shape == (M, N) and out.dtype == torch.float32
    (entry, args), = fake.calls
    assert entry == "lapha_grouped_gemm"
    assert args[:4] == (xs.data_ptr(), w.data_ptr(), gs.data_ptr(), out.data_ptr())
    grid = 0 if kernel == "grouped_gemm_wg" else gg.decode_grid(M, G, N, SMS)
    assert args[4:] == (M, K, N, G, int(kernel == "grouped_gemm_wg"), grid, 7)
    assert {k: v - before[k] for k, v in _cuda.LAUNCHES.items() if v != before[k]} == {kernel: 1}
