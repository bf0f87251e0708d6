"""The port's CUDA kernels against their plain PyTorch versions (needs a GPU).

Every test here is marked ``cuda`` and skips without a card. The file
imports no jax, so on the card it runs without the repo's conftest:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: the kernel takes bf16 inputs and writes bf16; the plain version
gets the same bf16 inputs, computes in f32 and is compared in f32. Outputs
are weighted averages of N(0,1) values (|v| <= ~5); the kernel rounds P to
bf16 before P·V and the result to bf16, each at most 2^-9 of max|v|:
max |diff| <= 3e-2, LSE to 1e-3.
"""

import numpy as np
import pytest
import torch

from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import flash_attention as fa
from lapha_tpu_torch.ops import ragged_decode_attention as rda

ATOL = 3e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)


def _flash_pair(q, k, v, kv_valid, qstart, name):
    B = q.shape[0]
    qstart = torch.as_tensor(qstart, device=q.device).reshape(-1).expand(B)
    scale = q.shape[-1] ** -0.5
    out, lse = fa._attention_cuda(q, k, v, kv_valid, qstart, scale, name)
    ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qstart, scale)
    torch.cuda.synchronize()
    return out.float(), ref.float(), lse, ref_lse


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,qstart,lens", [
    (4, 512, 640, 0, (512, 300, 450, 7)),      # engine prefill, ragged prompts
    (4, 64, 768, 512, (576, 576, 576, 576)),   # prefix-hit suffix prefill
    (2, 37, 100, (30, 5), None),               # ragged tile edges, per-row qstart, a hole
])
def test_flash_cached_kernel_matches_plain(dev, B, T, S, qstart, lens):
    rng = np.random.default_rng(T)
    nh, nkv, dh = 12, 2, 128
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, S, nkv, dh), dev), _bf16(rng, (B, S, nkv, dh), dev)
    ar = torch.arange(S, device=dev)[None, :]
    if lens is None:
        qs = torch.as_tensor(qstart, device=dev).reshape(-1, 1)
        kv_valid = (ar < qs + T).to(torch.int32)
        kv_valid[:, 12:20] = 0
    else:
        kv_valid = (ar < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)
    before = _cuda.LAUNCHES["flash_attention_cached"]
    out, ref, lse, ref_lse = _flash_pair(q, k, v, kv_valid, qstart, "flash_attention_cached")
    assert _cuda.LAUNCHES["flash_attention_cached"] == before + 1
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATOL
    seen = ref_lse > -1e29
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= 1e-3
    assert (lse[~seen] == -1e30).all() and (out.permute(0, 2, 1, 3)[~seen] == 0).all()


@pytest.mark.cuda
def test_flash_kernel_matches_plain_with_padding(dev):
    """No-cache causal forward (value forward), right- and left-padded rows;
    left padding leaves query rows that see no key (written as 0)."""
    rng = np.random.default_rng(1)
    B, T, nh, nkv, dh = 4, 512, 12, 2, 128
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, 400:] = 0
    mask[2, :100] = 0
    before = _cuda.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, mask).float()
    ref = fa.attention_plain(q, k, v, mask, torch.zeros(B, dtype=torch.int32, device=dev),
                             dh ** -0.5)[0].float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention"] == before + 1
    assert (out - ref).abs().max().item() <= ATOL
    assert (out[2, :100] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("pstart", [False, True])
def test_ragged_kernel_matches_plain(dev, pstart):
    rng = np.random.default_rng(2)
    L, B, nkv, S, nh, dh = 3, 24, 2, 640, 12, 128
    q = _bf16(rng, (B, nh, dh), dev)
    kc, vc = _bf16(rng, (L, B, nkv, S, dh), dev), _bf16(rng, (L, B, nkv, S, dh), dev)
    lens = torch.from_numpy(rng.integers(1, 513, B).astype(np.int32)).to(dev)
    dstart = torch.full((B,), 517, dtype=torch.int32, device=dev)  # not chunk-aligned
    dstart[:3] = lens[:3]  # decode starts right after the prompt: shared chunk
    ps = torch.minimum(lens, torch.full_like(lens, 40)) if pstart else None
    for layer, slot in ((0, 517), (2, 600)):
        before = _cuda.LAUNCHES["ragged_decode_attention"]
        out = rda.ragged_decode_attention(q, kc, vc, layer, lens, dstart, slot, ps).float()
        ref = rda.ragged_decode_plain(q, kc, vc, layer, lens, dstart, slot, ps).float()
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["ragged_decode_attention"] == before + 1
        assert (out - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 8, 12, 128), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :, :2], q[:, :, :2])  # f32, not bf16
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(qb[..., :64].contiguous(), qb[:, :, :2, :64].contiguous(),
                           qb[:, :, :2, :64].contiguous())  # head dim 64
    c = torch.zeros((1, 1, 2, 16, 128), dtype=torch.bfloat16, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        rda.ragged_decode_attention(qb[:, 0], c, c, 0, lens, lens, 16)  # slot past S


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(8, 8), (28, 4), (16, 2)])
@pytest.mark.parametrize("T,S", [(1, 1), (65, 130), (200, 333)])
def test_flash_kernel_shapes_and_groups(dev, nh, nkv, T, S):
    """GQA groups 1..8, a single query and key, tiles cut at both edges,
    per-row query offsets (including one past every key) and a
    non-causal call."""
    rng = np.random.default_rng(nh * 1000 + T)
    B, dh = 3, 128
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, S, nkv, dh), dev), _bf16(rng, (B, S, nkv, dh), dev)
    kv_valid = torch.from_numpy((rng.uniform(size=(B, S)) < 0.8).astype(np.int32)).to(dev)
    kv_valid[:, 0] = 1
    qstart = (0, max(S - T, 0), S)
    out, ref, _, _ = _flash_pair(q, k, v, kv_valid, qstart, "flash_attention_cached")
    assert (out - ref).abs().max().item() <= ATOL
    if T == S:
        o_nc = fa.flash_attention(q, k, v, kv_valid, causal=False).float()
        r_nc = fa.attention_plain(q, k, v, kv_valid, torch.full((B,), T, device=dev), dh ** -0.5)[0]
        torch.cuda.synchronize()
        assert (o_nc - r_nc.float()).abs().max().item() <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(8, 8), (32, 4), (14, 2)])
def test_ragged_kernel_groups_and_edges(dev, nh, nkv):
    """GQA groups 1, 8 and 7; one-slot prompts, an empty prompt segment
    (pstart >= lens) and the last cache column as the slot."""
    rng = np.random.default_rng(nh)
    L, B, S, dh = 2, 5, 200, 128
    q = _bf16(rng, (B, nh, dh), dev)
    kc, vc = _bf16(rng, (L, B, nkv, S, dh), dev), _bf16(rng, (L, B, nkv, S, dh), dev)
    lens = torch.tensor([1, 64, 65, 130, 7], dtype=torch.int32, device=dev)
    dstart = torch.tensor([1, 64, 131, 150, 199], dtype=torch.int32, device=dev)
    pstart = torch.tensor([0, 10, 65, 0, 7], dtype=torch.int32, device=dev)
    out = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, S - 1, pstart).float()
    ref = rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, S - 1, pstart).float()
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= ATOL
