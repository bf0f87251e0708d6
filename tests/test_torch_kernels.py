"""The port's CUDA kernels against their plain PyTorch versions (needs a GPU).

Every test here is marked ``cuda`` and skips without a card, but those of
the host's grid plans (K6's split of the in-dim, K2's split of the GQA
group), which run on the CPU. The file imports no jax, so on the card it
runs without the repo's conftest:

    python -m pytest -o addopts= --noconftest -m cuda tests/test_torch_kernels.py

Tolerance: the kernel takes bf16 inputs and writes bf16; the plain version
gets the same bf16 inputs, computes in f32 and is compared in f32. Outputs
are weighted averages of N(0,1) values (|v| <= ~5); the kernel rounds P to
bf16 before P·V and the result to bf16, each at most 2^-9 of max|v|:
max |diff| <= 3e-2, LSE to 1e-3.

The int8-cache entry of the ragged decode kernel: its K/V values are exact
in bf16 and the scales fold in f32; both sides round the output to bf16 (at
most one ulp apart, <= 2^-7 |out|), so per element |diff| <= 5e-3 + 2^-7 ·
|plain|. That check must fail for faults planted through the inputs (the V
scales of the next slot, a dropped prompt slot). The kernel also rounds P
times the V scale to bf16 before P·V (at most 2^-9 of the p-weighted |v|),
inside the same rule.

The decode kernel splits each row's slots over a cluster of CTAs (the
host's plan): every instance is checked at every split count 1-8 forced
through the plan, at the limits above, with rows whose few slots fall
inside one split, and two launches must give the same bits; with sinks
near each head's log-sum-exp, the sink counted once per split (sinks +
log(splits), a planted fault) must fail from two splits up.

The int4 dequant-matmul takes bf16 x and writes f32; the plain version does
the same arithmetic (exact bf16 x nibble products) with f32 sums in another
order: max |diff| <= 1e-3 · max |plain|.

The grouped GEMM (K8) takes bf16 xs and expert weights and writes f32; the
plain version forms the same exact bf16 products and sums them in f32 in
another order: max |diff| <= 1e-3 · max |plain|. Group sizes shifted by one
row (a planted fault) must fail that check. Its backward kernels (dX,
tgmm) write bf16: against the plain versions in f32 on the same
bf16-rounded cotangent, per element |diff| <= 1e-3 · max |plain| + 2^-8 ·
|plain| (the store's rounding). The forward has a wgmma kernel and a decode
kernel, picked on the host (``grouped_gemm.forward_kernel``) and counted
apart; every case asserts which one ran. Every output element of the
decode kernel is written by one thread in a fixed order: two launches give
the same bits, and so does another grid.

The sink entries of the ragged decode kernel (K5s, bf16 and int8 caches)
keep the tolerances of their entries without sinks (3e-2; the int8 rule);
sinks of the next head (a planted fault) must fail them. Windowed K1/K3 keep
3e-2, and a window off by one (a planted fault) must fail it. Both at head
dims 64 and 128.

The forward kernel with V narrower than Q/K (DeepSeek MLA: Q/K 192, V
128, 16/16 heads) keeps 3e-2 and LSE to 1e-3; V taken from the next head
(a planted fault) must fail it; a (dh, dv) pair without an instance raises.

The forward runs the per-element mask only on tiles that are not interior
(the diagonal, the band's edge, a key that is invalid or past S): its
cases plant invalid keys inside a tile the causal and band limits leave
interior, T and S off the 64-key tile, per-row qstart past the window and
rows that see no key (0 and LSE -1e30), at every head-dim pair, and
require two launches to give the same bits; the same 3e-2 and 1e-3.

The backward kernels (dq; dk/dv, at head dims 64, 128 and 256 and at Q/K
192 with V 128, banded or not, with or without the softcap) are held
against the plain backward on
the same bf16 inputs and the same saved LSE; a window off by one and the
softcap dropped from the kernel call (planted faults) must fail that check.
They round P and dS to bf16 before each product and write bf16, each at most
2^-9 relative, so the tolerance is relative to the largest gradient entry,
with a floor for gradients that are pure cancellation (T=1: dS = P·(dP - D)
is 0 up to rounding):
max |diff| <= 1e-2 · max |plain| + 1e-3.
"""

import math

import numpy as np
import pytest
import torch

from lapha_tpu_torch.models import quant
from lapha_tpu_torch.models.qwen2 import _quantize_kv
from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import flash_attention as fa
from lapha_tpu_torch.ops import grouped_gemm as gg
from lapha_tpu_torch.ops import int4_matmul as i4
from lapha_tpu_torch.ops import ragged_decode_attention as rda

ATOL = 3e-2
Q8_ATOL = 5e-3
BWD_RTOL = 1e-2
INT4_RTOL = 1e-3
GG_RTOL = 1e-3


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
        fa.flash_attention(qb[..., :80].contiguous(), qb[:, :, :2, :80].contiguous(),
                           qb[:, :, :2, :80].contiguous())  # head dim 80: no instance
    c = torch.zeros((1, 1, 2, 16, 128), dtype=torch.bfloat16, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        rda.ragged_decode_attention(qb[:, 0], c, c, 0, lens, lens, 16)  # slot past S
    with pytest.raises(ValueError, match="head dim 80"):
        rda.ragged_decode_attention(qb[:, 0, :, :80].contiguous(), c[..., :80].contiguous(),
                                    c[..., :80].contiguous(), 0, lens, lens, 8)


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


def _bwd_pair(q, k, v, mask, qstart, do, window=0, softcap=0.0, scale=None):
    """Kernel and plain (dq, dk, dv) from the kernel forward's out and LSE;
    ``window`` > 0 bands both, ``softcap`` > 0 caps both (the launches
    counted under their :func:`fa.launch_name`)."""
    B = q.shape[0]
    qs = torch.as_tensor(qstart, device=q.device).reshape(-1).expand(B).to(torch.int32)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", window, softcap)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, mask, qs, lse, do, delta, scale, window, softcap)
    before = dict(_cuda.LAUNCHES)
    dq = fa.attention_bwd_dq_cuda(*args)
    dk, dv = fa.attention_bwd_dkv_cuda(*args)
    ref = fa.attention_bwd_plain(*args)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        name = fa.launch_name(name, window, softcap, narrowv=v.shape[-1] < q.shape[-1])
        assert _cuda.LAUNCHES[name] == before[name] + 1, name
    return (dq, dk, dv), ref


def _assert_bwd_close(got, ref):
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        a, b = a.float(), b.float()
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= BWD_RTOL * b.abs().max().item() + 1e-3, (name, err, b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(8, 8), (12, 2), (16, 2)])
@pytest.mark.parametrize("T", [1, 63, 128, 1000])
def test_flash_bwd_kernels_match_plain(dev, nh, nkv, T):
    """GQA groups 1, 6 and 8; T=1, a ragged last tile, one exact block, and
    T=1000 (not a multiple of any tile); a right-padded row and a hole."""
    rng = np.random.default_rng(nh * 7 + T)
    B, dh = 2, 128
    q, do = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dh), dev)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, (3 * T) // 4 + 1:] = 0
    mask[0, T // 3:T // 3 + T // 10] = 0
    got, ref = _bwd_pair(q, k, v, mask, 0, do)
    _assert_bwd_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,nh,nkv,T,window,softcap", [
    (128, 12, 2, 1000, 0, 0.0),   # the wgmma kernels, the group split in 6
    (64, 64, 8, 300, 128, 0.0),   # banded, split in 4
    (96, 8, 2, 200, 0, 0.0),      # dh 96 padded to two boxes, split in 4
    (256, 4, 1, 300, 0, 50.0),    # the role-split dk/dv kernel, capped, split in 4
])
def test_flash_bwd_kernels_are_bit_equal_over_two_launches(dev, dh, nh, nkv, T, window, softcap):
    """dk/dv's group split adds its f32 partials in a fixed order and nothing
    is summed with atomics: the same inputs give the same dq, dk and dv bits."""
    rng = np.random.default_rng(dh + T)
    B = 2
    q, do = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dh), dev)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, (3 * T) // 4 + 1:] = 0
    got, ref = _bwd_pair(q, k, v, mask, 0, do, window, softcap)
    _assert_bwd_close(got, ref)
    again, _ = _bwd_pair(q, k, v, mask, 0, do, window, softcap)
    assert fa.dkv_split(B, T, nkv, nh // nkv, dh, _cuda.sm_count(dev)) > 1
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_kernels_left_padding_and_noncausal(dev):
    """Left padding leaves query rows that see no key (LSE -1e30: they
    contribute nothing); a non-causal call (qstart = T) sees every valid key."""
    rng = np.random.default_rng(5)
    B, T, nh, nkv, dh = 3, 200, 12, 2, 128
    q, do = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dh), dev)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, :70] = 0
    mask[2, 150:] = 0
    got, ref = _bwd_pair(q, k, v, mask, 0, do)
    _assert_bwd_close(got, ref)
    assert (got[0][1, :70] == 0).all() and (got[1][1, :70] == 0).all()
    got, ref = _bwd_pair(q, k, v, mask, T, do)
    _assert_bwd_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,nh,nkv", [(64, 64, 8), (64, 8, 8), (128, 12, 2)])
@pytest.mark.parametrize("T,window", [(300, 128), (1000, 128), (77, 16), (130, 1)])
def test_flash_bwd_window_kernels_match_plain(dev, dh, nh, nkv, T, window):
    """K2 with the window band (B6) at GPT-OSS's heads (64/8 of dim 64), a
    group of one, and dh 128: the band longer and shorter than a tile, W = 1
    (each query sees itself), a right-padded row and a hole; a window off by
    one (a planted fault) fails the check."""
    rng = np.random.default_rng(dh + nh + T + window)
    B = 2
    q, do = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dh), dev)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, (3 * T) // 4 + 1:] = 0
    mask[0, T // 3:T // 3 + T // 10] = 0
    got, ref = _bwd_pair(q, k, v, mask, 0, do, window)
    _assert_bwd_close(got, ref)
    # the backward kernels banded at W + 1 on the same forward's out and LSE
    qs, scale = torch.zeros(B, dtype=torch.int32, device=dev), dh ** -0.5
    out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", window)
    args = (q, k, v, mask, qs, lse, do, (do.float() * out.float()).sum(-1), scale, window + 1)
    bad = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        _assert_bwd_close(bad, ref)


@pytest.mark.cuda
def test_bf16_loss_through_the_model_reaches_attention(dev):
    """A bf16 loss through qwen2.forward on the card: the backward runs the
    K2 kernels and every layer's q/k/v projections get a non-zero gradient."""
    from lapha_tpu_torch.models import qwen2

    cfg = qwen2.Qwen2Config(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, rope_theta=1e6, dtype=torch.bfloat16)
    params = qwen2.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    attn = params["layers"]["attn"]
    leaves = [attn[n]["w"] for n in ("q_proj", "k_proj", "v_proj")]
    for t in leaves:
        t.requires_grad_(True)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 300))).to(dev)
    mask = torch.ones((2, 300), dtype=torch.int32, device=dev)
    mask[1, 250:] = 0
    before = dict(_cuda.LAUNCHES)
    logits, _, _ = qwen2.forward(params, cfg, ids, attention_mask=mask)
    loss = torch.log_softmax(logits, -1)[..., 0].mean()
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert _cuda.LAUNCHES[name] == before[name] + cfg.num_hidden_layers
    for g in grads:
        assert torch.isfinite(g.float()).all()
        for layer in range(cfg.num_hidden_layers):
            assert g[layer].float().abs().max().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(8, 8), (12, 2), (16, 2)])
def test_ragged_q8_kernel_matches_plain(dev, nh, nkv):
    """The int8-cache entry: GQA groups 1, 6 and 8; a one-slot prompt, a
    chunk shared by the prompt tail and the decode start, an empty prompt
    segment, the last column as the slot; caches quantized like the
    engine's (per-vector int8 + f32 scales)."""
    rng = np.random.default_rng(100 + nh)
    L, B, S, dh = 2, 6, 300, 128
    q = _bf16(rng, (B, nh, dh), dev)
    kq, ks = _quantize_kv(_bf16(rng, (L, B, nkv, S, dh), dev))
    vq, vs = _quantize_kv(_bf16(rng, (L, B, nkv, S, dh), dev))
    lens = torch.tensor([1, 64, 65, 130, 7, 256], dtype=torch.int32, device=dev)
    dstart = torch.tensor([1, 64, 131, 150, 299, 256], dtype=torch.int32, device=dev)
    for pstart in (None, torch.tensor([0, 10, 65, 0, 7, 3], dtype=torch.int32, device=dev)):
        before = _cuda.LAUNCHES["ragged_decode_attention_q8"]
        out = rda.ragged_decode_attention(q, kq, vq, 1, lens, dstart, S - 1, pstart,
                                          cache_scale=(ks, vs)).float()
        ref = rda.ragged_decode_plain(q, kq, vq, 1, lens, dstart, S - 1, pstart,
                                      cache_scale=(ks, vs)).float()
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["ragged_decode_attention_q8"] == before + 1
        assert torch.isfinite(out).all()
        assert _q8_excess(out, ref) <= 0


@pytest.mark.cuda
def test_ragged_q8_kernel_at_the_served_shape(dev):
    """B=48 rows, S=768, prompts of 512, 12/2 heads (the quantized serving
    round's decode), against the plain version."""
    rng = np.random.default_rng(7)
    L, B, nkv, S, nh, dh = 2, 48, 2, 768, 12, 128
    q = _bf16(rng, (B, nh, dh), dev)
    kq, ks = _quantize_kv(_bf16(rng, (L, B, nkv, S, dh), dev))
    vq, vs = _quantize_kv(_bf16(rng, (L, B, nkv, S, dh), dev))
    lens = torch.full((B,), 512, dtype=torch.int32, device=dev)
    dstart = torch.full((B,), 512, dtype=torch.int32, device=dev)
    for slot in (512, 700):
        out = rda.ragged_decode_attention(q, kq, vq, 0, lens, dstart, slot,
                                          cache_scale=(ks, vs)).float()
        ref = rda.ragged_decode_plain(q, kq, vq, 0, lens, dstart, slot,
                                      cache_scale=(ks, vs)).float()
        torch.cuda.synchronize()
        assert _q8_excess(out, ref) <= 0


def _q8_excess(out, ref):
    """How far the int8-cache kernel's output exceeds its tolerance."""
    d = (out.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
    return d.max().item() - Q8_ATOL


@pytest.mark.cuda
def test_ragged_q8_check_catches_planted_faults(dev):
    """At the served shape, the kernel given the V scales of the next slot,
    or lens one short (a dropped prompt slot), fails the tolerance that the
    true inputs pass."""
    rng = np.random.default_rng(8)
    L, B, nkv, S, nh, dh, slot = 1, 48, 2, 768, 12, 128, 700
    q = _bf16(rng, (B, nh, dh), dev)
    kq, ks = _quantize_kv(_bf16(rng, (L, B, nkv, S, dh), dev))
    vq, vs = _quantize_kv(_bf16(rng, (L, B, nkv, S, dh), dev))
    lens = torch.full((B,), 512, dtype=torch.int32, device=dev)
    ref = rda.ragged_decode_plain(q, kq, vq, 0, lens, lens, slot, cache_scale=(ks, vs))
    good = rda.ragged_decode_attention(q, kq, vq, 0, lens, lens, slot, cache_scale=(ks, vs))
    shifted = rda.ragged_decode_attention(q, kq, vq, 0, lens, lens, slot,
                                          cache_scale=(ks, vs.roll(-1, dims=-1)))
    dropped = rda.ragged_decode_attention(q, kq, vq, 0, lens - 1, lens, slot,
                                          cache_scale=(ks, vs))
    torch.cuda.synchronize()
    assert _q8_excess(good, ref) <= 0
    assert _q8_excess(shifted, ref) > 0
    assert _q8_excess(dropped, ref) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
def test_q_matmul_f32_is_not_rounded_to_bf16(dev, kind):
    """bf16 h on the card: _q_matmul_f32's product above the int4 kernel's
    rows (and the int8 and plain leaves at any rows) keeps f32 precision,
    against an f32 product of the same bf16 operands; its gradient reaches
    h and a plain leaf."""
    from lapha_tpu_torch.models.qwen2 import _q_matmul_f32

    rng = np.random.default_rng(9)
    h = _bf16(rng, (2, 300, 512), dev)  # 600 rows: the dequantized product
    w = _bf16(rng, (512, 384), dev)
    leaf = {"plain": w, "int8": quant.quantize_weight(w),
            "int4": quant.quantize_weight_int4(w, 128)}[kind]
    wd = quant.dequant(leaf, torch.bfloat16)
    ref = h.float() @ wd.float()
    out = _q_matmul_f32(h, leaf)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    if kind == "plain":
        hg, wg = h.clone().requires_grad_(True), w.clone().requires_grad_(True)
        g = torch.from_numpy(rng.normal(size=ref.shape).astype(np.float32)).to(dev)
        gh, gw = torch.autograd.grad((_q_matmul_f32(hg, wg) * g).sum(), (hg, wg))
        rh, rw = g @ w.float().T, h.float().reshape(-1, 512).T @ g.reshape(-1, 384)
        for a, b in ((gh, rh), (gw, rw)):
            assert a.dtype == torch.bfloat16
            assert (a.float() - b).abs().max().item() <= 1e-2 * b.abs().max().item()


def _int4_leaf(rng, IN, OUT, G, dev, L=None):
    shape = (IN, OUT) if L is None else (L, IN, OUT)
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    return quant.quantize_weight_int4(w, G)


@pytest.mark.cuda
@pytest.mark.parametrize("B,IN,OUT,G", [
    (1, 1536, 1536, 128),    # one row
    (48, 1536, 256, 128),    # decode k/v projections
    (48, 8960, 1536, 128),   # decode down projection
    (512, 1536, 8960, 128),  # the largest row count the model sends
    (37, 256, 1000, 64),     # padded rows; OUT neither a multiple of 64 nor of 16
    (70, 512, 1552, 32),     # OUT a multiple of 16 but not of the 64-column tile
    (3, 256, 200, 16),       # the smallest group
])
def test_int4_kernel_matches_plain(dev, B, IN, OUT, G):
    rng = np.random.default_rng(B + IN + OUT)
    x = _bf16(rng, (B, IN), dev)
    leaf = _int4_leaf(rng, IN, OUT, G, dev)
    before = _cuda.LAUNCHES["int4_matmul"]
    out = i4.int4_matmul(x, leaf["q"], leaf["s4"])
    ref = i4.int4_matmul_plain(x, leaf["q"], leaf["s4"])
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["int4_matmul"] == before + 1
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, OUT)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= INT4_RTOL * ref.abs().max().item()


@pytest.mark.cuda
def test_int4_kernel_stacked_layers_and_f32_input(dev):
    """A per-layer view of stacked (L, IN/2, OUT) weights, and an f32 x (the
    kernel rounds it to bf16 as the plain version does)."""
    rng = np.random.default_rng(3)
    leaf = _int4_leaf(rng, 512, 384, 128, dev, L=3)
    x = torch.from_numpy(rng.normal(size=(20, 512)).astype(np.float32)).to(dev)
    for layer in range(3):
        out = i4.int4_matmul(x, leaf["q"], leaf["s4"], layer=layer)
        ref = i4.int4_matmul_plain(x, leaf["q"][layer], leaf["s4"][layer])
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= INT4_RTOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,IN,OUT,G", [
    (48, 8960, 1536, 128),   # the down projection: 8 splits, a cluster of 8
    (48, 1536, 256, 128),    # 16-row, 16-column tiles, the k-steps split over the warps
    (37, 256, 1000, 64),     # ragged rows and columns, non-vector loads
    (70, 512, 1552, 32),     # two row tiles of 64, 6 splits
])
def test_int4_kernel_is_bit_equal_over_two_launches(dev, B, IN, OUT, G):
    """A tile's splits (one thread-block cluster) add their partial sums in
    split order: the same inputs give the same bits, launch after launch
    (greedy decode gives the same tokens)."""
    rng = np.random.default_rng(B * IN + OUT)
    x = _bf16(rng, (B, IN), dev)
    leaf = _int4_leaf(rng, IN, OUT, G, dev)
    outs = [i4.int4_matmul(x, leaf["q"], leaf["s4"]) for _ in range(3)]
    ref = i4.int4_matmul_plain(x, leaf["q"], leaf["s4"])
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert (outs[0] - ref).abs().max().item() <= INT4_RTOL * ref.abs().max().item()


# (B, IN, OUT, G): the CUDA tests' and phase 1c's shapes, and the smallest
# and largest groups at the decode shapes
K6_PLAN_SHAPES = [(48, 1536, 1536, 128), (48, 1536, 256, 128), (48, 1536, 8960, 128),
                  (48, 8960, 1536, 128), (512, 1536, 8960, 128), (1, 1536, 1536, 128),
                  (37, 256, 1000, 64), (70, 512, 1552, 32), (3, 256, 200, 16),
                  (48, 1536, 1536, 16), (48, 8960, 1536, 16), (48, 1536, 256, 16),
                  (20, 512, 384, 128)]


@pytest.mark.parametrize("B,IN,OUT,G", K6_PLAN_SHAPES)
def test_int4_split_plan_covers_every_group_pair_once(B, IN, OUT, G):
    """(CPU) The host's plan: each group pair, and so each group's low or
    high nibbles, is in exactly one split, the splits in ascending order."""
    plan = i4.split_plan(B, IN, OUT, G, 132)
    pairs = IN // (2 * G)
    assert plan.cols in i4.COLUMN_TILES and plan.rows in (16, 32, 48, 64)
    assert 1 <= plan.splits <= min(pairs, i4.MAX_SPLITS)
    ranges = i4.split_pairs(pairs, plan.splits)
    assert all(p1 > p0 for p0, p1 in ranges)
    assert [p for p0, p1 in ranges for p in range(p0, p1)] == list(range(pairs))
    groups = sorted(g for p0, p1 in ranges for p in range(p0, p1) for g in (p, p + pairs))
    assert groups == list(range(IN // G))


@pytest.mark.parametrize("B,IN,OUT,least", [
    (48, 1536, 1536, 132),  # q/o: a CTA an SM (24 tiles x 6 splits)
    (48, 8960, 1536, 132),  # down: 24 tiles x 8 splits
    (48, 1536, 8960, 132),  # gate/up: the tiles alone
    (48, 1536, 256, 96),    # k/v: 6 group pairs, so 16-row, 16-column tiles (288)
])
def test_int4_split_plan_fills_the_card(B, IN, OUT, least):
    """(CPU) CTAs of the plan at Qwen2.5-1.5B's decode shapes on 132 SMs:
    at least one an SM. Two an SM (narrower tiles, clusters of 11) read
    slower on the card (PERF.md §6)."""
    plan = i4.split_plan(B, IN, OUT, 128, 132)
    assert math.ceil(B / plan.rows) * math.ceil(OUT / plan.cols) * plan.splits >= least


def test_int4_split_plan_keeps_one_split_where_the_grid_is_full():
    """(CPU) At 512 rows the 64 x 64 tiles alone fill the card."""
    assert i4.split_plan(512, 1536, 8960, 128, 132) == (64, 64, 1)


# (B, S, KV heads, group, dh): phase 1b, the update (B=8), 1h, 1i's Gemma-3
# and Gemma-2, 1k, 1l, and small ragged shapes
K2_SPLIT_SHAPES = [(4, 1024, 2, 6, 128), (8, 1024, 2, 6, 128), (4, 1024, 8, 8, 64),
                   (4, 1024, 1, 4, 256), (4, 1024, 4, 2, 256), (4, 1024, 16, 1, 192),
                   (4, 1024, 32, 1, 96), (2, 77, 2, 6, 128), (1, 300, 1, 12, 64)]


@pytest.mark.parametrize("B,S,nkv,group,dh", K2_SPLIT_SHAPES)
def test_dkv_group_split_covers_each_head_and_key_block_once(B, S, nkv, group, dh):
    """(CPU) The dk/dv kernel's CTAs (part, KV head, row) x key blocks take
    each (query head, key block) exactly once, the parts' head ranges in
    ascending order, the order their partials are added in."""
    splits = fa.dkv_split(B, S, nkv, group, dh, 132)
    assert group % splits == 0
    heads = fa.split_heads(group, splits)
    assert [h for h0, h1 in heads for h in range(h0, h1)] == list(range(group))
    keys = 128 if dh <= 128 else 64
    seen = {}
    for b in range(B):
        for hk in range(nkv):
            for s, (h0, h1) in enumerate(heads):
                for kb in range(math.ceil(S / keys)):
                    for h in range(h0, h1):
                        key = (b, hk * group + h, kb)
                        assert key not in seen
                        seen[key] = s
    assert len(seen) == B * nkv * group * math.ceil(S / keys)


@pytest.mark.parametrize("B,S,nkv,group,dh,least", [
    (4, 1024, 2, 6, 128, 132),  # phase 1b: 64 CTAs of 128 keys without the split
    (4, 1024, 1, 4, 256, 128),  # Gemma-3's 4/1 heads: 64 CTAs of 64 keys without it
    (8, 1024, 2, 6, 128, 132),  # the update's 8 rows
])
def test_dkv_group_split_fills_the_card(B, S, nkv, group, dh, least):
    """(CPU) CTAs of the dk/dv kernels with the split, on 132 SMs; a grid
    that is full already keeps one part."""
    splits = fa.dkv_split(B, S, nkv, group, dh, 132)
    assert math.ceil(S / (128 if dh <= 128 else 64)) * nkv * B * splits >= least
    assert fa.dkv_split(4, 1024, 8, 8, 64, 132) == 1  # phase 1h: 256 CTAs


def test_dkv_partials_in_part_order_sum_to_the_plain_gradients():
    """(CPU) dK and dV as the kernels form them with the split: each part's
    heads in f32, the parts added in order, then rounded, equal the plain
    backward's (the rounding of one f32 sum either way)."""
    rng = np.random.default_rng(13)
    B, T, nh, nkv, dh = 2, 40, 12, 2, 32  # a group of 6: parts of 3 and of 2 heads
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q, k, v, do = f(B, T, nh, dh), f(B, T, nkv, dh), f(B, T, nkv, dh), f(B, T, nh, dh)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 30:] = 0
    qs = torch.zeros(B, dtype=torch.int32)
    scale = dh ** -0.5
    out, lse = fa.attention_plain(q, k, v, mask, qs, scale)
    delta = (do * out).sum(-1)
    dk_ref, dv_ref = fa.attention_bwd_dkv_plain(q, k, v, mask, qs, lse, do, delta, scale)
    group = nh // nkv
    for splits in (2, 3):
        dk = torch.zeros(B, T, nkv, dh)
        dv = torch.zeros(B, T, nkv, dh)
        for h0, h1 in fa.split_heads(group, splits):
            heads = [hk * group + h for hk in range(nkv) for h in range(h0, h1)]
            sub = lambda t: t[:, :, heads]  # noqa: E731
            pk, pv = fa.attention_bwd_dkv_plain(sub(q), k, v, mask, qs, lse[:, heads], sub(do),
                                                delta[:, :, heads], scale)
            dk, dv = dk + pk, dv + pv
        torch.testing.assert_close(dk, dk_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dv, dv_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_int4_and_q8_wrappers_reject_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(4)
    leaf = _int4_leaf(rng, 256, 128, 8, dev)  # group 8: below the mma depth
    with pytest.raises(ValueError):
        i4.int4_matmul(_bf16(rng, (4, 256), dev), leaf["q"], leaf["s4"])
    leaf = _int4_leaf(rng, 256, 128, 64, dev)
    with pytest.raises(ValueError):
        i4.int4_matmul(_bf16(rng, (4, 256), dev), leaf["q"].to(torch.int8), leaf["s4"])
    q = _bf16(rng, (2, 12, 128), dev)
    c = torch.zeros((1, 2, 2, 16, 128), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 2, 2, 16), dtype=torch.float32, device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # bf16 scales
        rda.ragged_decode_attention(q, c, c, 0, lens, lens, 3,
                                    cache_scale=(sc.to(torch.bfloat16), sc))
    with pytest.raises(ValueError):  # a bf16 cache with scales
        rda.ragged_decode_attention(q, c.to(torch.bfloat16), c.to(torch.bfloat16), 0, lens,
                                    lens, 3, cache_scale=(sc, sc))


@pytest.mark.cuda
def test_quantized_decode_step_on_the_card_matches_the_cpu(dev):
    """Two layers with int4 projections, int8 embed/head and an int8 KV
    cache: prefill + one decode step on the card (kernels, bf16) against the
    CPU (plain versions, f32); both kernels launch."""
    from lapha_tpu_torch.engine.engine import Engine
    from lapha_tpu_torch.models import qwen2

    cfg = qwen2.Qwen2Config(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, rope_theta=1e6, dtype=torch.bfloat16)
    params = quant.quantize_params(qwen2.init_params(cfg, torch.Generator(device=dev).manual_seed(0)),
                                   bits=4)
    cpu = quant.tree_to(params, "cpu", torch.float32)
    cfg_cpu = qwen2.Qwen2Config(**{**cfg.__dict__, "dtype": torch.float32})
    rng = np.random.default_rng(1)
    B, T, S = 3, 40, 64
    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, T)))
    nxt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B,)))
    lens = torch.full((B,), T, dtype=torch.int32)

    def run(p, c, device):
        with torch.inference_mode():
            cache = qwen2.init_kv_cache(c, B, S, device)
            _, _, cache = qwen2.forward(p, c, ids.to(device), kv_cache=cache, cache_pos=0)
            ck, cv, scl = Engine._quantize_cache(cache[0].permute(0, 1, 3, 2, 4).contiguous(),
                                                 cache[1].permute(0, 1, 3, 2, 4).contiguous())
            out = qwen2.decode_step(p, c, nxt.to(device), lens.to(device), ck, cv, T,
                                    lens.to(device), lens.to(device), cache_scale=scl)
        return out[0].float().cpu()

    before = dict(_cuda.LAUNCHES)
    got = run(params, cfg, dev)
    torch.cuda.synchronize()
    for name in ("int4_matmul", "ragged_decode_attention_q8"):
        assert _cuda.LAUNCHES[name] > before[name], name
    assert _cuda.LAUNCHES["ragged_decode_attention"] == before["ragged_decode_attention"]
    ref = run(cpu, cfg_cpu, torch.device("cpu"))
    assert float((got - ref).norm() / ref.norm()) <= 5e-2


def _gg_inputs(rng, sizes, K, N, dev, M=None):
    M = sum(sizes) if M is None else M
    xs = _bf16(rng, (M, K), dev)
    w = _bf16(rng, (len(sizes), K, N), dev)
    return xs, w, torch.tensor(sizes, dtype=torch.int32, device=dev)


def _gg_err(out, ref):
    """How far K8's output is from the plain version, in units of its limit
    (> 1: the check fails)."""
    return (out - ref).abs().max().item() / (GG_RTOL * ref.abs().max().item())


def _gg_bf16_err(out, ref):
    """The same for a bf16 output (K8's dX and dW) against the plain version
    in f32: the store's rounding (at most 2^-8 of each element) is taken out
    first."""
    out, ref = out.float(), ref.float()
    excess = ((out - ref).abs() - 2.0 ** -8 * ref.abs()).max().item()
    return max(excess, 0.0) / (GG_RTOL * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,K,N", [
    ((3, 0, 1, 70, 0, 5, 130), 64, 64),       # empty groups, groups shorter than a tile
    ((0,) * 5 + (200,) + (0,) * 5, 96, 200),  # one expert takes every row; N off the tile edge
    (tuple(range(1, 13)), 136, 72),           # K off the 32-deep stage, N off the tile
    ((2,) * 48 + (0,) * 12, 2048, 1408),      # the decode gate/up shape: 96 rows, 60 experts
    ((5, 7, 0, 9), 40, 36),                   # N % 8 != 0: element loads of the weights
])
def test_grouped_gemm_kernel_matches_plain(dev, sizes, K, N):
    rng = np.random.default_rng(sum(sizes) + K + N)
    xs, w, gs = _gg_inputs(rng, sizes, K, N, dev)
    # the host's rule: the decode kernel at decode's few rows an expert and
    # for N % 8 != 0, the wgmma kernel above WG_MIN_ROWS rows an expert
    kernel = gg.forward_kernel(sum(sizes), len(sizes), N, w.data_ptr())
    before = dict(_cuda.LAUNCHES)
    out = gg.grouped_gemm(xs, w, gs)
    ref = gg.grouped_gemm_plain(xs, w, gs)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[kernel] == before[kernel] + 1
    other = "grouped_gemm" if kernel == "grouped_gemm_wg" else "grouped_gemm_wg"
    assert _cuda.LAUNCHES[other] == before[other]
    assert out.dtype == torch.float32 and tuple(out.shape) == (sum(sizes), N)
    assert torch.isfinite(out).all()
    assert _gg_err(out, ref) <= 1.0


@pytest.mark.cuda
def test_grouped_gemm_kernel_zeroes_rows_past_the_groups_and_catches_a_planted_fault(dev):
    rng = np.random.default_rng(5)
    xs, w, gs = _gg_inputs(rng, (9, 0, 40, 3), 64, 128, dev, M=80)  # 28 rows past the groups
    out = gg.grouped_gemm(xs, w, gs)
    torch.cuda.synchronize()
    assert not out[52:].any()
    assert _gg_err(out, gg.grouped_gemm_plain(xs, w, gs)) <= 1.0
    xs, w, gs = _gg_inputs(rng, (30, 1, 64, 17), 128, 192, dev)
    shifted = gs.clone()
    shifted[0] -= 1
    shifted[1] += 1  # the last row of group 0 goes to expert 1
    bad = gg.grouped_gemm(xs, w, shifted)
    torch.cuda.synchronize()
    assert _gg_err(bad, gg.grouped_gemm_plain(xs, w, gs)) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,K,N,M", [
    ((3, 0, 1, 70, 0, 5, 130), 64, 64, None),   # empty groups, groups shorter than a tile
    ((9, 0, 40, 3), 136, 200, 80),              # 28 rows past the groups; K, N off the tiles
    ((0,) * 5 + (200,) + (0,) * 5, 96, 72, None),  # one expert takes every row
    ((12,) * 40 + (0,) * 20, 2048, 1408, None),  # Qwen1.5-MoE's gate/up, 20 empty experts
])
def test_grouped_gemm_cuda_backward_raises_and_wrapper_rejects(dev, sizes, K, N, M):
    """K8's backward on the card (B2): dX (grouped_gemm_dx) and dW
    (grouped_gemm_tgmm) through the autograd Function against the plain
    versions on the same bf16-rounded cotangent, at K8's limit; rows past the
    groups get dX 0 and an empty expert's dW is exact zeros even where the
    output held NaN. The wrappers still reject what the kernels do not take."""
    rng = np.random.default_rng(6 + len(sizes))
    xs, w, gs = _gg_inputs(rng, sizes, K, N, dev, M=M)
    xs.requires_grad_(True)
    w.requires_grad_(True)
    dout = torch.from_numpy(rng.normal(size=(xs.shape[0], N)).astype(np.float32)).to(dev)
    before = dict(_cuda.LAUNCHES)
    dx, dw = torch.autograd.grad(gg.grouped_gemm(xs, w, gs), (xs, w), dout)
    dy = dout.to(torch.bfloat16)  # the plain versions in f32 on the same rounded dY
    ref_dx = gg.grouped_gemm_dx_plain(dy.float(), w.detach().float(), gs)
    ref_dw = gg.grouped_gemm_tgmm_plain(xs.detach().float(), dy.float(), gs)
    nan_out = torch.full_like(w, float("nan"))
    dw2 = gg.grouped_gemm_tgmm_cuda(xs.detach(), dy, gs, out=nan_out)
    torch.cuda.synchronize()
    for name in ("grouped_gemm_dx", "grouped_gemm_tgmm"):
        assert _cuda.LAUNCHES[name] > before[name], name
    assert dx.dtype == dw.dtype == torch.bfloat16
    assert _gg_bf16_err(dx, ref_dx) <= 1.0
    assert _gg_bf16_err(dw, ref_dw) <= 1.0
    assert torch.equal(dw2, dw)  # deterministic, and every element written
    assert not dx[sum(sizes):].any()
    empty = torch.nonzero(gs == 0).flatten()
    assert not dw2[empty].any() and torch.isfinite(dw2.float()).all()
    with pytest.raises(ValueError):  # K not a multiple of 8
        gg.grouped_gemm(_bf16(rng, (8, 36), dev), _bf16(rng, (2, 36, 16), dev), gs[:2])
    with pytest.raises(ValueError):  # f32 operands
        gg.grouped_gemm(xs.detach().float(), w.detach().float(), gs)
    with pytest.raises(ValueError):  # the backward kernels take N a multiple of 8
        gg.grouped_gemm_dx_cuda(_bf16(rng, (8, 36), dev), _bf16(rng, (2, 16, 36), dev), gs[:2])


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [50, 12])
def test_moe_block_on_the_card_matches_the_cpu_without_syncs(dev, tokens):
    """The gather path in bf16 on the card (K8) against f32 on the CPU with
    the routing forced equal, and the whole block under the sync debug mode:
    nothing in it reads back to the host. 50 tokens x top-4 over 16 experts
    take the wgmma kernel, 12 the decode kernel (the host's rule)."""
    from lapha_tpu_torch.models import qwen2
    from lapha_tpu_torch.ops import moe

    cfg = qwen2.Qwen2Config.tiny(hidden_size=256, num_experts=16, num_experts_per_tok=4,
                                 moe_intermediate_size=128, shared_expert_intermediate_size=256,
                                 num_hidden_layers=1, dtype=torch.bfloat16)
    p = qwen2._layer_stack(qwen2.init_params(cfg, torch.Generator(device=dev).manual_seed(0)))[0]
    p = p["moe"]
    x = _bf16(np.random.default_rng(7), (tokens, 256), dev)
    kernel = gg.forward_kernel(4 * tokens, 16, 128, p["experts"]["gate_proj"]["w"].data_ptr())
    assert kernel == ("grouped_gemm_wg" if tokens == 50 else "grouped_gemm")
    before = _cuda.LAUNCHES[kernel]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        topw, topi = moe.route(x, p["router"]["w"], 4, False)
        got = moe.moe_block(x, p, top_k=4, norm_topk=False)
        routed = moe.moe_ffn_gather(x, p, top_k=4, norm_topk=False, routing=(topw, topi))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _cuda.LAUNCHES[kernel] == before + 6
    cpu = quant.tree_to(p, "cpu", torch.float32)
    ref = moe.moe_ffn_gather(x.float().cpu(), cpu, top_k=4, norm_topk=False,
                             routing=(topw.float().cpu(), topi.cpu()))
    assert float((routed.float().cpu() - ref).norm() / ref.norm()) <= 2e-2
    assert torch.isfinite(got.float()).all()


def _gmax_sizes(rng):
    """GMAX (1024) experts, most of them empty: 12 take 1400-2000 rows (so
    that M >= WG_MIN_ROWS · G picks the wgmma forward)."""
    sizes = np.zeros(gg.GMAX, np.int64)
    sizes[rng.choice(gg.GMAX, 12, replace=False)] = rng.integers(1400, 2001, 12)
    return tuple(int(s) for s in sizes)


# The wgmma kernels' ragged edges: groups ending off the 64- and 128-row
# tiles; a group starting mid-chunk after an odd-sized one (tgmm's last
# chunk runs into the next expert's rows); rows past the groups; GPT-OSS's
# 2880 (22.5 tiles of 128); GMAX experts, most empty; one expert with every row.
GG_WG_CASES = [
    ((129, 191, 546), 256, 384, None),
    ((67, 0, 133, 1, 255, 0), 136, 200, None),
    ((100, 0, 150, 13), 64, 128, 291),           # 28 rows past the groups, wgmma forward
    ((300, 0, 129, 211), 2880, 2880, None),
    ((300, 0, 129, 211), 2880, 5760, None),
    ("gmax", 64, 128, None),
    ((0, 0, 0, 600, 0), 128, 256, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,K,N,M", GG_WG_CASES)
def test_grouped_gemm_wgmma_kernels_match_plain(dev, sizes, K, N, M):
    """The wgmma forward, dX and tgmm against the plain versions at the
    limits of the kernels above: the host's rule picks the wgmma forward
    (counted apart from the decode kernel); rows past the groups get zeros
    in the forward and in dX; dW is written whole over a NaN-filled output,
    empty experts exact zeros, and two launches are bit-equal."""
    rng = np.random.default_rng(len(str(sizes)) + K + N)
    if sizes == "gmax":
        sizes = _gmax_sizes(rng)
    xs, w, gs = _gg_inputs(rng, sizes, K, N, dev, M=M)
    M, G, total = xs.shape[0], len(sizes), sum(sizes)
    assert gg.forward_kernel(M, G, N, w.data_ptr()) == "grouped_gemm_wg"
    dy = _bf16(rng, (M, N), dev)
    before = dict(_cuda.LAUNCHES)
    out = gg.grouped_gemm(xs, w, gs)
    dx = gg.grouped_gemm_dx_cuda(dy, w, gs)
    dw = gg.grouped_gemm_tgmm_cuda(xs, dy, gs, out=torch.full_like(w, float("nan")))
    dw2 = gg.grouped_gemm_tgmm_cuda(xs, dy, gs)
    torch.cuda.synchronize()
    for name, n in (("grouped_gemm_wg", 1), ("grouped_gemm", 0), ("grouped_gemm_dx", 1),
                    ("grouped_gemm_tgmm", 2)):
        assert _cuda.LAUNCHES[name] == before[name] + n, name
    assert _gg_err(out, gg.grouped_gemm_plain(xs, w, gs)) <= 1.0
    assert _gg_bf16_err(dx, gg.grouped_gemm_dx_plain(dy.float(), w.float(), gs)) <= 1.0
    assert _gg_bf16_err(dw, gg.grouped_gemm_tgmm_plain(xs.float(), dy.float(), gs)) <= 1.0
    assert not out[total:].any() and not dx[total:].any()
    assert torch.equal(dw, dw2) and torch.isfinite(dw.float()).all()
    assert not dw[torch.nonzero(gs == 0).flatten()].any()


@pytest.mark.cuda
def test_grouped_gemm_wgmma_kernels_catch_planted_faults(dev):
    """Group sizes shifted by one row (the last row of a group handed to the
    next expert) fail the checks of the wgmma forward, dX and tgmm; so does
    a group end moved by one row inside tgmm's last chunk."""
    rng = np.random.default_rng(12)
    xs, w, gs = _gg_inputs(rng, (129, 191, 546, 70), 256, 384, dev)
    dy = _bf16(rng, (xs.shape[0], 384), dev)
    ref = (gg.grouped_gemm_plain(xs, w, gs), gg.grouped_gemm_dx_plain(dy.float(), w.float(), gs),
           gg.grouped_gemm_tgmm_plain(xs.float(), dy.float(), gs))
    for g in (0, 1):
        shifted = gs.clone()
        shifted[g] -= 1
        shifted[g + 1] += 1
        before = _cuda.LAUNCHES["grouped_gemm_wg"]
        bad = (gg.grouped_gemm(xs, w, shifted), gg.grouped_gemm_dx_cuda(dy, w, shifted),
               gg.grouped_gemm_tgmm_cuda(xs, dy, shifted))
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["grouped_gemm_wg"] == before + 1
        assert _gg_err(bad[0], ref[0]) > 1.0
        assert _gg_bf16_err(bad[1], ref[1]) > 1.0
        assert _gg_bf16_err(bad[2], ref[2]) > 1.0


# The decode forward (csrc grouped_gemm_decode_kernel): every forward the
# host's rule does not send to the wgmma kernel. The MoE models' decode
# products at full width with routed group sizes (24 tokens: Qwen1.5-MoE
# top-4 of 60 experts, GPT-OSS-20B top-4 of 32, DeepSeek-V2-Lite top-6 of
# 64), an expert past one 16-row pass, GMAX experts mostly empty, rows past
# the groups; then other grids forced through the host's plan.
GG_DECODE_CASES = [
    (("route", 24, 4, 60), 2048, 1408, None),
    (("route", 24, 4, 60), 1408, 2048, None),
    (("route", 24, 4, 32), 2880, 5760, None),
    (("route", 24, 4, 32), 2880, 2880, None),
    (("route", 24, 6, 64), 2048, 1408, None),
    (("route", 24, 6, 64), 1408, 2048, None),
    ((0, 9, 0, 40, 17, 1, 0, 33, 0, 12) + (0,) * 6, 256, 192, None),  # 9-40 rows an expert
    ("gmax", 64, 128, None),
    ((3, 0, 5, 1, 0, 2, 7, 0), 136, 200, 40),  # 22 rows past the groups; K, N off the tiles
]


def _decode_sizes(rng, sizes):
    """Group sizes: as given; top-k of random logits over E experts for
    ("route", tokens, k, E); GMAX experts of which 40 take 1-8 rows."""
    if sizes == "gmax":
        out = np.zeros(gg.GMAX, np.int64)
        out[rng.choice(gg.GMAX, 40, replace=False)] = rng.integers(1, 9, 40)
        return tuple(int(v) for v in out)
    if sizes[0] == "route":
        _, tokens, k, E = sizes
        top = np.argsort(-rng.normal(size=(tokens, E)), axis=1)[:, :k].reshape(-1)
        return tuple(int(v) for v in np.bincount(top, minlength=E))
    return sizes


def _decode_inputs(rng, sizes, K, N, dev, M=None, w=None):
    """xs and the group sizes from numpy; the weights drawn on the card (a
    GB of numpy draws at GPT-OSS's width would take minutes)."""
    M = sum(sizes) if M is None else M
    xs = _bf16(rng, (M, K), dev)
    if w is None:
        gen = torch.Generator(device=dev).manual_seed(len(sizes) + K + N)
        w = (torch.randn((len(sizes), K, N), generator=gen, device=dev) * K ** -0.5).to(
            torch.bfloat16)
    return xs, w, torch.tensor(sizes, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,K,N,M", GG_DECODE_CASES)
def test_grouped_gemm_decode_kernel_matches_plain(dev, sizes, K, N, M):
    """The decode kernel against the plain version at K8's limit, counted
    under "grouped_gemm" (never the wgmma kernel); two launches bit-equal;
    rows past the groups zero; group sizes shifted by one row (the last row of the
    first non-empty group handed to the next expert) fail the check."""
    rng = np.random.default_rng(len(str(sizes)) + K + N)
    sizes = _decode_sizes(rng, sizes)
    xs, w, gs = _decode_inputs(rng, sizes, K, N, dev, M)
    M, G, total = xs.shape[0], len(sizes), sum(sizes)
    assert gg.forward_kernel(M, G, N, w.data_ptr()) == "grouped_gemm"
    before = dict(_cuda.LAUNCHES)
    out = gg.grouped_gemm(xs, w, gs)
    again = gg.grouped_gemm(xs, w, gs)
    ref = gg.grouped_gemm_plain(xs, w, gs)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["grouped_gemm"] == before["grouped_gemm"] + 2
    assert _cuda.LAUNCHES["grouped_gemm_wg"] == before["grouped_gemm_wg"]
    assert torch.isfinite(out).all() and _gg_err(out, ref) <= 1.0
    assert torch.equal(out, again)
    assert not out[total:].any()
    shifted = gs.clone()
    first = int(torch.nonzero(gs)[0])
    shifted[first] -= 1
    shifted[(first + 1) % G] += 1
    bad = gg.grouped_gemm(xs, w, shifted)
    torch.cuda.synchronize()
    assert _gg_err(bad, ref) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("grid,other", [
    (1, 2),      # one CTA walks every item, its ring across all of them
    (2, 1),
    (5, 64),
    (64, 3),
    (200, 7),    # more CTAs than items: the rest only zero rows
    (396, 33),   # every SM's CTAs
])
def test_grouped_gemm_decode_kernel_any_grid(dev, monkeypatch, grid, other):
    """Grids forced through the host's plan, at decode-shaped groups with an
    expert past 16 rows and rows past the groups: the plain version's result
    to K8's limit, bit-equal under another grid."""
    rng = np.random.default_rng(grid + other)
    sizes = (2, 0, 1, 8, 0, 0, 3, 5, 19, 0, 1, 4, 7, 0, 0, 6)
    xs, w, gs = _decode_inputs(rng, sizes, 256, 328, dev, M=70)
    ref = gg.grouped_gemm_plain(xs, w, gs)
    monkeypatch.setattr(gg, "decode_grid", lambda *a: grid)
    out = gg.grouped_gemm(xs, w, gs)
    torch.cuda.synchronize()
    assert _gg_err(out, ref) <= 1.0 and not out[sum(sizes):].any()
    monkeypatch.setattr(gg, "decode_grid", lambda *a: other)
    assert torch.equal(gg.grouped_gemm(xs, w, gs), out)


@pytest.mark.cuda
@pytest.mark.parametrize("N,offset", [(36, 0), (1404, 0), (1408, 1), (200, 3)])
def test_grouped_gemm_decode_kernel_takes_what_tma_cannot(dev, N, offset):
    """N % 8 != 0 and a weight pointer off 16 bytes (a view ``offset``
    elements into its storage): element loads of the weights at any row
    count, even where the wgmma kernel would take the rows (12 an expert)."""
    rng = np.random.default_rng(N + offset)
    sizes = (12, 0, 30, 6, 12, 0, 1, 11)
    G, K = len(sizes), 136
    store = _bf16(rng, (G * K * N + offset,), dev)
    w = store[offset:].view(G, K, N)
    assert (w.data_ptr() % 16 != 0) == (offset % 8 != 0)
    xs, _, gs = _decode_inputs(rng, sizes, K, N, dev, w=w)
    assert gg.forward_kernel(xs.shape[0], G, N, w.data_ptr()) == "grouped_gemm"
    before = _cuda.LAUNCHES["grouped_gemm"]
    out = gg.grouped_gemm(xs, w, gs)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["grouped_gemm"] == before + 1
    assert _gg_err(out, gg.grouped_gemm_plain(xs, w, gs)) <= 1.0


# ---------------------------------------------------------------- GPT-OSS: K5s, windowed K1/K3, dh 64

def _sink_case(rng, dev, dh, nh, nkv, int8):
    """24 decode rows over S=640, prompts up to 512, a 128-token window's
    clipped ranges on half the rows; random sinks."""
    L, B, S, slot, W = 2, 24, 640, 560, 128
    q = _bf16(rng, (B, nh, dh), dev)
    kc, vc = _bf16(rng, (L, B, nkv, S, dh), dev), _bf16(rng, (L, B, nkv, S, dh), dev)
    scl = None
    if int8:
        (kc, ks), (vc, vs) = _quantize_kv(kc), _quantize_kv(vc)
        scl = (ks, vs)
    lens = torch.from_numpy(rng.integers(1, 513, B).astype(np.int32)).to(dev)
    dstart = torch.full((B,), 512, dtype=torch.int32, device=dev)
    pos = lens + (slot - 512)
    pstart = torch.minimum(torch.clamp(pos - (W - 1), min=0), lens).to(torch.int32)
    pstart[::2] = 0
    dstart = torch.where(torch.arange(B, device=dev) % 2 == 1,
                         torch.clamp(dstart, min=slot - (W - 1)), dstart)
    # sinks of alternating sign, large against the logits' LSE (~6), so that
    # each head's output depends on its own sink and the planted fault shows
    sinks = rng.normal(size=nh) + np.where(np.arange(nh) % 2 == 0, 8.0, -8.0)
    return q, kc, vc, scl, lens, dstart, pstart, slot, torch.from_numpy(
        sinks.astype(np.float32)).to(dev)


def _sink_err(out, ref, int8):
    if int8:
        return _q8_excess(out, ref)
    return (out.float() - ref.float()).abs().max().item() - ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dh,nh,nkv", [(64, 64, 8), (128, 12, 2), (64, 6, 6)])
def test_ragged_sink_kernels_match_plain(dev, int8, dh, nh, nkv):
    """K5s (bf16 and int8 entries) at dh 64 (GPT-OSS's 64/8 heads) and 128,
    full and window-clipped ranges; the sinks of the next head fail."""
    rng = np.random.default_rng(200 + dh + nh + int8)
    q, kc, vc, scl, lens, dstart, pstart, slot, sinks = _sink_case(rng, dev, dh, nh, nkv, int8)
    name = "ragged_decode_attention_q8_sink" if int8 else "ragged_decode_attention_sink"
    for layer in (0, 1):
        before = _cuda.LAUNCHES[name]
        out = rda.ragged_decode_attention(q, kc, vc, layer, lens, dstart, slot, pstart,
                                          cache_scale=scl, sinks=sinks)
        ref = rda.ragged_decode_plain(q, kc, vc, layer, lens, dstart, slot, pstart,
                                      cache_scale=scl, sinks=sinks)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[name] == before + 1
        assert torch.isfinite(out.float()).all()
        assert _sink_err(out, ref, int8) <= 0
    bad = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl,
                                      sinks=sinks.roll(-1).contiguous())
    torch.cuda.synchronize()
    assert _sink_err(bad, ref, int8) > 0


@pytest.mark.cuda
def test_ragged_sink_kernel_rows_without_keys_are_zero(dev):
    """A row whose prompt segment is empty and whose decode segment starts
    past the slot sees no key: 0, the whole mass on the sink."""
    rng = np.random.default_rng(9)
    q = _bf16(rng, (2, 8, 64), dev)
    c = _bf16(rng, (1, 2, 1, 64, 64), dev)
    lens = torch.tensor([5, 5], dtype=torch.int32, device=dev)
    pstart = torch.tensor([0, 5], dtype=torch.int32, device=dev)
    dstart = torch.tensor([10, 11], dtype=torch.int32, device=dev)
    out = rda.ragged_decode_attention(q, c, c, 0, lens, dstart, 10, pstart,
                                      sinks=torch.zeros(8, device=dev))
    torch.cuda.synchronize()
    assert (out[1] == 0).all() and out[0].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dh,nh,nkv", [(64, 64, 8), (128, 12, 2)])
@pytest.mark.parametrize("T,qstart", [(64, 512), (512, 0), (37, (30, 5, 200))])
def test_flash_window_kernels_match_plain(dev, dh, nh, nkv, T, qstart):
    """Windowed K3 (W=128: a suffix prefill at qstart 512, a fresh prefill,
    per-row offsets with a hole) and dh 64/128, counted under the windowed
    name; a window off by one fails the check."""
    rng = np.random.default_rng(300 + dh + T)
    B, S, W = 3, 640, 128
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, S, nkv, dh), dev), _bf16(rng, (B, S, nkv, dh), dev)
    qs = torch.as_tensor(qstart, device=dev).reshape(-1).expand(B).to(torch.int32)
    kv_valid = (torch.arange(S, device=dev)[None, :] < (qs + T)[:, None]).to(torch.int32)
    kv_valid[:, 3:9] = 0
    scale = dh ** -0.5
    before = dict(_cuda.LAUNCHES)
    out, lse = fa._attention_cuda(q, k, v, kv_valid, qs, scale, "flash_attention_cached", W)
    ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qs, scale, W)
    bad = fa._attention_cuda(q, k, v, kv_valid, qs, scale, "flash_attention_cached", W + 1)[0]
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_cached_window"] == (
        before["flash_attention_cached_window"] + 2)
    assert _cuda.LAUNCHES["flash_attention_cached"] == before["flash_attention_cached"]
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    seen = ref_lse > -1e29
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= 1e-3
    assert (bad.float() - ref.float()).abs().max().item() > ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 128])
def test_flash_dh64_no_cache_window_and_sinks(dev, window):
    """K1 at dh 64 (the GPT-OSS value forward): padded rows, the window,
    the sinks folded outside the kernel."""
    rng = np.random.default_rng(400 + window)
    B, T, nh, nkv, dh = 3, 512, 64, 8, 64
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, 400:] = 0
    mask[2, :100] = 0
    sinks = torch.from_numpy(rng.normal(size=nh).astype(np.float32)).to(dev)
    name = "flash_attention_window" if window else "flash_attention"
    before = _cuda.LAUNCHES[name]
    out = fa.flash_attention(q, k, v, mask, window=window, sinks=sinks).float()
    ref = fa.attention_plain(q, k, v, mask, torch.zeros(B, dtype=torch.int32, device=dev),
                             dh ** -0.5, window, sinks)[0].float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 1
    assert (out - ref).abs().max().item() <= ATOL


@pytest.mark.cuda
def test_windowed_and_dh64_backward_raise_on_the_card(dev):
    """The windowed, dh-64, dh-96, dh-256 and softcapped backward run the K2
    kernels on the card, through the autograd Function (with sinks where
    the model has them), against the plain backward at K2's limit; a
    (Q/K, V) head-dim pair without an instance (256, 128) and a head dim the
    kernels do not take (dh 80) still raise, naming the pair; the dh-96
    backward (Phi-3) runs, banded and with sinks too; the sink backward at
    dh 128 without a window runs the K2 kernels."""
    rng = np.random.default_rng(11)
    for dh, window, cap, sink in ((128, 16, 0.0, True), (64, 0, 0.0, True), (64, 24, 0.0, True),
                                  (256, 0, 0.0, False), (256, 16, 50.0, False),
                                  (128, 0, 50.0, False), (96, 0, 0.0, False),
                                  (96, 24, 0.0, True)):
        B, T, nh, nkv = 2, 100, 8, 2
        q_sd = 25.0 if cap else 1.0  # the cap bites: |q·k|/sqrt(dh) reaches 2-3x it
        q = (_bf16(rng, (B, T, nh, dh), dev) * q_sd).requires_grad_(True)
        k, v = (_bf16(rng, (B, T, nkv, dh), dev).requires_grad_(True) for _ in range(2))
        sinks = torch.from_numpy(rng.normal(size=nh).astype(np.float32)).to(dev)
        sinks.requires_grad_(True)
        mask = torch.ones((B, T), dtype=torch.int32, device=dev)
        mask[1, 80:] = 0
        do = _bf16(rng, (B, T, nh, dh), dev)
        leaves = (q, k, v, sinks) if sink else (q, k, v)
        name = fa.launch_name("flash_attention_bwd_dq", window, cap)
        before = _cuda.LAUNCHES[name]
        kw = dict(window=window, softcap=cap, sinks=sinks if sink else None)
        got = torch.autograd.grad(fa.flash_attention(q, k, v, mask, **kw), leaves, do)
        cpu = [t.detach().float().cpu().requires_grad_(True) for t in leaves]
        kw["sinks"] = cpu[3] if sink else None
        ref = torch.autograd.grad(fa.flash_attention(*cpu[:3], mask.cpu(), **kw), cpu,
                                  do.float().cpu())
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[name] == before + 1, name
        _assert_bwd_close([g.cpu() for g in got[:3]], ref[:3])
        if sink:
            assert ((got[3].cpu() - ref[3]).abs().max().item()
                    <= BWD_RTOL * ref[3].abs().max() + 1e-3)
    q = _bf16(rng, (1, 32, 4, 128), dev).requires_grad_(True)
    sinks = torch.zeros(4, device=dev, requires_grad=True)
    before = _cuda.LAUNCHES["flash_attention_bwd_dq"]
    out = fa.flash_attention(q, _bf16(rng, (1, 32, 2, 128), dev), _bf16(rng, (1, 32, 2, 128), dev),
                             sinks=sinks)
    gq, gs = torch.autograd.grad(out.float().sum(), (q, sinks))
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_bwd_dq"] == before + 1
    assert torch.isfinite(gq.float()).all() and torch.isfinite(gs).all() and gs.abs().max() > 0
    # what K2 does not take raises, naming the pair
    for dh, dv_w, item in ((256, 128, r"head dims \(q/k 256, v 128\)"),
                           (80, 80, r"head dims \(q/k 80, v 80\)")):
        q, do = _bf16(rng, (1, 32, 4, dh), dev), _bf16(rng, (1, 32, 4, dv_w), dev)
        k, v = _bf16(rng, (1, 32, 2, dh), dev), _bf16(rng, (1, 32, 2, dv_w), dev)
        mask = torch.ones((1, 32), dtype=torch.int32, device=dev)
        qs = torch.zeros(1, dtype=torch.int32, device=dev)
        lse = torch.zeros((1, 4, 32), device=dev)
        delta = torch.zeros((1, 32, 4), device=dev)
        for fn in (fa.attention_bwd_dq_cuda, fa.attention_bwd_dkv_cuda):
            with pytest.raises(ValueError, match=item):
                fn(q, k, v, mask, qs, lse, do, delta, 0.1)


# ---------------------------------------------------------------- Gemma: softcap and dh 256

def _gemma_qkv(rng, dev, B, T, S, nh, nkv, q_scale):
    """dh-256 inputs; q ~ N(0, q_scale^2): with q_scale 25, q·k/16 reaches
    2-3x a softcap of 50 (with unit q the cap would move a logit by ~1e-5)."""
    dh = 256
    q = torch.from_numpy((rng.normal(size=(B, T, nh, dh)) * q_scale).astype(np.float32))
    return (q.to(dev, torch.bfloat16), _bf16(rng, (B, S, nkv, dh), dev),
            _bf16(rng, (B, S, nkv, dh), dev))


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("nh,nkv,window", [(8, 4, 4096), (8, 4, 0), (4, 1, 512), (4, 1, 0)])
@pytest.mark.parametrize("T,S,qstart", [(64, 640, 512), (512, 640, 0), (37, 300, (30, 5, 200))])
def test_flash_dh256_softcap_kernels_match_plain(dev, softcap, nh, nkv, window, T, S, qstart):
    """K3 at dh 256 (Gemma-2's 8/4 heads with its 4096 window, Gemma-3's
    4/1 with 512, and unbanded): a suffix prefill at qstart 512, a fresh
    prefill, per-row offsets with a hole; with and without the softcap of
    50, counted under their own names. With the softcap the kernel run
    without it (a planted fault) fails the check."""
    rng = np.random.default_rng(500 + T + nh + window)
    B = 3
    q, k, v = _gemma_qkv(rng, dev, B, T, S, nh, nkv, 25.0 if softcap else 1.0)
    qs = torch.as_tensor(qstart, device=dev).reshape(-1).expand(B).to(torch.int32)
    kv_valid = (torch.arange(S, device=dev)[None, :] < (qs + T)[:, None]).to(torch.int32)
    kv_valid[:, 3:9] = 0
    scale = 1.0 / 16
    name = fa.launch_name("flash_attention_cached", window, softcap)
    before = _cuda.LAUNCHES[name]
    out, lse = fa._attention_cuda(q, k, v, kv_valid, qs, scale, "flash_attention_cached", window,
                                  softcap)
    ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qs, scale, window, softcap=softcap)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    seen = ref_lse > -1e29
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= 1e-3
    if softcap:
        s = torch.einsum("bthd,bshd->bhts", q.float()[:, :, :nkv], k.float()) * scale
        assert s.abs().max().item() > softcap  # the cap bites
        bad = fa._attention_cuda(q, k, v, kv_valid, qs, scale, "flash_attention_cached", window)[0]
        torch.cuda.synchronize()
        assert (bad.float() - ref.float()).abs().max().item() > ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_flash_dh256_no_cache_kernel_and_backward_raise(dev, softcap):
    """K1 at dh 256 (the value forward and the training forward) with padded
    rows, Gemma-2's window and softcap; its backward through the autograd
    Function runs the dh-256 K2 kernels (softcapped ones with the cap) and
    matches the plain backward on the CPU, as does a softcapped backward at
    dh 128."""
    rng = np.random.default_rng(600 + int(softcap))
    B, T, nh, nkv = 3, 512, 8, 4
    q, k, v = _gemma_qkv(rng, dev, B, T, T, nh, nkv, 25.0 if softcap else 1.0)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, 400:] = 0
    mask[2, :100] = 0
    name = fa.launch_name("flash_attention", 0, softcap)
    before = _cuda.LAUNCHES[name]
    out = fa.flash_attention(q, k, v, mask, scale=1.0 / 16, softcap=softcap).float()
    ref = fa.attention_plain(q, k, v, mask, torch.zeros(B, dtype=torch.int32, device=dev),
                             1.0 / 16, softcap=softcap)[0].float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 1
    assert (out - ref).abs().max().item() <= ATOL
    for dh, cap in ((256, softcap), (128, 50.0)):
        sd = 25.0 if cap else 1.0
        qg = (_bf16(rng, (2, 96, 4, dh), dev) * sd).requires_grad_(True)
        kg, vg = (_bf16(rng, (2, 96, 2, dh), dev).requires_grad_(True) for _ in range(2))
        do = _bf16(rng, (2, 96, 4, dh), dev)
        bwd = fa.launch_name("flash_attention_bwd_dkv", 0, cap)
        before = _cuda.LAUNCHES[bwd]
        got = torch.autograd.grad(fa.flash_attention(qg, kg, vg, softcap=cap), (qg, kg, vg), do)
        cpu = [t.detach().float().cpu().requires_grad_(True) for t in (qg, kg, vg)]
        ref = torch.autograd.grad(fa.flash_attention(*cpu, softcap=cap), cpu, do.float().cpu())
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[bwd] == before + 1
        _assert_bwd_close([g.cpu() for g in got], ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,nh,nkv", [(256, 8, 4), (256, 4, 1), (128, 12, 2), (64, 64, 8)])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("T,window", [(300, 0), (1000, 128), (77, 16), (130, 1)])
def test_flash_bwd_dh256_softcap_kernels_match_plain(dev, dh, nh, nkv, softcap, T, window):
    """K2 at dh 256 (Gemma-2's 8/4 heads, Gemma-3's 4/1) and with the softcap
    at every head dim, full and banded (a band longer and shorter than a
    tile, W = 1), a right-padded row and a hole, Gemma's scale 1/16 at dh
    256; with the softcap q is scaled so that the logits reach 1-3x the cap,
    and the kernels run without it (a planted fault) fail the check."""
    rng = np.random.default_rng(dh + nh + T + window + int(softcap))
    B = 2
    q, do = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dh), dev)
    if softcap:
        q = (q.float() * 25.0).to(torch.bfloat16)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, (3 * T) // 4 + 1:] = 0
    mask[0, T // 3:T // 3 + T // 10] = 0
    scale = 1.0 / 16 if dh == 256 else dh ** -0.5
    got, ref = _bwd_pair(q, k, v, mask, 0, do, window, softcap, scale)
    _assert_bwd_close(got, ref)
    if softcap:
        s = torch.einsum("bthd,bshd->bhts", q.float()[:, :, :nkv], k.float()) * scale
        assert s.abs().max().item() > softcap  # the cap bites
        qs = torch.zeros(B, dtype=torch.int32, device=dev)
        out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", window,
                                      softcap)
        args = (q, k, v, mask, qs, lse, do, (do.float() * out.float()).sum(-1), scale, window)
        bad = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
        torch.cuda.synchronize()
        with pytest.raises(AssertionError):
            _assert_bwd_close(bad, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("nh,nkv,W", [(8, 4, 4096), (4, 1, 512)])
def test_ragged_dh256_softcap_kernels_match_plain(dev, int8, softcap, nh, nkv, W):
    """K4/K5 at dh 256 at the Gemma shapes (24 rows over S=640, prompts up
    to 512, the window's clipped ranges on half the rows), with and without
    the softcap of 50, the int8 entry's K scale folded before the cap; with
    the softcap the kernel run without it (a planted fault) fails."""
    rng = np.random.default_rng(700 + nh + int8 + int(softcap))
    L, B, S, slot, dh = 2, 24, 640, 560, 256
    q = torch.from_numpy((rng.normal(size=(B, nh, dh)) * (25.0 if softcap else 1.0)).astype(
        np.float32)).to(dev, torch.bfloat16)
    kc, vc = _bf16(rng, (L, B, nkv, S, dh), dev), _bf16(rng, (L, B, nkv, S, dh), dev)
    scl = None
    if int8:
        (kc, ks), (vc, vs) = _quantize_kv(kc), _quantize_kv(vc)
        scl = (ks, vs)
    lens = torch.from_numpy(rng.integers(1, 513, B).astype(np.int32)).to(dev)
    pos = lens + (slot - 512)
    pstart = torch.minimum(torch.clamp(pos - (W - 1), min=0), lens).to(torch.int32)
    pstart[::2] = 0
    dstart = torch.where(torch.arange(B, device=dev) % 2 == 1,
                         torch.full_like(lens, max(512, slot - (W - 1))),
                         torch.full_like(lens, 512)).to(torch.int32)
    name = ("ragged_decode_attention" + ("_q8" if int8 else "")
            + ("_softcap" if softcap else ""))
    kw = dict(scale=1.0 / 16, cache_scale=scl)

    def err(out, ref):
        return _q8_excess(out, ref) if int8 else (out.float() - ref.float()).abs().max().item() - ATOL

    for layer in (0, 1):
        before = _cuda.LAUNCHES[name]
        out = rda.ragged_decode_attention(q, kc, vc, layer, lens, dstart, slot, pstart,
                                          softcap=softcap, **kw)
        ref = rda.ragged_decode_plain(q, kc, vc, layer, lens, dstart, slot, pstart,
                                      softcap=softcap, **kw)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[name] == before + 1
        assert torch.isfinite(out.float()).all()
        assert err(out, ref) <= 0
    if softcap:
        bad = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, **kw)
        torch.cuda.synchronize()
        assert err(bad, ref) > 0


# ---------------------------------------------------------------- DeepSeek MLA: V narrower than Q/K


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,qstart,lens", [
    (4, 512, 640, 0, (512, 300, 450, 77)),             # engine prefill, ragged prompts
    (4, 64, 640, 512, (576, 560, 576, 530)),           # prefix-hit suffix, ragged kv_valid
    (2, 37, 100, (30, 5), None),                       # tile edges, per-row qstart, a hole
])
def test_flash_narrow_v_cached_kernel_matches_plain(dev, B, T, S, qstart, lens):
    """K3 at Q/K 192 and V 128 (DeepSeek-V2-Lite's 16/16 heads and its
    scale 1/sqrt(192)), counted as flash_attention_cached_narrowv; the V
    of the next head (a planted fault) fails the check."""
    rng = np.random.default_rng(900 + T)
    nh, dh, dv = 16, 192, 128
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, S, nh, dh), dev), _bf16(rng, (B, S, nh, dv), dev)
    ar = torch.arange(S, device=dev)[None, :]
    if lens is None:
        kv_valid = (ar < torch.as_tensor(qstart, device=dev).reshape(-1, 1) + T).to(torch.int32)
        kv_valid[:, 12:20] = 0
    else:
        kv_valid = (ar < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)
    before = _cuda.LAUNCHES["flash_attention_cached_narrowv"]
    out, ref, lse, ref_lse = _flash_pair(q, k, v, kv_valid, qstart, "flash_attention_cached")
    assert _cuda.LAUNCHES["flash_attention_cached_narrowv"] == before + 1
    assert out.shape == (B, T, nh, dv) and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= ATOL
    seen = ref_lse > -1e29
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= 1e-3
    bad, _, _, _ = _flash_pair(q, k, v.roll(-1, dims=2).contiguous(), kv_valid, qstart,
                               "flash_attention_cached")
    assert (bad - ref).abs().max().item() > ATOL


@pytest.mark.cuda
def test_flash_narrow_v_no_cache_kernel_and_refusals(dev):
    """K1 at Q/K 192 and V 128 with padded rows (the value forward), counted
    as flash_attention_narrowv; its backward through the autograd Function
    runs K2 at (192, 128), counted as flash_attention_bwd_{dq,dkv}_narrowv,
    within K2's limit of the plain backward on the CPU; a (dh, dv) pair
    without an instance raises in either direction."""
    rng = np.random.default_rng(901)
    B, T, nh, dh, dv = 4, 512, 16, 192, 128
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dv), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, 400:] = 0
    mask[3, 130:] = 0
    before = _cuda.LAUNCHES["flash_attention_narrowv"]
    out = fa.flash_attention(q, k, v, mask, scale=dh ** -0.5).float()
    ref = fa.attention_plain(q, k, v, mask, torch.zeros(B, dtype=torch.int32, device=dev),
                             dh ** -0.5)[0].float()
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["flash_attention_narrowv"] == before + 1
    assert out.shape == (B, T, nh, dv)
    assert (out - ref).abs().max().item() <= ATOL
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    do = _bf16(rng, (B, T, nh, dv), dev)
    names = [fa.launch_name(n, narrowv=True)
             for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")]
    before = [_cuda.LAUNCHES[n] for n in names]
    got = torch.autograd.grad(fa.flash_attention(*leaves, mask, scale=dh ** -0.5), leaves, do)
    cpu = [t.detach().float().cpu().requires_grad_(True) for t in leaves]
    ref = torch.autograd.grad(fa.flash_attention(*cpu, mask.cpu(), scale=dh ** -0.5), cpu,
                              do.float().cpu())
    torch.cuda.synchronize()
    assert [_cuda.LAUNCHES[n] for n in names] == [b + 1 for b in before]
    assert [tuple(g.shape) for g in got] == [(B, T, nh, dh), (B, T, nh, dh), (B, T, nh, dv)]
    _assert_bwd_close([g.cpu() for g in got], ref)
    qs = torch.zeros(B, dtype=torch.int32, device=dev)
    lse = torch.zeros((B, nh, T), device=dev)
    delta = torch.zeros((B, T, nh), device=dev)
    for dq, dvv in ((192, 64), (256, 128)):
        qq, kk = _bf16(rng, (B, T, nh, dq), dev), _bf16(rng, (B, T, nh, dq), dev)
        vv, dd = _bf16(rng, (B, T, nh, dvv), dev), _bf16(rng, (B, T, nh, dvv), dev)
        for fn in (fa.attention_bwd_dq_cuda, fa.attention_bwd_dkv_cuda):
            with pytest.raises(ValueError, match=f"head dims \\(q/k {dq}, v {dvv}\\)"):
                fn(qq, kk, vv, mask, qs, lse, dd, delta, 0.1)
    for dq, dvv in ((192, 64), (128, 64), (256, 128), (192, 192)):
        with pytest.raises(ValueError, match=f"head dims \\(q/k {dq}, v {dvv}\\)"):
            fa._attention_cuda(q[..., :dq].contiguous() if dq <= dh else _bf16(rng, (B, T, nh, dq), dev),
                               _bf16(rng, (B, T, nh, dq), dev), _bf16(rng, (B, T, nh, dvv), dev),
                               mask, qs, 0.1, "flash_attention")


@pytest.mark.cuda
def test_deepseek_forward_and_decode_on_the_card_match_the_cpu(dev, monkeypatch):
    """A small DeepSeek model at the served head dims (Q/K 192, V 128,
    latent 512 + 64), one dense and one MoE layer: prefill, one decode step
    over the bf16 latent cache and one over its int8 quantization on the
    card (kernels, bf16; the absorbed decode's products with f32 output)
    against the CPU (plain versions, f32, the card's routing replayed so
    that bf16 routing flips do not count); the narrow-V K3 and K8 launch,
    no decode kernel does."""
    from lapha_tpu_torch.engine.engine import Engine
    from lapha_tpu_torch.models import deepseek
    from lapha_tpu_torch.ops import moe
    from lapha_tpu_torch.train.losses import tree_map

    cfg = deepseek.DeepseekConfig(vocab_size=1024, hidden_size=512, intermediate_size=1024,
                                  num_hidden_layers=2, num_attention_heads=4, n_routed_experts=8,
                                  num_experts_per_tok=2, moe_intermediate_size=256,
                                  n_shared_experts=1, dtype=torch.bfloat16)
    params = deepseek.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cpu = tree_map(lambda t: t.to("cpu", torch.float32), params)
    cfg_cpu = deepseek.DeepseekConfig(**{**cfg.__dict__, "dtype": torch.float32})
    rng = np.random.default_rng(2)
    B, T, S = 3, 40, 64
    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, T)))
    nxt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B,)))
    lens = torch.full((B,), T, dtype=torch.int32)

    def run(p, c, device):
        with torch.inference_mode():
            cache = deepseek.init_kv_cache(c, B, S, device)
            logits, _, cache = deepseek.forward(p, c, ids.to(device), kv_cache=cache, cache_pos=0)
            ck, cv = (x.permute(0, 1, 3, 2, 4).contiguous() for x in cache)
            steps = [logits.float().cpu()]
            for k, v, scl in ((ck.clone(), cv, None), Engine._quantize_cache(ck, cv)):
                steps.append(deepseek.decode_step(p, c, nxt.to(device), lens.to(device), k, v, T,
                                                  lens.to(device), lens.to(device),
                                                  cache_scale=scl)[0].float().cpu())
        return steps

    route, seen = moe.route_deepseek, []

    def recording(x, *a, **kw):
        topw, topi = route(x, *a, **kw)
        seen.append((topw.float().cpu(), topi.cpu()))
        return topw, topi

    monkeypatch.setattr(moe, "route_deepseek", recording)
    before = dict(_cuda.LAUNCHES)
    got = run(params, cfg, dev)
    torch.cuda.synchronize()
    # K8: the prefill's 240 pair rows over 8 experts on the wgmma kernel, the
    # decode's 6 on the decode kernel
    for name, count in _cuda.LAUNCHES.items():
        ran = name in ("flash_attention_cached_narrowv", "grouped_gemm", "grouped_gemm_wg")
        assert (count > before[name]) == ran, name
    replay = iter(seen)
    monkeypatch.setattr(moe, "route_deepseek", lambda *a, **kw: next(replay))
    for a, b in zip(got, run(cpu, cfg_cpu, torch.device("cpu"))):
        assert float((a - b).norm() / b.norm()) <= 5e-2


# ---------------------------------------------------------------- dh 96 (Phi-3), groups > 8

@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(32, 32), (8, 2)])
@pytest.mark.parametrize("name,T,S,qstart,window", [
    ("flash_attention_cached", 512, 640, 0, 0),      # fresh prefill
    ("flash_attention_cached", 64, 768, 512, 0),     # prefix-hit suffix prefill
    ("flash_attention_cached", 300, 640, 200, 128),  # banded, the band biting
    ("flash_attention", 512, 512, 0, 0),             # value forward
    ("flash_attention", 300, 300, 0, 64),            # banded no-cache forward
])
def test_flash_dh96_kernels_match_plain(dev, nh, nkv, name, T, S, qstart, window):
    """K1/K3 at head dim 96 (Phi-3's 32/32 heads and a group of 4), full and
    banded, ragged rows with a hole, counted under the launch name; where
    the band bites a window off by one (a planted fault) fails."""
    rng = np.random.default_rng(900 + T + S + window + nh)
    B, dh = 3, 96
    q = _bf16(rng, (B, T, nh, dh), dev)
    k, v = _bf16(rng, (B, S, nkv, dh), dev), _bf16(rng, (B, S, nkv, dh), dev)
    qs = torch.full((B,), qstart, dtype=torch.int32, device=dev)
    lens = torch.tensor([qstart + T, qstart + T - 17, qstart + T - 40], device=dev)
    kv_valid = (torch.arange(S, device=dev)[None, :] < lens[:, None]).to(torch.int32)
    kv_valid[0, 5:12] = 0
    scale = dh ** -0.5
    key = fa.launch_name(name, window)
    before = _cuda.LAUNCHES[key]
    out, lse = fa._attention_cuda(q, k, v, kv_valid, qs, scale, name, window)
    ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qs, scale, window)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[key] == before + 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    seen = ref_lse > -1e29
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= 1e-3
    if window:
        bad = fa._attention_cuda(q, k, v, kv_valid, qs, scale, name, window + 1)[0]
        torch.cuda.synchronize()
        assert (bad.float() - ref.float()).abs().max().item() > ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("nh,nkv", [(32, 32), (8, 2)])
@pytest.mark.parametrize("T,window", [(1, 0), (300, 0), (1000, 128), (77, 16)])
def test_flash_bwd_dh96_kernels_match_plain(dev, nh, nkv, T, window):
    """K2 at head dim 96 (Phi-3's 32/32 heads and a group of 4), full and
    banded, a right-padded row and a hole, phase 1b's limit; a window off
    by one (a planted fault) fails where the band bites."""
    rng = np.random.default_rng(950 + T + window + nh)
    B, dh = 2, 96
    q, do = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, T, nh, dh), dev)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dh), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, (3 * T) // 4 + 1:] = 0
    mask[0, T // 3:T // 3 + T // 10] = 0
    got, ref = _bwd_pair(q, k, v, mask, 0, do, window)
    _assert_bwd_close(got, ref)
    if window and window < T:
        qs, scale = torch.zeros(B, dtype=torch.int32, device=dev), dh ** -0.5
        out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", window)
        args = (q, k, v, mask, qs, lse, do, (do.float() * out.float()).sum(-1), scale, window + 1)
        bad = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
        torch.cuda.synchronize()
        with pytest.raises(AssertionError):
            _assert_bwd_close(bad, ref)


def _decode_case(rng, dev, dh, nh, nkv, int8, W=2047, scale_q=1.0):
    """24 decode rows over S=640, prompts up to 512, decode columns from
    512, a window's clipped ranges on the odd rows (a W past the prompt
    clips nothing)."""
    L, B, S, slot = 2, 24, 640, 600
    q = torch.from_numpy((rng.normal(size=(B, nh, dh)) * scale_q).astype(np.float32)).to(
        dev, torch.bfloat16)
    kc, vc = _bf16(rng, (L, B, nkv, S, dh), dev), _bf16(rng, (L, B, nkv, S, dh), dev)
    scl = None
    if int8:
        (kc, ks), (vc, vs) = _quantize_kv(kc), _quantize_kv(vc)
        scl = (ks, vs)
    lens = torch.from_numpy(rng.integers(1, 513, B).astype(np.int32)).to(dev)
    pos = lens + (slot - 512)
    odd = torch.arange(B, device=dev) % 2 == 1
    pstart = torch.where(odd, torch.minimum(torch.clamp(pos - (W - 1), min=0), lens),
                         torch.zeros_like(lens)).to(torch.int32)
    dstart = torch.where(odd, torch.full_like(lens, max(512, slot - (W - 1))),
                         torch.full_like(lens, 512)).to(torch.int32)
    return q, kc, vc, scl, lens, dstart, pstart, slot


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dh,nh,nkv,W", [
    (96, 32, 32, 2047),   # Phi-3-mini: group 1, its window past every prompt
    (96, 32, 32, 200),    # the same heads with a band that clips
    (96, 8, 1, 200),      # dh 96 with a whole group of 8
    (128, 18, 2, 300),    # group 9: one CTA of 16 heads a KV head
    (128, 24, 2, 4096),   # StarCoder2-3B: group 12, one CTA
    (128, 32, 2, 300),    # group 16: 8 + 8
    (96, 32, 1, 300),     # group 32 at dh 96: two CTAs of 16 heads
])
def test_ragged_dh96_and_large_groups_match_plain(dev, int8, dh, nh, nkv, W):
    """K4/K5 at head dim 96 and at GQA groups above 8 (9, 12, 16, 32),
    bf16 and int8 caches, full and window-clipped ranges, counted under
    their entries; K and V taken from the next layer (a planted fault)
    fail the check."""
    rng = np.random.default_rng(1000 + dh + nh + nkv + W + int8)
    q, kc, vc, scl, lens, dstart, pstart, slot = _decode_case(rng, dev, dh, nh, nkv, int8, W)
    name = "ragged_decode_attention_q8" if int8 else "ragged_decode_attention"

    def err(out, ref):
        if int8:
            return _q8_excess(out, ref)
        return (out.float() - ref.float()).abs().max().item() - ATOL

    for layer in (0, 1):
        before = _cuda.LAUNCHES[name]
        out = rda.ragged_decode_attention(q, kc, vc, layer, lens, dstart, slot, pstart,
                                          cache_scale=scl)
        ref = rda.ragged_decode_plain(q, kc, vc, layer, lens, dstart, slot, pstart,
                                      cache_scale=scl)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[name] == before + 1
        assert torch.isfinite(out.float()).all()
        assert err(out, ref) <= 0
    bad = rda.ragged_decode_attention(q, kc, vc, 0, lens, dstart, slot, pstart, cache_scale=scl)
    torch.cuda.synchronize()
    assert err(bad, ref) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dh,nh,nkv", [(128, 24, 2), (96, 36, 3)])
def test_ragged_sink_kernels_with_large_groups(dev, int8, dh, nh, nkv):
    """The sink entries at groups of 12: each head of the group merges its
    own sink; the sinks of the next head (a planted fault) fail."""
    rng = np.random.default_rng(1100 + dh + int8)
    q, kc, vc, scl, lens, dstart, pstart, slot = _decode_case(rng, dev, dh, nh, nkv, int8, 128)
    sinks = rng.normal(size=nh) + np.where(np.arange(nh) % 2 == 0, 8.0, -8.0)
    sinks = torch.from_numpy(sinks.astype(np.float32)).to(dev)
    out = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl,
                                      sinks=sinks)
    ref = rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl,
                                  sinks=sinks)
    bad = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl,
                                      sinks=sinks.roll(-1).contiguous())
    torch.cuda.synchronize()
    assert _sink_err(out, ref, int8) <= 0
    assert _sink_err(bad, ref, int8) > 0


# ---------------------------------------------------------------- the wgmma forward (K1/K3) and K2 above dh 128


# (head dim of Q/K, of V, heads, KV heads) of the forward's wgmma instances
FWD_WG_DIMS = [(64, 64, 16, 2), (96, 96, 8, 8), (128, 128, 12, 2), (192, 128, 8, 8)]


def _fwd_case(rng, dev, case, dh, dv, nh, nkv):
    """(q, k, v, kv_valid, qstart (B,), window) of one masking case:
    'hole' — invalid keys inside a tile that the causal and band limits
    leave interior (the trap of a per-tile all-valid shortcut); 'edges' — T
    and S not multiples of the 64-key tile, per-row qstart; 'past_window' —
    per-row qstart past W, so that the band's first tile differs per row and
    bites; 'no_key' — left padding: rows that see no key."""
    B = 2
    T, S, qstart, window = {"hole": (300, 300, (0, 0), 0), "edges": (77, 333, (200, 256), 0),
                            "past_window": (150, 700, (520, 300), 200),
                            "no_key": (100, 100, (0, 0), 16)}[case]
    q, k, v = _bf16(rng, (B, T, nh, dh), dev), _bf16(rng, (B, S, nkv, dh), dev), _bf16(
        rng, (B, S, nkv, dv), dev)
    qs = torch.tensor(qstart, dtype=torch.int32, device=dev)
    kv_valid = (torch.arange(S, device=dev)[None, :] < qs[:, None] + T).to(torch.int32)
    if case == "hole":
        kv_valid[0, 70:73] = 0   # inside key tile 64-127, interior for rows from 128
        kv_valid[1, 200] = 0     # one key, interior for rows from 256
    elif case == "no_key":
        kv_valid[0, :40] = 0     # rows 0-39 of row 0 see no key
        kv_valid[1, :] = 0       # row 1 sees none at all
    return q, k, v, kv_valid, qs, window


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dv,nh,nkv", FWD_WG_DIMS)
@pytest.mark.parametrize("case", ["hole", "edges", "past_window", "no_key"])
def test_flash_wg_forward_masks_every_tile_that_needs_it(dev, dh, dv, nh, nkv, case):
    """The wgmma forward skips the per-element mask on interior tiles only:
    against the plain version (3e-2, LSE 1e-3 on rows that see a key), rows
    that see no key give 0 and LSE -1e30, two launches are bit-equal, and
    the banded case run with W + 1 (a planted fault) fails."""
    rng = np.random.default_rng(1200 + dh + len(case))
    q, k, v, kv_valid, qs, window = _fwd_case(rng, dev, case, dh, dv, nh, nkv)
    scale = dh ** -0.5
    out, lse = fa._attention_cuda(q, k, v, kv_valid, qs, scale, "flash_attention_cached", window)
    again, lse2 = fa._attention_cuda(q, k, v, kv_valid, qs, scale, "flash_attention_cached",
                                     window)
    ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qs, scale, window)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    seen = ref_lse > -1e29
    assert (lse[seen] - ref_lse[seen]).abs().max().item() <= 1e-3
    assert (lse[~seen] == -1e30).all()
    assert (out.transpose(1, 2)[~seen] == 0).all()
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    if case == "no_key":
        assert (~seen).any()
    if window:
        bad = fa._attention_cuda(q, k, v, kv_valid, qs, scale, "flash_attention_cached",
                                 window + 1)[0]
        torch.cuda.synchronize()
        assert (bad.float() - ref.float()).abs().max().item() > ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dv,nh,nkv", FWD_WG_DIMS)
def test_flash_wg_forward_softcap_and_no_cache_entry(dev, dh, dv, nh, nkv):
    """The capped instance at every wgmma head dim (q scaled so the logits
    reach 1-3x the cap of 50; the cap dropped, a planted fault, fails), and
    the no-cache entry with padded rows, counted under its own names."""
    rng = np.random.default_rng(1300 + dh)
    B, T = 2, 200
    q = (_bf16(rng, (B, T, nh, dh), dev).float() * 25.0).to(torch.bfloat16)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dv), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, 150:] = 0
    qs = torch.zeros(B, dtype=torch.int32, device=dev)
    scale = dh ** -0.5
    name = fa.launch_name("flash_attention", 0, 50.0, narrowv=dv < dh)
    before = _cuda.LAUNCHES[name]
    out = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", 0, 50.0)[0]
    ref = fa.attention_plain(q, k, v, mask, qs, scale, softcap=50.0)[0]
    bad = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention")[0]
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= ATOL
    assert (bad.float() - ref.float()).abs().max().item() > ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("dh,dv,nh,nkv,softcap", [
    (192, 128, 16, 16, 0.0),  # DeepSeek MLA: dq on 64-key tiles, dk/dv split by role
    (192, 128, 8, 2, 50.0),   # ... capped, the group split in parts
    (256, 256, 4, 1, 0.0),    # Gemma-3: dq on 32-key tiles, dk/dv two stages
    (256, 256, 8, 4, 50.0),   # Gemma-2, capped
])
@pytest.mark.parametrize("T,window", [(333, 0), (200, 64), (1, 0)])
def test_flash_bwd_wide_head_kernels_match_plain_and_repeat(dev, dh, dv, nh, nkv, softcap, T,
                                                            window):
    """K2 above dh 128 on wgmma: against the plain backward at K2's limits,
    T not a multiple of any tile (and T = 1), banded, a right-padded row and
    a hole; two launches bit-equal; dO of the next head (a planted fault)
    fails."""
    rng = np.random.default_rng(1400 + dh + dv + nh + T + window)
    B = 2
    q = _bf16(rng, (B, T, nh, dh), dev)
    if softcap:
        q = (q.float() * 25.0).to(torch.bfloat16)
    k, v = _bf16(rng, (B, T, nkv, dh), dev), _bf16(rng, (B, T, nkv, dv), dev)
    do = _bf16(rng, (B, T, nh, dv), dev)
    mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    mask[1, (3 * T) // 4 + 1:] = 0
    mask[0, T // 3:T // 3 + T // 10] = 0
    scale = 1.0 / 16 if dh == 256 else dh ** -0.5
    got, ref = _bwd_pair(q, k, v, mask, 0, do, window, softcap, scale)
    _assert_bwd_close(got, ref)
    again, _ = _bwd_pair(q, k, v, mask, 0, do, window, softcap, scale)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    if T > 1:
        bad, _ = _bwd_pair(q, k, v, mask, 0, do.roll(-1, dims=2).contiguous(), window, softcap,
                           scale)
        with pytest.raises(AssertionError):
            _assert_bwd_close(bad, ref)


# ---------------------------------------------------------------- the decode kernel's split (K4/K5)


def _force_plan(monkeypatch, splits, stages=None):
    """The wrapper's plan with ``splits`` CTAs a row (and ``stages``, else the
    plan's own)."""
    real = rda.split_plan

    def plan(*args, **kwargs):
        own = real(*args, **kwargs)
        return rda.Plan(splits, own.stages if stages is None else stages)

    monkeypatch.setattr(rda, "split_plan", plan)


def _lse_sinks(q, kc, scl, lens, dstart, pstart, slot, scale, rng):
    """One sink per query head near its log-sum-exp (mean over the rows that
    see a key, + N(0, 0.3)): a sink counted more than once then moves the
    output well past the limits."""
    B, nh, dh = q.shape
    nkv, S = kc.shape[2], kc.shape[3]
    k = kc[1].float() * (scl[0][1].float()[..., None] if scl is not None else 1.0)
    s = torch.einsum("bkgd,bksd->bkgs", q.float().reshape(B, nkv, nh // nkv, dh), k) * scale
    valid = _ragged_valid(lens, dstart, pstart, slot, S)[:, None, None, :]
    lse = torch.logsumexp(torch.where(valid, s, -1e30), dim=-1).reshape(B, nh)
    seen = valid.reshape(B, S).any(-1)
    noise = torch.from_numpy((rng.normal(size=nh) * 0.3).astype(np.float32)).to(q.device)
    return (lse[seen].mean(0) + noise).contiguous()


def _ragged_valid(lens, dstart, pstart, slot, S):
    ar = torch.arange(S, device=lens.device)[None, :]
    return (((ar >= pstart[:, None]) & (ar < lens[:, None]))
            | ((ar >= dstart[:, None]) & (ar <= slot)))


def _split_case(rng, dev, dh, nh, nkv, int8, scale_q=1.0):
    """24 decode rows over S=640 as _decode_case's (prompts up to 512, decode
    columns from 512, a window of 300 clipping the odd rows), drawn on the
    card, with the last four made short: 1 and 2 valid slots, 7, and none
    (dstart past the slot), so that a row's slots fall inside one split and
    most splits are empty."""
    L, B, S, slot, W = 2, 24, 640, 600, 300
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))

    def bf16(*shape, sd=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * sd).to(torch.bfloat16)

    q = bf16(B, nh, dh, sd=scale_q)
    kc, vc = bf16(L, B, nkv, S, dh), bf16(L, B, nkv, S, dh)
    scl = None
    if int8:
        (kc, ks), (vc, vs) = _quantize_kv(kc), _quantize_kv(vc)
        scl = (ks, vs)
    lens = torch.from_numpy(rng.integers(1, 513, B).astype(np.int32)).to(dev)
    pos = lens + (slot - 512)
    odd = torch.arange(B, device=dev) % 2 == 1
    pstart = torch.where(odd, torch.minimum(torch.clamp(pos - (W - 1), min=0), lens),
                         torch.zeros_like(lens)).to(torch.int32)
    dstart = torch.where(odd, torch.full_like(lens, max(512, slot - (W - 1))),
                         torch.full_like(lens, 512)).to(torch.int32)
    lens[-4:] = torch.tensor([0, 0, 5, 0], dtype=torch.int32)
    pstart[-4:] = torch.tensor([0, 0, 0, 0], dtype=torch.int32)
    dstart[-4:] = torch.tensor([slot, slot - 1, slot - 1, slot + 1], dtype=torch.int32)
    return q, kc, vc, scl, lens, dstart, pstart, slot


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("sinks", [False, True])
@pytest.mark.parametrize("dh,nh,nkv", [(64, 64, 8), (96, 32, 32), (128, 12, 2), (256, 8, 4)])
def test_ragged_split_kernel_every_instance_and_split(dev, monkeypatch, dh, nh, nkv, sinks,
                                                      int8, splits):
    """Every instance (dh 64, 96, 128, 256 x bf16 / int8 x sinks or not) at
    every split count 1-8 forced through the plan, ring depths 1-4, window-
    clipped rows and rows of 0, 1, 2 and 7 valid slots: one launch a call,
    the limits of the smoke script, two launches bit-equal. With sinks near
    the LSE, the sink counted once per split (sink + log(splits), the
    planted fault) fails from two splits up."""
    rng = np.random.default_rng(3000 + dh + 10 * splits + 2 * sinks + int8)
    q, kc, vc, scl, lens, dstart, pstart, slot = _split_case(rng, dev, dh, nh, nkv, int8)
    scale = dh ** -0.5
    sk = _lse_sinks(q, kc, scl, lens, dstart, pstart, slot, scale, rng) if sinks else None
    _force_plan(monkeypatch, splits, stages=1 + splits % 4)
    name = ("ragged_decode_attention" + ("_q8" if int8 else "") + ("_sink" if sinks else ""))
    before = _cuda.LAUNCHES[name]
    out = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl,
                                      sinks=sk)
    again = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl,
                                        sinks=sk)
    ref = rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl,
                                  sinks=sk)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 2
    assert torch.isfinite(out.float()).all()
    assert _sink_err(out, ref, int8) <= 0
    assert torch.equal(out, again)
    assert (out[-1] == 0).all()  # the row without a key
    if sinks and splits > 1:
        bad = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart,
                                          cache_scale=scl, sinks=sk + float(np.log(splits)))
        torch.cuda.synchronize()
        assert _sink_err(bad, ref, int8) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("group", [1, 6, 7, 8, 12, 16, 32])
@pytest.mark.parametrize("splits", [None, 3])
def test_ragged_split_kernel_groups(dev, monkeypatch, group, int8, splits):
    """GQA groups 1, 6, 7, 8, 12, 16 (one CTA of a KV head reads its slots)
    and 32 (two CTAs of 16 heads), 2 KV heads at dh 128, at the plan's
    split count and at 3;
    each query head's output is its own (the heads of the next KV head's
    group, a planted fault through q, fail)."""
    rng = np.random.default_rng(3100 + group + int8)
    nkv = 2
    q, kc, vc, scl, lens, dstart, pstart, slot = _split_case(rng, dev, 128, group * nkv, nkv,
                                                             int8)
    if splits is not None:
        _force_plan(monkeypatch, splits)
    out = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl)
    ref = rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, slot, pstart, cache_scale=scl)
    bad = rda.ragged_decode_attention(q.roll(group, dims=1).contiguous(), kc, vc, 1, lens,
                                      dstart, slot, pstart, cache_scale=scl)
    torch.cuda.synchronize()
    assert _sink_err(out, ref, int8) <= 0
    assert _sink_err(bad, ref, int8) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dh,nh,nkv", [(256, 8, 4), (128, 24, 2), (64, 64, 8)])
@pytest.mark.parametrize("splits", [1, 5])
def test_ragged_split_kernel_softcap(dev, monkeypatch, dh, nh, nkv, int8, splits):
    """The softcap (50, the logit scale 1/16 and q x400/sqrt(dh), x25 at dh
    256, so that the logits are 1-3x the cap) on the true logit after the K
    scale, at one and five splits, counted under the entry's name +
    "_softcap"; the cap left off (a planted fault) fails."""
    rng = np.random.default_rng(3200 + dh + int8 + splits)
    q, kc, vc, scl, lens, dstart, pstart, slot = _split_case(rng, dev, dh, nh, nkv, int8,
                                                             scale_q=400 / dh ** 0.5)
    _force_plan(monkeypatch, splits)
    name = "ragged_decode_attention" + ("_q8" if int8 else "") + "_softcap"
    before = _cuda.LAUNCHES[name]
    out = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, 1 / 16,
                                      cache_scale=scl, softcap=50.0)
    ref = rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, slot, pstart, 1 / 16,
                                  cache_scale=scl, softcap=50.0)
    bad = rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, slot, pstart, 1 / 16,
                                      cache_scale=scl)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 1
    assert _sink_err(out, ref, int8) <= 0
    assert _sink_err(bad, ref, int8) > 0
