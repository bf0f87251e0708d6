"""Block diffusion's block attention (``lapha_tpu_torch/ops/block_attention``)
against lapha_tpu on the CPU (f32): the same numpy-made inputs go through
``block_attention_plain`` and JAX's dense attend (``qwen2._attend``) under
the mask of ``forward(block_bidir=True)`` (``lapha_tpu/models/qwen2.py:
1314-1322``: valid & ((j <= cache_pos + t) | (j >= cache_pos))), computed in
jnp, at T = 1, 4 and 16 block queries, GQA groups 1, 6 and 12, head dims 64
and 128, over caches with holes between the prompt and the committed
columns, a per-row cache_pos, a valid column past cache_pos + T (JAX sees
it) and a row with no valid column (the port gives 0 there; JAX's softmax
over all-masked logits averages V, a padding row nothing reads). Tolerance
2e-5: both sides are f32 and differ only in the order of their sums.

Also: the plan (``block_plan``) from shapes alone, within 227 KB of shared
memory up to 32768 columns, and the wrapper's host path up to its C call
(a recorded stand-in library): the entry, its arguments, one count, the
refusals.
"""

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.models import Qwen2Config as JCfg
from lapha_tpu.models import qwen2 as jq
from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import block_attention as ba

from verify_smem import FakeLib, kernel_smem

TOL = 2e-5
SMS = 132  # an H100 SXM's SMs


def _case(T, group, dh, seed=0, nkv=2, S=56, Lp=24, softcap=0.0):
    """Three rows: prompts of 9 and 13 columns, holes up to Lp, committed
    columns from Lp up to the row's block at cp (20 + 4 apart, so cache_pos
    is per row, and the block reaches past Lp), column cp + T + 1 of row 0
    valid past its block; row 2 with no valid column. The cache holds noise
    everywhere (invalid columns hold garbage)."""
    rng = np.random.default_rng(seed)
    B, nh = 3, nkv * group
    cp = np.array([Lp + 4, Lp + 8, Lp])
    j = np.arange(S)[None, :]
    kvv = (j < np.array([9, 13, 5])[:, None]) | ((j >= Lp) & (j < cp[:, None] + T))
    kvv[0, cp[0] + T + 1] = True
    kvv[2] = False
    scale = 3.0 if softcap else 1.0  # so that the cap bites
    q = (rng.normal(size=(B, T, nh, dh)) * scale).astype(np.float32)
    k = rng.normal(size=(B, S, nkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, nkv, dh)).astype(np.float32)
    return q, k, v, kvv, cp


def _jax_block(q, k, v, kvv, cp, softcap=0.0):
    """JAX's dense attend under forward(block_bidir=True)'s mask (one jit:
    eager JAX compiles every op)."""
    B, T, nh, dh = q.shape
    S, nkv = k.shape[1], k.shape[2]
    cfg = dataclasses.replace(JCfg.tiny(), num_attention_heads=nh, num_key_value_heads=nkv,
                              attn_softcap=softcap or None)

    def attend(q, k, v, kvv, cp):
        kpos = jnp.arange(S)[None, None, :]
        cp_btc = cp[:, None, None]
        qpos = cp_btc + jnp.arange(T)[None, :, None]
        mask = kvv[:, None, :] & ((kpos <= qpos) | (kpos >= cp_btc))
        return jq._attend(q, k, v, mask, cfg)

    return np.asarray(jax.jit(attend)(q, k, v, kvv, cp))


@pytest.mark.parametrize("T,group,dh,softcap", [
    (1, 6, 128, 0.0), (4, 6, 128, 0.0), (16, 1, 64, 0.0), (4, 12, 64, 0.0), (16, 12, 128, 0.0),
    (1, 1, 64, 0.0), (4, 6, 128, 5.0)])
def test_block_attention_plain_matches_jax(T, group, dh, softcap):
    q, k, v, kvv, cp = _case(T, group, dh, softcap=softcap)
    want = _jax_block(q, k, v, kvv, cp, softcap)
    got = ba.block_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(kvv), softcap=softcap).numpy()
    np.testing.assert_allclose(got[:2], want[:2], rtol=TOL, atol=TOL)
    assert not got[2].any()  # a row with no valid column gives 0
    # the valid column past row 0's block carries weight: a mask cut below
    # cache_pos + T (the route through the causal kernel) misses it
    cut = kvv & (np.arange(k.shape[1])[None, :] < cp[:, None] + T)
    old = ba.block_attention_plain(*map(torch.from_numpy, (q, k, v, cut)),
                                   softcap=softcap).numpy()
    assert np.abs(old[0] - want[0]).max() > 1e-3


def test_block_attention_plain_sees_the_block_both_ways():
    """Query 0 of a block sees the block's last column; a hole never shows,
    whatever its K/V hold."""
    q, k, v, kvv, cp = _case(4, 6, 64, seed=1)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, kvv))
    base = ba.block_attention_plain(tq, tk, tv, tm)
    k2 = tk.clone()
    k2[0, cp[0] + 3] += 1.0
    assert float((ba.block_attention_plain(tq, k2, tv, tm)[0, 0] - base[0, 0]).abs().max()) > 0
    hole = int(np.flatnonzero(~kvv[0])[0])
    k3, v3 = tk.clone(), tv.clone()
    k3[0, hole] = 1e3
    v3[0, hole] = 1e3
    assert torch.equal(ba.block_attention_plain(tq, k3, v3, tm), base)


# ---------------------------------------------------------------- the plan

# (nkv, group, dh): Qwen2.5-1.5B, Llama-3.2-1B, StarCoder2-3B's group of 12,
# a dh-256 group of 2, a group of 1
PLAN_MODELS = ((2, 6, 128), (8, 4, 64), (2, 12, 128), (4, 2, 256), (32, 1, 96))


@pytest.mark.parametrize("nkv,group,dh", PLAN_MODELS)
def test_block_plan_bounds(nkv, group, dh):
    """At B 1-64, T 1-16 and caches of 64 to 32768 columns: splits a power
    of two up to 8, 1-4 stages, query rows a CTA within the instance's, and
    the CTA's shared memory within 227 KB."""
    for B, T, S in itertools.product((1, 4, 24, 64), (1, 4, 16), (64, 768, 4096, 32768)):
        plan = ba.block_plan(B, nkv, group, T, S, SMS, dh=dh, smem=kernel_smem)
        assert plan.splits in (1, 2, 4, 8) and 1 <= plan.stages <= 4
        rows = 8 * math.ceil(group * T / plan.qtiles / 8)
        assert group * T / plan.qtiles <= rows <= (16 if dh == 256 else 32)
        assert (plan.qtiles - 1) * math.ceil(group * T / plan.qtiles) < group * T
        assert kernel_smem(dh, False, rows, S, plan.stages, plan.splits) <= 227 * 1024


def test_block_plan_at_phase_1n_shapes():
    """Qwen2.5 at B=24, T=4, S=768: one CTA a KV head's 24 rows, 4 splits
    (192 CTAs, two an SM); Llama-3.2-1B's 32/8 heads at T=16: two query
    tiles of 32 rows."""
    assert tuple(ba.block_plan(24, 2, 6, 4, 768, SMS, dh=128, smem=kernel_smem)) == (1, 4, 2)
    assert ba.block_plan(24, 8, 4, 16, 768, SMS, dh=64, smem=kernel_smem).qtiles == 2


@pytest.fixture
def fake(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_cuda, "require_cuda_bf16", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "lib", lambda: lib)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 7)
    monkeypatch.setattr(_cuda, "sm_count", lambda dev: SMS)
    return lib


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_block_wrapper_calls_its_entry(fake, softcap):
    """The CUDA path up to the C call on CPU tensors, the device checks
    stubbed: ``lapha_block_attention`` once with q k v and the byte map, T,
    out, B nh nkv S dh, scale, softcap, the plan and the stream, counted
    once under its name."""
    B, T, nh, nkv, dh, S = 24, 4, 12, 2, 128, 768
    q = torch.zeros(B, T, nh, dh, dtype=torch.bfloat16)
    k = torch.zeros(B, S, nkv, dh, dtype=torch.bfloat16)
    valid = torch.zeros(B, S, dtype=torch.int32)
    before = dict(_cuda.LAUNCHES)
    out = ba._block_cuda(q, k, k, valid, 0.125, softcap)
    assert out.shape == (B, T, nh, dh) and out.dtype == torch.bfloat16
    (entry, args), = fake.calls
    assert entry == "lapha_block_attention" and len(args) == 17
    assert args[4] == T and args[6:11] == (B, nh, nkv, S, dh) and args[11:13] == (0.125, softcap)
    plan = ba.block_plan(B, nkv, nh // nkv, T, S, SMS, dh=dh, smem=kernel_smem)
    assert args[-4:] == (*plan, 7)
    name = ba.launch_name(softcap)
    assert {n: c - before[n] for n, c in _cuda.LAUNCHES.items() if c != before[n]} == {name: 1}


def test_block_plan_independent_of_kv_valid(fake):
    """The wrapper's plan is the same whatever kv_valid holds and wherever
    the block sits: a captured launch keeps it."""
    B, T, nh, nkv, dh, S = 4, 4, 12, 2, 128, 768
    q = torch.zeros(B, T, nh, dh, dtype=torch.bfloat16)
    k = torch.zeros(B, S, nkv, dh, dtype=torch.bfloat16)
    for density in (0.0, 0.5, 1.0):
        ba._block_cuda(q, k, k, torch.rand(B, S) < density, 0.125, 0.0)
    assert len({args[-4:-1] for _, args in fake.calls}) == 1


def test_block_attention_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(2, 4, 12, 128)
    k = torch.zeros(2, 64, 2, 128)
    kvv = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="sinks"):
        ba.block_attention(q, k, k, kvv, sinks=torch.zeros(12))
    with pytest.raises(ValueError, match="window"):
        ba.block_attention(q, k, k, kvv, window=128)
    with pytest.raises(ValueError, match="int8"):
        ba.block_attention(q, k.to(torch.int8), k.to(torch.int8), kvv)
    with pytest.raises(ValueError, match="kv_valid"):
        ba.block_attention(q, k, k, kvv[:, :32])
