"""The port's attention ops (CPU: their plain versions) against the JAX
Pallas kernels run in interpret mode, on the same numpy inputs.

Tolerance: rtol/atol 2e-5 in f32 — both sides compute the same masked
softmax in f32, in a different summation order (online blocks vs dense).
Rows that see no key are compared separately: the port writes 0 there (the
kernel rule), the JAX kernel a finite average; both are padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.ops import flash_attention as jfa
from lapha_tpu.ops.ragged_decode_attention import ragged_decode_attention as j_ragged
from lapha_tpu_torch.ops import flash_attention as tfa
from lapha_tpu_torch.ops.ragged_decode_attention import ragged_decode_attention as t_ragged

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(rng, B, T, S, nh, nkv, dh):
    return (rng.normal(size=(B, T, nh, dh)).astype(np.float32),
            rng.normal(size=(B, S, nkv, dh)).astype(np.float32),
            rng.normal(size=(B, S, nkv, dh)).astype(np.float32))


def _seen(kv_valid, qstart, T):
    """(B, T) bool: query row sees at least one key."""
    S = kv_valid.shape[1]
    qpos = np.asarray(qstart).reshape(-1, 1) + np.arange(T)[None, :]
    vis = (kv_valid[:, None, :] > 0) & (np.arange(S)[None, None, :] <= qpos[:, :, None])
    return vis.any(-1)


@pytest.mark.parametrize("T,nh,nkv,pad", [(40, 4, 2, "left"), (64, 6, 2, "right"),
                                          (33, 4, 4, "none")])
def test_flash_attention_matches_jax(T, nh, nkv, pad):
    rng = np.random.default_rng(T)
    B, dh = 3, 32
    q, k, v = _qkv(rng, B, T, T, nh, nkv, dh)
    mask = np.ones((B, T), np.int32)
    if pad == "left":
        mask[1, :9] = 0
        mask[2, :T - 3] = 0
    elif pad == "right":
        mask[0, T - 11:] = 0
        mask[2, 5:] = 0
    j_out, j_lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(mask), block_q=32, block_k=32,
                                      interpret=True)
    t_out, t_lse = tfa.flash_attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), torch.from_numpy(mask))
    seen = _seen(mask, np.zeros(B, np.int64), T)
    np.testing.assert_allclose(t_out.numpy()[seen], np.asarray(j_out)[seen], **TOL)
    np.testing.assert_allclose(t_lse.numpy().transpose(0, 2, 1)[seen],
                               np.asarray(j_lse).transpose(0, 2, 1)[seen], **TOL)
    assert (t_out.numpy()[~seen] == 0).all()
    assert (t_lse.numpy().transpose(0, 2, 1)[~seen] == -1e30).all()
    # the public entry returns the same output
    torch.testing.assert_close(
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(mask)), t_out)


@pytest.mark.parametrize("T,S,qstart", [(24, 96, 40), (32, 64, 0), (17, 96, (30, 5)),
                                        (8, 64, 40)])
def test_flash_attention_cached_matches_jax(T, S, qstart):
    """Rectangular T x S prefill: scalar and per-row qstart, S != T,
    non-multiple T, and (last case) a kv_valid hole between prefix and
    suffix."""
    rng = np.random.default_rng(S + T)
    B, nh, nkv, dh = 2, 4, 2, 32
    q, k, v = _qkv(rng, B, T, S, nh, nkv, dh)
    qs = np.broadcast_to(np.asarray(qstart, np.int32).reshape(-1), (B,))
    kv_valid = (np.arange(S)[None, :] < qs[:, None] + T).astype(np.int32)
    if T == 8:
        kv_valid[:, 20:40] = 0
    j_out = jfa.flash_attention_cached(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(kv_valid), jnp.asarray(qs),
                                       block_q=32, block_k=32, interpret=True)
    t_out = tfa.flash_attention_cached(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(kv_valid),
                                       torch.from_numpy(qs.copy()) if np.ndim(qstart) else int(qstart))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


def test_flash_options_not_ported_raise():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention(q, q, q, window=2)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_cached(q, q, q, torch.ones(1, 4), 0, sinks=torch.zeros(2))


def _ragged_case(rng, L, B, nkv, S, nh, dh):
    q = rng.normal(size=(B, nh, dh)).astype(np.float32)
    k = rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32)
    v = rng.normal(size=(L, B, nkv, S, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", ["basic", "pstart", "shared_chunk", "stub_rows"])
def test_ragged_decode_matches_jax(case):
    """Per-row admission (dstart), windowed prompt start (pstart), the
    prompt tail and decode start sharing one chunk (must not double count),
    and B not a multiple of the kernel's block_rows (stub rows)."""
    rng = np.random.default_rng(11)
    L, nkv, dh, nh, bk, rows = 2, 2, 32, 6, 32, 8
    pstart = None
    if case == "basic":
        B, S, slot = 4, 256, 173
        lens, dstart = [37, 120, 64, 5], [128, 128, 160, 128]
    elif case == "pstart":
        B, S, slot = 3, 128, 90
        lens, dstart = [40, 60, 10], [64, 64, 64]
        pstart = np.asarray([8, 33, 10], np.int32)  # last row: empty prompt range
    elif case == "shared_chunk":
        B, S, slot = 2, 128, 60
        lens, dstart = [40, 40], [44, 44]
    else:
        B, S, slot, rows = 5, 256, 148, 4
        lens, dstart = [37, 120, 64, 5, 99], [128, 131, 160, 128, 129]
    q, k, v = _ragged_case(rng, L, B, nkv, S, nh, dh)
    lens, dstart = np.asarray(lens, np.int32), np.asarray(dstart, np.int32)
    for layer in range(L):
        j_out = j_ragged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), layer,
                         jnp.asarray(lens), jnp.asarray(dstart), jnp.asarray(slot, jnp.int32),
                         pstart=None if pstart is None else jnp.asarray(pstart),
                         block_k=bk, block_rows=rows, interpret=True)
        t_out = t_ragged(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), layer,
                         torch.from_numpy(lens), torch.from_numpy(dstart), slot,
                         pstart=None if pstart is None else torch.from_numpy(pstart))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


def test_ragged_variants_not_ported_raise():
    q = torch.zeros(1, 2, 8)
    c = torch.zeros(1, 1, 1, 4, 8)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        t_ragged(q, c, c, 0, lens, lens, 2, sinks=torch.zeros(2))
