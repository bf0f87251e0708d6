"""The port's flash-attention backward (CPU: its plain version, the same
autograd Function the CUDA kernels sit in) against the JAX Pallas backward
(``_dq_kernel``/``_dkv_kernel``) run in interpret mode, on the same numpy
inputs.

Tolerance: rtol/atol 2e-4 in f32, the JAX package's own for its backward
against dense attention (tests/test_flash_attention.py): both sides compute
the same FlashAttention-2 formulas from the LSE, in a different summation
order. dq rows of padded query positions (right padding) are excluded:
their upstream gradient is zero in training and the rows are padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu.ops.flash_attention import flash_attention as j_flash
from lapha_tpu_torch.ops import flash_attention as tfa

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(rng, B, T, nh, nkv, dh):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(B, T, nh, dh), f(B, T, nkv, dh), f(B, T, nkv, dh), f(B, T, nh, dh)


def _port_grads(q, k, v, mask, g):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(qt, kt, vt, torch.from_numpy(mask))
    (out * torch.from_numpy(g)).sum().backward()
    return out, (qt.grad.numpy(), kt.grad.numpy(), vt.grad.numpy())


@pytest.mark.parametrize("T,nh,nkv,dh", [(64, 4, 2, 32), (96, 8, 2, 64), (128, 4, 4, 32),
                                          (77, 12, 2, 32)])  # ragged T, a group of 6
def test_flash_backward_matches_jax_pallas(T, nh, nkv, dh):
    rng = np.random.default_rng(T + nh)
    B = 2
    q, k, v, g = _inputs(rng, B, T, nh, nkv, dh)
    mask = np.ones((B, T), np.int32)
    mask[0, T - 9:] = 0
    mask[1, 10:14] = 0  # a hole of invalid keys
    g = g * mask[:, :, None, None]  # upstream grads at padded rows are zero in training

    def loss(q_, k_, v_):
        o = j_flash(q_, k_, v_, jnp.asarray(mask), causal=True, block_q=32, block_k=32,
                    interpret=True)
        return jnp.sum(o * jnp.asarray(g))

    jg = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _, tg = _port_grads(q, k, v, mask, g)
    valid = mask > 0
    for name, a, b in zip("qkv", tg, jg):
        b = np.asarray(b)
        if name == "q":
            a, b = a[valid], b[valid]
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)


def test_flash_attention_output_carries_the_backward_function():
    """With q requiring grad, the output's grad_fn is the port's flash
    autograd Function (the backward that runs the K2 kernels on the card),
    not a graph autograd recorded through the plain forward's ops."""
    rng = np.random.default_rng(0)
    q, k, v, g = _inputs(rng, 1, 40, 4, 2, 32)
    mask = np.ones((1, 40), np.int32)
    out, (dq, dk, dv) = _port_grads(q, k, v, mask, g)
    assert "FlashAttention" in out.grad_fn.name(), out.grad_fn.name()
    assert np.isfinite(dq).all() and np.abs(dk).max() > 0 and np.abs(dv).max() > 0


def test_plain_backward_rows_without_keys_contribute_nothing():
    """Left padding: query rows that see no key carry LSE -1e30 (the
    row_ok guard) and give zero dq, whatever their upstream gradient."""
    rng = np.random.default_rng(1)
    q, k, v, g = _inputs(rng, 2, 48, 4, 2, 16)
    mask = np.ones((2, 48), np.int32)
    mask[1, :20] = 0
    _, (dq, dk, dv) = _port_grads(q, k, v, mask, g)
    assert (dq[1, :20] == 0).all()
    assert (dk[1, :20] == 0).all() and (dv[1, :20] == 0).all()  # invalid keys
    assert np.isfinite(dq).all()
