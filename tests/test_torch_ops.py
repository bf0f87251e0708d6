"""lapha_tpu_torch.ops geometry + latent ops against lapha_tpu.ops (CPU, f32).

Both sides get the same numpy inputs. Tolerance: atol 1e-6 (plus a 1e-6
relative term for values above 1) — the two frameworks' f32 transcendental
functions (tanh, log1p, arccosh) differ in the last ulps, nothing more.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapha_tpu import ops as jops
from lapha_tpu_torch import ops as tops

ATOL = 1e-6
RTOL = 1e-6


def _ball(rng, n, d, max_norm=0.9):
    x = rng.normal(size=(n, d))
    x = x / np.linalg.norm(x, axis=-1, keepdims=True)
    return (x * rng.uniform(0.01, max_norm, size=(n, 1))).astype(np.float32)


def _close(t_out, j_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=rtol)


@pytest.mark.parametrize("name", ["artanh", "expmap0", "exp0_ball", "logmap0", "proj_ball"])
def test_unary_geometry_matches_jax(name):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(16, 24)) * 0.7).astype(np.float32)
    if name in ("artanh",):
        x = np.clip(x, -1.2, 1.2)  # exercise the clamp too
    if name == "logmap0":
        x = _ball(rng, 16, 24)
    x[0] = 0.0  # an exactly-zero row (the root)
    _close(getattr(tops, name)(torch.from_numpy(x)), getattr(jops, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["mobius_add", "poincare_dist"])
def test_binary_geometry_matches_jax(name):
    rng = np.random.default_rng(1)
    x, y = _ball(rng, 32, 16), _ball(rng, 32, 16)
    x[0] = 0.0
    _close(getattr(tops, name)(torch.from_numpy(x), torch.from_numpy(y)),
           getattr(jops, name)(jnp.asarray(x), jnp.asarray(y)))


def test_poincare_dist_matrix_matches_jax():
    rng = np.random.default_rng(2)
    X, Z = _ball(rng, 12, 32), _ball(rng, 7, 32)
    _close(tops.poincare_dist_matrix(torch.from_numpy(X), torch.from_numpy(Z)),
           jops.poincare_dist_matrix(jnp.asarray(X), jnp.asarray(Z)))


def test_riemannian_grad_scale_matches_jax():
    rng = np.random.default_rng(3)
    x = _ball(rng, 8, 16, max_norm=0.99)
    g = rng.normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jops.riemannian_grad_scale(a, 1.0, 1e-6, 0.5) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tops.riemannian_grad_scale(xt, 1.0, 1e-6, 0.5)
    torch.testing.assert_close(out.detach(), torch.from_numpy(x))  # identity forward
    (out * torch.from_numpy(g)).sum().backward()
    _close(xt.grad, jg)


def test_latent_ops_match_jax():
    rng = np.random.default_rng(4)
    B, L, H = 5, 9, 32
    hid = rng.normal(size=(B, L, H)).astype(np.float32)
    attn = (rng.uniform(size=(B, L)) < 0.8).astype(np.int32)
    attn[2] = 0  # empty row: denominator floor
    resp = (rng.uniform(size=(B, L)) < 0.5).astype(np.int32)
    prompt = (rng.uniform(size=(B, L)) < 0.3).astype(np.int32)
    tm = tops.pool_mask(torch.from_numpy(attn), torch.from_numpy(resp), torch.from_numpy(prompt))
    jm = jops.pool_mask(jnp.asarray(attn), jnp.asarray(resp), jnp.asarray(prompt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    h0t = tops.masked_mean(torch.from_numpy(hid), tm)
    h0j = jops.masked_mean(jnp.asarray(hid), jm)
    _close(h0t, h0j)
    root = hid[0, 0]
    _close(tops.latent_project(h0t, torch.from_numpy(root)), jops.latent_project(h0j, jnp.asarray(root)))
    _close(tops.latent_project(h0t, scale=3.0), jops.latent_project(h0j, scale=3.0))
    w = rng.normal(size=(H,)).astype(np.float32) * 0.1
    b = np.float32(0.3)
    for act in ("sigmoid", "linear"):
        _close(tops.value_head_apply(h0t, torch.from_numpy(w), torch.tensor(b), activation=act),
               jops.value_head_apply(h0j, jnp.asarray(w), jnp.asarray(b), activation=act))


def test_potential_v_matches_jax():
    rng = np.random.default_rng(5)
    Y, anchors = _ball(rng, 20, 16), _ball(rng, 4, 16)
    Y[0] = 0.0
    valid = np.array([1, 0, 1, 1], np.int32)
    root = np.zeros(16, np.float32)
    tv = tops.potential_v(torch.from_numpy(Y), torch.from_numpy(root), torch.from_numpy(anchors),
                          torch.from_numpy(valid))
    jv = jops.potential_v(jnp.asarray(Y), jnp.asarray(root), jnp.asarray(anchors), jnp.asarray(valid))
    _close(tv, jv)
    assert float(tv.min()) >= 0.0 and float(tv.max()) <= 1.0


def test_gradients_finite_at_zero_rows():
    """Root-centred rows are exactly zero: the projection and V must give
    finite gradients there (sqrt of a clamped square, not a norm)."""
    rng = np.random.default_rng(6)
    h0 = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    h0[0] = 0.0
    h0.requires_grad_(True)
    y = tops.latent_project(h0, torch.zeros(16))
    anchors = torch.from_numpy(_ball(rng, 3, 16))
    v = tops.potential_v(tops.riemannian_grad_scale(y), torch.zeros(16), anchors)
    (v.sum() + tops.expmap0(h0).sum() + tops.logmap0(y).sum()).backward()
    assert torch.isfinite(h0.grad).all()


def test_package_imports_no_jax():
    """The port imports neither jax nor the JAX package (checked in a fresh
    interpreter: this test process has both loaded)."""
    code = ("import sys, lapha_tpu_torch, lapha_tpu_torch.ops, lapha_tpu_torch.models, "
            "lapha_tpu_torch.engine, lapha_tpu_torch.search, lapha_tpu_torch.search.mcts, "
            "lapha_tpu_torch.train, lapha_tpu_torch.train.trainer, lapha_tpu_torch.models.quant, "
            "lapha_tpu_torch.ops.int4_matmul, lapha_tpu_torch.ops.moe, "
            "lapha_tpu_torch.ops.grouped_gemm, lapha_tpu_torch.evalsuite.rollout_jsonl, "
            "lapha_tpu_torch.evalsuite.eval_math, lapha_tpu_torch.tools, "
            "lapha_tpu_torch.tools.server, lapha_tpu_torch.run_dapo, "
            "lapha_tpu_torch.train.dataset, lapha_tpu_torch.train.viz, "
            "lapha_tpu_torch.models.loader, lapha_tpu_torch.models.deepseek, "
            "lapha_tpu_torch.engine.scheduler, lapha_tpu_torch.engine.server, "
            "lapha_tpu_torch.engine.client, lapha_tpu_torch.native, "
            "lapha_tpu_torch.bench_serve, lapha_tpu_torch.bench_verify; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lapha_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
