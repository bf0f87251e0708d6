"""Poincaré-ball geometry core in PyTorch (float32 internally).

Port of ``lapha_tpu/ops/hyperbolic.py``: the same ten functions with the
same epsilon/clamp structure, so V-maps computed here agree with the JAX
package in float32. Every function batches over leading axes and
differentiates cleanly; ``riemannian_grad_scale`` is a
``torch.autograd.Function`` in place of the JAX ``custom_vjp``.

Everything upcasts to float32: hyperbolic distances amplify bf16 rounding
near the ball boundary, and these ops cost nothing next to the LM forward.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "artanh",
    "mobius_add",
    "expmap0",
    "exp0_ball",
    "logmap0",
    "proj_ball",
    "poincare_dist",
    "poincare_dist_matrix",
    "riemannian_grad_scale",
]


def _safe_norm(v: torch.Tensor, floor: float) -> torch.Tensor:
    """‖v‖ along the last axis, floored at ``floor``, with a NaN-free gradient.

    ``clamp(linalg.norm(v), floor)`` has a NaN gradient at v = 0 (0/0 inside
    the norm); sqrt(max(Σv², floor²)) gives gradient 0 below the floor
    instead. Root-centred rows are exactly zero, so this matters.
    """
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    return torch.sqrt(torch.clamp(sq, min=floor * floor))


def artanh(x: torch.Tensor) -> torch.Tensor:
    """Numerically-stable inverse tanh, clamped to the open interval (-1, 1)."""
    x = torch.clamp(x, -1.0 + 1e-6, 1.0 - 1e-6)
    return 0.5 * (torch.log1p(x) - torch.log1p(-x))


def mobius_add(x: torch.Tensor, y: torch.Tensor, c: float = 1.0, eps: float = 1e-9) -> torch.Tensor:
    """Möbius addition x ⊕_c y on the Poincaré ball (last axis = coordinates)."""
    x = x.float()
    y = y.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True)
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    num = (1.0 + 2.0 * c * xy + c * y2) * x + (1.0 - c * x2) * y
    den = 1.0 + 2.0 * c * xy + (c**2) * x2 * y2
    return num / torch.clamp(den, min=eps)


def expmap0(v: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Exponential map at the origin, R^D -> Poincaré ball, margin 1e-5."""
    v = v.float()
    sqrt_c = math.sqrt(c)
    v_norm = _safe_norm(v, 1e-12)
    x = torch.tanh(sqrt_c * v_norm) / (sqrt_c * v_norm) * v
    x_norm = _safe_norm(x, 1e-12)
    scale = torch.clamp((1.0 - 1e-5) / x_norm, max=1.0)
    return x * scale


def exp0_ball(v: torch.Tensor, c: float = 1.0, eps: float = 1e-6, eps_ball: float = 1e-4) -> torch.Tensor:
    """Exp-map variant with the value head's clamp structure (norm floor
    ``eps``, ball margin ``eps_ball``) — the latent projection's map."""
    v = v.float()
    c = max(c, 1e-8)
    sqrt_c = math.sqrt(c)
    v_norm = _safe_norm(v, eps)
    y = torch.tanh(sqrt_c * v_norm) / (sqrt_c * v_norm) * v
    y_norm = _safe_norm(y, eps)
    factor = torch.clamp((1.0 - eps_ball) / y_norm, max=1.0)
    return y * factor


def logmap0(x: torch.Tensor, c: float = 1.0) -> torch.Tensor:
    """Logarithmic map at the origin (inverse of expmap0 inside the ball)."""
    x = x.float()
    sqrt_c = math.sqrt(c)
    x_norm = _safe_norm(x, 1e-12)
    return artanh(sqrt_c * x_norm) / (sqrt_c * x_norm) * x


def proj_ball(x: torch.Tensor, c: float = 1.0, eps: float = 1e-3) -> torch.Tensor:
    """Project points inside the ball: ‖x‖ ≤ (1-eps)/√c."""
    x = x.float()
    c = max(c, 1e-8)
    max_norm = (1.0 - eps) / math.sqrt(c)
    norm = _safe_norm(x, 1e-12)
    return x * torch.clamp(max_norm / norm, max=1.0)


def poincare_dist(x: torch.Tensor, y: torch.Tensor, c: float = 1.0, eps: float = 1e-5) -> torch.Tensor:
    """Geodesic distance between paired points; batch over leading axes.

    d(x,y) = acosh(1 + 2c‖x-y‖² / ((1-c‖x‖²)(1-c‖y‖²))) / √c with the
    denominator floored at ``eps`` and the argument at 1+1e-7.
    """
    x = x.float()
    y = y.float()
    c = max(c, 1e-8)
    x2 = torch.sum(x * x, dim=-1)
    y2 = torch.sum(y * y, dim=-1)
    d2 = torch.clamp(torch.sum((x - y) ** 2, dim=-1), min=0.0)
    denom = torch.clamp(1.0 - c * x2, min=eps) * torch.clamp(1.0 - c * y2, min=eps)
    z = torch.clamp(1.0 + 2.0 * c * d2 / denom, min=1.0 + 1e-7)
    return torch.arccosh(z) / math.sqrt(c)


def poincare_dist_matrix(X: torch.Tensor, Z: torch.Tensor, c: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    """All-pairs geodesic distances, (M,H) × (C,H) -> (M,C).

    ‖x-z‖² comes from one matrix product (‖x‖²+‖z‖²-2x·z), as in the JAX
    version, so both sides round the same way.
    """
    X = X.float()
    Z = Z.float()
    c = max(c, 1e-8)
    x2 = torch.sum(X * X, dim=-1, keepdim=True)  # (M,1)
    z2 = torch.sum(Z * Z, dim=-1, keepdim=True)  # (C,1)
    cross = X @ Z.T  # (M,C)
    sq = torch.clamp(x2 + z2.T - 2.0 * cross, min=0.0)
    one_minus_cx2 = torch.clamp(1.0 - c * x2, min=eps)
    one_minus_cz2 = torch.clamp(1.0 - c * z2, min=eps)
    denom = torch.clamp(one_minus_cx2 * one_minus_cz2.T, min=eps)
    arg = torch.clamp(1.0 + 2.0 * c * sq / denom, min=1.0 + 1e-7)
    return torch.arccosh(arg) / math.sqrt(c)


class _RiemannianGradScale(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, eps, gamma):
        ctx.save_for_backward(x)
        ctx.consts = (c, eps, gamma)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c, eps, gamma = ctx.consts
        x2 = torch.sum(x * x, dim=-1, keepdim=True)
        factor = torch.clamp(1.0 - c * x2, min=eps) ** 2 * (gamma / 4.0)
        return g * factor, None, None, None


def riemannian_grad_scale(x: torch.Tensor, c: float = 1.0, eps: float = 1e-6, gamma: float = 1.0) -> torch.Tensor:
    """Identity forward; backward scales grads by ((1-c‖x‖²)²/4)·γ —
    Riemannian SGD's metric-inverse scaling near the ball boundary."""
    return _RiemannianGradScale.apply(x, c, eps, gamma)
