"""Latent projection + hyperbolic potential ops in PyTorch.

Port of ``lapha_tpu/ops/latent.py``:

  last_hidden --masked-mean--> h0_raw --center/scale--> exp0 --> y (ball point)
  potential V(i) = d_root(i) / (d_root(i) + d_goal(i) + eps)
"""

from __future__ import annotations

import math

import torch

from .hyperbolic import exp0_ball, poincare_dist_matrix

__all__ = ["masked_mean", "pool_mask", "latent_project", "potential_v", "value_head_apply"]


def pool_mask(
    attention_mask: torch.Tensor,
    response_mask: torch.Tensor | None = None,
    prompt_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """pool = ((response_mask if given else attn) OR prompt_mask) AND attn.

    All masks are (B, L) int/bool; returns int32 (B, L).
    """
    attn = attention_mask > 0
    pool = attn if response_mask is None else (response_mask > 0)
    if prompt_mask is not None:
        pool = pool | (prompt_mask > 0)
    return (pool & attn).to(torch.int32)


def masked_mean(x: torch.Tensor, mask_2d: torch.Tensor) -> torch.Tensor:
    """Mean of x (B,L,H) over positions where mask (B,L) > 0; float32 out.

    The denominator is floored at 1, so empty rows give 0 rather than NaN.
    """
    x = x.float()
    m = (mask_2d > 0).float()
    denom = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
    return torch.einsum("blh,bl->bh", x, m) / denom


def latent_project(
    h0_raw: torch.Tensor,
    root_h0: torch.Tensor | None = None,
    *,
    scale: float = 0.0,
    c: float = 1.0,
    eps: float = 1e-6,
    eps_ball: float = 1e-4,
) -> torch.Tensor:
    """Root-centre a pooled hidden state and map it into the Poincaré ball.

    y = Exp0((h0_raw - root_h0) / s) with s = √H when ``scale`` <= 0.
    ``root_h0`` may be (H,), (1,H) or (B,H); None means no centring.
    """
    h0 = h0_raw.float()
    if root_h0 is not None:
        rh = root_h0.to(device=h0.device, dtype=torch.float32)
        if rh.ndim == 1:
            rh = rh[None, :]
        h0 = h0 - rh
    s = scale if scale > 0.0 else math.sqrt(h0.shape[-1])
    return exp0_ball(h0 / s, c=c, eps=eps, eps_ball=eps_ball)


def value_head_apply(
    h0_raw: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    *,
    activation: str = "sigmoid",
) -> torch.Tensor:
    """v_pred = act(h0_raw @ w + b) on the uncentred pooled state.

    ``w`` is (H,) or (H,1); returns float32 (B,).
    """
    w = w.float().reshape(-1)
    logit = h0_raw.float() @ w + b.float().reshape(())
    if activation == "sigmoid":
        return torch.sigmoid(logit)
    return logit


def potential_v(
    Y: torch.Tensor,
    y_root: torch.Tensor,
    anchors: torch.Tensor,
    anchor_valid: torch.Tensor | None = None,
    *,
    c: float = 1.0,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Hyperbolic potential V(i) = d_root / (d_root + d_goal + eps) in [0,1].

    Y (N,H) ball points; y_root (H,); anchors (A,H) goal anchors;
    anchor_valid (A,) excludes anchors from the min. d_goal(i) =
    min_a d(Y_i, anchor_a).
    """
    Y = Y.float()
    d_root = poincare_dist_matrix(Y, y_root[None, :], c=c)[:, 0]  # (N,)
    d_all = poincare_dist_matrix(Y, anchors, c=c)  # (N,A)
    if anchor_valid is not None:
        d_all = torch.where(anchor_valid[None, :] > 0, d_all,
                            torch.full_like(d_all, math.inf))
    d_goal = d_all.min(dim=1).values
    v = d_root / (d_root + d_goal + eps)
    return torch.clamp(v, 0.0, 1.0)
