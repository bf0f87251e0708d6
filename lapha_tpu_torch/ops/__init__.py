from .hyperbolic import (
    artanh,
    exp0_ball,
    expmap0,
    logmap0,
    mobius_add,
    poincare_dist,
    poincare_dist_matrix,
    proj_ball,
    riemannian_grad_scale,
)
from .latent import latent_project, masked_mean, pool_mask, potential_v, value_head_apply

__all__ = [
    "artanh",
    "exp0_ball",
    "expmap0",
    "logmap0",
    "mobius_add",
    "poincare_dist",
    "poincare_dist_matrix",
    "proj_ball",
    "riemannian_grad_scale",
    "latent_project",
    "masked_mean",
    "pool_mask",
    "potential_v",
    "value_head_apply",
]
