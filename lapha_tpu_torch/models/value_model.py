"""Value model = base LM forward + latent projection + linear value head.

Port of ``lapha_tpu/models/value_model.py``: one function returns
(y_state, v_pred, h0_raw) for a padded batch. Only the ``linear`` head type
exists, as in the JAX package.
"""

from __future__ import annotations

import math

import torch

from ..ops.latent import latent_project, masked_mean, pool_mask, value_head_apply
from . import qwen2


def init_value_head(hidden_size: int, generator: torch.Generator, device=None) -> dict:
    device = generator.device if device is None else torch.device(device)
    w = torch.randn((hidden_size,), generator=generator, device=device,
                    dtype=torch.float32) * (1.0 / math.sqrt(hidden_size))
    return {"w": w, "b": torch.zeros((), dtype=torch.float32, device=device)}


def make_value_head(head_type: str, hidden_size: int, generator: torch.Generator,
                    device=None) -> dict:
    if head_type != "linear":
        raise ValueError(
            f"value_head_type={head_type!r} is not supported: only 'linear' "
            "exists (the reference's 'qwen2' head is named but never defined)")
    return init_value_head(hidden_size, generator, device)


def value_forward(
    params: dict,
    head: dict,
    cfg: qwen2.Qwen2Config,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    response_mask: torch.Tensor | None = None,
    prompt_mask: torch.Tensor | None = None,
    root_h0: torch.Tensor | None = None,
    *,
    no_head_scale: float = 0.0,
    curvature: float = 1.0,
    value_activation: str = "sigmoid",
):
    """Returns (y_state (B,H) f32 ball points, v_pred (B,) f32, h0_raw (B,H) f32).

      last_hidden = base_lm(input_ids)
      h0_raw  = masked_mean(last_hidden, pool)
      y_state = exp0((h0_raw - root_h0)/√H)
      v_pred  = sigmoid(W·h0_raw + b)           # on the uncentred h0
    """
    _, hidden, _ = qwen2.forward(params, cfg, input_ids, attention_mask=attention_mask,
                                 return_hidden=True, compute_logits=False)
    pm = pool_mask(attention_mask, response_mask, prompt_mask)
    h0_raw = masked_mean(hidden, pm)
    y_state = latent_project(h0_raw, root_h0, scale=no_head_scale, c=curvature)
    v_pred = value_head_apply(h0_raw, head["w"], head["b"], activation=value_activation)
    return y_state, v_pred, h0_raw
