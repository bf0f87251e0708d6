"""Batched, bucketed value function: the search loop's scoring seam.

Port of ``ValueFunction`` from ``lapha_tpu/search/value_fn.py`` (without
``mesh``). Batches are rounded to ``batch_bucket`` rows and lengths to
``pad_multiple``, as in the JAX version, so both see the same padded shapes.
The parameters may be a quantized tree (``models/quant.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..models import value_model
from ..models.quant import leaf_device
from ..ops.latent import latent_project, value_head_apply


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ValueFunction:
    """Callable with the reference value_fn signature.

    __call__(input_ids, attention_mask, response_mask=None, prompt_mask=None,
             root_h0=None, return_h0=False)
      -> (y_state (B,H) np.float32, v_pred (B,) np.float32[, h0_raw])
    """

    def __init__(
        self,
        params: Any,
        head: dict,
        cfg,
        *,
        max_model_len: int = 4096,
        pad_multiple: int = 128,
        batch_bucket: int = 8,
        no_head_scale: float = 0.0,
        curvature: float = 1.0,
        value_activation: str = "sigmoid",
    ):
        self.params = params
        self.head = head
        self.cfg = cfg
        self.device = leaf_device(params["embed"]["weight"])
        self.max_model_len = int(max_model_len)
        self.pad_multiple = int(pad_multiple)
        self.batch_bucket = int(batch_bucket)
        self.kw = dict(no_head_scale=no_head_scale, curvature=curvature,
                       value_activation=value_activation)
        self.calls = 0

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a), device=self.device)

    def from_pooled(self, h0_raw, root_h0=None):
        """(y_state, v_pred) from an engine-pooled h0 — no LM forward.

        Engines built with ``collect_h0`` return each sample's pooled final
        hidden, so value scoring costs one small matvec.
        """
        h0 = self._t(np.asarray(h0_raw, np.float32))
        if h0.ndim == 1:
            h0 = h0[None, :]
        rh = None if root_h0 is None else self._t(
            np.asarray(root_h0, np.float32).reshape(-1))
        with torch.inference_mode():
            y = latent_project(h0, rh, scale=self.kw["no_head_scale"],
                               c=self.kw["curvature"])
            v = value_head_apply(h0, self.head["w"], self.head["b"],
                                 activation=self.kw["value_activation"])
        return y.cpu().numpy(), v.cpu().numpy()

    def update_params(self, params=None, head=None):
        if params is not None:
            self.params = params
        if head is not None:
            self.head = head

    def __call__(self, input_ids, attention_mask, response_mask=None, prompt_mask=None,
                 root_h0=None, return_h0: bool = False):
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None, :]
        B, L = ids.shape
        attn = np.asarray(attention_mask).reshape(B, L)
        resp = np.asarray(response_mask).reshape(B, L) if response_mask is not None else attn
        pmask = np.asarray(prompt_mask).reshape(B, L) if prompt_mask is not None else np.zeros_like(attn)

        # left-truncate together
        if L > self.max_model_len:
            ids, attn, resp, pmask = (a[:, -self.max_model_len:] for a in (ids, attn, resp, pmask))
            L = self.max_model_len

        Lb = min(_round_up(L, self.pad_multiple), self.max_model_len)
        Bb = _round_up(B, self.batch_bucket)
        idsb = np.zeros((Bb, Lb), np.int64)
        attnb = np.zeros((Bb, Lb), np.int32)
        respb = np.zeros((Bb, Lb), np.int32)
        pmb = np.zeros((Bb, Lb), np.int32)
        idsb[:B, :L], attnb[:B, :L], respb[:B, :L], pmb[:B, :L] = ids, attn, resp, pmask
        # padded rows get a 1-token attn so pooling denominators stay sane
        attnb[B:, 0] = 1
        respb[B:, 0] = 1

        rh = (None if root_h0 is None
              else self._t(np.asarray(root_h0, np.float32).reshape(-1)))
        with torch.inference_mode():
            y, v, h0 = value_model.value_forward(
                self.params, self.head, self.cfg, self._t(idsb), self._t(attnb),
                response_mask=self._t(respb), prompt_mask=self._t(pmb),
                root_h0=rh, **self.kw)
        self.calls += 1

        y = y[:B].cpu().numpy()
        v = v[:B].cpu().numpy()
        if return_h0:
            return y, v, h0[:B].cpu().numpy()
        return y, v
