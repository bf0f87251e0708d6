"""Batched sampling for the engine, in vLLM's order.

Port of ``lapha_tpu/engine/sampling.py``: repetition penalty → temperature →
top-k → top-p → min-p, per-row parameter vectors, and the logprob of the
sampled token from log-softmax of the fully processed logits. Top-k is exact
(``torch.topk``); the JAX engine's ``lax.approx_max_k`` candidate scan is a
TPU device choice, so the port matches ``Engine(approx_top_k=False)``.
Random draws come from an explicit ``torch.Generator`` (Gumbel-max over the
processed logits), so they differ from JAX's for the same seed.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30

__all__ = ["apply_repetition_penalty", "process_logits", "sample"]


def apply_repetition_penalty(logits, presence, penalty):
    """vLLM-style: positive logits of present tokens divided by the penalty,
    negative ones multiplied. presence (B, V); penalty (B,)."""
    p = penalty[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(presence > 0, penalized, logits)


def process_logits(logits, *, presence=None, repetition_penalty=None,
                   temperature=None, top_k=None, top_p=None, min_p=None,
                   static_top_k: int = 0):
    """Masked logits (B, V) f32 after the full pipeline. top_k <= 0, top_p
    >= 1 and min_p <= 0 disable their stage per row. ``static_top_k`` > 0
    promises every row's top_k is in (0, static_top_k]: truncation then runs
    on a top-k candidate set instead of a full-vocab sort (exact, because
    the nucleus lives inside the candidates)."""
    x = logits.float()
    B, V = x.shape
    if repetition_penalty is not None and presence is not None:
        x = apply_repetition_penalty(x, presence, repetition_penalty)
    if temperature is not None:
        x = x / temperature.clamp(min=1e-6)[:, None]
    if top_k is not None or top_p is not None:
        if static_top_k > 0 and top_k is not None:
            K = min(V, static_top_k)
            sorted_x = torch.topk(x, K, dim=-1, sorted=True).values
        else:
            sorted_x = torch.sort(x, dim=-1, descending=True).values
            K = V
        ranks = torch.arange(K, device=x.device)[None, :]
        keep = torch.ones_like(sorted_x, dtype=torch.bool)
        if top_k is not None:
            k = torch.where(top_k <= 0, V, top_k)[:, None]
            keep &= ranks < k
        if top_p is not None:
            probs = torch.softmax(torch.where(keep, sorted_x, NEG_INF), dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            # keep while the exclusive cumulative mass < top_p (rank 0 always kept)
            keep &= (cum - probs) < top_p.clamp(min=1e-6)[:, None]
        thresh = torch.where(keep, sorted_x, torch.inf).amin(dim=-1, keepdim=True)
        x = torch.where(x < thresh, NEG_INF, x)
    if min_p is not None:
        probs = torch.softmax(x, dim=-1)
        pmax = probs.amax(dim=-1, keepdim=True)
        x = torch.where((probs < min_p[:, None] * pmax) & (min_p[:, None] > 0), NEG_INF, x)
    return x


def sample(logits, generator: torch.Generator, *, presence=None,
           repetition_penalty=None, temperature=None, top_k=None, top_p=None,
           min_p=None, static_top_k: int = 0):
    """One token per row: (token (B,) int64, logprob (B,) f32). Rows with
    temperature 0 take the argmax of the penalized logits, as vLLM does."""
    processed = process_logits(
        logits, presence=presence, repetition_penalty=repetition_penalty,
        temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
        static_top_k=static_top_k)
    u = torch.rand(processed.shape, generator=generator, device=processed.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    token = torch.argmax(processed + gumbel, dim=-1)
    if temperature is not None:
        greedy_src = logits.float()
        if repetition_penalty is not None and presence is not None:
            greedy_src = apply_repetition_penalty(greedy_src, presence, repetition_penalty)
        token = torch.where(temperature <= 0.0, torch.argmax(greedy_src, dim=-1), token)
    lp = torch.log_softmax(processed, dim=-1).gather(-1, token[:, None])[:, 0]
    return token, lp
