"""GRPO + value-MSE update: host packing + one update step, in PyTorch.

Port of ``lapha_tpu/train/losses.py``. The packing and advantages are the
same host numpy code. The loss is the same function of the same packed
batch: the LM forward (``models.model_module(cfg).forward``: the qwen2
family or DeepSeek MLA, flash kernels forward and backward on the card),
per-token log-probabilities from the hidden states in sequence chunks
(never the whole (B, L, V) logits), the GRPO family's
clipped policy loss with an optional KL term, and the value head's MSE on
the pooled hidden state. ``make_update_fn`` returns the step the JAX
package jits: loss, gradients of (params, head), optional extra gradients,
the optimizer (``train.optim``) applied in place, and the metrics.

Parameters are pytrees of dicts; ``tree_leaves`` flattens them in JAX's
order (sorted keys), so gradient lists line up with the JAX package's
leaves. The step updates the leaves in place: the engine and the value
function hold the same tensors (the JAX package's pointer share).

Not ported: ``seq_mesh`` (sequence-parallel training, multi-device) raises.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models import model_module, qwen2
from ..models.quant import is_quantized
from ..ops.latent import masked_mean, pool_mask, value_head_apply
from . import optim


# ----------------------------------------------------------------- pytrees

def tree_paths(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(dotted path, leaf) pairs of a dict/tuple/list tree, dict keys sorted
    (the order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, v in enumerate(tree):
            out.extend(tree_paths(v, f"{prefix}{i}."))
        return out
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


# ----------------------------------------------------------------- host packing

def completion_eos_mask(c_ids: np.ndarray, eos_id: int | None) -> np.ndarray:
    """1 up to and including the first EOS, 0 after (reference
    _completion_eos_mask_1d)."""
    m = np.ones_like(c_ids)
    if eos_id is not None:
        hits = np.where(c_ids == int(eos_id))[0]
        if hits.size and hits[0] + 1 < m.size:
            m[hits[0] + 1:] = 0
    return m


def pack_samples(samples: list[dict], pad_id: int, eos_id: int | None,
                 max_prompt_length: int, pad_multiple: int = 128,
                 batch_multiple: int = 8) -> dict[str, np.ndarray] | None:
    """Right-pack (prompt‖completion) rows into one padded batch.

    Returns arrays: ids (B,L), attn, comp_mask (1 on completion pos up to
    EOS), resp_mask/prompt_mask (pooling), prompt_len (B,), comp_len (B,),
    valid (B,), and "kept" — the indices of ``samples`` that made it into
    the batch, in row order. Callers MUST align per-sample arrays
    (advantages, v_target) through "kept": dropped rows would otherwise
    shift every later row onto its neighbor's targets.

    Pad stripping is defensive only (search emits unpadded ids) and is
    skipped when pad_id == eos_id — Qwen tokenizers set pad = eos, and
    stripping would delete the EOS the policy must learn to emit.
    """
    strip = pad_id != eos_id
    rows = []
    kept: list[int] = []
    for idx, s in enumerate(samples):
        p = np.asarray(s["prompt_ids"], np.int64).reshape(-1)[-max_prompt_length:]
        c = np.asarray(s["completion_ids"], np.int64).reshape(-1)
        if strip:
            p = p[p != pad_id]
            c = c[c != pad_id]
        if p.size == 0 or c.size == 0:
            continue
        rows.append((p, c))
        kept.append(idx)
    if not rows:
        return None

    B = len(rows)
    Bb = -(-B // batch_multiple) * batch_multiple
    L = max(p.size + c.size for p, c in rows)
    Lb = -(-L // pad_multiple) * pad_multiple

    ids = np.full((Bb, Lb), pad_id, np.int32)
    attn = np.zeros((Bb, Lb), np.int32)
    comp = np.zeros((Bb, Lb), np.int32)
    resp = np.zeros((Bb, Lb), np.int32)
    pm = np.zeros((Bb, Lb), np.int32)
    plen = np.zeros((Bb,), np.int32)
    clen = np.zeros((Bb,), np.int32)
    valid = np.zeros((Bb,), np.int32)

    for i, (p, c) in enumerate(rows):
        lp, lc = p.size, c.size
        ids[i, :lp] = p
        ids[i, lp:lp + lc] = c
        attn[i, :lp + lc] = 1
        cm = completion_eos_mask(c, eos_id)
        comp[i, lp:lp + lc] = cm
        resp[i, lp:lp + lc] = cm
        pm[i, :lp] = 1
        plen[i], clen[i], valid[i] = lp, lc, 1
    # pad rows: 1-token attn keeps pooling denominators sane
    attn[B:, 0] = 1
    resp[B:, 0] = 1
    return dict(ids=ids, attn=attn, comp_mask=comp, resp_mask=resp,
                prompt_mask=pm, prompt_len=plen, comp_len=clen, valid=valid,
                kept=np.asarray(kept, np.int64))


def group_advantages(rewards: np.ndarray, group_ids: np.ndarray,
                     scale_rewards: str = "group") -> np.ndarray:
    """Group-mean-centered advantages (reference 2331-2379)."""
    rewards = np.asarray(rewards, np.float64)
    group_ids = np.asarray(group_ids, np.int64)
    if isinstance(scale_rewards, bool):
        scale_rewards = "group" if scale_rewards else "none"
    scale_rewards = str(scale_rewards).lower()

    if group_ids.size == 0:
        return np.zeros(0, np.float32)
    K = int(group_ids.max()) + 1
    cnt = np.bincount(group_ids, minlength=K).astype(np.float64)
    gsum = np.bincount(group_ids, weights=rewards, minlength=K)
    gmean = gsum / (cnt + 1e-8)
    centered = rewards - gmean[group_ids]

    if scale_rewards in ("none", "false", "0"):
        adv = centered
    elif scale_rewards in ("batch", "global"):
        adv = centered / (centered.std() + 1e-4)
    else:  # group
        gsumsq = np.bincount(group_ids, weights=centered**2, minlength=K)
        gstd = np.sqrt(np.maximum(gsumsq / (cnt + 1e-8), 0.0))
        adv = centered / (gstd[group_ids] + 1e-4)
    return adv.astype(np.float32)


def batch_to_device(packed: dict, device) -> dict[str, torch.Tensor]:
    """Packed numpy arrays -> tensors on ``device`` ("kept" is host bookkeeping)."""
    return {k: torch.as_tensor(v, device=device) for k, v in packed.items() if k != "kept"}


# ----------------------------------------------------------------- the step

_DENSE = ("dense", "eager", "sdpa")
_FLASH = ("auto", "pallas", "flash", "flash_attention_2")


def check_attn_impl(attn_impl: str | None, device: torch.device) -> None:
    """The training forward's attention: the flash kernels (CUDA) or their
    plain versions (CPU). "dense" names the plain version, which the port
    runs on the CPU only."""
    if attn_impl is None or attn_impl in _FLASH:
        return
    if attn_impl in _DENSE:
        if device.type == "cuda":
            raise ValueError(f"attn_implementation={attn_impl!r}: the port has no dense CUDA "
                             "attention; use 'auto' (the flash kernels)")
        return
    raise ValueError(f"unknown attn_implementation {attn_impl!r}")


def _head_weight(params: dict, model_cfg) -> torch.Tensor:
    return (params["embed"]["weight"] if model_cfg.tie_word_embeddings
            else params["lm_head"]["weight"])


def _chunk_logps(hc, w, tc, temperature: float):
    """A chunk's log-probs of its targets; ``w`` is the head as an f32 (V,
    H) table, or a quantized head {"q", "s"}, taken as JAX's chunk body
    takes it: the hidden folded by the per-channel scale in its dtype, the
    int8 table cast to that dtype, an f32 product (``qwen2._int8_head``: on
    the card in row slices, no f32 copy of the table)."""
    if is_quantized(w):
        logits = qwen2._int8_head(hc, w)
    else:
        logits = hc.float() @ w.T  # (B, c, V) f32
    if temperature != 1.0:
        logits = logits / temperature
    return torch.log_softmax(logits, dim=-1).gather(-1, tc[..., None].long())[..., 0]


def _selective_logps_chunked(params, model_cfg, hidden, targets, temperature,
                             chunk: int = 1024) -> torch.Tensor:
    """log p(targets | hidden) WITHOUT materializing (B, L, V) logits.

    hidden (B, L, H) post-final-norm; targets (B, L). Each sequence chunk
    computes only a (B, chunk, V) f32 logits block, recomputed in the
    backward (checkpoint), so peak logits memory is B*chunk*V*4 bytes
    instead of B*L*V*4 (20 GB at B=8, L=4k, V=152k). The head is cast to
    f32 once: f32 products of bf16 values are exact, so the logits are the
    JAX package's bf16 x bf16 -> f32 ones up to summation order. A
    quantized head stays quantized (``_chunk_logps``).
    """
    w = _head_weight(params, model_cfg)
    if not is_quantized(w):
        w = w.float()
    t = temperature if temperature > 0 else 1.0
    grad = torch.is_grad_enabled()
    outs = []
    for lo in range(0, hidden.shape[1], chunk):
        hc, tc = hidden[:, lo:lo + chunk], targets[:, lo:lo + chunk]
        outs.append(checkpoint(_chunk_logps, hc, w, tc, t, use_reentrant=False) if grad
                    else _chunk_logps(hc, w, tc, t))
    return torch.cat(outs, dim=1)


def _hidden(params, model_cfg, batch, remat, attn_impl, seq_mesh):
    if seq_mesh is not None:
        raise NotImplementedError("seq_mesh: sequence-parallel training is multi-device "
                                  "(ROADMAP A11), not ported yet")
    check_attn_impl(attn_impl, batch["ids"].device)
    _, hidden, _ = model_module(model_cfg).forward(
        params, model_cfg, batch["ids"], attention_mask=batch["attn"], remat=remat,
        return_hidden=True, compute_logits=False)
    return hidden


def loss_and_metrics(
    params: Any,
    head: dict,
    batch: dict[str, torch.Tensor],
    model_cfg: qwen2.Qwen2Config,
    *,
    temperature: float,
    eps_low: float,
    eps_high: float,
    loss_type: str,
    importance_level: str,
    value_w: float,
    beta: float,
    max_completion_length: int,
    no_head_scale: float = 0.0,
    value_activation: str = "sigmoid",
    remat=True,
    attn_impl: str | None = None,
    logits_chunk: int = 1024,
    ref_logps: torch.Tensor | None = None,
    old_logps: torch.Tensor | None = None,
    seq_mesh=None,
    seq_axis: str = "sequence",
):
    """Differentiable total loss over a packed batch; (loss, metrics).

    batch extra keys: advantages (B,), v_target (B,). ``no_head_scale`` is
    accepted for the JAX signature (the value head reads the uncentred h0).
    """
    ids, attn = batch["ids"], batch["attn"]
    comp_mask = batch["comp_mask"].float()
    valid = batch["valid"].float()

    hidden = _hidden(params, model_cfg, batch, remat, attn_impl, seq_mesh)
    logps_all = _selective_logps_chunked(params, model_cfg, hidden[:, :-1, :], ids[:, 1:],
                                         temperature, chunk=logits_chunk)  # (B, L-1)
    # token at position j is predicted from j-1 → completion token mask shifts by 1
    token_mask = comp_mask[:, 1:] * valid[:, None]
    per_token_logps = logps_all * token_mask

    # ---- policy loss (GRPO family) ----
    A = batch["advantages"].float()[:, None]
    if old_logps is None:
        old = per_token_logps.detach()  # on-policy: ratio == 1
    else:
        old = (old_logps * token_mask).detach()
    log_ratio = per_token_logps - old
    if importance_level == "sequence":
        denom_len = token_mask.sum(-1).clamp(min=1.0)
        log_w = ((log_ratio * token_mask).sum(-1) / denom_len)[:, None]
    else:
        log_w = log_ratio
    ratio = torch.exp(log_w)
    clipped = torch.clamp(ratio, 1.0 - eps_low, 1.0 + eps_high)
    per_token_loss = -torch.minimum(ratio * A, clipped * A)

    if beta > 0.0 and ref_logps is not None:
        kl = torch.exp(ref_logps - per_token_logps) - (ref_logps - per_token_logps) - 1.0
        per_token_loss = per_token_loss + beta * kl
        mean_kl = (kl * token_mask).sum() / token_mask.sum().clamp(min=1.0)
    else:
        mean_kl = torch.zeros((), device=ids.device)

    if loss_type == "grpo":
        row_loss = (per_token_loss * token_mask).sum(-1) / token_mask.sum(-1).clamp(min=1.0)
        policy_loss = (row_loss * valid).sum() / valid.sum().clamp(min=1.0)
    elif loss_type == "bnpo":
        policy_loss = (per_token_loss * token_mask).sum() / token_mask.sum().clamp(min=1.0)
    else:  # dr_grpo
        policy_loss = (per_token_loss * token_mask).sum() / (
            valid.sum().clamp(min=1.0) * max_completion_length)

    # ---- value loss ----
    pm = pool_mask(attn, batch["resp_mask"], batch["prompt_mask"])
    h0 = masked_mean(hidden, pm)
    v_pred = value_head_apply(h0, head["w"], head["b"], activation=value_activation)
    v_target = batch["v_target"].float().clamp(0.0, 1.0)
    sq = (v_pred - v_target) ** 2 * valid
    value_loss = sq.sum() / valid.sum().clamp(min=1.0)

    loss = policy_loss + value_w * value_loss
    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "kl": mean_kl,
        "v_pred_mean": (v_pred * valid).sum() / valid.sum().clamp(min=1.0),
        "completion_tokens": token_mask.sum(),
    }
    return loss, metrics


def _grads(loss, leaves):
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(gs, leaves)]


def _trainable(params, head) -> list[torch.Tensor]:
    leaves = tree_leaves((params, head))
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    return leaves


def make_update_fn(model_cfg: qwen2.Qwen2Config, optimizer, *, loss_kwargs: dict):
    """The (params, head, opt_state, batch) -> (params, head, opt_state,
    metrics) step. Params and head are updated IN PLACE (the returned trees
    are the given ones).

    ``extra_grads`` (optional list aligned with ``tree_leaves((params,
    head))``) is added to the loss gradients before the optimizer — the
    num_trees all-nodes value-MSE mode. ``value_w_override`` replaces
    value_w (0.0 when the MSE term comes via extra_grads)."""

    def step(params, head, opt_state, batch, ref_logps=None, extra_grads=None,
             value_w_override=None, old_logps=None):
        kw = dict(loss_kwargs)
        if value_w_override is not None:
            kw["value_w"] = value_w_override
        leaves = _trainable(params, head)
        with torch.enable_grad():
            loss, metrics = loss_and_metrics(params, head, batch, model_cfg,
                                             ref_logps=ref_logps, old_logps=old_logps, **kw)
            grads = _grads(loss, leaves)
        if extra_grads is not None:
            grads = [g + e.to(g.dtype) for g, e in zip(grads, extra_grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = optim.global_norm(grads)
        optimizer.apply(leaves, grads, opt_state)
        return params, head, opt_state, metrics

    return step


def make_value_sumsq_grad_fn(model_cfg: qwen2.Qwen2Config, *, no_head_scale=0.0,
                             value_activation="sigmoid", remat=True,
                             attn_impl: str | None = None, seq_mesh=None,
                             seq_axis: str = "sequence"):
    """(params, head, batch) -> (sum_sq, count, grads of sum_sq), grads a
    list aligned with ``tree_leaves((params, head))``.

    Per-chunk SUM of squared value errors (not mean) so micro-batch grads
    accumulate exactly: d(mean)/dθ = Σ_chunks d(sum)/dθ / Σ count. Used by
    the num_trees all-nodes MSE mode (reference 2171-2296)."""

    def fn(params, head, batch):
        leaves = _trainable(params, head)
        with torch.enable_grad():
            hidden = _hidden(params, model_cfg, batch, remat, attn_impl, seq_mesh)
            pm = pool_mask(batch["attn"], batch["resp_mask"], batch["prompt_mask"])
            v_pred = value_head_apply(masked_mean(hidden, pm), head["w"], head["b"],
                                      activation=value_activation)
            v_tgt = batch["v_target"].float().clamp(0.0, 1.0)
            valid = batch["valid"].float()
            sum_sq = ((v_pred - v_tgt) ** 2 * valid).sum()
            grads = _grads(sum_sq, leaves)
        return sum_sq.detach(), valid.sum(), grads

    return fn


@torch.no_grad()
def ref_logps_fn(ref_params, batch, model_cfg: qwen2.Qwen2Config, temperature: float):
    """Frozen per-token logps under the GIVEN params: the KL penalty's
    reference term (beta > 0), and the cached old-policy logps for
    multi-epoch PPO (num_iterations > 1)."""
    ids, attn = batch["ids"], batch["attn"]
    _, hidden, _ = model_module(model_cfg).forward(ref_params, model_cfg, ids,
                                                   attention_mask=attn, return_hidden=True,
                                                   compute_logits=False)
    logps = _selective_logps_chunked(ref_params, model_cfg, hidden[:, :-1, :],
                                     ids[:, 1:], temperature)
    return logps * batch["comp_mask"].float()[:, 1:]

