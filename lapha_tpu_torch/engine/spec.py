"""Prompt-lookup speculative decoding (``Engine(spec_decode="pld")``), on
tensors — the port of ``lapha_tpu/engine/spec.py``.

MCTS children repeat their parents' text (quoted expressions, repeated tool
output, loops), so an n-gram lookup over a row's own token history proposes
drafts with no draft model. One engine iteration forwards [last token,
draft_1..draft_K] through ``decode_step_multi`` (K + 1 tokens for about the
weight reads of one) and accepts a prefix of the drafts:

- greedy rows take the penalised argmax, as ``sampling.sample``: a draft is
  accepted iff it equals that argmax, so greedy streams are those of the
  non-speculative loop;
- sampled rows run delta-proposal rejection sampling on the same processed
  logits (``sampling.process_logits``): accept draft d with probability
  p(d), else sample from p with d masked out, so each position's marginal
  is exactly p. The draws come from an explicit ``torch.Generator``, so the
  streams differ from JAX's for the same seed.

Rejected drafts' cache columns stay written but invalid: the engine keeps a
per-row validity bitmap (``qwen2.decode_step_multi``).
"""

from __future__ import annotations

import torch

from . import sampling

__all__ = ["ngram_propose", "scatter_emit", "pick_with_draft"]


def ngram_propose(seq: torch.Tensor, cur: torch.Tensor, K: int, M: int = 2):
    """Draft K tokens a row by prompt lookup.

    seq (B, H) token history, valid in [0, cur); cur (B,) current lengths.
    Finds the latest position j < cur - 1 whose M-gram seq[j-M+1 .. j]
    equals the current suffix seq[cur-M .. cur-1] and proposes seq[j+1 ..
    j+K]. Returns (draft (B, K) int64, draft_len (B,) int64 in [0, K]): the
    continuation tokens that already exist (index < cur)."""
    B, H = seq.shape
    dev = seq.device
    cur = cur.long()
    ar = torch.arange(H, device=dev)[None, :]
    match = torch.ones((B, H), dtype=torch.bool, device=dev)
    for m in range(M):
        # the suffix token m from its start, seq[cur - M + m]
        suf = seq.gather(1, (cur[:, None] - M + m).clamp(min=0))
        # candidate j matches at offset m through seq[j - (M-1) + m]
        match &= torch.roll(seq, (M - 1) - m, dims=1) == suf
    # j has a whole M-gram before it and is not the suffix itself
    match &= (ar >= M - 1) & (ar < cur[:, None] - 1) & (cur[:, None] >= M + 1)
    j = torch.where(match, ar, -1).argmax(dim=1)  # the latest match
    has = match.any(dim=1)
    idx = j[:, None] + 1 + torch.arange(K, device=dev)[None, :]
    draft = seq.gather(1, idx.clamp(max=H - 1)).long()
    avail = (idx < cur[:, None]).long().sum(dim=1)
    return draft, torch.where(has, avail, 0)


def scatter_emit(buf: torch.Tensor, em: torch.Tensor, toks: torch.Tensor,
                 emit_mask: torch.Tensor) -> torch.Tensor:
    """Write a variable-length window of tokens a row into an emit buffer.

    buf (B, T), em (B,) the counts so far, toks (B, W) the window's values,
    emit_mask (B, W) the positions emitted. Position w of row b lands at
    column em[b] + (emitted positions before w); columns past T drop.
    Returns a new buffer."""
    B, T = buf.shape
    cols = em.long()[:, None] + emit_mask.long().cumsum(dim=1) - 1
    ok = emit_mask & (cols >= 0) & (cols < T)
    out = torch.cat([buf, buf.new_zeros((B, 1))], dim=1)  # column T takes what drops
    out.scatter_(1, torch.where(ok, cols, T), toks.to(buf.dtype))
    return out[:, :T]


def pick_with_draft(logits, generator: torch.Generator, draft, has_draft, *, presence,
                    repetition_penalty, temperature, top_k, top_p, min_p, static_top_k: int = 0):
    """One position of the acceptance chain: (token (B,) int64, logprob (B,)
    f32) from this position's logits (B, V).

    The engine's sampling pipeline (``sampling.process_logits``, exact
    top-k), then: sampled rows accept the draft with probability p(draft),
    else sample from p with the draft masked out; greedy rows (temperature
    <= 0) take the penalised argmax, as ``sampling.sample``. Rows without a
    draft sample from the full processed distribution. The logprob is that
    of the processed distribution at the token."""
    processed = sampling.process_logits(
        logits, presence=presence, repetition_penalty=repetition_penalty,
        temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
        static_top_k=static_top_k)
    logp = torch.log_softmax(processed, dim=-1)
    B, V = logits.shape
    draft = draft.long()
    p_d = torch.exp(logp.gather(1, draft[:, None])[:, 0])
    u = torch.rand((B,), generator=generator, device=logits.device)
    accept = has_draft & (u < p_d)
    is_d = torch.arange(V, device=logits.device)[None, :] == draft[:, None]
    src = torch.where(is_d & (has_draft & ~accept)[:, None], sampling.NEG_INF, processed)
    gumbel = -torch.log(-torch.log(
        torch.rand(src.shape, generator=generator, device=src.device).clamp(min=1e-20)))
    tok = torch.where(accept, draft, torch.argmax(src + gumbel, dim=-1))
    if temperature is not None:
        greedy_src = logits.float()
        if repetition_penalty is not None and presence is not None:
            greedy_src = sampling.apply_repetition_penalty(greedy_src, presence,
                                                           repetition_penalty)
        tok = torch.where(temperature <= 0.0, torch.argmax(greedy_src, dim=-1), tok)
    return tok, logp.gather(1, tok[:, None])[:, 0]
