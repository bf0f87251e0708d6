"""Block-diffusion generation (SDAR/JetEngine semantics), eager PyTorch — the
port of ``lapha_tpu/engine/diffusion.py``.

The model is autoregressive across fixed blocks of ``block_length`` tokens
and a masked-denoising diffusion within each block: a block starts as all
[MASK] tokens and each forward reveals positions by sampling confidence, so
several tokens can commit per forward. The loop rides the Engine's prefill,
prefix reuse and fan-out; each iteration forwards the current block through
``qwen2.forward(block_bidir=True)`` (bidirectional inside the block, causal
over the committed past), whose attention is the block-attention kernel
(``ops/block_attention.py``): every query of the block sees every valid column.

Loop invariant (JAX's): an iteration whose block is fully revealed at entry
is a *commit* step — its forward rewrote the block's K/V from the clean
tokens (the earlier denoise forwards wrote them with [MASK] embeddings in
place), the tokens land in the output and the loop moves to the next
all-[MASK] block. Otherwise it is a *denoise* step: every still-masked
position is sampled from the block logits and revealed per the remasking
strategy. A block costs (denoise steps until clean) + 1 forwards.

Remasking strategies:
  low_confidence_dynamic  reveal every position with confidence >= threshold,
                          and always the most confident one (the default)
  low_confidence_static   reveal the ceil(T_blk/steps) most confident
  sequential              reveal the ceil(T_blk/steps) leftmost masked
All of them reveal every masked position on the ``denoising_steps``-th pass.

Deliberate deviations from JAX: the ``while_loop`` and ``lax.cond`` become
one eager loop, the one-block chunk that the scheduler runs and the sync
generate runs once a block, reading one small tensor back per forward ("is
the block clean", or at a block boundary "has every row finished"), where
JAX reads back nothing until the end; random draws come from a
``torch.Generator`` (``sampling.sample``), so sampled tokens differ from
JAX's for the same seed while greedy ones agree.
``last_timings`` holds the prefill and the loop's host seconds and its
forwards (``decode_steps``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..models import qwen2
from . import sampling
from .adapter import CompletionOutput, RequestOutput
from .engine import Engine, _round_up

NEG_INF = -1e30
STRATEGIES = ("low_confidence_dynamic", "low_confidence_static", "sequential")

__all__ = ["DiffusionEngine", "STRATEGIES"]


class DiffusionEngine(Engine):
    """Engine whose generate() runs block diffusion instead of AR decode.

    Reuses the Engine's tokenizer handling, batched prefix-reuse prefill
    (``_prefill_rows``) and waves; only the token loop differs. Serves
    SDAR-class checkpoints: Qwen2-family bodies with a reserved [MASK] id.
    Composes with continuous batching (``auto_continuous=True`` or a
    :class:`~.scheduler.ContinuousEngine`): the scheduler's persistent batch
    then advances one committed block a chunk (:meth:`_diff_chunk_impl`).
    """

    decode_kind = "diffusion"

    def __init__(self, params, cfg, tokenizer, *, mask_token_id: int, block_length: int = 4,
                 denoising_steps: int = 4, remasking_strategy: str = "low_confidence_dynamic",
                 dynamic_threshold: float = 0.9, **kw):
        if kw.get("spec_decode") or kw.get("seq_mesh") is not None:
            raise ValueError("diffusion generation does not compose with spec_decode/seq_mesh")
        if kw.pop("collect_h0", False):
            raise ValueError("diffusion generation does not collect h0 "
                             "(value-mode MCTS drives the AR Engine)")
        if kw.get("kv_quant"):
            raise ValueError("diffusion does not support kv_quant yet "
                             "(denoise steps REWRITE block K/V in place; "
                             "the quantized decode layout is append-only)")
        super().__init__(params, cfg, tokenizer, **kw)
        if self._mod is not qwen2:
            raise ValueError("diffusion generation is qwen2-family only "
                             "(SDAR checkpoints are Qwen-based)")
        if int(cfg.sliding_window or 0) or cfg.layer_windows or \
                getattr(cfg, "attn_sinks", False):
            raise ValueError("diffusion does not support windowed/sink attention stacks")
        if not 0 <= int(mask_token_id) < cfg.vocab_size:
            raise ValueError(f"mask_token_id {mask_token_id} outside vocab")
        if remasking_strategy not in STRATEGIES:
            raise ValueError(f"unknown remasking_strategy {remasking_strategy!r}; "
                             f"one of {STRATEGIES}")
        if int(block_length) < 1 or int(denoising_steps) < 1:
            raise ValueError("block_length and denoising_steps must be >= 1")
        self.mask_token_id = int(mask_token_id)
        self.block_length = int(block_length)
        self.denoising_steps = int(denoising_steps)
        self.remasking_strategy = str(remasking_strategy)
        self.dynamic_threshold = float(dynamic_threshold)
        # the last generate's forwards and tokens (the diffusion speedup)
        self.last_diffusion_stats: dict | None = None

    # ------------------------------------------------------------------ reveal

    def _reveal_step(self, logits, blk_tok, blk_masked, blk_lp, d: int, generator, *,
                     temperature, top_k, top_p, min_p, threshold, Tb: int, steps: int,
                     strategy: str, static_top_k: int):
        """One denoise step: sample every position (the [MASK] id
        suppressed), reveal per the strategy. Shared by the sync loop and
        the scheduler's chunk. Returns (blk_tok, blk_masked, blk_lp)."""
        B = blk_tok.shape[0]
        k_reveal = max(1, math.ceil(Tb / steps))
        flat = logits.reshape(B * Tb, -1).float().clone()
        flat[:, self.mask_token_id] = NEG_INF  # the model must not reveal [MASK] itself

        def rep(v):
            return None if v is None else v.repeat_interleave(Tb, dim=0)

        cand_f, lp_f = sampling.sample(
            flat, generator, temperature=rep(temperature), top_k=rep(top_k), top_p=rep(top_p),
            min_p=rep(min_p), static_top_k=static_top_k)
        cand, cand_lp = cand_f.reshape(B, Tb), lp_f.reshape(B, Tb)
        conf = torch.exp(cand_lp)
        conf_m = torch.where(blk_masked, conf, -torch.inf)
        ar = torch.arange(Tb, device=blk_tok.device)
        if d + 1 >= steps:  # the last pass reveals everything still masked
            reveal = blk_masked
        elif strategy == "low_confidence_dynamic":
            top1 = ar[None, :] == conf_m.argmax(dim=1, keepdim=True)
            reveal = blk_masked & ((conf >= threshold[:, None]) | top1)
        else:
            # rank among the masked positions by a double stable argsort (as
            # jnp.argsort): by confidence, or leftmost first
            key = -conf_m if strategy == "low_confidence_static" else torch.where(
                blk_masked, ar[None, :], Tb)
            rank = torch.argsort(torch.argsort(key, dim=1, stable=True), dim=1, stable=True)
            reveal = blk_masked & (rank < k_reveal)
        return (torch.where(reveal, cand, blk_tok), blk_masked & ~reveal,
                torch.where(reveal, cand_lp, blk_lp))

    def _fresh_block(self, B: int, Tb: int):
        dev = self.device
        return (torch.full((B, Tb), self.mask_token_id, dtype=torch.int64, device=dev),
                torch.ones((B, Tb), dtype=torch.bool, device=dev),
                torch.zeros((B, Tb), dtype=torch.float32, device=dev))

    def _is_eos(self, blk_tok):
        eos = self._t(self.eos_token_ids or [-1])
        return (blk_tok[:, :, None] == eos[None, None, :]).any(dim=(1, 2))

    # -------------------------------------------------------------------- loop

    def _diffusion_impl(self, ck, cv, lens, fin0, generator, temperature, top_k, top_p, min_p,
                        threshold, *, Lp: int, Tb: int, nblocks: int, steps: int, strategy: str,
                        static_top_k: int):
        """The whole generation over the prefill-layout cache (L, B, S, nkv,
        dh), prompts at slots [0, lens[b]): block b is the scheduler's chunk
        (:meth:`_diff_chunk_impl`) at columns [Lp + b·Tb, Lp + (b+1)·Tb) for
        every row, and the loop ends early once every row has finished
        (JAX's loop condition, read back at each block boundary, the only
        place it changes). Returns (out (B, nblocks·Tb), out_lp, finished,
        forwards); the cache is written in place."""
        B = ck.shape[1]
        dev = self.device
        out = torch.zeros((B, nblocks * Tb), dtype=torch.int64, device=dev)
        out_lp = torch.zeros((B, nblocks * Tb), dtype=torch.float32, device=dev)
        dstart = torch.full((B,), Lp, dtype=torch.int64, device=dev)
        emitted = torch.zeros((B,), dtype=torch.int64, device=dev)
        budget = torch.full((B,), nblocks * Tb, dtype=torch.int64, device=dev)
        finished, nfwd = fin0, 0
        for b in range(nblocks):
            if bool(finished.all()):
                break
            blk_tok, blk_lp, finished, emitted, k = self._diff_chunk_impl(
                ck, cv, lens, dstart, finished, emitted, budget, Lp + b * Tb, generator,
                temperature, top_k, top_p, min_p, threshold, Tb=Tb, steps=steps,
                strategy=strategy, static_top_k=static_top_k)
            out[:, b * Tb:(b + 1) * Tb] = blk_tok
            out_lp[:, b * Tb:(b + 1) * Tb] = blk_lp
            nfwd += k
        return out, out_lp, finished, nfwd

    def _diff_chunk_impl(self, ck, cv, lens, dstart, fin, emitted, budget, col: int, generator,
                         temperature, top_k, top_p, min_p, threshold, *, Tb: int, steps: int,
                         strategy: str, static_top_k: int):
        """One committed block over the persistent batch (the scheduler's
        chunk, and each block of the sync loop).

        ck/cv: the prefill-layout persistent cache (L, B, S, nkv, dh); row r's
        prompt at slots [0, lens[r]), its committed tokens at [dstart[r],
        col). The block at columns [col, col + Tb) is denoised until clean
        and committed, so every chunk boundary is a commit boundary. The
        sampling knobs are per-row (B,) vectors. Returns (blk_tok (B, Tb),
        blk_lp, fin, emitted, forwards); the cache is written in place."""
        B, S = ck.shape[1], ck.shape[2]
        dev = self.device
        j = torch.arange(S, device=dev)[None, :]
        # a row's block starts at its prompt length + the tokens it committed
        pos = (lens + (col - dstart))[:, None] + torch.arange(Tb, device=dev)[None, :]
        kvv = (j < lens[:, None]) | ((j >= dstart[:, None]) & (j < col + Tb))
        blk_tok, blk_masked, blk_lp = self._fresh_block(B, Tb)
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
                  threshold=threshold, Tb=Tb, steps=steps, strategy=strategy,
                  static_top_k=static_top_k)
        d = nfwd = 0
        while True:
            # the block is all [MASK] on entry: no read-back before the first
            # forward, one (is the block clean) after each denoise step
            clean = nfwd > 0 and not bool(blk_masked.any())
            logits = qwen2.forward(self.params, self.cfg, blk_tok, positions=pos, kv_cache=(ck, cv),
                                   cache_pos=col, kv_valid=kvv, block_bidir=True)[0]
            nfwd += 1
            if clean:
                em = torch.where(fin, emitted, emitted + Tb)  # finished rows do not emit
                fin = fin | self._is_eos(blk_tok) | (em >= budget)
                return blk_tok, blk_lp, fin, em, nfwd
            blk_tok, blk_masked, blk_lp = self._reveal_step(
                logits, blk_tok, blk_masked, blk_lp, d, generator, **kw)
            d += 1

    # ---------------------------------------------------------------- generate

    def _generate_chunk(self, prompts: list[str], sp, n: int,
                        encs: list[list[int]] | None = None):
        tok = self.tokenizer
        dev = self.device
        enc = (encs if encs is not None else
               [tok(p, add_special_tokens=True)["input_ids"] for p in prompts])
        max_prompt = self.max_model_len - 1
        enc = [list(ids)[-max_prompt:] for ids in enc]
        P = len(enc)
        max_len = max(len(e) for e in enc)
        max_new = int(getattr(sp, "max_tokens", 256) or 256)
        Tb = self.block_length
        nblocks = max(1, math.ceil(max_new / Tb))
        Lp = _round_up(min(self.max_model_len, max_len), self.pad_multiple)
        S = _round_up(Lp + nblocks * Tb, self.pad_multiple)

        t0 = time.perf_counter()
        _, (ck, cv), _ = self._prefill_rows(enc, S)
        self._sync()
        self.last_timings["prefill_s"] += time.perf_counter() - t0

        # fan out to B = P·n rows sharing each prompt's prefill KV
        Bb = _round_up(P * n, self.batch_bucket)
        row_of = np.concatenate([np.repeat(np.arange(P), n), np.zeros(Bb - P * n, np.int64)])
        row_of_t = self._t(row_of)
        ck, cv = ck[:, row_of_t], cv[:, row_of_t]
        B = Bb
        lens = self._t(np.asarray([len(enc[r]) for r in row_of], np.int64))
        # bucket-padding rows are born finished, so they never hold the
        # loop's all-finished exit hostage
        fin0 = torch.zeros((B,), dtype=torch.bool, device=dev)
        fin0[P * n:] = True

        def vec(name, default):
            v = getattr(sp, name, None)
            return torch.full((B,), float(default if v is None else v), device=dev)

        temperature = vec("temperature", 1.0)
        tp_val = float(getattr(sp, "top_p", 1.0) or 1.0)
        top_p = None if tp_val >= 1.0 else vec("top_p", 1.0)
        mp_val = float(getattr(sp, "min_p", 0.0) or 0.0)
        min_p = None if mp_val <= 0.0 else vec("min_p", 0.0)
        tk = getattr(sp, "top_k", -1)
        tk = int(-1 if tk is None else tk)
        top_k = None if tk <= 0 else torch.full((B,), tk, dtype=torch.int64, device=dev)
        static_top_k = 0 if tk <= 0 else min(self.cfg.vocab_size, max(64, tk))
        # a request's SDAR knob overrides the engine's default (GenParams)
        thr_sp = getattr(sp, "dynamic_threshold", None)
        threshold = torch.full((B,), float(self.dynamic_threshold if thr_sp is None else thr_sp),
                               device=dev)

        self._call_counter += 1
        seed = sp.seed if getattr(sp, "seed", None) is not None else self._call_counter
        generator = torch.Generator(device=dev).manual_seed(int(seed))

        t0 = time.perf_counter()
        out, out_lp, _, nfwd = self._diffusion_impl(
            ck, cv, lens, fin0, generator, temperature, top_k, top_p, min_p, threshold, Lp=Lp,
            Tb=Tb, nblocks=nblocks, steps=self.denoising_steps,
            strategy=self.remasking_strategy, static_top_k=static_top_k)
        toks = out[:, :max_new].cpu().numpy()
        lps = out_lp[:, :max_new].cpu().numpy()
        self.last_timings["decode_s"] += time.perf_counter() - t0
        self.last_timings["decode_steps"] += nfwd

        eos_set = set(self.eos_token_ids)
        results = []
        emitted = 0
        for p in range(P):
            outs = []
            for jj in range(n):
                r = p * n + jj
                ids_out: list[int] = []
                lps_out: list[float] = []
                for t in range(toks.shape[1]):
                    ids_out.append(int(toks[r, t]))
                    lps_out.append(float(lps[r, t]))
                    if ids_out[-1] in eos_set:
                        break
                emitted += len(ids_out)
                finish = "stop" if (ids_out and ids_out[-1] in eos_set) else "length"
                text = (tok.decode(ids_out, skip_special_tokens=True)
                        if hasattr(tok, "decode") else None)
                outs.append(CompletionOutput(
                    token_ids=ids_out, cumulative_logprob=float(np.sum(lps_out)),
                    token_logprobs=lps_out, text=text, finish_reason=finish))
            results.append(RequestOutput(outputs=outs, prompt=prompts[p],
                                         prompt_token_ids=list(enc[p])))
        self.last_diffusion_stats = {
            "forwards": int(nfwd), "tokens": emitted,
            "tokens_per_forward": round(emitted / max(1, int(nfwd)), 3)}
        return results
