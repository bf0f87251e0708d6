"""Batched generation engine, eager PyTorch — the sync path of
``lapha_tpu/engine/engine.py``.

- Slot-uniform KV layout: each row's ragged prompt lives at slots [0, len)
  inside a shared [0, Lp) slab; decode step t writes slot Lp + t for all
  rows. Positions stay ragged for RoPE; attention only needs slot validity.
- Token-prefix KV reuse across calls (``prefix_cache.py``): a child prompt
  reuses its parent's cached prefix and only the suffix is prefilled, in
  one batched forward with per-row query offsets.
- n-sample fan-out: each unique prompt's KV is gathered to its n rows.
- Decode runs eagerly, one token per step for all rows, attention through
  the ragged decode kernel; "all rows finished" is read back once per
  ``decode_chunk`` steps. Finished rows emit 0 either way, so the tokens
  are those of the JAX engine's per-step ``while_loop`` exit.
- ``collect_h0``: the final-hidden sum over prompt + emitted tokens is
  accumulated during generation, so value scoring needs no extra forward.
- ``kv_quant="int8"``: the decode cache is int8 with per-vector f32 scales.
  Prefill and the prefix cache stay in the working dtype; the cache is
  quantized once, when it is installed in the decode layout (after the
  fan-out gather and the transpose), and decode writes and reads it
  through ``decode_step(cache_scale=)``. Quantized weights
  (``models/quant.py``) need nothing of the engine.
- The model module comes from the config (``models.model_module``): qwen2,
  or deepseek, whose MLA latent cache rides the same layout code
  MQA-shaped (one "head" of the latent width, ``deepseek.init_kv_cache``).
- Sliding-window stacks (GPT-OSS): the decode install keeps the windowed
  layers in a short cache, each row's last ``Wpad`` prompt slots plus the
  decode columns (``decode_step(win_cache=)``; JAX ``_install_win_impl``),
  where that is shorter: engaged when Wpad + (S - Lp) + min(pad_multiple,
  128) <= S, Wpad = max_window rounded up to min(pad_multiple, 128). The
  int8 KV cache quantizes the short cache too.
- ``auto_continuous``: a ``generate`` call larger than one wave (more than
  ``max_batch // n`` prompts) goes through an internal
  :class:`~.scheduler.ContinuousEngine`, so rows that finish early are
  replaced mid-wave; it falls back to waves wherever the scheduler would
  change the request (JAX ``generate``), and always under ``spec_decode``.
  The scheduler draws its own seeds, so sampled tokens differ from the sync
  path's; greedy tokens agree. A :class:`~.diffusion.DiffusionEngine` gets
  the scheduler's block-diffusion branch.
- ``spec_decode="pld"``: prompt-lookup speculative decoding (``spec.py``).
  An iteration drafts ``spec_k`` tokens a row by ``spec_ngram``-gram lookup
  over the row's history and verifies them in one (K+1)-token
  ``decode_step_multi`` forward (a 1-token one where no live row has a
  draft); rejected drafts leave holes in the cache, tracked by a per-row
  validity bitmap, so the decode region is sized (K+1)x the token budget.
  Greedy streams are the non-speculative loop's; sampled streams keep each
  position's distribution. The eager loop reads one small tensor back a
  iteration ("all finished", "any live row has a draft"), where JAX's loop
  has ``while_loop`` and ``lax.cond``. ``last_spec_stats`` sums the waves of
  one ``generate`` call.

Not ported yet (it raises ``ValueError("... not yet ported")``):
``seq_mesh``; sliding-window checkpoints of families other than gpt_oss are
refused by ``Qwen2Config.from_hf``.
"""

from __future__ import annotations

import time
from typing import Any, Sequence

import numpy as np
import torch

from ..models import model_module, qwen2
from ..models.quant import leaf_device
from . import sampling
from .adapter import CompletionOutput, RequestOutput, SamplingParams
from .prefix_cache import PrefixCacheStore


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Engine:
    # the token loop generate() runs: "ar" here, "diffusion" in
    # :class:`~.diffusion.DiffusionEngine` (the scheduler reads it)
    decode_kind = "ar"

    def __init__(
        self,
        params: Any,
        cfg,
        tokenizer,
        *,
        max_model_len: int = 4096,
        max_batch: int = 16,
        decode_chunk: int = 16,
        pad_multiple: int = 128,
        batch_bucket: int = 4,
        eos_token_ids: Sequence[int] | None = None,
        seed: int = 0,
        prefix_cache_bytes: int = 1_500_000_000,
        prefix_cache_min_reuse: int = 64,
        collect_h0: bool = False,
        device=None,
        kv_quant: str | None = None,
        seq_mesh=None,
        spec_decode: str | None = None,
        spec_k: int = 3,
        spec_ngram: int = 2,
        auto_continuous: bool = False,
    ):
        if seq_mesh:
            raise ValueError("seq_mesh: not yet ported")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant={kv_quant!r}")
        if spec_decode not in (None, "pld"):
            raise ValueError(f"unsupported spec_decode={spec_decode!r}")
        self.kv_quant = kv_quant
        # spec_decode="pld": K drafts an iteration, verified in one (K+1)-token
        # forward; the decode region is sized (K+1)x the budget (module docstring)
        self.spec_decode = spec_decode
        self.spec_k = int(spec_k)
        self.spec_ngram = int(spec_ngram)
        self.last_spec_stats: dict | None = None
        self.params = params
        self.cfg = cfg
        self._mod = model_module(cfg)
        self.tokenizer = tokenizer
        self.device = (torch.device(device) if device is not None
                       else leaf_device(params["embed"]["weight"]))
        self.max_model_len = int(max_model_len)
        self.max_batch = int(max_batch)
        self.decode_chunk = int(decode_chunk)
        self.pad_multiple = int(pad_multiple)
        self.batch_bucket = int(batch_bucket)
        self._call_counter = 0
        self.collect_h0 = bool(collect_h0)
        # generate() calls larger than one wave go through the scheduler
        self.auto_continuous = bool(auto_continuous)
        self._auto_sched = None
        self.prefix_cache = (
            PrefixCacheStore(prefix_cache_bytes, prefix_cache_min_reuse,
                             pad_to=min(self.pad_multiple, 128))
            if prefix_cache_bytes > 0 else None
        )
        if eos_token_ids is None:
            eos = getattr(tokenizer, "eos_token_id", None)
            eos_token_ids = [eos] if eos is not None else []
        self.eos_token_ids = [int(e) for e in eos_token_ids if e is not None]
        # host-clock seconds of the last generate() call, summed over its
        # waves; the device is synchronised at each phase boundary
        self.last_timings = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0}
        # sliding-window stacks: (full layers, windowed layers, max window)
        lw = [cfg.window_for_layer(l) for l in range(cfg.num_hidden_layers)]
        self._win_split = None
        if any(lw):
            self._win_split = (tuple(l for l, w in enumerate(lw) if not w),
                               tuple(l for l, w in enumerate(lw) if w), max(lw))

    # ------------------------------------------------------------------ device bodies

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _last_and_hsum(self, hidden, mask, last_idx):
        """Last-token logits (P, V) f32 and the masked hidden sum (P, H)."""
        P = hidden.shape[0]
        rows = torch.arange(P, device=self.device)
        last = qwen2._lm_head(self.params, self.cfg,
                              hidden[rows, last_idx.long().clamp(min=0)])
        if self.collect_h0:
            h_sum = torch.einsum("plh,pl->ph", hidden.float(), mask.float())
        else:
            h_sum = torch.zeros((P, self.cfg.hidden_size), device=self.device)
        return last, h_sum

    def _prefill_impl(self, ids, mask, plen, S: int):
        """ids/mask (P, Lp) right-padded; plen (P,) real lengths. Returns
        (last_logits (P, V), (ck, cv) (L, P, S, nkv, dh), h_sum (P, H))."""
        P, Lp = ids.shape
        cache = self._mod.init_kv_cache(self.cfg, P, S, self.device)
        kv_valid = torch.zeros((P, S), dtype=torch.bool, device=self.device)
        kv_valid[:, :Lp] = mask > 0
        positions = (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        # only the last real token's logits are used: the hidden states come
        # back and the LM head runs on those rows alone
        _, hidden, cache = self._mod.forward(
            self.params, self.cfg, ids, positions=positions, kv_cache=cache,
            cache_pos=0, kv_valid=kv_valid, return_hidden=True,
            compute_logits=False)
        last, h_sum = self._last_and_hsum(hidden, mask, plen - 1)
        return last, cache, h_sum

    def _suffix_batch_impl(self, cache_k, cache_v, ids, mask, starts, real_lens):
        """Batched prefix-hit prefill: row i's reused prefix KV already sits at
        [0, starts[i]); the right-padded suffixes (Hn, Ls) forward in one pass
        with per-row offsets, writing the caches in place."""
        S = cache_k.shape[2]
        kv_valid = torch.arange(S, device=self.device)[None, :] < (starts + real_lens)[:, None]
        positions = starts[:, None] + (torch.cumsum(mask, dim=1) - 1).clamp(min=0)
        _, hidden, cache = self._mod.forward(
            self.params, self.cfg, ids, positions=positions,
            kv_cache=(cache_k, cache_v), cache_pos=starts, kv_valid=kv_valid,
            return_hidden=True, compute_logits=False)
        last, h_sum = self._last_and_hsum(hidden, mask, real_lens - 1)
        return last, cache, h_sum

    def _install_win(self, ck, cv, lens, slab: int, Sw: int, Wpad: int):
        """Prefill-layout caches (L, B, S, nkv, dh) -> the windowed-short
        decode install: the full-attention layers in the decode layout
        (Lf, B, nkv, S, dh); the windowed layers' short (Lw, B, nkv, Sw, dh)
        stack holding each row's prompt tail [lens - Wpad, lens) (indices
        clipped to the cache; columns before slot 0 are outside the ranges
        decode reads) and Sw - Wpad empty decode columns. Returns (full_k,
        full_v, win_cache dict)."""
        full_idx, win_idx, _ = self._win_split
        S = ck.shape[2]
        woff = lens - Wpad
        idx = (woff[:, None] + torch.arange(Wpad, device=self.device)[None, :]).clamp(0, S - 1)

        def grab_win(c):
            cw = c[list(win_idx)]                            # (Lw, B, S, nkv, dh)
            gidx = idx[None, :, :, None, None].expand(cw.shape[0], -1, -1, *cw.shape[3:])
            out = torch.zeros((cw.shape[0], cw.shape[1], cw.shape[3], Sw, cw.shape[4]),
                              dtype=c.dtype, device=c.device)
            out[:, :, :, :Wpad] = torch.gather(cw, 2, gidx).permute(0, 1, 3, 2, 4)
            return out

        def grab_full(c):  # empty for a stack of windowed layers only
            return c[list(full_idx)].permute(0, 1, 3, 2, 4).contiguous()

        wc = {"k": grab_win(ck), "v": grab_win(cv), "woff": woff, "slab": slab}
        return grab_full(ck), grab_full(cv), wc

    @staticmethod
    def _quantize_cache(ck, cv):
        """Decode-layout caches (L,B,nkv,S,dh) -> int8 + per-vector f32 scales
        (L,B,nkv,S): the JAX engine's ``_quantize_cache_impl`` (empty slots
        quantize to 0 with the 1e-12 floor scale)."""
        kq, ks = qwen2._quantize_kv(ck)
        vq, vs = qwen2._quantize_kv(cv)
        return kq, vq, (ks, vs)

    def _decode_impl(self, cache_k, cache_v, presence, last_logits, lens, dstart,
                     positions, slot: int, finished, row_budget, generator,
                     temperature, top_k, top_p, min_p, rep_pen, T: int,
                     static_top_k: int = 0, use_presence: bool = True, cache_scale=None,
                     win_cache=None, win_pad: int = 0, emitted=None):
        """Generate up to T tokens for all B rows over the slot-uniform cache
        (L, B, nkv, S, dh), int8 with ``cache_scale`` = (ks, vs), the
        windowed layers in ``win_cache`` when it is given. A row finishes on
        EOS or when its ``emitted`` count (zeros by default; the scheduler
        carries it across chunks) reaches ``row_budget``; finished rows emit
        token 0 with logprob 0. The weights are read once, at entry: a
        concurrent :meth:`update_params` takes effect at the next call.
        Returns (tokens (B,T), logprobs (B,T), finished, h_sum (B,H), steps
        run, the last step's logits (B,V), the next positions, the next
        column, emitted); the caches are written in place."""
        dev = self.device
        params = self.params
        B = last_logits.shape[0]
        eos = self._t(self.eos_token_ids or [-1])
        toks = torch.zeros((B, T), dtype=torch.int64, device=dev)
        lps = torch.zeros((B, T), dtype=torch.float32, device=dev)
        emitted = (torch.zeros((B,), dtype=torch.int64, device=dev) if emitted is None
                   else emitted.to(device=dev, dtype=torch.int64).clone())
        h_sum = torch.zeros((B, self.cfg.hidden_size), device=dev)
        rows = torch.arange(B, device=dev)
        logits = last_logits
        steps = 0
        for i in range(T):
            # one host read-back per chunk, not per step
            if i % self.decode_chunk == 0 and bool(finished.all()):
                break
            steps += 1
            tok, lp = sampling.sample(
                logits, generator,
                presence=presence if use_presence else None,
                repetition_penalty=rep_pen if use_presence else None,
                temperature=temperature, top_k=top_k, top_p=top_p,
                min_p=min_p, static_top_k=static_top_k)
            live = ~finished
            is_eos = (tok[:, None] == eos[None, :]).any(dim=1)
            toks[:, i] = torch.where(live, tok, 0)
            lps[:, i] = torch.where(live, lp, 0.0)
            emitted += live.long()
            if use_presence:
                presence[rows, tok] = torch.maximum(presence[rows, tok], live.to(presence.dtype))
            logits, hidden, cache_k, cache_v, *_ = self._mod.decode_step(
                params, self.cfg, tok, positions, cache_k, cache_v, slot,
                lens, dstart, return_hidden=self.collect_h0, ragged=True,
                cache_scale=cache_scale, win_cache=win_cache, win_pad=win_pad)
            if self.collect_h0:
                # the token sampled this step is forwarded this step; pool it
                # iff it was emitted (live on entry — includes the EOS)
                h_sum += hidden.float() * live[:, None]
            finished = finished | is_eos | (emitted >= row_budget)
            positions = positions + 1
            slot += 1
        return toks, lps, finished, h_sum, steps, logits, positions, slot, emitted

    def _decode_spec_impl(self, cache_k, cache_v, presence, last_logits, lens, seq, positions,
                          slot: int, finished, row_budget, generator, temperature, top_k,
                          top_p, min_p, rep_pen, T: int, K: int, M: int,
                          static_top_k: int = 0, cache_scale=None):
        """The speculative variant of :meth:`_decode_impl` (JAX
        ``_decode_spec_impl``). Token 0 comes from the prefill logits; then
        each iteration drafts K tokens a row (``spec.ngram_propose`` over the
        history ``seq`` (B, H)) and forwards [last token, drafts] through
        ``decode_step_multi``, or only the last token where no live row has
        a draft, and runs the acceptance chain (``spec.pick_with_draft``)
        with presence evolving inside the window. Every iteration advances
        the shared column by its width; ``valid`` (B, S) marks the columns
        whose tokens were emitted, ``posm`` each written column's position.
        The loop stops when every row finished, after T iterations, or when
        a full window plus the reserved h0 column no longer fits. With
        ``collect_h0`` a last 1-token forward at the reserved column pools
        the hidden of rows whose last token was never forwarded (a bonus).

        Returns (tokens (B, T), logprobs (B, T), finished, h_sum (B, H),
        iterations, active row-iterations, emitted (B,)); the caches are
        written in place."""
        from . import spec

        dev = self.device
        params = self.params
        step = self._mod.decode_step_multi
        B = last_logits.shape[0]
        S = cache_k.shape[3]
        W = K + 1
        eos = self._t(self.eos_token_ids or [-1])
        rows = torch.arange(B, device=dev)
        pick_kw = dict(repetition_penalty=rep_pen, temperature=temperature, top_k=top_k,
                       top_p=top_p, min_p=min_p, static_top_k=static_top_k)
        no_draft = torch.zeros((B,), dtype=torch.bool, device=dev)
        zeros = torch.zeros((B,), dtype=torch.int64, device=dev)

        def is_eos(t):
            return (t[..., None] == eos).any(dim=-1)

        def forward(toks_in, pos_in, at: int, hidden: bool):
            out = step(params, self.cfg, toks_in, pos_in, cache_k, cache_v, at, valid,
                       return_hidden=hidden, cache_scale=cache_scale, pos_map=posm)
            return out[0], out[1]

        # the pre-step: token 0 from the prefill logits, forwarded as
        # iteration 1's first token
        tok0, lp0 = spec.pick_with_draft(last_logits, generator, zeros, no_draft,
                                         presence=presence, **pick_kw)
        emit0 = ~finished & (row_budget > 0)
        toks = torch.zeros((B, T), dtype=torch.int64, device=dev)
        lps = torch.zeros((B, T), dtype=torch.float32, device=dev)
        toks[:, 0] = torch.where(emit0, tok0, 0)
        lps[:, 0] = torch.where(emit0, lp0, 0.0)
        em = emit0.long()
        presence[rows, tok0] = torch.maximum(presence[rows, tok0], emit0.to(presence.dtype))
        fin = finished | (is_eos(tok0) & emit0) | (em >= row_budget)
        lens = lens.long()
        seq = spec.scatter_emit(seq, lens, tok0[:, None], emit0[:, None])
        cur = lens + emit0.long()
        arS = torch.arange(S, device=dev)
        valid = arS[None, :] < lens[:, None]
        # stored columns' positions: a prompt column's is its index
        posm = arS[None, :].expand(B, S).contiguous()
        pos = positions.long()
        lt = tok0
        unp = emit0  # lt was emitted and its hidden is not pooled yet
        hs = torch.zeros((B, self.cfg.hidden_size), device=dev)
        # the pre-step counts as one active iteration of each emitting row
        act = emit0.long().sum()
        it = 0
        while it < T and slot + W < S:
            draft, dl = spec.ngram_propose(seq, cur, K, M)
            active = ~fin
            # the iteration's one read-back: stop, or verify or single step
            all_fin, has_drafts = torch.stack(
                [fin.all(), ((dl > 0) & active).any()]).tolist()
            if all_fin:
                break
            Wb = W if has_drafts else 1
            toks_in = torch.cat([lt[:, None], draft], dim=1)[:, :Wb]
            logits_w, hidden = forward(toks_in, pos[:, None] + torch.arange(Wb, device=dev),
                                       slot, self.collect_h0)
            em_run, active_i = em, active
            tok_l, lp_l, emit_l, pool_l = [], [], [], []
            for i in range(Wb):
                if i < K and Wb > 1:
                    d_i, has_d = draft[:, i], active_i & (i < dl)
                else:
                    d_i, has_d = zeros, no_draft
                t_i, l_i = spec.pick_with_draft(logits_w[:, i], generator, d_i, has_d,
                                                presence=presence, **pick_kw)
                emit_i = active_i & (em_run < row_budget)
                # pooled: the draft token was emitted, so its hidden from this
                # forward joins the h0 sum; the chain also stops on EOS
                pool_i = (emit_i & (t_i == d_i) & (i < dl) if i < K and Wb > 1
                          else no_draft)
                presence[rows, t_i] = torch.maximum(presence[rows, t_i],
                                                    emit_i.to(presence.dtype))
                em_run = em_run + emit_i.long()
                tok_l.append(t_i)
                lp_l.append(l_i)
                emit_l.append(emit_i)
                pool_l.append(pool_i)
                active_i = pool_i & ~(is_eos(t_i) & emit_i)
            tok_w, lp_w = torch.stack(tok_l, 1), torch.stack(lp_l, 1)
            emit_w, pool_w = torch.stack(emit_l, 1), torch.stack(pool_l, 1)

            # the window's bookkeeping (JAX window_post)
            e = emit_w.long().sum(dim=1)
            fin = fin | (emit_w & is_eos(tok_w)).any(dim=1) | (em_run >= row_budget)
            toks = spec.scatter_emit(toks, em, tok_w, emit_w)
            lps = spec.scatter_emit(lps, em, lp_w, emit_w)
            seq = spec.scatter_emit(seq, cur, tok_w, emit_w)
            # column slot holds lt's KV (valid iff the row decoded), slot + 1 + i
            # draft i's (valid iff that draft was emitted); all of them held a
            # token at position pos + offset, valid or hole alike
            valid[:, slot:slot + Wb] = torch.cat([active[:, None], pool_w[:, :Wb - 1]], dim=1)
            posm[:, slot:slot + Wb] = pos[:, None] + torch.arange(Wb, device=dev)
            last_pooled = ~unp
            for i in range(Wb):
                lt = torch.where(emit_w[:, i], tok_w[:, i], lt)
                last_pooled = torch.where(emit_w[:, i], pool_w[:, i], last_pooled)
            unp = torch.where(e > 0, ~last_pooled, unp)
            if self.collect_h0:
                hs += hidden[:, 0].float() * active[:, None]
                for i in range(Wb - 1):
                    hs += hidden[:, 1 + i].float() * pool_w[:, i][:, None]
            act = act + active.long().sum()
            em = em_run
            pos = pos + e
            cur = cur + e
            slot += Wb
            it += 1
        if self.collect_h0:
            # rows whose last emitted token was a bonus (never forwarded): one
            # 1-token forward at the reserved column (never marked valid)
            _, hid1 = forward(lt[:, None], pos[:, None], min(slot, S - 1), True)
            hs += hid1[:, 0].float() * unp[:, None]
        return toks, lps, fin, hs, it, int(act), em

    def _add_spec_stats(self, tokens: int, iterations: int, active: int) -> None:
        """Sum one wave into ``last_spec_stats``: tokens emitted, iterations,
        and active row-iterations (the pre-step counted as one of each
        emitting row), whose ratio is the tokens a row gets an iteration:
        1.0 when no draft is ever accepted, K + 1 when all are."""
        prev = self.last_spec_stats or {"iterations": 0, "tokens": 0,
                                        "active_row_iterations": 0}
        tot_tok = prev["tokens"] + tokens
        tot_act = prev["active_row_iterations"] + active
        self.last_spec_stats = {
            "iterations": prev["iterations"] + iterations, "tokens": tot_tok,
            "active_row_iterations": tot_act,
            "tokens_per_iteration": round(tot_tok / max(1, tot_act), 3)}

    # ------------------------------------------------------------------ public API

    def update_params(self, params) -> None:
        """Swap weights; cached prefix KV was computed under the old ones."""
        self.params = params
        if self.prefix_cache is not None:
            self.prefix_cache.clear()

    def generate(self, prompts, sampling_params: SamplingParams, use_tqdm: bool = False):
        """vLLM-like entry: list[str] -> list[RequestOutput] with n samples each."""
        sp = sampling_params
        n = max(1, int(getattr(sp, "n", 1)))
        prompts = list(prompts)
        group = max(1, self.max_batch // n)
        self.last_timings = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0}
        if self.spec_decode is not None:
            self.last_spec_stats = None  # summed over this call's waves
        if self.auto_continuous and len(prompts) > group:
            sched = self._continuous()
            # routing must not change the request, so it falls back to waves
            # where the scheduler would: n beyond its rows (submit raises), a
            # budget beyond its decode region (admission would clamp it), a
            # prompt beyond its slab (submit would left-truncate it). The
            # encodings go on to submit, or to the waves, so prompts are
            # tokenized once.
            if sched is not None and n <= sched.B:
                max_new = int(getattr(sp, "max_tokens", 256) or 256)
                if max_new <= sched.S - sched.slab:
                    encs = [list(self.tokenizer(p, add_special_tokens=True)["input_ids"])
                            for p in prompts]
                    if all(len(e) <= sched.slab for e in encs):
                        futs = [sched.submit(p, sp, enc=e) for p, e in zip(prompts, encs)]
                        return [f.result() for f in futs]
                    return self._generate_waves(prompts, sp, n, group, encs=encs)
        return self._generate_waves(prompts, sp, n, group)

    def _generate_waves(self, prompts, sp, n: int, group: int, encs=None):
        results: list[RequestOutput | None] = [None] * len(prompts)
        with torch.inference_mode():
            for lo in range(0, len(prompts), group):
                outs = self._generate_chunk(prompts[lo:lo + group], sp, n,
                                            encs=None if encs is None else encs[lo:lo + group])
                for i, ro in enumerate(outs):
                    results[lo + i] = ro
        return results

    def _continuous(self):
        """The internal :class:`~.scheduler.ContinuousEngine` of
        ``auto_continuous``, built and started on first use (its diffusion
        branch for a :class:`~.diffusion.DiffusionEngine`); None under
        ``spec_decode`` (the scheduler's loop does not speculate), and the
        caller falls back to waves."""
        if self.spec_decode is not None:
            return None
        if self._auto_sched is None:
            from .scheduler import ContinuousEngine

            self._auto_sched = ContinuousEngine(self)
            self._auto_sched.start()
        return self._auto_sched

    # ------------------------------------------------------------------ internals

    def _prefill_full_batch(self, enc_rows: list[list[int]], S: int):
        """Batched full prefill of the given prompts (no prefix reuse)."""
        P = len(enc_rows)
        Lp = min(_round_up(max(len(e) for e in enc_rows), self.pad_multiple),
                 self.max_model_len)
        Pb = _round_up(P, self.batch_bucket)
        ids = np.zeros((Pb, Lp), np.int64)
        mask = np.zeros((Pb, Lp), np.int64)
        plen = np.zeros((Pb,), np.int64)
        for i, e in enumerate(enc_rows):
            ids[i, :len(e)] = e
            mask[i, :len(e)] = 1
            plen[i] = len(e)
        last, cache, h_sum = self._prefill_impl(self._t(ids), self._t(mask),
                                                self._t(plen), S)
        return last[:P], (cache[0][:, :P], cache[1][:, :P]), h_sum[:P]

    def _prefill_hit_batch(self, enc_rows: list[list[int]], hit_rows: list, S: int):
        """Batched prefix-hit prefill: copy each reused prefix into a fresh
        batch cache, then one batched suffix forward with per-row offsets."""
        cfg = self.cfg
        Hn = len(enc_rows)
        sufs = [toks[h[2]:] for toks, h in zip(enc_rows, hit_rows)]
        starts = np.asarray([h[2] for h in hit_rows], np.int64)
        max_suf = max(len(s) for s in sufs)
        # the padded suffix block is written at offset start_i: it must fit
        # inside S for every row
        Ls = _round_up(max_suf, min(self.pad_multiple, 128))
        if int(starts.max()) + Ls > S:
            Ls = _round_up(max_suf, 16)
        if int(starts.max()) + Ls > S:
            Ls = max_suf
        if int(starts.max()) + Ls > S:
            raise ValueError(f"suffix block does not fit: {int(starts.max())} + {Ls} > {S}")

        shape = (cfg.num_hidden_layers, Hn, S, cfg.num_key_value_heads, cfg.head_dim_)
        ck = torch.zeros(shape, dtype=cfg.dtype, device=self.device)
        cv = torch.zeros_like(ck)
        for i, (k_pref, v_pref, _plen, _h) in enumerate(hit_rows):
            ck[:, i, :k_pref.shape[1]] = k_pref
            cv[:, i, :v_pref.shape[1]] = v_pref

        ids = np.zeros((Hn, Ls), np.int64)
        mask = np.zeros((Hn, Ls), np.int64)
        for i, s in enumerate(sufs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        real = np.asarray([len(s) for s in sufs], np.int64)
        last, cache, h_suf = self._suffix_batch_impl(
            ck, cv, self._t(ids), self._t(mask), self._t(starts), self._t(real))
        h_pref = torch.stack([
            h[3] if h[3] is not None
            else torch.zeros((cfg.hidden_size,), device=self.device)
            for h in hit_rows])
        return last, cache, h_suf + h_pref

    def _prefill_rows(self, enc: list[list[int]], S: int):
        """Prefill all unique prompts: (last_logits (P,V), cache (L,P,S,..),
        h_sum (P,H)). Hit rows and miss rows each prefill as one batched
        call; results are reassembled into prompt order."""
        P = len(enc)
        store = self.prefix_cache
        hits = [None] * P
        if store is not None:
            for i, toks in enumerate(enc):
                hits[i] = store.longest_prefix(toks, max_use=len(toks) - 1,
                                               allow_partial=not self.collect_h0)
        miss_idx = [i for i in range(P) if hits[i] is None]
        hit_idx = [i for i in range(P) if hits[i] is not None]

        parts = []  # (row indices, last, (ck, cv), h_sum)
        if miss_idx:
            parts.append((miss_idx,) + tuple(
                self._prefill_full_batch([enc[i] for i in miss_idx], S)))
        if hit_idx:
            parts.append((hit_idx,) + tuple(
                self._prefill_hit_batch([enc[i] for i in hit_idx],
                                        [hits[i] for i in hit_idx], S)))
        if len(parts) == 1 and parts[0][0] == list(range(P)):
            _, last, cache, h_sum = parts[0]
        else:
            order = [i for part in parts for i in part[0]]
            inv = self._t(np.argsort(np.asarray(order)))
            last = torch.cat([p[1] for p in parts])[inv]
            cache = (torch.cat([p[2][0] for p in parts], dim=1)[:, inv],
                     torch.cat([p[2][1] for p in parts], dim=1)[:, inv])
            h_sum = torch.cat([p[3] for p in parts])[inv]

        if store is not None:
            for i, toks in enumerate(enc):
                if len(toks) >= store.min_reuse:
                    pad_len = min(_round_up(len(toks), store.pad_to), S)
                    # copies: the store must not alias the batch cache
                    store.put(toks, (cache[0][:, i, :pad_len].clone(memory_format=torch.contiguous_format),
                                     cache[1][:, i, :pad_len].clone(memory_format=torch.contiguous_format)),
                              h_sum=(h_sum[i].clone() if self.collect_h0 else None))
        return last, cache, h_sum

    def _generate_chunk(self, prompts: list[str], sp: SamplingParams, n: int,
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
        Lp = _round_up(min(self.max_model_len, max_len), self.pad_multiple)
        S = _round_up(Lp + max_new, self.pad_multiple)
        spec = self.spec_decode is not None
        if spec:
            # an iteration writes K+1 columns and emits at least one token: the
            # decode region holds the budget at (K+1)x, + the reserved h0 column
            budget0 = min(max_new, S - Lp)
            S = _round_up(Lp + budget0 * (self.spec_k + 1) + 1, self.pad_multiple)

        t0 = time.perf_counter()
        last_logits, (ck, cv), h_prompt = self._prefill_rows(enc, S)
        self._sync()
        self.last_timings["prefill_s"] += time.perf_counter() - t0

        # fan out to B = P*n rows; bucket-padding rows copy prompt 0
        Bb = _round_up(P * n, self.batch_bucket)
        row_of = np.concatenate([np.repeat(np.arange(P), n),
                                 np.zeros(Bb - P * n, np.int64)])
        row_of_t = self._t(row_of)
        last_logits = last_logits[row_of_t]
        h_prompt_rows = h_prompt[row_of_t].cpu().numpy() if self.collect_h0 else None
        B = Bb
        lens = np.asarray([len(enc[r]) for r in row_of], np.int64)
        finished = torch.zeros((B,), dtype=torch.bool, device=dev)
        finished[P * n:] = True

        rp_val = float(getattr(sp, "repetition_penalty", 1.0) or 1.0)
        # the spec loop threads presence through its acceptance chain
        use_presence = rp_val != 1.0 or spec
        presence = None
        if use_presence:
            pres = np.zeros((B, self.cfg.vocab_size), np.int8)
            for r in range(P * n):
                pres[r, np.asarray(enc[row_of[r]], np.int64)] = 1
            presence = self._t(pres)

        def vec(name, default):
            v = getattr(sp, name, None)
            return torch.full((B,), float(default if v is None else v), device=dev)

        temperature = vec("temperature", 1.0)
        # disabled stages are passed as None so they are skipped entirely
        tp_val = float(getattr(sp, "top_p", 1.0) or 1.0)
        top_p = None if tp_val >= 1.0 else vec("top_p", 1.0)
        mp_val = float(getattr(sp, "min_p", 0.0) or 0.0)
        min_p = None if mp_val <= 0.0 else vec("min_p", 0.0)
        rep_pen = vec("repetition_penalty", 1.0)
        tk = getattr(sp, "top_k", -1)
        tk = int(-1 if tk is None else tk)
        top_k = None if tk <= 0 else torch.full((B,), tk, dtype=torch.int64, device=dev)
        static_top_k = 0 if tk <= 0 else min(self.cfg.vocab_size, max(64, tk))

        self._call_counter += 1
        seed = sp.seed if getattr(sp, "seed", None) is not None else self._call_counter
        generator = torch.Generator(device=dev).manual_seed(int(seed))

        # every row finishes within `budget` steps, so the loop runs at most
        # that many (the JAX loop's emit buffer is rounded up to a compile
        # bucket; an eager loop needs no bucket). The spec loop keeps JAX's
        # bucket: it also stops after that many iterations.
        budget = (min(max_new, (S - Lp - 1) // (self.spec_k + 1)) if spec
                  else min(max_new, S - Lp))
        h_gen = None
        if budget > 0:
            t0 = time.perf_counter()
            lens_t = self._t(lens)
            # the windowed-short install, where it saves (long prompts); the
            # spec loop keeps full-S panels (its windows go by position)
            win_pad, win_cache = 0, None
            if self._win_split is not None and not spec:
                Wpad = _round_up(self._win_split[2], min(self.pad_multiple, 128))
                if Wpad + (S - Lp) + min(self.pad_multiple, 128) <= S:
                    win_pad = Wpad
            # fan-out gather, then the transpose to the decode layout
            # (L, B, nkv, S, dh)
            ck, cv = ck[:, row_of_t], cv[:, row_of_t]
            if win_pad:
                ck, cv, win_cache = self._install_win(ck, cv, lens_t, Lp, win_pad + (S - Lp),
                                                      win_pad)
            else:
                ck = ck.permute(0, 1, 3, 2, 4).contiguous()
                cv = cv.permute(0, 1, 3, 2, 4).contiguous()
            cache_scale = None
            if self.kv_quant == "int8":
                ck, cv, cache_scale = self._quantize_cache(ck, cv)
                if win_cache is not None:
                    wk, wv, (wks, wvs) = self._quantize_cache(win_cache["k"], win_cache["v"])
                    win_cache.update(k=wk, v=wv, ks=wks, vs=wvs)
            row_budget = torch.full((B,), budget, dtype=torch.int64, device=dev)
            if spec:
                T = _round_up(budget, self.decode_chunk)
                # the token history the drafts are looked up in: prompt, then
                # every emitted token
                seq = np.zeros((B, Lp + T), np.int64)
                for r in range(P * n):
                    seq[r, :lens[r]] = enc[row_of[r]]
                toks_d, lps_d, finished, hs, steps, act, em = self._decode_spec_impl(
                    ck, cv, presence, last_logits, lens_t, self._t(seq), lens_t, Lp, finished,
                    row_budget, generator, temperature, top_k, top_p, min_p, rep_pen, T=T,
                    K=self.spec_k, M=self.spec_ngram, static_top_k=static_top_k,
                    cache_scale=cache_scale)
                self._add_spec_stats(int(em[:P * n].sum()), steps, act)
            else:
                toks_d, lps_d, finished, hs, steps, *_ = self._decode_impl(
                    ck, cv, presence, last_logits, self._t(lens.astype(np.int32)),
                    torch.full((B,), Lp, dtype=torch.int32, device=dev),
                    lens_t, Lp, finished, row_budget, generator,
                    temperature, top_k, top_p, min_p, rep_pen, T=budget,
                    static_top_k=static_top_k, use_presence=use_presence,
                    cache_scale=cache_scale, win_cache=win_cache, win_pad=win_pad)
            toks = toks_d[:, :budget].cpu().numpy()
            lps = lps_d[:, :budget].cpu().numpy()
            if self.collect_h0:
                h_gen = hs.cpu().numpy()
            self.last_timings["decode_s"] += time.perf_counter() - t0
            self.last_timings["decode_steps"] += steps
        else:
            toks = np.zeros((B, 0), np.int64)
            lps = np.zeros((B, 0), np.float32)
            if self.collect_h0:
                h_gen = np.zeros((B, self.cfg.hidden_size), np.float32)

        eos_set = set(self.eos_token_ids)
        results = []
        for p in range(P):
            outs = []
            for j in range(n):
                r = p * n + j
                ids_out: list[int] = []
                lps_out: list[float] = []
                for t in range(toks.shape[1]):
                    tok_id = int(toks[r, t])
                    ids_out.append(tok_id)
                    lps_out.append(float(lps[r, t]))
                    if tok_id in eos_set:
                        break
                finish = "stop" if (ids_out and ids_out[-1] in eos_set) else "length"
                text = tok.decode(ids_out, skip_special_tokens=True) if hasattr(tok, "decode") else None
                co = CompletionOutput(
                    token_ids=ids_out,
                    cumulative_logprob=float(np.sum(lps_out)),
                    token_logprobs=lps_out,
                    text=text,
                    finish_reason=finish,
                )
                if self.collect_h0:
                    # pooled final-hidden mean over prompt + emitted tokens
                    n_tok = len(enc[p]) + len(ids_out)
                    co.pooled_hidden = (h_prompt_rows[r] + h_gen[r]) / max(1, n_tok)
                outs.append(co)
            results.append(RequestOutput(outputs=outs, prompt=prompts[p],
                                         prompt_token_ids=list(enc[p])))
        return results
