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

Not ported yet (they raise ``ValueError("... not yet ported")``):
``seq_mesh``, ``spec_decode``, ``auto_continuous``; sliding-window
checkpoints of families other than gpt_oss are refused by
``Qwen2Config.from_hf``.
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
        auto_continuous: bool = False,
    ):
        for name, val in (("seq_mesh", seq_mesh), ("spec_decode", spec_decode),
                          ("auto_continuous", auto_continuous)):
            if val:
                raise ValueError(f"{name}: not yet ported")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unsupported kv_quant={kv_quant!r}")
        self.kv_quant = kv_quant
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
                     win_cache=None, win_pad: int = 0):
        """Generate up to T tokens for all B rows over the slot-uniform cache
        (L, B, nkv, S, dh), int8 with ``cache_scale`` = (ks, vs), the
        windowed layers in ``win_cache`` when it is given. A row finishes on
        EOS or when it has emitted ``row_budget`` tokens; finished rows emit
        token 0 with logprob 0.
        Returns (tokens (B,T), logprobs (B,T), finished, h_sum (B,H), steps)."""
        dev = self.device
        B = last_logits.shape[0]
        eos = self._t(self.eos_token_ids or [-1])
        toks = torch.zeros((B, T), dtype=torch.int64, device=dev)
        lps = torch.zeros((B, T), dtype=torch.float32, device=dev)
        emitted = torch.zeros((B,), dtype=torch.int64, device=dev)
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
                self.params, self.cfg, tok, positions, cache_k, cache_v, slot,
                lens, dstart, return_hidden=self.collect_h0, ragged=True,
                cache_scale=cache_scale, win_cache=win_cache, win_pad=win_pad)
            if self.collect_h0:
                # the token sampled this step is forwarded this step; pool it
                # iff it was emitted (live on entry — includes the EOS)
                h_sum += hidden.float() * live[:, None]
            finished = finished | is_eos | (emitted >= row_budget)
            positions = positions + 1
            slot += 1
        return toks, lps, finished, h_sum, steps

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
        results: list[RequestOutput | None] = [None] * len(prompts)
        self.last_timings = {"prefill_s": 0.0, "decode_s": 0.0, "decode_steps": 0}
        with torch.inference_mode():
            for lo in range(0, len(prompts), group):
                for i, ro in enumerate(self._generate_chunk(prompts[lo:lo + group], sp, n)):
                    results[lo + i] = ro
        return results

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

    def _generate_chunk(self, prompts: list[str], sp: SamplingParams, n: int):
        tok = self.tokenizer
        dev = self.device
        enc = [tok(p, add_special_tokens=True)["input_ids"] for p in prompts]
        max_prompt = self.max_model_len - 1
        enc = [list(ids)[-max_prompt:] for ids in enc]
        P = len(enc)
        max_len = max(len(e) for e in enc)
        max_new = int(getattr(sp, "max_tokens", 256) or 256)
        Lp = _round_up(min(self.max_model_len, max_len), self.pad_multiple)
        S = _round_up(Lp + max_new, self.pad_multiple)

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
        use_presence = rp_val != 1.0
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
        # bucket; an eager loop needs no bucket)
        budget = min(max_new, S - Lp)
        h_gen = None
        if budget > 0:
            t0 = time.perf_counter()
            lens_t = self._t(lens)
            # the windowed-short install, where it saves (long prompts)
            win_pad, win_cache = 0, None
            if self._win_split is not None:
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
            toks_d, lps_d, finished, hs, steps = self._decode_impl(
                ck, cv, presence, last_logits, self._t(lens.astype(np.int32)),
                torch.full((B,), Lp, dtype=torch.int32, device=dev),
                lens_t, Lp, finished,
                torch.full((B,), budget, dtype=torch.int64, device=dev), generator,
                temperature, top_k, top_p, min_p, rep_pen, T=budget,
                static_top_k=static_top_k, use_presence=use_presence,
                cache_scale=cache_scale, win_cache=win_cache, win_pad=win_pad)
            toks = toks_d.cpu().numpy()
            lps = lps_d.cpu().numpy()
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
