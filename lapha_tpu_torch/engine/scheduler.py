"""Continuous-batching scheduler over the port's :class:`~.engine.Engine` —
the autoregressive and block-diffusion paths of
``lapha_tpu/engine/scheduler.py``.

A scheduler thread owns a persistent decode batch over the engine's
slot-uniform KV cache (decode layout (L, B, nkv, S, dh); int8 with (L, B,
nkv, S) f32 scales under ``kv_quant="int8"``):

- requests enter a queue (``submit`` returns a Future); between decode
  chunks the scheduler admits queued requests into FREE ROWS of the running
  batch, so a request submitted while another decodes starts at the next
  chunk boundary and finishes on its own schedule;
- row occupancy is kept by the compiled ``SlotAllocator`` when the native
  extension is importable, else by ``PySlotAllocator`` (``..native``);
- column space: all rows share one decode column cursor ``col``, the column
  every row writes each step. A request is admitted when a row is free and
  its token budget fits the columns left; its row reads [0, len) of its
  prompt and [col at admission, slot] of its decode. When the batch drains
  the cursor goes back to the prompt-slab boundary. When columns (not rows)
  block an admission the scheduler COMPACTS: each live row's decode columns
  fold into its prefix with one gather over the cache (K/V carry their RoPE,
  and slot == position holds again for the prefix, which a windowed layer's
  clipped ranges rely on), the cursor drops to max(slab, the longest row),
  and admission retries;
- sampling is per row (temperature, top_p, top_k, min_p, repetition
  penalty); admissions go through ``Engine._prefill_rows`` (hit and miss
  rows each one batched call), so the engine's prefix store serves them.

Each chunk is ``Engine._decode_impl`` with the rows' running ``emitted``
counts, read back once a chunk. A row is live for a prefix of the chunk
and emits a token on each live step, so the steps in which any row was
live (where JAX's ``while_loop`` leaves) are the largest per-row count of
new tokens; ``col``, every row's position and ``steps_executed`` advance
by that. Steps the loop runs after every row finished write only finished
rows' columns, and such a chunk drains the batch, which sends ``col`` back
to the slab. Every decode
step runs the ragged decode kernel over all B rows (a free row's writes
land in its own row, which an admission overwrites whole). Deliberate
deviations from JAX: the TPU policy that picks a dense decode for int8
caches and some shapes (``self.ragged``) is a TPU speed choice, so every
cache here goes through the ragged kernel; requests whose admission fails
before they hold rows are failed too (JAX leaves their futures pending); a
sampling stage no live row uses is skipped, as the sync path skips it; a
stream event's "sample" is the sample's index within its request (JAX
counts across the admission group).

Over a :class:`~.diffusion.DiffusionEngine` (``decode_kind == "diffusion"``)
a chunk is one committed block (``DiffusionEngine._diff_chunk_impl``):
``chunk`` is the block length, every chunk boundary is a commit boundary,
so admission and compaction need nothing new. The persistent cache keeps
the prefill layout (L, B, S, nkv, dh), which the block-causal forward
reads, with no presence and no last logits; a request reserves its budget
rounded up to whole blocks, and the host trims a row's last block to its
budget. The chunk reads one flag back per denoise forward (its eager loop).
Not ported: the sequence-mesh branch (ROADMAP A11).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import traceback
from concurrent.futures import Future
from typing import Sequence

import numpy as np
import torch

from ..models import qwen2
from ..native import make_slot_allocator
from .adapter import CompletionOutput, RequestOutput, SamplingParams
from .engine import Engine, _round_up


class _Request:
    __slots__ = ("prompt", "enc", "sp", "n", "future", "rows", "outputs", "stream")

    def __init__(self, prompt, enc, sp, n, future, stream=None):
        self.prompt = prompt
        self.enc = enc
        self.sp = sp
        self.n = n
        self.future = future
        self.rows: list[int] = []
        self.outputs: dict[int, CompletionOutput] = {}
        # (queue.Queue, tag) — incremental token events (see submit)
        self.stream = stream


class _Row:
    __slots__ = ("req", "sample_idx", "toks", "lps", "h_gen", "em", "sent", "eos_done")

    def __init__(self, req, sample_idx):
        self.req = req
        self.sample_idx = sample_idx
        self.toks: list[int] = []
        self.lps: list[float] = []
        self.h_gen = None
        self.em = 0
        self.sent = 0          # tokens already pushed to the stream queue
        self.eos_done = False  # stream hit EOS; suppress later deltas


class ContinuousEngine:
    """Cross-request continuous batching on top of an :class:`Engine`.

    ``prompt_slab`` bounds admitted prompt lengths; decode columns live in
    [prompt_slab, S), S = ``engine.max_model_len`` rounded up to
    ``pad_multiple``. Budgets are capped to the decode region. The device
    work runs on the scheduler's own thread, under ``torch.inference_mode``
    on the engine's device; ``step_lock`` is held across each admission and
    chunk (a weight swap taken under it lands between chunks).
    """

    def __init__(self, engine: Engine, *, prompt_slab: int | None = None,
                 chunk: int | None = None):
        self.engine = engine
        self.B = engine.max_batch
        self.S = _round_up(engine.max_model_len, engine.pad_multiple)
        self.slab = int(prompt_slab or (self.S // 2))
        if not 0 < self.slab < self.S:
            raise ValueError(f"prompt_slab {self.slab} must lie in (0, {self.S})")
        self.chunk = int(chunk or engine.decode_chunk)
        # a DiffusionEngine: the batch advances one committed block a chunk
        self.diffusion = getattr(engine, "decode_kind", "ar") == "diffusion"
        if self.diffusion:
            self.chunk = int(engine.block_length)
        self.slots = make_slot_allocator(self.B)
        self.kv_quant = engine.kv_quant

        self._queue: list[_Request] = []
        self._cv = threading.Condition()
        self.step_lock = threading.Lock()
        self._running = False
        self._thread: threading.Thread | None = None
        self._rows: dict[int, _Row] = {}  # row index -> bookkeeping
        self._seed_counter = 0
        self._state = None  # device state, created lazily
        self.steps_executed = 0
        self.waves = 0
        self.compactions = 0

    # ------------------------------------------------------------- lifecycle

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ContinuousEngine")
        self._thread.start()

    def stop(self):
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None

    # ------------------------------------------------------------- public API

    def submit(self, prompt: str, sampling_params: SamplingParams,
               stream=None, enc=None) -> Future:
        """Queue one prompt; the Future resolves to a RequestOutput with n
        samples. Raises at once if the request cannot ever fit.

        ``enc``: the prompt's token ids when the caller has them already
        (``Engine``'s auto_continuous routing), so it is not tokenized twice.

        ``stream``: optional (queue.Queue, tag) pair. Token events are
        pushed as they decode (chunk granularity), each carrying the tag:
          {"type": "delta",  "tag", "sample", "token_ids", "logprobs"}
          {"type": "finish", "tag", "sample", token_ids/logprobs/text/
                             finish_reason}  — authoritative per sample
          {"type": "request_done", "tag"}    — all n samples finished
          {"type": "error",  "tag", "error"} — scheduler failure
        Deltas are EOS-trimmed; the finish event repeats the full sample.
        """
        eng = self.engine
        if enc is None:
            enc = list(eng.tokenizer(prompt, add_special_tokens=True)["input_ids"])
        enc = list(enc)[-(self.slab):]
        n = max(1, int(getattr(sampling_params, "n", 1)))
        if n > self.B:
            raise ValueError(f"n={n} exceeds max_batch={self.B}")
        fut: Future = Future()
        req = _Request(prompt, enc, sampling_params, n, fut, stream=stream)
        with self._cv:
            if not self._running:
                raise RuntimeError("ContinuousEngine not started")
            self._queue.append(req)
            self._cv.notify_all()
        return fut

    def generate(self, prompts: Sequence[str], sampling_params: SamplingParams,
                 use_tqdm: bool = False) -> list[RequestOutput]:
        """Drop-in synchronous API: submit all, wait for all."""
        futs = [self.submit(p, sampling_params) for p in prompts]
        return [f.result() for f in futs]

    # ------------------------------------------------------------- internals

    def _init_state(self):
        eng = self.engine
        cfg = eng.cfg
        dev = eng.device
        B, S = self.B, self.S
        kv_dtype = torch.int8 if self.kv_quant == "int8" else cfg.dtype
        L, nkv, dh = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_
        # decode layout for decode_step; diffusion keeps the prefill layout
        # that forward(block_bidir=True) reads
        kshape = (L, B, S, nkv, dh) if self.diffusion else (L, B, nkv, S, dh)
        self._state = dict(
            ck=torch.zeros(kshape, dtype=kv_dtype, device=dev),
            cv=torch.zeros(kshape, dtype=kv_dtype, device=dev),
            scale=(tuple(torch.full((L, B, nkv, S), 1e-12, dtype=torch.float32, device=dev)
                         for _ in range(2))
                   if self.kv_quant == "int8" else None),
            presence=torch.zeros((B, cfg.vocab_size), dtype=torch.int8, device=dev),
            last_logits=torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev),
            lens=np.zeros((B,), np.int32),
            dstart=np.full((B,), self.slab, np.int32),
            pos=np.zeros((B,), np.int32),
            fin=np.ones((B,), bool),
            budget=np.zeros((B,), np.int32),
            emitted=np.zeros((B,), np.int32),
            temp=np.full((B,), 1.0, np.float32),
            top_p=np.full((B,), 1.0, np.float32),
            min_p=np.zeros((B,), np.float32),
            rep_pen=np.full((B,), 1.0, np.float32),
            top_k=np.full((B,), -1, np.int32),
            thr=np.full((B,), getattr(eng, "dynamic_threshold", 0.9), np.float32),
            col=self.slab,
        )
        if self.diffusion:
            # AR decode state: the diffusion chunk samples from its block
            # forward and has no repetition penalty
            self._state["presence"] = self._state["last_logits"] = None

    def _budget(self, sp) -> int:
        """The tokens a request may emit: its max_tokens, capped to the
        decode region."""
        return min(int(getattr(sp, "max_tokens", 256) or 256), self.S - self.slab)

    def _budget_cols(self, sp) -> int:
        """Decode columns a request may consume: its budget, rounded up to
        whole blocks under diffusion (columns grow a block at a time)."""
        b = self._budget(sp)
        if self.diffusion:
            Tb = self.chunk
            b = -(-b // Tb) * Tb
        return b

    def _admissible(self, req: _Request) -> bool:
        return self._admissible_with(req, [])

    def _admissible_with(self, req: _Request, pending: list[_Request]) -> bool:
        taken = sum(p.n for p in pending)
        if self.slots.available() - taken < req.n:
            return False
        return self._state["col"] + self._budget_cols(req.sp) <= self.S

    def _admit(self, reqs: list[_Request]):
        """Prefill the new requests (one batched call, prefix-store aware)
        and install their rows into the persistent batch state."""
        eng = self.engine
        st = self._state
        last, (ck_g, cv_g), h_sum = eng._prefill_rows([r.enc for r in reqs], self.S)
        h_np = h_sum.float().cpu().numpy() if eng.collect_h0 else None

        rows_all, group_of = [], []
        for gi, req in enumerate(reqs):
            rows = self.slots.acquire(req.n)
            assert rows is not None, "admission checked availability"
            req.rows = [int(r) for r in rows]
            for j, r in enumerate(req.rows):
                # the sample's index within its request (JAX numbers it
                # across the admission group, which its stream events show)
                self._rows[r] = _Row(req, j)
                rows_all.append(r)
                group_of.append(gi)

        # device-side row installs: KV copy + last logits + presence
        rows_t = eng._t(np.asarray(rows_all, np.int64))
        group_t = eng._t(np.asarray(group_of, np.int64))
        if self.diffusion:  # the same layout on both sides: one row scatter
            st["ck"][:, rows_t] = ck_g[:, group_t]
            st["cv"][:, rows_t] = cv_g[:, group_t]
        elif self.kv_quant == "int8":
            st["ck"], st["cv"], st["scale"] = _install_rows_q(
                st["ck"], st["cv"], st["scale"], ck_g, cv_g, group_t, rows_t)
        else:
            st["ck"], st["cv"] = _install_rows(st["ck"], st["cv"], ck_g, cv_g, group_t, rows_t)
        if not self.diffusion:
            st["last_logits"][rows_t] = last.float()[group_t]
            pres_rows = np.zeros((len(rows_all), eng.cfg.vocab_size), np.int8)
            for i, gi in enumerate(group_of):
                pres_rows[i, np.asarray(reqs[gi].enc, np.int64)] = 1
            st["presence"][rows_t] = eng._t(pres_rows)

        for r, gi in zip(rows_all, group_of):
            req = reqs[gi]
            sp = req.sp
            L = len(req.enc)
            st["lens"][r] = L
            st["dstart"][r] = st["col"]
            st["pos"][r] = L
            st["fin"][r] = False
            st["budget"][r] = self._budget(sp)
            st["emitted"][r] = 0
            st["temp"][r] = float(getattr(sp, "temperature", 1.0) or 0.0)
            st["top_p"][r] = float(getattr(sp, "top_p", 1.0) or 1.0)
            st["min_p"][r] = float(getattr(sp, "min_p", 0.0) or 0.0)
            st["rep_pen"][r] = float(getattr(sp, "repetition_penalty", 1.0) or 1.0)
            tk = getattr(sp, "top_k", -1)
            st["top_k"][r] = int(-1 if tk is None else tk)
            thr = getattr(sp, "dynamic_threshold", None)
            st["thr"][r] = float(getattr(eng, "dynamic_threshold", 0.9) if thr is None else thr)
            if eng.collect_h0:
                self._rows[r].h_gen = h_np[gi].astype(np.float32).copy()

    def _sampling_plan(self):
        """The chunk's generator and which sampling stages it runs: a stage
        no live row uses is skipped (the sync path's rule); the static top-k
        candidate bound holds only if every live row has a finite top-k.
        Returns (generator, static_top_k, use_presence, use_top_k,
        use_top_p, use_min_p)."""
        eng = self.engine
        st = self._state
        self._seed_counter += 1
        gen = torch.Generator(device=eng.device).manual_seed(
            self._seed_counter * 2654435761 % (2**32))
        live = ~st["fin"]
        tks = st["top_k"][live] if live.any() else st["top_k"]
        static_top_k = 0 if (tks <= 0).any() else min(
            eng.cfg.vocab_size, max(64, int(tks.max())))
        act = live if live.any() else np.ones_like(live)
        return (gen, static_top_k, bool((st["rep_pen"][act] != 1.0).any()),
                bool((st["top_k"][act] > 0).any()), bool((st["top_p"][act] < 1.0).any()),
                bool((st["min_p"][act] > 0.0).any()))

    def _diffusion_chunk(self):
        """Advance the persistent batch by one committed block
        (``DiffusionEngine._diff_chunk_impl``): live rows gain Tb tokens each,
        the host trims a row's last block to its budget."""
        eng = self.engine
        st = self._state
        dev = eng.device
        gen, static_top_k, _, use_top_k, use_top_p, use_min_p = self._sampling_plan()
        em_before = st["emitted"].copy()
        Tb = self.chunk

        def t(a, dtype):
            return torch.as_tensor(a, device=dev).to(dtype)

        toks_d, lps_d, fin_d, em_d, nfwd = eng._diff_chunk_impl(
            st["ck"], st["cv"], t(st["lens"], torch.int64), t(st["dstart"], torch.int64),
            t(st["fin"], torch.bool), t(st["emitted"], torch.int64), t(st["budget"], torch.int64),
            int(st["col"]), gen, t(st["temp"], torch.float32),
            t(st["top_k"], torch.int64) if use_top_k else None,
            t(st["top_p"], torch.float32) if use_top_p else None,
            t(st["min_p"], torch.float32) if use_min_p else None,
            t(st["thr"], torch.float32), Tb=Tb, steps=eng.denoising_steps,
            strategy=eng.remasking_strategy, static_top_k=static_top_k if use_top_k else 0)
        toks = toks_d.cpu().numpy()
        lps = lps_d.cpu().numpy()
        st["fin"] = fin_d.cpu().numpy().copy()
        st["emitted"] = em_d.cpu().numpy().astype(np.int32)
        st["col"] += Tb
        self.steps_executed += nfwd

        eos_set = set(eng.eos_token_ids)
        done_rows = []
        for r, row in self._rows.items():
            if st["emitted"][r] > em_before[r]:
                # the whole block is this row's; the budget may trim it
                take = min(Tb, int(st["budget"][r]) - len(row.toks))
                row.toks.extend(int(x) for x in toks[r, :take])
                row.lps.extend(float(x) for x in lps[r, :take])
                row.em = len(row.toks)
                self._push_delta(row, eos_set)
            if st["fin"][r]:
                done_rows.append(r)
        for r in done_rows:
            self._finish_row(r)

        if not self._rows:
            st["col"] = self.slab
            st["fin"][:] = True
            self.waves += 1

    def _decode_chunk(self):
        eng = self.engine
        st = self._state
        if not self._rows:
            return
        if self.diffusion:
            return self._diffusion_chunk()
        dev = eng.device
        gen, static_top_k, use_presence, use_top_k, use_top_p, use_min_p = self._sampling_plan()
        em_before = st["emitted"].copy()

        def t(a, dtype):
            return torch.as_tensor(a, device=dev).to(dtype)

        out = eng._decode_impl(
            st["ck"], st["cv"], st["presence"] if use_presence else None, st["last_logits"],
            t(st["lens"], torch.int32), t(st["dstart"], torch.int32), t(st["pos"], torch.int64),
            int(st["col"]), t(st["fin"], torch.bool), t(st["budget"], torch.int64), gen,
            t(st["temp"], torch.float32), t(st["top_k"], torch.int64) if use_top_k else None,
            t(st["top_p"], torch.float32) if use_top_p else None,
            t(st["min_p"], torch.float32) if use_min_p else None,
            t(st["rep_pen"], torch.float32), T=self.chunk,
            static_top_k=static_top_k if use_top_k else 0, use_presence=use_presence,
            cache_scale=st["scale"], emitted=t(st["emitted"], torch.int64))
        toks_d, lps_d, fin_d, hs_d, _, st["last_logits"], _, _, em_d = out

        toks = toks_d.cpu().numpy()
        lps = lps_d.cpu().numpy()
        st["fin"] = fin_d.cpu().numpy().copy()
        st["emitted"] = em_d.cpu().numpy().astype(np.int32)
        steps = int((st["emitted"] - em_before).max())  # the steps a row was live
        st["pos"] = st["pos"] + np.int32(steps)  # every row's position moves each step
        st["col"] += steps
        self.steps_executed += steps
        hs = hs_d.float().cpu().numpy() if eng.collect_h0 else None

        eos_set = set(eng.eos_token_ids)
        done_rows = []
        for r, row in self._rows.items():
            d = int(st["emitted"][r] - em_before[r])
            if d > 0:
                row.toks.extend(int(x) for x in toks[r, :d])
                row.lps.extend(float(x) for x in lps[r, :d])
                row.em = int(st["emitted"][r])
                if hs is not None:
                    row.h_gen = row.h_gen + hs[r]
                self._push_delta(row, eos_set)
            if st["fin"][r]:
                done_rows.append(r)
        for r in done_rows:
            self._finish_row(r)

        if not self._rows:
            # wave drained: reset the column cursor
            st["col"] = self.slab
            st["fin"][:] = True
            self.waves += 1

    def _push_delta(self, row: _Row, eos_set: set):
        """EOS-trimmed incremental token event for a streaming request."""
        req = row.req
        seg = list(zip(row.toks[row.sent:], row.lps[row.sent:]))
        row.sent = len(row.toks)
        if req.stream is None or row.eos_done or not seg:
            return
        out_t, out_l = [], []
        for tk, lp in seg:
            out_t.append(tk)
            out_l.append(lp)
            if tk in eos_set:
                row.eos_done = True
                break
        q, tag = req.stream
        q.put({"type": "delta", "tag": tag, "sample": row.sample_idx,
               "token_ids": out_t, "logprobs": out_l})

    def _finish_row(self, r: int):
        eng = self.engine
        row = self._rows.pop(r)
        req = row.req
        eos_set = set(eng.eos_token_ids)
        ids_out, lps_out = [], []
        for tk, lp in zip(row.toks, row.lps):
            ids_out.append(tk)
            lps_out.append(lp)
            if tk in eos_set:
                break
        finish = "stop" if (ids_out and ids_out[-1] in eos_set) else "length"
        text = (eng.tokenizer.decode(ids_out, skip_special_tokens=True)
                if hasattr(eng.tokenizer, "decode") else None)
        co = CompletionOutput(token_ids=ids_out,
                              cumulative_logprob=float(np.sum(lps_out) if lps_out else 0.0),
                              token_logprobs=lps_out, text=text, finish_reason=finish)
        if eng.collect_h0 and row.h_gen is not None:
            n_tok = len(req.enc) + len(ids_out)
            co.pooled_hidden = row.h_gen / max(1, n_tok)
        req.outputs[row.sample_idx] = co
        self.slots.release([r])
        if req.stream is not None:
            q, tag = req.stream
            q.put({"type": "finish", "tag": tag, "sample": row.sample_idx,
                   "token_ids": ids_out, "logprobs": lps_out, "text": text,
                   "finish_reason": finish})
        if len(req.outputs) == req.n:
            outs = [req.outputs[i] for i in sorted(req.outputs)]
            if req.stream is not None:
                q, tag = req.stream
                q.put({"type": "request_done", "tag": tag})
            req.future.set_result(RequestOutput(
                outputs=outs, prompt=req.prompt, prompt_token_ids=list(req.enc)))

    def _compact(self) -> bool:
        """Reclaim decode columns: fold each live row's decode columns
        [dstart_r, col) into its prefix ([0, len_r + n_r)) with one per-row
        gather over the cache, then set the column cursor to max(slab,
        max(len_r + n_r)). Returns True if columns were freed."""
        st = self._state
        if not self._rows:
            return False
        col = st["col"]
        new_lens = {}
        hi = self.slab
        for r in self._rows:
            n_r = col - int(st["dstart"][r])
            new_lens[r] = int(st["lens"][r]) + n_r
            hi = max(hi, new_lens[r])
        if hi >= col:
            return False  # nothing to gain
        idx = np.tile(np.arange(self.S, dtype=np.int64), (self.B, 1))
        for r in self._rows:
            L0 = int(st["lens"][r])
            d0 = int(st["dstart"][r])
            n_r = col - d0
            if n_r > 0:
                idx[r, L0:L0 + n_r] = np.arange(d0, col, dtype=np.int64)
        idx_t = self.engine._t(idx)
        gather = _gather_columns_pf if self.diffusion else _gather_columns
        st["ck"], st["cv"] = gather(st["ck"], st["cv"], idx_t)
        if st["scale"] is not None:
            st["scale"] = _gather_scale_columns(st["scale"], idx_t)
        for r in self._rows:
            st["lens"][r] = new_lens[r]
            st["dstart"][r] = hi
        st["col"] = hi
        self.compactions += 1
        return True

    def _pick_admissible(self):
        admit, rest = [], []
        for req in self._queue:
            if not admit and self._admissible(req):
                # one admission group per boundary: every admissible request
                admit.append(req)
            elif admit and self._admissible_with(req, admit):
                admit.append(req)
            else:
                rest.append(req)
        return admit, rest

    def _loop(self):
        dev = self.engine.device
        with torch.inference_mode(), (torch.cuda.device(dev) if dev.type == "cuda"
                                      else contextlib.nullcontext()):
            while True:
                with self._cv:
                    while self._running and not self._queue and not self._rows:
                        self._cv.wait(timeout=0.5)
                    if not self._running:
                        err = RuntimeError("engine stopped")
                        for req in self._queue:
                            _fail_request(req, err)
                        self._queue.clear()
                        for row in self._rows.values():
                            _fail_request(row.req, err)
                        self._rows.clear()
                        return
                admit = []
                try:
                    with self.step_lock:
                        if self._state is None:
                            self._init_state()
                        with self._cv:
                            admit, self._queue = self._pick_admissible()
                            if (not admit and self._queue and self._rows
                                    and self.slots.available() > 0 and self._compact()):
                                # columns (not rows) blocked the queue: compacted, retry
                                admit, self._queue = self._pick_admissible()
                        if admit:
                            self._admit(admit)
                        self._decode_chunk()
                except Exception as e:  # resolve futures instead of dying silently
                    traceback.print_exc(file=sys.stderr)
                    failed = admit + [row.req for row in self._rows.values()]
                    if self._state is None:  # the set-up failed: the queue would wait forever
                        with self._cv:
                            failed += self._queue
                            self._queue = []
                    for req in failed:
                        _fail_request(req, e)
                    self._rows.clear()
                    self._state = None
                    self.slots = make_slot_allocator(self.B)


def _fail_request(req: _Request, err: Exception):
    """Resolve a request's future AND its stream (if any) with an error.
    Idempotent per request (a request may own several rows)."""
    if req.future.done():
        return
    req.future.set_exception(err)
    if req.stream is not None:
        q, tag = req.stream
        q.put({"type": "error", "tag": tag, "error": f"{type(err).__name__}: {err}"})


def _gather_columns(ck, cv, idx):
    """Per-row column relocation for compaction: idx (B, S) maps new slot j
    of row b to old slot idx[b, j]; applied to both decode-layout caches
    (L, B, nkv, S, dh)."""
    ix = idx[None, :, None, :, None]
    return (torch.gather(ck, 3, ix.expand(ck.shape)),
            torch.gather(cv, 3, ix.expand(cv.shape)))


def _gather_columns_pf(ck, cv, idx):
    """Compaction column relocation for the prefill-layout cache (L, B, S,
    nkv, dh) of the diffusion branch: columns on axis 2."""
    ix = idx[None, :, :, None, None]
    return (torch.gather(ck, 2, ix.expand(ck.shape)),
            torch.gather(cv, 2, ix.expand(cv.shape)))


def _install_rows(ck_big, cv_big, ck_g, cv_g, group_of, rows):
    """Copy admitted rows' prefilled KV (group cache, prefill layout
    (L, P, S, nkv, dh)) into the persistent batch cache (decode layout
    (L, B, nkv, S, dh)) at their allocated row indices, every column."""
    ck_big[:, rows] = ck_g.permute(0, 1, 3, 2, 4)[:, group_of].to(ck_big.dtype)
    cv_big[:, rows] = cv_g.permute(0, 1, 3, 2, 4)[:, group_of].to(cv_big.dtype)
    return ck_big, cv_big


def _install_rows_q(ck_big, cv_big, scale_big, ck_g, cv_g, group_of, rows):
    """int8-KV variant of :func:`_install_rows`: the prefill KV is quantized
    per vector on the way into the int8 cache (``qwen2._quantize_kv``), and
    the scale planes (L, B, nkv, S) are written alongside."""
    kq, ks = qwen2._quantize_kv(ck_g.permute(0, 1, 3, 2, 4)[:, group_of])
    vq, vs = qwen2._quantize_kv(cv_g.permute(0, 1, 3, 2, 4)[:, group_of])
    ck_big[:, rows] = kq
    cv_big[:, rows] = vq
    ks_big, vs_big = scale_big
    ks_big[:, rows] = ks
    vs_big[:, rows] = vs
    return ck_big, cv_big, (ks_big, vs_big)


def _gather_scale_columns(scale, idx):
    """Compaction column relocation for the int8-KV scale planes (L, B, nkv,
    S): the same per-row idx map as :func:`_gather_columns`."""
    ix = idx[None, :, None, :].expand(scale[0].shape)
    return tuple(torch.gather(s, 3, ix) for s in scale)
