"""Time the continuous-batching scheduler (``engine/scheduler.py``) on one
card, at Qwen2.5-1.5B's full width and depth (28 layers, random bf16
weights from seed 0), with a bf16 and an int8 KV cache.

    python3 -m lapha_tpu_torch.bench_serve

Two readings, each printed with the card's name and power limit:

- one scheduler chunk (16 rows of 256-token prompts, 16 steps, S 2048),
  host clock, with the chunk's state read back once (the scheduler's way)
  and with a device sync after every decode step (what a per-step read of
  "all finished" costs), in turns (once, per step, once, per step), five
  chunks a turn, the median of each;
- a burst of 12 requests like ``chip_smoke.py`` phase 21's (prompts of
  200-500 ids, n 1-4, 32-128 new tokens, greedy and sampled at 0.7 / top_p
  0.95 by turns) submitted at once to a started scheduler: tokens, wall s,
  tok/s and ms a step; each KV kind's burst before, then after, one
  ``torch.profiler`` session with CUDA activity in the same process.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
CHUNKS = 5


class _Ids:
    """Prompts are space-separated token ids."""

    eos_token_id = 1

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


def _chunks(eng, rng, per_step: bool) -> list[float]:
    """Host ms of CHUNKS scheduler chunks over 16 fresh rows."""
    from concurrent.futures import Future

    from lapha_tpu_torch.engine import ContinuousEngine, SamplingParams
    from lapha_tpu_torch.engine import scheduler as sched_mod

    step = eng._mod.decode_step

    def synced(*a, **kw):
        out = step(*a, **kw)
        torch.cuda.synchronize()
        return out

    ce = ContinuousEngine(eng)
    ce._init_state()
    sp = SamplingParams(temperature=0.7, top_p=0.95, max_tokens=200)
    V = eng.cfg.vocab_size
    ts = []
    eng._mod.decode_step = synced if per_step else step
    try:
        with torch.inference_mode():
            ce._admit([sched_mod._Request("", [int(t) for t in rng.integers(2, V, 256)], sp, 1,
                                          Future()) for _ in range(16)])
            ce._decode_chunk()  # warm
            torch.cuda.synchronize()
            for _ in range(CHUNKS):
                t0 = time.perf_counter()
                ce._decode_chunk()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
    finally:
        eng._mod.decode_step = step
    return ts


def _burst(eng, rng) -> tuple[int, float, int]:
    """12 requests submitted at once to a started scheduler: (tokens, wall
    s, steps)."""
    from lapha_tpu_torch.engine import ContinuousEngine, SamplingParams

    V = eng.cfg.vocab_size
    ce = ContinuousEngine(eng)
    ce.start()
    try:
        reqs = []
        for i in range(12):
            ids = [int(t) for t in rng.integers(2, V, int(rng.integers(200, 501)))]
            sp = SamplingParams(n=int(rng.integers(1, 5)), max_tokens=int(rng.integers(32, 129)),
                                temperature=0.0 if i % 2 == 0 else 0.7,
                                top_p=1.0 if i % 2 == 0 else 0.95)
            reqs.append((" ".join(map(str, ids)), sp, ids))
        t0 = time.perf_counter()
        futs = [ce.submit(p, sp, enc=ids) for p, sp, ids in reqs]
        outs = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        ce.stop()
    return sum(len(o.token_ids) for r in outs for o in r.outputs), wall, ce.steps_executed


def _profiled_chunk(eng, rng) -> None:
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        _chunks(eng, rng, False)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("bench_serve: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    from lapha_tpu_torch.engine import Engine
    from lapha_tpu_torch.models import qwen2
    from lapha_tpu_torch.ops import _cuda

    _cuda.build()
    cfg = qwen2.Qwen2Config(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        max_position_embeddings=4096, rope_theta=1e6, dtype=torch.bfloat16)
    params = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    engines = {("int8 KV" if kv else "bf16 KV"): Engine(params, cfg, _Ids(), max_model_len=2048,
                                                      max_batch=16, eos_token_ids=[], kv_quant=kv)
               for kv in (None, "int8")}
    for label, eng in engines.items():
        for per_step in (False, True, False, True):
            ts = _chunks(eng, rng, per_step)
            print(f"{label} chunk (16 rows x 16 steps), state read "
                  f"{'with a sync every step' if per_step else 'once'}: host ms "
                  f"{[round(t, 1) for t in ts]}, median {float(np.median(ts)):.1f} [{card}]",
                  flush=True)
    # every burst before the process's first profile, then every one after it
    for when in ("before", "after"):
        if when == "after":
            _profiled_chunk(engines["bf16 KV"], rng)
        for label, eng in engines.items():
            ntok, wall, steps = _burst(eng, rng)
            print(f"{label} burst {when} a profile: {ntok} tokens in {wall:.2f} s = "
                  f"{ntok / wall:.1f} tok/s, {steps} steps, {1e3 * wall / steps:.1f} ms a step "
                  f"[{card}]", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
