#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lapha_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, one H100

Phases, each of which fails the run (traceback, non-zero exit) on any fault:

1. Build the CUDA kernels from ``lapha_tpu_torch/csrc`` and hold each one
   against its plain PyTorch version at the served shapes (bf16 kernel vs
   the plain version in f32 on the same bf16 inputs, max |diff| <= 3e-2),
   timing both with CUDA events.
2. Check the kernel path against the plain path on a small input: two
   layers of the full-width model, prefill + one decode step, on the card
   (kernels, bf16) and on the CPU (plain versions, f32); relative error of
   the logits <= 5e-2.
3. Drive the served path, through the entry points a user calls, at
   the full width of Qwen2.5-1.5B (28 layers, H 1536, 12/2 heads, dh 128,
   I 8960, V 151936, rope_theta 1e6) with random bf16 weights from a seed:
   Engine.generate on 4 parent prompts of 512 tokens x n=6 (64 new tokens),
   then on 4 children (parent + 64 tokens, a prefix-cache hit), the root
   value forward through ValueFunction, and from_pooled + potential V on the
   24 children. Kernel launch counts are zeroed just before the first such
   round and read just after it; every kernel must have run.
4. Check the outputs: shapes, finite values, V in [0, 1], 64 tokens per row,
   the prefix-hit path taken, and the children's engine-pooled h0 (prefill
   + decode kernels) against a value forward over the same tokens (the
   no-cache kernel), relative error <= 5e-2.
5. Time a second, warm round on fresh prompts (host clock; the engine
   synchronises the device at each phase boundary).

Prints the card's name and power limit, each timing beside them, one JSON
line of per-kernel results, and finally
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# bf16 kernel vs f32 plain on the same bf16 inputs: P is rounded to bf16
# before P·V and the output to bf16, each <= 2^-9 relative of max|v| <= ~5
KERNEL_ATOL = 3e-2
REF_RTOL = 5e-2      # bf16 through two layers (or 28, for pooled h0) vs f32
SEED = 0


def check(ok, what) -> None:
    """A failed check raises (asserts would vanish under python -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ab_ms(kernel_fn, plain_fn) -> tuple[float, float]:
    """Kernel and plain times, measured in turns (kernel, plain, plain,
    kernel) and averaged, so drift in clocks hits both alike."""
    k1, p1, p2, k2 = (_time_ms(f) for f in (kernel_fn, plain_fn, plain_fn, kernel_fn))
    return (k1 + k2) / 2, (p1 + p2) / 2


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def check_kernels(dev, card):
    """Phase 1: each kernel vs its plain version at the served shapes."""
    import numpy as np
    import torch

    from lapha_tpu_torch.ops import flash_attention as fa
    from lapha_tpu_torch.ops import ragged_decode_attention as rda

    rng = np.random.default_rng(SEED)
    nh, nkv, dh = 12, 2, 128

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)

    def flash_case(name, B, T, S, qstart, lens):
        q, k, v = bf16(B, T, nh, dh), bf16(B, S, nkv, dh), bf16(B, S, nkv, dh)
        kv_valid = (torch.arange(S, device=dev)[None, :]
                    < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)
        qs = torch.full((B,), qstart, dtype=torch.int32, device=dev)
        scale = dh ** -0.5
        out, lse = fa._attention_cuda(q, k, v, kv_valid, qs, scale, name)
        ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qs, scale)
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all(), f"{name} output finite")
        err = float((out.float() - ref.float()).abs().max())
        seen = ref_lse > -1e29
        check(err <= KERNEL_ATOL, f"{name} B={B} T={T} S={S} max|diff| {err}")
        check(float((lse[seen] - ref_lse[seen]).abs().max()) <= 1e-3, f"{name} LSE")
        ms, plain_ms = _ab_ms(lambda: fa._attention_cuda(q, k, v, kv_valid, qs, scale, name),
                              lambda: fa.attention_plain(q, k, v, kv_valid, qs, scale))
        print(f"kernel {name} B={B} T={T} S={S} qstart={qstart}: max|diff| {err:.3e}, "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]", flush=True)
        return err, ms, plain_ms

    results = {}
    # K3: fresh prefill of 4 ragged prompts; suffix prefill on a prefix hit
    e1, ms1, pms1 = flash_case("flash_attention_cached", 4, 512, 640, 0, (512, 300, 450, 77))
    e2, ms2, pms2 = flash_case("flash_attention_cached", 4, 128, 768, 512, (576, 576, 560, 576))
    results["flash_attention_cached"] = (max(e1, e2), ms1, pms1)
    # K1: value forward of 4 rows of 512 with padded rows (S = T, qstart = 0)
    results["flash_attention"] = flash_case("flash_attention", 4, 512, 512, 0, (512, 400, 512, 130))

    # K4: decode over the fanned-out cache, ragged prompts, unaligned dstart
    L, B, S = 2, 24, 640
    q, kc, vc = bf16(B, nh, dh), bf16(L, B, nkv, S, dh), bf16(L, B, nkv, S, dh)
    lens = torch.from_numpy(rng.integers(64, 513, B).astype(np.int32)).to(dev)
    dstart = torch.full((B,), 517, dtype=torch.int32, device=dev)
    dstart[:4] = lens[:4]  # prompt tail and decode start share a chunk
    err = 0.0
    for layer, slot in ((0, 517), (1, 580)):
        out = rda.ragged_decode_attention(q, kc, vc, layer, lens, dstart, slot)
        ref = rda.ragged_decode_plain(q, kc, vc, layer, lens, dstart, slot)
        torch.cuda.synchronize()
        err = max(err, float((out.float() - ref.float()).abs().max()))
    check(err <= KERNEL_ATOL, f"ragged_decode_attention max|diff| {err}")
    ms, plain_ms = _ab_ms(lambda: rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, 580),
                          lambda: rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, 580))
    print(f"kernel ragged_decode_attention B={B} S={S} slot=580: max|diff| {err:.3e}, "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]", flush=True)
    results["ragged_decode_attention"] = (err, ms, plain_ms)
    return results


def check_small_reference(params, cfg, dev):
    """Phase 2: two layers of the full-width model, kernels (card, bf16) vs
    plain versions (CPU, f32): cached prefill logits and one decode step."""
    import dataclasses

    import numpy as np
    import torch

    from lapha_tpu_torch.models import qwen2

    def tree_map(fn, node):
        return ({k: tree_map(fn, v) for k, v in node.items()} if isinstance(node, dict)
                else fn(node))

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    sub = dict(params, layers=tree_map(lambda t: t[:2], params["layers"]))
    cpu = tree_map(lambda t: t.to("cpu", torch.float32), sub)
    cfg_cpu = dataclasses.replace(cfg2, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 1)
    B, T, S = 2, 96, 128
    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, T)))
    lens = torch.tensor([96, 70])
    mask = (torch.arange(T)[None, :] < lens[:, None]).long()
    kv_valid = torch.zeros((B, S), dtype=torch.bool)
    kv_valid[:, :T] = mask > 0
    pos = (mask.cumsum(1) - 1).clamp(min=0)
    nxt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B,)))

    def run(p, c, device):
        with torch.inference_mode():
            cache = qwen2.init_kv_cache(c, B, S, device)
            logits, _, cache = qwen2.forward(p, c, ids.to(device), positions=pos.to(device),
                                             kv_cache=cache, cache_pos=0,
                                             kv_valid=kv_valid.to(device))
            ck = cache[0].permute(0, 1, 3, 2, 4).contiguous()
            cv = cache[1].permute(0, 1, 3, 2, 4).contiguous()
            step, _, _, _ = qwen2.decode_step(
                p, c, nxt.to(device), lens.to(device), ck, cv, T,
                lens.to(device, torch.int32), torch.full((B,), T, dtype=torch.int32, device=device))
        return logits.float().cpu(), step.float().cpu()

    g_logits, g_step = run(sub, cfg2, dev)
    c_logits, c_step = run(cpu, cfg_cpu, torch.device("cpu"))
    real = mask > 0
    e_prefill = _rel(g_logits[real], c_logits[real])
    e_decode = _rel(g_step, c_step)
    print(f"reference check (2 layers, card kernels bf16 vs CPU plain f32): prefill logits "
          f"rel err {e_prefill:.3e}, decode logits rel err {e_decode:.3e}", flush=True)
    check(e_prefill <= REF_RTOL and e_decode <= REF_RTOL,
          f"reference rel err prefill {e_prefill} decode {e_decode}")


class IdTok:
    """Prompts are space-separated token ids (the bench.py tokenizer stub)."""

    eos_token_id = 1
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    import numpy as np

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.models import qwen2, value_model
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops.latent import potential_v
    from lapha_tpu_torch.search import ValueFunction

    t0 = time.perf_counter()
    _cuda.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in _cuda.build_log.splitlines():  # ptxas: registers, smem, spills per kernel
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)
    kernels = check_kernels(dev, card)

    cfg = qwen2.Qwen2Config(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        max_position_embeddings=4096, rope_theta=1e6, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = qwen2.init_params(cfg, gen)
    head = value_model.init_value_head(cfg.hidden_size, gen)
    check_small_reference(params, cfg, dev)

    P, n, plen, new = 4, 6, 512, 64
    eng = Engine(params, cfg, IdTok(), max_model_len=plen + 2 * new + 128, max_batch=P * n,
                 decode_chunk=32, pad_multiple=128, batch_bucket=1, eos_token_ids=[],
                 seed=SEED, collect_h0=True)
    vf = ValueFunction(params, head, cfg, max_model_len=1024, pad_multiple=128, batch_bucket=P)
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    rng = np.random.default_rng(SEED + 2)

    def text(ids):
        return " ".join(str(int(t)) for t in ids)

    def serve():
        """One expansion round: parents, prefix-hit children, root value
        forward, children scored from their pooled h0, potential V."""
        roots = [rng.integers(2, cfg.vocab_size, plen) for _ in range(P)]
        children = [np.concatenate([r, rng.integers(2, cfg.vocab_size, new)]) for r in roots]
        out = {"roots": roots, "children": children}
        t0 = time.perf_counter()
        out["parents"] = eng.generate([text(r) for r in roots], sp)
        out["t_par"] = dict(eng.last_timings)
        hits0 = eng.prefix_cache.hits
        out["kids"] = eng.generate([text(c) for c in children], sp)
        out["t_kid"] = dict(eng.last_timings)
        out["hits"] = eng.prefix_cache.hits - hits0
        t1 = time.perf_counter()
        out["y_root"], out["v_root"], out["h0_root"] = vf(
            np.stack(roots), np.ones((P, plen), np.int32), return_h0=True)
        out["t_value"] = time.perf_counter() - t1
        out["pooled"] = np.stack([o.pooled_hidden for r in out["kids"] for o in r.outputs])
        out["y_kids"], out["v_kids"] = vf.from_pooled(out["pooled"], root_h0=out["h0_root"][0])
        y_t = torch.from_numpy(out["y_kids"]).to(dev)
        anchor = y_t[int(np.argmax(out["v_kids"]))][None, :]  # best-valued child as goal
        out["V"] = potential_v(y_t, torch.zeros(cfg.hidden_size, device=dev),
                               anchor).cpu().numpy()
        torch.cuda.synchronize()
        out["t_all"] = time.perf_counter() - t0
        return out

    # ---------------- the served path, counted
    torch.cuda.synchronize()
    _cuda.reset_launches()
    run = serve()
    launches = dict(_cuda.LAUNCHES)

    # ---------------- checks on what came out
    for name, count in launches.items():
        check(count > 0, f"{name} never launched on the served path")
    check(run["hits"] == P, f"expected {P} prefix-cache hits, got {run['hits']}")
    for outs in (run["parents"], run["kids"]):
        check(len(outs) == P and all(len(r.outputs) == n for r in outs), "request/sample count")
        for r in outs:
            for o in r.outputs:
                check(len(o.token_ids) == new, f"{len(o.token_ids)} tokens, expected {new}")
                check(all(0 <= t < cfg.vocab_size for t in o.token_ids), "token ids in vocab")
                check(np.isfinite(o.token_logprobs).all() and max(o.token_logprobs) <= 0.0,
                      "logprobs finite and <= 0")
                check(o.pooled_hidden.shape == (cfg.hidden_size,), "pooled_hidden shape")
    check(run["y_root"].shape == (P, cfg.hidden_size) and run["v_root"].shape == (P,),
          "root value shapes")
    check(run["y_kids"].shape == (P * n, cfg.hidden_size) and run["V"].shape == (P * n,),
          "child value shapes")
    for key in ("y_root", "v_root", "h0_root", "pooled", "y_kids", "v_kids", "V"):
        check(np.isfinite(run[key]).all(), f"{key} finite")
    check((run["V"] >= 0).all() and (run["V"] <= 1).all(), f"V in [0, 1]: {run['V']}")
    check((np.linalg.norm(run["y_kids"], axis=-1) < 1).all(), "ball points inside the ball")
    # fused value: the engine's pooled h0 of child sample 0 == a value forward
    # over the same prompt + completion (no-cache kernel vs prefill/decode kernels)
    full = np.concatenate([run["children"][0],
                           np.asarray(run["kids"][0].outputs[0].token_ids)])[None]
    _, _, h_ref = vf(full, np.ones_like(full, dtype=np.int32), return_h0=True)
    e_fused = float(np.linalg.norm(run["pooled"][0] - h_ref[0]) / np.linalg.norm(h_ref[0]))
    print(f"fused value check: engine pooled h0 vs value forward rel err {e_fused:.3e}", flush=True)
    check(e_fused <= REF_RTOL, f"fused value rel err {e_fused}")
    print(f"launches on the served path: {launches}; first (cold) round "
          f"{run['t_all']:.2f} s [{card}]", flush=True)

    # ---------------- timings: a second, warm round on fresh prompts
    warm = serve()
    tp, tk = warm["t_par"], warm["t_kid"]
    rows_tok = P * n * new
    print(f"warm parents: prefill {tp['prefill_s'] * 1e3:.1f} ms (4 x 512 tokens), decode "
          f"{tp['decode_s'] * 1e3:.1f} ms for {tp['decode_steps']} steps x {P * n} rows = "
          f"{rows_tok / tp['decode_s']:.1f} tok/s [{card}]", flush=True)
    print(f"warm children: prefix-hit prefill {tk['prefill_s'] * 1e3:.1f} ms (4 x 64-token "
          f"suffix at qstart 512), decode {tk['decode_s'] * 1e3:.1f} ms = "
          f"{rows_tok / tk['decode_s']:.1f} tok/s [{card}]", flush=True)
    print(f"warm root value forward (4 x 512): {warm['t_value'] * 1e3:.1f} ms; whole round "
          f"{warm['t_all']:.2f} s [{card}]", flush=True)

    replaces = {
        "flash_attention": ("lapha_tpu_torch/csrc/flash_attention.cu",
                            "lapha_tpu/ops/flash_attention.py:46"),
        "flash_attention_cached": ("lapha_tpu_torch/csrc/flash_attention.cu",
                                   "lapha_tpu/ops/flash_attention.py:395"),
        "ragged_decode_attention": ("lapha_tpu_torch/csrc/ragged_decode_attention.cu",
                                    "lapha_tpu/ops/ragged_decode_attention.py:68"),
    }
    rows = []
    for name, (src, rep) in replaces.items():
        err, ms, plain_ms = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": launches[name], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
