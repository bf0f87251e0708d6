#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lapha_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, one H100
    python3 chip_smoke.py --c5     # only the GPT-OSS fused-h0 probe (ROADMAP C5)

Phases, each of which fails the run (traceback, non-zero exit) on any fault:

1. Build the CUDA kernels from ``lapha_tpu_torch/csrc`` (one nvcc per
   source, in parallel) and hold each forward kernel against its plain
   PyTorch version at the served shapes (bf16 kernel vs the plain version
   in f32 on the same bf16 inputs, max |diff| <= 3e-2), timing both with
   CUDA events; the decode kernel (K4/K5, here and in 1c, 1e, 1f, 1l) as
   CUDA-graph replays through its wrapper, since at ~0.01 ms a call
   launches from Python would time the host.
1b. The flash backward kernels (dq; dk/dv) against the plain backward on
   the same bf16 inputs and saved LSE, at B=4 T=1024 (ragged masks) and B=2
   T=1000 (padded tails), 12/2 heads: max |diff| <= 1e-2 * max |plain| +
   1e-3 for each of dq, dk, dv; timed in turns against the plain version.
   Here and in every K2 check below (1h, 1i, 1k, 1l) dq and dk/dv are
   launched a second time and must be bit-equal to the first launch.
1c. The quantized-serving kernels against their plain versions at the
   path's shapes, timed in turns: the int8-cache ragged decode (K5) at B=48,
   S=768, prompts of 512, 12/2 heads, caches from ``_quantize_kv`` of random
   bf16 (|diff| <= 5e-3 + 2^-7 |plain| per element), and two faults planted
   through its inputs (the V scales of the next slot; a dropped prompt slot)
   must break that check; the int4 dequant-matmul (K6) at 48 rows for each
   projection of the model (1536->1536, 1536->256, 1536->8960, 8960->1536)
   and at 512 rows (max |diff| <= 1e-3 * max |plain|: the same exact bf16 x
   nibble products, f32 sums in another order), two launches bit-equal (the
   split in-dim's partial sums are added in a fixed order), and one split's
   contribution dropped (a planted fault, its pairs' scales zeroed) must
   fail the check; timed as CUDA-graph replays beside
   ``torch._weight_int4pack_mm`` on the same weights.
1d. The grouped GEMM (K8) against its plain version at the MoE paths'
   shapes: the decode kernel at the six decode products of the served MoE
   models (24 tokens: Qwen1.5-MoE top-4 over 60 experts, 2048 <-> 1408;
   GPT-OSS-20B top-4 over 32, 2880 -> 5760 and 2880 -> 2880;
   DeepSeek-V2-Lite top-6 over 64, 2048 <-> 1408; gate/up and down each),
   two launches bit-equal, timed as CUDA-graph replays beside
   ``torch._grouped_mm`` with the bound (the touched experts' weights once);
   prefill gate/up (8192 rows) and the training forward (32768 rows = 8 x
   1024 x top-4) on the wgmma kernel, as the host's rule picks them (each
   launch counted under its kernel's name), the group sizes from top-k
   routing of random hidden states through a random router; max |diff| <=
   1e-3 * max |plain| (the same exact bf16 products, f32 sums in another
   order). Group sizes shifted by one row (a planted fault) must fail it on
   both kernels. At every decode row, so must one 64-row stage of the
   decode kernel's ring counted twice (planted by doubling those weight
   rows, against the plain version of the weights as they were): that
   fault shows the limit is tight enough to catch a stage read twice, not
   that the ring never does.
1e. The GPT-OSS kernels against their plain versions, timed in turns: the
   attention-sink decode entries (K5s, bf16 and int8 caches) at B=24,
   S=640, 64/8 heads of dim 64 and 12/2 of dim 128, window-clipped ranges
   on half the rows (phase 1/1c's limits), with the sinks of the next head
   planted as a fault that must fail them, and at dh 128 (a row split over
   a cluster of CTAs) with sinks near each head's log-sum-exp, the sink
   counted once per split planted as a fault that must fail them; the
   windowed flash kernels (K3 at
   qstart 512 / T=64 and at T=512, K1 at T=512; W=128, dh 64, 64/8 heads)
   at 3e-2 beside SDPA with a banded boolean mask, with a window off by one
   planted as a fault that must fail them.
1f. The Gemma kernels at head dim 256 against their plain versions, timed in
   turns: K3 (fresh prefill T=512, suffix prefill at qstart 512), K1
   (T=512) and the decode kernel (K4, and K5 for Gemma-2) at Gemma-2's heads
   (8/4, window 4096, softcap 50) and Gemma-3's (4/1, window 512, no
   softcap), banded and full, phase 1/1c's limits. With the softcap, q is
   scaled so that the logits reach 2-3x the cap, and the kernel run without
   it (a planted fault) must fail. The library yardstick is SDPA for the
   softcap-free shapes and the compiled ``flex_attention`` (the softcap as
   its score_mod, a block mask) for the softcapped K1/K3/K4, held to the
   plain version at the kernels' limit; K5 has none.
1g. K8's backward (dX, ``grouped_gemm_dx``; dW, ``grouped_gemm_tgmm``; both
   wgmma kernels) against its plain versions in f32 on the same bf16 dY, at
   the training shapes of Qwen1.5-MoE (32768 pair rows over 60 experts;
   2048 -> 1408 and 1408 -> 2048) and GPT-OSS-20B (16384 over 32; 2880 ->
   5760, 2880 -> 2880), group sizes from top-4 routing with two experts
   forced empty, and DeepSeek-V2-Lite (49152 = 8 x 1024 x top-6 over 64;
   2048 -> 1408, 1408 -> 2048): per element |diff| <= 1e-3 * max |plain| +
   2^-8 |plain| (the bf16 store's rounding), an empty expert's dW exact
   zeros where the output held NaN, two launches bit-equal; group sizes
   shifted by one row and empty tiles left as NaN (planted faults) must
   fail; timed in turns beside ``torch._grouped_mm``.
1h. K2 at head dim 64 (GPT-OSS's 64/8 heads, B=4 T=1024, ragged masks),
   W = 128 and W = 0, the sinks folded into (out, LSE) as the autograd
   backward gives them: phase 1b's limits; a window off by one (a planted
   fault) must fail; timed beside SDPA's backward with a banded mask.
1i. K2 at head dim 256 and with the softcap, B=4 T=1024 with ragged masks:
   Gemma-2's 8/4 heads with the softcap of 50 (q x25: the scaled logits
   reach 1-3x the cap), full, at its own W=4096 and with a biting band
   W=128 (a check only printed); Gemma-3's 4/1 heads at W=512 and full; the
   softcap at dh 128 (12/2) and dh 64 (64/8); phase 1b's limits against the
   plain backward on the forward kernel's (out, LSE). The softcap dropped
   from the kernel call and a window off by one where the band bites
   (planted faults) must fail; timed beside SDPA's backward (cap-free)
   or the compiled flex_attention's backward with the softcap as its
   score_mod, itself held to the plain backward first.
1j. K1/K3 with V narrower than Q/K at DeepSeek-V2-Lite's shapes (16/16
   heads, Q/K 192, V 128, scale 1/sqrt(192)): K3 fresh prefill (B=4 T=512
   S=640), K3 suffix prefill (T=64 at qstart 512, ragged kv_valid), K1 (B=4
   T=512, padded rows), phase 1's limit; the scale of 1/sqrt(128) and each
   head's V taken from the next head (planted faults) must fail it; timed
   in turns beside SDPA (the first backend that takes V of 128 and agrees
   with the plain version, else V padded to 192, else the math backend);
   phase 1's (128, 128) K3 row timed again beside it.
1k. K2 with V narrower than Q/K at DeepSeek-V2-Lite's training shape (B=4
   T=1024, 16/16 heads, Q/K 192, V 128, its scale, ragged masks with a
   hole): dq, dk and dv at phase 1b's limits against the plain backward on
   the narrow-V forward kernel's (out, LSE); the scale of 1/sqrt(128) and dO
   read at the next head's offset (planted faults) must fail; timed in turns
   beside the fastest SDPA backend whose backward takes V of 128 natively
   (cuDNN or memory-efficient, held to the same limits), else the compiled
   flex_attention's backward.
1l. The instances Phi-3 and StarCoder2 run, at phase 1/1b/1c's limits,
   timed in turns beside the plain version and one library call (SDPA, its
   backward for K2; none for K5): K3 (B=4 T=512 S=640) and K1 (B=4 T=512)
   at Phi-3-mini's 32/32 heads of dim 96, full and at its window of 2047,
   and K3 banded where the band bites (T=512 at qstart 2048); K2 at B=4
   T=1024 32/32 dh 96, ragged masks, W=2047; K4/K5 at B=24 S=640, the
   window's clipped ranges on the odd rows, at 32/32 dh 96 (W 2047 and a
   band of 128) and at GQA groups of 9, 12 (StarCoder2-3B's 24/2), 16 and
   32 (dh 128). Planted faults that must fail: K/V of the next head (K1/K3),
   the window W + 1 where it bites, dO of the next head (K2), K/V of the
   next layer (K4/K5).
2d. Two full-width Qwen1.5-MoE-A2.7B layers, card (kernels, bf16) against
   CPU (plain versions, f32): prefill + one decode step, relative error of
   the logits <= 5e-2, with the count of (token, layer) routing choices
   that differ between the two; the same with the card's routing replayed
   on the CPU; then the MoE block of layer 0 alone with the card's routing
   forced on the CPU, relative error <= 1e-2.
10. MoE serving at the full width and depth of Qwen1.5-MoE-A2.7B (24
   layers, H 2048, 16/16 heads, 60 experts top-4 of width 1408, a
   sigmoid-gated shared expert of 5632, V 151936, untied; random bf16
   weights from a seed, 28.6 GB): the phase-3 round (4 parents x 512, n=6,
   64 new tokens, 4 prefix-hit children, the root value forward,
   from_pooled + V), launch counts zeroed before it and read after it under
   "serve_moe" (K8, K1, K3 and K4 must have run), phase 4's checks, a warm
   round timed, peak device memory; one MoE layer under
   ``torch.cuda.set_sync_debug_mode("error")`` (the gather path never waits
   on the host); one decode step at the served shape profiled as in phase
   9 (here and in phases 11 and 15 with K8's device ms and share of the
   step). The MoE model is freed before the GPT-OSS model is made.
2g. (in phases 10 and 11, on each model) Phase 2b's gradient check on two
   full-width layers of Qwen1.5-MoE-A2.7B and of GPT-OSS-20B (prompts of
   200 and 150 tokens, past the window), remat off, the card's routing
   replayed on the CPU (combine weights from the CPU's own router at the
   card's choices; the choices that would differ are counted): relative
   error per leaf <= 5e-2, an expert without rows zero on both sides.
2e. Two full-width GPT-OSS-20B layers (layer 0 sliding, layer 1 full),
   phase 2's check at prompts of 160 and 134 tokens (past the 128-token
   window): the routing choices that differ between the card and the CPU
   are counted, then the check (rel err <= 5e-2) is made with the card's
   routing replayed on the CPU.
11. GPT-OSS serving at the full width and depth of GPT-OSS-20B, from its
   published config.json through ``Qwen2Config.from_hf`` (24 layers, H
   2880, 64/8 heads of dim 64, alternating 128-token sliding windows, YaRN
   x32, 32 experts top-4 of width 2880, V 201088, untied; random bf16
   weights from a seed, random sinks and router biases, 41.8 GB): the
   phase-3 round with bf16 KV, then one with ``kv_quant="int8"``, launch
   counts zeroed before them and read after under "serve_gptoss" (the
   windowed K1/K3, both sink decode entries, K8 and the full-layer K1/K3
   must have run; the sink-free decode entries must not); the
   windowed-short decode cache installed in each generate; phase 4's
   checks, a warm round timed, peak device memory, one decode step
   profiled as in phase 9. The fused-h0 check is then made again with the
   engine's routing replayed into the value forward (a fresh parent and
   its prefix-hit child, n=1, each KV mode; ROADMAP C5). The GPT-OSS model
   is freed before the Gemma models are made.
2f. Two full-width layers of each Gemma model, phase 2's check (Gemma-3 at
   prompts of 560 and 534 tokens, past its 512-token window).
12. Gemma serving at full width and depth, from the published config.json
   of Gemma-2-2B (26 layers, H 2304, 8/4 heads of dim 256, I 9216 GeGLU,
   alternating 4096 windows, softcaps 50/30, V 256000 tied; 5.2 GB) and
   Gemma-3-1B (26 layers, H 1152, 4/1 heads of dim 256, I 6912, 512 windows
   with every 6th layer global, q/k norms, local rope 10000, V 262144 tied;
   2.0 GB) through ``Qwen2Config.from_hf``, random bf16 weights from the
   seed (Gemma-2's q projections x16 and embedding x32, so that its softcaps
   bite): the phase-3 round, for Gemma-2 with bf16 KV then int8 KV, launch
   counts zeroed before and read after under "serve_gemma2" /
   "serve_gemma3" (the softcap launches of K1/K3/K4/K5 for Gemma-2, the
   dh-256 K1/K3/K4 for Gemma-3, banded and full, and nothing else); the
   windowed-short install engaged for Gemma-3's children only; phase 4's
   checks, a warm round timed, peak device memory, one decode step
   profiled as in phase 9. Each model is freed before the next is made.
2h. Two full-width DeepSeek-V2-Lite layers (layer 0 dense, layer 1 MoE),
   phase 2's check with one decode step over the bf16 latent cache and one
   over its int8 quantization: the routing choices that differ between the
   card and the CPU are counted, then the check (rel err <= 5e-2) is made
   with the card's routing replayed on the CPU.
15. DeepSeek MLA serving at the full width and depth of DeepSeek-V2-Lite,
   from its published config.json through ``DeepseekConfig.from_hf`` (27
   layers, H 2048, 16 heads, kv_lora 512, Q/K 192 (nope 128 + rope 64), V
   128, YaRN x40, one dense layer of I 10944, then 64 experts top-6 of
   width 1408 + 2 shared, V 102400, untied; random bf16 weights from the
   seed, 31.4 GB): the phase-3 round with the bf16 latent cache, then with
   ``kv_quant="int8"``, launch counts zeroed before and read after under
   "serve_deepseek" (the narrow-V K1 and K3 and K8 must have run; no dh = dv
   flash instance and no decode kernel may: MLA decode is torch products);
   phase 4's checks (the fused-h0 check with the engine's routing replayed
   into the value forward where routing flips push it past the limit), a
   warm round timed, peak device memory, one decode step at 24 rows
   profiled as in phase 9. The model is freed before the dense one is made.
17. Phi-3-mini-4k (32 layers, H 3072, 32/32 heads of dim 96, I 8192 SwiGLU,
   every layer sliding at 2047, V 32064 untied; 7.64 GB) and StarCoder2-3B
   (30 layers, H 3072, 24/2 heads of dim 128, I 12288 plain gelu FFN,
   biased LayerNorms and projections, every layer sliding at 4096, V 49152
   tied; 6.06 GB) served at full width and depth from their published
   config.json through ``Qwen2Config.from_hf``, random bf16 weights from the
   seed, each made and freed in turn: phase 2's two-layer check (Phi-3's at
   prompts of 2100 and 2074 tokens, past its window), then phase 12's
   rounds with bf16 KV and int8 KV, counted under "serve_phi3" /
   "serve_starcoder2" (the windowed K1/K3 and K4/K5 and nothing else:
   dh 96 for Phi-3, the group of 12 for StarCoder2), phase 4's checks, a
   warm round timed, peak memory, one decode step profiled.
2. Check the kernel path against the plain path on a small input: two
   layers of the full-width model, prefill + one decode step, on the card
   (kernels, bf16) and on the CPU (plain versions, f32); relative error of
   the logits <= 5e-2.
2c. The same two layers with int4 projections, int8 embed/head and an int8
   KV cache (``quantize_params(bits=4)``, ``decode_step(cache_scale=)``),
   card (kernels, bf16) against CPU (plain versions, f32), relative error of
   the logits <= 5e-2; then the same with int8 weights (the dequantized
   matmul, no weight kernel).
2b. The same two layers: gradients of the GRPO + value loss
   (``losses.loss_and_metrics``) on the card (bf16, kernels) against the
   CPU (f32, plain) on one packed batch; relative error per parameter leaf
   and for the value head <= 5e-2.
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
8. Quantized serving at bench.py's shape: the phase-3 weights quantized on
   the card (``quantize_params(bits=4)``: int4 projections, int8 embed/head)
   and ``Engine(kv_quant="int8")``; a round is 8 parents x 512 tokens with
   n=6 and 256 new tokens (48 decode rows, S=768), 4 prefix-hit children,
   the root value forward and ``from_pooled`` + V. Launch counts are zeroed
   before the first round and read after it: the int4 kernel and the int8
   decode kernel ran, the bf16 decode kernel did not. Phase 4's checks
   follow, the fused-h0 check with a tolerance for the int8 cache. A warm
   round is timed; then the same two rounds with bf16 weights + int8 KV
   (bench.py's default configuration).
9. Where one decode step's time goes at bench.py's shape (48 rows, prompts
   of 512, S=768), for bf16 weights with a bf16 cache, bf16 weights with an
   int8 cache and int4 weights with an int8 cache: host-clock time per step
   (device synchronised after each), device time per step (``torch.profiler``,
   the CUDA kernels' own time summed), launches per step and the largest
   kernels.
6. Training through the normal entry at full width: ``MTPOTrainer`` on the
   28-layer random bf16 model (gradient checkpointing, beta 1e-8 as
   configs/lapha.yaml), PoorAgent's templates and a token-id chat tokenizer
   over the whole vocabulary; one ``train_step`` on two questions with a
   CoT anchor (depth 2, breadth 4, num_sim 4, 32 new tokens per step).
   Random weights may leave no trainable group; that is printed, not hidden.
7. The update at full width, always run: three update steps
   (``losses.make_update_fn``, remat "full") on 8 packed rows of 512 prompt
   + 512 completion tokens, launch counts zeroed just before and read just
   after (both backward kernels must have run); finite loss and grad norm;
   non-zero attention-projection gradients in every layer; moved params;
   the engine generates after the update and the logits changed. Then one
   warm step is timed at scripts/bench_train.py's shape (B=8, prompt 3072 +
   completion 1024).
13. MoE training at full width, after phase 7 (the dense model freed):
   three ``losses.make_update_fn`` steps (remat "full", AdamChain at
   TRAIN_LR) on the first 4 layers of Qwen1.5-MoE-A2.7B (8 packed rows of
   512 + 512 tokens) and of GPT-OSS-20B (2 sliding, 2 full; 4 rows), each
   model made and freed in turn: non-zero gradients in every layer's
   router, expert stacks, attention projections (GPT-OSS: sinks, expert
   biases), launch counts under "update_moe" / "update_gptoss" (the wgmma
   K8, dX, tgmm, K1, K2, and never the decode K8; GPT-OSS also the windowed
   K1 and K2), the routing
   recomputed in the backward equal to the forward's, finite loss and grad
   norm, moved params, generation after the update with changed logits,
   one warm step on the host clock and one under the profiler, the peak
   memory, the profile's K8 device time by kernel; then one
   MTPOTrainer.train_step on the MoE model as phase 6 ("train_step_moe":
   its decode rounds on the decode K8).
14. Gemma training at full width and depth, after phase 13: Gemma-2-2B
   (26 layers, 2.6 B params, softcaps biting: q_proj x16, embedding x32)
   and Gemma-3-1B (26 layers, 512 windows), each made and freed in turn:
   phase 2b's gradient check on its first two layers (Gemma-3 at rows past
   its window; Gemma-2's largest attention and final logits printed beside
   the caps), non-zero gradients in every layer's q/k/v/o, four sandwich
   norms and MLP, three ``losses.make_update_fn`` steps (remat "full",
   AdamChain at TRAIN_LR, 8 packed rows of 512 + 512 tokens) with the launch
   counts under "update_gemma2" / "update_gemma3" (the dh-256 K1 and K2,
   banded and full: Gemma-2's all softcapped, Gemma-3's none), finite loss
   and grad norm, moved params, generation after the update with changed
   logits, one warm step on the host clock and one profiled, the peak
   memory; then one MTPOTrainer.train_step on Gemma-2-2B
   ("train_step_gemma2").
16. DeepSeek training at full width, after phase 14: the first 4 layers of
   DeepSeek-V2-Lite (1 dense, 3 MoE; 2.25 B params, the full 27 layers
   would not fit one card with Adam's state), 8 packed rows of 512 + 512
   tokens, ``losses.make_update_fn`` (remat "full", AdamChain at TRAIN_LR):
   non-zero gradients in every layer's q, kv_a, kv_b, o, router, expert
   stacks, shared experts and the dense MLP; three steps with the launch
   counts under "update_deepseek" (the narrow-V K1 and K2, the wgmma K8,
   dX, tgmm, no decode K8 and no other attention instance), the routing
   recomputed in the backward
   equal to the forward's, finite loss and grad norm, moved params,
   generation after the update with changed logits, one warm step on the
   host clock and one profiled, the peak memory; then one
   MTPOTrainer.train_step on the same model ("train_step_deepseek": the
   narrow-V K3 prefill and the decode K8 in the rollout, the KL reference
   of beta 1e-8 through the DeepSeek forward), its peak memory; the
   profile's K8 device time by kernel.
18. Phi-3-mini-4k and StarCoder2-3B training at full width and depth (3.82
   and 3.03 B params), after phase 16, each made and freed in turn: phase
   14's steps (phase 2b's check on the first two layers, non-zero gradients
   in every layer's q/k/v/o, norms (StarCoder2's LayerNorm biases) and MLP
   (c_fc / c_proj with their biases), three counted updates under
   "update_phi3" / "update_starcoder2": the windowed K1 and K2, dh 96 for
   Phi-3; finite loss and grad norm, moved params, generation after the
   update with changed logits, a warm and a profiled step, the peak
   memory); then one MTPOTrainer.train_step on Phi-3 ("train_step_phi3").

Launch counts are read per path (serve_moe: phase 10; serve_gptoss: phase
11; serve_gemma2 and serve_gemma3: phase 12; serve_deepseek: phase 15;
serve: phase 3;
serve_quantized: phase 8; train_step: phase 6; update: phase 7;
update_moe, update_gptoss and train_step_moe: phase 13; update_gemma2,
update_gemma3 and train_step_gemma2: phase 14; update_deepseek and
train_step_deepseek: phase 16; serve_phi3 and serve_starcoder2: phase 17;
update_phi3, update_starcoder2 and train_step_phi3: phase 18). Prints the
card's name and power
limit, each timing beside them, one JSON line of per-kernel results (each
row with its time, the plain version's, the time of one PyTorch call that
computes the same function where there is one, and its bound: the larger
of the bytes it must move at 3.35 TB/s and its operations at 989 TFLOP/s,
for the timed shape), and finally
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import zlib

# bf16 kernel vs f32 plain on the same bf16 inputs: P is rounded to bf16
# before P·V and the output to bf16, each <= 2^-9 relative of max|v| <= ~5
KERNEL_ATOL = 3e-2
REF_RTOL = 5e-2      # bf16 through two layers (or 28, for pooled h0) vs f32
# backward kernels vs plain: P and dS are rounded to bf16 before each
# product and the grads written in bf16 (2^-9 relative each); the floor
# covers gradients that are pure cancellation
BWD_RTOL, BWD_ATOL = 1e-2, 1e-3
TRAIN_LR = 1e-3      # phase 7: large enough that Adam's ~lr steps move bf16 weights
# int4 kernel vs plain: exact bf16 x nibble products, f32 sums in another order
INT4_RTOL = 1e-3
# K5 vs plain: both round the output to bf16 (at most one ulp apart, <=
# 2^-7 |out|) and the kernel rounds P to bf16 (<= 2^-9 of the p-weighted
# |v|); the floor is 10x the 4.9e-4 read at the served shape on an H100
Q8_ATOL = 5e-3
# phase 8's fused-h0 check: the pooled h0 of decode over an int8 KV cache
# (each K/V vector rounded to amax/254) against a value forward that never
# quantizes K/V; ~14x the 1.4e-3 read on an H100
FUSED_Q8_RTOL = 2e-2
# K8 vs plain: the same exact bf16 products, f32 sums in another order
GG_RTOL = 1e-3
# phase 2d's MoE block (bf16 on the card vs f32 on the CPU) with the routing
# forced equal: ~3.4x the 2.9e-3 read on an H100
MOE_BLOCK_RTOL = 1e-2
# the bound's peaks: H100 SXM device memory and dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
SEED = 0
GEMMA_CAP = 50.0  # Gemma-2's attention softcap

# GPT-OSS-20B's published config.json (HF openai/gpt-oss-20b), the model
# phases 2e and 11 serve at full width and depth through Qwen2Config.from_hf
GPTOSS_20B_CONFIG = {
    "architectures": ["GptOssForCausalLM"], "model_type": "gpt_oss",
    "vocab_size": 201088, "hidden_size": 2880, "intermediate_size": 2880,
    "num_hidden_layers": 24, "num_attention_heads": 64, "num_key_value_heads": 8,
    "head_dim": 64, "sliding_window": 128,
    "layer_types": ["sliding_attention", "full_attention"] * 12,
    "num_local_experts": 32, "num_experts_per_tok": 4, "experts_per_token": 4,
    "swiglu_limit": 7.0, "tie_word_embeddings": False, "attention_bias": True,
    "attention_dropout": 0.0, "rms_norm_eps": 1e-05, "hidden_act": "silu",
    "initial_context_length": 4096, "max_position_embeddings": 131072,
    "rope_theta": 150000,
    "rope_scaling": {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
                     "original_max_position_embeddings": 4096, "truncate": False},
    "router_aux_loss_coef": 0.9, "output_router_logits": False, "use_cache": True,
    "eos_token_id": 200002, "pad_token_id": 199999, "torch_dtype": "bfloat16",
}

# Gemma-2-2B's published config.json (HF google/gemma-2-2b) and Gemma-3-1B's
# (HF google/gemma-3-1b-it, the text model gemma3_text), the models phases
# 2f and 12 serve at full width and depth through Qwen2Config.from_hf
GEMMA2_2B_CONFIG = {
    "architectures": ["Gemma2ForCausalLM"], "model_type": "gemma2",
    "attention_bias": False, "attention_dropout": 0.0, "attn_logit_softcapping": 50.0,
    "bos_token_id": 2, "cache_implementation": "hybrid", "eos_token_id": 1,
    "final_logit_softcapping": 30.0, "head_dim": 256, "hidden_act": "gelu_pytorch_tanh",
    "hidden_activation": "gelu_pytorch_tanh", "hidden_size": 2304, "initializer_range": 0.02,
    "intermediate_size": 9216, "max_position_embeddings": 8192, "num_attention_heads": 8,
    "num_hidden_layers": 26, "num_key_value_heads": 4, "pad_token_id": 0,
    "query_pre_attn_scalar": 256, "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
    "sliding_window": 4096, "torch_dtype": "float32", "use_cache": True, "vocab_size": 256000,
}
GEMMA3_1B_CONFIG = {
    "architectures": ["Gemma3ForCausalLM"], "model_type": "gemma3_text",
    "attention_bias": False, "attention_dropout": 0.0, "attn_logit_softcapping": None,
    "bos_token_id": 2, "cache_implementation": "hybrid", "eos_token_id": [1, 106],
    "final_logit_softcapping": None, "head_dim": 256, "hidden_activation": "gelu_pytorch_tanh",
    "hidden_size": 1152, "initializer_range": 0.02, "intermediate_size": 6912,
    "max_position_embeddings": 32768, "num_attention_heads": 4, "num_hidden_layers": 26,
    "num_key_value_heads": 1, "pad_token_id": 0, "query_pre_attn_scalar": 256,
    "rms_norm_eps": 1e-06, "rope_local_base_freq": 10000, "rope_scaling": None,
    "rope_theta": 1000000, "sliding_window": 512, "sliding_window_pattern": 6,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 262144,
}

# Phi-3-mini-4k-instruct's published config.json (HF
# microsoft/Phi-3-mini-4k-instruct; the auto_map entry of the remote code left
# out) and StarCoder2-3B's (HF bigcode/starcoder2-3b), the models phases 17
# and 18 serve and train at full width through Qwen2Config.from_hf
PHI3_MINI_4K_CONFIG = {
    "architectures": ["Phi3ForCausalLM"], "model_type": "phi3", "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 1, "embd_pdrop": 0.0, "eos_token_id": 32000,
    "hidden_act": "silu", "hidden_size": 3072, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 4096, "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 32, "original_max_position_embeddings": 4096,
    "pad_token_id": 32000, "resid_pdrop": 0.0, "rms_norm_eps": 1e-05, "rope_scaling": None,
    "rope_theta": 10000.0, "sliding_window": 2047, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32064,
}
STARCODER2_3B_CONFIG = {
    "architectures": ["Starcoder2ForCausalLM"], "model_type": "starcoder2",
    "attention_dropout": 0.1, "residual_dropout": 0.1, "embedding_dropout": 0.1,
    "bos_token_id": 0, "eos_token_id": 0, "hidden_act": "gelu_pytorch_tanh",
    "hidden_size": 3072, "initializer_range": 0.018042, "intermediate_size": 12288,
    "max_position_embeddings": 16384, "mlp_type": "default", "norm_epsilon": 1e-05,
    "norm_type": "layer_norm", "num_attention_heads": 24, "num_hidden_layers": 30,
    "num_key_value_heads": 2, "rope_theta": 999999.4420358813, "sliding_window": 4096,
    "torch_dtype": "float32", "use_bias": True, "use_cache": True, "vocab_size": 49152,
}

# DeepSeek-V2-Lite's published config.json (HF deepseek-ai/DeepSeek-V2-Lite),
# the model phases 2h and 15 serve at full width and depth through
# DeepseekConfig.from_hf (the auto_map entry of the remote code left out)
DEEPSEEK_V2_LITE_CONFIG = {
    "architectures": ["DeepseekV2ForCausalLM"], "model_type": "deepseek_v2",
    "attention_bias": False, "attention_dropout": 0.0, "aux_loss_alpha": 0.001,
    "bos_token_id": 100000, "eos_token_id": 100001, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 10944, "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "pretraining_tp": 1, "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1.0, "scoring_func": "softmax",
    "seq_aux": True, "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy",
    "torch_dtype": "bfloat16", "use_cache": True, "v_head_dim": 128, "vocab_size": 102400,
}


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


def _ab_ms(kernel_fn, plain_fn, library_fn=None, timer=_time_ms, plain_timer=None
           ) -> tuple[float, float, float | None]:
    """Kernel, plain and library times, measured in turns (kernel, plain,
    library, library, plain, kernel) by ``timer`` (the plain version by
    ``plain_timer`` where given) and averaged, so drift in clocks hits all
    alike. The library time is None without a library call."""
    plain_timer = plain_timer or timer
    k1, p1 = timer(kernel_fn), plain_timer(plain_fn)
    lib = None
    if library_fn is not None:
        lib = (timer(library_fn) + timer(library_fn)) / 2
    p2, k2 = plain_timer(plain_fn), timer(kernel_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def _row(err, ms, plain_ms, library_ms, nbytes, flops) -> dict:
    """A kernel's results at its timed shape, with its bound: the larger of
    the bytes it must move over the memory rate and its operations over the
    bf16 tensor-core rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sdpa(q, k, v, allowed, scale):
    """One PyTorch call computing the same attention: q (B,T,nh,dh), k/v
    (B,S,nkv,dh) in the kernels' layout, allowed (B,T,S) bool."""
    import torch.nn.functional as F

    qt, kt, vt, m = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), allowed[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale,
                                                  enable_gqa=True)


def _flex_softcap(q, k, v, allowed, scale, cap: float):
    """One PyTorch call computing the softcapped attention: the compiled
    ``flex_attention`` with ``cap·tanh(s/cap)`` as its score_mod (none when
    ``cap`` is 0) and the mask as a block mask, built here outside the timed
    call. q (B,T,nh,dh), k (B,S,nkv,dh), v (B,S,nkv,dv) in the kernels'
    layout, allowed (B,T,S) bool. Its compile cache goes under the port's
    build directory."""
    import os

    import torch

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lapha_tpu_torch", "_build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(build, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    import torch._inductor.config as inductor_config
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    inductor_config.compile_threads = 1  # no pool of compile workers outlives the script
    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    B, T, S = allowed.shape

    def mask_mod(b, h, qi, ki):
        return allowed[b, qi, ki]

    def softcap(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    block_mask = create_block_mask(mask_mod, B, None, T, S, device=q.device)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: _FLEX["fn"](qt, kt, vt, score_mod=softcap if cap else None,
                               block_mask=block_mask, scale=scale,
                               enable_gqa=True).transpose(1, 2)


_FLEX = {}


def _allowed(kv_valid, qstart, T: int, window: int = 0):
    """(B, T, S) bool: key j is seen by query t of row b (within the window
    of the last ``window`` positions when it is > 0)."""
    import torch

    S = kv_valid.shape[1]
    ar = torch.arange(S, device=kv_valid.device)
    frontier = qstart.reshape(-1, 1, 1) + torch.arange(T, device=kv_valid.device)[None, :, None]
    seen = (kv_valid[:, None, :] > 0) & (ar[None, None, :] <= frontier)
    return seen & (ar[None, None, :] > frontier - window) if window > 0 else seen


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def check_kernels(dev, card):
    """Phase 1: each kernel vs its plain version at the served shapes."""
    import numpy as np
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
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
        _k1_repeats(lambda: fa._attention_cuda(q, k, v, kv_valid, qs, scale, name), out, lse,
                    f"{name} B={B} T={T} S={S}")
        err = float((out.float() - ref.float()).abs().max())
        seen = ref_lse > -1e29
        check(err <= KERNEL_ATOL, f"{name} B={B} T={T} S={S} max|diff| {err}")
        check(float((lse[seen] - ref_lse[seen]).abs().max()) <= 1e-3, f"{name} LSE")
        allowed = _allowed(kv_valid, qs, T)
        ms, plain_ms, lib_ms = _ab_ms(
            lambda: fa._attention_cuda(q, k, v, kv_valid, qs, scale, name),
            lambda: fa.attention_plain(q, k, v, kv_valid, qs, scale),
            _sdpa(q, k, v, allowed, scale))
        print(f"kernel {name} B={B} T={T} S={S} qstart={qstart}: max|diff| {err:.3e}, "
              f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms [{card}]", flush=True)
        # reads q, k, v, the mask and qstart; writes out and the LSE
        nbytes = _nbytes(q, k, v, kv_valid, qs, out, lse)
        return _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh * nh * int(allowed.sum()))

    results = {}
    # K3: fresh prefill of 4 ragged prompts; suffix prefill on a prefix hit
    results["flash_attention_cached"] = flash_case("flash_attention_cached", 4, 512, 640, 0,
                                                   (512, 300, 450, 77))
    e2 = flash_case("flash_attention_cached", 4, 128, 768, 512, (576, 576, 560, 576))["max_abs_err"]
    results["flash_attention_cached"]["max_abs_err"] = max(
        results["flash_attention_cached"]["max_abs_err"], e2)
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
    valid = _decode_valid(lens, dstart, 580, S)
    ms, plain_ms, lib_ms = _ab_ms(
        lambda: rda.ragged_decode_attention(q, kc, vc, 1, lens, dstart, 580),
        lambda: rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, 580),
        _sdpa(q[:, None], kc[1].transpose(1, 2), vc[1].transpose(1, 2), valid[:, None, :],
              dh ** -0.5), timer=graph_ms)
    print(f"kernel ragged_decode_attention B={B} S={S} slot=580: max|diff| {err:.3e}, "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms [{card}]", flush=True)
    n_valid = int(valid.sum())  # the valid slots of one layer, summed over rows
    # K and V of the valid slots for each KV head; q, the lengths and out
    nbytes = 2 * n_valid * nkv * dh * 2 + 2 * _nbytes(q) + _nbytes(lens, dstart)
    results["ragged_decode_attention"] = _row(err, ms, plain_ms, lib_ms, nbytes,
                                              4 * dh * nh * n_valid)
    return results


def _lse_sinks(q, kc, lens, dstart, pstart, slot: int, scale: float, rng):
    """One sink per query head near its log-sum-exp over layer 1's valid
    slots (the mean over rows, + N(0, 0.3)): a sink counted more than once
    then moves the output (sinks of ±8 leave it to one side of the LSE)."""
    import numpy as np
    import torch

    B, nh, dh = q.shape
    nkv, S = kc.shape[2], kc.shape[3]
    k = kc[1].float()
    s = torch.einsum("bkgd,bksd->bkgs", q.float().reshape(B, nkv, nh // nkv, dh), k) * scale
    valid = _decode_valid(lens, dstart, slot, S, pstart)[:, None, None, :]
    lse = torch.logsumexp(torch.where(valid, s, -1e30), dim=-1).reshape(B, nh)
    noise = torch.from_numpy((rng.normal(size=nh) * 0.3).astype(np.float32)).to(q.device)
    return (lse.mean(0) + noise).contiguous()


def _q8_excess(out, ref) -> float:
    """How far K5's output exceeds its tolerance (> 0: the check fails)."""
    d = (out.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs()
    return float(d.max()) - Q8_ATOL


def _int4_library(x, leaf, group: int):
    """One PyTorch call computing K6's product: ``torch._weight_int4pack_mm``
    (tinygemm, bf16 x, w = (u - 8) * scale + zero per group) on the same
    nibbles, converted once outside the timed call, zeros 0. Its scales are
    rounded to bf16 and its output is bf16."""
    import torch

    from lapha_tpu_torch.models.quant import _unpack_int4

    u = (_unpack_int4(leaf["q"]).to(torch.int32) + 8).T.contiguous()  # (OUT, IN) in [1, 15]
    w = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    s = leaf["s4"].to(torch.bfloat16)
    sz = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()  # (IN/G, OUT, 2)
    xb = x.to(torch.bfloat16)
    return lambda: torch._weight_int4pack_mm(xb, w, group, sz)


def _decode_valid(lens, dstart, slot: int, S: int, pstart=None):
    """(B, S) bool: the slots a decode row attends, [pstart, lens) ∪ [dstart, slot]."""
    import torch

    ar = torch.arange(S, device=lens.device)[None, :]
    p0 = 0 if pstart is None else pstart[:, None]
    return ((ar >= p0) & (ar < lens[:, None])) | ((ar >= dstart[:, None]) & (ar <= slot))


def check_quant_kernels(dev, card):
    """Phase 1c: K5 (int8-cache ragged decode) and K6 (int4 dequant-matmul)
    vs their plain versions at the quantized serving path's shapes."""
    import numpy as np
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
    from lapha_tpu_torch.models import quant
    from lapha_tpu_torch.models.qwen2 import _quantize_kv
    from lapha_tpu_torch.ops import int4_matmul as i4
    from lapha_tpu_torch.ops import ragged_decode_attention as rda

    rng = np.random.default_rng(SEED + 6)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    nh, nkv, dh = 12, 2, 128

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    results = {}
    # K5: 48 decode rows over S=768, prompts of 512, decode columns 512..slot
    L, B, S, slot = 2, 48, 768, 700
    q = bf16(B, nh, dh)
    kq, ks = _quantize_kv(bf16(L, B, nkv, S, dh))
    vq, vs = _quantize_kv(bf16(L, B, nkv, S, dh))
    lens = torch.full((B,), 512, dtype=torch.int32, device=dev)
    dstart = torch.full((B,), 512, dtype=torch.int32, device=dev)
    lens[:6] = torch.from_numpy(rng.integers(64, 512, 6).astype(np.int32)).to(dev)
    err = 0.0
    for layer, sl in ((0, 512), (1, slot)):
        out = rda.ragged_decode_attention(q, kq, vq, layer, lens, dstart, sl, cache_scale=(ks, vs))
        ref = rda.ragged_decode_plain(q, kq, vq, layer, lens, dstart, sl, cache_scale=(ks, vs))
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()), "ragged_decode_attention_q8 finite")
        check(_q8_excess(out, ref) <= 0, f"ragged_decode_attention_q8 slot {sl}")
        err = max(err, float((out.float() - ref.float()).abs().max()))
    # the check sees the faults it is there for: each, planted through the
    # kernel's inputs, must fail it
    ref = rda.ragged_decode_plain(q, kq, vq, 1, lens, dstart, slot, cache_scale=(ks, vs))
    planted = {
        "V scales of the next slot": rda.ragged_decode_attention(
            q, kq, vq, 1, lens, dstart, slot, cache_scale=(ks, vs.roll(-1, dims=-1))),
        "the last prompt slot dropped": rda.ragged_decode_attention(
            q, kq, vq, 1, lens - 1, dstart, slot, cache_scale=(ks, vs)),
    }
    for what, bad in planted.items():
        excess = _q8_excess(bad, ref)
        check(excess > 0, f"ragged_decode_attention_q8 check missed a planted fault: {what}")
        print(f"planted K5 fault ({what}): max|diff| "
              f"{float((bad.float() - ref.float()).abs().max()):.3e}, caught", flush=True)
    ms, plain_ms, _ = _ab_ms(
        lambda: rda.ragged_decode_attention(q, kq, vq, 1, lens, dstart, slot, cache_scale=(ks, vs)),
        lambda: rda.ragged_decode_plain(q, kq, vq, 1, lens, dstart, slot, cache_scale=(ks, vs)),
        timer=graph_ms)
    print(f"kernel ragged_decode_attention_q8 B={B} S={S} slot={slot}: max|diff| {err:.3e}, "
          f"{ms:.4f} ms vs plain {plain_ms:.4f} ms [{card}]", flush=True)
    n_valid = int(_decode_valid(lens, dstart, slot, S).sum())
    # int8 K and V of the valid slots plus their two f32 scales, per KV head;
    # q, the lengths and out
    nbytes = n_valid * nkv * (2 * dh + 8) + 2 * _nbytes(q) + _nbytes(lens, dstart)
    results["ragged_decode_attention_q8"] = _row(err, ms, plain_ms, None, nbytes,
                                                 4 * dh * nh * n_valid)

    # K6: every projection of the model at 48 decode rows, and 512 rows.
    # Timed as CUDA-graph replays (bench_k6.graph_ms): at a few microseconds
    # a call, launches from Python would time the host.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, IN, OUT in ((48, 1536, 1536), (48, 1536, 256), (48, 1536, 8960), (48, 8960, 1536),
                       (512, 1536, 8960)):
        x = bf16(B, IN)
        leaf = quant.quantize_weight_int4(torch.randn((IN, OUT), generator=gen, device=dev), 128)
        out = i4.int4_matmul(x, leaf["q"], leaf["s4"])
        again = i4.int4_matmul(x, leaf["q"], leaf["s4"])
        ref = i4.int4_matmul_plain(x, leaf["q"], leaf["s4"])
        lib = _int4_library(x, leaf, 128)
        lib_out = lib()
        torch.cuda.synchronize()
        err, top = float((out - ref).abs().max()), float(ref.abs().max())
        check(bool(torch.isfinite(out).all()) and err <= INT4_RTOL * top,
              f"int4_matmul {B}x{IN}->{OUT}: max|diff| {err} vs max|plain| {top}")
        # the partial sums of the split in-dim are added in a fixed order
        check(torch.equal(out, again), f"int4_matmul {B}x{IN}->{OUT}: two launches differ")
        plan = i4.split_plan(B, IN, OUT, 128, sms)
        splits = plan.splits
        fault = ""
        if splits > 1:
            # a split dropped: its group pairs' scale rows zeroed, the kernel
            # gives the sum of the other splits; the check must fail it
            p0, p1 = i4.split_pairs(IN // 256, splits)[1]
            s_bad = leaf["s4"].clone()
            s_bad[p0:p1] = 0
            s_bad[IN // 256 + p0:IN // 256 + p1] = 0
            bad = i4.int4_matmul(x, leaf["q"], s_bad)
            torch.cuda.synchronize()
            bad_err = float((bad - ref).abs().max())
            check(bad_err > INT4_RTOL * top,
                  f"int4_matmul {B}x{IN}->{OUT}: the check missed a planted fault (split 1 dropped)")
            fault = f"; planted fault (split 1 of {splits} dropped) max|diff| {bad_err:.3e}, caught"
            del bad, s_bad
        # the library call computes the same product up to its bf16 scales
        # and bf16 output (2^-9 relative each)
        lib_err = float((lib_out.float() - ref).abs().max())
        check(lib_err <= 1e-2 * top, f"_weight_int4pack_mm {B}x{IN}->{OUT}: max|diff| {lib_err}")
        ms, plain_ms, lib_ms = _ab_ms(lambda: i4.int4_matmul(x, leaf["q"], leaf["s4"]),
                                      lambda: i4.int4_matmul_plain(x, leaf["q"], leaf["s4"]), lib,
                                      timer=graph_ms)
        # packed bytes, scales, x once; out once
        nbytes = _nbytes(leaf["q"], leaf["s4"], x, out)
        row = _row(err, ms, plain_ms, lib_ms, nbytes, 2 * B * IN * OUT)
        print(f"kernel int4_matmul {B}x{IN}->{OUT} ({plan.rows} rows, {plan.cols} columns, "
              f"{splits} splits, {plan.ctas(B, OUT)} CTAs): max|diff| {err:.3e} "
              f"(max|plain| {top:.3e}), bit-equal over two launches, {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, _weight_int4pack_mm {lib_ms:.4f} ms (max|diff| {lib_err:.3e}), "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}){fault} [{card}]", flush=True)
        if (B, IN, OUT) == (48, 1536, 8960):  # the table keeps the decode gate/up shape
            results["int4_matmul"] = row
    return results


def _grouped_library(xs, w, gs):
    """One PyTorch call computing K8's product, ``torch._grouped_mm`` on the
    same bf16 tensors with the int32 cumulative group ends (bf16 output);
    (fn, None), or (None, the first line of its refusal)."""
    import torch

    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        fn = lambda: torch._grouped_mm(xs, w, offs=offs)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:  # the yardstick only: K8 itself is checked above
        return None, (str(e).strip().splitlines() or [type(e).__name__])[0]


def _moe_cfg():
    """Qwen1.5-MoE-A2.7B's published config.json (HF Qwen/Qwen1.5-MoE-A2.7B)."""
    import torch

    from lapha_tpu_torch.models import qwen2

    return qwen2.Qwen2Config(
        vocab_size=151936, hidden_size=2048, intermediate_size=5632, num_hidden_layers=24,
        num_attention_heads=16, num_key_value_heads=16, max_position_embeddings=8192,
        rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=False, attention_bias=True,
        num_experts=60, num_experts_per_tok=4, moe_intermediate_size=1408,
        shared_expert_intermediate_size=5632, norm_topk_prob=False, dtype=torch.bfloat16)


# phase 1d's decode rows: (the kernels line's row, label, tokens, top-k,
# experts, K, N); 24 decode tokens of the MoE models phases 10, 11 and 15
# serve, each projection's experts at full width
GG_DECODE_ROWS = (
    ("grouped_gemm", "Qwen1.5-MoE decode gate/up", 24, 4, 60, 2048, 1408),
    ("grouped_gemm_qwen_down", "Qwen1.5-MoE decode down", 24, 4, 60, 1408, 2048),
    ("grouped_gemm_gptoss", "GPT-OSS-20B decode gate_up", 24, 4, 32, 2880, 5760),
    ("grouped_gemm_gptoss_down", "GPT-OSS-20B decode down", 24, 4, 32, 2880, 2880),
    ("grouped_gemm_deepseek", "DeepSeek-V2-Lite decode gate/up", 24, 6, 64, 2048, 1408),
    ("grouped_gemm_deepseek_down", "DeepSeek-V2-Lite decode down", 24, 6, 64, 1408, 2048),
)


def _gg_case(dev, card, label, xs, w, gs, kernel, graph: bool):
    """One K8 forward at its shape: counted under the host's pick, checked
    against the plain version (and, where ``graph``, two launches bit-equal),
    timed in turns beside ``torch._grouped_mm`` (the kernel and the library
    as CUDA-graph replays where ``graph``: the plain version reads the group
    sizes to the host and is event-timed); the kernels line's row."""
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import grouped_gemm as gg

    M, K = xs.shape
    G, _, N = w.shape
    check(gg.forward_kernel(M, G, N, w.data_ptr()) == kernel,
          f"grouped_gemm {label}: the host's rule picked "
          f"{gg.forward_kernel(M, G, N, w.data_ptr())}, not {kernel}")
    before = _cuda.LAUNCHES[kernel]
    out = gg.grouped_gemm(xs, w, gs)
    ref = gg.grouped_gemm_plain(xs, w, gs)
    torch.cuda.synchronize()
    check(_cuda.LAUNCHES[kernel] == before + 1, f"grouped_gemm {label}: {kernel} not counted")
    err, top = float((out - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(out).all()) and err <= GG_RTOL * top,
          f"{kernel} {label} M={M} {K}->{N}: max|diff| {err} vs max|plain| {top}")
    if graph:  # every output element is written by one thread in a fixed order
        check(torch.equal(gg.grouped_gemm(xs, w, gs), out),
              f"{kernel} {label}: two launches differ")
    lib, refusal = _grouped_library(xs, w, gs)
    lib_note = f"_grouped_mm refused: {refusal}"
    if lib is not None:
        lib_err = float((lib().float() - ref).abs().max())
        if lib_err > 1e-2 * top:  # bf16 output: 2^-9 relative
            lib, lib_note = None, f"_grouped_mm disagrees: max|diff| {lib_err:.3e}"
        else:
            lib_note = f"_grouped_mm max|diff| {lib_err:.3e}"
    ms, plain_ms, lib_ms = _ab_ms(lambda: gg.grouped_gemm(xs, w, gs),
                                  lambda: gg.grouped_gemm_plain(xs, w, gs), lib,
                                  timer=graph_ms if graph else _time_ms, plain_timer=_time_ms)
    touched = int((gs > 0).sum())
    # x once, the weights of the experts that receive rows, out once
    nbytes = _nbytes(xs, gs, out) + touched * K * N * w.element_size()
    row = _row(err, ms, plain_ms, lib_ms, nbytes, 2 * M * K * N)
    plan = (f"{gg.decode_grid(M, G, N, _cuda.sm_count(xs.device))} CTAs, "
            if kernel == "grouped_gemm" else "")
    print(f"kernel {kernel} {label}: M={M} {K}->{N} over {G} experts ({touched} with rows; "
          f"group sizes min {int(gs.min())} max {int(gs.max())}), {plan}max|diff| {err:.3e} "
          f"(max|plain| {top:.3e}){', bit-equal over two launches' if graph else ''}, "
          f"{ms:.4f} ms{' (graph replays)' if graph else ''} vs plain {plain_ms:.4f} ms, library "
          f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'} ({lib_note}), bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; {ms / row['bound_ms']:.2f}x) [{card}]",
          flush=True)
    return row


def check_grouped_gemm(dev, card):
    """Phase 1d: K8 vs its plain version at the MoE path's shapes."""
    import torch

    from lapha_tpu_torch.ops import moe
    from lapha_tpu_torch.ops import grouped_gemm as gg

    t_phase = time.perf_counter()
    cfg = _moe_cfg()
    H, E, k, Im = cfg.hidden_size, cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_intermediate_size
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)

    def bf16(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    router = bf16(H, E, scale=0.02)  # the model's router init
    w_gu, w_down = bf16(E, H, Im, scale=H ** -0.5), bf16(E, Im, H, scale=Im ** -0.5)

    def routed_rows(tokens):
        """Top-4 routing of random hidden states: the sorted gathered rows
        and the group sizes, as moe_ffn_gather forms them."""
        x = bf16(tokens, H)
        _, topi = moe.route(x, router, k, False)
        flat = topi.reshape(-1).long()
        order = torch.argsort(flat, stable=True)
        gs = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))
        return x.index_select(0, order // k), gs

    results = {}
    xs_dec, gs_dec = routed_rows(24)
    xs_pre, gs_pre = routed_rows(4 * 512)
    xs_train, gs_train = routed_rows(8 * 1024)
    # Qwen1.5-MoE's down rows take the gate/up rows' routing, as in the layer
    qwen = {"gate/up": (xs_dec, w_gu, gs_dec), "down": (bf16(xs_dec.shape[0], Im), w_down, gs_dec)}
    # the decode kernel at the served MoE models' decode products
    for row_name, label, tokens, top, experts, K, N in GG_DECODE_ROWS:
        if label.startswith("Qwen1.5-MoE"):  # the model's own router (phase 10's)
            xs, w, gs = qwen[label.split()[-1]]
        else:
            xs, gs = _routed_rows(dev, gen, tokens, K if K != 1408 else 2048, experts, top, ())
            w = bf16(experts, K, N, scale=K ** -0.5)
        if xs.shape[1] != K:  # the down projection: rows of the expert width
            xs = bf16(xs.shape[0], K)
        results[row_name] = _gg_case(dev, card, label, xs, w, gs, "grouped_gemm", True)
        ref = gg.grouped_gemm_plain(xs, w, gs)
        top_ref = float(ref.abs().max())
        # the limit's reach: the ring's second 64-row stage counted twice
        w_bad = w.clone()
        w_bad[:, 64:128] *= 2
        bad = gg.grouped_gemm(xs, w_bad, gs)
        torch.cuda.synchronize()
        bad_err = float((bad - ref).abs().max())
        check(bad_err > GG_RTOL * top_ref,
              f"the grouped_gemm check missed a planted fault ({label}: k rows 64-127 twice)")
        print(f"planted K8 fault on grouped_gemm ({label}; the stage of k rows [64, 128) counted "
              f"twice): max|diff| {bad_err:.3e} (limit {GG_RTOL * top_ref:.3e}), caught", flush=True)
        del w_bad, bad, xs, w, gs, ref
        torch.cuda.empty_cache()

    results["grouped_gemm_wg"] = _gg_case(dev, card, "prefill gate/up", xs_pre, w_gu, gs_pre,
                                          "grouped_gemm_wg", False)
    results["grouped_gemm_wg_train"] = _gg_case(dev, card, "training gate/up", xs_train, w_gu,
                                                gs_train, "grouped_gemm_wg", False)
    # the check sees the fault it is there for, on both kernels: the last
    # row of the first non-empty group handed to the next expert
    for label, (xs, w, gs) in (("decode gate/up", qwen["gate/up"]),
                               ("prefill gate/up", (xs_pre, w_gu, gs_pre))):
        shifted = gs.clone()
        first = int(torch.nonzero(gs)[0])
        shifted[first] -= 1
        shifted[(first + 1) % len(gs)] += 1
        ref = gg.grouped_gemm_plain(xs, w, gs)
        bad = gg.grouped_gemm(xs, w, shifted)
        torch.cuda.synchronize()
        bad_err, top = float((bad - ref).abs().max()), float(ref.abs().max())
        kernel = gg.forward_kernel(xs.shape[0], E, w.shape[-1], w.data_ptr())
        check(bad_err > GG_RTOL * top, f"the {kernel} check missed a planted fault ({label})")
        print(f"planted K8 fault on {kernel} ({label}; group sizes shifted by one row): max|diff| "
              f"{bad_err:.3e} (limit {GG_RTOL * top:.3e}), caught", flush=True)
    print(f"phase 1d took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def _routed_rows(dev, gen, tokens: int, H: int, E: int, k: int, empty):
    """Top-k routing of random hidden states through a random router, the
    router columns of the experts ``empty`` at -inf (they get no rows):
    the gathered pair rows (tokens x k, H) in expert order and the group
    sizes (E,) int32, as moe_ffn_gather forms them."""
    import torch

    x = torch.randn((tokens, H), generator=gen, device=dev).to(torch.bfloat16)
    router = (torch.randn((H, E), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    logits = x.float() @ router.float()
    logits[:, list(empty)] = float("-inf")
    flat = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    order = torch.argsort(flat, stable=True)
    gs = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))
    return x.index_select(0, order // k), gs


def _bf16_excess(out, ref) -> tuple[float, float]:
    """(max over elements of |out - ref| - 2^-8 |ref|, the limit GG_RTOL ·
    max |ref|): a bf16 output against its plain version in f32, the store's
    rounding (at most 2^-8 of an element) taken out."""
    ref = ref.float()
    excess = float(((out.float() - ref).abs() - 2.0 ** -8 * ref.abs()).max())
    return excess, GG_RTOL * float(ref.abs().max())


def _empty_tiles_zero(dw, gs) -> bool:
    """Every expert without rows has an all-zero dW (NaN fails it)."""
    empty = (gs == 0).nonzero().flatten()
    return bool((dw[empty] == 0).all())


# phase 1g's shapes: (model, tokens, H, experts, expert width, experts forced
# empty, top-k, the kernels line's rows' suffix); the pair rows are tokens x
# top-k. The first shape's rows are the table's own; DeepSeek-V2-Lite's
# 64-expert top-6 gate/up has rows of its own.
GG_BWD_CASES = (("Qwen1.5-MoE", 8 * 1024, 2048, 60, 1408, (3, 17), 4, ""),
                ("GPT-OSS", 4 * 1024, 2880, 32, 2880, (5, 20), 4, ""),
                ("DeepSeek-V2-Lite", 8 * 1024, 2048, 64, 1408, (), 6, "_ds"))


def check_grouped_gemm_backward(dev, card, cases=GG_BWD_CASES):
    """Phase 1g: K8's backward (dX, grouped_gemm_dx; dW, grouped_gemm_tgmm)
    against its plain versions (f32, on the same bf16 dY) at the training
    shapes of Qwen1.5-MoE-A2.7B (8 x 1024 tokens x top-4 = 32768 pair rows
    over 60 experts; gate/up 2048 -> 1408, down 1408 -> 2048) and GPT-OSS-20B
    (4 x 1024 x top-4 = 16384 over 32; gate_up 2880 -> 5760, down 2880 ->
    2880), group sizes from top-4 routing with two experts forced empty;
    each timed in turns beside torch._grouped_mm. Planted faults: group
    sizes shifted by one row, and a dW whose empty experts' tiles keep the
    NaN the output held (a kernel that skips them)."""
    import torch

    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import grouped_gemm as gg

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def bf16(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    results = {}
    for model, tokens, H, E, Im, empty, top_k, suffix in cases:
        xs_h, gs = _routed_rows(dev, gen, tokens, H, E, top_k, empty)
        check(int(gs.sum()) == tokens * top_k and int(gs[list(empty)].sum()) == 0,
              f"{model}: routing {gs.tolist()}")
        up = 2 * Im if model == "GPT-OSS" else Im  # GPT-OSS's fused gate|up
        for label, xs, K, N in ((f"{model} gate/up", xs_h, H, up),
                                (f"{model} down", bf16(tokens * top_k, Im), Im, H)):
            M = xs.shape[0]
            first = not results  # the first shape: the planted faults
            # the model's gate/up is its rows' timed shape
            table = (first or (suffix and label.endswith("gate/up")))
            dy, w = bf16(M, N), bf16(E, K, N, scale=K ** -0.5)
            before = dict(_cuda.LAUNCHES)
            dx = gg.grouped_gemm_dx_cuda(dy, w, gs)
            dw = gg.grouped_gemm_tgmm_cuda(xs, dy, gs, out=torch.full_like(w, float("nan")))
            dw2 = gg.grouped_gemm_tgmm_cuda(xs, dy, gs)
            for name, n in (("grouped_gemm_dx", 1), ("grouped_gemm_tgmm", 2)):
                check(_cuda.LAUNCHES[name] == before[name] + n, f"{name} {label}: not counted")
            ref_dx = gg.grouped_gemm_dx_plain(dy.float(), w.float(), gs)
            ref_dw = gg.grouped_gemm_tgmm_plain(xs.float(), dy.float(), gs)
            torch.cuda.synchronize()
            (ex_dx, lim_dx), (ex_dw, lim_dw) = _bf16_excess(dx, ref_dx), _bf16_excess(dw, ref_dw)
            check(bool(torch.isfinite(dx.float()).all()) and ex_dx <= lim_dx,
                  f"grouped_gemm_dx {label}: excess {ex_dx} vs limit {lim_dx}")
            check(bool(torch.isfinite(dw.float()).all()) and ex_dw <= lim_dw,
                  f"grouped_gemm_tgmm {label}: excess {ex_dw} vs limit {lim_dw}")
            check(_empty_tiles_zero(dw, gs), f"grouped_gemm_tgmm {label}: an empty expert's dW")
            check(torch.equal(dw, dw2), f"grouped_gemm_tgmm {label}: two launches differ")
            del dw2
            err_dx = float((dx.float() - ref_dx).abs().max())
            err_dw = float((dw.float() - ref_dw).abs().max())
            if first:
                # planted faults: the last row of the first non-empty group
                # handed to the next expert; the empty tiles left unwritten
                shifted = gs.clone()
                g0 = int(torch.nonzero(gs)[0])
                shifted[g0] -= 1
                shifted[(g0 + 1) % E] += 1
                bad_dx = gg.grouped_gemm_dx_cuda(dy, w, shifted)
                bad_dw = gg.grouped_gemm_tgmm_cuda(xs, dy, shifted)
                skipped = dw.clone()
                skipped[(gs == 0).nonzero().flatten()] = float("nan")
                torch.cuda.synchronize()
                check(_bf16_excess(bad_dx, ref_dx)[0] > lim_dx,
                      "the grouped_gemm_dx check missed a planted fault (group sizes shifted)")
                check(_bf16_excess(bad_dw, ref_dw)[0] > lim_dw,
                      "the grouped_gemm_tgmm check missed a planted fault (group sizes shifted)")
                check(not _empty_tiles_zero(skipped, gs),
                      "the empty-tile check missed a planted fault (tiles left as NaN)")
                print(f"planted K8-bwd faults (group sizes shifted by one row: dX excess "
                      f"{_bf16_excess(bad_dx, ref_dx)[0]:.3e}, dW excess "
                      f"{_bf16_excess(bad_dw, ref_dw)[0]:.3e}; empty experts' tiles left as NaN): "
                      f"caught", flush=True)
                del bad_dx, bad_dw, skipped
            for name, kernel, plain, lib_args, ref, nbytes in (
                    ("grouped_gemm_dx", lambda: gg.grouped_gemm_dx_cuda(dy, w, gs),
                     lambda: gg.grouped_gemm_dx_plain(dy, w, gs), (dy, w.transpose(1, 2)),
                     ref_dx,
                     # dy once, the weights of the experts with rows, dX once
                     _nbytes(dy, gs, dx) + int((gs > 0).sum()) * K * N * w.element_size()),
                    ("grouped_gemm_tgmm", lambda: gg.grouped_gemm_tgmm_cuda(xs, dy, gs),
                     lambda: gg.grouped_gemm_tgmm_plain(xs, dy, gs), (xs.t(), dy),
                     ref_dw, _nbytes(xs, dy, gs, dw))):
                lib, refusal = _grouped_library(*lib_args, gs)
                lib_note = f"_grouped_mm refused: {refusal}"
                if lib is not None:
                    lib_err = float((lib().float() - ref).abs().max())
                    if lib_err > 1e-2 * float(ref.abs().max()):  # bf16 output
                        lib, lib_note = None, f"_grouped_mm disagrees: max|diff| {lib_err:.3e}"
                    else:
                        lib_note = f"_grouped_mm max|diff| {lib_err:.3e}"
                ms, plain_ms, lib_ms = _ab_ms(kernel, plain, lib)
                err = err_dx if name == "grouped_gemm_dx" else err_dw
                row = _row(err, ms, plain_ms, lib_ms, nbytes, 2 * M * K * N)
                print(f"kernel {name} {label}: M={M} K={K} N={N} over {E} experts (group sizes "
                      f"min {int(gs.min())} max {int(gs.max())}): max|diff| {err:.3e} (max|plain| "
                      f"{float(ref.abs().max()):.3e}), {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                      f"library {'null' if lib_ms is None else f'{lib_ms:.4f} ms'} ({lib_note}), "
                      f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{card}]", flush=True)
                if table:  # the table keeps the first shape and DeepSeek's gate/up
                    results[name + suffix] = row
                else:
                    results[name + suffix]["max_abs_err"] = max(
                        results[name + suffix]["max_abs_err"], err)
            del dy, w, dx, dw, ref_dx, ref_dw
        del xs_h
        torch.cuda.empty_cache()
    print(f"phase 1g took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def _k2_repeats(args, got) -> None:
    """K2 launched again on the same arguments gives dq, dk and dv bit-equal
    to ``got`` (the dk/dv kernel's group split adds its partials in a fixed
    order, and nothing is summed with atomics)."""
    import torch

    from lapha_tpu_torch.ops import flash_attention as fa

    again = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
    torch.cuda.synchronize()
    q = args[0]
    what = f"K2 q {tuple(q.shape)}, KV heads {args[1].shape[2]}, args {args[8:]}"
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{what}: two launches differ")


def _k1_repeats(launch, out, lse, what) -> None:
    """The forward launched again (``launch`` gives (out, LSE)) is bit-equal
    to ``out`` and ``lse``: each CTA writes its own rows and nothing is
    summed across CTAs."""
    import torch

    again, lse_again = launch()
    torch.cuda.synchronize()
    check(torch.equal(out, again) and torch.equal(lse, lse_again),
          f"{what}: two launches differ")


def _bwd_close(got, ref) -> tuple[float, list]:
    """(worst |diff| / limit over dq, dk, dv; the max |diff| of each), the
    limit being phase 1b's BWD_RTOL · max|plain| + BWD_ATOL; inf where the
    kernel wrote a non-finite value."""
    import torch

    worst, errs = 0.0, []
    for a, b in zip(got, ref):
        a, b = a.float(), b.float()
        err = float((a - b).abs().max()) if bool(torch.isfinite(a).all()) else math.inf
        worst = max(worst, err / (BWD_RTOL * float(b.abs().max()) + BWD_ATOL))
        errs.append(err)
    return worst, errs


def check_backward_window_kernels(dev, card, B=4, T=1024):
    """Phase 1h: K2 at head dim 64 (GPT-OSS's 64/8 heads), B=4 T=1024 with
    ragged masks and a hole, W = 128 and W = 0, the sinks folded into the
    forward's (out, LSE) as the autograd backward gives them to K2; phase
    1b's limits. A window off by one (W + 1, on the same out and LSE) must
    fail the check. Timed in turns beside SDPA's backward with the banded
    boolean mask (no sinks: one PyTorch call takes none)."""
    import numpy as np
    import torch

    from lapha_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 21)
    nh, nkv, dh = 64, 8, 64
    lens = (T, (700 * T) // 1024, (1000 * T) // 1024, (333 * T) // 1024)[:B]
    scale = dh ** -0.5

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)

    results = {}
    sinks = torch.from_numpy(_gptoss_sinks(rng, nh)).to(dev)
    for W in (128, 0):
        q, do = bf16(B, T, nh, dh), bf16(B, T, nh, dh)
        k, v = bf16(B, T, nkv, dh), bf16(B, T, nkv, dh)
        mask = (torch.arange(T, device=dev)[None, :]
                < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)
        mask[0, 100:140] = 0  # a hole of invalid keys
        qs = torch.zeros(B, dtype=torch.int32, device=dev)
        out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", W)
        out, lse = fa._sink_fold(out, lse, sinks)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, mask, qs, lse, do, delta, scale, W)
        got = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
        _k2_repeats(args, got)
        ref = fa.attention_bwd_plain(*args)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all()) for t in got), f"K2 dh 64 W={W} finite")
        worst, errs = _bwd_close(got, ref)
        check(worst <= 1.0, f"K2 dh 64 W={W}: max|diff| (dq, dk, dv) {errs}, {worst:.3f} of "
                            "the limit")
        label = f"dh=64 64/8 heads B={B} T={T} W={W}, sinks folded"
        fault = ""
        if W:
            bad_args = args[:-1] + (W + 1,)
            bad = (fa.attention_bwd_dq_cuda(*bad_args), *fa.attention_bwd_dkv_cuda(*bad_args))
            torch.cuda.synchronize()
            bad_worst, _ = _bwd_close(bad, ref)
            check(bad_worst > 1.0, "the windowed K2 check missed a planted fault (W + 1)")
            fault = f"; planted fault (window W + 1) {bad_worst:.2f} of the limit, caught"
            del bad
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        allowed = _allowed(mask, qs, T, W)
        lib_out = _sdpa(*leaves, allowed, scale)()

        def lib():
            return torch.autograd.grad(lib_out, leaves, do.transpose(1, 2), retain_graph=True)

        ms_dq, pms_dq, lib_ms = _ab_ms(lambda: fa.attention_bwd_dq_cuda(*args),
                                       lambda: fa.attention_bwd_dq_plain(*args), lib)
        ms_kv, pms_kv, _ = _ab_ms(lambda: fa.attention_bwd_dkv_cuda(*args),
                                  lambda: fa.attention_bwd_dkv_plain(*args))
        print(f"kernel flash_attention_bwd {label}: max|diff| dq {errs[0]:.3e} dk {errs[1]:.3e} "
              f"dv {errs[2]:.3e} ({worst:.2f} of the limit); dq {ms_dq:.4f} ms vs plain "
              f"{pms_dq:.4f} ms, dk/dv {ms_kv:.4f} ms vs plain {pms_kv:.4f} ms, sdpa backward "
              f"(banded boolean mask; dq, dk, dv) {lib_ms:.4f} ms{fault} [{card}]", flush=True)
        if W:  # the table's rows: the windowed launches
            pairs = nh * int(allowed.sum())
            reads = _nbytes(q, k, v, do, mask, qs, lse, delta)
            results["flash_attention_bwd_dq_window"] = _row(
                errs[0], ms_dq, pms_dq, lib_ms, reads + _nbytes(got[0]), 6 * dh * pairs)
            results["flash_attention_bwd_dkv_window"] = _row(
                max(errs[1:]), ms_kv, pms_kv, lib_ms, reads + _nbytes(got[1], got[2]),
                8 * dh * pairs)
        del leaves, lib_out, got, ref
    print(f"phase 1h took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


# phase 1i's cases: (label, heads, KV heads, head dim, window, softcap, the
# kernels line's row suffix or None for a case only printed). The rows take
# the windows of the path (Gemma-2's 4096, which does not bite at T=1024;
# Gemma-3's 512); W=128 makes Gemma-2's band bite for the check.
K2_GEMMA_CASES = (("Gemma-2", 8, 4, 256, 0, GEMMA_CAP, "_softcap"),
                  ("Gemma-2", 8, 4, 256, 4096, GEMMA_CAP, "_window_softcap"),
                  ("Gemma-2", 8, 4, 256, 128, GEMMA_CAP, None),
                  ("Gemma-3", 4, 1, 256, 512, 0.0, "_window_dh256"),
                  ("Gemma-3", 4, 1, 256, 0, 0.0, "_dh256"),
                  ("softcap at dh 128", 12, 2, 128, 0, GEMMA_CAP, None),
                  ("softcap at dh 64", 64, 8, 64, 0, GEMMA_CAP, None))


def check_backward_gemma_kernels(dev, card):
    """Phase 1i: K2 at head dim 256 (Gemma-2's 8/4 heads with the softcap of
    50: full, at its own W=4096 and with a biting band W=128; Gemma-3's 4/1
    heads at W=512 and full) and with the softcap at dh 128 (12/2) and dh 64
    (64/8), B=4 T=1024 with ragged masks and a hole, against the plain
    backward on the same bf16 inputs and the forward kernel's (out, LSE):
    phase 1b's limits. With the softcap q is scaled x25, so that the scaled
    logits reach 1-3x the cap; the kernels run without the softcap, and with
    a window off by one where the band bites, on the same out and LSE
    (planted faults) must fail the check.
    Timed in turns beside the plain version and, for the kernels line's
    rows, one library call: SDPA's backward (banded boolean mask) for the
    cap-free shapes, the compiled flex_attention's backward (the softcap as
    its score_mod) for the capped ones, which is first held to the plain
    version at the same limits on the rows that see a key."""
    import numpy as np
    import torch

    from lapha_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 25)
    B, T = 4, 1024
    lens = (T, 700, 1000, 333)
    results = {}
    for fam, nh, nkv, dh, W, cap, row in K2_GEMMA_CASES:
        scale = 1.0 / 16 if dh == 256 else dh ** -0.5  # Gemma's query_pre_attn_scalar 256

        def bf16(*shape, sd=1.0):
            return torch.from_numpy((rng.normal(size=shape) * sd).astype(np.float32)).to(
                dev, torch.bfloat16)

        q, do = bf16(B, T, nh, dh, sd=25.0 if cap else 1.0), bf16(B, T, nh, dh)
        k, v = bf16(B, T, nkv, dh), bf16(B, T, nkv, dh)
        mask = (torch.arange(T, device=dev)[None, :]
                < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)
        mask[0, 100:140] = 0  # a hole of invalid keys
        qs = torch.zeros(B, dtype=torch.int32, device=dev)
        out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", W, cap)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, mask, qs, lse, do, delta, scale, W, cap)
        got = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
        _k2_repeats(args, got)
        ref = fa.attention_bwd_plain(*args)
        torch.cuda.synchronize()
        worst, errs = _bwd_close(got, ref)
        label = f"dh={dh} {nh}/{nkv} heads ({fam}) B={B} T={T} W={W} softcap={cap}"
        check(worst <= 1.0, f"K2 {label}: max|diff| (dq, dk, dv) {errs}, {worst:.3f} of the "
                            "limit")
        notes = []
        faults = ([("softcap off", args[:-1] + (0.0,))] if cap else []) + (
            [("window W + 1", args[:-2] + (W + 1, cap))] if 0 < W < T else [])
        for what, bad_args in faults:
            bad = (fa.attention_bwd_dq_cuda(*bad_args), *fa.attention_bwd_dkv_cuda(*bad_args))
            torch.cuda.synchronize()
            bad_worst, _ = _bwd_close(bad, ref)
            check(bad_worst > 1.0, f"the K2 {label} check missed a planted fault ({what})")
            notes.append(f"planted fault ({what}) {bad_worst:.3g} of the limit, caught")
            del bad
        allowed = _allowed(mask, qs, T, W)
        if cap:
            s_max = float(max((torch.einsum("bthd,bshd->bhts", q[:, :, g::nh // nkv].float(),
                                            k.float()) * scale).abs().max()
                              for g in range(nh // nkv)))
            check(s_max > cap, f"K2 {label}: max|scaled logit| {s_max} does not reach the cap")
            notes.insert(0, f"max|scaled logit| {s_max:.1f} before the cap")
        # the library yardstick for the kernels line's rows (each other shape
        # would cost flex_attention another compile)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        lib, lib_out, lib_name = None, None, "no library call timed"
        if row is not None and cap:
            # rows that see no key are zeros of the kernels and the library's
            # own choice: their cotangent is zero, their dq not compared
            seen = allowed.any(-1)[:, :, None, None]
            lib_out, gout = _flex_softcap(*leaves, allowed, scale, cap)(), do * seen
            lib_name = "flex_attention backward (softcap score_mod)"
        elif row is not None:
            lib_out, gout = _sdpa(*leaves, allowed, scale)(), do.transpose(1, 2)
            lib_name = "sdpa backward" + (" (banded boolean mask)" if W else "")
        if lib_out is not None:
            def lib():
                return torch.autograd.grad(lib_out, leaves, gout, retain_graph=True)

        if lib_out is not None and cap:  # the yardstick computes the same function
            lib_dq, lib_dk, lib_dv = lib()
            lib_worst, lib_errs = _bwd_close((lib_dq * seen, lib_dk, lib_dv), ref)
            check(lib_worst <= 1.0, f"{lib_name} {label}: max|diff| {lib_errs} against the "
                                    "plain backward")
            lib_name += f" (dq, dk, dv; {lib_worst:.2f} of the limit)"
            del lib_dq, lib_dk, lib_dv
        ms_dq, pms_dq, lib_ms = _ab_ms(lambda: fa.attention_bwd_dq_cuda(*args),
                                       lambda: fa.attention_bwd_dq_plain(*args), lib)
        ms_kv, pms_kv, _ = _ab_ms(lambda: fa.attention_bwd_dkv_cuda(*args),
                                  lambda: fa.attention_bwd_dkv_plain(*args))
        pairs = nh * int(allowed.sum())
        reads = _nbytes(q, k, v, do, mask, qs, lse, delta)
        # dq recomputes S and dP and forms dQ: 3 products; dk/dv: S, dP, dV, dK
        row_dq = _row(errs[0], ms_dq, pms_dq, lib_ms, reads + _nbytes(got[0]), 6 * dh * pairs)
        row_kv = _row(max(errs[1:]), ms_kv, pms_kv, lib_ms, reads + _nbytes(got[1], got[2]),
                      8 * dh * pairs)
        print(f"kernel flash_attention_bwd {label}: max|diff| dq {errs[0]:.3e} dk {errs[1]:.3e} "
              f"dv {errs[2]:.3e} ({worst:.2f} of the limit); dq {ms_dq:.4f} ms (bound "
              f"{row_dq['bound_ms']:.4f}, {row_dq['bound_by']}) vs plain {pms_dq:.4f} ms, dk/dv "
              f"{ms_kv:.4f} ms (bound {row_kv['bound_ms']:.4f}) vs plain {pms_kv:.4f} ms, "
              f"{lib_name}{'' if lib_ms is None else f' {lib_ms:.4f} ms'}; "
              f"{'; '.join(notes) or 'no planted fault'} [{card}]", flush=True)
        if row is not None:
            results["flash_attention_bwd_dq" + row] = row_dq
            results["flash_attention_bwd_dkv" + row] = row_kv
        del leaves, lib_out, got, ref
    print(f"phase 1i took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def _gptoss_sinks(rng, nh: int):
    """Sink logits of alternating sign, large against the logits' LSE (~6 at
    these lengths): each head's output depends on its own sink, so a sink
    taken from the wrong head fails the kernel checks."""
    import numpy as np

    return (rng.normal(size=nh) + np.where(np.arange(nh) % 2 == 0, 8.0, -8.0)).astype(np.float32)


def check_gptoss_kernels(dev, card):
    """Phase 1e: the attention-sink decode entries (K5s, bf16 and int8
    caches) at dh 64 (GPT-OSS, 64/8 heads) and dh 128 (12/2), window-clipped
    ranges on half the rows, and the windowed flash kernels (K3 at qstart
    512 / T=64 and at T=512, K1 at T=512, W=128, dh 64), each against its
    plain version, timed in turns; planted faults (sinks of the next head,
    a window off by one) must fail the checks."""
    import numpy as np
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
    from lapha_tpu_torch.models.qwen2 import _quantize_kv
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import flash_attention as fa
    from lapha_tpu_torch.ops import ragged_decode_attention as rda

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 13)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    W = 128

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    results = {}
    # K5s: 24 decode rows over S=640, prompts up to 512, decode columns from 512
    L, B, S, slot = 2, 24, 640, 600
    for dh, nh, nkv in ((64, 64, 8), (128, 12, 2)):
        q = bf16(B, nh, dh)
        kc, vc = bf16(L, B, nkv, S, dh), bf16(L, B, nkv, S, dh)
        (kq, ks), (vq, vs) = _quantize_kv(kc), _quantize_kv(vc)
        lens = torch.from_numpy(rng.integers(64, 513, B).astype(np.int32)).to(dev)
        pos = lens + (slot - 512)
        odd = torch.arange(B, device=dev) % 2 == 1  # odd rows: a windowed layer's ranges
        pstart = torch.where(odd, torch.minimum(torch.clamp(pos - (W - 1), min=0), lens),
                             torch.zeros_like(lens)).to(torch.int32)
        dstart = torch.where(odd, torch.full_like(lens, max(512, slot - (W - 1))),
                             torch.full_like(lens, 512)).to(torch.int32)
        sinks = torch.from_numpy(_gptoss_sinks(rng, nh)).to(dev)
        n_valid = int(_decode_valid(lens, dstart, slot, S, pstart).sum())
        for name, kk, vv, scl in (("ragged_decode_attention_sink", kc, vc, None),
                                  ("ragged_decode_attention_q8_sink", kq, vq, (ks, vs))):
            def kernel(sk=sinks, kk=kk, vv=vv, scl=scl):
                return rda.ragged_decode_attention(q, kk, vv, 1, lens, dstart, slot, pstart,
                                                   cache_scale=scl, sinks=sk)

            def plain(kk=kk, vv=vv, scl=scl):
                return rda.ragged_decode_plain(q, kk, vv, 1, lens, dstart, slot, pstart,
                                               cache_scale=scl, sinks=sinks)

            def excess(out, ref, scl=scl):
                if scl is not None:
                    return _q8_excess(out, ref)
                return float((out.float() - ref.float()).abs().max()) - KERNEL_ATOL

            out, ref = kernel(), plain()
            bad = kernel(sk=sinks.roll(-1).contiguous())
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.float()).all()) and excess(out, ref) <= 0,
                  f"{name} dh {dh}: max|diff| {float((out.float() - ref.float()).abs().max())}")
            check(excess(bad, ref) > 0, f"the {name} check missed a planted fault "
                                        "(sinks of the next head)")
            err = float((out.float() - ref.float()).abs().max())
            ms, plain_ms, _ = _ab_ms(kernel, plain, timer=graph_ms)
            # K and V of the valid slots per KV head (int8: + two f32 scales),
            # q, the sinks, the ranges and out
            per_slot = 2 * dh * (1 if scl is not None else 2) + (8 if scl is not None else 0)
            nbytes = n_valid * nkv * per_slot + 2 * _nbytes(q) + _nbytes(sinks, lens, dstart, pstart)
            row = _row(err, ms, plain_ms, None, nbytes, 4 * dh * nh * n_valid)
            print(f"kernel {name} dh={dh} {nh}/{nkv} heads B={B} S={S} slot={slot} (window-"
                  f"clipped ranges on half the rows): max|diff| {err:.3e}, {ms:.4f} ms vs plain "
                  f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
                  f"planted fault (sinks of the next head) max|diff| "
                  f"{float((bad.float() - ref.float()).abs().max()):.3e}, caught [{card}]",
                  flush=True)
            if dh == 64:  # the table keeps GPT-OSS's shape
                results[name] = row
        if dh == 128:
            # 48 CTAs: the plan splits each row over a cluster, and the sink
            # must enter the merge once; q x3 and sinks near each head's LSE,
            # so that a sink counted once per split (sink + log(splits), the
            # planted fault) moves the output past the limits
            q3 = (q.float() * 3).to(torch.bfloat16)
            near = _lse_sinks(q3, kc, lens, dstart, pstart, slot, dh ** -0.5, rng)
            for name, kk, vv, scl in (("ragged_decode_attention_sink", kc, vc, None),
                                      ("ragged_decode_attention_q8_sink", kq, vq, (ks, vs))):
                splits = rda.split_plan(B, nkv, nh // nkv, slot + 1, _cuda.sm_count(dev), dh=dh,
                                        int8=scl is not None).splits
                check(splits >= 2, f"the plan splits B={B} x {nkv} KV heads into {splits}")
                out = rda.ragged_decode_attention(q3, kk, vv, 1, lens, dstart, slot, pstart,
                                                  cache_scale=scl, sinks=near)
                bad = rda.ragged_decode_attention(q3, kk, vv, 1, lens, dstart, slot, pstart,
                                                  cache_scale=scl,
                                                  sinks=near + float(np.log(splits)))
                ref = rda.ragged_decode_plain(q3, kk, vv, 1, lens, dstart, slot, pstart,
                                              cache_scale=scl, sinks=near)
                torch.cuda.synchronize()

                def over(x, scl=scl):
                    return (_q8_excess(x, ref) if scl is not None
                            else float((x.float() - ref.float()).abs().max()) - KERNEL_ATOL)

                check(over(out) <= 0, f"{name} with sinks near the LSE, {splits} splits: "
                                      f"max|diff| {float((out.float() - ref.float()).abs().max())}")
                check(over(bad) > 0, f"the {name} check missed a planted fault (the sink "
                                     f"counted once per split, {splits} splits)")
                print(f"planted fault ({name}, dh={dh} {nh}/{nkv} heads, {splits} splits, sinks "
                      f"near the LSE: the sink counted once per split): max|diff| "
                      f"{float((bad.float() - ref.float()).abs().max()):.3e}, caught; the true "
                      f"sinks {float((out.float() - ref.float()).abs().max()):.3e} [{card}]",
                      flush=True)

    # windowed K3 / K1 at GPT-OSS's heads
    nh, nkv, dh = 64, 8, 64
    scale = dh ** -0.5
    for name, Bf, T, Sf, qstart in (("flash_attention_cached", 4, 64, 640, 512),
                                    ("flash_attention_cached", 4, 512, 640, 0),
                                    ("flash_attention", 4, 512, 512, 0)):
        q, k, v = bf16(Bf, T, nh, dh), bf16(Bf, Sf, nkv, dh), bf16(Bf, Sf, nkv, dh)
        qs = torch.full((Bf,), qstart, dtype=torch.int32, device=dev)
        lens = torch.tensor([qstart + T, qstart + T - 17, qstart + T - 40, qstart + T],
                            device=dev)
        kv_valid = (torch.arange(Sf, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        out, lse = fa._attention_cuda(q, k, v, kv_valid, qs, scale, name, W)
        ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qs, scale, W)
        bad = fa._attention_cuda(q, k, v, kv_valid, qs, scale, name, W + 1)[0]
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        seen = ref_lse > -1e29
        label = f"{name}_window dh={dh} B={Bf} T={T} S={Sf} qstart={qstart} W={W}"
        _k1_repeats(lambda: fa._attention_cuda(q, k, v, kv_valid, qs, scale, name, W), out, lse,
                    label)
        check(bool(torch.isfinite(out.float()).all()) and err <= KERNEL_ATOL, f"{label}: {err}")
        check(float((lse[seen] - ref_lse[seen]).abs().max()) <= 1e-3, f"{label} LSE")
        bad_err = float((bad.float() - ref.float()).abs().max())
        check(bad_err > KERNEL_ATOL, f"the {name}_window check missed a planted fault (W + 1)")
        allowed = _allowed(kv_valid, qs, T, W)
        ms, plain_ms, lib_ms = _ab_ms(
            lambda: fa._attention_cuda(q, k, v, kv_valid, qs, scale, name, W),
            lambda: fa.attention_plain(q, k, v, kv_valid, qs, scale, W),
            _sdpa(q, k, v, allowed, scale))
        # the keys of the band are the only ones a windowed kernel must read
        band_keys = int(_allowed(kv_valid, qs, T, W).any(1).sum())
        nbytes = (_nbytes(q, out, lse, kv_valid, qs)
                  + 2 * band_keys * nkv * dh * k.element_size())
        row = _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh * nh * int(allowed.sum()))
        print(f"kernel {label}: max|diff| {err:.3e}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"sdpa (banded boolean mask) {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); planted fault (window W + 1) max|diff| {bad_err:.3e}, "
              f"caught [{card}]", flush=True)
        key = name + "_window"
        if key not in results:  # the table keeps the first shape of each
            results[key] = row
        else:
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
    print(f"phase 1e took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def check_gemma_kernels(dev, card):
    """Phase 1f: the flash kernels (K3 fresh prefill at T=512 and suffix
    prefill at qstart 512, K1 at T=512) and the decode kernel (K4; K5 for
    Gemma-2) at head dim 256, at Gemma-2's heads (8/4, window 4096, softcap
    50) and Gemma-3's (4/1, window 512, no softcap), banded and full, each
    against its plain version, timed in turns. With the softcap, q is scaled
    so that the logits reach 1-3x the cap, and the kernel run without the
    softcap (a planted fault) must fail the check. The library call is SDPA
    for the softcap-free shapes and the compiled flex_attention (softcap as
    its score_mod) for the softcapped ones, itself held to the plain version
    at the kernel's limit; K5 has none (no one call reads an int8 cache)."""
    import numpy as np
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
    from lapha_tpu_torch.models.qwen2 import _quantize_kv
    from lapha_tpu_torch.ops import flash_attention as fa
    from lapha_tpu_torch.ops import ragged_decode_attention as rda

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    dh, scale = 256, 1.0 / 16

    def bf16(*shape, sd=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * sd).to(torch.bfloat16)

    def key(name, window, cap):  # the kernels line's row for this launch
        return fa.launch_name(name, window, cap) if cap else fa.launch_name(name, window) + "_dh256"

    results = {}
    families = (("Gemma-2", 8, 4, 4096, GEMMA_CAP), ("Gemma-3", 4, 1, 512, 0.0))
    for fam, nh, nkv, W, cap in families:
        q_sd = 25.0 if cap else 1.0  # q·k/16 ~ N(0, q_sd^2): |s| up to ~2-3x the cap
        for window in (W, 0):
            for name, Bf, T, Sf, qstart in (("flash_attention_cached", 4, 512, 640, 0),
                                            ("flash_attention_cached", 4, 64, 640, 512),
                                            ("flash_attention", 4, 512, 512, 0)):
                q, k, v = bf16(Bf, T, nh, dh, sd=q_sd), bf16(Bf, Sf, nkv, dh), bf16(Bf, Sf, nkv, dh)
                qs = torch.full((Bf,), qstart, dtype=torch.int32, device=dev)
                lens = torch.tensor([qstart + T, qstart + T - 17, qstart + T - 40, qstart + T],
                                    device=dev)
                kv_valid = (torch.arange(Sf, device=dev)[None, :] < lens[:, None]).to(torch.int32)
                args = (q, k, v, kv_valid, qs, scale)
                out, lse = fa._attention_cuda(*args, name, window, cap)
                ref, ref_lse = fa.attention_plain(*args, window, softcap=cap)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                seen = ref_lse > -1e29
                label = (f"{key(name, window, cap)} ({fam}) {nh}/{nkv} heads B={Bf} T={T} S={Sf} "
                         f"qstart={qstart} W={window} softcap={cap}")
                check(bool(torch.isfinite(out.float()).all()) and err <= KERNEL_ATOL,
                      f"{label}: {err}")
                check(float((lse[seen] - ref_lse[seen]).abs().max()) <= 1e-3, f"{label} LSE")
                _k1_repeats(lambda: fa._attention_cuda(*args, name, window, cap), out, lse, label)
                note = ""
                if cap:
                    s_max = float((torch.einsum("bthd,bshd->bhts", q[:, :, ::nh // nkv].float(),
                                                k.float()) * scale).abs().max())
                    bad = fa._attention_cuda(*args, name, window)[0]
                    torch.cuda.synchronize()
                    bad_err = float((bad.float() - ref.float()).abs().max())
                    check(s_max > GEMMA_CAP and bad_err > KERNEL_ATOL,
                          f"the {label} check missed a planted fault (softcap off): "
                          f"max|s| {s_max}, max|diff| {bad_err}")
                    note = (f"; max|logit| {s_max:.1f} before the cap; planted fault (softcap "
                            f"off) max|diff| {bad_err:.3e}, caught")
                allowed = _allowed(kv_valid, qs, T, window)
                if cap:
                    lib_fn = _flex_softcap(q, k, v, allowed, scale, cap)
                    lib_err = _library_err(lib_fn, ref, allowed.any(-1), f"{label} flex_attention")
                    lib_name = f"flex_attention (max|diff| {lib_err:.3e})"
                else:
                    lib_fn, lib_name = _sdpa(q, k, v, allowed, scale), "sdpa"
                ms, plain_ms, lib_ms = _ab_ms(
                    lambda: fa._attention_cuda(*args, name, window, cap),
                    lambda: fa.attention_plain(*args, window, softcap=cap), lib_fn)
                # the keys that some query sees are the only ones the kernel must read
                seen_keys = int(allowed.any(1).sum())
                nbytes = (_nbytes(q, out, lse, kv_valid, qs)
                          + 2 * seen_keys * nkv * dh * k.element_size())
                row = _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh * nh * int(allowed.sum()))
                print(f"kernel {label}: max|diff| {err:.3e}, {ms:.4f} ms vs plain {plain_ms:.4f} "
                      f"ms, {lib_name} {lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}){note} "
                      f"[{card}]", flush=True)
                rk = key(name, window, cap)
                if rk not in results:  # the table keeps the first shape of each
                    results[rk] = row
                else:
                    results[rk]["max_abs_err"] = max(results[rk]["max_abs_err"], err)

        # K4 / K5: 24 decode rows over S=640, prompts up to 512, decode
        # columns from 512, the window's clipped ranges on the odd rows
        L, B, S, slot = 2, 24, 640, 600
        q = bf16(B, nh, dh, sd=q_sd)
        kc, vc = bf16(L, B, nkv, S, dh), bf16(L, B, nkv, S, dh)
        lens = torch.from_numpy(rng.integers(64, 513, B).astype(np.int32)).to(dev)
        pos = lens + (slot - 512)
        odd = torch.arange(B, device=dev) % 2 == 1
        pstart = torch.where(odd, torch.minimum(torch.clamp(pos - (W - 1), min=0), lens),
                             torch.zeros_like(lens)).to(torch.int32)
        dstart = torch.where(odd, torch.full_like(lens, max(512, slot - (W - 1))),
                             torch.full_like(lens, 512)).to(torch.int32)
        valid = _decode_valid(lens, dstart, slot, S, pstart)
        n_valid = int(valid.sum())
        entries = [("ragged_decode_attention", kc, vc, None)]
        if cap:  # Gemma-2 is also served over an int8 cache
            (kq, ks), (vq, vs) = _quantize_kv(kc), _quantize_kv(vc)
            entries.append(("ragged_decode_attention_q8", kq, vq, (ks, vs)))
        for name, kk, vv, scl in entries:
            def kernel(c=cap, kk=kk, vv=vv, scl=scl):
                return rda.ragged_decode_attention(q, kk, vv, 1, lens, dstart, slot, pstart, scale,
                                                   cache_scale=scl, softcap=c)

            def plain(kk=kk, vv=vv, scl=scl):
                return rda.ragged_decode_plain(q, kk, vv, 1, lens, dstart, slot, pstart, scale,
                                               cache_scale=scl, softcap=cap)

            def excess(out, ref, scl=scl):
                if scl is not None:
                    return _q8_excess(out, ref)
                return float((out.float() - ref.float()).abs().max()) - KERNEL_ATOL

            out, ref = kernel(), plain()
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            label = (f"{key(name, 0, cap)} ({fam}) {nh}/{nkv} heads B={B} S={S} slot={slot} "
                     f"softcap={cap}")
            check(bool(torch.isfinite(out.float()).all()) and excess(out, ref) <= 0,
                  f"{label}: max|diff| {err}")
            note = ""
            if cap:
                bad = kernel(c=0.0)
                torch.cuda.synchronize()
                check(excess(bad, ref) > 0, f"the {label} check missed a planted fault "
                                            "(softcap off)")
                note = (f"; planted fault (softcap off) max|diff| "
                        f"{float((bad.float() - ref.float()).abs().max()):.3e}, caught")
            lib_fn, lib = None, "none (no one call reads an int8 cache)"
            if scl is None:
                lib_args = (q[:, None], kc[1].transpose(1, 2), vc[1].transpose(1, 2),
                            valid[:, None, :], scale)
                if cap:
                    lib_fn = _flex_softcap(*lib_args, cap)
                    lib_err = _library_err(lambda: lib_fn()[:, 0], ref, valid.any(-1),
                                           f"{label} flex_attention")
                    lib = f"flex_attention (max|diff| {lib_err:.3e})"
                else:
                    lib_fn, lib = _sdpa(*lib_args), "sdpa"
            ms, plain_ms, lib_ms = _ab_ms(kernel, plain, lib_fn, timer=graph_ms)
            if lib_ms is not None:
                lib = f"{lib} {lib_ms:.4f} ms"
            # K and V of the valid slots per KV head (int8: + two f32 scales),
            # q, the ranges and out
            per_slot = 2 * dh * (1 if scl is not None else 2) + (8 if scl is not None else 0)
            nbytes = n_valid * nkv * per_slot + 2 * _nbytes(q) + _nbytes(lens, dstart, pstart)
            row = _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh * nh * n_valid)
            print(f"kernel {label}: max|diff| {err:.3e}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
                  f"{lib}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}){note} [{card}]",
                  flush=True)
            results[key(name, 0, cap)] = row
    print(f"phase 1f took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def _library_err(lib_fn, ref, seen, what) -> float:
    """Max |library - plain| over the query rows that see a key (a row that
    sees none is the kernels' zero and the library's own choice), held to
    the kernels' limit: the yardstick computes the same function."""
    import torch

    out = lib_fn()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float())[seen].abs().max())
    check(bool(torch.isfinite(out[seen].float()).all()) and err <= KERNEL_ATOL, f"{what}: {err}")
    return err


def _published_model(dev, card, hf_config, label):
    """A model at full width and depth from its published config (Gemma,
    Phi-3, StarCoder2), random bf16 weights from the seed. With Gemma-2's
    softcaps the q projections are scaled x16 and the embedding x32, so
    that attention logits reach ~1-2x the cap of 50 and the final logits
    the cap of 30 (with the init's scales neither cap would bite)."""
    import torch

    from lapha_tpu_torch.models import qwen2, quant, value_model

    cfg = qwen2.Qwen2Config.from_hf(hf_config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = qwen2.init_params(cfg, gen)
    if cfg.attn_softcap:
        params["layers"]["attn"]["q_proj"]["w"].mul_(16.0)
        params["embed"]["weight"].mul_(32.0)
    head = value_model.init_value_head(cfg.hidden_size, gen)
    torch.cuda.synchronize()
    print(f"{label} weights ({cfg.num_hidden_layers} layers, H {cfg.hidden_size}, "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads} heads of dim {cfg.head_dim_}, I "
          f"{cfg.intermediate_size}, V {cfg.vocab_size}, windows "
          f"{cfg.layer_windows[:6] or cfg.sliding_window}..., norms {cfg.norm_style}, MLP "
          f"{cfg.mlp_style}, "
          f"softcaps {cfg.attn_softcap}/{cfg.final_softcap}, rope {cfg.rope_theta}/"
          f"{cfg.rope_local_theta}; random bf16): {quant.params_nbytes(params) / 1e9:.2f} GB made "
          f"in {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
    return params, head, cfg


def serve_published(dev, card, hf_config, label, kv_modes, ref_kw, phases="2f and 12"):
    """Phases 2f and 12 (Gemma) and 17 (Phi-3, StarCoder2) on one model
    made here from its published config and freed before the return: the
    two-layer check (``ref_kw``: its prompt and cache lengths), then serve's
    round for each KV mode in ``kv_modes``, counted, checked (the K1/K3 of
    the stack's window kinds and K4, K5 over the int8 cache, under the
    softcap's names when the model has one, and nothing else), a warm round
    timed, peak memory, one decode step profiled. Returns the launch counts
    of the counted rounds."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops.flash_attention import launch_name
    from lapha_tpu_torch.search import ValueFunction

    t_phase = time.perf_counter()
    params, head, cfg = _published_model(dev, card, hf_config, label)
    check_small_reference(params, cfg, dev, note=f", {label}", **ref_kw)

    P, n, plen, new = 4, 6, 512, 64
    kw = dict(max_model_len=plen + 2 * new + 128, max_batch=P * n, decode_chunk=32,
              pad_multiple=128, batch_bucket=1, eos_token_ids=[], seed=SEED, collect_h0=True)
    engines = {kv: Engine(params, cfg, IdTok(), kv_quant=kv, **kw) for kv in kv_modes}
    vf = ValueFunction(params, head, cfg, max_model_len=1024, pad_multiple=128, batch_bucket=P)
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    rng = np.random.default_rng(SEED + 18)
    installs = []
    install = Engine._install_win
    Engine._install_win = lambda self, *a: installs.append(a[-1]) or install(self, *a)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    try:
        runs = {kv: _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
                for kv, eng in engines.items()}
    finally:
        Engine._install_win = install
    launches = dict(_cuda.LAUNCHES)
    cap = cfg.attn_softcap
    # banded (sliding layers) and full K1/K3 as the stack has them, K4 (and
    # K5 over the int8 cache), all under their softcap names for Gemma-2;
    # nothing else
    kinds = {cfg.window_for_layer(l) > 0 for l in range(cfg.num_hidden_layers)}
    ran = [launch_name(nm, w, cap) for nm in ("flash_attention", "flash_attention_cached")
           for w in kinds]
    ran.append(launch_name("ragged_decode_attention", 0, cap))
    if "int8" in kv_modes:
        ran.append(launch_name("ragged_decode_attention_q8", 0, cap))
    for name in ran:
        check(launches[name] > 0, f"{name} never launched on the {label} served path")
    for name, count in launches.items():
        check(name in ran or count == 0, f"{name} ran {count} times on the {label} served path")
    # W = 4096 (Gemma-2, StarCoder2) or 2047 (Phi-3) never fits a prompt of
    # 512; W = 512 (Gemma-3) takes the short cache for the children's
    # prompts of 576 in slabs of 640
    expected = [] if cfg.max_window_ > plen else [512] * len(kv_modes)
    check(installs == expected, f"windowed-short installs {installs} (expected {expected})")
    for kv, run in runs.items():
        _check_round(run, vf, cfg.vocab_size, cfg.hidden_size, P, n, P, new,
                     REF_RTOL if kv is None else FUSED_Q8_RTOL)
        print(f"{label}, {'bf16' if kv is None else 'int8'} KV: first (cold) round "
              f"{run['t_all']:.2f} s [{card}]", flush=True)
    modes = ", then ".join("bf16-KV" if kv is None else "int8-KV" for kv in kv_modes)
    print(f"launches on the {label} served path (a {modes} round; windowed-short installs "
          f"{installs}): {launches}", flush=True)

    warm = _serve_round(engines[None], vf, sp, rng, cfg.vocab_size, P, plen, P, new)
    _report_warm(label, warm, params, P, n, new, card)
    del engines, vf, runs, warm
    torch.cuda.empty_cache()
    _profile_served(label, params, cfg, P * n, plen, plen + 2 * new, SEED + 19, card)
    del params, head
    torch.cuda.empty_cache()
    print(f"phases {phases} ({label}) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def check_moe_reference(params, cfg, dev):
    """Phase 2d: phase 2's two-layer check on the MoE model, with the
    routing choices of the two runs compared, then layer 0's MoE block
    alone with the card's routing forced on the CPU."""
    import torch

    from lapha_tpu_torch.ops import moe

    seen, route = [], moe.route

    def recording(x, router_w, top_k, norm_topk):
        topw, topi = route(x, router_w, top_k, norm_topk)
        seen.append((topw.float().cpu(), topi.cpu()))
        return topw, topi

    moe.route = recording
    try:
        check_small_reference(params, cfg, dev)
    finally:
        moe.route = route
    half = len(seen) // 2  # the card's calls, then the CPU's, in the same order
    card = seen[:half]
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for (_, a), (_, b) in zip(card, seen[half:]))
    rows = sum(a.shape[0] for _, a in card)
    print(f"routing: {flips} of {rows} (token, layer) top-{cfg.num_experts_per_tok} choices "
          f"differ between the card (bf16) and the CPU (f32) in the two-layer check", flush=True)

    # the same check with the card's routing replayed on the CPU: what is
    # left is the kernels' and bf16's error, without the flips
    replay = iter(card)
    calls = iter(range(2 * half))

    def replaying(x, router_w, top_k, norm_topk):  # the card's calls come first
        return route(x, router_w, top_k, norm_topk) if next(calls) < half else next(replay)

    moe.route = replaying
    try:
        check_small_reference(params, cfg, dev, note=", the card's routing replayed on the CPU")
    finally:
        moe.route = route

    sub, _, cpu, _ = _two_layers(params, cfg)
    p, pc = _layer0_moe(sub), _layer0_moe(cpu)
    x = torch.randn((192, cfg.hidden_size), generator=torch.Generator(device=dev).manual_seed(
        SEED + 11), device=dev).to(torch.bfloat16)
    kw = dict(top_k=cfg.num_experts_per_tok, norm_topk=cfg.norm_topk_prob)
    with torch.inference_mode():
        topw, topi = moe.route(x, p["router"]["w"], **kw)
        got = moe.moe_ffn_gather(x, p, routing=(topw, topi), **kw) + moe.shared_expert(x, p["shared"])
        xc = x.float().cpu()
        ref = (moe.moe_ffn_gather(xc, pc, routing=(topw.float().cpu(), topi.cpu()), **kw)
               + moe.shared_expert(xc, pc["shared"]))
    e_block = _rel(got.float().cpu(), ref)
    print(f"MoE block of layer 0 with the routing forced equal (192 tokens; card K8 bf16 vs "
          f"CPU plain f32): rel err {e_block:.3e}", flush=True)
    check(e_block <= MOE_BLOCK_RTOL, f"MoE block rel err {e_block}")


def _layer0_moe(params):
    from lapha_tpu_torch.models import qwen2

    return qwen2._layer_stack(params)[0]["moe"]


def _report_warm(label, warm, params, P: int, n: int, new: int, card) -> None:
    """Print a warm round's timings (phase 3's shape) and the peak memory."""
    import torch

    from lapha_tpu_torch.models import quant

    tp, tk = warm["t_par"], warm["t_kid"]
    rows_tok = P * n * new
    print(f"{label} warm parents: prefill {tp['prefill_s'] * 1e3:.1f} ms (4 x 512 tokens), "
          f"decode {tp['decode_s'] * 1e3:.1f} ms for {tp['decode_steps']} steps x {P * n} rows = "
          f"{rows_tok / tp['decode_s']:.1f} tok/s [{card}]", flush=True)
    print(f"{label} warm children: prefix-hit prefill {tk['prefill_s'] * 1e3:.1f} ms (4 x "
          f"64-token suffix at qstart 512), decode {tk['decode_s'] * 1e3:.1f} ms = "
          f"{rows_tok / tk['decode_s']:.1f} tok/s; root value forward (4 x 512) "
          f"{warm['t_value'] * 1e3:.1f} ms; whole round {warm['t_all']:.2f} s [{card}]",
          flush=True)
    print(f"{label} serving memory: params_nbytes {quant.params_nbytes(params) / 1e9:.2f} GB, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]",
          flush=True)


def _profile_served(label, params, cfg, rows: int, plen: int, S: int, seed: int, card) -> None:
    """Where one decode step's time goes at a served shape: ``rows`` rows
    over a random full-S cache (windowed layers read their clipped ranges),
    prompts of ``plen``, profiled as in phase 9."""
    import torch

    dev = params["norm"]["scale"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.num_hidden_layers, rows, cfg.num_key_value_heads, S, cfg.head_dim_)
    cache = tuple((torch.randn(shape, generator=gen, device=dev) * 0.5).to(cfg.dtype)
                  for _ in range(2))
    tok = torch.randint(2, cfg.vocab_size, (rows,), generator=gen, device=dev)
    lens = torch.full((rows,), plen, dtype=torch.int32, device=dev)
    _profile_decode(f"{label}, bf16 weights, bf16 KV", params, cfg, tok, lens, cache, None,
                    plen, 5, card)
    del cache
    torch.cuda.empty_cache()


def serve_moe(dev, card):
    """Phases 2d and 10 on one MoE model made here and freed before the
    return. Returns the launch counts of the first round."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.models import qwen2, quant, value_model
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    cfg = _moe_cfg()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = qwen2.init_params(cfg, gen)
    head = value_model.init_value_head(cfg.hidden_size, gen)
    torch.cuda.synchronize()
    print(f"MoE weights (Qwen1.5-MoE-A2.7B, {cfg.num_hidden_layers} layers, random bf16): "
          f"{quant.params_nbytes(params) / 1e9:.2f} GB made in {time.perf_counter() - t0:.2f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
    check_moe_reference(params, cfg, dev)
    check_moe_gradient_reference(params, head, cfg, dev, "Qwen1.5-MoE-A2.7B", (90, 40), (30, 60))

    P, n, plen, new = 4, 6, 512, 64
    eng = Engine(params, cfg, IdTok(), max_model_len=plen + 2 * new + 128, max_batch=P * n,
                 decode_chunk=32, pad_multiple=128, batch_bucket=1, eos_token_ids=[],
                 seed=SEED, collect_h0=True)
    vf = ValueFunction(params, head, cfg, max_model_len=1024, pad_multiple=128, batch_bucket=P)
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    rng = np.random.default_rng(SEED + 12)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    run = _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
    launches = dict(_cuda.LAUNCHES)
    # K8: the wgmma kernel at prefill (2048 tokens x top-4), the decode kernel at decode
    for name in ("grouped_gemm", "grouped_gemm_wg", "flash_attention", "flash_attention_cached",
                 "ragged_decode_attention"):
        check(launches[name] > 0, f"{name} never launched on the MoE served path")
    _check_round(run, vf, cfg.vocab_size, cfg.hidden_size, P, n, P, new, REF_RTOL)
    print(f"launches on the MoE served path: {launches}; first (cold) round "
          f"{run['t_all']:.2f} s [{card}]", flush=True)

    warm = _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
    _report_warm("MoE", warm, params, P, n, new, card)

    # one MoE layer call never waits on the host
    h = torch.randn((P * n, cfg.hidden_size), generator=gen, device=dev).to(cfg.dtype)
    layer = qwen2._layer_stack(params)[0]
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = qwen2._mlp(cfg, layer, h)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    check(bool(torch.isfinite(out.float()).all()), "MoE layer output finite")
    print(f"sync debug mode 'error': one MoE layer ({P * n} rows) ran without a host sync",
          flush=True)

    del eng, vf, run, warm
    torch.cuda.empty_cache()
    _profile_served("MoE", params, cfg, P * n, plen, plen + 2 * new, SEED + 10, card)
    del params, head, layer, out
    torch.cuda.empty_cache()
    print(f"phases 2d and 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def check_gptoss_reference(params, cfg, dev):
    """Phase 2e: phase 2's two-layer check on GPT-OSS-20B's first two layers
    (layer 0 sliding, layer 1 full) at prompts of 160 and 134 tokens, past
    the 128-token window, so the band shows in prefill and decode: the
    routing choices of the card (bf16) and the CPU (f32) runs are counted,
    then the check is made with the card's routing replayed on the CPU."""
    from lapha_tpu_torch.ops import moe

    seen, route = [], moe.route_topk_softmax

    def recording(x, router_w, router_b, top_k):
        topw, topi = route(x, router_w, router_b, top_k)
        seen.append((topw.float().cpu(), topi.cpu()))
        return topw, topi

    t0 = time.perf_counter()
    kw = dict(T=160, S=192)
    moe.route_topk_softmax = recording
    try:
        check_small_reference(params, cfg, dev, note=", GPT-OSS, routing free", strict=False, **kw)
    finally:
        moe.route_topk_softmax = route
    half = len(seen) // 2  # the card's calls, then the CPU's, in the same order
    card = seen[:half]
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for (_, a), (_, b) in zip(card, seen[half:]))
    rows = sum(a.shape[0] for _, a in card)
    print(f"routing: {flips} of {rows} (token, layer) top-{cfg.num_experts_per_tok} choices "
          f"differ between the card (bf16) and the CPU (f32) in the GPT-OSS two-layer check",
          flush=True)
    replay = iter(card)
    calls = iter(range(2 * half))

    def replaying(x, router_w, router_b, top_k):  # the card's calls come first
        return route(x, router_w, router_b, top_k) if next(calls) < half else next(replay)

    moe.route_topk_softmax = replaying
    try:
        check_small_reference(params, cfg, dev,
                              note=", GPT-OSS, the card's routing replayed on the CPU", **kw)
    finally:
        moe.route_topk_softmax = route
    print(f"phase 2e took {time.perf_counter() - t0:.1f} s", flush=True)


def _gptoss_model(dev, card, layers=None):
    """GPT-OSS-20B at full width and depth from its published config (its
    first ``layers`` layers when given), random bf16 weights from the seed,
    with random sinks and router biases (the init's are zero); on the card,
    expert stacks drawn one layer at a time."""
    import numpy as np
    import torch

    from lapha_tpu_torch.models import qwen2, quant, value_model

    hf = GPTOSS_20B_CONFIG
    if layers is not None:
        hf = dict(hf, num_hidden_layers=layers, layer_types=hf["layer_types"][:layers])
    cfg = qwen2.Qwen2Config.from_hf(hf)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = qwen2.init_params(cfg, gen)
    rng = np.random.default_rng(SEED + 14)
    a, m = params["layers"]["attn"], params["layers"]["moe"]
    L, nh, E = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.num_experts
    a["sinks"].copy_(torch.from_numpy(np.stack([_gptoss_sinks(rng, nh) for _ in range(L)])))
    m["router"]["b"].copy_(torch.from_numpy(rng.normal(size=(L, E)).astype(np.float32) * 0.5))
    head = value_model.init_value_head(cfg.hidden_size, gen)
    torch.cuda.synchronize()
    print(f"GPT-OSS-20B weights ({cfg.num_hidden_layers} layers, H {cfg.hidden_size}, "
          f"{nh}/{cfg.num_key_value_heads} heads of dim {cfg.head_dim_}, {E} experts top-"
          f"{cfg.num_experts_per_tok}, V {cfg.vocab_size}, windows {cfg.layer_windows[:2]}..., "
          f"rope {cfg.rope_scaling[:2]}; random bf16): {quant.params_nbytes(params) / 1e9:.2f} GB "
          f"made in {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
    return params, head, cfg


def check_h0_routing_replayed(eng, vf, cfg, rng, plen: int, extra: int, new: int, label: str,
                              router: str = "route_topk_softmax"):
    """Phase 11's fused-h0 check (ROADMAP C5) with routing flips taken out:
    one fresh parent of ``plen`` tokens and its child (``extra`` more, a
    prefix hit), n = 1, generated with every routing choice of row 0
    recorded by (layer, position) (the parent's below ``plen``, the child's
    prefill and decode above); then the value forward over child +
    completion, free and with the recorded choices replayed. ``router``
    names the ``ops.moe`` routing function of the model (the config's
    model module's forward and decode_step are tagged). Returns the two
    relative errors of the pooled h0 (free, replayed)."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import SamplingParams
    from lapha_tpu_torch.models import model_module
    from lapha_tpu_torch.ops import moe

    mod = model_module(cfg)
    fwd, step, route = mod.forward, mod.decode_step, getattr(moe, router)
    ctx = {"T": 0, "layer": 0}
    rec, replay, counts = {}, {}, {"replayed": 0, "free": 0}

    def tagged_forward(params, c, input_ids, attention_mask=None, positions=None, kv_cache=None,
                       cache_pos=0, kv_valid=None, **kw):
        T = input_ids.shape[1]
        ar = torch.arange(T, device=input_ids.device)
        if kv_cache is not None:  # row 0's tokens are real where its cache columns are valid
            c0 = int(torch.as_tensor(cache_pos).reshape(-1)[0])
            real = kv_valid[0, c0:c0 + T].bool()
        elif attention_mask is not None:
            real = attention_mask[0] > 0
        else:
            real = torch.ones(T, dtype=torch.bool, device=input_ids.device)
        if positions is not None:
            pos = positions[0]
        elif attention_mask is not None:
            pos = (torch.cumsum(attention_mask[0], 0) - 1).clamp(min=0)
        else:
            pos = ar
        ctx.update(T=T, pos=pos.tolist(), real=real.tolist(), layer=0)
        return fwd(params, c, input_ids, attention_mask, positions, kv_cache, cache_pos, kv_valid,
                   **kw)

    def tagged_step(params, c, tok, positions, *a, **kw):
        ctx.update(T=1, pos=[int(positions[0])], real=[True], layer=0)
        return step(params, c, tok, positions, *a, **kw)

    def routing(x, *args, **kw):
        topw, topi = route(x, *args, **kw)
        layer, T = ctx["layer"], ctx["T"]
        ctx["layer"] += 1
        keys = [(t, (layer, p)) for t, (p, r) in enumerate(zip(ctx["pos"], ctx["real"])) if r]
        if replay:
            rows = [(t, replay[k]) for t, k in keys if k in replay]
            counts["replayed"] += len(rows)
            counts["free"] += len(keys) - len(rows)
            if rows:
                idx = torch.tensor([t for t, _ in rows], device=x.device)
                topw[idx] = torch.stack([w for _, (w, _) in rows]).to(topw.device, topw.dtype)
                topi[idx] = torch.stack([i for _, (_, i) in rows]).to(topi.device, topi.dtype)
        else:
            tw, ti = topw[:T].float().cpu(), topi[:T].cpu()
            for t, k in keys:
                rec[k] = (tw[t], ti[t])
        return topw, topi

    parent = rng.integers(2, cfg.vocab_size, plen)
    child = np.concatenate([parent, rng.integers(2, cfg.vocab_size, extra)])
    sp = SamplingParams(n=1, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=3)
    mod.forward, mod.decode_step = tagged_forward, tagged_step
    setattr(moe, router, routing)
    try:
        eng.generate([_text(parent)], sp)
        for k in [k for k in rec if k[1] >= plen]:  # the parent's own completion
            del rec[k]
        hits0 = eng.prefix_cache.hits
        out = eng.generate([_text(child)], sp)[0].outputs[0]
        check(eng.prefix_cache.hits == hits0 + 1, "the replay's child hit the prefix cache")
        full = np.concatenate([child, np.asarray(out.token_ids)])[None]
        ones = np.ones_like(full, dtype=np.int32)
        errs = []
        for table in ({}, rec):
            replay.clear()
            replay.update(table)
            _, _, h_ref = vf(full, ones, return_h0=True)
            errs.append(float(np.linalg.norm(out.pooled_hidden - h_ref[0])
                              / np.linalg.norm(h_ref[0])))
    finally:
        mod.forward, mod.decode_step = fwd, step
        setattr(moe, router, route)
    print(f"fused value check with the engine's routing replayed ({label}; {full.shape[1]} "
          f"tokens, {counts['replayed']} (token, layer) choices replayed, {counts['free']} "
          f"free): engine pooled h0 vs value forward rel err {errs[0]:.3e} free, {errs[1]:.3e} "
          f"replayed", flush=True)
    return errs


def serve_gptoss(dev, card):
    """Phases 2e and 11 on one GPT-OSS-20B model made here and freed before
    the return. Returns the launch counts of the counted rounds."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    t_phase = time.perf_counter()
    params, head, cfg = _gptoss_model(dev, card)
    check_gptoss_reference(params, cfg, dev)
    # prompts past the 128-token window
    check_moe_gradient_reference(params, head, cfg, dev, "GPT-OSS-20B", (200, 150), (40, 90))

    P, n, plen, new = 4, 6, 512, 64
    kw = dict(max_model_len=plen + 2 * new + 128, max_batch=P * n, decode_chunk=32,
              pad_multiple=128, batch_bucket=1, eos_token_ids=[], seed=SEED, collect_h0=True)
    engines = {kv: Engine(params, cfg, IdTok(), kv_quant=kv, **kw) for kv in (None, "int8")}
    vf = ValueFunction(params, head, cfg, max_model_len=1024, pad_multiple=128, batch_bucket=P)
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    rng = np.random.default_rng(SEED + 15)
    installs = []
    install = Engine._install_win
    Engine._install_win = lambda self, *a: installs.append(a[-1]) or install(self, *a)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    try:
        runs = {kv: _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
                for kv, eng in engines.items()}
    finally:
        Engine._install_win = install
    launches = dict(_cuda.LAUNCHES)
    for name in ("flash_attention_window", "flash_attention_cached_window",
                 "ragged_decode_attention_sink", "ragged_decode_attention_q8_sink", "grouped_gemm",
                 "grouped_gemm_wg", "flash_attention", "flash_attention_cached"):
        check(launches[name] > 0, f"{name} never launched on the GPT-OSS served path")
    for name in ("ragged_decode_attention", "ragged_decode_attention_q8"):
        check(launches[name] == 0, f"{name} (no sinks) ran on the GPT-OSS path")
    check(installs == [128] * 4, f"windowed-short installs {installs} (expected 4 of Wpad 128)")
    for kv, run in runs.items():
        _check_round(run, vf, cfg.vocab_size, cfg.hidden_size, P, n, P, new,
                     REF_RTOL if kv is None else FUSED_Q8_RTOL)
        print(f"GPT-OSS-20B, {'bf16' if kv is None else 'int8'} KV: first (cold) round "
              f"{run['t_all']:.2f} s [{card}]", flush=True)
    print(f"launches on the GPT-OSS served path (a bf16-KV round, then an int8-KV round; "
          f"windowed-short decode cache installed in each generate): {launches}", flush=True)
    # ROADMAP C5: the same check with the engine's routing replayed
    for kv, eng in engines.items():
        label = f"GPT-OSS-20B, {'bf16' if kv is None else 'int8'} KV"
        _, e_replayed = check_h0_routing_replayed(eng, vf, cfg, rng, plen, new, new, label)
        check(e_replayed <= (REF_RTOL if kv is None else FUSED_Q8_RTOL),
              f"fused value rel err with the routing replayed {e_replayed} ({label})")

    warm = _serve_round(engines[None], vf, sp, rng, cfg.vocab_size, P, plen, P, new)
    _report_warm("GPT-OSS-20B", warm, params, P, n, new, card)
    del engines, vf, runs, warm
    torch.cuda.empty_cache()
    _profile_served("GPT-OSS-20B", params, cfg, P * n, plen, plen + 2 * new, SEED + 16, card)
    del params, head
    torch.cuda.empty_cache()
    print(f"phases 2e and 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _sdpa_narrow(q, k, v, allowed, scale, ref):
    """One PyTorch call for attention with V narrower than Q/K (nh = nkv):
    SDPA through the first fused backend (cuDNN, memory-efficient, flash)
    that takes V of its own width and agrees with the plain output ``ref``
    at the kernels' limit on the rows that see a key, else the first that
    does so with V zero-padded to Q/K's width (the same first columns), else
    the math backend. Returns (fn giving (B, T, nh, dv), what it ran, its
    max |diff|)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    dv = v.shape[-1]
    qt, kt, m = q.transpose(1, 2), k.transpose(1, 2), allowed[:, None]
    seen = allowed.any(-1)
    vp = F.pad(v, (0, q.shape[-1] - dv))
    fused = (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.FLASH_ATTENTION)
    tries = ([(v, f"V of {dv}", b) for b in fused] + [(vp, f"V zero-padded to {q.shape[-1]}", b)
                                                        for b in fused]
             + [(v, f"V of {dv}", SDPBackend.MATH)])
    for vv, how, backend in tries:
        vt = vv.transpose(1, 2)

        def fn(vt=vt, backend=backend):
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale)
            return out[..., :dv].transpose(1, 2)

        try:
            out = fn()
            torch.cuda.synchronize()
        except RuntimeError as e:  # this backend does not take these inputs
            print(f"    sdpa {backend.name} with {how}: not taken ({str(e).splitlines()[0][:80]})",
                  flush=True)
            continue
        err = float((out.float() - ref.float())[seen].abs().max())
        if torch.isfinite(out[seen].float()).all() and err <= KERNEL_ATOL:
            return fn, f"sdpa ({backend.name}, {how})", err
        print(f"    sdpa {backend.name} with {how}: max|diff| {err:.3e} from the plain version, "
              f"not used", flush=True)
    raise RuntimeError("no SDPA backend computes attention with Q/K 192 and V 128")


def check_deepseek_kernels(dev, card):
    """Phase 1j: K3 (fresh prefill B=4 T=512 S=640; suffix prefill T=64 at
    qstart 512 over ragged kv_valid) and K1 (B=4 T=512, padded rows) with V
    narrower than Q/K at DeepSeek-V2-Lite's shapes (16/16 heads, Q/K 192 =
    nope 128 + rope 64, V 128, its scale) against the plain version, timed
    in turns beside one SDPA call; planted faults (the scale of 1/sqrt(128)
    in place of the model's, each head's V taken from the next head) must
    fail the check. Phase 1's (128, 128) K3 row is timed again beside it."""
    import torch

    from lapha_tpu_torch.models.deepseek import DeepseekConfig
    from lapha_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    cfg = DeepseekConfig.from_hf(DEEPSEEK_V2_LITE_CONFIG)
    nh, dh, dv, scale = cfg.num_attention_heads, cfg.qk_head_dim_, cfg.v_head_dim, cfg.attn_scale_
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    results = {}
    for name, B, T, S, qstart, lens, pad in (
            ("flash_attention_cached", 4, 512, 640, 0, (512, 450, 300, 512), False),
            ("flash_attention_cached", 4, 64, 640, 512, (576, 560, 576, 530), False),
            ("flash_attention", 4, 512, 512, 0, (512, 400, 512, 130), True)):
        q, k, v = bf16(B, T, nh, dh), bf16(B, S, nh, dh), bf16(B, S, nh, dv)
        qs = torch.full((B,), qstart, dtype=torch.int32, device=dev)
        kv_valid = (torch.arange(S, device=dev)[None, :]
                    < torch.tensor(lens, device=dev)[:, None]).to(torch.int32)
        if not pad:
            kv_valid[2, 100:140] = 0  # a hole of invalid keys
        args = (q, k, v, kv_valid, qs, scale)
        out, lse = fa._attention_cuda(*args, name)
        ref, ref_lse = fa.attention_plain(*args)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        seen = ref_lse > -1e29
        rk = fa.launch_name(name, narrowv=True)
        label = f"{rk} {nh}/{nh} heads q/k {dh} v {dv} B={B} T={T} S={S} qstart={qstart}"
        check(out.shape == (B, T, nh, dv) and bool(torch.isfinite(out.float()).all())
              and err <= KERNEL_ATOL, f"{label}: {err}")
        check(float((lse[seen] - ref_lse[seen]).abs().max()) <= 1e-3, f"{label} LSE")
        _k1_repeats(lambda: fa._attention_cuda(*args, name), out, lse, label)
        bad = {"scale 1/sqrt(128)": fa._attention_cuda(q, k, v, kv_valid, qs, 128 ** -0.5, name)[0],
               "V of the next head": fa._attention_cuda(q, k, v.roll(-1, dims=2).contiguous(),
                                                        kv_valid, qs, scale, name)[0]}
        torch.cuda.synchronize()
        faults = []
        for what, o in bad.items():
            e = float((o.float() - ref.float()).abs().max())
            check(e > KERNEL_ATOL, f"the {label} check missed a planted fault ({what}): {e}")
            faults.append(f"{what} {e:.3e}")
        allowed = _allowed(kv_valid, qs, T)
        lib_fn, lib_name, lib_err = _sdpa_narrow(q, k, v, allowed, scale, ref)
        ms, plain_ms, lib_ms = _ab_ms(lambda: fa._attention_cuda(*args, name),
                                      lambda: fa.attention_plain(*args), lib_fn)
        # q, the seen keys' K and V rows, the mask and qstart read; out and LSE written
        seen_keys = int(allowed.any(1).sum())
        nbytes = _nbytes(q, out, lse, kv_valid, qs) + seen_keys * nh * (dh + dv) * 2
        row = _row(err, ms, plain_ms, lib_ms, nbytes, 2 * (dh + dv) * nh * int(allowed.sum()))
        print(f"kernel {label}: max|diff| {err:.3e}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"{lib_name} {lib_ms:.4f} ms (max|diff| {lib_err:.3e}), bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); planted faults caught: "
              f"{', '.join(faults)} [{card}]", flush=True)
        if rk not in results:  # the table keeps the first shape of each
            results[rk] = row
        else:
            results[rk]["max_abs_err"] = max(results[rk]["max_abs_err"], err)
    # phase 1's (128, 128) K3 shape again, beside the narrow-V instance
    B, T, S = 4, 512, 640
    q, k, v = bf16(B, T, 12, 128), bf16(B, S, 2, 128), bf16(B, S, 2, 128)
    kv_valid = (torch.arange(S, device=dev)[None, :]
                < torch.tensor((512, 300, 450, 77), device=dev)[:, None]).to(torch.int32)
    qs = torch.zeros(B, dtype=torch.int32, device=dev)
    ms = _time_ms(lambda: fa._attention_cuda(q, k, v, kv_valid, qs, 128 ** -0.5,
                                             "flash_attention_cached"))
    print(f"kernel flash_attention_cached 12/2 heads dh 128 B=4 T=512 S=640 (phase 1's row, "
          f"timed again): {ms:.4f} ms [{card}]", flush=True)
    print(f"phase 1j took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def _sdpa_narrow_bwd(leaves, do, allowed, scale, ref):
    """One PyTorch call for the backward of attention with V narrower than
    Q/K (nh = nkv): the backward of SDPA through each fused backend that
    takes V of its own width (cuDNN, memory-efficient) and whose dq, dk, dv
    agree with the plain backward ``ref`` at K2's limit, the fastest of
    them; else the compiled ``flex_attention``'s backward, held to the same
    limit. Returns (fn giving (dq, dk, dv), what it ran, its worst share of
    the limit)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in leaves)
    taken = []
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed[:, None],
                                                     scale=scale)

            def fn(out=out):
                return torch.autograd.grad(out, leaves, do.transpose(1, 2), retain_graph=True)

            worst, errs = _bwd_close(fn(), ref)
            torch.cuda.synchronize()
        except RuntimeError as e:  # this backend does not take these inputs
            print(f"    sdpa {backend.name} backward with V of {vt.shape[-1]}: not taken "
                  f"({str(e).splitlines()[0][:80]})", flush=True)
            continue
        if worst > 1.0:
            print(f"    sdpa {backend.name} backward: max|diff| (dq, dk, dv) {errs} from the "
                  f"plain backward, not used", flush=True)
            continue
        ms = _time_ms(fn)
        print(f"    sdpa {backend.name} backward with V of {vt.shape[-1]}: {ms:.4f} ms (dq, dk, "
              f"dv; {worst:.2f} of the limit)", flush=True)
        taken.append((ms, fn, f"sdpa backward ({backend.name}, V of {vt.shape[-1]})", worst))
    if taken:
        _, fn, what, worst = min(taken, key=lambda t: t[0])
        return fn, what, worst
    out = _flex_softcap(*leaves, allowed, scale, 0.0)()

    def fn():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    worst, errs = _bwd_close(fn(), ref)
    check(worst <= 1.0, f"flex_attention backward (V narrower than Q/K): max|diff| {errs}")
    return fn, "compiled flex_attention backward (V of its own width)", worst


def check_backward_deepseek_kernels(dev, card):
    """Phase 1k: K2 with V narrower than Q/K at DeepSeek-V2-Lite's training
    shape (B=4 T=1024, 16/16 heads as MLA expands K/V per head, Q/K 192, V
    128, the model's scale mscale²/sqrt(192)), ragged masks with a hole as
    phase 1b, against the plain backward on the same bf16 inputs and the
    narrow-V forward kernel's (out, LSE): phase 1b's limits for dq, dk and
    dv. The scale of 1/sqrt(128) and dO read at the next head's offset
    (planted faults, on the same out and LSE) must fail the check. Timed in
    turns beside the plain version and the fastest single PyTorch call that
    takes V of 128 natively (``_sdpa_narrow_bwd``)."""
    import torch

    from lapha_tpu_torch.models.deepseek import DeepseekConfig
    from lapha_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    cfg = DeepseekConfig.from_hf(DEEPSEEK_V2_LITE_CONFIG)
    nh, dh, dv, scale = cfg.num_attention_heads, cfg.qk_head_dim_, cfg.v_head_dim, cfg.attn_scale_
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    B, T = 4, 1024

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k = bf16(B, T, nh, dh), bf16(B, T, nh, dh)
    v, do = bf16(B, T, nh, dv), bf16(B, T, nh, dv)
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.tensor((T, 700, 1000, 333), device=dev)[:, None]).to(torch.int32)
    mask[0, 100:140] = 0  # a hole of invalid keys
    qs = torch.zeros(B, dtype=torch.int32, device=dev)
    out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention")
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, mask, qs, lse, do, delta, scale)
    got = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
    _k2_repeats(args, got)
    ref = fa.attention_bwd_plain(*args)
    torch.cuda.synchronize()
    label = f"q/k {dh} v {dv} {nh}/{nh} heads (DeepSeek-V2-Lite) B={B} T={T}"
    check([tuple(t.shape) for t in got] == [(B, T, nh, dh), (B, T, nh, dh), (B, T, nh, dv)],
          f"K2 {label}: shapes")
    worst, errs = _bwd_close(got, ref)
    check(worst <= 1.0, f"K2 {label}: max|diff| (dq, dk, dv) {errs}, {worst:.3f} of the limit")
    faults = []
    for what, bad_args in (("scale 1/sqrt(128)", args[:-1] + (128 ** -0.5,)),
                           ("dO of the next head", args[:6] + (do.roll(-1, dims=2).contiguous(),)
                            + args[7:])):
        bad = (fa.attention_bwd_dq_cuda(*bad_args), *fa.attention_bwd_dkv_cuda(*bad_args))
        torch.cuda.synchronize()
        bad_worst, _ = _bwd_close(bad, ref)
        check(bad_worst > 1.0, f"the K2 {label} check missed a planted fault ({what})")
        faults.append(f"{what} {bad_worst:.3g} of the limit")
        del bad
    allowed = _allowed(mask, qs, T)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    lib, lib_name, lib_worst = _sdpa_narrow_bwd(leaves, do, allowed, scale, ref)
    ms_dq, pms_dq, lib_ms = _ab_ms(lambda: fa.attention_bwd_dq_cuda(*args),
                                   lambda: fa.attention_bwd_dq_plain(*args), lib)
    ms_kv, pms_kv, _ = _ab_ms(lambda: fa.attention_bwd_dkv_cuda(*args),
                              lambda: fa.attention_bwd_dkv_plain(*args))
    pairs = nh * int(allowed.sum())
    reads = _nbytes(q, k, v, do, mask, qs, lse, delta)
    # dq: S (over dh), dP (over dv), dQ (dh wide); dk/dv: S, dP, dV (dv wide), dK (dh wide)
    row_dq = _row(errs[0], ms_dq, pms_dq, lib_ms, reads + _nbytes(got[0]),
                  2 * (2 * dh + dv) * pairs)
    row_kv = _row(max(errs[1:]), ms_kv, pms_kv, lib_ms, reads + _nbytes(got[1], got[2]),
                  4 * (dh + dv) * pairs)
    print(f"kernel flash_attention_bwd {label}: max|diff| dq {errs[0]:.3e} dk {errs[1]:.3e} "
          f"dv {errs[2]:.3e} ({worst:.2f} of the limit); dq {ms_dq:.4f} ms (bound "
          f"{row_dq['bound_ms']:.4f}, {row_dq['bound_by']}) vs plain {pms_dq:.4f} ms, dk/dv "
          f"{ms_kv:.4f} ms (bound {row_kv['bound_ms']:.4f}, {row_kv['bound_by']}) vs plain "
          f"{pms_kv:.4f} ms, {lib_name} (dq, dk, dv; {lib_worst:.2f} of the limit) "
          f"{lib_ms:.4f} ms; {pairs} (query, key) pairs; planted faults caught: "
          f"{', '.join(faults)} [{card}]", flush=True)
    del leaves, lib, got, ref
    torch.cuda.empty_cache()
    print(f"phase 1k took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"flash_attention_bwd_dq_narrowv": row_dq, "flash_attention_bwd_dkv_narrowv": row_kv}


# phase 1l's decode cases: (label, heads, KV heads, head dim, window, the
# kernels line's row suffix or None for a case only printed)
DECODE_1L_CASES = (("Phi-3-mini", 32, 32, 96, 2047, "_dh96"),
                   ("Phi-3-mini heads, a band of 128", 32, 32, 96, 128, None),
                   ("group 9", 18, 2, 128, 4096, None),
                   ("StarCoder2-3B", 24, 2, 128, 4096, "_g12"),
                   ("group 16", 32, 2, 128, 4096, None),
                   ("group 32", 32, 1, 128, 4096, None))


def check_phi3_starcoder2_kernels(dev, card):
    """Phase 1l: the instances Phi-3 (head dim 96) and StarCoder2 (a GQA
    group of 12) run, each against its plain version on the same bf16
    inputs at phase 1/1b/1c's limits, timed in turns beside the plain
    version and one library call, each with a planted fault that must fail
    it. K3 (fresh prefill B=4 T=512 S=640) and K1 (B=4 T=512, padded rows)
    at Phi-3-mini's 32/32 heads of dim 96, full and at its window of 2047
    (the path's launches; the band does not bite at 512), and K3 banded
    where the band bites (T=512 at qstart 2048, S=2560); faults: K/V of the
    next head, and the window W + 1 where it bites. K2 at B=4 T=1024 32/32
    dh 96 with ragged masks, W=2047 (the path's launches); fault: dO of the
    next head. K4/K5 at B=24 S=640 over prompts up to 512, the window's
    clipped ranges on the odd rows (Phi-3's 2047 clips none: a band of 128
    is checked too), at Phi-3's 32/32 dh 96 and at groups of
    9, 12 (StarCoder2-3B's 24/2), 16 and 32 at dh 128; fault: K/V of the
    next layer. Library calls: SDPA with the boolean mask (its backward for
    K2); K5 has none."""
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
    from lapha_tpu_torch.models.qwen2 import _quantize_kv
    from lapha_tpu_torch.ops import flash_attention as fa
    from lapha_tpu_torch.ops import ragged_decode_attention as rda

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    nh, dh, W = 32, 96, 2047
    scale = dh ** -0.5

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    results = {}
    # ---------------- K1 / K3 at dh 96
    for name, B, T, S, qstart, window, row in (
            ("flash_attention_cached", 4, 512, 640, 0, 0, None),
            ("flash_attention_cached", 4, 512, 640, 0, W, "flash_attention_cached_window_dh96"),
            ("flash_attention", 4, 512, 512, 0, W, "flash_attention_window_dh96"),
            ("flash_attention_cached", 2, 512, 2560, 2048, W,
             "flash_attention_cached_window_dh96_past")):
        q, k, v = bf16(B, T, nh, dh), bf16(B, S, nh, dh), bf16(B, S, nh, dh)
        qs = torch.full((B,), qstart, dtype=torch.int32, device=dev)
        lens = torch.tensor([qstart + T, qstart + T - 17, qstart + T - 40, qstart + T][:B],
                            device=dev)
        kv_valid = (torch.arange(S, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        args = (q, k, v, kv_valid, qs, scale)
        out, lse = fa._attention_cuda(*args, name, window)
        ref, ref_lse = fa.attention_plain(*args, window)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        seen = ref_lse > -1e29
        label = (f"{fa.launch_name(name, window)} dh=96 {nh}/{nh} heads B={B} T={T} S={S} "
                 f"qstart={qstart} W={window}")
        check(bool(torch.isfinite(out.float()).all()) and err <= KERNEL_ATOL, f"{label}: {err}")
        check(float((lse[seen] - ref_lse[seen]).abs().max()) <= 1e-3, f"{label} LSE")
        _k1_repeats(lambda: fa._attention_cuda(*args, name, window), out, lse, label)
        allowed = _allowed(kv_valid, qs, T, window)
        bites = window and bool((~allowed & _allowed(kv_valid, qs, T)).any())
        faults = [("K/V of the next head", (q, k.roll(-1, 2), v.roll(-1, 2), kv_valid, qs, scale),
                   window)]
        if bites:
            faults.append(("window W + 1", args, window + 1))
        notes = []
        for what, bad_args, bad_w in faults:
            bad = fa._attention_cuda(*bad_args, name, bad_w)[0]
            torch.cuda.synchronize()
            bad_err = float((bad.float() - ref.float()).abs().max())
            check(bad_err > KERNEL_ATOL, f"the {label} check missed a planted fault ({what})")
            notes.append(f"planted fault ({what}) max|diff| {bad_err:.3e}, caught")
        ms, plain_ms, lib_ms = _ab_ms(lambda: fa._attention_cuda(*args, name, window),
                                      lambda: fa.attention_plain(*args, window),
                                      _sdpa(q, k, v, allowed, scale))
        seen_keys = int(allowed.any(1).sum())
        nbytes = _nbytes(q, out, lse, kv_valid, qs) + 2 * seen_keys * nh * dh * k.element_size()
        r = _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh * nh * int(allowed.sum()))
        print(f"kernel {label}: max|diff| {err:.3e}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, "
              f"sdpa {lib_ms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{'; '.join(notes)} [{card}]", flush=True)
        if row is not None:
            results[row] = r

    # ---------------- K2 at dh 96
    B, T = 4, 1024
    q, do = bf16(B, T, nh, dh), bf16(B, T, nh, dh)
    k, v = bf16(B, T, nh, dh), bf16(B, T, nh, dh)
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.tensor([T, 700, 1000, 333], device=dev)[:, None]).to(torch.int32)
    mask[0, 100:140] = 0  # a hole of invalid keys
    qs = torch.zeros(B, dtype=torch.int32, device=dev)
    out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", W)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, mask, qs, lse, do, delta, scale, W)
    got = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
    _k2_repeats(args, got)
    ref = fa.attention_bwd_plain(*args)
    torch.cuda.synchronize()
    worst, errs = _bwd_close(got, ref)
    label = f"dh=96 {nh}/{nh} heads (Phi-3-mini) B={B} T={T} W={W}"
    check(worst <= 1.0, f"K2 {label}: max|diff| (dq, dk, dv) {errs}, {worst:.3f} of the limit")
    bad_do = do.roll(-1, 2)
    bad_args = args[:6] + (bad_do, (bad_do.float() * out.float()).sum(-1)) + args[8:]
    bad = (fa.attention_bwd_dq_cuda(*bad_args), *fa.attention_bwd_dkv_cuda(*bad_args))
    torch.cuda.synchronize()
    bad_worst, _ = _bwd_close(bad, ref)
    check(bad_worst > 1.0, f"the K2 {label} check missed a planted fault (dO of the next head)")
    del bad
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    allowed = _allowed(mask, qs, T, W)
    lib_out = _sdpa(*leaves, allowed, scale)()

    def lib():
        return torch.autograd.grad(lib_out, leaves, do.transpose(1, 2), retain_graph=True)

    ms_dq, pms_dq, lib_ms = _ab_ms(lambda: fa.attention_bwd_dq_cuda(*args),
                                   lambda: fa.attention_bwd_dq_plain(*args), lib)
    ms_kv, pms_kv, _ = _ab_ms(lambda: fa.attention_bwd_dkv_cuda(*args),
                              lambda: fa.attention_bwd_dkv_plain(*args))
    pairs = nh * int(allowed.sum())
    reads = _nbytes(q, k, v, do, mask, qs, lse, delta)
    row_dq = _row(errs[0], ms_dq, pms_dq, lib_ms, reads + _nbytes(got[0]), 6 * dh * pairs)
    row_kv = _row(max(errs[1:]), ms_kv, pms_kv, lib_ms, reads + _nbytes(got[1], got[2]),
                  8 * dh * pairs)
    print(f"kernel flash_attention_bwd {label}: max|diff| dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
          f"{errs[2]:.3e} ({worst:.2f} of the limit); dq {ms_dq:.4f} ms (bound "
          f"{row_dq['bound_ms']:.4f}, {row_dq['bound_by']}) vs plain {pms_dq:.4f} ms, dk/dv "
          f"{ms_kv:.4f} ms (bound {row_kv['bound_ms']:.4f}) vs plain {pms_kv:.4f} ms, sdpa "
          f"backward (boolean mask; dq, dk, dv) {lib_ms:.4f} ms; planted fault (dO of the next "
          f"head) {bad_worst:.3g} of the limit, caught [{card}]", flush=True)
    results["flash_attention_bwd_dq_window_dh96"] = row_dq
    results["flash_attention_bwd_dkv_window_dh96"] = row_kv
    del leaves, lib_out, got, ref, q, k, v, do

    # ---------------- K4 / K5 at dh 96 and at groups above 8
    L, B, S, slot = 2, 24, 640, 600
    for fam, nh_c, nkv, dh_c, W_c, suffix in DECODE_1L_CASES:
        scale_c = dh_c ** -0.5
        q = bf16(B, nh_c, dh_c)
        kc, vc = bf16(L, B, nkv, S, dh_c), bf16(L, B, nkv, S, dh_c)
        lens = torch.randint(64, 513, (B,), generator=gen, device=dev).to(torch.int32)
        pos = lens + (slot - 512)
        odd = torch.arange(B, device=dev) % 2 == 1
        pstart = torch.where(odd, torch.minimum(torch.clamp(pos - (W_c - 1), min=0), lens),
                             torch.zeros_like(lens)).to(torch.int32)
        dstart = torch.where(odd, torch.full_like(lens, max(512, slot - (W_c - 1))),
                             torch.full_like(lens, 512)).to(torch.int32)
        valid = _decode_valid(lens, dstart, slot, S, pstart)
        n_valid = int(valid.sum())
        (kq, ks), (vq, vs) = _quantize_kv(kc), _quantize_kv(vc)
        for name, kk, vv, scl in (("ragged_decode_attention", kc, vc, None),
                                  ("ragged_decode_attention_q8", kq, vq, (ks, vs))):
            def kernel(layer=1, kk=kk, vv=vv, scl=scl):
                return rda.ragged_decode_attention(q, kk, vv, layer, lens, dstart, slot, pstart,
                                                   scale_c, cache_scale=scl)

            def plain(kk=kk, vv=vv, scl=scl):
                return rda.ragged_decode_plain(q, kk, vv, 1, lens, dstart, slot, pstart, scale_c,
                                               cache_scale=scl)

            def excess(out, ref, scl=scl):
                if scl is not None:
                    return _q8_excess(out, ref)
                return float((out.float() - ref.float()).abs().max()) - KERNEL_ATOL

            out, ref, bad = kernel(), plain(), kernel(layer=0)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            label = (f"{name} ({fam}) dh={dh_c} {nh_c}/{nkv} heads (group {nh_c // nkv}) B={B} "
                     f"S={S} slot={slot} W={W_c}")
            check(bool(torch.isfinite(out.float()).all()) and excess(out, ref) <= 0,
                  f"{label}: max|diff| {err}")
            check(excess(bad, ref) > 0,
                  f"the {label} check missed a planted fault (K/V of the next layer)")
            lib_fn, lib = None, "none (no one call reads an int8 cache)"
            if scl is None:
                lib_fn = _sdpa(q[:, None], kc[1].transpose(1, 2), vc[1].transpose(1, 2),
                               valid[:, None, :], scale_c)
                lib = "sdpa"
            ms, plain_ms, lib_ms = _ab_ms(kernel, plain, lib_fn, timer=graph_ms)
            if lib_ms is not None:
                lib = f"{lib} {lib_ms:.4f} ms"
            # K and V of the valid slots per KV head (int8: + two f32
            # scales), q, the ranges and out
            per_slot = 2 * dh_c * (1 if scl is not None else 2) + (8 if scl is not None else 0)
            nbytes = n_valid * nkv * per_slot + 2 * _nbytes(q) + _nbytes(lens, dstart, pstart)
            r = _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh_c * nh_c * n_valid)
            print(f"kernel {label}: max|diff| {err:.3e}, {ms:.4f} ms vs plain {plain_ms:.4f} "
                  f"ms, {lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); planted fault "
                  f"(K/V of the next layer) max|diff| "
                  f"{float((bad.float() - ref.float()).abs().max()):.3e}, caught [{card}]",
                  flush=True)
            if suffix is not None:
                results[name + suffix] = r
    print(f"phase 1l took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def _deepseek_model(dev, card):
    """DeepSeek-V2-Lite at full width and depth from its published config,
    random bf16 weights from the seed (the JAX init's scales)."""
    import torch

    from lapha_tpu_torch.models import deepseek, quant, value_model

    cfg = deepseek.DeepseekConfig.from_hf(DEEPSEEK_V2_LITE_CONFIG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = deepseek.init_params(cfg, gen)
    head = value_model.init_value_head(cfg.hidden_size, gen)
    torch.cuda.synchronize()
    print(f"DeepSeek-V2-Lite weights ({cfg.num_hidden_layers} layers: {cfg.num_dense_layers_} "
          f"dense of I {cfg.intermediate_size}, {cfg.num_moe_layers_} MoE; H {cfg.hidden_size}, "
          f"{cfg.num_attention_heads} heads, MLA kv_lora {cfg.kv_lora_rank}, q/k "
          f"{cfg.qk_head_dim_}, v {cfg.v_head_dim}, {cfg.n_routed_experts} experts top-"
          f"{cfg.num_experts_per_tok} of {cfg.moe_intermediate_size} + {cfg.n_shared_experts} "
          f"shared, V {cfg.vocab_size}, rope {cfg.rope_scaling[:2]}; random bf16): "
          f"{quant.params_nbytes(params) / 1e9:.2f} GB made in {time.perf_counter() - t0:.2f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]", flush=True)
    return params, head, cfg


def _deepseek_reference(params, cfg, dev, T=96, S=128, strict=True, note=""):
    """Phase 2h's run: layers 0 (dense) and 1 (MoE) of the full-width
    model, kernels (card, bf16) vs plain versions (CPU, f32): cached
    prefill logits of prompts of T and T - 26 tokens, then one decode step
    over the bf16 latent cache and one over its int8 quantization."""
    import dataclasses

    import numpy as np
    import torch

    from lapha_tpu_torch.engine.engine import Engine
    from lapha_tpu_torch.models import deepseek
    from lapha_tpu_torch.train.losses import tree_map

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2)
    sub = {k: v for k, v in params.items() if k != "moe_layers"}
    sub["moe_layers"] = tree_map(lambda t: t[:1], params["moe_layers"])
    cpu = tree_map(lambda t: t.detach().to("cpu", torch.float32), sub)
    rng = np.random.default_rng(SEED + 21)
    B = 2
    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, T)))
    lens = torch.tensor([T, T - 26])
    mask = (torch.arange(T)[None, :] < lens[:, None]).long()
    kv_valid = torch.zeros((B, S), dtype=torch.bool)
    kv_valid[:, :T] = mask > 0
    pos = (mask.cumsum(1) - 1).clamp(min=0)
    nxt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B,)))

    def run(p, c, device):
        with torch.inference_mode():
            cache = deepseek.init_kv_cache(c, B, S, device)
            logits, _, cache = deepseek.forward(p, c, ids.to(device), positions=pos.to(device),
                                                kv_cache=cache, cache_pos=0,
                                                kv_valid=kv_valid.to(device))
            ck, cv = (x.permute(0, 1, 3, 2, 4).contiguous() for x in cache)
            steps = []
            for k, v, scl in ((ck.clone(), cv, None), Engine._quantize_cache(ck, cv)):
                steps.append(deepseek.decode_step(
                    p, c, nxt.to(device), lens.to(device), k, v, T, lens.to(device, torch.int32),
                    torch.full((B,), T, dtype=torch.int32, device=device),
                    cache_scale=scl)[0].float().cpu())
        return logits.float().cpu(), steps

    g_logits, g_steps = run(sub, cfg2, dev)
    c_logits, c_steps = run(cpu, dataclasses.replace(cfg2, dtype=torch.float32),
                            torch.device("cpu"))
    errs = [_rel(g_logits[mask > 0], c_logits[mask > 0])] + [
        _rel(a, b) for a, b in zip(g_steps, c_steps)]
    print(f"reference check (DeepSeek-V2-Lite layers 0 dense + 1 MoE{note}; card kernels bf16 "
          f"vs CPU plain f32): prefill logits rel err {errs[0]:.3e}, decode logits rel err "
          f"{errs[1]:.3e} (bf16 latent cache), {errs[2]:.3e} (int8 latent cache)", flush=True)
    check(not strict or max(errs) <= REF_RTOL, f"DeepSeek reference rel errs {errs}")


def check_deepseek_reference(params, cfg, dev):
    """Phase 2h: ``_deepseek_reference`` with the routing choices of the
    card and the CPU counted, then with the card's routing replayed on the
    CPU (phase 2e's recipe): the check is held on the replayed run."""
    from lapha_tpu_torch.ops import moe

    seen, route = [], moe.route_deepseek

    def recording(x, *a, **kw):
        topw, topi = route(x, *a, **kw)
        seen.append((topw.float().cpu(), topi.cpu()))
        return topw, topi

    t0 = time.perf_counter()
    moe.route_deepseek = recording
    try:
        _deepseek_reference(params, cfg, dev, strict=False, note=", routing free")
    finally:
        moe.route_deepseek = route
    half = len(seen) // 2  # the card's calls, then the CPU's, in the same order
    card = seen[:half]
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for (_, a), (_, b) in zip(card, seen[half:]))
    rows = sum(a.shape[0] for _, a in card)
    print(f"routing: {flips} of {rows} (token, layer) top-{cfg.num_experts_per_tok} choices "
          f"differ between the card (bf16) and the CPU (f32) in the DeepSeek two-layer check",
          flush=True)
    replay = iter(card)
    calls = iter(range(2 * half))

    def replaying(x, *a, **kw):  # the card's calls come first
        return route(x, *a, **kw) if next(calls) < half else next(replay)

    moe.route_deepseek = replaying
    try:
        _deepseek_reference(params, cfg, dev, note=", the card's routing replayed on the CPU")
    finally:
        moe.route_deepseek = route
    print(f"phase 2h took {time.perf_counter() - t0:.1f} s", flush=True)


def serve_deepseek(dev, card):
    """Phases 2h and 15 on DeepSeek-V2-Lite, made here and freed before the
    return. Returns the launch counts of the counted rounds."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    t_phase = time.perf_counter()
    params, head, cfg = _deepseek_model(dev, card)
    check_deepseek_reference(params, cfg, dev)

    P, n, plen, new = 4, 6, 512, 64
    kw = dict(max_model_len=plen + 2 * new + 128, max_batch=P * n, decode_chunk=32,
              pad_multiple=128, batch_bucket=1, eos_token_ids=[], seed=SEED, collect_h0=True)
    engines = {kv: Engine(params, cfg, IdTok(), kv_quant=kv, **kw) for kv in (None, "int8")}
    vf = ValueFunction(params, head, cfg, max_model_len=1024, pad_multiple=128, batch_bucket=P)
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    rng = np.random.default_rng(SEED + 22)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    runs = {kv: _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
            for kv, eng in engines.items()}
    launches = dict(_cuda.LAUNCHES)
    # prefill on the wgmma K8 (2048 tokens x top-6), decode on the decode kernel
    ran = ("flash_attention_narrowv", "flash_attention_cached_narrowv", "grouped_gemm",
           "grouped_gemm_wg")
    for name in ran:
        check(launches[name] > 0, f"{name} never launched on the DeepSeek served path")
    for name, count in launches.items():  # no dh = dv flash instance, no decode kernel
        check(name in ran or count == 0, f"{name} ran {count} times on the DeepSeek served path")
    for kv, run in runs.items():
        label = f"DeepSeek-V2-Lite, {'bf16' if kv is None else 'int8'} latent cache"
        limit = REF_RTOL if kv is None else FUSED_Q8_RTOL
        e_free = _check_round(run, vf, cfg.vocab_size, cfg.hidden_size, P, n, P, new, None)
        if e_free > limit:  # routing flips: replay the engine's routing (phase 11's C5 check)
            _, e_free = check_h0_routing_replayed(engines[kv], vf, cfg, rng, plen, new, new,
                                                  label, router="route_deepseek")
        check(e_free <= limit, f"fused value rel err {e_free} ({label})")
        print(f"{label}: first (cold) round {run['t_all']:.2f} s [{card}]", flush=True)
    print(f"launches on the DeepSeek served path (a bf16-latent round, then an int8-latent "
          f"round): {launches}", flush=True)
    # the cache pair's inert second plane (JAX's contract), at the decode install
    S = -(-(plen + new) // 128) * 128  # the engine's slab: prompt + budget, in pad_multiple
    plane = cfg.num_hidden_layers * P * n * S * cfg.cache_width_
    print(f"DeepSeek latent cache at {P * n} rows x S={S}: {plane * 2 / 1e6:.1f} MB a plane in "
          f"bf16 ({plane * 1 / 1e6:.1f} MB int8 + {plane // cfg.cache_width_ * 4 / 1e6:.1f} MB "
          f"of scales); the inert second plane doubles it", flush=True)

    for kv, eng in engines.items():
        warm = _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
        _report_warm(f"DeepSeek-V2-Lite ({'bf16' if kv is None else 'int8'} latent cache)", warm,
                     params, P, n, new, card)
    del engines, vf, runs, warm
    torch.cuda.empty_cache()
    _profile_served("DeepSeek-V2-Lite", params, cfg, P * n, plen, plen + 2 * new, SEED + 23, card)
    del params, head
    torch.cuda.empty_cache()
    print(f"phases 2h and 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# chip_smoke's phase-3 model (Qwen2.5-1.5B's widths), the dense yardstick of --c5
DENSE_1_5B = dict(vocab_size=151936, hidden_size=1536, intermediate_size=8960,
                  num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
                  max_position_embeddings=4096, rope_theta=1e6)


def probe_c5(dev, card) -> None:
    """``--c5`` (ROADMAP C5): where GPT-OSS-20B's fused-h0 gap comes from.
    Phase 11's replayed-routing check (one fresh parent of 512 tokens, its
    prefix-hit child of 576, n = 1, 64 new tokens, bf16 KV) under variants
    that each take one component out of both paths: ``kernels`` (as served),
    ``plain-decode`` / ``plain-flash`` / ``plain-attention`` / ``plain-gemm``
    (that kernel's plain version instead), ``no-sinks`` (sinks at -30: their
    column vanishes), ``no-windows`` (every layer full), ``repeat`` (the
    baseline again: the spread between runs), ``depth-6`` / ``depth-12``
    (the first 6 / 12 layers), ``depth-6-plain`` (6 layers, every kernel's
    plain version, bf16) and ``depth-6-f32`` (the same in f32: weights,
    cache and activations; what is left is the two paths' logic, not bf16).
    Then each model's sensitivity to bf16 rounding alone: the value forward
    over 640 tokens twice, the second time with the input embeddings times
    (1 + 2^-9 z), z ~ N(0, 1), and the relative change of the pooled h0, for
    GPT-OSS-20B with its sinks and with them at -30, and for the dense
    phase-3 model. The plain versions run on CUDA tensors only inside this
    probe; the port's wrappers never take them for a CUDA tensor."""
    import dataclasses

    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine
    from lapha_tpu_torch.models import qwen2, value_model
    from lapha_tpu_torch.ops import flash_attention as fa
    from lapha_tpu_torch.ops import grouped_gemm as gg
    from lapha_tpu_torch.ops import ragged_decode_attention as rda
    from lapha_tpu_torch.search import ValueFunction
    from lapha_tpu_torch.train.losses import tree_map

    params, head, cfg = _gptoss_model(dev, card)
    sinks = params["layers"]["attn"]["sinks"]

    def plain_flash(q, k, v, kv_valid, qstart, scale, name, window=0, softcap=0.0):
        return fa.attention_plain(q, k, v, kv_valid, qstart, scale, window, softcap=softcap)

    def plain_decode(q, kc, vc, layer, lens, dstart, slot, pstart, scale, cache_scale, sinks_,
                     softcap=0.0):
        return rda.ragged_decode_plain(q, kc, vc, layer, lens, dstart, slot, pstart, scale,
                                       cache_scale=cache_scale, sinks=sinks_, softcap=softcap)

    decode, flash = {(rda, "_ragged_cuda"): plain_decode}, {(fa, "_attention_cuda"): plain_flash}
    gemm = {(gg, "_grouped_gemm_cuda"): gg.grouped_gemm_plain}
    patches = {"kernels": {}, "plain-decode": decode, "plain-flash": flash,
               "plain-attention": {**decode, **flash}, "plain-gemm": gemm, "no-sinks": {},
               "no-windows": {}, "repeat": {}, "depth-6": {}, "depth-12": {},
               "depth-6-plain": {**decode, **flash, **gemm},
               "depth-6-f32": {**decode, **flash, **gemm}}
    kw = dict(max_model_len=768, max_batch=1, decode_chunk=32, pad_multiple=128, batch_bucket=1,
              eos_token_ids=[], seed=SEED, collect_h0=True)
    for variant, patch in patches.items():
        t0 = time.perf_counter()
        c, p = cfg, params
        if variant == "no-windows":
            c = dataclasses.replace(cfg, layer_windows=(0,) * cfg.num_hidden_layers)
        if variant.startswith("depth-"):
            n = int(variant.split("-")[1])
            c = dataclasses.replace(cfg, num_hidden_layers=n, layer_windows=cfg.layer_windows[:n])
            p = dict(params, layers=tree_map(lambda t: t[:n], params["layers"]))
        if variant.endswith("-f32"):
            c = dataclasses.replace(c, dtype=torch.float32)
            p = tree_map(lambda t: t.float() if t.is_floating_point() else t, p)
        saved_sinks = sinks.clone()
        if variant == "no-sinks":
            sinks.fill_(-30.0)
        saved = {(mod, attr): getattr(mod, attr) for mod, attr in patch}
        for (mod, attr), fn in patch.items():
            setattr(mod, attr, fn)
        try:
            eng = Engine(p, c, IdTok(), **kw)
            vf = ValueFunction(p, head, c, max_model_len=1024, pad_multiple=128, batch_bucket=1)
            rng = np.random.default_rng(SEED + 20)  # the same prompts in every variant
            free, replayed = check_h0_routing_replayed(eng, vf, c, rng, 512, 64, 64,
                                                       f"C5 probe {variant}")
        finally:
            for (mod, attr), fn in saved.items():
                setattr(mod, attr, fn)
            sinks.copy_(saved_sinks)
        print(f"C5 probe variant {variant}: pooled h0 rel err {free:.3e} free, {replayed:.3e} "
              f"replayed ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
        del eng, vf, p
        torch.cuda.empty_cache()

    embed = qwen2._embed
    ids = np.random.default_rng(SEED + 21).integers(2, DENSE_1_5B["vocab_size"], (1, 640))
    ones = np.ones_like(ids, dtype=np.int32)

    def sensitivity(p, hd, c, label):
        vf = ValueFunction(p, hd, c, max_model_len=1024, pad_multiple=128, batch_bucket=1)
        _, _, h_ref = vf(ids, ones, return_h0=True)
        gen = torch.Generator(device=dev).manual_seed(SEED + 22)

        def perturbed(params_, cfg_, toks):
            x = embed(params_, cfg_, toks)
            z = torch.randn(x.shape, generator=gen, device=x.device)
            return (x.float() * (1.0 + 2.0 ** -9 * z)).to(x.dtype)

        qwen2._embed = perturbed
        try:
            _, _, h_pert = vf(ids, ones, return_h0=True)
        finally:
            qwen2._embed = embed
        err = float(np.linalg.norm(h_pert[0] - h_ref[0]) / np.linalg.norm(h_ref[0]))
        print(f"C5 sensitivity {label}: pooled h0 rel change {err:.3e} for inputs perturbed by "
              f"2^-9 relative (640 tokens, value forward, bf16) [{card}]", flush=True)

    sensitivity(params, head, cfg, "GPT-OSS-20B")
    saved_sinks = sinks.clone()
    sinks.fill_(-30.0)
    sensitivity(params, head, cfg, "GPT-OSS-20B, sinks -30")
    sinks.copy_(saved_sinks)
    del params, head, sinks, saved_sinks
    torch.cuda.empty_cache()
    dense = qwen2.Qwen2Config(**DENSE_1_5B, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dp = qwen2.init_params(dense, gen)
    sensitivity(dp, value_model.init_value_head(dense.hidden_size, gen), dense, "Qwen2.5-1.5B")


def check_backward_kernels(dev, card):
    """Phase 1b: the dq and dk/dv kernels vs the plain backward."""
    import numpy as np
    import torch

    from lapha_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(SEED + 3)
    nh, nkv, dh = 12, 2, 128
    scale = dh ** -0.5

    def bf16(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, torch.bfloat16)

    results, errs_all = {}, {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    for B, T, lens in ((4, 1024, (1024, 700, 1000, 333)), (2, 1000, (1000, 871))):
        q, do = bf16(B, T, nh, dh), bf16(B, T, nh, dh)
        k, v = bf16(B, T, nkv, dh), bf16(B, T, nkv, dh)
        mask = (torch.arange(T, device=dev)[None, :]
                < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)
        mask[0, 100:140] = 0  # a hole of invalid keys
        qs = torch.zeros(B, dtype=torch.int32, device=dev)
        out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention")
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, mask, qs, lse, do, delta, scale)
        got = (fa.attention_bwd_dq_cuda(*args), *fa.attention_bwd_dkv_cuda(*args))
        _k2_repeats(args, got)
        ref = fa.attention_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, ref):
            a, b = a.float(), b.float()
            check(torch.isfinite(a).all(), f"{name} finite")
            err, top = float((a - b).abs().max()), float(b.abs().max())
            check(err <= BWD_RTOL * top + BWD_ATOL,
                  f"{name} B={B} T={T}: max|diff| {err} vs max|plain| {top}")
            errs.append(err)
            print(f"kernel flash_attention_bwd {name} B={B} T={T}: max|diff| {err:.3e} "
                  f"(max|plain| {top:.3e}, bound {BWD_RTOL * top + BWD_ATOL:.3e})", flush=True)
        errs_all["flash_attention_bwd_dq"] = max(errs_all["flash_attention_bwd_dq"], errs[0])
        errs_all["flash_attention_bwd_dkv"] = max(errs_all["flash_attention_bwd_dkv"], *errs[1:])
        # the library yardstick: SDPA's backward (dq, dk and dv in one call)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        allowed = _allowed(mask, qs, T)
        lib_out = _sdpa(*leaves, allowed, scale)()

        def lib():
            return torch.autograd.grad(lib_out, leaves, do.transpose(1, 2), retain_graph=True)

        ms_dq, pms_dq, lib_ms = _ab_ms(lambda: fa.attention_bwd_dq_cuda(*args),
                                       lambda: fa.attention_bwd_dq_plain(*args), lib)
        ms_kv, pms_kv, _ = _ab_ms(lambda: fa.attention_bwd_dkv_cuda(*args),
                                  lambda: fa.attention_bwd_dkv_plain(*args))
        print(f"kernel flash_attention_bwd_dq B={B} T={T}: {ms_dq:.4f} ms vs plain {pms_dq:.4f} ms; "
              f"flash_attention_bwd_dkv: {ms_kv:.4f} ms vs plain {pms_kv:.4f} ms; sdpa backward "
              f"(dq, dk, dv) {lib_ms:.4f} ms [{card}]", flush=True)
        if B == 4:  # the table keeps the first shape's times
            pairs = nh * int(allowed.sum())
            reads = _nbytes(q, k, v, do, mask, qs, lse, delta)
            # dq recomputes S and dP and forms dq: 3 products; dk/dv: S, dP, dV, dK
            results["flash_attention_bwd_dq"] = _row(0.0, ms_dq, pms_dq, lib_ms,
                                                     reads + _nbytes(got[0]), 6 * dh * pairs)
            results["flash_attention_bwd_dkv"] = _row(0.0, ms_kv, pms_kv, lib_ms,
                                                      reads + _nbytes(got[1], got[2]), 8 * dh * pairs)
        del leaves, lib_out
    for name, err in errs_all.items():
        results[name]["max_abs_err"] = err
    return results


def _two_layers(params, cfg):
    """The first two layers of the model, on the card and as f32 on the CPU."""
    import dataclasses

    import torch

    from lapha_tpu_torch.train.losses import tree_map

    cfg2 = dataclasses.replace(cfg, num_hidden_layers=2, layer_windows=cfg.layer_windows[:2])
    sub = dict(params, layers=tree_map(lambda t: t[:2], params["layers"]))
    cpu = tree_map(lambda t: t.detach().to("cpu", torch.float32), sub)
    return sub, cfg2, cpu, dataclasses.replace(cfg2, dtype=torch.float32)


def check_small_reference(params, cfg, dev, bits=None, note="", T=96, S=128, strict=True):
    """Phase 2: two layers of the full-width model, kernels (card, bf16) vs
    plain versions (CPU, f32): cached prefill logits of prompts of T and
    T - 26 tokens and one decode step. Phase 2c (``bits`` 4 or 8): the same
    with ``quantize_params(bits=)`` weights and an int8 KV cache for the
    decode step. ``note`` names a variant in the printed line; with
    ``strict`` False the errors are printed, not checked."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine.engine import Engine
    from lapha_tpu_torch.models import quant, qwen2

    sub, cfg2, cpu, cfg_cpu = _two_layers(params, cfg)
    if bits is not None:
        sub = quant.quantize_params(sub, bits=bits)
        cpu = quant.tree_to(sub, "cpu", torch.float32)
    rng = np.random.default_rng(SEED + 1)
    B = 2
    ids = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, T)))
    lens = torch.tensor([T, T - 26])
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
            scl = None
            if bits is not None:
                ck, cv, scl = Engine._quantize_cache(ck, cv)
            step = qwen2.decode_step(
                p, c, nxt.to(device), lens.to(device), ck, cv, T,
                lens.to(device, torch.int32), torch.full((B,), T, dtype=torch.int32, device=device),
                cache_scale=scl)[0]
        return logits.float().cpu(), step.float().cpu()

    g_logits, g_step = run(sub, cfg2, dev)
    c_logits, c_step = run(cpu, cfg_cpu, torch.device("cpu"))
    real = mask > 0
    e_prefill = _rel(g_logits[real], c_logits[real])
    e_decode = _rel(g_step, c_step)
    what = note + ("" if bits is None else
                   f", int{bits} weights (int8 embed/head), int8 KV cache for the decode step")
    print(f"reference check (2 layers{what}; card kernels bf16 vs CPU plain f32): prefill logits "
          f"rel err {e_prefill:.3e}, decode logits rel err {e_decode:.3e}", flush=True)
    check(not strict or (e_prefill <= REF_RTOL and e_decode <= REF_RTOL),
          f"reference rel err prefill {e_prefill} decode {e_decode} (bits {bits})")


def _packed_batch(rng, vocab, prompt_lens, comp_lens, dev):
    """A packed training batch (losses.pack_samples) of random rows, with
    random advantages and value targets (scripts/bench_train.py's recipe)."""
    import numpy as np
    import torch

    from lapha_tpu_torch.train import losses

    samples = [dict(prompt_ids=rng.integers(2, vocab, lp).tolist(),
                    completion_ids=rng.integers(2, vocab, lc).tolist())
               for lp, lc in zip(prompt_lens, comp_lens)]
    packed = losses.pack_samples(samples, pad_id=0, eos_id=1,
                                 max_prompt_length=max(prompt_lens), pad_multiple=128,
                                 batch_multiple=1)
    batch = losses.batch_to_device(packed, dev)
    B = batch["ids"].shape[0]
    batch["advantages"] = torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(dev)
    batch["v_target"] = torch.from_numpy(rng.uniform(size=B).astype(np.float32)).to(dev)
    return batch


LOSS_KW = dict(temperature=1.0, eps_low=0.2, eps_high=0.2, loss_type="grpo",
               importance_level="token", value_w=1.0, beta=0.0)


def _loss_grads(p, h, c, b, kw, copy=True):
    """(loss, every leaf's gradient as f32 on the CPU) of loss_and_metrics on
    copies of the trees (on the trees themselves when ``copy`` is False:
    their leaves are made to require gradients)."""
    import torch

    from lapha_tpu_torch.train import losses

    if copy:
        p = losses.tree_map(lambda t: t.detach().clone(), p)
        h = losses.tree_map(lambda t: t.detach().clone(), h)
    leaves = losses._trainable(p, h)
    loss, _ = losses.loss_and_metrics(p, h, b, c, **kw)
    return float(loss.detach()), [g.float().cpu() for g in torch.autograd.grad(loss, leaves)]


def _check_leaf_grads(names, g_card, g_cpu) -> tuple[float, str]:
    """Relative error per leaf <= REF_RTOL; returns the worst and its leaf."""
    import numpy as np

    ref_qb = g_cpu[names.index("0.layers.attn.q_proj.b")].norm()
    worst, worst_name = 0.0, ""
    for name, a, b in zip(names, g_card, g_cpu):
        if name.endswith("k_proj.b"):
            # zero analytically without a softcap or k norm (softmax is
            # shift-invariant along a row): both sides then hold rounding
            # noise, bounded against the q bias gradient; through Gemma-2's
            # softcap it is a gradient of its own size
            err = float((a - b).norm() / max(ref_qb, b.norm()).clamp(min=1e-30))
        else:
            err = float((a - b).norm() / b.norm().clamp(min=1e-30))
        if err >= worst:
            worst, worst_name = err, name
        check(np.isfinite(err) and err <= REF_RTOL, f"gradient {name}: rel err {err}")
    return worst, worst_name


def check_gradient_reference(params, head, cfg, dev, prompt_lens=(90, 40), comp_lens=(30, 60),
                             label=""):
    """Phase 2b: loss_and_metrics gradients of two full-width layers, card
    (bf16, kernels) vs CPU (f32, plain), on one packed batch of rows of
    ``prompt_lens`` + ``comp_lens`` tokens. Returns the batch on the card."""
    import numpy as np

    from lapha_tpu_torch.train import losses

    sub, cfg2, cpu, cfg_cpu = _two_layers(params, cfg)
    rng = np.random.default_rng(SEED + 4)
    batch = _packed_batch(rng, cfg.vocab_size, prompt_lens, comp_lens, dev)
    kw = dict(LOSS_KW, max_completion_length=max(comp_lens) + 4, remat="full")
    head_cpu = losses.tree_map(lambda t: t.detach().cpu(), head)
    g_loss, g_card = _loss_grads(sub, head, cfg2, batch, kw)
    c_loss, g_cpu = _loss_grads(cpu, head_cpu, cfg_cpu, losses.batch_to_device(batch, "cpu"), kw,
                                copy=False)
    names = [n for n, _ in losses.tree_paths((sub, head))]
    worst, worst_name = _check_leaf_grads(names, g_card, g_cpu)
    print(f"gradient reference ({label or '2 layers'}, T={batch['ids'].shape[1]}, card kernels "
          f"bf16 vs CPU plain f32): loss {g_loss:.6f} vs {c_loss:.6f}; worst leaf rel err "
          f"{worst:.3e} ({worst_name}) over {len(names)} leaves (params + value head)",
          flush=True)
    return batch


def check_moe_gradient_reference(params, head, cfg, dev, label, prompt_lens, comp_lens):
    """Phase 2g: phase 2b's check on two full-width MoE layers (routing,
    K8 and its backward, K1/K2; GPT-OSS: sinks, the window band at dh 64),
    remat off so that each router runs once a layer. The card's routing
    choices are recorded and replayed on the CPU, where the combine weights
    are recomputed from the CPU's own router at the card's choices (so the
    router's gradient is the CPU's); the choices the CPU would have made
    otherwise are counted. Relative error per leaf <= REF_RTOL; an expert
    that got no rows has an all-zero gradient on both sides."""
    import numpy as np
    import torch

    from lapha_tpu_torch.models.quant import dequant
    from lapha_tpu_torch.models.qwen2 import _mm_f32
    from lapha_tpu_torch.ops import moe
    from lapha_tpu_torch.train import losses

    t0 = time.perf_counter()
    sub, cfg2, cpu, cfg_cpu = _two_layers(params, cfg)
    rng = np.random.default_rng(SEED + 22)
    batch = _packed_batch(rng, cfg.vocab_size, prompt_lens, comp_lens, dev)
    kw = dict(LOSS_KW, max_completion_length=max(comp_lens), remat=False)
    gptoss = cfg.moe_style == "gptoss"
    fn_name = "route_topk_softmax" if gptoss else "route"
    own = getattr(moe, fn_name)
    card_topi, flips = [], [0, 0]

    def recording(*args):
        topw, topi = own(*args)
        card_topi.append(topi.detach().cpu())
        return topw, topi

    def replaying(x, router_w, *rest):
        topi = next(replay).to(x.device).long()
        logits = _mm_f32(x, dequant(router_w, x.dtype))
        if gptoss:  # route_topk_softmax at the card's choices
            router_b, top_k = rest
            logits = logits + router_b.float()
            mine = torch.topk(logits, top_k, dim=-1).indices
            topw = torch.softmax(logits.gather(1, topi), dim=-1)
        else:       # route at the card's choices
            top_k, norm_topk = rest
            probs = torch.softmax(logits, dim=-1)
            mine = torch.topk(probs, top_k, dim=-1).indices
            topw = probs.gather(1, topi)
            if norm_topk:
                topw = topw / topw.sum(dim=-1, keepdim=True)
        flips[0] += int((mine.sort(-1).values != topi.sort(-1).values).any(-1).sum())
        flips[1] += topi.shape[0]
        return topw.to(x.dtype), topi.to(torch.int32)

    head_cpu = losses.tree_map(lambda t: t.detach().cpu(), head)
    setattr(moe, fn_name, recording)
    try:
        g_loss, g_card = _loss_grads(sub, head, cfg2, batch, kw)
    finally:
        setattr(moe, fn_name, own)
    check(len(card_topi) == 2, f"{len(card_topi)} router calls on the card (expected 2)")
    replay = iter(card_topi)
    setattr(moe, fn_name, replaying)
    try:
        c_loss, g_cpu = _loss_grads(cpu, head_cpu, cfg_cpu, losses.batch_to_device(batch, "cpu"),
                                    kw, copy=False)
    finally:
        setattr(moe, fn_name, own)
    names = [n for n, _ in losses.tree_paths((sub, head))]
    print(f"routing: {flips[0]} of {flips[1]} (token, layer) top-{cfg.num_experts_per_tok} "
          f"choices would differ between the card (bf16) and the CPU (f32) in the {label} "
          f"two-layer gradient check; the card's are replayed", flush=True)
    # experts without rows: an all-zero gradient on both sides
    rows = torch.stack([torch.bincount(t.flatten().long(), minlength=cfg.num_experts)
                        for t in card_topi])  # (layer, expert)
    empty = (rows == 0).nonzero().tolist()
    for name, a, b in zip(names, g_card, g_cpu):
        if ".moe.experts." in name:
            for layer, e in empty:
                check(not a[layer, e].any() and not b[layer, e].any(),
                      f"gradient {name} of expert {e} (no rows) in layer {layer} is not zero")
    worst, worst_name = _check_leaf_grads(names, g_card, g_cpu)
    print(f"gradient reference ({label}, 2 layers, card kernels bf16 vs CPU plain f32, remat "
          f"off, routing replayed): loss {g_loss:.6f} vs {c_loss:.6f}; worst leaf rel err "
          f"{worst:.3e} ({worst_name}) over {len(names)} leaves; {len(empty)} (layer, expert) "
          f"pairs without rows, zero on both sides; phase 2g ({label}) took "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)


class IdTok:
    """Prompts are space-separated token ids (the bench.py tokenizer stub)."""

    eos_token_id = 1
    pad_token_id = 0

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [int(w) for w in text.split()]}

    def decode(self, ids, **kw):
        return " ".join(str(int(i)) for i in ids)


class ChatIdTok:
    """A chat tokenizer over the whole vocabulary: a word <i> is token i and
    any other word hashes to an id, so decode -> encode round-trips every
    generated token. No tokenizer files are needed."""

    eos_token_id = 1
    pad_token_id = 0

    def __init__(self, vocab: int):
        self.vocab = vocab

    def _id(self, w):
        m = re.fullmatch(r"<(\d+)>", w)
        return int(m.group(1)) if m else 2 + int(zlib.crc32(w.encode())) % (self.vocab - 2)

    def __call__(self, text, add_special_tokens=True, **kw):
        return {"input_ids": [self._id(w) for w in text.split()]}

    def decode(self, ids, skip_special_tokens=True, **kw):
        return " ".join(f"<{int(i)}>" for i in ids
                        if not (skip_special_tokens and int(i) in (0, 1)))

    def apply_chat_template(self, conversation, tools=None, tokenize=False,
                            add_generation_prompt=True, **kw):
        text = "\n".join(f"<|{m['role']}|> {m.get('content', '')}" for m in conversation)
        return text + ("\n<|assistant|>\n" if add_generation_prompt else "\n")


# run_dapo.py's PoorAgent templates
POOR_SYSTEM = """\
SOLVE THE PROBLEM STEP-BY-STEP. PRESENT THE ANSWER TO EXIT THE LOOP.


# Guidelines
→ Each assistant response must contain exactly one "<think>...</think>" block.
  · If the final answer is ready, use "<answer>...</answer>" block to terminate the loop.
  · No content other than whitespace may appear outside these tags.
→ Begin every response with "STEP-(\\d+):\\n<think>...", 1 step per response."""
POOR_USER = """
{support_material_str}
# Please answer:
{question}
"""


def train_through_the_trainer(params, cfg, card, tmpdir):
    """Phase 6: one MTPOTrainer.train_step at full width."""
    import torch

    from lapha_tpu_torch.search import MCTSAgent
    from lapha_tpu_torch.train import MTPOConfig, MTPOTrainer

    class PoorAgent(MCTSAgent):
        TOOLS = {}
        TOOLS_DESCRIPTION = ""
        SYSTEM_TEMPLATE = POOR_SYSTEM
        USER_TEMPLATE = POOR_USER

    args = MTPOConfig(output_dir=tmpdir, seed=SEED, depth=2, breadth=4, num_sim=4,
                      leaves_per_sim=2, num_pos_sim=1, max_completion_length=32,
                      max_model_len=1024, max_prompt_length=1024, num_groups=8,
                      bf16=True, gradient_checkpointing=True, beta=1e-8, save_steps=0,
                      debug_print=False)
    dataset = [{"question": "What is 17 * 23?", "ground_truth": "391",
                "support_material_path": [],
                "cot": "<think>17 * 23 = 17 * 20 + 17 * 3 = 340 + 51 = 391</think>"
                       "<answer>391</answer>"},
               {"question": "What is the sum of the first 10 positive integers?",
                "ground_truth": "55", "support_material_path": [],
                "cot": "<think>10 * 11 / 2 = 55</think><answer>55</answer>"}]
    trainer = MTPOTrainer(
        model=(params, cfg), agent_cls_list=[PoorAgent], args=args,
        reward_fns=[lambda c, gt: 1.0 if f"<answer>{gt}</answer>" in (c or "") else 0.0],
        train_dataset=dataset, tokenizer=ChatIdTok(cfg.vocab_size))
    m = trainer.train_step(dataset)
    torch.cuda.synchronize()
    check(trainer.global_step == 1, "train_step advanced the step")
    if m["n_samples"]:
        check(all(math.isfinite(m[k]) for k in ("loss", "grad_norm")), f"phase 6 metrics {m}")
    shown = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in m.items()}
    print(f"train_step ({cfg.num_hidden_layers} layers, depth 2, breadth 4, num_sim 4, 32 new "
          f"tokens): "
          f"n_samples {m['n_samples']}, num_groups {m['num_groups']}, "
          f"skipped {m.get('skipped')}, rollout {m['rollout_s']:.2f} s, update "
          f"{m.get('update_s', 0.0):.2f} s [{card}]; metrics {shown}", flush=True)
    # the trainer's objects refer to each other: only the cycle collector
    # frees its engine and Adam state on the card
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return m


def update_at_full_width(params, head, cfg, eng, card):
    """Phase 7: three update steps at full width, counted, then one warm step
    timed at scripts/bench_train.py's shape. Returns the update window's
    launch counts."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import SamplingParams
    from lapha_tpu_torch.models import qwen2
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.train import losses, optim

    rng = np.random.default_rng(SEED + 5)
    B, Lp, Lc = 8, 512, 512
    dev = params["embed"]["weight"].device
    batch = _packed_batch(rng, cfg.vocab_size, [Lp] * B, [Lc] * B, dev)
    opt = optim.AdamChain(optim.constant_schedule(TRAIN_LR), max_grad_norm=1.0)
    update = losses.make_update_fn(cfg, opt, loss_kwargs=dict(
        LOSS_KW, max_completion_length=Lc, remat="full"))
    opt_state = opt.init(losses.tree_leaves((params, head)))

    # the regression check of the autograd Function: every layer's
    # attention projections get a gradient through the flash backward
    attn = params["layers"]["attn"]
    proj = [attn[n]["w"] for n in ("q_proj", "k_proj", "v_proj", "o_proj")]
    for t in proj:
        t.requires_grad_(True)
    loss, _ = losses.loss_and_metrics(params, head, batch, cfg, max_completion_length=Lc,
                                      remat="full", **LOSS_KW)
    for name, g in zip(("q", "k", "v", "o"), torch.autograd.grad(loss, proj)):
        per_layer = g.float().flatten(1).abs().amax(1)
        check(bool(torch.isfinite(per_layer).all()) and bool((per_layer > 0).all()),
              f"{name}_proj gradient zero or non-finite in some layer: {per_layer.tolist()}")
    del loss

    probe = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 64))).to(dev)
    with torch.inference_mode():
        logits0 = qwen2.forward(params, cfg, probe)[0][0, -1].float().clone()
    w0 = attn["q_proj"]["w"].detach()[0, :64, :64].clone()

    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses_seen, gnorms = [], []
    for _ in range(3):
        _, _, opt_state, m = update(params, head, opt_state, batch)
        losses_seen.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)

    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        check(launches[name] > 0, f"{name} never launched in the update window")
    check(all(map(math.isfinite, losses_seen + gnorms)), f"loss {losses_seen} gnorm {gnorms}")
    moved = float((attn["q_proj"]["w"].detach()[0, :64, :64].float() - w0.float()).abs().max())
    check(moved > 0, "params did not move")
    eng.update_params(params)
    with torch.inference_mode():
        logits1 = qwen2.forward(params, cfg, probe)[0][0, -1].float()
    dlog = float((logits1 - logits0).abs().max())
    check(dlog > 0 and bool(torch.isfinite(logits1).all()), f"logits after update: {dlog}")
    out = eng.generate([" ".join(str(int(t)) for t in probe[0].tolist())],
                       SamplingParams(n=2, temperature=1.0, max_tokens=16, seed=3))
    check(all(len(o.token_ids) == 16 and np.isfinite(o.token_logprobs).all()
              for o in out[0].outputs), "generate after the update")
    print(f"update x3 (B={B}, {Lp}+{Lc} tokens, remat full, lr {TRAIN_LR}): loss {losses_seen}, "
          f"grad_norm {gnorms}; max |dW| {moved:.3e}; max |d logits| after {dlog:.3e}; "
          f"launches {launches}", flush=True)

    # one warm step at the bench_train.py shape
    del batch, opt_state
    torch.cuda.empty_cache()
    Lp, Lc = 3072, 1024
    batch = _packed_batch(rng, cfg.vocab_size, [Lp] * B, [Lc] * B, dev)
    update = losses.make_update_fn(cfg, opt, loss_kwargs=dict(
        LOSS_KW, max_completion_length=Lc, remat="full"))
    opt_state = opt.init(losses.tree_leaves((params, head)))
    update(params, head, opt_state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, opt_state, m = update(params, head, opt_state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ntok = int(batch["attn"].sum())
    check(math.isfinite(float(m["loss"])), "bench-shape loss finite")
    print(f"update step at bench_train.py's shape (B={B}, {Lp}+{Lc} tokens, remat full, "
          f"AdamW chain): {dt:.3f} s/step, {ntok / dt:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]", flush=True)
    return launches


def _step_profile(step, card, label: str) -> None:
    """One step under torch.profiler: device busy (the CUDA kernels' own
    time summed) against the host clock of the same step, and the largest
    device items."""
    from collections import defaultdict

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, n_launch = defaultdict(float), 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] += ev.device_time_total / 1e3
            n_launch += 1
    dev_ms = sum(by_kernel.values())
    check(dev_ms > 0, f"the profiler saw no device time ({label})")
    print(f"{label}, profiled step: {wall_ms:.1f} ms host clock (profiler on), {dev_ms:.1f} ms "
          f"device busy ({100 * dev_ms / wall_ms:.1f}%), {n_launch} kernel launches [{card}]",
          flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:9.3f} ms ({100 * ms / dev_ms:4.1f}%)  {name[:100]}", flush=True)
    k8 = defaultdict(float)  # K8's kernels: the decode and wgmma forwards (dX), tgmm
    for name, ms in by_kernel.items():
        found = re.search(r"grouped_gemm\w*(<[^>]*>)?", name)
        if found:
            k8[found.group(0)] += ms
    if k8:
        print(f"{label}, K8 device time: " + "; ".join(
            f"{name} {ms:.3f} ms" for name, ms in sorted(k8.items())) +
            f"; {sum(k8.values()):.3f} ms of {dev_ms:.1f} [{card}]", flush=True)


def _check_layer_grads(params, head, cfg, batch, kw, keep, label) -> None:
    """One loss's gradients of the parameter leaves whose names ``keep``
    accepts: finite and non-zero in every layer."""
    import torch

    from lapha_tpu_torch.train import losses

    names = [n for n, _ in losses.tree_paths(params)]
    leaves = losses._trainable(params, head)[:len(names)]
    watch = [i for i, n in enumerate(names) if keep(n)]
    loss, _ = losses.loss_and_metrics(params, head, batch, cfg, **kw)
    grads = torch.autograd.grad(loss, [leaves[i] for i in watch])
    for i, g in zip(watch, grads):
        per_layer = g.float().flatten(1).abs().amax(1)
        check(bool(torch.isfinite(per_layer).all()) and bool((per_layer > 0).all()),
              f"{names[i]} gradient zero or non-finite in some layer: {per_layer.tolist()}")
    print(f"{label}: non-zero gradients in every layer for {len(watch)} leaves: "
          f"{[names[i] for i in watch]}", flush=True)


def _check_after_update(eng, params, cfg, probe, logits0) -> float:
    """The engine, given the updated params, generates; the logits of
    ``probe`` changed from ``logits0``. Returns max |d logits|."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import SamplingParams
    from lapha_tpu_torch.models import model_module

    eng.update_params(params)
    with torch.inference_mode():
        logits1 = model_module(cfg).forward(params, cfg, probe)[0][0, -1].float()
    dlog = float((logits1 - logits0).abs().max())
    check(dlog > 0 and bool(torch.isfinite(logits1).all()), f"logits after update: {dlog}")
    out = eng.generate([_text(probe[0].tolist())],
                       SamplingParams(n=2, temperature=1.0, max_tokens=16, seed=3))
    check(all(len(o.token_ids) == 16 and np.isfinite(o.token_logprobs).all()
              for o in out[0].outputs), "generate after the update")
    return dlog


def _warm_step(update, params, head, opt_state, batch, which, label, card) -> None:
    """One warm update step on the host clock (s/step, tokens/s, peak
    memory), then one under the profiler."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    update(params, head, opt_state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ntok = int(batch["attn"].sum())
    print(f"{which}: {label}, warm update step {dt:.3f} s/step, {ntok / dt:.1f} tokens/s, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{card}]", flush=True)
    _step_profile(lambda: update(params, head, opt_state, batch), card, f"{which}: {label}")


def _counted_steps(update, params, head, opt, batch, router: str, n_routed: int, which: str):
    """Three update steps with the launch counts zeroed before and read after;
    ``ops.moe``'s ``router`` records the first step's choices: the forward's
    ``n_routed`` calls, then those recomputed in the backward (remat), which
    must choose the same. Checks them and the finite loss and grad norm;
    returns (launches, Adam's state, losses, grad norms)."""
    import torch

    from lapha_tpu_torch.ops import _cuda, moe
    from lapha_tpu_torch.train import losses

    own, seen = getattr(moe, router), []

    def recording(*args, **kwargs):
        topw, topi = own(*args, **kwargs)
        seen.append(topi.detach().clone())
        return topw, topi

    opt_state = opt.init(losses.tree_leaves((params, head)))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses_seen, gnorms = [], []
    for i in range(3):
        setattr(moe, router, recording if i == 0 else own)
        try:
            _, _, opt_state, m = update(params, head, opt_state, batch)
        finally:
            setattr(moe, router, own)
        losses_seen.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    check(len(seen) == 2 * n_routed,
          f"{len(seen)} router calls in the first step (expected {2 * n_routed})")
    fwd, again = seen[:n_routed], seen[n_routed:]
    check(all(any(torch.equal(f, r) for r in again) for f in fwd),
          f"the routing recomputed in the backward differs from the forward's ({which})")
    check(all(map(math.isfinite, losses_seen + gnorms)), f"loss {losses_seen} gnorm {gnorms}")
    return launches, opt_state, losses_seen, gnorms


def update_moe(dev, card, which: str, tmpdir: str):
    """Phase 13: the update at full width for ``which`` = "update_moe" (the
    first 4 layers of Qwen1.5-MoE-A2.7B, 8 packed rows of 512 prompt + 512
    completion tokens) or "update_gptoss" (the first 4 of GPT-OSS-20B, 2
    sliding and 2 full, 4 such rows): losses.make_update_fn, remat "full",
    AdamChain at TRAIN_LR. One loss's gradients first (every layer's
    router, expert stacks and attention projections, GPT-OSS's sinks and
    expert biases non-zero); then three steps with the launch counts zeroed
    before and read after (K8, its backward, K1 and K2, GPT-OSS's windowed
    K1/K2 too, must have run), the routing of the first step's forward
    equal to its recompute in the backward; finite loss and grad norm,
    moved params, an engine that generates after the update with changed
    logits; one warm step timed on the host clock and one profiled, the
    peak memory. For the MoE model one MTPOTrainer.train_step follows, as
    phase 6. The model is freed before the return. Returns the launch
    counts by path."""
    import dataclasses

    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine
    from lapha_tpu_torch.models import qwen2, value_model
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.train import losses, optim

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gptoss = which == "update_gptoss"
    if gptoss:
        params, head, cfg = _gptoss_model(dev, card, layers=4)
        label, B = "GPT-OSS-20B, first 4 layers (2 sliding, 2 full)", 4
    else:
        cfg = dataclasses.replace(_moe_cfg(), num_hidden_layers=4)
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        params = qwen2.init_params(cfg, gen)
        head = value_model.init_value_head(cfg.hidden_size, gen)
        label, B = "Qwen1.5-MoE-A2.7B, first 4 layers", 8
    n_par = sum(t.numel() for t in losses.tree_leaves((params, head)))
    # bf16 weight + bf16 gradient + Adam's f32 mu and bf16 nu (optax's dtypes)
    print(f"{label}: {n_par / 1e9:.3f} B params, {10 * n_par / 1e9:.1f} GB for weights, "
          f"gradients and Adam's moments at 10 bytes a param [{card}]", flush=True)
    rng = np.random.default_rng(SEED + 24)
    Lp = Lc = 512
    batch = _packed_batch(rng, cfg.vocab_size, [Lp] * B, [Lc] * B, dev)
    opt = optim.AdamChain(optim.constant_schedule(TRAIN_LR), max_grad_norm=1.0)
    # 256-position logits chunks: B x 256 x V f32 is 1.2 GB (Qwen) / 0.8 GB
    # (GPT-OSS) against 4.6 / 3.3 GB at the default 1024
    kw = dict(LOSS_KW, max_completion_length=Lc, remat="full", logits_chunk=256)
    update = losses.make_update_fn(cfg, opt, loss_kwargs=kw)
    eng = Engine(params, cfg, IdTok(), max_model_len=256, max_batch=2, decode_chunk=16,
                 pad_multiple=64, batch_bucket=1, eos_token_ids=[], seed=SEED)

    # every layer's router, expert stacks, attention projections (and
    # GPT-OSS's sinks and expert biases) get a gradient
    _check_layer_grads(
        params, head, cfg, batch, kw,
        lambda n: (".moe.router." in n or ".moe.experts." in n or n.endswith("sinks")
                   or any(n.endswith(f"attn.{p}.w") for p in ("q_proj", "k_proj", "v_proj",
                                                               "o_proj"))), label)

    probe = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 64))).to(dev)
    with torch.inference_mode():
        logits0 = qwen2.forward(params, cfg, probe)[0][0, -1].float().clone()
    experts = params["layers"]["moe"]["experts"]
    w_exp = experts["gate_up"]["w"] if gptoss else experts["gate_proj"]["w"]
    w0 = w_exp.detach()[:, :, :64, :64].clone()

    L = cfg.num_hidden_layers
    launches, opt_state, losses_seen, gnorms = _counted_steps(
        update, params, head, opt, batch, "route_topk_softmax" if gptoss else "route", L, which)
    need = ["grouped_gemm_wg", "grouped_gemm_dx", "grouped_gemm_tgmm", "flash_attention",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
    if gptoss:
        need += ["flash_attention_window", "flash_attention_bwd_dq_window",
                 "flash_attention_bwd_dkv_window"]
    for name in need:
        check(launches[name] > 0, f"{name} never launched in the {which} window")
    # the update's products have hundreds of rows an expert: the wgmma kernels
    check(launches["grouped_gemm"] == 0,
          f"the decode K8 ran {launches['grouped_gemm']} times in the {which} window")
    moved = float((w_exp.detach()[:, :, :64, :64].float() - w0.float()).abs().max())
    check(moved > 0, "params did not move")
    dlog = _check_after_update(eng, params, cfg, probe, logits0)
    print(f"{which}: {label}, update x3 (B={B}, {Lp}+{Lc} tokens, remat full, lr {TRAIN_LR}): "
          f"loss {losses_seen}, grad_norm {gnorms}; routing recomputed in the backward equal to "
          f"the forward's in all {L} layers; max |dW| {moved:.3e}; max |d logits| after "
          f"{dlog:.3e}; launches {launches}", flush=True)

    _warm_step(update, params, head, opt_state, batch, which, label, card)
    del eng, opt_state, batch, update, w0
    torch.cuda.empty_cache()
    counted = {which: launches}
    if not gptoss:  # the trainer's entry on the MoE model (phase 6's call)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        m = train_through_the_trainer(params, cfg, card, tmpdir)
        counted["train_step_moe"] = dict(_cuda.LAUNCHES)
        # the rollout's decode rounds run the decode K8; the update (when a
        # group was trainable) runs its backward
        for name in ("grouped_gemm",) + (("grouped_gemm_dx", "grouped_gemm_tgmm")
                                         if m["n_samples"] else ()):
            check(counted["train_step_moe"][name] > 0,
                  f"{name} never launched in the MoE train_step")
    del params, head
    torch.cuda.empty_cache()
    print(f"phase 13 ({which}) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counted


def update_deepseek(dev, card, tmpdir: str):
    """Phase 16: the update at full width on the first 4 layers of
    DeepSeek-V2-Lite (1 dense + 3 MoE, so that both stacked groups train; 8
    packed rows of 512 prompt + 512 completion tokens): losses.make_update_fn,
    remat "full", AdamChain at TRAIN_LR, 256-position logits chunks. One
    loss's gradients first (every layer's q, kv_a, kv_b and o, the router,
    the expert stacks, the shared experts and the dense MLP non-zero); then
    three steps with the launch counts zeroed before and read after (the
    narrow-V K1 and both narrow-V K2 kernels, K8, dX and tgmm must have
    run), the routing of the first step's forward equal to its recompute in
    the backward; finite loss and grad norm, moved params, an engine that
    generates after the update with changed logits; one warm step on the
    host clock and one profiled, the peak memory. Then one
    MTPOTrainer.train_step on the same model, as phase 6 (beta 1e-8: the
    reference copy runs ref_logps_fn on the DeepSeek tree), its peak memory
    printed. The model is freed before the return. Returns the launch
    counts by path."""
    import dataclasses

    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine
    from lapha_tpu_torch.models import deepseek, value_model
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.train import losses, optim

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full = deepseek.DeepseekConfig.from_hf(DEEPSEEK_V2_LITE_CONFIG)
    cfg = dataclasses.replace(full, num_hidden_layers=4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    params = deepseek.init_params(cfg, gen)
    head = value_model.init_value_head(cfg.hidden_size, gen)
    label, B = "DeepSeek-V2-Lite, first 4 layers (1 dense, 3 MoE)", 8
    n_par = sum(t.numel() for t in losses.tree_leaves((params, head)))
    per_moe = sum(t[0].numel() for t in losses.tree_leaves(params["moe_layers"]))
    n_full = n_par + (full.num_hidden_layers - cfg.num_hidden_layers) * per_moe
    # bf16 weight + bf16 gradient + Adam's f32 mu and bf16 nu (optax's dtypes)
    print(f"{label}: {n_par / 1e9:.3f} B params, {10 * n_par / 1e9:.1f} GB for weights, "
          f"gradients and Adam's moments at 10 bytes a param; the full depth of "
          f"{full.num_hidden_layers} layers would be {n_full / 1e9:.2f} B params, "
          f"{10 * n_full / 1e9:.1f} GB, over one card [{card}]", flush=True)
    rng = np.random.default_rng(SEED + 28)
    Lp = Lc = 512
    batch = _packed_batch(rng, cfg.vocab_size, [Lp] * B, [Lc] * B, dev)
    opt = optim.AdamChain(optim.constant_schedule(TRAIN_LR), max_grad_norm=1.0)
    # 256-position logits chunks: B x 256 x V f32 is 0.8 GB against 3.4 GB
    # at the default 1024
    kw = dict(LOSS_KW, max_completion_length=Lc, remat="full", logits_chunk=256)
    update = losses.make_update_fn(cfg, opt, loss_kwargs=kw)
    eng = Engine(params, cfg, IdTok(), max_model_len=256, max_batch=2, decode_chunk=16,
                 pad_multiple=64, batch_bucket=1, eos_token_ids=[], seed=SEED)

    attn = ("q", "kv_a", "kv_b", "o")
    _check_layer_grads(
        params, head, cfg, batch, kw,
        lambda n: (any(n.endswith(f"attn.{p}.w") for p in attn) or ".moe.router.w" in n
                   or ".moe.experts." in n or ".moe.shared." in n or n.startswith("dense_layers.mlp.")),
        label)

    probe = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 64))).to(dev)
    with torch.inference_mode():
        logits0 = deepseek.forward(params, cfg, probe)[0][0, -1].float().clone()
    w_exp = params["moe_layers"]["moe"]["experts"]["gate_proj"]["w"]
    w0 = w_exp.detach()[:, :, :64, :64].clone()

    L = cfg.num_moe_layers_
    launches, opt_state, losses_seen, gnorms = _counted_steps(
        update, params, head, opt, batch, "route_deepseek", L, "update_deepseek")
    for name in ("flash_attention_narrowv", "flash_attention_bwd_dq_narrowv",
                 "flash_attention_bwd_dkv_narrowv", "grouped_gemm_wg", "grouped_gemm_dx",
                 "grouped_gemm_tgmm"):
        check(launches[name] > 0, f"{name} never launched in the update_deepseek window")
    check(launches["grouped_gemm"] == 0,
          f"the decode K8 ran {launches['grouped_gemm']} times in the update_deepseek window")
    for name, count in launches.items():  # no dh = dv attention instance
        check(count == 0 or "narrowv" in name or name.startswith("grouped_gemm"),
              f"{name} ran {count} times in the update_deepseek window")
    moved = float((w_exp.detach()[:, :, :64, :64].float() - w0.float()).abs().max())
    check(moved > 0, "params did not move")
    dlog = _check_after_update(eng, params, cfg, probe, logits0)
    print(f"update_deepseek: {label}, update x3 (B={B}, {Lp}+{Lc} tokens, remat full, lr "
          f"{TRAIN_LR}): loss {losses_seen}, grad_norm {gnorms}; routing recomputed in the "
          f"backward equal to the forward's in all {L} MoE layers; max |dW| {moved:.3e}; max "
          f"|d logits| after {dlog:.3e}; launches {launches}", flush=True)

    _warm_step(update, params, head, opt_state, batch, "update_deepseek", label, card)
    del eng, opt_state, batch, update, w0
    torch.cuda.empty_cache()
    counted = {"update_deepseek": launches}
    # the trainer's entry on the DeepSeek model (phase 6's call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    m = train_through_the_trainer(params, cfg, card, tmpdir)
    counted["train_step_deepseek"] = dict(_cuda.LAUNCHES)
    print(f"train_step_deepseek: peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB "
          f"(the trainer's Adam state and the reference copy of the weights included) [{card}]",
          flush=True)
    # the rollout prefills through the narrow-V K3 and its decode rounds run
    # the decode K8; the update (when a group was trainable) runs the
    # narrow-V K2 and K8's backward
    for name in ("flash_attention_cached_narrowv", "grouped_gemm") + (
            ("flash_attention_bwd_dq_narrowv", "flash_attention_bwd_dkv_narrowv",
             "grouped_gemm_dx", "grouped_gemm_tgmm") if m["n_samples"] else ()):
        check(counted["train_step_deepseek"][name] > 0,
              f"{name} never launched in the DeepSeek train_step")
    del params, head
    torch.cuda.empty_cache()
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counted


def _max_logits(params, cfg, batch) -> tuple[float, float]:
    """(largest |scaled attention logit| over the layers of ``params``,
    largest |final logit| of the first row's first 64 positions), both
    before their softcaps, from one forward of ``batch`` on the card."""
    import torch

    from lapha_tpu_torch.models import qwen2
    from lapha_tpu_torch.train.losses import _head_weight

    own, seen = qwen2._dispatch_attend, []

    def spy(c, q, k, v, key_mask, win=0, sinks=None):
        g = q.shape[2] // k.shape[2]
        seen.append(max(float((torch.einsum("bthd,bshd->bhts", q[:, :, i::g].float(), k.float())
                               * c.attn_scale_).abs().max()) for i in range(g)))
        return own(c, q, k, v, key_mask, win, sinks)

    qwen2._dispatch_attend = spy
    try:
        with torch.no_grad():
            hidden = qwen2.forward(params, cfg, batch["ids"], attention_mask=batch["attn"],
                                   return_hidden=True, compute_logits=False)[1]
    finally:
        qwen2._dispatch_attend = own
    final = hidden[0, :64].float() @ _head_weight(params, cfg).float().T
    return max(seen), float(final.abs().max())


def update_published(dev, card, hf_config, label: str, which: str, tmpdir: str,
                     ref_lens=((90, 40), (30, 60)), trainer_path=None,
                     keep=lambda n: not n.endswith(".b"), phase="14"):
    """Phases 14 (Gemma: ``which`` = "update_gemma2" or "update_gemma3") and
    18 (Phi-3, StarCoder2): training at full width and depth, the model made
    here from its published config (``_published_model``: for Gemma-2
    q_proj x16 and embedding x32, so that both softcaps bite) and freed
    before the return. Phase 2b's gradient check on its first two layers
    (rows of ``ref_lens`` tokens; for Gemma-2 the largest scaled attention
    and final logits printed beside the caps); one loss's gradients (every
    layer's leaves whose names ``keep`` accepts non-zero: q/k/v/o, norms and
    MLP); three ``losses.make_update_fn`` steps (remat "full", AdamChain at
    TRAIN_LR) on 8 packed rows of 512 prompt + 512 completion tokens, the
    launch counts zeroed before and read after (K1 and K2 of the stack's
    window kinds: for Gemma-2 only their softcapped launches); finite loss
    and grad norm, moved params, an engine that generates after the update
    with changed logits; one warm step on the host clock and one profiled,
    the peak memory; with ``trainer_path`` then one MTPOTrainer.train_step
    counted under that name (K3 and K4 in the rollout, K2 when a group was
    trainable). Returns the launch counts by path."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine
    from lapha_tpu_torch.models import qwen2
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops.flash_attention import launch_name
    from lapha_tpu_torch.train import losses, optim

    t_phase = time.perf_counter()
    params, head, cfg = _published_model(dev, card, hf_config, label)
    n_par = sum(t.numel() for t in losses.tree_leaves((params, head)))
    # bf16 weight + bf16 gradient + Adam's f32 mu and bf16 nu (optax's dtypes)
    print(f"{label}: {n_par / 1e9:.3f} B params, {10 * n_par / 1e9:.1f} GB for weights, "
          f"gradients and Adam's moments at 10 bytes a param [{card}]", flush=True)
    ref_batch = check_gradient_reference(params, head, cfg, dev, *ref_lens,
                                         label=f"{label}, first 2 layers")
    if cfg.attn_softcap:
        sub, cfg2, _, _ = _two_layers(params, cfg)
        s_max, f_max = _max_logits(sub, cfg2, ref_batch)
        check(s_max > cfg.attn_softcap, f"{label}: the attention softcap does not bite ({s_max})")
        print(f"{label}, first 2 layers: max|scaled attention logit| {s_max:.1f} (cap "
              f"{cfg.attn_softcap}), max|final logit| {f_max:.1f} (cap {cfg.final_softcap}; the "
              f"training log-probs apply none, as JAX's: ROADMAP C2 (e))", flush=True)
        del sub
    del ref_batch

    rng = np.random.default_rng(SEED + 26)
    B, Lp, Lc = 8, 512, 512
    batch = _packed_batch(rng, cfg.vocab_size, [Lp] * B, [Lc] * B, dev)
    opt = optim.AdamChain(optim.constant_schedule(TRAIN_LR), max_grad_norm=1.0)
    # 256-position logits chunks: B x 256 x V f32 is 2.1 GB against 8.4 at 1024
    kw = dict(LOSS_KW, max_completion_length=Lc, remat="full", logits_chunk=256)
    update = losses.make_update_fn(cfg, opt, loss_kwargs=kw)
    eng = Engine(params, cfg, IdTok(), max_model_len=256, max_batch=2, decode_chunk=16,
                 pad_multiple=64, batch_bucket=1, eos_token_ids=[], seed=SEED)

    # every layer's projections, norms and MLP get a gradient
    _check_layer_grads(params, head, cfg, batch, kw,
                       lambda n: n.startswith("layers.") and keep(n), label)

    probe = torch.from_numpy(rng.integers(2, cfg.vocab_size, (1, 64))).to(dev)
    with torch.inference_mode():
        logits0 = qwen2.forward(params, cfg, probe)[0][0, -1].float().clone()
    w0 = params["layers"]["attn"]["q_proj"]["w"].detach()[:, :64, :64].clone()
    opt_state = opt.init(losses.tree_leaves((params, head)))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    losses_seen, gnorms = [], []
    for _ in range(3):
        _, _, opt_state, m = update(params, head, opt_state, batch)
        losses_seen.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    cap = cfg.attn_softcap
    kinds = {cfg.window_for_layer(l) > 0 for l in range(cfg.num_hidden_layers)}
    attn = [n for n in launches if n.startswith("flash_attention") and "cached" not in n]
    need = [launch_name(n, w, cap) for n in ("flash_attention", "flash_attention_bwd_dq",
                                             "flash_attention_bwd_dkv") for w in kinds]
    for name in need:
        check(launches[name] > 0, f"{name} never launched in the {which} window")
    stray = {n: launches[n] for n in attn if n not in need and launches[n]}
    check(not stray, f"attention launches of another kind in the {which} window: {stray}")
    check(all(map(math.isfinite, losses_seen + gnorms)), f"loss {losses_seen} gnorm {gnorms}")
    moved = float((params["layers"]["attn"]["q_proj"]["w"].detach()[:, :64, :64].float()
                   - w0.float()).abs().amax(dim=(1, 2)).min())
    check(moved > 0, "params did not move in every layer")
    dlog = _check_after_update(eng, params, cfg, probe, logits0)
    print(f"{which}: {label}, update x3 (B={B}, {Lp}+{Lc} tokens, remat full, lr {TRAIN_LR}): "
          f"loss {losses_seen}, grad_norm {gnorms}; min over layers of max |dW| {moved:.3e}; "
          f"max |d logits| after {dlog:.3e}; launches {launches}", flush=True)

    _warm_step(update, params, head, opt_state, batch, which, label, card)
    del eng, opt_state, batch, update, w0
    torch.cuda.empty_cache()
    counted = {which: launches}
    if trainer_path is not None:  # the trainer's entry (phase 6's call)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        m = train_through_the_trainer(params, cfg, card, tmpdir)
        got = counted[trainer_path] = dict(_cuda.LAUNCHES)
        # the rollout serves through K3 (every window kind of the stack) and
        # K4; the update (when a group was trainable) runs K2, under the
        # softcap's names for Gemma-2
        need = [launch_name("flash_attention_cached", w, cap) for w in kinds]
        need.append(launch_name("ragged_decode_attention", 0, cap))
        if m["n_samples"]:
            need += [launch_name(n, w, cap) for w in kinds
                     for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")]
        for name in need:
            check(got[name] > 0, f"{name} never launched in the {label} train_step")
    del params, head
    torch.cuda.empty_cache()
    print(f"phase {phase} ({which}) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counted


def _text(ids) -> str:
    return " ".join(str(int(t)) for t in ids)


def _serve_round(eng, vf, sp, rng, vocab: int, P: int, plen: int, n_kids: int, kid_extra: int):
    """One expansion round: P parents of plen random tokens, the first
    n_kids of them extended by kid_extra tokens as prefix-hit children, the
    root value forward, the children scored from their pooled h0, and the
    potential V."""
    import numpy as np
    import torch

    from lapha_tpu_torch.ops.latent import potential_v

    dev = vf.device
    roots = [rng.integers(2, vocab, plen) for _ in range(P)]
    children = [np.concatenate([r, rng.integers(2, vocab, kid_extra)]) for r in roots[:n_kids]]
    out = {"roots": roots, "children": children}
    t0 = time.perf_counter()
    out["parents"] = eng.generate([_text(r) for r in roots], sp)
    out["t_par"] = dict(eng.last_timings)
    hits0 = eng.prefix_cache.hits
    out["kids"] = eng.generate([_text(c) for c in children], sp)
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
    out["V"] = potential_v(y_t, torch.zeros(y_t.shape[1], device=dev), anchor).cpu().numpy()
    torch.cuda.synchronize()
    out["t_all"] = time.perf_counter() - t0
    return out


def _check_round(run, vf, vocab: int, H: int, P: int, n: int, n_kids: int, new: int,
                 fused_rtol: float | None) -> float:
    """Phase 4's checks on a round's outputs; returns the fused-h0 error
    (checked against ``fused_rtol`` unless it is None: the caller's check)."""
    import numpy as np

    check(run["hits"] == n_kids, f"expected {n_kids} prefix-cache hits, got {run['hits']}")
    for outs, count in ((run["parents"], P), (run["kids"], n_kids)):
        check(len(outs) == count and all(len(r.outputs) == n for r in outs),
              "request/sample count")
        for r in outs:
            for o in r.outputs:
                check(len(o.token_ids) == new, f"{len(o.token_ids)} tokens, expected {new}")
                check(all(0 <= t < vocab for t in o.token_ids), "token ids in vocab")
                check(np.isfinite(o.token_logprobs).all() and max(o.token_logprobs) <= 0.0,
                      "logprobs finite and <= 0")
                check(o.pooled_hidden.shape == (H,), "pooled_hidden shape")
    check(run["y_root"].shape == (P, H) and run["v_root"].shape == (P,), "root value shapes")
    check(run["y_kids"].shape == (n_kids * n, H) and run["V"].shape == (n_kids * n,),
          "child value shapes")
    for key in ("y_root", "v_root", "h0_root", "pooled", "y_kids", "v_kids", "V"):
        check(np.isfinite(run[key]).all(), f"{key} finite")
    check((run["V"] >= 0).all() and (run["V"] <= 1).all(), f"V in [0, 1]: {run['V']}")
    check((run["v_root"] >= 0).all() and (run["v_root"] <= 1).all(), "root values in [0, 1]")
    check((np.linalg.norm(run["y_kids"], axis=-1) < 1).all(), "ball points inside the ball")
    # fused value: the engine's pooled h0 of child sample 0 == a value forward
    # over the same prompt + completion (no-cache kernel vs prefill/decode kernels)
    full = np.concatenate([run["children"][0],
                           np.asarray(run["kids"][0].outputs[0].token_ids)])[None]
    _, _, h_ref = vf(full, np.ones_like(full, dtype=np.int32), return_h0=True)
    e_fused = float(np.linalg.norm(run["pooled"][0] - h_ref[0]) / np.linalg.norm(h_ref[0]))
    print(f"fused value check: engine pooled h0 vs value forward rel err {e_fused:.3e} "
          f"(limit {fused_rtol})", flush=True)
    check(fused_rtol is None or e_fused <= fused_rtol, f"fused value rel err {e_fused}")
    return e_fused


def serve_quantized(params, head, cfg, card):
    """Phase 8: quantized serving at bench.py's shape. Returns the launch
    counts of the first int4 round."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.models import quant
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    P, n, plen, new, n_kids, kid_extra = 8, 6, 512, 256, 4, 64
    kw = dict(max_model_len=plen + new + 128, max_batch=P * n, decode_chunk=32, pad_multiple=128,
              batch_bucket=1, eos_token_ids=[], seed=SEED, collect_h0=True, kv_quant="int8")
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    rng = np.random.default_rng(SEED + 7)
    t0 = time.perf_counter()
    qparams = quant.quantize_params(params, bits=4)
    torch.cuda.synchronize()
    print(f"quantize_params(bits=4) on the card: {time.perf_counter() - t0:.2f} s; weights "
          f"{quant.params_nbytes(qparams) / 2**30:.2f} GiB (bf16: "
          f"{quant.params_nbytes(params) / 2**30:.2f} GiB)", flush=True)
    counted = None
    for label, p in (("int4 weights + int8 KV", qparams), ("bf16 weights + int8 KV", params)):
        eng = Engine(p, cfg, IdTok(), **kw)
        vf = ValueFunction(p, head, cfg, max_model_len=1024, pad_multiple=128, batch_bucket=P)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        run = _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, n_kids, kid_extra)
        launches = dict(_cuda.LAUNCHES)
        for name in ("flash_attention", "flash_attention_cached", "ragged_decode_attention_q8"):
            check(launches[name] > 0, f"{name} never launched ({label})")
        check(launches["ragged_decode_attention"] == 0,
              f"the bf16 decode kernel ran on the int8-KV path ({label})")
        if p is qparams:
            check(launches["int4_matmul"] > 0, "int4_matmul never launched on the int4 path")
            counted = launches
        else:
            check(launches["int4_matmul"] == 0, "int4_matmul ran with bf16 weights")
        _check_round(run, vf, cfg.vocab_size, cfg.hidden_size, P, n, n_kids, new, FUSED_Q8_RTOL)
        print(f"{label}: launches {launches}; first (cold) round {run['t_all']:.2f} s [{card}]",
              flush=True)
        warm = _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, n_kids, kid_extra)
        tp, tk = warm["t_par"], warm["t_kid"]
        print(f"{label}, warm parents: prefill {tp['prefill_s'] * 1e3:.1f} ms ({P} x {plen} "
              f"tokens), decode {tp['decode_s'] * 1e3:.1f} ms for {tp['decode_steps']} steps x "
              f"{P * n} rows = {P * n * new / tp['decode_s']:.1f} tok/s [{card}]", flush=True)
        print(f"{label}, warm children: prefix-hit prefill {tk['prefill_s'] * 1e3:.1f} ms "
              f"({n_kids} x {kid_extra}-token suffix at qstart {plen}), decode "
              f"{tk['decode_s'] * 1e3:.1f} ms = {n_kids * n * new / tk['decode_s']:.1f} tok/s; "
              f"root value forward ({P} x {plen}) {warm['t_value'] * 1e3:.1f} ms; whole round "
              f"{warm['t_all']:.2f} s [{card}]", flush=True)
        del eng, vf, run, warm
        torch.cuda.empty_cache()
    del qparams
    torch.cuda.empty_cache()
    return counted


def profile_decode_step(params, cfg, card):
    """Phase 9: one decode step at bench.py's shape, in three configurations,
    on the host clock and in the profiler's device time."""
    import torch

    from lapha_tpu_torch.engine.engine import Engine
    from lapha_tpu_torch.models import quant

    B, prompt, S, steps = 48, 512, 768, 5
    dev = params["norm"]["scale"].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    shape = (cfg.num_hidden_layers, B, cfg.num_key_value_heads, S, cfg.head_dim_)
    ck = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    cv = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    tok = torch.randint(2, cfg.vocab_size, (B,), generator=gen, device=dev)
    lens = torch.full((B,), prompt, dtype=torch.int32, device=dev)
    kq, vq, scl = Engine._quantize_cache(ck, cv)
    runs = (("bf16 weights, bf16 KV", params, (ck, cv), None),
            ("bf16 weights, int8 KV", params, (kq, vq), scl),
            ("int4 weights, int8 KV", quant.quantize_params(params, bits=4), (kq, vq), scl))
    for label, p, cache, cache_scale in runs:
        _profile_decode(label, p, cfg, tok, lens, cache, cache_scale, prompt, steps, card)
    del runs, ck, cv, kq, vq, scl
    torch.cuda.empty_cache()


def _profile_decode(label, p, cfg, tok, lens, cache, cache_scale, prompt: int, steps: int, card):
    """Decode steps over ``cache`` (prompts of ``prompt`` tokens, one new
    slot per step): host clock per step with the device synchronised, then
    the profiler's device time (the CUDA kernels' own time summed), launches
    per step and the largest kernels."""
    from collections import defaultdict

    import torch

    from lapha_tpu_torch.models import model_module

    B, S = tok.shape[0], cache[0].shape[3]
    slot = prompt
    decode_step = model_module(cfg).decode_step

    def step():
        nonlocal slot
        decode_step(p, cfg, tok, lens.long() + (slot - prompt), cache[0], cache[1],
                    slot, lens, lens, cache_scale=cache_scale)
        slot += 1

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        step()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
    by_kernel, n_launch = defaultdict(float), 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] += ev.device_time_total / 1e3 / steps  # us -> ms per step
            n_launch += 1
    dev_ms = sum(by_kernel.values())
    check(dev_ms > 0, f"the profiler saw no device time ({label})")
    print(f"decode step profile, {label} (B={B}, S={S}, prompts {prompt}): {wall_ms:.2f} ms "
          f"host clock, {dev_ms:.2f} ms device busy ({100 * dev_ms / wall_ms:.1f}%), "
          f"{n_launch / steps:.0f} kernel launches per step [{card}]", flush=True)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    {ms:8.3f} ms  {name[:110]}", flush=True)
    k8_ms = sum(ms for name, ms in by_kernel.items() if "grouped_gemm" in name)
    if k8_ms > 0:  # K8's forwards (the decode kernel; a step runs no wgmma one)
        print(f"    K8 (grouped_gemm kernels) {k8_ms:.3f} ms a step, "
              f"{100 * k8_ms / dev_ms:.1f}% of the device time [{card}]", flush=True)
    k6_ms = sum(ms for name, ms in by_kernel.items() if "int4_mm_kernel" in name)
    if k6_ms > 0:  # K6's instances (one per column tile and row tile) together
        print(f"    K6 (int4_mm_kernel, all instances) {k6_ms:.3f} ms a step, "
              f"{100 * k6_ms / dev_ms:.1f}% of the device time", flush=True)


def main(argv=None) -> int:
    import argparse

    # the script makes and frees models of 2-42 GB in turn: segments that
    # grow and shrink keep the freed memory usable for the next one (set
    # before the first allocation on the card)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--c5", action="store_true",
                    help="run only the GPT-OSS fused-h0 probe of ROADMAP C5 (probe_c5)")
    args = ap.parse_args(argv)
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
    from lapha_tpu_torch.search import ValueFunction

    t0 = time.perf_counter()
    _cuda.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.c5:
        probe_c5(dev, card)
        return 0
    for line in _cuda.build_log.splitlines():  # ptxas: registers, smem, spills per kernel
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)
    kernels = check_kernels(dev, card)
    kernels.update(check_backward_kernels(dev, card))
    kernels.update(check_quant_kernels(dev, card))
    kernels.update(check_grouped_gemm(dev, card))
    kernels.update(check_gptoss_kernels(dev, card))
    kernels.update(check_gemma_kernels(dev, card))
    kernels.update(check_grouped_gemm_backward(dev, card))
    kernels.update(check_backward_window_kernels(dev, card))
    kernels.update(check_backward_gemma_kernels(dev, card))
    kernels.update(check_deepseek_kernels(dev, card))
    kernels.update(check_backward_deepseek_kernels(dev, card))
    kernels.update(check_phi3_starcoder2_kernels(dev, card))

    # ---------------- MoE serving at full width and depth, counted; freed after
    launches = {"serve_moe": serve_moe(dev, card)}
    # ---------------- GPT-OSS-20B serving at full width and depth, counted; freed after
    launches["serve_gptoss"] = serve_gptoss(dev, card)
    # ---------------- Gemma-2-2B (bf16, then int8 KV) and Gemma-3-1B serving at
    # full width and depth, counted; each freed after
    launches["serve_gemma2"] = serve_published(dev, card, GEMMA2_2B_CONFIG, "Gemma-2-2B",
                                               (None, "int8"), {})
    # Gemma-3's two-layer check at prompts past its 512-token window
    launches["serve_gemma3"] = serve_published(dev, card, GEMMA3_1B_CONFIG, "Gemma-3-1B",
                                               (None,), {"T": 560, "S": 592})
    # ---------------- DeepSeek-V2-Lite serving at full width and depth, counted; freed after
    launches["serve_deepseek"] = serve_deepseek(dev, card)
    # ---------------- Phi-3-mini (two-layer check past its 2047 window) and
    # StarCoder2-3B serving at full width and depth, counted; each freed after
    launches["serve_phi3"] = serve_published(dev, card, PHI3_MINI_4K_CONFIG, "Phi-3-mini-4k",
                                             (None, "int8"), {"T": 2100, "S": 2176}, "17")
    launches["serve_starcoder2"] = serve_published(dev, card, STARCODER2_3B_CONFIG,
                                                   "StarCoder2-3B", (None, "int8"), {}, "17")

    cfg = qwen2.Qwen2Config(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        max_position_embeddings=4096, rope_theta=1e6, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = qwen2.init_params(cfg, gen)
    head = value_model.init_value_head(cfg.hidden_size, gen)
    check_small_reference(params, cfg, dev)
    for bits in (4, 8):
        check_small_reference(params, cfg, dev, bits=bits)
    check_gradient_reference(params, head, cfg, dev)

    P, n, plen, new = 4, 6, 512, 64
    eng = Engine(params, cfg, IdTok(), max_model_len=plen + 2 * new + 128, max_batch=P * n,
                 decode_chunk=32, pad_multiple=128, batch_bucket=1, eos_token_ids=[],
                 seed=SEED, collect_h0=True)
    vf = ValueFunction(params, head, cfg, max_model_len=1024, pad_multiple=128, batch_bucket=P)
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    rng = np.random.default_rng(SEED + 2)

    # ---------------- the served path, counted
    torch.cuda.synchronize()
    _cuda.reset_launches()
    run = _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
    launches["serve"] = dict(_cuda.LAUNCHES)

    # ---------------- checks on what came out
    for name in ("flash_attention", "flash_attention_cached", "ragged_decode_attention"):
        check(launches["serve"][name] > 0, f"{name} never launched on the served path")
    _check_round(run, vf, cfg.vocab_size, cfg.hidden_size, P, n, P, new, REF_RTOL)
    print(f"launches on the served path: {launches['serve']}; first (cold) round "
          f"{run['t_all']:.2f} s [{card}]", flush=True)

    # ---------------- timings: a second, warm round on fresh prompts
    warm = _serve_round(eng, vf, sp, rng, cfg.vocab_size, P, plen, P, new)
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
    del run, warm

    # ---------------- quantized serving at bench.py's shape, counted
    launches["serve_quantized"] = serve_quantized(params, head, cfg, card)
    profile_decode_step(params, cfg, card)

    # ---------------- training: the trainer's entry, then the update, counted
    with tempfile.TemporaryDirectory() as tmpdir:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        train_through_the_trainer(params, cfg, card, tmpdir)
        launches["train_step"] = dict(_cuda.LAUNCHES)
    print(f"launches in train_step: {launches['train_step']}", flush=True)
    torch.cuda.empty_cache()
    launches["update"] = update_at_full_width(params, head, cfg, eng, card)
    del eng, vf, params, head
    torch.cuda.empty_cache()

    # ---------------- MoE and GPT-OSS training at full width, counted; each freed after
    with tempfile.TemporaryDirectory() as tmpdir:
        for which in ("update_moe", "update_gptoss"):
            launches.update(update_moe(dev, card, which, tmpdir))
        # ---------------- Gemma training at full width and depth, counted; each freed after
        launches.update(update_published(dev, card, GEMMA2_2B_CONFIG, "Gemma-2-2B",
                                         "update_gemma2", tmpdir,
                                         trainer_path="train_step_gemma2"))
        # the two-layer check at rows past Gemma-3's 512-token window
        launches.update(update_published(dev, card, GEMMA3_1B_CONFIG, "Gemma-3-1B",
                                         "update_gemma3", tmpdir, ((530, 300), (40, 60))))
        # ---------------- DeepSeek-V2-Lite training at full width, counted; freed after
        launches.update(update_deepseek(dev, card, tmpdir))
        # ---------------- Phi-3-mini and StarCoder2-3B training at full width and
        # depth, counted; each freed after (k_proj's bias gets no gradient:
        # softmax is shift-invariant along a row)
        every_leaf = lambda n: not n.endswith("k_proj.b")  # noqa: E731
        launches.update(update_published(dev, card, PHI3_MINI_4K_CONFIG, "Phi-3-mini-4k",
                                         "update_phi3", tmpdir, trainer_path="train_step_phi3",
                                         keep=every_leaf, phase="18"))
        launches.update(update_published(dev, card, STARCODER2_3B_CONFIG, "StarCoder2-3B",
                                         "update_starcoder2", tmpdir, keep=every_leaf,
                                         phase="18"))

    replaces = {
        "flash_attention": ("lapha_tpu_torch/csrc/flash_attention.cu",
                            "lapha_tpu/ops/flash_attention.py:46"),
        "flash_attention_cached": ("lapha_tpu_torch/csrc/flash_attention.cu",
                                   "lapha_tpu/ops/flash_attention.py:395"),
        "ragged_decode_attention": ("lapha_tpu_torch/csrc/ragged_decode_attention.cu",
                                    "lapha_tpu/ops/ragged_decode_attention.py:68"),
        "flash_attention_bwd_dq": ("lapha_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "lapha_tpu/ops/flash_attention.py:108"),
        "flash_attention_bwd_dkv": ("lapha_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "lapha_tpu/ops/flash_attention.py:165"),
        "ragged_decode_attention_q8": ("lapha_tpu_torch/csrc/ragged_decode_attention.cu",
                                       "lapha_tpu/ops/ragged_decode_attention.py:86"),
        "int4_matmul": ("lapha_tpu_torch/csrc/int4_matmul.cu",
                        "lapha_tpu/ops/int4_matmul.py:83"),
        "grouped_gemm": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                         "lapha_tpu/ops/moe.py:290"),
        # the decode kernel's other decode products, counted on their models' paths
        "grouped_gemm_qwen_down": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                                   "lapha_tpu/ops/moe.py:290"),
        "grouped_gemm_gptoss": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                                "lapha_tpu/ops/moe.py:290"),
        "grouped_gemm_gptoss_down": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                                     "lapha_tpu/ops/moe.py:290"),
        "grouped_gemm_deepseek": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                                  "lapha_tpu/ops/moe.py:290"),
        "grouped_gemm_deepseek_down": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                                       "lapha_tpu/ops/moe.py:290"),
        # the wgmma forward (prefill; the training forward counted on the update paths)
        "grouped_gemm_wg": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                            "lapha_tpu/ops/moe.py:290"),
        "grouped_gemm_wg_train": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                                  "lapha_tpu/ops/moe.py:290"),
        "ragged_decode_attention_sink": ("lapha_tpu_torch/csrc/ragged_decode_attention.cu",
                                         "lapha_tpu/ops/ragged_decode_attention.py:77"),
        "ragged_decode_attention_q8_sink": ("lapha_tpu_torch/csrc/ragged_decode_attention.cu",
                                            "lapha_tpu/ops/ragged_decode_attention.py:96"),
        "flash_attention_window": ("lapha_tpu_torch/csrc/flash_attention.cu",
                                   "lapha_tpu/ops/flash_attention.py:46"),
        "flash_attention_cached_window": ("lapha_tpu_torch/csrc/flash_attention.cu",
                                          "lapha_tpu/ops/flash_attention.py:395"),
        # K8's backward: megablox _gmm_bwd (jax 0.9.0 megablox/ops.py:63-105)
        "grouped_gemm_dx": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                            "jax/experimental/pallas/ops/tpu/megablox/gmm.py:314"),
        "grouped_gemm_tgmm": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                              "jax/experimental/pallas/ops/tpu/megablox/gmm.py:573"),
        # DeepSeek-V2-Lite's 64-expert top-6 shape, counted on its paths
        "grouped_gemm_dx_ds": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                               "jax/experimental/pallas/ops/tpu/megablox/gmm.py:314"),
        "grouped_gemm_tgmm_ds": ("lapha_tpu_torch/csrc/grouped_gemm.cu",
                                 "jax/experimental/pallas/ops/tpu/megablox/gmm.py:573"),
        "flash_attention_bwd_dq_window": ("lapha_tpu_torch/csrc/flash_attention_bwd.cu",
                                          "lapha_tpu/ops/flash_attention.py:108"),
        "flash_attention_bwd_dkv_window": ("lapha_tpu_torch/csrc/flash_attention_bwd.cu",
                                           "lapha_tpu/ops/flash_attention.py:165"),
        # V narrower than Q/K (DeepSeek MLA): the same kernels' dv <= dh
        "flash_attention_narrowv": ("lapha_tpu_torch/csrc/flash_attention.cu",
                                    "lapha_tpu/ops/flash_attention.py:46"),
        "flash_attention_cached_narrowv": ("lapha_tpu_torch/csrc/flash_attention.cu",
                                           "lapha_tpu/ops/flash_attention.py:395"),
        "flash_attention_bwd_dq_narrowv": ("lapha_tpu_torch/csrc/flash_attention_bwd.cu",
                                           "lapha_tpu/ops/flash_attention.py:108"),
        "flash_attention_bwd_dkv_narrowv": ("lapha_tpu_torch/csrc/flash_attention_bwd.cu",
                                            "lapha_tpu/ops/flash_attention.py:165"),
    }
    # the softcapped launches (Gemma-2) are counted apart; the dh-256 rows
    # without a softcap (Gemma-3's shapes) count their kernel's launches on
    # Gemma-3's paths
    for name in ("flash_attention", "flash_attention_window", "flash_attention_cached",
                 "flash_attention_cached_window", "ragged_decode_attention",
                 "ragged_decode_attention_q8", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq_window", "flash_attention_bwd_dkv_window"):
        replaces[name + "_softcap"] = replaces[name]
        if name != "ragged_decode_attention_q8":
            replaces[name + "_dh256"] = replaces[name]
    # the instances of head dim 96 (Phi-3, every layer sliding) and the decode
    # kernel's group of 12 (StarCoder2-3B) count their kernel's launches on
    # those models' paths
    for name in ("flash_attention_window", "flash_attention_cached_window",
                 "ragged_decode_attention", "ragged_decode_attention_q8",
                 "flash_attention_bwd_dq_window", "flash_attention_bwd_dkv_window"):
        replaces[name + "_dh96"] = replaces[name]
    for name in ("ragged_decode_attention", "ragged_decode_attention_q8"):
        replaces[name + "_g12"] = replaces[name]
    # K3 at dh 96 where the band bites (qstart past Phi-3's window): its
    # kernel's launches on Phi-3's paths
    replaces["flash_attention_cached_window_dh96_past"] = replaces["flash_attention_cached_window"]
    row_paths = {"_dh256": ("serve_gemma3", "update_gemma3"),
                 "_dh96": ("serve_phi3", "update_phi3", "train_step_phi3"),
                 "_dh96_past": ("serve_phi3", "update_phi3", "train_step_phi3"),
                 "_g12": ("serve_starcoder2",),
                 "_train": ("update_moe", "update_gptoss", "update_deepseek"),
                 "_qwen_down": ("serve_moe",),
                 "_gptoss_down": ("serve_gptoss",),
                 "_gptoss": ("serve_gptoss",),
                 "_deepseek_down": ("serve_deepseek",),
                 "_deepseek": ("serve_deepseek",),
                 "_ds": ("update_deepseek", "train_step_deepseek")}
    rows = []
    for name, (src, rep) in replaces.items():
        suffix = next((x for x in row_paths if name.endswith(x)), "")
        counter = name.removesuffix(suffix) if suffix else name
        by_path = {path: launches[path][counter] for path in row_paths.get(suffix, launches)}
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     **kernels[name]})
    for row in rows:  # every kernel of the line ran on the paths it is counted on
        check(row["launches"] > 0, f"{row['name']} never launched on {list(row['launches_by_path'])}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
