#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lapha_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root, one H100
    python3 chip_smoke.py --c5     # only the GPT-OSS fused-h0 probe (ROADMAP C5)

Phases, each of which fails the run (traceback, non-zero exit) on any fault.
Phases 10-12, 14, 15, 17 and 18 make their models at full width with the
first CUT_LAYERS (8) layers of the published stack, so that the whole run
stays inside its time limit; the layer counts and sizes given for them
below are the published model's:

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
   its score_mod, a block mask) for the softcapped K1/K3/K4 at the kernels
   line's shapes (not at the suffix prefill's T=64: each new shape is a
   new compile, and the phase took 56-81 s with that shape, 41-42 s
   without, on an H100), held to the plain version at the kernels' limit;
   K5 has none.
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
1m. The verify attention of speculative decoding (``spec_verify_attention``:
   no Pallas kernel, JAX's dense verify in ``qwen2.decode_step_multi``)
   against its plain version in an S=1152 cache whose decode region has
   random holes, at slot 1140: B=24 rows at T = 1, 4 and 8 queries a row,
   B=4 and B=1 at T = 1 and 4 (bf16), and a row whose only live columns are
   the block's new ones (B=1, T=4: most of the cluster's shares are empty);
   Qwen2.5-1.5B's 12/2 heads of dim 128 (bf16 and int8), GPT-OSS-20B's
   64/8 of dim 64 with sinks and a window of 128 by position (bf16 and
   int8), Gemma-2-2B's 8/4 of dim 256 with the softcap 50 (q x25 so that
   it bites), Phi-3-mini's 32/32 of dim 96 (W 2047) and StarCoder2-3B's
   24/2; phase 1/1c's limits, two launches bit-equal, and planted faults
   that must fail: the holes read as valid, the causal rule among the new
   columns off by one, and (Qwen2.5 bf16, where the plan splits a row) a
   build of the kernel whose cluster merge leaves the last rank's partial
   out. Timed as CUDA-graph replays beside the plain version and SDPA
   with the boolean (B, nh, T, S) mask where that computes the same
   function (bf16, no sinks, no softcap).
1n. Block diffusion's block attention (``block_attention``: no Pallas
   kernel, JAX's dense ``block_bidir`` attend; the verify kernel's design
   with the prefill layout and no causal new columns) at B=24, T=4,
   S=768, 12/2 heads of dim 128, prompts of 400-512 tokens, holes up to
   640, the block at 700 and column 706 valid past it: against the plain
   version and an independent dense f32 softmax under JAX's mask (phase
   1's limit), two launches bit-equal; planted faults that must fail: the
   holes read as valid, column 706 not read (the mask cut below the
   block's end, as the route through K3 had it), and a build whose
   cluster merge leaves the last rank out. Timed as CUDA-graph replays
   beside the plain version, SDPA with the boolean mask and K3's shifted
   launch (the kernel it replaced). Llama-3.2-1B's 32/8 heads of dim 64
   at T=16 (two query tiles) checked the same way, untimed.
2d. Two full-width Qwen1.5-MoE-A2.7B layers, card (kernels, bf16) against
   CPU (plain versions, f32): prefill + one decode step, relative error of
   the logits <= 5e-2, with the count of (token, layer) routing choices
   that differ between the two; the same with the card's routing replayed
   on the CPU; then the MoE block of layer 0 alone with the card's routing
   forced on the CPU, relative error <= 1e-2.
10. MoE serving at the full width of Qwen1.5-MoE-A2.7B (24
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
11. GPT-OSS serving at the full width of GPT-OSS-20B, from its
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
   its prefix-hit child, n=1, each KV mode; ROADMAP C5). Last, a greedy
   round with speculative decoding (2 prompts with a repeated tail x n 4,
   64 tokens, K 3, M 2, bf16 KV) against the same engine without it:
   phase 22's agreement rule, the sink verify entry 8 x iterations,
   counted as "serve_gptoss_spec". Then ROADMAP C7's probe, printed only:
   one more token of 16 rows after a block of 160 through
   ``decode_step`` (K5s) and through ``decode_step_multi`` at T=1 (the
   verify kernel's sink entry) on copies of one cache, per layer the
   router input's max |h_a - h_b|, the router logits' difference, the rows
   routed otherwise and the 4th-5th logit gap. The GPT-OSS model is freed
   before the Gemma models are made.
2f. Two full-width layers of each Gemma model, phase 2's check (Gemma-3 at
   prompts of 560 and 534 tokens, past its 512-token window).
12. Gemma serving at full width, from the published config.json
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
15. DeepSeek MLA serving at the full width of DeepSeek-V2-Lite,
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
   warm round timed, peak device memory, phase 11's spec round with the
   bf16 latent (counted as "serve_deepseek_spec") and the int8 latent (the
   weight-absorbed verify is torch products: no attention kernel, K8 for
   the experts), one decode step at 24 rows profiled as in phase 9. The
   model is freed before the dense one is made.
17. Phi-3-mini-4k (32 layers, H 3072, 32/32 heads of dim 96, I 8192 SwiGLU,
   every layer sliding at 2047, V 32064 untied; 7.64 GB) and StarCoder2-3B
   (30 layers, H 3072, 24/2 heads of dim 128, I 12288 plain gelu FFN,
   biased LayerNorms and projections, every layer sliding at 4096, V 49152
   tied; 6.06 GB) served at full width from their published
   config.json through ``Qwen2Config.from_hf``, random bf16 weights from the
   seed, each made and freed in turn: phase 2's two-layer check (Phi-3's at
   prompts of 2100 and 2074 tokens, past its window), then phase 12's
   rounds with bf16 KV and int8 KV, counted under "serve_phi3" /
   "serve_starcoder2" (the windowed K1/K3 and K4/K5 and nothing else:
   dh 96 for Phi-3, the group of 12 for StarCoder2), phase 4's checks, a
   warm round timed, then phase 11's spec round (2 prompts with a repeated
   tail x n 4, 64 tokens, K 3, M 2, bf16 KV) against the same engine
   without it, counted as "serve_phi3_spec" / "serve_starcoder2_spec"
   (the verify kernel's bf16 entry L x iterations, at dh 96 and at the
   group of 12), peak memory, one decode step profiled.
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
22. Speculative decoding (``Engine(spec_decode="pld")``, K 3, M 2) on the
   phase-3 model (28 layers, the weights as drawn): 24 rows (4 prompts of
   512 ids with a repeated tail x n 6), 128 new tokens, each run against
   the same engine without spec. (a) Greedy, bf16 KV, collect_h0 (counted
   as "serve_spec"), (b) greedy, int8 KV ("serve_spec_q8"): the streams
   agree up to their first divergence, where the non-spec decode's own
   top-2 margin must be within phase 21's greedy margin (SPEC_TIE =
   SERVE_LP_ATOL); printed: the agreed
   share, ``last_spec_stats``, tok/s with and without spec, host ms an
   iteration and a step; the verify kernel ran 28 x iterations (+ 28 for
   (a)'s h0 fix-up), the ragged decode kernel never, K3 for the prefill;
   the path's 5th layer-0 verify launch held to its plain version. (c)
   Sampled at temperature 0.8, top_p 0.95: tokens an iteration and tok/s
   with and without spec. (d) (a)'s 24 pooled h0 against a value forward
   over prompt + completion (phase 4's limit; the bonus token's fix-up
   forward included). Last, a profiled 8-token generate with and without
   spec: device ms an iteration of the decode part.
23. Block diffusion (``DiffusionEngine``, ``qwen2.forward(block_bidir=True)``
   over the block attention of phase 1n) on the phase-3 model (28 layers,
   the weights as drawn), mask id 151665, no EOS: 4 prompts of 512 ids x
   n 6, 128 new tokens, blocks of 4, 4 denoising steps. (a) Greedy with
   each strategy: "sequential" (counted as "serve_diffusion": the block
   attention 28 x forwards, K3 once a layer for the prefill, no decode
   kernel) and "low_confidence_static" take 32 x (4 + 1) = 160 forwards,
   "low_confidence_dynamic" 64; 128 tokens a row, never the mask id. (b)
   The sequential round with the block attention patched to its plain
   version: the streams agree up to phase 22's near ties. (c)
   Sampled (temperature 0.8, top-p 0.95, top-k 20, dynamic 0.9) twice with
   one seed: the same tokens. (d) Two layers, ``forward(block_bidir=True)``
   over phase 1n's cache with holes, card against CPU (phase 2's limit).
   (e) ``ContinuousEngine`` of 16 rows over a dynamic engine: the 24 rows,
   16 at a time, and a late short request that no longer fits the columns
   left, so the scheduler compacts (at least once), counted as
   "serve_diffusion_sched"; each request's tokens agree with (a)'s up to
   near ties. Printed: tok/s,
   forwards/s, tokens a forward, host ms a forward; last, a profiled
   one-block generate gives device ms a forward.
8. Quantized serving at bench.py's shape: the phase-3 weights quantized on
   the card (``quantize_params(bits=4)``: int4 projections, int8 embed/head)
   and ``Engine(kv_quant="int8")``; a round is 8 parents x 512 tokens with
   n=6 and 256 new tokens (48 decode rows, S=768), 4 prefix-hit children,
   the root value forward and ``from_pooled`` + V. Launch counts are zeroed
   before the first round and read after it: the int4 kernel and the int8
   decode kernel ran, the bf16 decode kernel did not. Phase 4's checks
   follow, the fused-h0 check with a tolerance for the int8 cache, and the
   round's times are printed (no second, warm round: phases 2-5 and 22 ran
   these kernels first); then the same round with bf16 weights + int8 KV
   (bench.py's default configuration).
9. Where one decode step's time goes at bench.py's shape (48 rows, prompts
   of 512, S=768), for bf16 weights with a bf16 cache, bf16 weights with an
   int8 cache and int4 weights with an int8 cache: host-clock time per step
   (device synchronised after each), device time per step (``torch.profiler``,
   the CUDA kernels' own time summed), launches per step and the largest
   kernels.
19. The evaluation entry, ``lapha_tpu_torch.evalsuite.rollout_jsonl.main``,
   on the phase-3 model and the first 2 questions of data/math-500.jsonl at
   eval.sh's sampling (temperature 0.3, top-p 0.8, top-k 20, repetition
   penalty 1.05), 64 new tokens a step, max model length 2048: value mode
   (depth 2, breadth 6, 4 simulations, k 4), value mode with
   ``--kv-quant int8``, react mode (depth 2) and single mode. The tokenizer
   is ``ChatIdTok`` (no tokenizer files are in reach), and the CLI gets the
   engine and value function it would build from a checkpoint through its
   ``engine_override`` / ``value_fn_override`` seam (``Engine(collect_h0=
   True)`` in value mode, as the CLI's own engine_kw; ``ValueFunction`` on
   the same weights). Launch counts are zeroed before each run and read
   after it (eval_value: K1, K3 and K4 must have run; eval_value_q8: K5 and
   not K4). Each run's JSONL is held to tests/test_cli_e2e.py's contract (2
   rows, a string completion, completions[0] and final_answers[0] the pass@1
   fields, 1 <= k <= 4 in value mode, 1 otherwise) and scored by
   ``eval_math.main`` (``LAPHA_EVAL_DIR`` a temp dir, set before the
   module is (re)loaded), whose summary must count 2 questions. The kernels are held to
   their plain versions at the shapes this path gives them: copies of the
   path's own launches (the first of each K1/K3 shape, fresh and after a
   prefix hit; for K4/K5 and each row count, the layer-0 launch with the
   longest rows) against the plain versions on the same inputs, with phase
   1's limits; each decode launch's plan must split its rows (at least one
   into >= 4 CTAs, where phase 1 checks 2 at this head dim), and the first
   split's share of each row lost in the merge (a planted fault) must fail
   the check. In value mode a suffix prefill after
   a prefix hit must have run, and the last expansion's pooled h0 is held
   to a value forward over its prompt + completion (phase 4's fused-h0
   check; FUSED_Q8_RTOL with the int8 cache). Wall seconds per question
   (the copies included), tokens generated and peak device memory are
   printed.
6. One ``MTPOTrainer.train_step`` at full width through the normal entry:
   the first step of phase 20's run (28 layers, gradient checkpointing,
   beta 1e-8 as configs/lapha.yaml, a token-id chat tokenizer over the
   whole vocabulary, two questions with a CoT anchor, depth 2, breadth 4,
   num_sim 4, 32 new tokens per step), its launches counted apart as
   "train_step"; finite loss and grad norm where it trained.
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
14. Gemma training at full width, after phase 13: Gemma-2-2B
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
18. Phi-3-mini-4k and StarCoder2-3B training at full width (3.82
   and 3.03 B params), after phase 16, each made and freed in turn: phase
   14's steps (phase 2b's check on the first two layers, non-zero gradients
   in every layer's q/k/v/o, norms (StarCoder2's LayerNorm biases) and MLP
   (c_fc / c_proj with their biases), three counted updates under
   "update_phi3" / "update_starcoder2": the windowed K1 and K2, dh 96 for
   Phi-3; finite loss and grad norm, moved params, generation after the
   update with changed logits, a warm and a profiled step, the peak
   memory); then one MTPOTrainer.train_step on Phi-3 ("train_step_phi3").
20. The training entry, ``lapha_tpu_torch.run_dapo.main``, after phase 7 on
   the phase-3 model (28 layers at Qwen2.5-1.5B's full width): the weights
   written by ``loader.export_hf`` with Qwen2.5-1.5B-Instruct's published
   config.json (phase 3's max_position_embeddings) and loaded back
   bit-equal; then ``main`` with configs/lapha.yaml and typed overrides
   (phase 6's search knobs, 2 steps of 2 questions, lr 1e-3, no warmup,
   ``--device cuda``), ``ChatIdTok`` and four DAPO-format MATH-500 rows
   written as a parquet and read by the entry's ``dataloader``, each
   record given a CoT anchor. Checks: step 2 reached, metrics.jsonl with
   two steps of the reference's scalar names, ``checkpoints/step_2`` and
   ``latest``, ``save_model``'s export and both value-head files loaded
   back bit-equal to the trainer's params and head, moved and finite
   leaves, K1, K2 (dq and dk/dv), K3 and K4 counted, and the path's own
   first K1/K3 launch of each shape, longest layer-0 K4 launch and first
   dq and dk/dv launches held to the plain versions (phase 19's checks and
   planted decode fault; K2 at phase 1b's limits). The files go where the
   machine has ~32 GB free (checked first) and are deleted after. Seconds
   per part, bytes written, peak memory and the PNG count are printed.
21. The serving entry, ``lapha_tpu_torch.engine.server.main``, after phase
   20, on phase 3's weights as drawn (made again from the seed; phase 7's
   update leaves a model whose greedy stream is one token for every
   prompt, where nearly every greedy token is a near tie the check skips),
   exported by ``loader.export_hf`` (28 layers at Qwen2.5-1.5B's full
   width), ``--device cuda``, ChatIdTok, port 0, 16 rows, 2048 columns,
   the served weights held bit-equal to the drawn ones: a burst of 12
   concurrent requests from the port's ``EngineClient`` (prompts of
   200-500 ids, n 1-4, 32-128 new tokens,
   greedy and sampled at 0.7 / top_p 0.95 by turns, a repetition penalty
   of 1.05 on every third), a short request admitted while a long one
   decodes (both prefix hits; the short one finishes first), a streamed
   request (its deltas make each finish event, then done), the routes
   (health, world size 1, prefix reset) and a weight reload from the same
   directory (the same greedy answer); the server again with 256 prompt
   columns of 512, where a compaction must happen; ``Engine(
   auto_continuous=True)`` on 32 prompts whose greedy streams stop at
   skewed lengths (an EOS set picked from a probe run before the counted
   window; fewer decode steps than the sum of the waves' maxima); all
   counted as "serve_http". Then the server with ``--kv-quant int8``, a
   second burst and a second late pair ("serve_http_q8"). The bursts are
   timed with the launch recorder off. Every sample is held to a
   teacher-forced forward of the same weights: a sampled token's logprob
   within SERVE_LP_ATOL (SERVE_LP_Q8_ATOL) of the forward's after
   ``sampling.process_logits`` with the request's parameters and presence,
   a greedy token the argmax wherever the top-2 margin exceeds the limit.
   The path's own K3 / K4 / K5 launches are held to the plain versions
   (phase 19's checks; the kept decode launch is the first whose live rows
   start their decode ranges at the most columns, and must have two or
   more). A planted fault (rows installed with dstart = slab in place of
   their admission column) must fail the teacher-forced check. Printed:
   requests, tokens, wall s, tok/s, p50 and max latency, steps, waves,
   compactions, one scheduler chunk's host and device ms, peak memory,
   launches, the phase's seconds. The engine's prefill writes a cache and
   so runs the cached entry (K3's counter) at qstart 0: K1's counter does
   not move on these paths.

Launch counts are read per path (serve_moe: phase 10; serve_gptoss: phase
11; serve_gemma2 and serve_gemma3: phase 12; serve_deepseek: phase 15;
serve: phase 3; serve_spec, serve_spec_q8: phase 22; serve_gptoss_spec: phase
11; serve_deepseek_spec: phase 15;
serve_quantized: phase 8; eval_value, eval_value_q8, eval_react and
eval_single: phase 19; train_step: phase 6; update: phase 7;
update_moe, update_gptoss and train_step_moe: phase 13; update_gemma2,
update_gemma3 and train_step_gemma2: phase 14; update_deepseek and
train_step_deepseek: phase 16; serve_phi3, serve_starcoder2, serve_phi3_spec
and serve_starcoder2_spec: phase 17;
update_phi3, update_starcoder2 and train_step_phi3: phase 18; train_entry:
phase 20; serve_http and serve_http_q8: phase 21). Prints the
card's name and power
limit, each timing beside them, one JSON line of per-kernel results (each
row with its time, the plain version's, the time of one PyTorch call that
computes the same function where there is one, and its bound: the larger
of the bytes it must move at 3.35 TB/s and its operations at 989 TFLOP/s,
for the timed shape), and finally
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import concurrent.futures
import gc
import json
import math
import os
import re
import shutil
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
# the layers of the published stack that phases 10-12, 14, 15, 17 and 18
# make (full width; the first layers, so that every window kind and, for
# DeepSeek, the dense layer stay): the run's time limit
CUT_LAYERS = 8

# GPT-OSS-20B's published config.json (HF openai/gpt-oss-20b), the model
# phases 2e and 11 serve at full width through Qwen2Config.from_hf
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
# 2f and 12 serve at full width through Qwen2Config.from_hf
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
# the model phases 2h and 15 serve at full width through
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
    alike. The library time is None without a library call, the plain time
    None without a plain version."""
    plain_timer = plain_timer or timer

    def plain():
        return None if plain_fn is None else plain_timer(plain_fn)

    k1, p1 = timer(kernel_fn), plain()
    lib = None
    if library_fn is not None:
        lib = (timer(library_fn) + timer(library_fn)) / 2
    p2, k2 = plain(), timer(kernel_fn)
    return (k1 + k2) / 2, None if plain_fn is None else (p1 + p2) / 2, lib


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


def _tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


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
    its score_mod) for the softcapped shapes of the kernels line's rows (the
    first shape of each), itself held to the plain version at the kernel's
    limit; K5 has none (no one call reads an int8 cache)."""
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
                rk = key(name, window, cap)
                if cap and rk in results:
                    # flex_attention is timed for the kernels line's shape only:
                    # another shape costs another compile
                    lib_fn, lib_name = None, "flex_attention not timed at this shape"
                elif cap:
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
                lib_txt = lib_name if lib_ms is None else f"{lib_name} {lib_ms:.4f} ms"
                print(f"kernel {label}: max|diff| {err:.3e}, {ms:.4f} ms vs plain {plain_ms:.4f} "
                      f"ms, {lib_txt}, bound {row['bound_ms']:.4f} ms ({row['bound_by']}){note} "
                      f"[{card}]", flush=True)
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
    """A model at full width from its published config (Gemma, Phi-3,
    StarCoder2), its first CUT_LAYERS layers, random bf16 weights from the
    seed. With Gemma-2's
    softcaps the q projections are scaled x16 and the embedding x32, so
    that attention logits reach ~1-2x the cap of 50 and the final logits
    the cap of 30 (with the init's scales neither cap would bite)."""
    import torch

    from lapha_tpu_torch.models import qwen2, quant, value_model

    cfg = qwen2.Qwen2Config.from_hf(dict(hf_config, num_hidden_layers=CUT_LAYERS))
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


def serve_published(dev, card, hf_config, label, path, kv_modes, ref_kw, phases="2f and 12",
                    spec=False) -> dict:
    """Phases 2f and 12 (Gemma) and 17 (Phi-3, StarCoder2) on one model
    made here from its published config and freed before the return: the
    two-layer check (``ref_kw``: its prompt and cache lengths), then serve's
    round for each KV mode in ``kv_modes``, counted, checked (the K1/K3 of
    the stack's window kinds and K4, K5 over the int8 cache, under the
    softcap's names when the model has one, and nothing else), a warm round
    timed, with ``spec`` phase 11's spec round (bf16 KV, counted), peak
    memory, one decode step profiled. Returns the launch counts of the
    counted rounds: the served path's as ``path``, the spec round's as
    ``path + "_spec"``."""
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
    paths = {path: launches}
    if spec:  # the spec path: greedy with and without speculative decoding, bf16 KV
        res = _spec_round(params, cfg, _spec_prompts(rng, cfg.vocab_size, 2, plen), 4, new,
                          dict(kw, collect_h0=False), f"phase {phases}, {label} bf16 KV", card)
        la, it = res["launches"], res["stats"]["iterations"]
        name = "spec_verify_attention" + ("_softcap" if cap else "")
        check(la[name] == cfg.num_hidden_layers * it,
              f"{name} launched {la[name]} times on the {label} spec path, expected "
              f"{cfg.num_hidden_layers} x {it} iterations")
        for other, count in la.items():
            check(other == name or not other.startswith("spec_verify") or count == 0,
                  f"{other} ran {count} times on the {label} spec path")
        paths[path + "_spec"] = la
        del res
    _profile_served(label, params, cfg, P * n, plen, plen + 2 * new, SEED + 19, card)
    del params, head
    torch.cuda.empty_cache()
    print(f"phases {phases} ({label}) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return paths


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
    """Phases 2d and 10 on one MoE model made here (the first CUT_LAYERS
    layers) and freed before the return. Returns the launch counts of the
    first round."""
    import dataclasses

    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.models import qwen2, quant, value_model
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    cfg = dataclasses.replace(_moe_cfg(), num_hidden_layers=CUT_LAYERS)
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
    """Phases 2e and 11 on one GPT-OSS-20B model made here (the first
    CUT_LAYERS layers) and freed before the return; phase 11 ends with a
    greedy round with and without speculative decoding. Returns the launch
    counts of the counted rounds ("serve_gptoss") and of the spec round
    ("serve_gptoss_spec")."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    t_phase = time.perf_counter()
    params, head, cfg = _gptoss_model(dev, card, layers=CUT_LAYERS)
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
    # the spec path: greedy with and without speculative decoding, bf16 KV
    spec = _spec_round(params, cfg, _spec_prompts(rng, cfg.vocab_size, 2, plen), 4, new,
                       dict(kw, collect_h0=False), "phase 11, GPT-OSS-20B bf16 KV", card,
                       router="route_topk_softmax")
    la, it = spec["launches"], spec["stats"]["iterations"]
    check(la["spec_verify_attention_sink"] == cfg.num_hidden_layers * it,
          f"spec_verify_attention_sink launched {la['spec_verify_attention_sink']} times on the "
          f"GPT-OSS spec path, expected {cfg.num_hidden_layers} x {it} iterations")
    for name in ("ragged_decode_attention_sink", "spec_verify_attention"):
        check(la[name] == 0, f"{name} ran {la[name]} times on the GPT-OSS spec path")
    del spec
    probe_c7(params, cfg, dev, card)
    _profile_served("GPT-OSS-20B", params, cfg, P * n, plen, plen + 2 * new, SEED + 16, card)
    del params, head
    torch.cuda.empty_cache()
    print(f"phases 2e and 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"serve_gptoss": launches, "serve_gptoss_spec": la}


def probe_c7(params, cfg, dev, card, rows: int = 16, steps: int = 160, T: int = 4) -> None:
    """ROADMAP C7, printed only: GPT-OSS's bf16 decode paths on one state.
    ``rows`` rows of ``steps`` random tokens are written into an empty cache
    as one block (past the 128-token window). Then, each on its own copy of
    that cache, the next token goes through ``qwen2.decode_step`` (K5s) and
    through ``decode_step_multi`` at T = 1 (the verify kernel's sink entry),
    and the next ``T`` tokens through ``T`` calls of ``decode_step`` and
    through one ``decode_step_multi`` at T (the block the spec loop
    verifies). The router's inputs are recorded (``moe.route_topk_softmax``
    wrapped). Per layer, for each pair and each of the block's tokens: max
    |h_a - h_b| of the router input, max |logit_a - logit_b| of the router
    logits, the rows whose top-k sets differ, and the 4th-5th router logit
    gap (the smallest over the rows, and at the rows routed otherwise)."""
    import torch

    from lapha_tpu_torch.models import qwen2
    from lapha_tpu_torch.ops import moe

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    L, nkv, dh, k = (cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim_,
                     cfg.num_experts_per_tok)
    S = steps + 2 * T
    ck = torch.zeros((L, rows, nkv, S, dh), dtype=torch.bfloat16, device=dev)
    cv = torch.zeros_like(ck)
    toks = torch.randint(2, cfg.vocab_size, (rows, steps + T), generator=gen, device=dev)
    zeros = torch.zeros(rows, dtype=torch.int32, device=dev)
    ar = torch.arange(S, device=dev)
    pos_map = ar[None, :].expand(rows, S).to(torch.int32).contiguous()
    valid = (ar < steps)[None, :].expand(rows, S).contiguous()
    calls, route = [], moe.route_topk_softmax

    def recording(x, router_w, router_b, top_k):
        logits = moe._mm_f32(x, moe.dequant(router_w, x.dtype)) + router_b.float()
        calls[-1].append((x.float(), logits))
        return route(x, router_w, router_b, top_k)

    def stepwise(n):  # n decode_step calls: per layer (rows, n, H) inputs, (rows, n, E) logits
        kc, vc, per_step = ck.clone(), cv.clone(), []
        for t in range(n):
            calls.append([])
            pos = torch.full((rows,), steps + t, dtype=torch.int32, device=dev)
            qwen2.decode_step(params, cfg, toks[:, steps + t], pos, kc, vc, steps + t, zeros,
                              zeros)
            per_step.append(calls.pop())
        return [tuple(torch.stack([c[l][j] for c in per_step], 1) for j in (0, 1))
                for l in range(L)]

    def block(n):  # one decode_step_multi at T = n: the same, from its (rows·n) router calls
        calls.append([])
        pos = steps + torch.arange(n, dtype=torch.int32, device=dev)[None, :].expand(rows, n)
        qwen2.decode_step_multi(params, cfg, toks[:, steps:steps + n], pos, ck.clone(),
                                cv.clone(), steps, valid, pos_map=pos_map)
        return [(x.reshape(rows, n, -1), lg.reshape(rows, n, -1)) for x, lg in calls.pop()]

    with torch.inference_mode():
        # the state: the first `steps` tokens written as one block
        qwen2.decode_step_multi(params, cfg, toks[:, :steps], pos_map[:, :steps], ck, cv, 0,
                                torch.zeros((rows, S), dtype=torch.bool, device=dev),
                                pos_map=pos_map)
        moe.route_topk_softmax = recording
        try:
            pairs = {1: (stepwise(1), block(1)), T: (stepwise(T), block(T))}
        finally:
            moe.route_topk_softmax = route
        torch.cuda.synchronize()
    worst = {}
    for n, (a, b) in pairs.items():
        check(len(a) == len(b) == L, f"C7 probe: router calls {len(a)}, {len(b)} for {L} layers")
        flips, firsts, near, gap_at, ldiff = 0, 0, 0, 0.0, 0.0
        gone = torch.zeros((rows, n), dtype=torch.bool, device=dev)  # routed otherwise before
        for l, ((xa, la), (xb, lb)) in enumerate(zip(a, b)):
            ta, tb = la.topk(k + 1, dim=-1), lb.topk(k + 1, dim=-1)
            gap_a = ta.values[..., k - 1] - ta.values[..., k]        # (rows, n)
            gap_b = tb.values[..., k - 1] - tb.values[..., k]
            other = (ta.indices[..., :k].sort(-1).values
                     != tb.indices[..., :k].sort(-1).values).any(-1)  # (rows, n)
            h = (xa - xb).abs().amax(dim=(0, 2))                     # by token of the block
            d = (la - lb).abs().amax(dim=(0, 2))
            flips += int(other.sum())
            ldiff = max(ldiff, float(d.max()))
            # a (row, token)'s first re-routing: its smaller gap against its
            # own largest router-logit difference (a swap of the 4th and 5th
            # needs gap <= 2 x that)
            first = other & ~gone
            if bool(first.any()):
                gap = torch.minimum(gap_a, gap_b)[first]
                own = (la - lb).abs().amax(-1)[first]
                firsts += int(first.sum())
                near += int((gap <= 2 * own).sum())
                gap_at = max(gap_at, float(gap.max()))
            gone |= other
            at = (f"; at them {gap_a[other].tolist()} / {gap_b[other].tolist()}"
                  if bool(other.any()) else "")
            print(f"C7 probe, GPT-OSS-20B layer {l}, {n} decode_step vs decode_step_multi at "
                  f"T={n}: router input max|h_a - h_b| by token {[f'{v:.3e}' for v in h.tolist()]}"
                  f" (max|h| {float(xa.abs().max()):.3e}), router logits max|diff| by token "
                  f"{[f'{v:.3e}' for v in d.tolist()]}; rows routed otherwise by token "
                  f"{other.sum(0).tolist()} of {rows}; 4th-5th logit gap, smallest over the rows "
                  f"{float(gap_a.min()):.3e} / {float(gap_b.min()):.3e}{at} [{card}]", flush=True)
        worst[n] = (flips, firsts, near, gap_at, ldiff)
    print("C7 probe, GPT-OSS-20B: " + "; ".join(
        f"T={n}: {f} (row, token, layer) routed otherwise of {rows * n * L}; {fi} (row, token) "
        f"re-routed a first time, {ne} of them where the 4th-5th gap is at most twice that "
        f"token's largest router-logit difference, the largest gap there {g:.3e}; the largest "
        f"router-logit difference {d:.3e}"
        for n, (f, fi, ne, g, d) in worst.items()) + f" [{card}]", flush=True)


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


# phase 1m's shapes: (family, heads, KV heads, head dim, window, softcap, sinks, int8 too, the
# kernels line's rows: (cache kind, T) at B=24 -> row name)
VERIFY_1M_CASES = (("Qwen2.5-1.5B", 12, 2, 128, 0, 0.0, False, True,
                    {("", 4): "spec_verify_attention", ("_q8", 4): "spec_verify_attention_q8",
                     ("", 1): "spec_verify_attention_t1"}),
                   ("GPT-OSS-20B", 64, 8, 64, 128, 0.0, True, True,
                    {("", 4): "spec_verify_attention_sink"}),
                   ("Gemma-2-2B", 8, 4, 256, 0, GEMMA_CAP, False, False, {}),
                   ("Phi-3-mini", 32, 32, 96, 2047, 0.0, False, False,
                    {("", 1): "spec_verify_attention_t1_phi3"}),
                   ("StarCoder2-3B", 24, 2, 128, 4096, 0.0, False, False,
                    {("", 1): "spec_verify_attention_t1_starcoder2"}))
# (B, T, int8 too, only the block's new columns live) of each family
VERIFY_1M_GEOMETRIES = ((24, 1, True, False), (24, 4, True, False), (24, 8, True, False),
                        (4, 1, False, False), (4, 4, False, False),
                        (1, 1, False, False), (1, 4, False, False), (1, 4, False, True))
# the merge-fault build's instances: Qwen2.5's head dim at 1 and 3 n8 tiles
# (6 query rows at T = 1; 24 at T = 4, and at T = 8 over two CTAs; block
# diffusion's 24 rows at T = 4)
MERGE_FAULT_INSTANCES = ("LAPHA_SV(128, 1)", "LAPHA_SV(128, 3)")


def _merge_fault_build():
    """Phases 1m and 1n's planted merge fault: a copy of the verify kernel's
    header whose cluster merge leaves the last rank's partial out (its sum
    and its part of every slice get the factor 0), with only Qwen2.5's
    instances, and the verify attention's bf16 entry and block diffusion's
    block-attention entry beside it (the same kernel), compiled into a
    library of their own under ``_build/merge_fault/``
    (``bench_k2.compile_sources``). Started beside the checks of phases
    1-1l (``main``), so its nvcc runs while they do. Returns (library,
    ptxas report)."""
    import ctypes

    from lapha_tpu_torch.bench_k2 import compile_sources
    from lapha_tpu_torch.ops import _cuda

    with open(os.path.join(_cuda.CSRC, "spec_verify_attention.cuh")) as f:
        src = f.read()
    merge = ("        cf[k * QB + r] = f;\n        L += in_ml[2 * (k * QB + r) + 1] * f;",
             "        cf[k * QB + r] = k < splits - 1 ? f : 0.f;\n"
             "        L += k < splits - 1 ? in_ml[2 * (k * QB + r) + 1] * f : 0.f;")
    check(src.count(merge[0]) == 1, "the merge-fault build: the cluster merge's lines changed")
    src = src.replace(*merge)
    src = re.sub(r"  LAPHA_SV\(\d+, \d+\)\n",
                 lambda m: m.group(0) if m.group(0).strip() in MERGE_FAULT_INSTANCES else "", src)
    out_dir = os.path.join(_cuda.BUILD_DIR, "merge_fault")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spec_verify_attention.cuh"), "w") as f:
        f.write(src)
    # the two entries' sources, with the edited header beside them
    for entry in ("spec_verify_attention.cu", "block_attention.cu"):
        shutil.copyfile(os.path.join(_cuda.CSRC, entry), os.path.join(out_dir, entry))
    (_, so, report), = compile_sources([os.path.join(out_dir, "spec_verify_attention.cu")],
                                       "merge_fault", siblings="*.cu")
    dll = ctypes.CDLL(so)
    _cuda.bind_verify(dll)
    return dll, report


def check_verify_kernels(dev, card, merge_fault):
    """Phase 1m: the verify attention of speculative decoding
    (``ops/spec_verify_attention``, no Pallas kernel: JAX's dense verify in
    ``qwen2.decode_step_multi``) against its plain version on the same
    inputs, at Qwen2.5-1.5B (12/2 heads, dh 128, bf16 and int8), GPT-OSS-20B
    (64/8, dh 64, sinks, a window of 128 by position; bf16 and int8),
    Gemma-2-2B (8/4, dh 256, softcap 50, q x25 so that it bites), Phi-3-mini
    (32/32, dh 96, W 2047) and StarCoder2-3B (24/2: a group of 12), in an
    S=1152 cache with random holes in the decode region at slot 1140, at the
    geometries of ``VERIFY_1M_GEOMETRIES`` (B=24 at T 1, 4, 8; B=4 and 1 at
    T 1, 4; a row whose only live columns are the block's new ones). Limits:
    phase 1's bf16 limit and phase 1c's int8 rule. Planted faults that must
    fail each check: the holes read as valid (the holes' V is x4, so reading
    them shows), and the causal rule among the new columns off by one
    (query t also sees column slot + t + 1, whose key is x4: the kernel run
    one column on with column slot marked valid); and where the plan splits
    a Qwen2.5 bf16 row, ``merge_fault`` (a future of
    :func:`_merge_fault_build`): the kernel whose merge drops the last
    rank's partial. Timed as CUDA-graph replays beside the plain version
    and, where it computes the same function (no sinks, no softcap, bf16),
    SDPA with the boolean (B, nh, T, S) mask over the same cache views."""
    import numpy as np
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
    from lapha_tpu_torch.bench_verify import _call, verify_geometry
    from lapha_tpu_torch.models.qwen2 import _quantize_kv
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import spec_verify_attention as sva

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    L, S, slot = 2, 1152, 1140
    results = {}
    bad_dll, bad_report = merge_fault.result()
    print(f"phase 1m's merge-fault build (the last rank dropped), ptxas:\n{bad_report}",
          flush=True)
    merge_caught = 0
    for fam, nh, nkv, dh, W, cap, with_sinks, with_q8, rows in VERIFY_1M_CASES:
        scale = dh ** -0.5
        sinks = (torch.from_numpy(_gptoss_sinks(np.random.default_rng(SEED + 41), nh)).to(dev)
                 if with_sinks else None)
        for B, T, geo_q8, fresh_only in VERIFY_1M_GEOMETRIES:
            valid, pos_map, positions, holes = verify_geometry(gen, B, S, slot, T, dev)
            if fresh_only:
                valid.zero_()
            q = torch.randn((B, T, nh, dh), generator=gen, device=dev) * (25.0 if cap else 1.0)
            q = q.to(torch.bfloat16)
            kc = torch.randn((L, B, nkv, S, dh), generator=gen, device=dev)
            vc = torch.randn((L, B, nkv, S, dh), generator=gen, device=dev)
            kc[1, :, :, slot + T] *= 4.0                         # the column past the block
            vc[1] = torch.where(holes[:, None, :, None], vc[1] * 4.0, vc[1])
            kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
            vis = sva.verify_visible(valid, positions, slot, pos_map, W)
            cases = [("", kc, vc, None)]
            if with_q8 and geo_q8:
                (kq, ks), (vq, vs) = _quantize_kv(kc), _quantize_kv(vc)
                cases.append(("_q8", kq, vq, (ks, vs)))
            for kind, kk, vv, scl in cases:
                def kernel(vm=valid, at=slot, pm=pos_map, kk=kk, vv=vv, scl=scl):
                    return sva.spec_verify_attention(q, kk, vv, 1, at, vm, positions, pm, W,
                                                     scale, cache_scale=scl, sinks=sinks,
                                                     softcap=cap)

                def plain(kk=kk, vv=vv, scl=scl):
                    return sva.spec_verify_plain(q, kk, vv, 1, slot, valid, positions, pos_map,
                                                 W, scale, cache_scale=scl, sinks=sinks,
                                                 softcap=cap)

                def excess(out, ref, scl=scl):
                    if scl is not None:
                        return _q8_excess(out, ref)
                    return float((out.float() - ref.float()).abs().max()) - KERNEL_ATOL

                name = sva.launch_name(scl is not None, with_sinks, cap)
                plan = sva.verify_plan(B, nkv, nh // nkv, T, S, _cuda.sm_count(dev), dh=dh,
                                       int8=scl is not None,
                                       smem=_cuda.lib().lapha_spec_verify_smem, window=W)
                label = (f"{name} ({fam}) dh={dh} {nh}/{nkv} heads B={B} T={T} S={S} "
                         f"slot={slot} W={W}{' new columns only' if fresh_only else ''}, "
                         f"plan {tuple(plan)}")
                out, again, ref = kernel(), kernel(), plain()
                # the planted faults: every hole read as valid; query t also
                # sees column slot + t + 1 (one column on, column slot valid)
                off_vm, off_pm = valid.clone(), pos_map.clone()
                off_vm[:, slot] = True
                off_pm[:, slot] = positions[:, 0]
                faults = {"the holes read as valid": kernel(vm=valid | holes),
                          "the causal rule among the new columns off by one":
                              kernel(vm=off_vm, at=slot + 1, pm=off_pm)}
                if fam.startswith("Qwen") and scl is None and plan.splits > 1:
                    faults["the last rank's partial dropped in the merge"] = _call(
                        bad_dll, q, kk, vv, None, valid, positions, pos_map, W, None, scale,
                        cap)().clone()
                    merge_caught += 1
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                check(bool(torch.isfinite(out.float()).all()) and excess(out, ref) <= 0,
                      f"{label}: max|diff| {err}")
                check(torch.equal(out, again), f"{label}: two launches differ")
                notes = []
                for what, bad in faults.items():
                    check(excess(bad, ref) > 0, f"the {label} check missed a planted fault "
                                                f"({what})")
                    notes.append(f"planted fault ({what}) max|diff| "
                                 f"{float((bad.float() - ref.float()).abs().max()):.3e}, caught")
                lib_fn, lib = None, "none (sinks, a softcap or an int8 cache: no one call)"
                if scl is None and not with_sinks and not cap:
                    lib_fn = _sdpa(q, kc[1].transpose(1, 2), vc[1].transpose(1, 2), vis, scale)
                    lib = "sdpa"
                # the plain version is timed for the kernels line's rows only
                row = rows.get((kind, T)) if B == 24 else None
                ms, plain_ms, lib_ms = _ab_ms(kernel, plain if row else None, lib_fn,
                                              timer=graph_ms)
                if lib_ms is not None:
                    lib = f"{lib} {lib_ms:.4f} ms"
                # K and V of the columns some query of the row sees (int8: +
                # two f32 scales) for each KV head; q, out, the map, positions
                # (and the position map where windowed)
                per_col = 2 * dh * kk.element_size() + (8 if scl is not None else 0)
                n_cols = int(vis.any(dim=1).sum())
                nbytes = (n_cols * nkv * per_col + 2 * _nbytes(q) + _nbytes(valid, positions)
                          + (_nbytes(pos_map) if W else 0))
                r = _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh * nh * int(vis.sum()))
                plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
                print(f"kernel {label}: max|diff| {err:.3e}, bit-equal over two launches, "
                      f"{ms:.4f} ms vs plain {plain_txt}, {lib}, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}); {'; '.join(notes)} [{card}]",
                      flush=True)
                if row is not None:
                    results[row] = r
    check(merge_caught > 0, "phase 1m ran the merge fault at no split row")
    print(f"phase 1m took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def check_block_kernels(dev, card, merge_fault):
    """Phase 1n: block diffusion's block attention (``ops/block_attention``:
    no Pallas kernel, JAX's dense ``block_bidir`` attend), as
    ``qwen2.forward(block_bidir=True)`` launches it: B=24 rows, T=4 block
    tokens, an S=768 cache of 12/2 heads of dim 128, prompts of 400-512
    tokens, holes up to Lp=640, the block at cp=700, kv_valid = (j < lens) |
    (640 <= j < cp + 4), and column cp + 6 valid past the block (JAX's mask
    sees it). Held to the plain version and to an independent dense f32
    softmax under JAX's mask formula (``lapha_tpu/models/qwen2.py:1320``:
    valid & (j <= cp + t | j >= cp)), at phase 1's limit; two launches
    bit-equal. The block's keys are x4 so that its columns carry the
    attention, the column past the block weighs (K x4, V x2: outputs stay
    small enough for bf16's rounding to keep within the limit) and the
    holes' V is x4, so that a fault shows. Planted faults that must fail: the holes
    read as valid, the valid column past the block not read (the mask cut
    below cp + T, as the route through K3 had it), and ``merge_fault`` (a
    future of :func:`_merge_fault_build`): the kernel whose cluster merge
    drops the last rank's partial. Timed as CUDA-graph replays beside the
    plain version, SDPA with the boolean (B, nh, T, S) mask and K3's
    shifted launch (qstart cp + 3 over the cut mask, the kernel this one
    replaced), all in this call. Then Llama-3.2-1B's 32/8 heads of dim 64
    at T=16 (two query tiles a KV head): checked and printed, not timed."""
    import torch

    from lapha_tpu_torch.bench_k6 import graph_ms
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import block_attention as ba
    from lapha_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    bad_dll, _ = merge_fault.result()
    results = {}
    # (model, heads, KV heads, head dim, T, timed)
    for fam, nh, nkv, dh, T, timed in (("Qwen2.5-1.5B", 12, 2, 128, 4, True),
                                       ("Llama-3.2-1B", 32, 8, 64, 16, False)):
        B, S, Lp, cp = 24, 768, 640, 700
        scale = dh ** -0.5
        past = cp + T + 2  # a valid column past the block
        lens = torch.randint(400, 513, (B,), generator=gen, device=dev)
        j = torch.arange(S, device=dev)[None, :]
        holes = (j >= lens[:, None]) & (j < Lp)
        kv_valid = (j < lens[:, None]) | ((j >= Lp) & (j < cp + T)) | (j == past)
        q = torch.randn((B, T, nh, dh), generator=gen, device=dev)
        k = torch.randn((B, S, nkv, dh), generator=gen, device=dev)
        v = torch.randn((B, S, nkv, dh), generator=gen, device=dev)
        k[:, cp:cp + T] *= 4.0
        k[:, past] *= 4.0
        v[:, past] *= 2.0
        v = torch.where(holes[:, :, None, None], v * 4.0, v)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()

        def kernel(vm=kv_valid):
            return ba.block_attention(q, k, v, vm, scale)

        def plain():
            return ba.block_attention_plain(q, k, v, kv_valid, scale)

        # the oracle: dense f32 softmax under the JAX forward's block_bidir mask
        qpos = cp + torch.arange(T, device=dev)[None, :, None]
        allowed = kv_valid[:, None, :] & ((j[:, None, :] <= qpos) | (j[:, None, :] >= cp))
        check(bool(torch.equal(allowed, kv_valid[:, None, :].expand(B, T, S))),
              "phase 1n: JAX's block_bidir mask is not kv_valid alone")
        logits = torch.einsum("btkgd,bskd->bkgts", q.float().reshape(B, T, nkv, nh // nkv, dh),
                              k.float()) * scale
        logits = logits.masked_fill(~allowed[:, None, None], float("-inf"))
        oracle = torch.einsum("bkgts,bskd->btkgd", torch.softmax(logits, dim=-1),
                              v.float()).reshape(B, T, nh, dh)
        plan = ba.block_plan(B, nkv, nh // nkv, T, S, _cuda.sm_count(dev), dh=dh,
                             smem=_cuda.lib().lapha_spec_verify_smem)
        label = (f"block_attention ({fam}) {nh}/{nkv} heads dh={dh} B={B} T={T} S={S} block at "
                 f"{cp}, holes up to {Lp}, column {past} valid, plan {tuple(plan)}")
        out, again, ref = kernel(), kernel(), plain()
        cut = kv_valid & (j < cp + T)
        faults = {"the holes read as valid": kernel(kv_valid | holes),
                  f"column {past} past the block not read (the mask cut below cp + T)":
                      kernel(cut)}
        if timed:
            check(plan.splits > 1, f"{label}: no split, so no merge to fault")
            bad = torch.empty_like(q)
            err = bad_dll.lapha_block_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(), T, bad.data_ptr(),
                B, nh, nkv, S, dh, scale, 0.0, *plan, _cuda.stream_of(q))
            check(err == 0, f"{label}: the merge-fault build refused the launch ({err})")
            faults["the last rank's partial dropped in the merge"] = bad
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        err_oracle = float((out.float() - oracle).abs().max())
        check(bool(torch.isfinite(out.float()).all()) and err <= KERNEL_ATOL,
              f"{label}: max|diff| {err} against the plain version")
        check(err_oracle <= KERNEL_ATOL, f"{label}: max|diff| {err_oracle} against the oracle")
        check(torch.equal(out, again), f"{label}: two launches differ")
        notes = []
        for what, bad in faults.items():
            e = float((bad.float() - oracle).abs().max())
            check(not e <= KERNEL_ATOL, f"the {label} check missed a planted fault ({what}): {e}")
            notes.append(f"planted fault ({what}) max|diff| {e:.3e}, caught")
        head = (f"kernel {label}: max|diff| {err:.3e} (dense oracle {err_oracle:.3e}), "
                f"bit-equal over two launches")
        if not timed:
            print(f"{head}; {'; '.join(notes)} [{card}]", flush=True)
            continue
        # K3's shifted launch over the cut mask (the route this kernel
        # replaced): query t at cp + 3 + t sees every valid column below cp + T
        qs = torch.full((B,), cp + T - 1, dtype=torch.int32, device=dev)
        cut_i = cut.to(torch.int32)

        def k3():
            return fa._attention_cuda(q, k, v, cut_i, qs, scale, "flash_attention_cached")

        k3_err = float((k3()[0].float() - ba.block_attention_plain(q, k, v, cut, scale).float())
                       .abs().max())
        k3_ms = graph_ms(k3)
        ms, plain_ms, lib_ms = _ab_ms(kernel, plain, _sdpa(q, k, v, allowed, scale),
                                      timer=graph_ms)
        k3_ms = (k3_ms + graph_ms(k3)) / 2
        # K and V of the valid columns of each row for each KV head, q,
        # out and the map
        n_cols = int(kv_valid.sum())
        nbytes = n_cols * nkv * dh * 2 * 2 + _nbytes(q, out, kv_valid)
        r = _row(err, ms, plain_ms, lib_ms, nbytes, 4 * dh * nh * T * n_cols)
        print(f"{head}, {ms:.4f} ms vs plain {plain_ms:.4f} ms, sdpa (boolean mask) "
              f"{lib_ms:.4f} ms, K3's shifted launch over the cut mask {k3_ms:.4f} ms (max|diff| "
              f"{k3_err:.3e} against the plain version on that mask), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {n_cols} valid columns x {nkv} KV "
              f"heads); {'; '.join(notes)} [{card}]", flush=True)
        results["block_attention"] = r
    print(f"phase 1n took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return results


def _deepseek_model(dev, card, layers=None):
    """DeepSeek-V2-Lite at full width and depth from its published config
    (its first ``layers`` layers when given), random bf16 weights from the
    seed (the JAX init's scales)."""
    import torch

    from lapha_tpu_torch.models import deepseek, quant, value_model

    hf = DEEPSEEK_V2_LITE_CONFIG
    if layers is not None:
        hf = dict(hf, num_hidden_layers=layers)
    cfg = deepseek.DeepseekConfig.from_hf(hf)
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
    """Phases 2h and 15 on DeepSeek-V2-Lite (the first CUT_LAYERS layers:
    1 dense, then MoE), made here and freed before the return; phase 15
    ends with greedy rounds with and without speculative decoding. Returns
    the launch counts of the counted rounds ("serve_deepseek") and of the
    bf16-latent spec round ("serve_deepseek_spec")."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    t_phase = time.perf_counter()
    params, head, cfg = _deepseek_model(dev, card, layers=CUT_LAYERS)
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
    # the spec path (the weight-absorbed T-token verify: torch products, no
    # attention kernel): greedy with and without speculative decoding, bf16
    # latent (counted) and int8 latent
    spec_launches = None
    for kv in (None, "int8"):
        spec = _spec_round(params, cfg, _spec_prompts(rng, cfg.vocab_size, 2, plen), 4, new,
                           dict(kw, collect_h0=False, kv_quant=kv),
                           f"phase 15, DeepSeek-V2-Lite {'bf16' if kv is None else 'int8'} latent",
                           card, router="route_deepseek")
        for name, count in spec["launches"].items():
            check(name in ran or count == 0,
                  f"{name} ran {count} times on the DeepSeek spec path")
        check(spec["launches"]["grouped_gemm"] > 0, "K8 never ran on the DeepSeek spec path")
        spec_launches = spec_launches or spec["launches"]
        del spec
    _profile_served("DeepSeek-V2-Lite", params, cfg, P * n, plen, plen + 2 * new, SEED + 23, card)
    del params, head
    torch.cuda.empty_cache()
    print(f"phases 2h and 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"serve_deepseek": launches, "serve_deepseek_spec": spec_launches}


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
    18 (Phi-3, StarCoder2): training at full width on CUT_LAYERS layers,
    the model made here from its published config (``_published_model``: for Gemma-2
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
        print(f"{label}: launches {launches} [{card}]", flush=True)
        # the counted round's times (earlier phases ran these shapes' kernels)
        tp, tk = run["t_par"], run["t_kid"]
        print(f"{label}, counted round, parents: prefill {tp['prefill_s'] * 1e3:.1f} ms ({P} x "
              f"{plen} tokens), decode {tp['decode_s'] * 1e3:.1f} ms for {tp['decode_steps']} "
              f"steps x {P * n} rows = {P * n * new / tp['decode_s']:.1f} tok/s [{card}]",
              flush=True)
        print(f"{label}, counted round, children: prefix-hit prefill {tk['prefill_s'] * 1e3:.1f} "
              f"ms ({n_kids} x {kid_extra}-token suffix at qstart {plen}), decode "
              f"{tk['decode_s'] * 1e3:.1f} ms = {n_kids * n * new / tk['decode_s']:.1f} tok/s; "
              f"root value forward ({P} x {plen}) {run['t_value'] * 1e3:.1f} ms; whole round "
              f"{run['t_all']:.2f} s [{card}]", flush=True)
        del eng, vf, run
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


class _CountedEngine:
    """The engine the CLI is given, counting the tokens it generates and
    keeping its last answer (the fused-h0 check reads it)."""

    def __init__(self, eng):
        self.eng, self.tokens, self.last = eng, 0, None

    def generate(self, prompts, sampling_params, use_tqdm=False):
        outs = self.eng.generate(prompts, sampling_params, use_tqdm=use_tqdm)
        self.tokens += sum(len(o.token_ids) for r in outs for o in r.outputs)
        self.last = outs
        return outs


class _PathLaunches:
    """Copies of the inputs and outputs of some of the path's own launches of
    the flash kernels (K1, K3), the decode kernels (K4, K5) and the flash
    backward (K2, the entries the autograd Function's backward calls), taken
    as the path makes them: the first launch of each flash shape and offset
    kind (fresh prefill, or a suffix after a prefix hit), for each decode
    entry and row count the layer-0 launch with the longest rows, and the
    first dq and the first dk/dv launch. Each launch is the path's own and
    is counted once; the copies are held against the plain versions after
    the run (:func:`_check_path_launches`)."""

    def __init__(self):
        from lapha_tpu_torch.ops import flash_attention as fa
        from lapha_tpu_torch.ops import ragged_decode_attention as rda

        self.fa, self.rda = fa, rda
        self.flash, self.decode, self.bwd = {}, {}, {}

    def __enter__(self):
        fa = self.fa
        self._fns = (fa._attention_cuda, self.rda._ragged_cuda, fa.attention_bwd_dq_cuda,
                     fa.attention_bwd_dkv_cuda)
        self._flash_fn, self._decode_fn, self._dq_fn, self._dkv_fn = self._fns
        fa._attention_cuda, self.rda._ragged_cuda = self._flash, self._decode
        fa.attention_bwd_dq_cuda, fa.attention_bwd_dkv_cuda = self._dq, self._dkv
        return self

    def __exit__(self, *exc):
        (self.fa._attention_cuda, self.rda._ragged_cuda, self.fa.attention_bwd_dq_cuda,
         self.fa.attention_bwd_dkv_cuda) = self._fns

    def _bwd(self, which, fn, args):
        import torch

        keep = which not in self.bwd
        saved = (tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args) if keep
                 else None)
        out = fn(*args)
        if keep:
            self.bwd[which] = dict(args=saved, out=tuple(
                o.clone() for o in (out if isinstance(out, tuple) else (out,))))
        return out

    def _dq(self, *args):
        return self._bwd("flash_attention_bwd_dq", self._dq_fn, args)

    def _dkv(self, *args):
        return self._bwd("flash_attention_bwd_dkv", self._dkv_fn, args)

    def _flash(self, q, k, v, kv_valid, qstart, scale, name, window=0, softcap=0.0):
        key = (name, tuple(q.shape), k.shape[1], int(qstart.max()) > 0)
        args = (None if key in self.flash
                else tuple(t.clone() for t in (q, k, v, kv_valid, qstart)))
        out, lse = self._flash_fn(q, k, v, kv_valid, qstart, scale, name, window, softcap)
        if args is not None:
            self.flash[key] = dict(args=args, kw=(scale, window, softcap), out=out.clone(),
                                   lse=lse.clone())
        return out, lse

    def _decode(self, q, k_cache, v_cache, layer, lens, dstart, slot, pstart, scale,
                cache_scale, sinks, softcap=0.0):
        key = (cache_scale is not None, q.shape[0])
        keep = int(layer) == 0 and int(slot) > self.decode.get(key, {}).get("slot", -1)
        if keep:  # layer 0 of the cache: (1, B, nkv, S, dh)
            rec = dict(slot=int(slot), q=q.clone(), k=k_cache[:1].clone(), v=v_cache[:1].clone(),
                       lens=lens.clone(), dstart=dstart.clone(),
                       pstart=None if pstart is None else pstart.clone(), scale=scale,
                       cache_scale=(None if cache_scale is None
                                    else tuple(c[:1].clone() for c in cache_scale)))
        out = self._decode_fn(q, k_cache, v_cache, layer, lens, dstart, slot, pstart, scale,
                              cache_scale, sinks, softcap)
        if keep:
            check(sinks is None and not softcap, "the path's decode has no sinks or cap")
            self.decode[key] = dict(rec, out=out.clone())
        return out


def _check_path_launches(rec, path: str, card) -> int:
    """Phase 19's and 20's kernel checks: each launch :class:`_PathLaunches`
    kept from the path's run, its output against the plain version on the
    same inputs (K1/K3: phase 1's limit and LSE limit; K4: KERNEL_ATOL; K5:
    Q8_ATOL + 2^-7 |plain|; K2: phase 1b's limits for dq, dk and dv, with
    the launch brought to unit scale, and a relaunch at that scale). Each
    decode launch's plan must split its rows (the merge runs),
    and the first split's share of each row (ceil(n / splits) slots) missing
    from the merge (a planted fault, through the kernel's pstart) must fail
    the check; so must a K2 relaunch with one head of dq zeroed, or with dk
    and dv swapped. Returns the most splits a kept decode launch had."""
    import torch

    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import flash_attention as fa
    from lapha_tpu_torch.ops import ragged_decode_attention as rda

    check(rec.flash and rec.decode, f"{path}: no flash or decode launch kept")
    most = 0
    for (name, qshape, S, suffix), r in sorted(rec.flash.items()):
        q, k, v, kv_valid, qs = r["args"]
        scale, window, softcap = r["kw"]
        ref, ref_lse = fa.attention_plain(q, k, v, kv_valid, qs, scale, window, None, softcap)
        err = float((r["out"].float() - ref.float()).abs().max())
        seen = ref_lse > -1e29
        lse_err = float((r["lse"][seen] - ref_lse[seen]).abs().max())
        label = (f"{path} {name} B={qshape[0]} T={qshape[1]} S={S} qstart "
                 f"{int(qs.min())}..{int(qs.max())}")
        check(bool(torch.isfinite(r["out"].float()).all()) and err <= KERNEL_ATOL,
              f"{label}: max|diff| {err}")
        check(lse_err <= 1e-3, f"{label}: LSE max|diff| {lse_err}")
        print(f"path launch {label}{' (suffix after a prefix hit)' if suffix else ''}: "
              f"max|diff| {err:.3e}, LSE {lse_err:.3e} [{card}]", flush=True)
    for (int8, B), r in sorted(rec.decode.items()):
        q, kc, vc, lens, dstart, pstart = (r[x] for x in ("q", "k", "v", "lens", "dstart",
                                                          "pstart"))
        slot, scl = r["slot"], r["cache_scale"]
        name = "ragged_decode_attention" + ("_q8" if int8 else "")
        nkv, S, dh = kc.shape[2], kc.shape[3], kc.shape[4]
        splits = rda.split_plan(B, nkv, q.shape[1] // nkv, slot + 1, _cuda.sm_count(q.device),
                                dh=dh, int8=int8).splits

        def plain(p0=pstart):
            return rda.ragged_decode_plain(q, kc, vc, 0, lens, dstart, slot, p0, r["scale"],
                                           cache_scale=scl)

        def over(out, ref):
            if int8:
                return _q8_excess(out, ref)
            return float((out.float() - ref.float()).abs().max()) - KERNEL_ATOL

        ref = plain()
        label = f"{path} {name} B={B} S={S} slot={slot} ({splits} splits)"
        check(splits >= 2, f"{label}: the plan does not split the rows")
        most = max(most, splits)
        check(bool(torch.isfinite(r["out"].float()).all()) and over(r["out"], ref) <= 0,
              f"{label}: max|diff| {float((r['out'].float() - ref.float()).abs().max())}")
        # a merge that loses the first split: its share of each row's slots
        # (the valid list, prompt first) is missing from the result
        p0 = torch.zeros_like(lens) if pstart is None else pstart
        n = _decode_valid(lens, dstart, slot, S, pstart).sum(1).to(torch.int32)
        lost = torch.minimum(p0 + (n + splits - 1) // splits, lens).to(torch.int32)
        bad = rda.ragged_decode_attention(q, kc, vc, 0, lens, dstart, slot, lost, r["scale"],
                                          cache_scale=scl)
        torch.cuda.synchronize()
        check(over(bad, ref) > 0, f"the {label} check missed a planted fault (the first "
                                  "split's share lost in the merge)")
        print(f"path launch {label}, rows {[int(x) for x in n]} slots: max|diff| "
              f"{float((r['out'].float() - ref.float()).abs().max()):.3e}; planted fault (the "
              f"first split's share lost in the merge) max|diff| "
              f"{float((bad.float() - ref.float()).abs().max()):.3e}, caught [{card}]",
              flush=True)
    _check_path_bwd(rec, path, card)
    return most


def _check_path_bwd(rec, path: str, card) -> None:
    """The K2 part of :func:`_check_path_launches`: each kept dq and dk/dv
    launch at unit scale, and the planted faults."""
    import torch

    from lapha_tpu_torch.ops import flash_attention as fa

    for name, r in sorted(rec.bwd.items()):
        dq = name.endswith("_dq")
        plain = fa.attention_bwd_dq_plain if dq else fa.attention_bwd_dkv_plain
        kernel = rec._dq_fn if dq else rec._dkv_fn
        args = r["args"]
        q = args[0]
        label = (f"{path} {name} B={q.shape[0]} T={q.shape[1]} S={args[1].shape[1]} "
                 f"{q.shape[2]}/{args[1].shape[2]} heads")
        ref = _tuple(plain(*args))
        top = max(float(t.float().abs().max()) for t in ref)
        check(math.isfinite(top) and top > 0, f"{label}: max|plain| {top}")
        # dq, dk and dv are linear in dO and delta, so a power of two brings
        # the launch to unit scale exactly; there phase 1b's limits bite (at
        # the path's own scale BWD_ATOL alone would pass a kernel that wrote
        # zeros). The path's launch is held at that scale, and the kernel is
        # launched again on dO and delta times c
        c = 2.0 ** round(-math.log2(top))
        own, own_errs = _bwd_close([o.float() * c for o in r["out"]],
                                   [t.float() * c for t in ref])
        scaled = (*args[:6], args[6] * c, args[7] * c, *args[8:])
        again = _tuple(kernel(*scaled))
        unit = _tuple(plain(*scaled))
        torch.cuda.synchronize()
        worst, errs = _bwd_close(again, unit)
        check(own <= 1.0 and worst <= 1.0,
              f"{label}: max|diff| {own_errs} (x{c:.3e}) and {errs} at unit scale, past phase "
              f"1b's limits")
        # planted faults: one query head's dq dropped; dk and dv swapped
        if dq:
            bad = again[0].clone()
            bad[:, :, 0] = 0
            fault, planted = "head 0 of dq zeroed", (bad,)
        else:
            fault, planted = "dk and dv swapped", (again[1], again[0])
        missed, bad_errs = _bwd_close(planted, unit)
        check(missed > 1.0, f"the {label} check missed a planted fault ({fault})")
        print(f"path launch {label}: max|plain| {top:.3e}, held at x{c:.3e}: max|diff| "
              f"{[f'{e:.3e}' for e in own_errs]}, {own:.3f} of phase 1b's limit; launched again "
              f"at that scale (max|plain| {max(float(t.float().abs().max()) for t in unit):.3f}):"
              f" max|diff| {[f'{e:.3e}' for e in errs]}, {worst:.3f} of the limit; planted fault "
              f"({fault}) {missed:.1f} of the limit, caught [{card}]", flush=True)


# eval.sh's sampling defaults; 2 MATH-500 questions, 64 new tokens a step
EVAL_QUESTIONS = 2
EVAL_ARGS = ["--dataset-name", "math", "--tokenizer-path", "unused", "--engine", "tpu",
             "--limit", str(EVAL_QUESTIONS), "--temperature", "0.3", "--top-p", "0.8",
             "--top-k", "20", "--repetition-penalty", "1.05", "--max-new-tokens", "64",
             "--max-model-len", "2048"]
EVAL_VALUE = ["--mode", "value", "--depth", "2", "--breadth", "6", "--mcts-num-sim", "4",
              "--k", "4"]
EVAL_RUNS = (("eval_value", EVAL_VALUE),
             ("eval_value_q8", EVAL_VALUE + ["--kv-quant", "int8"]),
             ("eval_react", ["--mode", "react", "--depth", "2"]),
             ("eval_single", ["--mode", "single"]))


def eval_entry(params, head, cfg, card) -> dict:
    """Phase 19: the evaluation entry, ``rollout_jsonl.main``, on the phase-3
    model in value, value with int8 KV, react and single modes, each scored
    by ``eval_math.main``; the path's own kernel launches checked against the
    plain versions, and in value mode the fused pooled h0. Returns each
    run's launch counts."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import Engine
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "math-500.jsonl")
    with open(data, encoding="utf-8") as f:
        gold_rows = [next(f) for _ in range(EVAL_QUESTIONS)]
    launches, splits = {}, 0
    with tempfile.TemporaryDirectory() as eval_dir:
        # eval_math reads LAPHA_EVAL_DIR when it is imported; the gold file
        # holds the questions the CLI answers (eval_math scores every gold row)
        gold = os.path.join(eval_dir, "gold.jsonl")
        with open(gold, "w", encoding="utf-8") as f:
            f.writelines(gold_rows)
        os.environ.update(LAPHA_EVAL_DIR=eval_dir, DATA_DIR_MATH=gold)
        import importlib

        from lapha_tpu_torch.evalsuite import eval_math, rollout_jsonl

        # the training package's graders come through the evalsuite package,
        # which may have imported eval_math (and read the variable) already
        importlib.reload(eval_math)
        check(str(eval_math.EVAL_DIR) == eval_dir, f"eval_math.EVAL_DIR {eval_math.EVAL_DIR}")
        tok = ChatIdTok(cfg.vocab_size)
        pred = os.path.join(eval_dir, "rollouts", "math.pred.jsonl")
        for path, mode_args in EVAL_RUNS:
            value = "value" in path
            # the engine and value function the CLI builds from a checkpoint
            # (rollout_jsonl.main's engine_kw and build_value_fn), on the
            # phase-3 weights
            eng = _CountedEngine(Engine(params, cfg, tok, max_model_len=2048, max_batch=16,
                                        collect_h0=value,
                                        kv_quant="int8" if path.endswith("q8") else None))
            vf = ValueFunction(params, head, cfg, max_model_len=2048) if value else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            with _PathLaunches() as rec:
                n = rollout_jsonl.main(["--data", data, "--out", pred, *EVAL_ARGS, *mode_args],
                                       engine_override=eng, value_fn_override=vf,
                                       tokenizer_override=tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[path] = dict(_cuda.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
            splits = max(splits, _check_path_launches(rec, path, card))
            if value:
                check(any(key[0] == "flash_attention_cached" and key[3] for key in rec.flash),
                      f"{path}: no prefix-hit suffix prefill")
                # fused value: the engine's pooled h0 of the last expansion's
                # first sample == a value forward over its prompt + completion
                ro = eng.last[0]
                full = np.asarray(ro.prompt_token_ids + ro.outputs[0].token_ids)[None]
                _, _, h_ref = vf(full, np.ones_like(full, dtype=np.int32), return_h0=True)
                e_fused = float(np.linalg.norm(ro.outputs[0].pooled_hidden - h_ref[0])
                                / np.linalg.norm(h_ref[0]))
                limit = FUSED_Q8_RTOL if path.endswith("q8") else REF_RTOL
                print(f"{path} fused value check: engine pooled h0 vs value forward over "
                      f"{full.shape[1]} tokens rel err {e_fused:.3e} (limit {limit}) [{card}]",
                      flush=True)
                check(e_fused <= limit, f"{path}: fused value rel err {e_fused}")
            del rec
            # the JSONL contract of tests/test_cli_e2e.py
            with open(pred, encoding="utf-8") as f:
                rows = [json.loads(line) for line in f]
            check(n == EVAL_QUESTIONS and len(rows) == EVAL_QUESTIONS, f"{path}: {n} rows")
            for row in rows:
                check(set(row) == {"dataset", "qid", "question", "completion", "final_answer",
                                   "completions", "final_answers", "k"}, f"{path} row keys")
                check(isinstance(row["completion"], str) and row["dataset"] == "math",
                      f"{path}: completion is a string")
                check(row["completions"][0] == row["completion"]
                      and row["final_answers"][0] == row["final_answer"]
                      and len(row["completions"]) == len(row["final_answers"]) == row["k"],
                      f"{path}: first completion and final answer are the pass@1 fields")
                check(1 <= row["k"] <= 4 if value else row["k"] == 1, f"{path}: k {row['k']}")
            eval_math.main(["--dataset", "math", "--k", "4"])
            with open(os.path.join(eval_dir, "results", "math.summary.json"),
                      encoding="utf-8") as f:
                summary = json.load(f)
            check(summary["num"] == EVAL_QUESTIONS, f"{path}: summary num {summary['num']}")
            used = launches[path]
            names = (("flash_attention", "flash_attention_cached") if value
                     else ("flash_attention_cached",))
            names += ("ragged_decode_attention_q8" if path.endswith("q8")
                      else "ragged_decode_attention",)
            for name in names:
                check(used[name] > 0, f"{name} never launched on {path}")
            if path.endswith("q8"):
                check(used["ragged_decode_attention"] == 0,
                      f"the bf16 decode kernel ran on {path}")
            print(f"{path}: {wall / n:.2f} s a question ({wall:.2f} s for {n}), "
                  f"{eng.tokens} tokens generated ({eng.tokens / wall:.1f} tok/s), peak "
                  f"{peak:.2f} GiB; pass@1 {summary['pass@1']}, answered "
                  f"{summary['answered']}; k {[r['k'] for r in rows]}; launches "
                  f"{ {k: v for k, v in used.items() if v} } [{card}]", flush=True)
            del eng, vf
            torch.cuda.empty_cache()
    # phase 1 checks the dh-128 decode at 2 splits; this path runs more
    check(splits >= 4, f"phase 19's decode launches split their rows {splits} ways at most")
    return launches


# Qwen/Qwen2.5-1.5B-Instruct's published config.json (the phase-3 model's
# widths); phase 20 writes it with phase 3's max_position_embeddings
QWEN25_1_5B_INSTRUCT_CONFIG = {
    "architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0, "bos_token_id": 151643,
    "eos_token_id": 151645, "hidden_act": "silu", "hidden_size": 1536, "initializer_range": 0.02,
    "intermediate_size": 8960, "max_position_embeddings": 32768, "max_window_layers": 21,
    "model_type": "qwen2", "num_attention_heads": 12, "num_hidden_layers": 28,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "sliding_window": 32768, "tie_word_embeddings": True, "torch_dtype": "bfloat16",
    "transformers_version": "4.43.1", "use_cache": True, "use_sliding_window": False,
    "vocab_size": 151936,
}
# phase 6's knobs as the entry's typed overrides, a learning rate that moves
# bf16 weights, two steps of two questions
TRAIN_ENTRY_FLAGS = ["--max-steps", "2", "--device", "cuda", "--depth", "2", "--breadth", "4",
                     "--num-sim", "4", "--leaves-per-sim", "2", "--max-completion-length", "32",
                     "--max-model-len", "1024", "--max-prompt-length", "1024",
                     "--per-device-train-batch-size", "2", "--save-steps", "0",
                     "--learning-rate", "1e-3", "--warmup-ratio", "0", "--debug-print", "false"]
TRAIN_ENTRY_QUESTIONS = 4
# the start export (f32), the step-2 checkpoint (bf16 params, f32 Adam
# moments) and save_model's export (f32): ~28 GB at 1.54 B params
TRAIN_ENTRY_BYTES = 32e9
# the scalar names of the reference's trainer (metrics.jsonl)
TRAIN_SCALARS = {"avgAcc", "pass@1", "VMap/mean", "VMap/std", "Loss/ValueLoss",
                 "Loss/PolicyLoss", "Loss/Loss", "Metrics/KL", "Metrics/ContextLength"}


class _Stopwatch:
    """Wall seconds (the device synchronised at both ends), return values and
    kernel launches of the named methods of ``cls``, for every call made
    while active."""

    def __init__(self, cls, names):
        self.cls, self.names = cls, names
        self.seconds = {n: [] for n in names}
        self.returned = {n: [] for n in names}
        self.launches = {n: [] for n in names}

    def __enter__(self):
        import torch

        from lapha_tpu_torch.ops import _cuda

        self._orig = {n: getattr(self.cls, n) for n in self.names}
        for n, fn in self._orig.items():
            def timed(*a, _n=n, _fn=fn, **kw):
                torch.cuda.synchronize()
                before = dict(_cuda.LAUNCHES)
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                self.seconds[_n].append(time.perf_counter() - t0)
                self.returned[_n].append(out)
                self.launches[_n].append({k: v - before[k] for k, v in _cuda.LAUNCHES.items()})
                return out
            setattr(self.cls, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self._orig.items():
            setattr(self.cls, n, fn)


def _bytes_under(d: str) -> int:
    return sum(os.path.getsize(os.path.join(base, f)) for base, _, files in os.walk(d)
               for f in files)


def train_entry(params, cfg, card) -> dict:
    """Phase 20: the training entry, ``lapha_tpu_torch.run_dapo.main``, from a
    checkpoint on disk to ``save_model``'s export, at the phase-3 model's
    full width and depth; its first train_step is phase 6. Returns the
    entry's launch counts ("train_entry") and its first step's
    ("train_step")."""
    import shutil

    import torch

    from lapha_tpu_torch import run_dapo
    from lapha_tpu_torch.models import loader, qwen2
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.train import MTPOTrainer, losses
    from lapha_tpu_torch.train.dataset import (_PROMPT_SHIM_OLD_HEAD, _PROMPT_SHIM_OLD_TAIL,
                                               dataloader)

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="train_entry_") as work:
        free = shutil.disk_usage(work).free
        check(free >= TRAIN_ENTRY_BYTES,
              f"phase 20 writes ~28 GB and needs {TRAIN_ENTRY_BYTES / 1e9:.0f} GB free: "
              f"{work} has {free / 1e9:.1f} GB")
        start, out = os.path.join(work, "start"), os.path.join(work, "out")
        # ---- the start checkpoint: the phase-3 weights in HF layout
        t0 = time.perf_counter()
        loader.export_hf(params, cfg, start)
        hf_config = dict(QWEN25_1_5B_INSTRUCT_CONFIG,
                         max_position_embeddings=cfg.max_position_embeddings,
                         num_hidden_layers=cfg.num_hidden_layers)
        with open(os.path.join(start, "config.json"), "w") as f:
            json.dump(hf_config, f, indent=2)
        t_export = time.perf_counter() - t0
        check(qwen2.Qwen2Config.from_hf(hf_config) == cfg,
              "Qwen2.5-1.5B-Instruct's config does not parse to the phase-3 config")
        t0 = time.perf_counter()
        back, back_cfg = loader.load_params(start, device="cuda")
        torch.cuda.synchronize()
        t_start_load = time.perf_counter() - t0
        want = dict(losses.tree_paths(params))
        got = dict(losses.tree_paths(back))
        check(back_cfg == cfg and got.keys() == want.keys()
              and all(torch.equal(got[k], w) for k, w in want.items()),
              "the start checkpoint does not load back bit-equal")
        del back, got
        start_bytes = _bytes_under(start)

        # ---- the dataset: a DAPO-format parquet of MATH-500 rows, read
        # through the entry's --dataset branch (its parser and load_records);
        # each record then gets a CoT anchor (the trainer's d_goal anchor,
        # which DAPO's rows do not carry): random weights answer nothing, and
        # without it no tree has a value signal to train on
        import pandas as pd

        with open(os.path.join(here, "data", "math-500.jsonl"), encoding="utf-8") as f:
            gold = [json.loads(next(f)) for _ in range(TRAIN_ENTRY_QUESTIONS)]
        parquet = os.path.join(work, "dapo.parquet")
        pd.DataFrame({
            "prompt": [[{"content": _PROMPT_SHIM_OLD_HEAD + g["question"] + _PROMPT_SHIM_OLD_TAIL,
                         "role": "user"}] for g in gold],
            "reward_model": [{"ground_truth": g["answer"], "style": "rule"} for g in gold],
        }).to_parquet(parquet)
        argv = ["--config", os.path.join(here, "configs", "lapha.yaml"),
                "--model-name-or-path", start, "--output-dir", out, *TRAIN_ENTRY_FLAGS]
        rows = run_dapo.load_records(
            run_dapo.build_parser().parse_known_args(argv + ["--dataset", parquet])[0])
        check(rows == dataloader(parquet)
              and [r["ground_truth"] for r in rows] == [g["answer"] for g in gold]
              and all(r["question"].endswith("`<answer>...</answer>`.") for r in rows),
              "the DAPO rows did not come back through --dataset and the prompt shim")
        records = [dict(r, cot=f"<think>{g['answer']}</think><answer>{g['answer']}</answer>")
                   for r, g in zip(rows, gold)]

        # ---- the entry, counted
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        with _PathLaunches() as rec, _Stopwatch(MTPOTrainer, ("__init__", "train_step",
                                                              "save_checkpoint",
                                                              "save_model")) as sw:
            trainer = run_dapo.main(argv, tokenizer_override=ChatIdTok(cfg.vocab_size),
                                    dataset_override=records)
        torch.cuda.synchronize()
        t_entry = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30

        # ---- checks
        args = trainer.args
        check(trainer.global_step == 2, f"the entry ended at step {trainer.global_step}")
        check((args.breadth, args.learning_rate, args.debug_print, args.attn_implementation,
               args.beta, args.gradient_checkpointing, args.bf16)
              == (4, 1e-3, False, "pallas", 1e-8, True, True),
              "the typed overrides and lapha.yaml's knobs did not reach the trainer")
        with open(os.path.join(out, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        names = {m["name"] for m in metrics}
        check({m["step"] for m in metrics} == {0, 1}, "metrics.jsonl does not hold two steps")
        check(all(n in TRAIN_SCALARS or n.startswith("Rollout/rej_") for n in names)
              and {"avgAcc", "pass@1", "Loss/Loss"} <= names,
              f"metrics.jsonl names {sorted(names)}")
        ckpt = os.path.join(out, "checkpoints")
        with open(os.path.join(ckpt, "latest")) as f:
            check(f.read().strip() == "2" and os.path.isfile(os.path.join(ckpt, "step_2",
                                                                          "state.pt")),
                  "checkpoints/step_2 and its latest pointer")
        for name in ("model.safetensors", "value_head.npz", "value_head.pt"):
            check(os.path.isfile(os.path.join(out, name)), f"save_model wrote no {name}")
        with open(os.path.join(out, "config.json"), "rb") as f, \
                open(os.path.join(start, "config.json"), "rb") as g:
            check(f.read() == g.read(), "save_model's config.json is not the start's")
        t0 = time.perf_counter()
        final, final_cfg = loader.load_params(out, device="cuda")
        heads = [loader.load_value_head(os.path.join(out, n), cfg.hidden_size, device="cuda")
                 for n in ("value_head.npz", "value_head.pt")]
        torch.cuda.synchronize()
        t_reload = time.perf_counter() - t0
        trained = dict(losses.tree_paths(trainer.params))
        got = dict(losses.tree_paths(final))
        check(final_cfg == cfg and got.keys() == trained.keys()
              and all(torch.equal(got[k], w.detach()) for k, w in trained.items()),
              "save_model's export does not load back bit-equal to the trainer's params")
        check(all(torch.equal(h[k], trainer.head[k].detach()) for h in heads for k in ("w", "b")),
              "the value-head files do not load back equal to the trainer's head")
        moved = [k for k, w in trained.items() if not torch.equal(w.detach(), want[k])]
        check(moved, "no leaf moved from the start weights")
        check(all(bool(torch.isfinite(w).all()) for w in trained.values()),
              "a trained leaf is not finite")
        for name in ("flash_attention", "flash_attention_cached", "ragged_decode_attention",
                     "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
            check(launches[name] > 0, f"{name} never launched on train_entry")
        check(set(rec.bwd) == {"flash_attention_bwd_dq", "flash_attention_bwd_dkv"},
              f"the path's K2 launches kept: {sorted(rec.bwd)}")
        _check_path_launches(rec, "train_entry", card)
        pngs = sorted(os.path.relpath(os.path.join(b, f), out)
                      for b, _, files in os.walk(os.path.join(out, "viz")) for f in files
                      if f.endswith("_disk.png"))
        why = ""
        if not pngs:
            import importlib.util

            why = (" (matplotlib absent: plot_tree_disk returns None)"
                   if importlib.util.find_spec("matplotlib") is None
                   else " (plot_tree_disk returned None with matplotlib present)")
        written = start_bytes + _bytes_under(out)
        steps = sw.returned["train_step"]
        # phase 6: the entry's first train_step, counted apart
        first = steps[0]
        if first["n_samples"]:
            check(all(math.isfinite(first[k]) for k in ("loss", "grad_norm")),
                  f"phase 6 metrics {first}")
        shown = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in first.items()}
        print(f"train_step (the entry's first step; {cfg.num_hidden_layers} layers, depth 2, "
              f"breadth 4, num_sim 4, 32 new tokens): n_samples {first['n_samples']}, "
              f"num_groups {first['num_groups']}, skipped {first.get('skipped')}, rollout "
              f"{first['rollout_s']:.2f} s, update {first.get('update_s', 0.0):.2f} s [{card}]; "
              f"metrics {shown}", flush=True)
        print(f"train_entry: start export {t_export:.2f} s ({start_bytes / 1e9:.2f} GB f32), "
              f"its reload {t_start_load:.2f} s; run_dapo.main {t_entry:.2f} s: the trainer's "
              f"load {sw.seconds['__init__'][0]:.2f} s, steps "
              f"{[(round(m['rollout_s'], 2), round(m.get('update_s', 0.0), 2)) for m in steps]} "
              f"(rollout s, update s), n_samples {[m['n_samples'] for m in steps]}, checkpoint "
              f"save {sum(sw.seconds['save_checkpoint']):.2f} s, save_model "
              f"{sw.seconds['save_model'][0]:.2f} s; reload of the export and heads "
              f"{t_reload:.2f} s; {written / 1e9:.2f} GB written; peak {peak:.2f} GiB; "
              f"{len(moved)} of {len(trained)} leaves moved [{card}]", flush=True)
        print(f"train_entry: {len(pngs)} tree PNGs written{why}; launches "
              f"{ {k: v for k, v in launches.items() if v} } [{card}]", flush=True)
        del trainer, final, got, trained, heads, rec
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"train_entry": launches, "train_step": sw.launches["train_step"][0]}


# phase 21: a returned logprob against a teacher-forced forward of the same
# weights (prompt + completion through K1, the logits through
# sampling.process_logits with the request's parameters; also the top-2
# margin past which a greedy token must be the argmax). Decode (a token a
# step through K4/K5 over the cache) and the forward round differently in
# bf16: ~2.5x the 5.9e-2 read on an H100 with a bf16 cache, ~2.8x the
# 8.9e-2 read with an int8 cache (each vector rounded to amax/254)
SERVE_LP_ATOL = 0.15
SERVE_LP_Q8_ATOL = 0.25
# a sampled token that the reference's top-p nucleus leaves out is a
# nucleus-edge case when the reference's mass before it is within this of
# top_p (the two sides' logits order the tail differently)
SERVE_EDGE_MASS = 0.02
# the server CLI as phase 21 runs it: one card, 16 rows, 2048 columns
SERVE_ARGS = ["--host", "127.0.0.1", "--port", "0", "--device", "cuda", "--max-batch", "16"]
SERVE_BURST = 12


class _ServedLaunches(_PathLaunches):
    """:class:`_PathLaunches` for a scheduler's path. While ``sched`` is
    None every launch passes through untouched (a timed burst runs so).
    Otherwise the decode launch kept for each entry and row count is the
    first layer-0 launch whose live rows (the rows ``sched``'s requests
    hold) start their decode ranges at more distinct columns than the
    launch kept before it, read from the scheduler's host state (no device
    read); its live rows are kept with it."""

    sched = None

    def _flash(self, q, k, v, kv_valid, qstart, scale, name, window=0, softcap=0.0):
        if self.sched is None:
            return self._flash_fn(q, k, v, kv_valid, qstart, scale, name, window, softcap)
        return super()._flash(q, k, v, kv_valid, qstart, scale, name, window, softcap)

    def _decode(self, q, k_cache, v_cache, layer, lens, dstart, slot, pstart, scale,
                cache_scale, sinks, softcap=0.0):
        key = (cache_scale is not None, q.shape[0])
        keep = False
        if int(layer) == 0 and self.sched is not None:
            live = sorted(self.sched._rows)
            ds = self.sched._state["dstart"]
            rank = len({int(ds[r]) for r in live})
            keep = rank > self.decode.get(key, {}).get("rank", 0)
        if keep:  # layer 0 of the cache: (1, B, nkv, S, dh)
            rec = dict(slot=int(slot), rank=rank, live=live, q=q.clone(), k=k_cache[:1].clone(),
                       v=v_cache[:1].clone(), lens=lens.clone(), dstart=dstart.clone(),
                       pstart=None if pstart is None else pstart.clone(), scale=scale,
                       cache_scale=(None if cache_scale is None
                                    else tuple(c[:1].clone() for c in cache_scale)))
        out = self._decode_fn(q, k_cache, v_cache, layer, lens, dstart, slot, pstart, scale,
                              cache_scale, sinks, softcap)
        if keep:
            check(sinks is None and not softcap, "the path's decode has no sinks or cap")
            self.decode[key] = dict(rec, out=out.clone())
        return out


def _chat(ids) -> str:
    """Token ids as ChatIdTok's words."""
    return " ".join(f"<{int(t)}>" for t in ids)


def _served_excess(params, cfg, served, limit: float) -> dict:
    """Phase 21's check of served completions against a teacher-forced
    forward of ``params``. ``served`` holds (prompt ids, sampling dict,
    completion ids, logprobs). A sampled token's logprob must be the
    reference's within ``limit`` (a token the reference's nucleus leaves out
    must sit at its edge, SERVE_EDGE_MASS); a greedy token must be the
    reference's argmax of the penalised logits, and its logprob the
    reference's, wherever the top-2 margin exceeds ``limit``. Returns the
    largest logprob error, the count of tokens past these rules ("over"),
    of tokens checked, of greedy tokens at a near tie and of nucleus-edge
    tokens."""
    import torch

    from lapha_tpu_torch.engine import sampling
    from lapha_tpu_torch.models import qwen2

    dev = params["embed"]["weight"].device
    st = dict(err=0.0, over=0, checked=0, ties=0, edge=0)
    with torch.inference_mode():
        for prompt, sp, comp, lps in served:
            T = len(comp)
            if T == 0:
                continue
            ids = torch.tensor([list(prompt) + list(comp)], device=dev)
            _, hidden, _ = qwen2.forward(params, cfg, ids, return_hidden=True,
                                         compute_logits=False)
            logits = qwen2._lm_head(params, cfg, hidden[0, len(prompt) - 1:-1])  # (T, V)
            tok = torch.tensor(comp, device=dev)
            rows = torch.arange(T, device=dev)
            # the row's presence at each step: the prompt, then the tokens before it
            seen = torch.zeros((T, cfg.vocab_size), dtype=torch.int32, device=dev)
            seen[rows, tok] = 1
            pres = torch.zeros_like(seen)
            pres[1:] = torch.cumsum(seen, 0)[:-1]
            pres[:, torch.tensor(list(prompt), device=dev)] = 1
            pres = (pres > 0).to(torch.int8)

            def full(v):
                return torch.full((T,), float(v), device=dev)

            rp, temp = sp.get("repetition_penalty", 1.0), sp["temperature"]
            top_p = sp.get("top_p", 1.0)
            proc = sampling.process_logits(logits, presence=pres, repetition_penalty=full(rp),
                                           temperature=full(temp),
                                           top_p=full(top_p) if top_p < 1.0 else None)
            ref = torch.log_softmax(proc, -1)[rows, tok]
            got = torch.tensor(lps, device=dev)
            pen = sampling.apply_repetition_penalty(logits, pres, full(rp))
            if temp == 0.0:
                top2 = pen.topk(2, dim=-1)
                sure = (top2.values[:, 0] - top2.values[:, 1]) > limit
                err = (got - ref).abs()[sure]
                st["over"] += int((sure & (top2.indices[:, 0] != tok)).sum())
                st["ties"] += int((~sure).sum())
            else:
                inside = proc[rows, tok] > sampling.NEG_INF / 2
                err = (got - ref).abs()[inside]
                if not bool(inside.all()):
                    probs = torch.softmax(pen / temp, -1)
                    p_tok = probs[rows, tok][:, None]
                    before = torch.where(probs > p_tok, probs, 0.0).sum(-1)
                    edge = ~inside & (before < top_p + SERVE_EDGE_MASS)
                    st["edge"] += int(edge.sum())
                    st["over"] += int((~inside & ~edge).sum())
            st["over"] += int((err > limit).sum())
            st["checked"] += int(err.numel())
            if err.numel():
                st["err"] = max(st["err"], float(err.max()))
    return st


def _burst(client, rng, vocab: int, count: int, prefix=()):
    """``count`` concurrent /generate requests, one client thread each:
    prompts of 200-500 random ids (after ``prefix``'s, where given), n 1-4,
    32-128 new tokens, greedy and sampled (0.7, top_p 0.95) by turns, a
    repetition penalty of 1.05 on every third. Returns the requests as
    (prompt ids, sampling dict, response), each thread's latency in s, and
    the wall s."""
    import threading

    reqs = []
    for i in range(count):
        prompt = list(prefix[i]) if i < len(prefix) else []
        prompt += [int(t) for t in rng.integers(2, vocab, int(rng.integers(200, 501)))]
        sp = dict(n=int(rng.integers(1, 5)), max_tokens=int(rng.integers(32, 129)),
                  temperature=0.0 if i % 2 == 0 else 0.7, top_p=1.0 if i % 2 == 0 else 0.95,
                  repetition_penalty=1.05 if i % 3 == 0 else 1.0)
        reqs.append([prompt, sp, None])
    lat = [0.0] * count

    def call(i):
        t0 = time.perf_counter()
        reqs[i][2] = client.generate([_chat(reqs[i][0])], timeout=600, **reqs[i][1])
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=call, args=(i,)) for i in range(count)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(all(r[2] is not None for r in reqs), "a burst request did not come back")
    return reqs, lat, wall


def _served_samples(reqs) -> list:
    """(prompt ids, sampling dict, completion ids, logprobs) of every sample
    of the answers, after the schema's checks: n samples, at most
    max_tokens each (fewer only at EOS, token 1), finish reasons, finite
    logprobs <= 0."""
    out = []
    for prompt, sp, resp in reqs:
        ids, lps = resp["completion_ids"][0], resp["logprobs"][0]
        check(len(ids) == len(lps) == sp["n"], f"{len(ids)} samples, expected {sp['n']}")
        for comp, lp, why in zip(ids, lps, resp["finish_reasons"][0]):
            stop = bool(comp) and comp[-1] == 1
            check(len(comp) == len(lp) and (len(comp) == sp["max_tokens"] or stop)
                  and why == ("stop" if stop else "length"),
                  f"{len(comp)} tokens ({why}) for max_tokens {sp['max_tokens']}")
            check(all(math.isfinite(x) and x <= 0.0 for x in lp), "logprobs finite and <= 0")
            out.append((prompt, sp, comp, lp))
    return out


def _report_excess(label, st, limit, card) -> None:
    print(f"{label}: teacher-forced check of {st['checked']} tokens: max |logprob diff| "
          f"{st['err']:.3e} (limit {limit}), {st['ties']} greedy tokens at a near tie "
          f"(top-2 margin <= the limit), {st['edge']} sampled at the nucleus edge, "
          f"{st['over']} past the limit [{card}]", flush=True)
    check(st["over"] == 0, f"{label}: {st['over']} tokens past the teacher-forced check")


def _serve_http(args, vocab: int):
    """The server as ``main`` starts it (``--device cuda``, ChatIdTok), on port
    0 in a background thread; returns (httpd, client)."""
    from lapha_tpu_torch.engine import EngineClient
    from lapha_tpu_torch.engine import server as engine_server

    httpd = engine_server.main(args, tokenizer_override=ChatIdTok(vocab), background=True)
    client = EngineClient(f"http://127.0.0.1:{httpd.server_address[1]}")
    check(client.check_server(total_timeout=30, retry_interval=0.2), "server not healthy")
    return httpd, client


def _wait_steps(sched, steps: int, timeout: float = 120.0) -> None:
    t0 = time.perf_counter()
    while sched.steps_executed < steps and time.perf_counter() - t0 < timeout:
        time.sleep(0.002)
    check(sched.steps_executed >= steps, f"the scheduler ran {sched.steps_executed} steps")


def _check_live_dstarts(rec, int8: bool, path: str, card) -> None:
    """At least one kept decode launch of the path held live rows whose
    decode ranges start at two or more columns."""
    kept = [r for (q8, _), r in rec.decode.items() if q8 == int8]
    best = max(kept, key=lambda r: r["rank"], default=None)
    starts = [] if best is None else sorted({int(best["dstart"][r]) for r in best["live"]})
    check(len(starts) >= 2,
          f"{path}: no checked decode launch held live rows of two or more dstart values")
    print(f"{path}: the checked decode launch at slot {best['slot']} held {len(best['live'])} "
          f"live rows whose decode ranges start at columns {starts} [{card}]", flush=True)


def _late_pair(client, sched, first, second, after: int):
    """``first`` (prompt ids, sampling dict) from one client thread; once the
    scheduler has run ``after`` more steps, ``second`` from another. Returns
    both as (prompt ids, sampling dict, response), and whether the second
    finished while the first still decoded."""
    import threading

    done = {}

    def call(i, req):
        done[i] = (client.generate([_chat(req[0])], timeout=600, **req[1]),
                   time.perf_counter())

    before = sched.steps_executed
    ta = threading.Thread(target=call, args=(0, first))
    ta.start()
    _wait_steps(sched, before + after)
    tb = threading.Thread(target=call, args=(1, second))
    tb.start()
    tb.join(600)
    first_running = ta.is_alive()
    ta.join(600)
    check(0 in done and 1 in done, "a request did not come back")
    return ([(first[0], first[1], done[0][0]), (second[0], second[1], done[1][0])],
            first_running and done[1][1] < done[0][1])


def serve_entry(cfg, card) -> dict:
    """Phase 21: the serving entry, ``lapha_tpu_torch.engine.server.main``, on
    phase 3's weights as drawn, made again from SEED and exported in HF
    layout (28 layers at Qwen2.5-1.5B's full width). Returns the launch
    counts of the bf16-KV servers and auto_continuous engine ("serve_http")
    and of the int8-KV server ("serve_http_q8"). The teacher-forced
    references run after each counted window."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import ContinuousEngine, Engine, SamplingParams
    from lapha_tpu_torch.models import loader, qwen2
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.train import losses

    t_phase = time.perf_counter()
    V = cfg.vocab_size
    rng = np.random.default_rng(SEED + 21)
    launches = {}
    # phase 3's weights as drawn: phase 7's steps at lr 1e-3 leave a model
    # whose greedy stream is one token for every prompt, which leaves the
    # greedy check nothing but near ties and no EOS set can skew
    fresh = qwen2.init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))

    # auto_continuous's 2 x max_batch prompts, whose greedy streams stop at
    # skewed lengths: an EOS set picked from a probe of the sync engine, run
    # before the counted window
    prompts = [[int(t) for t in rng.integers(2, V, int(rng.integers(100, 301)))]
               for _ in range(32)]
    sp0 = SamplingParams(n=1, temperature=0.0, max_tokens=48)
    probe_eng = Engine(fresh, cfg, ChatIdTok(V), max_model_len=2048, max_batch=16,
                       eos_token_ids=[])
    streams = [r.outputs[0].token_ids
               for r in probe_eng.generate([_chat(p) for p in prompts], sp0)]
    del probe_eng

    def lengths_for(eos):
        return [next((i + 1 for i, t in enumerate(s) if t in eos), len(s)) for s in streams]

    eos: set = set()
    for s in streams:
        if sum(n < 48 for n in lengths_for(eos)) >= 24:
            break
        eos.add(s[5])
    by_len = sorted(range(32), key=lambda i: -lengths_for(eos)[i])
    # one long row in each wave of 16
    prompts = [prompts[i] for i in [by_len[0]] + by_len[2:17] + [by_len[1]] + by_len[17:]]

    with tempfile.TemporaryDirectory(prefix="serve_entry_") as model:
        t0 = time.perf_counter()
        loader.export_hf(fresh, cfg, model)
        with open(os.path.join(model, "config.json"), "w") as f:
            json.dump(dict(QWEN25_1_5B_INSTRUCT_CONFIG,
                           max_position_embeddings=cfg.max_position_embeddings,
                           num_hidden_layers=cfg.num_hidden_layers), f, indent=2)
        t_export = time.perf_counter() - t0
        args = SERVE_ARGS + ["--model", model, "--max-model-len", "2048"]
        want = dict(losses.tree_paths(fresh))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # ---- bf16 KV, counted: the burst (timed, the recorder off), a late
        # request beside a long one, streaming, the routes and a reload; a
        # compaction; auto_continuous
        _cuda.reset_launches()
        with _ServedLaunches() as rec:
            t0 = time.perf_counter()
            httpd, client = _serve_http(args, V)
            t_start = time.perf_counter() - t0
            srv = httpd.engine_server
            sched, eng = srv.scheduler, srv.engine
            check(sched is not None and eng.device.type == "cuda" and eng.kv_quant is None,
                  "the server does not run the scheduler on the card")
            got = dict(losses.tree_paths(eng.params))
            check(got.keys() == want.keys() and all(torch.equal(got[k], w)
                                                    for k, w in want.items()),
                  "the served weights are not the drawn ones")
            del got
            reqs, lat, wall = _burst(client, rng, V, SERVE_BURST)
            burst = (len(reqs), lat, wall, sched.steps_executed, sched.waves, sched.compactions)
            rec.sched = sched
            # a short request admitted while a long one decodes, both prefix
            # hits on the burst's prompts
            hits = eng.prefix_cache.hits
            late = [(reqs[0][0] + [int(t) for t in rng.integers(2, V, 64)],
                     dict(n=1, temperature=0.0, max_tokens=128)),
                    (reqs[1][0] + [int(t) for t in rng.integers(2, V, 40)],
                     dict(n=1, temperature=0.7, top_p=0.95, max_tokens=16))]
            pair, overlapped = _late_pair(client, sched, *late, after=16)
            late_hits = eng.prefix_cache.hits - hits
            events = list(client.generate_stream([_chat(reqs[2][0])], n=2, temperature=0.0,
                                                 max_tokens=24))
            world = client.get_world_size()
            reset = client.reset_prefix_cache() and len(eng.prefix_cache) == 0
            probe = dict(n=1, temperature=0.0, max_tokens=16)
            first = client.generate([_chat(reqs[3][0])], **probe)
            t0 = time.perf_counter()
            reloaded = client.update_named_param(path=model)
            t_reload = time.perf_counter() - t0
            reset = reset and client.reset_prefix_cache() and len(eng.prefix_cache) == 0
            again = client.generate([_chat(reqs[3][0])], **probe)
            httpd.shutdown()
            del srv, eng, sched, httpd

            # a compaction: 256 prompt columns, 256 decode columns; the second
            # request's budget fits only once the first's decode is folded in
            httpd, client = _serve_http(SERVE_ARGS + ["--model", model, "--max-model-len",
                                                      "512", "--prompt-slab", "256"], V)
            sched = httpd.engine_server.scheduler
            rec.sched = sched
            comp = [([int(t) for t in rng.integers(2, V, 150)],
                     dict(n=1, temperature=0.0, max_tokens=120)),
                    ([int(t) for t in rng.integers(2, V, 100)],
                     dict(n=1, temperature=0.7, top_p=0.95, max_tokens=200))]
            comp_pair, _ = _late_pair(client, sched, *comp, after=64)
            compactions, comp_steps = sched.compactions, sched.steps_executed
            httpd.shutdown()
            del sched, httpd

            # Engine(auto_continuous=True) on the probe's prompts (the planted
            # fault and the profiled chunk take these weights too)
            auto = Engine(fresh, cfg, ChatIdTok(V), max_model_len=2048, max_batch=16,
                          eos_token_ids=sorted(eos), auto_continuous=True)
            rec.sched = auto._continuous()
            t0 = time.perf_counter()
            outs = auto.generate([_chat(p) for p in prompts], sp0)
            t_auto = time.perf_counter() - t0
            d_cont = auto._auto_sched.steps_executed
            auto._auto_sched.stop()
            rec.sched = None
            del auto
        torch.cuda.synchronize()
        launches["serve_http"] = dict(_cuda.LAUNCHES)

        # ---- the bf16 path's checks
        served = _served_samples(reqs)
        ntok = sum(len(s[2]) for s in served)
        n_req, lat, wall, steps, waves, comps = burst
        print(f"serve_http burst (the recorder off): {n_req} requests, {len(served)} samples, "
              f"{ntok} completion tokens in {wall:.2f} s = {ntok / wall:.1f} tok/s; latency p50 "
              f"{float(np.median(lat)):.2f} s, max {max(lat):.2f} s; steps_executed {steps}, "
              f"waves {waves}, compactions {comps}; export {t_export:.2f} s, server start "
              f"(load) {t_start:.2f} s [{card}]", flush=True)
        check(overlapped, "the short request did not finish while the long one decoded")
        check(late_hits == 2, f"{late_hits} of the late requests were prefix hits")
        served += _served_samples(pair)
        check(events[-1] == {"type": "done"}, f"the stream ended with {events[-1]}")
        for k in (0, 1):
            fin = [e for e in events if e["type"] == "finish" and e["sample"] == k]
            deltas = [t for e in events if e["type"] == "delta" and e["sample"] == k
                      for t in e["token_ids"]]
            check(len(fin) == 1 and deltas == fin[0]["token_ids"] and len(deltas) == 24,
                  f"stream sample {k}: its deltas do not make its finish event")
        check(world == 1 and reset, f"world size {world}, prefix store reset {reset}")
        check(reloaded == {"ok": True, "path": model} and again == first,
              "the answer changed across a reload of the same weights")
        _report_excess("serve_http", _served_excess(fresh, cfg, served, SERVE_LP_ATOL),
                       SERVE_LP_ATOL, card)
        check(compactions >= 1, "no compaction happened")
        _report_excess(f"serve_http compaction ({compactions} compactions, {comp_steps} steps)",
                       _served_excess(fresh, cfg, _served_samples(comp_pair), SERVE_LP_ATOL),
                       SERVE_LP_ATOL, card)
        lengths = [len(r.outputs[0].token_ids) for r in outs]
        d_sync = sum(max(lengths[lo:lo + 16]) for lo in (0, 16))
        print(f"auto_continuous: {len(prompts)} prompts, lengths {sorted(lengths)}, EOS set "
              f"{sorted(eos)}: {d_cont} decode steps against {d_sync} for the waves' maxima, "
              f"{t_auto:.2f} s (the recorder on) [{card}]", flush=True)
        check(len(set(lengths)) > 1 and d_cont < d_sync,
              f"auto_continuous took {d_cont} steps, the waves {d_sync}")
        _report_excess("auto_continuous", _served_excess(fresh, cfg, [
            (p, dict(temperature=0.0), r.outputs[0].token_ids, r.outputs[0].token_logprobs)
            for p, r in zip(prompts, outs)], SERVE_LP_ATOL), SERVE_LP_ATOL, card)
        used = launches["serve_http"]
        for name in ("flash_attention_cached", "ragged_decode_attention"):
            check(used[name] > 0, f"{name} never launched on serve_http")
        check(used["ragged_decode_attention_q8"] == 0, "the int8 decode kernel ran on serve_http")
        check(any(k[0] == "flash_attention_cached" and k[3] for k in rec.flash),
              "serve_http: no prefix-hit suffix prefill kept")
        _check_path_launches(rec, "serve_http", card)
        _check_live_dstarts(rec, False, "serve_http", card)
        del rec, outs

        # ---- a planted fault: rows installed with dstart = slab in place of
        # their admission column must fail the teacher-forced check
        eng = Engine(fresh, cfg, ChatIdTok(V), max_model_len=2048, max_batch=16,
                     eos_token_ids=[])
        ce = ContinuousEngine(eng)
        admit, cols = ce._admit, []

        def planted(reqs_):
            cols.append(int(ce._state["col"]))
            admit(reqs_)
            for r in reqs_:
                for row in r.rows:
                    ce._state["dstart"][row] = ce.slab

        ce._admit = planted
        ce.start()
        try:
            fa = ce.submit(_chat(rng.integers(2, V, 300)),
                           SamplingParams(temperature=0.0, max_tokens=256))
            _wait_steps(ce, 192)
            pb = [int(t) for t in rng.integers(2, V, 300)]
            spb = dict(n=1, temperature=0.7, top_p=0.95, max_tokens=32)
            ob = ce.submit(_chat(pb), SamplingParams(**spb)).result(timeout=300).outputs[0]
            fa.result(timeout=300)
        finally:
            ce.stop()
        bad = _served_excess(fresh, cfg, [(pb, spb, ob.token_ids, ob.token_logprobs)],
                             SERVE_LP_ATOL)
        print(f"planted fault (rows admitted at columns {cols} installed with dstart = slab "
              f"{ce.slab}): {bad['over']} of {bad['checked']} tokens past the limit, max "
              f"|logprob diff| {bad['err']:.3e} [{card}]", flush=True)
        check(bad["over"] > 0, "the teacher-forced check missed a planted fault (dstart = slab)")
        del ce

        # ---- int8 KV, counted: the burst again (timed, the recorder off) and
        # a late pair, held at the int8 limit
        _cuda.reset_launches()
        with _ServedLaunches() as rec:
            httpd, client = _serve_http(args + ["--kv-quant", "int8"], V)
            sched = httpd.engine_server.scheduler
            q8 = httpd.engine_server.engine.kv_quant
            reqs, lat, wall = _burst(client, rng, V, SERVE_BURST)
            burst = (sched.steps_executed, sched.waves, sched.compactions)
            rec.sched = sched
            late = [(reqs[0][0] + [int(t) for t in rng.integers(2, V, 64)],
                     dict(n=1, temperature=0.0, max_tokens=96)),
                    (reqs[1][0] + [int(t) for t in rng.integers(2, V, 40)],
                     dict(n=1, temperature=0.7, top_p=0.95, max_tokens=16))]
            pair, _ = _late_pair(client, sched, *late, after=16)
            httpd.shutdown()
            del sched, httpd
        torch.cuda.synchronize()
        launches["serve_http_q8"] = dict(_cuda.LAUNCHES)
    check(q8 == "int8", f"the server's KV is {q8}")
    served = _served_samples(reqs)
    ntok = sum(len(s[2]) for s in served)
    print(f"serve_http_q8 burst (the recorder off): {len(reqs)} requests, {len(served)} samples, "
          f"{ntok} completion tokens in {wall:.2f} s = {ntok / wall:.1f} tok/s; latency p50 "
          f"{float(np.median(lat)):.2f} s, max {max(lat):.2f} s; steps_executed {burst[0]}, "
          f"waves {burst[1]}, compactions {burst[2]} [{card}]", flush=True)
    served += _served_samples(pair)
    _report_excess("serve_http_q8", _served_excess(fresh, cfg, served, SERVE_LP_Q8_ATOL),
                   SERVE_LP_Q8_ATOL, card)
    used = launches["serve_http_q8"]
    check(used["flash_attention_cached"] > 0 and used["ragged_decode_attention_q8"] > 0
          and used["ragged_decode_attention"] == 0,
          f"serve_http_q8 launches {({k: v for k, v in used.items() if v})}")
    _check_path_launches(rec, "serve_http_q8", card)
    _check_live_dstarts(rec, True, "serve_http_q8", card)

    # ---- one scheduler chunk (16 rows x 16 steps): host clock, then profiled
    # (last: the bursts run before any profile of this phase)
    from concurrent.futures import Future

    from lapha_tpu_torch.engine import scheduler as sched_mod

    pc = ContinuousEngine(eng)
    pc._init_state()
    sp_p = SamplingParams(temperature=0.7, top_p=0.95, max_tokens=64)
    with torch.inference_mode():
        pc._admit([sched_mod._Request("", [int(t) for t in rng.integers(2, V, 256)], sp_p,
                                      1, Future()) for _ in range(16)])
        pc._decode_chunk()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pc._decode_chunk()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            pc._decode_chunk()
            torch.cuda.synchronize()
    dev_ms = sum(ev.device_time_total for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    check(dev_ms > 0, "the profiler saw no device time in the scheduler chunk")
    print(f"scheduler chunk (16 rows x {pc.chunk} steps, prompts 256, S {pc.S}): "
          f"{host_ms:.2f} ms host clock, {dev_ms:.2f} ms device busy "
          f"({100 * dev_ms / host_ms:.1f}%), {host_ms / pc.chunk:.2f} ms a step [{card}]",
          flush=True)
    del pc, eng, prof, rec, fresh
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for path, used in launches.items():
        print(f"{path}: launches {({k: v for k, v in used.items() if v})} [{card}]", flush=True)
    print(f"phase 21: peak memory {peak:.2f} GiB; the weight reload took {t_reload:.2f} s "
          f"[{card}]", flush=True)
    print(f"phase 21 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# phases 22, 11 and 15: speculative decoding (Engine(spec_decode="pld"))
# against the same engine without it, greedy. The two decode the same
# tokens through different attention kernels (the verify kernel over K+1
# columns a row, the ragged decode kernel over one; DeepSeek through
# products of other shapes), so bf16 rounds them apart and a greedy argmax
# may flip where the top two logits are close: the streams must agree up to
# their first divergence, and there the non-spec decode's own top-2 margin
# (recorded as it decodes) must be within SPEC_TIE, phase 21's greedy
# margin (SERVE_LP_ATOL: decode against a teacher-forced forward, ~2.5x the
# deviation read on an H100). On an MoE model the two paths also pick
# different experts where a token's router scores nearly tie (GPT-OSS-20B's
# first 8 layers, one decode step through each path on copies of one cache,
# 8 rows x 24 steps: 64 of the 192 row-steps routed some token otherwise, the
# logits then moved by up to 4.9 and the argmax flipped at margins up to 0.61;
# the dense model's two steps differ by <= 0.069): there a divergence that
# follows a routing difference at an earlier position of its row is a tie
# of the router, counted apart, and the margin rule holds for the others
SPEC_K, SPEC_NGRAM = 3, 2
SPEC_TIE = SERVE_LP_ATOL


def _spec_prompts(rng, vocab: int, P: int, plen: int) -> list:
    """P prompts of plen token ids whose last 96 tokens repeat their 32
    before: the repeated tail that prompt lookup drafts from."""
    import numpy as np

    out = []
    for _ in range(P):
        body = rng.integers(2, vocab, plen - 96)
        out.append(np.concatenate([body, np.tile(body[-32:], 3)]))
    return out


class _GreedyMargins:
    """Records, for each decode step of the non-spec engine, every row's
    top-2 margin of the logits its greedy token is the argmax of (the
    engine's ``sampling.sample`` wrapped; one small tensor a step, read
    after the run)."""

    def __enter__(self):
        from lapha_tpu_torch.engine import sampling

        self.sampling, self.fn, self.steps = sampling, sampling.sample, []

        def wrapped(logits, generator, **kw):
            src = logits.float()
            if kw.get("repetition_penalty") is not None and kw.get("presence") is not None:
                src = sampling.apply_repetition_penalty(src, kw["presence"],
                                                        kw["repetition_penalty"])
            top2 = src.topk(2, dim=-1).values
            self.steps.append(top2[:, 0] - top2[:, 1])
            return self.fn(logits, generator, **kw)

        sampling.sample = wrapped
        return self

    def __exit__(self, *exc):
        self.sampling.sample = self.fn

    def table(self):
        import torch

        return torch.stack(self.steps, dim=1).cpu().numpy()  # (B, steps)


class _RoutingLog:
    """The experts an MoE decode path routed each token to, keyed by (row,
    position, router call of the forward): ``router`` of ``ops.moe`` and the
    model module's ``decode_step`` / ``decode_step_multi`` wrapped (the
    forward's positions give each routed token's key); the choices stay on
    the card until :meth:`table`. A position fed again (a rejected draft's,
    then the accepted token's) keeps its last routing."""

    def __init__(self, mod, router: str):
        self.mod, self.router, self.steps, self.cur = mod, router, [], None

    def __enter__(self):
        from lapha_tpu_torch.ops import moe

        self.moe, self.route = moe, getattr(moe, self.router)
        self.fns = {name: getattr(self.mod, name) for name in ("decode_step", "decode_step_multi")}

        def route(*a, **k):
            w, i = self.route(*a, **k)
            if self.cur is not None:
                self.cur[1].append(i.sort(dim=-1).values)
            return w, i

        def wrap(fn, multi):
            def step(params, cfg, tok, positions, *a, **k):
                self.cur = (positions if multi else positions[:, None], [])
                out = fn(params, cfg, tok, positions, *a, **k)
                self.steps.append(self.cur)
                self.cur = None
                return out
            return step

        setattr(self.moe, self.router, route)
        for name, fn in self.fns.items():
            setattr(self.mod, name, wrap(fn, name == "decode_step_multi"))
        return self

    def __exit__(self, *exc):
        setattr(self.moe, self.router, self.route)
        for name, fn in self.fns.items():
            setattr(self.mod, name, fn)

    def table(self) -> dict:
        tab = {}
        for pos, picks in self.steps:
            pos = pos.cpu().numpy()
            B, T = pos.shape
            for layer, topi in enumerate(picks):
                topi = topi.reshape(B, T, -1).cpu().numpy()
                for b in range(B):
                    for t in range(T):
                        tab[(b, int(pos[b, t]), layer)] = tuple(topi[b, t])
        return tab


def _agree_to_tie(n: int, spec_out, ref_out, margins, tie: float, routes=None) -> dict:
    """Phases 22/11/15's agreement rule (above) on greedy outputs of the same
    prompts, ``margins`` (B, steps) the non-spec run's recorded top-2
    margins (row r's token t was step t's argmax), ``routes`` the two runs'
    routing tables (:class:`_RoutingLog`) on an MoE model: the share of
    tokens before each row's first divergence, the rows that diverge, those
    after a routing difference and the largest margin at another
    divergence; raises if a divergence that follows no routing difference
    has a margin above ``tie``."""
    agreed = total = diverged = routed = 0
    worst = 0.0
    for p, (so, ro) in enumerate(zip(spec_out, ref_out)):
        lens = len(ro.prompt_token_ids)
        for j in range(n):
            r = p * n + j
            a, b = so.outputs[j].token_ids, ro.outputs[j].token_ids
            c = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            agreed += c
            total += len(b)
            if c >= min(len(a), len(b)) and len(a) == len(b):
                continue
            diverged += 1
            if routes is not None and any(
                    routes[0].get(key) != routes[1].get(key)
                    for key in {k for k in routes[1] if k[0] == r and lens <= k[1] < lens + c}):
                routed += 1
                continue
            gap = float(margins[r, c])
            worst = max(worst, gap)
            check(gap <= tie, f"spec and non-spec greedy diverge at token {c} of row {r} where "
                              f"the non-spec top-2 margin is {gap:.4f} > {tie} and no token "
                              f"before it was routed otherwise")
    return {"agreed": agreed / max(1, total), "diverged": diverged, "after_routing": routed,
            "max_gap": worst}


class _VerifyCapture:
    """Keeps a copy of the inputs and output of one launch of the verify
    kernel on the path (the ``at``-th launch at layer 0 with T > 1, the
    layer's cache panels cloned as they were), so that it can be held to
    the plain version on the same inputs afterwards."""

    def __init__(self, at: int):
        self.at, self.seen, self.kept = at, 0, None

    def __enter__(self):
        from lapha_tpu_torch.ops import spec_verify_attention as sva

        self.sva, self.fn = sva, sva._verify_cuda

        def wrapped(q, kc, vc, layer, slot, valid, pos, pm, window, scale, scl, sinks, cap):
            out = self.fn(q, kc, vc, layer, slot, valid, pos, pm, window, scale, scl, sinks, cap)
            if int(layer) == 0 and q.shape[1] > 1 and self.kept is None:
                self.seen += 1
                if self.seen == self.at:
                    self.kept = dict(
                        q=q.clone(), k=kc[:1].clone(), v=vc[:1].clone(), slot=int(slot),
                        valid=valid.clone(), positions=pos.clone(),
                        pos_map=None if pm is None else pm.clone(), window=window, scale=scale,
                        scl=None if scl is None else (scl[0][:1].clone(), scl[1][:1].clone()),
                        sinks=sinks, softcap=cap, out=out.clone())
            return out

        self.sva._verify_cuda = wrapped
        return self

    def __exit__(self, *exc):
        self.sva._verify_cuda = self.fn

    def check(self, label: str, card: str) -> float:
        k = self.kept
        check(k is not None, f"{label}: no verify launch {self.at} at layer 0 with T > 1")
        ref = self.sva.spec_verify_plain(k["q"], k["k"], k["v"], 0, k["slot"], k["valid"],
                                         k["positions"], k["pos_map"], k["window"], k["scale"],
                                         cache_scale=k["scl"], sinks=k["sinks"],
                                         softcap=k["softcap"])
        err = float((k["out"].float() - ref.float()).abs().max())
        excess = (_q8_excess(k["out"], ref) if k["scl"] is not None else err - KERNEL_ATOL)
        B, T = k["positions"].shape
        below = k["valid"][:, :k["slot"]]
        print(f"{label}: the path's verify launch {self.at} (layer 0, B={B} T={T} slot "
              f"{k['slot']}, {int(below.sum())} valid columns below the block of "
              f"{below.numel()}) vs its plain version: max|diff| {err:.3e} [{card}]", flush=True)
        check(excess <= 0, f"{label}: the path's verify launch vs plain: max|diff| {err}")
        return err


def _profile_generate(eng, prompts, sp, label: str, card: str) -> float:
    """Device busy ms an iteration of one generate call under
    torch.profiler: the CUDA kernels' own time from the first decode
    attention launch on (the verify or the ragged decode kernel; the first
    step's embedding and layer-0 projections before it, a few microseconds,
    are left out with the prefill), over the decode steps or spec
    iterations. Its host clock and the profiling's own seconds are printed."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        eng.generate(prompts, sp)
        torch.cuda.synchronize()
    steps = max(1, eng.last_timings["decode_steps"])
    kernels = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    first = min((ev.time_range.start for ev in kernels
                 if "spec_verify" in ev.name or "ragged_decode" in ev.name), default=None)
    check(first is not None, f"the profiler saw no decode attention kernel ({label})")
    dev_ms = sum(ev.device_time_total for ev in kernels if ev.time_range.start >= first) / 1e3
    host_ms = eng.last_timings["decode_s"] * 1e3
    print(f"profiled generate, {label}: {steps} decode steps or iterations, device busy "
          f"{dev_ms / steps:.2f} ms an iteration against {host_ms / steps:.2f} ms host "
          f"({100 * dev_ms / host_ms:.1f}% busy; profiling took {time.perf_counter() - t0:.1f} "
          f"s) [{card}]", flush=True)
    return dev_ms / steps


def _spec_round(params, cfg, prompts, n: int, new: int, kw: dict, label: str, card: str,
                capture_at: int = 0, router: str = "") -> dict:
    """One greedy generate of ``prompts`` x n with ``Engine(spec_decode=
    "pld")`` (counted) and one without, on engines of ``kw``: the agreement
    rule, the spec stats, tok/s of each, host ms an iteration. With
    ``capture_at`` one of the path's verify launches is held to its plain
    version; ``router`` (an MoE model's ``ops.moe`` router) logs both runs'
    routing for the rule, which makes their tok/s host clocks of
    instrumented runs. Returns the spec run's launches and numbers."""
    import contextlib

    import torch

    from lapha_tpu_torch.engine import Engine, SamplingParams
    from lapha_tpu_torch.models import model_module
    from lapha_tpu_torch.ops import _cuda

    def log():
        return (_RoutingLog(model_module(cfg), router) if router
                else contextlib.nullcontext())

    t_round = time.perf_counter()
    text = [_text(pr) for pr in prompts]
    sp = SamplingParams(n=n, temperature=0.0, max_tokens=new, seed=1)
    spec_eng = Engine(params, cfg, IdTok(), spec_decode="pld", spec_k=SPEC_K,
                      spec_ngram=SPEC_NGRAM, **kw)
    ref_eng = Engine(params, cfg, IdTok(), **kw)
    spec_eng.generate(text, SamplingParams(n=n, temperature=0.0, max_tokens=8))  # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with log() as spec_routes:
        if capture_at:
            with _VerifyCapture(capture_at) as cap:
                spec_out = spec_eng.generate(text, sp)
        else:
            spec_out = spec_eng.generate(text, sp)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    st, t_spec = dict(spec_eng.last_spec_stats), dict(spec_eng.last_timings)
    with _GreedyMargins() as margins, log() as ref_routes:
        ref_out = ref_eng.generate(text, sp)
    t_ref = dict(ref_eng.last_timings)
    if capture_at:
        cap.check(label, card)
    agree = _agree_to_tie(n, spec_out, ref_out, margins.table(), SPEC_TIE,
                          (spec_routes.table(), ref_routes.table()) if router else None)
    n_ref = sum(len(o.token_ids) for r in ref_out for o in r.outputs)
    res = {"launches": launches, "stats": st, "agree": agree, "spec_out": spec_out,
           "engine": spec_eng, "ref_engine": ref_eng,
           "tok_s": st["tokens"] / t_spec["decode_s"], "ref_tok_s": n_ref / t_ref["decode_s"],
           "ms_it": t_spec["decode_s"] / max(1, st["iterations"]) * 1e3,
           "ref_ms_step": t_ref["decode_s"] / max(1, t_ref["decode_steps"]) * 1e3}
    print(f"{label}, greedy spec (K {SPEC_K}, M {SPEC_NGRAM}) vs non-spec: {agree['agreed']:.4f} "
          f"of tokens agreed before a divergence, {agree['diverged']} rows diverged, "
          f"{agree['after_routing']} of them after a token routed otherwise (largest non-spec "
          f"top-2 margin at the others {agree['max_gap']:.4f}, limit {SPEC_TIE}); "
          f"last_spec_stats {st}; "
          f"{res['tok_s']:.1f} tok/s with spec ({res['ms_it']:.2f} ms host an iteration) vs "
          f"{res['ref_tok_s']:.1f} tok/s without ({res['ref_ms_step']:.2f} ms a step); the "
          f"round took {time.perf_counter() - t_round:.1f} s [{card}]", flush=True)
    return res


def serve_spec(params, vf, cfg, card) -> dict:
    """Phase 22: speculative decoding on phase 3's Qwen2.5-1.5B model (28
    layers, the weights as drawn), 24 rows (4 prompts of 512 tokens with a
    repeated tail x n 6), 128 new tokens, K 3, M 2, each against the same
    engine without spec: (a) greedy with a bf16 cache and collect_h0,
    counted as "serve_spec"; (b) greedy with an int8 cache, counted as
    "serve_spec_q8"; (c) sampled at temperature 0.8 and top_p 0.95 (tokens
    an iteration, tok/s); (d) the pooled h0 of (a)'s rows against a value
    forward over prompt + completion (phase 4's fused-h0 check: it covers
    the bonus token's fix-up forward); (e) launches: the verify kernel 28
    times an iteration (+ 28 for the h0 fix-up) and the ragged decode
    kernel never, K3 for the prefill, and in (a) and (b) one launch of the
    path held to its plain version. Then a profiled spec and non-spec
    generate each (8 tokens) give device ms an iteration."""
    import numpy as np
    import torch

    from lapha_tpu_torch.engine import SamplingParams

    t_phase = time.perf_counter()
    L = cfg.num_hidden_layers
    P, n, plen, new = 4, 6, 512, 128
    rng = np.random.default_rng(SEED + 22)
    prompts = _spec_prompts(rng, cfg.vocab_size, P, plen)
    kw = dict(max_model_len=1024, max_batch=P * n, decode_chunk=32, pad_multiple=128,
              batch_bucket=1, eos_token_ids=[], seed=SEED, prefix_cache_bytes=0)
    out = {}
    for kv, path in ((None, "serve_spec"), ("int8", "serve_spec_q8")):
        label = f"phase 22{'a' if kv is None else 'b'}, Qwen2.5-1.5B {'bf16' if kv is None else 'int8'} KV"
        r = _spec_round(params, cfg, prompts, n, new, dict(kw, kv_quant=kv, collect_h0=kv is None),
                        label, card, capture_at=5)
        la, it = r["launches"], r["stats"]["iterations"]
        name = "spec_verify_attention" + ("" if kv is None else "_q8")
        want = L * (it + (1 if kv is None else 0))  # + the h0 fix-up forward
        check(la[name] == want, f"{label}: {name} launched {la[name]} times, expected "
                                f"{L} x {it} iterations{' + the h0 fix-up' if kv is None else ''}")
        for other in ("ragged_decode_attention", "ragged_decode_attention_q8"):
            check(la[other] == 0, f"{label}: {other} ran {la[other]} times in the spec loop")
        check(la["flash_attention_cached"] > 0, f"{label}: K3 never ran for the prefill")
        for ro in r["spec_out"]:
            for o in ro.outputs:
                check(len(o.token_ids) == new and all(0 <= t < cfg.vocab_size for t in o.token_ids),
                      f"{label}: {len(o.token_ids)} tokens")
        print(f"{label}: launches {({k: v for k, v in la.items() if v})} [{card}]", flush=True)
        out[path] = la
        if kv is None:
            # (d) every row's pooled h0 against a value forward of prompt + completion
            comps = [o.token_ids for ro in r["spec_out"] for o in ro.outputs]
            full = np.stack([np.concatenate([prompts[i // n], comps[i]]) for i in range(P * n)])
            _, _, h_ref = vf(full, np.ones_like(full, dtype=np.int32), return_h0=True)
            pooled = np.stack([o.pooled_hidden for ro in r["spec_out"] for o in ro.outputs])
            e = float(np.max(np.linalg.norm(pooled - h_ref, axis=-1)
                             / np.linalg.norm(h_ref, axis=-1)))
            print(f"{label}: fused value check on the spec path, the {P * n} rows' pooled h0 vs "
                  f"a value forward: largest rel err {e:.3e} (limit {REF_RTOL}) [{card}]",
                  flush=True)
            check(e <= REF_RTOL, f"{label}: spec-path pooled h0 rel err {e}")
        del r
    # (c) sampled
    sp = SamplingParams(n=n, temperature=0.8, top_p=0.95, max_tokens=new, seed=1)
    text = [_text(pr) for pr in prompts]
    from lapha_tpu_torch.engine import Engine

    spec_eng = Engine(params, cfg, IdTok(), spec_decode="pld", spec_k=SPEC_K,
                      spec_ngram=SPEC_NGRAM, **kw)
    ref_eng = Engine(params, cfg, IdTok(), **kw)
    outs = spec_eng.generate(text, sp)
    st, t_spec = dict(spec_eng.last_spec_stats), dict(spec_eng.last_timings)
    ref_eng.generate(text, sp)
    t_ref = dict(ref_eng.last_timings)
    for ro in outs:
        for o in ro.outputs:
            check(len(o.token_ids) == new and np.isfinite(o.token_logprobs).all()
                  and max(o.token_logprobs) <= 0.0, "phase 22c: tokens and logprobs")
    check(st["tokens_per_iteration"] >= 1.0, f"phase 22c: {st}")
    print(f"phase 22c, Qwen2.5-1.5B bf16 KV, sampled (temperature 0.8, top_p 0.95): "
          f"last_spec_stats {st}; {st['tokens'] / t_spec['decode_s']:.1f} tok/s with spec "
          f"({t_spec['decode_s'] / max(1, st['iterations']) * 1e3:.2f} ms host an iteration) vs "
          f"{P * n * new / t_ref['decode_s']:.1f} tok/s without "
          f"({t_ref['decode_s'] / max(1, t_ref['decode_steps']) * 1e3:.2f} ms a step) [{card}]",
          flush=True)
    # device ms an iteration, profiled last (a profiler session slows later host work)
    short = SamplingParams(n=n, temperature=0.0, max_tokens=8, seed=1)
    _profile_generate(spec_eng, text, short, "phase 22, greedy spec, bf16 KV, 8 tokens", card)
    _profile_generate(ref_eng, text, short, "phase 22, greedy non-spec, bf16 KV, 8 tokens", card)
    del spec_eng, ref_eng
    torch.cuda.empty_cache()
    print(f"phase 22 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


DIFF_MASK = 151665  # inside Qwen2.5's 151936 rows, outside its tokenizer's ids


def _diffusion_agree(n: int, out, ref_out, margins, call_of, Tb: int, tie: float) -> dict:
    """Phase 22's agreement rule for block diffusion: per row, the tokens
    before the first divergence of ``out`` from ``ref_out`` (greedy, the same
    prompts), and at a divergence the top-2 margin the reference run's
    reveal of that token had; ``margins`` (B·Tb, sample calls) is the
    reference run's recorded table, ``call_of(c)`` the sample call that
    revealed token c. Raises at a margin above ``tie``."""
    agreed = total = diverged = 0
    worst = 0.0
    first = None
    for p, (ro, rr) in enumerate(zip(out, ref_out)):
        for jj in range(len(ro.outputs)):
            r = p * n + jj
            a, b = ro.outputs[jj].token_ids, rr.outputs[jj].token_ids
            c = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            agreed += c
            total += len(b)
            if c >= min(len(a), len(b)) and len(a) == len(b):
                continue
            diverged += 1
            gap = float(margins[r * Tb + c % Tb, call_of(c)])
            worst = max(worst, gap)
            first = (r, c, gap) if first is None or c < first[1] else first
            check(gap <= tie, f"block diffusion streams diverge at token {c} of row {r} where "
                              f"the reference run's top-2 margin is {gap:.4f} > {tie}")
    return {"agreed": agreed / max(1, total), "diverged": diverged, "max_gap": worst,
            "first": first}


def _check_diffusion_out(res, vocab: int, new: int, label: str) -> None:
    import numpy as np

    for ro in res:
        for o in ro.outputs:
            check(len(o.token_ids) == new, f"{label}: {len(o.token_ids)} tokens, expected {new}")
            check(all(0 <= t < vocab and t != DIFF_MASK for t in o.token_ids),
                  f"{label}: a token outside the vocabulary or the mask id")
            check(np.isfinite(o.token_logprobs).all() and max(o.token_logprobs) <= 0.0,
                  f"{label}: logprobs finite and <= 0")


def _diffusion_round(eng, text, sp, label: str, card: str, margins: bool = False):
    """One generate: its outputs, stats, tok/s, forwards/s, host ms a
    forward (and the recorded greedy margins)."""
    import contextlib

    import torch

    t0 = time.perf_counter()
    with (_GreedyMargins() if margins else contextlib.nullcontext()) as m:
        res = eng.generate(text, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, tm = dict(eng.last_diffusion_stats), dict(eng.last_timings)
    loop_s = tm["decode_s"]
    print(f"{label}: last_diffusion_stats {st}; {st['tokens'] / loop_s:.1f} tok/s, "
          f"{st['forwards'] / loop_s:.1f} forwards/s, {loop_s / st['forwards'] * 1e3:.2f} ms host "
          f"a forward, prefill {tm['prefill_s'] * 1e3:.1f} ms, the call {wall:.2f} s [{card}]",
          flush=True)
    st["host_ms_a_forward"] = loop_s / st["forwards"] * 1e3
    return res, st, (m.table() if margins else None)


def _profile_diffusion(eng, text, sp, label: str, card: str, host_ms: float) -> None:
    """Device busy ms a forward of one generate's block loop under
    torch.profiler (started once the prefill is done), against ``host_ms``,
    the host ms a forward of an unprofiled round of the same engine (the
    profiler slows the host, so its own clock would understate the busy
    share)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CUDA]  # the kernels' own time only
    loop, held = eng._diffusion_impl, {}

    def profiled(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            out = loop(*a, **kw)
            torch.cuda.synchronize()
        held["prof"], held["host"] = prof, time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    eng._diffusion_impl = profiled
    try:
        eng.generate(text, sp)
    finally:
        del eng._diffusion_impl
    fwd = eng.last_diffusion_stats["forwards"]
    kernels = [ev for ev in held["prof"].events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(ev.device_time_total for ev in kernels) / 1e3 / fwd
    by_name = {}
    for ev in kernels:
        ms, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (ms + ev.device_time_total / 1e3, count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"profiled generate, {label}: {fwd} forwards, device busy {dev_ms:.2f} ms a forward "
          f"against {host_ms:.2f} ms host a forward unprofiled ({100 * dev_ms / host_ms:.1f}% "
          f"busy; {held['host'] * 1e3 / fwd:.2f} ms host a forward under the profiler, "
          f"profiling took {time.perf_counter() - t0:.1f} s); the top kernels, ms a forward "
          f"(launches, ms a launch): "
          + "; ".join(f"{name[:90]} {ms / fwd:.3f} ({count}, {ms / count:.4f})"
                      for name, (ms, count) in top) + f" [{card}]", flush=True)


def check_diffusion_reference(params, cfg, dev, card) -> None:
    """Phase 23's two-layer check: ``forward(block_bidir=True)`` at T=4 over
    an S=768 cache with holes (phase 1n's layout, 4 rows, noise in every
    slot), card (bf16, the block attention) against CPU (f32, plain):
    relative error of the block's logits <= REF_RTOL."""
    import torch

    from lapha_tpu_torch.models import qwen2

    sub, cfg2, cpu, cfg_cpu = _two_layers(params, cfg)
    gen = torch.Generator().manual_seed(SEED + 44)
    B, T, S, Lp, cp = 4, 4, 768, 640, 700
    lens = torch.randint(400, 513, (B,), generator=gen)
    j = torch.arange(S)[None, :]
    kv_valid = (j < lens[:, None]) | ((j >= Lp) & (j < cp + T))
    ids = torch.randint(2, 151643, (B, T), generator=gen)
    pos = lens[:, None] + (cp - Lp) + torch.arange(T)[None, :]
    shape = (2, B, S, cfg.num_key_value_heads, cfg.head_dim_)
    ck = torch.randn(shape, generator=gen).bfloat16()
    cv = torch.randn(shape, generator=gen).bfloat16()

    def run(p, c, device, dtype):
        with torch.inference_mode():
            cache = (ck.to(device, dtype), cv.to(device, dtype))
            logits, _, _ = qwen2.forward(p, c, ids.to(device), positions=pos.to(device),
                                         kv_cache=cache, cache_pos=cp,
                                         kv_valid=kv_valid.to(device), block_bidir=True)
        return logits.float().cpu()

    e = _rel(run(sub, cfg2, dev, torch.bfloat16), run(cpu, cfg_cpu, torch.device("cpu"),
                                                      torch.float32))
    print(f"reference check (2 layers, forward(block_bidir=True) T={T} at cache_pos {cp}, S={S} "
          f"with holes; card kernels bf16 vs CPU plain f32): logits rel err {e:.3e} (limit "
          f"{REF_RTOL}) [{card}]", flush=True)
    check(e <= REF_RTOL, f"block_bidir reference rel err {e}")


def serve_diffusion(params, cfg, card) -> dict:
    """Phase 23: block diffusion (``DiffusionEngine``) on phase 3's
    Qwen2.5-1.5B model (28 layers, the weights as drawn), mask id 151665, no
    EOS: 4 prompts of 512 ids x n 6 (24 rows), 128 new tokens, block_length
    4, denoising_steps 4. (a) Greedy with each strategy: sequential
    (counted as "serve_diffusion": the block attention 28 x forwards, K3
    for the prefill, no decode kernel) and low_confidence_static take 32
    blocks x (4 + 1) = 160 forwards, low_confidence_dynamic 2 a block (64);
    128 tokens a row, never the mask id. (b) The sequential round again with
    the block attention patched to its plain version: the streams agree up
    to near ties (phase 22's rule on the kernel round's own margins). (c) Sampled (temperature
    0.8, top-p 0.95, top-k 20, dynamic 0.9) twice with one seed: the same
    tokens, never the mask id; tokens a forward. (d) The two-layer
    reference check. (e) The scheduler: ``ContinuousEngine`` of 16 rows
    (slab 512, S 768) over a dynamic engine takes the 4 requests (24 rows,
    16 at a time) and a late one (prompt 0, n 1) after its first chunk, so
    the column cursor runs on past the first wave and the second wave's
    rows start at column 640, after a gap of holes; at column 756 a late
    short request (16 tokens) no longer fits the columns left, so the
    scheduler compacts (folds the live rows' committed columns into their
    prefixes; the gathered cache is then read by the kernel) and admits it.
    Counted as "serve_diffusion_sched", at least one compaction; each
    request's greedy tokens agree with (a)'s dynamic round up to near ties.
    Last, a profiled one-block generate: device ms a forward."""
    import threading
    import types

    import numpy as np
    import torch

    from lapha_tpu_torch.engine import ContinuousEngine, DiffusionEngine, SamplingParams
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.ops import block_attention as ba

    t_phase = time.perf_counter()
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    P, n, plen, new, Tb, steps = 4, 6, 512, 128, 4, 4
    nblocks = new // Tb
    rng = np.random.default_rng(SEED + 23)
    text = [_text(rng.integers(2, 151643, plen)) for _ in range(P)]
    kw = dict(mask_token_id=DIFF_MASK, block_length=Tb, denoising_steps=steps,
              max_model_len=plen + new + 128, max_batch=P * n, pad_multiple=128, batch_bucket=1,
              eos_token_ids=[], seed=SEED, prefix_cache_bytes=0)
    greedy = SamplingParams(n=n, temperature=0.0, max_tokens=new, seed=1)
    out = {}
    runs = {}
    for strategy, want in (("sequential", nblocks * (steps + 1)),
                           ("low_confidence_static", nblocks * (steps + 1)),
                           ("low_confidence_dynamic", nblocks * 2)):
        eng = DiffusionEngine(params, cfg, IdTok(), remasking_strategy=strategy, **kw)
        label = f"phase 23a, Qwen2.5-1.5B greedy {strategy}"
        if strategy == "sequential":
            torch.cuda.synchronize()
            _cuda.reset_launches()
        res, st, margins = _diffusion_round(eng, text, greedy, label, card,
                                            margins=strategy != "low_confidence_static")
        if strategy == "sequential":
            la = out["serve_diffusion"] = dict(_cuda.LAUNCHES)
            check(la["block_attention"] == L * want,
                  f"{label}: the block attention launched {la['block_attention']} times, "
                  f"expected {L} x {want} forwards")
            check(la["flash_attention_cached"] == L, f"{label}: K3 for the prefill "
                                                     f"{la['flash_attention_cached']} times")
            for other in ("ragged_decode_attention", "flash_attention", "spec_verify_attention"):
                check(la[other] == 0, f"{label}: {other} ran {la[other]} times")
            print(f"{label}: launches {({k: c for k, c in la.items() if c})} [{card}]",
                  flush=True)
        check(st["forwards"] == want, f"{label}: {st['forwards']} forwards, expected {want}")
        check(st["tokens"] == P * n * new, f"{label}: {st['tokens']} tokens")
        _check_diffusion_out(res, V, new, label)
        runs[strategy] = (eng, res, margins)
        if strategy == "sequential":
            seq_host_ms = st["host_ms_a_forward"]
    # (b) the sequential round with the block attention's plain version
    eng, res_k, margins_k = runs["sequential"]
    real = ba._block_cuda

    def plain_block(q, k, v, kv_valid, scale, softcap):
        return ba.block_attention_plain(q, k, v, kv_valid, scale, softcap=softcap)

    ba._block_cuda = plain_block
    try:
        res_p, _, _ = _diffusion_round(eng, text, greedy, "phase 23b, greedy sequential, plain "
                                       "block attention", card)
    finally:
        ba._block_cuda = real
    ag = _diffusion_agree(n, res_p, res_k, margins_k, lambda c: c, Tb, SPEC_TIE)
    print(f"phase 23b, plain block attention vs the kernel: {ag['agreed']:.4f} of tokens agreed "
          f"before a divergence, {ag['diverged']} rows diverged, first divergence (row, token, the "
          f"kernel round's top-2 margin) {ag['first']}, largest margin at a divergence "
          f"{ag['max_gap']:.4f} (limit {SPEC_TIE}) [{card}]", flush=True)
    # (c) sampled, twice with one seed
    sampled = SamplingParams(n=n, temperature=0.8, top_p=0.95, top_k=20, max_tokens=new, seed=1)
    eng_d = runs["low_confidence_dynamic"][0]
    a, st_a, _ = _diffusion_round(eng_d, text, sampled, "phase 23c, sampled (temperature 0.8, "
                                  "top-p 0.95, top-k 20), dynamic 0.9", card)
    b, _, _ = _diffusion_round(eng_d, text, sampled, "phase 23c, the same seed again", card)
    _check_diffusion_out(a, V, new, "phase 23c")
    toks_a = [o.token_ids for ro in a for o in ro.outputs]
    check(toks_a == [o.token_ids for ro in b for o in ro.outputs],
          "phase 23c: one seed gave two token streams")
    print(f"phase 23c: {st_a['tokens_per_forward']} tokens a forward, the same tokens twice, "
          f"{len(set(map(tuple, toks_a)))} distinct streams of {P * n} [{card}]", flush=True)
    # (d) two layers, card against CPU
    check_diffusion_reference(params, cfg, eng.device, card)
    # (e) the scheduler: the 24 rows (16 at a time) and a late request that
    # keeps the column cursor going past the first wave, then a late short
    # request that no longer fits the columns left, which forces a compaction
    _, res_d, margins_d = runs["low_confidence_dynamic"]
    late_new = 4 * Tb
    sched_eng = DiffusionEngine(params, cfg, IdTok(), **dict(kw, max_batch=16))
    ce = ContinuousEngine(sched_eng, prompt_slab=plen)
    # pause the loop after the first chunk, and after the second wave's 29th
    # (the first wave's rows take 32 chunks): column 752 of 768 then
    chunk, calls = sched_eng._diff_chunk_impl, [0]
    pauses = {c: (threading.Event(), threading.Event()) for c in (1, nblocks + 29)}

    def pause_after(*a, **kw):
        res = chunk(*a, **kw)
        calls[0] += 1
        if calls[0] in pauses:
            reached, go = pauses[calls[0]]
            reached.set()
            go.wait(300)
        return res

    def submit_at(c, prompt, max_tokens):  # -> (future, the column it is first considered at)
        reached, go = pauses[c]
        check(reached.wait(600), f"phase 23e: the scheduler never reached chunk {c}")
        fut = ce.submit(prompt, SamplingParams(n=1, temperature=0.0, max_tokens=max_tokens))
        at = ce._state["col"] + Tb  # the paused chunk's columns are counted after it
        go.set()
        return fut, at

    sched_eng._diff_chunk_impl = pause_after
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    ce.start()
    try:
        futs = [ce.submit(t, greedy) for t in text]
        late, _ = submit_at(1, text[0], new)
        short, col_at = submit_at(nblocks + 29, text[0], late_new)
        got = [f.result(timeout=600) for f in futs]
        got_late, got_short = late.result(timeout=600), short.result(timeout=600)
    finally:
        for _, go in pauses.values():
            go.set()
        ce.stop()
    wall = time.perf_counter() - t0
    la = out["serve_diffusion_sched"] = dict(_cuda.LAUNCHES)
    check(la["block_attention"] == L * ce.steps_executed,
          f"phase 23e: the block attention launched {la['block_attention']} times, expected "
          f"{L} x {ce.steps_executed} forwards")
    check(ce.compactions >= 1, f"phase 23e: no compaction (the short request came at column "
                               f"{col_at} of {ce.S})")
    _check_diffusion_out(got + [got_late], V, new, "phase 23e")
    _check_diffusion_out([got_short], V, late_new, "phase 23e, the short request")
    call_of = lambda c: c // Tb  # noqa: E731 (greedy dynamic: one reveal pass a block)
    ag = _diffusion_agree(n, got, res_d, margins_d, call_of, Tb, SPEC_TIE)
    ag_late = _diffusion_agree(n, [got_late], res_d[:1], margins_d, call_of, Tb, SPEC_TIE)
    head = types.SimpleNamespace(outputs=[types.SimpleNamespace(
        token_ids=res_d[0].outputs[0].token_ids[:late_new])])
    ag_short = _diffusion_agree(n, [got_short], [head], margins_d, call_of, Tb, SPEC_TIE)
    print(f"phase 23e, ContinuousEngine (16 rows, S {ce.S}) over the dynamic engine: 24 rows, a "
          f"late request after the first chunk, a late request of {late_new} tokens at column "
          f"{col_at}; {ce.steps_executed} forwards, waves {ce.waves}, compactions "
          f"{ce.compactions}, {((P * n + 1) * new + late_new) / wall:.1f} tok/s in {wall:.2f} s; "
          f"against the sync round: {ag['agreed']:.4f} agreed, {ag['diverged']} rows diverged "
          f"(largest margin {ag['max_gap']:.4f}), the late requests {ag_late['agreed']:.4f} and "
          f"{ag_short['agreed']:.4f}; launches {({k: c for k, c in la.items() if c})} [{card}]",
          flush=True)
    # device ms a forward, profiled last (a profiler session slows later host work)
    _profile_diffusion(runs["sequential"][0], text, SamplingParams(
        n=n, temperature=0.0, max_tokens=Tb, seed=1), "phase 23, greedy sequential, one block",
        card, seq_host_ms)
    del runs, eng, eng_d, sched_eng, ce
    torch.cuda.empty_cache()
    print(f"phase 23 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def _qwen25_model(dev):
    """Phase 3's model: Qwen2.5-1.5B at full width and depth, random bf16
    weights from the seed. Returns (cfg, params, the generator, which the
    value head draws from next)."""
    import torch

    from lapha_tpu_torch.models import qwen2

    cfg = qwen2.Qwen2Config(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=28, num_attention_heads=12, num_key_value_heads=2,
        max_position_embeddings=4096, rope_theta=1e6, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return cfg, qwen2.init_params(cfg, gen), gen


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
    ap.add_argument("--diffusion", action="store_true",
                    help="run only block diffusion's phases: 1n (its kernel) and 23 (served)")
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
    from lapha_tpu_torch.models import value_model
    from lapha_tpu_torch.ops import _cuda
    from lapha_tpu_torch.search import ValueFunction

    t0 = time.perf_counter()

    def elapsed(what: str) -> None:  # the script's time so far, against the run's limit
        print(f"elapsed {time.perf_counter() - t0:.1f} s after {what}", flush=True)

    _cuda.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.c5:
        probe_c5(dev, card)
        return 0
    if args.diffusion:
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        check_block_kernels(dev, card, pool.submit(_merge_fault_build))
        pool.shutdown()
        cfg, params, _ = _qwen25_model(dev)
        serve_diffusion(params, cfg, card)
        elapsed("phases 1n and 23")
        return 0
    for line in _cuda.build_log.splitlines():  # ptxas: registers, smem, spills per kernel
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)
    # phases 1m and 1n's merge-fault build compiles while phases 1-1l run
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    merge_fault = pool.submit(_merge_fault_build)
    pool.shutdown(wait=False)
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
    kernels.update(check_verify_kernels(dev, card, merge_fault))
    kernels.update(check_block_kernels(dev, card, merge_fault))
    elapsed("the kernel checks (phases 1-1n)")

    # ---------------- MoE serving at full width, counted; freed after
    launches = {"serve_moe": serve_moe(dev, card)}
    # ---------------- GPT-OSS-20B serving at full width, counted; freed after
    launches.update(serve_gptoss(dev, card))
    # ---------------- Gemma-2-2B (bf16, then int8 KV) and Gemma-3-1B serving at
    # full width, counted; each freed after
    launches.update(serve_published(dev, card, GEMMA2_2B_CONFIG, "Gemma-2-2B", "serve_gemma2",
                                    (None, "int8"), {}))
    # Gemma-3's two-layer check at prompts past its 512-token window
    launches.update(serve_published(dev, card, GEMMA3_1B_CONFIG, "Gemma-3-1B", "serve_gemma3",
                                    (None,), {"T": 560, "S": 592}))
    # ---------------- DeepSeek-V2-Lite serving at full width, counted; freed after
    launches.update(serve_deepseek(dev, card))
    # ---------------- Phi-3-mini (two-layer check past its 2047 window) and
    # StarCoder2-3B serving at full width, counted; each freed after
    launches.update(serve_published(dev, card, PHI3_MINI_4K_CONFIG, "Phi-3-mini-4k", "serve_phi3",
                                    (None, "int8"), {"T": 2100, "S": 2176}, "17", spec=True))
    launches.update(serve_published(dev, card, STARCODER2_3B_CONFIG, "StarCoder2-3B",
                                    "serve_starcoder2", (None, "int8"), {}, "17", spec=True))
    elapsed(f"serving at full width, {CUT_LAYERS} layers (phases 10-12, 15, 17)")

    cfg, params, gen = _qwen25_model(dev)
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

    # ---------------- speculative decoding on the same model, counted
    launches.update(serve_spec(params, vf, cfg, card))
    elapsed("speculative decoding (phase 22)")
    # ---------------- block diffusion on the same model, counted
    launches.update(serve_diffusion(params, cfg, card))
    elapsed("block diffusion (phase 23)")

    # ---------------- quantized serving at bench.py's shape, counted
    launches["serve_quantized"] = serve_quantized(params, head, cfg, card)
    profile_decode_step(params, cfg, card)

    elapsed("the dense and quantized serving (phases 2-5, 8, 9)")
    # ---------------- the evaluation entry (rollout_jsonl.main), each mode counted
    launches.update(eval_entry(params, head, cfg, card))
    elapsed("the evaluation entry (phase 19)")

    # ---------------- training: the update, then the training entry
    # (run_dapo.main), whose first train_step is phase 6, counted
    launches["update"] = update_at_full_width(params, head, cfg, eng, card)
    elapsed("the dense update (phase 7)")
    launches.update(train_entry(params, cfg, card))
    print(f"launches in train_step: {launches['train_step']}", flush=True)
    elapsed("the training entry (phases 20 and 6)")
    # ---------------- the serving entry (engine.server.main) on phase 3's
    # weights as drawn, counted
    launches.update(serve_entry(cfg, card))
    del eng, vf, params, head
    torch.cuda.empty_cache()
    elapsed("the serving entry (phase 21)")

    # ---------------- MoE and GPT-OSS training at full width, counted; each freed after
    with tempfile.TemporaryDirectory() as tmpdir:
        for which in ("update_moe", "update_gptoss"):
            launches.update(update_moe(dev, card, which, tmpdir))
        # ---------------- Gemma training at full width, counted; each freed after
        launches.update(update_published(dev, card, GEMMA2_2B_CONFIG, "Gemma-2-2B",
                                         "update_gemma2", tmpdir,
                                         trainer_path="train_step_gemma2"))
        # the two-layer check at rows past Gemma-3's 512-token window
        launches.update(update_published(dev, card, GEMMA3_1B_CONFIG, "Gemma-3-1B",
                                         "update_gemma3", tmpdir, ((530, 300), (40, 60))))
        # ---------------- DeepSeek-V2-Lite training at full width, counted; freed after
        launches.update(update_deepseek(dev, card, tmpdir))
        # ---------------- Phi-3-mini and StarCoder2-3B training at full width,
        # counted; each freed after (k_proj's bias gets no gradient:
        # softmax is shift-invariant along a row)
        every_leaf = lambda n: not n.endswith("k_proj.b")  # noqa: E731
        launches.update(update_published(dev, card, PHI3_MINI_4K_CONFIG, "Phi-3-mini-4k",
                                         "update_phi3", tmpdir, trainer_path="train_step_phi3",
                                         keep=every_leaf, phase="18"))
        launches.update(update_published(dev, card, STARCODER2_3B_CONFIG, "StarCoder2-3B",
                                         "update_starcoder2", tmpdir, keep=every_leaf,
                                         phase="18"))
    elapsed("training at full width (phases 13, 14, 16, 18)")

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
        # no Pallas kernel: JAX's dense verify attention (XLA einsums) in
        # decode_step_multi, counted on the spec paths (phases 22 and 11)
        "spec_verify_attention": ("lapha_tpu_torch/csrc/spec_verify_attention.cuh",
                                  "lapha_tpu/models/qwen2.py:1878"),
        "spec_verify_attention_q8": ("lapha_tpu_torch/csrc/spec_verify_attention.cuh",
                                     "lapha_tpu/models/qwen2.py:1878"),
        "spec_verify_attention_sink": ("lapha_tpu_torch/csrc/spec_verify_attention.cuh",
                                       "lapha_tpu/models/qwen2.py:1878"),
        # no Pallas kernel: JAX's dense block_bidir attend (qwen2.forward's
        # mask, where its flash path cannot go), counted on the
        # block-diffusion paths (phase 23)
        "block_attention": ("lapha_tpu_torch/csrc/block_attention.cu",
                            "lapha_tpu/models/qwen2.py:1314"),
    }
    # the verify kernel at T = 1 (Qwen2.5, Phi-3, StarCoder2's shapes, beside
    # SDPA): its bf16 entry's launches on that model's spec path (phase 22,
    # phase 17's for Phi-3 and StarCoder2)
    for fam in ("", "_phi3", "_starcoder2"):
        replaces["spec_verify_attention_t1" + fam] = replaces["spec_verify_attention"]
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
                 "_ds": ("update_deepseek", "train_step_deepseek"),
                 "_t1": ("serve_spec",),
                 "_t1_phi3": ("serve_phi3_spec",),
                 "_t1_starcoder2": ("serve_starcoder2_spec",)}
    # a counter of its own, read on the paths that launch it
    own_paths = {"block_attention": ("serve_diffusion", "serve_diffusion_sched")}
    rows = []
    for name, (src, rep) in replaces.items():
        suffix = next((x for x in row_paths if name.endswith(x)), "")
        counter = name.removesuffix(suffix) if suffix else name
        paths = own_paths.get(name) or row_paths.get(suffix, launches)
        by_path = {path: launches[path][counter] for path in paths}
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
