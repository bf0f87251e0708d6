"""LaPha in PyTorch on CUDA: the port of ``lapha_tpu`` to one NVIDIA H100.

``lapha_tpu`` (JAX/Pallas) stays the reference. This package mirrors its
subpackage layout so each module has an obvious partner; it imports
``torch`` and neither ``jax`` nor anything of ``lapha_tpu``. What is ported
so far is the serving path — value-guided generation, i.e. what one
expansion of value-mode MCTS costs on the device — with quantized weights
and KV cache, the MoE family and GPT-OSS, and the training step on top of it (MCTS
rollout, hyperbolic shaping, GRPO + value update):

- ``ops.hyperbolic``       — all ten Poincaré-ball functions
- ``ops.latent``           — pool_mask, masked_mean, latent_project,
                             value_head_apply, potential_v
- ``ops.flash_attention``  — causal + cached (rectangular) flash forward,
                             sliding windows, sinks folded from the LSE:
                             CUDA kernel ``csrc/flash_attention.cu``; the
                             causal one is an autograd Function whose
                             backward is ``csrc/flash_attention_bwd.cu``
- ``ops.ragged_decode_attention`` — ragged decode attention over a bf16
                             or int8 cache, with or without sinks: CUDA
                             kernel ``csrc/ragged_decode_attention.cu``
- ``ops.int4_matmul``      — W4A16 projections: ``csrc/int4_matmul.cu``
- ``ops.moe``              — MoE routing and blocks (gather / dense impls),
                             GPT-OSS's router and clamped-GLU block
- ``ops.grouped_gemm``     — the expert products: ``csrc/grouped_gemm.cu``
- ``models.qwen2``         — the Qwen2/Llama decoder, dense or MoE (qwen2_moe,
                             qwen3_moe, mixtral), and GPT-OSS (sinks,
                             per-layer windows, YaRN): forward with and
                             without a cache (training: remat "full"),
                             decode_step (with the short window cache)
- ``models.value_model``   — linear value head + value_forward
- ``models.quant``         — int8 / int4 weight quantization
- ``models.loader``        — HF load (dense, MoE and gpt_oss, optionally quantized),
                             HF export, value-head load and save, params_from_numpy
- ``engine.adapter``       — SamplingParams / CompletionOutput / RequestOutput
- ``engine.sampling``      — vLLM-order sampling with logprobs (exact top-k)
- ``engine.prefix_cache``  — token-prefix KV store
- ``engine.engine``        — Engine.generate: prefill, prefix-hit suffix
                             prefill, n-fan-out, decode (the windowed-short
                             cache for sliding layers), collect_h0
- ``search.value_fn``      — ValueFunction (bucketed) with from_pooled
- ``search.mcts``, ``node``, ``tool_parse``, ``support``, ``latent_bank``,
  ``cluster``              — MCTSAgent and its host-side pieces; clustering
                             on the port's Poincaré distances
- ``train.config``         — MTPOConfig
- ``train.shaping``        — tree rewards, V-map over the port's potential_v
- ``train.losses``         — packing, chunked log-probs, GRPO + value MSE,
                             the update step
- ``train.optim``          — the JAX trainer's optax chain, written out
- ``train.trainer``        — MTPOTrainer: rollout_batch, train_step, train,
                             checkpoints, save_model (HF export + value head)
- ``train.dataset``        — the DAPO parquet, its row converter, the rewards
- ``train.viz``            — Poincaré-disk tree plots
- ``run_dapo``             — the training entry (typed overrides, --device)
- ``native``               — the prefix trie: the repo's C++ extension from
                             ``native/`` when built, else pure Python

Each kernel wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version beside the kernel, a CUDA tensor launches the kernel
(built on first use into ``lapha_tpu_torch/_build/``) or raises.
"""

__version__ = "0.1.0"
