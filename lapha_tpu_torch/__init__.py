"""LaPha in PyTorch on CUDA: the port of ``lapha_tpu`` to one NVIDIA H100.

``lapha_tpu`` (JAX/Pallas) stays the reference. This package mirrors its
subpackage layout so each module has an obvious partner; it imports
``torch`` and neither ``jax`` nor anything of ``lapha_tpu``. What is ported
so far is the serving path — value-guided generation, i.e. what one
expansion of value-mode MCTS costs on the device:

- ``ops.hyperbolic``       — all ten Poincaré-ball functions
- ``ops.latent``           — pool_mask, masked_mean, latent_project,
                             value_head_apply, potential_v
- ``ops.flash_attention``  — causal + cached (rectangular) flash forward:
                             CUDA kernel ``csrc/flash_attention.cu``
- ``ops.ragged_decode_attention`` — bf16 ragged decode attention: CUDA
                             kernel ``csrc/ragged_decode_attention.cu``
- ``models.qwen2``         — the dense Qwen2/Llama decoder: forward with and
                             without a cache, decode_step
- ``models.value_model``   — linear value head + value_forward
- ``models.loader``        — HF bf16 load, value-head load, params_from_numpy
- ``engine.adapter``       — SamplingParams / CompletionOutput / RequestOutput
- ``engine.sampling``      — vLLM-order sampling with logprobs (exact top-k)
- ``engine.prefix_cache``  — token-prefix KV store
- ``engine.engine``        — Engine.generate: prefill, prefix-hit suffix
                             prefill, n-fan-out, decode, collect_h0
- ``search.value_fn``      — ValueFunction (bucketed) with from_pooled
- ``native``               — the prefix trie: the repo's C++ extension from
                             ``native/`` when built, else pure Python

Each kernel wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version beside the kernel, a CUDA tensor launches the kernel
(built on first use into ``lapha_tpu_torch/_build/``) or raises.
"""

__version__ = "0.1.0"
