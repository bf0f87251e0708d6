"""Engine-agnostic sampling params + adapter factory for the eval harness.

Port of ``lapha_tpu/evalsuite/adapters.py`` (parity with the reference
implementation's eval/adapters.py:100-153, vLLM-like output structs, and
the build factory 385-424). "tpu" and "vllm" build the port's ``Engine``
on ``device``; "jet" builds the block-diffusion ``DiffusionEngine``
(``engine/diffusion.py``) on ``device``; "fake" builds the scripted
``FakeEngine``.
"""

from __future__ import annotations

import dataclasses
import os

from ..engine.adapter import CompletionOutput as LLMResponse  # noqa: F401 (compat alias)
from ..engine.adapter import RequestOutput as LLMOutput  # noqa: F401 (compat alias)
from ..engine.adapter import SamplingParams


@dataclasses.dataclass
class GenParams(SamplingParams):
    """SamplingParams + the SDAR diffusion knobs (reference adapters.py:100-125).

    Under "jet" the factory builds the block-diffusion engine, whose
    block_length / denoising_steps / remasking_strategy come from the
    factory, while ``dynamic_threshold`` applies per request. The AR
    engines accept and ignore all four, as the reference's vLLM path does.
    """

    remasking_strategy: str = "low_confidence_dynamic"
    block_length: int = 4
    denoising_steps: int = 4
    dynamic_threshold: float = 0.9


def build_engine_adapter(name: str = "tpu", tokenizer=None, *, device="cuda", **kw):
    """Factory: "tpu"/"vllm" the port's AR engine; "jet" its block-diffusion
    engine; "fake" scripted.

    For the native engines pass either a prebuilt ``engine=`` instance or
    ``model_path=`` (HF dir) plus engine kwargs; the weights are loaded on
    ``device`` (``loader.load_params``: a CUDA device without a card raises).
    "jet" also needs a [MASK] token id: the ``mask_token_id=`` kwarg, else
    $SDAR_MASK_TOKEN_ID, else ``tokenizer.mask_token_id``. Its block knobs
    come from the kwargs or the reference's environment ($SDAR_BLOCK_LENGTH,
    $SDAR_DENOISING_STEPS, $SDAR_REMASKING_STRATEGY, $SDAR_DYNAMIC_THRESHOLD;
    reference eval/adapters.py:237-246).
    """
    name = (name or "tpu").lower()
    if name == "fake":
        from ..engine.adapter import FakeEngine

        return FakeEngine(tokenizer=tokenizer, **kw)
    if name in ("tpu", "vllm", "jet"):
        if "engine" in kw:
            return kw["engine"]
        from ..models import loader

        model_path = kw.pop("model_path", None) or kw.pop("jet_model_path", None)
        if model_path is None:
            raise ValueError("native engine needs model_path= or a prebuilt engine=")
        # drop foreign backend knobs (vllm_client, jet_*) for CLI compatibility
        kw = {k: v for k, v in kw.items()
              if not k.startswith("jet_") and k not in ("vllm_client", "base_url")}
        params, cfg = loader.load_params(model_path, device=device)
        if name == "jet":
            from ..engine.diffusion import DiffusionEngine

            mask_id = kw.pop("mask_token_id", os.getenv("SDAR_MASK_TOKEN_ID"))
            if mask_id is None:
                mask_id = getattr(tokenizer, "mask_token_id", None)
            if mask_id is None:
                raise ValueError("ENGINE=jet needs a [MASK] token id: pass mask_token_id=, "
                                 "set $SDAR_MASK_TOKEN_ID, or use a tokenizer with "
                                 "mask_token_id")
            return DiffusionEngine(
                params, cfg, tokenizer, mask_token_id=int(mask_id),
                block_length=int(kw.pop("block_length", os.getenv("SDAR_BLOCK_LENGTH", 4))),
                denoising_steps=int(kw.pop("denoising_steps",
                                           os.getenv("SDAR_DENOISING_STEPS", 4))),
                remasking_strategy=kw.pop("remasking_strategy",
                                          os.getenv("SDAR_REMASKING_STRATEGY",
                                                    "low_confidence_dynamic")),
                dynamic_threshold=float(kw.pop("dynamic_threshold",
                                               os.getenv("SDAR_DYNAMIC_THRESHOLD", 0.9))),
                **kw)
        from ..engine.engine import Engine

        return Engine(params, cfg, tokenizer, **kw)
    raise ValueError(f"unknown engine adapter {name!r}")
