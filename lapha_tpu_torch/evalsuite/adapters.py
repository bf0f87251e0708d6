"""Engine-agnostic sampling params + adapter factory for the eval harness.

Port of ``lapha_tpu/evalsuite/adapters.py`` (parity with the reference
implementation's eval/adapters.py:100-153, vLLM-like output structs, and
the build factory 385-424). "tpu" and "vllm" build the port's ``Engine``
on ``device``; "fake" builds the scripted ``FakeEngine``; "jet" (the
block-diffusion engine) raises: it is not ported (ROADMAP A10).

``GenParams`` is the engine's ``SamplingParams``: the JAX class adds the
four SDAR diffusion knobs (remasking strategy, block length, denoising
steps, dynamic threshold), which only "jet" reads, so the port has none.
"""

from __future__ import annotations

from ..engine.adapter import CompletionOutput as LLMResponse  # noqa: F401 (compat alias)
from ..engine.adapter import RequestOutput as LLMOutput  # noqa: F401 (compat alias)
from ..engine.adapter import SamplingParams


GenParams = SamplingParams


def build_engine_adapter(name: str = "tpu", tokenizer=None, *, device="cuda", **kw):
    """Factory: "tpu"/"vllm" the port's AR engine; "fake" scripted; "jet"
    raises (block diffusion is not ported, ROADMAP A10).

    For the AR engine pass either a prebuilt ``engine=`` instance or
    ``model_path=`` (HF dir) plus engine kwargs; the weights are loaded on
    ``device`` (``loader.load_params``: a CUDA device without a card raises).
    """
    name = (name or "tpu").lower()
    if name == "fake":
        from ..engine.adapter import FakeEngine

        return FakeEngine(tokenizer=tokenizer, **kw)
    if name == "jet":
        raise ValueError("engine 'jet' (the block-diffusion DiffusionEngine) is not ported "
                         "to lapha_tpu_torch yet: ROADMAP A10")
    if name in ("tpu", "vllm"):
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
        from ..engine.engine import Engine

        return Engine(params, cfg, tokenizer, **kw)
    raise ValueError(f"unknown engine adapter {name!r}")
