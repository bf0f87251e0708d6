"""Request/response types of the engine (vLLM-compatible shapes).

Copies of the three dataclasses of ``lapha_tpu/engine/adapter.py``:
importing ``lapha_tpu.engine`` pulls in jax, and this package never does.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SamplingParams", "CompletionOutput", "RequestOutput"]


@dataclasses.dataclass
class SamplingParams:
    """vLLM-like sampling params (plus `n` and `logprobs`).

    top_k <= 0 disables top-k (vLLM uses -1); top_p >= 1 disables top-p.
    """

    n: int = 1
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    max_tokens: int = 256
    logprobs: int = 0
    stop_token_ids: tuple[int, ...] = ()
    seed: int | None = None


@dataclasses.dataclass
class CompletionOutput:
    token_ids: list[int]
    cumulative_logprob: float = 0.0
    token_logprobs: list[float] | None = None
    text: str | None = None
    finish_reason: str = "stop"  # "stop" | "length"
    # set by engines with collect_h0: mean final hidden over prompt+emitted
    # tokens — the value head's pooled h0, produced during generation
    pooled_hidden: object = None


@dataclasses.dataclass
class RequestOutput:
    outputs: list[CompletionOutput]
    prompt: str | None = None
    prompt_token_ids: list[int] | None = None
