"""Request/response types of the engine (vLLM-compatible shapes) and the
scripted ``FakeEngine`` for hermetic tests.

A copy of ``lapha_tpu/engine/adapter.py``: importing ``lapha_tpu.engine``
pulls in jax, and this package never does. Its engine factory has one
counterpart in the port, ``lapha_tpu_torch.evalsuite.adapters.
build_engine_adapter``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Sequence

__all__ = ["SamplingParams", "CompletionOutput", "RequestOutput", "FakeEngine"]


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


class FakeEngine:
    """Deterministic scripted engine for hermetic tests.

    Responds from a script: a list of (pattern, [completion strings]) pairs
    matched against the prompt (first regex match wins), or a default
    callable. Token ids come from the supplied tokenizer; cumulative
    logprobs decrease with list position so softmax priors are ordered.
    """

    def __init__(self, tokenizer, script: Sequence[tuple[str, list[str]]] = (),
                 default: Callable[[str, int], list[str]] | None = None):
        self.tokenizer = tokenizer
        self.script = list(script)
        self.default = default or (lambda prompt, n: [f"<think>fake</think><answer>{i}</answer>" for i in range(n)])
        self.calls: list[dict] = []

    def update_params(self, params) -> None:
        """Weight-sync seam no-op (scripted outputs don't depend on params)."""

    def _completions_for(self, prompt: str, n: int) -> list[str]:
        for pat, comps in self.script:
            if re.search(pat, prompt, flags=re.S):
                out = list(comps)
                while len(out) < n:
                    out.append(out[-1])
                return out[:n]
        return self.default(prompt, n)

    def generate(self, prompts, sampling_params, use_tqdm: bool = False):
        n = int(getattr(sampling_params, "n", 1))
        results = []
        for p in prompts:
            comps = self._completions_for(p, n)
            outs = []
            for j, text in enumerate(comps):
                ids = self.tokenizer(text, add_special_tokens=False)["input_ids"]
                lps = [-0.1 * (j + 1)] * max(1, len(ids))
                outs.append(CompletionOutput(
                    token_ids=list(ids),
                    cumulative_logprob=float(sum(lps)),
                    token_logprobs=lps,
                    text=text,
                ))
            results.append(RequestOutput(outputs=outs, prompt=p))
        self.calls.append({"prompts": list(prompts), "n": n})
        return results

