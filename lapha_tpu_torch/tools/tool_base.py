"""Abstract tool interface (OpenAI function-call format).

Parity with the reference implementation's tools/tool_base.py:1-185: name/description/
JSON-schema parameters, get_description(), argument validation,
batch_execute, and a per-call reward hook.

A copy of ``lapha_tpu/tools/tool_base.py`` (host code; importing the JAX
package would pull in jax).
"""

from __future__ import annotations

import abc
from typing import Any

_JSON_TYPES = {
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
    "array": list,
    "object": dict,
}


class Tool(abc.ABC):
    name: str = "tool"
    description: str = ""
    parameters: dict = {"type": "object", "properties": {}, "required": []}

    def get_description(self) -> dict:
        """OpenAI function-call schema."""
        return {
            "type": "function",
            "function": {
                "name": self.name,
                "description": self.description,
                "parameters": self.parameters,
            },
        }

    def validate_args(self, args: dict) -> None:
        props = self.parameters.get("properties", {})
        for req in self.parameters.get("required", []):
            if req not in args:
                raise ValueError(f"{self.name}: missing required argument '{req}'")
        for k, v in args.items():
            if k not in props:
                raise ValueError(f"{self.name}: unexpected argument '{k}'")
            expect = _JSON_TYPES.get(props[k].get("type"))
            if expect and not isinstance(v, expect):
                raise TypeError(
                    f"{self.name}: argument '{k}' should be {props[k]['type']}, "
                    f"got {type(v).__name__}"
                )

    @abc.abstractmethod
    def execute(self, **kwargs) -> Any:
        ...

    def __call__(self, **kwargs):
        self.validate_args({k: v for k, v in kwargs.items() if k != "context"})
        return self.execute(**kwargs)

    def batch_execute(self, calls: list[dict]) -> list[Any]:
        return [self(**c) for c in calls]

    def calculate_reward(self, **kwargs) -> float:
        """Optional per-call shaping hook; default neutral."""
        return 0.0
