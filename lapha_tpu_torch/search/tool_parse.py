"""Tool-call extraction from model completions.

Behavior parity with the reference implementation's trainer/agent.py:56-120: supports
``<tool_call>{json}</tool_call>`` blocks and ```python fenced code (mapped
to execute_python_code); returns an assistant message whose content has the
tool blocks removed and a ``tool_calls`` list in OpenAI function format.

A copy of ``lapha_tpu/search/tool_parse.py`` (host code; importing the JAX
package's ``search`` would pull in jax).
"""

from __future__ import annotations

import ast
import json
import re
from typing import Any

_TOOL_RE = re.compile(r"<tool_call>(.*?)</tool_call>", re.DOTALL)
_PY_RE = re.compile(r"```(?:python)\s*\n(.*?)```", re.DOTALL | re.IGNORECASE)
_IM_END_RE = re.compile(r"<\|im_end\|>$")


def _loose_json(raw: str) -> Any:
    try:
        return json.JSONDecoder(strict=False).decode(raw.strip())
    except Exception:
        return ast.literal_eval(raw.strip())


def parse_tool_calls(content: str) -> dict:
    """Parse a completion into {"role", "content"[, "tool_calls"]}.

    Raises on malformed <tool_call> JSON (the caller converts that into an
    error tool message, agent.py:954-960).
    """
    hits: list[tuple[str, int, re.Match]] = []
    for m in _TOOL_RE.finditer(content):
        hits.append(("tool", m.start(), m))
    for m in _PY_RE.finditer(content):
        hits.append(("py", m.start(), m))
    hits.sort(key=lambda t: t[1])

    segments: list[str] = []
    tool_calls: list[dict] = []
    cursor = 0
    for kind, start, m in hits:
        if start > cursor and content[cursor:start].strip():
            segments.append(content[cursor:start])
        raw = m.group(1)
        if kind == "tool":
            func = _loose_json(raw)
            args = func.get("arguments", {})
            if isinstance(args, str):
                args = _loose_json(args)
            func["arguments"] = args
            tool_calls.append({"type": "function", "function": func})
        else:
            tool_calls.append({
                "type": "function",
                "function": {"name": "execute_python_code", "arguments": {"code": raw}},
            })
        cursor = m.end()
    if cursor < len(content) and content[cursor:].strip():
        segments.append(content[cursor:])

    if tool_calls:
        text = "\n".join(s.strip() for s in segments if s.strip())
        return {"role": "assistant", "content": text, "tool_calls": tool_calls}
    return {"role": "assistant", "content": _IM_END_RE.sub("", content)}
