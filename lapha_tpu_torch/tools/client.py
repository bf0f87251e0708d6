"""Remote tool client: `execute_python_code` over HTTP.

Parity with the reference implementation's tools/remote_python_code_interpreter.py:5-65 but
using `requests` instead of a curl subprocess; falls back to the in-process
interpreter when no server is reachable (so eval runs don't require the
server for simple cases).

A copy of ``lapha_tpu/tools/client.py`` (host code; importing the JAX
package would pull in jax).
"""

from __future__ import annotations

import os
from typing import Any

from .interpreter import description as description  # re-exported schema
from .interpreter import execute_python_code as _local_execute

SERVER_URL = os.getenv("TOOL_SERVER_URL", "http://127.0.0.1:8001")
_TRUNCATE = 512


def execute_python_code(code: str, context: dict | None = None,
                        session_id: str | None = None,
                        timeout: int = 10,
                        server_url: str | None = None) -> tuple[str, dict[str, Any]]:
    """POST /execute; merge returned context; truncate output at 512 chars."""
    url = (server_url or SERVER_URL).rstrip("/") + "/execute"
    try:
        import requests

        resp = requests.post(
            url,
            json={"code": code, "session_id": session_id, "timeout": timeout},
            timeout=timeout + 5,
        )
        resp.raise_for_status()
        data = resp.json()
        out = str(data.get("output", ""))
        new_ctx = dict(context or {})
        new_ctx.update(data.get("context") or {})
    except Exception:
        # no server: run locally with the same sandbox
        out, new_ctx = _local_execute(code, context=context, time_limit=timeout)
        merged = dict(context or {})
        merged.update(new_ctx)
        new_ctx = merged
    if len(out) > _TRUNCATE:
        out = out[:_TRUNCATE] + "...<truncated>"
    return out, new_ctx
