"""HTTP client + adapter for a remote engine server — ``lapha_tpu/engine/client.py``.

``EngineClient`` mirrors the reference's VLLMClient surface (health poll,
world size, /generate, streamed /generate, prefix-cache reset, the weight
push as a /reload_weights POST) and ``RemoteEngineAdapter`` its server
adapter: ``generate(prompts, sampling_params, use_tqdm) -> [RequestOutput]``
with cumulative logprobs summed from the per-token logprobs.

The requests go through the standard library (``http.client``), not
``requests``, with the JAX client's bytes: a JSON body
(``json.dumps(payload, allow_nan=False)``, ``Content-Type:
application/json``), one connection a request. A reply of status 400 or
above raises :class:`EngineHTTPError`.
"""

from __future__ import annotations

import http.client
import json
import time
from typing import Any
from urllib.parse import urlsplit

from .adapter import CompletionOutput, RequestOutput


class EngineHTTPError(RuntimeError):
    """A reply with an HTTP status of 400 or above."""

    def __init__(self, status: int, body: bytes, url: str):
        super().__init__(f"{status} from {url}: {body[:500].decode(errors='replace')}")
        self.status = status
        self.body = body


class EngineClient:
    def __init__(self, base_url: str = "http://localhost:8000",
                 connection_timeout: float = 240.0):
        self.base_url = base_url.rstrip("/")
        self.connection_timeout = connection_timeout
        u = urlsplit(self.base_url)
        if u.scheme != "http":
            raise ValueError(f"EngineClient speaks plain http: {base_url}")
        self._host, self._port = u.hostname, u.port or 80
        self._prefix = u.path.rstrip("/")

    def _open(self, method: str, path: str, payload: dict | None, timeout: float):
        """Send one request; returns (connection, response) with the
        response's headers read."""
        conn = http.client.HTTPConnection(self._host, self._port, timeout=timeout)
        headers, body = {}, None
        if payload is not None:
            body = json.dumps(payload, allow_nan=False).encode("utf-8")
            headers = {"Content-Type": "application/json"}
        try:
            conn.request(method, self._prefix + path, body=body, headers=headers)
            return conn, conn.getresponse()
        except BaseException:
            conn.close()
            raise

    def _call(self, method: str, path: str, payload: dict | None = None,
              timeout: float = 30.0, check: bool = True) -> tuple[int, bytes]:
        conn, resp = self._open(method, path, payload, timeout)
        try:
            data = resp.read()
        finally:
            conn.close()
        if check and resp.status >= 400:
            raise EngineHTTPError(resp.status, data, self.base_url + path)
        return resp.status, data

    def _json(self, method: str, path: str, payload: dict | None = None,
              timeout: float = 30.0):
        return json.loads(self._call(method, path, payload, timeout)[1])

    def check_server(self, total_timeout: float | None = None, retry_interval: float = 2.0):
        """Poll /health until the server responds."""
        deadline = time.time() + (total_timeout or self.connection_timeout)
        last_err = None
        while time.time() < deadline:
            try:
                status, _ = self._call("GET", "/health", timeout=5, check=False)
                if status < 400:
                    return True
                last_err = f"status {status}"
            except Exception as e:
                last_err = e
            time.sleep(retry_interval)
        raise ConnectionError(f"engine server at {self.base_url} not healthy: {last_err}")

    def get_world_size(self) -> int:
        return int(self._json("GET", "/get_world_size", timeout=10)["world_size"])

    def generate(self, prompts, n=1, repetition_penalty=1.0, temperature=1.0,
                 top_p=1.0, top_k=-1, min_p=0.0, max_tokens=16,
                 guided_decoding_regex=None, generation_kwargs=None,
                 logprobs=None, images=None, timeout: float = 600.0) -> dict:
        payload = dict(prompts=list(prompts), n=n,
                       repetition_penalty=repetition_penalty,
                       temperature=temperature, top_p=top_p, top_k=top_k,
                       min_p=min_p, max_tokens=max_tokens, logprobs=logprobs)
        return self._json("POST", "/generate", payload, timeout=timeout)

    def generate_stream(self, prompts, n=1, repetition_penalty=1.0,
                        temperature=1.0, top_p=1.0, top_k=-1, min_p=0.0,
                        max_tokens=16, logprobs=None, timeout: float = 600.0):
        """Streaming /generate: yields NDJSON event dicts as they arrive.

        Event protocol (server.handle_generate_stream): "delta" events carry
        incremental token_ids/logprobs per (tag=prompt index, sample);
        "finish" is authoritative per sample; "request_done" per prompt; a
        final {"type": "done"} closes the stream. "error" reports a failure
        for that prompt."""
        payload = dict(prompts=list(prompts), n=n, stream=True,
                       repetition_penalty=repetition_penalty,
                       temperature=temperature, top_p=top_p, top_k=top_k,
                       min_p=min_p, max_tokens=max_tokens, logprobs=logprobs)
        conn, resp = self._open("POST", "/generate", payload, timeout)
        try:
            if resp.status >= 400:
                raise EngineHTTPError(resp.status, resp.read(), self.base_url + "/generate")
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                ev = json.loads(line)
                yield ev
                if ev.get("type") == "done":
                    break
        finally:
            conn.close()

    def update_named_param(self, name: str = "", weights: Any = None,
                           path: str | None = None) -> dict:
        """Weight push: tell the server to reload exported weights from
        shared storage."""
        return self._json("POST", "/reload_weights", {"path": path}, timeout=600)

    reload_weights = update_named_param

    def reset_prefix_cache(self) -> bool:
        status, _ = self._call("POST", "/reset_prefix_cache", {}, timeout=30, check=False)
        return status < 400

    def close_communicator(self):
        """Nothing to close: every request opens and closes its own
        connection."""


class RemoteEngineAdapter:
    """vLLM-like adapter over :class:`EngineClient`."""

    def __init__(self, client: EngineClient, defaults: dict | None = None):
        self.client = client
        self.defaults = defaults or {}

    def _get(self, sp, name, default):
        val = getattr(sp, name, None)
        return default if val is None else val

    def generate(self, prompts, sampling_params, use_tqdm: bool = False):
        prompts = list(prompts)
        n = int(getattr(sampling_params, "n", 1) or 1)
        d = self.defaults
        resp = self.client.generate(
            prompts=prompts,
            n=n,
            repetition_penalty=float(self._get(sampling_params, "repetition_penalty",
                                               d.get("repetition_penalty", 1.0))),
            temperature=float(self._get(sampling_params, "temperature",
                                        d.get("temperature", 1.0))),
            top_p=float(self._get(sampling_params, "top_p", d.get("top_p", 1.0))),
            top_k=int(self._get(sampling_params, "top_k", d.get("top_k", -1)) or -1),
            min_p=float(self._get(sampling_params, "min_p", d.get("min_p", 0.0)) or 0.0),
            max_tokens=int(self._get(sampling_params, "max_tokens", d.get("max_tokens", 16))),
            logprobs=int(getattr(sampling_params, "logprobs", 0) or 0) or None,
        )
        comp = resp.get("completion_ids") or []
        lps = resp.get("logprobs") or [[None] * n for _ in comp]
        texts = resp.get("texts") or [[None] * n for _ in comp]
        outs = []
        for p in range(len(comp)):
            row = []
            for j, ids in enumerate(comp[p]):
                tok_lps = lps[p][j] if p < len(lps) and j < len(lps[p]) else None
                cum = float(sum(tok_lps)) if tok_lps else 0.0
                row.append(CompletionOutput(
                    token_ids=list(ids), cumulative_logprob=cum,
                    token_logprobs=tok_lps,
                    text=texts[p][j] if p < len(texts) and j < len(texts[p]) else None))
            outs.append(RequestOutput(outputs=row,
                                      prompt=prompts[p] if p < len(prompts) else None))
        return outs
