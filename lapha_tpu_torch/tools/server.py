"""Tool RPC server: POST /execute with per-session persistent state.

Parity with the reference implementation's tools/rpc_python_server.py:52-178 (FastAPI +
gunicorn there): same wire contract —

  POST /execute {"code": str, "session_id"?: str, "timeout"?: int}
  -> {"session_id", "output", "status": "success"|"error", "context"}

Built on stdlib ThreadingHTTPServer (no third-party web framework);
sessions are kept in memory keyed by uuid, each guarded by a lock.
--max-requests N recycles all session interpreter state every N /execute
requests (the leak bound gunicorn's --max-requests worker recycling gives
the reference, rpc_python_server.py:175-178, without downtime; hard
isolation of stuck C calls is the sandbox subprocess tier instead).

A copy of ``lapha_tpu/tools/server.py`` (host code; importing the JAX
package would pull in jax).
"""

from __future__ import annotations

import argparse
import json
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .interpreter import IPythonInterpreter, POWER_GUARD

SESSIONS: dict[str, IPythonInterpreter] = {}
_SESSION_LOCKS: dict[str, threading.Lock] = {}
_GLOBAL_LOCK = threading.Lock()
ISOLATION = "thread"  # set by serve()/--isolation; "subprocess" hard-kills
# stuck C calls via fork + RLIMIT_CPU (see IPythonInterpreter)


def _get_session(session_id: str | None, timeout: int) -> tuple[str, IPythonInterpreter, threading.Lock]:
    with _GLOBAL_LOCK:
        sid = session_id or str(uuid.uuid4())
        if sid not in SESSIONS:
            SESSIONS[sid] = IPythonInterpreter(time_limit=timeout,
                                               isolation=ISOLATION)
            _SESSION_LOCKS[sid] = threading.Lock()
        return sid, SESSIONS[sid], _SESSION_LOCKS[sid]


def execute_request(payload: dict) -> dict:
    code = payload.get("code", "")
    timeout = int(payload.get("timeout", 10))
    sid, tool, lock = _get_session(payload.get("session_id"), timeout)

    if POWER_GUARD.search(code or ""):
        return {"session_id": sid, "output": "Error: power expression too large.",
                "status": "error", "context": {}}

    with lock:
        tool.time_limit = timeout
        out, user_vars = tool.execute(code=code)
    status = "error" if out.startswith("Error:") else "success"
    # context values stringified like the reference (rpc_python_server.py:150-173)
    ctx = {k: repr(v) if not isinstance(v, (str, int, float, bool, type(None))) else v
           for k, v in user_vars.items()}
    return {"session_id": sid, "output": out, "status": status, "context": ctx}


class _Handler(BaseHTTPRequestHandler):
    server_version = "LaPhaToolServer/0.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/health", "/healthz"):
            self._reply(200, {"status": "ok", "sessions": len(SESSIONS)})
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):
        if self.path != "/execute":
            self._reply(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            self._reply(200, execute_request(payload))
            self._maybe_recycle()
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}", "status": "error"})

    def _maybe_recycle(self):
        srv = self.server
        limit = int(getattr(srv, "max_requests", 0) or 0)
        if not limit:
            return
        with _GLOBAL_LOCK:
            srv.request_count = getattr(srv, "request_count", 0) + 1
            if srv.request_count >= limit:
                SESSIONS.clear()
                _SESSION_LOCKS.clear()
                srv.request_count = 0


def serve(host: str = "127.0.0.1", port: int = 8001, background: bool = False,
          max_requests: int = 0, isolation: str = "thread"):
    global ISOLATION
    ISOLATION = isolation
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.max_requests = int(max_requests or 0)
    httpd.request_count = 0
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    httpd.serve_forever()
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description="LaPha tool RPC server (POST /execute)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--max-requests", type=int, default=0,
                    help="recycle all session interpreter state every N requests "
                         "(0 = never); gunicorn-style leak bound")
    ap.add_argument("--isolation", choices=["thread", "subprocess"],
                    default="thread",
                    help="subprocess: fork + RLIMIT_CPU per request — hard-kills "
                         "stuck C calls the in-thread watchdog cannot interrupt")
    args = ap.parse_args(argv)
    print(f"tool server listening on {args.host}:{args.port}")
    serve(args.host, args.port, max_requests=args.max_requests,
          isolation=args.isolation)


if __name__ == "__main__":
    main()
