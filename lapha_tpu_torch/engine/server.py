"""Generation HTTP server over the port's engine — ``lapha_tpu/engine/server.py``.

  GET  /health                 -> {"status": "ok"}
  GET  /get_world_size         -> {"world_size": 1}   (the devices the engine uses)
  GET  /prefix_cache_stats     -> the prefix store's counters
  POST /generate               -> {"completion_ids": [[...]xN per prompt],
                                   "logprobs": [[...]], "texts": [[...]],
                                   "finish_reasons": [[...]]}
       with {"stream": true}   -> chunked NDJSON token events (delta/
                                   finish/request_done/done; see
                                   handle_generate_stream)
  POST /reset_prefix_cache     -> {"ok": true}
  POST /reload_weights {path}  -> {"ok": true, "path": ...}  (also
        /update_named_param: the trainer exports safetensors and the server
        loads them onto the engine's device with ``loader.load_params``)
  POST /start_profile, /stop_profile -> bracket a ``torch.profiler`` trace
        (CPU ops of every thread, and the card's kernels) written to log_dir

stdlib ThreadingHTTPServer. With ``continuous=True`` (the CLI's default)
concurrent /generate requests feed one :class:`~.scheduler.ContinuousEngine`
and batch together on the device; without it a lock serializes them.

``main`` is the CLI (``python -m lapha_tpu_torch.engine.server --model
DIR``): JAX's flags, plus ``--device {cuda,cpu}`` (default cuda, which raises
without a card). ``--spec-decode pld`` serves through the sync path (the
scheduler's loop does not speculate), as JAX's does. ``--sequence-parallel``
above 1 raises (not ported: ROADMAP A11).
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .adapter import SamplingParams


class EngineServer:
    def __init__(self, engine, model_dir: str | None = None,
                 continuous: bool = False, prompt_slab: int | None = None,
                 profile_dir: str | None = None, quantize: str | None = None):
        self.engine = engine
        self.model_dir = model_dir
        # a weight reload loads with the serving quantization
        self.quantize = quantize
        self.lock = threading.Lock()
        self.scheduler = None
        self.profile_dir = profile_dir
        self._profiler = None
        if continuous:
            from .scheduler import ContinuousEngine

            self.scheduler = ContinuousEngine(engine, prompt_slab=prompt_slab)
            self.scheduler.start()

    def close(self) -> None:
        if self.scheduler is not None:
            self.scheduler.stop()

    def handle_start_profile(self, payload: dict) -> dict:
        import torch
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        log_dir = payload.get("log_dir") or self.profile_dir
        if not log_dir:
            raise ValueError("no log_dir: pass {'log_dir': ...} or start "
                             "the server with --profile-dir")
        with self.lock:
            if self._profiler is not None:
                raise ValueError("a profile trace is already running")
            acts = [ProfilerActivity.CPU]
            if self.engine.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            # the scheduler and the handlers run on threads of their own
            prof = profile(activities=acts, on_trace_ready=tensorboard_trace_handler(log_dir),
                           experimental_config=torch._C._profiler._ExperimentalConfig(
                               profile_all_threads=True))
            prof.start()
            self._profiler = prof
        return {"ok": True, "log_dir": log_dir}

    def handle_stop_profile(self, payload: dict) -> dict:
        with self.lock:
            if self._profiler is None:
                raise ValueError("no profile trace is running")
            prof, self._profiler = self._profiler, None
            prof.stop()
        return {"ok": True}

    def handle_generate(self, payload: dict) -> dict:
        prompts = payload.get("prompts") or []
        if isinstance(prompts, str):
            prompts = [prompts]
        sp = self._payload_sp(payload)
        if self.scheduler is not None:
            # concurrent requests join the running device batch
            outs = self.scheduler.generate(prompts, sp)
        else:
            with self.lock:
                outs = self.engine.generate(prompts, sp)
        return {
            "completion_ids": [[o.token_ids for o in r.outputs] for r in outs],
            "logprobs": [[o.token_logprobs for o in r.outputs] for r in outs],
            "texts": [[o.text for o in r.outputs] for r in outs],
            "finish_reasons": [[o.finish_reason for o in r.outputs] for r in outs],
        }

    @staticmethod
    def _payload_sp(payload: dict) -> SamplingParams:
        return SamplingParams(
            n=int(payload.get("n", 1)),
            temperature=float(payload.get("temperature", 1.0)),
            top_p=float(payload.get("top_p", 1.0)),
            top_k=int(payload.get("top_k", -1) if payload.get("top_k") is not None else -1),
            min_p=float(payload.get("min_p", 0.0) or 0.0),
            repetition_penalty=float(payload.get("repetition_penalty", 1.0)),
            max_tokens=int(payload.get("max_tokens", 256)),
            logprobs=int(payload.get("logprobs") or 0),
            seed=payload.get("seed"),
        )

    def handle_generate_stream(self, payload: dict):
        """Iterator of NDJSON events for ``{"stream": true}`` requests.

        Continuous mode streams token deltas at decode-chunk granularity
        (scheduler.submit's stream protocol, "tag" = prompt index); the
        serializing path cannot observe mid-generation tokens, so it emits
        the finish events only. Either way the stream ends with
        {"type": "done"}.

        Every failure stays INSIDE the event stream: what can raise (submit
        validation, the sync engine.generate) runs EAGERLY in this call,
        before the caller has sent the 200 chunked headers, and a failure
        becomes {"type": "error"} followed by {"type": "done"}. On a partial
        submit failure the submitted prompts' events are drained first, so
        nothing keeps decoding into an orphaned queue.
        """
        prompts = payload.get("prompts") or []
        if isinstance(prompts, str):
            prompts = [prompts]
        sp = self._payload_sp(payload)
        if self.scheduler is None:
            try:
                with self.lock:
                    outs = self.engine.generate(prompts, sp)
            except Exception as e:  # eager: headers not sent yet
                return iter([{"type": "error", "tag": -1,
                              "error": f"{type(e).__name__}: {e}"},
                             {"type": "done"}])

            def sync_events():
                for i, r in enumerate(outs):
                    for k, o in enumerate(r.outputs):
                        yield {"type": "finish", "tag": i, "sample": k,
                               "token_ids": o.token_ids,
                               "logprobs": o.token_logprobs, "text": o.text,
                               "finish_reason": o.finish_reason}
                    yield {"type": "request_done", "tag": i}
                yield {"type": "done"}

            return sync_events()

        import queue

        q: queue.Queue = queue.Queue()
        submitted = 0
        submit_err = None
        try:
            # whole-request validation first, so the common failure
            # (n > max_batch) submits nothing
            n = max(1, int(getattr(sp, "n", 1)))
            if n > self.scheduler.B:
                raise ValueError(f"n={n} exceeds max_batch={self.scheduler.B}")
            for i, p in enumerate(prompts):
                self.scheduler.submit(p, sp, stream=(q, i))
                submitted += 1
        except Exception as e:
            submit_err = f"{type(e).__name__}: {e}"

        def events():
            pending = submitted
            while pending > 0:
                ev = q.get()
                yield ev
                if ev.get("type") in ("request_done", "error"):
                    pending -= 1
            if submit_err is not None:
                yield {"type": "error", "tag": submitted, "error": submit_err}
            yield {"type": "done"}

        return events()

    def handle_reload_weights(self, payload: dict) -> dict:
        from ..models import loader

        path = payload.get("path") or self.model_dir
        if not path:
            raise ValueError("reload_weights requires a path")
        eng = self.engine
        params, _cfg = loader.load_params(path, dtype=eng.cfg.dtype, device=eng.device,
                                          quantize=self.quantize)
        with self.lock:
            # under the running scheduler the swap waits for the chunk in
            # flight (which keeps the old tensors alive until it ends); the
            # next chunk uses the new weights, and the prefix store is cleared
            if self.scheduler is not None:
                with self.scheduler.step_lock:
                    eng.update_params(params)
            else:
                eng.update_params(params)
        return {"ok": True, "path": path}


def make_handler(server: EngineServer):
    class Handler(BaseHTTPRequestHandler):
        server_version = "LaPhaEngineServer/0.1"

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_stream(self, events):
            """Chunked transfer encoding, one NDJSON event per chunk."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for ev in events:
                data = (json.dumps(ev) + "\n").encode()
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")

        def do_GET(self):
            if self.path in ("/health", "/health/"):
                self._reply(200, {"status": "ok"})
            elif self.path == "/get_world_size":
                # one engine on one device (multi-device serving: ROADMAP A11)
                self._reply(200, {"world_size": 1})
            elif self.path == "/prefix_cache_stats":
                pc = server.engine.prefix_cache
                self._reply(200, pc.stats() if pc else {})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/generate":
                    if payload.get("stream"):
                        # handle_generate_stream raises only before any event
                        # exists (the except below then sends a clean 500);
                        # once the chunked 200 is on the wire a transport
                        # error must not fall through to _reply
                        events = server.handle_generate_stream(payload)
                        try:
                            self._reply_stream(events)
                        except (BrokenPipeError, ConnectionError):
                            self.close_connection = True
                    else:
                        self._reply(200, server.handle_generate(payload))
                elif self.path == "/reset_prefix_cache":
                    if server.engine.prefix_cache is not None:
                        server.engine.prefix_cache.clear()
                    self._reply(200, {"ok": True})
                elif self.path in ("/reload_weights", "/update_named_param"):
                    self._reply(200, server.handle_reload_weights(payload))
                elif self.path == "/start_profile":
                    self._reply(200, server.handle_start_profile(payload))
                elif self.path == "/stop_profile":
                    self._reply(200, server.handle_stop_profile(payload))
                else:
                    self._reply(404, {"error": "not found"})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    """The HTTP server of one :class:`EngineServer` (``engine_server``);
    ``shutdown`` also closes the socket and stops the scheduler."""

    def __init__(self, address, srv: EngineServer):
        super().__init__(address, make_handler(srv))
        self.engine_server = srv

    def shutdown(self):
        super().shutdown()
        self.server_close()
        self.engine_server.close()


def serve(engine, host: str = "127.0.0.1", port: int = 8000,
          model_dir: str | None = None, background: bool = False,
          continuous: bool = False, prompt_slab: int | None = None,
          profile_dir: str | None = None, quantize: str | None = None):
    """Serve ``engine`` over HTTP. ``background=True`` returns the running
    server at once (see :class:`_HTTPServer`); otherwise this call serves
    until interrupted."""
    srv = EngineServer(engine, model_dir, continuous=continuous,
                       prompt_slab=prompt_slab, profile_dir=profile_dir, quantize=quantize)
    httpd = _HTTPServer((host, port), srv)
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="EngineServer").start()
        return httpd
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.close()
    return httpd


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="LaPha generation server (PyTorch/CUDA port)")
    ap.add_argument("--model", required=True, help="HF model dir")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-model-len", type=int, default=4096)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--quantize", choices=["int8", "int4"], default=None,
                    help="weight-only int8, or group-128 int4 projections "
                         "through the int4 matmul kernel")
    ap.add_argument("--no-continuous-batching", action="store_true",
                    help="serialize requests instead of cross-request batching")
    ap.add_argument("--prompt-slab", type=int, default=None,
                    help="continuous mode: max prompt length (default len/2)")
    ap.add_argument("--kv-quant", choices=["int8"], default=None,
                    help="int8 KV cache with per-vector scales")
    ap.add_argument("--spec-decode", choices=["pld"], default=None,
                    help="prompt-lookup speculative decoding (serves through the "
                         "sync path)")
    ap.add_argument("--sequence-parallel", type=int, default=0,
                    help="sequence-parallel serving over devices (not ported: "
                         "above 1 raises)")
    ap.add_argument("--profile-dir", default=None,
                    help="default log dir for the /start_profile + "
                         "/stop_profile torch.profiler trace endpoints")
    # the port's device: the card unless the CPU is asked for
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap


def main(argv=None, *, tokenizer_override=None, background: bool = False):
    """The server CLI. ``tokenizer_override`` replaces the tokenizer read
    from ``--model``; ``background=True`` returns the running server
    (see :func:`serve`) instead of serving in this thread."""
    args = build_parser().parse_args(argv)

    from ..models import loader
    from ..models.loader import _device
    from .engine import Engine

    device = _device(args.device, "engine.server (--device)")
    if args.spec_decode:
        # the scheduler's chunked loop does not speculate; spec serving uses
        # the sync engine path
        args.no_continuous_batching = True
    if args.sequence_parallel > 1:
        raise ValueError("--sequence-parallel above 1: not yet ported (ROADMAP A11)")
    if tokenizer_override is not None:
        tokenizer = tokenizer_override
    else:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model, trust_remote_code=True)
        if tokenizer.pad_token is None:
            tokenizer.pad_token = tokenizer.eos_token
    params, cfg = loader.load_params(args.model, device=device, quantize=args.quantize)
    engine = Engine(params, cfg, tokenizer, max_model_len=args.max_model_len,
                    max_batch=args.max_batch, kv_quant=args.kv_quant,
                    spec_decode=args.spec_decode, device=device)
    httpd = serve(engine, args.host, args.port, model_dir=args.model, background=True,
                  continuous=not args.no_continuous_batching, prompt_slab=args.prompt_slab,
                  profile_dir=args.profile_dir, quantize=args.quantize)
    print(f"engine server on {args.host}:{httpd.server_address[1]} (model {args.model}, "
          f"{device})", flush=True)
    if background:
        return httpd
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
    return httpd


if __name__ == "__main__":
    main()
