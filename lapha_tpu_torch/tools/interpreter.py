"""In-process python interpreter tool + the agent-facing tool function.

Parity with the reference implementation's tools/python_code_interpreter.py (IPythonInterpreter
Tool with timeout + power guard + variable formatting, 290-520) and
remote_python_code_interpreter.py (the `execute_python_code` signature agents
call: (code, context) -> (output_str, new_context), output truncated).

A copy of ``lapha_tpu/tools/interpreter.py`` (host code; importing the JAX
package would pull in jax).
"""

from __future__ import annotations

import re
import signal
import threading
from .sandbox import FinalAnswerException, Interpreter, InterpreterError
from .tool_base import Tool

POWER_GUARD = re.compile(r"\*\*\s*\d{5,}|pow\s*\(\s*\d+\s*,\s*\d{5,}")

_MAX_REPR_LEN = 256
_MAX_OUTPUT = 1024


class _Timeout:
    """SIGALRM on the main thread; async-exception watchdog elsewhere.

    Off the main thread (the tool RPC server runs handlers in
    ThreadingHTTPServer threads) a watchdog timer injects TimeoutError into
    the executing thread via PyThreadState_SetAsyncExc. That interrupts at
    the next bytecode boundary — pure-Python loops and the AST interpreter
    are covered; a single long-running C call (e.g. one huge sympy op)
    cannot be interrupted, which the op budget and power guard mitigate.
    """

    def __init__(self, seconds: int):
        self.seconds = seconds
        self._main = threading.current_thread() is threading.main_thread()
        self._old = None
        self._timer = None

    def __enter__(self):
        if self.seconds <= 0:
            return self
        if self._main:
            def handler(signum, frame):
                raise TimeoutError(f"execution exceeded {self.seconds}s")

            self._old = signal.signal(signal.SIGALRM, handler)
            signal.alarm(self.seconds)
        else:
            import ctypes

            tid = threading.get_ident()

            def fire():
                ctypes.pythonapi.PyThreadState_SetAsyncExc(
                    ctypes.c_ulong(tid), ctypes.py_object(TimeoutError))

            self._timer = threading.Timer(self.seconds, fire)
            self._timer.daemon = True
            self._timer.start()
        return self

    def __exit__(self, *exc):
        if self.seconds <= 0:
            return False
        if self._main:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._old)
        elif self._timer is not None:
            self._timer.cancel()
        return False


def format_variables(state: dict, max_len: int = _MAX_REPR_LEN) -> str:
    """Depth/length-limited pretty print of user variables."""
    lines = []
    for k, v in state.items():
        if k.startswith("_"):
            continue
        r = repr(v)
        if len(r) > max_len:
            r = r[: max_len] + "...<truncated>"
        lines.append(f"Var: {k}; Type: {type(v).__name__}\n{r}")
    return "\n".join(lines)


class IPythonInterpreter(Tool):
    name = "execute_python_code"
    description = (
        "Execute a snippet of Python code in a persistent sandboxed session "
        "and return printed output plus the session variables."
    )
    parameters = {
        "type": "object",
        "properties": {
            "code": {"type": "string", "description": "Python code to execute."},
        },
        "required": ["code"],
    }

    def __init__(self, time_limit: int = 10, state: dict | None = None,
                 isolation: str = "thread", mem_limit_bytes: int = 2 << 30):
        """isolation="thread" (default): in-process with the async-exception
        watchdog — cannot interrupt a single long C call (sympy.factorint).
        isolation="subprocess": each execute() forks a child with RLIMIT_CPU
        (+RLIMIT_AS) so the kernel hard-kills stuck C calls — the isolation
        class the reference gets from gunicorn worker recycling
        (rpc_python_server.py:175-178), without waiting for the recycle.
        Session state persists via fork-in / pickle-back (unpicklable
        variables survive the call but lose child-side mutations)."""
        self.time_limit = int(time_limit)
        if isolation not in ("thread", "subprocess"):
            raise ValueError(f"unknown isolation {isolation!r}")
        self.isolation = isolation
        self.mem_limit_bytes = int(mem_limit_bytes)
        self.interp = Interpreter(state=state if state is not None else {})

    @property
    def state(self) -> dict:
        return self.interp.state

    def _run_inline(self, code: str) -> str:
        try:
            with _Timeout(self.time_limit):
                result = self.interp.run(code)
            printed = str(self.interp.print_output)
            out = printed
            if result is not None:
                out = (out + ("\n" if out and not out.endswith("\n") else "") + repr(result))
            if not out.strip():
                out = format_variables(self.interp.state) or "(no output)"
        except FinalAnswerException as e:
            out = f"final_answer: {e.value}"
        except (InterpreterError, TimeoutError, Exception) as e:
            out = f"Error: {type(e).__name__}: {e}"
        return out

    def _run_subprocess(self, code: str) -> str:
        import multiprocessing as mp
        import pickle

        ctx = mp.get_context("fork")  # child inherits the session state
        parent, child = ctx.Pipe(duplex=False)

        def worker(conn):
            import resource

            cpu = max(1, self.time_limit)
            resource.setrlimit(resource.RLIMIT_CPU, (cpu, cpu + 1))
            if self.mem_limit_bytes > 0:
                try:
                    resource.setrlimit(resource.RLIMIT_AS,
                                       (self.mem_limit_bytes, self.mem_limit_bytes))
                except (ValueError, OSError):
                    pass
            out = self._run_inline(code)
            safe_vars = {}
            for k, v in self.interp.state.items():
                if k.startswith("_"):
                    continue
                try:
                    pickle.dumps(v)
                    safe_vars[k] = v
                except Exception:
                    pass
            conn.send((out, safe_vars))
            conn.close()

        proc = ctx.Process(target=worker, args=(child,), daemon=True)
        proc.start()
        child.close()
        # wall-clock guard on top of the child's CPU rlimit (sleeps etc.)
        try:
            if parent.poll(self.time_limit + 2):
                out, safe_vars = parent.recv()
                self.interp.state.update(safe_vars)
            else:
                out = f"Error: TimeoutError: execution exceeded {self.time_limit}s (killed)"
        except (EOFError, OSError):
            # the kernel killed the child (CPU rlimit / OOM) before it replied
            out = (f"Error: TimeoutError: execution exceeded {self.time_limit}s "
                   "of CPU (killed by resource limit)")
        proc.join(timeout=1)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=5)
        parent.close()
        return out

    def execute(self, code: str, context: dict | None = None, **kw) -> tuple[str, dict]:
        if POWER_GUARD.search(code or ""):
            return "Error: power expression too large.", dict(context or {})
        if context:
            for k, v in context.items():
                self.interp.state.setdefault(k, v)
        if self.isolation == "subprocess":
            out = self._run_subprocess(code)
        else:
            out = self._run_inline(code)
        if len(out) > _MAX_OUTPUT:
            out = out[:_MAX_OUTPUT] + "...<truncated>"
        user_vars = {k: v for k, v in self.interp.state.items() if not k.startswith("_")}
        return out, user_vars


def execute_python_code(code: str, context: dict | None = None,
                        time_limit: int = 10) -> tuple[str, dict]:
    """The tool function agents call (fresh session per call, context seeded).

    Output truncated to 512 chars like the remote client
    (remote_python_code_interpreter.py:31-34).
    """
    tool = IPythonInterpreter(time_limit=time_limit, state=dict(context or {}))
    out, new_ctx = tool.execute(code=code)
    if len(out) > 512:
        out = out[:512] + "...<truncated>"
    return out, new_ctx


description = [
    {
        "type": "function",
        "function": {
            "name": "execute_python_code",
            "description": (
                "Execute Python code in a sandboxed interpreter with persistent "
                "session variables. Returns printed output and updated variables. "
                "Allowed imports: math, numpy, sympy, pandas, itertools, ..."
            ),
            "parameters": {
                "type": "object",
                "properties": {
                    "code": {"type": "string", "description": "The Python code to run."},
                },
                "required": ["code"],
            },
        },
    }
]
