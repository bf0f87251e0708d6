"""Sandboxed Python executor: AST-walking interpreter with allowlists.

Capability parity with the reference implementation's tools/local_python_executor.py
(1,744-line smolagents-style interpreter): evaluates model-generated code
node-by-node with

- an authorized-import allowlist (with submodule prefixes),
- dunder-attribute blocking,
- a hard operation-count budget (infinite-loop guard),
- safe builtins only, print capture, persistent state dicts,
- ``final_answer(...)`` raising FinalAnswerException.

This is a fresh, compact implementation of the same behavior class; it is
host-side Python (no device involvement) and is exercised by the tool RPC
server (tools/server.py) and the in-process tool (tools/interpreter.py).

A copy of ``lapha_tpu/tools/sandbox.py`` (host code; importing the JAX
package would pull in jax).
"""

from __future__ import annotations

import ast
import builtins as _builtins
import math
from typing import Any, Callable

DEFAULT_AUTHORIZED_IMPORTS = [
    "math", "cmath", "random", "re", "itertools", "functools", "collections",
    "statistics", "fractions", "decimal", "datetime", "time", "queue",
    "numpy", "sympy", "pandas", "scipy", "unicodedata", "string", "heapq", "bisect",
]

MAX_OPERATIONS = 10_000_000
MAX_WHILE_ITERS = 1_000_000


class InterpreterError(Exception):
    pass


class FinalAnswerException(Exception):
    def __init__(self, value):
        super().__init__(str(value))
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


_SAFE_BUILTIN_NAMES = [
    "abs", "all", "any", "ascii", "bin", "bool", "bytes", "callable", "chr",
    "complex", "dict", "divmod", "enumerate", "filter", "float", "format",
    "frozenset", "hash", "hex", "int", "isinstance", "issubclass", "iter",
    "len", "list", "map", "max", "min", "next", "oct", "ord", "pow", "range",
    "repr", "reversed", "round", "set", "slice", "sorted", "str", "sum",
    "tuple", "type", "zip",
    # exception types (for try/except/raise in model code)
    "BaseException", "Exception", "ArithmeticError", "AssertionError",
    "AttributeError", "FloatingPointError", "IndexError", "KeyError",
    "LookupError", "NameError", "NotImplementedError", "OverflowError",
    "RecursionError", "RuntimeError", "StopIteration", "TypeError",
    "ValueError", "ZeroDivisionError",
]


class PrintContainer:
    def __init__(self):
        self._parts: list[str] = []

    def append(self, s: str):
        self._parts.append(s)

    def __str__(self):
        return "".join(self._parts)

    def __len__(self):
        return len(str(self))


def _nodunder_getattr(obj, name: str):
    if name.startswith("__") and name.endswith("__"):
        raise InterpreterError(f"access to dunder attribute '{name}' is forbidden")
    if name.startswith("_") and name in ("_module", "_modules"):
        raise InterpreterError(f"access to '{name}' is forbidden")
    return getattr(obj, name)


class _Function:
    """User-defined function closure."""

    def __init__(self, interp: "Interpreter", node: ast.FunctionDef | ast.Lambda, closure: dict):
        self.interp = interp
        self.node = node
        self.closure = closure
        self.name = getattr(node, "name", "<lambda>")

    def __get__(self, obj, objtype=None):
        """Descriptor protocol so class-attribute functions bind as methods."""
        if obj is None:
            return self
        import functools

        return functools.partial(self, obj)

    def __call__(self, *args, **kwargs):
        node = self.node
        params = node.args
        frame: dict[str, Any] = {}

        names = [a.arg for a in params.args]
        defaults = params.defaults
        n_required = len(names) - len(defaults)
        for i, name in enumerate(names):
            if i < len(args):
                frame[name] = args[i]
            elif name in kwargs:
                frame[name] = kwargs.pop(name)
            elif i >= n_required:
                frame[name] = self.interp._eval(defaults[i - n_required], self.closure)
            else:
                raise InterpreterError(f"{self.name}() missing argument '{name}'")
        if params.vararg:
            frame[params.vararg.arg] = tuple(args[len(names):])
        elif len(args) > len(names):
            raise InterpreterError(f"{self.name}() takes {len(names)} args, got {len(args)}")
        for a, d in zip(params.kwonlyargs, params.kw_defaults):
            if a.arg in kwargs:
                frame[a.arg] = kwargs.pop(a.arg)
            elif d is not None:
                frame[a.arg] = self.interp._eval(d, self.closure)
            else:
                raise InterpreterError(f"{self.name}() missing kwonly argument '{a.arg}'")
        if params.kwarg:
            frame[params.kwarg.arg] = dict(kwargs)
        elif kwargs:
            raise InterpreterError(f"{self.name}() got unexpected kwargs {list(kwargs)}")

        scope = dict(self.closure)
        scope.update(frame)
        body = node.body if isinstance(node, ast.FunctionDef) else [ast.Return(value=node.body)]
        try:
            for stmt in body:
                self.interp._exec(stmt, scope)
        except _Return as r:
            return r.value
        return None


class Interpreter:
    def __init__(
        self,
        state: dict | None = None,
        tools: dict[str, Callable] | None = None,
        authorized_imports: list[str] | None = None,
        max_operations: int = MAX_OPERATIONS,
    ):
        self.state = state if state is not None else {}
        self.tools = tools or {}
        self.authorized_imports = list(
            DEFAULT_AUTHORIZED_IMPORTS if authorized_imports is None else authorized_imports
        )
        self.max_operations = max_operations
        self.ops = 0
        self.print_output = PrintContainer()

        self._builtins = {name: getattr(_builtins, name) for name in _SAFE_BUILTIN_NAMES}
        self._builtins["print"] = self._print
        self._builtins["getattr"] = _nodunder_getattr
        self._builtins["final_answer"] = self._final_answer

    # ------------------------------------------------------------- public

    def run(self, code: str) -> Any:
        """Execute code in persistent state; returns the last expression value."""
        self.ops = 0
        self.print_output = PrintContainer()
        try:
            tree = ast.parse(code)
        except SyntaxError as e:
            raise InterpreterError(f"SyntaxError: {e}") from e
        result = None
        for stmt in tree.body:
            if isinstance(stmt, ast.Expr):
                result = self._eval(stmt.value, self.state)
            else:
                self._exec(stmt, self.state)
                result = None
        self.state["_print_outputs"] = str(self.print_output)
        return result

    # ------------------------------------------------------------- helpers

    def _print(self, *args, sep=" ", end="\n", **kw):
        self.print_output.append(sep.join(str(a) for a in args) + end)

    def _final_answer(self, value):
        raise FinalAnswerException(value)

    def _tick(self):
        self.ops += 1
        if self.ops > self.max_operations:
            raise InterpreterError(
                f"operation budget exceeded ({self.max_operations}); possible infinite loop"
            )

    def _import_allowed(self, modname: str) -> bool:
        parts = modname.split(".")
        return any(".".join(parts[: i + 1]) in self.authorized_imports for i in range(len(parts)))

    def _lookup(self, name: str, scope: dict):
        if name in scope:
            return scope[name]
        if scope is not self.state and name in self.state:
            return self.state[name]
        if name in self.tools:
            return self.tools[name]
        if name in self._builtins:
            return self._builtins[name]
        raise InterpreterError(f"name '{name}' is not defined")

    # ------------------------------------------------------------- exec/eval

    def _exec(self, node: ast.stmt, scope: dict) -> None:
        self._tick()
        method = getattr(self, f"_exec_{type(node).__name__}", None)
        if method is None:
            raise InterpreterError(f"statement {type(node).__name__} is not allowed")
        method(node, scope)

    def _eval(self, node: ast.expr, scope: dict) -> Any:
        self._tick()
        method = getattr(self, f"_eval_{type(node).__name__}", None)
        if method is None:
            raise InterpreterError(f"expression {type(node).__name__} is not allowed")
        return method(node, scope)

    # statements ------------------------------------------------------------

    def _exec_Expr(self, node, scope):
        self._eval(node.value, scope)

    def _exec_Assign(self, node, scope):
        value = self._eval(node.value, scope)
        for tgt in node.targets:
            self._assign(tgt, value, scope)

    def _exec_AugAssign(self, node, scope):
        current = self._eval_target(node.target, scope)
        value = self._binop(node.op, current, self._eval(node.value, scope))
        self._assign(node.target, value, scope)

    def _exec_AnnAssign(self, node, scope):
        if node.value is not None:
            self._assign(node.target, self._eval(node.value, scope), scope)

    def _exec_If(self, node, scope):
        branch = node.body if self._eval(node.test, scope) else node.orelse
        for stmt in branch:
            self._exec(stmt, scope)

    def _exec_While(self, node, scope):
        iters = 0
        while self._eval(node.test, scope):
            iters += 1
            if iters > MAX_WHILE_ITERS:
                raise InterpreterError(f"while loop exceeded {MAX_WHILE_ITERS} iterations")
            try:
                for stmt in node.body:
                    self._exec(stmt, scope)
            except _Break:
                break
            except _Continue:
                continue
        else:
            for stmt in node.orelse:
                self._exec(stmt, scope)

    def _exec_For(self, node, scope):
        broke = False
        for item in self._eval(node.iter, scope):
            self._assign(node.target, item, scope)
            try:
                for stmt in node.body:
                    self._exec(stmt, scope)
            except _Break:
                broke = True
                break
            except _Continue:
                continue
        if not broke:
            for stmt in node.orelse:
                self._exec(stmt, scope)

    def _exec_Break(self, node, scope):
        raise _Break()

    def _exec_Continue(self, node, scope):
        raise _Continue()

    def _exec_Pass(self, node, scope):
        pass

    def _exec_Return(self, node, scope):
        raise _Return(self._eval(node.value, scope) if node.value else None)

    def _exec_FunctionDef(self, node, scope):
        scope[node.name] = _Function(self, node, scope)

    def _exec_ClassDef(self, node, scope):
        bases = tuple(self._eval(b, scope) for b in node.bases)
        ns = dict(scope)  # class body sees the enclosing scope
        before = dict(ns)
        for stmt in node.body:
            self._exec(stmt, ns)
        members = {k: v for k, v in ns.items()
                   if k not in before or before[k] is not v}
        cls = type(node.name, bases or (object,), members)
        scope[node.name] = cls

    def _exec_Import(self, node, scope):
        for alias in node.names:
            if not self._import_allowed(alias.name):
                raise InterpreterError(f"import of '{alias.name}' is not allowed")
            mod = __import__(alias.name)
            if alias.asname:
                for part in alias.name.split(".")[1:]:
                    mod = getattr(mod, part)
                scope[alias.asname] = mod
            else:
                scope[alias.name.split(".")[0]] = mod

    def _exec_ImportFrom(self, node, scope):
        if not self._import_allowed(node.module or ""):
            raise InterpreterError(f"import from '{node.module}' is not allowed")
        mod = __import__(node.module, fromlist=[a.name for a in node.names])
        for alias in node.names:
            if alias.name == "*":
                for k in dir(mod):
                    if not k.startswith("_"):
                        scope[k] = getattr(mod, k)
            else:
                scope[alias.asname or alias.name] = getattr(mod, alias.name)

    def _exec_Try(self, node, scope):
        try:
            for stmt in node.body:
                self._exec(stmt, scope)
        except (_Break, _Continue, _Return, FinalAnswerException, InterpreterError):
            raise
        except Exception as e:
            for handler in node.handlers:
                etype = self._eval(handler.type, scope) if handler.type else Exception
                if isinstance(e, etype):
                    if handler.name:
                        scope[handler.name] = e
                    for stmt in handler.body:
                        self._exec(stmt, scope)
                    break
            else:
                raise
        else:
            for stmt in node.orelse:
                self._exec(stmt, scope)
        finally:
            for stmt in node.finalbody:
                self._exec(stmt, scope)

    def _exec_Raise(self, node, scope):
        if node.exc is None:
            raise InterpreterError("bare raise outside except is not supported")
        exc = self._eval(node.exc, scope)
        if isinstance(exc, type) and issubclass(exc, BaseException):
            exc = exc()
        raise exc

    def _exec_Assert(self, node, scope):
        if not self._eval(node.test, scope):
            msg = self._eval(node.msg, scope) if node.msg else ""
            raise AssertionError(msg)

    def _exec_Delete(self, node, scope):
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id in scope:
                del scope[tgt.id]
            elif isinstance(tgt, ast.Subscript):
                obj = self._eval(tgt.value, scope)
                del obj[self._eval(tgt.slice, scope)]

    def _exec_Global(self, node, scope):
        pass  # flat scoping: globals are the state dict already

    # assignment helpers ----------------------------------------------------

    def _assign(self, target: ast.expr, value, scope: dict):
        if isinstance(target, ast.Name):
            scope[target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            vals = list(value)
            starred = [i for i, e in enumerate(target.elts) if isinstance(e, ast.Starred)]
            if starred:
                i = starred[0]
                before, after = target.elts[:i], target.elts[i + 1:]
                for t, v in zip(before, vals[: len(before)]):
                    self._assign(t, v, scope)
                mid = vals[len(before): len(vals) - len(after)]
                self._assign(target.elts[i].value, mid, scope)
                for t, v in zip(after, vals[len(vals) - len(after):]):
                    self._assign(t, v, scope)
            else:
                if len(vals) != len(target.elts):
                    raise InterpreterError("unpack length mismatch")
                for t, v in zip(target.elts, vals):
                    self._assign(t, v, scope)
        elif isinstance(target, ast.Subscript):
            obj = self._eval(target.value, scope)
            obj[self._eval(target.slice, scope)] = value
        elif isinstance(target, ast.Attribute):
            if target.attr.startswith("__"):
                raise InterpreterError("dunder attribute assignment forbidden")
            setattr(self._eval(target.value, scope), target.attr, value)
        else:
            raise InterpreterError(f"cannot assign to {type(target).__name__}")

    def _eval_target(self, target: ast.expr, scope: dict):
        if isinstance(target, ast.Name):
            return self._lookup(target.id, scope)
        return self._eval(target, scope)

    # expressions -----------------------------------------------------------

    def _eval_Constant(self, node, scope):
        return node.value

    def _eval_Name(self, node, scope):
        return self._lookup(node.id, scope)

    def _eval_Tuple(self, node, scope):
        return tuple(self._eval(e, scope) for e in node.elts)

    def _eval_List(self, node, scope):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Starred):
                out.extend(self._eval(e.value, scope))
            else:
                out.append(self._eval(e, scope))
        return out

    def _eval_Set(self, node, scope):
        return {self._eval(e, scope) for e in node.elts}

    def _eval_Dict(self, node, scope):
        out = {}
        for k, v in zip(node.keys, node.values):
            if k is None:
                out.update(self._eval(v, scope))
            else:
                out[self._eval(k, scope)] = self._eval(v, scope)
        return out

    _BINOPS = {
        ast.Add: lambda a, b: a + b,
        ast.Sub: lambda a, b: a - b,
        ast.Mult: lambda a, b: a * b,
        ast.Div: lambda a, b: a / b,
        ast.FloorDiv: lambda a, b: a // b,
        ast.Mod: lambda a, b: a % b,
        ast.Pow: pow,
        ast.LShift: lambda a, b: a << b,
        ast.RShift: lambda a, b: a >> b,
        ast.BitOr: lambda a, b: a | b,
        ast.BitAnd: lambda a, b: a & b,
        ast.BitXor: lambda a, b: a ^ b,
        ast.MatMult: lambda a, b: a @ b,
    }

    def _binop(self, op, a, b):
        if isinstance(op, ast.Pow):
            # guard DoS-sized exponentiations (reference rpc server regex guard)
            if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                if abs(b) > 10_000 or (isinstance(a, int) and a != 0 and abs(b) > 64
                                       and math.log10(abs(a) + 1) * abs(b) > 100_000):
                    raise InterpreterError("power expression too large")
        fn = self._BINOPS.get(type(op))
        if fn is None:
            raise InterpreterError(f"operator {type(op).__name__} not allowed")
        return fn(a, b)

    def _eval_BinOp(self, node, scope):
        return self._binop(node.op, self._eval(node.left, scope), self._eval(node.right, scope))

    def _eval_UnaryOp(self, node, scope):
        v = self._eval(node.operand, scope)
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return +v
        if isinstance(node.op, ast.Not):
            return not v
        if isinstance(node.op, ast.Invert):
            return ~v
        raise InterpreterError("unary operator not allowed")

    def _eval_BoolOp(self, node, scope):
        if isinstance(node.op, ast.And):
            v = True
            for e in node.values:
                v = self._eval(e, scope)
                if not v:
                    return v
            return v
        v = False
        for e in node.values:
            v = self._eval(e, scope)
            if v:
                return v
        return v

    _CMPOPS = {
        ast.Eq: lambda a, b: a == b,
        ast.NotEq: lambda a, b: a != b,
        ast.Lt: lambda a, b: a < b,
        ast.LtE: lambda a, b: a <= b,
        ast.Gt: lambda a, b: a > b,
        ast.GtE: lambda a, b: a >= b,
        ast.Is: lambda a, b: a is b,
        ast.IsNot: lambda a, b: a is not b,
        ast.In: lambda a, b: a in b,
        ast.NotIn: lambda a, b: a not in b,
    }

    def _eval_Compare(self, node, scope):
        left = self._eval(node.left, scope)
        for op, comp in zip(node.ops, node.comparators):
            right = self._eval(comp, scope)
            if not self._CMPOPS[type(op)](left, right):
                return False
            left = right
        return True

    def _eval_Call(self, node, scope):
        func = self._eval(node.func, scope)
        args = []
        for a in node.args:
            if isinstance(a, ast.Starred):
                args.extend(self._eval(a.value, scope))
            else:
                args.append(self._eval(a, scope))
        kwargs = {}
        for kw in node.keywords:
            if kw.arg is None:
                kwargs.update(self._eval(kw.value, scope))
            else:
                kwargs[kw.arg] = self._eval(kw.value, scope)
        if func in (_builtins.eval, _builtins.exec, _builtins.compile, _builtins.open,
                    _builtins.__import__):
            raise InterpreterError("call to forbidden builtin")
        return func(*args, **kwargs)

    def _eval_Attribute(self, node, scope):
        return _nodunder_getattr(self._eval(node.value, scope), node.attr)

    def _eval_Subscript(self, node, scope):
        return self._eval(node.value, scope)[self._eval(node.slice, scope)]

    def _eval_Slice(self, node, scope):
        return slice(
            self._eval(node.lower, scope) if node.lower else None,
            self._eval(node.upper, scope) if node.upper else None,
            self._eval(node.step, scope) if node.step else None,
        )

    def _eval_Index(self, node, scope):  # pragma: no cover (py<3.9 nodes)
        return self._eval(node.value, scope)

    def _eval_IfExp(self, node, scope):
        return self._eval(node.body, scope) if self._eval(node.test, scope) \
            else self._eval(node.orelse, scope)

    def _eval_Lambda(self, node, scope):
        return _Function(self, node, scope)

    def _eval_JoinedStr(self, node, scope):
        parts = []
        for v in node.values:
            if isinstance(v, ast.FormattedValue):
                val = self._eval(v.value, scope)
                spec = self._eval(v.format_spec, scope) if v.format_spec else ""
                if v.conversion == 114:
                    val = repr(val)
                elif v.conversion == 115:
                    val = str(val)
                parts.append(format(val, spec))
            else:
                parts.append(str(v.value))
        return "".join(parts)

    def _eval_FormattedValue(self, node, scope):
        return format(self._eval(node.value, scope))

    def _comprehend(self, generators, scope, emit):
        def rec(gens, local):
            if not gens:
                emit(local)
                return
            gen = gens[0]
            for item in self._eval(gen.iter, local):
                self._tick()
                inner = dict(local)
                self._assign(gen.target, item, inner)
                if all(self._eval(cond, inner) for cond in gen.ifs):
                    rec(gens[1:], inner)
        rec(list(generators), dict(scope))

    def _eval_ListComp(self, node, scope):
        out = []
        self._comprehend(node.generators, scope, lambda s: out.append(self._eval(node.elt, s)))
        return out

    def _eval_SetComp(self, node, scope):
        out = set()
        self._comprehend(node.generators, scope, lambda s: out.add(self._eval(node.elt, s)))
        return out

    def _eval_DictComp(self, node, scope):
        out = {}
        self._comprehend(node.generators, scope,
                         lambda s: out.__setitem__(self._eval(node.key, s), self._eval(node.value, s)))
        return out

    def _eval_GeneratorExp(self, node, scope):
        return iter(self._eval_ListComp(
            ast.ListComp(elt=node.elt, generators=node.generators), scope))

    def _eval_Starred(self, node, scope):
        return self._eval(node.value, scope)


def evaluate_python_code(
    code: str,
    state: dict | None = None,
    tools: dict | None = None,
    authorized_imports: list[str] | None = None,
) -> tuple[Any, str]:
    """One-shot helper: returns (result, printed_output)."""
    interp = Interpreter(state=state, tools=tools, authorized_imports=authorized_imports)
    result = interp.run(code)
    return result, str(interp.print_output)


class LocalPythonExecutor:
    """Persistent-state wrapper (reference local_python_executor.py:1689-1744)."""

    def __init__(self, additional_authorized_imports: list[str] | None = None,
                 tools: dict | None = None):
        imports = list(DEFAULT_AUTHORIZED_IMPORTS)
        if additional_authorized_imports:
            imports.extend(additional_authorized_imports)
        self.state: dict[str, Any] = {}
        self._interp = Interpreter(state=self.state, tools=tools, authorized_imports=imports)

    def __call__(self, code: str) -> tuple[Any, str, bool]:
        """Returns (result, logs, is_final_answer)."""
        try:
            result = self._interp.run(code)
            return result, str(self._interp.print_output), False
        except FinalAnswerException as e:
            return e.value, str(self._interp.print_output), True
