"""The Python tool: a sandboxed interpreter, its tool wrapper, an RPC server
and its client. A copy of ``lapha_tpu/tools/`` (host code).
"""

from .client import execute_python_code, description
from .interpreter import IPythonInterpreter, format_variables
from .sandbox import (
    FinalAnswerException,
    Interpreter,
    InterpreterError,
    LocalPythonExecutor,
    evaluate_python_code,
)
from .tool_base import Tool

__all__ = [
    "execute_python_code",
    "description",
    "IPythonInterpreter",
    "format_variables",
    "FinalAnswerException",
    "Interpreter",
    "InterpreterError",
    "LocalPythonExecutor",
    "evaluate_python_code",
    "Tool",
]
