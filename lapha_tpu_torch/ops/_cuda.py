"""Build, load and count the port's CUDA kernels.

The sources in ``lapha_tpu_torch/csrc/*.cu`` have a plain C interface. On
first use they are compiled together by ``nvcc`` for ``sm_90a`` into one
shared library under ``lapha_tpu_torch/_build/`` (named by a hash of the
sources and flags, so an edit rebuilds) and loaded with ``ctypes``. Nothing
here runs at import time: the CPU tests import every module on machines
that have no ``nvcc``.

``LAUNCHES`` counts, per wrapper, the kernel launches it made; a wrapper adds
one right after its launch and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")

LAUNCHES = {"flash_attention": 0, "flash_attention_cached": 0,
            "ragged_decode_attention": 0}

_lib = None
build_log = ""  # nvcc's output of the build this process ran (ptxas register/smem report)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source on first use")
    return found


def build() -> str:
    """Compile csrc/*.cu into the shared library if it is not built yet;
    returns its path. Raises with the compiler's output on failure."""
    global build_log
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    deps = srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in deps:
        with open(p, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"liblapha_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    build_log = res.stdout + res.stderr
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(build())
        dll.lapha_flash_fwd.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _F, _P]
        dll.lapha_flash_fwd.restype = _I
        dll.lapha_ragged_decode.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _P,
                                            _I, _I, _I, _I, _I, _F, _P]
        dll.lapha_ragged_decode.restype = _I
        dll.lapha_error_string.argtypes = [_I]
        dll.lapha_error_string.restype = ctypes.c_char_p
        _lib = dll
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if the launch was refused (cudaGetLastError right after it)."""
    if err != 0:
        msg = lib().lapha_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def require_cuda_bf16(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """The kernels take contiguous bf16 tensors on one CUDA device, 16-byte aligned."""
    for key, t in tensors.items():
        require(t.device == device, name, f"{key} is on {t.device}, expected {device}")
        require(t.dtype == torch.bfloat16, name, f"{key} must be bfloat16, got {t.dtype}")
        require(t.is_contiguous(), name, f"{key} must be contiguous")
        require(t.data_ptr() % 16 == 0, name, f"{key} must be 16-byte aligned")


def int32_on(t, device: torch.device, shape: tuple) -> torch.Tensor:
    """Index/validity arguments as contiguous int32 on ``device`` (bool masks
    and int64 lengths are converted, as the JAX wrappers cast them)."""
    out = torch.as_tensor(t, device=device).to(torch.int32).contiguous()
    if tuple(out.shape) != shape:
        raise ValueError(f"expected shape {shape}, got {tuple(out.shape)}")
    return out
