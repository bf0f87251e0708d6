"""Build, load and count the port's CUDA kernels.

The sources in ``lapha_tpu_torch/csrc/*.cu`` have a plain C interface. On
first use each is compiled by its own ``nvcc`` process for ``sm_90a``, all
started together, and the objects are linked into one shared library under
``lapha_tpu_torch/_build/`` (named by a hash of the sources and flags, so an
edit rebuilds), loaded with ``ctypes``. Nothing here runs at import time:
the CPU tests import every module on machines that have no ``nvcc``.

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
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")

# the attention kernels count windowed, softcapped and narrow-V launches apart
LAUNCHES = {name + cap: 0
            for name in ("flash_attention", "flash_attention_cached", "flash_attention_window",
                         "flash_attention_cached_window", "flash_attention_narrowv",
                         "flash_attention_cached_narrowv", "flash_attention_narrowv_window",
                         "flash_attention_cached_narrowv_window", "ragged_decode_attention",
                         "ragged_decode_attention_q8", "ragged_decode_attention_sink",
                         "ragged_decode_attention_q8_sink", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv", "flash_attention_bwd_dq_window",
                         "flash_attention_bwd_dkv_window", "flash_attention_bwd_dq_narrowv",
                         "flash_attention_bwd_dkv_narrowv", "flash_attention_bwd_dq_narrowv_window",
                         "flash_attention_bwd_dkv_narrowv_window")
            for cap in ("", "_softcap")}
LAUNCHES.update({name: 0 for name in (
    "int4_matmul", "grouped_gemm", "grouped_gemm_wg", "grouped_gemm_dx", "grouped_gemm_tgmm")})

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
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, f"{os.path.basename(s)}.o") for s in srcs]
        build_log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)])
        build_log += _run([[nvcc, "-shared", "-o", os.path.join(tmp, "lib.so"), *objs]])
        os.replace(os.path.join(tmp, "lib.so"), so)
    return so


def _run(cmds: list[list[str]]) -> str:
    """Run the commands together; their joined output, or raise with it
    once all have ended if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed with code {p.returncode}:\n{' '.join(c)}\n{out}"
              for c, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(build())
        # the last float of the attention entries is the softcap (0 = off);
        # the forward's ints: B T S nh nkv dh dv window
        dll.lapha_flash_fwd.argtypes = [_P, _P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
        dll.lapha_flash_fwd.restype = _I
        # the decode entries end with the plan: splits, stages
        dll.lapha_ragged_decode.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _P,
                                            _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]
        dll.lapha_ragged_decode.restype = _I
        dll.lapha_ragged_decode_q8.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                                               _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]
        dll.lapha_ragged_decode_q8.restype = _I
        dll.lapha_ragged_decode_sink.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P,
                                                 _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]
        dll.lapha_ragged_decode_sink.restype = _I
        dll.lapha_ragged_decode_q8_sink.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                                    _P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P]
        dll.lapha_ragged_decode_q8_sink.restype = _I
        # x packed scales out, then B IN OUT G, the plan: rows, columns, splits
        dll.lapha_int4_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        dll.lapha_int4_matmul.restype = _I
        # ints: M K N G, then 1 for the wgmma kernel, 0 for the decode kernel,
        # then the decode kernel's grid
        dll.lapha_grouped_gemm.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        dll.lapha_grouped_gemm.restype = _I
        for entry in (dll.lapha_grouped_gemm_dx, dll.lapha_grouped_gemm_tgmm):
            entry.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
            entry.restype = _I
        bwd = [_P, _P, _P, _P, _P, _P, _P, _P]  # q k v dout lse delta kv_valid qstart
        # ... then the outputs, B T S nh nkv dh dv window, scale, softcap, stream
        dll.lapha_flash_bwd_dq.argtypes = bwd + [_P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P]
        dll.lapha_flash_bwd_dq.restype = _I
        # dk/dv: dk dv work, the ints, scale, softcap, splits, stream
        dll.lapha_flash_bwd_dkv.argtypes = bwd + [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                                                  _F, _F, _I, _P]
        dll.lapha_flash_bwd_dkv.restype = _I
        dll.lapha_error_string.argtypes = [_I]
        dll.lapha_error_string.restype = ctypes.c_char_p
        _lib = dll
    return _lib


def check_launch(err: int, name: str) -> None:
    """Raise if the launch was refused (cudaGetLastError right after it)."""
    if err != 0:
        msg = lib().lapha_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def sm_count(device: torch.device) -> int:
    """The card's SM count, which the kernels' grid plans fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def require_cuda(name: str, device: torch.device, dtype: torch.dtype, *, aligned: bool,
                 **tensors: torch.Tensor) -> None:
    """Contiguous tensors of ``dtype`` on one CUDA device; ``aligned`` for
    those the kernel reads with 16-byte loads."""
    for key, t in tensors.items():
        require(t.device == device, name, f"{key} is on {t.device}, expected {device}")
        require(t.dtype == dtype, name, f"{key} must be {dtype}, got {t.dtype}")
        require(t.is_contiguous(), name, f"{key} must be contiguous")
        require(not aligned or t.data_ptr() % 16 == 0, name, f"{key} must be 16-byte aligned")


def require_cuda_bf16(name: str, device: torch.device, **tensors: torch.Tensor) -> None:
    """The kernels take contiguous bf16 tensors on one CUDA device, 16-byte aligned."""
    require_cuda(name, device, torch.bfloat16, aligned=True, **tensors)


def int32_on(t, device: torch.device, shape: tuple) -> torch.Tensor:
    """Index/validity arguments as contiguous int32 on ``device`` (bool masks
    and int64 lengths are converted, as the JAX wrappers cast them)."""
    out = torch.as_tensor(t, device=device).to(torch.int32).contiguous()
    if tuple(out.shape) != shape:
        raise ValueError(f"expected shape {shape}, got {tuple(out.shape)}")
    return out
