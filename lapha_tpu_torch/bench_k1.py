"""Time builds of the flash-attention forward (K1/K3) from several sources, in
turns, on one card.

    python3 -m lapha_tpu_torch.bench_k1 A/flash_attention.cu B/flash_attention.cu ...

Each source (for example the file of an unpacked parent checkout beside the
working tree's) is compiled by its own ``nvcc``, all started together, with
the package's flags into a library of its own under ``_build/bench_k1/``
(``bench_k2.compile_sources``); ``common.cuh`` is taken from the source's
directory if it has one, else from the package. A source whose C entry
takes no ``dv`` (those written before V could be narrower than Q/K) is
called without it and skips the narrow-V shapes.

The shapes are those of ``chip_smoke.py``'s forward checks: phase 1's K3
(fresh prefill B=4 T=512 S=640 and suffix prefill T=128 at qstart 512, 12/2
heads of dim 128) and K1 (B=4 T=512), phase 1e's windowed K3 at dh 64 (64/8
heads, W=128; K3 also as a suffix of T=64 at qstart 512, and K1), phase 1f's
K3 and K1 at dh 256 (Gemma-2's 8/4 heads with the cap of 50; Gemma-3's 4/1
heads, full and at its window of 512), phase 1j's narrow-V K3 and K1 (Q/K
192, V 128, 16/16 heads) and phase 1l's dh-96 rows (Phi-3's 32/32 heads at
its window of 2047: K3 B=4 T=512 S=640, K1 B=4 T=512, and K3 banded past the
window, B=2 T=512 S=2560 at qstart 2048). Every build's output is held to
the plain version at the smoke script's limit first, and launched twice it
must give the same bits. Then each shape is timed with CUDA events (20
launches a reading) in rounds that visit the builds in order and back (A B C
C B A), three rounds, and the mean of each build's six readings is printed
beside its ratio to the first build's, with the card's name and power limit.
One PyTorch call computing the same attention is timed in the same rounds as
a yardstick (``library``: SDPA with the boolean mask, its cuDNN backend
where V is narrower than Q/K; none for the softcapped shapes). ptxas's
register and spill lines of each build are printed too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

from lapha_tpu_torch.bench_k2 import ROUNDS, _time_ms, compile_sources
from lapha_tpu_torch.ops import flash_attention as fa

KERNEL_ATOL = 3e-2  # chip_smoke.py's limit
# (label, B, T, S, qstart, heads, KV heads, head dim of Q/K, of V, window, softcap, q scaled by)
SHAPES = (("1 K3 dh128 12/2", 4, 512, 640, 0, 12, 2, 128, 128, 0, 0.0, 1.0),
          ("1 K3 suffix dh128 12/2", 4, 128, 768, 512, 12, 2, 128, 128, 0, 0.0, 1.0),
          ("1 K1 dh128 12/2", 4, 512, 512, 0, 12, 2, 128, 128, 0, 0.0, 1.0),
          ("1e K3 dh64 64/8 W=128", 4, 512, 640, 0, 64, 8, 64, 64, 128, 0.0, 1.0),
          ("1e K3 suffix dh64 64/8 W=128", 4, 64, 640, 512, 64, 8, 64, 64, 128, 0.0, 1.0),
          ("1e K1 dh64 64/8 W=128", 4, 512, 512, 0, 64, 8, 64, 64, 128, 0.0, 1.0),
          ("1f K3 dh256 8/4 cap50", 4, 512, 640, 0, 8, 4, 256, 256, 0, 50.0, 25.0),
          ("1f K1 dh256 8/4 cap50", 4, 512, 512, 0, 8, 4, 256, 256, 0, 50.0, 25.0),
          ("1f K3 dh256 4/1", 4, 512, 640, 0, 4, 1, 256, 256, 0, 0.0, 1.0),
          ("1f K3 dh256 4/1 W=512", 4, 512, 640, 0, 4, 1, 256, 256, 512, 0.0, 1.0),
          ("1f K1 dh256 4/1", 4, 512, 512, 0, 4, 1, 256, 256, 0, 0.0, 1.0),
          ("1f K1 dh256 4/1 W=512", 4, 512, 512, 0, 4, 1, 256, 256, 512, 0.0, 1.0),
          ("1j K3 192/128 16/16", 4, 512, 640, 0, 16, 16, 192, 128, 0, 0.0, 1.0),
          ("1j K3 suffix 192/128 16/16", 4, 64, 640, 512, 16, 16, 192, 128, 0, 0.0, 1.0),
          ("1j K1 192/128 16/16", 4, 512, 512, 0, 16, 16, 192, 128, 0, 0.0, 1.0),
          ("1l K3 dh96 32/32 W=2047", 4, 512, 640, 0, 32, 32, 96, 96, 2047, 0.0, 1.0),
          ("1l K1 dh96 32/32 W=2047", 4, 512, 512, 0, 32, 32, 96, 96, 2047, 0.0, 1.0),
          ("1l K3 dh96 32/32 W=2047 past the window", 2, 512, 2560, 2048, 32, 32, 96, 96, 2047,
           0.0, 1.0))


def _build(srcs: list[str]) -> list[tuple[ctypes.CDLL, bool, str]]:
    """(library, takes a dv, ptxas report) of each source."""
    libs = []
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for text, so, report in compile_sources(srcs, "bench_k1"):
        has_dv = re.search(r"lapha_flash_fwd\([^)]*int dh, int dv", text) is not None
        dll = ctypes.CDLL(so)
        dll.lapha_flash_fwd.argtypes = [P] * 7 + [I] * (8 if has_dv else 7) + [F, F, P]
        dll.lapha_flash_fwd.restype = I
        libs.append((dll, has_dv, report))
    return libs


def _call(dll, has_dv: bool, q, k, v, kv_valid, qs, scale, window, softcap):
    """One build's forward on the kernels' arguments, as a closure."""
    B, T, nh, dh = q.shape
    S, nkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, T, nh, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, nh, T), dtype=torch.float32, device=q.device)
    dims = (dh, dv) if has_dv else (dh,)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = dll.lapha_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
                                  qs.data_ptr(), out.data_ptr(), lse.data_ptr(), B, T, S, nh, nkv,
                                  *dims, window, float(scale), float(softcap), stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    return run


def _library(q, k, v, kv_valid, qs, scale, window, softcap):
    """One PyTorch call computing the same attention (SDPA with the boolean
    mask; its cuDNN backend where V is narrower than Q/K), or None: the
    softcap has no one call without a compile. Timed only as a yardstick."""
    if softcap:
        return None
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    T, S = q.shape[1], k.shape[1]
    qpos = qs[:, None, None] + torch.arange(T, device=q.device)[None, :, None]
    kpos = torch.arange(S, device=q.device)[None, None, :]
    allowed = (kv_valid[:, None, :] > 0) & (kpos <= qpos)
    if window > 0:
        allowed &= kpos > qpos - window
    qt, kt, vt, m = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), allowed[:, None]
    narrow = v.shape[-1] < q.shape[-1]

    def run():
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]) if narrow else contextlib.nullcontext():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, scale=scale,
                                                  enable_gqa=True)

    try:
        run()
        torch.cuda.synchronize()
    except RuntimeError:  # no backend takes these inputs
        return None
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="flash_attention.cu files, the first the base")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_k1: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs = _build(args.sources)
    # a build is named by its source's directory in the timing lines
    names = [os.path.basename(os.path.dirname(os.path.abspath(s))) for s in args.sources]
    for name, src, (_, has_dv, report) in zip(names, args.sources, libs):
        print(f"== {name}: {src} (dv argument: {has_dv})\n{report}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def bf16(*shape, sd=1.0):
        return torch.from_numpy((rng.normal(size=shape) * sd).astype(np.float32)).to(
            dev, torch.bfloat16)

    for label, B, T, S, qstart, nh, nkv, dh, dv, window, cap, q_sd in SHAPES:
        q, k, v = bf16(B, T, nh, dh, sd=q_sd), bf16(B, S, nkv, dh), bf16(B, S, nkv, dv)
        lens = torch.tensor([qstart + T, qstart + T - 17, qstart + T - 40, qstart + T],
                            device=dev)[:B]
        kv_valid = (torch.arange(S, device=dev)[None, :] < lens[:, None]).to(torch.int32)
        qs = torch.full((B,), qstart, dtype=torch.int32, device=dev)
        scale = 1.0 / 16 if dh == 256 else dh ** -0.5
        ref = fa.attention_plain(q, k, v, kv_valid, qs, scale, window, softcap=cap)[0].float()
        builds = []
        for build, (dll, has_dv, _) in zip(names, libs):
            if dv != dh and not has_dv:
                continue
            run = _call(dll, has_dv, q, k, v, kv_valid, qs, scale, window, cap)
            first = run().clone()
            err = float((first.float() - ref).abs().max())
            again = run()
            torch.cuda.synchronize()
            if not err <= KERNEL_ATOL:
                raise SystemExit(f"{build} {label}: max|diff| {err}")
            if not torch.equal(first, again):
                raise SystemExit(f"{build} {label}: two launches differ")
            builds.append((build, run))
        lib = _library(q, k, v, kv_valid, qs, scale, window, cap)
        timed = builds + ([("library", lib)] if lib is not None else [])
        times = {build: [] for build, _ in timed}
        order = timed + timed[::-1]
        for _ in range(ROUNDS):
            for build, run in order:
                times[build].append(_time_ms(run))
        base = sum(times[builds[0][0]]) / len(times[builds[0][0]])
        cells = []
        for build, _ in timed:
            ms = sum(times[build]) / len(times[build])
            cells.append(f"{build} {ms:.4f} ms ({ms / base:.3f}x, readings "
                         f"{min(times[build]):.4f}-{max(times[build]):.4f})")
        print(f"{label}: " + "; ".join(cells) + f" [{card}]", flush=True)
        del q, k, v, ref, builds, timed, lib
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
