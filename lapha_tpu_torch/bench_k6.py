"""Time builds of the int4 dequant-matmul (K6) from several sources, in
turns, on one card.

    python3 -m lapha_tpu_torch.bench_k6 A/int4_matmul.cu B/int4_matmul.cu ...

Each source (for example the file of an unpacked parent checkout beside the
working tree's) is compiled by its own ``nvcc``, all started together, with
the package's flags into a library of its own under ``_build/bench_k6/``
(``bench_k2.compile_sources``); ``common.cuh`` is taken from the source's
directory if it has one, else from the package. A source whose C entry
takes the plan (``int splits``: the split in-dim) is launched with
``int4_matmul.split_plan``'s; an older one with its own fixed grid.

The shapes are those of ``chip_smoke.py``'s phase 1c: Qwen2.5-1.5B's
projections at 48 decode rows (1536 -> 1536, 1536 -> 256, 1536 -> 8960,
8960 -> 1536) and 512 rows (1536 -> 8960), group 128, weights N(0, 1)
quantized by ``models.quant.quantize_weight_int4``. Every build's output is
held to the plain version at the smoke script's limit (max |diff| <= 1e-3 ·
max |plain|) first, and a build with the split is launched twice and must
give bit-equal outputs. Then each build, and one PyTorch call computing the
same product (``torch._weight_int4pack_mm`` on the same nibbles, weights
converted once), is timed by :func:`graph_ms` (20 calls a reading) in rounds
that visit them in order and back (A B lib lib B A), three rounds; the mean
of each one's six readings is printed beside its ratio to the first build's
and the byte bound, with the card's name and power limit. ptxas's register
and spill lines of each build are printed too.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from lapha_tpu_torch.bench_k2 import ROUNDS, compile_sources
from lapha_tpu_torch.models import quant
from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import int4_matmul as i4

INT4_RTOL = 1e-3  # chip_smoke.py's K6 limit
HBM_BYTES_PER_S = 3.35e12
GROUP = 128
# (label, rows, IN, OUT)
SHAPES = (("q/o 48 x 1536 -> 1536", 48, 1536, 1536),
          ("k/v 48 x 1536 -> 256", 48, 1536, 256),
          ("gate/up 48 x 1536 -> 8960", 48, 1536, 8960),
          ("down 48 x 8960 -> 1536", 48, 8960, 1536),
          ("prefill gate/up 512 x 1536 -> 8960", 512, 1536, 8960))


def _build(srcs: list[str]) -> list[tuple[ctypes.CDLL, bool, str]]:
    """(library, its entry takes the split plan, ptxas report) of each source."""
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = []
    for text, so, report in compile_sources(srcs, "bench_k6"):
        split = re.search(r"lapha_int4_matmul\([^)]*int splits", text) is not None
        dll = ctypes.CDLL(so)
        dll.lapha_int4_matmul.argtypes = [P] * 4 + [I] * (7 if split else 4) + [P]
        dll.lapha_int4_matmul.restype = I
        libs.append((dll, split, report))
    return libs


def _call(dll, split: bool, x, packed, scales):
    """One build's launch on these inputs (into one output buffer)."""
    B, IN = x.shape
    OUT = packed.shape[1]
    G = IN // scales.shape[0]
    plan = i4.split_plan(B, IN, OUT, G, _cuda.sm_count(x.device)) if split else ()
    out = torch.empty((B, OUT), dtype=torch.float32, device=x.device)

    def run():  # on the current stream: a graph's capture stream while capturing
        stream = torch.cuda.current_stream().cuda_stream
        err = dll.lapha_int4_matmul(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                                    out.data_ptr(), B, IN, OUT, G, *plan, stream)
        if err:
            raise RuntimeError(f"int4_matmul launch failed: {err}")
        return out

    return run


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the replay timed with CUDA events. At a few microseconds a call
    the wrapper's and PyTorch's host work outlasts the kernel, so launches
    from Python would time the host; a replay launches nothing from it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _library(x, leaf):
    """``torch._weight_int4pack_mm`` on the same nibbles (zeros 0, bf16
    scales), converted once outside the timed call."""
    u = (quant._unpack_int4(leaf["q"]).to(torch.int32) + 8).T.contiguous()
    w = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
    s = leaf["s4"].to(torch.bfloat16)
    sz = torch.stack([s, torch.zeros_like(s)], dim=-1).contiguous()
    return lambda: torch._weight_int4pack_mm(x, w, GROUP, sz)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="int4_matmul.cu files, the first the base")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_k6: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs = _build(args.sources)
    names = [os.path.basename(os.path.dirname(os.path.abspath(s))) for s in args.sources]
    for name, src, (_, split, report) in zip(names, args.sources, libs):
        print(f"== {name}: {src} (split in-dim: {split})\n{report}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    for label, B, IN, OUT in SHAPES:
        x = torch.randn((B, IN), generator=gen, device=dev).to(torch.bfloat16)
        leaf = quant.quantize_weight_int4(torch.randn((IN, OUT), generator=gen, device=dev), GROUP)
        ref = i4.int4_matmul_plain(x, leaf["q"], leaf["s4"])
        top = float(ref.abs().max())
        runs = []
        for build, (dll, split, _) in zip(names, libs):
            run = _call(dll, split, x, leaf["q"], leaf["s4"])
            a = run().clone()
            b = run()
            torch.cuda.synchronize()
            err = float((a - ref).abs().max())
            if not err <= INT4_RTOL * top:
                raise SystemExit(f"{build} {label}: max|diff| {err} vs max|plain| {top}")
            if split and not torch.equal(a, b):
                raise SystemExit(f"{build} {label}: two launches differ")
            runs.append((build, run))
        runs.append(("_weight_int4pack_mm", _library(x, leaf)))
        times = {name: [] for name, _ in runs}
        order = runs + runs[::-1]
        for _ in range(ROUNDS):
            for name, fn in order:
                times[name].append(graph_ms(fn))
        base = sum(times[runs[0][0]]) / len(times[runs[0][0]])
        nbytes = leaf["q"].numel() + 4 * leaf["s4"].numel() + 2 * x.numel() + 4 * B * OUT
        cells = []
        for name, _ in runs:
            ms = sum(times[name]) / len(times[name])
            cells.append(f"{name} {ms:.4f} ms ({ms / base:.3f}x, readings "
                         f"{min(times[name]):.4f}-{max(times[name]):.4f})")
        plan = i4.split_plan(B, IN, OUT, GROUP, _cuda.sm_count(dev))
        print(f"{label} (plan: {plan.rows} rows, {plan.cols} columns, {plan.splits} splits, "
              f"{plan.ctas(B, OUT)} CTAs; byte bound "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms): " + "; ".join(cells) + f" [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
