"""Time builds of the grouped GEMM (K8: the forward, dX and tgmm) from several
sources, in turns, on one card.

    python3 -m lapha_tpu_torch.bench_k8 A/grouped_gemm.cu B/grouped_gemm.cu ...

Each source (for example the file of an unpacked parent checkout beside the
working tree's) is compiled by its own ``nvcc``, all started together, with
the package's flags into a library of its own under ``_build/bench_k8/``
(``bench_k2.compile_sources``); ``common.cuh`` is taken from the source's
directory if it has one, else from the package. A source whose forward
entry takes the kernel flag (``int wide``) runs the kernel that
``grouped_gemm.forward_kernel`` picks; an older one runs its only kernel.

The shapes are those of ``chip_smoke.py``'s K8 checks, Qwen1.5-MoE-A2.7B's
experts (60, 2048 <-> 1408) unless named: phase 1d's decode rows (24
tokens: Qwen1.5-MoE top-4 over 60 experts, GPT-OSS-20B top-4 over 32
experts, 2880 -> 5760 and 2880 -> 2880, DeepSeek-V2-Lite top-6 over 64
experts, 2048 <-> 1408; gate/up and down each), the decode rows of the
rollout's 8 and 16 sequences (``train_step``'s decode rounds) of
Qwen1.5-MoE and DeepSeek-V2-Lite, and prefill gate/up (4 x 512 tokens x
top-4); phase 1g's training shapes, Qwen1.5-MoE (8 x 1024 tokens x
top-4 = 32768 pair rows, experts 3 and 17 empty) and GPT-OSS-20B (4 x 1024
x top-4 over 32 experts, gate_up and down, experts 5 and 20 empty), gate/up
and down; and DeepSeek-V2-Lite's training gate/up (8 x 1024 tokens x top-6
= 49152 pair rows over 64 experts, 2048 -> 1408). Group sizes come from
top-k routing of random hidden states through a random router. The decode
and prefill shapes time the forward; the training shapes the forward, dX
and tgmm. Every build's outputs are held to the plain versions at phase
1g's limits first (the forward max |diff| <= 1e-3 · max |plain|; dX and
dW, bf16, per element 1e-3 · max |plain| over the store's rounding of 2^-8
|plain|; dW written over NaN), and the decode rows of a build that takes
the decode grid to two launches giving the same bits. Then each product is
timed in rounds that visit the builds in order and back (A B B A), three
rounds, and the mean of each build's six readings is printed beside its
ratio to the first build's and its rate, with the card's name and power
limit: the decode rows as CUDA-graph replays (``bench_k6.graph_ms``; at
~0.1 ms a call launches from Python would time the host too), beside
``torch._grouped_mm`` on the same operands in the same rounds and the
bound (the touched experts' weights, x and out once at 3.35 TB/s); the
others with CUDA events over 20 launches. ptxas's register and spill lines
of each build are printed too.

A source whose forward entry takes the kernel flag (``int wide``) runs the
kernel that ``grouped_gemm.forward_kernel`` picks, and one whose entry also
takes the decode kernel's grid (``int grid``) is given
``grouped_gemm.decode_grid``'s; an older one runs its only kernel.
``--sweep`` then times the last source's decode kernel at each decode row
under other constants, in turns, beside the source's own: copies of the
source with its panel width, ring depth and CTAs an SM (``DPW``,
``DSTAGES``, ``DCTAS``) edited to each of ``VARIANTS``, built beside it
under ``_build/bench_k8/``, each run at 1 to its CTAs an SM (the readings
behind ``decode_grid`` and the constants; the first of ``VARIANTS`` is
the source's own).

Last, for the dispatch rule: the last build that has both forward kernels
runs each of them at 2-64 rows an expert (Qwen1.5-MoE's gate/up, GPT-OSS's
gate_up), in turns, so that ``grouped_gemm.WG_MIN_ROWS`` can be read off.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

from lapha_tpu_torch.bench_k2 import ROUNDS, _time_ms, compile_sources
from lapha_tpu_torch.bench_k6 import graph_ms
from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import grouped_gemm as gg

GG_RTOL = 1e-3  # chip_smoke.py's K8 limit
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# (label, tokens, top-k, experts, K, N, experts forced empty, products timed)
TRAIN = ("fwd", "dx", "tgmm")
DECODE = (("1d Qwen1.5-MoE decode gate/up", 24, 4, 60, 2048, 1408, (), ("fwd",)),
          ("1d Qwen1.5-MoE decode down", 24, 4, 60, 1408, 2048, (), ("fwd",)),
          ("1d GPT-OSS decode gate_up", 24, 4, 32, 2880, 5760, (), ("fwd",)),
          ("1d GPT-OSS decode down", 24, 4, 32, 2880, 2880, (), ("fwd",)),
          ("1d DeepSeek-V2-Lite decode gate/up", 24, 6, 64, 2048, 1408, (), ("fwd",)),
          ("1d DeepSeek-V2-Lite decode down", 24, 6, 64, 1408, 2048, (), ("fwd",)),
          ("rollout Qwen1.5-MoE gate/up 8 seq", 8, 4, 60, 2048, 1408, (), ("fwd",)),
          ("rollout Qwen1.5-MoE down 8 seq", 8, 4, 60, 1408, 2048, (), ("fwd",)),
          ("rollout Qwen1.5-MoE gate/up 16 seq", 16, 4, 60, 2048, 1408, (), ("fwd",)),
          ("rollout Qwen1.5-MoE down 16 seq", 16, 4, 60, 1408, 2048, (), ("fwd",)),
          ("rollout DeepSeek-V2-Lite gate/up 8 seq", 8, 6, 64, 2048, 1408, (), ("fwd",)),
          ("rollout DeepSeek-V2-Lite down 8 seq", 8, 6, 64, 1408, 2048, (), ("fwd",)),
          ("rollout DeepSeek-V2-Lite gate/up 16 seq", 16, 6, 64, 2048, 1408, (), ("fwd",)),
          ("rollout DeepSeek-V2-Lite down 16 seq", 16, 6, 64, 1408, 2048, (), ("fwd",)))
SHAPES = DECODE + (
    ("1d prefill gate/up", 2048, 4, 60, 2048, 1408, (), ("fwd",)),
    ("1g Qwen1.5-MoE gate/up", 8192, 4, 60, 2048, 1408, (3, 17), TRAIN),
    ("1g Qwen1.5-MoE down", 8192, 4, 60, 1408, 2048, (3, 17), TRAIN),
    ("1g GPT-OSS gate/up", 4096, 4, 32, 2880, 5760, (5, 20), TRAIN),
    ("1g GPT-OSS down", 4096, 4, 32, 2880, 2880, (5, 20), TRAIN),
    ("DeepSeek-V2-Lite gate/up", 8192, 6, 64, 2048, 1408, (), TRAIN))
# the decode kernel's constants under --sweep: (DPW, DSTAGES, DCTAS), the
# first the source's own
VARIANTS = ((128, 3, 3), (128, 2, 3), (128, 4, 2), (128, 5, 2), (64, 3, 3), (64, 6, 3))
# (label, experts, K, N): the dispatch sweep's weights
SWEEP = (("Qwen1.5-MoE gate/up", 60, 2048, 1408), ("GPT-OSS gate_up", 32, 2880, 5760))
SWEEP_ROWS = (2, 4, 8, 12, 16, 24, 32, 64)


def _variant(src: str, cols: int, stages: int, ctas: int) -> str:
    """A copy of ``src`` (and the headers beside it) with the decode
    kernel's constants edited, under ``_build/bench_k8/``; its path."""
    with open(src) as f:
        text = f.read()
    for name, value in (("DPW", cols), ("DSTAGES", stages), ("DCTAS", ctas)):
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"--sweep: {src} has no single constant {name}")
    out = os.path.join(_cuda.BUILD_DIR, "bench_k8", f"decode_{cols}_{stages}_{ctas}")
    os.makedirs(out, exist_ok=True)
    here = os.path.dirname(os.path.abspath(src))
    for header in ("common.cuh", "hopper.cuh"):
        if os.path.exists(os.path.join(here, header)):
            shutil.copy(os.path.join(here, header), out)
    path = os.path.join(out, "grouped_gemm.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def _build(srcs: list[str]) -> list[tuple[ctypes.CDLL, bool, bool, str]]:
    """(library, its forward takes the kernel flag, ... and the decode grid,
    ptxas report) of each source, its three C entries bound."""
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = []
    for text, so, report in compile_sources(srcs, "bench_k8"):
        wide = re.search(r"lapha_grouped_gemm\([^)]*int wide", text) is not None
        planned = re.search(r"lapha_grouped_gemm\([^)]*int grid", text) is not None
        dll = ctypes.CDLL(so)
        dll.lapha_grouped_gemm.argtypes = [P] * 4 + [I] * (4 + wide + planned) + [P]
        for entry in (dll.lapha_grouped_gemm, dll.lapha_grouped_gemm_dx,
                      dll.lapha_grouped_gemm_tgmm):
            entry.restype = I
        for entry in (dll.lapha_grouped_gemm_dx, dll.lapha_grouped_gemm_tgmm):
            entry.argtypes = [P] * 4 + [I] * 4 + [P]
        libs.append((dll, wide, planned, report))
    return libs


def _checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: launch refused ({err})")


def _calls(dll, wide: bool, planned: bool, xs, w, gs, dy, force=None, grid=None):
    """The forward, dX and tgmm of one build on these operands, as closures
    returning their outputs. ``force`` (0 or 1) overrides the host's choice
    of forward kernel in a build that has both; ``grid`` the decode grid of
    a build that takes one."""
    M, K = xs.shape
    G, _, N = w.shape
    out = torch.empty((M, N), dtype=torch.float32, device=xs.device)
    dx = torch.empty_like(xs)
    dw = torch.empty_like(w)
    flag = [] if not wide else [
        int(gg.forward_kernel(M, G, N, w.data_ptr()) == "grouped_gemm_wg")
        if force is None else force]
    if planned:
        if grid is None:
            grid = 0 if flag[0] else gg.decode_grid(M, G, N, _cuda.sm_count(xs.device))
        flag.append(grid)
    p = (xs.data_ptr(), w.data_ptr(), gs.data_ptr())

    # the current stream at each call: a graph capture runs on a stream of its own
    def fwd():
        _checked(dll.lapha_grouped_gemm(*p, out.data_ptr(), M, K, N, G, *flag,
                                        torch.cuda.current_stream().cuda_stream), "forward")
        return out

    def run_dx():
        _checked(dll.lapha_grouped_gemm_dx(dy.data_ptr(), w.data_ptr(), gs.data_ptr(),
                                           dx.data_ptr(), M, K, N, G,
                                           torch.cuda.current_stream().cuda_stream), "dX")
        return dx

    def run_tgmm():
        _checked(dll.lapha_grouped_gemm_tgmm(xs.data_ptr(), dy.data_ptr(), gs.data_ptr(),
                                             dw.data_ptr(), M, K, N, G,
                                             torch.cuda.current_stream().cuda_stream), "tgmm")
        return dw

    return {"fwd": fwd, "dx": run_dx, "tgmm": run_tgmm}


def _library(xs, w, gs):
    """``torch._grouped_mm`` on the same bf16 operands with the int32 group
    ends (bf16 output), as a closure; None where it refuses them."""
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        fn = lambda: torch._grouped_mm(xs, w, offs=offs)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn
    except RuntimeError:
        return None


def _bound_ms(xs, w, gs, N) -> float:
    """The touched experts' weights, x and out (f32) once at 3.35 TB/s."""
    touched = int((gs > 0).sum())
    K = xs.shape[1]
    nbytes = touched * K * N * w.element_size() + xs.numel() * 2 + xs.shape[0] * N * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def _bf16_excess(out, ref) -> float:
    """max over elements of |out - ref| - 2^-8 |ref| over the limit GG_RTOL ·
    max |ref| (> 1: the check fails)."""
    ref = ref.float()
    excess = float(((out.float() - ref).abs() - 2.0 ** -8 * ref.abs()).max())
    return excess / (GG_RTOL * float(ref.abs().max()))


def _routed(gen, dev, tokens: int, k: int, E: int, H: int, empty):
    """Top-k routing of random hidden states through a random router, the
    experts ``empty`` never chosen: the pair rows in expert order and the
    group sizes (E,) int32, as the MoE layer's gather forms them."""
    x = torch.randn((tokens, H), generator=gen, device=dev).to(torch.bfloat16)
    logits = x.float() @ (torch.randn((H, E), generator=gen, device=dev) * 0.02)
    logits[:, list(empty)] = float("-inf")
    flat = torch.topk(logits, k, dim=-1).indices.reshape(-1)
    gs = torch.bincount(flat, minlength=E).to(torch.int32)
    return x.index_select(0, torch.argsort(flat, stable=True) // k), gs


def _rounds(runs: list[tuple[str, object]], timer=_time_ms) -> dict[str, list[float]]:
    times = {name: [] for name, _ in runs}
    for _ in range(ROUNDS):
        for name, fn in runs + runs[::-1]:
            times[name].append(timer(fn))
    return times


def _mean(xs: list[float]) -> float:
    return sum(xs) / len(xs)


def _sweep(label, variants, xs, w, gs, ref, card) -> None:
    """The decode kernel at one decode row under each variant's constants
    and 1 to its CTAs an SM, in turns; the first is the source's own at
    ``decode_grid``'s grid."""
    M, K = xs.shape
    G, _, N = w.shape
    sms = _cuda.sm_count(xs.device)
    runs = []
    for (cols, stages, ctas), dll in variants:
        for per_sm in range(ctas, 0, -1):
            grid = min(sms * per_sm, (min(G, M) + M // gg.DECODE_ROWS) * -(-N // cols))
            if not runs and grid != gg.decode_grid(M, G, N, sms):
                raise SystemExit(f"sweep: VARIANTS[0] is not the plan's ({grid} CTAs)")
            name = f"{cols}x{stages}x{ctas}@{per_sm}" + (" (plan)" if not runs else "")
            fn = _calls(dll, True, True, xs, w, gs, None, force=0, grid=grid)["fwd"]
            err = float((fn() - ref).abs().max()) / (GG_RTOL * float(ref.abs().max()))
            if not err <= 1.0:
                raise SystemExit(f"sweep {label} {name}: {err:.3f} of the limit")
            runs.append((name, fn))
    times = _rounds(runs, graph_ms)
    ranked = sorted(runs, key=lambda r: _mean(times[r[0]]))
    print(f"{label} sweep (columns x stages x CTAs an SM of the build @ CTAs an SM of the grid; "
          f"{len(runs)} plans): " + "; ".join(f"{name} {_mean(times[name]):.4f}"
                                             for name, _ in ranked) + f" [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="grouped_gemm.cu files, the first the base")
    ap.add_argument("--sweep", action="store_true",
                    help="time the last source's decode kernel under other constants at each decode row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_k8: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    sweep = [_variant(args.sources[-1], *v) for v in VARIANTS[1:]] if args.sweep else []
    libs = _build(args.sources + sweep)
    variants = list(zip(VARIANTS, [libs[len(args.sources) - 1][0]] + [l[0] for l in
                                                                    libs[len(args.sources):]]))
    libs = libs[:len(args.sources)]
    # a build is named by its source's directory in the timing lines
    names = [os.path.basename(os.path.dirname(os.path.abspath(s))) for s in args.sources]
    for name, src, (_, wide, planned, report) in zip(names, args.sources, libs):
        print(f"== {name}: {src} (two forward kernels: {wide}; decode grid: {planned})\n"
              f"{report}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def bf16(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    for label, tokens, k, E, K, N, empty, products in SHAPES:
        decode = (label, tokens, k, E, K, N, empty, products) in DECODE
        xs, gs = _routed(gen, dev, tokens, k, E, 2048 if K == 1408 else K, empty)
        if xs.shape[1] != K:  # the down projection: rows of the expert width
            xs = bf16(xs.shape[0], K)
        M = xs.shape[0]
        w, dy = bf16(E, K, N, scale=K ** -0.5), bf16(M, N)
        refs = {"fwd": gg.grouped_gemm_plain(xs, w, gs)}
        if "dx" in products:
            refs["dx"] = gg.grouped_gemm_dx_plain(dy.float(), w.float(), gs)
            refs["tgmm"] = gg.grouped_gemm_tgmm_plain(xs.float(), dy.float(), gs)
        calls = []
        for build, (dll, wide, planned, _) in zip(names, libs):
            fns = _calls(dll, wide, planned, xs, w, gs, dy)
            if "tgmm" in products:  # the checked launch writes every element
                fns["tgmm"]().fill_(float("nan"))
            for prod in products:
                got = fns[prod]().clone()
                torch.cuda.synchronize()
                ref = refs[prod]
                err = (float((got - ref).abs().max()) / (GG_RTOL * float(ref.abs().max()))
                       if prod == "fwd" else _bf16_excess(got, ref))
                if not (err <= 1.0 and bool(torch.isfinite(got.float()).all())):
                    raise SystemExit(f"{build} {label} {prod}: {err:.3f} of the limit")
                if decode and planned and not torch.equal(fns[prod](), got):
                    raise SystemExit(f"{build} {label} {prod}: two launches differ")
            calls.append((build, fns))
        for prod in products:
            runs = [(build, fns[prod]) for build, fns in calls]
            lib = _library(xs, w, gs) if decode else None
            if lib is not None:
                runs.append(("_grouped_mm", lib))
            times = _rounds(runs, graph_ms if decode else _time_ms)
            base = _mean(times[names[0]])
            cells = []
            for build, _ in runs:
                ms = _mean(times[build])
                cells.append(f"{build} {ms:.4f} ms ({ms / base:.3f}x, {2 * M * K * N / ms / 1e9:.1f} "
                             f"TFLOP/s, readings {min(times[build]):.4f}-{max(times[build]):.4f})")
            bound = f", bound {_bound_ms(xs, w, gs, N):.4f} ms (bytes)" if decode else ""
            print(f"{label} {prod} (M={M} K={K} N={N}, {E} experts, {int((gs > 0).sum())} with "
                  f"rows, group sizes min {int(gs.min())} max {int(gs.max())}{bound}): " +
                  "; ".join(cells) + f" [{card}]", flush=True)
        if args.sweep and decode and libs[-1][2]:
            _sweep(label, variants, xs, w, gs, refs["fwd"], card)
        del xs, w, dy, refs, calls
        torch.cuda.empty_cache()

    both = [(build, dll, planned) for build, (dll, wide, planned, _) in zip(names, libs) if wide]
    if both:
        build, dll, planned = both[-1]
        for label, E, K, N in SWEEP:
            w = bf16(E, K, N, scale=K ** -0.5)
            for rows in SWEEP_ROWS:
                M = rows * E
                gs = torch.bincount(torch.randint(0, E, (M,), generator=gen, device=dev),
                                    minlength=E).to(torch.int32)
                xs = bf16(M, K)
                runs = [(kernel, _calls(dll, True, planned, xs, w, gs, None, force=flag)["fwd"])
                        for kernel, flag in (("grouped_gemm", 0), ("grouped_gemm_wg", 1))]
                ref = gg.grouped_gemm_plain(xs, w, gs)
                for kernel, fn in runs:
                    err = float((fn() - ref).abs().max()) / (GG_RTOL * float(ref.abs().max()))
                    if not err <= 1.0:
                        raise SystemExit(f"{build} sweep {label} {rows} rows {kernel}: {err:.3f}")
                times = _rounds(runs, graph_ms)
                old, new = (_mean(times[n]) for n, _ in runs)
                print(f"dispatch sweep ({build}) {label}: {rows} rows an expert (M={M}): decode "
                      f"{old:.4f} ms, wgmma {new:.4f} ms ({new / old:.3f}x); the rule picks "
                      f"{gg.forward_kernel(M, E, N, w.data_ptr())} [{card}]", flush=True)
            del w
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
