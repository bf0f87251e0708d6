"""Time builds of the ragged decode attention (K4/K5) from several sources, in
turns, on one card.

    python3 -m lapha_tpu_torch.bench_k4 A/ragged_decode_attention.cu B/... ...

Each source (for example the file of an unpacked parent checkout beside the
working tree's) is compiled by its own ``nvcc``, all started together, with
the package's flags into a library of its own under ``_build/bench_k4/``
(``bench_k2.compile_sources``); ``common.cuh`` is taken from the source's
directory if it has one, else from the package.

The shapes are those of ``chip_smoke.py``'s decode checks: phase 1's K4
(B=24 S=640, 12/2 heads of dim 128), phase 1c's K5 (B=48 S=768, int8), phase
1e's sink entries (64/8 heads of dim 64, bf16 and int8), phase 1f's dh-256
rows (Gemma-2's 8/4 heads with the cap of 50, Gemma-3's 4/1) and phase 1l's
(Phi-3's 32/32 heads of dim 96; StarCoder2-3B's group of 12, 24/2 heads of
dim 128). A build that refuses a shape (a source written before dh 96 or a
group above 8) skips it. Every build's output is held to the plain version
at the smoke script's limits first (3e-2; the int8 rule 5e-3 + 2^-7 |plain|).
Then each shape is timed as CUDA-graph replays (``bench_k6.graph_ms``: 20
launches captured in one graph, a replay a reading; at ~10 us a call,
launches from Python would time the host) in rounds that visit the builds
in order and back (A B C C B A), three rounds, and the
mean of each build's six readings is printed beside its ratio to the first
build's, with the card's name and power limit. One PyTorch call computing
the same attention is timed in the same rounds where there is one
(``library``: SDPA with the boolean mask of the valid slots, bf16 cache, no
sinks, no softcap). ptxas's register and spill lines of each build are
printed too.

A source whose C entries end with the host's plan (``int splits, int
stages``, the split kernel) is called with ``split_plan``'s plan at each
shape; an older one without it. ``--sweep`` then times the last build at
each shape under every plan of 1, 2, 3, 4, 6 and 8 splits and 1 to 4 stages,
in turns, each beside the plan's own choice (the readings behind
``split_plan``).
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import re
import subprocess
import sys

import torch

from lapha_tpu_torch.bench_k2 import ROUNDS, compile_sources
from lapha_tpu_torch.bench_k6 import graph_ms
from lapha_tpu_torch.models.qwen2 import _quantize_kv
from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import ragged_decode_attention as rda

KERNEL_ATOL, Q8_ATOL = 3e-2, 5e-3  # chip_smoke.py's limits
# (label, B, S, slot, heads, KV heads, head dim, window, int8, sinks, softcap, q scaled by)
SHAPES = (("1 K4 dh128 12/2", 24, 640, 580, 12, 2, 128, 0, False, False, 0.0, 1.0),
          ("1c K5 dh128 12/2 B=48", 48, 768, 700, 12, 2, 128, 0, True, False, 0.0, 1.0),
          ("1e K5s dh64 64/8 W=128", 24, 640, 600, 64, 8, 64, 128, False, True, 0.0, 1.0),
          ("1e K5s q8 dh64 64/8 W=128", 24, 640, 600, 64, 8, 64, 128, True, True, 0.0, 1.0),
          ("1f K4 dh256 8/4 cap50", 24, 640, 600, 8, 4, 256, 4096, False, False, 50.0, 25.0),
          ("1f K4 dh256 4/1 W=512", 24, 640, 600, 4, 1, 256, 512, False, False, 0.0, 1.0),
          ("1l K4 dh96 32/32", 24, 640, 600, 32, 32, 96, 2047, False, False, 0.0, 1.0),
          ("1l K5 dh96 32/32", 24, 640, 600, 32, 32, 96, 2047, True, False, 0.0, 1.0),
          ("1l K4 dh128 24/2 (group 12)", 24, 640, 600, 24, 2, 128, 4096, False, False, 0.0, 1.0),
          ("1l K5 dh128 24/2 (group 12)", 24, 640, 600, 24, 2, 128, 4096, True, False, 0.0, 1.0))


def _build(srcs: list[str]) -> list[tuple[ctypes.CDLL, bool, str]]:
    """(library, takes the plan, ptxas report) of each source, its four C
    entries bound."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = []
    for text, so, report in compile_sources(srcs, "bench_k4"):
        planned = re.search(r"lapha_ragged_decode\([^)]*int splits", text) is not None
        # layer slot out B nh nkv S dh scale softcap (splits stages) stream
        tail = [I, I, P, I, I, I, I, I, F, F] + ([I, I] if planned else []) + [P]
        dll = ctypes.CDLL(so)
        for entry, n_ptr in (("lapha_ragged_decode", 6), ("lapha_ragged_decode_q8", 8),
                             ("lapha_ragged_decode_sink", 7), ("lapha_ragged_decode_q8_sink", 9)):
            fn = getattr(dll, entry)
            fn.argtypes = [P] * n_ptr + tail
            fn.restype = I
        libs.append((dll, planned, report))
    return libs


def _call(dll, planned, q, kc, vc, scl, lens, dstart, pstart, sinks, slot, scale, softcap,
          plan=None):
    """One build's decode at layer 1 on the kernel's arguments, as a
    closure (with ``plan``, or ``split_plan``'s, if the build takes one);
    None if the build refuses the shape."""
    B, nh, dh = q.shape
    nkv, S = kc.shape[2], kc.shape[3]
    out = torch.empty_like(q)
    entry = "lapha_ragged_decode" + ("" if scl is None else "_q8") + (
        "" if sinks is None else "_sink")
    ptrs = [q.data_ptr(), kc.data_ptr(), vc.data_ptr()]
    if scl is not None:
        ptrs += [scl[0].data_ptr(), scl[1].data_ptr()]
    ptrs += [lens.data_ptr(), dstart.data_ptr(), pstart.data_ptr()]
    if sinks is not None:
        ptrs.append(sinks.data_ptr())
    if planned and plan is None:
        plan = rda.split_plan(B, nkv, nh // nkv, slot + 1, _cuda.sm_count(q.device), dh=dh,
                              int8=scl is not None)
    extra = list(plan) if planned else []
    fn = getattr(dll, entry)

    def run():
        # the current stream: a graph capture runs on a stream of its own
        err = fn(*ptrs, 1, slot, out.data_ptr(), B, nh, nkv, S, dh, float(scale), float(softcap),
                 *extra, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch refused: {err}")
        return out

    try:
        run()
    except RuntimeError:
        return None
    return run


def _library(q, kc, vc, valid, scale):
    """SDPA over layer 1 with the boolean mask of the valid slots, as a closure."""
    import torch.nn.functional as F

    qt, k, v, m = q[:, :, None], kc[1], vc[1], valid[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=m, scale=scale,
                                                  enable_gqa=True)


def _rounds(timed, card, label):
    """Time (name, closure) pairs in turns, ROUNDS rounds of A B .. B A, and
    print each mean beside its ratio to the first."""
    times = {name: [] for name, _ in timed}
    order = timed + timed[::-1]
    for _ in range(ROUNDS):
        for name, run in order:
            times[name].append(graph_ms(run))
    base = sum(times[timed[0][0]]) / len(times[timed[0][0]])
    cells = []
    for name, _ in timed:
        ms = sum(times[name]) / len(times[name])
        cells.append(f"{name} {ms:.4f} ms ({ms / base:.3f}x, readings "
                     f"{min(times[name]):.4f}-{max(times[name]):.4f})")
    print(f"{label}: " + "; ".join(cells) + f" [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+",
                    help="ragged_decode_attention.cu files, the first the base")
    ap.add_argument("--sweep", action="store_true",
                    help="time the last build under every plan at each shape")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_k4: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs = _build(args.sources)
    # a build is named by its source's directory in the timing lines
    names = [os.path.basename(os.path.dirname(os.path.abspath(s))) for s in args.sources]
    for name, src, (_, _, report) in zip(names, args.sources, libs):
        print(f"== {name}: {src}\n{report}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def bf16(*shape, sd=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * sd).to(torch.bfloat16)

    for label, B, S, slot, nh, nkv, dh, W, int8, sink, cap, q_sd in SHAPES:
        q = bf16(B, nh, dh, sd=q_sd)
        kc, vc = bf16(2, B, nkv, S, dh), bf16(2, B, nkv, S, dh)
        scl = None
        if int8:
            (kc, ks), (vc, vs) = _quantize_kv(kc), _quantize_kv(vc)
            scl = (ks, vs)
        lens = torch.randint(64, 513, (B,), generator=gen, device=dev).to(torch.int32)
        pos = lens + (slot - 512)
        odd = torch.arange(B, device=dev) % 2 == 1
        pstart = torch.where(odd & (W > 0), torch.minimum(torch.clamp(pos - (W - 1), min=0), lens),
                             torch.zeros_like(lens)).to(torch.int32)
        dstart = torch.where(odd & (W > 0), torch.full_like(lens, max(512, slot - (W - 1))),
                             torch.full_like(lens, 512)).to(torch.int32)
        sinks = (torch.randn(nh, generator=gen, device=dev)
                 + torch.where(torch.arange(nh, device=dev) % 2 == 0, 8.0, -8.0)) if sink else None
        scale = 1.0 / 16 if dh == 256 else dh ** -0.5
        ref = rda.ragged_decode_plain(q, kc, vc, 1, lens, dstart, slot, pstart, scale,
                                      cache_scale=scl, sinks=sinks, softcap=cap).float()

        def checked(build, run):
            diff = (run().float() - ref).abs()
            torch.cuda.synchronize()
            excess = (float((diff - 2.0 ** -7 * ref.abs()).max()) - Q8_ATOL if int8
                      else float(diff.max()) - KERNEL_ATOL)
            if not excess <= 0:
                raise SystemExit(f"{build} {label}: max|diff| {float(diff.max())}")
            return build, run

        builds = []
        for build, (dll, planned, _) in zip(names, libs):
            run = _call(dll, planned, q, kc, vc, scl, lens, dstart, pstart, sinks, slot, scale,
                        cap)
            if run is None:
                print(f"{label}: {build} refuses the shape, skipped", flush=True)
                continue
            builds.append(checked(build, run))
        timed = list(builds)
        if not int8 and not sink and not cap:
            ar = torch.arange(S, device=dev)[None, :]
            valid = (((ar >= pstart[:, None]) & (ar < lens[:, None]))
                     | ((ar >= dstart[:, None]) & (ar <= slot)))
            timed.append(("library", _library(q, kc, vc, valid, scale)))
        _rounds(timed, card, label)
        dll, planned, _ = libs[-1]
        if args.sweep and planned:
            chosen = rda.split_plan(B, nkv, nh // nkv, slot + 1, _cuda.sm_count(dev), dh=dh,
                                    int8=int8)
            plans = [(f"plan {tuple(chosen)}", chosen)] + [
                (f"{sp}x{st}", rda.Plan(sp, st))
                for sp, st in itertools.product((1, 2, 3, 4, 6, 8), range(1, rda.MAX_STAGES + 1))
                if rda.Plan(sp, st) != chosen]
            swept = []
            for name, plan in plans:
                run = _call(dll, planned, q, kc, vc, scl, lens, dstart, pstart, sinks, slot,
                            scale, cap, plan)
                if run is not None:
                    swept.append(checked(f"{names[-1]} {name}", run))
            _rounds(swept, card, f"{label} sweep")
        del q, kc, vc, ref, builds, timed
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
