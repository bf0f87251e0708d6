"""Time builds of the flash-attention backward (K2) from several sources, in
turns, on one card.

    python3 -m lapha_tpu_torch.bench_k2 A/flash_attention_bwd.cu B/flash_attention_bwd.cu ...

Each source (for example the file of an unpacked parent checkout beside the
working tree's) is compiled by its own ``nvcc``, all started together, with
the package's flags into a library of its own under ``_build/bench_k2/``;
``common.cuh`` is taken from the source's directory if it has one, else from
the package. A source whose C entries take no ``softcap`` (those written
before the cap) is called without it and skips the capped shapes; one whose
entries take no ``dv_w`` (those written before V narrower than Q/K) is called
without it and skips the narrow-V shape.

The shapes are those of ``chip_smoke.py``'s K2 checks: phase 1b (B=4 T=1024,
12/2 heads of dim 128, ragged masks and a hole), phase 1h (64/8 heads of dim
64, W=128 and full), phase 1i's Gemma rows (dh 256: 8/4 heads with the cap
of 50, full and at W=4096, 4/1 heads at W=512 and full) and phase 1k's
DeepSeek row (16/16 heads, Q/K 192, V 128, scale 1/sqrt(192)) and phase 1l's
Phi-3 row (32/32 heads of dim 96, W=2047). A source whose dk/dv entry takes
a workspace (``void* work``: the GQA group split into parts) gets the
wrapper's split (``flash_attention.dkv_split``). Every build's dq, dk and dv
are held to the plain backward at the smoke script's limits first, and a
build with the split is launched twice and must give bit-equal results. Then
each kernel is timed with CUDA events (20 launches a reading) in rounds that
visit the builds in order and back (A B C C B A), three rounds, and the mean
of each build's six readings is printed beside its ratio to the first
build's, with the card's name and power limit. One PyTorch call computing
the same gradients is timed in the same rounds as a yardstick (``library``:
SDPA's backward with the boolean mask, dq, dk and dv together, its cuDNN
backend where V is narrower than Q/K; none for the softcapped shapes).
ptxas's register and spill lines of each build are printed too.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import torch

from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import flash_attention as fa

BWD_RTOL, BWD_ATOL = 1e-2, 1e-3  # chip_smoke.py's K2 limits
ROUNDS, REPS = 3, 20
# (label, B, T, heads, KV heads, head dim of Q/K, of V, window, softcap, q
# scaled by)
SHAPES = (("1b dh128 12/2", 4, 1024, 12, 2, 128, 128, 0, 0.0, 1.0),
          ("1h dh64 64/8 W=128", 4, 1024, 64, 8, 64, 64, 128, 0.0, 1.0),
          ("1h dh64 64/8 W=0", 4, 1024, 64, 8, 64, 64, 0, 0.0, 1.0),
          ("1i dh256 8/4 cap50 W=0", 4, 1024, 8, 4, 256, 256, 0, 50.0, 25.0),
          ("1i dh256 8/4 cap50 W=4096", 4, 1024, 8, 4, 256, 256, 4096, 50.0, 25.0),
          ("1i dh256 4/1 W=512", 4, 1024, 4, 1, 256, 256, 512, 0.0, 1.0),
          ("1i dh256 4/1 W=0", 4, 1024, 4, 1, 256, 256, 0, 0.0, 1.0),
          ("1k dh192 v128 16/16", 4, 1024, 16, 16, 192, 128, 0, 0.0, 1.0),
          ("1l dh96 32/32 W=2047", 4, 1024, 32, 32, 96, 96, 2047, 0.0, 1.0))


def compile_sources(srcs: list[str], subdir: str, siblings: str | None = None
                    ) -> list[tuple[str, str, str]]:
    """Compile each source into a shared library of its own under
    ``_build/<subdir>/``, one ``nvcc`` a translation unit, all started
    together: (the units' text, library path, ptxas's entry, register and
    spill lines). With ``siblings`` (a glob pattern), a source's library
    holds every file matching it in the source's directory, the source
    among them (a kernel whose C entries are sources of their own). A
    library is named by a hash of its units, the headers beside them and
    the flags."""
    out_dir = os.path.join(_cuda.BUILD_DIR, subdir)
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _cuda._nvcc()
    cmds, links, builds = [], [], []
    for src in srcs:
        here = os.path.dirname(os.path.abspath(src))
        tus = sorted(glob.glob(os.path.join(here, siblings))) if siblings else [src]
        text = "".join(open(p).read() for p in tus)
        headers = "".join(open(p).read() for p in sorted(glob.glob(os.path.join(here, "*.cuh"))))
        tag = hashlib.sha1((text + headers + " ".join(_cuda.NVCC_FLAGS)).encode()).hexdigest()[:12]
        so = os.path.join(out_dir, f"{subdir}_{tag}.so")
        objs = [f"{so}.{i}.o" for i in range(len(tus))]
        # compiled, then linked, as ops/_cuda.build does
        cmds += [[nvcc, *_cuda.NVCC_FLAGS, "-c", "-I", here, "-I", _cuda.CSRC, "-o", o, tu]
                 for tu, o in zip(tus, objs)]
        links.append([nvcc, "-shared", "-o", so, *objs])
        builds.append((text, so, len(tus)))
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {p.returncode}:\n{' '.join(c)}\n{log}")
    for link in links:
        subprocess.run(link, check=True, capture_output=True)
    out, at = [], 0
    for text, so, n in builds:
        report = [ln.strip() for log in logs[at:at + n] for ln in log.splitlines()
                  if "Compiling entry function" in ln or "registers" in ln or "spill" in ln]
        out.append((text, so, "\n".join(report)))
        at += n
    return out


def _build(srcs: list[str]) -> list[tuple[ctypes.CDLL, bool, bool, bool, str]]:
    """(library, takes a softcap, takes V's head dim, splits the GQA group,
    ptxas report) of each source."""
    libs = []
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for text, so, report in compile_sources(srcs, "bench_k2"):
        cap = re.search(r"lapha_flash_bwd_dq\([^)]*float softcap", text) is not None
        narrow = re.search(r"lapha_flash_bwd_dq\([^)]*int dv_w", text) is not None
        split = re.search(r"lapha_flash_bwd_dkv\([^)]*void\* work", text) is not None
        dll = ctypes.CDLL(so)
        ints = [I] * (8 if narrow else 7)  # B T S nh nkv dh (dv_w) window
        tail = [F, F, P] if cap else [F, P]  # scale(, softcap), stream
        dll.lapha_flash_bwd_dq.argtypes = [P] * 9 + ints + tail
        # (work), ..., (splits) before the stream
        dll.lapha_flash_bwd_dkv.argtypes = ([P] * 11 + ints + [F, F, I, P] if split
                                            else [P] * 10 + ints + tail)
        dll.lapha_flash_bwd_dq.restype = dll.lapha_flash_bwd_dkv.restype = I
        libs.append((dll, cap, narrow, split, report))
    return libs


def _calls(dll, cap: bool, narrow: bool, split: bool, args):
    """The dq and the dk/dv call of one build on the kernels' arguments."""
    q, k, v, mask, qs, lse, do, delta, scale, window, softcap = args
    B, T, nh, dh = q.shape
    S, nkv = k.shape[1], k.shape[2]
    dims = (dh, v.shape[-1]) if narrow else (dh,)
    delta_t = delta.transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream().cuda_stream
    tail = (float(scale), float(softcap), stream) if cap else (float(scale), stream)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta_t.data_ptr(), mask.data_ptr(), qs.data_ptr())
    if split:  # the wrapper's group split and its partials
        splits = fa.dkv_split(B, S, nkv, nh // nkv, dh, _cuda.sm_count(q.device))
        work = [torch.empty(splits * B * S * nkv * (dh + v.shape[-1]), dtype=torch.float32,
                            device=q.device)]  # held by run_dkv for as long as it is called
        tail = (float(scale), float(softcap), splits, stream)
    else:
        work = []

    def run_dq():
        err = dll.lapha_flash_bwd_dq(*common, dq.data_ptr(), B, T, S, nh, nkv, *dims, window,
                                     *((float(scale), float(softcap), stream) if cap
                                       else (float(scale), stream)))
        if err:
            raise RuntimeError(f"dq launch failed: {err}")
        return dq

    def run_dkv():
        err = dll.lapha_flash_bwd_dkv(*common, dk.data_ptr(), dv.data_ptr(),
                                      *(w.data_ptr() for w in work), B, T, S, nh, nkv, *dims,
                                      window, *tail)
        if err:
            raise RuntimeError(f"dk/dv launch failed: {err}")
        return dk, dv

    return run_dq, run_dkv


def _time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def _inputs(dev, B, T, nh, nkv, dh, dv, window, cap, q_sd, rng):
    def bf16(*shape, sd=1.0):
        return torch.from_numpy((rng.normal(size=shape) * sd).astype(np.float32)).to(
            dev, torch.bfloat16)

    scale = 1.0 / 16 if dh == 256 else dh ** -0.5
    q, do = bf16(B, T, nh, dh, sd=q_sd), bf16(B, T, nh, dv)
    k, v = bf16(B, T, nkv, dh), bf16(B, T, nkv, dv)
    lens = (T, (700 * T) // 1024, (1000 * T) // 1024, (333 * T) // 1024)[:B]
    mask = (torch.arange(T, device=dev)[None, :]
            < torch.as_tensor(lens, device=dev)[:, None]).to(torch.int32)
    mask[0, 100:140] = 0  # a hole of invalid keys
    qs = torch.zeros(B, dtype=torch.int32, device=dev)
    out, lse = fa._attention_cuda(q, k, v, mask, qs, scale, "flash_attention", window, cap)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, mask, qs, lse, do, delta, scale, window, cap


def _library(args):
    """SDPA's backward on the same inputs (dq, dk, dv in one autograd call),
    or None: the softcap has no one call without a compile, and a backend
    that does not take the inputs gives none. Timed only as a yardstick."""
    import contextlib

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v, mask, qs, lse, do, delta, scale, window, softcap = args
    if softcap:
        return None
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    allowed = (mask[:, None, :] > 0) & (pos[None, None, :] <= pos[None, :, None])
    if window > 0:
        allowed &= pos[None, None, :] > pos[None, :, None] - window
    leaves = [t.detach().transpose(1, 2).requires_grad_(True) for t in (q, k, v)]
    narrow = v.shape[-1] < q.shape[-1]
    try:
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]) if narrow else contextlib.nullcontext():
            out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed[:, None], scale=scale,
                                                 enable_gqa=True)
        gout = do.transpose(1, 2)

        def run():
            return torch.autograd.grad(out, leaves, gout, retain_graph=True)

        run()
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="flash_attention_bwd.cu files, the first the base")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_k2: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    libs = _build(args.sources)
    # a build is named by its source's directory in the timing lines
    names = [os.path.basename(os.path.dirname(os.path.abspath(s))) for s in args.sources]
    for name, src, (_, cap, narrow, split, report) in zip(names, args.sources, libs):
        print(f"== {name}: {src} (softcap argument: {cap}, V head dim argument: {narrow}, "
              f"group split: {split})\n{report}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for label, B, T, nh, nkv, dh, dv, window, cap, q_sd in SHAPES:
        kargs = _inputs(dev, B, T, nh, nkv, dh, dv, window, cap, q_sd, rng)
        ref = fa.attention_bwd_plain(*kargs)
        builds = []
        for build, (dll, has_cap, narrow, split, _) in zip(names, libs):
            if (cap and not has_cap) or (dv < dh and not narrow):
                continue
            run_dq, run_dkv = _calls(dll, has_cap, narrow, split, kargs)
            try:
                got = [t.clone() for t in (run_dq(), *run_dkv())]
            except RuntimeError as e:  # a source written before this head dim
                print(f"{label}: {build} skipped ({e})", flush=True)
                continue
            again = (run_dq(), *run_dkv())
            torch.cuda.synchronize()
            for part, a, b, c in zip(("dq", "dk", "dv"), got, ref, again):
                err, top = float((a.float() - b.float()).abs().max()), float(b.abs().max())
                if not err <= BWD_RTOL * top + BWD_ATOL:
                    bad = (~torch.isfinite(a.float())).nonzero()
                    raise SystemExit(f"{build} {label} {part}: max|diff| {err} vs max|plain| {top}"
                                     f" ({len(bad)} non-finite, the first at {bad[:4].tolist()})")
                if split and not torch.equal(a, c):
                    raise SystemExit(f"{build} {label} {part}: two launches differ")
            builds.append((build, (run_dq, run_dkv)))
        lib = _library(kargs)
        for kernel in (0, 1):
            # the library call computes dq, dk and dv at once: timed beside dq
            timed = builds + ([("library", (lib, lib))] if lib is not None and kernel == 0 else [])
            times = {build: [] for build, _ in timed}
            order = timed + timed[::-1]
            for _ in range(ROUNDS):
                for build, fns in order:
                    times[build].append(_time_ms(fns[kernel]))
            base = sum(times[builds[0][0]]) / len(times[builds[0][0]])
            cells = []
            for build, _ in timed:
                ms = sum(times[build]) / len(times[build])
                cells.append(f"{build} {ms:.4f} ms ({ms / base:.3f}x, readings "
                             f"{min(times[build]):.4f}-{max(times[build]):.4f})")
            print(f"{label} {('dq', 'dk/dv')[kernel]}: " + "; ".join(cells) + f" [{card}]",
                  flush=True)
        del kargs, ref, builds, lib
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
