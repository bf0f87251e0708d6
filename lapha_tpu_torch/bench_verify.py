"""Time builds of the speculative verify attention from one or more sources,
in turns, on one card.

    python3 -m lapha_tpu_torch.bench_verify [A/spec_verify_attention.cu B/...] [--sweep]

With no source the package's own ``csrc/spec_verify_attention.cu`` is
built. Each source (for example an edited copy of the package's ``csrc``
beside it) is built with the ``spec_verify_attention*.cu`` files beside it
(the four entry sources), each by its own ``nvcc``, all started together,
with the package's flags, into a library of its own under
``_build/bench_verify/`` (``bench_k2.compile_sources``); headers are taken
from the source's directory if it has them, else from the package. Every
build has the package's C entries, the plan's arguments and
``lapha_spec_verify_smem`` among them.

The shapes are ``chip_smoke.py``'s phase 1m: Qwen2.5-1.5B (12/2 heads, dh
128, bf16 and int8), GPT-OSS-20B (64/8, dh 64, sinks, a window of 128 by
position, bf16 and int8), Gemma-2-2B (8/4, dh 256, softcap 50, q x25),
Phi-3-mini (32/32, dh 96, W 2047) and StarCoder2-3B (24/2: a group of 12,
W 4096), in an S = 1152 cache at slot 1140 with its geometry
(:func:`verify_geometry`: prompts of 300-512 columns, ~65% of the decode
columns valid), at T = 1, 2, 4 and 8 queries a row and B = 24 rows
(phase 1m's) and 4 and 8 (the evaluation entry's). Every build's output is
held to the plain version at the smoke script's limits first (3e-2; the
int8 rule 5e-3 + 2^-7 |plain|). Then each shape is timed as CUDA-graph
replays (``bench_k6.graph_ms``: 20 launches captured in one graph, a replay
a reading) in rounds that visit the builds in order and back (A B B A),
three rounds, and each build's mean of six readings is printed beside its
ratio to the first build's, with the card's name and power limit and the
shape's bound (the bytes of the K/V columns some query sees, the queries,
outputs and maps, at 3.35 TB/s). One PyTorch call computing the same
function is timed in the same rounds where there is one (``sdpa``: SDPA
with the boolean (B, nh, T, S) mask over the same cache views; bf16, no
sinks, no softcap).

Each build is called with ``verify_plan``'s plan, sized by the build's own
shared-memory count. ``--sweep`` then times the last build at each shape
under every plan of 1, 2, 4 and 8 splits and 1 to 4 stages (the plan's
qtiles), in turns, each beside the plan's own choice: the readings behind
``verify_plan``. ``--unchecked NAME ...`` times the builds of those
directories without the check: copies of ``csrc`` edited to leave work
out (a ``return`` at entry, no walk, no merge), which split the kernel's
time into launch, list building, merge and walk where no profiler reads
the card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import subprocess
import sys

import torch

from lapha_tpu_torch.bench_k2 import ROUNDS, compile_sources
from lapha_tpu_torch.bench_k6 import graph_ms
from lapha_tpu_torch.models.qwen2 import _quantize_kv
from lapha_tpu_torch.ops import _cuda
from lapha_tpu_torch.ops import spec_verify_attention as sva

KERNEL_ATOL, Q8_ATOL = 3e-2, 5e-3  # chip_smoke.py's limits
HBM_BYTES_PER_S = 3.35e12
L, S, SLOT = 2, 1152, 1140         # phase 1m's cache and block
# (family, heads, KV heads, head dim, window, softcap, sinks, int8 too)
FAMILIES = (("Qwen2.5-1.5B", 12, 2, 128, 0, 0.0, False, True),
            ("GPT-OSS-20B", 64, 8, 64, 128, 0.0, True, True),
            ("Gemma-2-2B", 8, 4, 256, 0, 50.0, False, False),
            ("Phi-3-mini", 32, 32, 96, 2047, 0.0, False, False),
            ("StarCoder2-3B", 24, 2, 128, 4096, 0.0, False, False))
TS = (1, 2, 4, 8)
BS = (24, 4, 8)


def verify_geometry(gen, B: int, S: int, slot: int, T: int, dev):
    """A spec-decode cache's validity at B rows: prompts of 300-512 columns
    in a 512-column slab, decode columns [512, slot) of which ~65% are valid
    (the rest are rejected drafts' holes), the position map (a prompt
    column's position is its index; a decode column's, the row's length
    before it) and the block's T positions after the row's tokens. Returns
    (valid_map, pos_map, positions, holes)."""
    lens = torch.randint(300, 513, (B,), generator=gen, device=dev)
    ar = torch.arange(S, device=dev)[None, :]
    dec = (ar >= 512) & (ar < slot)
    kept = torch.rand((B, S), generator=gen, device=dev) < 0.65
    valid = (ar < lens[:, None]) | (dec & kept)
    before = torch.cumsum((dec & kept).long(), dim=1) - (dec & kept).long()
    pos_map = torch.where(ar < 512, ar, lens[:, None] + before).to(torch.int32)
    n_dec = (dec & kept).sum(dim=1)
    positions = (lens + n_dec)[:, None] + torch.arange(T, device=dev)[None, :]
    return valid, pos_map, positions.to(torch.int32), dec & ~kept


def bound_bytes(vis, q, kk, nkv: int, int8: bool, window: int, valid, positions, pos_map) -> int:
    """The bytes the verify must move: K and V of the columns some query of
    the row sees (int8: + their two f32 scales) for each KV head, q read and
    the output written, the map and positions (and the position map where
    windowed)."""
    dh = q.shape[-1]
    per_col = 2 * dh * kk.element_size() + (8 if int8 else 0)
    n_cols = int(vis.any(dim=1).sum())
    maps = valid.numel() * valid.element_size() + positions.numel() * positions.element_size()
    if window:
        maps += pos_map.numel() * pos_map.element_size()
    return n_cols * nkv * per_col + 2 * q.numel() * q.element_size() + maps


def _build(srcs: list[str], subdir: str = "bench_verify") -> list[tuple[ctypes.CDLL, str]]:
    """(library, ptxas report) of each source's build (the
    ``spec_verify_attention*.cu`` files beside it), its C entries bound."""
    libs = []
    for _, so, report in compile_sources(srcs, subdir, siblings="spec_verify_attention*.cu"):
        dll = ctypes.CDLL(so)
        _cuda.bind_verify(dll)
        libs.append((dll, report))
    return libs


def _call(dll, q, kc, vc, scl, valid, positions, pos_map, window, sinks, scale, softcap,
          plan=None):
    """One build's verify at layer 1 on the kernel's arguments, as a closure
    (with ``plan``, else ``verify_plan``'s); None if the build refuses the
    shape."""
    B, T, nh, dh = q.shape
    nkv = kc.shape[2]
    out = torch.empty_like(q)
    entry = "lapha_spec_verify" + ("" if scl is None else "_q8") + ("" if sinks is None else "_sink")
    ptrs = [q.data_ptr(), kc.data_ptr(), vc.data_ptr()]
    if scl is not None:
        ptrs += [scl[0].data_ptr(), scl[1].data_ptr()]
    ptrs += [valid.data_ptr(), positions.data_ptr(), pos_map.data_ptr() if window else None]
    if sinks is not None:
        ptrs.append(sinks.data_ptr())
    if plan is None:
        plan = sva.verify_plan(B, nkv, nh // nkv, T, S, _cuda.sm_count(q.device), dh=dh,
                               int8=scl is not None, smem=dll.lapha_spec_verify_smem,
                               window=window)
    fn = getattr(dll, entry)

    def run():
        # the current stream: a graph capture runs on a stream of its own
        err = fn(*ptrs, 1, SLOT, T, window, out.data_ptr(), B, nh, nkv, S, dh, float(scale),
                 float(softcap), *plan, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch refused: {err}")
        return out

    try:
        run()
    except RuntimeError:
        return None
    return run


def _sdpa(q, kc, vc, vis, scale):
    """SDPA over layer 1 with the boolean mask of what each query sees, as a
    closure (the kernel's layouts: q (B, T, nh, dh), the cache (B, nkv, S,
    dh))."""
    import torch.nn.functional as F

    qt, m = q.transpose(1, 2), vis[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kc[1], vc[1], attn_mask=m, scale=scale,
                                                  enable_gqa=True)


def _rounds(timed, card, label, bound_ms, rounds=ROUNDS) -> dict:
    """Time (name, closure) pairs in turns, ``rounds`` rounds of A B .. B A,
    print each mean beside its ratio to the first and the bound; returns
    the means."""
    times = {name: [] for name, _ in timed}
    order = timed + timed[::-1]
    for _ in range(rounds):
        for name, run in order:
            times[name].append(graph_ms(run))
    means = {name: sum(v) / len(v) for name, v in times.items()}
    base = means[timed[0][0]]
    cells = [f"{name} {means[name]:.4f} ms ({means[name] / base:.3f}x, readings "
             f"{min(times[name]):.4f}-{max(times[name]):.4f})" for name, _ in timed]
    print(f"{label}: " + "; ".join(cells) + f"; bound {bound_ms:.4f} ms [{card}]", flush=True)
    return means


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*",
                    help="spec_verify_attention.cu files, the first the base (default: the "
                         "package's)")
    ap.add_argument("--sweep", action="store_true",
                    help="time the last build under every plan at each shape")
    ap.add_argument("--unchecked", nargs="*", default=[], metavar="NAME",
                    help="builds (by directory name) timed without the check: variants that "
                         "leave work out on purpose, to see where the time goes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_verify: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]
    print(card, flush=True)
    sources = args.sources or [os.path.join(_cuda.CSRC, "spec_verify_attention.cu")]
    libs = _build(sources)
    # a build is named by its source's directory in the timing lines
    names = [os.path.basename(os.path.dirname(os.path.abspath(s))) for s in sources]
    for name, src, (_, report) in zip(names, sources, libs):
        print(f"== {name}: {src}\n{report}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = _cuda.sm_count(dev)

    for (fam, nh, nkv, dh, W, cap, with_sinks, with_q8), B, T in itertools.product(
            FAMILIES, BS, TS):
        scale = dh ** -0.5
        valid, pos_map, positions, _ = verify_geometry(gen, B, S, SLOT, T, dev)
        q = (torch.randn((B, T, nh, dh), generator=gen, device=dev) * (25.0 if cap else 1.0)
             ).to(torch.bfloat16)
        kc = torch.randn((L, B, nkv, S, dh), generator=gen, device=dev).to(torch.bfloat16)
        vc = torch.randn((L, B, nkv, S, dh), generator=gen, device=dev).to(torch.bfloat16)
        sinks = ((torch.randn(nh, generator=gen, device=dev)
                  + torch.where(torch.arange(nh, device=dev) % 2 == 0, 8.0, -8.0))
                 if with_sinks else None)
        vis = sva.verify_visible(valid, positions, SLOT, pos_map, W)
        kinds = [("", kc, vc, None)]
        if with_q8:
            (kq, ks), (vq, vs) = _quantize_kv(kc), _quantize_kv(vc)
            kinds.append(("_q8", kq, vq, (ks, vs)))
        for kind, kk, vv, scl in kinds:
            int8 = scl is not None
            label = (f"{sva.launch_name(int8, with_sinks, cap)} ({fam}) dh={dh} {nh}/{nkv} "
                     f"B={B} T={T} W={W}")
            ref = sva.spec_verify_plain(q, kk, vv, 1, SLOT, valid, positions, pos_map, W, scale,
                                        cache_scale=scl, sinks=sinks, softcap=cap).float()
            bound_ms = bound_bytes(vis, q, kk, nkv, int8, W, valid, positions, pos_map) \
                / HBM_BYTES_PER_S * 1e3

            def checked(build, run, label=label, ref=ref, int8=int8):
                if build in args.unchecked:
                    return build, run
                diff = (run().float() - ref).abs()
                again = run().clone()
                torch.cuda.synchronize()
                excess = (float((diff - 2.0 ** -7 * ref.abs()).max()) - Q8_ATOL if int8
                          else float(diff.max()) - KERNEL_ATOL)
                if not excess <= 0:
                    raise SystemExit(f"{build} {label}: max|diff| {float(diff.max())}")
                if not torch.equal(run(), again):
                    raise SystemExit(f"{build} {label}: two launches differ")
                return build, run

            builds = []
            for build, (dll, _) in zip(names, libs):
                run = _call(dll, q, kk, vv, scl, valid, positions, pos_map, W, sinks, scale, cap)
                if run is None:
                    print(f"{label}: {build} refuses the shape, skipped", flush=True)
                    continue
                builds.append(checked(build, run))
            timed = list(builds)
            if not int8 and not with_sinks and not cap:
                timed.append(("sdpa", _sdpa(q, kk, vv, vis, scale)))
            dll = libs[-1][0]
            plan = sva.verify_plan(B, nkv, nh // nkv, T, S, sms, dh=dh, int8=int8,
                                   smem=dll.lapha_spec_verify_smem, window=W)
            _rounds(timed, card, f"{label} plan {tuple(plan)}", bound_ms)
            if args.sweep:
                plans = [(f"plan {tuple(plan)}", plan)] + [
                    (f"{sp}x{st}", sva.VerifyPlan(plan.qtiles, sp, st))
                    for sp, st in itertools.product((1, 2, 4, 8), range(1, sva.MAX_STAGES + 1))
                    if (sp, st) != (plan.splits, plan.stages)]
                swept = []
                for name, pl in plans:
                    run = _call(dll, q, kk, vv, scl, valid, positions, pos_map, W, sinks,
                                scale, cap, pl)
                    if run is not None:
                        swept.append(checked(f"{names[-1]} {name}", run))
                _rounds(swept, card, f"{label} sweep", bound_ms, rounds=1)
        del q, kc, vc, kinds, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
