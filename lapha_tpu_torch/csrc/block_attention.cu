// Block diffusion's block attention, for Hopper: the C entry.
//
// Replaces no Pallas kernel. The JAX package computes this attention dense,
// with XLA einsums (lapha_tpu/models/qwen2.py:1314-1322, forward with
// block_bidir=True; its flash path cannot take the mask, :1330-1335). Its
// mask valid & ((j <= cache_pos + t) | (j >= cache_pos)) is `valid` alone,
// since every j < cache_pos is <= cache_pos + t: query t of row b sees every
// column j with kv_valid[b, j], and nothing else. The logit is the true one,
// softcapped (a runtime float, 0 = off) before the mask; a query that sees
// nothing gives 0.
//
// What bounds it on an H100: a denoise forward's block is T = 4 queries a
// row against a cache of some hundreds of valid columns, so each K/V column
// read serves group·T query rows, about 2·group·T FLOP a byte (48 at
// Qwen2.5's group of 6), far below the card's ~295 FLOP/byte ridge: it is
// bound by the bytes of the valid columns, at 3.35 TB/s. K3 (the prefill
// kernel, flash_attention.cu) ran this at 19x that bound: 128 query rows of
// one head a CTA, of which 4 were live, each KV head's panel read once for
// every one of its query heads, the holes loaded and masked, and 288 CTAs in
// three waves.
//
// The design is the verify kernel's (spec_verify_attention.cuh, points 1-4
// there), which meets the same bound at the same shape: each CTA lists the
// row's valid columns on the card with warp ballots and keeps a contiguous
// share, the shares of a row are one thread-block cluster of up to 8 CTAs
// that merge in rank order through distributed shared memory (deterministic,
// no workspace, no second launch); the group·T query rows sit on mma.sync's
// n8 side with the columns on M (Sᵀ = K·Qᵀ, Oᵀ = Vᵀ·Pᵀ), so a KV head's
// panel is read once for its whole block, more query tiles where group·T
// exceeds 32 rows (16 at dh 256); each warp feeds itself through a ring of
// 16-byte cp.async copies. Holes and the columns past the prompt are never
// read. wgmma is not used: 24 live rows fill little of its 64-row M, and the
// work is bound by bytes. The kernel is the verify header's with two
// compile-time switches on (kPf: the prefill layout, kBidir: no causal new
// columns) rather than a header of its own, so the two share one body and
// one plan; its instances sit in this source, so that it compiles beside
// the four verify sources.

#include "spec_verify_attention.cuh"

// q (B, T, nh, dh) bf16; k, v: one layer of the (L, B, S, nkv, dh) bf16 cache
// (a zero-copy view, (B, S, nkv, dh) contiguous); kv_valid (B, S) one byte a
// column; out (B, T, nh, dh) bf16. The plan (qtiles, splits, stages) comes
// from the host's ops/block_attention.block_plan, sized by
// lapha_spec_verify_smem (the same Layout).
extern "C" int lapha_block_attention(const void* q, const void* k, const void* v,
                                     const void* kv_valid, int T, void* out, int B, int nh,
                                     int nkv, int S, int dh, float scale, float softcap,
                                     int qtiles, int splits, int stages, void* stream) {
  return launch<false, false, true, true>(q, k, v, nullptr, nullptr, kv_valid, nullptr, nullptr,
                                          nullptr, 0, 0, T, 0, out, B, nh, nkv, S, dh, scale,
                                          softcap, qtiles, splits, stages, stream);
}
