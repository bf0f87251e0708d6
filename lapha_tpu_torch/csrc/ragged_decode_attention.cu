// Ragged one-token decode attention over the stacked decode cache, for Hopper.
//
// Replaces the four entries of the Pallas kernel in
// lapha_tpu/ops/ragged_decode_attention.py (one pallas_call, :410, called
// from ragged_decode_attention :270): the bf16 cache, _kernel :68 ->
// _kernel_impl :108, the int8 cache, _kernel_q8 :86 (template flag kQ8), and
// both with attention sinks, _kernel_sink :77 and _kernel_q8_sink :96 (flag
// kSink). Row b's query group attends only to cache slots
// [pstart[b], lens[b]) ∪ [dstart[b], slot] of layer `layer` in the
// (L, B, nkv, S, dh) decode cache; nothing else of the cache is read.
//
// The semantics are the Pallas kernel's:
// - The two segments are admitted separately, as a list of n = n1 + n2
//   valid slots: the prompt's n1 = lens - pstart, then the decode columns'
//   n2 = slot - dstart + 1 (bad lengths clamped to the panel). A 64-slot
//   chunk that the prompt tail and the decode start share is never counted
//   twice, since nothing walks chunks of the cache.
// - int8 cache (kQ8): K/V int8 with one f32 scale per (layer, row, head,
//   slot) in (L, B, nkv, S) planes. The K scale multiplies each logit
//   (q·k times the attention scale), the softmax denominator is summed from
//   the unscaled p, and P·V uses p·vs (:221-222, :239-246).
// - Attention sinks (kSink, GPT-OSS): one learned logit per query head, an
//   extra softmax column of zero value (:186-201). It enters once, in the
//   final merge: (m, l) = (max(m, sink), l·e^(m-M) + e^(sink-M)). A row
//   that sees no key gives 0, with or without a sink.
// - Logit softcap (Gemma-2; a runtime float, 0 = off): each true logit s
//   (after the attention scale and the K scale) becomes cap·tanh(s/cap)
//   before the mask, as JAX's dense decode applies it.
// - Sliding-window layers need no flag: the caller clips pstart and dstart
//   to the window, so the two segments hold exactly the banded slots.
//
// What bounds it on an H100: one query token per row does 2 FLOP per byte
// of K/V read (2·group for a GQA group), far below the card's ~295
// FLOP/byte ridge, so it is bound by the bytes of the valid slots at
// 3.35 TB/s — a few microseconds at the served shapes, where a launch and
// one trip to device memory are most of the time. The design:
//
// 1. The row's valid slots are split over a thread-block cluster. The grid
//    is (B, nkv, splits), the cluster (1, 1, splits), splits a power of two
//    <= 8 planned on the host (ops/ragged_decode_attention.split_plan: 1
//    where B·nkv fills the card, 4 at Gemma-3's 24 x 1). Each CTA reads
//    lens, pstart and dstart itself and takes the contiguous share
//    [n·r/splits, n·(r+1)/splits) of the row's list; an empty share gives
//    m = -inf, l = 0. After the walk every CTA merges its warps' partials
//    (m, l, acc) in its own shared memory and pushes them through
//    distributed shared memory into the inboxes of the slices' owners: CTA
//    r owns slice r of the (head, dim) outputs. After one cluster barrier
//    each CTA merges its slice over the ranks in order, folds the sink in
//    once and writes it. Deterministic, no workspace, no second launch.
//    (A first version pulled the partials after the barrier, which took a
//    second barrier to keep them alive: level at 2-4 splits, 4-17% slower
//    at 6-8 in bench_k4's sweeps.)
// 2. The whole GQA group is in one CTA, over one copy of the slots: a CTA
//    takes 8 heads (group <= 8) or 16 (instance NTW = 2), so StarCoder2's
//    12 read their KV head once; a group above 16 takes ceil(group / 16)
//    CTAs a KV head on grid.y, each reading the slots (no served model has
//    one; the rereads hit L2 when the CTAs run together).
// 3. The products run on the tensor cores with the slots on M and the query
//    heads on the narrow side: mma.sync m16n8k16 Sᵀ = K·Qᵀ gives 16 slots x
//    8 heads a fragment (Q held in registers as B fragments for the whole
//    walk), and Oᵀ = Vᵀ·Pᵀ takes Pᵀ straight from Sᵀ's fragment: the bf16
//    pair of P for (slot g, heads 2t4, 2t4+1) transposed by movmatrix is
//    the B fragment (slots 2t4, 2t4+1; head g); V comes by ldmatrix.trans.
//    A lane's softmax state is per head of its columns, which are the same
//    heads in both products, so rescaling the accumulator needs no shuffle.
//    mma.sync rather than wgmma: a warp owns 16 slots (wgmma's M is 64 rows
//    of a warpgroup), so each warp runs its own online softmax over its
//    pieces with no barrier between warps, and the products are a small
//    share of the time.
// 4. Each of the 4 warps owns every 4th 16-slot piece of the CTA's share and
//    feeds itself through its own ring of `nst` stages (<= 4, host-chosen)
//    of 16-byte cp.async copies, zero-filled past the share: pieces j+1 ..
//    j+nst-1 are in flight while piece j is computed, and a stage costs one
//    __syncwarp, no CTA barrier. Rows in shared memory are padded by 16
//    bytes to an odd number of 16-byte units, which keeps ldmatrix's 8 rows
//    of one matrix on 8 distinct bank groups at every head dim (a 128-byte
//    XOR swizzle would not cover dh 96's 12 units).
// 5. int8 (kQ8) is converted in registers, never staged as bf16: ldmatrix
//    of the int8 rows gives a lane 4 bytes, which become two bf16x2 words by
//    byte permutes into 2^23 + (v + 128) and one subtraction (exact). For K
//    a lane's bytes are dims 4t4..4t4+3 of a 16-dim step, so Q's B
//    fragments take the same order of dims (a product may order its k
//    axis as it likes); for V, ldmatrix.trans gives dims 2g, 2g+1 of slots
//    2t4, 2t4+1, so Oᵀ's rows g and g+8 of an m-tile are dims 2g and
//    2g+1. The K scale goes on Sᵀ's rows, the V scale into p, and p·vs
//    enters P·V as two bf16 terms, its rounding and the rest: the int8
//    values are exact in bf16, so the product keeps f32's accuracy where
//    a row's terms cancel (one bf16 P missed the int8 rule's 5e-3 floor
//    there by 2.6e-4, softcapped logits at dh 64).
//
// Every instance: DH 64, 96, 128, 256 x {bf16, int8} x {sinks or not} x
// NTW (1: up to 8 heads a CTA, 2: 16), the softcap a runtime float. Shared
// memory: 4 warps x nst stages of a 16-slot piece's K and V (bf16: 64·(DH+8)
// bytes a stage, 16.5 KB at dh 256, which caps nst at 3 there), the
// merge's partials reusing the ring, and with splits > 1 an inbox of
// (16·DH + 8·(2·16 + 1)) f32 at most.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace lapha;  // common.cuh's mma.sync, hopper.cuh's cp.async, ldmatrix, clusters
using bf16 = __nv_bfloat16;

constexpr int NW = 4;             // warps per CTA
constexpr int NTH = 32 * NW;      // threads per CTA
constexpr int PIECE = 16;         // slots a warp takes at a time: the mma's M
constexpr int MAX_SPLITS = 8;     // a row's splits are one cluster: at most 8 CTAs (portable)
constexpr int MAX_STAGES = 4;     // ring stages per warp
constexpr int SMEM_LIMIT = 227 * 1024;

// Shared-memory layout of one CTA. The ring: warp w's stage s at
// (w·nst + s)·STAGE, holding the piece's K rows, then V rows (ROW bytes
// each, an odd number of 16-byte units), then (kQ8) its 16 K and 16 V
// scales. The merge reuses the ring for the warps' accumulators
// (NW x HW heads x DH f32, rows LDP apart), then a tail of small arrays,
// then (splits > 1) the inbox the cluster's CTAs push into: each rank's
// (m, l) of every head and its part of this CTA's slice of the outputs.
template <int DH, bool kQ8, int NTW>
struct Layout {
  static constexpr int HW = 8 * NTW;                  // heads a CTA
  static constexpr int ROW = kQ8 ? DH + 16 : 2 * DH + 16;
  static constexpr int KV = PIECE * ROW;
  static constexpr int STAGE = 2 * KV + (kQ8 ? 2 * PIECE * 4 : 0);
  static constexpr int LDP = DH + 4;                   // f32 row of one head's accumulator
  static constexpr int ACC = NW * HW * LDP * 4;
  // tail (f32): pm, pl, pf (NW x HW each: the warps' max, sum, factor), cm,
  // cl (HW each: the CTA's), cf (MAX_SPLITS x HW: the cluster's factors)
  static constexpr int TAIL = (3 * NW * HW + 2 * HW + MAX_SPLITS * HW) * 4;
  // inbox (f32): MAX_SPLITS x HW (m, l) pairs, then the slice's partials,
  // splits x ceil(HW·DH / splits) <= HW·DH + MAX_SPLITS
  static constexpr int INBOX = (2 * MAX_SPLITS * HW + HW * DH + MAX_SPLITS) * 4;
  __host__ __device__ static constexpr int tail_at(int nst) {
    return NW * nst * STAGE > ACC ? NW * nst * STAGE : ACC;
  }
  static constexpr int smem(int nst, int splits) {
    return tail_at(nst) + TAIL + (splits > 1 ? INBOX : 0);
  }
  static constexpr int max_stages() {
    return smem(MAX_STAGES, 2) <= SMEM_LIMIT ? MAX_STAGES
           : smem(3, 2) <= SMEM_LIMIT        ? 3
                                             : 2;
  }
};

// int8 bytes of r as f32, exactly: r ^ 0x80808080 holds v + 128 a byte; a
// byte permute puts it under the exponent of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ float i8_at(uint32_t u, int k) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + k)) - 8388736.f;
}

// 4 int8 -> bf16 pairs (bytes 0, 1) and (2, 3): a K fragment's two k pairs
__device__ __forceinline__ void i8_k(uint32_t r, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = r ^ 0x80808080u;
  lo = pack_f32(i8_at(u, 0), i8_at(u, 1));
  hi = pack_f32(i8_at(u, 2), i8_at(u, 3));
}

// 4 int8 -> bf16 pairs (bytes 0, 2) and (1, 3): ldmatrix.trans's (slot 2t4,
// dims 2g, 2g+1; slot 2t4+1, same dims) as dim 2g's and dim 2g+1's slot pair
__device__ __forceinline__ void i8_v(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  even = pack_f32(i8_at(u, 0), i8_at(u, 2));
  odd = pack_f32(i8_at(u, 1), i8_at(u, 3));
}

__device__ __forceinline__ void wait_ring(int nst) {
  // the oldest of the nst - 1 groups in flight has landed (this thread's copies)
  switch (nst) {
    case 1: cp_async_wait<0>(); break;
    case 2: cp_async_wait<1>(); break;
    case 3: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

template <int DH, bool kQ8, bool kSink, int NTW>
__global__ void __launch_bounds__(NTH)
ragged_decode_kernel(const bf16* __restrict__ q,           // (B, nh, DH)
                     const void* __restrict__ kc_,         // (L, B, nkv, S, DH) bf16 or int8
                     const void* __restrict__ vc_,
                     const float* __restrict__ ks,         // (L, B, nkv, S) scales (kQ8)
                     const float* __restrict__ vs,
                     const int* __restrict__ lens, const int* __restrict__ dstart,
                     const int* __restrict__ pstart,
                     const float* __restrict__ sinks,      // (nh,) (kSink)
                     int layer, int slot,
                     bf16* __restrict__ out,               // (B, nh, DH)
                     int nh, int nkv, int S, float scale, float softcap, int nst) {
  using Lay = Layout<DH, kQ8, NTW>;
  constexpr int HW = Lay::HW, ROW = Lay::ROW, LDP = Lay::LDP;
  constexpr int KS = DH / 16;                       // k-steps of Sᵀ, m-tiles of Oᵀ
  constexpr int ESZ = kQ8 ? 1 : 2;                  // bytes of a cache element
  constexpr int UPR = DH * ESZ / 16;                // 16-byte units of a cache row
  extern __shared__ __align__(128) unsigned char smem[];
  float* pacc = reinterpret_cast<float*>(smem);     // the merge's accumulators (reuse the ring)
  float* pm = reinterpret_cast<float*>(smem + Lay::tail_at(nst));
  float* pl = pm + NW * HW;
  float* pf = pl + NW * HW;
  float* cm = pf + NW * HW;
  float* cl = cm + HW;
  float* cf = cl + HW;
  float* in_ml = cf + MAX_SPLITS * HW;     // inbox: rank r's (m, l) of head h at 2(r·HW + h)
  float* in_acc = in_ml + 2 * MAX_SPLITS * HW;  // rank r's part of the slice at r·per

  // grid (B, nkv x passes, splits): row b, KV head hk, heads h0 .. h0 + HW
  // of its group, share `rank` of the row's slots
  const int group = nh / nkv, passes = (group + HW - 1) / HW;
  const int b = blockIdx.x, B = gridDim.x;
  const int hk = blockIdx.y / passes, h0 = (blockIdx.y % passes) * HW;
  const int splits = gridDim.z, rank = blockIdx.z;  // cluster (1, 1, splits): rank = z
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  if (splits > 1) cluster_arrive_relaxed();  // waited for before the first push

  // the row's valid slots as one list: the prompt's [p0, p0 + n1), then the
  // decode columns' [d0, d0 + n2), clamped to the panel; this CTA's share of
  // it is [lo, hi)
  const int p0 = max(pstart[b], 0);
  const int n1 = max(min(lens[b], S) - p0, 0);
  const int d0 = max(dstart[b], 0);
  const int n2 = max(slot + 1 - d0, 0);
  const int n = n1 + n2;
  const int lo = static_cast<int>(static_cast<long long>(n) * rank / splits);
  const int hi = static_cast<int>(static_cast<long long>(n) * (rank + 1) / splits);
  const int pieces = (hi - lo + PIECE - 1) / PIECE;
  const int mine = pieces > warp ? (pieces - warp + NW - 1) / NW : 0;  // pieces w, w+4, ...

  const size_t panel = (static_cast<size_t>(layer) * B + b) * nkv + hk;
  const unsigned char* kbase = static_cast<const unsigned char*>(kc_) + panel * S * DH * ESZ;
  const unsigned char* vbase = static_cast<const unsigned char*>(vc_) + panel * S * DH * ESZ;
  unsigned char* ring = smem + warp * nst * Lay::STAGE;

  // piece `pc` of the CTA's share (slots lo + 16pc ..) into stage `st` of this warp's ring
  auto issue = [&](int pc, int st) {
    unsigned char* sk = ring + st * Lay::STAGE;
    unsigned char* sv = sk + Lay::KV;
    const int base = lo + pc * PIECE;
#pragma unroll
    for (int it = 0; it < PIECE * UPR / 32; ++it) {  // PIECE·UPR = 2·DH (bf16) or DH units
      const int u = lane + 32 * it, r = u / UPR, c = u % UPR, i = base + r;
      const bool ok = i < hi;
      const size_t off = ok ? static_cast<size_t>(i < n1 ? p0 + i : d0 + (i - n1)) * DH * ESZ +
                                  c * 16
                            : 0;
      cp_async16(sk + r * ROW + c * 16, kbase + off, ok);
      cp_async16(sv + r * ROW + c * 16, vbase + off, ok);
    }
    if constexpr (kQ8) {
      const int i = base + (lane & 15);
      const bool ok = i < hi;
      const size_t at = panel * S + (ok ? (i < n1 ? p0 + i : d0 + (i - n1)) : 0);
      cp_async4(reinterpret_cast<float*>(sv + Lay::KV) + lane, (lane < 16 ? ks : vs) + at, ok);
    }
  };

#pragma unroll 1
  for (int j = 0; j < nst - 1; ++j) {
    if (j < mine) issue(warp + NW * j, j);
    cp_async_commit();
  }

  // Q of heads h0 + 8nt + g as B fragments of the k-steps: dims (2t4, 2t4
  // + 1) and (2t4 + 8, 2t4 + 9) of the step for a bf16 cache; for an int8
  // one (4t4, 4t4 + 1) and (4t4 + 2, 4t4 + 3), K's order (kQ8 above)
  uint32_t qf[KS][NTW][2];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int h = h0 + 8 * nt + g;
    const bf16* qh = q + (static_cast<size_t>(b) * nh + hk * group + min(h, group - 1)) * DH;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int d = 16 * kk + (kQ8 ? 4 * t4 : 2 * t4);
      qf[kk][nt][0] = h < group ? ld_u32(qh + d) : 0u;
      qf[kk][nt][1] = h < group ? ld_u32(qh + d + (kQ8 ? 2 : 8)) : 0u;
    }
  }

  float acc[KS][NTW][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // online softmax of heads 8nt + 2t4 + c: max (the same in every lane of
  // the head) and this lane's share of the sum (its rows only)
  float m_run[NTW][2], l_run[NTW][2];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    m_run[nt][0] = m_run[nt][1] = NEG;
    l_run[nt][0] = l_run[nt][1] = 0.f;
  }

#pragma unroll 1
  for (int j = 0; j < mine; ++j) {
    const int jn = j + nst - 1;
    if (jn < mine) issue(warp + NW * jn, jn % nst);
    cp_async_commit();
    wait_ring(nst);
    __syncwarp();
    const unsigned char* sk = ring + (j % nst) * Lay::STAGE;
    const unsigned char* sv = sk + Lay::KV;
    const int base = lo + (warp + NW * j) * PIECE;

    // Sᵀ (16 slots x 8 heads a tile) = K · Qᵀ
    float s[NTW][4];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    if constexpr (kQ8) {
#pragma unroll
      for (int p = 0; p < DH / 32; ++p) {  // two k-steps an ldmatrix
        uint32_t r[4], a[4];
        ldsm_x4(r, sk + (lane & 15) * ROW + 32 * p + (lane >> 4) * 16);
        i8_k(r[0], a[0], a[2]);
        i8_k(r[1], a[1], a[3]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          mma_bf16_16816(s[nt], a, qf[2 * p][nt][0], qf[2 * p][nt][1]);
        i8_k(r[2], a[0], a[2]);
        i8_k(r[3], a[1], a[3]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          mma_bf16_16816(s[nt], a, qf[2 * p + 1][nt][0], qf[2 * p + 1][nt][1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, sk + (lane & 15) * ROW + (16 * kk + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma_bf16_16816(s[nt], a, qf[kk][nt][0], qf[kk][nt][1]);
      }
    }

    // logits of rows g, g + 8 (kQ8: times the K scale), capped, masked past
    // the share; the online softmax per head column; P (kQ8: times the V
    // scale) rounded to bf16 and transposed into Pᵀ's B fragments
    const float* sc = reinterpret_cast<const float*>(sv + Lay::KV);
    const bool ok0 = base + g < hi, ok1 = base + g + 8 < hi;
    const float kscl0 = kQ8 ? sc[g] * scale : scale, kscl1 = kQ8 ? sc[g + 8] * scale : scale;
    uint32_t pb[NTW][2], pr[NTW][2];  // P in bf16; kQ8: what the rounding left
    float alpha[NTW][2];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * (e < 2 ? kscl0 : kscl1);
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        s[nt][e] = (e < 2 ? ok0 : ok1) ? x : NEG;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = fmaxf(s[nt][c], s[nt][2 + c]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m_run[nt][c], mx);
        alpha[nt][c] = __expf(m_run[nt][c] - m_new);
        p[c] = s[nt][c] > 0.5f * NEG ? __expf(s[nt][c] - m_new) : 0.f;
        p[2 + c] = s[nt][2 + c] > 0.5f * NEG ? __expf(s[nt][2 + c] - m_new) : 0.f;
        l_run[nt][c] = l_run[nt][c] * alpha[nt][c] + p[c] + p[2 + c];
        m_run[nt][c] = m_new;
      }
      if constexpr (kQ8) {
        const float v0 = sc[PIECE + g], v1 = sc[PIECE + g + 8];
        p[0] *= v0;
        p[1] *= v0;
        p[2] *= v1;
        p[3] *= v1;
      }
      uint32_t w[2] = {pack_f32(p[0], p[1]), pack_f32(p[2], p[3])};
      pb[nt][0] = movmatrix_t(w[0]);  // slots 2t4, 2t4+1 of head g
      pb[nt][1] = movmatrix_t(w[1]);  // slots 2t4+8, 2t4+9
      if constexpr (kQ8) {
        // int8 values are exact in bf16: P·V is as exact as P, so P goes in
        // as bf16 hi + lo (the int8 rule's 5e-3 floor has no room for
        // P's own 2^-9 where the terms of a row cancel)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          pr[nt][i] = movmatrix_t(pack_f32(p[2 * i] - r.x, p[2 * i + 1] - r.y));
        }
      }
    }

    // Oᵀ (dims x heads) = Oᵀ·alpha + Vᵀ · Pᵀ
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
        acc[mt][nt][0] *= alpha[nt][0];
        acc[mt][nt][1] *= alpha[nt][1];
        acc[mt][nt][2] *= alpha[nt][0];
        acc[mt][nt][3] *= alpha[nt][1];
      }
    if constexpr (kQ8) {
#pragma unroll
      for (int mp = 0; mp < KS / 2; ++mp) {  // two m-tiles (32 dims) an ldmatrix
        uint32_t r[4], a[4];
        ldsm_x4_t(r, sv + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW + 32 * mp +
                         (lane >> 4) * 16);
        i8_v(r[0], a[0], a[1]);
        i8_v(r[1], a[2], a[3]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          mma_bf16_16816(acc[2 * mp][nt], a, pb[nt][0], pb[nt][1]);
          mma_bf16_16816(acc[2 * mp][nt], a, pr[nt][0], pr[nt][1]);
        }
        i8_v(r[2], a[0], a[1]);
        i8_v(r[3], a[2], a[3]);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          mma_bf16_16816(acc[2 * mp + 1][nt], a, pb[nt][0], pb[nt][1]);
          mma_bf16_16816(acc[2 * mp + 1][nt], a, pr[nt][0], pr[nt][1]);
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < KS; ++mt) {
        uint32_t a[4];
        ldsm_x4_t(a, sv + ((lane & 7) + ((lane >> 4) << 3)) * ROW +
                         (16 * mt + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) mma_bf16_16816(acc[mt][nt], a, pb[nt][0], pb[nt][1]);
      }
    }
    __syncwarp();  // every lane is done with the stage before it is refilled
  }
  cp_async_wait<0>();

  // ---------------- merge: the CTA's warps, then (splits > 1) the cluster
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float l = l_run[nt][c];
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      l_run[nt][c] = l;
    }
  __syncthreads();  // every warp is done with its ring: the accumulators take its memory
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // bf16: rows g, g + 8 are dims 16mt + g, + 8; int8: 16mt + 2g, + 1
        const int d = kQ8 ? 16 * mt + 2 * g + (e >> 1) : 16 * mt + g + 8 * (e >> 1);
        const int h = 8 * nt + 2 * t4 + (e & 1);
        pacc[(warp * HW + h) * LDP + d] = acc[mt][nt][e];
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        pm[warp * HW + 8 * nt + 2 * t4 + c] = m_run[nt][c];
        pl[warp * HW + 8 * nt + 2 * t4 + c] = l_run[nt][c];
      }
  }
  __syncthreads();
  const int heads = min(HW, group - h0);
  if (tid < HW) {
    // the CTA's (m, l) of head tid and each warp's factor; with one split
    // the sink and 1/l fold in here
    const int h = tid;
    float M = NEG;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, pm[w * HW + h]);
    float L = 0.f;
    for (int w = 0; w < NW; ++w) L += pl[w * HW + h] * __expf(pm[w * HW + h] - M);
    float f = 1.f;
    if (splits == 1) {
      if (kSink && h < heads) {
        const float sink = sinks[hk * group + h0 + h];
        const float Ms = fmaxf(M, sink);
        L = L * __expf(M - Ms) + __expf(sink - Ms);
        M = Ms;
      }
      f = L > 0.f ? 1.f / L : 0.f;
    }
    for (int w = 0; w < NW; ++w) pf[w * HW + h] = __expf(pm[w * HW + h] - M) * f;
    cm[h] = M;
    cl[h] = L;
  }
  __syncthreads();
  bf16* og = out + (static_cast<size_t>(b) * nh + hk * group + h0) * DH;
  // splits > 1: CTA r owns slice r of the (head, dim) outputs, [r·per,
  // (r+1)·per); every CTA pushes its part of each slice, and its (m, l)
  // of every head, into the owner's inbox at its own rank
  const int total = heads * DH, per = (total + splits - 1) / splits;
  if (splits > 1) cluster_wait();  // every peer has started
  if (splits > 1 && tid < HW) {
    for (int r = 0; r < splits; ++r) {
      st_cluster_f32(in_ml + 2 * (rank * HW + tid), r, cm[tid]);
      st_cluster_f32(in_ml + 2 * (rank * HW + tid) + 1, r, cl[tid]);
    }
  }
  for (int e = tid; e < HW * DH; e += NTH) {
    const int h = e / DH, d = e % DH;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) v += pacc[(w * HW + h) * LDP + d] * pf[w * HW + h];
    if (splits == 1) {
      if (h < heads) og[h * DH + d] = __float2bfloat16(v);
    } else if (e < total) {
      const int owner = e / per;
      st_cluster_f32(in_acc + rank * per + e - owner * per, owner, v);
    }
  }
  if (splits > 1) {
    cluster_sync();  // every push has landed; no CTA touches a peer's memory after it
    if (tid < HW) {
      // head tid over the ranks in order, the sink once: the factors of
      // each rank's part, 1/l folded in
      const int h = tid;
      const float sink = kSink && h < heads ? sinks[hk * group + h0 + h] : NEG;
      float M = sink;
      for (int r = 0; r < splits; ++r) M = fmaxf(M, in_ml[2 * (r * HW + h)]);
      float L = kSink && h < heads ? __expf(sink - M) : 0.f;
      for (int r = 0; r < splits; ++r) {
        const float f = __expf(in_ml[2 * (r * HW + h)] - M);
        cf[r * HW + h] = f;
        L += in_ml[2 * (r * HW + h) + 1] * f;
      }
      const float inv = L > 0.f ? 1.f / L : 0.f;
      for (int r = 0; r < splits; ++r) cf[r * HW + h] *= inv;
    }
    __syncthreads();
    const int e_lo = rank * per, e_hi = min(total, e_lo + per);
    for (int e = e_lo + tid; e < e_hi; e += NTH) {
      const int h = e / DH;
      float v = 0.f;
      for (int r = 0; r < splits; ++r) v += in_acc[r * per + e - e_lo] * cf[r * HW + h];
      og[e] = __float2bfloat16(v);
    }
  }
}

template <int DH, bool kQ8, bool kSink, int NTW>
int launch_inst(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
                const float* v_scale, const int* lens, const int* dstart, const int* pstart,
                const float* sinks, int layer, int slot, void* out, int B, int nh, int nkv, int S,
                float scale, float softcap, int splits, int nst, cudaStream_t stream) {
  using Lay = Layout<DH, kQ8, NTW>;
  const auto kernel = ragged_decode_kernel<DH, kQ8, kSink, NTW>;
  nst = nst < Lay::max_stages() ? nst : Lay::max_stages();
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t opt_in = smem_opt_in(kernel, Lay::smem(Lay::max_stages(), 2), opted_in);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  cudaLaunchConfig_t cfg = {};
  constexpr int HW = Lay::HW;
  cfg.gridDim = dim3(B, nkv * ((nh / nkv + HW - 1) / HW), splits);  // a CTA per HW heads
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = Lay::smem(nst, splits);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;  // a row's splits: one cluster
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), k_cache, v_cache, k_scale, v_scale, lens, dstart,
      pstart, sinks, layer, slot, static_cast<bf16*>(out), nh, nkv, S, scale, softcap, nst));
}

template <bool kQ8, bool kSink>
int launch(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
           const float* v_scale, const int* lens, const int* dstart, const int* pstart,
           const float* sinks, int layer, int slot, void* out, int B, int nh, int nkv, int S,
           int dh, float scale, float softcap, int splits, int stages, void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || B <= 0 || slot < 0 || slot >= S || splits < 1 ||
      splits > MAX_SPLITS || stages < 1 || stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = nh / nkv > 8;  // 16 heads a CTA
#define LAPHA_RD(DH)                                                                          \
  if (dh == DH)                                                                               \
    return wide ? launch_inst<DH, kQ8, kSink, 2>(q, k_cache, v_cache, k_scale, v_scale, lens, \
                                                 dstart, pstart, sinks, layer, slot, out, B,  \
                                                 nh, nkv, S, scale, softcap, splits, stages, st) \
                : launch_inst<DH, kQ8, kSink, 1>(q, k_cache, v_cache, k_scale, v_scale, lens, \
                                                 dstart, pstart, sinks, layer, slot, out, B,  \
                                                 nh, nkv, S, scale, softcap, splits, stages, st);
  LAPHA_RD(64)
  LAPHA_RD(96)
  LAPHA_RD(128)
  LAPHA_RD(256)
#undef LAPHA_RD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// `splits` (1..8 CTAs a row and KV head, one cluster) and `stages` (1..4 ring
// stages a warp, fewer where they would not fit) come from the host's plan,
// ops/ragged_decode_attention.split_plan.
extern "C" int lapha_ragged_decode(const void* q, const void* k_cache, const void* v_cache,
                                   const int* lens, const int* dstart, const int* pstart,
                                   int layer, int slot, void* out, int B, int nh, int nkv, int S,
                                   int dh, float scale, float softcap, int splits, int stages,
                                   void* stream) {
  return launch<false, false>(q, k_cache, v_cache, nullptr, nullptr, lens, dstart, pstart,
                              nullptr, layer, slot, out, B, nh, nkv, S, dh, scale, softcap,
                              splits, stages, stream);
}

extern "C" int lapha_ragged_decode_q8(const void* q, const void* k_cache, const void* v_cache,
                                      const float* k_scale, const float* v_scale,
                                      const int* lens, const int* dstart, const int* pstart,
                                      int layer, int slot, void* out, int B, int nh, int nkv,
                                      int S, int dh, float scale, float softcap, int splits,
                                      int stages, void* stream) {
  return launch<true, false>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart, pstart,
                             nullptr, layer, slot, out, B, nh, nkv, S, dh, scale, softcap,
                             splits, stages, stream);
}

// sinks: (nh,) f32 sink logits, one per query head
extern "C" int lapha_ragged_decode_sink(const void* q, const void* k_cache, const void* v_cache,
                                        const int* lens, const int* dstart, const int* pstart,
                                        const float* sinks, int layer, int slot, void* out,
                                        int B, int nh, int nkv, int S, int dh, float scale,
                                        float softcap, int splits, int stages, void* stream) {
  return launch<false, true>(q, k_cache, v_cache, nullptr, nullptr, lens, dstart, pstart, sinks,
                             layer, slot, out, B, nh, nkv, S, dh, scale, softcap, splits, stages,
                             stream);
}

extern "C" int lapha_ragged_decode_q8_sink(const void* q, const void* k_cache,
                                           const void* v_cache, const float* k_scale,
                                           const float* v_scale, const int* lens,
                                           const int* dstart, const int* pstart,
                                           const float* sinks, int layer, int slot, void* out,
                                           int B, int nh, int nkv, int S, int dh, float scale,
                                           float softcap, int splits, int stages, void* stream) {
  return launch<true, true>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart, pstart, sinks,
                            layer, slot, out, B, nh, nkv, S, dh, scale, softcap, splits, stages,
                            stream);
}
