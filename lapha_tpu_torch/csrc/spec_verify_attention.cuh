// T-token verify attention of speculative decoding over the decode cache, for
// Hopper.
//
// Replaces no Pallas kernel. The JAX package computes this function dense,
// with XLA einsums (lapha_tpu/models/qwen2.py:1878-1912, inside
// decode_step_multi); it was added because the port runs decode attention on
// the card through a kernel, and neither of its attention kernels takes this
// validity: rejected drafts leave permanent holes in a row's decode columns,
// so what a row may read is a per-row bitmap `valid_map` (B, S), not the two
// ranges of the ragged decode kernel (K4/K5), and K3 reads the prefill layout,
// no int8 cache and bands by column, which the holes break.
//
// Query t (0 <= t < T) of row b sits at position positions[b, t] and sees
// column j of layer `layer` in the (L, B, nkv, S, dh) decode cache iff
//     valid_map[b, j]  or  slot <= j <= slot + t
// (the row's stored columns, then the block's new columns causally), and,
// with window W > 0, also pos_col[b, j] > positions[b, t] - W, where pos_col
// is pos_map except that the new columns [slot, slot + T) take
// positions[b, j - slot] (qwen2.py:1814-1830). The logit is the true one:
// q.k times the attention scale and, on an int8 cache, the K scale; the
// softcap (Gemma-2) caps it before the mask; GPT-OSS's sinks are an extra
// softmax column of zero value, folded in once at the end; an int8 cache's V
// scale multiplies the probabilities. A query that sees nothing gives 0.
//
// What bounds it on an H100: each K/V column read serves group·T queries,
// about 2·group·T FLOP a byte (48 at Qwen2.5's group of 6 and T = 4), far
// below the card's ~295 FLOP/byte ridge, so it is bound by the bytes of the
// columns some query sees, at 3.35 TB/s: a few microseconds at the served
// shapes. The design follows the ragged decode kernel's
// (ragged_decode_attention.cu, points 1-5 there):
//
// 1. The row's live columns are split over a thread-block cluster. The grid
//    is (B, nkv x qtiles, splits), the cluster (1, 1, splits), splits a power
//    of two <= 8 and qtiles planned on the host from shapes alone
//    (ops/spec_verify_attention.verify_plan). Each CTA lists the row's live
//    columns itself: a column is live if it is one of the block's new ones,
//    or valid and (with a window) inside the window of the block's earliest
//    query. Warp ballots give a 32-column word's bits, one warp's prefix
//    count the words' offsets, and each lane writes its own column's entry,
//    so the list is built in parallel and only the CTA's contiguous share
//    [n·r/splits, n·(r+1)/splits) of the n entries is kept. An empty share
//    gives m = -inf, l = 0. Holes, the prompt's padding, the columns past
//    the block and (windowed) those out of every query's window are never
//    read. The CTAs push their merged (m, l, acc) through distributed shared
//    memory into the inboxes of the slices' owners; after one cluster
//    barrier each owner merges its slice of the (query, dim) outputs over
//    the ranks in order, folds the sink in once and writes it.
//    Deterministic, no workspace, no second launch.
// 2. A KV head's panel is read once for its whole block of group·T query
//    rows (row r = t·group + h): the products run with the columns on
//    mma.sync's M and the query rows on the n8 side, Sᵀ = K·Qᵀ, then Oᵀ =
//    Vᵀ·Pᵀ with Pᵀ taken from Sᵀ's fragment by movmatrix, as K4 does. A CTA
//    holds NTW n8 tiles (1 to 4: up to 32 rows, 16 at dh 256, where the
//    accumulators Oᵀ (DH/16 x NTW fragments of 4 f32 a lane) would no longer
//    fit the registers); a larger block takes `qtiles` CTAs a KV head on
//    grid.y, each rereading the columns (from L2 when they run together).
//    Q sits in shared memory and its B fragments are loaded with the K tile
//    (ldmatrix; an int8 cache's reordered dims as 8-byte loads).
// 3. Each of the 4 warps owns every 4th 16-column piece of the CTA's share
//    and feeds itself through its own ring of `nst` stages (<= 4, host-
//    chosen) of 16-byte cp.async copies of the listed columns' K and V rows
//    (int8: + their K and V scales), a __syncwarp a stage and no CTA barrier
//    in the walk. The mask needs no global memory there: a list entry holds
//    the column, or -(c + 1) for a new column c that only queries t >= c
//    see, and (windowed) the column's position sits beside it; each query
//    row's t and its position - W sit in shared memory once.
// 4. The arithmetic: the K scale on the logit, the V scale in p, which
//    enters P·V as two bf16 terms (its rounding and the rest: int8 values
//    are exact in bf16), the exact int8 conversion in registers, the
//    softcap before the mask, the sink folded in once, 0 for a query that
//    sees nothing. Fixed order everywhere: two launches give the same bits.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (bench_verify.py, PERF.md
// §6): the launch alone is
// ~2 us and the list ~3.5 us more, which is why the list's loads are issued
// in one batch; an L2 prefetch of each CTA's span before the list was
// slower, and a deeper ring gains nothing where it costs a CTA an SM.
//
// Every instance: DH 64, 96, 128, 256 x {bf16, int8} x {sinks or not} x NTW
// (1-4; 1, 2 at DH 256), the softcap a runtime float. Shared memory: the
// Q tile, each row's (t, position - W, output row, sink), the merge's tail,
// the inbox with splits > 1, a region holding first the list-building
// scratch (two masks and an offset a word), then the warps' rings, then the
// merge's accumulators, and the share's list (and positions).
//
// This header holds the kernel and its launcher; each C entry is a source of
// its own (spec_verify_attention{,_q8,_sink,_q8_sink}.cu, 14 instances each),
// so that the four compile in parallel (ops/_cuda.py runs one nvcc a source).
//
// Two compile-time switches give block diffusion's block attention the same
// kernel (its entry: block_attention.cu). kPf reads the prefill layout
// (L, B, S, nkv, DH), where a column's K row lies nkv·DH elements after the
// one before; kBidir has no causal new columns: every query of the block
// sees every valid column, so the list holds the valid columns alone (that
// entry passes no window, sinks or int8 cache). The verify instances have
// both off, and the switches fold away there at compile time.

#pragma once

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace lapha;  // common.cuh's mma.sync, hopper.cuh's cp.async, ldmatrix, clusters
using bf16 = __nv_bfloat16;

constexpr int NW = 4;             // warps a CTA
constexpr int NTH = 32 * NW;      // threads a CTA
constexpr int PIECE = 16;         // columns a warp takes at a time: the mma's M
constexpr int MAX_SPLITS = 8;     // a row's splits are one cluster: at most 8 CTAs (portable)
constexpr int MAX_STAGES = 4;     // ring stages a warp
constexpr int SMEM_LIMIT = 227 * 1024;

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

template <int DH, bool kQ8, int NTW>
struct Layout {
  static constexpr int QB = 8 * NTW;                  // query rows a CTA
  static constexpr int ROW = kQ8 ? DH + 16 : 2 * DH + 16;  // a cache row, an odd number of 16 B
  static constexpr int KV = PIECE * ROW;
  static constexpr int STAGE = 2 * KV + (kQ8 ? 2 * PIECE * 4 : 0);
  static constexpr int QROW = 2 * DH + 16;             // a Q row (bf16), an odd number of 16 B
  static constexpr int QT = QB * QROW;
  static constexpr int META = QB * 16;                 // int4 a query row
  static constexpr int LDP = DH + 4;                   // f32 row of one query's accumulator
  static constexpr int ACC = NW * QB * LDP * 4;
  // tail (f32): pm, pl, pf (NW x QB each: the warps' max, sum, factor), cm,
  // cl (QB each: the CTA's), cf (MAX_SPLITS x QB: the cluster's factors)
  static constexpr int TAIL = (3 * NW * QB + 2 * QB + MAX_SPLITS * QB) * 4;
  // inbox (f32): MAX_SPLITS x QB (m, l) pairs, then the slice's partials,
  // splits x ceil(QB·DH / splits) <= QB·DH + MAX_SPLITS
  static constexpr int INBOX = (2 * MAX_SPLITS * QB + QB * DH + MAX_SPLITS) * 4;
  // the region: the list build's scratch (lmask, vmask: a word each per 32
  // columns; the words' offsets + the count), then the rings, then the merge
  __host__ __device__ static int region(int nst, int words) {
    const int ring = NW * nst * STAGE, scratch = round16((3 * words + 1) * 4);
    const int m = ring > ACC ? ring : ACC;
    return m > scratch ? m : scratch;
  }
  __host__ __device__ static int head(int splits) {  // Q, meta, tail, inbox
    return QT + META + TAIL + (splits > 1 ? INBOX : 0);
  }
  // + the share's list: a column entry and its position, ceil(S / splits) each
  __host__ __device__ static int smem(int nst, int S, int splits) {
    const int cap = (S + splits - 1) / splits;
    return head(splits) + region(nst, (S + 31) / 32) + 2 * round16(4 * cap);
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

// 4 int8 -> bf16 pairs (bytes 0, 2) and (1, 3): ldmatrix.trans's (column
// 2t4, dims 2g, 2g+1; column 2t4+1, same dims) as dim 2g's and dim 2g+1's
// column pair
__device__ __forceinline__ void i8_v(uint32_t r, uint32_t& even, uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  even = pack_f32(i8_at(u, 0), i8_at(u, 2));
  odd = pack_f32(i8_at(u, 1), i8_at(u, 3));
}

// four f32 -> four bf16 at an 8-byte aligned address
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_f32(v.x, v.y), pack_f32(v.z, v.w));
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

template <int DH, bool kQ8, bool kSink, int NTW, bool kPf, bool kBidir>
__global__ void __launch_bounds__(NTH)
spec_verify_kernel(const bf16* __restrict__ q,                   // (B, T, nh, DH)
                   const void* __restrict__ kc_,                 // (L, B, nkv, S, DH); kPf: (L, B, S, nkv, DH)
                   const void* __restrict__ vc_,
                   const float* __restrict__ ks,                 // (L, B, nkv, S) (kQ8)
                   const float* __restrict__ vs,
                   const unsigned char* __restrict__ valid_map,  // (B, S) bool bytes
                   const int* __restrict__ positions,            // (B, T)
                   const int* __restrict__ pos_map,              // (B, S) (window > 0)
                   const float* __restrict__ sinks,              // (nh,) (kSink)
                   int layer, int slot, int T, int window,
                   bf16* __restrict__ out,                       // (B, T, nh, DH)
                   int nh, int nkv, int S, float scale, float softcap, int qtiles, int nst) {
  static_assert(!(kPf && kQ8), "the int8 cache and its scales have the decode layout only");
  using Lay = Layout<DH, kQ8, NTW>;
  constexpr int QB = Lay::QB, ROW = Lay::ROW, LDP = Lay::LDP, QROW = Lay::QROW;
  constexpr int KS = DH / 16;                       // k-steps of Sᵀ, m-tiles of Oᵀ
  constexpr int ESZ = kQ8 ? 1 : 2;                  // bytes of a cache element
  constexpr int UPR = DH * ESZ / 16;                // 16-byte units of a cache row
  constexpr uint32_t FULL = 0xffffffffu;
  extern __shared__ __align__(128) unsigned char smem[];

  // grid (B, nkv x qtiles, splits): row b, KV head hk, query rows q0 ..
  // q0 + rows of its block, share `rank` of the row's live columns
  const int b = blockIdx.x, B = gridDim.x;
  const int hk = blockIdx.y / qtiles, qt = blockIdx.y % qtiles;
  const int splits = gridDim.z, rank = blockIdx.z;  // cluster (1, 1, splits): rank = z
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int group = nh / nkv, qtot = group * T, per_tile = (qtot + qtiles - 1) / qtiles;
  const int q0 = qt * per_tile, rows = min(per_tile, qtot - q0);
  const int words = (S + 31) / 32, cap = (S + splits - 1) / splits;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  unsigned char* qs = smem;                                   // QB rows of QROW bytes
  int4* meta = reinterpret_cast<int4*>(smem + Lay::QT);       // (t, pos - W, out row, head)
  float* pm = reinterpret_cast<float*>(smem + Lay::QT + Lay::META);
  float* pl = pm + NW * QB;
  float* pf = pl + NW * QB;
  float* cm = pf + NW * QB;
  float* cl = cm + QB;
  float* cf = cl + QB;
  float* in_ml = cf + MAX_SPLITS * QB;       // inbox: rank r's (m, l) of row n at 2(r·QB + n)
  float* in_acc = in_ml + 2 * MAX_SPLITS * QB;  // rank r's part of the slice at r·per
  unsigned char* region = smem + Lay::head(splits);
  float* pacc = reinterpret_cast<float*>(region);           // the merge (reuses the rings)
  uint32_t* lmask = reinterpret_cast<uint32_t*>(region);    // the list build (before the rings)
  uint32_t* vmask = lmask + words;
  int* pref = reinterpret_cast<int*>(vmask + words);
  int* list = reinterpret_cast<int*>(region + Lay::region(nst, words));
  int* lpos = list + round16(4 * cap) / 4;
  if (splits > 1) cluster_arrive_relaxed();  // waited for before the first push

  // Q rows q0 .. q0 + QB (zeros past `rows`): row n is query t = (q0 + n) /
  // group of head hk·group + (q0 + n) % group
  for (int u = tid; u < QB * (DH / 8); u += NTH) {
    const int n = u / (DH / 8), c = u % (DH / 8), gr = q0 + n;
    const bool ok = n < rows;
    const bf16* src = ok ? q + ((static_cast<size_t>(b) * T + gr / group) * nh + hk * group +
                                gr % group) * DH + 8 * c
                         : q;
    cp_async16(qs + n * QROW + 16 * c, src, ok);
  }
  cp_async_commit();
  if (tid < QB) {
    const int n = tid, gr = q0 + n;
    const bool ok = n < rows;
    const int t = ok ? gr / group : T - 1, h = ok ? gr % group : 0;
    const size_t at = static_cast<size_t>(b) * T + t;
    meta[n] = make_int4(t, window > 0 ? positions[at] - window : 0,
                        static_cast<int>(at * nh) + hk * group + h, hk * group + h);
  }

  // the row's live columns: the block's new ones, and the valid ones (within
  // the window of the block's earliest query): bit j % 32 of word j / 32. A
  // warp reads BATCH words' bytes (and positions) at once before it votes,
  // so one trip to memory serves a cache of up to NW·BATCH·32 columns.
  constexpr int BATCH = 16;
  const unsigned char* vrow = valid_map + static_cast<size_t>(b) * S;
  const int* prow = window > 0 ? pos_map + static_cast<size_t>(b) * S : nullptr;
  int wmin = INT_MAX;
  if (window > 0)
    for (int t = lane; t < T; t += 32) wmin = min(wmin, positions[static_cast<size_t>(b) * T + t]);
  for (int w0 = warp; w0 < words; w0 += NW * BATCH) {
    bool vb[BATCH];
    int pc[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int j = 32 * (w0 + NW * i) + lane;
      vb[i] = j < S && vrow[j] != 0;
      pc[i] = window > 0 && j < S ? prow[j] : 0;
    }
    if (window > 0 && w0 == warp) {  // the earliest query's position - W, once
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) wmin = min(wmin, __shfl_xor_sync(FULL, wmin, o));
      wmin -= window;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int w = w0 + NW * i, j = 32 * w + lane;
      if (w < words) {
        const bool fresh = !kBidir && j >= slot && j < slot + T;
        const bool live = fresh || (vb[i] && (window <= 0 || pc[i] > wmin));
        const uint32_t lm = __ballot_sync(FULL, live), vm = __ballot_sync(FULL, vb[i]);
        if (lane == 0) {
          lmask[w] = lm;
          vmask[w] = vm;
        }
      }
    }
  }
  __syncthreads();
  if (warp == 0) {  // the words' offsets in the list, then its length
    int carry = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
      const int w = w0 + lane, c = w < words ? __popc(lmask[w]) : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (w < words) pref[w] = carry + incl - c;
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) pref[words] = carry;
  }
  __syncthreads();
  // this CTA's share [lo, hi) of the n entries; each lane writes its own
  // column's: the column, or -(c + 1) for new column c that is not valid
  // (seen by queries t >= c only), and its position where windowed
  const int n = pref[words];
  const int lo = static_cast<int>(static_cast<long long>(n) * rank / splits);
  const int hi = static_cast<int>(static_cast<long long>(n) * (rank + 1) / splits);
  const int cnt = hi - lo;
  for (int w = warp; w < words; w += NW) {
    const int p0 = pref[w];
    if (pref[w + 1] <= lo || p0 >= hi) continue;
    const uint32_t lm = lmask[w];
    const int idx = p0 + __popc(lm & ((1u << lane) - 1u));
    if (((lm >> lane) & 1u) && idx >= lo && idx < hi) {
      const int j = 32 * w + lane, c = j - slot;
      const bool fresh = !kBidir && c >= 0 && c < T;
      list[idx - lo] = fresh && !((vmask[w] >> lane) & 1u) ? -(c + 1) : j;
      if (window > 0)
        lpos[idx - lo] = fresh ? positions[static_cast<size_t>(b) * T + c] : prow[j];
    }
  }
  cp_async_wait<0>();  // this thread's Q copies
  __syncthreads();     // Q, meta and the list are the CTA's; the scratch is free for the rings

  // every 4th 16-column piece of the share, through this warp's ring
  const int pieces = (cnt + PIECE - 1) / PIECE;
  const int mine = pieces > warp ? (pieces - warp + NW - 1) / NW : 0;  // pieces w, w+4, ...
  const size_t panel = (static_cast<size_t>(layer) * B + b) * nkv + hk;
  // the head's first column and the step from one column to the next
  const size_t first = kPf ? ((static_cast<size_t>(layer) * B + b) * S * nkv + hk) * DH * ESZ
                           : panel * S * DH * ESZ;
  const size_t stride = kPf ? static_cast<size_t>(nkv) * DH * ESZ : DH * ESZ;
  const unsigned char* kbase = static_cast<const unsigned char*>(kc_) + first;
  const unsigned char* vbase = static_cast<const unsigned char*>(vc_) + first;
  unsigned char* ring = region + warp * nst * Lay::STAGE;

  // piece `pc` of the share (entries 16pc ..) into stage `st` of this warp's ring
  auto issue = [&](int pc, int st) {
    unsigned char* sk = ring + st * Lay::STAGE;
    unsigned char* sv = sk + Lay::KV;
    const int base = pc * PIECE;
#pragma unroll
    for (int it = 0; it < PIECE * UPR / 32; ++it) {
      const int u = lane + 32 * it, r = u / UPR, c = u % UPR, i = base + r;
      const bool ok = i < cnt;
      const int e = ok ? list[i] : 0;
      const size_t off = ok ? static_cast<size_t>(e < 0 ? slot - e - 1 : e) * stride + c * 16 : 0;
      cp_async16(sk + r * ROW + c * 16, kbase + off, ok);
      cp_async16(sv + r * ROW + c * 16, vbase + off, ok);
    }
    if constexpr (kQ8) {
      const int i = base + (lane & 15);
      const bool ok = i < cnt;
      const int e = ok ? list[i] : 0;
      const size_t at = panel * S + (ok ? (e < 0 ? slot - e - 1 : e) : 0);
      cp_async4(reinterpret_cast<float*>(sv + Lay::KV) + lane, (lane < 16 ? ks : vs) + at, ok);
    }
  };

#pragma unroll 1
  for (int j = 0; j < nst - 1; ++j) {
    if (j < mine) issue(warp + NW * j, j);
    cp_async_commit();
  }

  float acc[KS][NTW][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // online softmax of query rows 8nt + 2t4 + c: max (the same in every lane
  // of the row) and this lane's share of the sum (its columns only)
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
    const int base = (warp + NW * j) * PIECE;

    // Sᵀ (16 columns x 8 query rows a tile) = K · Qᵀ
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
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          i8_k(r[2 * h], a[0], a[2]);
          i8_k(r[2 * h + 1], a[1], a[3]);
          // Q in K's order of dims: (4t4, 4t4 + 1), (4t4 + 2, 4t4 + 3) of the step
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const uint2 qb = *reinterpret_cast<const uint2*>(
                qs + (8 * nt + g) * QROW + (16 * (2 * p + h) + 4 * t4) * 2);
            mma_bf16_16816(s[nt], a, qb.x, qb.y);
          }
        }
      }
    } else {
#pragma unroll
      for (int kp = 0; kp < KS / 2; ++kp) {  // two k-steps a Q ldmatrix
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, sk + (lane & 15) * ROW + (32 * kp + (lane >> 4) * 8) * 2);
        ldsm_x4(a1, sk + (lane & 15) * ROW + (32 * kp + 16 + (lane >> 4) * 8) * 2);
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          uint32_t qb[4];  // rows 8nt .. 8nt+7: dims 32kp + 8i .. + 7 as matrix i
          ldsm_x4(qb, qs + (8 * nt + (lane & 7)) * QROW + (32 * kp + (lane >> 3) * 8) * 2);
          mma_bf16_16816(s[nt], a0, qb[0], qb[1]);
          mma_bf16_16816(s[nt], a1, qb[2], qb[3]);
        }
      }
    }

    // logits of the piece's columns g, g + 8 (kQ8: times the K scale),
    // capped, masked: past the share, a new column before the query, out of
    // the query's window; the online softmax per query row; P (kQ8: times
    // the V scale) rounded to bf16 and transposed into Pᵀ's B fragments
    const float* sc = reinterpret_cast<const float*>(sv + Lay::KV);
    const int i0 = base + g, i1 = base + g + 8;
    const int e0 = i0 < cnt ? list[i0] : 0, e1 = i1 < cnt ? list[i1] : 0;
    // the first query t that sees the column (INT_MAX: none, past the share)
    const int th0 = i0 < cnt ? (e0 < 0 ? -e0 - 1 : 0) : INT_MAX;
    const int th1 = i1 < cnt ? (e1 < 0 ? -e1 - 1 : 0) : INT_MAX;
    const int lp0 = window > 0 && i0 < cnt ? lpos[i0] : 0;
    const int lp1 = window > 0 && i1 < cnt ? lpos[i1] : 0;
    const float kscl0 = kQ8 ? sc[g] * scale : scale, kscl1 = kQ8 ? sc[g + 8] * scale : scale;
    uint32_t pb[NTW][2], pr[NTW][2];  // P in bf16; kQ8: what the rounding left
    float alpha[NTW][2];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      int2 md[2];  // (t, position - W) of rows 8nt + 2t4, + 1
#pragma unroll
      for (int c = 0; c < 2; ++c)
        md[c] = *reinterpret_cast<const int2*>(&meta[8 * nt + 2 * t4 + c]);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * (e < 2 ? kscl0 : kscl1);
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        const int2 m = md[e & 1];
        bool ok = m.x >= (e < 2 ? th0 : th1);
        if (window > 0) ok = ok && (e < 2 ? lp0 : lp1) > m.y;
        s[nt][e] = ok ? x : NEG;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mx = fmaxf(s[nt][c], s[nt][2 + c]);
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
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
      pb[nt][0] = movmatrix_t(w[0]);  // columns 2t4, 2t4+1 of query row g
      pb[nt][1] = movmatrix_t(w[1]);  // columns 2t4+8, 2t4+9
      if constexpr (kQ8) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
          pr[nt][i] = movmatrix_t(pack_f32(p[2 * i] - r.x, p[2 * i + 1] - r.y));
        }
      }
    }

    // Oᵀ (dims x query rows) = Oᵀ·alpha + Vᵀ · Pᵀ; the rescale is skipped
    // where no row's max moved in the warp (alpha is exactly 1 there)
    bool moved = false;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) moved |= alpha[nt][0] != 1.f || alpha[nt][1] != 1.f;
    if (__any_sync(FULL, moved)) {
#pragma unroll
      for (int mt = 0; mt < KS; ++mt)
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          acc[mt][nt][0] *= alpha[nt][0];
          acc[mt][nt][1] *= alpha[nt][1];
          acc[mt][nt][2] *= alpha[nt][0];
          acc[mt][nt][3] *= alpha[nt][1];
        }
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
      l += __shfl_xor_sync(FULL, l, 4);
      l += __shfl_xor_sync(FULL, l, 8);
      l += __shfl_xor_sync(FULL, l, 16);
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
        const int r = 8 * nt + 2 * t4 + (e & 1);
        pacc[(warp * QB + r) * LDP + d] = acc[mt][nt][e];
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        pm[warp * QB + 8 * nt + 2 * t4 + c] = m_run[nt][c];
        pl[warp * QB + 8 * nt + 2 * t4 + c] = l_run[nt][c];
      }
  }
  __syncthreads();
  if (tid < QB) {
    // the CTA's (m, l) of query row tid and each warp's factor; with one
    // split the sink and 1/l fold in here
    const int r = tid;
    float M = NEG;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, pm[w * QB + r]);
    float L = 0.f;
    for (int w = 0; w < NW; ++w) L += pl[w * QB + r] * __expf(pm[w * QB + r] - M);
    float f = 1.f;
    if (splits == 1) {
      if (kSink && r < rows) {
        const float sink = sinks[meta[r].w];
        const float Ms = fmaxf(M, sink);
        L = L * __expf(M - Ms) + __expf(sink - Ms);
        M = Ms;
      }
      f = L > 0.f ? 1.f / L : 0.f;
    }
    for (int w = 0; w < NW; ++w) pf[w * QB + r] = __expf(pm[w * QB + r] - M) * f;
    cm[r] = M;
    cl[r] = L;
  }
  __syncthreads();
  // splits > 1: CTA r owns slice r of the (query row, dim) outputs, [r·per,
  // (r+1)·per); every CTA pushes its part of each slice, and its (m, l) of
  // every row, into the owner's inbox at its own rank
  const int total = rows * DH, per = (total + splits - 1) / splits;
  if (splits > 1) cluster_wait();  // every peer has started
  if (splits > 1 && tid < QB) {
    for (int r = 0; r < splits; ++r) {
      st_cluster_f32(in_ml + 2 * (rank * QB + tid), r, cm[tid]);
      st_cluster_f32(in_ml + 2 * (rank * QB + tid) + 1, r, cl[tid]);
    }
  }
  // four dims of a query row a thread at a time (per and DH are multiples of 4)
  for (int e = 4 * tid; e < total; e += 4 * NTH) {
    const int r = e / DH, d = e % DH;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float4 a = *reinterpret_cast<const float4*>(&pacc[(w * QB + r) * LDP + d]);
      const float f = pf[w * QB + r];
      v.x += a.x * f;
      v.y += a.y * f;
      v.z += a.z * f;
      v.w += a.w * f;
    }
    if (splits == 1) {
      store4(out + static_cast<size_t>(meta[r].z) * DH + d, v);
    } else {
      const int owner = e / per;
      st_cluster_f32x4(in_acc + rank * per + e - owner * per, owner, v);
    }
  }
  if (splits > 1) {
    cluster_sync();  // every push has landed; no CTA touches a peer's memory after it
    if (tid < QB) {
      // query row tid over the ranks in order, the sink once: the factors of
      // each rank's part, 1/l folded in
      const int r = tid;
      const float sink = kSink && r < rows ? sinks[meta[r].w] : NEG;
      float M = sink;
      for (int k = 0; k < splits; ++k) M = fmaxf(M, in_ml[2 * (k * QB + r)]);
      float L = kSink && r < rows ? __expf(sink - M) : 0.f;
      for (int k = 0; k < splits; ++k) {
        const float f = __expf(in_ml[2 * (k * QB + r)] - M);
        cf[k * QB + r] = f;
        L += in_ml[2 * (k * QB + r) + 1] * f;
      }
      const float inv = L > 0.f ? 1.f / L : 0.f;
      for (int k = 0; k < splits; ++k) cf[k * QB + r] *= inv;
    }
    __syncthreads();
    const int e_lo = rank * per, e_hi = min(total, e_lo + per);
    for (int e = e_lo + 4 * tid; e < e_hi; e += 4 * NTH) {
      const int r = e / DH;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < splits; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&in_acc[k * per + e - e_lo]);
        const float f = cf[k * QB + r];
        v.x += a.x * f;
        v.y += a.y * f;
        v.z += a.z * f;
        v.w += a.w * f;
      }
      store4(out + static_cast<size_t>(meta[r].z) * DH + e % DH, v);
    }
  }
}

template <int DH, bool kQ8, bool kSink, int NTW, bool kPf, bool kBidir>
int launch_inst(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
                const float* v_scale, const unsigned char* valid_map, const int* positions,
                const int* pos_map, const float* sinks, int layer, int slot, int T, int window,
                void* out, int B, int nh, int nkv, int S, float scale, float softcap, int qtiles,
                int splits, int nst, cudaStream_t stream) {
  using Lay = Layout<DH, kQ8, NTW>;
  const auto kernel = spec_verify_kernel<DH, kQ8, kSink, NTW, kPf, kBidir>;
  const int smem = Lay::smem(nst, S, splits);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t opt_in = smem_opt_in(kernel, SMEM_LIMIT, opted_in);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, nkv * qtiles, splits);
  cfg.blockDim = dim3(NTH);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;  // a row's splits: one cluster
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), k_cache, v_cache, k_scale, v_scale, valid_map,
      positions, pos_map, sinks, layer, slot, T, window, static_cast<bf16*>(out), nh, nkv, S,
      scale, softcap, qtiles, nst));
}

// A CTA's dynamic shared memory under a plan: the Layout of the instance
// that `rows` query rows a CTA take (8 a tile of n8), -1 where the kernel
// has no such instance. The one count of it: the launcher sizes its launch
// by it and the host's verify_plan its plan (lapha_spec_verify_smem).
template <bool kQ8>
int plan_smem(int dh, int rows, int S, int stages, int splits) {
  const int ntw = rows < 1 ? 0 : (rows + 7) / 8;
  if (S < 1 || stages < 1 || splits < 1) return -1;
#define LAPHA_SM(DH, NTW) \
  if (dh == DH && ntw == NTW) return Layout<DH, kQ8, NTW>::smem(stages, S, splits);
  LAPHA_SM(64, 1)
  LAPHA_SM(64, 2)
  LAPHA_SM(64, 3)
  LAPHA_SM(64, 4)
  LAPHA_SM(96, 1)
  LAPHA_SM(96, 2)
  LAPHA_SM(96, 3)
  LAPHA_SM(96, 4)
  LAPHA_SM(128, 1)
  LAPHA_SM(128, 2)
  LAPHA_SM(128, 3)
  LAPHA_SM(128, 4)
  LAPHA_SM(256, 1)
  LAPHA_SM(256, 2)
#undef LAPHA_SM
  return -1;
}

// The four C entries' launcher (one a source).
// q (B, T, nh, dh) bf16; k_cache, v_cache (L, B, nkv, S, dh) bf16 (or int8 with
// the (L, B, nkv, S) f32 scales); valid_map (B, S) one byte a column;
// positions (B, T) and pos_map (B, S) int32 (pos_map may be null when window
// is 0); out (B, T, nh, dh) bf16. The softcap is the last float (0 = off).
// The plan (`qtiles` CTAs a KV head's query block, `splits` 1..8 CTAs a row's
// live columns, one cluster, a power of two; `stages` 1..4 ring stages a
// warp) comes from the host's ops/spec_verify_attention.verify_plan.
// sinks (kSink): (nh,) f32 sink logits, one per query head.
template <bool kQ8, bool kSink, bool kPf = false, bool kBidir = false>
int launch(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
           const float* v_scale, const void* valid_map, const int* positions, const int* pos_map,
           const float* sinks, int layer, int slot, int T, int window, void* out, int B, int nh,
           int nkv, int S, int dh, float scale, float softcap, int qtiles, int splits, int stages,
           void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || B <= 0 || T < 1 || slot < 0 || slot + T > S || window < 0 ||
      (window > 0 && pos_map == nullptr) || qtiles < 1 || qtiles > nh / nkv * T ||
      static_cast<long long>(nkv) * qtiles > 65535 || splits < 1 || splits > MAX_SPLITS ||
      (splits & (splits - 1)) != 0 || stages < 1 || stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  // query rows a CTA -> the n8 tiles of its instance (up to 32 rows, 16 at dh 256)
  const int rows = (nh / nkv * T + qtiles - 1) / qtiles;
  if ((qtiles - 1) * rows >= nh / nkv * T) return static_cast<int>(cudaErrorInvalidValue);
  const int ntw = rows > 32 ? 0 : (rows + 7) / 8;
  if (ntw == 0 || (dh > 128 && ntw > 2)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* vm = static_cast<const unsigned char*>(valid_map);
#define LAPHA_SV(DH, NTW)                                                                      \
  if (dh == DH && ntw == NTW)                                                                  \
    return launch_inst<DH, kQ8, kSink, NTW, kPf, kBidir>(                                     \
        q, k_cache, v_cache, k_scale, v_scale, vm, positions, pos_map, sinks, layer, slot, T,  \
        window, out, B, nh, nkv, S, scale, softcap, qtiles, splits, stages, st);
  LAPHA_SV(64, 1)
  LAPHA_SV(64, 2)
  LAPHA_SV(64, 3)
  LAPHA_SV(64, 4)
  LAPHA_SV(96, 1)
  LAPHA_SV(96, 2)
  LAPHA_SV(96, 3)
  LAPHA_SV(96, 4)
  LAPHA_SV(128, 1)
  LAPHA_SV(128, 2)
  LAPHA_SV(128, 3)
  LAPHA_SV(128, 4)
  LAPHA_SV(256, 1)
  LAPHA_SV(256, 2)
#undef LAPHA_SV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
