// Flash-attention backward for Hopper (sm_90a): dQ, and dK/dV summed over
// the GQA group.
//
// Replaces the two Pallas kernels of lapha_tpu/ops/flash_attention.py that
// _flash_backward (:617) launches: _dq_kernel (:108, call :652) and
// _dkv_kernel (:165, call :672). Same semantics as the forward in
// flash_attention.cu: query t of row b sits at position qstart[b] + t and
// sees key j iff kv_valid[b, j] != 0 and j <= qstart[b] + t (training calls
// it with qstart = 0; a non-causal call has qstart = T). Both kernels
// recompute the probabilities from the forward's LSE (FlashAttention-2):
//   s  = scale·q·k, and with a logit softcap (Gemma-2; a runtime float,
//        0 = off) c = cap·tanh(s/cap) before the mask, else c = s
//   P  = exp(c - lse)   on visible keys of rows with lse > -5e29, else 0
//   dS = P ∘ (dO·Vᵀ - D) ∘ dc/ds,  dc/ds = 1 - (c/cap)² (1 without a cap),
//        D = rowsum(dO ∘ O) (computed by the caller)
//   dQ = scale·dS·K,  dK = scale·dSᵀ·Q,  dV = Pᵀ·dO
// The forward's LSE is over the capped logits, so P needs no other change;
// the chain rule is the Pallas kernels' (:137-147, :194-206). A row whose
// LSE is the -1e30 sentinel saw no key and contributes nothing (the
// `row_ok` guard of the Pallas kernels). With a window W > 0 (a
// sliding-window layer) key j is seen only where also j > qstart[b] + t - W:
// the window terms of _dq_kernel (:130-131, band start :158-159) and
// _dkv_kernel (:190-191, band end :215-219). The dq kernel starts at the key
// tile of the band's first key, the dk/dv kernel stops after the last query
// tile that sees its key block, and both mask inside the band. The head dims
// of Q/K (DH) and of V and dO (DV) are template parameters, instantiated for
// (64, 64) (GPT-OSS), (96, 96) (Phi-3), (128, 128), (256, 256) (Gemma) and
// (192, 128) (DeepSeek MLA: Q/K are nope 128 + rope 64, V is 128 wide, the
// Pallas kernels' dv_w, :623, :643-644, :661-663, :677). With V narrower than Q/K,
// dP = dO·Vᵀ contracts over DV, dV = Pᵀ·dO is DV wide, dQ and dK stay DH
// wide; V and dO tiles have their own padded strides (DV + 8). W and the
// softcap are runtime arguments, in any combination. A softcap > 0 launches
// the instance with the cap (kCap), so the cap-free ones carry none of its
// work.
//
// What bounds it on an H100: at the training shape (B=8, T=4096, 12/2
// heads, dh 128) each kernel does ~2.5x the forward's matrix work (dq: two
// products per tile for dS plus dS·K; dk/dv: four) against the same bytes,
// far above the ~295 FLOP/byte ridge, so it is bound by matrix-multiply
// throughput, and at the port's shapes (T = 1024) by keeping enough of the
// card busy. P and dS are rounded to bf16 only as the A operand of the next
// product; sums are f32.
//
// Two designs, by head dim:
//
// 1. DH <= 128 (64, 96, 128; V as wide): wgmma kernels fed by a TMA ring
//    (the wgmma section below). dq: a CTA per (128-query block, query head,
//    batch row); dk/dv: a CTA per (128-key block, KV head, batch row, part
//    of the GQA group). Where the grid would leave SMs idle the host splits
//    the group into parts (ops/flash_attention.dkv_split: phase 1b's 12/2
//    heads, 64 CTAs of 128 keys, become 192); each part writes f32 partial
//    dK/dV and dkv_reduce_kernel adds them in part order, so dq, dk and dv
//    are the same from launch to launch (no atomics anywhere). The first
//    version of this file ran every product with mma.sync from plain
//    synchronous loads, one four-warp CTA per 64-key block: 128 CTAs at
//    phase 1b, 0.2383 + 0.6285 ms against 0.0988 + 0.1477 now (bench_k2).
//
// 2. DH > 128 (256, and 192 with V 128): mma.sync kernels. dq: one
//    CTA per (64-query block, query head, batch row), four warps of 16 rows;
//    K/V tiles of 32 keys pass through shared memory up to the block's causal
//    frontier; dQ accumulates in f32 registers and is written once. The dQ
//    accumulator alone is 128 registers a thread at dh 256, so Q and dO are
//    staged once into shared memory and their fragments read per k-step (as
//    the forward's dh-256 instance keeps Q): 101.5 KB of dynamic shared
//    memory; DH 192 the same (dQ 96 registers; 63.1 KB with DV 128).
//    dk/dv: one CTA per (64-key block, KV head, batch row, part of the group,
//    as above: Gemma-3's 4/1 heads go from 64 CTAs to 256). The Pallas
//    kernel sums the GQA group through a grid axis that revisits a
//    VMEM-resident output block; here one CTA loops over its part's query
//    heads and, for each, over 32-query tiles from the key block's causal
//    horizon on. dK and dV together would be 256 registers a thread, past
//    the limit of 255, so the CTA has eight warps and splits the products
//    by role, two warps a 16-key strip: the P warp computes Sᵀ = K·Qᵀ, Pᵀ
//    and dV += Pᵀ·dO; the dS warp computes dPᵀ = V·dOᵀ and, from the P
//    warp's Pᵀ∘dc/ds handed over through shared memory (2 KB a strip, in
//    the mma fragment layout, so each lane reads what the same lane of its
//    partner wrote), dSᵀ and dK += dSᵀ·Q. Each warp keeps one 16x256 f32
//    accumulator (128 registers) and does two of the four products; 110.1
//    KB of dynamic shared memory, one CTA an SM. At DH 192 the dS warp's
//    dPᵀ contracts over DV and its dK is DH wide, the P warp's dV is DV
//    wide; 71.5 KB with DV 128. The partial path (f32 out) is an instance
//    of its own (kPart).
//
// A windowed dq CTA stops before the band's first key tile and a windowed
// dk/dv CTA after the last query tile that sees its keys, so a band of W =
// 128 costs O(T·W), not O(T²).

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

using lapha::NEG;
using lapha::a_from_d;
using lapha::ld_u32;
using lapha::mma_bf16_16816;
using lapha::pack_f32;
using lapha::pack_raw;
using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 128;

constexpr int DQ_BQ = 64;            // query rows per dq CTA (4 warps x 16)
constexpr int DQ_BK = 32;            // keys per tile
constexpr int DQ_NT = DQ_BK / 8;     // n-tiles of a logits tile
constexpr int DQ_KS = DQ_BK / 16;    // k-steps of dS·K

constexpr int KV_BK = 64;            // key rows per dk/dv CTA (4 strips x 16)
constexpr int KV_BQ = 32;            // queries per tile
constexpr int KV_NT = KV_BQ / 8;     // n-tiles of a transposed logits tile
constexpr int KV_KS = KV_BQ / 16;    // k-steps of Pᵀ·dO and dSᵀ·Q

// The DH > 128 kernels' dims per (Q/K, V) head-dim pair: the padded smem
// rows of Q/K and of V/dO (width + 8: 400 or 528 B, conflict-free fragment
// reads), the k-steps and n-tiles over each width, the threads of a dk/dv
// CTA (two warps a strip), and both kernels' dynamic shared memory: dq — K,
// V, Q, dO and the key validity; dk/dv — K, V, a Q and a dO tile, the Pᵀ
// hand-over, LSE, D and the key validity.
template <int DH, int DV>
struct Dims {
  static_assert(DH > 128 && DV <= DH && DV % 16 == 0,
                "the mma.sync kernels take DH > 128; V may be narrower, in whole k-steps");
  static constexpr int LDS = DH + 8;   // rows of sK and sQ
  static constexpr int LDV = DV + 8;   // rows of sV and sO (dO)
  static constexpr int KS_D = DH / 16, KS_V = DV / 16;
  static constexpr int NT_D = DH / 8, NT_V = DV / 8;
  static constexpr int KV_THREADS = 2 * NTHREADS;
  static constexpr size_t DQ_SMEM =
      (DQ_BK + DQ_BQ) * (LDS + LDV) * sizeof(bf16) + DQ_BK * sizeof(int);
  static constexpr size_t KV_XCHG = (KV_BK / 16) * KV_NT * 4 * 32;  // floats
  static constexpr size_t KV_SMEM = (KV_BK + KV_BQ) * (LDS + LDV) * sizeof(bf16)
                                    + (KV_XCHG + 2 * KV_BQ) * sizeof(float)
                                    + KV_BK * sizeof(int);
};

// Stage ROWS rows of W bf16 (row r0 + r of a (rows, stride) panel) into a
// smem tile padded to W + 8 with NT threads; rows at or past `limit` are zero.
template <int ROWS, int W, int NT = NTHREADS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t stride,
                                           int r0, int limit, int tid) {
  constexpr int LD = W + 8;
  for (int i = tid; i < ROWS * (W / 8); i += NT) {
    const int r = i / (W / 8), c = (i % (W / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// A fragment of a 16-row strip held row-major in a padded smem tile:
// p = tile + (first row + g)·LDS + 16ks + 2t4.
template <int LDS>
__device__ __forceinline__ void a_rows(const bf16* p, uint32_t (&a)[4]) {
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * LDS);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * LDS + 8);
}

// B fragment of a (k = tile row, n = head-dim column) operand held row-major
// in a padded smem tile: two rows per register. p = tile + (16kk + 2t4)·LDS + 8dt + g.
template <int LDS>
__device__ __forceinline__ void b_rows(const bf16* p, uint32_t& b0, uint32_t& b1) {
  b0 = pack_raw(p[0], p[LDS]);
  b1 = pack_raw(p[8 * LDS], p[9 * LDS]);
}

// The scaled logit of an accumulated q·k, softcapped in a kCap instance; `dc`
// is the cap's derivative dc/ds = 1 - (c/cap)². Without a cap `dc` is the
// constant 1, so a cap-free instance has no tanh and no extra multiply.
template <bool kCap>
__device__ __forceinline__ float capped(float acc, float scale, float softcap, float inv_cap,
                                        float& dc) {
  float x = acc * scale;
  dc = 1.f;
  if constexpr (kCap) {
    x = softcap * tanhf(x * inv_cap);
    const float u = x * inv_cap;
    dc = 1.f - u * u;
  }
  return x;
}

template <int DH, int DV, bool kCap>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q,        // (B, T, nh, DH)
                    const bf16* __restrict__ k,        // (B, S, nkv, DH)
                    const bf16* __restrict__ v,        // (B, S, nkv, DV)
                    const bf16* __restrict__ dout,     // (B, T, nh, DV)
                    const float* __restrict__ lse,     // (B, nh, T)
                    const float* __restrict__ delta,   // (B, nh, T)
                    const int* __restrict__ kv_valid,  // (B, S)
                    const int* __restrict__ qstart,    // (B,)
                    bf16* __restrict__ dq,             // (B, T, nh, DH)
                    int T, int S, int nh, int nkv, int window, float scale, float softcap) {
  using D = Dims<DH, DV>;
  constexpr int LDS = D::LDS, LDV = D::LDV, KS_D = D::KS_D, KS_V = D::KS_V, NT_D = D::NT_D;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + DQ_BK * LDS;
  bf16* sQ = sV + DQ_BK * LDV;
  bf16* sO = sQ + DQ_BQ * LDS;  // dO
  int* sValid = reinterpret_cast<int*>(sO + DQ_BQ * LDV);
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (nh / nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int q0 = qb * DQ_BQ;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Q and dO of the CTA's 64 rows, staged once into shared memory.
  const size_t q_stride = static_cast<size_t>(nh) * DH, o_stride = static_cast<size_t>(nh) * DV;
  const size_t qoff = (static_cast<size_t>(b) * T * nh + h) * DH;
  const size_t ooff = (static_cast<size_t>(b) * T * nh + h) * DV;
  stage_rows<DQ_BQ, DH>(sQ, q + qoff, q_stride, q0, T, tid);
  stage_rows<DQ_BQ, DV>(sO, dout + ooff, o_stride, q0, T, tid);
  float lse_r[2], d_r[2];
  bool ok_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t i = (static_cast<size_t>(b) * nh + h) * T + row[r];
    lse_r[r] = row[r] < T ? lse[i] : NEG;
    d_r[r] = row[r] < T ? delta[i] : 0.f;
    ok_r[r] = lse_r[r] > 0.5f * NEG;
  }

  float acc[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // Keys past the frontier of this CTA's last real query row are never
  // visible, nor (with a window) keys below the band of its first row.
  const int last_row = min(q0 + DQ_BQ, T) - 1;
  const int kend = min(S, qs + last_row + 1);
  const int nkb = (kend + DQ_BK - 1) / DQ_BK;
  const int kb0 = window > 0 ? max(qs + q0 - (window - 1), 0) / DQ_BK : 0;
  const size_t k_stride = static_cast<size_t>(nkv) * DH, v_stride = static_cast<size_t>(nkv) * DV;
  const bf16* kbase = k + (static_cast<size_t>(b) * S * nkv + hk) * DH;
  const bf16* vbase = v + (static_cast<size_t>(b) * S * nkv + hk) * DV;

  for (int kb = kb0; kb < nkb; ++kb) {
    const int k0 = kb * DQ_BK;
    stage_rows<DQ_BK, DH>(sK, kbase, k_stride, k0, S, tid);
    stage_rows<DQ_BK, DV>(sV, vbase, v_stride, k0, S, tid);
    if (tid < DQ_BK) sValid[tid] = (k0 + tid < S) ? kv_valid[static_cast<size_t>(b) * S + k0 + tid] : 0;
    __syncthreads();

    // S = Q Kᵀ (over DH) and dP = dO Vᵀ (over DV) for this warp's 16 rows x
    // 32 keys; the k-steps past DV (a narrower V) form S alone.
    float s[DQ_NT][4], dp[DQ_NT][4];
#pragma unroll
    for (int nt = 0; nt < DQ_NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
      uint32_t aq[4], ad[4];
      a_rows<LDS>(sQ + (warp * 16 + g) * LDS + ks * 16 + t4 * 2, aq);
      if (ks < KS_V) a_rows<LDV>(sO + (warp * 16 + g) * LDV + ks * 16 + t4 * 2, ad);
#pragma unroll
      for (int nt = 0; nt < DQ_NT; ++nt) {
        const bf16* kp = sK + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
        mma_bf16_16816(s[nt], aq, ld_u32(kp), ld_u32(kp + 8));
        if (ks < KS_V) {
          const bf16* vp = sV + (nt * 8 + g) * LDV + ks * 16 + t4 * 2;
          mma_bf16_16816(dp[nt], ad, ld_u32(vp), ld_u32(vp + 8));
        }
      }
    }
    // dS = P ∘ (dP - D) ∘ dc/ds, P recomputed from the LSE; 0 where not visible.
#pragma unroll
    for (int nt = 0; nt < DQ_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        const bool vis = ok_r[r] && sValid[col] != 0 && (k0 + col) <= qs + row[r] &&
                         (window <= 0 || (k0 + col) > qs + row[r] - window);
        float dc;
        const float c = capped<kCap>(s[nt][e], scale, softcap, inv_cap, dc);
        const float p = vis ? __expf(c - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - d_r[r]) * dc;
      }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < DQ_KS; ++kk) {
      uint32_t a[4];
      a_from_d(a, s[2 * kk], s[2 * kk + 1]);
      const bf16* kp = sK + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt) {
        uint32_t b0, b1;
        b_rows<LDS>(kp + dt * 8, b0, b1);
        mma_bf16_16816(acc[dt], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    bf16* op = dq + qoff + row[r] * q_stride + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < NT_D; ++dt)
      *reinterpret_cast<uint32_t*>(op + dt * 8) =
          pack_f32(acc[dt][2 * r] * scale, acc[dt][2 * r + 1] * scale);
  }
}

// One 16-row strip's first product of the split dk/dv kernel: x = A·Bᵀ over
// KS k-steps, A the strip's rows of a padded (LD) smem tile (p = first row
// + 2t4), B the 32 rows of another tile of the same width.
template <int KS, int LD>
__device__ __forceinline__ void strip_product(float (&x)[KV_NT][4], const bf16* a1,
                                              const bf16* bt, int g, int t4) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    a_rows<LD>(a1 + ks * 16, a);
#pragma unroll
    for (int nt = 0; nt < KV_NT; ++nt) {
      const bf16* bp = bt + (nt * 8 + g) * LD + ks * 16 + t4 * 2;
      mma_bf16_16816(x[nt], a, ld_u32(bp), ld_u32(bp + 8));
    }
  }
}

// Its second: acc[0, NT) += x·B, x the strip's 16 x 32 f32 D fragments
// rounded to bf16 as the A operand, B the 32 rows of a padded (LD) tile.
template <int NT_OUT, int LD, int N>
__device__ __forceinline__ void strip_accumulate(float (&acc)[N][4], const float (&x)[KV_NT][4],
                                                 const bf16* bt, int g, int t4) {
  static_assert(NT_OUT <= N, "the accumulator holds the product's n-tiles");
#pragma unroll
  for (int kk = 0; kk < KV_KS; ++kk) {
    uint32_t a[4];
    a_from_d(a, x[2 * kk], x[2 * kk + 1]);
    const bf16* bp = bt + (kk * 16 + t4 * 2) * LD + g;
#pragma unroll
    for (int dt = 0; dt < NT_OUT; ++dt) {
      uint32_t b0, b1;
      b_rows<LD>(bp + dt * 8, b0, b1);
      mma_bf16_16816(acc[dt], a, b0, b1);
    }
  }
}

// dk/dv at DH > 128: eight warps, two a 16-key strip. Warp w < 4 (the P warp
// of strip w) forms Sᵀ = K·Qᵀ (over DH), Pᵀ, hands Pᵀ∘dc/ds over and
// accumulates dV += Pᵀ·dO (DV wide); warp 4 + w (the dS warp) forms dPᵀ =
// V·dOᵀ (over DV), dSᵀ from the hand-over and accumulates dK += dSᵀ·Q (DH
// wide). The two roles run the same code on swapped operands: (K, Q, dO)
// for the P warp, (V, dO, Q) for the dS warp; with V narrower than Q/K each
// role takes its own widths.
template <int DH, int DV, bool kCap, bool kPart>
__global__ void __launch_bounds__(2 * NTHREADS, 1)
flash_bwd_dkv_split_kernel(const bf16* __restrict__ q,        // (B, T, nh, DH)
                           const bf16* __restrict__ k,        // (B, S, nkv, DH)
                           const bf16* __restrict__ v,        // (B, S, nkv, DV)
                           const bf16* __restrict__ dout,     // (B, T, nh, DV)
                           const float* __restrict__ lse,     // (B, nh, T)
                           const float* __restrict__ delta,   // (B, nh, T)
                           const int* __restrict__ kv_valid,  // (B, S)
                           const int* __restrict__ qstart,    // (B,)
                           bf16* __restrict__ dk,             // (B, S, nkv, DH)
                           bf16* __restrict__ dv,             // (B, S, nkv, DV)
                           float* __restrict__ work,          // partials, splits > 1
                           int T, int S, int nh, int nkv, int window, float scale,
                           float softcap, int splits) {
  using D = Dims<DH, DV>;
  constexpr int LDS = D::LDS, LDV = D::LDV, KS_D = D::KS_D, KS_V = D::KS_V;
  constexpr int NT_D = D::NT_D, NT_V = D::NT_V;
  constexpr int NT = 2 * NTHREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KV_BK * LDS;
  bf16* sQ = sV + KV_BK * LDV;
  bf16* sO = sQ + KV_BQ * LDS;  // dO tile
  float* sX = reinterpret_cast<float*>(sO + KV_BQ * LDV);  // Pᵀ∘dc/ds, by (strip, nt, e, lane)
  float* sL = sX + D::KV_XCHG;
  float* sD = sL + KV_BQ;
  int* sValid = reinterpret_cast<int*>(sD + KV_BQ);
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // grid.y: (KV head, part of its group) with parts; the KV head alone without
  const int kb = blockIdx.x, hk = kPart ? blockIdx.y / splits : blockIdx.y;
  const int split = kPart ? blockIdx.y % splits : 0;
  const int b = blockIdx.z;
  const int group = nh / nkv, per_split = kPart ? group / splits : group;  // the part's query heads
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int strip = warp & 3;
  const bool ds_warp = warp >= 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int k0 = kb * KV_BK;
  const int kl[2] = {strip * 16 + g, strip * 16 + g + 8};  // this thread's key rows in the tile
  float* xchg = sX + strip * (KV_NT * 4 * 32) + lane;

  const size_t k_stride = static_cast<size_t>(nkv) * DH, v_stride = static_cast<size_t>(nkv) * DV;
  const size_t koff = (static_cast<size_t>(b) * S * nkv + hk) * DH;
  const size_t voff = (static_cast<size_t>(b) * S * nkv + hk) * DV;
  stage_rows<KV_BK, DH, NT>(sK, k + koff, k_stride, k0, S, tid);
  stage_rows<KV_BK, DV, NT>(sV, v + voff, v_stride, k0, S, tid);
  if (tid < KV_BK) sValid[tid] = (k0 + tid < S) ? kv_valid[static_cast<size_t>(b) * S + k0 + tid] : 0;

  // The first product's A rows (K or V) and B tile (Q or dO), the second
  // product's B tile (dO or Q).
  const bf16* a1 = ds_warp ? sV + kl[0] * LDV + t4 * 2 : sK + kl[0] * LDS + t4 * 2;
  const bf16* b1t = ds_warp ? sO : sQ;
  const bf16* b2t = ds_warp ? sQ : sO;

  float acc[NT_D][4];  // dV (P warp; its first NT_V n-tiles) or dK (dS warp) of this strip
#pragma unroll
  for (int i = 0; i < NT_D; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const int qb0 = max(0, k0 - qs) / KV_BQ;
  int nqb = (T + KV_BQ - 1) / KV_BQ;
  if (window > 0) {
    const int t_last = k0 + KV_BK + window - 2 - qs;
    nqb = t_last < 0 ? 0 : min(nqb, t_last / KV_BQ + 1);
  }
  const size_t q_stride = static_cast<size_t>(nh) * DH, o_stride = static_cast<size_t>(nh) * DV;

  for (int gi = split * per_split; gi < (split + 1) * per_split; ++gi) {
    const int h = hk * group + gi;
    const size_t qoff = (static_cast<size_t>(b) * T * nh + h) * DH;
    const size_t ooff = (static_cast<size_t>(b) * T * nh + h) * DV;
    const float* lrow = lse + (static_cast<size_t>(b) * nh + h) * T;
    const float* drow = delta + (static_cast<size_t>(b) * nh + h) * T;
    for (int qb = qb0; qb < nqb; ++qb) {
      const int t0 = qb * KV_BQ;
      __syncthreads();  // the previous tile's readers are done (and K/V are staged)
      stage_rows<KV_BQ, DH, NT>(sQ, q + qoff, q_stride, t0, T, tid);
      stage_rows<KV_BQ, DV, NT>(sO, dout + ooff, o_stride, t0, T, tid);
      if (tid < KV_BQ) {
        const int t = t0 + tid;
        sL[tid] = t < T ? lrow[t] : NEG;
        sD[tid] = t < T ? drow[t] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K Qᵀ (P warp) or dPᵀ = V dOᵀ (dS warp): 16 keys x 32 queries.
      float x[KV_NT][4];
#pragma unroll
      for (int nt = 0; nt < KV_NT; ++nt) x[nt][0] = x[nt][1] = x[nt][2] = x[nt][3] = 0.f;
      if (DV == DH || !ds_warp) {
        strip_product<KS_D, LDS>(x, a1, b1t, g, t4);
      } else {
        strip_product<KS_V, LDV>(x, a1, b1t, g, t4);
      }
      if (!ds_warp) {  // Pᵀ, 0 where not visible; Pᵀ∘dc/ds to the dS warp
#pragma unroll
        for (int nt = 0; nt < KV_NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = nt * 8 + t4 * 2 + (e & 1);
            const int r = e >> 1;
            const float l = sL[qc];
            const bool vis = l > 0.5f * NEG && sValid[kl[r]] != 0 &&
                             (k0 + kl[r]) <= qs + t0 + qc &&
                             (window <= 0 || (k0 + kl[r]) > qs + t0 + qc - window);
            float dc;
            const float c = capped<kCap>(x[nt][e], scale, softcap, inv_cap, dc);
            const float p = vis ? __expf(c - l) : 0.f;
            x[nt][e] = p;
            xchg[(nt * 4 + e) * 32] = p * dc;
          }
      }
      __syncthreads();
      if (ds_warp) {  // dSᵀ = Pᵀ∘dc/ds ∘ (dPᵀ - D)
#pragma unroll
        for (int nt = 0; nt < KV_NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[nt][e] = xchg[(nt * 4 + e) * 32] * (x[nt][e] - sD[nt * 8 + t4 * 2 + (e & 1)]);
      }
      // dV += Pᵀ dO (P warp) or dK += dSᵀ Q (dS warp)
      if (DV == DH || ds_warp) {
        strip_accumulate<NT_D, LDS>(acc, x, b2t, g, t4);
      } else {
        strip_accumulate<NT_V, LDV>(acc, x, b2t, g, t4);
      }
    }
  }

  const size_t stride = ds_warp ? k_stride : v_stride;
  const int nt_out = ds_warp ? NT_D : NT_V;
  if constexpr (kPart) {  // this split's f32 partial, unscaled: dkv_reduce_kernel sums them
    const size_t nk = static_cast<size_t>(gridDim.z) * S * nkv * DH;
    const size_t nv = static_cast<size_t>(gridDim.z) * S * nkv * DV;
    float* out = ds_warp ? work + split * nk + koff : work + splits * nk + split * nv + voff;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + kl[r];
      if (j >= S) continue;
      float* op = out + j * stride + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt)
        if (dt < nt_out)
          *reinterpret_cast<float2*>(op + dt * 8) = make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  } else {
    bf16* out = ds_warp ? dk + koff : dv + voff;
    const float f = ds_warp ? scale : 1.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + kl[r];
      if (j >= S) continue;
      bf16* op = out + j * stride + t4 * 2;
#pragma unroll
      for (int dt = 0; dt < NT_D; ++dt)
        if (dt < nt_out)
          *reinterpret_cast<uint32_t*>(op + dt * 8) =
              pack_f32(acc[dt][2 * r] * f, acc[dt][2 * r + 1] * f);
    }
  }
}

// ---------------------------------------------------------------- the wgmma design (DH <= 128)
//
// Both kernels: 256 threads, two warpgroups, each owning a 64-row strip
// (wgmma's M); thread 0 also issues every TMA load, item i + 2's when its
// warpgroup reaches item i (after both have released the stage). With no
// producer warp ptxas may give a thread 255 registers, and the dk/dv
// warpgroup holds dK and dV (2 x 64), Sᵀ and dPᵀ (2 x 32) without spilling:
// with a producer warpgroup and setmaxnreg (K8's layout), or a producer
// warp, ptxas capped these kernels at 168 and spilled ~470 bytes. A CTA keeps two
// resident 64-row tiles of each of two tensors (dk/dv: K and V of its 128
// keys; dq: Q and dO of its 128 queries) and streams 64-row tiles of the
// other two (dk/dv: Q and dO of (head, query tile) items; dq: K and V of key
// tiles) through a 3-stage ring; both consumers read every stage, so a
// stage is released by two arrivals. Tiles are TMA boxes of 64 rows x 64
// head-dim columns, 128-byte swizzled, through 4-D tensor maps (DH, heads,
// rows, B) that stride over the heads; a head dim of 96 is padded to two
// boxes, the columns past it zeros.

constexpr int WG_THREADS = 256;
constexpr int WG_ROWS = 64;       // a consumer's strip; a streamed tile's rows
constexpr int WG_CTA_ROWS = 128;  // a CTA's keys (dk/dv) or queries (dq)
constexpr int WG_NST = 3;         // ring depth
constexpr int BOX_BYTES = 64 * 64 * 2;

template <int DH>
struct WgDims {
  static constexpr int NB = DH <= 64 ? 1 : 2;  // boxes across the head dim
  static constexpr int DP = 64 * NB;           // the head dim padded to whole boxes
  static constexpr int KS = DH / 16;           // k16 steps over the real head dim
  static constexpr int NACC = DP / 2;          // f32 a thread of a 64 x DP accumulator
  static constexpr int TILE = NB * BOX_BYTES;  // one 64-row tile
};

struct WgBars {
  uint64_t res;            // the resident tiles landed
  uint64_t full[WG_NST];   // a stage's TMA bytes landed
  uint64_t empty[WG_NST];  // both consumers done with a stage
};

// resident: 2 tensors x 2 strips; ring: 2 tensors a stage; the barriers;
// the base's alignment to 1024 (the swizzle atom)
template <int DH>
constexpr int wg_smem_bytes() {
  return (4 + 2 * WG_NST) * WgDims<DH>::TILE + static_cast<int>(sizeof(WgBars)) + 1024;
}

template <int DH>
__device__ __forceinline__ uint8_t* wg_smem(WgBars*& bars) {
  extern __shared__ uint8_t wg_raw[];
  uint8_t* base = wg_raw + ((1024u - (lapha::smem_addr(wg_raw) & 1023u)) & 1023u);
  bars = reinterpret_cast<WgBars*>(base + (4 + 2 * WG_NST) * WgDims<DH>::TILE);
  return base;
}

__device__ __forceinline__ void wg_init(WgBars* bars) {
  if (threadIdx.x == 0) {
    lapha::mbar_init(&bars->res, 1);
    for (int s = 0; s < WG_NST; ++s) {
      lapha::mbar_init(&bars->full[s], 1);
      lapha::mbar_init(&bars->empty[s], 2);  // one arrive from each consumer warpgroup
    }
    lapha::mbar_init_fence();
  }
  __syncthreads();
}

// A 64-row tile's boxes (head-dim columns 0.., 64..) from a 4-D map at
// (head, row, batch row).
template <int NB>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row, int b) {
#pragma unroll
  for (int c = 0; c < NB; ++c) lapha::tma_load(dst + c * BOX_BYTES, map, bar, c * 64, head, row, b);
}

// Descriptors of a 64-row tile at shared address t: K-major at k16 step ks
// of the head dim (32 bytes a step inside a box); MN-major at k16 step kk
// of its rows (16 rows of 128 bytes), the boxes BOX_BYTES apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int ks) {
  return lapha::gmma_desc(t + (ks >> 2) * BOX_BYTES + (ks & 3) * 32, 16, lapha::SW_ROWS);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t t, int kk) {
  return lapha::gmma_desc(t + kk * 16 * 128, BOX_BYTES, lapha::SW_ROWS);
}

// x (64 x 64 f32) = A·Bᵀ over the head dim, both tiles K-major (rows of A,
// rows of B), KS k16 steps; issued, not waited for.
template <int KS>
__device__ __forceinline__ void wg_logits(float (&x)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) lapha::wgmma_m64n64<0, 0>(x, desc_k(a, ks), desc_k(b, ks), ks > 0);
}

// A fragments of the four k16 steps over a 64 x 64 accumulator's columns,
// rounded to bf16: the wgmma accumulator's n-tile j is x[4j..4j+3], laid
// out as an mma.sync D fragment, so common.cuh's a_from_d applies.
__device__ __forceinline__ void wg_a_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
  const auto& tiles = reinterpret_cast<const float(&)[8][4]>(x);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a_from_d(a[kk], tiles[2 * kk], tiles[2 * kk + 1]);
}

// dk/dv: CTA (split, KV head, batch row) on grid.x, 128-key block on grid.y
// (block 0, whose keys every query tile sees, launched first). Consumer
// warpgroup s owns keys k0 + 64s..: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (both
// operands in shared memory), Pᵀ and dSᵀ in registers, then dV += Pᵀ·dO and
// dK += dSᵀ·Q with A from registers and B the stage's tiles, MN-major.
template <int DH, bool kCap>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,     // (B, nh, T)
                        const float* __restrict__ delta,   // (B, nh, T)
                        const int* __restrict__ kv_valid,  // (B, S)
                        const int* __restrict__ qstart,    // (B,)
                        bf16* __restrict__ dk,             // (B, S, nkv, DH)
                        bf16* __restrict__ dv,             // (B, S, nkv, DH)
                        float* __restrict__ work,          // partials, splits > 1
                        int B, int T, int S, int nh, int nkv, int window, float scale,
                        float softcap, int splits) {
  using W = WgDims<DH>;
  WgBars* bars;
  uint8_t* sm = wg_smem<DH>(bars);
  uint8_t* sK = sm;                  // [strip] tiles
  uint8_t* sV = sm + 2 * W::TILE;
  uint8_t* ring = sm + 4 * W::TILE;  // [stage]: Q tile, dO tile
  wg_init(bars);

  const int tid = threadIdx.x, wg = tid >> 7;  // the warpgroup: its 64-row strip
  const int split = blockIdx.x % splits, hk = (blockIdx.x / splits) % nkv;
  const int b = blockIdx.x / (splits * nkv);
  const int k0 = blockIdx.y * WG_CTA_ROWS;
  const int group = nh / nkv, per_split = group / splits;
  const int h0 = hk * group + split * per_split;
  const int qs = qstart[b];
  // query tiles from the block's causal horizon to the band's end
  const int qb0 = max(0, k0 - qs) / WG_ROWS;
  int nqb = (T + WG_ROWS - 1) / WG_ROWS;
  if (window > 0) {
    const int t_last = k0 + WG_CTA_ROWS + window - 2 - qs;
    nqb = t_last < 0 ? 0 : min(nqb, t_last / WG_ROWS + 1);
  }

  // items: (query head, query tile), heads outer
  const int nq = max(0, nqb - qb0), n_items = per_split * nq;
  auto issue = [&](int it) {  // item it's Q and dO tiles into stage it % WG_NST
    uint64_t* full = &bars->full[it % WG_NST];
    uint8_t* st = ring + (it % WG_NST) * 2 * W::TILE;
    const int h = h0 + it / nq, row = (qb0 + it % nq) * WG_ROWS;
    lapha::mbar_expect_tx(full, 2 * W::TILE);
    tma_tile<W::NB>(st, &map_q, full, h, row, b);
    tma_tile<W::NB>(st + W::TILE, &map_do, full, h, row, b);
  };
  if (tid == 0) {
    lapha::mbar_expect_tx(&bars->res, 4 * W::TILE);
    for (int s = 0; s < 2; ++s) {
      tma_tile<W::NB>(sK + s * W::TILE, &map_k, &bars->res, hk, k0 + s * WG_ROWS, b);
      tma_tile<W::NB>(sV + s * W::TILE, &map_v, &bars->res, hk, k0 + s * WG_ROWS, b);
    }
    for (int it = 0; it < min(WG_NST - 1, n_items); ++it) issue(it);
  }

  const int strip = wg, t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = k0 + strip * WG_ROWS;  // the strip's first key
  const int key[2] = {s0 + warp * 16 + g, s0 + warp * 16 + g + 8};
  bool kvis[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kvis[rr] = key[rr] < S && kv_valid[static_cast<size_t>(b) * S + key[rr]] != 0;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const uint32_t aK = lapha::smem_addr(sK + strip * W::TILE);
  const uint32_t aV = lapha::smem_addr(sV + strip * W::TILE);

  float dka[W::NACC], dva[W::NACC];
#pragma unroll
  for (int i = 0; i < W::NACC; ++i) dka[i] = dva[i] = 0.f;
  lapha::fence_acc(dka);
  lapha::fence_acc(dva);
  lapha::mbar_wait(&bars->res, 0);

  lapha::Ring<WG_NST> r;
  for (int it = 0; it < n_items; ++it, r.next()) {
    // thread 0: item it + WG_NST - 1 into the stage item it - 1 held, once
    // both warpgroups have released it
    const int pf = it + WG_NST - 1;
    if (tid == 0 && pf < n_items) {
      lapha::mbar_wait(&bars->empty[pf % WG_NST], ((pf / WG_NST) & 1) ^ 1);
      issue(pf);
    }
    __syncwarp();
    const int h = h0 + it / nq, t0 = (qb0 + it % nq) * WG_ROWS;
    const float* lrow = lse + (static_cast<size_t>(b) * nh + h) * T;
    const float* drow = delta + (static_cast<size_t>(b) * nh + h) * T;
    // some query of the tile sees some key of the strip
    const bool live = qs + t0 + WG_ROWS - 1 >= s0 &&
                      (window <= 0 || qs + t0 - window < s0 + WG_ROWS - 1);
    lapha::mbar_wait(&bars->full[r.stage], r.phase);
    if (live) {
      const uint32_t aQ = lapha::smem_addr(ring + r.stage * 2 * W::TILE);
      const uint32_t aO = aQ + W::TILE;
      float st[32], dpt[32];
      lapha::wgmma_fence();
      wg_logits<W::KS>(st, aK, aQ);   // Sᵀ = K·Qᵀ
      wg_logits<W::KS>(dpt, aV, aO);  // dPᵀ = V·dOᵀ
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(st);
      lapha::fence_acc(dpt);
      // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ - D) ∘ dc/ds; 0 where not visible. The
      // LSE and D of the thread's 16 query columns are read here (L1: all
      // 256 threads read the tile's 64), not held across the products.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + 8 * j + 2 * t4 + e;
          const float l = t < T ? __ldg(lrow + t) : NEG, d = t < T ? __ldg(drow + t) : 0.f;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = 4 * j + 2 * rr + e, kr = key[rr];
            const bool vis = kvis[rr] && l > 0.5f * NEG && kr <= qs + t &&
                             (window <= 0 || kr > qs + t - window);
            float dc;
            const float cl = capped<kCap>(st[i], scale, softcap, inv_cap, dc);
            const float p = vis ? __expf(cl - l) : 0.f;
            st[i] = p;
            dpt[i] = p * (dpt[i] - d) * dc;
          }
        }
      uint32_t ap[4][4], as[4][4];
      wg_a_frags(ap, st);
      wg_a_frags(as, dpt);
      lapha::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        lapha::wgmma_rs<1>(dva, ap[kk], desc_mn(aO, kk));  // dV += Pᵀ·dO
        lapha::wgmma_rs<1>(dka, as[kk], desc_mn(aQ, kk));  // dK += dSᵀ·Q
      }
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(dka);
      lapha::fence_acc(dva);
    }
    if (t128 == 0) lapha::mbar_arrive(&bars->empty[r.stage]);
  }

  // keys key[0], key[1]; columns 8j + 2t4 (+1) below DH
  const size_t nk = static_cast<size_t>(B) * S * nkv * DH;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (key[rr] >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + key[rr]) * nkv + hk) * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < W::DP / 8; ++j) {
      if (8 * j >= DH) continue;
      const float k0v = dka[4 * j + 2 * rr], k1v = dka[4 * j + 2 * rr + 1];
      const float v0 = dva[4 * j + 2 * rr], v1 = dva[4 * j + 2 * rr + 1];
      if (splits > 1) {  // unscaled f32 partials: dkv_reduce_kernel sums them
        *reinterpret_cast<float2*>(work + split * nk + off + 8 * j) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(work + (splits + split) * nk + off + 8 * j) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_f32(k0v * scale, k1v * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_f32(v0, v1);
      }
    }
  }
}

// dq: CTA (query head, batch row) on grid.x, 128-query block on grid.y in
// reverse (the last block, which sees the most keys, launched first).
// Consumer warpgroup s owns queries q0 + 64s..: S = Q·Kᵀ and dP = dO·Vᵀ
// (both operands in shared memory), dS in registers, then dQ += dS·K with A
// from registers and B the stage's K tile, MN-major.
template <int DH, bool kCap>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,     // (B, nh, T)
                       const float* __restrict__ delta,   // (B, nh, T)
                       const int* __restrict__ kv_valid,  // (B, S)
                       const int* __restrict__ qstart,    // (B,)
                       bf16* __restrict__ dq,             // (B, T, nh, DH)
                       int T, int S, int nh, int nkv, int window, float scale, float softcap) {
  using W = WgDims<DH>;
  WgBars* bars;
  uint8_t* sm = wg_smem<DH>(bars);
  uint8_t* sQ = sm;                  // [strip] tiles
  uint8_t* sO = sm + 2 * W::TILE;
  uint8_t* ring = sm + 4 * W::TILE;  // [stage]: K tile, V tile
  wg_init(bars);

  const int tid = threadIdx.x, wg = tid >> 7;  // the warpgroup: its 64-row strip
  const int h = blockIdx.x % nh, b = blockIdx.x / nh, hk = h / (nh / nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_CTA_ROWS;
  const int qs = qstart[b];
  // key tiles from the band's start to the causal frontier of the last row
  const int last_row = min(q0 + WG_CTA_ROWS, T) - 1;
  const int kend = min(S, qs + last_row + 1);
  const int nkb = kend <= 0 ? 0 : (kend + WG_ROWS - 1) / WG_ROWS;
  const int kb0 = window > 0 ? max(qs + q0 - (window - 1), 0) / WG_ROWS : 0;

  // items: key tiles
  const int n_items = max(0, nkb - kb0);
  auto issue = [&](int it) {  // item it's K and V tiles into stage it % WG_NST
    uint64_t* full = &bars->full[it % WG_NST];
    uint8_t* st = ring + (it % WG_NST) * 2 * W::TILE;
    lapha::mbar_expect_tx(full, 2 * W::TILE);
    tma_tile<W::NB>(st, &map_k, full, hk, (kb0 + it) * WG_ROWS, b);
    tma_tile<W::NB>(st + W::TILE, &map_v, full, hk, (kb0 + it) * WG_ROWS, b);
  };
  if (tid == 0) {
    lapha::mbar_expect_tx(&bars->res, 4 * W::TILE);
    for (int s = 0; s < 2; ++s) {
      tma_tile<W::NB>(sQ + s * W::TILE, &map_q, &bars->res, h, q0 + s * WG_ROWS, b);
      tma_tile<W::NB>(sO + s * W::TILE, &map_do, &bars->res, h, q0 + s * WG_ROWS, b);
    }
    for (int it = 0; it < min(WG_NST - 1, n_items); ++it) issue(it);
  }

  const int strip = wg, t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = q0 + strip * WG_ROWS;      // the strip's first query
  const int s1 = min(s0 + WG_ROWS, T) - 1;  // ... and last
  const int row[2] = {s0 + warp * 16 + g, s0 + warp * 16 + g + 8};
  float lse_r[2], d_r[2];
  bool ok_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const size_t i = (static_cast<size_t>(b) * nh + h) * T + row[rr];
    lse_r[rr] = row[rr] < T ? lse[i] : NEG;
    d_r[rr] = row[rr] < T ? delta[i] : 0.f;
    ok_r[rr] = lse_r[rr] > 0.5f * NEG;
  }
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const uint32_t aQ = lapha::smem_addr(sQ + strip * W::TILE);
  const uint32_t aO = lapha::smem_addr(sO + strip * W::TILE);
  const int* vrow = kv_valid + static_cast<size_t>(b) * S;

  float dqa[W::NACC];
#pragma unroll
  for (int i = 0; i < W::NACC; ++i) dqa[i] = 0.f;
  lapha::fence_acc(dqa);
  lapha::mbar_wait(&bars->res, 0);

  lapha::Ring<WG_NST> r;
  for (int it = 0; it < n_items; ++it, r.next()) {
    // thread 0: item it + WG_NST - 1 into the stage item it - 1 held, once
    // both warpgroups have released it
    const int pf = it + WG_NST - 1;
    if (tid == 0 && pf < n_items) {
      lapha::mbar_wait(&bars->empty[pf % WG_NST], ((pf / WG_NST) & 1) ^ 1);
      issue(pf);
    }
    __syncwarp();
    const int k0 = (kb0 + it) * WG_ROWS;
    // some key of the tile is seen by some query of the strip
    const bool live = s0 <= s1 && k0 <= qs + s1 &&
                      (window <= 0 || k0 + WG_ROWS - 1 > qs + s0 - window);
    bool kvis[16];  // this thread's 16 key columns
    if (live) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + 2 * t4 + e;
          kvis[2 * j + e] = c < S && vrow[c] != 0;
        }
    }
    lapha::mbar_wait(&bars->full[r.stage], r.phase);
    if (live) {
      const uint32_t aK = lapha::smem_addr(ring + r.stage * 2 * W::TILE);
      const uint32_t aV = aK + W::TILE;
      float s[32], dp[32];
      lapha::wgmma_fence();
      wg_logits<W::KS>(s, aQ, aK);   // S = Q·Kᵀ
      wg_logits<W::KS>(dp, aO, aV);  // dP = dO·Vᵀ
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(s);
      lapha::fence_acc(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, rr = e >> 1;
          const int c = k0 + 8 * j + 2 * t4 + (e & 1);
          const bool vis = ok_r[rr] && kvis[2 * j + (e & 1)] && c <= qs + row[rr] &&
                           (window <= 0 || c > qs + row[rr] - window);
          float dc;
          const float cl = capped<kCap>(s[i], scale, softcap, inv_cap, dc);
          const float p = vis ? __expf(cl - lse_r[rr]) : 0.f;
          s[i] = p * (dp[i] - d_r[rr]) * dc;
        }
      uint32_t a[4][4];
      wg_a_frags(a, s);
      lapha::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) lapha::wgmma_rs<1>(dqa, a[kk], desc_mn(aK, kk));  // dQ += dS·K
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(dqa);
    }
    if (t128 == 0) lapha::mbar_arrive(&bars->empty[r.stage]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] >= T) continue;
    bf16* op = dq + ((static_cast<size_t>(b) * T + row[rr]) * nh + h) * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < W::DP / 8; ++j)
      if (8 * j < DH)
        *reinterpret_cast<uint32_t*>(op + 8 * j) =
            pack_f32(dqa[4 * j + 2 * rr] * scale, dqa[4 * j + 2 * rr + 1] * scale);
  }
}

// ---------------------------------------------------------------- the split's reduction

// dK = scale·Σ_s partial_s and dV = Σ_s partial_s, over the splits in
// order 0, 1, ...: `work` holds the dK partials (splits x nk) then the dV
// ones (splits x nv). The fixed order makes two launches bit-equal.
__global__ void dkv_reduce_kernel(const float* __restrict__ work, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, size_t nk, size_t nv, int splits,
                                  float scale) {
  const size_t n4 = (nk + nv) / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = 4 * i;
    const bool is_k = e < nk;
    const size_t n = is_k ? nk : nv;
    const float* src = is_k ? work + e : work + splits * nk + (e - nk);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(src + s * n);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const float f = is_k ? scale : 1.f;
    uint2 out;
    out.x = pack_f32(acc.x * f, acc.y * f);
    out.y = pack_f32(acc.z * f, acc.w * f);
    *reinterpret_cast<uint2*>(is_k ? dk + e : dv + (e - nk)) = out;
  }
}

int launch_reduce(const float* work, void* dk, void* dv, size_t nk, size_t nv, int splits,
                  float scale, cudaStream_t stream) {
  const size_t blocks = std::min<size_t>(((nk + nv) / 4 + 255) / 256, 16 * lapha::sm_count());
  dkv_reduce_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      work, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nk, nv, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

// A 4-D map over a (B, rows, heads, dh) bf16 tensor: boxes of 64 rows x 64
// head-dim columns of one head and batch row.
cudaError_t head_map(CUtensorMap* map, const void* base, int B, int rows, int heads, int dh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(heads) * dh * 2,
                                 static_cast<cuuint64_t>(rows) * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, WG_ROWS, 1};
  return lapha::make_map(map, base, 4, dims, strides, box);
}

// Q, K, V and dO maps (V and dO as wide as Q/K on this design).
cudaError_t wg_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                    const void* dout, int B, int T, int S, int nh, int nkv, int dh) {
  cudaError_t err = head_map(&m[0], q, B, T, nh, dh);
  if (err == cudaSuccess) err = head_map(&m[1], k, B, S, nkv, dh);
  if (err == cudaSuccess) err = head_map(&m[2], v, B, S, nkv, dh);
  if (err == cudaSuccess) err = head_map(&m[3], dout, B, T, nh, dh);
  return err;
}

bool bad_shape(int B, int T, int S, int nh, int nkv, int window, float softcap) {
  return nkv <= 0 || nh % nkv != 0 || B <= 0 || T <= 0 || S <= 0 || window < 0 ||
         !(softcap >= 0.f);
}

template <int DH, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* kv_valid, const int* qstart, void* dq, int B, int T,
              int S, int nh, int nkv, int window, float scale, float softcap,
              cudaStream_t stream) {
  const bool cap = softcap > 0.f;
  static bool opted[2][lapha::kMaxDevices] = {};
  if constexpr (DH <= 128) {  // the wgmma design
    static_assert(DV == DH, "the wgmma design takes V as wide as Q/K");
    constexpr int smem = wg_smem_bytes<DH>();
    const auto kernel = cap ? flash_bwd_dq_wg_kernel<DH, true> : flash_bwd_dq_wg_kernel<DH, false>;
    CUtensorMap m[4];
    cudaError_t err = wg_maps(m, q, k, v, dout, B, T, S, nh, nkv, DH);
    if (err == cudaSuccess) err = lapha::smem_opt_in(kernel, smem, opted[cap]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(nh * B, (T + WG_CTA_ROWS - 1) / WG_CTA_ROWS);
    kernel<<<grid, WG_THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], lse, delta, kv_valid,
                                               qstart, static_cast<bf16*>(dq), T, S, nh, nkv,
                                               window, scale, softcap);
  } else {
    constexpr size_t smem = Dims<DH, DV>::DQ_SMEM;
    const auto kernel = cap ? flash_bwd_dq_kernel<DH, DV, true> : flash_bwd_dq_kernel<DH, DV, false>;
    cudaError_t err = lapha::smem_opt_in(kernel, static_cast<int>(smem), opted[cap]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((T + DQ_BQ - 1) / DQ_BQ, nh, B);
    kernel<<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, kv_valid, qstart, static_cast<bf16*>(dq),
        T, S, nh, nkv, window, scale, softcap);
  }
  return static_cast<int>(cudaGetLastError());
}

// dk/dv: the wgmma kernel at DH <= 128, the eight-warp split kernel above;
// with splits > 1 each writes its heads' f32 partials to `work` and a second
// launch sums them in split order.
template <int DH, int DV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kv_valid, const int* qstart, void* dk, void* dv,
               float* work, int B, int T, int S, int nh, int nkv, int window, float scale,
               float softcap, int splits, cudaStream_t stream) {
  if (splits < 1 || (nh / nkv) % splits != 0 || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cap = softcap > 0.f;
  cudaError_t err;
  if constexpr (DH <= 128) {
    static_assert(DV == DH, "the wgmma design takes V as wide as Q/K");
    static bool opted[2][lapha::kMaxDevices] = {};
    constexpr int smem = wg_smem_bytes<DH>();
    const auto kernel = cap ? flash_bwd_dkv_wg_kernel<DH, true> : flash_bwd_dkv_wg_kernel<DH, false>;
    CUtensorMap m[4];
    err = wg_maps(m, q, k, v, dout, B, T, S, nh, nkv, DH);
    if (err == cudaSuccess) err = lapha::smem_opt_in(kernel, smem, opted[cap]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(splits * nkv * B, (S + WG_CTA_ROWS - 1) / WG_CTA_ROWS);
    kernel<<<grid, WG_THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], lse, delta, kv_valid,
                                               qstart, static_cast<bf16*>(dk),
                                               static_cast<bf16*>(dv), work, B, T, S, nh, nkv,
                                               window, scale, softcap, splits);
  } else {
    // the partial path is an instance of its own: the one-split kernel
    // carries none of its registers
    constexpr size_t smem = Dims<DH, DV>::KV_SMEM;
    const bool part = splits > 1;
    const auto kernel = cap ? (part ? flash_bwd_dkv_split_kernel<DH, DV, true, true>
                                    : flash_bwd_dkv_split_kernel<DH, DV, true, false>)
                            : (part ? flash_bwd_dkv_split_kernel<DH, DV, false, true>
                                    : flash_bwd_dkv_split_kernel<DH, DV, false, false>);
    static bool opted[2][2][lapha::kMaxDevices] = {};
    err = lapha::smem_opt_in(kernel, static_cast<int>(smem), opted[cap][part]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + KV_BK - 1) / KV_BK, nkv * splits, B);
    kernel<<<grid, Dims<DH, DV>::KV_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, kv_valid, qstart, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), work, T, S, nh, nkv, window, scale, softcap, splits);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(B) * S * nkv;
  return launch_reduce(work, dk, dv, rows * DH, rows * DV, splits, scale, stream);
}

}  // namespace

// `window` > 0 bands the keys to the last `window` positions (0 = off);
// `softcap` > 0 caps the scaled logits, s -> cap·tanh(s/cap) (0 = off).
// (dh, dv_w): the head dims of Q/K and of V/dO, one of the instances above;
// any other pair is refused with cudaErrorInvalidValue.
extern "C" int lapha_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, const int* kv_valid,
                                  const int* qstart, void* dq, int B, int T, int S, int nh,
                                  int nkv, int dh, int dv_w, int window, float scale,
                                  float softcap, void* stream) {
  if (bad_shape(B, T, S, nh, nkv, window, softcap)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define LAPHA_DQ(DH, DV)                                                                      \
  if (dh == DH && dv_w == DV)                                                                 \
    return launch_dq<DH, DV>(q, k, v, dout, lse, delta, kv_valid, qstart, dq, B, T, S, nh, nkv, \
                             window, scale, softcap, st);
  LAPHA_DQ(64, 64)
  LAPHA_DQ(128, 128)
  LAPHA_DQ(256, 256)
  LAPHA_DQ(192, 128)
  LAPHA_DQ(96, 96)
#undef LAPHA_DQ
  return static_cast<int>(cudaErrorInvalidValue);
}

// `splits` divides the GQA group: each split's CTAs take that many of its
// query heads, and `work` holds splits x (B·S·nkv·(dh + dv_w)) f32 partials
// (unused with one split).
extern "C" int lapha_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* kv_valid,
                                   const int* qstart, void* dk, void* dv, void* work, int B, int T,
                                   int S, int nh, int nkv, int dh, int dv_w, int window,
                                   float scale, float softcap, int splits, void* stream) {
  if (bad_shape(B, T, S, nh, nkv, window, softcap)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define LAPHA_DKV(DH, DV)                                                                    \
  if (dh == DH && dv_w == DV)                                                                \
    return launch_dkv<DH, DV>(q, k, v, dout, lse, delta, kv_valid, qstart, dk, dv,            \
                              static_cast<float*>(work), B, T, S, nh, nkv, window, scale,      \
                              softcap, splits, st);
  LAPHA_DKV(64, 64)
  LAPHA_DKV(128, 128)
  LAPHA_DKV(256, 256)
  LAPHA_DKV(192, 128)
  LAPHA_DKV(96, 96)
#undef LAPHA_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
