// Grouped GEMM (the MoE expert products) for Hopper, forward and backward:
// out[r] = x[r] @ w[g] for every row r of group g, the groups being
// contiguous row ranges, rows [off_g, off_g + group_sizes[g]) with
// off_g = Σ_{h<g} group_sizes[h].
//
// Replaces lapha_tpu/ops/moe.py _grouped_gemm :290 (megablox.gmm :303 on the
// TPU, jax.lax.ragged_dot elsewhere): x (M, K) bf16, w (G, K, N) bf16 with
// each expert's weights [K][N] row-major, group_sizes (G,) int32 on the
// device -> out (M, N) f32 (preferred_element_type=float32). Rows past
// Σ group_sizes are written as zeros, as ragged_dot gives.
//
// And its backward, megablox's _gmm_bwd (jax 0.9.0 megablox/ops.py:63-105),
// two kernels from the bf16-rounded cotangent dy (M, N):
//   dX = dy @ w_gᵀ per group (M, K) bf16: gmm(grad, rhs, transpose_rhs=True)
//        (megablox/gmm.py:314); rows past the groups are 0. It is the
//        forward kernel with the B tile read from rows of w_g[k, :]
//        (template flag kDx) and a bf16 store.
//   dW_g = x_gᵀ @ dy_g (G, K, N) bf16: tgmm (megablox/gmm.py:573); an
//        expert with no rows gets exact zeros (_zero_uninitialized_memory,
//        gmm.py:286), never memory left as it was.
//
// What bounds them on an H100: the expert weights at decode, matrix
// throughput at prefill and in training. At decode (M = 96 rows, 24 rows x
// top-4, over 60 experts) each touched expert's K·N weights feed ~2 rows:
// the bound is ~48 experts x 5.8 MB at 3.35 TB/s. At prefill (M = 8192)
// all 60 experts (346 MB) are read for ~137 rows each: 2·M·K·N = 47 GFLOP
// is 0.05 ms at 989 TFLOP/s, under the 0.10 ms of the weight stream. In
// training (M = 32768 pair rows, ~546 an expert) each of the three
// products is 2·M·K·N = 189 GFLOP against 346 MB + 2 x 92-134 MB of rows:
// operations bound, 0.19 ms each. The design reads every tile from device
// memory once per output tile and keeps loads in flight: a CTA owns a
// 64 x 64 output tile (of one expert's rows for the forward and dX, of one
// expert's dW for tgmm) and walks the reduction in steps of 32 through a
// 3-stage cp.async ring, so two tiles are in flight while the tensor cores
// work on the third.
//
// The group sizes never leave the device (the MoE layer never waits on the
// host): each CTA builds the exclusive prefix sums of the row counts and of
// the 64-row tile counts in shared memory (one warp, shuffle scans over 32
// groups at a time). The forward and dX find their (expert, row tile) by
// binary search over the tile offsets on a fixed grid: ceil(M/64) + G + 1
// row tiles (enough for any split of M rows into G groups, plus the zero
// tail) x ceil(N/64) column tiles; CTAs past the last tile exit at once,
// and rows past a group's end are never read or written. tgmm's grid is
// (K/64 x N/64 tiles, G): its CTA reads its expert's row range [off_g,
// off_g + size_g) from the prefix sums and sums over those rows alone, so
// dW needs no atomics and is deterministic.
//
// Products: mma.sync m16n8k16 bf16 with f32 accumulators (common.cuh); each
// of the 4 warps owns 32x32 of the tile. Fragments come from padded shared
// memory with ldmatrix: the forward's A tiles are [m][k] and its B tiles
// keep the weights' [k][n] layout (ldmatrix.trans); dX's B tiles are rows
// of w_g, [n][k] (plain ldmatrix); tgmm's A tiles are x rows [r][k], read
// transposed (ldmatrix.trans), and its B tiles dy rows [r][n] as the
// forward's B. Rows past the group, reductions past their end and columns
// past the output are zero-filled by cp.async. Simple first version: no
// TMA or wgmma, and 64-row tiles spend tensor-core work on padding at
// decode (~2 rows per expert), where the weight stream bounds it anyway.

#include "common.cuh"

namespace {

using lapha::mma_bf16_16816;  // fragment layout: common.cuh
using bf16 = __nv_bfloat16;

constexpr int BM = 64;       // output rows per CTA
constexpr int BN = 64;       // output columns per CTA
constexpr int BK = 32;       // reduction per pipeline stage
constexpr int NT = 128;      // threads: 4 warps, 2 x 2 over the tile, 32x32 each
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int LDA = BK + 8;  // 80-byte smem rows: 16-byte aligned, ldmatrix conflict-free
constexpr int LDB = BN + 8;  // 144-byte smem rows: the same
constexpr int B_TILE = (BK * LDB > BN * LDA) ? BK * LDB : BN * LDA;  // [k][n] or [n][k]
constexpr int GMAX = 1024;   // most groups the prefix sums hold

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: from [k][n] rows, lane 4g + t4 gets
// (k = 2t4, 2t4 + 1; n = g), an mma B fragment.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// out[n], out[n + 1] of one row, masked at N
__device__ __forceinline__ void store2(float* row, int n, int N, float a, float b) {
  if (n + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<float2*>(row + n) = make_float2(a, b);
  } else {
    if (n < N) row[n] = a;
    if (n + 1 < N) row[n + 1] = b;
  }
}

__device__ __forceinline__ void store2(bf16* row, int n, int N, float a, float b) {
  if (n + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(a, b);
  } else {
    if (n < N) row[n] = __float2bfloat16(a);
    if (n + 1 < N) row[n + 1] = __float2bfloat16(b);
  }
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ bf16 zero_of<bf16>() { return __float2bfloat16(0.f); }

// Warp 0 writes the exclusive prefix sums of the group sizes (s_roff) and
// of their 64-row tile counts (s_toff), G + 1 entries each; the caller
// synchronises the block after it.
__device__ __forceinline__ void group_prefix(const int* __restrict__ group_sizes, int G,
                                             int* s_roff, int* s_toff, int lane) {
  int rows = 0, tiles = 0;
  for (int base = 0; base < G; base += 32) {
    const int g = base + lane;
    const int s = g < G ? max(group_sizes[g], 0) : 0;
    const int nt = (s + BM - 1) / BM;
    int rs = s, ts = nt;  // inclusive scans over the 32 lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int r = __shfl_up_sync(0xffffffffu, rs, o);
      const int t = __shfl_up_sync(0xffffffffu, ts, o);
      if (lane >= o) {
        rs += r;
        ts += t;
      }
    }
    if (g < G) {
      s_roff[g] = rows + rs - s;
      s_toff[g] = tiles + ts - nt;
    }
    rows += __shfl_sync(0xffffffffu, rs, 31);
    tiles += __shfl_sync(0xffffffffu, ts, 31);
  }
  if (lane == 0) {
    s_roff[G] = rows;
    s_toff[G] = tiles;
  }
}

// The forward (kDx false): a = x (M, R = K), w (G, R, Nout) [k][n], out
// (M, Nout) f32. dX (kDx true): a = dy (M, R = N), w (G, Nout = K, R)
// read as [n][k] rows, out (M, Nout) bf16. Rows are grouped alike in both.
template <bool kDx, typename OutT>
__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const bf16* __restrict__ a,           // (M, R)
                    const bf16* __restrict__ w,           // (G, R, Nout) or (G, Nout, R)
                    const int* __restrict__ group_sizes,  // (G,)
                    OutT* __restrict__ out,               // (M, Nout)
                    int M, int R, int Nout, int G, int vec_b) {
  __shared__ int s_roff[GMAX + 1];  // exclusive prefix sum of the group sizes
  __shared__ int s_toff[GMAX + 1];  // exclusive prefix sum of the 64-row tiles
  __shared__ __align__(16) bf16 sA[STAGES][BM * LDA];  // a tile, [m][k]
  __shared__ __align__(16) bf16 sB[STAGES][B_TILE];    // w tile, [k][n] (kDx: [n][k])

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp == 0) group_prefix(group_sizes, G, s_roff, s_toff, lane);
  __syncthreads();

  const int t = blockIdx.x, n0 = blockIdx.y * BN;
  const int n_tiles = s_toff[G];
  const int total = min(s_roff[G], M);
  if (t >= n_tiles) {
    // past the groups: rows [total, M) are zeros, as ragged_dot gives
    const int r0 = total + (t - n_tiles) * BM;
    if (r0 >= M) return;
    const int r1 = min(r0 + BM, M);
    for (int i = tid; i < (r1 - r0) * BN; i += NT) {
      const int r = r0 + i / BN, n = n0 + i % BN;
      if (n < Nout) out[static_cast<size_t>(r) * Nout + n] = zero_of<OutT>();
    }
    return;
  }
  int lo = 0, hi = G - 1;  // the largest g with s_toff[g] <= t: a non-empty group
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_toff[mid] <= t) lo = mid;
    else hi = mid - 1;
  }
  const int g = lo;
  const int r0 = s_roff[g] + (t - s_toff[g]) * BM;         // this CTA's rows [r0, r1)
  const int r1 = min(min(s_roff[g + 1], r0 + BM), M);
  if (r0 >= r1) return;  // only when Σ group_sizes > M
  const bf16* wg = w + static_cast<size_t>(g) * R * Nout;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kt * BK;
    // a rows r0.. of this group: BM x BK in 16-byte chunks
    for (int i = tid; i < BM * (BK / 8); i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = r0 + r < r1 && k0 + c < R;
      const bf16* src = ok ? a + static_cast<size_t>(r0 + r) * R + k0 + c : a;
      cp_async16(&sA[stage][r * LDA + c], src, ok);
    }
    if constexpr (kDx) {
      // rows n0.. of w_g (output columns), BK reduction columns each
      for (int i = tid; i < BN * (BK / 8); i += NT) {
        const int nr = i / (BK / 8), c = (i % (BK / 8)) * 8;
        const bool ok = n0 + nr < Nout && k0 + c < R;
        cp_async16(&sB[stage][nr * LDA + c],
                   ok ? wg + static_cast<size_t>(n0 + nr) * R + k0 + c : wg, ok);
      }
      return;
    }
    // the expert's weights: BK rows of k, BN columns
    for (int i = tid; i < BK * (BN / 8); i += NT) {
      const int kr = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const int k = k0 + kr, n = n0 + c;
      bf16* dst = &sB[stage][kr * LDB + c];
      if (vec_b) {
        const bool ok = k < R && n < Nout;
        cp_async16(dst, ok ? wg + static_cast<size_t>(k) * Nout + n : wg, ok);
      } else {  // rows of w not 16-byte aligned (N % 8 != 0): element loads
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (k < R && n + j < Nout) ? wg[static_cast<size_t>(k) * Nout + n + j]
                                           : __float2bfloat16(0.f);
      }
    }
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const bool live = wm < r1 - r0;  // warp-uniform: the warp has rows of the group
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const int nk = (R + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and stage (kt-1)%STAGES is free
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_tile(pf % STAGES, pf);
    cp_async_commit();
    if (!live) continue;
    const bf16* as = sA[kt % STAGES];
    const bf16* bs = sB[kt % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // matrices (rows 0-7|8-15) x (k 0-7|8-15)
        ldsm_x4(af[mi], as + (wm + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDA +
                            ks + 8 * (lane >> 4));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        if constexpr (kDx)  // [n][k] rows: matrices (n 0-7, k 0-7|8-15), (n 8-15, k 0-7|8-15)
          ldsm_x4(bf[nj], bs + (wn + nj * 16 + (lane & 7) + 8 * (lane >> 4)) * LDA +
                              ks + 8 * ((lane >> 3) & 1));
        else      // [k][n] rows: matrices (k 0-7|8-15) x (n 0-7|8-15), transposed
          ldsm_x4_t(bf[nj], bs + (ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                                wn + nj * 16 + 8 * (lane >> 4));
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bf[ni >> 1][2 * (ni & 1)],
                         bf[ni >> 1][2 * (ni & 1) + 1]);
    }
  }
  cp_async_wait<0>();
  if (!live) return;

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int ra = r0 + wm + mi * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn + ni * 8 + 2 * (lane & 3);
      if (ra < r1) store2(out + static_cast<size_t>(ra) * Nout, n, Nout, acc[mi][ni][0], acc[mi][ni][1]);
      if (rb < r1) store2(out + static_cast<size_t>(rb) * Nout, n, Nout, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// dW_g = x_gᵀ dy_g: the CTA (blockIdx.x = its 64 x 64 tile of (K, N),
// blockIdx.y = expert g) sums over the expert's rows [off_g, off_g + size_g)
// in steps of BK; an expert without rows writes its tile's zeros.
__global__ void __launch_bounds__(NT)
grouped_gemm_tgmm_kernel(const bf16* __restrict__ x,           // (M, K)
                         const bf16* __restrict__ dy,          // (M, N)
                         const int* __restrict__ group_sizes,  // (G,)
                         bf16* __restrict__ dw,                // (G, K, N)
                         int M, int K, int N, int G) {
  __shared__ int s_roff[GMAX + 1];
  __shared__ int s_toff[GMAX + 1];
  __shared__ __align__(16) bf16 sA[STAGES][BK * LDB];  // x rows, [r][k]
  __shared__ __align__(16) bf16 sB[STAGES][BK * LDB];  // dy rows, [r][n]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp == 0) group_prefix(group_sizes, G, s_roff, s_toff, lane);
  __syncthreads();

  const int g = blockIdx.y;
  const int n_col_tiles = (N + BN - 1) / BN;
  const int k0 = (blockIdx.x / n_col_tiles) * BM, n0 = (blockIdx.x % n_col_tiles) * BN;
  const int r0 = min(s_roff[g], M), r1 = min(s_roff[g + 1], M);

  auto load_tile = [&](int stage, int kt) {
    const int rt = r0 + kt * BK;
    for (int i = tid; i < BK * (BM / 8); i += NT) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const bool okr = rt + r < r1;
      const bool oka = okr && k0 + c < K, okb = okr && n0 + c < N;
      cp_async16(&sA[stage][r * LDB + c],
                 oka ? x + static_cast<size_t>(rt + r) * K + k0 + c : x, oka);
      cp_async16(&sB[stage][r * LDB + c],
                 okb ? dy + static_cast<size_t>(rt + r) * N + n0 + c : dy, okb);
    }
  };

  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  const int nk = (r1 - r0 + BK - 1) / BK;  // 0 for an expert without rows
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < nk) load_tile(pf % STAGES, pf);
    cp_async_commit();
    const bf16* as = sA[kt % STAGES];
    const bf16* bs = sB[kt % STAGES];
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)  // [r][k] stored: matrices (k 0-7|8-15) x (r 0-7|8-15), transposed
        ldsm_x4_t(af[mi], as + (ks + (lane & 7) + 8 * (lane >> 4)) * LDB +
                              wm + mi * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4_t(bf[nj], bs + (ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDB +
                              wn + nj * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16_16816(acc[mi][ni], af[mi], bf[ni >> 1][2 * (ni & 1)],
                         bf[ni >> 1][2 * (ni & 1) + 1]);
    }
  }
  cp_async_wait<0>();

  bf16* out = dw + static_cast<size_t>(g) * K * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int ka = k0 + wm + mi * 16 + (lane >> 2), kb = ka + 8;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int n = n0 + wn + ni * 8 + 2 * (lane & 3);
      if (ka < K) store2(out + static_cast<size_t>(ka) * N, n, N, acc[mi][ni][0], acc[mi][ni][1]);
      if (kb < K) store2(out + static_cast<size_t>(kb) * N, n, N, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

}  // namespace

extern "C" int lapha_grouped_gemm(const void* x, const void* w, const void* group_sizes, void* out,
                                  int M, int K, int N, int G, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > GMAX || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_b = (N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) ? 1 : 0;
  const dim3 grid((M + BM - 1) / BM + G + 1, (N + BN - 1) / BN);
  grouped_gemm_kernel<false, float><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<float*>(out), M, K, N, G, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// dX (M, K) bf16 from dy (M, N) bf16 and w (G, K, N); N a multiple of 8
// and w 16-byte aligned (rows of w are read with 16-byte copies).
extern "C" int lapha_grouped_gemm_dx(const void* dy, const void* w, const void* group_sizes,
                                     void* dx, int M, int K, int N, int G, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > GMAX || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + BM - 1) / BM + G + 1, (K + BN - 1) / BN);
  grouped_gemm_kernel<true, bf16><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(dx), M, N, K, G, 1);
  return static_cast<int>(cudaGetLastError());
}

// dW (G, K, N) bf16 from x (M, K) and dy (M, N), both bf16; K and N
// multiples of 8 (rows are read with 16-byte copies).
extern "C" int lapha_grouped_gemm_tgmm(const void* x, const void* dy, const void* group_sizes,
                                       void* dw, int M, int K, int N, int G, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > GMAX || K % 8 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(((K + BM - 1) / BM) * ((N + BN - 1) / BN), G);
  grouped_gemm_tgmm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const int*>(group_sizes), static_cast<bf16*>(dw), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}
