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
//        forward's wgmma kernel with the B tile read from rows of w_g[k, :]
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
// operations bound, 0.19 ms each.
//
// Two designs, chosen on the host before the launch from M, G, N and the
// weights' alignment (ops/grouped_gemm.py forward_kernel), never from the
// group sizes, which stay on the device:
//
// 1. The wgmma design (the forward where experts have many rows, every dX,
//    every tgmm). A persistent CTA per SM walks 128 x 128 output tiles. One
//    producer thread keeps a 4-stage ring full with TMA loads
//    (cp.async.bulk.tensor, 128-byte swizzle, 64 reduction columns of
//    128-byte rows a stage) signalled through mbarrier full/empty pairs;
//    two consumer warpgroups each issue wgmma.mma_async m64n128k16 on a
//    64-row half, f32 accumulators in registers (setmaxnreg moves registers
//    from the producer to them), one group of products kept in flight while
//    the next stage is issued. Operand layouts: the forward's A is x rows
//    [r][k] (K-major) and its B the weights [k][n] (MN-major, wgmma's
//    transpose bit); dX's A is dy rows [r][n] and its B rows of w_g [k][n]
//    read as [n-out][n-red] (both K-major); tgmm's A is x rows read as
//    [k][r] and its B dy rows [r][n] (both MN-major). The weights go through
//    a 3-D tensor map (G, ., .), so a box never reads past its expert.
//    Tiles of the row-grouped products are ordered expert by expert, then by
//    column panel, then by the expert's row tiles, so that an expert's
//    weight panel is read from HBM once and reread from L2 by its row tiles.
//    A tile's A rows may run past the group's end into the next expert's
//    rows (TMA reads them, they are in bounds): they are never stored. The
//    epilogue goes through shared memory, and each row is stored as whole
//    16-byte chunks with st.global, masked at the group's end and at the
//    edges (never a TMA store, which would write a partial tile's rows of
//    the next expert). tgmm's tiles are (expert, K tile, N tile); its
//    reduction starts at the expert's first row, and the last chunk's rows
//    past the expert's end are zeroed in the consumer's own x box in shared
//    memory (then fence.proxy.async) before the wgmma that reads them. The
//    next tile's loads run during a tile's epilogue.
// 2. The 64-row mma.sync forward (decode: a few rows an expert, where the
//    weight stream bounds it and 128-row tiles would be padding; N % 8 != 0
//    or weights not 16-byte aligned, which TMA cannot take). A CTA owns a
//    64 x 64 output tile of one expert's rows on a fixed grid of ceil(M/64)
//    + G + 1 row tiles x ceil(N/64) column tiles, walks the reduction in
//    steps of 32 through a 3-stage cp.async ring, and finds its (expert, row
//    tile) by binary search over the tile offsets. mma.sync m16n8k16 with
//    ldmatrix fragments; each of the 4 warps owns 32x32 of the tile.
//
// Both find their tiles from the exclusive prefix sums of the group sizes
// and of their tile counts, built by one warp in shared memory (shuffle
// scans over 32 groups at a time), clipped at M. No atomics: every output
// element is written by one thread, so the results are deterministic.

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"  // cp.async, ldmatrix, mbarriers, TMA, wgmma, tensor maps

namespace {

using lapha::mma_bf16_16816;  // fragment layout: common.cuh
using namespace lapha;        // hopper.cuh's helpers
using bf16 = __nv_bfloat16;

constexpr int GMAX = 1024;   // most groups the prefix sums hold

// Warp 0 writes the exclusive prefix sums of the group sizes, clipped at M
// (s_roff), and of their TILE-row tile counts (s_toff), G + 1 entries each;
// the caller synchronises the block after it.
template <int TILE>
__device__ __forceinline__ void group_prefix(const int* __restrict__ group_sizes, int G, int M,
                                             int* s_roff, int* s_toff, int lane) {
  int rows = 0, tiles = 0;
  for (int base = 0; base < G; base += 32) {
    const int g = base + lane;
    const int s = g < G ? max(group_sizes[g], 0) : 0;
    int rs = s;  // inclusive scan over the 32 lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int r = __shfl_up_sync(0xffffffffu, rs, o);
      if (lane >= o) rs += r;
    }
    const int start = min(rows + rs - s, M), end = min(rows + rs, M);
    const int nt = (end - start + TILE - 1) / TILE;
    int ts = nt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, ts, o);
      if (lane >= o) ts += t;
    }
    if (g < G) {
      s_roff[g] = start;
      s_toff[g] = tiles + ts - nt;
    }
    rows += __shfl_sync(0xffffffffu, rs, 31);
    tiles += __shfl_sync(0xffffffffu, ts, 31);
  }
  if (lane == 0) {
    s_roff[G] = min(rows, M);
    s_toff[G] = tiles;
  }
}

// ---------------------------------------------------------------- the 64-row mma.sync forward

constexpr int BM = 64;       // output rows per CTA
constexpr int BN = 64;       // output columns per CTA
constexpr int BK = 32;       // reduction per pipeline stage
constexpr int NT = 128;      // threads: 4 warps, 2 x 2 over the tile, 32x32 each
constexpr int STAGES = 3;    // cp.async ring depth
constexpr int LDA = BK + 8;  // 80-byte smem rows: 16-byte aligned, ldmatrix conflict-free
constexpr int LDB = BN + 8;  // 144-byte smem rows: the same

// out[n], out[n + 1] of one row, masked at N
__device__ __forceinline__ void store2(float* row, int n, int N, float a, float b) {
  if (n + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<float2*>(row + n) = make_float2(a, b);
  } else {
    if (n < N) row[n] = a;
    if (n + 1 < N) row[n + 1] = b;
  }
}

// x (M, K), w (G, K, N) [k][n], out (M, N) f32.
__global__ void __launch_bounds__(NT)
grouped_gemm_kernel(const bf16* __restrict__ a,           // (M, K)
                    const bf16* __restrict__ w,           // (G, K, N)
                    const int* __restrict__ group_sizes,  // (G,)
                    float* __restrict__ out,              // (M, N)
                    int M, int R, int Nout, int G, int vec_b) {
  __shared__ int s_roff[GMAX + 1];  // exclusive prefix sum of the group sizes
  __shared__ int s_toff[GMAX + 1];  // exclusive prefix sum of the 64-row tiles
  __shared__ __align__(16) bf16 sA[STAGES][BM * LDA];  // a tile, [m][k]
  __shared__ __align__(16) bf16 sB[STAGES][BK * LDB];  // w tile, [k][n]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp == 0) group_prefix<BM>(group_sizes, G, M, s_roff, s_toff, lane);
  __syncthreads();

  const int t = blockIdx.x, n0 = blockIdx.y * BN;
  const int n_tiles = s_toff[G];
  const int total = s_roff[G];
  if (t >= n_tiles) {
    // past the groups: rows [total, M) are zeros, as ragged_dot gives
    const int r0 = total + (t - n_tiles) * BM;
    if (r0 >= M) return;
    const int r1 = min(r0 + BM, M);
    for (int i = tid; i < (r1 - r0) * BN; i += NT) {
      const int r = r0 + i / BN, n = n0 + i % BN;
      if (n < Nout) out[static_cast<size_t>(r) * Nout + n] = 0.f;
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
  const int r0 = s_roff[g] + (t - s_toff[g]) * BM;  // this CTA's rows [r0, r1)
  const int r1 = min(s_roff[g + 1], r0 + BM);
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
      for (int nj = 0; nj < 2; ++nj)  // [k][n] rows: matrices (k 0-7|8-15) x (n 0-7|8-15), transposed
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

// ---------------------------------------------------------------- the wgmma design

constexpr int WM = 128;                     // output rows of a tile: two consumer warpgroups x 64
constexpr int WN = 128;                     // output columns of a tile: one m64n128k16 each
constexpr int WK = 64;                      // reduction per stage: 128-byte rows, the swizzle's span
constexpr int WSTAGES = 4;                  // TMA ring depth
constexpr int WTHREADS = 384;               // the producer warpgroup, then two consumer warpgroups
constexpr int BOX = 64 * WK;                // elements of a 64-row box (8 KB)
constexpr int STAGE_BYTES = 2 * WM * WK * 2;  // A and B of one stage: 32 KB
constexpr int EPI_LD = WN + 8;              // epilogue rows: fragment writes conflict-free

struct __align__(1024) WgSmem {
  bf16 a[WSTAGES][WM * WK];  // A: 128 rows x 64 (or two 64-row boxes), swizzled
  bf16 b[WSTAGES][WN * WK];  // B: 128 rows x 64, or two 64 x 64 boxes side by side
  float epi[2][64 * EPI_LD]; // each consumer warpgroup's tile half on its way out (f32 or bf16)
  uint64_t full[WSTAGES];    // TMA bytes landed
  uint64_t empty[WSTAGES];   // both consumer warpgroups done reading
  int roff[GMAX + 1];        // exclusive prefix sums of the group sizes, clipped at M
  int toff[GMAX + 1];        // ... and of their 128-row tiles
};
constexpr int WG_SMEM = static_cast<int>(sizeof(WgSmem)) + 1024;  // + the base's alignment

__device__ __forceinline__ WgSmem& wg_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  return *reinterpret_cast<WgSmem*>(smem_raw + pad);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The 128 threads of consumer warpgroup wg (barriers 1 and 2; 0 is the block's).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A consumer warpgroup's 64 x 128 accumulator tile to `out` (row stride
// ld), its rows [0, rows) and columns [0, cols) only (cols a multiple of
// 8), through shared memory: the fragments go to `stage` in rows of
// EPI_LD, then each thread stores whole 16-byte chunks of a row, a warp
// one or two rows of consecutive columns at a time.
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[64], OutT* stage, OutT* out,
                                           size_t ld, int rows, int cols, int wg) {
  const int t128 = threadIdx.x & 127, lane = t128 & 31;
  const int r = (t128 >> 5) * 16 + (lane >> 2);
  wg_sync(wg);  // every thread is done reading the previous tile's stage
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    store_pair(stage + r * EPI_LD + c, acc[4 * j], acc[4 * j + 1]);
    store_pair(stage + (r + 8) * EPI_LD + c, acc[4 * j + 2], acc[4 * j + 3]);
  }
  wg_sync(wg);
  constexpr int CH = 16 / sizeof(OutT), PER_ROW = WN / CH;  // elements, chunks of a row
#pragma unroll 4
  for (int i = t128; i < 64 * PER_ROW; i += 128) {
    const int row = i / PER_ROW, col = (i % PER_ROW) * CH;
    if (row < rows && col < cols)
      *reinterpret_cast<uint4*>(out + row * ld + col) =
          *reinterpret_cast<const uint4*>(stage + row * EPI_LD + col);
  }
}

// The prefix sums (warp 0) and the barriers (thread 32), then the block
// synchronises once; after it the roles never meet again.
__device__ __forceinline__ void wg_setup(WgSmem& sm, const int* group_sizes, int G, int M,
                                         int tid) {
  if (tid < 32) group_prefix<WM>(group_sizes, G, M, sm.roff, sm.toff, tid);
  if (tid == 32) {
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&sm.full[s], 1);   // the producer's arrive, with the stage's bytes
      mbar_init(&sm.empty[s], 2);  // one arrive from each consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// Tile t of the row-grouped products: expert g (largest with toff[g] <=
// t / n_col, a non-empty group), then its column panel, then its row tile.
struct RowTile {
  int g, r0, r1, n0;
};

__device__ __forceinline__ RowTile row_tile(const WgSmem& sm, int t, int n_col, int G) {
  const int q = t / n_col;
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (sm.toff[mid] <= q) lo = mid;
    else hi = mid - 1;
  }
  const int nt = sm.toff[lo + 1] - sm.toff[lo], local = t - sm.toff[lo] * n_col;
  const int r0 = sm.roff[lo] + (local % nt) * WM;
  return {lo, r0, min(sm.roff[lo + 1], r0 + WM), (local / nt) * WN};
}

// The forward (kDx false): a = x (M, R = K), w (G, R, Nout) [k][n] through
// a 3-D map with 64 x 64 x 1 boxes, out (M, Nout) f32. dX (kDx true): a = dy
// (M, R = N), w (G, Nout = K, R) through a 3-D map with 64 x 128 x 1 boxes
// (rows of w_g, K-major), out (M, Nout) bf16. a's map has 64 x 128 boxes.
template <bool kDx, typename OutT>
__global__ void __launch_bounds__(WTHREADS, 1)
grouped_gemm_wg_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w,
                       const int* __restrict__ group_sizes, OutT* __restrict__ out, int M, int R,
                       int Nout, int G) {
  WgSmem& sm = wg_smem();
  const int tid = threadIdx.x, warp = tid >> 5;
  wg_setup(sm, group_sizes, G, M, tid);
  const int n_col = (Nout + WN - 1) / WN, nk = (R + WK - 1) / WK;
  const int n_tiles = sm.toff[G] * n_col;

  if (warp < 4) {  // the producer warpgroup: one thread issues every load
    regs_dec<40>();
    if (tid == 0) {
      Ring<WSTAGES> ring;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const RowTile tl = row_tile(sm, t, n_col, G);
        for (int kt = 0; kt < nk; ++kt, ring.next()) {
          mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
          uint64_t* full = &sm.full[ring.stage];
          mbar_expect_tx(full, STAGE_BYTES);
          tma_load(sm.a[ring.stage], &map_a, full, kt * WK, tl.r0);
          if constexpr (kDx) {
            tma_load(sm.b[ring.stage], &map_w, full, kt * WK, tl.n0, tl.g);
          } else {
            tma_load(sm.b[ring.stage], &map_w, full, tl.n0, kt * WK, tl.g);
            tma_load(sm.b[ring.stage] + BOX, &map_w, full, tl.n0 + 64, kt * WK, tl.g);
          }
        }
      }
    }
  } else {  // two consumer warpgroups: rows 64·wg.. of each tile
    regs_inc<232>();
    const int wg = (warp >> 2) - 1, t128 = tid & 127;
    Ring<WSTAGES> ring;
    float acc[64];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const RowTile tl = row_tile(sm, t, n_col, G);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      fence_acc(acc);
      int held = -1;  // the stage the products in flight read
      for (int kt = 0; kt < nk; ++kt, ring.next()) {
        mbar_wait(&sm.full[ring.stage], ring.phase);
        const uint32_t a0 = smem_addr(sm.a[ring.stage]) + wg * (64 * 128);
        const uint32_t b0 = smem_addr(sm.b[ring.stage]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < WK / 16; ++ks) {  // 16 columns = 32 bytes of each K-major row
          const uint64_t da = gmma_desc(a0 + ks * 32, 16, SW_ROWS);
          if constexpr (kDx) {
            wgmma_m64n128<0, 0>(acc, da, gmma_desc(b0 + ks * 32, 16, SW_ROWS));
          } else {  // [k][n]: 16 rows of k a step; the second 64 columns one box on
            wgmma_m64n128<0, 1>(acc, da, gmma_desc(b0 + ks * 16 * 128, BOX * 2, SW_ROWS));
          }
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (held >= 0 && t128 == 0) mbar_arrive(&sm.empty[held]);
        held = ring.stage;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (held >= 0 && t128 == 0) mbar_arrive(&sm.empty[held]);
      // rows past the group's end (the next expert's, or past M) are not stored
      const int row0 = tl.r0 + wg * 64;
      store_tile(acc, reinterpret_cast<OutT*>(sm.epi[wg]),
                 out + static_cast<size_t>(row0) * Nout + tl.n0, Nout, tl.r1 - row0,
                 Nout - tl.n0, wg);
    }
    // rows [Σ sizes, M) are zeros, as ragged_dot gives
    const size_t total = static_cast<size_t>(sm.roff[G]) * Nout;
    const size_t end = static_cast<size_t>(M) * Nout;
    for (size_t i = total + static_cast<size_t>(blockIdx.x) * 256 + (tid - 128); i < end;
         i += static_cast<size_t>(gridDim.x) * 256)
      out[i] = OutT(0.f);
  }
}

// dW_g = x_gᵀ dy_g: the tiles are (expert, 128-row K tile, 128-column N
// tile), each summing over the expert's rows [off_g, off_g + size_g) in
// chunks of 64 from its first row; an expert without rows writes its
// tiles' zeros. x's and dy's maps have 64 x 64 boxes: a stage holds x's
// rows [r, r + 64) at columns k0.. and k0 + 64.. (one box per consumer
// warpgroup, its A, M-major) and dy's at n0.. and n0 + 64.. (B, N-major).
__global__ void __launch_bounds__(WTHREADS, 1)
grouped_gemm_tgmm_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_dy,
                         const int* __restrict__ group_sizes, bf16* __restrict__ dw, int M, int K,
                         int N, int G) {
  WgSmem& sm = wg_smem();
  const int tid = threadIdx.x, warp = tid >> 5;
  wg_setup(sm, group_sizes, G, M, tid);
  const int n_nt = (N + WN - 1) / WN, per_g = ((K + WM - 1) / WM) * n_nt;
  const int n_tiles = G * per_g;

  if (warp < 4) {
    regs_dec<40>();
    if (tid == 0) {
      Ring<WSTAGES> ring;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int g = t / per_g, rem = t % per_g;
        const int k0 = (rem / n_nt) * WM, n0 = (rem % n_nt) * WN;
        const int r0 = sm.roff[g], nk = (sm.roff[g + 1] - r0 + WK - 1) / WK;
        for (int c = 0; c < nk; ++c, ring.next()) {
          mbar_wait(&sm.empty[ring.stage], ring.phase ^ 1);
          uint64_t* full = &sm.full[ring.stage];
          mbar_expect_tx(full, STAGE_BYTES);
          const int r = r0 + c * WK;
          tma_load(sm.a[ring.stage], &map_x, full, k0, r);
          tma_load(sm.a[ring.stage] + BOX, &map_x, full, k0 + 64, r);
          tma_load(sm.b[ring.stage], &map_dy, full, n0, r);
          tma_load(sm.b[ring.stage] + BOX, &map_dy, full, n0 + 64, r);
        }
      }
    }
  } else {
    regs_inc<232>();
    const int wg = (warp >> 2) - 1, t128 = tid & 127;
    Ring<WSTAGES> ring;
    float acc[64];
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int g = t / per_g, rem = t % per_g;
      const int k0 = (rem / n_nt) * WM, n0 = (rem % n_nt) * WN;
      const int rows = sm.roff[g + 1] - sm.roff[g], nk = (rows + WK - 1) / WK;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      fence_acc(acc);
      int held = -1;
      for (int c = 0; c < nk; ++c, ring.next()) {
        mbar_wait(&sm.full[ring.stage], ring.phase);
        bf16* xa = sm.a[ring.stage] + wg * BOX;  // this warpgroup's x box: its A
        const int valid = rows - c * WK;
        if (valid < WK) {
          // the last chunk runs past the expert's end into the next
          // expert's rows: they count as zeros (x's rows past M are zeros
          // already). Whole 128-byte rows, so the swizzle does not matter.
          uint4* p = reinterpret_cast<uint4*>(xa + valid * 64);
          for (int i = t128; i < (WK - valid) * 8; i += 128) p[i] = make_uint4(0u, 0u, 0u, 0u);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          wg_sync(wg);
        }
        const uint32_t a0 = smem_addr(xa), b0 = smem_addr(sm.b[ring.stage]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < WK / 16; ++ks)  // 16 rows of the reduction a step
          wgmma_m64n128<1, 1>(acc, gmma_desc(a0 + ks * 16 * 128, BOX * 2, SW_ROWS),
                              gmma_desc(b0 + ks * 16 * 128, BOX * 2, SW_ROWS));
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0 && t128 == 0) mbar_arrive(&sm.empty[held]);
        held = ring.stage;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (held >= 0 && t128 == 0) mbar_arrive(&sm.empty[held]);
      const int row0 = k0 + wg * 64;
      store_tile(acc, reinterpret_cast<bf16*>(sm.epi[wg]),
                 dw + (static_cast<size_t>(g) * K + row0) * N + n0, N, K - row0, N - n0, wg);
    }
  }
}

// ---------------------------------------------------------------- host side

// One persistent CTA per SM, no more than there are tiles at most.
int wg_grid(long long max_tiles) {
  const int sms = sm_count();
  return static_cast<int>(std::max(1LL, std::min(static_cast<long long>(sms), max_tiles)));
}

// The forward (kDx false: a = x (M, R), w (G, R, Nout)) or dX (kDx true: a
// = dy (M, R), w (G, Nout, R)) on the wgmma kernel; R and Nout multiples
// of 8, a and w 16-byte aligned (TMA's rules).
template <bool kDx, typename OutT>
int launch_wg(const void* a, const void* w, const void* group_sizes, void* out, int M, int R,
              int Nout, int G, cudaStream_t stream) {
  if (R % 8 != 0 || Nout % 8 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_w;
  const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(R), static_cast<cuuint64_t>(M)};
  const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(R) * 2};
  const cuuint32_t a_box[2] = {WK, WM};
  // fwd: w_g is [k = R][n = Nout], boxes of 64 columns x 64 rows of k; dX:
  // w_g is [k = Nout][n = R], boxes of 64 columns of n x 128 rows of k
  const cuuint64_t inner = kDx ? R : Nout, outer = kDx ? Nout : R;
  const cuuint64_t w_dims[3] = {inner, outer, static_cast<cuuint64_t>(G)};
  const cuuint64_t w_strides[2] = {inner * 2, inner * outer * 2};
  const cuuint32_t w_box[3] = {64, kDx ? static_cast<cuuint32_t>(WN) : static_cast<cuuint32_t>(WK), 1};
  cudaError_t err = make_map(&map_a, a, 2, a_dims, a_strides, a_box);
  if (err == cudaSuccess) err = make_map(&map_w, w, 3, w_dims, w_strides, w_box);
  static bool opted[lapha::kMaxDevices] = {};
  auto kernel = grouped_gemm_wg_kernel<kDx, OutT>;
  if (err == cudaSuccess) err = lapha::smem_opt_in(kernel, WG_SMEM, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long max_tiles =
      (static_cast<long long>((M + WM - 1) / WM) + G) * ((Nout + WN - 1) / WN);
  kernel<<<wg_grid(max_tiles), WTHREADS, WG_SMEM, stream>>>(
      map_a, map_w, static_cast<const int*>(group_sizes), static_cast<OutT*>(out), M, R, Nout, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward: x (M, K) bf16, w (G, K, N) bf16 -> out (M, N) f32; K a
// multiple of 8. `wide` picks the wgmma kernel (N a multiple of 8, x and w
// 16-byte aligned, else an error), 0 the 64-row mma.sync kernel.
extern "C" int lapha_grouped_gemm(const void* x, const void* w, const void* group_sizes, void* out,
                                  int M, int K, int N, int G, int wide, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > GMAX || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) return launch_wg<false, float>(x, w, group_sizes, out, M, K, N, G, s);
  const int vec_b = (N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) ? 1 : 0;
  const dim3 grid((M + BM - 1) / BM + G + 1, (N + BN - 1) / BN);
  grouped_gemm_kernel<<<grid, NT, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(group_sizes), static_cast<float*>(out), M, K, N, G, vec_b);
  return static_cast<int>(cudaGetLastError());
}

// dX (M, K) bf16 from dy (M, N) bf16 and w (G, K, N) on the wgmma kernel;
// K and N multiples of 8, dy and w 16-byte aligned.
extern "C" int lapha_grouped_gemm_dx(const void* dy, const void* w, const void* group_sizes,
                                     void* dx, int M, int K, int N, int G, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > GMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wg<true, bf16>(dy, w, group_sizes, dx, M, N, K, G,
                               static_cast<cudaStream_t>(stream));
}

// dW (G, K, N) bf16 from x (M, K) and dy (M, N), both bf16 and 16-byte
// aligned; K and N multiples of 8.
extern "C" int lapha_grouped_gemm_tgmm(const void* x, const void* dy, const void* group_sizes,
                                       void* dw, int M, int K, int N, int G, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > GMAX || K % 8 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(dy) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_dy;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t dy_strides[1] = {static_cast<cuuint64_t>(N) * 2};
  const cuuint32_t box[2] = {64, WK};
  cudaError_t err = make_map(&map_x, x, 2, x_dims, x_strides, box);
  if (err == cudaSuccess) err = make_map(&map_dy, dy, 2, dy_dims, dy_strides, box);
  static bool opted[lapha::kMaxDevices] = {};
  if (err == cudaSuccess) err = lapha::smem_opt_in(grouped_gemm_tgmm_kernel, WG_SMEM, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long max_tiles =
      static_cast<long long>(G) * ((K + WM - 1) / WM) * ((N + WN - 1) / WN);
  grouped_gemm_tgmm_kernel<<<wg_grid(max_tiles), WTHREADS, WG_SMEM,
                             static_cast<cudaStream_t>(stream)>>>(
      map_x, map_dy, static_cast<const int*>(group_sizes), static_cast<bf16*>(dw), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}
