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
// the bound is ~51 experts x 5.8 MB at 3.35 TB/s, 0.088 ms. At prefill (M =
// 8192) all 60 experts (346 MB) are read for ~137 rows each: 2·M·K·N = 47
// GFLOP is 0.05 ms at 989 TFLOP/s, under the 0.10 ms of the weight stream.
// In training (M = 32768 pair rows, ~546 an expert) each of the three
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
// 2. The decode forward (a few rows an expert, where only the weight stream
//    counts; also N % 8 != 0 or weights not 16-byte aligned, at any M). Its
//    bound is bytes: a touched expert's weights are read once for 1-8 rows,
//    so the design streams them evenly over the card with enough of the
//    stream in flight; the products are nearly free.
//    - Operands swapped: it computes out_gᵀ = w_gᵀ · x_gᵀ with mma.sync
//      m16n8k16, the expert's output columns on M (A fragments by
//      ldmatrix.trans of the [k][n] weight box) and its rows on n8 (B
//      fragments by ldmatrix of the x box [r][k]). 1-8 rows cost one n8
//      product, 9-16 two; an expert with more rows takes more passes of 16
//      rows, each rereading the panel (from L2: a panel's passes are
//      neighbouring items).
//    - Items are (expert, pass, 128-column panel), ordered expert by expert,
//      only the touched experts' (the prefix sums, built by warp 0 of every
//      CTA from the device's group sizes). The grid is persistent, DCTAS
//      CTAs an SM at most (the host's plan, from the shapes); CTA b takes
//      items b, b + gridDim.x, ..., each over the whole in-dim.
//    - A producer warp keeps a DSTAGES-deep ring full: its lane 0 loads each
//      stage (64 k rows x 128 columns of the weights from a 3-D map, two 64
//      x 64 boxes, and the pass's 16 x rows x 64 k) with TMA in the 128-byte
//      swizzle (where TMA cannot read the weights, its 32 lanes load them
//      with element loads into the same layout), on full/empty mbarriers,
//      across item boundaries. Four
//      consumer warps each multiply a quarter of the panel's columns: every
//      fragment of a stage is loaded first (ldmatrix addresses XOR the
//      swizzle; conflict-free), the stage released, then the products
//      issued, so their latencies overlap. After an item's last stage each
//      thread stores its f32 accumulators straight to `out`, masked at the
//      group's end and at N.
//    - bench_k8.py --sweep reads the constants: 128-column panels, 3 stages
//      and 3 CTAs an SM, with no split of the in-dim (a split over a
//      thread-block cluster, merged through distributed shared memory, lost
//      at every decode row it was timed at; PERF.md's K8 finding).
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

// Tile t of the row-grouped products, TILE rows and TN columns: expert g
// (the largest with toff[g] <= t / n_col, a non-empty group), then its
// column panel, then its row tile.
struct Tile {
  int g, r0, r1, n0;
};

template <int TILE, int TN>
__device__ __forceinline__ Tile tile_of(const int* roff, const int* toff, int t, int n_col, int G) {
  const int q = t / n_col;
  int lo = 0, hi = G - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (toff[mid] <= q) lo = mid;
    else hi = mid - 1;
  }
  const int nt = toff[lo + 1] - toff[lo], local = t - toff[lo] * n_col;
  const int r0 = roff[lo] + (local % nt) * TILE;
  return {lo, r0, min(roff[lo + 1], r0 + TILE), (local / nt) * TN};
}

// ---------------------------------------------------------------- the decode forward

constexpr int DT = 160;          // threads: 4 consumer warps, then the producer warp
constexpr int DXR = 16;          // rows of a pass: two n8 blocks
constexpr int DCK = 64;          // k rows of a stage: 128-byte rows of x, 64-column boxes of w
constexpr int DPW = 128;         // columns of a panel: two 64-column weight boxes
constexpr int DSTAGES = 3;       // the ring's depth: 2 stages of 16 KB of weights in flight
constexpr int DCTAS = 3;         // CTAs an SM (ops/grouped_gemm.DECODE_CTAS_PER_SM)
constexpr int DBOX = DCK * 128;  // bytes of a 64 x 64 weight box
constexpr int DSTAGE = (DPW / 64) * DBOX + DXR * 128;

// A decode CTA's shared memory, from a 1024-byte aligned base: the ring (a
// stage is DPW/64 weight boxes [k][64 n] and the pass's x box [16 r][64 k],
// all 128-byte rows in TMA's 128-byte swizzle), the ring's full and empty
// barriers, the prefix sums.
__host__ __device__ constexpr int dec_smem(int G) {
  return 1024 + DSTAGES * DSTAGE + 16 * DSTAGES + 8 * (G + 1);
}
static_assert(DCTAS * (dec_smem(GMAX) + 1024) <= 228 * 1024,
              "DCTAS decode CTAs an SM at any G (an SM's 228 KB, 1 KB a CTA reserved)");

// Byte offset of 16-byte chunk `ch` of 128-byte row `row` in a box written
// with TMA's 128-byte swizzle (the box 1024-byte aligned).
__device__ __forceinline__ int swz(int row, int ch) { return row * 128 + ((ch ^ (row & 7)) << 4); }

// x (M, K), w (G, K, N) [k][n], out (M, N) f32; a persistent grid, CTA b
// taking items b, b + gridDim.x, ... kTma: the producer's lane 0 loads the
// weights and x through the tensor maps (3-D w (G, K, N), 64 x 64 boxes;
// 2-D x (M, K), 64 x 16 boxes); else (rows of w not 16-byte aligned) its 32
// lanes load each stage with element loads into the same swizzled layout.
template <bool kTma>
__global__ void __launch_bounds__(DT, DCTAS)
grouped_gemm_decode_kernel(const __grid_constant__ CUtensorMap map_w,
                           const __grid_constant__ CUtensorMap map_x, const bf16* __restrict__ x,
                           const bf16* __restrict__ w, const int* __restrict__ group_sizes,
                           float* __restrict__ out, int M, int K, int N, int G) {
  constexpr int NB = DPW / 64, WC = DPW / 4, MF = WC / 16;  // boxes a stage; a warp's columns, fragments
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DSTAGES * DSTAGE);
  uint64_t* empty = full + DSTAGES;
  int* roff = reinterpret_cast<int*>(empty + DSTAGES);
  int* toff = roff + G + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (warp == 0) group_prefix<DXR>(group_sizes, G, M, roff, toff, lane);
  if (tid == 32) {
    for (int s = 0; s < DSTAGES; ++s) {
      mbar_init(&full[s], kTma ? 1 : 32);  // the producer's arrivals (with the bytes, for TMA)
      mbar_init(&empty[s], 4);              // one arrive from each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_col = (N + DPW - 1) / DPW, n_items = toff[G] * n_col;
  const int nch = (K + DCK - 1) / DCK;  // stages an item
  const int cid = blockIdx.x, ncl = gridDim.x;
  const int nsteps = (cid < n_items ? (n_items - 1 - cid) / ncl + 1 : 0) * nch;
  // step s of this CTA: its (s / nch)-th item, stage s % nch of the in-dim

  if (warp == 4) {  // ---------------- the producer: the ring, DSTAGES - 1 steps ahead
    Tile lt{};
    int lj = -1;
    for (int step = 0; step < nsteps; ++step) {
      const int slot = step % DSTAGES, j = step / nch, k0 = (step - j * nch) * DCK;
      if (step >= DSTAGES) mbar_wait(&empty[slot], ((step / DSTAGES) - 1) & 1);
      if (j != lj) {
        lt = tile_of<DXR, DPW>(roff, toff, cid + j * ncl, n_col, G);
        lj = j;
      }
      uint8_t* st = smem + slot * DSTAGE;
      if constexpr (kTma) {
        if (lane == 0) {
          mbar_expect_tx(&full[slot], DSTAGE);
#pragma unroll
          for (int b = 0; b < NB; ++b)
            tma_load(st + b * DBOX, &map_w, &full[slot], lt.n0 + 64 * b, k0, lt.g);
          tma_load(st + NB * DBOX, &map_x, &full[slot], k0, lt.r0);
        }
      } else {
        const bf16* wg = w + static_cast<size_t>(lt.g) * K * N;
        for (int i = lane; i < DCK * (DPW / 8); i += 32) {
          const int r = i / (DPW / 8), n = (i % (DPW / 8)) * 8, k = k0 + r;
          __align__(16) bf16 v[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = (k < K && lt.n0 + n + e < N) ? wg[static_cast<size_t>(k) * N + lt.n0 + n + e]
                                                : __float2bfloat16(0.f);
          *reinterpret_cast<uint4*>(st + (n / 64) * DBOX + swz(r, (n % 64) / 8)) =
              *reinterpret_cast<const uint4*>(v);
        }
        for (int i = lane; i < DXR * (DCK / 8); i += 32) {
          const int r = i / (DCK / 8), ch = i % (DCK / 8), k = k0 + 8 * ch;
          const bool ok = lt.r0 + r < M && k < K;  // K % 8 == 0: a chunk is whole or out
          *reinterpret_cast<uint4*>(st + NB * DBOX + swz(r, ch)) =
              ok ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(lt.r0 + r) * K + k)
                 : make_uint4(0u, 0u, 0u, 0u);
        }
        mbar_arrive(&full[slot]);
      }
    }
  } else {  // ---------------- 4 consumer warps: warp w the panel's columns [w·WC, (w+1)·WC)
    float acc[MF][2][4];
#pragma unroll
    for (int f = 0; f < MF; ++f)
#pragma unroll
      for (int b = 0; b < 2; ++b) acc[f][b][0] = acc[f][b][1] = acc[f][b][2] = acc[f][b][3] = 0.f;
    Tile ct{};
    int cj = -1;
    const int xr = 8 * (lane >> 4) + (lane & 7), hi = (lane >> 3) & 1;
    for (int step = 0; step < nsteps; ++step) {
      const int slot = step % DSTAGES, j = step / nch, c = step - j * nch;
      if (j != cj) {
        ct = tile_of<DXR, DPW>(roff, toff, cid + j * ncl, n_col, G);
        cj = j;
      }
      const int kr = min(DCK, K - c * DCK);  // the in-dim's rows in this stage
      const bool two = ct.r1 - ct.r0 > 8;    // warp-uniform: a second n8 block of rows
      mbar_wait(&full[slot], (step / DSTAGES) & 1);
      const uint8_t* st = smem + slot * DSTAGE;
      // every fragment first, then the products: the loads' latencies overlap
      uint32_t b[4][4];      // per k16 step: x rows 0-7 (k 0-7 | 8-15), rows 8-15 (...)
      uint32_t a[4][MF][4];  // per k16 step and fragment: [k][n] transposed, an A fragment
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (16 * ks >= kr) break;
        ldsm_x4(b[ks], st + NB * DBOX + swz(xr, 2 * ks + hi));
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          const int col = warp * WC + 16 * f;
          ldsm_x4_t(a[ks][f], st + (col / 64) * DBOX +
                                  swz(16 * ks + (lane & 7) + 8 * (lane >> 4), (col % 64) / 8 + hi));
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);  // the fragments are in registers
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (16 * ks >= kr) break;
#pragma unroll
        for (int f = 0; f < MF; ++f) {
          mma_bf16_16816(acc[f][0], a[ks][f], b[ks][0], b[ks][1]);
          if (two) mma_bf16_16816(acc[f][1], a[ks][f], b[ks][2], b[ks][3]);
        }
      }

      if (c == nch - 1) {  // the item is done: its rows and columns from the registers
        // lane 4g + t4 holds columns (g, g + 8) of each fragment, rows 2t4, 2t4 + 1
        const int rows = ct.r1 - ct.r0;
#pragma unroll
        for (int f = 0; f < MF; ++f)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = ct.n0 + warp * WC + 16 * f + (lane >> 2) + 8 * h;
#pragma unroll
            for (int bb = 0; bb < 2; ++bb)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = 8 * bb + 2 * (lane & 3) + e;
                if (r < rows && n < N) out[static_cast<size_t>(ct.r0 + r) * N + n] = acc[f][bb][2 * h + e];
                acc[f][bb][2 * h + e] = 0.f;
              }
          }
      }
    }

    // rows [Σ sizes, M) are zeros, as ragged_dot gives
    const size_t total = static_cast<size_t>(roff[G]) * N, end = static_cast<size_t>(M) * N;
    for (size_t i = total + static_cast<size_t>(blockIdx.x) * 128 + tid; i < end;
         i += static_cast<size_t>(gridDim.x) * 128)
      out[i] = 0.f;
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
        const Tile tl = tile_of<WM, WN>(sm.roff, sm.toff, t, n_col, G);
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
      const Tile tl = tile_of<WM, WN>(sm.roff, sm.toff, t, n_col, G);
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

// The decode forward: `grid` CTAs, at most DCTAS an SM (the host's plan).
// TMA reads the weights where their rows are 16-byte aligned.
template <bool kTma>
int launch_decode(const void* x, const void* w, const void* group_sizes, void* out, int M, int K,
                  int N, int G, int grid, cudaStream_t stream) {
  CUtensorMap map_w = {}, map_x = {};
  cudaError_t err = cudaSuccess;
  if constexpr (kTma) {
    const cuuint64_t w_dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                                  static_cast<cuuint64_t>(G)};
    const cuuint64_t w_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                     static_cast<cuuint64_t>(N) * K * 2};
    const cuuint32_t w_box[3] = {64, DCK, 1};
    const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(M)};
    const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t x_box[2] = {DCK, DXR};
    err = make_map(&map_w, w, 3, w_dims, w_strides, w_box);
    if (err == cudaSuccess) err = make_map(&map_x, x, 2, x_dims, x_strides, x_box);
  }
  static bool opted[lapha::kMaxDevices] = {};
  const auto kernel = grouped_gemm_decode_kernel<kTma>;
  if (err == cudaSuccess) err = lapha::smem_opt_in(kernel, dec_smem(GMAX), opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, DT, dec_smem(G), stream>>>(map_w, map_x, static_cast<const bf16*>(x),
                                            static_cast<const bf16*>(w),
                                            static_cast<const int*>(group_sizes),
                                            static_cast<float*>(out), M, K, N, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The forward: x (M, K) bf16, w (G, K, N) bf16 -> out (M, N) f32; K a
// multiple of 8. `wide` picks the wgmma kernel (N a multiple of 8, x and w
// 16-byte aligned, else an error; `grid` is not read), 0 the decode kernel
// on `grid` CTAs (the host's plan, at least 1).
extern "C" int lapha_grouped_gemm(const void* x, const void* w, const void* group_sizes, void* out,
                                  int M, int K, int N, int G, int wide, int grid, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || G > GMAX || K % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) return launch_wg<false, float>(x, w, group_sizes, out, M, K, N, G, s);
  if (grid < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA reads the weights where their rows are 16-byte aligned, else element loads
  if (N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
    return launch_decode<true>(x, w, group_sizes, out, M, K, N, G, grid, s);
  return launch_decode<false>(x, w, group_sizes, out, M, K, N, G, grid, s);
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
