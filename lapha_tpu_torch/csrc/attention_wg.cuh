// The wgmma attention kernels' shared pieces (flash_attention.cu: K1/K3;
// flash_attention_bwd.cu: K2). Tiles are 64-column TMA boxes of a (B, rows,
// heads, dh) bf16 tensor, read through 4-D tensor maps (dh, heads, rows, B)
// that stride over the heads, 128-byte swizzled; a head dim that is not a
// multiple of 64 (Phi-3's 96) is padded to whole boxes, TMA filling the
// columns past it with zeros. A tile of R rows is ceil(dh / 64) boxes of
// R·128 bytes. Here: the wgmma descriptors of such tiles, the logits
// product, the register A fragments of a 64-row probability tile, an RS
// product as wide as a padded head dim, the ring's barriers in dynamic
// shared memory, and the host's tensor maps.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace lapha {
namespace attn {

constexpr int THREADS = 256;  // two consumer warpgroups of 64 rows each

// bytes of an R-row box (64 bf16 columns of 128 bytes a row)
template <int R>
__host__ __device__ constexpr int box_bytes() {
  return R * 128;
}

// Boxes across a head dim of D.
__host__ __device__ constexpr int boxes(int D) { return (D + 63) / 64; }

// Descriptors of an R-row tile at shared address t: K-major at k16 step ks
// of the head dim (32 bytes a step inside a box, box_bytes<R> from one box
// to the next); MN-major at k16 step kk of its rows (16 rows of 128 bytes),
// the leading byte offset the box stride (64 columns further), the stride
// byte offset 1 KB between 8-row groups.
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t t, int ks) {
  return gmma_desc(t + (ks >> 2) * box_bytes<R>() + (ks & 3) * 32, 16, SW_ROWS);
}
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t t, int kk) {
  return gmma_desc(t + kk * 16 * 128, box_bytes<R>(), SW_ROWS);
}

// x (64 x N f32, N = 64 or 32) = A·Bᵀ over the head dim: A a 64-row tile, B
// an N-row tile, both K-major, KS k16 steps; issued, not waited for.
template <int KS, int N>
__device__ __forceinline__ void logits(float (&x)[N / 2], uint32_t a, uint32_t b) {
  static_assert(N == 64 || N == 32, "the logits tile is 64 x 64 or 64 x 32");
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if constexpr (N == 64)
      wgmma_m64n64<0, 0>(x, desc_k<64>(a, ks), desc_k<64>(b, ks), ks > 0);
    else
      wgmma_m64n32<0, 0>(x, desc_k<64>(a, ks), desc_k<32>(b, ks), ks > 0);
  }
}

// A fragments of the N/16 k16 steps over a 64 x N accumulator's columns,
// rounded to bf16: the accumulator's n-tile j is x[4j..4j+3], laid out as
// an mma.sync D fragment, so common.cuh's a_from_d applies.
template <int N>
__device__ __forceinline__ void a_frags(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
  const auto& tiles = reinterpret_cast<const float(&)[N / 8][4]>(x);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) a_from_d(a[kk], tiles[2 * kk], tiles[2 * kk + 1]);
}

// d (64 x DP f32, DP a multiple of 64) += A (64 x 16, registers) · B, B the
// k16 step kk of an R-row tile at t read MN-major, DP columns (DP / 64
// boxes) wide: an m64n128 product over each 128 columns and an m64n64 one
// over a last 64. The accumulator is laid out as one m64nDP accumulator:
// d[4j + e] is column 8j + 2(l%4) + (e & 1) of rows l/4 (+8 for e >= 2).
template <int DP, int R>
__device__ __forceinline__ void rs_wide(float (&d)[DP / 2], const uint32_t (&a)[4], uint32_t t,
                                        int kk) {
  static_assert(DP % 64 == 0, "whole boxes");
#pragma unroll
  for (int c = 0; c + 128 <= DP; c += 128)
    wgmma_m64n128_rs<1>(reinterpret_cast<float(&)[64]>(d[c / 2]), a,
                        desc_mn<R>(t + (c / 64) * box_bytes<R>(), kk));
  if constexpr (DP % 128 != 0)
    wgmma_m64n64_rs<1>(reinterpret_cast<float(&)[32]>(d[(DP - 64) / 2]), a,
                       desc_mn<R>(t + (DP / 64 - 1) * box_bytes<R>(), kk));
}

// An R-row tile's NB boxes (head-dim columns 0, 64, ...) from a 4-D map at
// (head, row, batch row), counted on `bar`.
template <int NB, int R>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row, int b) {
#pragma unroll
  for (int c = 0; c < NB; ++c) tma_load(dst + c * box_bytes<R>(), map, bar, c * 64, head, row, b);
}

// 2^x, the SFU's approximation (-1e30 and below give 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The ring's barriers: the resident tiles landed, a stage's bytes landed,
// both consumer warpgroups done with a stage.
template <int NST>
struct Bars {
  uint64_t res;
  uint64_t full[NST];
  uint64_t empty[NST];
};

// Dynamic shared memory of `tiles` bytes of tiles, then the barriers; the
// base aligned to 1024 bytes (the swizzle atom).
template <int NST>
constexpr int smem_bytes(int tiles) {
  return tiles + static_cast<int>(sizeof(Bars<NST>)) + 1024;
}

// The aligned base; `bars` after `tiles` bytes of it, initialised (res and
// full by one arrival and the TMA bytes, empty by one arrival of each
// consumer warpgroup) before the CTA's threads go on.
template <int NST>
__device__ __forceinline__ uint8_t* ring_smem(int tiles, Bars<NST>*& bars) {
  extern __shared__ uint8_t attn_raw[];
  uint8_t* base = attn_raw + ((1024u - (smem_addr(attn_raw) & 1023u)) & 1023u);
  bars = reinterpret_cast<Bars<NST>*>(base + tiles);
  if (threadIdx.x == 0) {
    mbar_init(&bars->res, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(&bars->full[s], 1);
      mbar_init(&bars->empty[s], 2);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return base;
}

// ---------------------------------------------------------------- host

// A 4-D map over a (B, rows, heads, dh) bf16 tensor: boxes of `box_rows`
// rows x 64 head-dim columns of one head and batch row.
inline cudaError_t head_map(CUtensorMap* map, const void* base, int B, int rows, int heads,
                            int dh, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(heads) * dh * 2,
                                 static_cast<cuuint64_t>(rows) * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  return make_map(map, base, 4, dims, strides, box);
}

}  // namespace attn
}  // namespace lapha
