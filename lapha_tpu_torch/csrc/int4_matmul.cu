// Packed-int4 dequant-matmul (W4A16) for Hopper: out = x @ W, W stored as
// offset-binary nibbles u = v + 8 in split-half packing with one f32 scale
// per (in-dim group, output column).
//
// Replaces lapha_tpu/ops/int4_matmul.py _int4_mm_kernel_v3 :83 (the default,
// called from int4_matmul :145) and, for the same function, the version-2
// kernel _int4_mm_kernel :54. As v3 does, the raw nibbles go to the tensor
// cores and the offset and scale fold into the f32 accumulator per group:
//
//   out[b, o] = Σ_g (Σ_{i in g} x[b, i]·u[i, o] − 8·Σ_{i in g} x[b, i]) · s[g, o]
//
// with x rounded to bf16 and every sum in f32.
//
// What bounds it on an H100: at decode row counts (B = 48) each packed byte
// feeds 2·B multiply-adds, far below the card's ~295 FLOP/byte ridge, so
// the bound is the weight stream, IN/2·OUT packed bytes + 4·IN/G·OUT bytes
// of scales, at 3.35 TB/s. The design reads each packed byte and scale from
// device memory once: a CTA owns 64 output columns and 64 rows of x, walks
// the in-dim one group pair at a time (packed rows [gi·G, gi·G + G) hold
// group gi in the low nibbles and group gi + IN/(2G) in the high ones),
// keeps the packed tile in registers, and unpacks each half into a bf16
// tile in shared memory (nibbles 0..15 are exact in bf16). Products are
// mma.sync m16n8k16 bf16 with f32 accumulation; each warp owns 16 rows and
// all 64 columns. Simple first version: no cp.async/TMA pipelining, x is
// re-read from L2 by every column tile, and at B = 48 a quarter of the
// 64-row tile is padding; edges in B and OUT are masked in the kernel.

#include "common.cuh"

namespace {

using lapha::mma_bf16_16816;  // fragment layout: common.cuh
using lapha::ld_u32;

constexpr int BM = 64;           // rows of x per CTA (4 warps x 16)
constexpr int BN = 64;           // output columns per CTA
constexpr int GMAX = 128;        // largest group the tiles hold
constexpr int LDS = GMAX + 8;    // padded smem row (bf16): fragment loads are conflict-free
constexpr int NT = 128;          // threads per CTA
constexpr int ITEMS = 2;         // packed (row pair, 16-column chunk) items per thread: 2G / NT

// 16 packed bytes of one row at columns n..n+15; columns >= OUT read as 0.
__device__ __forceinline__ uint4 load16(const uint8_t* row, int n, int OUT, bool vec) {
  if (vec && n + 16 <= OUT) return *reinterpret_cast<const uint4*>(row + n);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n + j < OUT) w[j >> 2] |= static_cast<uint32_t>(row[n + j]) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(NT)
int4_mm_kernel(const __nv_bfloat16* __restrict__ x,  // (B, IN)
               const uint8_t* __restrict__ packed,   // (IN/2, OUT)
               const float* __restrict__ scales,     // (IN/G, OUT)
               float* __restrict__ out,              // (B, OUT)
               int B, int IN, int OUT, int G, int vec) {
  __shared__ __align__(16) __nv_bfloat16 sW[BN * LDS];  // one group's nibbles u, [n][k]
  __shared__ __align__(16) __nv_bfloat16 sX[BM * LDS];  // one group's x, [m][k]

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nh = IN / (2 * G);  // groups per packed half
  const bool warp_live = m0 + warp * 16 < B;

  float acc[BN / 8][4];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int gi = 0; gi < nh; ++gi) {
    // the packed tile of this group pair: rows gi·G .. gi·G + G, read once
    uint4 raw[ITEMS][2];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int item = tid + i * NT;
      raw[i][0] = raw[i][1] = make_uint4(0u, 0u, 0u, 0u);
      if (item < 2 * G) {
        const int kp = item / (BN / 16), nc = item % (BN / 16);
        const size_t k = static_cast<size_t>(gi) * G + 2 * kp;
        raw[i][0] = load16(packed + k * OUT, n0 + nc * 16, OUT, vec);
        raw[i][1] = load16(packed + (k + 1) * OUT, n0 + nc * 16, OUT, vec);
      }
    }

#pragma unroll
    for (int ph = 0; ph < 2; ++ph) {
      const int g = gi + ph * nh;  // in-dim group: x columns [g·G, g·G + G)
      const int shift = 4 * ph;    // low nibbles: first half of IN; high: second
      __syncthreads();             // the previous group's fragments have been read

      // nibbles -> bf16 pairs (k, k+1) at sW[n][k]
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int item = tid + i * NT;
        if (item < 2 * G) {
          const int kp = item / (BN / 16), nc = item % (BN / 16);
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int bit = 8 * (j & 3) + shift;
            const uint32_t u0 = (word(raw[i][0], j >> 2) >> bit) & 15u;
            const uint32_t u1 = (word(raw[i][1], j >> 2) >> bit) & 15u;
            *reinterpret_cast<uint32_t*>(sW + (nc * 16 + j) * LDS + 2 * kp) =
                lapha::pack_f32(static_cast<float>(u0), static_cast<float>(u1));
          }
        }
      }
      // x[m0 .. m0+BM, g·G .. g·G+G) with 16-byte loads; rows >= B are 0
      const int cpr = G / 8;
      for (int i = tid; i < BM * cpr; i += NT) {
        const int r = i / cpr, c = (i % cpr) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < B)
          v = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m0 + r) * IN + g * G + c);
        *reinterpret_cast<uint4*>(sX + r * LDS + c) = v;
      }
      __syncthreads();

      if (warp_live) {
        // rowsum(x_g) of the warp's 16 rows, two lanes per row
        const int rr = warp * 16 + (lane >> 1), hh = lane & 1;
        float rs = 0.f;
        for (int c = hh * (G / 2); c < (hh + 1) * (G / 2); c += 2) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(sX + rr * LDS + c));
          rs += f.x + f.y;
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        const float rs0 = __shfl_sync(0xffffffffu, rs, 2 * g8);        // row g8 of the warp
        const float rs1 = __shfl_sync(0xffffffffu, rs, 2 * (g8 + 8));  // row g8 + 8

        float gacc[BN / 8][4];
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
        const __nv_bfloat16* xa = sX + (warp * 16 + g8) * LDS + 2 * t4;
        for (int ks = 0; ks < G; ks += 16) {
          const uint32_t a[4] = {ld_u32(xa + ks), ld_u32(xa + 8 * LDS + ks),
                                 ld_u32(xa + ks + 8), ld_u32(xa + 8 * LDS + ks + 8)};
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const __nv_bfloat16* wb = sW + (j * 8 + g8) * LDS + ks + 2 * t4;
            mma_bf16_16816(gacc[j], a, ld_u32(wb), ld_u32(wb + 8));
          }
        }
        // fold the offset and the group scale into the accumulator
        const float* srow = scales + static_cast<size_t>(g) * OUT;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + j * 8 + 2 * t4;
          const float s0 = n < OUT ? __ldg(srow + n) : 0.f;
          const float s1 = n + 1 < OUT ? __ldg(srow + n + 1) : 0.f;
          acc[j][0] += (gacc[j][0] - 8.f * rs0) * s0;
          acc[j][1] += (gacc[j][1] - 8.f * rs0) * s1;
          acc[j][2] += (gacc[j][2] - 8.f * rs1) * s0;
          acc[j][3] += (gacc[j][3] - 8.f * rs1) * s1;
        }
      }
    }
  }

  if (!warp_live) return;
  const int r0 = m0 + warp * 16 + g8, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + j * 8 + 2 * t4;
    if (r0 < B) {
      if (n < OUT) out[static_cast<size_t>(r0) * OUT + n] = acc[j][0];
      if (n + 1 < OUT) out[static_cast<size_t>(r0) * OUT + n + 1] = acc[j][1];
    }
    if (r1 < B) {
      if (n < OUT) out[static_cast<size_t>(r1) * OUT + n] = acc[j][2];
      if (n + 1 < OUT) out[static_cast<size_t>(r1) * OUT + n + 1] = acc[j][3];
    }
  }
}

}  // namespace

extern "C" int lapha_int4_matmul(const void* x, const void* packed, const void* scales, void* out,
                                 int B, int IN, int OUT, int G, void* stream) {
  if (B <= 0 || OUT <= 0 || G <= 0 || G % 16 != 0 || G > GMAX || IN % (2 * G) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (OUT % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0) ? 1 : 0;
  const dim3 grid((OUT + BN - 1) / BN, (B + BM - 1) / BM);
  int4_mm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<float*>(out), B, IN, OUT, G, vec);
  return static_cast<int>(cudaGetLastError());
}
