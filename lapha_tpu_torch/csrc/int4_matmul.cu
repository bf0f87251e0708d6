// Packed-int4 dequant-matmul (W4A16) for Hopper: out = x @ W, W stored as
// offset-binary nibbles u = v + 8 in split-half packing with one f32 scale
// per (in-dim group, output column).
//
// Replaces lapha_tpu/ops/int4_matmul.py _int4_mm_kernel_v3 :83 (the default,
// called from int4_matmul :145) and, for the same function, the version-2
// kernel _int4_mm_kernel :54. As v3 does, the nibbles go to the tensor cores
// and the scale folds into the f32 accumulator per group:
//
//   out[b, o] = Σ_g (Σ_{i in g} x[b, i]·(u[i, o] − 8)) · s[g, o]
//
// with x rounded to bf16 and every sum in f32 (v3 subtracts 8·rowsum(x_g)
// after the product; u − 8 is exact in bf16, so the two differ only in the
// order of f32 roundings).
//
// What bounds it on an H100: at decode row counts (B = 48) each packed byte
// feeds 2·B multiply-adds, far below the card's ~295 FLOP/byte ridge, so
// the bound is the weight stream, IN/2·OUT packed bytes + 4·IN/G·OUT bytes
// of scales, at 3.35 TB/s: 0.1-2.7 µs for Qwen2.5-1.5B's projections. At
// 512 rows (prefill, 1536 -> 8960) it is operations: 14.1 GFLOP.
//
// The design (chosen on the host: ops/int4_matmul.split_plan):
// - A CTA owns BN output columns (64, or 32 / 16 where OUT is short) and
//   16·MT rows of x (MT = 3 at B = 48: no padding rows; 1 where the tiles
//   would leave SMs idle), and a contiguous
//   range of group pairs: the in-dim is split across CTAs (grid.z) so that
//   the decode shapes fill the card. Group pair gi covers packed rows
//   [gi·G, gi·G + G): low nibbles for group gi, high ones for gi + IN/(2G);
//   a split covers whole pairs and uses both nibbles of every byte it
//   loads, so no packed byte is read twice.
// - Each pair's packed tile, its two x slices and its two scale rows move
//   through a cp.async ring of up to 3 stages (2 at MT = 4; no more than a
//   split has pairs, so that CTAs of one pair take less shared memory and
//   more of them fit an SM), so pair i + 1's bytes arrive while pair i is
//   multiplied.
// - The nibbles go from shared memory to mma B fragments in registers with
//   no unpack pass: ldmatrix.trans of the [k][n] byte tile gives lane 4g+t4
//   the bytes (k = 2t4, 2t4+1) x (n = 2g, 2g+1); a shift, a mask and an OR
//   with 0x4300 make bf16 128 + u of a k pair, and a bf16x2 subtraction of
//   136 makes u − 8 (exact). The even and odd columns of a 16-column span
//   are two m16n8 products, so a lane's accumulators cover 4 consecutive
//   columns and the store is one 16-byte vector a row.
// - The 4 warps split the columns (16 each) and, where BN < 64, the k-steps
//   of a pair too; warps of one column span are summed in shared memory in
//   warp order.
// - With more than one split (at most 8), a tile's splits are one thread-
//   block cluster: CTA r owns slice r of the tile, every CTA stores its
//   f32 partial of each slice into the owner's shared memory (distributed
//   shared memory, slot = its rank), and after one cluster barrier each
//   owner sums its slice over the slots in rank (= split) order 0, 1, ...
//   and writes it out. No workspace, no atomics: two launches on the same
//   inputs are bit-equal. (A first version summed f32 partials from a
//   global workspace in the last CTA to take an atomic ticket; that serial
//   tail cost 2.6 us of 6.8 at 48 x 1536 -> 256 and 9.1 of 22.7 at
//   48 x 8960 -> 1536. Clusters of 11, a non-portable size, read 26.6 us
//   at the down projection against 17.5 for 8.)

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace lapha;  // common.cuh's mma.sync, hopper.cuh's cp.async and ldmatrix
using bf16 = __nv_bfloat16;

constexpr int NT = 128;                    // threads per CTA
constexpr int GMAX = 128;                  // largest group the tiles hold
constexpr int MAX_SPLITS = 8;              // splits of a tile: one cluster of at most 8 CTAs
constexpr int SMEM_TWO_CTAS = 112 * 1024;  // dynamic shared memory that leaves room for two CTAs an SM

// Shared-memory layout of one ring stage for group size G: the packed
// [k][n] byte tile (rows padded so ldmatrix's 8 row reads hit distinct
// banks), the two x slices as rows [m][2G] (+8 elements), two scale rows.
template <int MT, int BN>
struct Stage {
  static constexpr int BM = 16 * MT;
  // the deepest ring (fewer stages where a split has fewer pairs): two CTAs
  // an SM fit either way
  static constexpr int NST = MT == 4 ? 2 : 3;
  static constexpr int LDB = BN == 16 ? 16 : BN + 16;
  static constexpr int WN = BN / 16, WK = 4 / WN;  // warps over the columns, over a pair's k-steps
  static constexpr int RED_BYTES = (WK - 1) * WN * MT * 8 * 32 * 4;  // the k-step warps' sums
  // the inbox of a cluster's partial sums, after the ring (peers store into
  // it while this CTA may still be reading its ring): splits x
  // ceil(chunks / splits) 16-byte slots
  __host__ __device__ static int inbox_at(int G, int nst) {
    return nst * bytes(G) > RED_BYTES ? nst * bytes(G) : RED_BYTES;
  }
  static int inbox_bytes(int splits) {
    return splits > 1 ? splits * ((BM * BN / 4 + splits - 1) / splits) * 16 : 0;
  }
  __host__ __device__ static constexpr int ldx(int G) { return 2 * G + 8; }
  __host__ __device__ static constexpr int w_bytes(int G) { return G * LDB; }
  __host__ __device__ static constexpr int x_bytes(int G) { return BM * ldx(G) * 2; }
  __host__ __device__ static constexpr int bytes(int G) { return w_bytes(G) + x_bytes(G) + 8 * BN; }
  static constexpr int SMEM_MAX = NST * (GMAX * LDB + BM * (2 * GMAX + 8) * 2 + 8 * BN) +
                                  MAX_SPLITS * (BM * BN / 4 / MAX_SPLITS + 1) * 16;
  static int smem(int G, int nst, int splits) { return inbox_at(G, nst) + inbox_bytes(splits); }
};

// Two bf16 (u − 8) of the nibbles at bit `sh` of bytes 0 and 2 of r.
__device__ __forceinline__ uint32_t nibbles(uint32_t r, int sh) {
  uint32_t t = ((r >> sh) & 0x000F000Fu) | 0x43004300u;  // bf16 128 + u, twice
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&t);
  v = __hsub2(v, __float2bfloat162_rn(136.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 16-byte store into rank r's shared memory at the address `a` has in
// this CTA's (hopper.cuh has the cluster's rank and barrier).
__device__ __forceinline__ void st_cluster4(uint32_t a, int r, float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(a), "r"(r));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// 4 consecutive f32 of an output row, `room` columns left before OUT; one
// 16-byte store where the row is vector-aligned (vec: OUT % 16 == 0)
__device__ __forceinline__ void store4(float* o, int room, int vec, float4 v) {
  if (room <= 0) return;
  if (vec) {
    *reinterpret_cast<float4*>(o) = v;
    return;
  }
  const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < room) o[j] = f[j];
}

template <int MT, int BN>
__global__ void __launch_bounds__(NT, 2)
int4_mm_kernel(const bf16* __restrict__ x,          // (B, IN)
               const uint8_t* __restrict__ packed,  // (IN/2, OUT)
               const float* __restrict__ scales,    // (IN/G, OUT)
               float* __restrict__ out,             // (B, OUT)
               int B, int IN, int OUT, int G, int nst, int vec) {
  using St = Stage<MT, BN>;
  constexpr int BM = St::BM, LDB = St::LDB, WN = St::WN, WK = St::WK;
  extern __shared__ __align__(16) uint8_t smem[];

  const int LDX = St::ldx(G), stage_bytes = St::bytes(G);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int splits = gridDim.z, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nh = IN / (2 * G);  // groups per packed half = group pairs
  const int p0 = split * nh / splits, np = (split + 1) * nh / splits - p0;

  auto sW = [&](int s) { return smem + s * stage_bytes; };
  auto sX = [&](int s) { return reinterpret_cast<bf16*>(smem + s * stage_bytes + St::w_bytes(G)); };
  auto sS = [&](int s) {
    return reinterpret_cast<float*>(smem + s * stage_bytes + St::w_bytes(G) + St::x_bytes(G));
  };

  // pair gi into stage s: packed rows gi·G.., x columns of groups gi and
  // gi + nh, their scale rows
  auto load = [&](int s, int gi) {
    uint8_t* w = sW(s);
    const uint8_t* src = packed + static_cast<size_t>(gi) * G * OUT;
    for (int i = tid; i < G * (BN / 16); i += NT) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16, n = n0 + c;
      uint8_t* dst = w + r * LDB + c;
      if (vec) {
        cp_async16(dst, n < OUT ? src + static_cast<size_t>(r) * OUT + n : src, n < OUT);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = n + j < OUT ? src[static_cast<size_t>(r) * OUT + n + j] : uint8_t{0};
      }
    }
    // x: a warp a row at a time, lane c its 16-byte chunk c of the row's two
    // slices (G / 4 <= 32 chunks: no division by the runtime G)
    if (lane < G / 4) {
      const int half = lane >= G / 8, col = (lane - half * (G / 8)) * 8;
      const bf16* gx = x + (gi + half * nh) * G + col;
      bf16* xs = sX(s) + half * G + col;
      for (int r = warp; r < BM; r += NT / 32) {
        const bool ok = m0 + r < B;
        cp_async16(xs + r * LDX, gx + static_cast<size_t>(ok ? m0 + r : 0) * IN, ok);
      }
    }
    float* ss = sS(s);
    for (int i = tid; i < 2 * (BN / 4); i += NT) {
      const int half = i / (BN / 4), c = (i % (BN / 4)) * 4, n = n0 + c;
      const float* row = scales + static_cast<size_t>(gi + half * nh) * OUT;
      if (vec) {
        cp_async16(ss + half * BN + c, n < OUT ? row + n : row, n < OUT);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) ss[half * BN + c + j] = n + j < OUT ? row[n + j] : 0.f;
      }
    }
  };

  const int wn = warp % WN, wk = warp / WN, c0 = wn * 16;
  float acc[MT][2][4];  // [m-tile][even | odd columns][fragment]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int p = 0; p < 2; ++p) acc[mt][p][0] = acc[mt][p][1] = acc[mt][p][2] = acc[mt][p][3] = 0.f;

  // a ring of nst stages (1..NST: no deeper than a split's pairs)
  for (int s = 0; s < nst - 1; ++s) {
    if (s < np) load(s, p0 + s);
    cp_async_commit();
  }
  for (int i = 0; i < np; ++i) {
    // pair i + nst - 1 into the stage pair i - 1 was read from
    if (i + nst - 1 < np) load((i + nst - 1) % nst, p0 + i + nst - 1);
    cp_async_commit();
    // pair i has landed (this thread's copies; nst - 1 younger groups may
    // still be in flight) ... and everyone's
    if (nst >= 3) {
      cp_async_wait<2>();
    } else if (nst == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int s = i % nst;
    const uint8_t* w = sW(s);
    const bf16* xs = sX(s);
    float gacc[2][MT][2][4];  // [half][m-tile][even | odd][fragment]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          gacc[h][mt][p][0] = gacc[h][mt][p][1] = gacc[h][mt][p][2] = gacc[h][mt][p][3] = 0.f;
    for (int ks = wk; ks < G / 16; ks += WK) {
      uint32_t r[2];  // k rows 0-7 and 8-15 of the step, columns c0..c0+15
      ldsm_x2_t(r, w + (ks * 16 + (lane & 15)) * LDB + c0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // low nibbles: group gi; high: gi + nh
        uint32_t b[2][2];            // [even | odd columns][k 0-7 | 8-15]
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          b[p][0] = nibbles(r[0], 4 * h + 8 * p);
          b[p][1] = nibbles(r[1], 4 * h + 8 * p);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t a[4];
          ldsm_x4(a, xs + (mt * 16 + (lane & 15)) * LDX + h * G + ks * 16 + 8 * (lane >> 4));
#pragma unroll
          for (int p = 0; p < 2; ++p) mma_bf16_16816(gacc[h][mt][p], a, b[p][0], b[p][1]);
        }
      }
    }
    // fold each group's scale: the lane's columns are c0 + 4t4 + {0, 1, 2, 3}
    // = (even d0, odd d0, even d1, odd d1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 sc = *reinterpret_cast<const float4*>(sS(s) + h * BN + c0 + 4 * t4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          acc[mt][0][e] += gacc[h][mt][0][e] * sc.x;
          acc[mt][0][e + 1] += gacc[h][mt][0][e + 1] * sc.z;
          acc[mt][1][e] += gacc[h][mt][1][e] * sc.y;
          acc[mt][1][e + 1] += gacc[h][mt][1][e + 1] * sc.w;
        }
      }
    }
    __syncthreads();  // stage s is read before it is loaded again
  }
  cp_async_wait<0>();

  // warps that split a span's k-steps: summed into warp wk = 0 in warp order
  if constexpr (WK > 1) {  // every stage has been read: the ring is scratch now
    float* red = reinterpret_cast<float*>(smem);
    if (wk > 0) {
      float* dst = red + ((wk - 1) * WN + wn) * (MT * 8 * 32) + lane;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[((mt * 2 + p) * 4 + e) * 32] = acc[mt][p][e];
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int k = 1; k < WK; ++k) {
        const float* src = red + ((k - 1) * WN + wn) * (MT * 8 * 32) + lane;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][p][e] += src[((mt * 2 + p) * 4 + e) * 32];
      }
    }
  }

  if (splits == 1) {  // the tile, rows < B, columns < OUT
    if (wk == 0) {
      const int n = n0 + c0 + 4 * t4;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = m0 + mt * 16 + g8 + 8 * hr;
          if (row < B)
            store4(out + static_cast<size_t>(row) * OUT + n, OUT - n, vec,
                   make_float4(acc[mt][0][2 * hr], acc[mt][1][2 * hr], acc[mt][0][2 * hr + 1],
                               acc[mt][1][2 * hr + 1]));
        }
    }
    return;
  }

  // the cluster (this tile's splits): CTA r owns slice r of the tile's
  // 16-byte chunks; every CTA stores its partial of each chunk into the
  // owner's inbox, slot [its rank], in the owner's shared memory. After one
  // cluster barrier each owner sums its slice over slots 0, 1, ... (split
  // order) from its own shared memory and writes it out.
  const int chunks = BM * BN / 4, slice = (chunks + splits - 1) / splits;
  const int rank = static_cast<int>(cluster_rank());
  const uint32_t inbox = smem_addr(smem + St::inbox_at(G, nst));
  if (wk == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int c = (mt * 16 + g8 + 8 * hr) * (BN / 4) + (c0 + 4 * t4) / 4;
        const int owner = ((c + 1) * splits - 1) / chunks;  // c in [owner·chunks/splits, ...)
        const int at = rank * slice + c - owner * chunks / splits;
        st_cluster4(inbox + 16 * at, owner,
                    make_float4(acc[mt][0][2 * hr], acc[mt][1][2 * hr], acc[mt][0][2 * hr + 1],
                                acc[mt][1][2 * hr + 1]));
      }
  }
  cluster_sync();
  const int c_lo = rank * chunks / splits, c_hi = (rank + 1) * chunks / splits;
  const float4* box = reinterpret_cast<const float4*>(smem + St::inbox_at(G, nst));
  for (int c = c_lo + tid; c < c_hi; c += NT) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) add4(sum, box[r * slice + c - c_lo]);
    const int row = c / (BN / 4), col = (c % (BN / 4)) * 4;
    if (m0 + row < B)
      store4(out + static_cast<size_t>(m0 + row) * OUT + n0 + col, OUT - n0 - col, vec, sum);
  }
}

template <int MT, int BN>
int launch(const void* x, const void* packed, const void* scales, void* out, int B, int IN,
           int OUT, int G, int splits, int vec, cudaStream_t stream) {
  using St = Stage<MT, BN>;
  static bool opted[lapha::kMaxDevices] = {};
  const auto kernel = int4_mm_kernel<MT, BN>;
  const cudaError_t err = lapha::smem_opt_in(kernel, St::SMEM_MAX, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a ring no deeper than the longest split's pairs (more CTAs an SM), and
  // shallow enough that two CTAs fit an SM beside their inboxes
  const int pairs = IN / (2 * G);
  int nst = std::min(St::NST, (pairs + splits - 1) / splits);
  while (nst > 1 && St::smem(G, nst, splits) > SMEM_TWO_CTAS) --nst;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((OUT + BN - 1) / BN, (B + St::BM - 1) / St::BM, splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = St::smem(G, nst, splits);
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;  // a tile's splits: one cluster
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<float*>(out), B, IN, OUT, G, nst, vec));
}

}  // namespace

// `rows` (16, 32, 48 or 64 rows of x a CTA), `bn` (16, 32 or 64 columns)
// and `splits` (1..min(8, IN/(2G)) ranges of group pairs, a tile's splits
// one thread-block cluster) come from the host's plan.
extern "C" int lapha_int4_matmul(const void* x, const void* packed, const void* scales, void* out,
                                 int B, int IN, int OUT, int G, int rows, int bn, int splits,
                                 void* stream) {
  if (B <= 0 || OUT <= 0 || G < 16 || G % 16 != 0 || G > GMAX || IN % (2 * G) != 0 ||
      splits < 1 || splits > MAX_SPLITS || splits > IN / (2 * G) || rows % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (OUT % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scales) % 16 == 0) ? 1 : 0;
  const int mt = rows / 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LAPHA_I4(MT, BN) \
  if (mt == MT && bn == BN) return launch<MT, BN>(x, packed, scales, out, B, IN, OUT, G, splits, vec, st);
#define LAPHA_I4_MT(MT) LAPHA_I4(MT, 16) LAPHA_I4(MT, 32) LAPHA_I4(MT, 64)
  LAPHA_I4_MT(1)
  LAPHA_I4_MT(2)
  LAPHA_I4_MT(3)
  LAPHA_I4_MT(4)
#undef LAPHA_I4_MT
#undef LAPHA_I4
  return static_cast<int>(cudaErrorInvalidValue);
}
