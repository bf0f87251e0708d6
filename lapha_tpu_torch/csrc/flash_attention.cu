// Rectangular causal flash-attention forward for Hopper (sm_90a).
//
// Replaces two Pallas kernels of lapha_tpu/ops/flash_attention.py:
//   _flash_cached_kernel (:395, via flash_attention_cached :507) — every
//     engine prefill: T new queries over the whole (B, S) cache, query t of
//     row b at absolute position qstart[b] + t;
//   _flash_kernel (:46, via flash_attention :340) — the no-cache causal
//     forward of the value model, which is the same computation with S = T,
//     qstart = 0 and kv_valid = the key-padding mask.
// Semantics (both): key j is visible to query t of row b iff
// kv_valid[b, j] != 0 and j <= qstart[b] + t. A row with no visible key
// writes 0 and LSE = -1e30.
//
// What bounds it on an H100: at the prefill shapes (T=512, S=640, dh=128,
// 12 query heads over 2 KV heads) the work is ~2·T·S·dh·2 FLOP per head
// against ~(T+2S)·dh·2 bytes per head, well above the card's ~295 FLOP/byte
// ridge, so it is bound by matrix-multiply throughput. The design keeps the
// T×S logits out of device memory (online softmax, f32 m/l/acc in
// registers) and runs both products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate). It is the simple first version:
// one CTA per (64-query block, query head, batch row), four warps of 16
// rows each, K/V tiles of 64 keys staged through padded shared memory with
// plain 16-byte loads and no pipelining; wgmma, TMA and a multi-stage ring
// are later work. Each CTA maps its query head to KV head h / (nh/nkv) (no
// repeated K/V) and walks key tiles only up to its last row's causal
// frontier qstart + t, so blocks past the frontier are skipped, not masked.

#include "common.cuh"

namespace {

using lapha::NEG;

constexpr int BQ = 64;          // query rows per CTA (4 warps x 16)
constexpr int BK = 64;          // keys per tile
constexpr int DH = 128;         // head dim (the only one on the slice)
constexpr int LDS = DH + 8;     // padded smem row: 272 B, conflict-free fragment reads
constexpr int NT_S = BK / 8;    // n-tiles of the logits tile
constexpr int KS_QK = DH / 16;  // k-steps of Q·K^T
constexpr int NT_O = DH / 8;    // n-tiles of the output
constexpr int KS_PV = BK / 16;  // k-steps of P·V

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of mma m16n8k16 (PTX ISA), lane = 4*g + t4:
//   A (16x16, row-major): reg0 = (row g,   cols 2t4..+1), reg1 = (row g+8, cols 2t4..+1),
//                         reg2 = (row g,   cols 2t4+8..+9), reg3 = (row g+8, cols 2t4+8..+9)
//   B (16x8,  "col"):     reg0 = (k 2t4..+1, col g), reg1 = (k 2t4+8..+9, col g)
//   C (16x8, f32):        c0,c1 = (row g, cols 2t4, 2t4+1), c2,c3 = (row g+8, same cols)
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,   // (B, T, nh, DH)
                 const __nv_bfloat16* __restrict__ k,   // (B, S, nkv, DH)
                 const __nv_bfloat16* __restrict__ v,   // (B, S, nkv, DH)
                 const int* __restrict__ kv_valid,      // (B, S)
                 const int* __restrict__ qstart,        // (B,)
                 __nv_bfloat16* __restrict__ out,       // (B, T, nh, DH)
                 float* __restrict__ lse,               // (B, nh, T)
                 int T, int S, int nh, int nkv, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[BK * LDS];
  __shared__ __align__(16) __nv_bfloat16 sV[BK * LDS];
  __shared__ int sValid[BK];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (nh / nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int q0 = qb * BQ;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Q fragments for this warp's 16 rows, loaded once straight from global.
  const size_t q_stride = static_cast<size_t>(nh) * DH;
  const __nv_bfloat16* qbase = q + (static_cast<size_t>(b) * T * nh + h) * DH;
  uint32_t qf[KS_QK][4];
#pragma unroll
  for (int ks = 0; ks < KS_QK; ++ks) {
    const int c = ks * 16 + t4 * 2;
    qf[ks][0] = row[0] < T ? lapha::ld_u32(qbase + row[0] * q_stride + c) : 0u;
    qf[ks][1] = row[1] < T ? lapha::ld_u32(qbase + row[1] * q_stride + c) : 0u;
    qf[ks][2] = row[0] < T ? lapha::ld_u32(qbase + row[0] * q_stride + c + 8) : 0u;
    qf[ks][3] = row[1] < T ? lapha::ld_u32(qbase + row[1] * q_stride + c + 8) : 0u;
  }

  float o[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG, NEG};
  float l[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  // Keys past the frontier of this CTA's last real query row are never visible.
  const int last_row = min(q0 + BQ, T) - 1;
  const int kend = min(S, qs + last_row + 1);
  const int nkb = (kend + BK - 1) / BK;
  const size_t kv_stride = static_cast<size_t>(nkv) * DH;
  const __nv_bfloat16* kbase = k + (static_cast<size_t>(b) * S * nkv + hk) * DH;
  const __nv_bfloat16* vbase = v + (static_cast<size_t>(b) * S * nkv + hk) * DH;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    // Stage the K/V tile: 64 rows x 16 vectors of 16 B; rows past S are zero.
    for (int i = tid; i < BK * (DH / 8); i += 128) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      const int j = k0 + r;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (j < S) {
        kk = *reinterpret_cast<const uint4*>(kbase + j * kv_stride + c);
        vv = *reinterpret_cast<const uint4*>(vbase + j * kv_stride + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LDS + c) = kk;
      *reinterpret_cast<uint4*>(sV + r * LDS + c) = vv;
    }
    if (tid < BK) {
      const int j = k0 + tid;
      sValid[tid] = (j < S) ? kv_valid[static_cast<size_t>(b) * S + j] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kp = sK + (nt * 8 + g) * LDS + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < KS_QK; ++ks)
        mma_bf16_16816(s[nt], qf[ks], lapha::ld_u32(kp + ks * 16), lapha::ld_u32(kp + ks * 16 + 8));
    }

    // Mask, scale and take the per-row max over the tile.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        const bool ok = sValid[col] != 0 && (k0 + col) <= qs + row[r];
        const float x = ok ? s[nt][e] * scale : NEG;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
    }
    // p = exp(s - m) on visible keys, exactly 0 elsewhere.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = s[nt][e] > 0.5f * NEG ? __expf(s[nt][e] - m[r]) : 0.f;
        s[nt][e] = p;
        rs[r] += p;
      }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }

    // O += P V: the logits' C fragments of n-tiles (2kk, 2kk+1) are exactly
    // the A fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < KS_PV; ++kk) {
      uint32_t a[4];
      a[0] = lapha::pack_f32(s[2 * kk][0], s[2 * kk][1]);
      a[1] = lapha::pack_f32(s[2 * kk][2], s[2 * kk][3]);
      a[2] = lapha::pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = lapha::pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = sV + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const __nv_bfloat16* vd = vp + dt * 8;
        const uint32_t b0 = lapha::pack_raw(vd[0], vd[LDS]);
        const uint32_t b1 = lapha::pack_raw(vd[8 * LDS], vd[9 * LDS]);
        mma_bf16_16816(o[dt], a, b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* op = out + ((static_cast<size_t>(b) * T + row[r]) * nh + h) * DH + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt)
      *reinterpret_cast<uint32_t*>(op + dt * 8) =
          lapha::pack_f32(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    if (t4 == 0)
      lse[(static_cast<size_t>(b) * nh + h) * T + row[r]] = l[r] > 0.f ? m[r] + logf(l[r]) : NEG;
  }
}

}  // namespace

extern "C" int lapha_flash_fwd(const void* q, const void* k, const void* v, const int* kv_valid,
                               const int* qstart, void* out, float* lse, int B, int T, int S,
                               int nh, int nkv, int dh, float scale, void* stream) {
  if (dh != DH || nkv <= 0 || nh % nkv != 0 || B <= 0 || T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((T + BQ - 1) / BQ, nh, B);
  flash_fwd_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_valid, qstart,
      static_cast<__nv_bfloat16*>(out), lse, T, S, nh, nkv, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lapha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
