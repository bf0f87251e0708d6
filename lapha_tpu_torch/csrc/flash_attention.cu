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
// kv_valid[b, j] != 0 and j <= qstart[b] + t, and, on a sliding-window
// layer (window W > 0), j > qstart[b] + t - W (the Pallas band, :72-73 and
// :419-420). With a logit softcap (Gemma-2, a runtime float, 0 = off) the
// scaled logit s becomes cap·tanh(s/cap) in f32 before the mask and before
// the running max, on every tile the band visits (Pallas :66-67, :413-414).
// A row with no visible key writes 0 and LSE = -1e30. Attention sinks fold
// outside the kernel from its LSE, as in JAX.
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
// repeated K/V) and walks key tiles only from the first tile of its band
// (windowed layers, the Pallas kernels' kb_start :91-93, :436-437) up to its
// last row's causal frontier qstart + t, so tiles outside the band are
// skipped, not masked: a banded row reads O(W) keys. The head dims of Q/K
// (DH) and of V and the output (DV) are template parameters, instantiated
// for (64, 64) (GPT-OSS), (128, 128), (256, 256) (Gemma), (192, 128)
// (DeepSeek MLA: the scores on the 192-wide nope + rope Q/K, the combine on
// the 128-wide V, as the Pallas kernels take a V narrower than Q/K, :50-53
// and :441) and (96, 96) (Phi-3: six k-steps of Q·Kᵀ, twelve output
// n-tiles, Q in 24 registers; rows of 104 bf16, 208 B = 52 words, so the
// eight rows g of a fragment read start on banks 0, 20, 8, 28, 16, 4, 24,
// 12 and the four t4 lanes of each fill the gaps: no conflict). K and V
// tiles have their own padded strides. Shared memory is
// dynamic. At DH = 256 the output accumulator alone is 128 f32 registers a
// thread, so Q stays in shared memory (its fragments are read per k-step
// instead of held in 64 more registers) and key tiles are 32 wide (fewer
// logits registers, 67.7 KB of shared memory: two CTAs an SM); DH = 192
// does the same (46.1 KB).

#include "common.cuh"

namespace {

using lapha::NEG;
using lapha::mma_bf16_16816;  // fragment layout: common.cuh

constexpr int BQ = 64;          // query rows per CTA (4 warps x 16)

// Per-head-dim tiling: keys per tile, Q in shared memory, padded smem rows
// (width + 8 bf16: 272 B at 128, 400 B at 192, conflict-free fragment reads).
template <int DH, int DV>
struct Tile {
  static constexpr bool kQSmem = DH > 128;
  static constexpr int BK = DH > 128 ? 32 : 64;
  static constexpr int LDS = DH + 8;   // rows of sK and sQ
  static constexpr int LDV = DV + 8;   // rows of sV
  // sK, sV (and sQ) in bf16, then the tile's key validity
  static constexpr int kSmemBytes = ((BK + (kQSmem ? BQ : 0)) * LDS + BK * LDV) * 2 + BK * 4;
};

template <int DH, int DV>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,   // (B, T, nh, DH)
                 const __nv_bfloat16* __restrict__ k,   // (B, S, nkv, DH)
                 const __nv_bfloat16* __restrict__ v,   // (B, S, nkv, DV)
                 const int* __restrict__ kv_valid,      // (B, S)
                 const int* __restrict__ qstart,        // (B,)
                 __nv_bfloat16* __restrict__ out,       // (B, T, nh, DV)
                 float* __restrict__ lse,               // (B, nh, T)
                 int T, int S, int nh, int nkv, int window, float scale, float softcap) {
  static_assert(DV <= DH && DV % 8 == 0, "V may be narrower than Q/K, in whole 8-wide n-tiles");
  constexpr bool kQSmem = Tile<DH, DV>::kQSmem;
  constexpr int BK = Tile<DH, DV>::BK;
  constexpr int LDS = Tile<DH, DV>::LDS;
  constexpr int LDV = Tile<DH, DV>::LDV;
  constexpr int NT_S = BK / 8;    // n-tiles of the logits tile
  constexpr int KS_PV = BK / 16;  // k-steps of P·V
  constexpr int KS_QK = DH / 16;  // k-steps of Q·K^T
  constexpr int NT_O = DV / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BK * LDS;
  __nv_bfloat16* sQ = sV + BK * LDV;  // kQSmem only
  int* sValid = reinterpret_cast<int*>(sQ + (kQSmem ? BQ * LDS : 0));
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (nh / nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int q0 = qb * BQ;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Q fragments for this warp's 16 rows: held in registers, loaded once
  // straight from global; at DH = 256 staged once in shared memory instead.
  const size_t q_stride = static_cast<size_t>(nh) * DH;
  const __nv_bfloat16* qbase = q + (static_cast<size_t>(b) * T * nh + h) * DH;
  uint32_t qf[kQSmem ? 1 : KS_QK][4];
  if constexpr (kQSmem) {
    for (int i = tid; i < BQ * (DH / 8); i += 128) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      uint4 qq = make_uint4(0u, 0u, 0u, 0u);
      if (q0 + r < T) qq = *reinterpret_cast<const uint4*>(qbase + (q0 + r) * q_stride + c);
      *reinterpret_cast<uint4*>(sQ + r * LDS + c) = qq;
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < KS_QK; ++ks) {
      const int c = ks * 16 + t4 * 2;
      qf[ks][0] = row[0] < T ? lapha::ld_u32(qbase + row[0] * q_stride + c) : 0u;
      qf[ks][1] = row[1] < T ? lapha::ld_u32(qbase + row[1] * q_stride + c) : 0u;
      qf[ks][2] = row[0] < T ? lapha::ld_u32(qbase + row[0] * q_stride + c + 8) : 0u;
      qf[ks][3] = row[1] < T ? lapha::ld_u32(qbase + row[1] * q_stride + c + 8) : 0u;
    }
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
  // Keys below the band of this CTA's first query row are never visible.
  const int kb0 = window > 0 ? max(qs + q0 - (window - 1), 0) / BK : 0;
  const size_t k_stride = static_cast<size_t>(nkv) * DH, v_stride = static_cast<size_t>(nkv) * DV;
  const __nv_bfloat16* kbase = k + (static_cast<size_t>(b) * S * nkv + hk) * DH;
  const __nv_bfloat16* vbase = v + (static_cast<size_t>(b) * S * nkv + hk) * DV;

  for (int kb = kb0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    // Stage the K/V tile: BK rows x DH/8 vectors of 16 B of K and the first
    // DV/8 of them of V; rows past S are zero.
    for (int i = tid; i < BK * (DH / 8); i += 128) {
      const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
      const int j = k0 + r;
      const bool in_v = DV == DH || c < DV;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (j < S) {
        kk = *reinterpret_cast<const uint4*>(kbase + j * k_stride + c);
        if (in_v) vv = *reinterpret_cast<const uint4*>(vbase + j * v_stride + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LDS + c) = kk;
      if (in_v) *reinterpret_cast<uint4*>(sV + r * LDV + c) = vv;
    }
    if (tid < BK) {
      const int j = k0 + tid;
      sValid[tid] = (j < S) ? kv_valid[static_cast<size_t>(b) * S + j] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BK keys.
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS_QK; ++ks) {
      uint32_t a[4];
      if constexpr (kQSmem) {
        const __nv_bfloat16* qp = sQ + (warp * 16 + g) * LDS + ks * 16 + t4 * 2;
        a[0] = lapha::ld_u32(qp);
        a[1] = lapha::ld_u32(qp + 8 * LDS);
        a[2] = lapha::ld_u32(qp + 8);
        a[3] = lapha::ld_u32(qp + 8 * LDS + 8);
      } else {
        a[0] = qf[ks][0]; a[1] = qf[ks][1]; a[2] = qf[ks][2]; a[3] = qf[ks][3];
      }
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* kp = sK + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
        mma_bf16_16816(s[nt], a, lapha::ld_u32(kp), lapha::ld_u32(kp + 8));
      }
    }

    // Scale, softcap, mask and take the per-row max over the tile.
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        const int j = k0 + col, qp = qs + row[r];
        const bool ok = sValid[col] != 0 && j <= qp && (window <= 0 || j > qp - window);
        float x = s[nt][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        x = ok ? x : NEG;
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
      const __nv_bfloat16* vp = sV + (kk * 16 + t4 * 2) * LDV + g;
#pragma unroll
      for (int dt = 0; dt < NT_O; ++dt) {
        const __nv_bfloat16* vd = vp + dt * 8;
        const uint32_t b0 = lapha::pack_raw(vd[0], vd[LDV]);
        const uint32_t b1 = lapha::pack_raw(vd[8 * LDV], vd[9 * LDV]);
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
    __nv_bfloat16* op = out + ((static_cast<size_t>(b) * T + row[r]) * nh + h) * DV + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < NT_O; ++dt)
      *reinterpret_cast<uint32_t*>(op + dt * 8) =
          lapha::pack_f32(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    if (t4 == 0)
      lse[(static_cast<size_t>(b) * nh + h) * T + row[r]] = l[r] > 0.f ? m[r] + logf(l[r]) : NEG;
  }
}

template <int DH, int DV>
int launch(const void* q, const void* k, const void* v, const int* kv_valid, const int* qstart,
           void* out, float* lse, int B, int T, int S, int nh, int nkv, int window, float scale,
           float softcap, void* stream) {
  constexpr int smem = Tile<DH, DV>::kSmemBytes;
  static bool opted_in[lapha::kMaxDevices] = {};
  const cudaError_t opt_in = lapha::smem_opt_in(flash_fwd_kernel<DH, DV>, smem, opted_in);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid((T + BQ - 1) / BQ, nh, B);
  flash_fwd_kernel<DH, DV><<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), kv_valid, qstart,
      static_cast<__nv_bfloat16*>(out), lse, T, S, nh, nkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: full causal attention; window W > 0: the band of the last W
// positions. softcap <= 0: no logit softcap; cap > 0: s -> cap·tanh(s/cap).
// (dh, dv): the head dims of Q/K and of V/out, one of the instances above.
extern "C" int lapha_flash_fwd(const void* q, const void* k, const void* v, const int* kv_valid,
                               const int* qstart, void* out, float* lse, int B, int T, int S,
                               int nh, int nkv, int dh, int dv, int window, float scale,
                               float softcap, void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || B <= 0 || T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh == 64 && dv == 64)
    return launch<64, 64>(q, k, v, kv_valid, qstart, out, lse, B, T, S, nh, nkv, window, scale,
                          softcap, stream);
  if (dh == 128 && dv == 128)
    return launch<128, 128>(q, k, v, kv_valid, qstart, out, lse, B, T, S, nh, nkv, window, scale,
                            softcap, stream);
  if (dh == 256 && dv == 256)
    return launch<256, 256>(q, k, v, kv_valid, qstart, out, lse, B, T, S, nh, nkv, window, scale,
                            softcap, stream);
  if (dh == 192 && dv == 128)
    return launch<192, 128>(q, k, v, kv_valid, qstart, out, lse, B, T, S, nh, nkv, window, scale,
                            softcap, stream);
  if (dh == 96 && dv == 96)
    return launch<96, 96>(q, k, v, kv_valid, qstart, out, lse, B, T, S, nh, nkv, window, scale,
                          softcap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* lapha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
