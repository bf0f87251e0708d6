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
//   P  = exp(scale·q·k - lse)   on visible keys of rows with lse > -5e29, else 0
//   dS = P ∘ (dO·Vᵀ - D),  D = rowsum(dO ∘ O) (computed by the caller)
//   dQ = scale·dS·K,  dK = scale·dSᵀ·Q,  dV = Pᵀ·dO
// A row whose LSE is the -1e30 sentinel saw no key and contributes nothing
// (the `row_ok` guard of the Pallas kernels). With a window W > 0 (a
// sliding-window layer) key j is seen only where also j > qstart[b] + t - W:
// the window terms of _dq_kernel (:130-131, band start :158-159) and
// _dkv_kernel (:190-191, band end :215-219). The dq kernel starts at the key
// tile of the band's first key, the dk/dv kernel stops after the last query
// tile that sees its key block, and both mask inside the band. Head dims 64
// (GPT-OSS) and 128, a template parameter; W is a runtime argument (0 = off).
//
// What bounds it on an H100: at the training shape (B=8, T=4096, 12/2
// heads, dh 128) each kernel does ~2.5x the forward's matrix work (dq: two
// products per tile for dS plus dS·K; dk/dv: four) against the same bytes,
// far above the ~295 FLOP/byte ridge, so it is bound by matrix-multiply
// throughput. Both run every product on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate); P and dS are rounded to bf16 only as
// the A operand of the next product. Simple first version: plain 16-byte
// loads into padded shared memory, no cp.async/TMA pipelining, no wgmma.
//
// dq kernel: one CTA per (64-query block, query head, batch row), four warps
// of 16 rows. Q and dO fragments stay in registers; K/V tiles of 32 keys
// pass through shared memory up to the block's causal frontier; dQ
// accumulates in f32 registers and is written once.
//
// dk/dv kernel: one CTA per (64-key block, KV head, batch row), four warps of
// 16 keys. The Pallas kernel sums the GQA group through a grid axis that
// revisits a VMEM-resident output block; here one CTA loops over the
// group's query heads and, for each, over 32-query tiles from the key
// block's causal horizon on, so the sum stays in registers and needs no
// atomics. dK and dV (2 x 16xDH f32 per warp) are the register budget, so K
// and V stay in shared memory and their fragments are read per tile rather
// than held; shared memory is 52.7 KB at dh 128, 28.2 KB at dh 64 (dynamic).
// A windowed dq CTA walks at most ceil((W + 63) / 32) + 1 key tiles and a
// windowed dk/dv CTA at most ceil((W + 63) / 32) + 1 query tiles per head,
// so a band of W = 128 costs O(T·W), not O(T²).

#include "common.cuh"

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

constexpr int KV_BK = 64;            // key rows per dk/dv CTA (4 warps x 16)
constexpr int KV_BQ = 32;            // queries per tile
constexpr int KV_NT = KV_BQ / 8;     // n-tiles of a transposed logits tile
constexpr int KV_KS = KV_BQ / 16;    // k-steps of Pᵀ·dO and dSᵀ·Q

// Per head dim: the padded smem row (DH + 8: 144 or 272 B, conflict-free
// fragment reads), the k-steps and n-tiles over the head dim, and the dk/dv
// kernel's dynamic shared memory (K, V, a Q and a dO tile, LSE, D, validity).
template <int DH>
struct Dims {
  static constexpr int LDS = DH + 8;
  static constexpr int KS_D = DH / 16;
  static constexpr int NT_D = DH / 8;
  static constexpr size_t KV_SMEM = (2 * KV_BK + 2 * KV_BQ) * LDS * sizeof(bf16)
                                    + 2 * KV_BQ * sizeof(float) + KV_BK * sizeof(int);
};

// Stage ROWS rows of DH bf16 (row r0 + r of a (rows, stride) panel) into a
// padded smem tile; rows at or past `limit` are zero.
template <int ROWS, int DH>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t stride,
                                           int r0, int limit, int tid) {
  constexpr int LDS = Dims<DH>::LDS;
  for (int i = tid; i < ROWS * (DH / 8); i += NTHREADS) {
    const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// B fragment of a (k = tile row, n = head-dim column) operand held row-major
// in a padded smem tile: two rows per register. p = tile + (16kk + 2t4)·LDS + 8dt + g.
template <int LDS>
__device__ __forceinline__ void b_rows(const bf16* p, uint32_t& b0, uint32_t& b1) {
  b0 = pack_raw(p[0], p[LDS]);
  b1 = pack_raw(p[8 * LDS], p[9 * LDS]);
}

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q,        // (B, T, nh, DH)
                    const bf16* __restrict__ k,        // (B, S, nkv, DH)
                    const bf16* __restrict__ v,        // (B, S, nkv, DH)
                    const bf16* __restrict__ dout,     // (B, T, nh, DH)
                    const float* __restrict__ lse,     // (B, nh, T)
                    const float* __restrict__ delta,   // (B, nh, T)
                    const int* __restrict__ kv_valid,  // (B, S)
                    const int* __restrict__ qstart,    // (B,)
                    bf16* __restrict__ dq,             // (B, T, nh, DH)
                    int T, int S, int nh, int nkv, int window, float scale) {
  constexpr int LDS = Dims<DH>::LDS, KS_D = Dims<DH>::KS_D, NT_D = Dims<DH>::NT_D;
  __shared__ __align__(16) bf16 sK[DQ_BK * LDS];
  __shared__ __align__(16) bf16 sV[DQ_BK * LDS];
  __shared__ int sValid[DQ_BK];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (nh / nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int q0 = qb * DQ_BQ;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Q and dO fragments of this warp's 16 rows, loaded once from global.
  const size_t q_stride = static_cast<size_t>(nh) * DH;
  const size_t qoff = (static_cast<size_t>(b) * T * nh + h) * DH;
  uint32_t qf[KS_D][4], df[KS_D][4];
#pragma unroll
  for (int ks = 0; ks < KS_D; ++ks) {
    const int c = ks * 16 + t4 * 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row[i & 1];
      const size_t off = qoff + r * q_stride + c + (i >> 1) * 8;
      qf[ks][i] = r < T ? ld_u32(q + off) : 0u;
      df[ks][i] = r < T ? ld_u32(dout + off) : 0u;
    }
  }
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
  const size_t kv_stride = static_cast<size_t>(nkv) * DH;
  const bf16* kbase = k + (static_cast<size_t>(b) * S * nkv + hk) * DH;
  const bf16* vbase = v + (static_cast<size_t>(b) * S * nkv + hk) * DH;

  for (int kb = kb0; kb < nkb; ++kb) {
    const int k0 = kb * DQ_BK;
    stage_rows<DQ_BK, DH>(sK, kbase, kv_stride, k0, S, tid);
    stage_rows<DQ_BK, DH>(sV, vbase, kv_stride, k0, S, tid);
    if (tid < DQ_BK) sValid[tid] = (k0 + tid < S) ? kv_valid[static_cast<size_t>(b) * S + k0 + tid] : 0;
    __syncthreads();

    // S = Q Kᵀ and dP = dO Vᵀ for this warp's 16 rows x 32 keys.
    float s[DQ_NT][4], dp[DQ_NT][4];
#pragma unroll
    for (int nt = 0; nt < DQ_NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const bf16* kp = sK + (nt * 8 + g) * LDS + t4 * 2;
      const bf16* vp = sV + (nt * 8 + g) * LDS + t4 * 2;
#pragma unroll
      for (int ks = 0; ks < KS_D; ++ks) {
        mma_bf16_16816(s[nt], qf[ks], ld_u32(kp + ks * 16), ld_u32(kp + ks * 16 + 8));
        mma_bf16_16816(dp[nt], df[ks], ld_u32(vp + ks * 16), ld_u32(vp + ks * 16 + 8));
      }
    }
    // dS = P ∘ (dP - D), P recomputed from the LSE; 0 where not visible.
#pragma unroll
    for (int nt = 0; nt < DQ_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        const bool vis = ok_r[r] && sValid[col] != 0 && (k0 + col) <= qs + row[r] &&
                         (window <= 0 || (k0 + col) > qs + row[r] - window);
        const float p = vis ? __expf(s[nt][e] * scale - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - d_r[r]);
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

template <int DH>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q,        // (B, T, nh, DH)
                     const bf16* __restrict__ k,        // (B, S, nkv, DH)
                     const bf16* __restrict__ v,        // (B, S, nkv, DH)
                     const bf16* __restrict__ dout,     // (B, T, nh, DH)
                     const float* __restrict__ lse,     // (B, nh, T)
                     const float* __restrict__ delta,   // (B, nh, T)
                     const int* __restrict__ kv_valid,  // (B, S)
                     const int* __restrict__ qstart,    // (B,)
                     bf16* __restrict__ dk,             // (B, S, nkv, DH)
                     bf16* __restrict__ dv,             // (B, S, nkv, DH)
                     int T, int S, int nh, int nkv, int window, float scale) {
  constexpr int LDS = Dims<DH>::LDS, KS_D = Dims<DH>::KS_D, NT_D = Dims<DH>::NT_D;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KV_BK * LDS;
  bf16* sQ = sV + KV_BK * LDS;
  bf16* sO = sQ + KV_BQ * LDS;  // dO tile
  float* sL = reinterpret_cast<float*>(sO + KV_BQ * LDS);
  float* sD = sL + KV_BQ;
  int* sValid = reinterpret_cast<int*>(sD + KV_BQ);

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = nh / nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int k0 = kb * KV_BK;
  const int kl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's key rows in the tile

  const size_t kv_stride = static_cast<size_t>(nkv) * DH;
  const size_t kvoff = (static_cast<size_t>(b) * S * nkv + hk) * DH;
  stage_rows<KV_BK, DH>(sK, k + kvoff, kv_stride, k0, S, tid);
  stage_rows<KV_BK, DH>(sV, v + kvoff, kv_stride, k0, S, tid);
  if (tid < KV_BK) sValid[tid] = (k0 + tid < S) ? kv_valid[static_cast<size_t>(b) * S + k0 + tid] : 0;

  float dka[NT_D][4], dva[NT_D][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
  }

  // The first query that can see key k0 is t = k0 - qs (the causal horizon);
  // with a window the last that sees the block's last key is
  // t = k0 + KV_BK - 1 + W - 1 - qs.
  const int qb0 = max(0, k0 - qs) / KV_BQ;
  int nqb = (T + KV_BQ - 1) / KV_BQ;
  if (window > 0) {
    const int t_last = k0 + KV_BK + window - 2 - qs;
    nqb = t_last < 0 ? 0 : min(nqb, t_last / KV_BQ + 1);
  }
  const size_t q_stride = static_cast<size_t>(nh) * DH;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t qoff = (static_cast<size_t>(b) * T * nh + h) * DH;
    const float* lrow = lse + (static_cast<size_t>(b) * nh + h) * T;
    const float* drow = delta + (static_cast<size_t>(b) * nh + h) * T;
    for (int qb = qb0; qb < nqb; ++qb) {
      const int t0 = qb * KV_BQ;
      __syncthreads();  // the previous tile's readers are done (and K/V are staged)
      stage_rows<KV_BQ, DH>(sQ, q + qoff, q_stride, t0, T, tid);
      stage_rows<KV_BQ, DH>(sO, dout + qoff, q_stride, t0, T, tid);
      if (tid < KV_BQ) {
        const int t = t0 + tid;
        sL[tid] = t < T ? lrow[t] : NEG;
        sD[tid] = t < T ? drow[t] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ for this warp's 16 keys x 32 queries.
      float st[KV_NT][4], dpt[KV_NT][4];
#pragma unroll
      for (int nt = 0; nt < KV_NT; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS_D; ++ks) {
        const bf16* ka = sK + kl[0] * LDS + ks * 16 + t4 * 2;
        const bf16* va = sV + kl[0] * LDS + ks * 16 + t4 * 2;
        const uint32_t ak[4] = {ld_u32(ka), ld_u32(ka + 8 * LDS), ld_u32(ka + 8), ld_u32(ka + 8 * LDS + 8)};
        const uint32_t av[4] = {ld_u32(va), ld_u32(va + 8 * LDS), ld_u32(va + 8), ld_u32(va + 8 * LDS + 8)};
#pragma unroll
        for (int nt = 0; nt < KV_NT; ++nt) {
          const bf16* qp = sQ + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
          const bf16* op = sO + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
          mma_bf16_16816(st[nt], ak, ld_u32(qp), ld_u32(qp + 8));
          mma_bf16_16816(dpt[nt], av, ld_u32(op), ld_u32(op + 8));
        }
      }
      // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ - D); 0 where not visible.
#pragma unroll
      for (int nt = 0; nt < KV_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + t4 * 2 + (e & 1);
          const int r = e >> 1;
          const float l = sL[qc];
          const bool vis = l > 0.5f * NEG && sValid[kl[r]] != 0 && (k0 + kl[r]) <= qs + t0 + qc &&
                           (window <= 0 || (k0 + kl[r]) > qs + t0 + qc - window);
          const float p = vis ? __expf(st[nt][e] * scale - l) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sD[qc]);
        }
      // dV += Pᵀ dO and dK += dSᵀ Q
#pragma unroll
      for (int kk = 0; kk < KV_KS; ++kk) {
        uint32_t ap[4], as[4];
        a_from_d(ap, st[2 * kk], st[2 * kk + 1]);
        a_from_d(as, dpt[2 * kk], dpt[2 * kk + 1]);
        const bf16* op = sO + (kk * 16 + t4 * 2) * LDS + g;
        const bf16* qp = sQ + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
        for (int dt = 0; dt < NT_D; ++dt) {
          uint32_t b0, b1;
          b_rows<LDS>(op + dt * 8, b0, b1);
          mma_bf16_16816(dva[dt], ap, b0, b1);
          b_rows<LDS>(qp + dt * 8, b0, b1);
          mma_bf16_16816(dka[dt], as, b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = k0 + kl[r];
    if (j >= S) continue;
    const size_t off = kvoff + j * kv_stride + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < NT_D; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8) =
          pack_f32(dka[dt][2 * r] * scale, dka[dt][2 * r + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8) = pack_f32(dva[dt][2 * r], dva[dt][2 * r + 1]);
    }
  }
}

bool bad_shape(int B, int T, int S, int nh, int nkv, int dh, int window) {
  return (dh != 64 && dh != 128) || nkv <= 0 || nh % nkv != 0 || B <= 0 || T <= 0 || S <= 0 ||
         window < 0;
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* kv_valid, const int* qstart, void* dq, int B, int T,
              int S, int nh, int nkv, int window, float scale, cudaStream_t stream) {
  const dim3 grid((T + DQ_BQ - 1) / DQ_BQ, nh, B);
  flash_bwd_dq_kernel<DH><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, kv_valid, qstart, static_cast<bf16*>(dq),
      T, S, nh, nkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kv_valid, const int* qstart, void* dk, void* dv,
               int B, int T, int S, int nh, int nkv, int window, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = Dims<DH>::KV_SMEM;
  static bool opted[lapha::kMaxDevices] = {};
  cudaError_t err = lapha::smem_opt_in(flash_bwd_dkv_kernel<DH>, static_cast<int>(smem), opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + KV_BK - 1) / KV_BK, nkv, B);
  flash_bwd_dkv_kernel<DH><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, kv_valid, qstart, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, S, nh, nkv, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `window` > 0 bands the keys to the last `window` positions (0 = off).
extern "C" int lapha_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const float* lse, const float* delta, const int* kv_valid,
                                  const int* qstart, void* dq, int B, int T, int S, int nh,
                                  int nkv, int dh, int window, float scale, void* stream) {
  if (bad_shape(B, T, S, nh, nkv, dh, window)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return dh == 64 ? launch_dq<64>(q, k, v, dout, lse, delta, kv_valid, qstart, dq, B, T, S, nh,
                                  nkv, window, scale, st)
                  : launch_dq<128>(q, k, v, dout, lse, delta, kv_valid, qstart, dq, B, T, S, nh,
                                   nkv, window, scale, st);
}

extern "C" int lapha_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* kv_valid,
                                   const int* qstart, void* dk, void* dv, int B, int T, int S,
                                   int nh, int nkv, int dh, int window, float scale,
                                   void* stream) {
  if (bad_shape(B, T, S, nh, nkv, dh, window)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  return dh == 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, kv_valid, qstart, dk, dv, B, T, S,
                                   nh, nkv, window, scale, st)
                  : launch_dkv<128>(q, k, v, dout, lse, delta, kv_valid, qstart, dk, dv, B, T,
                                    S, nh, nkv, window, scale, st);
}
