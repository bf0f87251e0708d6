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
// throughput. Every product runs on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulate); P and dS are rounded to bf16 only as
// the A operand of the next product. Simple first version: plain 16-byte
// loads into padded shared memory, no cp.async/TMA pipelining, no wgmma.
//
// dq kernel: one CTA per (64-query block, query head, batch row), four warps
// of 16 rows. K/V tiles of 32 keys pass through shared memory up to the
// block's causal frontier; dQ accumulates in f32 registers and is written
// once. At dh 64/128 the Q and dO fragments stay in registers. At dh 256
// the dQ accumulator alone is 128 registers a thread, so Q and dO are staged
// once into shared memory and their fragments read per k-step (as the
// forward's dh-256 instance keeps Q): 101.5 KB of dynamic shared memory.
// DH 192 does the same (dQ alone 96 registers; 63.1 KB with DV 128).
//
// At dh 96 both kernels take the dh <= 128 design: the dq kernel holds Q
// and dO (24 registers each) and dQ (48) in registers, the dk/dv kernel dK
// and dV (48 each) with four warps, 39.5 KB of shared memory.
//
// dk/dv kernel: one CTA per (64-key block, KV head, batch row). The Pallas
// kernel sums the GQA group through a grid axis that revisits a
// VMEM-resident output block; here one CTA loops over the group's query
// heads and, for each, over 32-query tiles from the key block's causal
// horizon on, so the sums stay in registers and need no atomics. K and V
// stay in shared memory and their fragments are read per tile. At dh 64/128
// four warps of 16 keys each hold dK and dV (2 x 16xDH f32 a warp); shared
// memory is 52.7 KB at dh 128, 28.2 KB at dh 64. At dh 256 those two
// accumulators would be 256 registers a thread, past the limit of 255, so
// the CTA has eight warps and splits the products by role, two warps a
// 16-key strip: the P warp computes Sᵀ = K·Qᵀ, Pᵀ and dV += Pᵀ·dO; the dS
// warp computes dPᵀ = V·dOᵀ and, from the P warp's Pᵀ∘dc/ds handed over
// through shared memory (2 KB a strip, in the mma fragment layout, so each
// lane reads what the same lane of its partner wrote), dSᵀ and dK += dSᵀ·Q.
// Each warp keeps one 16x256 f32 accumulator (128 registers) and does two
// of the four products, so the split adds no arithmetic; 110.1 KB of
// dynamic shared memory, one CTA an SM. DH 192 takes the same kernel (dK
// and dV together would be 160 registers a thread before the logits): the
// dS warp's dPᵀ contracts over DV and its dK is DH wide, the P warp's dV is
// DV wide; 71.5 KB with DV 128.
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

constexpr int KV_BK = 64;            // key rows per dk/dv CTA (4 strips x 16)
constexpr int KV_BQ = 32;            // queries per tile
constexpr int KV_NT = KV_BQ / 8;     // n-tiles of a transposed logits tile
constexpr int KV_KS = KV_BQ / 16;    // k-steps of Pᵀ·dO and dSᵀ·Q

// Per (Q/K, V) head-dim pair: the padded smem rows of Q/K and of V/dO (width
// + 8: 144, 272, 400 or 528 B, conflict-free fragment reads), the k-steps
// and n-tiles over each width, whether the dq kernel stages Q/dO in shared
// memory and the dk/dv kernel splits its products over two warps a strip
// (DH > 128), the threads of a dk/dv CTA, and both kernels' dynamic shared
// memory: dq — K, V (Q, dO) and the key validity; dk/dv — K, V, a Q and a dO
// tile, (the Pᵀ hand-over,) LSE, D and the key validity.
template <int DH, int DV>
struct Dims {
  static_assert(DV <= DH && DV % 16 == 0, "V may be narrower than Q/K, in whole 16-wide k-steps");
  static constexpr int LDS = DH + 8;   // rows of sK and sQ
  static constexpr int LDV = DV + 8;   // rows of sV and sO (dO)
  static constexpr int KS_D = DH / 16, KS_V = DV / 16;
  static constexpr int NT_D = DH / 8, NT_V = DV / 8;
  static constexpr bool kSplit = DH > 128;
  static constexpr int KV_THREADS = kSplit ? 2 * NTHREADS : NTHREADS;
  static constexpr size_t DQ_SMEM =
      (DQ_BK + (kSplit ? DQ_BQ : 0)) * (LDS + LDV) * sizeof(bf16) + DQ_BK * sizeof(int);
  static constexpr size_t KV_XCHG = kSplit ? (KV_BK / 16) * KV_NT * 4 * 32 : 0;  // floats
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
  constexpr bool kQSmem = D::kSplit;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + DQ_BK * LDS;
  bf16* sQ = sV + DQ_BK * LDV;               // kQSmem only
  bf16* sO = sQ + DQ_BQ * LDS;               // dO, kQSmem only
  int* sValid = reinterpret_cast<int*>(sV + DQ_BK * LDV + (kQSmem ? DQ_BQ * (LDS + LDV) : 0));
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (nh / nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int q0 = qb * DQ_BQ;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  // Q and dO of this warp's 16 rows: fragments loaded once from global into
  // registers, or (DH > 128) the CTA's 64 rows staged once into shared memory.
  const size_t q_stride = static_cast<size_t>(nh) * DH, o_stride = static_cast<size_t>(nh) * DV;
  const size_t qoff = (static_cast<size_t>(b) * T * nh + h) * DH;
  const size_t ooff = (static_cast<size_t>(b) * T * nh + h) * DV;
  uint32_t qf[kQSmem ? 1 : KS_D][4], df[kQSmem ? 1 : KS_V][4];
  if constexpr (kQSmem) {
    stage_rows<DQ_BQ, DH>(sQ, q + qoff, q_stride, q0, T, tid);
    stage_rows<DQ_BQ, DV>(sO, dout + ooff, o_stride, q0, T, tid);
  } else {
#pragma unroll
    for (int ks = 0; ks < KS_D; ++ks) {
      const int c = ks * 16 + t4 * 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row[i & 1];
        qf[ks][i] = r < T ? ld_u32(q + qoff + r * q_stride + c + (i >> 1) * 8) : 0u;
        if (ks < KS_V) df[ks][i] = r < T ? ld_u32(dout + ooff + r * o_stride + c + (i >> 1) * 8) : 0u;
      }
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
      if constexpr (kQSmem) {
        a_rows<LDS>(sQ + (warp * 16 + g) * LDS + ks * 16 + t4 * 2, aq);
        if (ks < KS_V) a_rows<LDV>(sO + (warp * 16 + g) * LDV + ks * 16 + t4 * 2, ad);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          aq[i] = qf[ks][i];
          if (ks < KS_V) ad[i] = df[ks][i];
        }
      }
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

// dk/dv at DH <= 128: four warps, each with dK and dV of its 16 keys.
template <int DH, int DV, bool kCap>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q,        // (B, T, nh, DH)
                     const bf16* __restrict__ k,        // (B, S, nkv, DH)
                     const bf16* __restrict__ v,        // (B, S, nkv, DV)
                     const bf16* __restrict__ dout,     // (B, T, nh, DV)
                     const float* __restrict__ lse,     // (B, nh, T)
                     const float* __restrict__ delta,   // (B, nh, T)
                     const int* __restrict__ kv_valid,  // (B, S)
                     const int* __restrict__ qstart,    // (B,)
                     bf16* __restrict__ dk,             // (B, S, nkv, DH)
                     bf16* __restrict__ dv,             // (B, S, nkv, DV)
                     int T, int S, int nh, int nkv, int window, float scale, float softcap) {
  using D = Dims<DH, DV>;
  constexpr int LDS = D::LDS, LDV = D::LDV, KS_D = D::KS_D, KS_V = D::KS_V;
  constexpr int NT_D = D::NT_D, NT_V = D::NT_V;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + KV_BK * LDS;
  bf16* sQ = sV + KV_BK * LDV;
  bf16* sO = sQ + KV_BQ * LDS;  // dO tile
  float* sL = reinterpret_cast<float*>(sO + KV_BQ * LDV);
  float* sD = sL + KV_BQ;
  int* sValid = reinterpret_cast<int*>(sD + KV_BQ);
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = nh / nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int qs = qstart[b];
  const int k0 = kb * KV_BK;
  const int kl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's key rows in the tile

  const size_t k_stride = static_cast<size_t>(nkv) * DH, v_stride = static_cast<size_t>(nkv) * DV;
  const size_t koff = (static_cast<size_t>(b) * S * nkv + hk) * DH;
  const size_t voff = (static_cast<size_t>(b) * S * nkv + hk) * DV;
  stage_rows<KV_BK, DH>(sK, k + koff, k_stride, k0, S, tid);
  stage_rows<KV_BK, DV>(sV, v + voff, v_stride, k0, S, tid);
  if (tid < KV_BK) sValid[tid] = (k0 + tid < S) ? kv_valid[static_cast<size_t>(b) * S + k0 + tid] : 0;

  float dka[NT_D][4], dva[NT_V][4];
#pragma unroll
  for (int i = 0; i < NT_D; ++i) {
    dka[i][0] = dka[i][1] = dka[i][2] = dka[i][3] = 0.f;
    if (i < NT_V) dva[i][0] = dva[i][1] = dva[i][2] = dva[i][3] = 0.f;
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
  const size_t q_stride = static_cast<size_t>(nh) * DH, o_stride = static_cast<size_t>(nh) * DV;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t qoff = (static_cast<size_t>(b) * T * nh + h) * DH;
    const size_t ooff = (static_cast<size_t>(b) * T * nh + h) * DV;
    const float* lrow = lse + (static_cast<size_t>(b) * nh + h) * T;
    const float* drow = delta + (static_cast<size_t>(b) * nh + h) * T;
    for (int qb = qb0; qb < nqb; ++qb) {
      const int t0 = qb * KV_BQ;
      __syncthreads();  // the previous tile's readers are done (and K/V are staged)
      stage_rows<KV_BQ, DH>(sQ, q + qoff, q_stride, t0, T, tid);
      stage_rows<KV_BQ, DV>(sO, dout + ooff, o_stride, t0, T, tid);
      if (tid < KV_BQ) {
        const int t = t0 + tid;
        sL[tid] = t < T ? lrow[t] : NEG;
        sD[tid] = t < T ? drow[t] : 0.f;
      }
      __syncthreads();

      // Sᵀ = K Qᵀ (over DH) and dPᵀ = V dOᵀ (over DV) for this warp's 16 keys
      // x 32 queries.
      float st[KV_NT][4], dpt[KV_NT][4];
#pragma unroll
      for (int nt = 0; nt < KV_NT; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS_D; ++ks) {
        uint32_t ak[4], av[4];
        a_rows<LDS>(sK + kl[0] * LDS + ks * 16 + t4 * 2, ak);
        if (ks < KS_V) a_rows<LDV>(sV + kl[0] * LDV + ks * 16 + t4 * 2, av);
#pragma unroll
        for (int nt = 0; nt < KV_NT; ++nt) {
          const bf16* qp = sQ + (nt * 8 + g) * LDS + ks * 16 + t4 * 2;
          mma_bf16_16816(st[nt], ak, ld_u32(qp), ld_u32(qp + 8));
          if (ks < KS_V) {
            const bf16* op = sO + (nt * 8 + g) * LDV + ks * 16 + t4 * 2;
            mma_bf16_16816(dpt[nt], av, ld_u32(op), ld_u32(op + 8));
          }
        }
      }
      // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ - D) ∘ dc/ds; 0 where not visible.
#pragma unroll
      for (int nt = 0; nt < KV_NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = nt * 8 + t4 * 2 + (e & 1);
          const int r = e >> 1;
          const float l = sL[qc];
          const bool vis = l > 0.5f * NEG && sValid[kl[r]] != 0 && (k0 + kl[r]) <= qs + t0 + qc &&
                           (window <= 0 || (k0 + kl[r]) > qs + t0 + qc - window);
          float dc;
          const float c = capped<kCap>(st[nt][e], scale, softcap, inv_cap, dc);
          const float p = vis ? __expf(c - l) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sD[qc]) * dc;
        }
      // dV += Pᵀ dO (DV wide) and dK += dSᵀ Q (DH wide)
#pragma unroll
      for (int kk = 0; kk < KV_KS; ++kk) {
        uint32_t ap[4], as[4];
        a_from_d(ap, st[2 * kk], st[2 * kk + 1]);
        a_from_d(as, dpt[2 * kk], dpt[2 * kk + 1]);
        const bf16* op = sO + (kk * 16 + t4 * 2) * LDV + g;
        const bf16* qp = sQ + (kk * 16 + t4 * 2) * LDS + g;
#pragma unroll
        for (int dt = 0; dt < NT_D; ++dt) {
          uint32_t b0, b1;
          if (dt < NT_V) {
            b_rows<LDV>(op + dt * 8, b0, b1);
            mma_bf16_16816(dva[dt], ap, b0, b1);
          }
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
    const size_t ko = koff + j * k_stride + t4 * 2, vo = voff + j * v_stride + t4 * 2;
#pragma unroll
    for (int dt = 0; dt < NT_D; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + ko + dt * 8) =
          pack_f32(dka[dt][2 * r] * scale, dka[dt][2 * r + 1] * scale);
      if (dt < NT_V)
        *reinterpret_cast<uint32_t*>(dv + vo + dt * 8) = pack_f32(dva[dt][2 * r], dva[dt][2 * r + 1]);
    }
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
template <int DH, int DV, bool kCap>
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
                           int T, int S, int nh, int nkv, int window, float scale,
                           float softcap) {
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

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = nh / nkv;
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

  for (int gi = 0; gi < group; ++gi) {
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

  bf16* out = ds_warp ? dk + koff : dv + voff;
  const size_t stride = ds_warp ? k_stride : v_stride;
  const int nt_out = ds_warp ? NT_D : NT_V;
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

bool bad_shape(int B, int T, int S, int nh, int nkv, int window, float softcap) {
  return nkv <= 0 || nh % nkv != 0 || B <= 0 || T <= 0 || S <= 0 || window < 0 ||
         !(softcap >= 0.f);
}

template <int DH, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* kv_valid, const int* qstart, void* dq, int B, int T,
              int S, int nh, int nkv, int window, float scale, float softcap,
              cudaStream_t stream) {
  constexpr size_t smem = Dims<DH, DV>::DQ_SMEM;
  const bool cap = softcap > 0.f;
  const auto kernel = cap ? flash_bwd_dq_kernel<DH, DV, true> : flash_bwd_dq_kernel<DH, DV, false>;
  static bool opted[2][lapha::kMaxDevices] = {};
  cudaError_t err = lapha::smem_opt_in(kernel, static_cast<int>(smem), opted[cap]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + DQ_BQ - 1) / DQ_BQ, nh, B);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, kv_valid, qstart, static_cast<bf16*>(dq),
      T, S, nh, nkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// The dk/dv kernel of a head-dim pair (only that one is instantiated).
template <int DH, int DV, bool kCap>
auto dkv_kernel() {
  if constexpr (Dims<DH, DV>::kSplit) {
    return flash_bwd_dkv_split_kernel<DH, DV, kCap>;
  } else {
    return flash_bwd_dkv_kernel<DH, DV, kCap>;
  }
}

template <int DH, int DV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kv_valid, const int* qstart, void* dk, void* dv,
               int B, int T, int S, int nh, int nkv, int window, float scale, float softcap,
               cudaStream_t stream) {
  constexpr size_t smem = Dims<DH, DV>::KV_SMEM;
  const bool cap = softcap > 0.f;
  const auto kernel = cap ? dkv_kernel<DH, DV, true>() : dkv_kernel<DH, DV, false>();
  static bool opted[2][lapha::kMaxDevices] = {};
  cudaError_t err = lapha::smem_opt_in(kernel, static_cast<int>(smem), opted[cap]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + KV_BK - 1) / KV_BK, nkv, B);
  kernel<<<grid, Dims<DH, DV>::KV_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, kv_valid, qstart, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, S, nh, nkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
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

extern "C" int lapha_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* kv_valid,
                                   const int* qstart, void* dk, void* dv, int B, int T, int S,
                                   int nh, int nkv, int dh, int dv_w, int window, float scale,
                                   float softcap, void* stream) {
  if (bad_shape(B, T, S, nh, nkv, window, softcap)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define LAPHA_DKV(DH, DV)                                                                    \
  if (dh == DH && dv_w == DV)                                                                \
    return launch_dkv<DH, DV>(q, k, v, dout, lse, delta, kv_valid, qstart, dk, dv, B, T, S, nh, \
                              nkv, window, scale, softcap, st);
  LAPHA_DKV(64, 64)
  LAPHA_DKV(128, 128)
  LAPHA_DKV(256, 256)
  LAPHA_DKV(192, 128)
  LAPHA_DKV(96, 96)
#undef LAPHA_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
