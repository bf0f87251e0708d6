// T-token verify attention of speculative decoding over the decode cache, for
// Hopper.
//
// Replaces no Pallas kernel. The JAX package computes this function dense,
// with XLA einsums (lapha_tpu/models/qwen2.py:1878-1912, inside
// decode_step_multi); it was added because the port runs decode attention on
// the card through a kernel, and neither of its attention kernels takes this
// validity: rejected drafts leave permanent holes in a row's decode columns,
// so what a row may read is a per-row bitmap `valid_map` (B, S), not the two
// ranges of the ragged decode kernel (K4/K5), and K3 reads the prefill layout,
// no int8 cache and bands by column, which the holes break.
//
// Query t (0 <= t < T) of row b sits at position positions[b, t] and sees
// column j of layer `layer` in the (L, B, nkv, S, dh) decode cache iff
//     valid_map[b, j]  or  slot <= j <= slot + t
// (the row's stored columns, then the block's new columns causally), and,
// with window W > 0, also pos_col[b, j] > positions[b, t] - W, where pos_col
// is pos_map except that the new columns [slot, slot + T) take
// positions[b, j - slot] (qwen2.py:1814-1830). The logit is the true one:
// q.k times the attention scale and, on an int8 cache, the K scale; the
// softcap (Gemma-2) caps it before the mask; GPT-OSS's sinks are an extra
// softmax column of zero value, folded in once at the end; an int8 cache's V
// scale multiplies the probabilities. A query that sees nothing gives 0.
//
// What bounds it on an H100: each K/V column read serves group·T queries,
// about 2·group·T FLOP a byte (48 at Qwen2.5's group of 6 and T = 4), far
// below the card's ~295 FLOP/byte ridge, so it is bound by the bytes of the
// columns it reads at 3.35 TB/s. The design is kept simple:
//
// 1. The grid is (m-tiles, nkv, B): a CTA takes one KV head of one row and
//    16 of its group·T query rows (row r = t·group + h), so the whole query
//    block of a KV head reads its columns once when group·T <= 16 (two or
//    three m-tiles at Qwen2.5's or StarCoder2's T = 4, whose rereads of the
//    panel come from L2 when the CTAs of one head run together).
// 2. First the CTA marks the 64-column chunks of the row that hold a valid
//    bit or a new column; it walks only those, through a two-stage ring of
//    16-byte cp.async copies (K rows, V rows and, for int8, the chunk's K and
//    V scales). Unwritten columns past the block and the prompt's padding
//    are never read.
// 3. Each of the 4 warps takes 16 columns of a chunk and runs its own online
//    softmax: mma.sync m16n8k16 with the 16 query rows on M, S = Q·Kᵀ over
//    two 8-column n-tiles, and O += P·V with P's A fragment taken straight
//    from S's accumulators (FlashAttention-2's register reuse). The mask is
//    applied per element from valid_map and the positions, read from global
//    memory (a few bytes a lane a chunk). An int8 cache is converted in
//    registers (its values are exact in bf16), the K scale multiplies the
//    logits and the V scale p, which enters P·V as two bf16 terms, its
//    rounding and the rest, as the ragged decode kernel's int8 path does.
// 4. The 4 warps' (max, sum, accumulator) are merged in shared memory in warp
//    order, the sink folded in once, and the CTA writes its 16 rows. Fixed
//    order everywhere: two launches give the same bits.
//
// No split of a row's columns over CTAs, no TMA and no warp specialisation:
// at T = 1 the grid is only B·nkv CTAs. Making it fast is later work.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace lapha;
using bf16 = __nv_bfloat16;

constexpr int NW = 4;          // warps a CTA
constexpr int NTH = 32 * NW;   // threads a CTA
constexpr int CH = 64;         // columns a chunk: 16 a warp
constexpr int QR = 16;         // query rows a CTA: the mma's M
constexpr int SMEM_LIMIT = 227 * 1024;

template <int DH, bool kQ8>
struct Layout {
  static constexpr int ESZ = kQ8 ? 1 : 2;
  // a cache row in shared memory, padded by 16 bytes so that the 8 rows one
  // fragment load touches fall on distinct banks
  static constexpr int ROW = DH * ESZ + 16;
  static constexpr int KV = CH * ROW;
  static constexpr int STAGE = 2 * KV + (kQ8 ? 2 * CH * 4 : 0);
  static constexpr int QROW = 2 * DH + 16;                 // a Q row (bf16)
  static constexpr int QT = QR * QROW;
  static constexpr int LDA = DH + 4;                       // the merge's f32 rows
  static constexpr int MERGE = (NW * QR * LDA + 2 * NW * QR) * 4;
  static constexpr int RING = 2 * STAGE > MERGE ? 2 * STAGE : MERGE;
  // Q tile, ring (or the merge), then the chunk list: one int a chunk + a count
  static int smem(int chunks) { return QT + RING + (chunks + 1) * 4; }
};

// int8 bytes of r as f32, exactly (the ragged decode kernel's conversion): r ^
// 0x80808080 holds v + 128 a byte; a byte permute puts it under the exponent
// of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ float i8_at(uint32_t u, int k) {
  return __uint_as_float(__byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7540 + k)) - 8388736.f;
}

// Two int8 at byte offsets `lo` and `hi` of a shared row -> one bf16 pair.
__device__ __forceinline__ uint32_t i8_pair(const unsigned char* lo, const unsigned char* hi) {
  const uint32_t u = static_cast<uint32_t>(*lo) | (static_cast<uint32_t>(*hi) << 8);
  return pack_f32(i8_at(u, 0), i8_at(u, 1));
}

__device__ __forceinline__ uint32_t bf16_pair(const unsigned char* lo, const unsigned char* hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

template <int DH, bool kQ8, bool kSink>
__global__ void __launch_bounds__(NTH)
spec_verify_kernel(const bf16* __restrict__ q,                 // (B, T, nh, DH)
                   const void* __restrict__ kc_,               // (L, B, nkv, S, DH)
                   const void* __restrict__ vc_,
                   const float* __restrict__ ks,               // (L, B, nkv, S) (kQ8)
                   const float* __restrict__ vs,
                   const unsigned char* __restrict__ valid_map,  // (B, S) bool bytes
                   const int* __restrict__ positions,          // (B, T)
                   const int* __restrict__ pos_map,            // (B, S) (window > 0)
                   const float* __restrict__ sinks,            // (nh,) (kSink)
                   int layer, int slot, int T, int window,
                   bf16* __restrict__ out,                     // (B, T, nh, DH)
                   int nh, int nkv, int S, float scale, float softcap) {
  using Lay = Layout<DH, kQ8>;
  constexpr int ESZ = Lay::ESZ, ROW = Lay::ROW, KS = DH / 16, ND = DH / 8;
  constexpr int UPR = DH * ESZ / 16;  // 16-byte units of a cache row
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* ring = smem + Lay::QT;
  int* list = reinterpret_cast<int*>(ring + Lay::RING);

  const int group = nh / nkv, QTOT = group * T;
  const int mt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int chunks = (S + CH - 1) / CH;
  const unsigned char* vrow = valid_map + static_cast<size_t>(b) * S;

  // Q's 16 rows (zeros past the block), row r = query t = (16mt + r) / group
  // of head hk·group + (16mt + r) % group
  for (int u = tid; u < QR * (DH / 8); u += NTH) {
    const int r = u / (DH / 8), c = u % (DH / 8), gr = QR * mt + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < QTOT) {
      const int t = gr / group, h = gr % group;
      val = reinterpret_cast<const uint4*>(
          q + ((static_cast<size_t>(b) * T + t) * nh + hk * group + h) * DH)[c];
    }
    *reinterpret_cast<uint4*>(qs + r * Lay::QROW + c * 16) = val;
  }
  // the chunks with a valid bit or a new column: flags, then the list
  for (int c = warp; c < chunks; c += NW) {
    const int j0 = c * CH + 2 * lane;
    bool live = false;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + e;
      live |= j < S && (vrow[j] != 0 || (j >= slot && j < slot + T));
    }
    live = __any_sync(0xffffffffu, live);
    if (lane == 0) list[c] = live ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int c = 0; c < chunks; ++c)
      if (list[c]) list[n++] = c;
    list[chunks] = n;
  }
  __syncthreads();
  const int nlive = list[chunks];

  const size_t panel = (static_cast<size_t>(layer) * B + b) * nkv + hk;
  const unsigned char* kbase = static_cast<const unsigned char*>(kc_) + panel * S * DH * ESZ;
  const unsigned char* vbase = static_cast<const unsigned char*>(vc_) + panel * S * DH * ESZ;

  // chunk list[i] into ring stage i % 2: K rows, V rows, (kQ8) K and V scales
  auto issue = [&](int i) {
    unsigned char* sk = ring + (i & 1) * Lay::STAGE;
    unsigned char* sv = sk + Lay::KV;
    const int c0 = list[i] * CH;
    for (int u = tid; u < CH * UPR; u += NTH) {
      const int r = u / UPR, c = u % UPR, j = c0 + r;
      const bool ok = j < S;
      const size_t off = ok ? static_cast<size_t>(j) * DH * ESZ + c * 16 : 0;
      cp_async16(sk + r * ROW + c * 16, kbase + off, ok);
      cp_async16(sv + r * ROW + c * 16, vbase + off, ok);
    }
    if constexpr (kQ8) {
      const int r = tid & (CH - 1), j = c0 + r;
      const bool ok = j < S;
      float* dst = reinterpret_cast<float*>(sv + Lay::KV) + tid;  // ks[64], then vs[64]
      cp_async4(dst, (tid < CH ? ks : vs) + panel * S + (ok ? j : 0), ok);
    }
  };

  // this lane's query rows g and g + 8: their query index t, whether they are
  // real rows, and their positions
  int t_r[2], qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = QR * mt + g + 8 * i;
    row_ok[i] = gr < QTOT;
    t_r[i] = row_ok[i] ? gr / group : 0;
    qpos[i] = positions[static_cast<size_t>(b) * T + t_r[i]];
  }
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  if (nlive > 0) issue(0);
  cp_async_commit();
#pragma unroll 1
  for (int i = 0; i < nlive; ++i) {
    if (i + 1 < nlive) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* sk = ring + (i & 1) * Lay::STAGE + warp * 16 * ROW;  // this warp's 16 rows
    const unsigned char* sv = sk + Lay::KV;
    const float* sks = reinterpret_cast<const float*>(ring + (i & 1) * Lay::STAGE + 2 * Lay::KV);
    const float* svs = sks + CH;
    const int jw = list[i] * CH + 16 * warp;  // the warp's first column

    // S (16 query rows x 16 columns, two n-tiles) = Q · Kᵀ
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      const unsigned char* qa = qs + g * Lay::QROW + (16 * kk + 2 * t4) * 2;
      a[0] = *reinterpret_cast<const uint32_t*>(qa);
      a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * Lay::QROW);
      a[2] = *reinterpret_cast<const uint32_t*>(qa + 16);
      a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * Lay::QROW + 16);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // B (k = dims, n = columns): column 8nt + g, dims 16kk + 2t4 (+1), + 8
        const unsigned char* kr = sk + (8 * nt + g) * ROW + (16 * kk + 2 * t4) * ESZ;
        uint32_t b0, b1;
        if constexpr (kQ8) {
          b0 = i8_pair(kr, kr + 1);
          b1 = i8_pair(kr + 8, kr + 9);
        } else {
          b0 = *reinterpret_cast<const uint32_t*>(kr);
          b1 = *reinterpret_cast<const uint32_t*>(kr + 16);
        }
        mma_bf16_16816(s[nt], a, b0, b1);
      }
    }

    // true logits, the mask, this piece's max of each row
    bool vis[2][4];
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1, cl = 8 * nt + 2 * t4 + (e & 1), j = jw + cl;
        float x = s[nt][e] * scale;
        if constexpr (kQ8) x *= sks[16 * warp + cl];
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        bool ok = row_ok[ri] && j < S &&
                  (vrow[j] != 0 || (j >= slot && j <= slot + t_r[ri]));
        if (ok && window > 0) {
          const int pc = (j >= slot && j < slot + T)
                             ? positions[static_cast<size_t>(b) * T + (j - slot)]
                             : pos_map[static_cast<size_t>(b) * S + j];
          ok = pc > qpos[ri] - window;
        }
        vis[nt][e] = ok;
        s[nt][e] = x;
        if (ok) mx[ri] = fmaxf(mx[ri], x);
      }
    float alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float m = fmaxf(mx[ri], __shfl_xor_sync(0xffffffffu, mx[ri], 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(m_run[ri], m);
      alpha[ri] = __expf(m_run[ri] - m_new);
      m_run[ri] = m_new;
      l_run[ri] *= alpha[ri];
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
    // p = exp(s - m) where visible; l sums the unscaled p, P·V takes p·vs
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const float p = vis[nt][e] ? __expf(s[nt][e] - m_run[ri]) : 0.f;
        l_run[ri] += p;
        if constexpr (kQ8) {
          s[nt][e] = p * svs[16 * warp + 8 * nt + 2 * t4 + (e & 1)];
        } else {
          s[nt][e] = p;
        }
      }
    uint32_t pa[4];
    a_from_d(pa, s[0], s[1]);
    uint32_t pl[4];  // (kQ8) p·vs less its bf16 rounding
    if constexpr (kQ8) {
      float lo[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lo[nt][e] = s[nt][e] - __bfloat162float(__float2bfloat16_rn(s[nt][e]));
      a_from_d(pl, lo[0], lo[1]);
    }
    // O += P · V: B (k = columns, n = dims): columns 2t4 (+1) and 2t4 + 8 (+9), dim 8nd + g
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const unsigned char* v0 = sv + (2 * t4) * ROW + (8 * nd + g) * ESZ;
      uint32_t b0, b1;
      if constexpr (kQ8) {
        b0 = i8_pair(v0, v0 + ROW);
        b1 = i8_pair(v0 + 8 * ROW, v0 + 9 * ROW);
      } else {
        b0 = bf16_pair(v0, v0 + ROW);
        b1 = bf16_pair(v0 + 8 * ROW, v0 + 9 * ROW);
      }
      mma_bf16_16816(acc[nd], pa, b0, b1);
      if constexpr (kQ8) mma_bf16_16816(acc[nd], pl, b0, b1);
    }
    __syncthreads();  // the stage is refilled next
  }
  cp_async_wait<0>();

  // merge the warps in order: (m, l) a row, the accumulators in the ring's place
  float* macc = reinterpret_cast<float*>(ring);            // NW x 16 x LDA
  float* mm = macc + NW * QR * Lay::LDA;                   // NW x 16
  float* ml = mm + NW * QR;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float l = l_run[ri];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t4 == 0) {
      mm[warp * QR + g + 8 * ri] = m_run[ri];
      ml[warp * QR + g + 8 * ri] = l;
    }
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      macc[(warp * QR + g + 8 * (e >> 1)) * Lay::LDA + 8 * nd + 2 * t4 + (e & 1)] = acc[nd][e];
  __syncthreads();
  for (int u = tid; u < QR * DH; u += NTH) {
    const int r = u / DH, d = u % DH, gr = QR * mt + r;
    if (gr >= QTOT) continue;
    const int t = gr / group, h = hk * group + gr % group;
    float m = NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) m = fmaxf(m, mm[w * QR + r]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = __expf(mm[w * QR + r] - m);
      l += ml[w * QR + r] * f;
      o += macc[(w * QR + r) * Lay::LDA + d] * f;
    }
    if constexpr (kSink) {
      const float sk = sinks[h], m2 = fmaxf(m, sk), f = __expf(m - m2);
      l = l * f + __expf(sk - m2);
      o *= f;
    }
    out[((static_cast<size_t>(b) * T + t) * nh + h) * DH + d] =
        __float2bfloat16_rn(l > 0.f ? o / l : 0.f);
  }
}

template <int DH, bool kQ8, bool kSink>
int launch_inst(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
                const float* v_scale, const unsigned char* valid_map, const int* positions,
                const int* pos_map, const float* sinks, int layer, int slot, int T, int window,
                void* out, int B, int nh, int nkv, int S, float scale, float softcap,
                cudaStream_t stream) {
  using Lay = Layout<DH, kQ8>;
  auto kernel = spec_verify_kernel<DH, kQ8, kSink>;
  const int chunks = (S + CH - 1) / CH;
  const int smem = Lay::smem(chunks);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in[kMaxDevices] = {};
  const cudaError_t opt_in = smem_opt_in(kernel, SMEM_LIMIT, opted_in);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int mtiles = (nh / nkv * T + QR - 1) / QR;
  kernel<<<dim3(mtiles, nkv, B), NTH, smem, stream>>>(
      static_cast<const bf16*>(q), k_cache, v_cache, k_scale, v_scale, valid_map, positions,
      pos_map, sinks, layer, slot, T, window, static_cast<bf16*>(out), nh, nkv, S, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kQ8, bool kSink>
int launch(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
           const float* v_scale, const void* valid_map, const int* positions, const int* pos_map,
           const float* sinks, int layer, int slot, int T, int window, void* out, int B, int nh,
           int nkv, int S, int dh, float scale, float softcap, void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || B <= 0 || B > 65535 || T < 1 || slot < 0 || slot + T > S ||
      window < 0 || (window > 0 && pos_map == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* vm = static_cast<const unsigned char*>(valid_map);
#define LAPHA_SV(DH)                                                                           \
  if (dh == DH)                                                                                \
    return launch_inst<DH, kQ8, kSink>(q, k_cache, v_cache, k_scale, v_scale, vm, positions,   \
                                       pos_map, sinks, layer, slot, T, window, out, B, nh,     \
                                       nkv, S, scale, softcap, st);
  LAPHA_SV(64)
  LAPHA_SV(96)
  LAPHA_SV(128)
  LAPHA_SV(256)
#undef LAPHA_SV
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, T, nh, dh) bf16; k_cache, v_cache (L, B, nkv, S, dh) bf16 (or int8 with
// the (L, B, nkv, S) f32 scales); valid_map (B, S) one byte a column;
// positions (B, T) and pos_map (B, S) int32 (pos_map may be null when window
// is 0); out (B, T, nh, dh) bf16. The softcap is the last float (0 = off).
extern "C" int lapha_spec_verify(const void* q, const void* k_cache, const void* v_cache,
                                 const void* valid_map, const int* positions, const int* pos_map,
                                 int layer, int slot, int T, int window, void* out, int B, int nh,
                                 int nkv, int S, int dh, float scale, float softcap,
                                 void* stream) {
  return launch<false, false>(q, k_cache, v_cache, nullptr, nullptr, valid_map, positions,
                              pos_map, nullptr, layer, slot, T, window, out, B, nh, nkv, S, dh,
                              scale, softcap, stream);
}

extern "C" int lapha_spec_verify_q8(const void* q, const void* k_cache, const void* v_cache,
                                    const float* k_scale, const float* v_scale,
                                    const void* valid_map, const int* positions,
                                    const int* pos_map, int layer, int slot, int T, int window,
                                    void* out, int B, int nh, int nkv, int S, int dh, float scale,
                                    float softcap, void* stream) {
  return launch<true, false>(q, k_cache, v_cache, k_scale, v_scale, valid_map, positions,
                             pos_map, nullptr, layer, slot, T, window, out, B, nh, nkv, S, dh,
                             scale, softcap, stream);
}

// sinks: (nh,) f32 sink logits, one per query head
extern "C" int lapha_spec_verify_sink(const void* q, const void* k_cache, const void* v_cache,
                                      const void* valid_map, const int* positions,
                                      const int* pos_map, const float* sinks, int layer,
                                      int slot, int T, int window, void* out, int B, int nh,
                                      int nkv, int S, int dh, float scale, float softcap,
                                      void* stream) {
  return launch<false, true>(q, k_cache, v_cache, nullptr, nullptr, valid_map, positions,
                             pos_map, sinks, layer, slot, T, window, out, B, nh, nkv, S, dh,
                             scale, softcap, stream);
}

extern "C" int lapha_spec_verify_q8_sink(const void* q, const void* k_cache, const void* v_cache,
                                         const float* k_scale, const float* v_scale,
                                         const void* valid_map, const int* positions,
                                         const int* pos_map, const float* sinks, int layer,
                                         int slot, int T, int window, void* out, int B, int nh,
                                         int nkv, int S, int dh, float scale, float softcap,
                                         void* stream) {
  return launch<true, true>(q, k_cache, v_cache, k_scale, v_scale, valid_map, positions,
                            pos_map, sinks, layer, slot, T, window, out, B, nh, nkv, S, dh,
                            scale, softcap, stream);
}
