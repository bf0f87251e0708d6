// Ragged one-token decode attention over the stacked decode cache, for Hopper.
//
// Replaces the four entries of the Pallas kernel in
// lapha_tpu/ops/ragged_decode_attention.py (called from
// ragged_decode_attention :270): the bf16 cache, _kernel :68 -> _kernel_impl
// :108, the int8 cache, _kernel_q8 :86 (template flag kQ8), and both with
// attention sinks, _kernel_sink :77 and _kernel_q8_sink :96 (flag kSink).
// Row b's
// query group attends only to cache slots [pstart[b], lens[b]) ∪
// [dstart[b], slot] of layer `layer` in the (L, B, nkv, S, dh) decode cache;
// nothing else of the cache is read.
//
// int8 cache (kQ8): K/V are int8 with one f32 scale per (layer, row, head,
// slot) in (L, B, nkv, S) planes. The values go to bf16 in shared memory
// (exact: |v| <= 127), the K scale multiplies each logit after q·k·scale,
// the softmax denominator is summed from the unscaled p, and P·V uses
// p·vs — the Pallas kernel's order (:221-222, :239-246). Its bound is the
// int8 K+V bytes of the valid slots plus their 8 bytes of scales at
// 3.35 TB/s, half the bf16 cache's bytes.
//
// Attention sinks (kSink, GPT-OSS): one learned logit per query head, an
// extra softmax column with zero value. Each query head's online softmax
// starts at m = sink, l = exp(sink - m) = 1 instead of (-1e30, 0), which is
// "the sink column was already processed" (Pallas :186-201); the sink never
// touches the accumulator. A row that sees no key gives 0 (all its mass on
// the sink). Sliding-window layers need no flag: the caller clips pstart and
// dstart to the window (Pallas module docstring), so the two segments hold
// exactly the banded slots.
//
// Logit softcap (Gemma-2; a runtime float, 0 = off): each true logit s (q·k
// times the attention scale, times the K scale on an int8 cache) becomes
// cap·tanh(s/cap) in f32 before the mask and the online softmax, as JAX's
// dense decode applies it (lapha_tpu/models/qwen2.py decode_step, dense_att);
// the Pallas kernel has none, so JAX decodes a softcapped model dense.
//
// What bounds it on an H100: one query token per row does 2 FLOP per byte
// of K/V read, far below the card's ~295 FLOP/byte ridge, so it is bound by
// device-memory bandwidth — the bytes of the valid slots. The design reads
// only those: each CTA (one row, one KV head) walks its two segments in
// 64-slot chunks with coalesced 16-byte loads into shared memory, and the
// segments are walked separately, so a chunk shared by the prompt tail and
// the decode start is never counted twice. A GQA group of up to 8 query
// heads shares each K/V chunk, so the cache is read once per KV head, not
// once per query head. A larger group (StarCoder2-3B: 24 query heads over 2
// KV heads, 12 a group; the Pallas kernel takes any group >= 8, :339-342)
// is split into ceil(G/8) blocks of equal size (12 -> 6 + 6, 9 -> 5 + 4),
// one CTA each on a third grid axis: every block rereads its KV head's
// slots, mostly from L2 when the blocks run together, and the shared memory
// stays sized for 8 heads. Simple first version: CUDA-core FMAs, f32 online
// softmax, no split of the sequence across CTAs and no prefetch of the next
// chunk; at B=24 and 2 KV heads (group <= 8) it fills 48 of the 132 SMs,
// which is the first thing to change when it is tuned. The head dim DH is a
// template parameter (64 for GPT-OSS, 96 for Phi-3, 128, 256 for Gemma):
// one thread per output dim, and NTH = DH rounded up to a whole chunk of 64
// threads, so that the logits stage's NTH/64 threads per slot and the
// softmax stage's NTH/32 warps divide the 8 heads (at DH = 96 NTH is 128
// and the last warp has no output dim in the P·V stage; DH = 64, 128 and
// 256 have NTH = DH). Shared memory is dynamic: at DH = 256 the chunk of K
// and V, the group's queries and logits take 76.6 KB.

#include "common.cuh"

namespace {

using lapha::NEG;

constexpr int CH = 64;        // cache slots per chunk
constexpr int GMAX = 8;       // query heads per CTA (a larger group takes several CTAs)

// Threads of a CTA: DH rounded up to a whole chunk.
__host__ __device__ constexpr int threads_of(int dh) { return (dh + CH - 1) / CH * CH; }

// 16 int8 values (one 16-byte load) -> 8 words of bf16 pairs, in order.
__device__ __forceinline__ void int8x16_to_bf16(const uint4& v, uint32_t (&w)[8]) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float b0 = static_cast<float>(static_cast<int8_t>(in[i] & 0xffu));
    const float b1 = static_cast<float>(static_cast<int8_t>((in[i] >> 8) & 0xffu));
    const float b2 = static_cast<float>(static_cast<int8_t>((in[i] >> 16) & 0xffu));
    const float b3 = static_cast<float>(static_cast<int8_t>(in[i] >> 24));
    w[2 * i] = lapha::pack_f32(b0, b1);
    w[2 * i + 1] = lapha::pack_f32(b2, b3);
  }
}

// Dynamic shared memory of one CTA: sK (CH x (DH+2) bf16), sV (CH x DH
// bf16), sQ (GMAX x DH f32), sP (GMAX x CH f32), sAlpha, sL (GMAX f32 each),
// sKS, sVS (CH f32 each); every region a multiple of 16 bytes.
template <int DH>
constexpr int smem_bytes() {
  return CH * (DH + 2) * 2 + CH * DH * 2 + GMAX * DH * 4 + GMAX * CH * 4 + 2 * GMAX * 4 +
         2 * CH * 4;
}

template <int DH, bool kQ8, bool kSink>
__global__ void __launch_bounds__(threads_of(DH))
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,  // (B, nh, DH)
                     const void* __restrict__ kc_,         // (L, B, nkv, S, DH) bf16 or int8
                     const void* __restrict__ vc_,
                     const float* __restrict__ ks,         // (L, B, nkv, S) scales (kQ8)
                     const float* __restrict__ vs,
                     const int* __restrict__ lens, const int* __restrict__ dstart,
                     const int* __restrict__ pstart,
                     const float* __restrict__ sinks,      // (nh,) (kSink)
                     int layer, int slot,
                     __nv_bfloat16* __restrict__ out,      // (B, nh, DH)
                     int nh, int nkv, int S, float scale, float softcap) {
  constexpr int NTH = threads_of(DH);  // threads per CTA
  constexpr int KLDS = DH + 2;       // padded K row: thread j reads row j conflict-free
  constexpr int NWARP = NTH / 32;    // warps per CTA
  constexpr int HPW = GMAX / NWARP;  // query heads whose softmax one warp owns
  constexpr int NGS = NTH / CH;      // threads per chunk slot in the logits stage
  constexpr int HPT = GMAX / NGS;    // query heads per thread in the logits stage
  static_assert(GMAX % NWARP == 0 && GMAX % NGS == 0, "whole heads per warp and per thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + CH * KLDS;
  float* sQ = reinterpret_cast<float*>(sV + CH * DH);
  float* sP = sQ + GMAX * DH;
  float* sAlpha = sP + GMAX * CH;
  float* sL = sAlpha + GMAX;
  float* sKS = sL + GMAX;  // kQ8: the chunk's K and V scales
  float* sVS = sKS + CH;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  const int b = blockIdx.x, hk = blockIdx.y, B = gridDim.x;
  // this CTA's block of the group: G query heads from h0 (gridDim.z = 1
  // for a group of at most GMAX)
  const int group = nh / nkv;
  const int gb = (group + gridDim.z - 1) / gridDim.z;
  const int G = min(gb, group - static_cast<int>(blockIdx.z) * gb);
  const int h0 = hk * group + blockIdx.z * gb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qg = q + (static_cast<size_t>(b) * nh + h0) * DH;
  for (int i = tid; i < G * DH; i += NTH) sQ[i] = __bfloat162float(qg[i]) * scale;

  const size_t panel = (static_cast<size_t>(layer) * B + b) * nkv + hk;

  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
  // softmax state of query heads warp + NWARP*i, held by every lane of the
  // warp; with sinks it starts as if the sink column were already seen
  float m_run[HPW], l_run[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + NWARP * i;
    m_run[i] = (kSink && g < G) ? sinks[h0 + g] : NEG;
    l_run[i] = (kSink && g < G) ? 1.f : 0.f;
  }

  // clamped to the panel, so bad lengths cannot read outside it
  const int seg_lo[2] = {max(pstart[b], 0), max(dstart[b], 0)};
  const int seg_hi[2] = {min(lens[b], S), slot + 1};
  __syncthreads();

  for (int seg = 0; seg < 2; ++seg) {
    for (int c0 = seg_lo[seg]; c0 < seg_hi[seg]; c0 += CH) {
      const int n = min(CH, seg_hi[seg] - c0);
      if constexpr (kQ8) {
        const int8_t* kp = static_cast<const int8_t*>(kc_) + panel * S * DH;
        const int8_t* vp = static_cast<const int8_t*>(vc_) + panel * S * DH;
        for (int i = tid; i < CH * (DH / 16); i += NTH) {
          const int r = i / (DH / 16), c = (i % (DH / 16)) * 16;
          uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
          if (r < n) {
            kk = *reinterpret_cast<const uint4*>(kp + static_cast<size_t>(c0 + r) * DH + c);
            vv = *reinterpret_cast<const uint4*>(vp + static_cast<size_t>(c0 + r) * DH + c);
          }
          uint32_t kw[8], vw[8];
          int8x16_to_bf16(kk, kw);
          int8x16_to_bf16(vv, vw);
          uint32_t* kd = reinterpret_cast<uint32_t*>(sK + r * KLDS + c);
#pragma unroll
          for (int w = 0; w < 8; ++w) kd[w] = kw[w];
          uint4* vd = reinterpret_cast<uint4*>(sV + r * DH + c);
          vd[0] = make_uint4(vw[0], vw[1], vw[2], vw[3]);
          vd[1] = make_uint4(vw[4], vw[5], vw[6], vw[7]);
        }
        if (tid < CH) {
          sKS[tid] = tid < n ? ks[panel * S + c0 + tid] : 0.f;
          sVS[tid] = tid < n ? vs[panel * S + c0 + tid] : 0.f;
        }
      } else {
        const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(kc_) + panel * S * DH;
        const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(vc_) + panel * S * DH;
        for (int i = tid; i < CH * (DH / 8); i += NTH) {
          const int r = i / (DH / 8), c = (i % (DH / 8)) * 8;
          uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
          if (r < n) {
            kk = *reinterpret_cast<const uint4*>(kp + static_cast<size_t>(c0 + r) * DH + c);
            vv = *reinterpret_cast<const uint4*>(vp + static_cast<size_t>(c0 + r) * DH + c);
          }
          // K rows are 260 B apart (4-byte aligned only): store as 32-bit words
          uint32_t* kd = reinterpret_cast<uint32_t*>(sK + r * KLDS + c);
          kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
          *reinterpret_cast<uint4*>(sV + r * DH + c) = vv;
        }
      }
      __syncthreads();

      // logits: thread -> slot j = tid % 64 and query heads gsub, gsub+NGS, ...
      {
        const int j = tid & (CH - 1), gsub = tid / CH;
        float dot[HPT];
#pragma unroll
        for (int u = 0; u < HPT; ++u) dot[u] = 0.f;
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(sK + j * KLDS);
        for (int d2 = 0; d2 < DH / 2; ++d2) {
          const float2 kf = __bfloat1622float2(kr[d2]);
#pragma unroll
          for (int u = 0; u < HPT; ++u) {
            const int g = gsub + NGS * u;
            if (g < G) {
              const float2 qf = *reinterpret_cast<const float2*>(sQ + g * DH + 2 * d2);
              dot[u] = fmaf(qf.x, kf.x, fmaf(qf.y, kf.y, dot[u]));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < HPT; ++u) {
          const int g = gsub + NGS * u;
          // kQ8: the K scale folds into the logit (q already carries `scale`);
          // the softcap applies to that true logit
          float x = kQ8 ? dot[u] * sKS[j] : dot[u];
          if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
          if (g < G) sP[g * CH + j] = j < n ? x : NEG;
        }
      }
      __syncthreads();

      // online-softmax update: warp w owns query heads w, w+NWARP, ...
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int g = warp + NWARP * i;
        if (g < G) {
          const float x0 = sP[g * CH + lane], x1 = sP[g * CH + lane + 32];
          const float m_new = fmaxf(m_run[i], lapha::warp_max(fmaxf(x0, x1)));
          const float p0 = x0 > 0.5f * NEG ? __expf(x0 - m_new) : 0.f;
          const float p1 = x1 > 0.5f * NEG ? __expf(x1 - m_new) : 0.f;
          const float sum = lapha::warp_sum(p0 + p1);
          const float alpha = __expf(m_run[i] - m_new);
          l_run[i] = l_run[i] * alpha + sum;
          m_run[i] = m_new;
          // kQ8: the V scale folds into p after the denominator is summed
          sP[g * CH + lane] = kQ8 ? p0 * sVS[lane] : p0;
          sP[g * CH + lane + 32] = kQ8 ? p1 * sVS[lane + 32] : p1;
          if (lane == 0) sAlpha[g] = alpha;
        }
      }
      __syncthreads();

      // acc[g] (this thread's output dim) = acc[g]·alpha + Σ_j p[g][j]·V[j]
      if (NTH == DH || tid < DH) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g] *= sAlpha[g];
        for (int jj = 0; jj < n; ++jj) {
          const float vv = __bfloat162float(sV[jj * DH + tid]);
#pragma unroll
          for (int g = 0; g < GMAX; ++g)
            if (g < G) acc[g] = fmaf(sP[g * CH + jj], vv, acc[g]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + NWARP * i;
    if (g < G && lane == 0) sL[g] = l_run[i];
  }
  __syncthreads();
  if (NTH != DH && tid >= DH) return;
  __nv_bfloat16* og = out + (static_cast<size_t>(b) * nh + h0) * DH;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) og[g * DH + tid] = __float2bfloat16(sL[g] > 0.f ? acc[g] / sL[g] : 0.f);
}

template <int DH, bool kQ8, bool kSink>
int launch_dh(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
              const float* v_scale, const int* lens, const int* dstart, const int* pstart,
              const float* sinks, int layer, int slot, void* out, int B, int nh, int nkv, int S,
              float scale, float softcap, void* stream) {
  constexpr int smem = smem_bytes<DH>();
  static bool opted_in[lapha::kMaxDevices] = {};
  const cudaError_t opt_in =
      lapha::smem_opt_in(ragged_decode_kernel<DH, kQ8, kSink>, smem, opted_in);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int group = nh / nkv;
  const dim3 grid(B, nkv, (group + GMAX - 1) / GMAX);  // blocks of at most GMAX heads
  ragged_decode_kernel<DH, kQ8, kSink>
      <<<grid, threads_of(DH), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k_cache, v_cache, k_scale, v_scale, lens, dstart,
      pstart, sinks, layer, slot, static_cast<__nv_bfloat16*>(out), nh, nkv, S, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool kQ8, bool kSink>
int launch(const void* q, const void* k_cache, const void* v_cache, const float* k_scale,
           const float* v_scale, const int* lens, const int* dstart, const int* pstart,
           const float* sinks, int layer, int slot, void* out, int B, int nh, int nkv, int S,
           int dh, float scale, float softcap, void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || B <= 0 || slot < 0 || slot >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 64:
      return launch_dh<64, kQ8, kSink>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart,
                                       pstart, sinks, layer, slot, out, B, nh, nkv, S, scale,
                                       softcap, stream);
    case 96:
      return launch_dh<96, kQ8, kSink>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart,
                                       pstart, sinks, layer, slot, out, B, nh, nkv, S, scale,
                                       softcap, stream);
    case 128:
      return launch_dh<128, kQ8, kSink>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart,
                                        pstart, sinks, layer, slot, out, B, nh, nkv, S, scale,
                                        softcap, stream);
    case 256:
      return launch_dh<256, kQ8, kSink>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart,
                                        pstart, sinks, layer, slot, out, B, nh, nkv, S, scale,
                                        softcap, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int lapha_ragged_decode(const void* q, const void* k_cache, const void* v_cache,
                                   const int* lens, const int* dstart, const int* pstart,
                                   int layer, int slot, void* out, int B, int nh, int nkv, int S,
                                   int dh, float scale, float softcap, void* stream) {
  return launch<false, false>(q, k_cache, v_cache, nullptr, nullptr, lens, dstart, pstart,
                              nullptr, layer, slot, out, B, nh, nkv, S, dh, scale, softcap, stream);
}

extern "C" int lapha_ragged_decode_q8(const void* q, const void* k_cache, const void* v_cache,
                                      const float* k_scale, const float* v_scale,
                                      const int* lens, const int* dstart, const int* pstart,
                                      int layer, int slot, void* out, int B, int nh, int nkv,
                                      int S, int dh, float scale, float softcap, void* stream) {
  return launch<true, false>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart, pstart,
                             nullptr, layer, slot, out, B, nh, nkv, S, dh, scale, softcap, stream);
}

// sinks: (nh,) f32 sink logits, one per query head
extern "C" int lapha_ragged_decode_sink(const void* q, const void* k_cache, const void* v_cache,
                                        const int* lens, const int* dstart, const int* pstart,
                                        const float* sinks, int layer, int slot, void* out,
                                        int B, int nh, int nkv, int S, int dh, float scale,
                                        float softcap, void* stream) {
  return launch<false, true>(q, k_cache, v_cache, nullptr, nullptr, lens, dstart, pstart, sinks,
                             layer, slot, out, B, nh, nkv, S, dh, scale, softcap, stream);
}

extern "C" int lapha_ragged_decode_q8_sink(const void* q, const void* k_cache,
                                           const void* v_cache, const float* k_scale,
                                           const float* v_scale, const int* lens,
                                           const int* dstart, const int* pstart,
                                           const float* sinks, int layer, int slot, void* out,
                                           int B, int nh, int nkv, int S, int dh, float scale,
                                           float softcap, void* stream) {
  return launch<true, true>(q, k_cache, v_cache, k_scale, v_scale, lens, dstart, pstart, sinks,
                            layer, slot, out, B, nh, nkv, S, dh, scale, softcap, stream);
}
