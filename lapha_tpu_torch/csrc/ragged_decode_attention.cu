// Ragged one-token decode attention over the stacked bf16 cache, for Hopper.
//
// Replaces the bf16 entry of the Pallas kernel in
// lapha_tpu/ops/ragged_decode_attention.py (_kernel :68 -> _kernel_impl
// :108, called from ragged_decode_attention :270). Row b's query group
// attends only to cache slots [pstart[b], lens[b]) ∪ [dstart[b], slot] of
// layer `layer` in the (L, B, nkv, S, dh) decode cache; nothing else of the
// cache is read.
//
// What bounds it on an H100: one query token per row does 2 FLOP per byte
// of K/V read, far below the card's ~295 FLOP/byte ridge, so it is bound by
// device-memory bandwidth — the bytes of the valid slots. The design reads
// only those: each CTA (one row, one KV head) walks its two segments in
// 64-slot chunks with coalesced 16-byte loads into shared memory, and the
// segments are walked separately, so a chunk shared by the prompt tail and
// the decode start is never counted twice. The GQA group (up to 8 query
// heads) shares each K/V chunk, so the cache is read once per KV head, not
// once per query head. Simple first version: CUDA-core FMAs, f32 online
// softmax, no split of the sequence across CTAs and no prefetch of the next
// chunk; at B=24 and 2 KV heads it fills 48 of the 132 SMs, which is the
// first thing to change when it is tuned.

#include "common.cuh"

namespace {

using lapha::NEG;

constexpr int CH = 64;        // cache slots per chunk
constexpr int DH = 128;       // head dim = threads per CTA
constexpr int GMAX = 8;       // query heads per KV head
constexpr int KLDS = DH + 2;  // padded K row: thread j reads row j conflict-free

__global__ void __launch_bounds__(DH)
ragged_decode_kernel(const __nv_bfloat16* __restrict__ q,   // (B, nh, DH)
                     const __nv_bfloat16* __restrict__ kc,  // (L, B, nkv, S, DH)
                     const __nv_bfloat16* __restrict__ vc,  // (L, B, nkv, S, DH)
                     const int* __restrict__ lens, const int* __restrict__ dstart,
                     const int* __restrict__ pstart, int layer, int slot,
                     __nv_bfloat16* __restrict__ out,       // (B, nh, DH)
                     int nh, int nkv, int S, float scale) {
  __shared__ __align__(16) __nv_bfloat16 sK[CH * KLDS];
  __shared__ __align__(16) __nv_bfloat16 sV[CH * DH];
  __shared__ float sQ[GMAX * DH];
  __shared__ float sP[GMAX * CH];
  __shared__ float sAlpha[GMAX];
  __shared__ float sL[GMAX];

  const int b = blockIdx.x, hk = blockIdx.y, B = gridDim.x;
  const int G = nh / nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qg = q + (static_cast<size_t>(b) * nh + hk * G) * DH;
  for (int i = tid; i < G * DH; i += DH) sQ[i] = __bfloat162float(qg[i]) * scale;

  const size_t panel = (static_cast<size_t>(layer) * B + b) * nkv + hk;
  const __nv_bfloat16* kp = kc + panel * S * DH;
  const __nv_bfloat16* vp = vc + panel * S * DH;

  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.f;
  // softmax state of query heads warp and warp+4, held by every lane of the warp
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  // clamped to the panel, so bad lengths cannot read outside it
  const int seg_lo[2] = {max(pstart[b], 0), max(dstart[b], 0)};
  const int seg_hi[2] = {min(lens[b], S), slot + 1};
  __syncthreads();

  for (int seg = 0; seg < 2; ++seg) {
    for (int c0 = seg_lo[seg]; c0 < seg_hi[seg]; c0 += CH) {
      const int n = min(CH, seg_hi[seg] - c0);
      for (int i = tid; i < CH * (DH / 8); i += DH) {
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
      __syncthreads();

      // logits: thread -> slot j = tid % 64 and query heads gsub, gsub+2, ...
      {
        const int j = tid & (CH - 1), gsub = tid >> 6;
        float dot[GMAX / 2] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(sK + j * KLDS);
        for (int d2 = 0; d2 < DH / 2; ++d2) {
          const float2 kf = __bfloat1622float2(kr[d2]);
#pragma unroll
          for (int u = 0; u < GMAX / 2; ++u) {
            const int g = gsub + 2 * u;
            if (g < G) {
              const float2 qf = *reinterpret_cast<const float2*>(sQ + g * DH + 2 * d2);
              dot[u] = fmaf(qf.x, kf.x, fmaf(qf.y, kf.y, dot[u]));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < GMAX / 2; ++u) {
          const int g = gsub + 2 * u;
          if (g < G) sP[g * CH + j] = j < n ? dot[u] : NEG;
        }
      }
      __syncthreads();

      // online-softmax update: warp w owns query heads w and w+4
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int g = warp + 4 * i;
        if (g < G) {
          const float x0 = sP[g * CH + lane], x1 = sP[g * CH + lane + 32];
          const float m_new = fmaxf(m_run[i], lapha::warp_max(fmaxf(x0, x1)));
          const float p0 = x0 > 0.5f * NEG ? __expf(x0 - m_new) : 0.f;
          const float p1 = x1 > 0.5f * NEG ? __expf(x1 - m_new) : 0.f;
          const float sum = lapha::warp_sum(p0 + p1);
          const float alpha = __expf(m_run[i] - m_new);
          l_run[i] = l_run[i] * alpha + sum;
          m_run[i] = m_new;
          sP[g * CH + lane] = p0;
          sP[g * CH + lane + 32] = p1;
          if (lane == 0) sAlpha[g] = alpha;
        }
      }
      __syncthreads();

      // acc[g] (this thread's output dim) = acc[g]·alpha + Σ_j p[g][j]·V[j]
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] *= sAlpha[g];
      for (int jj = 0; jj < n; ++jj) {
        const float vv = __bfloat162float(sV[jj * DH + tid]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) acc[g] = fmaf(sP[g * CH + jj], vv, acc[g]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int g = warp + 4 * i;
    if (g < G && lane == 0) sL[g] = l_run[i];
  }
  __syncthreads();
  __nv_bfloat16* og = out + (static_cast<size_t>(b) * nh + hk * G) * DH;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
    if (g < G) og[g * DH + tid] = __float2bfloat16(sL[g] > 0.f ? acc[g] / sL[g] : 0.f);
}

}  // namespace

extern "C" int lapha_ragged_decode(const void* q, const void* k_cache, const void* v_cache,
                                   const int* lens, const int* dstart, const int* pstart,
                                   int layer, int slot, void* out, int B, int nh, int nkv, int S,
                                   int dh, float scale, void* stream) {
  if (dh != DH || nkv <= 0 || nh % nkv != 0 || nh / nkv > GMAX || B <= 0 || slot < 0 || slot >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, nkv);
  ragged_decode_kernel<<<grid, DH, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_cache),
      static_cast<const __nv_bfloat16*>(v_cache), lens, dstart, pstart, layer, slot,
      static_cast<__nv_bfloat16*>(out), nh, nkv, S, scale);
  return static_cast<int>(cudaGetLastError());
}
