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
// outside the kernel from its LSE, as in JAX. The head dims of Q/K (DH) and
// of V and the output (DV) are template parameters, instantiated for (64,
// 64) (GPT-OSS), (96, 96) (Phi-3), (128, 128), (192, 128) (DeepSeek MLA:
// the scores on the 192-wide nope + rope Q/K, the combine on the 128-wide
// V, as the Pallas kernels take a V narrower than Q/K, :50-53 and :441)
// and (256, 256) (Gemma).
//
// What bounds it on an H100: at the prefill shapes (T=512, S=640, dh=128,
// 12 query heads over 2 KV heads) the work is ~2·T·S·dh·2 FLOP per head
// against ~(T+2S)·dh·2 bytes per head, well above the card's ~295 FLOP/byte
// ridge, so it is bound by matrix-multiply throughput; at the port's
// shapes (a few µs of tensor-core work) by keeping the card busy and each
// CTA's tiles in flight. The design keeps the T×S logits out of device
// memory (online softmax, f32 m/l/O in registers), maps query head h to KV
// head h / (nh/nkv) (no repeated K/V in memory), and walks key tiles only
// from the first tile of the CTA's band (windowed layers, the Pallas
// kernels' kb_start :91-93, :436-437) up to its last row's causal frontier
// qstart + t: tiles outside the band are skipped, not masked, so a banded
// row reads O(W) keys.
//
// A CTA takes 128 query rows of one head: two consumer warpgroups of 64
// rows (256 threads). Q comes in once by TMA; K and V tiles of 64 keys come
// through a TMA ring with mbarriers (3 stages; 2 at dh 256), issued by
// thread 0 of a consumer (a separate producer warp made ptxas cap K2's
// kernels at 168 registers and spill). S = Q·Kᵀ is a wgmma with both
// operands in shared memory; the online softmax runs in the accumulator's
// register layout, in base 2; P goes to bf16 in registers as the A operand
// of O += P·V, V read MN-major. A warpgroup computes only the run of tiles
// that some row of its strip sees, and within it S of tile j and P·V of
// tile j-1 are issued together, so that tile j's softmax runs while P·V is
// on the tensor cores (FlashAttention-3's intra-warpgroup overlap); only the
// rescale of O waits for it. Only the tiles that need it are masked: the
// diagonal tiles, the band's edge, and any tile with a key that is invalid
// or past S (each warp reads the tile's 64 kv_valid entries once and
// votes); interior tiles skip the per-element mask. Causal CTAs launch
// longest first (the last query block, which sees the most keys, on the
// first blocks). Head dims that are not multiples of 64 ride in 64-column
// boxes that TMA zero-fills (96 -> 128); 192/128 takes three Q/K boxes and
// two V boxes; at dh 256 the O accumulator is 128 registers a thread and
// a stage 64 KB. At dh 64 without the softcap two CTAs share an SM.

#include "attention_wg.cuh"

namespace {

using lapha::NEG;
using bf16 = __nv_bfloat16;
namespace at = lapha::attn;

constexpr int WG_ROWS = 64;       // a consumer's query strip; a key tile's rows
constexpr int WG_CTA_ROWS = 128;  // a CTA's queries
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DH, int DV>
struct FwdWg {
  static_assert(DV <= DH && DV % 16 == 0 && DH % 16 == 0, "V may be narrower than Q/K");
  static constexpr int NBQ = at::boxes(DH);  // boxes across Q/K's head dim
  static constexpr int NBV = at::boxes(DV);  // ... and V's
  static constexpr int DVP = 64 * NBV;       // V's head dim padded to whole boxes
  static constexpr int KS = DH / 16;         // k16 steps of Q·Kᵀ
  static constexpr int NO = DVP / 2;         // f32 a thread of the 64 x DVP output
  static constexpr int QT = NBQ * at::box_bytes<WG_ROWS>();  // a 64-row Q or K tile
  static constexpr int VT = NBV * at::box_bytes<WG_ROWS>();  // a 64-row V tile
  static constexpr int NST = DV > 128 ? 2 : 3;               // ring depth
  // resident Q of both strips, then the ring's stages (a K tile and a V tile)
  static constexpr int TILES = 2 * QT + NST * (QT + VT);
};

// One key tile's softmax for a thread's two rows: the scaled (capped)
// logits in base 2, set to -1e30 where not visible when kMask (a tile that
// is not interior), the running max m and sum l updated; s becomes P (0
// exactly where not visible) and alpha the factor that rescales what the
// output accumulated before this tile.
template <bool kMask, bool kCap>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float scale2, float cap_in,
                                             float cap_out, int k0, int t4, const int (&qpos)[2],
                                             const int* vrow, int S, int window) {
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int rr = (i >> 1) & 1;
    // base 2: log2(e)·(scale·s), or log2(e)·cap·tanh(scale·s / cap)
    float x = kCap ? cap_out * tanhf(s[i] * cap_in) : s[i] * scale2;
    if constexpr (kMask) {
      const int j = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      const bool vis = j < S && __ldg(vrow + j) != 0 && j <= qpos[rr] &&
                       (window <= 0 || j > qpos[rr] - window);
      x = vis ? x : NEG;
    }
    s[i] = x;
    mx[rr] = fmaxf(mx[rr], x);
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(m[rr], mx[rr]);
    alpha[rr] = at::exp2_approx(m[rr] - m_new);
    m[rr] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int rr = (i >> 1) & 1;
    const float p = !kMask || s[i] > 0.5f * NEG ? at::exp2_approx(s[i] - m[rr]) : 0.f;
    s[i] = p;
    rs[rr] += p;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + rs[rr];
}

// CTA (query head, batch row) on grid.x, 128-query block on grid.y in
// reverse. Consumer warpgroup w owns queries q0 + 64w.. and computes the
// run of the CTA's key tiles that some row of its strip sees, releasing the
// others unread: S = Q·Kᵀ (both from shared memory), the softmax in
// registers, O += P·V with P from registers and V the stage's tile,
// MN-major. The products overlap the softmax (FlashAttention-3's
// intra-warpgroup pipelining): tile j's S and tile j-1's P·V are issued
// together, and tile j's softmax runs while P·V is still on the tensor
// cores; only the rescale of O waits for it. The run is a prologue, a loop
// and an epilogue with no branch around a wgmma, and the warpgroup's index
// is shuffled from lane 0: otherwise ptxas cannot see the products issued
// uniformly and serialises them (its warning C7520; 7-17% slower). Two CTAs
// an SM at dh 64 (66 KB of shared memory each, 128 registers a thread), but
// with the softcap, whose tanh would spill at 128.
template <int DH, int DV, bool kCap>
__global__ void __launch_bounds__(at::THREADS, DH <= 64 && !kCap ? 2 : 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const int* __restrict__ kv_valid,  // (B, S)
                    const int* __restrict__ qstart,    // (B,)
                    bf16* __restrict__ out,            // (B, T, nh, DV)
                    float* __restrict__ lse,           // (B, nh, T)
                    int T, int S, int nh, int nkv, int window, float scale, float softcap) {
  using F = FwdWg<DH, DV>;
  at::Bars<F::NST>* bars;
  uint8_t* sQ = at::ring_smem<F::NST>(F::TILES, bars);  // [strip] Q tiles
  uint8_t* ring = sQ + 2 * F::QT;                        // [stage]: K tile, V tile

  // the warpgroup (its 64-row strip), shuffled from lane 0 so that the
  // compiler sees it uniform over the warp and keeps the wgmma unserialised
  const int tid = threadIdx.x, wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  const int h = blockIdx.x % nh, b = blockIdx.x / nh, hk = h / (nh / nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_CTA_ROWS;
  const int qs = qstart[b];
  // key tiles from the band's start to the causal frontier of the last row
  const int last_row = min(q0 + WG_CTA_ROWS, T) - 1;
  const int kend = min(S, qs + last_row + 1);
  const int nkb = kend <= 0 ? 0 : (kend + WG_ROWS - 1) / WG_ROWS;
  const int kb0 = window > 0 ? max(qs + q0 - (window - 1), 0) / WG_ROWS : 0;
  const int n_items = max(0, nkb - kb0);

  auto issue = [&](int it) {  // key tile it's K and V into stage it % NST
    uint64_t* full = &bars->full[it % F::NST];
    uint8_t* st = ring + (it % F::NST) * (F::QT + F::VT);
    lapha::mbar_expect_tx(full, F::QT + F::VT);
    at::tma_tile<F::NBQ, WG_ROWS>(st, &map_k, full, hk, (kb0 + it) * WG_ROWS, b);
    at::tma_tile<F::NBV, WG_ROWS>(st + F::QT, &map_v, full, hk, (kb0 + it) * WG_ROWS, b);
  };
  // thread 0, once its warpgroup released item it - 1: item it + NST - 1
  // into the stage item it - 1 held, once the other warpgroup released it
  // too (it is called once for each item, in order)
  auto refill = [&](int it) {
    const int pf = it + F::NST - 1;
    if (tid == 0 && pf < n_items) {
      lapha::mbar_wait(&bars->empty[pf % F::NST], ((pf / F::NST) & 1) ^ 1);
      issue(pf);
    }
  };
  // the strips that hold a query row (a strip past T is not loaded)
  const int strips = q0 + WG_ROWS < T ? 2 : 1;
  if (tid == 0) {
    lapha::mbar_expect_tx(&bars->res, strips * F::QT);
    for (int s = 0; s < strips; ++s)
      at::tma_tile<F::NBQ, WG_ROWS>(sQ + s * F::QT, &map_q, &bars->res, h, q0 + s * WG_ROWS, b);
    for (int it = 0; it < min(F::NST - 1, n_items); ++it) issue(it);
  }

  const int t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = q0 + wg * WG_ROWS;         // the strip's first query
  const int s1 = min(s0 + WG_ROWS, T) - 1;  // ... and last (s1 < s0: none)
  const int row[2] = {s0 + warp * 16 + g, s0 + warp * 16 + g + 8};
  const int qpos[2] = {qs + row[0], qs + row[1]};
  const uint32_t aQ = lapha::smem_addr(sQ + wg * F::QT);
  const int* vrow = kv_valid + static_cast<size_t>(b) * S;
  // base-2 logits: log2(e)·scale·s, or log2(e)·cap·tanh(s·scale/cap)
  const float scale2 = scale * LOG2E;
  const float cap_in = kCap ? scale / softcap : 0.f, cap_out = softcap * LOG2E;
  auto k_addr = [&](int it) {  // item it's stage: its K tile, then its V tile
    return lapha::smem_addr(ring + (it % F::NST) * (F::QT + F::VT));
  };
  auto landed = [&](int it) {  // item it's tiles are in shared memory
    lapha::mbar_wait(&bars->full[it % F::NST], (it / F::NST) & 1);
  };
  auto release = [&](int it) {
    if (t128 == 0) lapha::mbar_arrive(&bars->empty[it % F::NST]);
  };
  // key tile it's softmax: the per-element mask unless the tile is interior
  // (every key valid and below S, below the first row's frontier and inside
  // the last row's band; each warp reads the tile's 64 kv_valid entries once)
  auto softmax = [&](float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2], int it) {
    const int k0 = (kb0 + it) * WG_ROWS;
    const int j = k0 + 2 * lane;
    const bool ok = j + 1 < S && __ldg(vrow + j) != 0 && __ldg(vrow + j + 1) != 0;
    const bool interior = __all_sync(0xffffffffu, ok) && k0 + WG_ROWS - 1 <= qs + s0 &&
                          (window <= 0 || k0 > qs + s1 - window);
    if (interior)
      softmax_tile<false, kCap>(s, m, l, alpha, scale2, cap_in, cap_out, k0, t4, qpos, vrow, S,
                                window);
    else
      softmax_tile<true, kCap>(s, m, l, alpha, scale2, cap_in, cap_out, k0, t4, qpos, vrow, S,
                               window);
  };
  // the strip's tiles [a, z): those some query of it sees, a run of the
  // CTA's; the others are released unread
  auto live = [&](int it) {
    const int k0 = (kb0 + it) * WG_ROWS;
    return s0 <= s1 && k0 <= qs + s1 && (window <= 0 || k0 + WG_ROWS - 1 > qs + s0 - window);
  };
  int a = 0;
  while (a < n_items && !live(a)) ++a;
  int z = a;
  while (z < n_items && live(z)) ++z;

  float o[F::NO];
#pragma unroll
  for (int i = 0; i < F::NO; ++i) o[i] = 0.f;
  lapha::fence_acc(o);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: the thread's partial row sums
  float s[32], alpha[2];
  uint32_t ap[4][4];  // P of the tile whose P·V is next, bf16

  for (int it = 0; it < a; ++it) {  // tiles before the strip's
    refill(it);
    landed(it);
    release(it);
  }
  if (a < z) {
    // the first tile: S, its softmax
    refill(a);
    lapha::mbar_wait(&bars->res, 0);
    landed(a);
    lapha::wgmma_fence();
    at::logits<F::KS, 64>(s, aQ, k_addr(a));  // S_a = Q·K_aᵀ
    lapha::wgmma_commit();
    lapha::wgmma_wait<0>();
    lapha::fence_acc(s);
    softmax(s, m, l, alpha, a);
    at::a_frags<64>(ap, s);
    for (int it = a + 1; it < z; ++it) {
      // S of tile it and P·V of tile it - 1 together; tile it's softmax
      // while P·V is still on the tensor cores
      landed(it);
      lapha::wgmma_fence();
      at::logits<F::KS, 64>(s, aQ, k_addr(it));  // S_it = Q·K_itᵀ
      lapha::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // O += P_{it-1}·V_{it-1}
        at::rs_wide<F::DVP, WG_ROWS>(o, ap[kk], k_addr(it - 1) + F::QT, kk);
      lapha::wgmma_commit();
      lapha::wgmma_wait<1>();  // S_it landed; P·V may still run
      lapha::fence_acc(s);
      softmax(s, m, l, alpha, it);
      lapha::wgmma_wait<0>();
      lapha::fence_acc(o);
      release(it - 1);
      refill(it);
#pragma unroll
      for (int i = 0; i < F::NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      at::a_frags<64>(ap, s);
    }
    // the last tile's P·V
    lapha::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      at::rs_wide<F::DVP, WG_ROWS>(o, ap[kk], k_addr(z - 1) + F::QT, kk);
    lapha::wgmma_commit();
    lapha::wgmma_wait<0>();
    lapha::fence_acc(o);
    release(z - 1);
  }
  for (int it = z; it < n_items; ++it) {  // tiles after the strip's
    refill(it);
    landed(it);
    release(it);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] >= T) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
    bf16* op = out + ((static_cast<size_t>(b) * T + row[rr]) * nh + h) * DV + 2 * t4;
#pragma unroll
    for (int j = 0; j < F::DVP / 8; ++j)
      if (8 * j < DV)
        *reinterpret_cast<uint32_t*>(op + 8 * j) =
            lapha::pack_f32(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    if (t4 == 0)
      lse[(static_cast<size_t>(b) * nh + h) * T + row[rr]] =
          l[rr] > 0.f ? (m[rr] + log2f(l[rr])) * LN2 : NEG;
  }
}

template <int DH, int DV>
int launch_wg(const void* q, const void* k, const void* v, const int* kv_valid, const int* qstart,
              void* out, float* lse, int B, int T, int S, int nh, int nkv, int window, float scale,
              float softcap, cudaStream_t stream) {
  using F = FwdWg<DH, DV>;
  constexpr int smem = at::smem_bytes<F::NST>(F::TILES);
  static bool opted[2][lapha::kMaxDevices] = {};
  const bool cap = softcap > 0.f;
  const auto kernel = cap ? flash_fwd_wg_kernel<DH, DV, true> : flash_fwd_wg_kernel<DH, DV, false>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = at::head_map(&mq, q, B, T, nh, DH, WG_ROWS);
  if (err == cudaSuccess) err = at::head_map(&mk, k, B, S, nkv, DH, WG_ROWS);
  if (err == cudaSuccess) err = at::head_map(&mv, v, B, S, nkv, DV, WG_ROWS);
  if (err == cudaSuccess) err = lapha::smem_opt_in(kernel, smem, opted[cap]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh * B, (T + WG_CTA_ROWS - 1) / WG_CTA_ROWS);
  kernel<<<grid, at::THREADS, smem, stream>>>(mq, mk, mv, kv_valid, qstart,
                                              static_cast<bf16*>(out), lse, T, S, nh, nkv,
                                              window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// window <= 0: full causal attention; window W > 0: the band of the last W
// positions. softcap <= 0: no logit softcap; cap > 0: s -> cap·tanh(s/cap).
// (dh, dv): the head dims of Q/K and of V/out, one of the instances above;
// any other pair is refused with cudaErrorInvalidValue.
extern "C" int lapha_flash_fwd(const void* q, const void* k, const void* v, const int* kv_valid,
                               const int* qstart, void* out, float* lse, int B, int T, int S,
                               int nh, int nkv, int dh, int dv, int window, float scale,
                               float softcap, void* stream) {
  if (nkv <= 0 || nh % nkv != 0 || B <= 0 || T <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define LAPHA_FWD(DH, DV)                                                                      \
  if (dh == DH && dv == DV)                                                                    \
    return launch_wg<DH, DV>(q, k, v, kv_valid, qstart, out, lse, B, T, S, nh, nkv, window, scale, \
                             softcap, st);
  LAPHA_FWD(64, 64)
  LAPHA_FWD(96, 96)
  LAPHA_FWD(128, 128)
  LAPHA_FWD(192, 128)
  LAPHA_FWD(256, 256)
#undef LAPHA_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* lapha_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
