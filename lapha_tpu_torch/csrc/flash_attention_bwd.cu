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
// wide. W and the softcap are runtime arguments, in any combination. A
// softcap > 0 launches the instance with the cap (kCap), so the cap-free
// ones carry none of its work.
//
// What bounds it on an H100: at the training shape (B=8, T=4096, 12/2
// heads, dh 128) each kernel does ~2.5x the forward's matrix work (dq: two
// products per tile for dS plus dS·K; dk/dv: four) against the same bytes,
// far above the ~295 FLOP/byte ridge, so it is bound by matrix-multiply
// throughput, and at the port's shapes (T = 1024) by keeping enough of the
// card busy. P and dS are rounded to bf16 only as the A operand of the next
// product; sums are f32.
//
// Every kernel is a wgmma kernel of 256 threads, two consumer warpgroups,
// fed by a TMA ring (the pieces in attention_wg.cuh). Thread 0 also issues
// every TMA load, item i + NST - 1's when its warpgroup reaches item i
// (after both have released the stage): with a producer warpgroup and
// setmaxnreg (K8's layout), or a producer warp, ptxas capped these kernels
// at 168 registers and spilled ~470 bytes; with none it may give a thread
// 255. Both consumers read every stage, so a stage is released by two
// arrivals. The ring's tiles are TMA boxes of 64 head-dim columns, 128-byte
// swizzled, through 4-D tensor maps (dh, heads, rows, B); a head dim of 96
// is padded to two boxes, the columns past it zeros.
//
// dq: a CTA per (128-query block, query head, batch row), the last block
//   (which sees the most keys) launched first. Q and dO of its 128 queries
//   come in once; K and V tiles stream through a 3-stage ring. Warpgroup w
//   owns queries q0 + 64w..: S = Q·Kᵀ (over DH) and dP = dO·Vᵀ (over DV)
//   with both operands in shared memory, dS in registers, then dQ += dS·K
//   with A from registers and B the stage's K tile, MN-major, DH wide (an
//   m64n128 product per 128 columns, m64n64 for a last 64). At DH 256 dQ is
//   128 registers a thread and Q and dO of 128 queries take 128 KB, so its
//   key tiles are 32 wide (S and dP 16 registers each; 224 KB with three
//   stages); elsewhere 64.
//
// dk/dv, DH <= 128 (V as wide): a CTA per (128-key block, KV head, batch
//   row, part of the GQA group). Warpgroup w owns keys k0 + 64w.. and holds
//   both dK and dV (2 x 64 registers at dh 128): Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ,
//   Pᵀ and dSᵀ in registers, then dV += Pᵀ·dO and dK += dSᵀ·Q, Q and dO
//   tiles of (query head, 64-query tile) items streaming through the ring.
//
// dk/dv, DH > 128 (256, 192 with V 128): dK and dV of 64 keys would be 2 x
//   DH/2 registers a thread (256 at dh 256), so the two warpgroups split the
//   work by role over the CTA's 64 keys: warpgroup 0 forms Sᵀ = K·Qᵀ (over
//   DH), Pᵀ, hands Pᵀ∘dc/ds over through shared memory and accumulates dV
//   += Pᵀ·dO (DV wide); warpgroup 1 forms dPᵀ = V·dOᵀ (over DV), then dSᵀ
//   from the hand-over, and accumulates dK += dSᵀ·Q (DH wide). Each keeps
//   one accumulator and does two of the four products. The hand-over (64 x
//   64 f32, laid out so that each thread reads what the same thread of the
//   other warpgroup wrote) lives in the ring's stage, so the ring's own
//   barriers keep it from being overwritten before it is read; a named
//   barrier per stage tells warpgroup 1 that it was written. Two stages at
//   dh 256 (224 KB), three at 192/128 (208 KB).
//
// Where the grid would leave SMs idle the host splits the GQA group into
// parts (ops/flash_attention.dkv_split: phase 1b's 12/2 heads, 64 CTAs of
// 128 keys, become 192; Gemma-3's 4/1 heads 64 CTAs of 64 keys, 256); each
// part writes f32 partial dK/dV and dkv_reduce_kernel adds them in part
// order, so dq, dk and dv are the same from launch to launch (no atomics
// anywhere). A windowed dq CTA starts at the band's first key tile and a
// windowed dk/dv CTA stops after the last query tile that sees its keys, so
// a band of W = 128 costs O(T·W), not O(T²).

#include <algorithm>

#include "attention_wg.cuh"

namespace {

using lapha::NEG;
using lapha::pack_f32;
using bf16 = __nv_bfloat16;
namespace at = lapha::attn;

constexpr int ROWS = 64;  // a consumer's strip; a streamed Q or dO tile's rows

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

// ---------------------------------------------------------------- dq

template <int DH, int DV>
struct DqWg {
  static_assert(DV <= DH && DV % 16 == 0 && DH % 16 == 0, "V may be narrower than Q/K");
  static constexpr int NBD = at::boxes(DH), NBV = at::boxes(DV);  // boxes across each
  static constexpr int DP = 64 * NBD;        // dQ's head dim padded to whole boxes
  static constexpr int BKEY = DV > 128 ? 32 : 64;  // a ring tile's keys
  static constexpr int KS = DH / 16, KSV = DV / 16;  // k16 steps of S and of dP
  static constexpr int QT = NBD * at::box_bytes<ROWS>();  // a resident 64-query Q strip
  static constexpr int OT = NBV * at::box_bytes<ROWS>();  // ... and dO strip
  static constexpr int KT = NBD * at::box_bytes<BKEY>();  // a ring stage's K tile
  static constexpr int VT = NBV * at::box_bytes<BKEY>();  // ... and V tile
  static constexpr int NST = 3;
  static constexpr int TILES = 2 * (QT + OT) + NST * (KT + VT);
};

// dq: CTA (query head, batch row) on grid.x, 128-query block on grid.y in
// reverse (the last block, which sees the most keys, launched first).
template <int DH, int DV, bool kCap>
__global__ void __launch_bounds__(at::THREADS, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const float* __restrict__ lse,     // (B, nh, T)
                       const float* __restrict__ delta,   // (B, nh, T)
                       const int* __restrict__ kv_valid,  // (B, S)
                       const int* __restrict__ qstart,    // (B,)
                       bf16* __restrict__ dq,             // (B, T, nh, DH)
                       int T, int S, int nh, int nkv, int window, float scale, float softcap) {
  using W = DqWg<DH, DV>;
  constexpr int BK = W::BKEY;
  at::Bars<W::NST>* bars;
  uint8_t* sQ = at::ring_smem<W::NST>(W::TILES, bars);  // [strip] Q tiles
  uint8_t* sO = sQ + 2 * W::QT;                          // [strip] dO tiles
  uint8_t* ring = sO + 2 * W::OT;                        // [stage]: K tile, V tile

  const int tid = threadIdx.x, wg = tid >> 7;  // the warpgroup: its 64-row strip
  const int h = blockIdx.x % nh, b = blockIdx.x / nh, hk = h / (nh / nkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * ROWS;
  const int qs = qstart[b];
  // key tiles from the band's start to the causal frontier of the last row
  const int last_row = min(q0 + 2 * ROWS, T) - 1;
  const int kend = min(S, qs + last_row + 1);
  const int nkb = kend <= 0 ? 0 : (kend + BK - 1) / BK;
  const int kb0 = window > 0 ? max(qs + q0 - (window - 1), 0) / BK : 0;

  // items: key tiles
  const int n_items = max(0, nkb - kb0);
  auto issue = [&](int it) {  // item it's K and V tiles into stage it % NST
    uint64_t* full = &bars->full[it % W::NST];
    uint8_t* st = ring + (it % W::NST) * (W::KT + W::VT);
    lapha::mbar_expect_tx(full, W::KT + W::VT);
    at::tma_tile<W::NBD, BK>(st, &map_k, full, hk, (kb0 + it) * BK, b);
    at::tma_tile<W::NBV, BK>(st + W::KT, &map_v, full, hk, (kb0 + it) * BK, b);
  };
  if (tid == 0) {
    lapha::mbar_expect_tx(&bars->res, 2 * (W::QT + W::OT));
    for (int s = 0; s < 2; ++s) {
      at::tma_tile<W::NBD, ROWS>(sQ + s * W::QT, &map_q, &bars->res, h, q0 + s * ROWS, b);
      at::tma_tile<W::NBV, ROWS>(sO + s * W::OT, &map_do, &bars->res, h, q0 + s * ROWS, b);
    }
    for (int it = 0; it < min(W::NST - 1, n_items); ++it) issue(it);
  }

  const int t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = q0 + wg * ROWS;         // the strip's first query
  const int s1 = min(s0 + ROWS, T) - 1;  // ... and last
  const int row[2] = {s0 + warp * 16 + g, s0 + warp * 16 + g + 8};
  float lse_r[2], d_r[2];
  bool ok_r[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const size_t i = (static_cast<size_t>(b) * nh + h) * T + row[rr];
    lse_r[rr] = row[rr] < T ? lse[i] : NEG;
    d_r[rr] = row[rr] < T ? delta[i] : 0.f;
    ok_r[rr] = lse_r[rr] > 0.5f * NEG;
  }
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const uint32_t aQ = lapha::smem_addr(sQ + wg * W::QT);
  const uint32_t aO = lapha::smem_addr(sO + wg * W::OT);
  const int* vrow = kv_valid + static_cast<size_t>(b) * S;

  float dqa[W::DP / 2];
#pragma unroll
  for (int i = 0; i < W::DP / 2; ++i) dqa[i] = 0.f;
  lapha::fence_acc(dqa);
  lapha::mbar_wait(&bars->res, 0);

  lapha::Ring<W::NST> r;
  for (int it = 0; it < n_items; ++it, r.next()) {
    // thread 0: item it + NST - 1 into the stage item it - 1 held, once
    // both warpgroups have released it
    const int pf = it + W::NST - 1;
    if (tid == 0 && pf < n_items) {
      lapha::mbar_wait(&bars->empty[pf % W::NST], ((pf / W::NST) & 1) ^ 1);
      issue(pf);
    }
    __syncwarp();
    const int k0 = (kb0 + it) * BK;
    // some key of the tile is seen by some query of the strip
    const bool live = s0 <= s1 && k0 <= qs + s1 &&
                      (window <= 0 || k0 + BK - 1 > qs + s0 - window);
    bool kvis[BK / 4];  // this thread's key columns
    if (live) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = k0 + 8 * j + 2 * t4 + e;
          kvis[2 * j + e] = c < S && vrow[c] != 0;
        }
    }
    lapha::mbar_wait(&bars->full[r.stage], r.phase);
    if (live) {
      const uint32_t aK = lapha::smem_addr(ring + r.stage * (W::KT + W::VT));
      const uint32_t aV = aK + W::KT;
      float s[BK / 2], dp[BK / 2];
      lapha::wgmma_fence();
      at::logits<W::KS, BK>(s, aQ, aK);    // S = Q·Kᵀ
      at::logits<W::KSV, BK>(dp, aO, aV);  // dP = dO·Vᵀ
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(s);
      lapha::fence_acc(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e, rr = e >> 1;
          const int c = k0 + 8 * j + 2 * t4 + (e & 1);
          const bool vis = ok_r[rr] && kvis[2 * j + (e & 1)] && c <= qs + row[rr] &&
                           (window <= 0 || c > qs + row[rr] - window);
          float dc;
          const float cl = capped<kCap>(s[i], scale, softcap, inv_cap, dc);
          const float p = vis ? __expf(cl - lse_r[rr]) : 0.f;
          s[i] = p * (dp[i] - d_r[rr]) * dc;
        }
      uint32_t a[BK / 16][4];
      at::a_frags<BK>(a, s);
      lapha::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // dQ += dS·K
        at::rs_wide<W::DP, BK>(dqa, a[kk], aK, kk);
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(dqa);
    }
    if (t128 == 0) lapha::mbar_arrive(&bars->empty[r.stage]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (row[rr] >= T) continue;
    bf16* op = dq + ((static_cast<size_t>(b) * T + row[rr]) * nh + h) * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < W::DP / 8; ++j)
      if (8 * j < DH)
        *reinterpret_cast<uint32_t*>(op + 8 * j) =
            pack_f32(dqa[4 * j + 2 * rr] * scale, dqa[4 * j + 2 * rr + 1] * scale);
  }
}

// ---------------------------------------------------------------- dk/dv, DH <= 128

template <int DH>
struct DkvWg {
  static constexpr int NB = at::boxes(DH);  // boxes across the head dim
  static constexpr int DP = 64 * NB;        // the head dim padded to whole boxes
  static constexpr int KS = DH / 16;        // k16 steps over the real head dim
  static constexpr int NACC = DP / 2;       // f32 a thread of a 64 x DP accumulator
  static constexpr int TILE = NB * at::box_bytes<ROWS>();  // one 64-row tile
  static constexpr int NST = 3;
  // resident K and V of both strips; the ring's Q and dO tiles
  static constexpr int TILES = (4 + 2 * NST) * TILE;
};

// dk/dv: CTA (split, KV head, batch row) on grid.x, 128-key block on grid.y
// (block 0, whose keys every query tile sees, launched first). Consumer
// warpgroup s owns keys k0 + 64s..: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (both
// operands in shared memory), Pᵀ and dSᵀ in registers, then dV += Pᵀ·dO and
// dK += dSᵀ·Q with A from registers and B the stage's tiles, MN-major.
template <int DH, bool kCap>
__global__ void __launch_bounds__(at::THREADS, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,     // (B, nh, T)
                        const float* __restrict__ delta,   // (B, nh, T)
                        const int* __restrict__ kv_valid,  // (B, S)
                        const int* __restrict__ qstart,    // (B,)
                        bf16* __restrict__ dk,             // (B, S, nkv, DH)
                        bf16* __restrict__ dv,             // (B, S, nkv, DH)
                        float* __restrict__ work,          // partials, splits > 1
                        int B, int T, int S, int nh, int nkv, int window, float scale,
                        float softcap, int splits) {
  using W = DkvWg<DH>;
  at::Bars<W::NST>* bars;
  uint8_t* sK = at::ring_smem<W::NST>(W::TILES, bars);  // [strip] tiles
  uint8_t* sV = sK + 2 * W::TILE;
  uint8_t* ring = sK + 4 * W::TILE;  // [stage]: Q tile, dO tile

  const int tid = threadIdx.x, wg = tid >> 7;  // the warpgroup: its 64-row strip
  const int split = blockIdx.x % splits, hk = (blockIdx.x / splits) % nkv;
  const int b = blockIdx.x / (splits * nkv);
  const int k0 = blockIdx.y * 2 * ROWS;
  const int group = nh / nkv, per_split = group / splits;
  const int h0 = hk * group + split * per_split;
  const int qs = qstart[b];
  // query tiles from the block's causal horizon to the band's end
  const int qb0 = max(0, k0 - qs) / ROWS;
  int nqb = (T + ROWS - 1) / ROWS;
  if (window > 0) {
    const int t_last = k0 + 2 * ROWS + window - 2 - qs;
    nqb = t_last < 0 ? 0 : min(nqb, t_last / ROWS + 1);
  }

  // items: (query head, query tile), heads outer
  const int nq = max(0, nqb - qb0), n_items = per_split * nq;
  auto issue = [&](int it) {  // item it's Q and dO tiles into stage it % NST
    uint64_t* full = &bars->full[it % W::NST];
    uint8_t* st = ring + (it % W::NST) * 2 * W::TILE;
    const int h = h0 + it / nq, row = (qb0 + it % nq) * ROWS;
    lapha::mbar_expect_tx(full, 2 * W::TILE);
    at::tma_tile<W::NB, ROWS>(st, &map_q, full, h, row, b);
    at::tma_tile<W::NB, ROWS>(st + W::TILE, &map_do, full, h, row, b);
  };
  if (tid == 0) {
    lapha::mbar_expect_tx(&bars->res, 4 * W::TILE);
    for (int s = 0; s < 2; ++s) {
      at::tma_tile<W::NB, ROWS>(sK + s * W::TILE, &map_k, &bars->res, hk, k0 + s * ROWS, b);
      at::tma_tile<W::NB, ROWS>(sV + s * W::TILE, &map_v, &bars->res, hk, k0 + s * ROWS, b);
    }
    for (int it = 0; it < min(W::NST - 1, n_items); ++it) issue(it);
  }

  const int strip = wg, t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int s0 = k0 + strip * ROWS;  // the strip's first key
  const int key[2] = {s0 + warp * 16 + g, s0 + warp * 16 + g + 8};
  bool kvis[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kvis[rr] = key[rr] < S && kv_valid[static_cast<size_t>(b) * S + key[rr]] != 0;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const uint32_t aK = lapha::smem_addr(sK + strip * W::TILE);
  const uint32_t aV = lapha::smem_addr(sV + strip * W::TILE);

  float dka[W::NACC], dva[W::NACC];
#pragma unroll
  for (int i = 0; i < W::NACC; ++i) dka[i] = dva[i] = 0.f;
  lapha::fence_acc(dka);
  lapha::fence_acc(dva);
  lapha::mbar_wait(&bars->res, 0);

  lapha::Ring<W::NST> r;
  for (int it = 0; it < n_items; ++it, r.next()) {
    // thread 0: item it + NST - 1 into the stage item it - 1 held, once
    // both warpgroups have released it
    const int pf = it + W::NST - 1;
    if (tid == 0 && pf < n_items) {
      lapha::mbar_wait(&bars->empty[pf % W::NST], ((pf / W::NST) & 1) ^ 1);
      issue(pf);
    }
    __syncwarp();
    const int h = h0 + it / nq, t0 = (qb0 + it % nq) * ROWS;
    const float* lrow = lse + (static_cast<size_t>(b) * nh + h) * T;
    const float* drow = delta + (static_cast<size_t>(b) * nh + h) * T;
    // some query of the tile sees some key of the strip
    const bool live = qs + t0 + ROWS - 1 >= s0 &&
                      (window <= 0 || qs + t0 - window < s0 + ROWS - 1);
    lapha::mbar_wait(&bars->full[r.stage], r.phase);
    if (live) {
      const uint32_t aQ = lapha::smem_addr(ring + r.stage * 2 * W::TILE);
      const uint32_t aO = aQ + W::TILE;
      float st[32], dpt[32];
      lapha::wgmma_fence();
      at::logits<W::KS, 64>(st, aK, aQ);   // Sᵀ = K·Qᵀ
      at::logits<W::KS, 64>(dpt, aV, aO);  // dPᵀ = V·dOᵀ
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(st);
      lapha::fence_acc(dpt);
      // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ - D) ∘ dc/ds; 0 where not visible. The
      // LSE and D of the thread's 16 query columns are read here (L1: all
      // 256 threads read the tile's 64), not held across the products.
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + 8 * j + 2 * t4 + e;
          const float l = t < T ? __ldg(lrow + t) : NEG, d = t < T ? __ldg(drow + t) : 0.f;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = 4 * j + 2 * rr + e, kr = key[rr];
            const bool vis = kvis[rr] && l > 0.5f * NEG && kr <= qs + t &&
                             (window <= 0 || kr > qs + t - window);
            float dc;
            const float cl = capped<kCap>(st[i], scale, softcap, inv_cap, dc);
            const float p = vis ? __expf(cl - l) : 0.f;
            st[i] = p;
            dpt[i] = p * (dpt[i] - d) * dc;
          }
        }
      uint32_t ap[4][4], as[4][4];
      at::a_frags<64>(ap, st);
      at::a_frags<64>(as, dpt);
      lapha::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        at::rs_wide<W::DP, ROWS>(dva, ap[kk], aO, kk);  // dV += Pᵀ·dO
        at::rs_wide<W::DP, ROWS>(dka, as[kk], aQ, kk);  // dK += dSᵀ·Q
      }
      lapha::wgmma_commit();
      lapha::wgmma_wait<0>();
      lapha::fence_acc(dka);
      lapha::fence_acc(dva);
    }
    if (t128 == 0) lapha::mbar_arrive(&bars->empty[r.stage]);
  }

  // keys key[0], key[1]; columns 8j + 2t4 (+1) below DH
  const size_t nk = static_cast<size_t>(B) * S * nkv * DH;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (key[rr] >= S) continue;
    const size_t off = ((static_cast<size_t>(b) * S + key[rr]) * nkv + hk) * DH + 2 * t4;
#pragma unroll
    for (int j = 0; j < W::DP / 8; ++j) {
      if (8 * j >= DH) continue;
      const float k0v = dka[4 * j + 2 * rr], k1v = dka[4 * j + 2 * rr + 1];
      const float v0 = dva[4 * j + 2 * rr], v1 = dva[4 * j + 2 * rr + 1];
      if (splits > 1) {  // unscaled f32 partials: dkv_reduce_kernel sums them
        *reinterpret_cast<float2*>(work + split * nk + off + 8 * j) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(work + (splits + split) * nk + off + 8 * j) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_f32(k0v * scale, k1v * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_f32(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------- dk/dv, DH > 128

template <int DH, int DV>
struct DkvRole {
  static_assert(DV <= DH && DV % 16 == 0 && DH > 128, "the role split takes DH > 128");
  static constexpr int NBD = at::boxes(DH), NBV = at::boxes(DV);  // boxes across each
  static constexpr int DP = 64 * NBD, DVP = 64 * NBV;  // dK's and dV's padded widths
  static constexpr int KS = DH / 16, KSV = DV / 16;  // k16 steps of Sᵀ and of dPᵀ
  static constexpr int KT = NBD * at::box_bytes<ROWS>();  // a 64-row K or Q tile
  static constexpr int VT = NBV * at::box_bytes<ROWS>();  // a 64-row V or dO tile
  static constexpr int XT = ROWS * ROWS * 4;             // the Pᵀ∘dc/ds hand-over
  static constexpr int NST = DV > 128 ? 2 : 3;
  // resident K and V; the ring's stages: a Q tile, a dO tile, a hand-over
  static constexpr int STAGE = KT + VT + XT;
  static constexpr int TILES = KT + VT + NST * STAGE;
};

// dk/dv: CTA (split, KV head, batch row) on grid.x, 64-key block on grid.y
// (block 0 launched first); warpgroup 0 the Pᵀ / dV role, 1 the dSᵀ / dK
// role, over the same 64 keys and the same (query head, query tile) items.
template <int DH, int DV, bool kCap>
__global__ void __launch_bounds__(at::THREADS, 1)
flash_bwd_dkv_role_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const float* __restrict__ lse,     // (B, nh, T)
                          const float* __restrict__ delta,   // (B, nh, T)
                          const int* __restrict__ kv_valid,  // (B, S)
                          const int* __restrict__ qstart,    // (B,)
                          bf16* __restrict__ dk,             // (B, S, nkv, DH)
                          bf16* __restrict__ dv,             // (B, S, nkv, DV)
                          float* __restrict__ work,          // partials, splits > 1
                          int B, int T, int S, int nh, int nkv, int window, float scale,
                          float softcap, int splits) {
  using W = DkvRole<DH, DV>;
  at::Bars<W::NST>* bars;
  uint8_t* sK = at::ring_smem<W::NST>(W::TILES, bars);
  uint8_t* sV = sK + W::KT;
  uint8_t* ring = sV + W::VT;  // [stage]: Q tile, dO tile, hand-over

  const int tid = threadIdx.x, role = tid >> 7;  // 0: Pᵀ and dV; 1: dSᵀ and dK
  const int split = blockIdx.x % splits, hk = (blockIdx.x / splits) % nkv;
  const int b = blockIdx.x / (splits * nkv);
  const int k0 = blockIdx.y * ROWS;
  const int group = nh / nkv, per_split = group / splits;
  const int h0 = hk * group + split * per_split;
  const int qs = qstart[b];
  // query tiles from the block's causal horizon to the band's end
  const int qb0 = max(0, k0 - qs) / ROWS;
  int nqb = (T + ROWS - 1) / ROWS;
  if (window > 0) {
    const int t_last = k0 + ROWS + window - 2 - qs;
    nqb = t_last < 0 ? 0 : min(nqb, t_last / ROWS + 1);
  }

  // items: (query head, query tile), heads outer
  const int nq = max(0, nqb - qb0), n_items = per_split * nq;
  auto issue = [&](int it) {  // item it's Q and dO tiles into stage it % NST
    uint64_t* full = &bars->full[it % W::NST];
    uint8_t* st = ring + (it % W::NST) * W::STAGE;
    const int h = h0 + it / nq, row = (qb0 + it % nq) * ROWS;
    lapha::mbar_expect_tx(full, W::KT + W::VT);
    at::tma_tile<W::NBD, ROWS>(st, &map_q, full, h, row, b);
    at::tma_tile<W::NBV, ROWS>(st + W::KT, &map_do, full, h, row, b);
  };
  if (tid == 0) {
    lapha::mbar_expect_tx(&bars->res, W::KT + W::VT);
    at::tma_tile<W::NBD, ROWS>(sK, &map_k, &bars->res, hk, k0, b);
    at::tma_tile<W::NBV, ROWS>(sV, &map_v, &bars->res, hk, k0, b);
    for (int it = 0; it < min(W::NST - 1, n_items); ++it) issue(it);
  }

  const int t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  bool kvis[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    kvis[rr] = key[rr] < S && kv_valid[static_cast<size_t>(b) * S + key[rr]] != 0;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  const uint32_t aK = lapha::smem_addr(sK);
  const uint32_t aV = lapha::smem_addr(sV);

  // dV (role 0: its first DVP / 2) or dK (role 1) of the CTA's 64 keys
  float acc[W::DP / 2];
#pragma unroll
  for (int i = 0; i < W::DP / 2; ++i) acc[i] = 0.f;
  lapha::fence_acc(acc);
  auto& acc_v = reinterpret_cast<float(&)[W::DVP / 2]>(acc);
  lapha::mbar_wait(&bars->res, 0);

  lapha::Ring<W::NST> r;
  for (int it = 0; it < n_items; ++it, r.next()) {
    // thread 0: item it + NST - 1 into the stage item it - 1 held, once
    // both warpgroups have released it (the hand-over included)
    const int pf = it + W::NST - 1;
    if (tid == 0 && pf < n_items) {
      lapha::mbar_wait(&bars->empty[pf % W::NST], ((pf / W::NST) & 1) ^ 1);
      issue(pf);
    }
    __syncwarp();
    const int h = h0 + it / nq, t0 = (qb0 + it % nq) * ROWS;
    // some query of the tile sees some key of the block
    const bool live = qs + t0 + ROWS - 1 >= k0 &&
                      (window <= 0 || qs + t0 - window < k0 + ROWS - 1);
    lapha::mbar_wait(&bars->full[r.stage], r.phase);
    if (live) {
      uint8_t* st = ring + r.stage * W::STAGE;
      const uint32_t aQ = lapha::smem_addr(st);
      const uint32_t aO = aQ + W::KT;
      // element i of thread t128 at xs[128 i + t128]: consecutive threads,
      // consecutive words
      float* xs = reinterpret_cast<float*>(st + W::KT + W::VT);
      const int bar = 1 + r.stage;  // the hand-over of this stage is written
      float x[32];
      if (role == 0) {
        lapha::wgmma_fence();
        at::logits<W::KS, ROWS>(x, aK, aQ);  // Sᵀ = K·Qᵀ
        lapha::wgmma_commit();
        lapha::wgmma_wait<0>();
        lapha::fence_acc(x);
        const float* lrow = lse + (static_cast<size_t>(b) * nh + h) * T;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + 8 * j + 2 * t4 + e;
            const float l = t < T ? __ldg(lrow + t) : NEG;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int i = 4 * j + 2 * rr + e, kr = key[rr];
              const bool vis = kvis[rr] && l > 0.5f * NEG && kr <= qs + t &&
                               (window <= 0 || kr > qs + t - window);
              float dc;
              const float cl = capped<kCap>(x[i], scale, softcap, inv_cap, dc);
              const float p = vis ? __expf(cl - l) : 0.f;
              x[i] = p;
              xs[128 * i + t128] = p * dc;
            }
          }
        lapha::bar_arrive(bar, at::THREADS);
        uint32_t ap[4][4];
        at::a_frags<64>(ap, x);
        lapha::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dV += Pᵀ·dO
          at::rs_wide<W::DVP, ROWS>(acc_v, ap[kk], aO, kk);
        lapha::wgmma_commit();
        lapha::wgmma_wait<0>();
        lapha::fence_acc(acc);
      } else {
        lapha::wgmma_fence();
        at::logits<W::KSV, ROWS>(x, aV, aO);  // dPᵀ = V·dOᵀ
        lapha::wgmma_commit();
        lapha::wgmma_wait<0>();
        lapha::fence_acc(x);
        const float* drow = delta + (static_cast<size_t>(b) * nh + h) * T;
        lapha::bar_sync(bar, at::THREADS);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int t = t0 + 8 * j + 2 * t4 + e;
            const float d = t < T ? __ldg(drow + t) : 0.f;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int i = 4 * j + 2 * rr + e;
              x[i] = xs[128 * i + t128] * (x[i] - d);  // dSᵀ = Pᵀ∘dc/ds ∘ (dPᵀ - D)
            }
          }
        uint32_t as[4][4];
        at::a_frags<64>(as, x);
        lapha::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // dK += dSᵀ·Q
          at::rs_wide<W::DP, ROWS>(acc, as[kk], aQ, kk);
        lapha::wgmma_commit();
        lapha::wgmma_wait<0>();
        lapha::fence_acc(acc);
      }
    }
    if (t128 == 0) lapha::mbar_arrive(&bars->empty[r.stage]);
  }

  // keys key[0], key[1]; columns 8j + 2t4 (+1) below DV (role 0) or DH (role 1)
  const size_t rows = static_cast<size_t>(B) * S * nkv;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (key[rr] >= S) continue;
    const size_t kv_row = (static_cast<size_t>(b) * S + key[rr]) * nkv + hk;
    if (role == 0) {
      const size_t off = kv_row * DV + 2 * t4;
#pragma unroll
      for (int j = 0; j < W::DVP / 8; ++j) {
        if (8 * j >= DV) continue;
        const float v0 = acc[4 * j + 2 * rr], v1 = acc[4 * j + 2 * rr + 1];
        if (splits > 1)  // unscaled f32 partials: dkv_reduce_kernel sums them
          *reinterpret_cast<float2*>(work + splits * rows * DH + split * rows * DV + off + 8 * j) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<uint32_t*>(dv + off + 8 * j) = pack_f32(v0, v1);
      }
    } else {
      const size_t off = kv_row * DH + 2 * t4;
#pragma unroll
      for (int j = 0; j < W::DP / 8; ++j) {
        if (8 * j >= DH) continue;
        const float k0v = acc[4 * j + 2 * rr], k1v = acc[4 * j + 2 * rr + 1];
        if (splits > 1)
          *reinterpret_cast<float2*>(work + split * rows * DH + off + 8 * j) =
              make_float2(k0v, k1v);
        else
          *reinterpret_cast<uint32_t*>(dk + off + 8 * j) = pack_f32(k0v * scale, k1v * scale);
      }
    }
  }
}

// ---------------------------------------------------------------- the split's reduction

// dK = scale·Σ_s partial_s and dV = Σ_s partial_s, over the splits in
// order 0, 1, ...: `work` holds the dK partials (splits x nk) then the dV
// ones (splits x nv). The fixed order makes two launches bit-equal.
__global__ void dkv_reduce_kernel(const float* __restrict__ work, bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, size_t nk, size_t nv, int splits,
                                  float scale) {
  const size_t n4 = (nk + nv) / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t e = 4 * i;
    const bool is_k = e < nk;
    const size_t n = is_k ? nk : nv;
    const float* src = is_k ? work + e : work + splits * nk + (e - nk);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(src + s * n);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const float f = is_k ? scale : 1.f;
    uint2 out;
    out.x = pack_f32(acc.x * f, acc.y * f);
    out.y = pack_f32(acc.z * f, acc.w * f);
    *reinterpret_cast<uint2*>(is_k ? dk + e : dv + (e - nk)) = out;
  }
}

int launch_reduce(const float* work, void* dk, void* dv, size_t nk, size_t nv, int splits,
                  float scale, cudaStream_t stream) {
  const size_t blocks = std::min<size_t>(((nk + nv) / 4 + 255) / 256, 16 * lapha::sm_count());
  dkv_reduce_kernel<<<static_cast<int>(blocks), 256, 0, stream>>>(
      work, static_cast<bf16*>(dk), static_cast<bf16*>(dv), nk, nv, splits, scale);
  return static_cast<int>(cudaGetLastError());
}

// Q, K, V and dO maps: Q and dO in 64-row boxes, K and V in boxes of the
// ring's key tile (`kbox` rows).
cudaError_t maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v,
                 const void* dout, int B, int T, int S, int nh, int nkv, int dh, int dv,
                 int kbox) {
  cudaError_t err = at::head_map(&m[0], q, B, T, nh, dh, ROWS);
  if (err == cudaSuccess) err = at::head_map(&m[1], k, B, S, nkv, dh, kbox);
  if (err == cudaSuccess) err = at::head_map(&m[2], v, B, S, nkv, dv, kbox);
  if (err == cudaSuccess) err = at::head_map(&m[3], dout, B, T, nh, dv, ROWS);
  return err;
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
  using W = DqWg<DH, DV>;
  constexpr int smem = at::smem_bytes<W::NST>(W::TILES);
  const bool cap = softcap > 0.f;
  static bool opted[2][lapha::kMaxDevices] = {};
  const auto kernel = cap ? flash_bwd_dq_wg_kernel<DH, DV, true>
                          : flash_bwd_dq_wg_kernel<DH, DV, false>;
  CUtensorMap m[4];
  cudaError_t err = maps(m, q, k, v, dout, B, T, S, nh, nkv, DH, DV, W::BKEY);
  if (err == cudaSuccess) err = lapha::smem_opt_in(kernel, smem, opted[cap]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nh * B, (T + 2 * ROWS - 1) / (2 * ROWS));
  kernel<<<grid, at::THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], lse, delta, kv_valid,
                                              qstart, static_cast<bf16*>(dq), T, S, nh, nkv,
                                              window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

// dk/dv: the two-strip kernel at DH <= 128, the role split above; with
// splits > 1 each writes its heads' f32 partials to `work` and a second
// launch sums them in split order.
template <int DH, int DV>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* kv_valid, const int* qstart, void* dk, void* dv,
               float* work, int B, int T, int S, int nh, int nkv, int window, float scale,
               float softcap, int splits, cudaStream_t stream) {
  if (splits < 1 || (nh / nkv) % splits != 0 || (splits > 1 && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool cap = softcap > 0.f;
  static bool opted[2][lapha::kMaxDevices] = {};
  CUtensorMap m[4];
  cudaError_t err = maps(m, q, k, v, dout, B, T, S, nh, nkv, DH, DV, ROWS);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (DH <= 128) {
    static_assert(DV == DH, "the two-strip kernel takes V as wide as Q/K");
    using W = DkvWg<DH>;
    constexpr int smem = at::smem_bytes<W::NST>(W::TILES);
    const auto kernel =
        cap ? flash_bwd_dkv_wg_kernel<DH, true> : flash_bwd_dkv_wg_kernel<DH, false>;
    err = lapha::smem_opt_in(kernel, smem, opted[cap]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(splits * nkv * B, (S + 2 * ROWS - 1) / (2 * ROWS));
    kernel<<<grid, at::THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], lse, delta, kv_valid,
                                                qstart, static_cast<bf16*>(dk),
                                                static_cast<bf16*>(dv), work, B, T, S, nh, nkv,
                                                window, scale, softcap, splits);
  } else {
    using W = DkvRole<DH, DV>;
    constexpr int smem = at::smem_bytes<W::NST>(W::TILES);
    const auto kernel = cap ? flash_bwd_dkv_role_kernel<DH, DV, true>
                            : flash_bwd_dkv_role_kernel<DH, DV, false>;
    err = lapha::smem_opt_in(kernel, smem, opted[cap]);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(splits * nkv * B, (S + ROWS - 1) / ROWS);
    kernel<<<grid, at::THREADS, smem, stream>>>(m[0], m[1], m[2], m[3], lse, delta, kv_valid,
                                                qstart, static_cast<bf16*>(dk),
                                                static_cast<bf16*>(dv), work, B, T, S, nh, nkv,
                                                window, scale, softcap, splits);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t rows = static_cast<size_t>(B) * S * nkv;
  return launch_reduce(work, dk, dv, rows * DH, rows * DV, splits, scale, stream);
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

// `splits` divides the GQA group: each split's CTAs take that many of its
// query heads, and `work` holds splits x (B·S·nkv·(dh + dv_w)) f32 partials
// (unused with one split).
extern "C" int lapha_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const float* lse, const float* delta, const int* kv_valid,
                                   const int* qstart, void* dk, void* dv, void* work, int B, int T,
                                   int S, int nh, int nkv, int dh, int dv_w, int window,
                                   float scale, float softcap, int splits, void* stream) {
  if (bad_shape(B, T, S, nh, nkv, window, softcap)) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
#define LAPHA_DKV(DH, DV)                                                                    \
  if (dh == DH && dv_w == DV)                                                                \
    return launch_dkv<DH, DV>(q, k, v, dout, lse, delta, kv_valid, qstart, dk, dv,            \
                              static_cast<float*>(work), B, T, S, nh, nkv, window, scale,      \
                              softcap, splits, st);
  LAPHA_DKV(64, 64)
  LAPHA_DKV(128, 128)
  LAPHA_DKV(256, 256)
  LAPHA_DKV(192, 128)
  LAPHA_DKV(96, 96)
#undef LAPHA_DKV
  return static_cast<int>(cudaErrorInvalidValue);
}
