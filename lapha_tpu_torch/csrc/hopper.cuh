// Hopper (sm_90a) building blocks shared by the port's kernels: cp.async,
// ldmatrix and movmatrix, thread-block clusters, mbarriers, TMA loads and
// the host's tensor-map encoder, wgmma shared-memory descriptors and the
// wgmma products (A from shared memory or from registers), setmaxnreg, and
// the ring position of a producer/consumer pipeline, named barriers.
// grouped_gemm.cu (K8), int4_matmul.cu (K6), ragged_decode_attention.cu
// (K4/K5), and through attention_wg.cuh flash_attention.cu (K1/K3) and
// flash_attention_bwd.cu (K2) take them from here.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lapha {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async, ldmatrix

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4 bytes global -> shared (an f32 at any 4-byte boundary); zero-filled when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(n));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each matrix transposed: from [k][n] rows, lane 4g + t4 gets
// (k = 2t4, 2t4 + 1; n = g), an mma B fragment.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two transposed matrices; lanes 0-15 give the row addresses.
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// An 8x8 b16 matrix in the ldmatrix / mma fragment layout (lane 4g + t4
// holds row g, columns 2t4, 2t4 + 1), transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// ---------------------------------------------------------------- thread-block clusters

// This CTA's rank in its cluster, and a barrier of all the cluster's threads
// (release / acquire: every CTA's shared-memory writes before it, to its own
// or another's, are seen by all after it).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The same barrier in two halves: a CTA arrives on entry and waits before it
// first touches a peer's shared memory, which must have started to exist.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// An f32 stored at the address `p` has in this CTA's shared memory, into
// rank r's (distributed shared memory; seen there after a cluster barrier).
__device__ __forceinline__ void st_cluster_f32(float* p, int r, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(r));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

// ---------------------------------------------------------------- mbarriers, TMA

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A
// barrier that never completes (a fault in the ring) traps after 2^28
// polls, seconds, rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// TMA: a box of the tensor map at the coordinates (innermost first) into
// shared memory, its bytes counted on `bar`; out-of-bounds elements are zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
        "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The ring position a role is at: stage and the parity of its pass.
template <int STAGES>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------------- wgmma

constexpr uint32_t SW_ROWS = 1024;  // bytes of 8 swizzled 128-byte rows: the swizzle atom

// A wgmma shared-memory matrix descriptor, 128-byte swizzle: the start
// address, the leading byte offset (K-major: unused; MN-major: from one
// 64-element column of atoms to the next) and the stride byte offset (from
// one 8-row group to the next), each in 16-byte units. A K-major operand
// steps 32 bytes a k16 step inside the atom; an MN-major one 16 rows (2 KB).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products (which it cannot see).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32) accumulator layout: thread 32w + l of the warpgroup holds
// rows 16w + l/4 (d[4j], d[4j+1]) and 16w + l/4 + 8 (d[4j+2], d[4j+3]) at
// columns 8j + 2(l%4) + {0, 1}. With `acc` 0 the product overwrites D.

#define LAPHA_D8(i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define LAPHA_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define LAPHA_R32                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define LAPHA_R64                                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "            \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D (64 x 128) (+)= A (64 x 16) · B (16 x 128), bf16, both from shared memory.
// kTA / kTB: the operand is MN-major (wgmma's transpose bit).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LAPHA_R64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : LAPHA_D8(0), LAPHA_D8(8), LAPHA_D8(16), LAPHA_D8(24), LAPHA_D8(32), LAPHA_D8(40),
        LAPHA_D8(48), LAPHA_D8(56)
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

// D (64 x 64) (+)= A (64 x 16) · B (16 x 64), both from shared memory.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LAPHA_R32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : LAPHA_D8(0), LAPHA_D8(8), LAPHA_D8(16), LAPHA_D8(24)
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

// D (64 x 32) (+)= A (64 x 16) · B (16 x 32), both from shared memory.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " LAPHA_R16
      ", %16, %17, p, 1, 1, %19, %20;\n}\n"
      : LAPHA_D8(0), LAPHA_D8(8)
      : "l"(da), "l"(db), "r"(acc), "n"(kTA), "n"(kTB));
}

// D (64 x 128) += A (64 x 16, registers) · B (16 x 128, shared memory). A's
// registers are those of an mma.sync m16n8k16 A fragment, warp w of the
// warpgroup holding rows 16w..16w+15 (common.cuh: a_from_d builds it from
// two 8-column tiles of a D accumulator).
template <int kTB>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " LAPHA_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : LAPHA_D8(0), LAPHA_D8(8), LAPHA_D8(16), LAPHA_D8(24), LAPHA_D8(32), LAPHA_D8(40),
        LAPHA_D8(48), LAPHA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTB));
}

// D (64 x 64) += A (64 x 16, registers) · B (16 x 64, shared memory).
template <int kTB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " LAPHA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : LAPHA_D8(0), LAPHA_D8(8), LAPHA_D8(16), LAPHA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTB));
}

#undef LAPHA_D8
#undef LAPHA_R16
#undef LAPHA_R32
#undef LAPHA_R64

// Named barrier `id` (1-15; 0 is __syncthreads') over `n` threads, a
// multiple of 32: bar_sync waits for the barrier's phase to complete,
// bar_arrive counts towards it without waiting (a producer's release).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found once at run time through the
// runtime's entry-point query (no link against libcuda); null if absent.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map, 128-byte swizzle: dims and box innermost first, the
// row strides in bytes (rank - 1 of them, multiples of 16).
inline cudaError_t make_map(CUtensorMap* map, const void* base, cuuint32_t rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The device's SM count (132 on an H100 SXM if the query fails).
inline int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

}  // namespace lapha
