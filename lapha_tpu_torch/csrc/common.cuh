// Helpers shared by the port's Hopper kernels (built for sm_90a with nvcc,
// bound to PyTorch through a plain C interface and ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lapha {

// Finite stand-in for -inf, as in the JAX kernels: exp(NEG - m) underflows
// to 0 for any real m, and NEG - NEG stays 0 rather than NaN.
constexpr float NEG = -1e30f;

// Dynamic shared memory above 48 KB needs an opt-in per kernel, and the
// opt-in holds for the current device only: it is made at a kernel's first
// launch on each device, `done` being that kernel's record of the devices.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t smem_opt_in(Kernel kernel, int smem, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 bit patterns -> one 32-bit register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two floats rounded to bf16 -> one 32-bit register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D += A·B on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col), D f32.
// Fragment layout (PTX ISA), lane = 4*g + t4:
//   A: reg0 = (row g, cols 2t4..+1), reg1 = (row g+8, cols 2t4..+1),
//      reg2 = (row g, cols 2t4+8..+9), reg3 = (row g+8, cols 2t4+8..+9)
//   B: reg0 = (k 2t4..+1, col g), reg1 = (k 2t4+8..+9, col g)
//   D: d0,d1 = (row g, cols 2t4, 2t4+1), d2,d3 = (row g+8, same cols)
// So the D fragments of n-tiles (2kk, 2kk+1) are exactly the A fragment of
// k-step kk of the next product (after rounding to bf16).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of k-step kk from the f32 D fragments of n-tiles 2kk, 2kk+1.
__device__ __forceinline__ void a_from_d(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_f32(lo[0], lo[1]);
  a[1] = pack_f32(lo[2], lo[3]);
  a[2] = pack_f32(hi[0], hi[1]);
  a[3] = pack_f32(hi[2], hi[3]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace lapha
