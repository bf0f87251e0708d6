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
