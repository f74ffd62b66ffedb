// Shared device helpers for the port's kernels: dtype conversion, warp
// reductions and the mask constants of the reference's Pallas kernels.
#pragma once

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

// Masked scores use -0.7 * f32max (flash_attention.py:45,
// decode_attention.py:39), not -inf: exp(mask - m) is exactly 0 and
// mask - mask stays finite for rows whose every entry is masked.
constexpr float kMaskValue = -0.7f * FLT_MAX;
// lse of a fully masked row (flash_attention.py:48)
constexpr float kFullyMaskedLse = 0.7f * FLT_MAX;

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1, kI32 = 2 };

// every lane of a warp takes part in a warp intrinsic
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions over the 32 lanes of a warp (__shfl_xor_sync):
// every lane ends with the result.  This is the paper's HW warp-reduce.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace repro
