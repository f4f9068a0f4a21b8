// What the flash-attention kernels share: dtype conversions and the
// rounding of an f32 value to the model dtype (what the tensor-core kernels
// share is in flash_tc.cuh and flash_tf32.cuh).  Every flash kernel runs on
// the tensor cores.  In both dtypes B5 recomputes the scores with B4's own
// product over B4's key tiles, so p = exp(s - lse) comes from the scores
// behind the forward's lse and does not exceed 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tl_flash {

constexpr int BQ = 64;  // rows owned by a block (query rows in B4/B5, key rows in B6)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision, kept as f32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32<T>(from_f32<T>(x)); }

}  // namespace tl_flash
