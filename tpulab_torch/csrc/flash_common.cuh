// What the flash-attention kernels share: dtype conversions, the rounding
// of an f32 value to the model dtype, and the per-row thread geometry of
// the kernel on the FMA pipes, float32 B5 (what the tensor-core kernels
// share is in flash_tc.cuh and flash_tf32.cuh).
//
// A query row of head_dim D lives in the registers of TPR neighbouring
// threads of one warp: thread t holds dims (c * TPR + t) * 4 + e for c <
// CPT, e < 4, and a dot product over the row is each thread's partial sum
// reduced with __shfl_xor_sync over the TPR lanes.  Float32 B4 and B6 sum
// scores in the tensor cores' order, three TF32 passes, so B5 recomputes
// each score in another order than the one behind B4's logsumexp: p =
// exp(s - lse) may exceed 1 by a few f32 ulps, far inside grad_tolerance.
// In bfloat16 all three run on the tensor cores (flash_tc.cuh) and B5
// recomputes B4's own scores.

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

// q * scale in f32, rounded back to q's dtype: the wrapper's prescale
template <typename T>
__device__ __forceinline__ float prescaled(T x, float scale) {
  return round_to<T>(__fmul_rn(to_f32<T>(x), scale));
}

template <int D>
struct Geometry {
  static constexpr int TPR = D / 4 < 4 ? D / 4 : 4;  // threads per row
  static constexpr int DPT = D / TPR;                 // head dims per thread
  static constexpr int CPT = DPT / 4;                 // float4 chunks per thread
  static constexpr int BK = D <= 64 ? 64 : 32;        // rows per shared-memory tile
  static constexpr int THREADS = BQ * TPR;
};

// sum of `part` over the TPR lanes that share a row
template <int TPR>
__device__ __forceinline__ float row_sum(float part) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, off);
  }
  return part;
}

}  // namespace tl_flash
