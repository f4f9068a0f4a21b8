// What the flash-attention kernels share: dtype conversions, the rounding
// of an f32 value to the model dtype, and the per-row thread geometry of
// the kernels on the FMA pipes (what the tensor-core kernels share is in
// flash_tc.cuh).
//
// A query (or key) row of head_dim D lives in the registers of TPR
// neighbouring threads of one warp: thread t holds dims (c * TPR + t) * 4 + e
// for c < CPT, e < 4, and a dot product over the row is each thread's
// partial sum reduced with __shfl_xor_sync over the TPR lanes.  In float32,
// B4, B5 and B6 sum a score in this same order, so the backward recomputes
// exactly the scores the forward's logsumexp came from.  In bfloat16 they
// run on the tensor cores (flash_tc.cuh) and sum scores in its order.

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
