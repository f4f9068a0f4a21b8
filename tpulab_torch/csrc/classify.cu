// Kernel B3: per-pixel Mahalanobis argmin over nc <= 32 classes, with the
// label written into the pixel's alpha byte, in one launch.
//
// Replaces tpulab/ops/pallas/classify.py::_classify_kernel (reached through
// classify_labels_pallas) together with the label-into-alpha packing of
// tpulab/ops/mahalanobis.py:114-128.
//
// Bound: operations.  Each pixel costs 24 flops per class (3 subtractions,
// 12 multiplies, 9 additions) against 8 bytes moved, so in double the card's
// FP64 rate is the limit.  The class statistics (at most 32 x 12 values) come
// in a small device buffer that each block copies into shared memory once;
// every thread then reads them as broadcasts.  A module-global __constant__
// written per call would race between two streams, so there is none.
//
// Arithmetic, in tpulab's loop order (tpulab/ops/mahalanobis.py:102-110):
//   d_i  = p_i - mu_i
//   t_i  = d_0 * IC[0][i] + d_1 * IC[1][i] + d_2 * IC[2][i]
//   dist = t_0 * d_0 + t_1 * d_1 + t_2 * d_2
// In float the form is contracted exactly as XLA:CPU contracts the Pallas
// kernel and the jnp path: t_i = fma(d_2, IC[2][i], fma(d_0, IC[0][i],
// d_1 * IC[1][i])) and dist = fma(t_2, d_2, fma(t_0, d_0, t_1 * d_1)), so the
// distances carry the same bits as the JAX package's f32 ones.  In double
// every operation rounds on its own, the order of the reference kernel's
// C loops.  The build uses -fmad=false so nvcc adds no contraction.
//
// The argmin is a strict < fold starting at label -1, as tpulab's XLA path
// (mahalanobis.py:100) and the C oracle do: a NaN distance (a degenerate
// single-point class) never wins, and a pixel where every class is
// degenerate keeps -1, written as alpha 255.  The Pallas kernel started at
// 0 instead (classify.py:56); this kernel follows the XLA path.
//
// Geometry: the literal (blocks, threads) launch of the reference's sweep
// (lab3/src/to_plot.cu), as a grid-stride loop.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxClasses = 32;
constexpr int kStatsPerClass = 12;  // mean[3], then inv_cov[3][3] row-major

enum DType { kF64 = 0, kF32 = 1 };

__device__ __forceinline__ float mahalanobis(const float* s, float d0, float d1, float d2) {
  const float* ic = s + 3;
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = __fmaf_rn(d2, ic[6 + i], __fmaf_rn(d0, ic[i], __fmul_rn(d1, ic[3 + i])));
  }
  return __fmaf_rn(t[2], d2, __fmaf_rn(t[0], d0, __fmul_rn(t[1], d1)));
}

__device__ __forceinline__ double mahalanobis(const double* s, double d0, double d1,
                                              double d2) {
  const double* ic = s + 3;
  const double d[3] = {d0, d1, d2};
  double dist = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double t = __dadd_rn(__dadd_rn(__dmul_rn(d0, ic[i]), __dmul_rn(d1, ic[3 + i])),
                               __dmul_rn(d2, ic[6 + i]));
    dist = __dadd_rn(dist, __dmul_rn(t, d[i]));
  }
  return dist;
}

template <typename T>
__global__ void classify_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                const T* __restrict__ stats, int nc, long long n) {
  __shared__ T s[kMaxClasses * kStatsPerClass];
  for (int i = threadIdx.x; i < nc * kStatsPerClass; i += blockDim.x) s[i] = stats[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const uint32_t u = in[p];
    const T r = static_cast<T>(u & 0xFFu);
    const T g = static_cast<T>((u >> 8) & 0xFFu);
    const T b = static_cast<T>((u >> 16) & 0xFFu);
    int best = -1;
    T best_dist = static_cast<T>(INFINITY);
    for (int c = 0; c < nc; ++c) {
      const T* sc = s + c * kStatsPerClass;
      const T dist = mahalanobis(sc, r - sc[0], g - sc[1], b - sc[2]);
      if (dist < best_dist) {  // strict <: the first minimal class wins, NaN never
        best_dist = dist;
        best = c;
      }
    }
    out[p] = (u & 0x00FFFFFFu) | (static_cast<uint32_t>(static_cast<uint8_t>(best)) << 24);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `stats` holds nc * 12 values of the compute type (kF64: double, kF32: float).
extern "C" int tl_classify(int dtype, const void* in, void* out, const void* stats, int nc,
                           long long n, int blocks, int threads, void* stream) {
  if (nc < 0 || nc > kMaxClasses) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pin = static_cast<const uint32_t*>(in);
  uint32_t* pout = static_cast<uint32_t*>(out);
  switch (dtype) {
    case kF64:
      classify_kernel<double><<<blocks, threads, 0, s>>>(
          pin, pout, static_cast<const double*>(stats), nc, n);
      break;
    case kF32:
      classify_kernel<float><<<blocks, threads, 0, s>>>(
          pin, pout, static_cast<const float*>(stats), nc, n);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
