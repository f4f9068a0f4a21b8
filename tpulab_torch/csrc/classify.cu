// Kernel B3: per-pixel Mahalanobis argmin over nc <= 32 classes, with the
// label written into the pixel's alpha byte, in one launch.
//
// Replaces tpulab/ops/pallas/classify.py::_classify_kernel (reached through
// classify_labels_pallas) together with the label-into-alpha packing of
// tpulab/ops/mahalanobis.py:114-128.
//
// Bound: operations.  In double every one of the 24 operations per pixel
// and class must round on its own to keep the reference's bits, so each is
// a DADD or DMUL of its own on the card's 64-lane FP64 pipe.  The design
// moves almost all of that work to the 128-lane FP32 pipe: a float screen
// with a rigorous error margin rules out every class but one or two, and
// the double form is evaluated only for those.  The labels stay those of
// the double fold, bit for bit (the derivation follows).
//
// Statistics.  The class rows come as one __grid_constant__ parameter
// (Params) in the constant bank: no per-block copy, no barrier, no
// shared-memory load.  ptxas reads them through uniform registers, one
// ULDC.64 per two values.  Each launch carries its own copy, so two
// streams never race on them (a module __constant__ written per call
// would).  One instance per class count (0 to 32) unrolls the class loops
// with no guard.
//
// Bytes to floats.  __byte_perm puts a channel byte b under the exponent of
// 2^23 (float: 0x4B0000bb) or 2^52 (double: 0x43300000'000000bb); one exact
// subtraction leaves b.  No conversion instruction is issued.
//
// The screen, in float, in the form XLA:CPU contracts the Pallas kernel and
// the jnp path into (tpulab/ops/mahalanobis.py:102-110):
//   d_i  = p_i - mu_i
//   t_i  = fma(d_2, IC[2][i], fma(d_0, IC[0][i], d_1 * IC[1][i]))
//   dist = fma(t_2, d_2, fma(t_0, d_0, t_1 * d_1))
// The float32 instance ends here: its label is the strict-<, first-wins
// argmin of these distances, the JAX package's float32 bits.  The build
// uses -fmad=false so nvcc adds no contraction of its own.
//
// The recheck (float64 instance).  min32 is the screen's argmin distance
// and E_min the margin of the class that set it.  The candidates are the
// classes with dist32_c <= min32 + E_c + E_min (the sum rounded up), every
// class flagged "always recheck", and every class when min32 is not
// finite.  Over the candidates, in class order, runs the reference's
// double fold: d_i = p_i - mu_i, t_i = (d_0*IC[0][i] + d_1*IC[1][i]) +
// d_2*IC[2][i], dist = ((0 + t_0*d_0) + t_1*d_1) + t_2*d_2, each operation
// rounded on its own; strict <, from label -1 and +inf.  When the only
// candidate is an unflagged class, the fold's answer is that class (its
// double distance is finite, below), so it is not evaluated.
//
// Why the labels are the double fold's, for every input.  Staging
// (tpulab_torch/ops/cuda/classify.py::stage_screen) computes, in double and
// rounded up, M_j = max(|mu_j|, |255 - mu_j|) >= |p_j - mu_j| for every
// pixel, the class's magnitude bound A_c = sum_ij M_j |IC_ji| M_i and its
// margin E_c = 2^-18 A_c (64 units of float roundoff).  It flags a class
// when a statistic is not finite, a nonzero |mu| or |IC| lies outside
// [2^-60, 2^60], or A_c > 2^120; in the float64 instance a flagged class's
// screen row is NaN, so it never sets min32.  For an unflagged class every
// float statistic is normal or zero, no value of the screen overflows, and
// each rounding errs by at most u = 2^-24 relative plus 2^-150 absolute
// (underflow).  Rounding the statistics to float and the at most three
// roundings that each term of a three-term dot product sees, contracted or
// not, give against the exact D_c = d^T IC d of the double statistics
//   |d32_j - d_j| <= 2.1u M_j,  |t32_i - t_i| <= 6.1u sum_j M_j |IC_ji|,
//   |dist32_c - D_c| <= 11.3u A_c + 2^-92 A_c,
// and the double fold, whose statistics are not rounded, |D64_c - D_c| <=
// 9 * 2^-53 A_c.  Together: |dist32_c - D64_c| <= e A_c with e < 12u, and
// E_c = 64u A_c.  An unflagged class's D64 is finite (|d|, |IC| <= 2^61).
// Let c* be the first class whose D64 is the least double distance, and m
// the class that set min32.  A flagged c* is a candidate.  Otherwise
//   dist32_c* <= D64_c* + e A_c* <= D64_m + e A_c*
//             <= min32 + e (A_c* + A_m) <= min32 + E_c* + E_m,
// so c* is a candidate; every class whose D64 ties with c*'s exactly is
// one by the same lines.  The fold over the candidates, in class order
// with strict <, then stops at c*: no earlier class attains its distance.
// When no class has a finite double distance, every class is flagged, so
// every class is a candidate and the fold is the full fold (label -1 when
// all are NaN, C2).
//
// Cost: the screen is 18 float issues per class in float32 (15 of
// arithmetic, the argmin's compare and two selects) and 21 in float64 (the
// candidate's bound, compare and bit), plus about 6 ULDC; the warp pays 25
// double issues per candidate of its lane with the most candidates, when
// that lane has two or more.
//
// Geometry: the literal (blocks, threads) launch of the reference's sweep
// (lab3/src/to_plot.cu), as a grid-stride loop.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>

namespace {

constexpr int kMaxClasses = 32;
constexpr int kStatsPerClass = 12;  // mean[3], then inv_cov[3][3] row-major

enum DType { kF64 = 0, kF32 = 1 };

// The launch's statistics, laid out as classify.py::Screen.param packs them.
struct Params {
  double rows64[kMaxClasses][kStatsPerClass];  // the float64 rows
  float rows32[kMaxClasses][kStatsPerClass];   // the screen's rows (NaN: flagged, float64)
  float margin[kMaxClasses];                   // E_c, rounded up (float64 only)
  uint32_t recheck;                            // bit c: class c is always a candidate
  int nc;
};
static_assert(sizeof(Params) == 4744, "Params must match classify.py's packing");

template <int K>
__device__ __forceinline__ float byte_f32(uint32_t u) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + K)), 8388608.0f);
}

template <int K>
__device__ __forceinline__ double byte_f64(uint32_t u) {
  return __dsub_rn(__hiloint2double(0x43300000, static_cast<int>(__byte_perm(u, 0u, 0x4440 + K))),
                   4503599627370496.0);
}

__device__ __forceinline__ float screen_distance(const float* s, float r, float g, float b) {
  const float d0 = __fsub_rn(r, s[0]), d1 = __fsub_rn(g, s[1]), d2 = __fsub_rn(b, s[2]);
  const float* ic = s + 3;
  float t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    t[i] = __fmaf_rn(d2, ic[6 + i], __fmaf_rn(d0, ic[i], __fmul_rn(d1, ic[3 + i])));
  }
  return __fmaf_rn(t[2], d2, __fmaf_rn(t[0], d0, __fmul_rn(t[1], d1)));
}

__device__ __forceinline__ double fold_distance(const double* s, double r, double g, double b) {
  const double d[3] = {__dsub_rn(r, s[0]), __dsub_rn(g, s[1]), __dsub_rn(b, s[2])};
  const double* ic = s + 3;
  double dist = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double t = __dadd_rn(__dadd_rn(__dmul_rn(d[0], ic[i]), __dmul_rn(d[1], ic[3 + i])),
                               __dmul_rn(d[2], ic[6 + i]));
    dist = __dadd_rn(dist, __dmul_rn(t, d[i]));
  }
  return dist;
}

// The float64 label of pixel u from the screen's distances (see the header).
template <int kNc>
__device__ __forceinline__ int recheck(uint32_t u, const Params& p, const float* dist,
                                       float min32, float min_margin) {
  uint32_t cand = p.recheck;
  if (!(min32 < INFINITY)) {
    cand = static_cast<uint32_t>((1ull << kNc) - 1u);
  } else {
    const float base = __fadd_ru(min32, min_margin);
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      if (dist[c] <= __fadd_ru(base, p.margin[c])) cand |= 1u << c;
    }
  }
  if ((cand & (cand - 1u)) == 0u && (cand & ~p.recheck) != 0u) return __ffs(cand) - 1;
  const double r = byte_f64<0>(u), g = byte_f64<1>(u), b = byte_f64<2>(u);
  int best = -1;
  double best_dist = INFINITY;
  for (; cand != 0u; cand &= cand - 1u) {
    const int c = __ffs(cand) - 1;
    const double dc = fold_distance(p.rows64[c], r, g, b);
    if (dc < best_dist) {  // strict <: the first minimal class wins, NaN never
      best_dist = dc;
      best = c;
    }
  }
  return best;
}

// One instance per class count, so the class loops unroll with no guard.
template <DType kType, int kNc>
__global__ void __launch_bounds__(1024)
    classify_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                    const __grid_constant__ Params p, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t u = in[i];
    const float r = byte_f32<0>(u), g = byte_f32<1>(u), b = byte_f32<2>(u);
    float dist[kNc > 0 ? kNc : 1];
    float min32 = INFINITY, min_margin = 0.0f;
    int best = -1;
#pragma unroll
    for (int c = 0; c < kNc; ++c) {
      dist[c] = screen_distance(p.rows32[c], r, g, b);
      if (dist[c] < min32) {  // strict <: the first minimal class wins, NaN never
        min32 = dist[c];
        best = c;
        if (kType == kF64) min_margin = p.margin[c];
      }
    }
    if (kType == kF64) best = recheck<kNc>(u, p, dist, min32, min_margin);
    out[i] = (u & 0x00FFFFFFu) | (static_cast<uint32_t>(static_cast<uint8_t>(best)) << 24);
  }
}

using Kernel = void (*)(const uint32_t*, uint32_t*, Params, long long);

template <DType kType, int... kNc>
Kernel kernel_for(int nc, std::integer_sequence<int, kNc...>) {
  static const Kernel table[] = {classify_kernel<kType, kNc>...};
  return table[nc];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// `params` is a host pointer to the packed Params (classify.py::Screen);
// its nc must equal `nc`.
extern "C" int tl_classify(int dtype, const void* in, void* out, const void* params, int nc,
                           long long n, int blocks, int threads, void* stream) {
  Params p;
  std::memcpy(&p, params, sizeof p);
  if (nc < 0 || nc > kMaxClasses || p.nc != nc) return static_cast<int>(cudaErrorInvalidValue);
  const std::make_integer_sequence<int, kMaxClasses + 1> counts;
  Kernel kernel;
  switch (dtype) {
    case kF64:
      kernel = kernel_for<kF64>(nc, counts);
      break;
    case kF32:
      kernel = kernel_for<kF32>(nc, counts);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), p, n);
  return static_cast<int>(cudaGetLastError());
}
