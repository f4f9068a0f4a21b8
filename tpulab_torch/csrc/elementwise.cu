// Kernel B2: a binary elementwise op (subtract, add, multiply, minimum,
// maximum) over two vectors, in double, float and bfloat16.
//
// Replaces tpulab/ops/pallas/elementwise.py::_ew_kernel (reached through
// pallas_binary), whose (rows, 128) padded tiling was the TPU's layout; the
// JAX package sent double to XLA:CPU, here it stays on the card.
//
// Bound: bytes.  One op per element against three elements moved; the
// loop reads each input once and writes each output once, neighbouring
// threads on neighbouring elements.
//
// Arithmetic: each op rounds once in its type.  bfloat16 widens to float,
// applies the op and rounds once with __float2bfloat16_rn, as XLA:CPU does.
// minimum/maximum are the IEEE-754-2019 operations XLA:CPU evaluates for
// jnp.minimum/jnp.maximum: a NaN operand propagates (CUDA's fmin/fmax would
// drop it) and -0 orders below +0.  Between two NaNs the one returned follows
// the sign of the first operand, as in LLVM's x86 lowering of
// llvm.minimum/llvm.maximum; the selection never does arithmetic, so a NaN
// keeps its bits.
//
// Geometry: the literal (grid, block) launch of the reference's sweep
// (lab1/src/to_plot.cu), as a grid-stride loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

enum Op { kSub = 0, kAdd = 1, kMul = 2, kMin = 3, kMax = 4 };
enum DType { kF64 = 0, kF32 = 1, kBF16 = 2 };

template <int OP> __device__ __forceinline__ float arith(float a, float b) {
  if constexpr (OP == kSub) return __fsub_rn(a, b);
  if constexpr (OP == kAdd) return __fadd_rn(a, b);
  return __fmul_rn(a, b);
}

template <int OP> __device__ __forceinline__ double arith(double a, double b) {
  if constexpr (OP == kSub) return __dsub_rn(a, b);
  if constexpr (OP == kAdd) return __dadd_rn(a, b);
  return __dmul_rn(a, b);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// minimum/maximum as a choice between the two operands (see the header)
template <int OP, typename T> __device__ __forceinline__ T pick(T x, T y) {
  const auto kx = widen(x), ky = widen(y);
  const bool neg = signbit(kx);
  if constexpr (OP == kMin) {
    const T a = neg ? y : x, b = neg ? x : y;
    const auto ka = neg ? ky : kx, kb = neg ? kx : ky;
    return isnan(ka) ? a : (ka < kb ? a : b);
  } else {
    const T a = neg ? x : y, b = neg ? y : x;
    const auto ka = neg ? kx : ky, kb = neg ? ky : kx;
    return isnan(ka) ? a : (ka > kb ? a : b);
  }
}

template <int OP, typename T> __device__ __forceinline__ T apply(T a, T b) {
  if constexpr (OP == kMin || OP == kMax) {
    return pick<OP>(a, b);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(arith<OP>(widen(a), widen(b)));
  } else {
    return arith<OP>(a, b);
  }
}

template <typename T, int OP>
__global__ void binary_kernel(const T* __restrict__ a, const T* __restrict__ b,
                              T* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = apply<OP>(a[i], b[i]);
  }
}

template <typename T>
int launch(int op, const void* a, const void* b, void* out, long long n, int grid,
           int block, cudaStream_t stream) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* po = static_cast<T*>(out);
  switch (op) {
    case kSub: binary_kernel<T, kSub><<<grid, block, 0, stream>>>(pa, pb, po, n); break;
    case kAdd: binary_kernel<T, kAdd><<<grid, block, 0, stream>>>(pa, pb, po, n); break;
    case kMul: binary_kernel<T, kMul><<<grid, block, 0, stream>>>(pa, pb, po, n); break;
    case kMin: binary_kernel<T, kMin><<<grid, block, 0, stream>>>(pa, pb, po, n); break;
    case kMax: binary_kernel<T, kMax><<<grid, block, 0, stream>>>(pa, pb, po, n); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tl_binary(int op, int dtype, const void* a, const void* b, void* out,
                         long long n, int grid, int block, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF64: return launch<double>(op, a, b, out, n, grid, block, s);
    case kF32: return launch<float>(op, a, b, out, n, grid, block, s);
    case kBF16: return launch<__nv_bfloat16>(op, a, b, out, n, grid, block, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
