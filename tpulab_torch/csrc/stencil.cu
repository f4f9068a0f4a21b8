// Kernel B1: Roberts cross edges over a packed RGBA image, in one launch.
//
// Replaces tpulab/ops/pallas/stencil.py::_stencil_kernel (the halo-DMA
// Pallas kernel) together with the XLA code around it in roberts_pallas:
// luminance, the clamp-addressed 2x2 stencil, the magnitude, the clamp to
// [0, 255], the truncation to u8 and the gray RGBA packing with the input
// alpha (tpulab/ops/roberts.py:99-106).
//
// Bound: bytes.  Each pixel is read as one u32 and written as one u32, and
// the few flops per pixel are far below the card's rate.  The design keeps
// the image packed (one 4-byte load per neighbour, no planes in device
// memory) and lets the L1/L2 caches serve the three neighbour reads that
// overlap with the next thread's and the next row's.
//
// Arithmetic follows what XLA:CPU makes of tpulab's jnp code, so the bytes
// equal the JAX package's: it contracts the luminance into
// fma(0.114f, B, fma(0.299f, R, 0.587f * G)) and the magnitude into
// sqrtf(fma(gx, gx, gy * gy)).  The build uses -fmad=false and every
// rounding step is written out.
//
// Geometry: the literal (bx, by, gx, gy) launch of the reference's sweep
// (lab2/src/to_plot.cu), as a 2-D grid-stride loop, so the output does not
// depend on it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float luminance(uint32_t p) {
  const float r = static_cast<float>(p & 0xFFu);
  const float g = static_cast<float>((p >> 8) & 0xFFu);
  const float b = static_cast<float>((p >> 16) & 0xFFu);
  return __fmaf_rn(0.114f, b, __fmaf_rn(0.299f, r, __fmul_rn(0.587f, g)));
}

__global__ void roberts_kernel(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out, int h, int w) {
  const long long stride_y = static_cast<long long>(gridDim.y) * blockDim.y;
  const long long stride_x = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long y = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y;
       y < h; y += stride_y) {
    const long long y1 = y + 1 < h ? y + 1 : h - 1;  // clamp addressing
    const uint32_t* row0 = in + y * w;
    const uint32_t* row1 = in + y1 * w;
    for (long long x = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         x < w; x += stride_x) {
      const long long x1 = x + 1 < w ? x + 1 : w - 1;
      const uint32_t p00 = row0[x];
      const float gx = __fsub_rn(luminance(row1[x1]), luminance(p00));
      const float gy = __fsub_rn(luminance(row0[x1]), luminance(row1[x]));
      const float m = __fsqrt_rn(__fmaf_rn(gx, gx, __fmul_rn(gy, gy)));
      const uint32_t g = static_cast<uint32_t>(fminf(fmaxf(m, 0.0f), 255.0f));
      out[y * w + x] = g | (g << 8) | (g << 16) | (p00 & 0xFF000000u);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int tl_roberts(const void* in, void* out, int h, int w, int bx, int by,
                          int gx, int gy, void* stream) {
  roberts_kernel<<<dim3(gx, gy), dim3(bx, by), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
