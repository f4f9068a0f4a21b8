// Kernel B1: Roberts cross edges over a packed RGBA image, in one launch.
//
// Replaces tpulab/ops/pallas/stencil.py::_stencil_kernel (the halo-DMA
// Pallas kernel) together with the XLA code around it in roberts_pallas:
// luminance, the clamp-addressed 2x2 stencil, the magnitude, the clamp to
// [0, 255], the truncation to u8 and the gray RGBA packing with the input
// alpha (tpulab/ops/roberts.py:99-106).
//
// Bound: bytes.  Each pixel is read as one u32 and written as one u32.  The
// arithmetic must stay below that, and on this card the conversions are the
// trap: integer<->float conversions issue at an eighth of the float rate.
// So no conversion is issued.  A byte b becomes a float by __byte_perm
// under the exponent of 2^23 (0x4B0000bb = 2^23 + b) and one exact
// subtraction; the truncation of 0 <= m <= 255 is __fadd_rz(m, 2^23),
// whose low mantissa byte is trunc(m), and __byte_perm packs it three times
// beside the input's alpha byte.
//
// Work per thread: a quad of 4 pixels in x over a strip of kRows rows.  The
// thread loads each row of its strip once, and the row below the strip,
// all before it computes, so every load is in flight at once (16 bytes
// when w % 4 == 0 and the planes are 16-byte aligned, four u32 loads
// otherwise).  It computes each luminance once and carries the lower
// row's into the next row.  The luminance right of the quad comes from the next lane,
// which holds the next quad, by __shfl_down_sync; the warp's last lane and
// a lane beside a strip's edge read it themselves, and the image's last
// column clamps to itself.  Indices are 32-bit: the wrapper refuses h * w
// >= 2^31.
//
// Arithmetic follows what XLA:CPU makes of tpulab's jnp code, so the bytes
// equal the JAX package's: it contracts the luminance into
// fma(0.114f, B, fma(0.299f, R, 0.587f * G)) and the magnitude into
// sqrtf(fma(gx, gx, gy * gy)).  The build uses -fmad=false and every
// rounding step is written out.
//
// Geometry: the literal (bx, by, gx, gy) launch of the reference's sweep
// (lab2/src/to_plot.cu), as a grid-stride loop over quads x strips, so the
// output does not depend on it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 4;  // rows of a strip

// Byte K of p as an exact float, with no conversion instruction.
template <int K>
__device__ __forceinline__ float byte_f32(uint32_t p) {
  return __fsub_rn(__uint_as_float(__byte_perm(p, 0x4B000000u, 0x7440 + K)), 8388608.0f);
}

__device__ __forceinline__ float luminance(uint32_t p) {
  return __fmaf_rn(0.114f, byte_f32<2>(p),
                   __fmaf_rn(0.299f, byte_f32<0>(p), __fmul_rn(0.587f, byte_f32<1>(p))));
}

// The output pixel from the luminances at (x, y), (x+1, y), (x, y+1),
// (x+1, y+1) and the input pixel at (x, y).
__device__ __forceinline__ uint32_t edge(float y00, float y10, float y01, float y11,
                                         uint32_t p00) {
  const float gx = __fsub_rn(y11, y00);
  const float gy = __fsub_rn(y10, y01);
  const float m = __fsqrt_rn(__fmaf_rn(gx, gx, __fmul_rn(gy, gy)));
  const float g = __fadd_rz(fminf(fmaxf(m, 0.0f), 255.0f), 8388608.0f);  // 2^23 + trunc
  return __byte_perm(__float_as_uint(g), p00, 0x7000);
}

// A quad's 4 pixels in one row (those past the image's last column repeat
// that column).
struct Pixels {
  uint32_t p[4];
};

template <bool kVec>
__device__ __forceinline__ Pixels load_quad(const uint32_t* __restrict__ row, unsigned x0,
                                            unsigned w) {
  Pixels q;
  if (kVec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + x0));
    q.p[0] = v.x, q.p[1] = v.y, q.p[2] = v.z, q.p[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) q.p[k] = __ldg(row + min(x0 + k, w - 1));
  }
  return q;
}

// The luminances of a quad's row and, in y[4], of the pixel right of it.
// Every lane of `mask` calls this (the shuffle): `from_lane` says the next
// lane holds the next quad of the same strip, `last_quad` that x0 + 4 lies
// past the image (clamp: y[3]); otherwise the lane reads that pixel itself.
struct Lumas {
  float y[5];
};

__device__ __forceinline__ Lumas lumas(const Pixels& q, const uint32_t* __restrict__ row,
                                       unsigned x0, bool on, bool from_lane, bool last_quad,
                                       unsigned mask) {
  Lumas l;
#pragma unroll
  for (int k = 0; k < 4; ++k) l.y[k] = luminance(q.p[k]);
  const float next = __shfl_down_sync(mask, l.y[0], 1);
  l.y[4] = from_lane ? next : last_quad ? l.y[3] : on ? luminance(__ldg(row + x0 + 4)) : 0.0f;
  return l;
}

template <bool kVec>
__global__ void __launch_bounds__(1024)
    roberts_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, unsigned h,
                   unsigned w) {
  const unsigned quads = (w + 3) / 4;
  const unsigned total = quads * ((h + kRows - 1) / kRows);  // < 2^30 for h * w < 2^31
  const unsigned block = blockDim.x * blockDim.y;
  const unsigned t = threadIdx.y * blockDim.x + threadIdx.x;
  const unsigned lane = t % 32;
  // the lanes of this warp (a block's last warp may be partial)
  const unsigned lanes = min(32u, block - (t - lane));
  const unsigned mask = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1u;
  const unsigned long long first =
      (static_cast<unsigned long long>(blockIdx.y) * gridDim.x + blockIdx.x) * block + t;
  const unsigned long long threads =
      static_cast<unsigned long long>(gridDim.x) * gridDim.y * block;
  if (first - lane >= total) return;  // the whole warp: the loop below is warp-uniform
  const unsigned step = threads < total ? static_cast<unsigned>(threads) : total;
  for (unsigned item = static_cast<unsigned>(first); item - lane < total; item += step) {
    const bool live = item < total;
    const unsigned q = item % quads, x0 = 4 * q, y0 = item / quads * kRows;
    const bool last_quad = q + 1 == quads;
    const bool from_lane = lane + 1 < lanes && !last_quad;  // the next item is quad q + 1
    // every row of the strip and the one below it, all loads in flight at
    // once; row r is needed while y0 + r - 1 < h (clamp addressing: the
    // last row is its own lower row)
    Pixels rows[kRows + 1] = {};  // a lane past the image shuffles zeros
#pragma unroll
    for (int r = 0; r <= kRows; ++r) {
      if (live && y0 + r <= h) rows[r] = load_quad<kVec>(in + min(y0 + r, h - 1) * w, x0, w);
    }
    Lumas top = lumas(rows[0], in + min(y0, h - 1) * w, x0, live, from_lane, last_quad, mask);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const unsigned y = y0 + r;
      const bool on = live && y < h;
      const Lumas bottom = lumas(rows[r + 1], in + min(y + 1, h - 1) * w, x0, on, from_lane,
                                 last_quad, mask);
      if (on) {
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          o[k] = edge(top.y[k], top.y[k + 1], bottom.y[k], bottom.y[k + 1], rows[r].p[k]);
        }
        uint32_t* dst = out + y * w + x0;
        if (kVec) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (x0 + k < w) dst[k] = o[k];
          }
        }
      }
      top = bottom;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.  The
// 16-byte path needs w % 4 == 0 and both planes 16-byte aligned.
extern "C" int tl_roberts(const void* in, void* out, int h, int w, int bx, int by, int gx,
                          int gy, void* stream) {
  if (h < 0 || w < 0 || static_cast<long long>(h) * w >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid(gx, gy), block(bx, by);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* pin = static_cast<const uint32_t*>(in);
  uint32_t* pout = static_cast<uint32_t*>(out);
  if (vec) {
    roberts_kernel<true><<<grid, block, 0, s>>>(pin, pout, h, w);
  } else {
    roberts_kernel<false><<<grid, block, 0, s>>>(pin, pout, h, w);
  }
  return static_cast<int>(cudaGetLastError());
}
