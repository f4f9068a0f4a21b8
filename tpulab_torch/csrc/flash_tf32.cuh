// What the float32 flash kernels on Hopper's tensor cores share (B4 in
// flash_fwd.cu, B5 and B6 in flash_bwd.cu): f32 tiles staged in shared
// memory and split into two TF32 parts, and the three-pass products over
// those parts (CUTLASS's OpMultiplyAddFastF32, written out here).
//
// The split.  An f32 value x becomes hi = cvt.rna.tf32.f32(x) and lo =
// cvt.rna.tf32.f32(x - hi), both with their low 13 bits zero, so the
// tensor cores read exactly the bits they are given.  x - hi is exact, and
// lo keeps its 11 leading bits: hi + lo is x to 2^-22 of |x|.  A product
// a.b is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in f32, the small terms first;
// the dropped a_lo.b_lo is below 2^-22 of |a||b|.  One pass (a_hi.b_hi
// alone) keeps 11 bits and misses the f32 limits (tests/test_torch_flash.py).
//
// Layout.  A tile of R rows and D f32 columns lives as D / 32 panels (one
// for D <= 32) of R rows x 128 bytes: column c of row r sits in 16-byte
// chunk ((c % 32) / 4) ^ (r % 8) of its row, the 128-byte swizzle of
// flash_tc.cuh with 4-byte elements.  Read with its rows as M or N and its
// columns as K it is K-major, the only layout wgmma takes for tf32: an
// 8-column k-step is 32 bytes, so flash_tc.cuh's desc_k<R> addresses it
// unchanged.  Below 32 columns only the first D of each row's 32 are used.
//
// The products.  Those that reduce over the head dim (B4's and B5's S =
// Q'K^T, B5's dP = dO V^T, B6's S^T = K q'^T and dP^T = V do^T) read both
// operands K-major from shared memory: wgmma m64nNk8 tf32.  Those that
// reduce over keys or queries (B4's O += P V, B5's dQ += dS K, B6's dV +=
// P^T do and dK += dS^T q') would need their B operand K-major along keys
// or queries, a transpose that wgmma cannot make for 32-bit operands and
// cp.async cannot make on the way in.  They run as mma.sync m16n8k8 tf32
// instead, one per warp and 16 rows, whose fragments are loaded element by
// element: A from the score accumulator's registers (a warp's 16 rows of a
// wgmma accumulator are an m16n8 accumulator's rows), B from the same
// K-major tile that stages the operand.  Within each
// 8-wide k-step the logical index t < 4 takes key (query) 2 t and t + 4
// takes 2 t + 1, on both sides: then A's parts are the accumulator's
// registers in place, and the B loads of a warp fall in 32 distinct banks
// (the swizzle's XOR with row % 8 spreads the four row pairs).
//
// Staging.  Raw tiles arrive by 16-byte cp.async into the same swizzled
// layout; split_tile turns each 16-byte chunk into its hi and lo chunks at
// the same offsets of two other tiles.  Tiles read once per block come in
// from global memory through registers (stage_split).

#pragma once

#include "flash_tc.cuh"

namespace tl_tf32 {

using tl_tc::THREADS;

// byte offset of f32 element (row, col) in a swizzled tile of `rows` rows
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return (col >> 5) * rows * 128 + row * 128 + ((((col & 31) >> 2) ^ (row & 7)) << 4) +
         ((col & 3) << 2);
}

// bytes of a tile of R rows and D f32 columns
template <int R, int D>
constexpr int tile_bytes() {
  return R * ((D + 31) / 32) * 128;
}

// keys per tile of the kernels that walk keys, B4 and B5: 64, and 32 from
// head dim 64 on, so that B4's hi and lo parts leave room for two blocks an
// SM.  B5 walks B4's tiles with B4's score product, so its scores are B4's.
template <int D>
constexpr int key_tile() {
  return D <= 32 ? 64 : 32;
}

// blocks of `kernel` (one warpgroup, `smem` bytes of dynamic shared memory)
// that one SM holds at once, into *blocks; returns the CUDA error
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, smem);
  }
  return static_cast<int>(err);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// the four values of a chunk, times `scale` (rounded to f32), split into
// the hi and lo tiles at byte offset `off`
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, uint32_t off, float4 x,
                                            float scale) {
  uint4 h, l;
  split(__fmul_rn(x.x, scale), h.x, l.x);
  split(__fmul_rn(x.y, scale), h.y, l.y);
  split(__fmul_rn(x.z, scale), h.z, l.z);
  split(__fmul_rn(x.w, scale), h.w, l.w);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// Rows [0, R) of an (rows, D) f32 matrix at `src` (row stride `stride`
// elements, 16-byte aligned rows) by cp.async into the swizzled tile at
// `dst`; rows at or past `nvalid` are zero-filled.  Thread `tid` copies
// chunks tid, tid + 128, ..., the chunks it splits in split_tile.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const float* src, long long stride,
                                          int nvalid, int tid) {
  constexpr int CPR = D / 4, N = R * CPR;  // 16-byte chunks per row, in all
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + tid;
    if (N % THREADS == 0 || i < N) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r < nvalid;
      tl_tc::cp16(dst + swz(R, r, c * 4), src + (ok ? r : 0) * stride + c * 4, ok);
    }
  }
}

// the raw tile this thread loaded with load_tile<R, D> (after its
// cp_wait), times `scale`, split into the hi and lo tiles
template <int R, int D>
__device__ __forceinline__ void split_tile(const uint8_t* raw, uint8_t* hi, uint8_t* lo,
                                           float scale, int tid) {
  constexpr int CPR = D / 4, N = R * CPR;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + tid;
    if (N % THREADS == 0 || i < N) {
      const uint32_t off = swz(R, i / CPR, (i % CPR) * 4);
      store_split(hi, lo, off, *reinterpret_cast<const float4*>(raw + off), scale);
    }
  }
}

// rows [0, R) of an (rows, D) f32 matrix at `src`, times `scale`, split
// into the hi and lo tiles through registers; rows at or past `nvalid`
// are zero
template <int R, int D>
__device__ __forceinline__ void stage_split(uint8_t* hi, uint8_t* lo, const float* src,
                                            long long stride, int nvalid, float scale, int tid) {
  constexpr int CPR = D / 4, N = R * CPR;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + tid;
    if (N % THREADS == 0 || i < N) {
      const int r = i / CPR, c = i % CPR;
      const float4 x = r < nvalid ? *reinterpret_cast<const float4*>(src + r * stride + c * 4)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      store_split(hi, lo, swz(R, r, c * 4), x, scale);
    }
  }
}

// ------------------------------------------------------------ wgmma, tf32

// D(64 x 32, f32) += A(64 x 8) . B(8 x 32), tf32 operands from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same with N = 64
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64, "a tile of 32 or 64 rows");
  if constexpr (N == 32) {
    wgmma_n32(d, a, b, accumulate);
  } else {
    wgmma_n64(d, a, b, accumulate);
  }
}

// Issues D (64 x N) = A B^T over D_ / 8 k-steps in three passes, small
// terms first: A_lo B_hi, A_hi B_lo, A_hi B_hi.  A is a 64-row tile and B
// an N-row tile, each as hi and lo parts (shared-memory addresses).  The
// caller fences, commits and waits.
template <int N, int D_>
__device__ __forceinline__ void wgmma_x3(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                         uint32_t b_hi, uint32_t b_lo) {
  using tl_tc::desc_k;
#pragma unroll
  for (int kk = 0; kk < D_ / 8; ++kk) wgmma_ss<N>(d, desc_k<64>(a_lo, kk), desc_k<N>(b_hi, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D_ / 8; ++kk) wgmma_ss<N>(d, desc_k<64>(a_hi, kk), desc_k<N>(b_lo, kk), 1);
#pragma unroll
  for (int kk = 0; kk < D_ / 8; ++kk) wgmma_ss<N>(d, desc_k<64>(a_hi, kk), desc_k<N>(b_hi, kk), 1);
}

// ---------------------------------------------------------- mma.sync, tf32

// c(16 x 8, f32) += a(16 x 8) . b(8 x 8), tf32 fragments: a0 (g, t), a1
// (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4,
// n g); c0, c1 (g, 2 t + {0, 1}), c2, c3 (g + 8, 2 t + {0, 1}), for lane
// 4 g + t
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (this warp's 16 rows x D_, a wgmma accumulator's layout) = P X in
// three passes, where P (16 rows x R) is this warp's part of a 64 x R
// wgmma accumulator and X (R rows x D_) is a tile's hi and lo parts
// (generic pointers into shared memory).  Lane 4 g + t.  The tile's
// product starts from zero, and the caller adds it to its running sum by
// an f32 add: the tensor cores' accumulation does not round to nearest,
// and run across every tile of a long sequence (dK and dV over 4096
// queries) its error grows past grad_tolerance; within a tile it stays far
// below.  The D_ / 8 slices of c are independent chains of mma.sync.
template <int R, int D_>
__device__ __forceinline__ void mma_x3(float (&c)[D_ / 2], const float (&p)[R / 2],
                                       const uint8_t* x_hi, const uint8_t* x_lo, int g, int t) {
#pragma unroll
  for (int i = 0; i < D_ / 2; ++i) c[i] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
    // logical k t is row 8 kk + 2 t, t + 4 is 8 kk + 2 t + 1: the accumulator's own pairs
    uint32_t ah[4], al[4];
    split(p[4 * kk + 0], ah[0], al[0]);
    split(p[4 * kk + 2], ah[1], al[1]);
    split(p[4 * kk + 1], ah[2], al[2]);
    split(p[4 * kk + 3], ah[3], al[3]);
    const int row = 8 * kk + 2 * t;
#pragma unroll
    for (int j = 0; j < D_ / 8; ++j) {
      const uint32_t o0 = swz(R, row, 8 * j + g), o1 = swz(R, row + 1, 8 * j + g);
      const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(x_hi + o0);
      const uint32_t bh1 = *reinterpret_cast<const uint32_t*>(x_hi + o1);
      const uint32_t bl0 = *reinterpret_cast<const uint32_t*>(x_lo + o0);
      const uint32_t bl1 = *reinterpret_cast<const uint32_t*>(x_lo + o1);
      mma_tf32(&c[4 * j], al, bh0, bh1);
      mma_tf32(&c[4 * j], ah, bl0, bl1);
      mma_tf32(&c[4 * j], ah, bh0, bh1);
    }
  }
}

}  // namespace tl_tf32
