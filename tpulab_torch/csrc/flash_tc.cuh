// What the bf16 flash kernels on Hopper's tensor cores share (B4 in
// flash_fwd.cu, B5 and B6 in flash_bwd.cu): bf16 tiles staged in shared
// memory by 16-byte cp.async copies into 128-byte-swizzled panels, wgmma
// descriptors over those panels, and the warpgroup's products in raw PTX
// (sm_90a).
//
// Layout.  A tile of R rows and D bf16 columns lives as D / 64 panels (one
// for D <= 64) of R rows x 128 bytes: column c of row r sits in 16-byte
// chunk ((c % 64) / 8) ^ (r % 8) of its row, the 128-byte swizzle that
// wgmma's descriptors name (layout type 1).  Every panel starts on a
// 1024-byte boundary.  Read with its rows as the M or N dimension and its
// columns as K, a panel is K-major: 8-row groups 1024 bytes apart (SBO),
// and a 16-column k-step advances the start address by 32 bytes inside the
// swizzle atom.  Read with its rows as K and its columns as N (the
// transpose bit), it is MN-major: 8-row groups 1024 bytes apart (SBO),
// 64-column panels R * 128 bytes apart (LBO), and a 16-row k-step
// advances 2048 bytes.  Head dims below 64 keep a 64-column panel: the
// score products read only the first max(d, 16) columns (at d = 8 the
// columns 8..15 are zeroed once, so they add exact zeros), and the d-wide
// products compute all 64 columns of which only the first d are stored.
//
// Fragments.  A product's f32 accumulator of a 64 x N tile is spread over
// the warpgroup's 128 threads: thread t (warp w = t / 32, lane l = t % 32)
// holds rows 16 w + l / 4 and 16 w + l / 4 + 8, columns 8 j + 2 (l % 4) and
// one more, for j < N / 8: d[4 j + 0, 1] on the first row, d[4 j + 2, 3]
// on the second.  Rounded to bf16 and packed two by two, each 16 columns
// of that layout are the A operand of one k-step of a register-sourced
// wgmma (to_a_frag), so P and dS never leave the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tl_tc {

constexpr int THREADS = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row, col) in a swizzled tile of `rows` rows
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return (col >> 6) * rows * 128 + row * 128 + ((((col & 63) >> 3) ^ (row & 7)) << 4) +
         ((col & 7) << 1);
}

// ------------------------------------------------------------ cp.async

// 16 bytes from global to shared memory; zero-filled when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes from global to shared memory; zero-filled when !valid
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes from global to shared memory; zero-filled when !valid
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes (cp.async's included, once waited
// for) made visible to wgmma's reads; a barrier follows
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [0, R) of a (rows, D) bf16 matrix at `src` (row stride `stride`
// elements, 16-byte aligned rows) into the swizzled tile at `dst`; rows at
// or past `nvalid` are zero-filled.  Thread `tid` copies chunks tid,
// tid + 128, ... (the same chunks each call, which prescale_tile relies on).
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long stride,
                                          int nvalid, int tid) {
  constexpr int CPR = D / 8, N = R * CPR;  // 16-byte chunks per row, in all
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + tid;
    if (N % THREADS == 0 || i < N) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = r < nvalid;
      cp16(dst + swz(R, r, c * 8), src + (ok ? r : 0) * stride + c * 8, ok);
    }
  }
}

// q' = bf16(f32(q) * scale) in place, over the chunks this thread loaded
// with load_tile<R, D> (after its cp_wait)
template <int R, int D>
__device__ __forceinline__ void prescale_tile(uint8_t* tile, float scale, int tid) {
  constexpr int CPR = D / 8, N = R * CPR;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += THREADS) {
    const int i = i0 + tid;
    if (N % THREADS == 0 || i < N) {
      const int r = i / CPR, c = i % CPR;
      uint4* at = reinterpret_cast<uint4*>(tile + swz(R, r, c * 8));
      uint4 x = *at;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        h[e] = __floats2bfloat162_rn(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale));
      }
      *at = x;
    }
  }
}

// zero columns 8..15 of every row of a swizzled tile (head dim 8, whose
// score products read 16 columns)
template <int R>
__device__ __forceinline__ void zero_pad8(uint8_t* tile, int tid) {
  for (int r = tid; r < R; r += THREADS) {
    *reinterpret_cast<uint4*>(tile + swz(R, r, 8)) = make_uint4(0, 0, 0, 0);
  }
}

// ------------------------------------------------------------ descriptors

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);  // 128-byte swizzle
}

// k-step kk (16 columns) of a tile of R rows read K-major
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16, 1024);
}

// k-step kk (16 rows) of a tile of R rows read MN-major (columns as N)
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, R * 128, 1024);
}

// ------------------------------------------------------------ wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// e^x as 2^(x log2 e) on the MUFU (ex2.approx): a few f32 ulps, far below
// the bf16 rounding of p; e^-inf = 0
__device__ __forceinline__ float exp_mufu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// k-step kk (accumulator columns 16 kk .. 16 kk + 15) as a bf16 A fragment
template <int N>
__device__ __forceinline__ void to_a_frag(const float (&d)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// D(64 x 32, f32) += A(64 x 16) . B(16 x 32), bf16 operands, f32 accumulation;
// A and B from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same with N = 64
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64, f32) += A(64 x 16) . B(16 x 64), bf16 operands, f32 accumulation;
// A from registers (to_a_frag), B from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the same with N = 128
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}


}  // namespace tl_tc
