// Kernel B4: the flash-attention forward over (batch, seq, heads, head_dim).
//
// Replaces tpulab/ops/pallas/attention.py::_flash_kernel as reached through
// _flash_fwd_call and _flash_bshd: exact softmax attention with an online
// (running max, denominator, f32 accumulator) recurrence, causal masking, a
// sliding window that keeps k in (q - w, q], a static query offset, and the
// per-row logsumexp.  A row with no visible key gets o = 0 and lse = -inf.
//
// Numerics, as in the Pallas kernel and its wrapper:
// - q is scaled by 1/sqrt(d) in f32 and rounded back to q's dtype first;
// - scores are exact products of the inputs' values summed in f32 (no TF32:
//   f32 runs as f32 FMAs; bf16 products are exact in the tensor cores' f32
//   accumulation);
// - p is rounded to v's dtype before P.V, the denominator sums unrounded p;
// - o = acc / l in f32, then rounded to q's dtype; lse = m + log(l).
//
// Bound: operations, at the shapes of the model path (s >= 1024: 4*s*s*d
// flops per head against 4*s*d*2 bytes per head), so one kernel per dtype:
//
// float32 (flash_fwd_kernel) runs on the f32 FMA pipes (67 TFLOP/s): the
// Pallas kernel runs f32 at Precision.HIGHEST, and TF32 would miss its
// limit.  One block per (64-query tile, batch*head) stages each K/V tile in
// shared memory, and each query row lives in registers of TPR threads (its
// slice of q, of the accumulator, and the tile's scores), which reduce each
// dot product with warp shuffles.
//
// bfloat16 (flash_fwd_wgmma_kernel) runs on the tensor cores (989 TFLOP/s).
// One warpgroup per (64-query tile, batch*head) holds the prescaled q' tile
// in shared memory; K/V tiles of 64 keys stay bf16 in 128-byte-swizzled
// shared memory, two stages filled by cp.async, so the next tile's copy is
// in flight while this one computes (flash_tc.cuh).  S = Q'K^T is a wgmma
// (m64n64k16, d / 16 k-steps); the online softmax runs on its f32
// accumulator in registers, each row's max and sum over the 4 threads that
// share it; P is rounded to bf16 straight into the A fragment of the second
// wgmma, O += P V, with V read MN-major (the transpose bit).  exp is the
// MUFU's ex2 of x log2(e), a few f32 ulps from expf.  Scores are summed in
// the tensor cores' order, not row_sum's (flash_common.cuh).  At head dim 8
// the score product reads 16 columns, 8 of them zeroed; below 64 the P.V
// product computes a 64-column tile and stores the first d.
//
// Both: tiles wholly outside the causal or window range are never loaded
// (the Pallas kernel's _block_edges); tiles wholly inside skip the
// positional mask.  Blocks run the heaviest causal query tiles first.
//
// GQA: K and V arrive at kv_heads width; query head i reads kv head
// i / (heads / kv_heads), the contiguous mapping of repeat_kv.
//
// The build passes -fmad=false for B1-B3's byte equality; this kernel has
// no byte-equality target and writes fmaf where it wants a fused multiply-add.

#include "flash_common.cuh"
#include "flash_tc.cuh"

#include <math.h>

namespace {

using namespace tl_flash;

template <int D, typename T>
__global__ void __launch_bounds__(Geometry<D>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int s, int h, int kvh,
                 long long qsb, long long qss, long long qsh, long long ksb, long long kss,
                 long long ksh, long long vsb, long long vss, long long vsh, float scale,
                 int causal, int window, int q_offset) {
  using G = Geometry<D>;
  constexpr int TPR = G::TPR, DPT = G::DPT, CPT = G::CPT, BK = G::BK, NC = D / 4;
  __shared__ float4 ks[BK][NC];
  __shared__ float4 vs[BK][NC];
  float* ksf = reinterpret_cast<float*>(ks);
  float* vsf = reinterpret_cast<float*>(vs);

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kh = hi / (h / kvh);
  const int row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int qi = qt * BQ + row;
  const long long qpos = static_cast<long long>(q_offset) + qi;

  // this thread's slice of the (prescaled) query row: dims (c*TPR + t)*4 + e
  float qr[DPT];
  const T* qrow = q + bi * qsb + static_cast<long long>(min(qi, s - 1)) * qss + hi * qsh;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c * 4 + e] = prescaled<T>(qrow[(c * TPR + t) * 4 + e], scale);
    }
  }
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.0f;
  float m = -INFINITY;
  float l = 0.0f;

  // the keys this query tile can see
  const long long q_lo = static_cast<long long>(q_offset) + qt * BQ;
  const long long q_hi = static_cast<long long>(q_offset) + min(qt * BQ + BQ, s) - 1;
  long long k_begin = 0, k_end = s - 1;  // inclusive
  if (causal) {
    k_end = min(k_end, q_hi);
    if (window > 0) k_begin = max(0LL, q_lo - window + 1);
  }
  const int kt_begin = static_cast<int>(k_begin / BK);
  const int kt_end = k_end >= k_begin ? static_cast<int>(k_end / BK) + 1 : kt_begin;

  const T* kbase = k + bi * ksb + kh * ksh;
  const T* vbase = v + bi * vsb + kh * vsh;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < BK * D; e += G::THREADS) {
      const int j = e / D;
      const int dd = e % D;
      const int kj = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kj < s) {
        kx = to_f32<T>(kbase[kj * kss + dd]);
        vx = to_f32<T>(vbase[kj * vss + dd]);
      }
      ksf[j * D + dd] = kx;
      vsf[j * D + dd] = vx;
    }
    __syncthreads();

    // a tile inside every row's range needs no positional mask
    const bool full = k0 + BK <= s &&
                      (!causal || (k0 + BK - 1 <= q_lo && (window == 0 || k0 > q_hi - window)));
    float sc[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 kk = ks[j][c * TPR + t];
        part = fmaf(qr[c * 4 + 0], kk.x, part);
        part = fmaf(qr[c * 4 + 1], kk.y, part);
        part = fmaf(qr[c * 4 + 2], kk.z, part);
        part = fmaf(qr[c * 4 + 3], kk.w, part);
      }
      part = row_sum<TPR>(part);
      if (!full) {
        const long long kp = k0 + j;
        bool keep = kp < s;
        if (causal) {
          keep = keep && kp <= qpos;
          if (window > 0) keep = keep && kp > qpos - window;
        }
        if (!keep) part = -INFINITY;
      }
      sc[j] = part;
      tile_max = fmaxf(tile_max, part);
    }

    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {  // else this row has seen no visible key yet
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float p = expf(sc[j] - m_new);
        psum += p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float4 vv = vs[j][c * TPR + t];
          acc[c * 4 + 0] = fmaf(pr, vv.x, acc[c * 4 + 0]);
          acc[c * 4 + 1] = fmaf(pr, vv.y, acc[c * 4 + 1]);
          acc[c * 4 + 2] = fmaf(pr, vv.z, acc[c * 4 + 2]);
          acc[c * 4 + 3] = fmaf(pr, vv.w, acc[c * 4 + 3]);
        }
      }
      l = fmaf(l, alpha, psum);
      m = m_new;
    }
  }

  if (qi < s) {
    const long long r = (static_cast<long long>(bi) * s + qi) * h + hi;
    T* orow = o + r * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float val = l > 0.0f ? acc[c * 4 + e] / l : 0.0f;
        orow[(c * TPR + t) * 4 + e] = from_f32<T>(val);
      }
    }
    if (t == 0) lse[r] = l > 0.0f ? m + logf(l) : -INFINITY;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b, int s, int h,
           int kvh, const long long* st, float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<D, float><<<grid, Geometry<D>::THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), s, h, kvh, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ bf16 on the tensor cores

template <int D>
struct FwdTC {
  static constexpr int NP = D > 64 ? 2 : 1;               // 64-column panels of a row
  static constexpr int KSTEPS = (D < 16 ? 16 : D) / 16;  // k-steps of the score product
  static constexpr int BK = 64;                           // keys per tile
  static constexpr int QTILE = BQ * NP * 128;             // bytes of the q' tile
  static constexpr int TILE = BK * NP * 128;              // bytes of a K or V tile
  static constexpr int SMEM = 1024 + QTILE + 4 * TILE;    // alignment; q'; two stages of K, V
};

template <int D>
__global__ void __launch_bounds__(tl_tc::THREADS)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int s, int h, int kvh, long long qsb,
                       long long qss, long long qsh, long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh, float scale, int causal,
                       int window, int q_offset) {
  using namespace tl_tc;
  using C = FwdTC<D>;
  constexpr int BK = C::BK, TILE = C::TILE;
  constexpr int NS = BK / 2, NA = C::NP * 32;  // accumulator floats of S and of O
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sbase - raw);
  // q', then K stages 0 and 1, then V stages 0 and 1
  const uint32_t sq = sbase;
  auto sk = [&](int st) { return sbase + C::QTILE + st * TILE; };
  auto sv = [&](int st) { return sbase + C::QTILE + (2 + st) * TILE; };

  const int tid = threadIdx.x;
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's rows: r0, r0 + 8
  const int cq = (tid % 4) * 2;                      // its columns: 8 j + cq, + 1
  const int qt = gridDim.x - 1 - blockIdx.x;         // heaviest causal tiles first
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kh = hi / (h / kvh);

  // the keys this query tile can see
  const long long q_lo = static_cast<long long>(q_offset) + qt * BQ;
  const long long q_hi = static_cast<long long>(q_offset) + min(qt * BQ + BQ, s) - 1;
  long long k_begin = 0, k_end = s - 1;  // inclusive
  if (causal) {
    k_end = min(k_end, q_hi);
    if (window > 0) k_begin = max(0LL, q_lo - window + 1);
  }
  const int kt_begin = static_cast<int>(k_begin / BK);
  const int kt_end = k_end >= k_begin ? static_cast<int>(k_end / BK) + 1 : kt_begin;

  const __nv_bfloat16* kbase = k + bi * ksb + kh * ksh;
  const __nv_bfloat16* vbase = v + bi * vsb + kh * vsh;
  auto load_kv = [&](int kt, int st) {
    const long long k0 = static_cast<long long>(kt) * BK;
    load_tile<BK, D>(sk(st), kbase + k0 * kss, kss, s - kt * BK, tid);
    load_tile<BK, D>(sv(st), vbase + k0 * vss, vss, s - kt * BK, tid);
  };
  if (D == 8) {
    zero_pad8<BQ>(base, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i) zero_pad8<BK>(base + C::QTILE + i * TILE, tid);
  }
  load_tile<BQ, D>(sq, q + bi * qsb + static_cast<long long>(qt) * BQ * qss + hi * qsh, qss,
                   s - qt * BQ, tid);
  cp_commit();
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_commit();
  cp_wait<1>();  // the Q tile
  prescale_tile<BQ, D>(base, scale, tid);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this thread's share of each row's denominator

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, st ^ 1);  // in flight while this tile computes
    cp_commit();
    cp_wait<1>();
    fence_async_shared();
    __syncthreads();

    // S = Q' K^T
    float sc[NS];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      wgmma_ss_n64(sc, desc_k<BQ>(sq, kk), desc_k<BK>(sk(st), kk), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    // a tile inside every row's range needs no positional mask
    const int k0 = kt * BK;
    const bool full = k0 + BK <= s &&
                      (!causal || (k0 + BK - 1 <= q_lo && (window == 0 || k0 > q_hi - window)));
    if (!full) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const long long kp = k0 + 8 * (i / 4) + cq + (i % 2);
        const long long qpos = q_lo + r0 + 8 * ((i / 2) % 2);
        bool keep = kp < s;
        if (causal) {
          keep = keep && kp <= qpos;
          if (window > 0) keep = keep && kp > qpos - window;
        }
        if (!keep) sc[i] = -INFINITY;
      }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < NS; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float ref[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      ref[rr] = mx[rr] == -INFINITY ? 0.0f : mx[rr];  // a row with no visible key yet
      alpha[rr] = exp_mufu(m[rr] - ref[rr]);
      m[rr] = mx[rr];
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      sc[i] = exp_mufu(sc[i] - ref[(i / 2) % 2]);
      ps[(i / 2) % 2] += sc[i];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = fmaf(l[rr], alpha[rr], ps[rr]);
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha[(i / 2) % 2];

    // O += bf16(P) V, P straight from the score accumulator
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_a_frag(sc, kk, pa[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t bv = desc_mn<BK>(sv(st), kk);
      if constexpr (C::NP == 1) {
        wgmma_rs_n64(acc, pa[kk], bv, 1);
      } else {
        wgmma_rs_n128(acc, pa[kk], bv, 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int qi = qt * BQ + r0 + 8 * rr;
    if (qi < s) {
      const long long r = (static_cast<long long>(bi) * s + qi) * h + hi;
      __nv_bfloat16* orow = o + r * D;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int col = 8 * j + cq;
        if (col < D) {
          const float a0 = acc[4 * j + 2 * rr], a1 = acc[4 * j + 2 * rr + 1];
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = l[rr] > 0.0f
              ? __floats2bfloat162_rn(a0 / l[rr], a1 / l[rr])
              : __floats2bfloat162_rn(0.0f, 0.0f);
        }
      }
      if (cq == 0) lse[r] = l[rr] > 0.0f ? m[rr] + logf(l[rr]) : -INFINITY;
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, void* lse, int b, int s,
                 int h, int kvh, const long long* st, float scale, int causal, int window,
                 int q_offset, int smem, cudaStream_t stream) {
  if (smem != FwdTC<D>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_wgmma_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  kernel<<<grid, tl_tc::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), s, h, kvh, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define TL_FLASH_ARGS q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window, q_offset

// float32 on the FMA pipes.  Strides are in elements; the head dimension
// is contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tl_flash_fwd(int d, const void* q, const void* k, const void* v, void* o,
                            void* lse, int b, int s, int h, int kvh, long long qsb, long long qss,
                            long long qsh, long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh, float scale, int causal,
                            int window, int q_offset, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch<8>(TL_FLASH_ARGS, cs);
    case 16: return launch<16>(TL_FLASH_ARGS, cs);
    case 32: return launch<32>(TL_FLASH_ARGS, cs);
    case 64: return launch<64>(TL_FLASH_ARGS, cs);
    case 128: return launch<128>(TL_FLASH_ARGS, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bfloat16 on the tensor cores.  As tl_flash_fwd, and besides: the base
// pointers and the batch, seq and head strides are 16-byte aligned, and
// smem is the block's dynamic shared memory in bytes (the wrapper's
// tc_shared_bytes; any other value is refused).
extern "C" int tl_flash_fwd_bf16(int d, const void* q, const void* k, const void* v, void* o,
                                 void* lse, int b, int s, int h, int kvh, long long qsb,
                                 long long qss, long long qsh, long long ksb, long long kss,
                                 long long ksh, long long vsb, long long vss, long long vsh,
                                 float scale, int causal, int window, int q_offset, int smem,
                                 void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch_wgmma<8>(TL_FLASH_ARGS, smem, cs);
    case 16: return launch_wgmma<16>(TL_FLASH_ARGS, smem, cs);
    case 32: return launch_wgmma<32>(TL_FLASH_ARGS, smem, cs);
    case 64: return launch_wgmma<64>(TL_FLASH_ARGS, smem, cs);
    case 128: return launch_wgmma<128>(TL_FLASH_ARGS, smem, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
