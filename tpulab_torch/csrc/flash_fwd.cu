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
// - scores are products of the inputs' values summed in f32 (bf16 products
//   are exact in the tensor cores' f32 accumulation; f32 products run as
//   three TF32 passes, flash_tf32.cuh, within the f32 limits);
// - p is rounded to v's dtype before P.V, the denominator sums unrounded p;
// - o = acc / l in f32, then rounded to q's dtype; lse = m + log(l).
// exp is the MUFU's ex2 of x log2(e) (tl_tc::exp_mufu), a few f32 ulps
// from expf, far inside both dtypes' limits.
//
// Bound: operations, at the shapes of the model path (s >= 1024: 4*s*s*d
// flops per head against 4*s*d*2 bytes per head).  Both dtypes run on the
// tensor cores, one warpgroup per (64-query tile, batch*head):
//
// float32 (flash_fwd_tf32_kernel): the Pallas kernel runs f32 at
// Precision.HIGHEST, and one TF32 pass would miss its limit, so every
// product is three TF32 passes (495 TFLOP/s dense, a 165 TFLOP/s ceiling
// for f32 against the FMA pipes' 67).  q' is split into hi and lo parts once
// per block, through registers.  K/V tiles of 64 keys (32 from head dim 64
// on, so two blocks fit an SM) arrive raw by cp.async, the next tile's copy
// in flight while this one computes, and are split when they land.  S =
// Q'K^T is a wgmma (m64nBKk8 tf32, both operands K-major); the online
// softmax runs on its f32 accumulator in registers, each row's max and sum
// over the 4 threads that share it.  O += P V reduces over keys, so V
// would have to be K-major along keys, a transpose wgmma cannot make for
// tf32: it runs as mma.sync m16n8k8 tf32, P split in the registers of the
// score accumulator, V's fragments loaded from its natural tile.  Scores
// are summed in the tensor cores' order, not B5's (flash_common.cuh).
//
// bfloat16 (flash_fwd_wgmma_kernel) runs on the tensor cores (989 TFLOP/s).
// One warpgroup per (64-query tile, batch*head) holds the prescaled q' tile
// in shared memory; K/V tiles of 64 keys stay bf16 in 128-byte-swizzled
// shared memory, two stages filled by cp.async, so the next tile's copy is
// in flight while this one computes (flash_tc.cuh).  S = Q'K^T is a wgmma
// (m64n64k16, d / 16 k-steps); the online softmax runs on its f32
// accumulator in registers; P is rounded to bf16 straight into the A
// fragment of the second wgmma, O += P V, with V read MN-major (the
// transpose bit).  At head dim 8 the score product reads 16 columns, 8 of
// them zeroed; below 64 the P.V product computes a 64-column tile and
// stores the first d.
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
#include "flash_tf32.cuh"

#include <math.h>

namespace {

using namespace tl_flash;

// ------------------------------------------- float32 on the tensor cores

template <int D>
struct FwdTF32 {
  static constexpr int BK = tl_tf32::key_tile<D>();             // keys per tile
  static constexpr int QTILE = tl_tf32::tile_bytes<BQ, D>();   // bytes of a q' part
  static constexpr int TILE = tl_tf32::tile_bytes<BK, D>();    // bytes of a K or V part
  // alignment; q' hi and lo; K hi and lo; V hi and lo; the next raw K and V
  static constexpr int SMEM = 1024 + 2 * QTILE + 6 * TILE;
};

template <int D>
__global__ void __launch_bounds__(tl_tc::THREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int s, int h, int kvh, long long qsb,
                      long long qss, long long qsh, long long ksb, long long kss, long long ksh,
                      long long vsb, long long vss, long long vsh, float scale, int causal,
                      int window, int q_offset) {
  using namespace tl_tc;
  using C = FwdTF32<D>;
  constexpr int BK = C::BK, QTILE = C::QTILE, TILE = C::TILE;
  constexpr int NS = BK / 2, NA = D / 2;  // accumulator floats of S and of O
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sbase - raw);
  // q' hi, lo; K hi, lo; V hi, lo; raw K, raw V
  const uint32_t sqh = sbase, sql = sbase + QTILE;
  const uint32_t skh = sbase + 2 * QTILE, skl = skh + TILE, svh = skl + TILE, svl = svh + TILE;
  const uint32_t srk = svl + TILE, srv = srk + TILE;
  auto at = [&](uint32_t a) { return base + (a - sbase); };

  const int tid = threadIdx.x;
  const int g = (tid % 32) / 4, t = tid % 4;  // the lane's group and its place in it
  const int r0 = (tid / 32) * 16 + g;         // this thread's rows: r0, r0 + 8
  const int cq = 2 * t;                       // its columns: 8 j + cq, + 1
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
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

  const float* kbase = k + bi * ksb + kh * ksh;
  const float* vbase = v + bi * vsb + kh * vsh;
  auto load_kv = [&](int kt) {
    const long long k0 = static_cast<long long>(kt) * BK;
    tl_tf32::load_tile<BK, D>(srk, kbase + k0 * kss, kss, s - kt * BK, tid);
    tl_tf32::load_tile<BK, D>(srv, vbase + k0 * vss, vss, s - kt * BK, tid);
  };
  if (kt_begin < kt_end) load_kv(kt_begin);
  cp_commit();
  // q' = f32(q * scale), split once for the block
  tl_tf32::stage_split<BQ, D>(at(sqh), at(sql),
                              q + bi * qsb + static_cast<long long>(qt) * BQ * qss + hi * qsh,
                              qss, s - qt * BQ, scale, tid);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};  // this thread's share of each row's denominator

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    cp_wait<0>();
    __syncthreads();  // this tile landed; every warp is done with the last one's parts
    tl_tf32::split_tile<BK, D>(at(srk), at(skh), at(skl), 1.0f, tid);
    tl_tf32::split_tile<BK, D>(at(srv), at(svh), at(svl), 1.0f, tid);
    fence_async_shared();
    __syncthreads();  // the parts are visible to wgmma; the raw tiles are free
    if (kt + 1 < kt_end) load_kv(kt + 1);  // in flight while this tile computes
    cp_commit();

    // S = Q' K^T in three passes
    float sc[NS];
    wg_fence();
    tl_tf32::wgmma_x3<BK, D>(sc, sqh, sql, skh, skl);
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

    // O = alpha O + P V, the tile's P V in three passes, P from the score accumulator
    float pv[NA];
    tl_tf32::mma_x3<BK, D>(pv, sc, at(svh), at(svl), g, t);
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = fmaf(acc[i], alpha[(i / 2) % 2], pv[i]);
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    const int qi = qt * BQ + r0 + 8 * rr;
    if (qi < s) {
      const long long r = (static_cast<long long>(bi) * s + qi) * h + hi;
      float* orow = o + r * D;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const float a0 = acc[4 * j + 2 * rr], a1 = acc[4 * j + 2 * rr + 1];
        *reinterpret_cast<float2*>(orow + 8 * j + cq) =
            l[rr] > 0.0f ? make_float2(a0 / l[rr], a1 / l[rr]) : make_float2(0.0f, 0.0f);
      }
      if (cq == 0) lse[r] = l[rr] > 0.0f ? m[rr] + logf(l[rr]) : -INFINITY;
    }
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, void* lse, int b, int s,
                int h, int kvh, const long long* st, float scale, int causal, int window,
                int q_offset, int smem, cudaStream_t stream) {
  if (smem != FwdTF32<D>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_tf32_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  kernel<<<grid, tl_tc::THREADS, smem, stream>>>(
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

// float32 on the tensor cores, three TF32 passes.  Strides are in
// elements; the head dimension is contiguous; the base pointers and the
// batch, seq and head strides are 16-byte aligned, and smem is the block's
// dynamic shared memory in bytes (the wrapper's tf32_shared_bytes; any
// other value is refused).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tl_flash_fwd(int d, const void* q, const void* k, const void* v, void* o,
                            void* lse, int b, int s, int h, int kvh, long long qsb, long long qss,
                            long long qsh, long long ksb, long long kss, long long ksh,
                            long long vsb, long long vss, long long vsh, float scale, int causal,
                            int window, int q_offset, int smem, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return launch_tf32<8>(TL_FLASH_ARGS, smem, cs);
    case 16: return launch_tf32<16>(TL_FLASH_ARGS, smem, cs);
    case 32: return launch_tf32<32>(TL_FLASH_ARGS, smem, cs);
    case 64: return launch_tf32<64>(TL_FLASH_ARGS, smem, cs);
    case 128: return launch_tf32<128>(TL_FLASH_ARGS, smem, cs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bfloat16 on the tensor cores.  As tl_flash_fwd, with smem the wrapper's
// tc_shared_bytes.
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

namespace {

template <int D>
int fwd_blocks(int* blocks) {
  return tl_tf32::blocks_per_sm(flash_fwd_tf32_kernel<D>, FwdTF32<D>::SMEM, blocks);
}

}  // namespace

// Blocks of the float32 instance for head dim d that one SM holds at once,
// into *blocks; returns the CUDA error
extern "C" int tl_flash_fwd_blocks_per_sm(int d, int* blocks) {
  switch (d) {
    case 8: return fwd_blocks<8>(blocks);
    case 16: return fwd_blocks<16>(blocks);
    case 32: return fwd_blocks<32>(blocks);
    case 64: return fwd_blocks<64>(blocks);
    case 128: return fwd_blocks<128>(blocks);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
