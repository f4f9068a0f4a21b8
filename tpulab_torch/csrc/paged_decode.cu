// Kernel B7: single-token decode attention read in place from the paged KV
// pools through each slot's block table.
//
// Replaces tpulab/ops/pallas/paged.py::_kernel as reached through
// paged_attend_pallas.  The function is the Pallas kernel's:
// - q is divided by sqrt(d) rounded to q's dtype, in q's dtype (the
//   wrapper passes that divisor; the quotient is rounded back to T here);
// - scores are q times k, both in q's dtype, summed in f32; keys at or past
//   the slot's length, and with a window those at or below
//   length - 1 - window, are masked with NEG_INF, the float32 minimum;
// - running max, denominator and accumulator in f32, p not rounded, v
//   widened to f32, output acc / l rounded once to q's dtype;
// - int8 pools: (int8 -> f32) * scale, rounded to q's dtype, the engine's
//   _pool_gather recipe, for K and for V;
// - a slot of length 0 sees no key: acc = 0, l = 0, and o = 0/0 = NaN.
//
// Layout: q and out (S, 1, h, D); pools (P, BS, kvh, D) contiguous, or int8
// data of that shape with f32 scales (P, BS, kvh); tables (S, M) int32;
// lengths (S,) int32.  Query head i reads kv head i / (h / kvh).
//
// Design.  One block per (slot, kv head) holds the g = h / kvh query rows
// of that head's group (no padding of the group: the Pallas kernel pads g
// to a multiple of 8 only for the TPU's tiles) and loops over the slot's
// live key positions, CHUNK at a time (64 for D <= 64, 32 for D = 128, so
// four or two 16-position table blocks per step).  This loop replaces the
// Pallas grid's sequential table axis, whose running (max, denominator,
// accumulator) the TPU carries in VMEM scratch; here they live in shared
// memory for the whole loop.  The block reads its own table entries from
// device memory (Hopper has no scalar prefetch).  Each step stages the
// chunk's K and V rows in shared memory as f32 after dequant-and-round
// (rows padded to D + 1 floats, so a warp reading one column of 32 rows
// hits 32 banks), forms the g x CHUNK scores with f32 FMAs, updates each
// row's running max and denominator (one warp per row), and folds p.V into
// the accumulator.
//
// Dead positions are never loaded: the loop starts at the chunk holding
// the first visible key (length - window with a window, else 0) and stops
// at length.  That changes no bit of the Pallas function.  There a table
// block past the length never runs (pl.when), and a block wholly below the
// window runs while every score is NEG_INF, so m stays NEG_INF and the
// block adds exp(0) = 1 per position to l and its v rows to acc; the first
// block with a visible key then has a finite max, and its
// alpha = exp(NEG_INF - m) = 0 multiplies those sums to exactly 0.  A
// masked position inside a live chunk gets p = 0, as exp(NEG_INF - m) is 0
// for a finite m.
//
// Bound: bytes.  A decode step reads every live K/V position once and does
// 4 * g * D flops per position and kv head, far below the card's ratio of
// flops to bytes.  This first kernel runs one block per (slot, kv head):
// at the serving bench's 8 slots and 2 kv heads that is 16 blocks on 132
// SMs; splitting a slot's key range across blocks (flash-decoding) is
// later work.

#include "flash_common.cuh"

#include <cfloat>
#include <cstdint>

namespace {

using tl_flash::from_f32;
using tl_flash::round_to;
using tl_flash::to_f32;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -FLT_MAX;

template <int D>
struct Chunk {
  static constexpr int CK = D <= 64 ? 64 : 32;  // key positions staged per step
  static constexpr int KS = D + 1;              // padded row stride of staged K/V
  static constexpr int SS = CK + 1;             // padded row stride of the scores
  static constexpr int PER = CK * D / THREADS;  // K (and V) elements each thread stages
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// one K or V element as the attention reads it, in f32
template <typename T, bool Q>
__device__ __forceinline__ float pool_value(const void* pool, const float* scale, long long row,
                                            int dd, int D) {
  if constexpr (Q) {
    const float x = static_cast<float>(static_cast<const int8_t*>(pool)[row * D + dd]);
    return round_to<T>(__fmul_rn(x, scale[row]));
  } else {
    return to_f32<T>(static_cast<const T*>(pool)[row * D + dd]);
  }
}

template <int D, typename T, bool Q>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const void* __restrict__ kpool,
                    const void* __restrict__ vpool, const float* __restrict__ kscale,
                    const float* __restrict__ vscale, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int h, int kvh, int bs,
                    int M, int window, float qdiv) {
  using C = Chunk<D>;
  constexpr int CK = C::CK, KS = C::KS, SS = C::SS, PER = C::PER;
  extern __shared__ float smem[];
  const int g = h / kvh;
  float* ks = smem;              // CK x KS
  float* vs = ks + CK * KS;      // CK x KS
  float* qs = vs + CK * KS;      // g x D, the prescaled query rows
  float* acc = qs + g * D;       // g x D
  float* sc = acc + g * D;       // g x SS, scores then p
  float* ms = sc + g * SS;       // g running maxima
  float* ls = ms + g;            // g running denominators
  float* al = ls + g;            // g rescale factors of the current step

  const int s = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int length = lengths[s];
  const int lo = window > 0 ? max(0, length - window) : 0;  // first visible key
  const long long qbase = (static_cast<long long>(s) * h + c * g) * D;

  for (int e = tid; e < g * D; e += THREADS) {
    qs[e] = round_to<T>(__fdiv_rn(to_f32<T>(q[qbase + e]), qdiv));
    acc[e] = 0.0f;
  }
  for (int r = tid; r < g; r += THREADS) {
    ms[r] = NEG_INF;
    ls[r] = 0.0f;
  }
  __syncthreads();

  const int* trow = tables + static_cast<long long>(s) * M;
  for (int c0 = (lo / CK) * CK; c0 < length; c0 += CK) {
    const int jlo = max(lo - c0, 0);
    const int jhi = min(length - c0, CK);
    // stage this chunk's visible K/V rows (zeros elsewhere; never read)
    float kr[PER], vr[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      const int j = e / D;
      const int dd = e % D;
      kr[i] = 0.0f;
      vr[i] = 0.0f;
      if (j >= jlo && j < jhi) {
        const int pos = c0 + j;
        const long long row = (static_cast<long long>(trow[pos / bs]) * bs + pos % bs) * kvh + c;
        kr[i] = pool_value<T, Q>(kpool, kscale, row, dd, D);
        vr[i] = pool_value<T, Q>(vpool, vscale, row, dd, D);
      }
    }
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = tid + i * THREADS;
      ks[(e / D) * KS + e % D] = kr[i];
      vs[(e / D) * KS + e % D] = vr[i];
    }
    __syncthreads();

    // scores of the g rows against the chunk's keys
    for (int e = tid; e < g * CK; e += THREADS) {
      const int r = e / CK;
      const int j = e % CK;
      float sv = NEG_INF;
      if (j >= jlo && j < jhi) {
        const float* qrow = qs + r * D;
        const float* krow = ks + j * KS;
        float part = 0.0f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) part = fmaf(qrow[dd], krow[dd], part);
        sv = part;
      }
      sc[r * SS + j] = sv;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < g; r += WARPS) {
      float tmax = NEG_INF;
      for (int j = lane; j < CK; j += 32) tmax = fmaxf(tmax, sc[r * SS + j]);
      tmax = warp_max(tmax);
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.0f;
      for (int j = lane; j < CK; j += 32) {
        const float p = (j >= jlo && j < jhi) ? expf(sc[r * SS + j] - m_new) : 0.0f;
        sc[r * SS + j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al[r] = alpha;
        ls[r] = __fadd_rn(__fmul_rn(ls[r], alpha), psum);
        ms[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
    for (int e = tid; e < g * D; e += THREADS) {
      const int r = e / D;
      const int dd = e % D;
      const float* prow = sc + r * SS;
      float a = __fmul_rn(acc[e], al[r]);
      for (int j = jlo; j < jhi; ++j) a = fmaf(prow[j], vs[j * KS + dd], a);
      acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < g * D; e += THREADS) {
    out[qbase + e] = from_f32<T>(__fdiv_rn(acc[e], ls[e / D]));  // 0/0 = NaN at length 0
  }
}

template <int D, typename T, bool Q>
int launch(const void* q, const void* kp, const void* vp, const void* ksc, const void* vsc,
           const void* tables, const void* lengths, void* out, int S, int h, int kvh, int bs,
           int M, int window, float qdiv, int smem, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<D, T, Q>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(S, kvh), THREADS, smem, stream>>>(
      static_cast<const T*>(q), kp, vp, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), h, kvh, bs, M, window, qdiv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool Q>
int dispatch_d(int d, const void* q, const void* kp, const void* vp, const void* ksc,
               const void* vsc, const void* tables, const void* lengths, void* out, int S, int h,
               int kvh, int bs, int M, int window, float qdiv, int smem, cudaStream_t stream) {
#define TL_PAGED_CASE(DIM)                                                                     \
  case DIM:                                                                                    \
    return launch<DIM, T, Q>(q, kp, vp, ksc, vsc, tables, lengths, out, S, h, kvh, bs, M,     \
                             window, qdiv, smem, stream);
  switch (d) {
    TL_PAGED_CASE(8)
    TL_PAGED_CASE(16)
    TL_PAGED_CASE(32)
    TL_PAGED_CASE(64)
    TL_PAGED_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TL_PAGED_CASE
}

template <typename T>
int dispatch_q(int quantized, int d, const void* q, const void* kp, const void* vp,
               const void* ksc, const void* vsc, const void* tables, const void* lengths,
               void* out, int S, int h, int kvh, int bs, int M, int window, float qdiv, int smem,
               cudaStream_t stream) {
  if (quantized) {
    return dispatch_d<T, true>(d, q, kp, vp, ksc, vsc, tables, lengths, out, S, h, kvh, bs, M,
                               window, qdiv, smem, stream);
  }
  return dispatch_d<T, false>(d, q, kp, vp, ksc, vsc, tables, lengths, out, S, h, kvh, bs, M,
                              window, qdiv, smem, stream);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (of q, out and a native pool).  With
// quantized != 0 the pools are int8 and ks, vs their f32 scales; otherwise
// ks and vs are unused.  smem is the block's dynamic shared memory in
// bytes (the wrapper's shared_bytes).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int tl_paged_decode(int dtype, int d, int quantized, const void* q, const void* kp,
                               const void* vp, const void* ks, const void* vs,
                               const void* tables, const void* lengths, void* out, int S, int h,
                               int kvh, int bs, int M, int window, float qdiv, int smem,
                               void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_q<float>(quantized, d, q, kp, vp, ks, vs, tables, lengths, out, S, h, kvh,
                             bs, M, window, qdiv, smem, cs);
  }
  if (dtype == 1) {
    return dispatch_q<__nv_bfloat16>(quantized, d, q, kp, vp, ks, vs, tables, lengths, out, S,
                                     h, kvh, bs, M, window, qdiv, smem, cs);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
