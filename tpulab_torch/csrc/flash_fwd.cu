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
//   f32 runs as f32 FMAs, bf16 is widened to f32, whose product is exact);
// - p is rounded to v's dtype before P.V, the denominator sums unrounded p;
// - o = acc / l in f32, then rounded to q's dtype; lse = m + log(l).
//
// Bound: operations, at the shapes of the model path (s >= 1024: 4*s*s*d
// flops per head against 4*s*d*2 bytes per head).  This first kernel runs
// on the f32 FMA pipes, not the tensor cores, so its ceiling is the card's
// 67 TFLOP/s f32 rate whatever the dtype.  The design keeps the scores out
// of device memory: one block per (64-query tile, batch*head) stages each
// K/V tile in shared memory as f32, and each query row lives in registers
// of TPR threads (its slice of q, of the accumulator, and the tile's
// scores), which reduce each dot product with warp shuffles.  Tiles wholly
// outside the causal or window range are never loaded (the Pallas kernel's
// _block_edges); tiles wholly inside skip the positional mask.  Blocks run
// the heaviest causal query tiles first.
//
// GQA: K and V arrive at kv_heads width; query head i reads kv head
// i / (heads / kv_heads), the contiguous mapping of repeat_kv.
//
// The build passes -fmad=false for B1-B3's byte equality; this kernel has
// no byte-equality target and writes fmaf where it wants a fused multiply-add.

#include "flash_common.cuh"

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

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int b, int s,
           int h, int kvh, const long long* st, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<D, T><<<grid, Geometry<D>::THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), s, h, kvh, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, void* lse, int b,
               int s, int h, int kvh, const long long* st, float scale, int causal, int window,
               int q_offset, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<8, T>(q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window, q_offset, stream);
    case 16: return launch<16, T>(q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window, q_offset, stream);
    case 32: return launch<32, T>(q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window, q_offset, stream);
    case 64: return launch<64, T>(q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window, q_offset, stream);
    case 128: return launch<128, T>(q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window, q_offset, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  Strides are in elements; the head
// dimension is contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int tl_flash_fwd(int dtype, int d, const void* q, const void* k, const void* v,
                            void* o, void* lse, int b, int s, int h, int kvh, long long qsb,
                            long long qss, long long qsh, long long ksb, long long kss,
                            long long ksh, long long vsb, long long vss, long long vsh,
                            float scale, int causal, int window, int q_offset, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window, q_offset, cs);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, s, h, kvh, st, scale, causal, window,
                                     q_offset, cs);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
