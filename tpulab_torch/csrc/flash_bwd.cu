// Kernels B5 and B6: the flash-attention backward over (batch, seq, heads,
// head_dim), the gradient of kernel B4 (csrc/flash_fwd.cu).
//
// B5 replaces tpulab/ops/pallas/attention.py::_flash_bwd_dq_kernel and B6
// replaces _flash_bwd_dkv_kernel, both reached through _flash_bwd_call.
// With q' = q * (1/sqrt(d)) rounded to q's dtype (the forward's prescale),
// s = q'.k, p = exp(s - lse), dp = do.v and ds = p * (dp - delta), where
// delta = rowsum(do * o) - dlse comes in from the wrapper:
//   B5: dq' = sum_k ds * k, then dq = dq' * (1/sqrt(d)) in f32 rounded to
//       q's dtype: the chain autodiff gives the prescale, which tpulab
//       applies outside its custom_vjp and the port inside B4;
//   B6: dv = sum_q p * do, dk = sum_q ds * q'.
// Numerics follow the Pallas kernels: scores from the model-dtype q' and k
// summed in f32, p in f32 with masked positions set to 0 (never exp of a
// -inf lse), ds and p rounded to the operand dtype before their products,
// f32 accumulators, one rounding to the model dtype at the end.
//
// Blocks run in parallel, so the Pallas grids' sequential axes become loops
// inside a block: B5 has one block per (64-query tile, batch*head) and
// walks the key tiles; B6 has one block per (64-key tile, batch*kv_head)
// and walks the query tiles of every query head of its GQA group, so dk
// and dv come out at kv width, summed over the group in f32, with no
// atomics.  Tiles no row can see are never loaded (the Pallas kernels'
// _block_edges, at this kernel's tile size), and tiles that every row sees
// whole skip the positional mask.  No padding: positions past the sequence
// end are masked.
//
// Bound: operations at the model path's shapes (B5 6*d and B6 8*d flops per
// visible (query, key) pair, against ~4 reads of (s, d) per head).
//
// In float32 both run on the f32 FMA pipes (Precision.HIGHEST, no TF32):
// each row lives in registers of TPR threads (flash_common.cuh), and the
// tile that every row of the block reads is staged in shared memory as f32.
//
// In bfloat16 both run on the tensor cores (wgmma over flash_tc.cuh's
// 128-byte-swizzled bf16 panels, A operands of the d-wide products straight
// from the score accumulators' registers, exp the MUFU's as in B4):
//
// B5 (flash_dq_wgmma_kernel): one warpgroup holds the block's 64 queries,
// q' (prescaled in shared memory after its copy) and do resident in shared
// memory, each thread's two rows' lse and delta in registers, and dQ in f32
// registers across every key tile.  K and V tiles of 64 keys come in two
// stages filled by cp.async, the next in flight while this one computes.
// Per tile, three products: S = Q'K^T, with the instruction, operand
// layouts and k-steps of B4's, so p = exp(S - lse) comes from the very
// scores behind the forward's lse; dP = dO V^T; then, in f32 registers, p
// (0 where masked) and dS = p (dP - delta); and dQ += bf16(dS) K, K read
// MN-major.
//
// B6 (flash_dkv_wgmma_kernel): one warpgroup holds the block's 64 keys, K
// and V in shared memory, and dK, dV in f32 registers across every query
// tile of the group.  Query tiles of 64 rows (32 at head dim 128, so the
// registers fit) are staged bf16 with their lse and delta, two stages
// filled by cp.async; q' is prescaled in shared memory after its copy.
// Per tile, four products: S^T = K q'^T and dP^T = V do^T; P^T = exp(S^T -
// lse) (0 where masked) and dS^T = P^T (dP^T - delta) in f32 registers;
// then dV += bf16(P^T) do and dK += bf16(dS^T) q'.  It recomputes the
// scores in the tensor cores' order, as B4 computed them.

#include "flash_common.cuh"
#include "flash_tc.cuh"

#include <math.h>

namespace {

using namespace tl_flash;

template <int D, typename T>
__global__ void __launch_bounds__(Geometry<D>::THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int s, int h, int kvh,
                    float scale, int causal, int window, int q_offset) {
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
  // this row's index in the (batch, seq, heads) layout of q, do, lse, delta
  const long long r = (static_cast<long long>(bi) * s + min(qi, s - 1)) * h + hi;

  float qr[DPT], dor[DPT], acc[DPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long at = r * D + (c * TPR + t) * 4 + e;
      qr[c * 4 + e] = prescaled<T>(q[at], scale);
      dor[c * 4 + e] = to_f32<T>(dout[at]);
      acc[c * 4 + e] = 0.0f;
    }
  }
  const float row_lse = lse[r];
  const float row_delta = delta[r];

  // the keys this query tile can see (the forward's range)
  const long long q_lo = static_cast<long long>(q_offset) + qt * BQ;
  const long long q_hi = static_cast<long long>(q_offset) + min(qt * BQ + BQ, s) - 1;
  long long k_begin = 0, k_end = s - 1;  // inclusive
  if (causal) {
    k_end = min(k_end, q_hi);
    if (window > 0) k_begin = max(0LL, q_lo - window + 1);
  }
  const int kt_begin = static_cast<int>(k_begin / BK);
  const int kt_end = k_end >= k_begin ? static_cast<int>(k_end / BK) + 1 : kt_begin;

  const long long kv_row = static_cast<long long>(kvh) * D;  // elements between keys
  const T* kbase = k + static_cast<long long>(bi) * s * kv_row + kh * D;
  const T* vbase = v + static_cast<long long>(bi) * s * kv_row + kh * D;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < BK * D; e += G::THREADS) {
      const int j = e / D;
      const int dd = e % D;
      const int kj = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kj < s) {
        kx = to_f32<T>(kbase[kj * kv_row + dd]);
        vx = to_f32<T>(vbase[kj * kv_row + dd]);
      }
      ksf[j * D + dd] = kx;
      vsf[j * D + dd] = vx;
    }
    __syncthreads();

    // a tile inside every row's range needs no positional mask
    const bool full = k0 + BK <= s &&
                      (!causal || (k0 + BK - 1 <= q_lo && (window == 0 || k0 > q_hi - window)));
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sp = 0.0f, dpp = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 kk = ks[j][c * TPR + t];
        const float4 vv = vs[j][c * TPR + t];
        sp = fmaf(qr[c * 4 + 0], kk.x, sp);
        sp = fmaf(qr[c * 4 + 1], kk.y, sp);
        sp = fmaf(qr[c * 4 + 2], kk.z, sp);
        sp = fmaf(qr[c * 4 + 3], kk.w, sp);
        dpp = fmaf(dor[c * 4 + 0], vv.x, dpp);
        dpp = fmaf(dor[c * 4 + 1], vv.y, dpp);
        dpp = fmaf(dor[c * 4 + 2], vv.z, dpp);
        dpp = fmaf(dor[c * 4 + 3], vv.w, dpp);
      }
      sp = row_sum<TPR>(sp);
      dpp = row_sum<TPR>(dpp);
      bool keep = true;
      if (!full) {
        const long long kp = k0 + j;
        keep = kp < s;
        if (causal) {
          keep = keep && kp <= qpos;
          if (window > 0) keep = keep && kp > qpos - window;
        }
      }
      const float p = keep ? expf(sp - row_lse) : 0.0f;
      const float ds = round_to<T>(p * (dpp - row_delta));
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float4 kk = ks[j][c * TPR + t];
        acc[c * 4 + 0] = fmaf(ds, kk.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(ds, kk.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(ds, kk.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(ds, kk.w, acc[c * 4 + 3]);
      }
    }
  }

  if (qi < s) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dq_scaled = __fmul_rn(round_to<T>(acc[c * 4 + e]), scale);
        dq[r * D + (c * TPR + t) * 4 + e] = from_f32<T>(dq_scaled);
      }
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(Geometry<D>::THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int s, int h, int kvh, float scale, int causal, int window, int q_offset) {
  using G = Geometry<D>;
  constexpr int TPR = G::TPR, DPT = G::DPT, CPT = G::CPT, BT = G::BK, NC = D / 4;
  __shared__ float4 qs[BT][NC];
  __shared__ float4 dos[BT][NC];
  __shared__ float lses[BT];
  __shared__ float deltas[BT];
  float* qsf = reinterpret_cast<float*>(qs);
  float* dosf = reinterpret_cast<float*>(dos);

  const int kt = blockIdx.x;  // the first key tiles see the most causal query tiles
  const int bi = blockIdx.y / kvh;
  const int kh = blockIdx.y % kvh;
  const int group = h / kvh;
  const int row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int kj = kt * BQ + row;
  // this key's index in the (batch, seq, kv_heads) layout of k, v, dk, dv
  const long long rk = (static_cast<long long>(bi) * s + min(kj, s - 1)) * kvh + kh;

  float kr[DPT], vr[DPT], dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long at = rk * D + (c * TPR + t) * 4 + e;
      kr[c * 4 + e] = to_f32<T>(k[at]);
      vr[c * 4 + e] = to_f32<T>(v[at]);
      dk_acc[c * 4 + e] = 0.0f;
      dv_acc[c * 4 + e] = 0.0f;
    }
  }

  // the query rows that see some key of this tile
  const long long k_lo = static_cast<long long>(kt) * BQ;
  const long long k_hi = k_lo + BQ - 1;
  long long i_begin = 0, i_end = s - 1;  // inclusive, query row indices
  if (causal) {
    i_begin = max(0LL, k_lo - q_offset);
    if (window > 0) i_end = min(i_end, min(k_hi, s - 1LL) + window - 1 - q_offset);
  }
  const int qt_begin = static_cast<int>(i_begin / BT);
  const int qt_end = i_end >= i_begin ? static_cast<int>(i_end / BT) + 1 : qt_begin;

  for (int hi = kh * group; hi < kh * group + group; ++hi) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // every row is done with the previous tile
      for (int e = threadIdx.x; e < BT * D; e += G::THREADS) {
        const int i = e / D;
        const int dd = e % D;
        const int qi = q0 + i;
        float qx = 0.0f, dx = 0.0f;
        if (qi < s) {
          const long long at = ((static_cast<long long>(bi) * s + qi) * h + hi) * D + dd;
          qx = prescaled<T>(q[at], scale);
          dx = to_f32<T>(dout[at]);
        }
        qsf[i * D + dd] = qx;
        dosf[i * D + dd] = dx;
      }
      for (int i = threadIdx.x; i < BT; i += G::THREADS) {
        const int qi = q0 + i;
        float l = 0.0f, dl = 0.0f;
        if (qi < s) {
          const long long rq = (static_cast<long long>(bi) * s + qi) * h + hi;
          l = lse[rq];
          dl = delta[rq];
        }
        lses[i] = l;
        deltas[i] = dl;
      }
      __syncthreads();

      // a tile whose every query row sees every key of this block needs no mask
      const long long q_lo = static_cast<long long>(q_offset) + q0;
      const long long q_hi = q_lo + BT - 1;
      const bool full = q0 + BT <= s &&
                        (!causal || (k_hi <= q_lo && (window == 0 || k_lo > q_hi - window)));
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float sp = 0.0f, dpp = 0.0f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float4 qq = qs[i][c * TPR + t];
          const float4 dd = dos[i][c * TPR + t];
          sp = fmaf(qq.x, kr[c * 4 + 0], sp);
          sp = fmaf(qq.y, kr[c * 4 + 1], sp);
          sp = fmaf(qq.z, kr[c * 4 + 2], sp);
          sp = fmaf(qq.w, kr[c * 4 + 3], sp);
          dpp = fmaf(dd.x, vr[c * 4 + 0], dpp);
          dpp = fmaf(dd.y, vr[c * 4 + 1], dpp);
          dpp = fmaf(dd.z, vr[c * 4 + 2], dpp);
          dpp = fmaf(dd.w, vr[c * 4 + 3], dpp);
        }
        sp = row_sum<TPR>(sp);
        dpp = row_sum<TPR>(dpp);
        bool keep = true;
        if (!full) {
          const int qi = q0 + i;
          keep = qi < s;
          if (causal) {
            const long long qpos = static_cast<long long>(q_offset) + qi;
            keep = keep && kj <= qpos;
            if (window > 0) keep = keep && kj > qpos - window;
          }
        }
        const float p = keep ? expf(sp - lses[i]) : 0.0f;
        const float ds = p * (dpp - deltas[i]);
        const float pr = round_to<T>(p);
        const float dsr = round_to<T>(ds);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float4 qq = qs[i][c * TPR + t];
          const float4 dd = dos[i][c * TPR + t];
          dv_acc[c * 4 + 0] = fmaf(pr, dd.x, dv_acc[c * 4 + 0]);
          dv_acc[c * 4 + 1] = fmaf(pr, dd.y, dv_acc[c * 4 + 1]);
          dv_acc[c * 4 + 2] = fmaf(pr, dd.z, dv_acc[c * 4 + 2]);
          dv_acc[c * 4 + 3] = fmaf(pr, dd.w, dv_acc[c * 4 + 3]);
          dk_acc[c * 4 + 0] = fmaf(dsr, qq.x, dk_acc[c * 4 + 0]);
          dk_acc[c * 4 + 1] = fmaf(dsr, qq.y, dk_acc[c * 4 + 1]);
          dk_acc[c * 4 + 2] = fmaf(dsr, qq.z, dk_acc[c * 4 + 2]);
          dk_acc[c * 4 + 3] = fmaf(dsr, qq.w, dk_acc[c * 4 + 3]);
        }
      }
    }
  }

  if (kj < s) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long at = rk * D + (c * TPR + t) * 4 + e;
        dk[at] = from_f32<T>(dk_acc[c * 4 + e]);
        dv[at] = from_f32<T>(dv_acc[c * 4 + e]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int b, s, h, kvh;
  float scale;
  int causal, window, q_offset;
  cudaStream_t stream;
};

template <int D>
int launch_dq(const Args& a) {
  const dim3 grid((a.s + BQ - 1) / BQ, a.b * a.h);
  flash_bwd_dq_kernel<D, float><<<grid, Geometry<D>::THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), a.s, a.h, a.kvh, a.scale, a.causal, a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Args& a) {
  const dim3 grid((a.s + BQ - 1) / BQ, a.b * a.kvh);
  flash_bwd_dkv_kernel<D, float><<<grid, Geometry<D>::THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.s, a.h, a.kvh, a.scale, a.causal,
      a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ B6 in bf16 on the tensor cores

template <int D>
struct DkvTC {
  static constexpr int NP = D > 64 ? 2 : 1;               // 64-column panels of a row
  static constexpr int KSTEPS = (D < 16 ? 16 : D) / 16;  // k-steps of the score products
  static constexpr int BT = D > 64 ? 32 : 64;             // query rows per tile
  static constexpr int KTILE = BQ * NP * 128;             // bytes of the K or V tile
  static constexpr int QTILE = BT * NP * 128;             // bytes of a q' or do tile
  // alignment; K and V; two stages of q', do, lse and delta
  static constexpr int SMEM = 1024 + 2 * KTILE + 4 * QTILE + 4 * BT * 4;
};

template <int D>
__global__ void __launch_bounds__(tl_tc::THREADS)
flash_dkv_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int s,
                       int h, int kvh, float scale, int causal, int window, int q_offset) {
  using namespace tl_tc;
  using C = DkvTC<D>;
  constexpr int BT = C::BT, KTILE = C::KTILE, QTILE = C::QTILE;
  constexpr int NS = BT / 2;      // accumulator floats of the (key, query) products
  constexpr int NA = C::NP * 32;  // accumulator floats of dk and dv
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sbase - raw);
  // K, V, then per stage q', do; then per stage lse and delta
  const uint32_t sk = sbase, sv = sbase + KTILE;
  auto sq = [&](int st) { return sbase + 2 * KTILE + st * 2 * QTILE; };
  auto sdo = [&](int st) { return sbase + 2 * KTILE + st * 2 * QTILE + QTILE; };
  const uint32_t srow = sbase + 2 * KTILE + 4 * QTILE;  // lse[st][BT], delta[st][BT]
  const float* rows = reinterpret_cast<const float*>(base + 2 * KTILE + 4 * QTILE);

  const int tid = threadIdx.x;
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's keys: r0, r0 + 8
  const int cq = (tid % 4) * 2;                      // its query columns: 8 j + cq, + 1
  const int kt = blockIdx.x;  // the first key tiles see the most causal query tiles
  const int bi = blockIdx.y / kvh;
  const int kh = blockIdx.y % kvh;
  const int group = h / kvh;

  // the query rows that see some key of this tile
  const long long k_lo = static_cast<long long>(kt) * BQ;
  const long long k_hi = k_lo + BQ - 1;
  long long i_begin = 0, i_end = s - 1;  // inclusive, query row indices
  if (causal) {
    i_begin = max(0LL, k_lo - q_offset);
    if (window > 0) i_end = min(i_end, min(k_hi, s - 1LL) + window - 1 - q_offset);
  }
  const int qt_begin = static_cast<int>(i_begin / BT);
  const int nq = i_end >= i_begin ? static_cast<int>(i_end / BT) + 1 - qt_begin : 0;
  const int n_tiles = nq * group;  // (query head, query tile) pairs, head-major

  const long long kv_row = static_cast<long long>(kvh) * D;  // elements between keys
  const long long q_row = static_cast<long long>(h) * D;     // elements between queries
  if (D == 8) {
    zero_pad8<BQ>(base, tid);
    zero_pad8<BQ>(base + KTILE, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i) zero_pad8<BT>(base + 2 * KTILE + i * QTILE, tid);
  }
  const long long kv_at = (static_cast<long long>(bi) * s + k_lo) * kv_row + kh * D;
  load_tile<BQ, D>(sk, k + kv_at, kv_row, s - kt * BQ, tid);
  load_tile<BQ, D>(sv, v + kv_at, kv_row, s - kt * BQ, tid);
  auto load_q = [&](int it, int st) {
    const int hi = kh * group + it / nq;
    const int q0 = (qt_begin + it % nq) * BT;
    const long long at = (static_cast<long long>(bi) * s + q0) * h + hi;  // row of (b, s, h)
    load_tile<BT, D>(sq(st), q + at * D, q_row, s - q0, tid);
    load_tile<BT, D>(sdo(st), dout + at * D, q_row, s - q0, tid);
    for (int i = tid; i < BT; i += THREADS) {
      const bool ok = q0 + i < s;
      const long long r = ok ? at + static_cast<long long>(i) * h : at;
      cp4(srow + (2 * st) * BT * 4 + i * 4, lse + r, ok);
      cp4(srow + (2 * st + 1) * BT * 4 + i * 4, delta + r, ok);
    }
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_commit();

  float dk_acc[NA], dv_acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) load_q(it + 1, st ^ 1);  // in flight while this tile computes
    cp_commit();
    cp_wait<1>();
    prescale_tile<BT, D>(base + (sq(st) - sbase), scale, tid);
    fence_async_shared();
    __syncthreads();

    // S^T = K q'^T and dP^T = V do^T
    float sc[NS], dp[NS];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      if constexpr (BT == 64) {
        wgmma_ss_n64(sc, desc_k<BQ>(sk, kk), desc_k<BT>(sq(st), kk), kk > 0);
      } else {
        wgmma_ss_n32(sc, desc_k<BQ>(sk, kk), desc_k<BT>(sq(st), kk), kk > 0);
      }
    }
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      if constexpr (BT == 64) {
        wgmma_ss_n64(dp, desc_k<BQ>(sv, kk), desc_k<BT>(sdo(st), kk), kk > 0);
      } else {
        wgmma_ss_n32(dp, desc_k<BQ>(sv, kk), desc_k<BT>(sdo(st), kk), kk > 0);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp(S^T - lse), 0 where masked; dS^T = P^T (dP^T - delta)
    const int q0 = (qt_begin + it % nq) * BT;
    const long long q_lo = static_cast<long long>(q_offset) + q0;
    const long long q_hi = q_lo + BT - 1;
    const bool full = q0 + BT <= s &&
                      (!causal || (k_hi <= q_lo && (window == 0 || k_lo > q_hi - window)));
    const float* lse_s = rows + 2 * st * BT;
    const float* delta_s = rows + (2 * st + 1) * BT;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = 8 * (i / 4) + cq + (i % 2);
      bool keep = true;
      if (!full) {
        const long long kj = k_lo + r0 + 8 * ((i / 2) % 2);
        const long long qpos = q_lo + col;
        keep = q0 + col < s;
        if (causal) {
          keep = keep && kj <= qpos;
          if (window > 0) keep = keep && kj > qpos - window;
        }
      }
      const float p = keep ? exp_mufu(sc[i] - lse_s[col]) : 0.0f;
      sc[i] = p;
      dp[i] = p * (dp[i] - delta_s[col]);
    }

    // dV += bf16(P^T) do and dK += bf16(dS^T) q', both from registers
    uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      to_a_frag(sc, kk, pa[kk]);
      to_a_frag(dp, kk, da[kk]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      if constexpr (C::NP == 1) {
        wgmma_rs_n64(dv_acc, pa[kk], desc_mn<BT>(sdo(st), kk), 1);
      } else {
        wgmma_rs_n128(dv_acc, pa[kk], desc_mn<BT>(sdo(st), kk), 1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      if constexpr (C::NP == 1) {
        wgmma_rs_n64(dk_acc, da[kk], desc_mn<BT>(sq(st), kk), 1);
      } else {
        wgmma_rs_n128(dk_acc, da[kk], desc_mn<BT>(sq(st), kk), 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kj = kt * BQ + r0 + 8 * rr;
    if (kj < s) {
      const long long at = ((static_cast<long long>(bi) * s + kj) * kvh + kh) * D;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int col = 8 * j + cq;
        if (col < D) {
          *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
              __floats2bfloat162_rn(dk_acc[4 * j + 2 * rr], dk_acc[4 * j + 2 * rr + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
              __floats2bfloat162_rn(dv_acc[4 * j + 2 * rr], dv_acc[4 * j + 2 * rr + 1]);
        }
      }
    }
  }
}

template <int D>
int launch_dkv_wgmma(const Args& a, int smem) {
  if (smem != DkvTC<D>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_dkv_wgmma_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s + BQ - 1) / BQ, a.b * a.kvh);
  kernel<<<grid, tl_tc::THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.s, a.h, a.kvh,
      a.scale, a.causal, a.window, a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ B5 in bf16 on the tensor cores

template <int D>
struct DqTC {
  static constexpr int NP = D > 64 ? 2 : 1;               // 64-column panels of a row
  static constexpr int KSTEPS = (D < 16 ? 16 : D) / 16;  // k-steps of the score products
  static constexpr int BK = 64;                           // keys per tile
  static constexpr int QTILE = BQ * NP * 128;             // bytes of the q' or do tile
  static constexpr int TILE = BK * NP * 128;              // bytes of a K or V tile
  // alignment; q' and do; two stages of K and V
  static constexpr int SMEM = 1024 + 2 * QTILE + 4 * TILE;
};

template <int D>
__global__ void __launch_bounds__(tl_tc::THREADS)
flash_dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int s, int h, int kvh, float scale,
                      int causal, int window, int q_offset) {
  using namespace tl_tc;
  using C = DqTC<D>;
  constexpr int BK = C::BK, QTILE = C::QTILE, TILE = C::TILE;
  constexpr int NS = BK / 2, NA = C::NP * 32;  // accumulator floats of S or dP, and of dQ
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  uint8_t* base = smem_raw + (sbase - raw);
  // q', do, then K stages 0 and 1, then V stages 0 and 1
  const uint32_t sq = sbase, sdo = sbase + QTILE;
  auto sk = [&](int st) { return sbase + 2 * QTILE + st * TILE; };
  auto sv = [&](int st) { return sbase + 2 * QTILE + (2 + st) * TILE; };

  const int tid = threadIdx.x;
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;  // this thread's rows: r0, r0 + 8
  const int cq = (tid % 4) * 2;                      // its columns: 8 j + cq, + 1
  const int qt = gridDim.x - 1 - blockIdx.x;         // heaviest causal tiles first
  const int bi = blockIdx.y / h;
  const int hi = blockIdx.y % h;
  const int kh = hi / (h / kvh);

  // the keys this query tile can see (the forward's range)
  const long long q_lo = static_cast<long long>(q_offset) + qt * BQ;
  const long long q_hi = static_cast<long long>(q_offset) + min(qt * BQ + BQ, s) - 1;
  long long k_begin = 0, k_end = s - 1;  // inclusive
  if (causal) {
    k_end = min(k_end, q_hi);
    if (window > 0) k_begin = max(0LL, q_lo - window + 1);
  }
  const int kt_begin = static_cast<int>(k_begin / BK);
  const int kt_end = k_end >= k_begin ? static_cast<int>(k_end / BK) + 1 : kt_begin;

  const long long q_row = static_cast<long long>(h) * D;     // elements between queries
  const long long kv_row = static_cast<long long>(kvh) * D;  // elements between keys
  const long long q_at = (static_cast<long long>(bi) * s + qt * BQ) * h + hi;  // row of (b, s, h)
  const __nv_bfloat16* kbase = k + static_cast<long long>(bi) * s * kv_row + kh * D;
  const __nv_bfloat16* vbase = v + static_cast<long long>(bi) * s * kv_row + kh * D;
  auto load_kv = [&](int kt, int st) {
    const long long k0 = static_cast<long long>(kt) * BK;
    load_tile<BK, D>(sk(st), kbase + k0 * kv_row, kv_row, s - kt * BK, tid);
    load_tile<BK, D>(sv(st), vbase + k0 * kv_row, kv_row, s - kt * BK, tid);
  };
  if (D == 8) {
    zero_pad8<BQ>(base, tid);
    zero_pad8<BQ>(base + QTILE, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i) zero_pad8<BK>(base + 2 * QTILE + i * TILE, tid);
  }
  load_tile<BQ, D>(sq, q + q_at * D, q_row, s - qt * BQ, tid);
  load_tile<BQ, D>(sdo, dout + q_at * D, q_row, s - qt * BQ, tid);
  cp_commit();
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_commit();

  // this thread's rows' lse and delta; rows past s take 0, so their p is
  // finite and their dS (from zero-filled do) is 0
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = r0 + 8 * rr;
    const bool ok = qt * BQ + i < s;
    row_lse[rr] = ok ? lse[q_at + static_cast<long long>(i) * h] : 0.0f;
    row_delta[rr] = ok ? delta[q_at + static_cast<long long>(i) * h] : 0.0f;
  }
  cp_wait<1>();  // the q' and do tiles
  prescale_tile<BQ, D>(base, scale, tid);

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, st ^ 1);  // in flight while this tile computes
    cp_commit();
    cp_wait<1>();
    fence_async_shared();
    __syncthreads();

    // S = Q'K^T (B4's product) and dP = dO V^T
    float sc[NS], dp[NS];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      wgmma_ss_n64(sc, desc_k<BQ>(sq, kk), desc_k<BK>(sk(st), kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < C::KSTEPS; ++kk) {
      wgmma_ss_n64(dp, desc_k<BQ>(sdo, kk), desc_k<BK>(sv(st), kk), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // p = exp(S - lse), 0 where masked; dS = p (dP - delta)
    const int k0 = kt * BK;
    const bool full = k0 + BK <= s &&
                      (!causal || (k0 + BK - 1 <= q_lo && (window == 0 || k0 > q_hi - window)));
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int rr = (i / 2) % 2;
      bool keep = true;
      if (!full) {
        const long long kp = k0 + 8 * (i / 4) + cq + (i % 2);
        const long long qpos = q_lo + r0 + 8 * rr;
        keep = kp < s;
        if (causal) {
          keep = keep && kp <= qpos;
          if (window > 0) keep = keep && kp > qpos - window;
        }
      }
      const float p = keep ? exp_mufu(sc[i] - row_lse[rr]) : 0.0f;
      dp[i] = p * (dp[i] - row_delta[rr]);
    }

    // dQ += bf16(dS) K, dS from registers, K read MN-major
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_a_frag(dp, kk, da[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t bk = desc_mn<BK>(sk(st), kk);
      if constexpr (C::NP == 1) {
        wgmma_rs_n64(acc, da[kk], bk, 1);
      } else {
        wgmma_rs_n128(acc, da[kk], bk, 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // dq = bf16(bf16(dq') * scale): the prescale's gradient, as autodiff gives it
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = r0 + 8 * rr;
    if (qt * BQ + i < s) {
      __nv_bfloat16* row = dq + (q_at + static_cast<long long>(i) * h) * D;
#pragma unroll
      for (int j = 0; j < NA / 4; ++j) {
        const int col = 8 * j + cq;
        if (col < D) {
          const float a0 = round_to<__nv_bfloat16>(acc[4 * j + 2 * rr]);
          const float a1 = round_to<__nv_bfloat16>(acc[4 * j + 2 * rr + 1]);
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(__fmul_rn(a0, scale), __fmul_rn(a1, scale));
        }
      }
    }
  }
}

template <int D>
int launch_dq_wgmma(const Args& a, int smem) {
  if (smem != DqTC<D>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_dq_wgmma_kernel<D>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.s + BQ - 1) / BQ, a.b * a.h);
  kernel<<<grid, tl_tc::THREADS, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dq), a.s, a.h, a.kvh, a.scale, a.causal, a.window,
      a.q_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q and do are contiguous (b, s, h, d), k and v contiguous (b, s, kv_heads,
// d), lse and delta contiguous (b, s, h) f32.  Launch on `stream`; return
// cudaGetLastError().

// B5 in float32, on the FMA pipes
extern "C" int tl_flash_bwd_dq(int d, const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta, void* dq,
                               int b, int s, int h, int kvh, float scale, int causal, int window,
                               int q_offset, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, s, h, kvh, scale,
               causal, window, q_offset, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 8: return launch_dq<8>(a);
    case 16: return launch_dq<16>(a);
    case 32: return launch_dq<32>(a);
    case 64: return launch_dq<64>(a);
    case 128: return launch_dq<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B5 in bfloat16, on the tensor cores; besides, the base pointers are
// 16-byte aligned and smem is the block's dynamic shared memory in bytes
// (the wrapper's tc_shared_bytes; any other value is refused)
extern "C" int tl_flash_bwd_dq_bf16(int d, const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dq, int b, int s, int h, int kvh, float scale,
                                    int causal, int window, int q_offset, int smem,
                                    void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, b, s, h, kvh, scale,
               causal, window, q_offset, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 8: return launch_dq_wgmma<8>(a, smem);
    case 16: return launch_dq_wgmma<16>(a, smem);
    case 32: return launch_dq_wgmma<32>(a, smem);
    case 64: return launch_dq_wgmma<64>(a, smem);
    case 128: return launch_dq_wgmma<128>(a, smem);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B6 in float32, on the FMA pipes
extern "C" int tl_flash_bwd_dkv(int d, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta, void* dk,
                                void* dv, int b, int s, int h, int kvh, float scale, int causal,
                                int window, int q_offset, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, b, s, h, kvh, scale,
               causal, window, q_offset, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 8: return launch_dkv<8>(a);
    case 16: return launch_dkv<16>(a);
    case 32: return launch_dkv<32>(a);
    case 64: return launch_dkv<64>(a);
    case 128: return launch_dkv<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B6 in bfloat16, on the tensor cores; besides, the base pointers are
// 16-byte aligned and smem is the block's dynamic shared memory in bytes
// (the wrapper's tc_shared_bytes; any other value is refused)
extern "C" int tl_flash_bwd_dkv_bf16(int d, const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int b, int s, int h, int kvh,
                                     float scale, int causal, int window, int q_offset, int smem,
                                     void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, b, s, h, kvh, scale,
               causal, window, q_offset, static_cast<cudaStream_t>(stream)};
  switch (d) {
    case 8: return launch_dkv_wgmma<8>(a, smem);
    case 16: return launch_dkv_wgmma<16>(a, smem);
    case 32: return launch_dkv_wgmma<32>(a, smem);
    case 64: return launch_dkv_wgmma<64>(a, smem);
    case 128: return launch_dkv_wgmma<128>(a, smem);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
