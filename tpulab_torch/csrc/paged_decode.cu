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
// The sums run in another order than the Pallas kernel's, and exp is the
// MUFU's ex2 of x log2(e), a few f32 ulps from expf (the wrapper's
// paged_over_tolerance holds the two together); the order is fixed, so a
// call's output does not depend on the order in which blocks run.
//
// Layout: q and out (S, 1, h, D); pools (P, BS, kvh, D) contiguous, or int8
// data of that shape with f32 scales (P, BS, kvh); tables (S, M) int32;
// lengths (S,) int32.  Query head i reads kv head i / (h / kvh).
//
// Bound: bytes.  A decode step reads every live K/V position once and does
// 4 * g * D flops per position and kv head, far below the card's ratio of
// flops to bytes.  So the design keeps many loads in flight on every SM:
//
// - Split across blocks (flash-decoding).  The grid is (kv heads x row
//   blocks, splits, slots).  Each split covers a fixed span of positions, a
//   multiple of the chunk; the wrapper's split_plan picks splits and span
//   from the shapes and the SM count alone, never from the lengths, which
//   stay on the device: one wave of BLOCKS_PER_SM resident blocks on each
//   SM.  A block whose span holds no visible key (past the length, or
//   wholly below the window) loads no K/V and records an empty partial,
//   m = NEG_INF, which the merge skips (it stands for l = 0, acc = 0).
// - Loads in flight.  A block reads its span's table entries once into
//   shared memory, then streams the visible K and V rows in their stored
//   dtype with cp.async (16 bytes a copy, 8 for an 8-byte int8 row) into
//   STAGES shared-memory stages, so two chunks are in flight while one is
//   reduced.  Rows of dead positions are zero-filled, not read.  The int8
//   dequant-and-round happens when a value is read from shared memory.
// - Parallel work in a chunk.  A block holds ROWS = 4 query rows of the kv
//   head's group (zero-padded; a group of g > 4 takes ceil(g / 4) row
//   blocks, each reading the K/V again) in registers: L = D / 8 lanes hold
//   a row's 8 dims each, so a warp reads 32 / L keys at once, each lane one
//   16-byte vector of a key row (8 lanes per 128-byte row at d64 bf16),
//   and reduces each key's 4 scores by shuffles over its L lanes.  Each
//   warp keeps its own running (m, l) per row over its keys of every chunk
//   (rescaling only when m moves) and an accumulator slice per lane, on
//   the FMA pipes: with 4 query rows a tensor-core tile would be mostly
//   padding.  At the end of the span the lane groups are summed by
//   shuffles and the 4 warps merged in warp order in shared memory.
// - Combine in the same launch.  With one split the block writes o.  With
//   more, each block writes its partial (m, l, acc) to the workspace,
//   fences, and takes a ticket from its (slot, kv head, row block)
//   counter; the block that draws the last ticket merges every partial in
//   split order (M = max m_i, l = sum l_i exp(m_i - M), acc likewise, read
//   through L2), writes o = acc / l, and resets the counter to 0.  An
//   empty split weighs 0; a slot whose splits are all empty gives 0/0 =
//   NaN.  One launch a call, no host synchronisation, and the grid and
//   every buffer depend on the shapes alone.

#include "flash_common.cuh"
#include "flash_tc.cuh"

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

using tl_flash::from_f32;
using tl_flash::round_to;
using tl_flash::to_f32;
using tl_tc::cp16;
using tl_tc::cp4;
using tl_tc::cp8;
using tl_tc::cp_commit;
using tl_tc::cp_wait;
using tl_tc::exp_mufu;
using tl_tc::smem_addr;

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;       // query rows a block holds
constexpr int DPL = 8;        // head dims a lane holds
constexpr int KPL = 4;        // keys a lane group reads per chunk
constexpr int STAGES = 3;     // shared-memory stages of the K/V stream
constexpr int BLOCKS_PER_SM = 4;  // resident blocks the registers allow (128 a thread)
constexpr float NEG_INF = -FLT_MAX;

template <int D, typename T, bool Q>
struct Plan {
  using E = std::conditional_t<Q, int8_t, T>;    // stored K/V element
  static constexpr int L = D / DPL;               // lanes per key
  static constexpr int LG = 32 / L;               // keys a warp reads at once
  static constexpr int CK = WARPS * LG * KPL;     // positions per chunk (4096 / D)
  static constexpr int RB = D * static_cast<int>(sizeof(E));  // bytes of a row
  static constexpr int UNIT = RB < 16 ? RB : 16;  // bytes of one cp.async
  static constexpr int UPR = RB / UNIT;           // copies per row
  static constexpr int VE = 16 / static_cast<int>(sizeof(E)) < DPL
                                ? 16 / static_cast<int>(sizeof(E))
                                : DPL;            // elements per vector read
  static constexpr int NV = DPL / VE;             // vector reads per lane and row
  static constexpr int TILE = CK * RB;            // bytes of a K (or V) chunk
  static constexpr int STAGE = 2 * TILE + (Q ? 2 * CK * 4 : 0);
  static constexpr int MERGE = WARPS * ROWS * (D + 2) * 4;
  static constexpr int BODY = STAGES * STAGE > MERGE ? STAGES * STAGE : MERGE;
  static constexpr int REC = ROWS * (D + 2);      // floats of one partial
};

// table entries a block stages: its span's (one more where the span
// straddles a table block), at most the table's
__host__ __device__ inline int table_entries(int span, int bs, int M) {
  const int n = (span + bs - 1) / bs + 1;
  return n < M ? n : M;
}

// head dim of a lane's i-th value (i < DPL); lane `sub` of its key's L
template <int D, typename T, bool Q>
__device__ __forceinline__ int dim_of(int i, int sub) {
  using P = Plan<D, T, Q>;
  return (i / P::VE) * P::L * P::VE + sub * P::VE + i % P::VE;
}

// a lane's DPL values of one staged K or V row, as the attention reads them
template <int D, typename T, bool Q>
__device__ __forceinline__ void read_row(const uint8_t* row, float scale, int sub,
                                         float (&x)[DPL]) {
  using P = Plan<D, T, Q>;
#pragma unroll
  for (int v = 0; v < P::NV; ++v) {
    const uint8_t* p = row + (v * P::L * P::VE + sub * P::VE) * sizeof(typename P::E);
    if constexpr (Q) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t word = e < 4 ? w.x : w.y;
        const float b = static_cast<float>(static_cast<int8_t>((word >> (8 * (e & 3))) & 0xffu));
        x[v * P::VE + e] = round_to<T>(__fmul_rn(b, scale));
      }
    } else if constexpr (std::is_same<T, float>::value) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      x[v * 4 + 0] = w.x;
      x[v * 4 + 1] = w.y;
      x[v * 4 + 2] = w.z;
      x[v * 4 + 3] = w.w;
    } else {
      const uint4 w = *reinterpret_cast<const uint4*>(p);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[2 * e] = __uint_as_float(words[e] << 16);
        x[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
      }
    }
  }
}

template <int BYTES>
__device__ __forceinline__ void copy_async(uint32_t dst, const void* src, bool valid) {
  if constexpr (BYTES == 16) cp16(dst, src, valid);
  else cp8(dst, src, valid);
}

// sum over the lanes of a warp whose lane bits at or above `from` differ
template <int FROM>
__device__ __forceinline__ float sum_above(float x) {
#pragma unroll
  for (int off = FROM; off < 32; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One block's span: the query rows into registers, the visible chunks
// streamed through the stages, each warp's running softmax, then the warps
// merged in warp order into the block's partial at `rec` (with one split,
// o itself into `out`).
template <int D, typename T, bool Q>
__device__ __forceinline__ void attend_span(
    const T* __restrict__ q, const void* __restrict__ kpool, const void* __restrict__ vpool,
    const float* __restrict__ kscale, const float* __restrict__ vscale, T* __restrict__ out,
    float* __restrict__ rec, uint8_t* smem, const int* tab, int h, int kvh, int bs, int g, int c,
    int row0, int s, int s0, int tb, int first, int last, int k0, int nk, float qdiv,
    bool single) {
  using P = Plan<D, T, Q>;
  constexpr int CK = P::CK, L = P::L, LG = P::LG, RB = P::RB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % L;
  const int lg = lane / L;

  float qr[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const long long base = (static_cast<long long>(s) * h + c * g + row0 + r) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[r][i] = row0 + r < g
          ? round_to<T>(__fdiv_rn(to_f32<T>(q[base + dim_of<D, T, Q>(i, sub)]), qdiv))
          : 0.0f;
    }
  }
  __syncthreads();  // the table entries

  const uint32_t sbase = smem_addr(smem);
  // chunk i of the span's visible ones into stage i % STAGES (an empty
  // group past the last), zero-filling rows of dead positions
  auto load_chunk = [&](int i) {
    if (i < nk) {
      const int c0 = s0 + (k0 + i) * CK;
      const uint32_t st = sbase + (i % STAGES) * P::STAGE;
      for (int u = tid; u < CK * P::UPR; u += THREADS) {
        const int j = u / P::UPR;
        const int pos = c0 + j;
        const bool live = pos >= first && pos < last;
        const long long row =
            live ? (static_cast<long long>(tab[pos / bs - tb]) * bs + pos % bs) * kvh + c : 0;
        const long long off = row * RB + (u % P::UPR) * P::UNIT;
        const uint32_t dst = st + j * RB + (u % P::UPR) * P::UNIT;
        copy_async<P::UNIT>(dst, static_cast<const uint8_t*>(kpool) + off, live);
        copy_async<P::UNIT>(dst + P::TILE, static_cast<const uint8_t*>(vpool) + off, live);
      }
      if constexpr (Q) {
        for (int j = tid; j < CK; j += THREADS) {
          const int pos = c0 + j;
          const bool live = pos >= first && pos < last;
          const long long row =
              live ? (static_cast<long long>(tab[pos / bs - tb]) * bs + pos % bs) * kvh + c : 0;
          cp4(st + 2 * P::TILE + j * 4, kscale + row, live);
          cp4(st + 2 * P::TILE + (CK + j) * 4, vscale + row, live);
        }
      }
    }
    cp_commit();
  };

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.0f;
  }

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_chunk(i);
  for (int i = 0; i < nk; ++i) {
    load_chunk(i + STAGES - 1);
    cp_wait<STAGES - 1>();
    __syncthreads();  // chunk i has landed for every thread
    const uint8_t* st = smem + (i % STAGES) * P::STAGE;
    const float* scales = reinterpret_cast<const float*>(st + 2 * P::TILE);
    const int c0 = s0 + (k0 + i) * CK;

    // this lane group's KPL keys of the chunk, and their scores
    float sc[KPL][ROWS];
    bool live[KPL];
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = (warp * KPL + kk) * LG + lg;
      const int pos = c0 + j;
      live[kk] = pos >= first && pos < last;
      float kv[DPL];
      read_row<D, T, Q>(st + j * RB, Q ? scales[j] : 0.0f, sub, kv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) part = fmaf(qr[r][e], kv[e], part);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[kk][r] = live[kk] ? part : NEG_INF;
      }
    }

    // the warp's running softmax over its keys
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      float tmax = NEG_INF;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) tmax = fmaxf(tmax, sc[kk][r]);
#pragma unroll
      for (int off = L; off < 32; off <<= 1) {
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      }
      const float m_new = fmaxf(m[r], tmax);
      float psum = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const float p = live[kk] ? exp_mufu(sc[kk][r] - m_new) : 0.0f;
        sc[kk][r] = p;
        psum += p;
      }
      if (m_new != m[r]) {  // warp-uniform; a rescale by 1 changes nothing
        const float alpha = exp_mufu(m[r] - m_new);
        l[r] = __fmul_rn(l[r], alpha);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = __fmul_rn(acc[r][e], alpha);
      }
      l[r] = __fadd_rn(l[r], psum);
      m[r] = m_new;
    }

    // acc += p . v
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
      const int j = (warp * KPL + kk) * LG + lg;
      float vv[DPL];
      read_row<D, T, Q>(st + P::TILE + j * RB, Q ? scales[CK + j] : 0.0f, sub, vv);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(sc[kk][r], vv[e], acc[r][e]);
      }
    }
    __syncthreads();  // every thread is done with this stage
  }
  cp_wait<0>();

  // the warp's lane groups summed, then the 4 warps merged in warp order
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    l[r] = sum_above<L>(l[r]);
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = sum_above<L>(acc[r][e]);
  }
  __syncthreads();  // no thread reads a stage any more
  float* mw = reinterpret_cast<float*>(smem);  // WARPS x ROWS maxima
  float* lw = mw + WARPS * ROWS;               // WARPS x ROWS denominators
  float* aw = lw + WARPS * ROWS;               // WARPS x ROWS x D accumulators
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      mw[warp * ROWS + r] = m[r];
      lw[warp * ROWS + r] = l[r];
    }
  }
  if (lg == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int e = 0; e < DPL; ++e) aw[(warp * ROWS + r) * D + dim_of<D, T, Q>(e, sub)] = acc[r][e];
    }
  }
  __syncthreads();

  for (int e = tid; e < ROWS * D; e += THREADS) {
    const int r = e / D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, mw[w * ROWS + r]);
    float ll = 0.0f, aa = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp_mufu(mw[w * ROWS + r] - mm);
      ll = __fadd_rn(ll, __fmul_rn(lw[w * ROWS + r], wt));
      aa = __fadd_rn(aa, __fmul_rn(aw[w * ROWS * D + e], wt));
    }
    if (single) {
      if (row0 + r < g) {
        out[(static_cast<long long>(s) * h + c * g + row0) * D + e] =
            from_f32<T>(__fdiv_rn(aa, ll));  // 0/0 = NaN at length 0
      }
    } else {
      __stcg(rec + 2 * ROWS + e, aa);
      if (e % D == 0) {
        __stcg(rec + r, mm);
        __stcg(rec + ROWS + r, ll);
      }
    }
  }
}

template <int D, typename T, bool Q>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
paged_split_kernel(const T* __restrict__ q, const void* __restrict__ kpool,
                   const void* __restrict__ vpool, const float* __restrict__ kscale,
                   const float* __restrict__ vscale, const int* __restrict__ tables,
                   const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ work,
                   int* __restrict__ tickets, int h, int kvh, int bs, int M, int window,
                   float qdiv, int splits, int span) {
  using P = Plan<D, T, Q>;
  constexpr int CK = P::CK;
  extern __shared__ __align__(16) uint8_t smem[];
  int* tab = reinterpret_cast<int*>(smem + P::BODY);

  const int g = h / kvh;
  const int nrb = (g + ROWS - 1) / ROWS;
  const int c = blockIdx.x / nrb;              // kv head
  const int row0 = (blockIdx.x % nrb) * ROWS;  // first query row of the group
  const int split = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;

  // the span's table entries, read beside the length (not after it)
  const int length = lengths[s];
  const int s0 = split * span;
  const int tb = s0 / bs;  // first staged table entry
  const int nt = min((s0 + span - 1) / bs, M - 1) - tb + 1;
  const int* trow = tables + static_cast<long long>(s) * M;
  for (int i = tid; i < nt; i += THREADS) tab[i] = trow[tb + i];

  // the span's visible positions [first, last), in chunks k0 .. k0 + nk - 1
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int first = max(s0, lo);
  const int last = min(min(s0 + span, length), M * bs);
  const int k0 = first < last ? (first - s0) / CK : 0;
  const int nk = first < last ? (last - s0 + CK - 1) / CK - k0 : 0;

  const long long head = static_cast<long long>(s) * gridDim.x + blockIdx.x;
  float* rec = work + (head * splits + split) * P::REC;
  const bool single = splits == 1;
  if (nk == 0 && !single) {
    // an empty partial: its m alone, NEG_INF, which the merge skips
    if (tid < ROWS) __stcg(rec + tid, NEG_INF);
  } else {
    attend_span<D, T, Q>(q, kpool, vpool, kscale, vscale, out, rec, smem, tab, h, kvh, bs, g, c,
                         row0, s, s0, tb, first, last, k0, nk, qdiv, single);
    if (single) return;
  }

  // the ticket: the block that draws the last one merges every split
  __threadfence();
  __syncthreads();
  const bool merger = __syncthreads_or(tid == 0 && atomicAdd(tickets + head, 1) == splits - 1);
  if (!merger) return;
  __threadfence();
  const float* recs = work + head * splits * P::REC;
  for (int e = tid; e < ROWS * D; e += THREADS) {
    const int r = e / D;
    if (row0 + r >= g) continue;
    float mm = NEG_INF;
    for (int i = 0; i < splits; ++i) mm = fmaxf(mm, __ldcg(recs + i * P::REC + r));
    float ll = 0.0f, aa = 0.0f;
    for (int i = 0; i < splits; ++i) {
      const float* ri = recs + i * P::REC;
      const float mi = __ldcg(ri + r);
      if (mi == NEG_INF) continue;  // an empty split, which weighs 0
      const float wt = exp_mufu(mi - mm);
      ll = __fadd_rn(ll, __fmul_rn(__ldcg(ri + ROWS + r), wt));
      aa = __fadd_rn(aa, __fmul_rn(__ldcg(ri + 2 * ROWS + e), wt));
    }
    out[(static_cast<long long>(s) * h + c * g + row0) * D + e] =
        from_f32<T>(__fdiv_rn(aa, ll));  // 0/0 = NaN when every split is empty
  }
  if (tid == 0) tickets[head] = 0;
}

template <int D, typename T, bool Q>
int launch(const void* q, const void* kp, const void* vp, const void* ksc, const void* vsc,
           const void* tables, const void* lengths, void* out, void* work, void* tickets, int S,
           int h, int kvh, int bs, int M, int window, float qdiv, int splits, int span, int smem,
           cudaStream_t stream) {
  using P = Plan<D, T, Q>;
  if (splits < 1 || span < P::CK || span % P::CK ||
      smem != P::BODY + 4 * table_entries(span, bs, M)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = paged_split_kernel<D, T, Q>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nrb = (h / kvh + ROWS - 1) / ROWS;
  kernel<<<dim3(kvh * nrb, splits, S), THREADS, smem, stream>>>(
      static_cast<const T*>(q), kp, vp, static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), static_cast<float*>(work),
      static_cast<int*>(tickets), h, kvh, bs, M, window, qdiv, splits, span);
  return static_cast<int>(cudaGetLastError());
}

#define TL_PAGED_ARGS                                                                         \
  q, kp, vp, ksc, vsc, tables, lengths, out, work, tickets, S, h, kvh, bs, M, window, qdiv,   \
      splits, span, smem, stream

template <typename T, bool Q>
int dispatch_d(int d, const void* q, const void* kp, const void* vp, const void* ksc,
               const void* vsc, const void* tables, const void* lengths, void* out, void* work,
               void* tickets, int S, int h, int kvh, int bs, int M, int window, float qdiv,
               int splits, int span, int smem, cudaStream_t stream) {
  switch (d) {
    case 8: return launch<8, T, Q>(TL_PAGED_ARGS);
    case 16: return launch<16, T, Q>(TL_PAGED_ARGS);
    case 32: return launch<32, T, Q>(TL_PAGED_ARGS);
    case 64: return launch<64, T, Q>(TL_PAGED_ARGS);
    case 128: return launch<128, T, Q>(TL_PAGED_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_q(int quantized, int d, const void* q, const void* kp, const void* vp,
               const void* ksc, const void* vsc, const void* tables, const void* lengths,
               void* out, void* work, void* tickets, int S, int h, int kvh, int bs, int M,
               int window, float qdiv, int splits, int span, int smem, cudaStream_t stream) {
  if (quantized) return dispatch_d<T, true>(d, TL_PAGED_ARGS);
  return dispatch_d<T, false>(d, TL_PAGED_ARGS);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (of q, out and a native pool).  With
// quantized != 0 the pools are int8 and ks, vs their f32 scales; otherwise
// ks and vs are unused.  work is the f32 workspace of the partials (slots x
// kv heads x row blocks x splits records of 4 x (d + 2) floats), tickets
// one int32 per (slot, kv head, row block), zero before the first call and
// left zero by every call.  splits and span are the wrapper's split_plan
// (span a multiple of the chunk); smem is the block's dynamic shared memory
// in bytes (the wrapper's shared_bytes; any other value is refused).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int tl_paged_decode(int dtype, int d, int quantized, const void* q, const void* kp,
                               const void* vp, const void* ksc, const void* vsc,
                               const void* tables, const void* lengths, void* out, void* work,
                               void* tickets, int S, int h, int kvh, int bs, int M, int window,
                               float qdiv, int splits, int span, int smem, void* stream) {
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_q<float>(quantized, d, q, kp, vp, ksc, vsc, tables, lengths, out, work,
                             tickets, S, h, kvh, bs, M, window, qdiv, splits, span, smem, cs);
  }
  if (dtype == 1) {
    return dispatch_q<__nv_bfloat16>(quantized, d, q, kp, vp, ksc, vsc, tables, lengths, out,
                                     work, tickets, S, h, kvh, bs, M, window, qdiv, splits,
                                     span, smem, cs);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
