// Fused lambda-gradient pair sums for Hopper (sm_90a): the CUDA counterpart
// of ranklib_tpu/ops/lambda_kernel.py _kernel (wrapper lambda_weights_fused),
// sort and gathers included: one launch computes a boosting round's lambdas
// for every query.
//
// What it computes (the same as the TPU kernel and its wrapper): per query,
// rank its documents in the stable score-descending order, take the
// metric's separable factors A and B at those ranks, and over every other
// document q of the query
//
//   lam[p] =  sum_{q: L_p > L_q} rho * delta
//           - sum_{q: L_q > L_p} rho * delta
//   w[p]   =  sum over both sets of rho (1 - rho) * delta
//
// with rho = sigmoid(s_loser - s_winner) and delta = |A_p - A_q| |B_p - B_q|,
// the product-separable swap change of NDCG, DCG and P@k:
//
//   NDCG  A = f32(f64(2^L - 1) * (1/idealDCG)),  B = disc[rank] inside k
//   DCG   A = 2^L - 1,                            B = disc[rank] inside k
//   P@k   A = [L > 0] * (1/k_eff),                B = [rank < k_eff]
//
// Everything that depends only on labels comes in per fit, from the plain
// version's own f64 code (ops/lambda_kernel.py round_lambda_data): each
// query's factor (1/idealDCG, 1, or 1/k_eff), its k_eff, and the f32
// discount table f32(1/log2(r + 2)) (all ones for P@k). Results land in
// flat document order, pad documents (past the last query) get 0.
//
// How: one block a query, a contiguous run [qptr[q], qptr[q+1]) of the flat
// documents, the blocks taking the queries widest first (a per-fit order),
// so that every SM gets a like share of the pairs. For a query of at most
// a block's threads (1,024), a thread a document:
//   1. rank_p = #{q: s_q > s_p} + #{q < p: s_q == s_p}, the stable
//      score-descending order of torch.sort(-s, stable=True) (and of
//      gbdt/lambdas.py's sort-free rank), counted on one 64-bit key a
//      document (order-preserving score bits, then the complement of the
//      index), so there is no sort and no gather;
//   2. A_p and B_p from the per-fit factors at rank_p, into shared memory
//      beside L and S (16 bytes a document);
//   3. every unordered pair once: at step j = 1..(n-1)/2 document p takes
//      q = (p + j) mod n (an even n ends with the pairs (p, p + n/2)),
//      adds its share and hands the pair's term to q through a shared-
//      memory slot, two steps a barrier of the query's warps. Terms are
//      f32 (expf, not the fast intrinsic); each document sums its shares
//      in f64 in a fixed order and rounds once, as the plain version's;
//      no atomics, so two launches give the same bits.
// A wider query stages (A, B, L, S) in a global scratch row and each
// document walks all others in tiles, so any width runs.
//
// What bounds it on the H100 (measured, PERF.md): instruction issue. At
// the training shape (1,500 queries of 80-160 documents) a round is 11M
// unordered pairs of ~45 instructions (two exp/reciprocal, two f32 -> f64
// conversions, four f64 adds) and 22M key compares; the bytes (labels and
// scores in, lam and w out) are 16 a document. Computing each pair once
// (not from both ends) and launching the widest queries first took it
// from 0.071 to 0.045 ms. It replaces a round of ~45 small torch ops and
// five launches a bucket chunk with one launch.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;

// 1 / (1 + e^-x): the correctly rounded reciprocal is the IEEE quotient
__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(1.0f + expf(-x));
}

struct Round {
  const float* labels;   // [n_pad], pad documents past qptr[n_queries]
  const float* scores;   // [n_pad]
  const int* qptr;       // [n_queries + 1]
  const int* order;      // [n_queries] the queries, widest first
  const double* qfac;    // [n_queries] the metric's per-query factor
  const int* keff;       // [n_queries] the effective cutoff
  const float* disc;     // [max_docs] the discount at each rank
  int rel_only;          // P@k: A is [L > 0] * factor, not 2^L - 1
  int n_queries;
  int64_t n_pad;
  float4* wide;          // [n_pad] (A, B, L, S) of queries past a block
  float* lam;
  float* w;
};

// The stable score-descending order as one unsigned key a document:
// document i ranks before p iff key_i > key_p, i.e. s_i > s_p, or s_i ==
// s_p and i < p (-0.0 == +0.0). The score's bits, made order-preserving,
// then the complement of the index.
__device__ __forceinline__ unsigned long long order_key(float s, int i) {
  unsigned u = __float_as_uint(s + 0.0f);            // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return static_cast<unsigned long long>(u) << 32 |
         (0xFFFFFFFFu - static_cast<unsigned>(i));
}

// Documents a block's barrier waits for: the warps that hold the query's
// documents (the others have left).
__device__ __forceinline__ void query_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// (A, B) of a document of label l at rank `rank`.
__device__ __forceinline__ float2 factors(const Round& r, float l, int rank,
                                          int ke, double fac) {
  const float g = r.rel_only ? (l > 0.0f ? 1.0f : 0.0f) : exp2f(l) - 1.0f;
  const float a = static_cast<float>(static_cast<double>(g) * fac);
  return make_float2(a, rank < ke ? r.disc[rank] : 0.0f);
}

// The pair of documents p = (A, B, L, S) and q: p's lambda share (+ as
// the winner, - as the loser) and the weight, both in f32 and then
// widened (both 0 when the labels are equal: so are the A). The other
// side's share is the negated first number.
__device__ __forceinline__ double2 pair_term(float4 p, float4 q) {
  const float delta = fabsf(p.x - q.x) * fabsf(p.y - q.y);
  // p wins: rho = s(s_q - s_p); q wins: rho = s(s_p - s_q)
  const bool wins = p.z > q.z;
  const float rho = sigmoid(wins ? q.w - p.w : p.w - q.w);
  const double t = rho * delta;
  return make_double2(wins ? t : -t, (rho * (1.0f - rho)) * delta);
}

__device__ __forceinline__ void store(const Round& r, int64_t doc, double lam,
                                      double w) {
  r.lam[doc] = static_cast<float>(lam);
  r.w[doc] = static_cast<float>(w);
}

// A query of n <= blockDim.x documents, one a thread, everything in shared
// memory; warps past the query's documents leave at once. Every unordered
// pair is computed once: at step j = 1..(n-1)/2, document p takes q = (p +
// j) mod n, adds its own share and hands the pair's term to q through an
// exchange slot; two steps share a barrier, their slots double-buffered.
// An even n ends with the pairs (p, p + n/2). Pairs of one label add
// exactly 0 (their A are equal), so no lane branches on them.
__device__ void paired_query(const Round& r, float4* tile,
                             unsigned long long* keys, double2* xbuf,
                             int64_t base, int n, int ke, double fac) {
  const int p = threadIdx.x, T = blockDim.x;
  const int threads = (n + 31) & ~31;
  if (p >= threads) return;
  const bool live = p < n;
  unsigned long long mine = 0;
  if (live) {
    const float s = r.scores[base + p];
    mine = order_key(s, p);
    keys[p] = mine;
    tile[p] = make_float4(0.0f, 0.0f, r.labels[base + p], s);
  }
  query_sync(threads);
  if (live) {
    int rank = 0;
    for (int i = 0; i < n; ++i) rank += keys[i] > mine;
    // only A and B are written: the other threads read S and L meanwhile
    *reinterpret_cast<float2*>(&tile[p]) = factors(r, tile[p].z, rank, ke,
                                                   fac);
  }
  query_sync(threads);
  const float4 me = live ? tile[p] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  double lam = 0.0, w = 0.0;
  // p's share of a pair is t.x (+ as the winner), q's is -t.x
  auto give = [&](int q, double2* slot) {
    const double2 t = pair_term(me, tile[q]);
    lam += t.x;
    w += t.y;
    slot[q] = t;
  };
  auto take = [&](const double2* slot) {
    const double2 t = slot[p];
    lam -= t.x;
    w += t.y;
  };
  const int h = (n - 1) / 2;
  double2* slot = xbuf;                      // [2][T] a phase, two phases
  int q = p;
  for (int j = 1; j <= h; j += 2) {
    const bool two = j < h;
    if (live) {
      if (++q == n) q = 0;
      give(q, slot);
      if (two) {
        if (++q == n) q = 0;
        give(q, slot + T);
      }
    }
    query_sync(threads);
    if (live) {
      take(slot);
      if (two) take(slot + T);
    }
    slot = slot == xbuf ? xbuf + 2 * T : xbuf;
  }
  if (n % 2 == 0 && n > 0) {                 // the pairs (p, p + n/2)
    const int half = n / 2;
    if (p < half) give(p + half, slot);
    query_sync(threads);
    if (live && p >= half) take(slot);
  }
  if (live) store(r, base + p, lam, w);
}

// A query wider than the block: (A, B, L, S) go to the query's rows of
// the global scratch, then each document walks every other in tiles of
// blockDim.x, both sides of each pair computed.
__device__ void wide_query(const Round& r, float4* tile, int64_t base, int n,
                           int ke, double fac) {
  const int T = blockDim.x;
  for (int p0 = 0; p0 < n; p0 += T) {
    const int p = p0 + threadIdx.x;
    const bool live = p < n;
    const float sp = live ? r.scores[base + p] : 0.0f;
    int rank = 0;
    for (int t0 = 0; t0 < n; t0 += T) {
      const int cnt = min(T, n - t0);
      __syncthreads();                       // the previous tile is read
      if (threadIdx.x < cnt) tile[threadIdx.x].w = r.scores[base + t0 +
                                                            threadIdx.x];
      __syncthreads();
      if (live) {
        const unsigned long long mine = order_key(sp, p);
        for (int i = 0; i < cnt; ++i) {
          rank += order_key(tile[i].w, t0 + i) > mine;
        }
      }
    }
    if (live) {
      const float lp = r.labels[base + p];
      const float2 ab = factors(r, lp, rank, ke, fac);
      r.wide[base + p] = make_float4(ab.x, ab.y, lp, sp);
    }
  }
  __syncthreads();                           // the scratch rows are written
  for (int p0 = 0; p0 < n; p0 += T) {
    const int p = p0 + threadIdx.x;
    const bool live = p < n;
    const float4 me =
        live ? r.wide[base + p] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    double lam = 0.0, w = 0.0;
    for (int t0 = 0; t0 < n; t0 += T) {
      const int cnt = min(T, n - t0);
      __syncthreads();
      if (threadIdx.x < cnt) tile[threadIdx.x] = r.wide[base + t0 +
                                                        threadIdx.x];
      __syncthreads();
      if (live) {
        for (int i = 0; i < cnt; ++i) {
          const double2 t = pair_term(me, tile[i]);
          lam += t.x;
          w += t.y;
        }
      }
    }
    if (live) store(r, base + p, lam, w);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    lambda_round_kernel(const Round r) {
  // [blockDim] tile, [2][2][blockDim] exchange slots, [blockDim] keys
  extern __shared__ float4 smem[];
  if (blockIdx.x == r.n_queries) {           // pad documents pair with none
    for (int64_t i = r.qptr[r.n_queries] + threadIdx.x; i < r.n_pad;
         i += blockDim.x) {
      r.lam[i] = 0.0f;
      r.w[i] = 0.0f;
    }
    return;
  }
  const int q = r.order[blockIdx.x];
  const int64_t base = r.qptr[q];
  const int n = r.qptr[q + 1] - r.qptr[q];
  if (n <= static_cast<int>(blockDim.x)) {
    paired_query(r, smem,
                 reinterpret_cast<unsigned long long*>(smem + 5 * blockDim.x),
                 reinterpret_cast<double2*>(smem + blockDim.x), base, n,
                 r.keff[q], r.qfac[q]);
  } else {
    wide_query(r, smem, base, n, r.keff[q], r.qfac[q]);
  }
}

}  // namespace

// Plain C interface for ctypes: one launch of a round's lambdas. Device
// pointers: labels and scores [n_pad] f32, qptr [n_queries + 1] int32
// (qptr[n_queries] <= n_pad), order [n_queries] int32 (a permutation of
// the queries: block b takes query order[b]), qfac [n_queries] f64, keff
// [n_queries] int32, disc [max_docs] f32, wide [n_pad] float4 (needed
// only when max_docs > kMaxThreads, else may be null), lam and w [n_pad]
// f32. `max_docs` is the widest query. `stream` is the caller's
// cudaStream_t. Nothing here allocates or synchronises. Returns the
// launch's cudaError_t.
extern "C" int lambda_pairs(const void* labels, const void* scores,
                            const void* qptr, const void* order,
                            const void* qfac,
                            const void* keff, const void* disc, int rel_only,
                            int n_queries, int64_t n_pad, int max_docs,
                            void* wide, void* lam, void* w, void* stream) {
  if (n_queries < 0 || max_docs < 0 ||
      (max_docs > kMaxThreads && wide == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads =
      std::min(kMaxThreads, std::max(32, ((max_docs + 31) / 32) * 32));
  // a tile of (A, B, L, S), four exchange slots (f64 pairs) and a key a
  // thread: 88 KB at 1,024 threads
  const size_t smem = 88 * static_cast<size_t>(threads);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lambda_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Round r{static_cast<const float*>(labels),
                static_cast<const float*>(scores),
                static_cast<const int*>(qptr),
                static_cast<const int*>(order),
                static_cast<const double*>(qfac),
                static_cast<const int*>(keff),
                static_cast<const float*>(disc),
                rel_only,
                n_queries,
                n_pad,
                static_cast<float4*>(wide),
                static_cast<float*>(lam),
                static_cast<float*>(w)};
  lambda_round_kernel<<<static_cast<unsigned>(n_queries) + 1, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(r);
  return static_cast<int>(cudaGetLastError());
}
