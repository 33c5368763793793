// Forest evaluation for Hopper (sm_90a): the CUDA counterparts of
// ranklib_tpu/ops/forest_eval.py _forest_frombins_kernel (host-binned ids),
// _forest_bins_kernel (ids binned here from f32 features),
// _forest_full3_kernel / _forest_full_kernel (the f32 route),
// _bins_only_kernel (the split route's binning pass; its selection half,
// _forest_bins_split_kernel, is frombins_kernel on the ids written here) and
// _forest_kernel (the predicate-matrix epilogue).
//
// What they compute (the same as the TPU kernels): the score of a document
// is the sum over trees of w * the output of the leaf it reaches. In bin
// space every document carries, per feature, a bin id b = #{grid_f < x_f}
// against the model's own sorted per-feature threshold grid (NaN ->
// n_grid), and goes LEFT at a node iff b <= nodebin, which equals the f32
// test x <= threshold exactly because every threshold is a grid point. The
// f32 route (models with more than 256 thresholds on a feature, or inputs
// wider than the bin kernels' staging) makes that test directly: x <= t in
// f32, so NaN goes right, -inf left, +inf right of every finite
// threshold, -0.0 equals +0.0, and thresholds near +-3.4e38 compare like
// any other. The TPU's 3-plane bf16 split, its +-3e38 clamp and the band
// gate that guards it were MXU workarounds and have no counterpart here.
//
// How: the TPU kernels turn the walk into one-hot selection and path
// matmuls because the MXU is the only fast unit there. Here one thread
// walks one document through every tree from the root. Scores add in f32
// in tree order, one partial per chunk of `tree_chunk` trees, the order
// the plain PyTorch versions use, so kernel and plain version agree bit for
// bit.
//
// The three forest walks (frombins_kernel, bins_kernel, full_kernel) run
// one chunk loop (walk_chunks) over split records (gbdt/ensemble.py
// _pack_splits): one 16-byte record an internal node that carries both
// children, a child being a leaf's w*output itself, so a tree costs one
// record per test and no leaf visit. A bin-space record holds the node bin
// and the two leaf flags in its second word; an f32 record holds the
// threshold's bits there and the flags in the top two bits of its feature
// word. A chunk of tree_chunk trees is one contiguous run of records (9 a
// 10-leaf tree, ~3.6 KB a chunk), which every block copies into shared
// memory with cp.async, double-buffered, the next chunk landing while its
// warps walk this one. While chunk 0 lands, the block stages its
// documents once, feature-major: frombins_kernel its ids as they came
// (uint8 as bytes), bins_kernel the ids it bins from f32 features (uint8,
// int16 at n_grid 256), full_kernel the f32 values themselves. The last two
// read row-major X through stage_docs: a warp reads 32-byte runs of four
// documents' rows and transposes 8 x 8 blocks by shuffles, so its loads
// are coalesced and then each lane holds one document; a warp's binary
// searches (bin_of, over at most 256 grid entries) read one grid row, and
// its stores hit distinct banks. Documents a block (plan_walk): of 256,
// 128, 64 and 32, the count that keeps the most threads resident; at 136
// features, five blocks of 256 for uint8 ids, but f32 values take 4x the
// bytes (544 a document), so five blocks of 64 for the f32 walk. It stages
// the features that fit beside 32 documents and reads any later one from
// the document's row of X, so any width runs.
//
// A warp walks each tree in lockstep, so its lanes read one record or a
// few, and the same feature's ids or values. What bounds it: the dependent
// shared-memory loads and the instructions of each test, repeated to the
// deepest walk of the warp's 32 documents (on the H100 it was measured
// against variants: records read through L1 instead, 2 trees in flight a
// thread, lanes running through a chunk at their own pace, int16 staging,
// 64/128 documents a block, id rows padded against bank conflicts;
// PERF.md), and for the f32 walk the few threads its staging leaves
// resident. Chunks too large to stage (more than 64 KB for both buffers)
// are walked from the read-only cache: a compile-time choice of the
// launch that computes the same thing bit for bit.
//
// The split route's binning pass (bins_only_kernel) transposes X [N, F]
// through a 32 x 32 shared-memory tile, so both its f32 reads and its id
// writes ([F, N], uint8 or int16) are coalesced; it is bound by those bytes.
//
// The predicate epilogue (pred_epilogue_kernel) takes the reference's
// matmul layout as it is: 0/1 node tests predT [nch * TCM, N], P - Q
// blocks, csQ, plen, w * output. One thread per document counts, for each
// leaf of each tree, its path agreements hits = sum_m pred * (P - Q)
// (small integers, exact in f32) and takes the output of the leaf whose
// hits == plen - csQ. It reads only the tree's own [M, L] block of the
// block-diagonal P - Q (one block per tree, M nodes, L leaves) and skips its
// zero entries (a warp-uniform branch), so the work is the path lengths,
// not TCM x TCL; the dominant cost is reading predT once (1 or 2 bytes a
// node test and document).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kMaxDocsPerBlock = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

// Bin of x in a sorted grid row: #{row[i] < x} over the first n entries
// (+inf pads compare false); NaN -> n_grid, past every node bin.
__device__ __forceinline__ int bin_of(const float* __restrict__ row, int n,
                                      float x, int n_grid) {
  if (isnan(x)) return n_grid;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---- the forest walks: split records staged a tree chunk at a time ----

// The split records of gbdt/ensemble.py _pack_splits: one int4 an internal
// node, a child being a leaf's w*output bits or a record index counted
// from the first record of its chunk of tree_chunk trees.
struct SplitForest {
  const int4* recs;
  const int* roots;          // [n_trees], within the tree's chunk
  const int* starts;         // [n_chunks + 1], the chunks' first records
  int n_trees, tree_chunk, max_tests, chunk_splits;
};

// A bin-space record (feature, node bin | left-is-leaf << 16 |
// right-is-leaf << 17, left, right) against the document's ids
// ids[f * stride] (an int compare: no wrap).
template <typename IdT>
struct BinTest {
  const IdT* ids;
  int stride;
  __device__ __forceinline__ int right(const int4& r) const {
    return static_cast<int>(ids[r.x * stride]) > (r.y & 0xFFFF);
  }
  __device__ __forceinline__ int leaf(const int4& r, int right) const {
    return (r.y >> (16 + right)) & 1;
  }
};

// An f32 record (feature | left-is-leaf << 30 | right-is-leaf << 31, the
// threshold's bits, left, right): left iff x <= t (NaN <= t is false). The
// first `staged` features come from shared memory (xs[f * stride]), later
// ones from the document's row of X.
struct F32Test {
  const float* xs;
  int stride, staged;
  const float* row;
  __device__ __forceinline__ int right(const int4& r) const {
    const int f = r.x & 0x3FFFFFFF;
    const float x = f < staged ? xs[f * stride] : __ldg(row + f);
    return !(x <= __int_as_float(r.y));
  }
  __device__ __forceinline__ int leaf(const int4& r, int right) const {
    return (static_cast<unsigned>(r.x) >> (30 + right)) & 1u;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Copies chunk c's records into dst (every thread of the block takes part).
__device__ __forceinline__ void stage_chunk(int4* dst, const SplitForest& s,
                                            int c) {
  const int lo = __ldg(s.starts + c);
  const int n = __ldg(s.starts + c + 1) - lo;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    cp_async16(dst + i, s.recs + lo + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Shared memory of a walk: [2][chunk_splits] staged records (kStaged),
// then the block's documents.
template <bool kStaged>
__device__ __forceinline__ size_t records_bytes(const SplitForest& s) {
  return kStaged ? 2 * static_cast<size_t>(s.chunk_splits) * 16 : 0;
}

// One tree from record `node` of the chunk `cr`: the leaf's w*output, or 0
// if no leaf is reached in max_tests tests (a malformed pack).
template <bool kStaged, typename Test>
__device__ __forceinline__ float walk_tree(const int4* cr, int node,
                                           const Test& test, int max_tests) {
  for (int d = 0; d < max_tests; ++d) {
    const int4 r = kStaged ? cr[node] : __ldg(cr + node);
    const int right = test.right(r);
    const int next = right ? r.w : r.z;
    if (test.leaf(r, right)) return __int_as_float(next);
    node = next;
  }
  return 0.0f;
}

// The chunk loop of every forest walk: the thread's document through every
// tree, one f32 partial a chunk. With kStaged the caller has started chunk
// 0's copy into srec (stage_chunk) before staging its documents; the
// __syncthreads after each chunk's wait also publishes those documents.
template <bool kStaged, typename Test>
__device__ __forceinline__ float walk_chunks(int4* srec, const SplitForest& s,
                                             const Test& test) {
  const int n_chunks = (s.n_trees + s.tree_chunk - 1) / s.tree_chunk;
  if constexpr (!kStaged) __syncthreads();
  float score = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * s.tree_chunk;
    const int t1 = min(t0 + s.tree_chunk, s.n_trees);
    const int4* cr;
    if constexpr (kStaged) {
      if (c + 1 < n_chunks) {        // the next chunk into the other buffer
        stage_chunk(srec + ((c + 1) & 1) * s.chunk_splits, s, c + 1);
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
      __syncthreads();
      cr = srec + (c & 1) * s.chunk_splits;
    } else {
      cr = s.recs + __ldg(s.starts + c);
    }
    float partial = 0.0f;
    for (int t = t0; t < t1; ++t) {
      partial += walk_tree<kStaged>(cr, __ldg(s.roots + t), test,
                                    s.max_tests);
    }
    score += partial;
    if constexpr (kStaged) __syncthreads();  // before its buffer is refilled
  }
  return score;
}

// Hands put(f, d, x) every x = X[doc0 + d, f] of the block's documents d
// and features f < n_cols (0 past n_docs). A warp takes its 32 documents 8
// features at a time: lane l reads feature f0 + l % 8 of documents
// 4 s + l / 8, s < 8 (a 32-byte run of each row), then an 8 x 8 transpose
// by shuffles within each 8 lanes leaves lane l the 8 features of document
// 4 (l % 8) + l / 8, which put takes one feature at a time.
template <typename Put>
__device__ __forceinline__ void stage_docs(const float* __restrict__ X,
                                           int64_t n_docs, int n_features,
                                           int n_cols, int64_t doc0,
                                           Put put) {
  const int lane = threadIdx.x & 31;
  const int p = lane & 7, q = lane >> 3;
  const int w0 = threadIdx.x - lane;
  const int d = w0 + 4 * p + q;
  for (int f0 = 0; f0 < n_cols; f0 += 8) {
    const int f = f0 + p;
    float v[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int64_t doc = doc0 + w0 + 4 * s + q;
      v[s] = doc < n_docs && f < n_cols ? X[doc * n_features + f] : 0.0f;
    }
    // swap bit b of the lane's p with bit b of the register index
#pragma unroll
    for (int b = 1; b < 8; b <<= 1) {
      const bool up = p & b;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r & b) continue;
        const float got =
            __shfl_xor_sync(0xffffffffu, up ? v[r] : v[r | b], b);
        if (up) v[r] = got; else v[r | b] = got;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (f0 + k < n_cols) put(f0 + k, d, v[k]);
    }
  }
}

// Host-binned ids binsT [n_features, n_docs] (uint8 or int16).
template <typename IdT, bool kStaged>
__global__ void frombins_kernel(const IdT* __restrict__ binsT,
                                int64_t n_docs, int n_features,
                                SplitForest s, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tb = blockDim.x;
  int4* srec = reinterpret_cast<int4*>(smem);
  IdT* sids = reinterpret_cast<IdT*>(smem + records_bytes<kStaged>(s));
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * tb;
  if constexpr (kStaged) stage_chunk(srec, s, 0);   // lands while ids load
  for (int i = threadIdx.x; i < n_features * tb; i += tb) {
    const int f = i / tb;
    const int d = i - f * tb;
    const int64_t doc = doc0 + d;
    sids[f * tb + d] =
        doc < n_docs ? binsT[static_cast<int64_t>(f) * n_docs + doc] : IdT{0};
  }
  const float score =
      walk_chunks<kStaged>(srec, s, BinTest<IdT>{sids + threadIdx.x, tb});
  const int64_t doc = doc0 + threadIdx.x;
  if (doc < n_docs) out[doc] = score;
}

// Device-resident X [n_docs, n_features] f32, binned against the model grid
// [n_features, grid_stride] into staged ids (uint8 or int16).
template <typename IdT, bool kStaged>
__global__ void bins_kernel(const float* __restrict__ X, int64_t n_docs,
                            int n_features, const float* __restrict__ grid,
                            int grid_stride, int n_grid, SplitForest s,
                            float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tb = blockDim.x;
  int4* srec = reinterpret_cast<int4*>(smem);
  IdT* sids = reinterpret_cast<IdT*>(smem + records_bytes<kStaged>(s));
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * tb;
  if constexpr (kStaged) stage_chunk(srec, s, 0);   // lands while X bins
  stage_docs(X, n_docs, n_features, n_features, doc0,
             [&](int f, int d, float x) {
               sids[f * tb + d] = static_cast<IdT>(bin_of(
                   grid + static_cast<int64_t>(f) * grid_stride, n_grid, x,
                   n_grid));
             });
  const float score =
      walk_chunks<kStaged>(srec, s, BinTest<IdT>{sids + threadIdx.x, tb});
  const int64_t doc = doc0 + threadIdx.x;
  if (doc < n_docs) out[doc] = score;
}

// f32 route: the first `staged` features of the block's documents are
// staged (feature-major); a node on a later feature reads the document's
// row of X.
template <bool kStaged>
__global__ void full_kernel(const float* __restrict__ X, int64_t n_docs,
                            int n_features, int staged, SplitForest s,
                            float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tb = blockDim.x;
  int4* srec = reinterpret_cast<int4*>(smem);
  float* sx = reinterpret_cast<float*>(smem + records_bytes<kStaged>(s));
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * tb;
  if constexpr (kStaged) stage_chunk(srec, s, 0);   // lands while X stages
  stage_docs(X, n_docs, n_features, staged, doc0,
             [&](int f, int d, float x) { sx[f * tb + d] = x; });
  const int64_t doc = doc0 + threadIdx.x;
  const float* row = X + (doc < n_docs ? doc : n_docs - 1) * n_features;
  const float score = walk_chunks<kStaged>(
      srec, s, F32Test{sx + threadIdx.x, tb, staged, row});
  if (doc < n_docs) out[doc] = score;
}

// Split route, binning pass: ids[f, doc] = bin_of(x[doc, f]) through a
// kTransposeTile^2 tile (read along features, written along documents).
constexpr int kTransposeTile = 32;
constexpr int kTransposeRows = 8;

template <typename IdT>
__global__ void bins_only_kernel(const float* __restrict__ X, int64_t n_docs,
                                 int n_features,
                                 const float* __restrict__ grid,
                                 int grid_stride, int n_grid,
                                 IdT* __restrict__ ids) {
  __shared__ float tile[kTransposeTile][kTransposeTile + 1];
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * kTransposeTile;
  const int f0 = blockIdx.y * kTransposeTile;
  for (int j = threadIdx.y; j < kTransposeTile; j += kTransposeRows) {
    const int64_t doc = doc0 + j;
    const int f = f0 + threadIdx.x;
    tile[j][threadIdx.x] =
        doc < n_docs && f < n_features ? X[doc * n_features + f] : 0.0f;
  }
  __syncthreads();
  const int64_t doc = doc0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTransposeTile; i += kTransposeRows) {
    const int f = f0 + i;
    if (f < n_features && doc < n_docs) {
      ids[static_cast<int64_t>(f) * n_docs + doc] = static_cast<IdT>(
          bin_of(grid + static_cast<int64_t>(f) * grid_stride, n_grid,
                 tile[threadIdx.x][i], n_grid));
    }
  }
}

// A 0/1 node test as f32: uint8, or bf16 passed as its raw 16 bits.
__device__ __forceinline__ float pred_value(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float pred_value(uint16_t bf16_bits) {
  return __uint_as_float(static_cast<unsigned>(bf16_bits) << 16);
}

// Predicate epilogue: chunks in order, one f32 partial a chunk; in a chunk,
// trees in order, each adding the output of the leaf its path reaches.
template <typename PredT>
__global__ void pred_epilogue_kernel(const PredT* __restrict__ predT,
                                     int64_t n_docs, int n_chunks, int tcm,
                                     int tcl, int tree_chunk, int m_per_tree,
                                     const float* __restrict__ pmq,
                                     const float* __restrict__ csq,
                                     const float* __restrict__ plen,
                                     const float* __restrict__ outw,
                                     float* __restrict__ out) {
  const int64_t doc = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (doc >= n_docs) return;
  const int n_leaves = tcl / tree_chunk;
  float score = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const PredT* pred = predT + static_cast<int64_t>(c) * tcm * n_docs + doc;
    const float* pm = pmq + static_cast<int64_t>(c) * tcm * tcl;
    const int aux = c * tcl;
    float partial = 0.0f;
    for (int j = 0; j < tree_chunk; ++j) {
      float leaf = 0.0f;
      for (int l = 0; l < n_leaves; ++l) {
        const int col = j * n_leaves + l;
        float hits = 0.0f;
        for (int m = 0; m < m_per_tree; ++m) {
          const int r = j * m_per_tree + m;
          const float w = __ldg(pm + static_cast<int64_t>(r) * tcl + col);
          if (w != 0.0f) hits += w * pred_value(pred[static_cast<int64_t>(r) *
                                                     n_docs]);
        }
        if (hits == __ldg(plen + aux + col) - __ldg(csq + aux + col)) {
          leaf += __ldg(outw + aux + col);
        }
      }
      partial += leaf;
    }
    score += partial;
  }
  out[doc] = score;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The launch of a forest walk whose documents take `value_bytes` a staged
// feature. Documents a block: of 256, 128, 64 and 32, the count that keeps
// the most threads resident on an SM (at most 2,048 threads and 32 blocks,
// 233,472 bytes of shared memory less 1 KB a block; the larger count on a
// tie), every feature staged. With `partial` (the f32 walk), 32 documents
// stage as many leading features as fit when not all do. A chunk's
// records are staged (double-buffered) when both buffers take at most
// kMaxStagedRecords bytes and fit beside the documents; else the walk
// reads them through the read-only cache. tb == 0: no count fits.
constexpr size_t kMaxStagedRecords = 64 * 1024;
constexpr size_t kMaxSmem = 232448;
constexpr size_t kSmSmem = 233472;

struct WalkPlan {
  int tb = 0;                // documents (threads) a block
  int cols = 0;              // features staged
  bool staged = false;       // records staged
  size_t smem = 0;
};

WalkPlan plan_walk(int n_features, size_t value_bytes, bool partial,
                   const SplitForest& s) {
  const size_t recs = 2 * static_cast<size_t>(s.chunk_splits) * 16;
  WalkPlan best;
  int resident = 0;
  for (int docs = 256; docs >= 32; docs >>= 1) {
    const size_t col = value_bytes * docs;
    int cols = n_features;
    if (cols * col > kMaxSmem) {
      if (!partial || docs > 32) continue;
      cols = static_cast<int>(kMaxSmem / col);
    }
    const size_t vals = cols * col;
    const bool stage = recs <= kMaxStagedRecords && vals + recs <= kMaxSmem;
    const size_t bytes = vals + (stage ? recs : 0);
    const int blocks = std::min({2048 / docs, 32,
                                 static_cast<int>(kSmSmem / (bytes + 1024))});
    if (blocks * docs > resident) {
      resident = blocks * docs;
      best = WalkPlan{docs, cols, stage, bytes};
    }
  }
  return best;
}

template <typename Kernel, typename... Args>
int launch_walk(Kernel kernel, const WalkPlan& p, int64_t n_docs,
                void* stream, Args... args) {
  if (p.tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_docs + p.tb - 1) / p.tb);
  kernel<<<blocks, p.tb, p.smem, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename IdT>
int launch_frombins(const void* binsT, int64_t n_docs, int n_features,
                    const SplitForest& s, void* out, void* stream) {
  const WalkPlan p = plan_walk(n_features, sizeof(IdT), false, s);
  return launch_walk(p.staged ? frombins_kernel<IdT, true>
                              : frombins_kernel<IdT, false>,
                     p, n_docs, stream, static_cast<const IdT*>(binsT),
                     n_docs, n_features, s, static_cast<float*>(out));
}

template <typename IdT>
int launch_bins(const void* X, int64_t n_docs, int n_features,
                const void* grid, int grid_stride, int n_grid,
                const SplitForest& s, void* out, void* stream) {
  const WalkPlan p = plan_walk(n_features, sizeof(IdT), false, s);
  return launch_walk(p.staged ? bins_kernel<IdT, true>
                              : bins_kernel<IdT, false>,
                     p, n_docs, stream, static_cast<const float*>(X),
                     n_docs, n_features, static_cast<const float*>(grid),
                     grid_stride, n_grid, s, static_cast<float*>(out));
}

SplitForest split_forest(const void* splits, const void* roots,
                         const void* starts, int n_trees, int tree_chunk,
                         int max_tests, int chunk_splits) {
  return SplitForest{static_cast<const int4*>(splits),
                     static_cast<const int*>(roots),
                     static_cast<const int*>(starts), n_trees, tree_chunk,
                     max_tests, chunk_splits};
}

template <typename IdT>
int launch_bins_only(const void* X, int64_t n_docs, int n_features,
                     const void* grid, int grid_stride, int n_grid, void* ids,
                     void* stream) {
  const dim3 blocks(
      static_cast<unsigned>((n_docs + kTransposeTile - 1) / kTransposeTile),
      static_cast<unsigned>((n_features + kTransposeTile - 1) /
                            kTransposeTile));
  bins_only_kernel<IdT><<<blocks, dim3(kTransposeTile, kTransposeRows), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), n_docs, n_features,
      static_cast<const float*>(grid), grid_stride, n_grid,
      static_cast<IdT*>(ids));
  return static_cast<int>(cudaGetLastError());
}

template <typename PredT>
int launch_pred(const void* predT, int64_t n_docs, int n_chunks, int tcm,
                int tcl, int tree_chunk, int m_per_tree, const void* pmq,
                const void* csq, const void* plen, const void* outw, void* out,
                void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((n_docs + kMaxDocsPerBlock - 1) / kMaxDocsPerBlock);
  pred_epilogue_kernel<PredT><<<blocks, kMaxDocsPerBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const PredT*>(predT), n_docs, n_chunks, tcm, tcl,
      tree_chunk, m_per_tree, static_cast<const float*>(pmq),
      static_cast<const float*>(csq), static_cast<const float*>(plen),
      static_cast<const float*>(outw), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is the caller's cudaStream_t. Nothing here allocates or synchronises.
// Each returns the cudaError_t of the launch (0 = success).
//
// The forest walks take the split records of _pack_splits: splits [S, 4],
// roots [n_trees] and starts [n_chunks + 1] int32, max_tests the most
// tests on a root-to-leaf path (at least 1), chunk_splits the most records
// in a chunk.

// frombins: binsT [n_features, n_docs] uint8 or int16 ids.
extern "C" int forest_eval_frombins_u8(const void* binsT, int64_t n_docs,
                                       int n_features, const void* splits,
                                       const void* roots, const void* starts,
                                       int n_trees, int tree_chunk,
                                       int max_tests, int chunk_splits,
                                       void* out, void* stream) {
  return launch_frombins<uint8_t>(
      binsT, n_docs, n_features,
      split_forest(splits, roots, starts, n_trees, tree_chunk, max_tests,
                   chunk_splits),
      out, stream);
}

extern "C" int forest_eval_frombins_i16(const void* binsT, int64_t n_docs,
                                        int n_features, const void* splits,
                                        const void* roots, const void* starts,
                                        int n_trees, int tree_chunk,
                                        int max_tests, int chunk_splits,
                                        void* out, void* stream) {
  return launch_frombins<int16_t>(
      binsT, n_docs, n_features,
      split_forest(splits, roots, starts, n_trees, tree_chunk, max_tests,
                   chunk_splits),
      out, stream);
}

// bins: X [n_docs, n_features] f32 row-major, binned against grid
// [n_features, grid_stride] (sorted rows, n_grid thresholds used) into
// staged uint8 ids, int16 when n_grid reaches 256.
extern "C" int forest_eval_bins(const void* X, int64_t n_docs, int n_features,
                                const void* grid, int grid_stride, int n_grid,
                                const void* splits, const void* roots,
                                const void* starts, int n_trees,
                                int tree_chunk, int max_tests,
                                int chunk_splits, void* out, void* stream) {
  const SplitForest s = split_forest(splits, roots, starts, n_trees,
                                     tree_chunk, max_tests, chunk_splits);
  return n_grid < 256
             ? launch_bins<uint8_t>(X, n_docs, n_features, grid, grid_stride,
                                    n_grid, s, out, stream)
             : launch_bins<int16_t>(X, n_docs, n_features, grid, grid_stride,
                                    n_grid, s, out, stream);
}

// f32 route: X [n_docs, n_features] f32 row-major; f32 split records
// (_pack_splits(f32=True)), any width.
extern "C" int forest_eval_full(const void* X, int64_t n_docs, int n_features,
                                const void* splits, const void* roots,
                                const void* starts, int n_trees,
                                int tree_chunk, int max_tests,
                                int chunk_splits, void* out, void* stream) {
  const SplitForest s = split_forest(splits, roots, starts, n_trees,
                                     tree_chunk, max_tests, chunk_splits);
  const WalkPlan p = plan_walk(n_features, sizeof(float), true, s);
  return launch_walk(p.staged ? full_kernel<true> : full_kernel<false>, p,
                     n_docs, stream, static_cast<const float*>(X), n_docs,
                     n_features, p.cols, s, static_cast<float*>(out));
}

// Split route, binning pass: X [n_docs, n_features] f32 row-major -> ids
// [n_features, n_docs] (uint8 when every id is below 256, else int16).
extern "C" int forest_bins_only_u8(const void* X, int64_t n_docs,
                                   int n_features, const void* grid,
                                   int grid_stride, int n_grid, void* ids,
                                   void* stream) {
  return launch_bins_only<uint8_t>(X, n_docs, n_features, grid, grid_stride,
                                   n_grid, ids, stream);
}

extern "C" int forest_bins_only_i16(const void* X, int64_t n_docs,
                                    int n_features, const void* grid,
                                    int grid_stride, int n_grid, void* ids,
                                    void* stream) {
  return launch_bins_only<int16_t>(X, n_docs, n_features, grid, grid_stride,
                                   n_grid, ids, stream);
}

// Predicate epilogue: predT [n_chunks * tcm, n_docs] 0/1 (uint8, or bf16
// bits), pmq [n_chunks, tcm, tcl] f32 block-diagonal (one [m_per_tree,
// tcl / tree_chunk] block a tree), csq / plen / outw [n_chunks, tcl] f32.
extern "C" int forest_eval_pred_u8(const void* predT, int64_t n_docs,
                                   int n_chunks, int tcm, int tcl,
                                   int tree_chunk, int m_per_tree,
                                   const void* pmq, const void* csq,
                                   const void* plen, const void* outw,
                                   void* out, void* stream) {
  return launch_pred<uint8_t>(predT, n_docs, n_chunks, tcm, tcl, tree_chunk,
                              m_per_tree, pmq, csq, plen, outw, out, stream);
}

extern "C" int forest_eval_pred_bf16(const void* predT, int64_t n_docs,
                                     int n_chunks, int tcm, int tcl,
                                     int tree_chunk, int m_per_tree,
                                     const void* pmq, const void* csq,
                                     const void* plen, const void* outw,
                                     void* out, void* stream) {
  return launch_pred<uint16_t>(predT, n_docs, n_chunks, tcm, tcl, tree_chunk,
                               m_per_tree, pmq, csq, plen, outw, out, stream);
}
