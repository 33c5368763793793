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
// threshold, and thresholds near +-3.4e38 compare like any other. The
// TPU's 3-plane bf16 split, its +-3e38 clamp and the band gate that guards
// it were MXU workarounds and have no counterpart here.
//
// How: the TPU kernels turn the walk into one-hot selection and path
// matmuls because the MXU is the only fast unit there. Here one thread
// walks one document through every tree from the root. Scores add in f32
// in tree order, one partial per chunk of `tree_chunk` trees, the order
// the plain PyTorch versions use, so kernel and plain version agree bit for
// bit.
//
// The bins and f32 kernels walk per-slot records (feature or -1 at a leaf,
// node test, left, right; gbdt/ensemble.py _pack_walk), the node test being
// the node bin or the threshold's f32 bits, with leaf values in a second
// array: per tree ~depth + 1 dependent loads of a 16-byte record from L1/L2
// (a 1,000-tree model's ~19K records do not fit L1 beside the staged
// inputs), each followed by the document's bin or value of that feature.
// The documents' bins are staged once per block in shared memory (int16,
// feature-major), so those reads never leave the SM; the staging reads of
// binsT / X are coalesced. Binning on the device is a binary search per
// value over at most 256 grid entries. The f32 route stages f32 values the
// same way up to a 48 KB budget (every feature at 136 features); features
// past it are read from the document's row in global memory, so any width
// runs.
//
// The frombins kernel (the default serving route, and the selection half
// of the split route) walks split records instead (_pack_splits): one
// 16-byte record an internal node that carries both children, a child
// being a leaf's w*output itself, so a tree costs one record per test and
// no leaf visit; a chunk of tree_chunk trees is one contiguous run of
// records (9 a 10-leaf tree, ~3.6 KB a chunk), which every block copies
// into shared memory with cp.async, double-buffered, the next chunk landing
// while its warps walk this one; uint8 ids are staged as bytes (34.8 KB
// for 256 documents x 136 features), so five blocks of 256 documents fit
// an SM. A warp walks each tree in lockstep, so its lanes read one record
// or a few, and the same feature's ids. What bounds it: the dependent
// shared-memory loads and the instructions of each test, repeated to the
// deepest walk of the warp's 32 documents (on the H100 it was measured
// against variants: records read through L1 instead, 2 trees in flight a
// thread, lanes running through a chunk at their own pace, int16 staging,
// 64/128 documents a block, id rows padded against bank conflicts;
// PERF.md). Chunks too large to stage (more than 64 KB for both buffers)
// are walked from the read-only cache.
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

struct Forest {
  const int4* nodes;
  const float* values;
  const int* roots;
  int n_trees, max_depth, tree_chunk;
};

// Walks every tree for one document; go_left(rec) is the node test of a
// record (feature, test, left, right) at a split.
template <typename GoLeft>
__device__ __forceinline__ float walk_forest(GoLeft go_left,
                                             const Forest& forest) {
  float score = 0.0f;
  for (int t0 = 0; t0 < forest.n_trees; t0 += forest.tree_chunk) {
    const int t1 = min(t0 + forest.tree_chunk, forest.n_trees);
    float partial = 0.0f;
    for (int t = t0; t < t1; ++t) {
      int node = __ldg(forest.roots + t);
      int4 rec = __ldg(forest.nodes + node);
      for (int d = 0; d < forest.max_depth && rec.x >= 0; ++d) {
        node = go_left(rec) ? rec.z : rec.w;
        rec = __ldg(forest.nodes + node);
      }
      partial += __ldg(forest.values + node);
    }
    score += partial;
  }
  return score;
}

// Walks one document whose bin ids are sbins[f * stride] (int compare: no
// wrap).
__device__ __forceinline__ float walk_bins(const int16_t* sbins, int stride,
                                           const Forest& forest) {
  return walk_forest(
      [&](const int4& rec) { return sbins[rec.x * stride] <= rec.y; },
      forest);
}

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

// ---- the frombins kernel: split records staged a tree chunk at a time ----

// The split records of gbdt/ensemble.py _pack_splits: one int4 an internal
// node (feature, node bin | left-is-leaf << 16 | right-is-leaf << 17, left,
// right), a child being a leaf's w*output bits or a record index counted
// from the first record of its chunk of tree_chunk trees.
struct SplitForest {
  const int4* recs;
  const int* roots;          // [n_trees], within the tree's chunk
  const int* starts;         // [n_chunks + 1], the chunks' first records
  int n_trees, tree_chunk, max_tests, chunk_splits;
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

// One tree from record `node` of the chunk `cr` for the document whose ids
// are ids[f * stride]: the leaf's w*output, or 0 if no leaf is reached in
// max_tests tests (a malformed pack; the old walk added 0 there too).
template <bool kStaged, typename IdT>
__device__ __forceinline__ float walk_splits(const int4* cr, int node,
                                             const IdT* ids, int stride,
                                             int max_tests) {
  for (int d = 0; d < max_tests; ++d) {
    const int4 r = kStaged ? cr[node] : __ldg(cr + node);
    const int right = static_cast<int>(ids[r.x * stride]) > (r.y & 0xFFFF);
    const int next = right ? r.w : r.z;
    if ((r.y >> (16 + right)) & 1) return __int_as_float(next);
    node = next;
  }
  return 0.0f;
}

template <typename IdT, bool kStaged>
__global__ void frombins_kernel(const IdT* __restrict__ binsT,
                                int64_t n_docs, int n_features,
                                SplitForest s, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tb = blockDim.x;
  // [2][chunk_splits] staged records (kStaged), then [n_features][tb] ids
  // of the block's documents, as they came (bytes when uint8)
  int4* srec = reinterpret_cast<int4*>(smem);
  IdT* sids = reinterpret_cast<IdT*>(
      smem + (kStaged ? 2 * static_cast<size_t>(s.chunk_splits) * 16 : 0));
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * tb;
  const int n_chunks = (s.n_trees + s.tree_chunk - 1) / s.tree_chunk;
  if constexpr (kStaged) stage_chunk(srec, s, 0);   // lands while ids load
  for (int i = threadIdx.x; i < n_features * tb; i += tb) {
    const int f = i / tb;
    const int d = i - f * tb;
    const int64_t doc = doc0 + d;
    sids[f * tb + d] =
        doc < n_docs ? binsT[static_cast<int64_t>(f) * n_docs + doc] : IdT{0};
  }
  if constexpr (!kStaged) __syncthreads();
  const IdT* ids = sids + threadIdx.x;
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
      partial += walk_splits<kStaged>(cr, __ldg(s.roots + t), ids, tb,
                                      s.max_tests);
    }
    score += partial;
    if constexpr (kStaged) __syncthreads();  // before its buffer is refilled
  }
  const int64_t doc = doc0 + threadIdx.x;
  if (doc < n_docs) out[doc] = score;
}

__global__ void bins_kernel(const float* __restrict__ X, int64_t n_docs,
                            int n_features, const float* __restrict__ grid,
                            int grid_stride, int n_grid, Forest forest,
                            float* __restrict__ out) {
  extern __shared__ int16_t sbins[];             // [n_features][blockDim.x]
  const int tb = blockDim.x;
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * tb;
  // consecutive threads read consecutive X elements (row-major [N, F])
  for (int i = threadIdx.x; i < n_features * tb; i += tb) {
    const int j = i / n_features;
    const int f = i - j * n_features;
    const int64_t doc = doc0 + j;
    int b = 0;
    if (doc < n_docs) {
      b = bin_of(grid + static_cast<int64_t>(f) * grid_stride, n_grid,
                 X[doc * n_features + f], n_grid);
    }
    sbins[f * tb + j] = static_cast<int16_t>(b);
  }
  __syncthreads();
  const int64_t doc = doc0 + threadIdx.x;
  if (doc < n_docs) out[doc] = walk_bins(sbins + threadIdx.x, tb, forest);
}

// f32 route: the first `staged` features of the block's documents are
// staged in shared memory (feature-major); a node on a later feature reads
// the document's row of X.
__global__ void full_kernel(const float* __restrict__ X, int64_t n_docs,
                            int n_features, int staged, Forest forest,
                            float* __restrict__ out) {
  extern __shared__ float sx[];                  // [staged][blockDim.x]
  const int tb = blockDim.x;
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * tb;
  for (int i = threadIdx.x; i < staged * tb; i += tb) {
    const int j = i / staged;
    const int f = i - j * staged;
    const int64_t doc = doc0 + j;
    sx[f * tb + j] = doc < n_docs ? X[doc * n_features + f] : 0.0f;
  }
  __syncthreads();
  const int64_t doc = doc0 + threadIdx.x;
  if (doc >= n_docs) return;
  const float* sxd = sx + threadIdx.x;
  const float* row = X + doc * n_features;
  out[doc] = walk_forest(
      [&](const int4& rec) {
        const float x = rec.x < staged ? sxd[rec.x * tb] : __ldg(row + rec.x);
        return x <= __int_as_float(rec.y);       // NaN <= t is false
      },
      forest);
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

// Docs per block: 128, halved while the staged bins exceed the default
// 48 KB; past that (very wide inputs) the block asks for up to 227 KB.
int docs_per_block(int n_features, size_t* smem) {
  int tb = kMaxDocsPerBlock;
  while (tb > 32 && static_cast<size_t>(n_features) * tb * sizeof(int16_t) >
                        kDefaultSmem) {
    tb >>= 1;
  }
  *smem = static_cast<size_t>(n_features) * tb * sizeof(int16_t);
  return tb;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

Forest make_forest(const void* nodes, const void* values, const void* roots,
                   int n_trees, int max_depth, int tree_chunk) {
  return Forest{static_cast<const int4*>(nodes),
                static_cast<const float*>(values),
                static_cast<const int*>(roots), n_trees, max_depth,
                tree_chunk};
}

// The frombins launch. Documents a block: of 256, 128, 64 and 32, the
// count that keeps the most threads resident on an SM (at most 2,048
// threads and 32 blocks, 233,472 bytes of shared memory less 1 KB a block;
// the larger count on a tie). A chunk's records are staged
// (double-buffered) when both buffers take at most kMaxStagedRecords bytes
// and fit beside the ids; else the walk reads them through the read-only
// cache.
constexpr size_t kMaxStagedRecords = 64 * 1024;
constexpr size_t kMaxSmem = 232448;
constexpr size_t kSmSmem = 233472;

template <typename IdT>
int launch_frombins(const void* binsT, int64_t n_docs, int n_features,
                    const SplitForest& s, void* out, void* stream) {
  const size_t recs = 2 * static_cast<size_t>(s.chunk_splits) * 16;
  int tb = 0, resident = 0;
  bool staged = false;
  size_t smem = 0;
  for (int docs = 256; docs >= 32; docs >>= 1) {
    const size_t ids = static_cast<size_t>(n_features) * docs * sizeof(IdT);
    if (ids > kMaxSmem) continue;
    const bool stage = recs <= kMaxStagedRecords && ids + recs <= kMaxSmem;
    const size_t bytes = ids + (stage ? recs : 0);
    const int blocks = std::min({2048 / docs, 32,
                                 static_cast<int>(kSmSmem / (bytes + 1024))});
    if (blocks * docs > resident) {
      tb = docs, resident = blocks * docs;
      staged = stage, smem = bytes;
    }
  }
  if (tb == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = staged ? frombins_kernel<IdT, true>
                             : frombins_kernel<IdT, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_docs + tb - 1) / tb);
  kernel<<<blocks, tb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const IdT*>(binsT), n_docs, n_features, s,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
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

// frombins: binsT [n_features, n_docs] uint8 or int16 ids; the split
// records of _pack_splits (splits [S, 4], roots [n_trees] and starts
// [n_chunks + 1] int32), max_tests the most tests on a root-to-leaf path
// (at least 1), chunk_splits the most records in a chunk.
extern "C" int forest_eval_frombins_u8(const void* binsT, int64_t n_docs,
                                       int n_features, const void* splits,
                                       const void* roots, const void* starts,
                                       int n_trees, int tree_chunk,
                                       int max_tests, int chunk_splits,
                                       void* out, void* stream) {
  return launch_frombins<uint8_t>(
      binsT, n_docs, n_features,
      SplitForest{static_cast<const int4*>(splits),
                  static_cast<const int*>(roots),
                  static_cast<const int*>(starts), n_trees, tree_chunk,
                  max_tests, chunk_splits},
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
      SplitForest{static_cast<const int4*>(splits),
                  static_cast<const int*>(roots),
                  static_cast<const int*>(starts), n_trees, tree_chunk,
                  max_tests, chunk_splits},
      out, stream);
}

extern "C" int forest_eval_bins(const void* X, int64_t n_docs, int n_features,
                                const void* grid, int grid_stride, int n_grid,
                                const void* nodes, const void* values,
                                const void* roots, int n_trees, int max_depth,
                                int tree_chunk, void* out, void* stream) {
  size_t smem = 0;
  const int tb = docs_per_block(n_features, &smem);
  cudaError_t err = allow_smem(bins_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_docs + tb - 1) / tb);
  bins_kernel<<<blocks, tb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), n_docs, n_features,
      static_cast<const float*>(grid), grid_stride, n_grid,
      make_forest(nodes, values, roots, n_trees, max_depth, tree_chunk),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// f32 route: X [n_docs, n_features] f32 row-major; node records carry the
// threshold's f32 bits. Docs per block: 128, halved (to 32) while their
// f32 rows exceed 48 KB; as many leading features as fit 48 KB are staged.
extern "C" int forest_eval_full(const void* X, int64_t n_docs, int n_features,
                                const void* nodes, const void* values,
                                const void* roots, int n_trees, int max_depth,
                                int tree_chunk, void* out, void* stream) {
  int tb = kMaxDocsPerBlock;
  while (tb > 32 &&
         static_cast<size_t>(n_features) * tb * sizeof(float) > kDefaultSmem) {
    tb >>= 1;
  }
  const int staged = static_cast<int>(std::min(
      static_cast<size_t>(n_features), kDefaultSmem / (tb * sizeof(float))));
  const size_t smem = static_cast<size_t>(staged) * tb * sizeof(float);
  const unsigned blocks = static_cast<unsigned>((n_docs + tb - 1) / tb);
  full_kernel<<<blocks, tb, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), n_docs, n_features, staged,
      make_forest(nodes, values, roots, n_trees, max_depth, tree_chunk),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
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
