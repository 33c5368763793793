// Forest evaluation for Hopper (sm_90a): the CUDA counterparts of
// ranklib_tpu/ops/forest_eval.py _forest_frombins_kernel (host-binned ids),
// _forest_bins_kernel (ids binned here from f32 features) and
// _forest_full3_kernel / _forest_full_kernel (the f32 route).
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
// walks one document through every tree from the root, over per-node
// records (feature or -1 at a leaf, node test, left, right) packed once per
// model (gbdt/ensemble.py _pack_walk); the node test is the node bin, or
// the threshold's f32 bits on the f32 route. Scores add in f32 in tree
// order, one partial per chunk of `tree_chunk` trees, the order the plain
// PyTorch versions use, so kernel and plain version agree bit for bit.
//
// What bounds it on the H100: per document, ~depth dependent loads per
// tree (node record, then the document's bin or value of that node's
// feature). The node records of a 1,000-tree model (~19K x 16 B) stay in
// L1/L2 and are read by every warp, so the walk is bound by load latency
// and warp divergence, not by HBM. The documents' bins are staged once per
// block in shared memory (int16, feature-major), so the walk's bin reads
// never leave the SM; the staging reads of binsT / X are coalesced.
// Binning on the device is a binary search per value over at most 256 grid
// entries. The f32 route stages f32 values the same way up to a 48 KB
// budget (every feature at 136 features); features past it are read from
// the document's row in global memory, so any width runs.

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

template <typename BinT>
__global__ void frombins_kernel(const BinT* __restrict__ binsT,
                                int64_t n_docs, int n_features, Forest forest,
                                float* __restrict__ out) {
  extern __shared__ int16_t sbins[];             // [n_features][blockDim.x]
  const int tb = blockDim.x;
  const int64_t doc0 = static_cast<int64_t>(blockIdx.x) * tb;
  for (int i = threadIdx.x; i < n_features * tb; i += tb) {
    const int f = i / tb;
    const int64_t doc = doc0 + (i - f * tb);
    sbins[i] = doc < n_docs
        ? static_cast<int16_t>(binsT[static_cast<int64_t>(f) * n_docs + doc])
        : int16_t{0};
  }
  __syncthreads();
  const int64_t doc = doc0 + threadIdx.x;
  if (doc < n_docs) out[doc] = walk_bins(sbins + threadIdx.x, tb, forest);
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

template <typename BinT>
int launch_frombins(const void* binsT, int64_t n_docs, int n_features,
                    const void* nodes, const void* values, const void* roots,
                    int n_trees, int max_depth, int tree_chunk, void* out,
                    void* stream) {
  size_t smem = 0;
  const int tb = docs_per_block(n_features, &smem);
  cudaError_t err = allow_smem(frombins_kernel<BinT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_docs + tb - 1) / tb);
  frombins_kernel<BinT><<<blocks, tb, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const BinT*>(binsT), n_docs, n_features,
      make_forest(nodes, values, roots, n_trees, max_depth, tree_chunk),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is the caller's cudaStream_t. Nothing here allocates or synchronises.
// Each returns the cudaError_t of the launch (0 = success).

extern "C" int forest_eval_frombins_u8(const void* binsT, int64_t n_docs,
                                       int n_features, const void* nodes,
                                       const void* values, const void* roots,
                                       int n_trees, int max_depth,
                                       int tree_chunk, void* out,
                                       void* stream) {
  return launch_frombins<uint8_t>(binsT, n_docs, n_features, nodes, values,
                                  roots, n_trees, max_depth, tree_chunk, out,
                                  stream);
}

extern "C" int forest_eval_frombins_i16(const void* binsT, int64_t n_docs,
                                        int n_features, const void* nodes,
                                        const void* values, const void* roots,
                                        int n_trees, int max_depth,
                                        int tree_chunk, void* out,
                                        void* stream) {
  return launch_frombins<int16_t>(binsT, n_docs, n_features, nodes, values,
                                  roots, n_trees, max_depth, tree_chunk, out,
                                  stream);
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
