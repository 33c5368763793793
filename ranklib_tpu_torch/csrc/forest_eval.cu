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
// The split route's binning pass (bins_only_kernel) is bound by its bytes
// (f32 X read once, ids [F, N] written once) and by the instructions of
// its searches. A block stages the grid rows of its 16 features in shared
// memory once, in Eytzinger (breadth-first) order padded with +inf to
// 2^steps - 1 entries, and walks tiles of 128 documents: X arrives by
// 16-byte reads and is transposed in shared memory, then a warp bins 128
// documents of one feature, 4 consecutive documents a lane, by a fixed
// trip of ceil(log2(n_grid + 1)) branchless steps of four instructions
// (load, compare, shift-add of the node's address, add), and stores the 4
// ids as one 32-bit (uint8) or 64-bit (int16) word. Measured against
// variants (PERF.md): a sorted row searched by halving lost to the
// Eytzinger order (bank conflicts), loads one tile ahead, a ring of tiles
// by cp.async, top levels held in registers and transposing 16-byte
// stores gained nothing or lost.
//
// The predicate epilogue (pred_epilogue_kernel) takes the reference's
// matmul layout: 0/1 node tests predT [nch * TCM, N], csQ, plen, w * output,
// and instead of the block-diagonal P - Q its path lists (gbdt/ensemble.py
// _pred_paths: per tree, each leaf's +1 rows then its -1 rows, built once
// a pack). Bound by reading predT once (1 or 2 bytes a node test and
// document). A thread takes 32 documents (uint8; bf16 16), a block its
// threads' documents over one group of chunks; tree by tree it stages the
// tree's M rows of predT for its documents and the tree's path record in
// shared memory with cp.async, double-buffered, so each node test is read
// from global memory once. Each leaf then counts its path agreements
// hits = sum of +-test over its path list: warp-uniform list reads, 16
// documents a 16-byte shared load and four integer adds, 4 documents'
// counts packed in the bytes of one word; a chain tree of 10 leaves reads
// its 54 path entries, not the 90 entries of its P - Q block. A leaf's
// output adds where hits == plen - csQ, in leaf order, trees in order into
// one partial a chunk; a second kernel adds the chunks' partials in chunk
// order, so the sums keep the plain version's order while the chunk groups
// fill the card. Trees too large to stage read the words from global
// memory instead.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

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
// The same, reading `bytes` (0..16) and zero-filling the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// ---- the split route's binning pass ----

// ids[f, doc] = #{grid_f[0:n_grid] < x[doc, f]}, NaN -> n_grid. A block
// takes kBinFeats features and walks tiles of kBinDocs documents, grid-
// strided; each tile's X [kBinDocs, kBinFeats] is read into registers
// (16-byte reads when the rows allow) and lands in shared memory
// feature-major, then a warp bins 128 documents of one feature, 4
// consecutive documents a lane, and stores their 4 ids as one 32-bit
// (uint8) or 64-bit (int16) word.
constexpr int kBinFeats = 16;
constexpr int kBinDocs = 128;
constexpr int kBinThreads = 256;
constexpr int kBinPitch = kBinDocs + 4;   // 16-byte rows, 2-way at most
constexpr int kBinMaxSteps = 9;           // staged grids: n_grid <= 511
constexpr int kBinPerThread = kBinDocs * kBinFeats / kBinThreads;  // 8

// #{row[i] < x} of four documents over a grid row staged in Eytzinger
// (breadth-first) order: eyt[k - 1] is the node k = 1..2^steps - 1 of the
// complete search tree over the sorted row padded with +inf, so a fixed
// trip of `steps` branchless steps k = 2k + (eyt[k - 1] < x) ends at
// 2^steps + the count. A step is a load, a compare and a shift-add on the
// node's shared-memory byte address a = base + 4(k - 1) (a' = 2a + 4 -
// base, plus 4 to go right). A level's nodes are contiguous: the lanes of
// a warp, all on one row, read at most 2^level distinct words, in distinct
// banks up to level 5. NaN -> n_grid.
__device__ __forceinline__ int4 bins4_eytzinger(const float* eyt, int steps,
                                                float4 x4, int n_grid) {
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(eyt));
  const unsigned left = 4u - base;
  const float x[4] = {x4.x, x4.y, x4.z, x4.w};
  unsigned a[4] = {base, base, base, base};
  for (int l = 0; l < steps; ++l) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v;
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a[j]));
      const unsigned child = 2u * a[j] + left;      // the left child
      a[j] = v < x[j] ? child + 4u : child;
    }
  }
  int b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // a = base + 4(k - 1): the count is k - 2^steps
    b[j] = isnan(x[j]) ? n_grid
                       : static_cast<int>((a[j] - base) >> 2) + 1 -
                             (1 << steps);
  }
  return make_int4(b[0], b[1], b[2], b[3]);
}

// The same count over a sorted row read from global memory (grids past
// kBinMaxSteps): the position advances by halving steps.
__device__ __forceinline__ int4 bins4_global(const float* __restrict__ row,
                                             int n, int steps, float4 x) {
  int b[4] = {0, 0, 0, 0};
  const float v[4] = {x.x, x.y, x.z, x.w};
  for (int step = (1 << steps) >> 1; step > 0; step >>= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = b[j] + step - 1;
      b[j] += i < n && __ldg(row + i) < v[j] ? step : 0;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = isnan(v[j]) ? n : b[j];
  return make_int4(b[0], b[1], b[2], b[3]);
}

__device__ __forceinline__ void store4(uint8_t* p, int4 b) {
  *reinterpret_cast<uint32_t*>(p) =
      static_cast<uint32_t>(b.x) | static_cast<uint32_t>(b.y) << 8 |
      static_cast<uint32_t>(b.z) << 16 | static_cast<uint32_t>(b.w) << 24;
}
__device__ __forceinline__ void store4(int16_t* p, int4 b) {
  *reinterpret_cast<uint2*>(p) = make_uint2(
      static_cast<uint32_t>(b.x & 0xffff) | static_cast<uint32_t>(b.y) << 16,
      static_cast<uint32_t>(b.z & 0xffff) | static_cast<uint32_t>(b.w) << 16);
}

// A thread's kBinPerThread values of tile t: with vec_x, two 16-byte reads
// of 4 features (thread i and i + 256 of the tile's 512 reads), else 8
// scalars.
__device__ __forceinline__ void read_tile(const float* __restrict__ X,
                                          int64_t n_docs, int n_features,
                                          int f0, int nf, int64_t doc0,
                                          bool vec_x,
                                          float (&v)[kBinPerThread]) {
  if (vec_x) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = threadIdx.x + h * kBinThreads;
      const int d = i >> 2, q = (i & 3) * 4;
      const int64_t doc = doc0 + d;
      const float4 x =
          q < nf && doc < n_docs
              ? __ldg(reinterpret_cast<const float4*>(
                    X + doc * n_features + f0 + q))
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int h = 0; h < kBinPerThread; ++h) {
      const int i = threadIdx.x + h * kBinThreads;
      const int d = i / kBinFeats, fl = i - d * kBinFeats;
      const int64_t doc = doc0 + d;
      v[h] = fl < nf && doc < n_docs ? __ldg(X + doc * n_features + f0 + fl)
                                     : 0.0f;
    }
  }
}

__device__ __forceinline__ void write_tile(float* sx, bool vec_x,
                                           const float (&v)[kBinPerThread]) {
  if (vec_x) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = threadIdx.x + h * kBinThreads;
      const int d = i >> 2, q = (i & 3) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) sx[(q + j) * kBinPitch + d] = v[4 * h + j];
    }
  } else {
#pragma unroll
    for (int h = 0; h < kBinPerThread; ++h) {
      const int i = threadIdx.x + h * kBinThreads;
      const int d = i / kBinFeats, fl = i - d * kBinFeats;
      sx[fl * kBinPitch + d] = v[h];
    }
  }
}

template <typename IdT, bool kStagedGrid>
__global__ void __launch_bounds__(kBinThreads)
    bins_only_kernel(const float* __restrict__ X, int64_t n_docs,
                     int n_features, const float* __restrict__ grid,
                     int grid_stride, int n_grid, int steps, bool vec_x,
                     bool vec_ids, IdT* __restrict__ ids) {
  extern __shared__ __align__(16) float bsm[];
  float* sx = bsm;                                    // [kBinFeats][pitch]
  float* eyt = bsm + kBinFeats * kBinPitch;           // [kBinFeats][row_len]
  const int row_len = (1 << steps) - 1;
  const int f0 = blockIdx.y * kBinFeats;
  const int nf = min(kBinFeats, n_features - f0);
  if constexpr (kStagedGrid) {
    for (int i = threadIdx.x; i < kBinFeats * row_len; i += kBinThreads) {
      const int fl = i / row_len, k = i - fl * row_len + 1;
      const int level = 31 - __clz(k);
      // node k's in-order index in the complete tree of 2^steps - 1 nodes
      const int j = ((2 * (k - (1 << level)) + 1) << (steps - 1 - level)) - 1;
      eyt[i] = fl < nf && j < n_grid
                   ? grid[static_cast<int64_t>(f0 + fl) * grid_stride + j]
                   : INFINITY;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_tiles = (n_docs + kBinDocs - 1) / kBinDocs;
  float vals[kBinPerThread];
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t doc0 = t * kBinDocs;
    read_tile(X, n_docs, n_features, f0, nf, doc0, vec_x, vals);
    __syncthreads();                   // the grid is staged, the tile read
    write_tile(sx, vec_x, vals);
    __syncthreads();
    const int64_t doc = doc0 + 4 * lane;
    for (int fl = warp; fl < nf; fl += kBinThreads / 32) {
      const float4 x =
          *reinterpret_cast<const float4*>(sx + fl * kBinPitch + 4 * lane);
      int4 b;
      if constexpr (kStagedGrid) {
        b = bins4_eytzinger(eyt + fl * row_len, steps, x, n_grid);
      } else {
        b = bins4_global(grid + static_cast<int64_t>(f0 + fl) * grid_stride,
                         n_grid, steps, x);
      }
      IdT* out = ids + static_cast<int64_t>(f0 + fl) * n_docs + doc;
      if (vec_ids && doc + 3 < n_docs) {
        store4(out, b);
      } else {
        const int v[4] = {b.x, b.y, b.z, b.w};
        for (int j = 0; j < 4 && doc + j < n_docs; ++j) {
          out[j] = static_cast<IdT>(v[j]);
        }
      }
    }
  }
}

// ---- the predicate epilogue ----

constexpr int kPredThreads = 128;          // threads a block at most
constexpr int kPredWords = 4;              // 4-document words a span

// A thread's kPredWords test words of one row, read as one vector.
struct alignas(4 * kPredWords) PredWords {
  unsigned w[kPredWords];
};
constexpr int kPackedMax = 127;            // longest path of the byte test

// A tree's node tests for 4 documents as one word, a byte (0/1) each:
// uint8 as it is, bf16 as 1 where the value is nonzero. Two bf16 words
// (4 tests) -> one word.
__device__ __forceinline__ unsigned bf16_nonzero(unsigned w) {
  return (((w & 0x7FFF7FFFu) + 0x7FFF7FFFu) >> 15) & 0x00010001u;
}
__device__ __forceinline__ unsigned bf16_word(unsigned lo, unsigned hi) {
  return __byte_perm(bf16_nonzero(lo), bf16_nonzero(hi), 0x6420);
}

// The word of documents d .. d + 3 of one row of predT read from global
// memory (the unstaged launch); documents past n_docs read 0.
__device__ __forceinline__ unsigned global_word(const uint8_t* row, int64_t d,
                                                int64_t n_docs, bool al) {
  if (al && d + 3 < n_docs)
    return __ldg(reinterpret_cast<const unsigned*>(row + d));
  unsigned w = 0;
  for (int e = 0; e < 4; ++e)
    if (d + e < n_docs)
      w |= static_cast<unsigned>(__ldg(row + d + e)) << (8 * e);
  return w;
}
__device__ __forceinline__ unsigned global_word(const uint16_t* row, int64_t d,
                                                int64_t n_docs, bool al) {
  if (al && d + 3 < n_docs) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + d));
    return bf16_word(v.x, v.y);
  }
  unsigned h[2] = {0, 0};
  for (int e = 0; e < 4; ++e)
    if (d + e < n_docs)
      h[e >> 1] |= static_cast<unsigned>(__ldg(row + d + e)) << (16 * (e & 1));
  return bf16_word(h[0], h[1]);
}

// One tree's operands of the predicate epilogue: its M rows of predT for
// the block's documents (rows [M][db], one byte or bf16 a test), its path
// record (L + 1 leaf offsets, L counts of P rows, then each leaf's P rows
// and Q rows, m the tree's node row) and its leaves' plen, csQ and
// w * output.
template <typename PredT>
struct PredTree {
  const PredT* rows;
  const int* path;
  const float* plen;
  const float* csq;
  const float* outw;
};

// Bytes of a stage's operands besides its rows: the path record (r_len
// ints, a multiple of 4) and plen / csQ / w * output (3 x L floats, padded
// to 16 bytes).
__host__ __device__ __forceinline__ size_t pred_meta_bytes(int r_len,
                                                           int n_leaves) {
  return 4 * static_cast<size_t>(r_len) +
         (12 * static_cast<size_t>(n_leaves) + 15) / 16 * 16;
}

// Copies tree t's operands into the stage at `dst` (every thread of the
// block takes part) and commits them as one cp.async group: rows in
// 16-byte pieces when they are 16-byte aligned (`vec`; else element by
// element, documents past n_docs zeros), the path record in 16-byte
// pieces, the leaves' floats 4 bytes at a time.
template <typename PredT>
__device__ __forceinline__ void stage_pred_tree(
    const PredT* __restrict__ predT, int64_t n_docs, int64_t row0,
    int m_rows, int64_t d0, int db, const int* path, int r_len,
    const float* plen, const float* csq, const float* outw, int n_leaves,
    unsigned char* dst, bool vec) {
  constexpr int kPer = 16 / sizeof(PredT);
  const int pieces = db / kPer;
  PredT* rows = reinterpret_cast<PredT*>(dst);
  for (int i = threadIdx.x; i < m_rows * pieces; i += blockDim.x) {
    const int m = i / pieces, p = i - m * pieces;
    const int64_t d = d0 + static_cast<int64_t>(p) * kPer;
    const PredT* src = predT + (row0 + m) * n_docs + d;
    PredT* out = rows + m * db + p * kPer;
    if (vec) {
      const int64_t left = n_docs - d;
      const int bytes = left >= kPer ? 16
                        : left > 0   ? static_cast<int>(left * sizeof(PredT))
                                     : 0;
      cp_async16(out, bytes ? src : predT, bytes);
    } else {
      for (int e = 0; e < kPer; ++e)
        out[e] = d + e < n_docs ? src[e] : PredT(0);
    }
  }
  unsigned char* meta = dst + static_cast<size_t>(m_rows) * db *
                                  sizeof(PredT);
  for (int i = threadIdx.x; i < r_len / 4; i += blockDim.x)
    cp_async16(meta + 16 * i, path + 4 * i);
  float* leaves = reinterpret_cast<float*>(meta + 4 * r_len);
  for (int i = threadIdx.x; i < 3 * n_leaves; i += blockDim.x) {
    const int k = i / n_leaves, l = i - k * n_leaves;
    cp_async4(leaves + i, (k == 0 ? plen : k == 1 ? csq : outw) + l);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The predicate epilogue's spans of 16 documents a thread (each span's
// words one 16-byte shared load a row) and stages in flight (tree t + 1
// lands while tree t is scored). bf16 rows take twice the bytes: one span.
template <typename PredT>
__host__ __device__ constexpr int pred_spans() {
  return sizeof(PredT) == 2 ? 1 : 2;
}
constexpr int kPredStages = 2;

// Predicate epilogue: a block scores db = 16 x spans x blockDim documents
// over the chunks of its group (blockIdx.y), a thread kSpans spans of 16
// documents. Trees in order, each adding to one f32 partial a chunk the
// outputs of the leaves whose path agreements hits = sum over the leaf's
// path list of +-test equal plen - csQ, in leaf order; each chunk's
// partial goes to part [n_chunks, n_docs], which pred_sum_kernel adds in
// chunk order.
//
// The hits of a word's 4 documents are counted at once in one 32-bit
// integer: acc = sum_k 256^k h_k exactly (mod 2^32), the list's P rows
// added and its Q rows subtracted as words. With t = plen - csQ an integer
// in [-nQ, nP] (else no document can match) and the path at most
// kPackedMax long, every
// h_k - t lies in [-127, 127], so acc + 0x80808080 - t * 0x01010101 has
// the digits h_k - t + 128 with no carry, and document k matches iff its
// byte is 0x80. Longer paths count each document's hits on their own.
//
// bf16 rows land as they are (2 bytes a test); each thread then turns its
// own 32 bytes of a span's row into its 16 test bytes, written in place
// within them (at byte 16 of the 32 for threads 4-7 of each 8, so a quarter
// warp's 16-byte reads still hit 32 banks): no other thread reads them,
// so no barrier.
//
// kStaged: every tree's operands are staged (kPredStages deep); else they
// are read from global memory as they are used.
template <typename PredT, bool kStaged>
__global__ void pred_epilogue_kernel(
    const PredT* __restrict__ predT, int64_t n_docs, int n_chunks, int tcm,
    int tcl, int tree_chunk, int m_per_tree, const int* __restrict__ paths,
    int r_len, const float* __restrict__ csq, const float* __restrict__ plen,
    const float* __restrict__ outw, float* __restrict__ part, bool vec) {
  extern __shared__ __align__(16) unsigned char pred_smem[];
  constexpr bool kBf16 = sizeof(PredT) == 2;
  constexpr int kW = kPredWords, kSpan = 4 * kW;   // documents a span
  constexpr int kSpans = pred_spans<PredT>();
  constexpr int kDocs = kSpan * kSpans;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int db = kDocs * nt, units = kSpans * nt;      // spans a row
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * db;
  const int n_leaves = tcl / tree_chunk;
  const int t_lo = n_chunks * blockIdx.y / gridDim.y * tree_chunk;
  const int t_hi = n_chunks * (blockIdx.y + 1) / gridDim.y * tree_chunk;
  const size_t rows_bytes = static_cast<size_t>(m_per_tree) * db *
                            sizeof(PredT);
  const size_t stage_bytes = rows_bytes + pred_meta_bytes(r_len, n_leaves);
  constexpr int kStages = kPredStages;
  // span h of this thread: documents d0 + kSpan * (h * nt + tid) ..; its
  // test bytes in a staged row at PredWords index slot(h) (+ m * units,
  // bf16: + 2 m units)
  auto unit = [&](int h) { return h * nt + tid; };
  auto slot = [&](int h) {
    return kBf16 ? 2 * unit(h) + ((tid >> 2) & 1) : unit(h);
  };
  // tree t's operands in global memory
  auto tree = [&](int t) {
    const int c = t / tree_chunk, j = t - c * tree_chunk;
    const int col = c * tcl + j * n_leaves;
    return PredTree<PredT>{
        predT + (static_cast<int64_t>(c) * tcm + j * m_per_tree) * n_docs,
        paths + static_cast<int64_t>(t) * r_len, plen + col, csq + col,
        outw + col};
  };
  auto stage = [&](int t) {
    if (t < t_hi) {
      const int c = t / tree_chunk, j = t - c * tree_chunk;
      const PredTree<PredT> g = tree(t);
      stage_pred_tree(predT, n_docs,
                      static_cast<int64_t>(c) * tcm + j * m_per_tree,
                      m_per_tree, d0, db, g.path, r_len, g.plen, g.csq,
                      g.outw, n_leaves,
                      pred_smem + ((t - t_lo) % kStages) * stage_bytes, vec);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  };
  float partial[kDocs];
#pragma unroll
  for (int i = 0; i < kDocs; ++i) partial[i] = 0.0f;
  if constexpr (kStaged) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) stage(t_lo + s);
  }
  for (int t = t_lo; t < t_hi; ++t) {
    const int j = t % tree_chunk;
    PredTree<PredT> g = tree(t);
    const PredWords* words = nullptr;
    if constexpr (kStaged) {
      stage(t + kStages - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
      __syncthreads();
      unsigned char* st = pred_smem + ((t - t_lo) % kStages) * stage_bytes;
      const int* path = reinterpret_cast<const int*>(st + rows_bytes);
      const float* leaves = reinterpret_cast<const float*>(path + r_len);
      g.path = path;
      g.plen = leaves;
      g.csq = leaves + n_leaves;
      g.outw = leaves + 2 * n_leaves;
      words = reinterpret_cast<const PredWords*>(st);
      if constexpr (kBf16) {       // own bf16 bytes -> one byte a test
        PredWords* w = reinterpret_cast<PredWords*>(st);
        for (int m = 0; m < m_per_tree; ++m) {
#pragma unroll
          for (int h = 0; h < kSpans; ++h) {
            const PredWords a = w[2 * (m * units + unit(h))];
            const PredWords b = w[2 * (m * units + unit(h)) + 1];
            unsigned raw[2 * kW];
#pragma unroll
            for (int q = 0; q < kW; ++q) {
              raw[q] = a.w[q];
              raw[kW + q] = b.w[q];
            }
            PredWords c;
#pragma unroll
            for (int q = 0; q < kW; ++q)
              c.w[q] = bf16_word(raw[2 * q], raw[2 * q + 1]);
            w[2 * m * units + slot(h)] = c;
          }
        }
      }
    }
    // span h's test words of node row m of this tree
    auto row_words = [&](int m, int h) -> PredWords {
      if constexpr (kStaged) {
        return words[(kBf16 ? 2 : 1) * m * units + slot(h)];
      } else {
        const PredT* r = g.rows + m * n_docs;
        const int64_t d = d0 + kSpan * static_cast<int64_t>(unit(h));
        PredWords w;
#pragma unroll
        for (int q = 0; q < kW; ++q)
          w.w[q] = global_word(r, d + 4 * q, n_docs, vec);
        return w;
      }
    };
    const int* npos = g.path + n_leaves + 1;
    const int* ents = npos + n_leaves;
    float leaf[kDocs];
#pragma unroll
    for (int i = 0; i < kDocs; ++i) leaf[i] = 0.0f;
    for (int l = 0; l < n_leaves; ++l) {
      // P rows [p0, pq), Q rows [pq, p1)
      const int p0 = g.path[l], p1 = g.path[l + 1], pq = p0 + npos[l];
      const float adj = g.plen[l] - g.csq[l];
      const float o = g.outw[l];
      if (p1 - p0 <= kPackedMax) {
        unsigned acc[kSpans * kW] = {};
        for (int e = p0; e < pq; ++e) {
#pragma unroll
          for (int h = 0; h < kSpans; ++h) {
            const PredWords w = row_words(ents[e], h);
#pragma unroll
            for (int q = 0; q < kW; ++q) acc[h * kW + q] += w.w[q];
          }
        }
        for (int e = pq; e < p1; ++e) {
#pragma unroll
          for (int h = 0; h < kSpans; ++h) {
            const PredWords w = row_words(ents[e], h);
#pragma unroll
            for (int q = 0; q < kW; ++q) acc[h * kW + q] -= w.w[q];
          }
        }
        if (adj == truncf(adj) && adj >= pq - p1 && adj <= pq - p0) {
          const unsigned cst =
              0x80808080u - static_cast<unsigned>(static_cast<int>(adj)) *
                                0x01010101u;
#pragma unroll
          for (int q = 0; q < kSpans * kW; ++q) {
            const unsigned v = (acc[q] + cst) ^ 0x80808080u;
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (((v >> (8 * k)) & 0xFFu) == 0) leaf[4 * q + k] += o;
          }
        }
      } else {
        int hits[kDocs] = {};
        for (int e = p0; e < p1; ++e) {
          const int s = e < pq ? 1 : -1;
#pragma unroll
          for (int h = 0; h < kSpans; ++h) {
            const PredWords w = row_words(ents[e], h);
#pragma unroll
            for (int q = 0; q < kW; ++q) {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                hits[h * kSpan + 4 * q + k] +=
                    s * static_cast<int>((w.w[q] >> (8 * k)) & 0xFFu);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kDocs; ++i)
          if (static_cast<float>(hits[i]) == adj) leaf[i] += o;
      }
    }
#pragma unroll
    for (int i = 0; i < kDocs; ++i) partial[i] += leaf[i];
    if (j == tree_chunk - 1) {
      float* dst = part + static_cast<int64_t>(t / tree_chunk) * n_docs;
#pragma unroll
      for (int i = 0; i < kDocs; ++i) {
        const int64_t d = d0 + kSpan * static_cast<int64_t>(unit(i / kSpan)) +
                          i % kSpan;
        if (d < n_docs) dst[d] = partial[i];
        partial[i] = 0.0f;
      }
    }
    if constexpr (kStaged) __syncthreads();
  }
}

// score[d] = the chunks' partials added in chunk order.
__global__ void pred_sum_kernel(const float* __restrict__ part, int n_chunks,
                                int64_t n_docs, float* __restrict__ out) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (d >= n_docs) return;
  float score = 0.0f;
  for (int c = 0; c < n_chunks; ++c) score += part[c * n_docs + d];
  out[d] = score;
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

// The binning pass's launch: kBinFeats features a block (blockIdx.y), and
// as many document blocks as keep every SM full at once, each walking
// tiles of kBinDocs documents; grids of more than 2^kBinMaxSteps - 1
// thresholds are searched in global memory.
template <typename IdT>
int launch_bins_only(const void* X, int64_t n_docs, int n_features,
                     const void* grid, int grid_stride, int n_grid, void* ids,
                     void* stream) {
  int steps = 0;
  while ((1 << steps) <= n_grid) ++steps;      // ceil(log2(n_grid + 1))
  const bool staged = steps <= kBinMaxSteps;
  auto kernel = staged ? bins_only_kernel<IdT, true>
                       : bins_only_kernel<IdT, false>;
  const size_t smem =
      sizeof(float) * kBinFeats *
      (kBinPitch + (staged ? (1 << steps) - 1 : 0));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kBinThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned fblocks =
      static_cast<unsigned>((n_features + kBinFeats - 1) / kBinFeats);
  const int64_t tiles = (n_docs + kBinDocs - 1) / kBinDocs;
  const unsigned dblocks = static_cast<unsigned>(std::max<int64_t>(
      1, std::min<int64_t>(tiles, static_cast<int64_t>(sms) *
                                      std::max(per_sm, 1) / fblocks)));
  // 16-byte reads of X need 16-byte rows; packed id words need rows of a
  // multiple of 4 documents
  const bool vec_x = n_features % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const bool vec_ids = n_docs % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(ids) % (4 * sizeof(IdT))
                           == 0;
  kernel<<<dim3(dblocks, fblocks), kBinThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), n_docs, n_features,
      static_cast<const float*>(grid), grid_stride, n_grid, steps, vec_x,
      vec_ids, static_cast<IdT*>(ids));
  return static_cast<int>(cudaGetLastError());
}

// The predicate epilogue's launch: of 128, 64 and 32 threads a block, the
// count that keeps the most threads resident with kPredStages stages of a
// tree's operands (the smaller count on a tie: more, smaller blocks); when
// none fits, the unstaged kernel at 128 threads reads them from global
// memory. The chunks split into as many groups (blockIdx.y) as the SMs'
// resident blocks hold in one wave. `vec`: rows 16-byte aligned (staged)
// or 4-document words aligned (unstaged).
template <typename PredT>
int launch_pred(const void* predT, int64_t n_docs, int n_chunks, int tcm,
                int tcl, int tree_chunk, int m_per_tree, const void* paths,
                int r_len, const void* csq, const void* plen,
                const void* outw, void* part, void* out, void* stream) {
  constexpr size_t kBytes = sizeof(PredT);
  const size_t meta = pred_meta_bytes(r_len, tcl / tree_chunk);
  int nt = 0, resident = 0, per_sm = 1;
  size_t smem = 0;
  for (int t = kPredThreads; t >= 32; t >>= 1) {
    const size_t rows = static_cast<size_t>(m_per_tree) * 4 * kPredWords *
                        pred_spans<PredT>() * t;
    const size_t bytes = kPredStages * (rows * kBytes + meta);
    if (bytes > kMaxSmem) continue;
    const int blocks = std::min({2048 / t, 32,
                                 static_cast<int>(kSmSmem / (bytes + 1024))});
    if (blocks * t >= resident) {
      resident = blocks * t;
      nt = t;
      smem = bytes;
      per_sm = blocks;
    }
  }
  const uintptr_t p = reinterpret_cast<uintptr_t>(predT);
  const bool staged = nt != 0;
  bool vec = (n_docs * kBytes) % 16 == 0 && p % 16 == 0;
  if (!staged) {
    nt = kPredThreads;
    vec = n_docs % 4 == 0 && p % (4 * kBytes) == 0;
  }
  auto kernel = staged ? pred_epilogue_kernel<PredT, true>
                       : pred_epilogue_kernel<PredT, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int64_t db = 4 * kPredWords * pred_spans<PredT>() * nt;
  const int64_t doc_blocks = (n_docs + db - 1) / db;
  const int64_t want = static_cast<int64_t>(sms) * per_sm / doc_blocks;
  const unsigned groups = static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(want, n_chunks)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(static_cast<unsigned>(doc_blocks), groups), nt, smem, s>>>(
      static_cast<const PredT*>(predT), n_docs, n_chunks, tcm, tcl,
      tree_chunk, m_per_tree, static_cast<const int*>(paths), r_len,
      static_cast<const float*>(csq), static_cast<const float*>(plen),
      static_cast<const float*>(outw), static_cast<float*>(part), vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pred_sum_kernel<<<static_cast<unsigned>((n_docs + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), n_chunks, n_docs,
      static_cast<float*>(out));
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
// bits); paths [n_chunks * tree_chunk, r_len] int32, the path records of
// P - Q [n_chunks, tcm, tcl] (one [m_per_tree, tcl / tree_chunk] block a
// tree; gbdt/ensemble.py _pred_paths); csq / plen / outw [n_chunks, tcl]
// f32; part [n_chunks, n_docs] f32 scratch for the chunks' partials.
extern "C" int forest_eval_pred_u8(const void* predT, int64_t n_docs,
                                   int n_chunks, int tcm, int tcl,
                                   int tree_chunk, int m_per_tree,
                                   const void* paths, int r_len,
                                   const void* csq, const void* plen,
                                   const void* outw, void* part, void* out,
                                   void* stream) {
  return launch_pred<uint8_t>(predT, n_docs, n_chunks, tcm, tcl, tree_chunk,
                              m_per_tree, paths, r_len, csq, plen, outw, part,
                              out, stream);
}

extern "C" int forest_eval_pred_bf16(const void* predT, int64_t n_docs,
                                     int n_chunks, int tcm, int tcl,
                                     int tree_chunk, int m_per_tree,
                                     const void* paths, int r_len,
                                     const void* csq, const void* plen,
                                     const void* outw, void* part, void* out,
                                     void* stream) {
  return launch_pred<uint16_t>(predT, n_docs, n_chunks, tcm, tcl, tree_chunk,
                               m_per_tree, paths, r_len, csq, plen, outw,
                               part, out, stream);
}
