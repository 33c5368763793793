// Lane-owned histogram columns: the device code of both histogram kernels
// (csrc/histogram.cu, one weight vector; csrc/histogram_multi.cu, C bags).
//
// Function: out[c, f, b] = (sum of w[c, d] * g[c, d], sum of w[c, d]) over
// documents d with bins[f, d] == b, for C weight/gradient rows over one
// [F, N] id matrix (uint8, int16 or int32). Ids >= B and ids < 0 add
// nothing. The single-vector kernel is the C = 1 case. The multi-bag
// kernel may take each bag's feature list (Random Forests' sampled
// features, ascending, -1 past the bag's count): it then builds only the
// listed columns, and the others read zero.
//
// Design (NVIDIA H100, sm_90a): a block is one warp, and it owns 32
// (bag, feature) columns over a range of at most 256 bins of one document
// slice: bag c and 32 consecutive entries of its feature list, lane l
// taking the feature of entry p0 + l (without a list, entry p is feature
// p). A padded entry leaves its lane idle, and a warp past its bag's last
// entry only writes zeros.
// * Its histogram lives in shared memory as float2 (sum g*w, sum w) laid
//   out [bin][lane], so the 32 lanes hit 32 distinct bank pairs whatever
//   their bins: no bank conflicts, no __match_any_sync, and each cell has
//   exactly one writer.
// * The warp walks its slice a step of 128 id bytes at a time (128 / id
//   bytes documents). Lane j reads w and g of documents j, j + 32, ...
//   (coalesced); ballots of w != 0 are the step's masks, and a step its
//   bag does not weight is skipped before its ids are read, so a child
//   build costs in proportion to the steps and documents it weights.
//   Weights are read two steps ahead and ids one step ahead, into
//   registers (16-byte loads of the lane's own feature row, one 128-byte
//   line a step).
// * For each weighted document j of the step, in order, every lane takes
//   (g*w, w) by shuffle from lane j and its own id from its private row of
//   the step's ids in shared memory (an odd number of words a row, so the
//   32 lanes' reads at one document never share a bank), and adds to its
//   cell with a plain read-modify-write, four documents at a time: the
//   four cells are loaded together, a document whose bin equals an earlier
//   one of the four takes that one's running sum (the sequential result,
//   bit for bit), and the cells are stored in order.
// * The histograms leave through a [32][33] tile, so each feature's row of
//   bins is written as contiguous 256-byte runs. An unlisted feature's row
//   is zeroed by the lane of the list entry after it (the last entry's
//   lane also takes those after it), in slice 0: every out cell is
//   written, so a parent's histogram less its child's stays finite.
// * Determinism: one writer a cell and document order within a slice;
//   with several slices each block writes its slice's partial histograms
//   (one row a list entry) and a second kernel adds them in slice order
//   into their features' rows. No float atomics: two launches give the
//   same bits, and with one slice the sums are taken in the order of the
//   plain version's sequential index_add_; a list changes no listed cell
//   under the same slices.
//
// What bounds it: a warp's histograms take 64 KB at 256 bins, so an SM
// holds three warps, and each weighted document is a dependent chain per
// warp (mask bit, shuffles and id load, cell load, adds, store; about 25
// instructions) that three warps hide poorly: latency, not device memory
// or shared-memory bandwidth (PERF.md has the measurements). A launch
// thus costs about (waves of 132 x 3 warps) x one warp's walk of its
// slice. Without a list every bag takes ceil(F / 32) warps, most of them
// building columns that the split scan then masks off: RF's 106-bag groups
// of 136 features take 530 warps, 2 waves, and 66 bags of 700 take 1,452,
// 4 waves. With lists of 40 and 210 sampled features they take 212 and
// 462 warps, and the planner slices them into 7 and 6 slices: 4 waves of
// a seventh of a walk, 7 waves of a sixth. The chain still bounds each
// walk; the waves are now the columns the scan reads. Device-memory
// traffic is small beside it: the ids of weighted steps once per bag
// (mostly from L2), g and w once per 32-column group, the output once,
// and slice partials of the listed columns when there are several slices.
//
// Tensor cores do not pay here. As a one-hot product the multi-bag root is
// [256, N] x [N, 2C] per feature, 2 * 256 * 180,224 * 600 * 136 = 7.5 TFLOP
// at the RF group's width; the g*w channel would need 2-3 bf16 planes to
// stay within the histogram tolerance, 15-23 TFLOP, over 15 ms at the
// 989 TFLOP/s dense bf16 peak before any child's sparsity, while this
// design's cost falls with the weighted pairs.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Internal linkage throughout: each kernel library carries its own copy,
// and no symbol (such as allow_shared_memory's per-device flags) is shared
// between two libraries loaded into one process.
namespace hist {
namespace {

constexpr int kLanes = 32;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTposeBytes = kLanes * (kLanes + 1) * 8;  // write-out tile

// What a launch covers; the planner (ops/histogram.py plan) fills it.
struct Geometry {
  int64_t N;
  int F, B, C;
  int Fs;              // columns a bag: its feature list's width, else F
  int warp_bins;       // bins a warp covers (<= 256)
  int ranges;          // bin ranges: ceil(B / warp_bins)
  int64_t slice_len;   // documents a slice (a multiple of 128)
  int slices;
  int vec;             // id rows 16-byte aligned: read 16 bytes a load
};

// Id bytes a lane reads a step (one 128-byte line of its feature row), the
// documents that makes, and the words of a lane's private id row: the
// step's ids and one spare word, an odd count so lane l's row starts in
// bank (l * 33) % 32 = l.
constexpr int kStepBytes = 128;
constexpr int kRowWords = kStepBytes / 4 + 1;

template <typename T>
__host__ __device__ constexpr int step_docs() {
  return kStepBytes / static_cast<int>(sizeof(T));
}

// Dynamic shared memory of a block: the histograms, then the lanes' id
// rows, which the write-out tile (larger) reuses after the last step.
__host__ __device__ size_t smem_bytes(const Geometry& g) {
  return static_cast<size_t>(g.warp_bins) * kLanes * sizeof(float2) +
         kTposeBytes;
}

template <typename T>
__global__ void __launch_bounds__(kLanes)
    columns_kernel(const T* __restrict__ bins,
                   const float* __restrict__ grads,
                   const float* __restrict__ w,
                   const int* __restrict__ feats, const Geometry g,
                   float* __restrict__ dst, float* out) {
  constexpr int S = step_docs<T>();          // documents a step
  constexpr int Q = S / kLanes;              // 32-document chunks a step
  constexpr int V = kStepBytes / 16;         // uint4s of ids a lane a step
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int range = blockIdx.y % g.ranges;
  const int p_warp = (blockIdx.y / g.ranges) * kLanes;
  const int c = blockIdx.z;
  const int lo_bin = range * g.warp_bins;
  const int n_bins = min(g.warp_bins, g.B - lo_bin);
  // entry p of bag c's feature list (p itself without a list); -1 past
  // the list's width and for its pads
  const int* list =
      feats ? feats + static_cast<int64_t>(c) * g.Fs : nullptr;
  auto listed = [&](int p) {
    return p < 0 || p >= g.Fs ? -1 : list ? list[p] : p;
  };
  const int pos = p_warp + lane;             // the lane's entry
  const int feat = listed(pos);
  const bool active = feat >= 0 && feat < g.F;

  // With a list, the bag's unlisted features read zero in this block's
  // bins (written once, by slice 0's blocks, straight into out): each
  // entry's lane takes the features between the entry before it and its
  // own, the last entry's lane those after it too, and an empty list's
  // first lane all of them.
  if (list && blockIdx.x == 0) {
    int gap[4] = {0, 0, 0, 0};               // [gap[0], gap[1]) u [2], [3])
    if (feat >= 0) {
      gap[0] = pos == 0 ? 0 : listed(pos - 1) + 1;
      gap[1] = feat;
      if (listed(pos + 1) < 0) {
        gap[2] = feat + 1;
        gap[3] = g.F;
      }
    } else if (pos == 0) {
      gap[1] = g.F;
    }
    float2* zero = reinterpret_cast<float2*>(out) +
                   static_cast<int64_t>(c) * g.F * g.B + lo_bin;
    for (int j = 0; j < kLanes; ++j) {
#pragma unroll
      for (int k = 0; k < 4; k += 2) {
        const int f0 = max(__shfl_sync(kFull, gap[k], j), 0);
        const int f1 = min(__shfl_sync(kFull, gap[k + 1], j), g.F);
        for (int f = f0; f < f1; ++f)
          for (int b = lane; b < n_bins; b += kLanes)
            zero[static_cast<int64_t>(f) * g.B + b] = make_float2(0.f, 0.f);
      }
    }
  }
  if (!__any_sync(kFull, active)) return;    // a bag's list ends earlier

  const int64_t lo = static_cast<int64_t>(blockIdx.x) * g.slice_len;
  const int64_t hi = min(g.N, lo + g.slice_len);
  const int steps = static_cast<int>((hi - lo + S - 1) / S);

  float2* h = reinterpret_cast<float2*>(smem) + lane;   // cell b: h[b * 32]
  uint32_t* row = reinterpret_cast<uint32_t*>(
                      smem + static_cast<size_t>(g.warp_bins) * kLanes *
                                 sizeof(float2)) +
                  lane * kRowWords;
  const T* ids = bins + static_cast<int64_t>(active ? feat : 0) * g.N;
  const float* gc = grads + static_cast<int64_t>(c) * g.N;
  const float* wc = w + static_cast<int64_t>(c) * g.N;
  for (int b = 0; b < n_bins; ++b) h[b * kLanes] = make_float2(0.0f, 0.0f);

  auto step_start = [&](int t) { return lo + static_cast<int64_t>(t) * S; };
  // a whole step of 16-byte aligned ids goes through registers
  auto whole = [&](int t) { return g.vec && step_start(t) + S <= hi; };
  // lane l holds documents l, l + 32, ... of the step
  auto load_w = [&](int t, float (&wv)[Q], float (&gv)[Q]) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int64_t d = step_start(t) + q * kLanes + lane;
      wv[q] = gv[q] = 0.0f;
      if (t < steps && d < hi) {
        wv[q] = wc[d];
        gv[q] = gc[d];
      }
    }
  };
  auto load_ids = [&](int t, uint4 (&r)[V]) {
    const uint4* p = reinterpret_cast<const uint4*>(ids + step_start(t));
#pragma unroll
    for (int v = 0; v < V; ++v)
      r[v] = active ? __ldg(p + v) : make_uint4(0u, 0u, 0u, 0u);
  };
  auto masks = [&](const float (&wv)[Q], unsigned (&m)[Q]) {
    unsigned any = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      m[q] = __ballot_sync(kFull, wv[q] != 0.0f);
      any |= m[q];
    }
    return any;
  };

  // weights two steps ahead of their sums, ids one step ahead
  float w0[Q], g0[Q], w1[Q], g1[Q];
  unsigned m0[Q], m1[Q];
  uint4 ids0[V], ids1[V];
  load_w(0, w0, g0);
  load_w(1, w1, g1);
  unsigned any0 = masks(w0, m0);
  if (any0 && whole(0)) load_ids(0, ids0);
  for (int t = 0; t < steps; ++t) {
    float w2[Q], g2[Q];
    load_w(t + 2, w2, g2);
    const unsigned any1 = masks(w1, m1);
    if (any1 && whole(t + 1)) load_ids(t + 1, ids1);
    if (any0) {
      if (whole(t)) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          row[4 * v] = ids0[v].x;
          row[4 * v + 1] = ids0[v].y;
          row[4 * v + 2] = ids0[v].z;
          row[4 * v + 3] = ids0[v].w;
        }
      } else if (active) {                   // unaligned rows, ragged end
        const int n = static_cast<int>(min(static_cast<int64_t>(S),
                                           hi - step_start(t)));
        for (int e = 0; e < n; ++e)
          reinterpret_cast<T*>(row)[e] = ids[step_start(t) + e];
      }
      const T* my = reinterpret_cast<const T*>(row);
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float wq = w0[q];
        const float gw = g0[q] * wq;         // lane j: document 32q + j
        unsigned m = m0[q];
        while (m) {                          // four documents, in order
          int b[kUnroll];
          float cg[kUnroll], cw[kUnroll];
          float2 v[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = m ? __ffs(m) - 1 : 0;
            cg[u] = __shfl_sync(kFull, gw, j);
            cw[u] = __shfl_sync(kFull, wq, j);
            const int rel = static_cast<int>(my[q * kLanes + j]) - lo_bin;
            b[u] = m && active && static_cast<unsigned>(rel) <
                                      static_cast<unsigned>(n_bins)
                       ? rel : -1;
            m &= m - 1;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) v[u] = h[max(b[u], 0) * kLanes];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {  // document order, bit-exact
#pragma unroll
            for (int j = 0; j < u; ++j)
              if (b[j] == b[u]) v[u] = v[j];
            v[u].x += cg[u];
            v[u].y += cw[u];
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            if (b[u] >= 0) h[b[u] * kLanes] = v[u];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      w0[q] = w1[q];
      g0[q] = g1[q];
      m0[q] = m1[q];
      w1[q] = w2[q];
      g1[q] = g2[q];
    }
    any0 = any1;
#pragma unroll
    for (int v = 0; v < V; ++v) ids0[v] = ids1[v];
  }

  // write-out through a [32][33] tile (over the id rows, free now): lane
  // l's column goes in as row l, and each feature's row of 32 bins leaves
  // as 256 contiguous bytes, to out[c, feature] with one slice, else to
  // partial[slice, c, entry]
  __syncwarp();
  float2* tile = reinterpret_cast<float2*>(
      smem + static_cast<size_t>(g.warp_bins) * kLanes * sizeof(float2));
  for (int b0 = 0; b0 < n_bins; b0 += kLanes) {
    const int nb = min(kLanes, n_bins - b0);
    for (int j = 0; j < nb; ++j)
      tile[lane * (kLanes + 1) + j] = h[(b0 + j) * kLanes];
    __syncwarp();
    for (int r = 0; r < kLanes; ++r) {
      const int f = __shfl_sync(kFull, active ? feat : -1, r);
      if (f < 0) continue;
      const int64_t at =
          g.slices > 1 ? (static_cast<int64_t>(blockIdx.x) * g.C + c) *
                                 g.Fs + p_warp + r
                       : static_cast<int64_t>(c) * g.F + f;
      if (lane < nb)
        reinterpret_cast<float2*>(dst)[at * g.B + lo_bin + b0 + lane] =
            tile[r * (kLanes + 1) + lane];
    }
    __syncwarp();
  }
}

// out[c, f] = sum over slices s, in order, of partial[s, c, p], where f is
// entry p of bag c's feature list (p itself without a list; pads are
// skipped). A row of partial is one feature's B bins x 2.
__global__ void slice_sum_kernel(const float* __restrict__ partial,
                                 const int* __restrict__ feats,
                                 const Geometry g, float* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(g.B) * 2;
  const int64_t size = static_cast<int64_t>(g.C) * g.Fs * row;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= size) return;
  const int64_t cp = i / row;                // c * Fs + p
  const int f = feats ? feats[cp] : static_cast<int>(cp % g.Fs);
  if (f < 0 || f >= g.F) return;
  float acc = partial[i];
  for (int s = 1; s < g.slices; ++s)
    acc += partial[static_cast<int64_t>(s) * size + i];
  out[((cp / g.Fs) * g.F + f) * row + i % row] = acc;
}

// Allow the column kernel the card's whole shared-memory budget once per
// device and process, not on every launch.
template <typename T>
cudaError_t allow_shared_memory() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int max_optin = 0;
  err = cudaDeviceGetAttribute(&max_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(columns_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// bins [F, N]; grads, w [C, N] f32 contiguous; feats [C, Fs] int32 (each
// bag's features, ascending, -1 past its count) or null for every
// feature; partial [slices, C, Fs, B, 2] scratch when slices > 1; out
// [C, F, B, 2]. Returns the cudaError_t of the launches (0 on success).
template <typename T>
int launch(const T* bins, const float* grads, const float* w,
           const int* feats, const Geometry& g, float* partial, float* out,
           cudaStream_t stream) {
  cudaError_t err = allow_shared_memory<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g.warp_bins < 1 || g.warp_bins > 256 || g.Fs < 1 ||
      g.slice_len % step_docs<T>() != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(g.slices, (g.Fs + kLanes - 1) / kLanes * g.ranges, g.C);
  float* dst = g.slices > 1 ? partial : out;
  columns_kernel<T><<<grid, kLanes, smem_bytes(g), stream>>>(
      bins, grads, w, feats, g, dst, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || g.slices == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(g.C) * g.Fs * g.B * 2;
  const int threads = 256;
  slice_sum_kernel<<<static_cast<unsigned>((size + threads - 1) / threads),
                     threads, 0, stream>>>(partial, feats, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace hist
