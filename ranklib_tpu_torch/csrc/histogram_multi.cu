// Multi-bag two-channel feature histogram for Hopper (sm_90a): the CUDA
// counterpart of ranklib_tpu/ops/histogram.py _hist_kernel (wrappers
// _hist_pallas_rows and hist_multi_pallas), which Random-Forests growth
// (gbdt/grow.py grow_forest) runs for the root and every right child of a
// group of bags grown in lockstep.
//
// What it computes (the same as C calls of hist_xla): out[c, f, b] =
// (sum of w[c, d] * g[c, d], sum of w[c, d]) over docs d with
// bins[f, d] == b, for C bags that share one id matrix [F, N] and differ in
// their pseudo-responses g [C, N] and doc weights w [C, N] (integer
// multiplicities >= 0; counts are exact). Ids >= B (and < 0) add nothing;
// uint8/int16/int32 ids are upcast to int before any compare. Any B.
//
// How: the TPU kernel shares one one-hot build across 2C matmul rows. Here
// the bags share the bin grouping instead. A block takes a slice of the
// documents, a group of up to 8 features and a tile of `bags` bags; the
// tile's [bags, F_blk, B, 2] histograms live in shared memory (64 KB at
// B = 256: 8 features x 4 bags), and the tile's g*w and w are staged in
// shared memory `sub` documents at a time (read once per block, reused by
// every feature of the group). Each warp owns whole features. For each
// 32-document step it loads the 32 ids once and groups equal bins with
// __match_any_sync; then, per bag of the tile, every group leader sums its
// members' values in lane order (one shuffle pair per group member, each
// lane reading its own group's next member) and adds the sum to its bin.
// Distinct groups touch distinct bins and one warp owns a feature, so there
// are no races and no atomics.
//
// Zero weights: a staged sub-chunk whose tile weights are all zero is
// skipped by the whole block; a 32-document step with no weight in any bag
// of the tile loads no ids; a bag with no weight in a step skips its
// shuffles. Bags of an RF group weight different documents, so the skip is
// per (sub-chunk, bag tile) and per (step, bag), not per chunk of all bags.
//
// Determinism: inside a block each (bag, feature, bin) is written by one
// warp in document order; with several document slices each block writes
// its partial histograms to a [slices, C, F, B, 2] scratch and a second
// kernel adds them in slice order. Two launches give the same bits.
//
// What bounds it on the H100: per (32 documents, feature, bag) one ballot,
// one shared load of the weights and two shuffles per member of the
// largest bin group (usually 1-3 for quantile bins). The work grows as
// C x F x N / 32 warp steps; memory traffic (ids once per bag tile,
// weights once per feature group, mostly from L2) is small beside it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void hist_multi_partial_kernel(
    const T* __restrict__ bins, const float* __restrict__ grads,
    const float* __restrict__ w, int64_t N, int F, int B, int C, int feats,
    int bags, int64_t slice_len, int sub, float* __restrict__ dst) {
  extern __shared__ float smem[];
  float* s_gw = smem;                              // [bags, sub] g * w
  float* s_w = smem + static_cast<size_t>(bags) * sub;   // [bags, sub] w
  float* s_hist = smem + 2 * static_cast<size_t>(bags) * sub;
  // s_hist: [feats, bags, B, 2]
  const int f0 = blockIdx.y * feats;
  const int nf = min(feats, F - f0);
  const int c0 = blockIdx.z * bags;
  const int nb = min(bags, C - c0);
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * slice_len;
  const int64_t hi = min(N, lo + slice_len);
  const int hsize = nf * bags * B * 2;
  for (int i = threadIdx.x; i < hsize; i += kThreads) s_hist[i] = 0.0f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int64_t d0 = lo; d0 < hi; d0 += sub) {
    const int len = static_cast<int>(min(static_cast<int64_t>(sub), hi - d0));
    int any = 0;
    for (int i = threadIdx.x; i < nb * sub; i += kThreads) {
      const int c = i / sub;
      const int j = i - c * sub;
      float wv = 0.0f, gv = 0.0f;
      if (j < len) {
        const int64_t at = static_cast<int64_t>(c0 + c) * N + d0 + j;
        wv = w[at];
        if (wv != 0.0f) gv = grads[at] * wv;
      }
      s_w[i] = wv;
      s_gw[i] = gv;
      any |= (wv != 0.0f);
    }
    if (!__syncthreads_or(any)) continue;   // the tile weights nothing here

    for (int lf = warp; lf < nf; lf += kWarps) {
      const T* col = bins + static_cast<int64_t>(f0 + lf) * N + d0;
      float* h = s_hist + static_cast<size_t>(lf) * bags * B * 2;
      for (int base = 0; base < len; base += 32) {
        const int i = base + lane;
        bool weighted = false;
        if (i < len) {
          for (int c = 0; c < nb; ++c) weighted |= (s_w[c * sub + i] != 0.0f);
        }
        if (!__any_sync(kFull, weighted)) continue;
        const int b = i < len ? static_cast<int>(col[i]) : -1;
        const bool valid = b >= 0 && b < B;
        const unsigned grp = __match_any_sync(kFull, valid ? b : -1);
        const int gmax = __reduce_max_sync(kFull, valid ? __popc(grp) : 0);
        const bool leader = valid && lane == __ffs(grp) - 1;
        for (int c = 0; c < nb; ++c) {
          const float wv = valid ? s_w[c * sub + i] : 0.0f;
          if (!__any_sync(kFull, wv != 0.0f)) continue;
          const float gv = valid ? s_gw[c * sub + i] : 0.0f;
          float sg = 0.0f, sw = 0.0f;
          unsigned m = grp;
          for (int k = 0; k < gmax; ++k) {       // lane order within a group
            const int src = m ? __ffs(m) - 1 : lane;
            const float gj = __shfl_sync(kFull, gv, src);
            const float wj = __shfl_sync(kFull, wv, src);
            if (m) {
              sg += gj;
              sw += wj;
              m &= m - 1;
            }
          }
          if (leader && (sw != 0.0f || sg != 0.0f)) {
            float* cell = h + (static_cast<size_t>(c) * B + b) * 2;
            cell[0] += sg;
            cell[1] += sw;
          }
        }
      }
    }
    __syncthreads();                        // before the next staging
  }
  __syncthreads();
  const int row = B * 2;
  for (int i = threadIdx.x; i < nb * nf * row; i += kThreads) {
    const int c = i / (nf * row);
    const int rem = i - c * nf * row;
    const int lf = rem / row;
    const int k = rem - lf * row;
    const int64_t at = ((static_cast<int64_t>(blockIdx.x) * C + c0 + c) * F +
                        f0 + lf) * row + k;
    dst[at] = s_hist[(static_cast<size_t>(lf) * bags + c) * row + k];
  }
}

__global__ void hist_multi_reduce_kernel(const float* __restrict__ partial,
                                         int n_slices, int64_t size,
                                         float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= size) return;
  float acc = 0.0f;
  for (int s = 0; s < n_slices; ++s)        // fixed order: slice 0, 1, ...
    acc += partial[static_cast<int64_t>(s) * size + i];
  out[i] = acc;
}

template <typename T>
int launch(const T* bins, const float* grads, const float* w, int64_t N,
           int F, int B, int C, int feats, int bags, int64_t slice_len,
           int n_slices, int sub, float* partial, float* out,
           cudaStream_t stream) {
  const size_t smem = (2 * static_cast<size_t>(bags) * sub +
                       static_cast<size_t>(feats) * bags * B * 2) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_multi_partial_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_slices, (F + feats - 1) / feats, (C + bags - 1) / bags);
  float* dst = n_slices > 1 ? partial : out;
  hist_multi_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      bins, grads, w, N, F, B, C, feats, bags, slice_len, sub, dst);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(C) * F * B * 2;
  const int threads = 256;
  hist_multi_reduce_kernel<<<static_cast<unsigned>((size + threads - 1) /
                                                   threads),
                             threads, 0, stream>>>(partial, n_slices, size,
                                                   out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bins [F, N] contiguous; grads, w [C, N] f32 contiguous; partial
// [n_slices, C, F, B, 2] scratch (unused when n_slices == 1); out
// [C, F, B, 2] f32. Documents [s * slice_len, (s + 1) * slice_len) form
// slice s. Returns the cudaError_t of the launches (0 on success).
#define HIST_MULTI_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* bins, const float* grads, const float* w,    \
                      int64_t N, int F, int B, int C, int feats, int bags,  \
                      int64_t slice_len, int n_slices, int sub,             \
                      float* partial, float* out, void* stream) {           \
    return launch(bins, grads, w, N, F, B, C, feats, bags, slice_len,       \
                  n_slices, sub, partial, out,                              \
                  static_cast<cudaStream_t>(stream));                       \
  }

HIST_MULTI_ENTRY(histogram_multi_u8, uint8_t)
HIST_MULTI_ENTRY(histogram_multi_i16, int16_t)
HIST_MULTI_ENTRY(histogram_multi_i32, int32_t)
