// Masked two-channel feature histogram for Hopper (sm_90a): the CUDA
// counterpart of ranklib_tpu/ops/histogram.py _hist_radix_kernel (wrapper
// hist_pallas_radix), which tree growth runs for the root and for every
// right child it builds.
//
// What it computes (the same as hist_xla): out[f, b] = (sum of w_d * g_d,
// sum of w_d) over docs d with bins[f, d] == b; bins >= B (and < 0) add
// nothing. w is a 0/1 mask or f32 multiplicities; counts of integer
// weights are exact. Any B.
//
// How: the TPU kernel turns the scatter into radix-16 one-hot matmuls
// because the MXU is its only fast unit. Here a block takes one chunk of
// `chunk` documents and a group of features. It stages g*w and w of its
// chunk in shared memory once and reuses them for every feature of the
// group; each warp owns whole features, and each owned feature's [B, 2]
// histogram lives in shared memory (2 KB at B = 256). Bins are read
// coalesced along the doc axis ([F, N] puts documents contiguous) and
// upcast to int before any compare (a uint8 compare against 256 wraps).
//
// Determinism: no float atomics. Within a warp, the 32 documents of one
// step that fall in the same bin are found with __match_any_sync; each
// group is summed in lane order with shuffles and its lowest lane adds the
// sum to the bin (distinct groups touch distinct bins, and one warp owns a
// feature, so there are no races). Each block writes its chunk's partial
// histograms to a [chunks, F, B, 2] scratch; a second kernel adds the
// partials in chunk order. Every launch therefore sums in the same order
// and gives the same bits. Chunks whose weights are all zero (child builds
// mask most docs) flag themselves empty and write nothing; inside a chunk,
// 32-doc steps with no nonzero weight cost one ballot and load no bins.
//
// What bounds it on the H100: the root pass at the bench's shape reads
// 136 x ~180K uint8 ids (~25 MB), a few microseconds of HBM. The bound is
// the per-step warp work (ballot, match, up to 64 shuffles for 32 docs)
// and its latency, not memory traffic; a child build with ~10% nonzero
// weights does a fraction of the shuffles.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void hist_partial_kernel(const T* __restrict__ bins,
                                    const float* __restrict__ grad,
                                    const float* __restrict__ w, int64_t N,
                                    int F, int B, int chunk, int feats,
                                    float* __restrict__ partial,
                                    int* __restrict__ nonempty) {
  extern __shared__ float smem[];
  float* s_gw = smem;                    // [chunk] g * w
  float* s_w = smem + chunk;             // [chunk] w
  float* s_hist = smem + 2 * chunk;      // [feats, B, 2]
  const int c = blockIdx.x;
  const int f0 = blockIdx.y * feats;
  const int nf = min(feats, F - f0);
  const int64_t d0 = static_cast<int64_t>(c) * chunk;
  const int len = static_cast<int>(min(static_cast<int64_t>(chunk), N - d0));

  int any = 0;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float wv = w[d0 + i];
    s_w[i] = wv;
    s_gw[i] = grad[d0 + i] * wv;
    any |= (wv != 0.0f);
  }
  any = __syncthreads_or(any);
  if (blockIdx.y == 0 && threadIdx.x == 0) nonempty[c] = any ? 1 : 0;
  if (!any) return;
  for (int i = threadIdx.x; i < nf * B * 2; i += kThreads) s_hist[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int lf = warp; lf < nf; lf += kWarps) {
    const T* col = bins + static_cast<int64_t>(f0 + lf) * N + d0;
    float* h = s_hist + static_cast<size_t>(lf) * B * 2;
    for (int base = 0; base < len; base += 32) {
      const int i = base + lane;
      const float wv = i < len ? s_w[i] : 0.0f;
      int b = -1;
      if (wv != 0.0f) b = static_cast<int>(col[i]);
      const bool act = wv != 0.0f && b >= 0 && b < B;
      const unsigned active = __ballot_sync(kFull, act);
      if (active == 0) continue;
      const float gv = act ? s_gw[i] : 0.0f;
      const unsigned grp = __match_any_sync(kFull, act ? b : -1);
      float s = 0.0f, n = 0.0f;
      for (unsigned m = active; m; m &= m - 1) {   // lane order
        const int j = __ffs(m) - 1;
        const float gj = __shfl_sync(kFull, gv, j);
        const float wj = __shfl_sync(kFull, wv, j);
        if (act && ((grp >> j) & 1u)) {
          s += gj;
          n += wj;
        }
      }
      if (act && lane == __ffs(grp) - 1) {
        h[2 * b] += s;
        h[2 * b + 1] += n;
      }
    }
  }
  __syncthreads();
  float* out = partial + (static_cast<size_t>(c) * F + f0) * B * 2;
  for (int i = threadIdx.x; i < nf * B * 2; i += kThreads) out[i] = s_hist[i];
}

__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   const int* __restrict__ nonempty,
                                   int n_chunks, int64_t size,
                                   float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= size) return;
  float acc = 0.0f;
  for (int c = 0; c < n_chunks; ++c)   // fixed order: chunk 0, 1, ...
    if (nonempty[c]) acc += partial[static_cast<int64_t>(c) * size + i];
  out[i] = acc;
}

template <typename T>
int launch(const T* bins, const float* grad, const float* w, int64_t N,
           int F, int B, int chunk, int feats, float* partial,
           int* nonempty, float* out, cudaStream_t stream) {
  const int n_chunks = static_cast<int>((N + chunk - 1) / chunk);
  const size_t smem = (2 * static_cast<size_t>(chunk) +
                       static_cast<size_t>(feats) * B * 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_chunks, (F + feats - 1) / feats);
  hist_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      bins, grad, w, N, F, B, chunk, feats, partial, nonempty);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t size = static_cast<int64_t>(F) * B * 2;
  const int threads = 256;
  hist_reduce_kernel<<<static_cast<unsigned>((size + threads - 1) / threads),
                       threads, 0, stream>>>(partial, nonempty, n_chunks,
                                             size, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bins [F, N] contiguous; grad, w [N] f32; partial [ceil(N/chunk), F, B, 2]
// and nonempty [ceil(N/chunk)] scratch; out [F, B, 2] f32. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int histogram_u8(const uint8_t* bins, const float* grad,
                            const float* w, int64_t N, int F, int B,
                            int chunk, int feats, float* partial,
                            int* nonempty, float* out, void* stream) {
  return launch(bins, grad, w, N, F, B, chunk, feats, partial, nonempty, out,
                static_cast<cudaStream_t>(stream));
}

extern "C" int histogram_i16(const int16_t* bins, const float* grad,
                             const float* w, int64_t N, int F, int B,
                             int chunk, int feats, float* partial,
                             int* nonempty, float* out, void* stream) {
  return launch(bins, grad, w, N, F, B, chunk, feats, partial, nonempty, out,
                static_cast<cudaStream_t>(stream));
}

extern "C" int histogram_i32(const int32_t* bins, const float* grad,
                             const float* w, int64_t N, int F, int B,
                             int chunk, int feats, float* partial,
                             int* nonempty, float* out, void* stream) {
  return launch(bins, grad, w, N, F, B, chunk, feats, partial, nonempty, out,
                static_cast<cudaStream_t>(stream));
}
