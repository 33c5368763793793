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
// each (bag, 32-feature group) is one warp that walks only the 32-document
// chunks its bag weights: the lane-owned column design of
// histogram_common.cuh (design, determinism and bound there). With enough
// (bag, group) warps to fill the card the launch has one document slice,
// so every cell sums in document order, as the plain version's index_add_
// does.

#include "histogram_common.cuh"

// bins [F, N] contiguous; grads, w [C, N] f32 contiguous; partial
// [slices, C, F, B, 2] scratch when slices > 1; out [C, F, B, 2] f32. The
// rest is the planner's (ops/histogram.py plan). Returns the cudaError_t of
// the launches (0 on success).
#define HIST_MULTI_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* bins, const float* grads, const float* w,    \
                      int64_t N, int F, int B, int C, int warp_bins,        \
                      int ranges, int64_t slice_len, int slices, int vec,   \
                      float* partial, float* out, void* stream) {           \
    const hist::Geometry g{N,         F,      B,   C, warp_bins, ranges,    \
                           slice_len, slices, vec};                         \
    return hist::launch(bins, grads, w, g, partial, out,                    \
                        static_cast<cudaStream_t>(stream));                 \
  }

HIST_MULTI_ENTRY(histogram_multi_u8, uint8_t)
HIST_MULTI_ENTRY(histogram_multi_i16, int16_t)
HIST_MULTI_ENTRY(histogram_multi_i32, int32_t)
