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
// because the MXU is its only fast unit. Here it is the C = 1 case of the
// lane-owned column design in histogram_common.cuh (the design, its
// determinism and what bounds it are described there): a warp's 32 lanes
// own 32 features' [bins, 2] histograms in shared memory and walk one
// document slice in order, skipping 32-document chunks the mask leaves
// empty; the slices' partials are added in slice order. A child build
// costs in proportion to the chunks and documents it weights.

#include "histogram_common.cuh"

// bins [F, N] contiguous; grad, w [N] f32; partial [slices, F, B, 2]
// scratch when slices > 1; out [F, B, 2] f32. The rest is the planner's
// (ops/histogram.py plan). Returns the cudaError_t of the launches.
#define HIST_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* bins, const float* grad, const float* w,     \
                      int64_t N, int F, int B, int warp_bins, int ranges,   \
                      int64_t slice_len, int slices, int vec,               \
                      float* partial, float* out, void* stream) {           \
    const hist::Geometry g{N,         F,         B,      1,  F,             \
                           warp_bins, ranges,    slice_len, slices, vec};   \
    return hist::launch(bins, grad, w, nullptr, g, partial, out,            \
                        static_cast<cudaStream_t>(stream));                 \
  }

HIST_ENTRY(histogram_u8, uint8_t)
HIST_ENTRY(histogram_i16, int16_t)
HIST_ENTRY(histogram_i32, int32_t)
