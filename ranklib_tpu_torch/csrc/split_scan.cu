// Best-split scan over node histograms for Hopper (sm_90a): the CUDA
// counterpart of ranklib_tpu/ops/split_scan.py _scan_kernel (wrapper
// _scan_rows_pallas), which tree growth runs on the root and, once per
// growth iteration, on both new children stacked.
//
// What it computes, per row r (one node x feature) of hist [R, B, 2]
// (channel 0 the gradient sum, 1 the count): inclusive prefix sums c_l,
// s_l over the B bins; totals from the row's own last prefix; c_r, s_r by
// difference; ok = c_l >= mls && c_r >= mls (the caller floors mls at
// 1e-9 so empty sides never win at -mls 0); gain = s_l^2/max(c_l,1) +
// s_r^2/max(c_r,1) where ok, else -inf. Out: the row's max gain and the
// FIRST bin reaching it (bin 0 when nothing is valid, the flat argmax's
// answer). The feature-major first max over a node's rows stays in torch.
//
// How: one warp per row. The TPU kernel takes the prefix sums as one
// matmul against a triangular matrix; here the warp walks the row in
// 32-bin steps with a shuffle inclusive scan that carries the running
// sum, any B. A first pass gets the totals as the last prefix of the very
// same scan, so the second pass's c_r, s_r are exact differences of that
// scan. The gain uses round-to-nearest intrinsics (no FMA contraction),
// the same f32 operations as the plain torch version, and a (gain, -bin)
// warp reduction keeps the first max. With integer-valued histograms
// every prefix is exact, so kernel and plain version agree bit for bit,
// ties included; float histograms differ only by the prefix order.
//
// What bounds it on the H100: the whole input is small (2 x 136 x 256 x
// 8 B = 557 KB for a stacked pair of children), so one launch is latency:
// a few 32-bin steps of shuffles per warp, 8 rows per block.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive warp scan of (c, s), then the carry from earlier steps.
__device__ __forceinline__ void scan_step(float& c, float& s, float& carry_c,
                                          float& carry_s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float tc = __shfl_up_sync(kFull, c, off);
    const float ts = __shfl_up_sync(kFull, s, off);
    if (lane >= off) {
      c = __fadd_rn(c, tc);
      s = __fadd_rn(s, ts);
    }
  }
  c = __fadd_rn(carry_c, c);
  s = __fadd_rn(carry_s, s);
  carry_c = __shfl_sync(kFull, c, 31);
  carry_s = __shfl_sync(kFull, s, 31);
}

__global__ void split_scan_kernel(const float* __restrict__ hist, int64_t R,
                                  int B, float mls, float* __restrict__ gain,
                                  int* __restrict__ best_bin) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;                     // the whole warp leaves
  const float* h = hist + row * B * 2;

  float tot_c = 0.0f, tot_s = 0.0f;         // pass 1: the last prefix
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    float c = b < B ? h[2 * b + 1] : 0.0f;
    float s = b < B ? h[2 * b] : 0.0f;
    scan_step(c, s, tot_c, tot_s, lane);
  }

  float carry_c = 0.0f, carry_s = 0.0f;     // pass 2: the same scan
  float best_g = -CUDART_INF_F;
  int best_b = INT_MAX;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    float c_l = b < B ? h[2 * b + 1] : 0.0f;
    float s_l = b < B ? h[2 * b] : 0.0f;
    scan_step(c_l, s_l, carry_c, carry_s, lane);
    const float c_r = __fsub_rn(tot_c, c_l);
    const float s_r = __fsub_rn(tot_s, s_l);
    if (b < B && c_l >= mls && c_r >= mls) {
      const float g = __fadd_rn(
          __fdiv_rn(__fmul_rn(s_l, s_l), fmaxf(c_l, 1.0f)),
          __fdiv_rn(__fmul_rn(s_r, s_r), fmaxf(c_r, 1.0f)));
      if (g > best_g) {                      // bins rise: strict > = first
        best_g = g;
        best_b = b;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(kFull, best_g, off);
    const int ob = __shfl_down_sync(kFull, best_b, off);
    if (og > best_g || (og == best_g && ob < best_b)) {
      best_g = og;
      best_b = ob;
    }
  }
  if (lane == 0) {
    gain[row] = best_g;
    best_bin[row] = best_b == INT_MAX ? 0 : best_b;
  }
}

}  // namespace

// hist [R, B, 2] f32 contiguous → gain [R] f32, best_bin [R] int32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int split_scan(const float* hist, int64_t R, int B, float mls,
                          float* gain, int* best_bin, void* stream) {
  const int64_t blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
  split_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      hist, R, B, mls, gain, best_bin);
  return static_cast<int>(cudaGetLastError());
}
