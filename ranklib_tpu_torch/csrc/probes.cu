// The compiler probes for Hopper (sm_90a): the CUDA counterparts of
// tools/exp_int8_dot_probe.py _kernel_i8 / _kernel_f32 (an int8 -> int32 and
// an f32 -> f32 matrix product over 0/1 inputs) and
// tools/exp_mosaic_reprobe.py kern (an int16 compare, x > 3 -> f32).
//
// What they computed on the TPU: whether the compiler took an int8 dot and
// a sub-32-bit compare inside a kernel, and what rate the int8 dot reached
// against the f32 one. Here nvcc takes both types as a matter of course;
// the probes keep the measurement: one kernel template instantiated for
// int8 inputs with int32 sums and for f32, timed at the reference's shape
// ([256, K] x [K, 128], K = 2^20), with checksums that must agree (0/1
// inputs keep every sum an integer below 2^24, exact in f32).
//
// How: a plain shared-memory tiled product on the CUDA cores. A block
// computes a 64 x 64 tile of C over one slice of K (split-K: 2,048 blocks
// at the reference's shape), 256 threads each holding a 4 x 4 register
// tile, and adds its partial sums to C with atomicAdd — exact for int32,
// and for f32 while every sum is an integer below 2^24, so the result does
// not depend on the order. No tensor cores (no mma/wgmma): the probe
// measures what a hand-written kernel of this simple shape reaches.
//
// What bounds it on the H100: operations (2 x 256 x 128 x K: 68.7 G at
// the reference's shape, 1.0 ms at the 67 TFLOP/s of f32 outside the tensor
// cores); the inputs are 0.4 GB (int8) or 1.6 GB (f32).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;                 // 16 x 16, 4 x 4 outputs each
constexpr int kKPerBlock = 4096;              // K slice of one block

template <typename TIn, typename TAcc>
__global__ void dot_kernel(const TIn* __restrict__ A,
                           const TIn* __restrict__ B, int M, int N, int64_t K,
                           TAcc* __restrict__ C) {
  __shared__ TAcc sA[kBK][kBM];               // A tile, k-major
  __shared__ TAcc sB[kBK][kBN];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.z) * kKPerBlock;
  const int64_t k_hi = k_lo + kKPerBlock < K ? k_lo + kKPerBlock : K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  TAcc acc[4][4] = {};
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int m = i / kBK, k = i % kBK;      // along k: coalesced
      const int64_t gk = k0 + k;
      sA[k][m] = (m0 + m < M && gk < k_hi)
                     ? static_cast<TAcc>(A[(m0 + m) * K + gk]) : TAcc(0);
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, n = i % kBN;      // along n: coalesced
      const int64_t gk = k0 + k;
      sB[k][n] = (n0 + n < N && gk < k_hi)
                     ? static_cast<TAcc>(B[gk * N + n0 + n]) : TAcc(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      TAcc a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sA[k][ty * 4 + i];
        b[i] = sB[k][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) atomicAdd(C + static_cast<int64_t>(m) * N + n,
                                    acc[i][j]);
    }
  }
}

__global__ void compare_kernel(const int16_t* __restrict__ x, int64_t n,
                               int threshold, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) out[i] = x[i] > threshold ? 1.0f : 0.0f;
}

template <typename TIn, typename TAcc>
int launch_dot(const void* A, const void* B, int M, int N, int64_t K, void* C,
               void* stream) {
  const dim3 blocks((N + kBN - 1) / kBN, (M + kBM - 1) / kBM,
                    static_cast<unsigned>((K + kKPerBlock - 1) / kKPerBlock));
  dot_kernel<TIn, TAcc><<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TIn*>(A), static_cast<const TIn*>(B), M, N, K,
      static_cast<TAcc*>(C));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is the caller's cudaStream_t. Nothing here allocates or synchronises; the
// dot adds into C, which the caller zeroes. Each returns the cudaError_t of
// the launch.

// C [M, N] += A [M, K] x B [K, N], int8 inputs, int32 sums (row-major).
extern "C" int probe_dot_i8(const void* A, const void* B, int M, int N,
                            int64_t K, void* C, void* stream) {
  return launch_dot<int8_t, int>(A, B, M, N, K, C, stream);
}

// C [M, N] += A [M, K] x B [K, N], f32 (row-major).
extern "C" int probe_dot_f32(const void* A, const void* B, int M, int N,
                             int64_t K, void* C, void* stream) {
  return launch_dot<float, float>(A, B, M, N, K, C, stream);
}

// out[i] = x[i] > threshold ? 1 : 0, int16 in, f32 out.
extern "C" int probe_compare_i16(const void* x, int64_t n, int threshold,
                                 void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  compare_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), n, threshold, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
