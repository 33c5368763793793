// Fused lambda-gradient pair sums for Hopper (sm_90a): the CUDA counterpart
// of ranklib_tpu/ops/lambda_kernel.py _kernel (wrapper lambda_weights_fused).
//
// What it computes (the same as the TPU kernel): per query row and ranked
// position p, over every other position q of the row,
//
//   lam[p] =  sum_{q: L_p > L_q} rho * delta * V_p V_q
//           - sum_{q: L_q > L_p} rho * delta * V_p V_q
//   w[p]   =  sum over both sets of rho (1 - rho) * delta * V_p V_q
//
// with rho = sigmoid(s_loser - s_winner) and delta = |A_p - A_q| |B_p - B_q|,
// the product-separable swap change of NDCG, DCG and P@k.
//
// How: one block per query row. The row's five vectors (A, B, L, S, V:
// 20 bytes a position) are staged in shared memory in tiles of kTile
// positions; one thread owns one position p (a block loops over positions
// when D is wider than the block) and walks q in order, keeping its winner
// and loser sums apart, then lam = winner - loser as in the reference. No
// atomics: two launches give the same bits. Each pair's terms are f32 (expf,
// not the fast intrinsic); the sums run in f64 and round to f32 once, as the
// plain version's do, so the order of the sums (here q by q, there torch's
// reduction) leaves the result at the correctly rounded value but for rare
// halfway cases: kernel and plain version, and so card and CPU, give the
// same lambdas from the same terms.
//
// What bounds it on the H100: D^2 pairs a row, ~12 flops (two of them f64
// adds) and one expf each — microseconds at the training shape (1,500
// queries of 80-160 docs); the inputs and outputs are 28 bytes a position.
// Every q read is a shared-memory broadcast (all threads of a warp read
// the same q), so the loop runs at the SM's arithmetic rate; at this size
// launch and latency, not arithmetic, bound it (a round's five launches
// take ~0.3 ms on the card, PERF.md).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTile = 512;
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void lambda_pairs_kernel(const float* __restrict__ A,
                                    const float* __restrict__ Bv,
                                    const float* __restrict__ L,
                                    const float* __restrict__ S,
                                    const float* __restrict__ V, int D,
                                    float* __restrict__ lam,
                                    float* __restrict__ w) {
  __shared__ float sA[kTile], sB[kTile], sL[kTile], sS[kTile], sV[kTile];
  const int64_t row = static_cast<int64_t>(blockIdx.x) * D;
  for (int p0 = 0; p0 < D; p0 += blockDim.x) {
    const int p = p0 + threadIdx.x;
    const bool live = p < D;
    float ap = 0.0f, bp = 0.0f, lp = 0.0f, sp = 0.0f, vp = 0.0f;
    if (live) {
      ap = A[row + p];
      bp = Bv[row + p];
      lp = L[row + p];
      sp = S[row + p];
      vp = V[row + p];
    }
    double win_l = 0.0, lose_l = 0.0, win_w = 0.0, lose_w = 0.0;
    for (int q0 = 0; q0 < D; q0 += kTile) {
      const int nq = min(kTile, D - q0);
      __syncthreads();                       // the previous tile is read
      for (int i = threadIdx.x; i < nq; i += blockDim.x) {
        sA[i] = A[row + q0 + i];
        sB[i] = Bv[row + q0 + i];
        sL[i] = L[row + q0 + i];
        sS[i] = S[row + q0 + i];
        sV[i] = V[row + q0 + i];
      }
      __syncthreads();
      if (!live || vp == 0.0f) continue;     // an invalid p pairs with none
      for (int i = 0; i < nq; ++i) {
        const float lq = sL[i];
        if (lq == lp) continue;
        const float vv = vp * sV[i];
        const float delta = fabsf(ap - sA[i]) * fabsf(bp - sB[i]);
        // p wins: rho = s(s_q - s_p); q wins: rho = s(s_p - s_q)
        const bool wins = lp > lq;
        const float rho = sigmoid(wins ? sS[i] - sp : sp - sS[i]);
        const float t = vv * rho * delta;
        const float tw = vv * (rho * (1.0f - rho)) * delta;
        if (wins) {
          win_l += t;
          win_w += tw;
        } else {
          lose_l += t;
          lose_w += tw;
        }
      }
    }
    if (live) {
      lam[row + p] = static_cast<float>(win_l - lose_l);
      w[row + p] = static_cast<float>(win_w + lose_w);
    }
  }
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer to a
// contiguous [rows, D] f32 matrix; `stream` is the caller's cudaStream_t.
// Nothing here allocates or synchronises. Returns the launch's cudaError_t.
extern "C" int lambda_pairs(const void* A, const void* Bv, const void* L,
                            const void* S, const void* V, int64_t rows, int D,
                            void* lam, void* w, void* stream) {
  const int threads = std::min(kMaxThreads, ((D + 31) / 32) * 32);
  lambda_pairs_kernel<<<static_cast<unsigned>(rows), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bv),
      static_cast<const float*>(L), static_cast<const float*>(S),
      static_cast<const float*>(V), D, static_cast<float*>(lam),
      static_cast<float*>(w));
  return static_cast<int>(cudaGetLastError());
}
