// Best-split scan over node histograms for Hopper (sm_90a): the CUDA
// counterpart of ranklib_tpu/ops/split_scan.py _scan_kernel (wrapper
// _scan_rows_pallas) together with the first max over a node's features
// that its router best_splits takes in XLA. Tree growth runs it on the root
// and, once per growth iteration, on both new children.
//
// What one launch computes, for each node n of hist [Cn, F, B, 2] (channel
// 0 the gradient sum, 1 the count; the nodes may lie in two tensors, the
// first n_first nodes at base0 and the rest at base1): per row (n, f),
// inclusive prefix sums c_l, s_l over the B bins, the totals as the row's
// own last prefix, c_r, s_r by difference, ok = c_l >= mls && c_r >= mls
// (the caller floors mls at 1e-9 so empty sides never win at -mls 0) and
// fmask[n, f], gain = s_l^2/max(c_l,1) + s_r^2/max(c_r,1) where ok; then
// the node's first max, feature-major: the largest gain, on ties the
// lowest feature, then the lowest bin. Out per node: (gain, feature, bin,
// ok = gain finite), and (-inf, 0, 0, false) when nothing is valid -- the
// flat argmax of the plain PyTorch version.
//
// How. One warp scans one row, reading it once: lane l holds the K
// contiguous bins [l*K, l*K + K) of a pass of 32*K bins (16-byte loads when
// the rows are aligned), K the least power of two with 32*K >= B, at most
// 16. A lane-serial inclusive prefix over its K bins, then a Hillis-Steele
// warp scan of the 32 lane totals, whose exclusive value (plus the carry of
// earlier passes) is added to each of the lane's prefixes; the row total is
// the prefix at the last bin, so c_r, s_r are exact differences of that
// very scan. Rows of more than 512 bins take several passes and a first
// pass for the total (the only case that reads a row twice). The gain uses
// round-to-nearest intrinsics (no FMA contraction), the plain version's
// f32 operations, and a lane-serial then (gain, -bin) warp reduction keeps
// the first max. With integer-valued histograms every prefix is exact, so
// kernel and plain version agree bit for bit, ties included; on float
// histograms they differ only by the prefix order (tests emulate it).
//
// The node's max is finished in the same launch by the warp that scans its
// last row (a last-arrival ticket): each warp writes its row's (gain, bin)
// to a scratch slot, makes it visible (__threadfence) and counts the row in
// the node's ticket; the warp that counts the F-th row reads the node's F
// slots in feature order and writes the result, so the answer does not
// depend on which warp finished first. It then resets the ticket to 0, so
// the tickets stay zeroed between launches (the wrapper keeps them per
// device and stream and allocates them once). Masked rows are not read.
//
// What bounds it on the H100: a LambdaMART call ([2, 136, 256, 2], 557 KB)
// is launch latency; warps take rows in a grid-stride loop over up to 132
// x 16 blocks of 4 warps, so at Cn = 1-2 the 136-272 rows spread one a warp
// over the SMs. A Random-Forest call ([600, 136, 256, 2], 167 MB) is bound
// by the bytes of its unmasked rows.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;                 // warps a block
constexpr int kMaxBlocks = 132 * 16;
constexpr unsigned kFull = 0xffffffffu;

struct Scan {
  const float* base0;                     // nodes [0, n_first)
  const float* base1;                     // nodes [n_first, Cn)
  int64_t n_first, Cn;
  int F, B, passes;
  float mls;
  const uint8_t* fmask;                   // [Cn, F] bool (row stride), or null
  int64_t fmask_stride;
  bool vec;                               // rows 16-byte aligned, B even
};

// Loads one pass of a row: lane holds bins [first, first + K).
template <int K>
__device__ __forceinline__ void load_pass(const float* __restrict__ h, int B,
                                          int first, bool vec, float (&c)[K],
                                          float (&s)[K]) {
  if constexpr (K >= 2) {
    if (vec && first + K <= B) {
#pragma unroll
      for (int j = 0; j < K; j += 2) {
        const float4 q =
            __ldg(reinterpret_cast<const float4*>(h + 2 * (first + j)));
        s[j] = q.x;
        c[j] = q.y;
        s[j + 1] = q.z;
        c[j + 1] = q.w;
      }
      return;
    }
  }
  {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int b = first + j;
      s[j] = b < B ? __ldg(h + 2 * b) : 0.0f;
      c[j] = b < B ? __ldg(h + 2 * b + 1) : 0.0f;
    }
  }
}

// Turns one pass's bins into inclusive prefixes (lane-serial, then the
// exclusive warp scan of the lane totals plus the carry); returns the new
// carry, the prefix at the pass's last bin.
template <int K>
__device__ __forceinline__ void prefix_pass(float (&c)[K], float (&s)[K],
                                            float& carry_c, float& carry_s,
                                            int lane) {
#pragma unroll
  for (int j = 1; j < K; ++j) {
    c[j] = __fadd_rn(c[j - 1], c[j]);
    s[j] = __fadd_rn(s[j - 1], s[j]);
  }
  float tc = c[K - 1], ts = s[K - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float uc = __shfl_up_sync(kFull, tc, off);
    const float us = __shfl_up_sync(kFull, ts, off);
    if (lane >= off) {
      tc = __fadd_rn(uc, tc);
      ts = __fadd_rn(us, ts);
    }
  }
  float ec = __shfl_up_sync(kFull, tc, 1);
  float es = __shfl_up_sync(kFull, ts, 1);
  if (lane == 0) ec = es = 0.0f;
  const float bc = __fadd_rn(carry_c, ec);
  const float bs = __fadd_rn(carry_s, es);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    c[j] = __fadd_rn(bc, c[j]);
    s[j] = __fadd_rn(bs, s[j]);
  }
  carry_c = __shfl_sync(kFull, c[K - 1], 31);
  carry_s = __shfl_sync(kFull, s[K - 1], 31);
}

// Keeps (g, b) if it beats (best_g, best_b): larger gain, then lower bin.
__device__ __forceinline__ void keep_first_max(float g, int b, float& best_g,
                                               int& best_b) {
  if (g > best_g || (g == best_g && b < best_b)) {
    best_g = g;
    best_b = b;
  }
}

__device__ __forceinline__ void warp_first_max(float& g, int& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(kFull, g, off);
    const int ob = __shfl_down_sync(kFull, b, off);
    keep_first_max(og, ob, g, b);
  }
  g = __shfl_sync(kFull, g, 0);
  b = __shfl_sync(kFull, b, 0);
}

// The row's best (gain, bin), bin INT_MAX when nothing is valid.
template <int K>
__device__ void scan_row(const float* __restrict__ h, const Scan& p, int lane,
                         float& best_g, int& best_b) {
  best_g = -CUDART_INF_F;
  best_b = INT_MAX;
  float tot_c = 0.0f, tot_s = 0.0f;
  float c[K], s[K];
  if (p.passes > 1) {                     // the total first: the same scan
    for (int q = 0; q < p.passes; ++q) {
      load_pass<K>(h, p.B, q * 32 * K + lane * K, p.vec, c, s);
      prefix_pass<K>(c, s, tot_c, tot_s, lane);
    }
  }
  float carry_c = 0.0f, carry_s = 0.0f;
  for (int q = 0; q < p.passes; ++q) {
    const int first = q * 32 * K + lane * K;
    load_pass<K>(h, p.B, first, p.vec, c, s);
    prefix_pass<K>(c, s, carry_c, carry_s, lane);
    if (p.passes == 1) {
      tot_c = carry_c;
      tot_s = carry_s;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int b = first + j;
      const float c_r = __fsub_rn(tot_c, c[j]);
      const float s_r = __fsub_rn(tot_s, s[j]);
      if (b < p.B && c[j] >= p.mls && c_r >= p.mls) {
        const float g = __fadd_rn(
            __fdiv_rn(__fmul_rn(s[j], s[j]), fmaxf(c[j], 1.0f)),
            __fdiv_rn(__fmul_rn(s_r, s_r), fmaxf(c_r, 1.0f)));
        if (g > best_g) {                 // a lane's bins rise: > is first
          best_g = g;
          best_b = b;
        }
      }
    }
  }
  warp_first_max(best_g, best_b);
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
split_scan_kernel(Scan p, float2* __restrict__ rows,
                  int* __restrict__ tickets, float* __restrict__ gain,
                  int* __restrict__ feature, int* __restrict__ bin,
                  uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x % 32;
  const int64_t R = p.Cn * p.F;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps +
                   threadIdx.x / 32;
       r < R; r += stride) {
    const int64_t n = r / p.F;
    const int f = static_cast<int>(r - n * p.F);
    float g = -CUDART_INF_F;
    int b = INT_MAX;
    if (p.fmask == nullptr || p.fmask[n * p.fmask_stride + f]) {
      const float* h = n < p.n_first
          ? p.base0 + (n * p.F + f) * static_cast<int64_t>(p.B) * 2
          : p.base1 + ((n - p.n_first) * p.F + f) *
                          static_cast<int64_t>(p.B) * 2;
      scan_row<K>(h, p, lane, g, b);
    }
    int last = 0;
    if (lane == 0) {
      rows[r] = make_float2(g, __int_as_float(b));
      __threadfence();                    // the slot before the ticket
      last = atomicAdd(tickets + n, 1) == p.F - 1;
    }
    if (!__shfl_sync(kFull, last, 0)) continue;
    // the node's last row: its F slots in feature order
    __threadfence();
    float bg = -CUDART_INF_F;
    int bf = INT_MAX, bb = 0;
    for (int k = lane; k < p.F; k += 32) {
      const float2 v = __ldcg(rows + n * p.F + k);
      if (v.x > bg) {                     // a lane's features rise
        bg = v.x;
        bf = k;
        bb = __float_as_int(v.y);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float og = __shfl_down_sync(kFull, bg, off);
      const int of = __shfl_down_sync(kFull, bf, off);
      const int ob = __shfl_down_sync(kFull, bb, off);
      if (og > bg || (og == bg && of < bf)) {
        bg = og;
        bf = of;
        bb = ob;
      }
    }
    if (lane == 0) {
      const bool any = bg > -CUDART_INF_F;
      gain[n] = bg;
      feature[n] = any ? bf : 0;
      bin[n] = any ? bb : 0;
      ok[n] = any && bg < CUDART_INF_F;
      tickets[n] = 0;                     // zeroed for the next launch
    }
  }
}

template <int K>
cudaError_t launch(const Scan& p, void* rows, void* tickets, void* gain,
                   void* feature, void* bin, void* ok, cudaStream_t stream) {
  const int64_t R = p.Cn * p.F;
  int64_t blocks = (R + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  split_scan_kernel<K><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                         stream>>>(
      p, static_cast<float2*>(rows), static_cast<int*>(tickets),
      static_cast<float*>(gain), static_cast<int*>(feature),
      static_cast<int*>(bin), static_cast<uint8_t*>(ok));
  return cudaGetLastError();
}

}  // namespace

// hist: Cn nodes of [F, B, 2] f32 contiguous rows, the first n_first at
// base0 and the rest at base1 (base1 may equal base0 + n_first nodes);
// fmask: null, or [Cn, F] bytes with row stride fmask_stride (0 = one row
// for every node); rows: Cn * F float2 scratch; tickets: Cn int32, zero on
// entry and on return. Out: gain [Cn] f32, feature [Cn] int32, bin [Cn]
// int32, ok [Cn] bool. Returns the launch's cudaError_t (0 on success).
extern "C" int split_scan(const float* base0, const float* base1,
                          int64_t n_first, int64_t Cn, int F, int B,
                          float mls, const uint8_t* fmask,
                          int64_t fmask_stride, void* rows, void* tickets,
                          void* gain, void* feature, void* bin, void* ok,
                          void* stream) {
  if (Cn <= 0 || F <= 0 || B <= 0) return 0;
  int K = 1;
  while (K < 16 && 32 * K < B) K <<= 1;
  Scan p{base0, base1, n_first, Cn, F, B, (B + 32 * K - 1) / (32 * K), mls,
         fmask, fmask_stride,
         B % 2 == 0 && reinterpret_cast<uintptr_t>(base0) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(base1) % 16 == 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (K) {
    case 1: err = launch<1>(p, rows, tickets, gain, feature, bin, ok, st); break;
    case 2: err = launch<2>(p, rows, tickets, gain, feature, bin, ok, st); break;
    case 4: err = launch<4>(p, rows, tickets, gain, feature, bin, ok, st); break;
    case 8: err = launch<8>(p, rows, tickets, gain, feature, bin, ok, st); break;
    default: err = launch<16>(p, rows, tickets, gain, feature, bin, ok, st);
  }
  return static_cast<int>(err);
}
