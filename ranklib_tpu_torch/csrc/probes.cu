// The compiler probes for Hopper (sm_90a): the CUDA counterparts of
// tools/exp_int8_dot_probe.py _kernel_i8 / _kernel_f32 (an int8 -> int32 and
// an f32 -> f32 matrix product over 0/1 inputs) and
// tools/exp_mosaic_reprobe.py kern (an int16 compare, x > 3 -> f32).
//
// What they computed on the TPU: whether the compiler took an int8 dot and
// a sub-32-bit compare inside a kernel, and what rate the int8 dot reached
// against the f32 one. Here nvcc takes both types as a matter of course;
// the probes keep the measurement: C [M, N] += A [M, K] x B [K, N], both
// row-major, timed at the reference's shape ([256, K] x [K, 128], K =
// 2^20), with checksums that must agree (0/1 inputs keep every sum an
// integer below 2^24, exact in f32).
//
// Both products split K: a block owns one 128 x 128 tile of C and one run
// of whole K tiles, sized so that the tiles x runs fill every SM twice in
// one wave, and adds its sums to C with atomicAdd — exact for int32, and
// for f32 while every sum is an integer below 2^24, so the result does not
// depend on the order.
//
// f32 (sgemm_kernel): exact f32 FMAs on the CUDA cores (no TF32: it would
// round every input to 10 mantissa bits). Bound by operations (2 x 256 x
// 128 x K: 68.7 G at the reference's shape, 1.03 ms at the 67 TFLOP/s of
// f32 outside the tensor cores), so the design keeps the FMA pipe fed:
// 256 threads, each an 8 x 8 register tile (64 FMAs for four 16-byte
// shared loads a k step; a warp's A loads are broadcasts, its B loads
// cover 32 banks once); K tiles of 32 (one barrier a 2,048 FMAs a
// thread); A (K-contiguous in memory) is loaded as float4 and stored
// k-major with its m index XOR-swizzled by (k / 4) so the transposing
// store hits 32 banks; B goes to shared memory with cp.async; two stages,
// the next K tile landing while this one is multiplied; the split-K sums
// leave as 16-byte atomic reductions.
//
// int8 (imma_kernel): the tensor cores, mma.sync m16n8k32 s8 x s8 -> s32.
// Bound by bytes (0.4 GB of input at the reference's shape, 0.12 ms at
// 3.35 TB/s). 8-bit MMA takes B K-major, but B [K, N] is N-contiguous and
// ldmatrix .trans exists only for 16-bit types, so each thread loads 4 K
// rows x 8 bytes of B and transposes the 4 x 4 byte blocks with
// __byte_perm (prmt) into K-major words as it stages them. A is K-major
// already and goes to shared memory with cp.async. Both tiles are 64-byte
// rows whose 16-byte chunks are XOR-swizzled by (row / 2) % 4, so the
// ldmatrix reads of 8 rows hit 32 banks. Two stages as above.
//
// Shapes whose rows are not 16-byte (A) or 8-byte (B) aligned take the
// same kernels with element-wise staging (kVec = false): same tiles, same
// sums.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;                    // C tile: kTile x kTile
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `src_bytes` (0..16) are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The K tiles [lo, hi) of split `s` of `splits` over `k_tiles`.
__device__ __forceinline__ void k_run(int64_t k_tiles, int s, int splits,
                                      int64_t* lo, int64_t* hi) {
  *lo = k_tiles * s / splits;
  *hi = k_tiles * (s + 1) / splits;
}

// ---- f32 --------------------------------------------------------------

constexpr int kFBK = 32;                      // K tile of the f32 product
constexpr size_t kFSmem = 2 * 2 * kFBK * kTile * sizeof(float);

// Physical column of A element (k, m) in its k-major row: m with bits 2-4
// XORed by (k / 4) % 8. Groups of 4 m stay contiguous (float4 reads).
__device__ __forceinline__ int swz_a(int k, int m) {
  return m ^ (((k >> 2) & 7) << 2);
}

template <bool kVec>
struct F32Stage {
  float4 a[4];                                // A held between load/store

  // A tile (kTile m x kFBK k): element (m, kq..kq+3) for idx = tid + 256 i.
  __device__ __forceinline__ void load_a(const float* A, int M, int64_t K,
                                         int m0, int64_t k0, int tid) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kThreads * i;
      const int m = idx >> 3, kq = (idx & 7) * 4;
      const int64_t gk = k0 + kq;
      const float* src = A + static_cast<int64_t>(m0 + m) * K + gk;
      const bool row = m0 + m < M;
      if (kVec) {
        a[i] = (row && gk < K) ? __ldg(reinterpret_cast<const float4*>(src))
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        a[i].x = (row && gk < K) ? __ldg(src) : 0.f;
        a[i].y = (row && gk + 1 < K) ? __ldg(src + 1) : 0.f;
        a[i].z = (row && gk + 2 < K) ? __ldg(src + 2) : 0.f;
        a[i].w = (row && gk + 3 < K) ? __ldg(src + 3) : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store_a(float (*sA)[kTile], int tid) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kThreads * i;
      const int m = idx >> 3, kq = (idx & 7) * 4;
      sA[kq + 0][swz_a(kq, m)] = a[i].x;
      sA[kq + 1][swz_a(kq + 1, m)] = a[i].y;
      sA[kq + 2][swz_a(kq + 2, m)] = a[i].z;
      sA[kq + 3][swz_a(kq + 3, m)] = a[i].w;
    }
  }

  // B tile (kFBK k x kTile n) straight into shared memory: float4 (k, n4)
  // for idx = tid + 256 i, by cp.async (kVec) or element by element.
  __device__ __forceinline__ void stage_b(const float* B, int N, int64_t K,
                                          int n0, int64_t k0,
                                          float (*sB)[kTile], int tid) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + kThreads * i;
      const int k = idx >> 5, n4 = (idx & 31) * 4;
      const int64_t gk = k0 + k;
      const int gn = n0 + n4;
      const float* src = B + gk * N + gn;
      if (kVec) {
        const bool ok = gk < K && gn < N;
        cp_async16(&sB[k][n4], ok ? src : B, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sB[k][n4 + j] = (gk < K && gn + j < N) ? __ldg(src + j) : 0.f;
      }
    }
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    sgemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                 int M, int N, int64_t K, int splits, float* __restrict__ C) {
  extern __shared__ __align__(16) float f_smem[];
  // A k-major, swizzled; B as it is
  auto sA = reinterpret_cast<float (*)[kFBK][kTile]>(f_smem);
  auto sB = reinterpret_cast<float (*)[kFBK][kTile]>(f_smem +
                                                       2 * kFBK * kTile);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int64_t kt, kt_end;
  k_run((K + kFBK - 1) / kFBK, blockIdx.z, splits, &kt, &kt_end);
  // warp tile 32 (m) x 64 (n); a thread's m: wm + tm*4 + {0..3, 16..19},
  // its n: wn + tn*4 + {0..3, 32..35}
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int tm = lane >> 3, tn = lane & 7;
  float acc[8][8] = {};
  F32Stage<kVec> st;
  if (kt < kt_end) {
    st.load_a(A, M, K, m0, kt * kFBK, tid);
    st.stage_b(B, N, K, n0, kt * kFBK, sB[0], tid);
    cp_async_commit();
    st.store_a(sA[0], tid);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; kt < kt_end; ++kt, s ^= 1) {
    const bool more = kt + 1 < kt_end;
    if (more) {
      st.load_a(A, M, K, m0, (kt + 1) * kFBK, tid);
      st.stage_b(B, N, K, n0, (kt + 1) * kFBK, sB[s ^ 1], tid);
      cp_async_commit();
    }
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          &sA[s][k][swz_a(k, wm + tm * 4)]);
      const float4 a1 = *reinterpret_cast<const float4*>(
          &sA[s][k][swz_a(k, wm + 16 + tm * 4)]);
      const float4 b0 = *reinterpret_cast<const float4*>(
          &sB[s][k][wn + tn * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(
          &sB[s][k][wn + 32 + tn * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) st.store_a(sA[s ^ 1], tid);
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wm + (i >> 2) * 16 + tm * 4 + (i & 3);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + wn + h * 32 + tn * 4;
      float* c = C + static_cast<int64_t>(m) * N + n;
      if (kVec && n + 3 < N) {               // one 16-byte reduction
        atomicAdd(reinterpret_cast<float4*>(c),
                  make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                              acc[i][4 * h + 2], acc[i][4 * h + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) atomicAdd(c + j, acc[i][4 * h + j]);
      }
    }
  }
}

// ---- int8 on the tensor cores -------------------------------------------

constexpr int kIBK = 64;                      // K tile of the int8 product

// Byte offset of 16-byte chunk c of row r in a tile of 64-byte rows.
__device__ __forceinline__ int swz_chunk(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

// The 4 x 4 byte transpose: x[r] holds bytes (row r, cols 0..3); out[c]
// holds bytes (rows 0..3, col c).
__device__ __forceinline__ void transpose4x4(const unsigned x[4],
                                             unsigned out[4]) {
  const unsigned t0 = __byte_perm(x[0], x[1], 0x5140);
  const unsigned t1 = __byte_perm(x[0], x[1], 0x7362);
  const unsigned t2 = __byte_perm(x[2], x[3], 0x5140);
  const unsigned t3 = __byte_perm(x[2], x[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

template <bool kVec>
struct I8Stage {
  uint2 b[4];                                 // B rows k4*4 + r, 8 columns

  // A tile (kTile m x 64 k bytes): 16-byte chunk (m, c) for idx = tid +
  // 256 i, by cp.async (kVec: K % 16 == 0) or byte by byte.
  __device__ __forceinline__ void stage_a(const int8_t* A, int M, int64_t K,
                                          int m0, int64_t k0, char* sA,
                                          int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + kThreads * i;
      const int m = idx >> 2, c = idx & 3;
      const int64_t gk = k0 + c * 16;
      const int8_t* src = A + static_cast<int64_t>(m0 + m) * K + gk;
      char* dst = sA + swz_chunk(m, c);
      if (kVec) {
        const bool ok = m0 + m < M && gk < K;
        cp_async16(dst, ok ? src : A, ok ? 16 : 0);
      } else {
        unsigned w[4] = {0, 0, 0, 0};
        if (m0 + m < M) {
          for (int j = 0; j < 16; ++j) {
            if (gk + j < K)
              w[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                               src[j])) << ((j & 3) * 8);
          }
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }

  // B rows k0 + k4*4 + r (r < 4), columns n0 + nb*8 .. +7, with k4 = tid
  // % 16 and nb = tid / 16 (kVec: N % 8 == 0, 8-byte loads).
  __device__ __forceinline__ void load_b(const int8_t* B, int N, int64_t K,
                                         int n0, int64_t k0, int tid) {
    const int k4 = tid & 15, nb = tid >> 4;
    const int gn = n0 + nb * 8;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int64_t gk = k0 + k4 * 4 + r;
      const int8_t* src = B + gk * N + gn;
      if (kVec) {
        b[r] = (gk < K && gn < N)
                   ? __ldg(reinterpret_cast<const uint2*>(src))
                   : make_uint2(0, 0);
      } else {
        unsigned w[2] = {0, 0};
        if (gk < K) {
          for (int j = 0; j < 8; ++j) {
            if (gn + j < N)
              w[j >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(
                               src[j])) << ((j & 3) * 8);
          }
        }
        b[r] = make_uint2(w[0], w[1]);
      }
    }
  }

  // The loaded 4 x 8 bytes as 8 K-major words: column n's bytes k4*4 ..
  // k4*4 + 3 at (row n, k bytes k4*4) of the swizzled [kTile n][64 k] tile.
  __device__ __forceinline__ void store_b(char* sB, int tid) const {
    const int k4 = tid & 15, nb = tid >> 4;
    const unsigned lo[4] = {b[0].x, b[1].x, b[2].x, b[3].x};
    const unsigned hi[4] = {b[0].y, b[1].y, b[2].y, b[3].y};
    unsigned t[8];
    transpose4x4(lo, t);
    transpose4x4(hi, t + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb * 8 + j;
      *reinterpret_cast<unsigned*>(sB + swz_chunk(n, k4 >> 2) +
                                   (k4 & 3) * 4) = t[j];
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int c[4], const unsigned a[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    imma_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                int M, int N, int64_t K, int splits, int* __restrict__ C) {
  __shared__ __align__(128) char sA[2][kTile * kIBK];  // [m][k], swizzled
  __shared__ __align__(128) char sB[2][kTile * kIBK];  // [n][k], swizzled
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  int64_t kt, kt_end;
  k_run((K + kIBK - 1) / kIBK, blockIdx.z, splits, &kt, &kt_end);
  // warp tile 64 (m) x 32 (n): 4 x 4 m16n8 tiles
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  int acc[4][4][4] = {};
  I8Stage<kVec> st;
  if (kt < kt_end) {
    st.stage_a(A, M, K, m0, kt * kIBK, sA[0], tid);
    cp_async_commit();
    st.load_b(B, N, K, n0, kt * kIBK, tid);
    st.store_b(sB[0], tid);
    cp_async_wait_all();
    __syncthreads();
  }
  // ldmatrix lane addresses: A matrices (rows 0-7 | 8-15) x (k 0-15 |
  // 16-31); B matrices (k 0-15 | 16-31) x (n 0-7 | 8-15)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_c = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_c = (lane >> 3) & 1;
  for (int s = 0; kt < kt_end; ++kt, s ^= 1) {
    const bool more = kt + 1 < kt_end;
    if (more) {
      st.stage_a(A, M, K, m0, (kt + 1) * kIBK, sA[s ^ 1], tid);
      cp_async_commit();
      st.load_b(B, N, K, n0, (kt + 1) * kIBK, tid);
    }
#pragma unroll
    for (int kk = 0; kk < kIBK / 32; ++kk) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + a_row;
        ldmatrix_x4(a[mi], sA[s] + swz_chunk(r, kk * 2 + a_c));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int r = wn + p * 16 + b_row;
        unsigned q[4];
        ldmatrix_x4(q, sB[s] + swz_chunk(r, kk * 2 + b_c));
        b[2 * p][0] = q[0];
        b[2 * p][1] = q[1];
        b[2 * p + 1][0] = q[2];
        b[2 * p + 1][1] = q[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    if (more) st.store_b(sB[s ^ 1], tid);
    cp_async_wait_all();
    __syncthreads();
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + mi * 16 + g + h * 8;
      if (m >= M) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + ni * 8 + t * 2 + e;
          if (n < N)
            atomicAdd(C + static_cast<int64_t>(m) * N + n,
                      acc[mi][ni][h * 2 + e]);
        }
      }
    }
  }
}

__global__ void compare_kernel(const int16_t* __restrict__ x, int64_t n,
                               int threshold, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i < n) out[i] = x[i] > threshold ? 1.0f : 0.0f;
}

// Grid of a split-K product: (N tiles, M tiles, K runs), the runs as many
// as fill every SM with two blocks (at most one a K tile).
dim3 split_grid(int M, int N, int64_t K, int bk, int* splits) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const int tiles_n = (N + kTile - 1) / kTile;
  const int tiles_m = (M + kTile - 1) / kTile;
  const int64_t k_tiles = (K + bk - 1) / bk;
  int64_t s = (2 * sms + tiles_n * tiles_m - 1) / (tiles_n * tiles_m);
  s = s < k_tiles ? s : k_tiles;
  *splits = static_cast<int>(s < 1 ? 1 : s);
  return dim3(tiles_n, tiles_m, *splits);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C interface for ctypes. Every pointer is a device pointer; `stream`
// is the caller's cudaStream_t. Nothing here allocates or synchronises; the
// dot adds into C, which the caller zeroes. Each returns the cudaError_t of
// the launch.

// C [M, N] += A [M, K] x B [K, N], int8 inputs, int32 sums (row-major).
extern "C" int probe_dot_i8(const void* A, const void* B, int M, int N,
                            int64_t K, void* C, void* stream) {
  int splits = 1;
  const dim3 grid = split_grid(M, N, K, kIBK, &splits);
  const auto a = static_cast<const int8_t*>(A);
  const auto b = static_cast<const int8_t*>(B);
  const bool vec = K % 16 == 0 && N % 8 == 0 && aligned(A, 16) &&
                   aligned(B, 8);
  auto kernel = vec ? imma_kernel<true> : imma_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, M, N, K, splits, static_cast<int*>(C));
  return static_cast<int>(cudaGetLastError());
}

// C [M, N] += A [M, K] x B [K, N], f32 (row-major).
extern "C" int probe_dot_f32(const void* A, const void* B, int M, int N,
                             int64_t K, void* C, void* stream) {
  int splits = 1;
  const dim3 grid = split_grid(M, N, K, kFBK, &splits);
  const auto a = static_cast<const float*>(A);
  const auto b = static_cast<const float*>(B);
  const bool vec = K % 4 == 0 && N % 4 == 0 && aligned(A, 16) &&
                   aligned(B, 16);
  auto kernel = vec ? sgemm_kernel<true> : sgemm_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kFSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kFSmem, static_cast<cudaStream_t>(stream)>>>(
      a, b, M, N, K, splits, static_cast<float*>(C));
  return static_cast<int>(cudaGetLastError());
}

// out[i] = x[i] > threshold ? 1 : 0, int16 in, f32 out.
extern "C" int probe_compare_i16(const void* x, int64_t n, int threshold,
                                 void* out, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  compare_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), n, threshold, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
