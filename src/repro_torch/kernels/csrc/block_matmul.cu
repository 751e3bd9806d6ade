// C = A @ B in fp32 on CUDA cores (FFMA, not TF32): the chain GEMM.
//
// Replaces: src/repro/kernels/block_matmul.py `block_matmul` (Pallas
// `_matmul_kernel`, pallas_call at :67), reached on the chain through
// core/distmatrix.py `_local_dot`.
//
// Bound on an H100: operations.  A chain GEMM at n=10512 is 2 n^3 = 2.3
// TFLOP against 1.3 GB of operands; at the 67 TFLOP/s fp32 peak that is
// ~35 ms against ~0.4 ms of HBM traffic.  The chain raises S~ to S~^(2^d),
// so rounding is amplified 2^d-fold and the tensor cores' TF32 is not an
// option: the kernel runs full-precision FFMA.
//
// Design: a classic register-blocked SIMT GEMM.  A 128x128 output tile per
// 256-thread block, 8x8 outputs per thread, K walked in steps of 16 through
// double-buffered shared memory (the next K-slab is fetched into registers
// while the current one is multiplied), so each element loaded from HBM/L2
// feeds 128 FMAs.  Ragged edges (n=10512 is not a multiple of 128) are masked
// on load (zero fill) and on store.  Each output is summed over k in
// ascending order by one thread: no atomics, bitwise repeatable.  bf16
// inputs are widened to fp32 on their way into shared memory.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int A_LOADS = BM * BK / THREADS;  // 8 elements of A per thread per slab
constexpr int B_LOADS = BK * BN / THREADS;  // 8 elements of B per thread per slab
constexpr int A_PAD = 4;                    // keeps the transposed A stores off one bank

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ C,
                    int M, int N, int K) {
  __shared__ __align__(16) float As[2][BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float ra[A_LOADS];
  float rb[B_LOADS];

  auto load_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int gr = row0 + r;
      const int gc = k0 + c;
      ra[i] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int gr = k0 + r;
      const int gc = col0 + c;
      rb[i] = (gr < K && gc < N) ? to_f32(B[(size_t)gr * N + gc]) : 0.0f;
    }
  };

  auto store_slab = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int e = tid + i * THREADS;
      As[buf][e % BK][e / BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int e = tid + i * THREADS;
      Bs[buf][e / BN][e % BN] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int n_slabs = (K + BK - 1) / BK;
  load_slab(0);
  store_slab(0);
  __syncthreads();

  for (int t = 0; t < n_slabs; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_slabs;
    if (more) load_slab((t + 1) * BK);  // in flight while this slab is multiplied

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    if (more) store_slab(cur ^ 1);  // the other buffer was last read before the previous barrier
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c < N) C[(size_t)r * N + c] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int m, int n, int k, void* stream) {
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  block_matmul_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_block_matmul_f32(const void* a, const void* b, void* c, int m, int n, int k,
                                   void* stream) {
  return launch<float>(a, b, c, m, n, k, stream);
}

extern "C" int rt_block_matmul_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                    void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, stream);
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
