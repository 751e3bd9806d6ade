// The fp32 SIMT GEMM tile loop shared by block_matmul.cu and stream_gemm.cu:
//   C = init + sign * (A @ B)      (init optional, sign +-1)
// with A and B each fp32, bf16, or bf16 bit patterns carried as 16-bit
// integers (widened exactly: the bits become the high half of a float32).
//
// A 128x128 output tile per 256-thread block, 8x8 outputs per thread, K
// walked in steps of 16 through double-buffered shared memory (the next
// K-slab is fetched into registers while the current one is multiplied), so
// each element loaded from HBM/L2 feeds 128 FMAs.  Operands are widened to
// fp32 on their way into shared memory.  Ragged edges are masked on load
// (zero fill) and on store.  Each output is summed over k in ascending order
// by one thread and the epilogue reads init at the same index it writes:
// no atomics, bitwise repeatable, and C may alias init.
#pragma once

#include "common.cuh"

namespace {

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 128;
constexpr int GEMM_BK = 16;
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_A_LOADS = GEMM_BM * GEMM_BK / GEMM_THREADS;  // A elements per thread per slab
constexpr int GEMM_B_LOADS = GEMM_BK * GEMM_BN / GEMM_THREADS;  // B elements per thread per slab
constexpr int GEMM_A_PAD = 4;  // keeps the transposed A stores off one bank

template <typename TA, typename TB>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const TA* __restrict__ A, const TB* __restrict__ B, const float* init, float* C,
            int M, int N, int K, bool neg) {
  __shared__ __align__(16) float As[2][GEMM_BK][GEMM_BM + GEMM_A_PAD];
  __shared__ __align__(16) float Bs[2][GEMM_BK][GEMM_BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * GEMM_BM;
  const int col0 = blockIdx.x * GEMM_BN;

  float ra[GEMM_A_LOADS];
  float rb[GEMM_B_LOADS];

  auto load_slab = [&](int k0) {
#pragma unroll
    for (int i = 0; i < GEMM_A_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int r = e / GEMM_BK;
      const int c = e % GEMM_BK;
      const int gr = row0 + r;
      const int gc = k0 + c;
      ra[i] = (gr < M && gc < K) ? to_f32(A[(size_t)gr * K + gc]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < GEMM_B_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      const int r = e / GEMM_BN;
      const int c = e % GEMM_BN;
      const int gr = k0 + r;
      const int gc = col0 + c;
      rb[i] = (gr < K && gc < N) ? to_f32(B[(size_t)gr * N + gc]) : 0.0f;
    }
  };

  auto store_slab = [&](int buf) {
#pragma unroll
    for (int i = 0; i < GEMM_A_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      As[buf][e % GEMM_BK][e / GEMM_BK] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < GEMM_B_LOADS; ++i) {
      const int e = tid + i * GEMM_THREADS;
      Bs[buf][e / GEMM_BN][e % GEMM_BN] = rb[i];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int n_slabs = (K + GEMM_BK - 1) / GEMM_BK;
  load_slab(0);
  store_slab(0);
  __syncthreads();

  for (int t = 0; t < n_slabs; ++t) {
    const int cur = t & 1;
    const bool more = t + 1 < n_slabs;
    if (more) load_slab((t + 1) * GEMM_BK);  // in flight while this slab is multiplied

#pragma unroll
    for (int kk = 0; kk < GEMM_BK; ++kk) {
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
      if (c < N) {
        const size_t idx = (size_t)r * N + c;
        float v = acc[i][j];
        if (init != nullptr) {
          v = neg ? init[idx] - v : init[idx] + v;
        } else if (neg) {
          v = -v;
        }
        C[idx] = v;
      }
    }
  }
}

template <typename TA, typename TB>
int launch_gemm(const void* a, const void* b, const void* init, void* c, int m, int n, int k,
                bool neg, void* stream) {
  dim3 grid((n + GEMM_BN - 1) / GEMM_BN, (m + GEMM_BM - 1) / GEMM_BM);
  gemm_kernel<TA, TB><<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<const float*>(init),
      static_cast<float*>(c), m, n, k, neg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
