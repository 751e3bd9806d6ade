// The out-of-core hot path: the streaming panel GEMM and the fused solve pass.
//
// Replaces: src/repro/kernels/stream_gemm.py `stream_gemm` (Pallas
// `_stream_gemm_kernel` / `_stream_gemm_init_kernel`, pallas_call at :144)
// and `fused_panel_matvec` (`_fused_matvec_kernel`, pallas_call at :229).
//
// Both take operands in the store's *stored* form: fp32, or bf16 bit
// patterns (uint16, carried by PyTorch as int16) widened in the kernel as
// (uint32)bits << 16 reinterpreted as float -- the exact widening of the
// host codec `_bf16_u16_to_f32`, so a bits operand gives bitwise the same
// result as its host-decoded fp32 copy.
//
// rt_stream_gemm: C = init + sign * (A @ B), init optional.
//   Bound on an H100: operations.  The chain's K step is (1314 x 1314) @
//   (1314 x 10512) = 36.3 GFLOP of fp32 FFMA, ~0.54 ms at 67 TFLOP/s,
//   against 0.11 GB of operands and output (~0.03 ms of HBM).  The chain
//   amplifies rounding 2^d-fold, so no TF32: the fp32 SIMT tile loop of
//   gemm_tile.cuh, with the decode on the way into shared memory and the
//   init/sign add in the epilogue (one launch per K step, the accumulator
//   as init).  The skinny chi-build shape (n x 17 output) runs on the same
//   tiling, most of each 128-column tile masked.
//
// rt_fused_panel_matvec: one pass over a row panel P (ph x K):
//   gy = chi + y_panel - P y,   delta = chi - P y,
//   colsum[c] = sum_rows delta[:, c],   sumsq = sum delta^2.
//   Bound on an H100: bytes.  P is read once (55 MB fp32 at ph=1314,
//   K=10512: ~0.017 ms at 3.35 TB/s; half of that as bits) against ~0.5
//   GFLOP.  One warp per row streams the row with coalesced loads; the
//   block's 8 rows share a shared-memory slab of y (256 rows x q, padded so
//   the lanes' reads hit distinct banks).  Reductions are two-stage and
//   fixed-order -- per-block partials, then one block sums them in block
//   order -- with no atomics, so CachingHandle replays are bitwise.
#include "gemm_tile.cuh"

namespace {

constexpr int FM_ROWS = 8;  // rows per block, one warp each
constexpr int FM_THREADS = FM_ROWS * RT_WARP;
constexpr int FM_KT = 256;  // y rows staged per slab
constexpr int FM_QMAX = 32;

template <typename TP>
__global__ void __launch_bounds__(FM_THREADS)
fused_matvec_kernel(const TP* __restrict__ P, const float* __restrict__ Y,
                    const float* __restrict__ CHI, const float* __restrict__ YP,
                    float* __restrict__ GY, float* __restrict__ part_cs,
                    float* __restrict__ part_ss, int ph, int K, int q) {
  __shared__ float ys[FM_KT][FM_QMAX + 1];
  __shared__ float red_cs[FM_ROWS][FM_QMAX];
  __shared__ float red_ss[FM_ROWS];

  const int lane = threadIdx.x % RT_WARP;
  const int warp = threadIdx.x / RT_WARP;
  const int row = blockIdx.x * FM_ROWS + warp;
  const bool active = row < ph;
  const TP* prow = P + (size_t)(active ? row : 0) * K;

  float acc[FM_QMAX];
#pragma unroll
  for (int c = 0; c < FM_QMAX; ++c) acc[c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FM_KT) {
    const int kt = min(FM_KT, K - k0);
    for (int e = threadIdx.x; e < kt * q; e += FM_THREADS) {
      ys[e / q][e % q] = Y[(size_t)k0 * q + e];  // rows k0.. of y are contiguous
    }
    __syncthreads();
    if (active) {
      for (int kk = lane; kk < kt; kk += RT_WARP) {
        const float p = to_f32(prow[k0 + kk]);
#pragma unroll
        for (int c = 0; c < FM_QMAX; ++c) {
          if (c < q) acc[c] = fmaf(p, ys[kk][c], acc[c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int c = 0; c < FM_QMAX; ++c) {
    if (c < q) acc[c] = rt_warp_sum(acc[c]);  // lane 0 holds P y for this row
  }
  if (lane == 0) {
    float ss = 0.0f;
#pragma unroll
    for (int c = 0; c < FM_QMAX; ++c) {
      if (c < q) {
        float d = 0.0f;
        if (active) {
          const size_t idx = (size_t)row * q + c;
          const float chi = CHI[idx];
          GY[idx] = (chi + YP[idx]) - acc[c];
          d = chi - acc[c];
        }
        red_cs[warp][c] = d;
        ss += d * d;
      }
    }
    red_ss[warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x < q) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < FM_ROWS; ++w) t += red_cs[w][threadIdx.x];
    part_cs[(size_t)blockIdx.x * q + threadIdx.x] = t;
  }
  if (threadIdx.x == 0) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < FM_ROWS; ++w) t += red_ss[w];
    part_ss[blockIdx.x] = t;
  }
}

// Second stage: thread c sums column c over the blocks in block order.
__global__ void fused_matvec_finish(const float* __restrict__ part_cs,
                                    const float* __restrict__ part_ss, float* __restrict__ cs,
                                    float* __restrict__ ss, int n_blocks, int q) {
  const int c = threadIdx.x;
  if (c < q) {
    float t = 0.0f;
    for (int b = 0; b < n_blocks; ++b) t += part_cs[(size_t)b * q + c];
    cs[c] = t;
  }
  if (c == 0) {
    float t = 0.0f;
    for (int b = 0; b < n_blocks; ++b) t += part_ss[b];
    ss[0] = t;
  }
}

}  // namespace

extern "C" int rt_stream_gemm(const void* a, int a_bits, const void* b, int b_bits,
                              const void* init, int neg, void* c, int m, int n, int k,
                              void* stream) {
  if (a_bits && b_bits) return launch_gemm<uint16_t, uint16_t>(a, b, init, c, m, n, k, neg, stream);
  if (a_bits) return launch_gemm<uint16_t, float>(a, b, init, c, m, n, k, neg, stream);
  if (b_bits) return launch_gemm<float, uint16_t>(a, b, init, c, m, n, k, neg, stream);
  return launch_gemm<float, float>(a, b, init, c, m, n, k, neg, stream);
}

// part_cs (n_blocks x q) and part_ss (n_blocks) are caller-allocated
// scratch, n_blocks = ceil(ph / 8); q <= 32.
extern "C" int rt_fused_panel_matvec(const void* p, int p_bits, const void* y, const void* chi,
                                     const void* yp, void* gy, void* part_cs, void* part_ss,
                                     void* cs, void* ss, int ph, int k, int q, void* stream) {
  const int n_blocks = (ph + FM_ROWS - 1) / FM_ROWS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* chif = static_cast<const float*>(chi);
  const float* ypf = static_cast<const float*>(yp);
  float* gyf = static_cast<float*>(gy);
  float* pcs = static_cast<float*>(part_cs);
  float* pss = static_cast<float*>(part_ss);
  if (p_bits) {
    fused_matvec_kernel<uint16_t><<<n_blocks, FM_THREADS, 0, st>>>(
        static_cast<const uint16_t*>(p), yf, chif, ypf, gyf, pcs, pss, ph, k, q);
  } else {
    fused_matvec_kernel<float><<<n_blocks, FM_THREADS, 0, st>>>(
        static_cast<const float*>(p), yf, chif, ypf, gyf, pcs, pss, ph, k, q);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_matvec_finish<<<1, FM_QMAX, 0, st>>>(pcs, pss, static_cast<float*>(cs),
                                             static_cast<float*>(ss), n_blocks, q);
  return static_cast<int>(cudaGetLastError());
}
