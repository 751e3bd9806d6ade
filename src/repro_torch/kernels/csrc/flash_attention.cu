// Flash attention: online-softmax attention without the (S, T) score matrix.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (Pallas
// `_flash_kernel` :28, pallas_call at :90).  Same function: q (BHq, S, D),
// k/v (BHkv, T, D), q scaled by 1/sqrt(D) before the product, causal mask
// q_pos >= k_pos counted from 0, fp32 statistics, fully masked KV tiles
// skipped, the output normalised once by max(l, 1e-30) and stored in q's
// type.  GQA is one integer: q head h reads KV head h / groups, which is
// the TPU kernel applied to K/V repeated per group, i.e. what the model's
// `_chunked_flash` computes.
//
// Bound on an H100: operations.  Dense causal prefill of qwen2-1.5b (q
// 48 x 1024 x 128, k/v 8 x 1024 x 128, bf16) is ~12.9 GFLOP of products,
// ~0.013 ms at the 989 TFLOP/s bf16 tensor-core rate, against ~17 MB of
// operands (~0.005 ms of HBM).
//
// Design (a simple kernel first; tensor cores are a later change).  One
// block of 256 threads per (q head, tile of 64 q rows).  The scaled Q tile
// and each 64-row K/V tile are widened to fp32 in shared memory (~113 KB at
// D = 128, so the launch raises the dynamic shared-memory limit); the block
// loops over the K/V tiles up to the q tile's last row under `causal` and
// all of them otherwise.  Thread (ti, tj) owns q rows 4ti..4ti+3: for the
// scores it computes columns tj + 16b (b < 4) with FFMA on CUDA cores, the
// 16 threads of a row reduce its max and sum with shuffles, P goes through
// shared memory, and the same thread keeps the rows' output accumulators
// (columns tj + 16c, c < 8) in registers, so the running max, sum and
// rescale never leave registers.  Rows and keys past S and T are masked.
// Heavy causal tiles (late q rows) are issued first.  No atomics; every sum
// runs in a fixed order, so two runs are bitwise equal.
#include "common.cuh"

namespace {

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;  // 16 x 16: (ti, tj)
constexpr int FA_DMAX = 128;
constexpr int FA_CMAX = FA_DMAX / 16;  // output columns per thread
constexpr float FA_NEG_INF = -1e30f;

size_t fa_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(FA_BQ + FA_BK) * (d + 1) + (size_t)FA_BK * d +
                          (size_t)FA_BQ * (FA_BK + 1));
}

template <typename T, int DC>  // DC > 0: the head dim at compile time; 0: d_rt
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int s_len, int t_len, int d_rt, int groups, int causal,
             float scale) {
  const int D = DC > 0 ? DC : d_rt;
  const int ldk = D + 1;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                    // BQ x ldk, scaled
  float* ks = qs + FA_BQ * ldk;      // BK x ldk
  float* vs = ks + FA_BK * ldk;      // BK x D
  float* ps = vs + FA_BK * D;        // BQ x (BK + 1)

  const int tid = threadIdx.x;
  const int ti = tid >> 4, tj = tid & 15;
  const size_t h = blockIdx.y;
  const size_t hk = h / groups;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FA_BQ;
  const T* qh = q + h * s_len * D;
  const T* kh = k + hk * t_len * D;
  const T* vh = v + hk * t_len * D;

  for (int e = tid; e < FA_BQ * D; e += FA_THREADS) {
    const int i = e / D, c = e - i * D;
    const int row = q0 + i;
    qs[i * ldk + c] = row < s_len ? to_f32(qh[(size_t)row * D + c]) * scale : 0.0f;
  }

  float m_i[4], l_i[4], acc[4][FA_CMAX];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = FA_NEG_INF;
    l_i[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < FA_CMAX; ++c) acc[a][c] = 0.0f;
  }

  const int kv_end = causal ? min(t_len, q0 + FA_BQ) : t_len;
  for (int k0 = 0; k0 < kv_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile's K, V and P are consumed (and Q is staged)
    for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
      const int j = e / D, c = e - j * D;
      const bool ok = k0 + j < t_len;
      const size_t g = (size_t)(k0 + j) * D + c;
      ks[j * ldk + c] = ok ? to_f32(kh[g]) : 0.0f;
      vs[j * D + c] = ok ? to_f32(vh[g]) : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = qs[(4 * ti + a) * ldk + c];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = ks[(tj + 16 * b) * ldk + c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sc[a][b] = fmaf(qa[a], kb[b], sc[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + 4 * ti + a;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kpos = k0 + tj + 16 * b;
        const bool ok = kpos < t_len && (!causal || qpos >= kpos);
        sc[a][b] = ok ? sc[a][b] : FA_NEG_INF;
        mx = fmaxf(mx, sc[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[a], mx);
      float sum = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(sc[a][b] - m_new);
        ps[(4 * ti + a) * (FA_BK + 1) + tj + 16 * b] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_i[a] - m_new);
      l_i[a] = alpha * l_i[a] + sum;
      m_i[a] = m_new;
#pragma unroll
      for (int c = 0; c < FA_CMAX; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(4 * ti + a) * (FA_BK + 1) + j];
#pragma unroll
      for (int c = 0; c < FA_CMAX; ++c) {
        const int col = tj + 16 * c;
        if (col < D) {
          const float vv = vs[j * D + col];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pa[a], vv, acc[a][c]);
        }
      }
    }
  }

  T* oh = o + h * s_len * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + 4 * ti + a;
    if (row >= s_len) continue;
    const float inv = 1.0f / fmaxf(l_i[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < FA_CMAX; ++c) {
      const int col = tj + 16 * c;
      if (col < D) oh[(size_t)row * D + col] = from_f32<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* o, int bhq, int s_len, int t_len,
           int d, int groups, int causal, float scale, void* stream) {
  const size_t smem = fa_smem_bytes(d);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_len + FA_BQ - 1) / FA_BQ, bhq);
  flash_kernel<T, DC><<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s_len, t_len, d, groups, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bhq, int s_len,
             int t_len, int d, int groups, int causal, float scale, void* stream) {
  if (d == 128)
    return launch<T, 128>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, scale, stream);
  if (d == 64)
    return launch<T, 64>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, scale, stream);
  return launch<T, 0>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, scale, stream);
}

}  // namespace

// Grid (ceil(S / 64), BHq).  The wrapper bounds d <= 128, checks that BHq =
// BHkv x groups, and checks every shape and type.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int bhq,
                                  int s_len, int t_len, int d, int groups, int causal,
                                  float scale, int bf16, void* stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, scale,
                                   stream);
  return dispatch<float>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, scale, stream);
}
