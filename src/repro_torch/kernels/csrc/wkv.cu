// RWKV6 WKV recurrence (chunked linear attention with per-channel decay).
//
// Replaces: src/repro/kernels/wkv.py `wkv` (Pallas `_wkv_kernel`, pallas_call
// at :81), and computes what src/repro/models/rwkv6.py `wkv_chunked` does
// (:88), the initial state s0 in and the final state out:
//
//   y_t = r_t . (S + diag(u) k_t v_t^T)        S <- diag(w_t) S + k_t v_t^T
//
// with w_t = exp(lw_t), lw <= 0.  Layout: r/k/lw (BH, S, dk), v (BH, S, dv),
// u (BH, dk), s0 and s_final (BH, dk, dv) fp32; r/k/v/y fp32 or bf16, lw
// fp32; dk, dv <= 64.
//
// Bound on an H100: bytes.  At rwkv6-3b's prefill (BH = 4 x 40, S = 1024,
// 64 x 64 heads) the kernel moves ~0.13 GB (r/k/v/y bf16, lw fp32) in
// ~0.04 ms at 3.35 TB/s, against ~2.7 GFLOP of recurrence.
//
// Design.  The TPU grid walks the chunks of one (batch, head) in order and
// carries the state in VMEM; Hopper's blocks run in no order, so one block
// owns one (batch, head) and loops over its chunks.  The (dk, dv) fp32 state
// (16 KB) stays in shared memory for the whole sequence; each chunk of
// WKV_C rows stages r, k, v and the inclusive cumulative log decay `cum` in
// shared memory, then
//   1. A[t][i] = sum_c r_t[c] k_i[c] exp(cum_{t-1}[c] - cum_i[c])  (i < t),
//      A[t][t] = sum_c r_t[c] u[c] k_t[c]                          (bonus);
//   2. y_t = sum_{i<=t} A[t][i] v_i + (r_t (.) exp(cum_{t-1})) . S;
//   3. S <- diag(exp(cum_last)) S + sum_i (k_i (.) exp(cum_last - cum_i)) v_i^T.
// Step 1 takes the decay ratio pairwise, as one exponent that is <= 0,
// instead of the TPU kernel's factorized exp(cum_{t-1}) * exp(-cum_i): the
// factorized form overflows or cancels once |cum| within a chunk passes ~30
// (src/repro/kernels/wkv.py:17-21), the pairwise one never does, so the
// chunk can be any length at any decay.  It costs one exp per (t, i, c)
// triple, which a chunk of 32 rows keeps to 16 per element of r.  Every
// product reads its operands from shared memory (one load per FMA), which
// bounds this simple form well above the bytes bound; register tiles or
// tensor cores are a later change.  A prompt
// the chunk does not divide is masked: rows past S load r = k = v = 0 and
// lw = 0, which leave y's valid rows and the state untouched.  No atomics;
// every sum runs in a fixed order, so two runs are bitwise equal.
#include "common.cuh"

namespace {

constexpr int WKV_C = 32;        // rows per chunk
constexpr int WKV_DMAX = 64;     // widest head
constexpr int WKV_LD = WKV_DMAX + 1;  // padded row stride: lanes hit distinct banks
constexpr int WKV_THREADS = 256;

constexpr size_t wkv_smem_bytes() {
  return sizeof(float) * (4 * WKV_C * WKV_LD + WKV_DMAX * WKV_LD + WKV_C * (WKV_C + 1) +
                          WKV_DMAX);
}

template <typename T>
__global__ void __launch_bounds__(WKV_THREADS)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ lw, const float* __restrict__ u,
           const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ s_fin,
           int s_len, int dk, int dv) {
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                        // C x LD: r, then r (.) exp(cum_{t-1})
  float* ks = rs + WKV_C * WKV_LD;       // C x LD: k, then k (.) exp(cum_last - cum_i)
  float* vs = ks + WKV_C * WKV_LD;       // C x LD: v
  float* cs = vs + WKV_C * WKV_LD;       // C x LD: lw, then its inclusive cumsum
  float* st = cs + WKV_C * WKV_LD;       // DMAX x LD: the state S[c][j]
  float* as = st + WKV_DMAX * WKV_LD;    // C x (C + 1): intra-chunk scores
  float* us = as + WKV_C * (WKV_C + 1);  // DMAX: the bonus u

  const int tid = threadIdx.x;
  const size_t bh = blockIdx.x;
  const T* rh = r + bh * s_len * dk;
  const T* kh = k + bh * s_len * dk;
  const T* vh = v + bh * s_len * dv;
  const float* lh = lw + bh * s_len * dk;
  T* yh = y + bh * s_len * dv;

  for (int e = tid; e < dk * dv; e += WKV_THREADS) {
    const int c = e / dv, j = e - c * dv;
    st[c * WKV_LD + j] = s0 != nullptr ? s0[bh * dk * dv + e] : 0.0f;
  }
  for (int c = tid; c < dk; c += WKV_THREADS) us[c] = u[bh * dk + c];

  for (int c0 = 0; c0 < s_len; c0 += WKV_C) {
    const int rows = min(WKV_C, s_len - c0);
    __syncthreads();  // the previous chunk is done with the tiles (and the state is seeded)
    for (int e = tid; e < WKV_C * dk; e += WKV_THREADS) {
      const int t = e / dk, c = e - t * dk;
      const bool ok = t < rows;
      const size_t g = (size_t)(c0 + t) * dk + c;
      rs[t * WKV_LD + c] = ok ? to_f32(rh[g]) : 0.0f;
      ks[t * WKV_LD + c] = ok ? to_f32(kh[g]) : 0.0f;
      cs[t * WKV_LD + c] = ok ? lh[g] : 0.0f;
    }
    for (int e = tid; e < WKV_C * dv; e += WKV_THREADS) {
      const int t = e / dv, j = e - t * dv;
      vs[t * WKV_LD + j] = t < rows ? to_f32(vh[(size_t)(c0 + t) * dv + j]) : 0.0f;
    }
    __syncthreads();
    if (tid < dk) {  // inclusive cumulative log decay down each column
      float acc = 0.0f;
      for (int t = 0; t < WKV_C; ++t) {
        acc += cs[t * WKV_LD + tid];
        cs[t * WKV_LD + tid] = acc;
      }
    }
    __syncthreads();

    // 1. intra-chunk scores, pairwise decay; the bonus on the diagonal
    for (int e = tid; e < WKV_C * WKV_C; e += WKV_THREADS) {
      const int t = e / WKV_C, i = e - t * WKV_C;
      float a = 0.0f;
      if (i < t) {
        const float* rt = rs + t * WKV_LD;
        const float* ki = ks + i * WKV_LD;
        const float* ct = cs + (t - 1) * WKV_LD;
        const float* ci = cs + i * WKV_LD;
        for (int c = 0; c < dk; ++c) a = fmaf(rt[c] * ki[c], expf(ct[c] - ci[c]), a);
      } else if (i == t) {
        const float* rt = rs + t * WKV_LD;
        const float* kt = ks + t * WKV_LD;
        for (int c = 0; c < dk; ++c) a = fmaf(rt[c] * us[c], kt[c], a);
      }
      as[t * (WKV_C + 1) + i] = a;
    }
    __syncthreads();

    // decay r to the chunk start and k to the chunk end, in place
    const float* clast = cs + (WKV_C - 1) * WKV_LD;
    for (int e = tid; e < WKV_C * dk; e += WKV_THREADS) {
      const int t = e / dk, c = e - t * dk;
      const float cex = t > 0 ? cs[(t - 1) * WKV_LD + c] : 0.0f;
      rs[t * WKV_LD + c] *= expf(cex);
      ks[t * WKV_LD + c] *= expf(clast[c] - cs[t * WKV_LD + c]);
    }
    __syncthreads();

    // 2. outputs: intra-chunk part plus the carried state's part
    for (int e = tid; e < rows * dv; e += WKV_THREADS) {
      const int t = e / dv, j = e - t * dv;
      float acc = 0.0f;
      const float* at = as + t * (WKV_C + 1);
      for (int i = 0; i <= t; ++i) acc = fmaf(at[i], vs[i * WKV_LD + j], acc);
      const float* rt = rs + t * WKV_LD;
      for (int c = 0; c < dk; ++c) acc = fmaf(rt[c], st[c * WKV_LD + j], acc);
      yh[(size_t)(c0 + t) * dv + j] = from_f32<T>(acc);
    }
    __syncthreads();

    // 3. state update
    for (int e = tid; e < dk * dv; e += WKV_THREADS) {
      const int c = e / dv, j = e - c * dv;
      float acc = st[c * WKV_LD + j] * expf(clast[c]);
      for (int i = 0; i < WKV_C; ++i) acc = fmaf(ks[i * WKV_LD + c], vs[i * WKV_LD + j], acc);
      st[c * WKV_LD + j] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * dv; e += WKV_THREADS) {
    const int c = e / dv, j = e - c * dv;
    s_fin[bh * dk * dv + e] = st[c * WKV_LD + j];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* y, void* s_fin, int bh, int s_len, int dk, int dv,
           void* stream) {
  const size_t smem = wkv_smem_bytes();
  const cudaError_t attr = cudaFuncSetAttribute(
      wkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  wkv_kernel<T><<<bh, WKV_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lw), static_cast<const float*>(u),
      static_cast<const float*>(s0), static_cast<T*>(y), static_cast<float*>(s_fin), s_len,
      dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One block per (batch, head): bh blocks.  s0 may be null (a zero state).
// The wrapper bounds dk, dv <= 64 and checks every shape and type.
extern "C" int rt_wkv(const void* r, const void* k, const void* v, const void* lw, const void* u,
                      const void* s0, void* y, void* s_fin, int bh, int s_len, int dk, int dv,
                      int bf16, void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, s_fin, bh, s_len, dk, dv, stream);
  return launch<float>(r, k, v, lw, u, s0, y, s_fin, bh, s_len, dk, dv, stream);
}
