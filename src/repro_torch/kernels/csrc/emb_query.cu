// The query read path: fused distance, von Luxburg epilogue and running
// top-k merge over one streamed Z row panel.
//
// Replaces: src/repro/kernels/emb_query.py `panel_topk_update` (Pallas
// `_panel_topk_kernel` with `_select_topk`, pallas_call at :193).
//
// Per query row q and panel row j (global id row0 + j):
//   dist2  = max(|z_q|^2 + |z_j|^2 - 2 z_q . z_j, 0)      (the TPU kernel's
//            three-term fp32 form, not |z_q - z_j|^2)
//   score  = vol * dist2,  or  dist2 - 1/deg_q - 1/deg_j  (corrected)
//   score  = worst (-inf largest, +inf smallest) at the excluded global id.
// Candidates are the running state's topk slots, then the panel's rows in
// order.  The best topk by value are kept, ties to the lower position (the
// order lax.top_k keeps), each position taken at most once.  Empty state
// slots are (worst, -1), so when fewer than topk candidates are finite the
// remaining slots come from the lowest unselected positions.  (The TPU
// kernel marks a taken position with -inf, which is also an empty slot's
// value, and takes slot 0 again once the finite candidates run out: it
// duplicates ids whenever topk > 2 * panel rows.  This kernel does not.)
//
// Bound on an H100: bytes, and far below the launch latency.  On the main
// path a launch reads one 144 x 17 panel (9.8 KB fp32, 4.9 KB as bf16 bits)
// and 2 x 20 state entries, ~3 ns of HBM time and ~10 kFLOP, while one
// launch costs microseconds whatever it does.  So the design is simple: one
// block per query row.  One warp sums |z_q|^2, threads score the panel rows
// into shared memory beside the state's values, every candidate becomes a
// 64-bit key (order-preserving bits of the value in the high half, the
// complement of its position in the low half, so larger key = better and
// ties go to the lower position), and a block-wide bitonic sort orders the
// keys.  Keys are unique, the sort network is fixed, no atomics: bitwise
// repeatable.
//
// The host keeps a per-query plan (`TopkPlan`): the query's constant
// arguments and two (q, topk) state buffers used in turn, so a panel's call
// passes only the panel, its dtype flag, its row origin and its row count.
#include "common.cuh"

namespace {

constexpr int TK_THREADS = 256;
constexpr int TK_K_MAX = 256;  // widest sketch the wrapper passes

// Float bits as an unsigned key with the same order (-0 counts as +0, so a
// zero tie goes to position order as the reference's == does).
__device__ __forceinline__ uint32_t ordered_bits(float w) {
  if (w == 0.0f) w = 0.0f;
  const uint32_t b = __float_as_uint(w);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <typename TZ>
__global__ void __launch_bounds__(TK_THREADS)
panel_topk_kernel(const float* __restrict__ run_v, const int* __restrict__ run_i,
                  const float* __restrict__ zq, const TZ* __restrict__ zp,
                  const float* __restrict__ idq, const float* __restrict__ idp, float vol,
                  int row0, const int* __restrict__ ex, float* __restrict__ out_v,
                  int* __restrict__ out_i, int ph, int k, int topk, int npow2, int corrected,
                  int largest) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // npow2
  float* vals = reinterpret_cast<float*>(keys + npow2);                    // topk + ph
  float* zqs = vals + (topk + ph);                                         // k
  __shared__ float sq_q_s;

  const int tid = threadIdx.x;
  const size_t q = blockIdx.x;
  const int ncand = topk + ph;
  for (int c = tid; c < k; c += TK_THREADS) zqs[c] = zq[q * k + c];
  __syncthreads();
  if (tid < RT_WARP) {  // |z_q|^2: lane-strided sums, then a butterfly
    float s = 0.0f;
    for (int c = tid; c < k; c += RT_WARP) s = fmaf(zqs[c], zqs[c], s);
#pragma unroll
    for (int off = RT_WARP / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tid == 0) sq_q_s = s;
  }
  for (int p = tid; p < topk; p += TK_THREADS) vals[p] = run_v[q * topk + p];
  __syncthreads();

  const float sq_q = sq_q_s;
  const float worst = __uint_as_float(largest ? 0xff800000u : 0x7f800000u);  // -inf / +inf
  const int exclude = ex[q];
  const float inv_q = idq[q];
  for (int j = tid; j < ph; j += TK_THREADS) {
    const TZ* zr = zp + (size_t)j * k;
    float sq_j = 0.0f, dot = 0.0f;
    for (int c = 0; c < k; ++c) {
      const float v = to_f32(zr[c]);
      sq_j = fmaf(v, v, sq_j);
      dot = fmaf(zqs[c], v, dot);
    }
    const float dist2 = fmaxf(sq_q + sq_j - 2.0f * dot, 0.0f);
    float s = corrected ? (dist2 - inv_q) - idp[j] : vol * dist2;
    if (row0 + j == exclude) s = worst;
    vals[topk + j] = s;
  }
  __syncthreads();

  for (int p = tid; p < npow2; p += TK_THREADS) {
    unsigned long long key = 0ull;  // padding: below every candidate
    if (p < ncand) {
      const float w = largest ? vals[p] : -vals[p];
      key = (static_cast<unsigned long long>(ordered_bits(w)) << 32) | (~static_cast<uint32_t>(p));
    }
    keys[p] = key;
  }
  __syncthreads();

  // Bitonic sort of the keys, descending.
  for (int size = 2; size <= npow2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < npow2; i += TK_THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i], b = keys[j];
          if (((i & size) == 0) ? (a < b) : (a > b)) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int r = tid; r < topk; r += TK_THREADS) {
    const int p = static_cast<int>(~static_cast<uint32_t>(keys[r]));
    out_v[q * topk + r] = vals[p];
    out_i[q * topk + r] = p < topk ? run_i[q * topk + p] : row0 + (p - topk);
  }
}

// The per-query plan the host keeps (repro_torch.kernels.emb_query._TopkPlan
// mirrors this layout): the state is read from vals/ids[cur] and written to
// vals/ids[cur ^ 1], then cur flips.  idp holds 1/deg of global rows
// idp_row0, idp_row0 + 1, ...
struct TopkPlan {
  void* vals[2];
  void* ids[2];
  const void* zq;
  const void* idq;
  const void* idp;
  const void* ex;
  void* stream;
  float vol;
  int idp_row0;
  int nq, k, topk, corrected, largest, cur;
};

template <typename TZ>
int launch(const TopkPlan& p, const void* zp, int row0, int ph) {
  const cudaStream_t s = static_cast<cudaStream_t>(p.stream);
  const float* run_v = static_cast<const float*>(p.vals[p.cur]);
  const int* run_i = static_cast<const int*>(p.ids[p.cur]);
  float* out_v = static_cast<float*>(p.vals[p.cur ^ 1]);
  int* out_i = static_cast<int*>(p.ids[p.cur ^ 1]);
  const float* zq = static_cast<const float*>(p.zq);
  const float* idq = static_cast<const float*>(p.idq);
  const float* idp = static_cast<const float*>(p.idp) + (row0 - p.idp_row0);
  const int* ex = static_cast<const int*>(p.ex);
  const TZ* z = static_cast<const TZ*>(zp);
  int npow2 = 1;
  while (npow2 < p.topk + ph) npow2 <<= 1;
  const size_t smem = (size_t)npow2 * sizeof(unsigned long long) +
                      (size_t)(p.topk + ph + p.k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        panel_topk_kernel<TZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  panel_topk_kernel<TZ><<<p.nq, TK_THREADS, smem, s>>>(
      run_v, run_i, zq, z, idq, idp, p.vol, row0, ex, out_v, out_i, ph, p.k, p.topk, npow2,
      p.corrected, p.largest);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch per (panel, plan): nq blocks.  The wrapper bounds topk + ph
// (shared memory) and k (the query row is staged in shared memory).
extern "C" int rt_panel_topk_step(void* plan, const void* zp, int zp_bits, int row0, int ph) {
  TopkPlan& p = *static_cast<TopkPlan*>(plan);
  if (p.k < 1 || p.k > TK_K_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int err = zp_bits ? launch<uint16_t>(p, zp, row0, ph) : launch<float>(p, zp, row0, ph);
  if (err == 0) p.cur ^= 1;
  return err;
}
