// Flash attention: online-softmax attention without the (S, T) score matrix.
//
// Replaces: src/repro/kernels/flash_attention.py `flash_attention` (Pallas
// `_flash_kernel` :28, pallas_call at :90).  Same function: q (BHq, S, D),
// k/v (BHkv, T, D), q scaled by 1/sqrt(D) before the product, causal mask
// q_pos + q_offset >= k_pos (both counted from 0; q_offset > 0 for a tile
// that holds the queries [q_offset, q_offset + S) of a sequence-sharded
// prompt against all T keys, 0 for a whole sequence), fp32 statistics, fully masked KV tiles
// skipped, the output normalised once by max(l, 1e-30) and stored in q's
// type.  GQA is one integer: q head h reads KV head h / groups, which is
// the TPU kernel applied to K/V repeated per group, i.e. what the model's
// `_chunked_flash` computes.
//
// Bound on an H100: operations at D = 128 (bytes at zamba2's D = 224, see
// below).  Dense causal prefill of qwen2-1.5b (q
// 48 x 1024 x 128, k/v 8 x 1024 x 128, bf16) is ~12.9 GFLOP of products,
// ~0.013 ms at the 989 TFLOP/s bf16 tensor-core rate, against ~17 MB of
// operands (~0.005 ms of HBM).
//
// Two routes, a fixed dispatch on dtype and head dim (see the wrapper):
//
// * `flash_kernel_wgmma`, bf16 q/k/v with D in {64, 128, 224} (the serve
//   path's prefill; 224 is zamba2's shared block, whose head is 2 x 3584 /
//   32 wide): both products on the tensor cores.  One block per (q head,
//   tile of 128 q rows): two consumer warpgroups of 64 rows and one producer
//   warp (a warpgroup at D = 224, below).  The producer loads the Q tile
//   once and K/V tiles of 64 keys into a ring of 2 stages by TMA (a 3-D map over (BH, S, D), so a ragged last
//   tile is zero-filled per head; 128-byte swizzle, a head of 128 as two
//   64-wide column blocks), each stage under a full and an empty mbarrier.
//   A consumer computes S = Q K^T with wgmma m64n64k16 (both operands
//   K-major in shared memory, fp32 accumulator in registers), scales S by
//   1/sqrt(D) in fp32 (log2(e) folded in, exp2f), masks causal and ragged
//   keys only on the tiles that straddle them, keeps the running max and
//   sum per row in registers (a row lives in the four threads of a quad:
//   shuffles 1 and 2), converts P to bf16 in place -- the m64n64 accumulator
//   layout is the register layout of wgmma's A operand -- and adds P V with
//   wgmma m64nDk16, A from registers and V from shared memory (MN-major,
//   the transpose flag).  P rounded to bf16 is the one departure from the
//   TPU kernel's fp32 P: at most one bf16 step of the output.  Causal tiles
//   past a warpgroup's last row are skipped; the heaviest q tiles of every
//   head are issued first.
//   D = 224 is not a multiple of the 128-byte swizzle's 64 columns, so its
//   tiles are seven 32-column boxes under the 64-byte swizzle (atoms of 8 x
//   64 bytes, SBO 512 B, LBO 4 KB between V's column blocks): no padding, and
//   each TMA box is written whole, so every expect_tx counts whole boxes.
//   Shared memory: Q 2 x 7 x 4 KB + K and V 2 stages x 7 x 4 KB each =
//   172,032 bytes (+ barriers and 1 KB of alignment slack).  P V is one
//   wgmma m64n224k16 (112 fp32 accumulators a thread) over V's seven blocks.
//   Registers: O 112 + S 32 + packed P 16 do not fit the 168 a thread that
//   ptxas grants 288 threads (it rounds a block to whole warpgroups), and
//   spilled 128 bytes; so at D = 224 the producer is a whole warpgroup that
//   setmaxnreg drops to 40 registers, and the two consumer warpgroups rise to
//   232.  ptxas -v: 168 registers at entry, 0 bytes of spill stores and loads.
//   At zamba2's prefill (q/k/v 128 x 1024 x 224, causal) the products are
//   60.2 GFLOP (0.0609 ms at 989 TFLOP/s) against 235 MB of q, k, v and o
//   (0.0701 ms at 3.35 TB/s): (S + 1) / 4 ~ 256 operations a byte, below the
//   card's ~295, so the bound is bytes.
// * `flash_kernel`, fp32 at any D, or bf16 at any other D <= 256: the SIMT
//   kernel.  One block of 256 threads per (q head, tile of 64 q rows); the
//   scaled Q tile and each 64-row K/V tile are widened to fp32 in shared
//   memory (~113 KB at D = 128, 189,184 bytes at D = 224); thread (ti, tj)
//   owns q rows 4ti..4ti+3 and computes
//   scores and ceil(D / 16) output columns with FFMA on CUDA cores (4 x 14
//   fp32 accumulators a thread at D = 224); P goes through shared memory;
//   rows and keys past S and T are masked; heavy causal tiles first.
//   Compiled for D = 64, 128 and 224, and once for any D read at run time.
//
// No atomics in either; every sum runs in a fixed order, so two runs are
// bitwise equal.
#include "hopper.cuh"

namespace {

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;  // 16 x 16: (ti, tj)
constexpr int FA_DMAX = 256;
constexpr int FA_CMAX = FA_DMAX / 16;  // output columns per thread, D read at run time
constexpr float FA_NEG_INF = -1e30f;

size_t fa_smem_bytes(int d) {
  return sizeof(float) * ((size_t)(FA_BQ + FA_BK) * (d + 1) + (size_t)FA_BK * d +
                          (size_t)FA_BQ * (FA_BK + 1));
}

template <typename T, int DC>  // DC > 0: the head dim at compile time; 0: d_rt
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int s_len, int t_len, int d_rt, int groups, int causal,
             int q_offset, float scale) {
  const int D = DC > 0 ? DC : d_rt;
  constexpr int CM = DC > 0 ? (DC + 15) / 16 : FA_CMAX;  // output columns per thread
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

  float m_i[4], l_i[4], acc[4][CM];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = FA_NEG_INF;
    l_i[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < CM; ++c) acc[a][c] = 0.0f;
  }

  const int kv_end = causal ? min(t_len, q0 + q_offset + FA_BQ) : t_len;
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
      const int qpos = q0 + q_offset + 4 * ti + a;
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
      for (int c = 0; c < CM; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < FA_BK; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(4 * ti + a) * (FA_BK + 1) + j];
#pragma unroll
      for (int c = 0; c < CM; ++c) {
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
    for (int c = 0; c < CM; ++c) {
      const int col = tj + 16 * c;
      if (col < D) oh[(size_t)row * D + col] = from_f32<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, int DC>
int launch(const void* q, const void* k, const void* v, void* o, int bhq, int s_len, int t_len,
           int d, int groups, int causal, int q_offset, float scale, void* stream) {
  const size_t smem = fa_smem_bytes(d);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((s_len + FA_BQ - 1) / FA_BQ, bhq);
  flash_kernel<T, DC><<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s_len, t_len, d, groups, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bhq, int s_len,
             int t_len, int d, int groups, int causal, int q_offset, float scale, void* stream) {
  if (d == 128)
    return launch<T, 128>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset, scale,
                          stream);
  if (d == 64)
    return launch<T, 64>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset, scale,
                         stream);
  if (d == 224)
    return launch<T, 224>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset, scale,
                          stream);
  return launch<T, 0>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset, scale, stream);
}

// ---------------------------------------------------------------------------
// Tensor-core route: bf16, D in {64, 128, 224}.
// ---------------------------------------------------------------------------

constexpr int TC_WG_ROWS = 64;                  // q rows of a consumer warpgroup
constexpr int TC_NWG = 2;                       // consumer warpgroups
constexpr int TC_BQ = TC_WG_ROWS * TC_NWG;      // q rows of a block
constexpr int TC_BK = 64;                       // keys of a K/V tile
constexpr int TC_NST = 2;                       // K/V ring stages
constexpr float TC_LOG2E = 1.4426950408889634f;
constexpr int TC_PRODUCER_REGS = 40;   // D = 224: the producer warpgroup's registers a thread
constexpr int TC_CONSUMER_REGS = 232;  // and the consumers' (128 x 40 + 256 x 232 <= 65,536)

// The shape of the route at head dim D.  A head's column blocks are each one
// TMA box of 64 rows: 64 columns under the 128-byte swizzle where D is a
// multiple of 64, else 32 columns under the 64-byte swizzle (D = 224: seven
// blocks, no padding).  The producer is one warp at D 64 and 128; at 224 it
// is a whole warpgroup, so that setmaxnreg can hand its registers to the
// consumers (REG_SPLIT).
template <int D>
struct TcHead {
  static constexpr int W = D % 64 == 0 ? 64 : 32;  // columns of a block
  static constexpr int N = D / W;                  // blocks of a head
  static constexpr int BOX = 64 * W;               // bf16 of one 64-row block
  static constexpr uint32_t ATOM = 8 * W * 2;      // bytes of eight rows: a swizzle atom (SBO)
  static constexpr int KSTEPS = W / 16;            // k16 slices of a block's row
  static constexpr bool REG_SPLIT = D > 128;
  static constexpr int THREADS = 128 * TC_NWG + (REG_SPLIT ? 128 : 32);
  static_assert(D == 64 || D == 128 || D == 224, "the tensor-core route takes D 64, 128, 224");
};

template <int D>
struct TcSmem {
  using C = TcHead<D>;
  __nv_bfloat16 q[TC_NWG][C::N][C::BOX];  // [warpgroup][column block][64 rows x W]
  __nv_bfloat16 k[TC_NST][C::N][C::BOX];  // [stage][column block][64 keys x W]
  __nv_bfloat16 v[TC_NST][C::N][C::BOX];
  uint64_t q_full;
  uint64_t kv_full[TC_NST];
  uint64_t kv_empty[TC_NST];
};

// The wgmma descriptor of a block (the swizzle the TMA map wrote it with).
template <int D>
__device__ __forceinline__ uint64_t tc_desc(const __nv_bfloat16* p, uint32_t lbo_bytes) {
  if constexpr (TcHead<D>::W == 64) {
    return rt_desc_sw128(p, lbo_bytes, TcHead<D>::ATOM);
  } else {
    return rt_desc_sw64(p, lbo_bytes, TcHead<D>::ATOM);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void pv_mma(float (&acc)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    rt_wgmma_m64n64k16_bf16_rs_tb(acc, a, db, 1);
  } else if constexpr (D == 128) {
    rt_wgmma_m64n128k16_bf16_rs_tb(acc, a, db, 1);
  } else {
    static_assert(D == 224, "P V has a product for D 64, 128 and 224 only");
    rt_wgmma_m64n224k16_bf16_rs_tb(acc, a, db, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(TcHead<D>::THREADS, 1)
flash_kernel_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                   int s_len, int t_len, int groups, int causal, int q_offset, float scale) {
  using C = TcHead<D>;
  extern __shared__ uint8_t smem_raw[];
  TcSmem<D>& sm = *reinterpret_cast<TcSmem<D>*>(rt_smem_align1024(smem_raw));
  const int h = blockIdx.x;
  const int hk = h / groups;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;  // heavy causal tiles of every head first
  const int kv_end = causal ? min(t_len, q0 + q_offset + TC_BQ) : t_len;
  const int n_tiles = (kv_end + TC_BK - 1) / TC_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    rt_mbar_init(&sm.q_full, 1);
    for (int s = 0; s < TC_NST; ++s) {
      rt_mbar_init(&sm.kv_full[s], 1);
      rt_mbar_init(&sm.kv_empty[s], 4 * TC_NWG);  // one arrival per consumer warp
    }
    rt_fence_mbar_init();
  }
  __syncthreads();

  if (warp >= 4 * TC_NWG) {  // producer
    if constexpr (C::REG_SPLIT) rt_setmaxnreg_dec<TC_PRODUCER_REGS>();
    if (warp == 4 * TC_NWG && lane == 0) {
      // the bytes TMA writes: whole boxes, zero-filled rows past S or T included
      rt_mbar_expect_tx(&sm.q_full, sizeof(sm.q));
      for (int w = 0; w < TC_NWG; ++w)
        for (int c = 0; c < C::N; ++c)
          rt_tma_load_3d(sm.q[w][c], &tq, &sm.q_full, C::W * c, q0 + TC_WG_ROWS * w, h);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % TC_NST;
        if (it >= TC_NST) rt_mbar_wait(&sm.kv_empty[st], ((it / TC_NST) - 1) & 1);
        rt_mbar_expect_tx(&sm.kv_full[st], sizeof(sm.k[st]) + sizeof(sm.v[st]));
        for (int c = 0; c < C::N; ++c) {
          rt_tma_load_3d(sm.k[st][c], &tk, &sm.kv_full[st], C::W * c, it * TC_BK, hk);
          rt_tma_load_3d(sm.v[st][c], &tv, &sm.kv_full[st], C::W * c, it * TC_BK, hk);
        }
      }
    }
    return;
  }
  if constexpr (C::REG_SPLIT) rt_setmaxnreg_inc<TC_CONSUMER_REGS>();

  const int wg = warp / 4;
  const int wq0 = q0 + TC_WG_ROWS * wg;  // the warpgroup's first q row
  const int wqp = wq0 + q_offset;         // and its position among the keys
  const int wkv_end = causal ? min(t_len, wqp + TC_WG_ROWS) : t_len;
  const int row_in = 16 * (warp % 4) + lane / 4;  // + 8 hh: this thread's two rows
  const int col_in = 2 * (lane % 4);              // + 8 j + e: its columns
  const float sl2 = scale * TC_LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  rt_mbar_wait(&sm.q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % TC_NST;
    rt_mbar_wait(&sm.kv_full[st], (it / TC_NST) & 1);
    __syncwarp();
    const int k0 = it * TC_BK;
    if (k0 < wkv_end) {  // uniform over the warpgroup
      // S = Q K^T (unscaled), fp32 in registers
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      rt_fence_regs(s);
      rt_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // 16 bf16 = 32 bytes of a block's row
        const int cb = kk / C::KSTEPS, k16 = 16 * (kk % C::KSTEPS);
        const uint64_t da = tc_desc<D>(&sm.q[wg][cb][0] + k16, 16);
        const uint64_t db = tc_desc<D>(&sm.k[st][cb][0] + k16, 16);
        rt_wgmma_m64n64k16_bf16_ss(s, da, db, kk > 0);
      }
      rt_wgmma_commit();
      rt_wgmma_wait<0>();
      rt_fence_regs(s);

      if (k0 + TC_BK > t_len || (causal && k0 + TC_BK - 1 > wqp)) {  // a straddling tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i / 4) + col_in + (i % 2);
          const int qpos = wqp + row_in + 8 * ((i / 2) % 2);
          if (key >= t_len || (causal && qpos < key)) s[i] = -INFINITY;
        }
      }

      // online softmax: p = exp2((s - m) * scale * log2 e), in place
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[hh], mx);
        const float base = m_new == -INFINITY ? 0.0f : m_new * sl2;
        const float alpha = exp2f(m_run[hh] * sl2 - base);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < TC_BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(fmaf(s[4 * j + 2 * hh + e], sl2, -base));
            s[4 * j + 2 * hh + e] = p;
            sum += p;
          }
        }
        l_run[hh] = alpha * l_run[hh] + sum;
        m_run[hh] = m_new;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * hh] *= alpha;
          acc[4 * j + 2 * hh + 1] *= alpha;
        }
      }

      // O += P V: P (bf16) from registers, V from shared memory (MN-major)
      uint32_t pa[TC_BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        rt_fence_regs(pa[kk]);
      }
      rt_fence_regs(acc);
      rt_wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {  // 16 keys = 16 rows of every block
        const uint64_t db = tc_desc<D>(&sm.v[st][0][0] + 16 * C::W * kk,
                                       C::BOX * sizeof(__nv_bfloat16));
        pv_mma<D>(acc, pa[kk], db);
      }
      rt_wgmma_commit();
      rt_wgmma_wait<0>();
      rt_fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) rt_mbar_arrive(&sm.kv_empty[st]);
  }

  __nv_bfloat16* oh = o + (size_t)h * s_len * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int row = wq0 + row_in + 8 * hh;
    if (row >= s_len) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(oh + (size_t)row * D + 8 * j + col_in) =
          pack_bf16x2(acc[4 * j + 2 * hh] * inv, acc[4 * j + 2 * hh + 1] * inv);
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int bhq, int s_len,
                 int t_len, int groups, int causal, int q_offset, float scale, void* stream) {
  const cuuint64_t row = D * sizeof(__nv_bfloat16);
  const cuuint64_t q_dims[3] = {D, (cuuint64_t)s_len, (cuuint64_t)bhq};
  const cuuint64_t kv_dims[3] = {D, (cuuint64_t)t_len, (cuuint64_t)(bhq / groups)};
  const cuuint64_t q_str[2] = {row, row * s_len};
  const cuuint64_t kv_str[2] = {row, row * t_len};
  constexpr int W = TcHead<D>::W;
  const cuuint32_t q_box[3] = {W, TC_WG_ROWS, 1};
  const cuuint32_t kv_box[3] = {W, TC_BK, 1};
  const CUtensorMapSwizzle swz = W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  cudaError_t err = rt_encode_swizzled(&mq, bf16, 3, q, q_dims, q_str, q_box, swz);
  if (err == cudaSuccess)
    err = rt_encode_swizzled(&mk, bf16, 3, k, kv_dims, kv_str, kv_box, swz);
  if (err == cudaSuccess)
    err = rt_encode_swizzled(&mv, bf16, 3, v, kv_dims, kv_str, kv_box, swz);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(TcSmem<D>) + 1024;
  err = cudaFuncSetAttribute(flash_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bhq, (s_len + TC_BQ - 1) / TC_BQ);
  flash_kernel_wgmma<D><<<grid, TcHead<D>::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), s_len, t_len, groups, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Grid (ceil(S / 64), BHq).  The wrapper bounds d <= 256, checks that BHq =
// BHkv x groups and q_offset >= 0, and checks every shape and type.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o, int bhq,
                                  int s_len, int t_len, int d, int groups, int causal,
                                  int q_offset, float scale, int bf16, void* stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset,
                                   scale, stream);
  return dispatch<float>(q, k, v, o, bhq, s_len, t_len, d, groups, causal, q_offset, scale,
                         stream);
}

// Grid (BHq, ceil(S / 128)).  bf16 q/k/v with d in {64, 128, 224}, each base
// 16-byte aligned; the wrapper checks every shape and type.
extern "C" int rt_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                        int bhq, int s_len, int t_len, int d, int groups,
                                        int causal, int q_offset, float scale, void* stream) {
  if (d == 128)
    return launch_wgmma<128>(q, k, v, o, bhq, s_len, t_len, groups, causal, q_offset, scale,
                             stream);
  if (d == 64)
    return launch_wgmma<64>(q, k, v, o, bhq, s_len, t_len, groups, causal, q_offset, scale,
                            stream);
  if (d == 224)
    return launch_wgmma<224>(q, k, v, o, bhq, s_len, t_len, groups, causal, q_offset, scale,
                             stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
