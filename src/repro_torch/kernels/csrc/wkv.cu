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
// Bound on an H100.  At rwkv6-3b's prefill (BH = 4 x 40, S = 1024, 64 x 64
// heads) the inputs and outputs are ~0.13 GB (~0.04 ms at 3.35 TB/s), the
// recurrence is ~2.7 GFLOP of fp32 FMA (~0.04 ms at 67 TFLOP/s), and the
// decays below are ~120M exponentials (~0.03 ms at the SFUs' 16 a clock per
// SM).  The three are close, so the design keeps every one of them from
// serialising behind a single block per head.
//
// Design: a chunk-parallel scan.  The TPU grid walks a head's chunks in
// order with the state in VMEM; on Hopper that is one block per head (160
// blocks for 132 SMs, 32 chunk steps each).  Here the sequence is cut into
// chunks of WKV_L = 64 rows, and three launches replace the walk:
//   A (state_kernel, one block per (head, chunk)): the chunk's decay
//     dec = exp(cum_last) and its state increment
//     dS = sum_i (k_i (.) exp(cum_last - cum_i)) v_i^T, to fp32 scratch;
//   B (scan_kernel, one thread per (head, state element)): the only serial
//     part, S_{c+1} = diag(dec_c) S_c + dS_c from s0, writing each chunk's
//     incoming state over its dS and the last state to s_final;
//   C (out_kernel, one block per (head, chunk)): the outputs,
//     y_t = sum_{i<=t} A[t][i] v_i + (r_t (.) exp(cum_{t-1})) . S_in,
//     A[t][i] = sum_c r_t[c] k_i[c] exp(cum_{t-1}[c] - cum_i[c]) for i < t
//     and the bonus sum_c r_t[c] u[c] k_t[c] on the diagonal.
// cum is the inclusive cumulative log decay within the chunk, kept in log2
// units (lw log2(e)) so each decay is one ex2.approx.  Every exponent is <= 0,
// as in the walk this replaces: C takes the decay pairwise within each
// 16-row block, and between blocks factorises it through a boundary row b
// between them, exp(cum_{t-1} - cum_b) exp(cum_b - cum_i), both factors <= 1
// (b = 31 between the two 32-row halves of the chunk, b = 15 and 47 between
// the two blocks of each half).  So any decay is safe at any length, and the
// pairwise exponentials are 4 x 16 x 15 / 2 x dk a chunk.  The products run
// on fp32 FFMA from register tiles: a thread owns 4 x 4 outputs and each
// 16-byte shared-memory load feeds four FMAs; rows of the shared tiles are
// padded to 68 floats so the lanes of a quarter warp hit distinct banks.  In
// C every warp takes an equal share of the pairwise entries (the
// exponentials, each entry once) and of the dense cross blocks.  A prompt the
// chunk does not divide is masked: rows past S load r = k = v = 0 and
// lw = 0, which leave y's valid rows and the state untouched.  No atomics;
// every sum runs in a fixed order, so two runs are bitwise equal.
#include "common.cuh"

namespace {

constexpr int WKV_L = 64;            // rows per chunk
constexpr int WKV_SC = 32;           // rows per sub-chunk: halves of the chunk
constexpr int WKV_PB = 16;           // rows per block of the pairwise decay: halves of a sub-chunk
constexpr int WKV_D = 64;            // widest head
constexpr int WKV_LD = WKV_D + 4;    // padded row stride of the shared tiles (16-byte rows)
constexpr int WKV_THREADS = 256;
constexpr int WKV_SEG = WKV_THREADS / WKV_D;  // row segments of the cumulative sum
constexpr int WKV_SEGROWS = WKV_L / WKV_SEG;
constexpr int WKV_TILE = WKV_L * WKV_LD;
constexpr float WKV_LOG2E = 1.4426950408889634f;
static_assert(WKV_L == 2 * WKV_SC && WKV_SC == 2 * WKV_PB && WKV_D == WKV_L,
              "two sub-chunks of two pairwise blocks; square 64 x 64 tiles");

// The scores of C are shared by all 256 threads, so every warp scheduler of
// the SM carries the same mix.  The pairwise entries: a 16-row block's rows
// p and q = 15 - p (p < 8) fold into one run of 15 entries, (p, i) for i < p
// and (q, i) for i < q; WKV_FOLD_THREADS threads (a quarter warp) share a
// fold by columns i = s, s + 8: each loads rows p and q once and each column
// once for both rows.  The cross blocks: between the sub-chunks (t >= 32,
// i < 32) a 2 x 2 tile a thread, between the blocks of a sub-chunk (t in
// 16..31, i < 16 and t in 48..63, i in 32..47) two entries a thread.  Threads
// 0..63 also take the diagonal (the bonus), a row each.
constexpr int WKV_FOLD_THREADS = 8;
constexpr int WKV_PW_COLS = (WKV_PB - 1 + WKV_FOLD_THREADS - 1) / WKV_FOLD_THREADS;
static_assert((WKV_L / WKV_PB) * (WKV_PB / 2) * WKV_FOLD_THREADS == WKV_THREADS,
              "one fold per quarter warp");
static_assert(WKV_PB / 2 <= WKV_FOLD_THREADS, "row p's columns fit one pass of a fold");
static_assert((WKV_SC / 2) * (WKV_SC / 2) == WKV_THREADS, "the sub-chunks' cross block in 2 x 2 tiles");
static_assert(2 * WKV_PB * WKV_PB == 2 * WKV_THREADS, "the blocks' cross entries, two a thread");

constexpr size_t out_smem_bytes() {
  return sizeof(float) * (6 * WKV_TILE + WKV_SEG * WKV_D + WKV_D);
}

// 2^x by the SFU's ex2.approx (~2 ulp); a result below the normal range is 0.
// Every argument here is <= 0, so the decay factors lie in [0, 1].
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Four outputs of one row, from fp32.
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&lo);
  w.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = w;
}

// One thread's share of a 64-row slab of T as 16-byte vectors: `load` issues
// every global load of the share at once (a block's loads are then in flight
// together instead of one latency each), `store` widens them into a 64 x
// WKV_LD shared tile.  Rows past `rows` and columns past `d` are zeros.  For a
// row-major (rows x d) slab whose d is a multiple of the 16-byte width and
// which is 16-byte aligned; `stage` below takes any other.
template <typename T>
struct Slab {
  static constexpr int VW = 16 / sizeof(T);
  static constexpr int VPR = WKV_D / VW;
  static constexpr int N = WKV_L * VPR / WKV_THREADS;
  uint4 raw[N];

  __device__ __forceinline__ void load(const T* __restrict__ src, int rows, int d) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * WKV_THREADS;
      const int t = e / VPR, c0 = (e % VPR) * VW;
      raw[n] = (t < rows && c0 < d) ? *reinterpret_cast<const uint4*>(src + (size_t)t * d + c0)
                                    : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ dst) const {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int e = threadIdx.x + n * WKV_THREADS;
      const int t = e / VPR, c0 = (e % VPR) * VW;
      float w[VW];
      widen16(reinterpret_cast<const T*>(&raw[n]), w);
#pragma unroll
      for (int j = 0; j < VW; j += 4) store4(dst + t * WKV_LD + c0 + j, w + j);
    }
  }
};

// A slab of any width and alignment, one element at a time.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, int rows, int d,
                                      float* __restrict__ dst) {
  for (int e = threadIdx.x; e < WKV_L * WKV_D; e += WKV_THREADS) {
    const int t = e / WKV_D, c = e % WKV_D;
    dst[t * WKV_LD + c] = (t < rows && c < d) ? to_f32(src[(size_t)t * d + c]) : 0.0f;
  }
}

// The inclusive cumulative sum of `lw` down each column, in log2 units.  A
// thread takes WKV_SEGROWS rows of one column; `x` returns them (this
// thread's rows), `off` their segment's offset (cum = x + off), `last` the
// column's total, cum at row 63.  Ends with every thread past one barrier.
__device__ __forceinline__ void column_cumsum(const float (&lw)[WKV_SEGROWS], float* segtot,
                                              float (&x)[WKV_SEGROWS], float& off, float& last) {
  const int col = threadIdx.x % WKV_D, seg = threadIdx.x / WKV_D;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < WKV_SEGROWS; ++i) {
    acc = fmaf(lw[i], WKV_LOG2E, acc);
    x[i] = acc;
  }
  segtot[seg * WKV_D + col] = acc;
  __syncthreads();
  float o = 0.0f;
#pragma unroll
  for (int s = 0; s < WKV_SEG; ++s) {
    const float st = segtot[s * WKV_D + col];
    if (s == seg) off = o;
    if (s == WKV_SEG - 1) last = st + o;  // row 63's x + off, bit for bit
    o += st;
  }
}

// A: per (head, chunk), dec = exp(cum_last) and dS = sum_i (k_i (.) exp(cum_last - cum_i)) v_i^T.
template <typename T>
__global__ void __launch_bounds__(WKV_THREADS)
wkv_state_kernel(const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ lw,
                 float* __restrict__ ds, float* __restrict__ dec, int s_len, int dk, int dv,
                 int nch, int vec_k, int vec_v) {
  __shared__ __align__(16) float ks[WKV_TILE];
  __shared__ __align__(16) float vs[WKV_TILE];
  __shared__ float segtot[WKV_SEG * WKV_D];
  const int tid = threadIdx.x;
  const int bh = blockIdx.x / nch, ch = blockIdx.x % nch;
  const int rows = min(WKV_L, s_len - ch * WKV_L);
  const size_t row0 = (size_t)bh * s_len + (size_t)ch * WKV_L;
  const int col = tid % WKV_D, seg = tid / WKV_D;
  Slab<T> sk, sv;  // every load in flight before the first store
  if (vec_k) sk.load(k + row0 * dk, rows, dk);
  if (vec_v) sv.load(v + row0 * dv, rows, dv);
  float l[WKV_SEGROWS], x[WKV_SEGROWS], off = 0.0f, last = 0.0f;
#pragma unroll
  for (int i = 0; i < WKV_SEGROWS; ++i) {
    const int t = seg * WKV_SEGROWS + i;
    l[i] = (t < rows && col < dk) ? lw[(row0 + t) * dk + col] : 0.0f;
  }
  if (vec_k) sk.store(ks); else stage(k + row0 * dk, rows, dk, ks);
  if (vec_v) sv.store(vs); else stage(v + row0 * dv, rows, dv, vs);
  column_cumsum(l, segtot, x, off, last);  // its barrier also publishes ks, vs
#pragma unroll
  for (int i = 0; i < WKV_SEGROWS; ++i) {
    ks[(seg * WKV_SEGROWS + i) * WKV_LD + col] *= ex2(last - (x[i] + off));
  }
  const size_t chunk = (size_t)bh * nch + ch;
  if (seg == 0 && col < dk) dec[chunk * dk + col] = ex2(last);
  __syncthreads();

  // dS[c][j], c = 4 tc + a, j = 4 tj + b: a 4 x 4 register tile over the 64 rows
  const int tc = tid / 16, tj = tid % 16;
  float acc[4][4] = {};
#pragma unroll 8
  for (int t = 0; t < WKV_L; ++t) {
    const float4 kq = *reinterpret_cast<const float4*>(ks + t * WKV_LD + 4 * tc);
    const float4 vq = *reinterpret_cast<const float4*>(vs + t * WKV_LD + 4 * tj);
    const float ka[4] = {kq.x, kq.y, kq.z, kq.w};
    const float vb[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(ka[a], vb[b], acc[a][b]);
    }
  }
  float* out = ds + chunk * dk * dv;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int c = 4 * tc + a, j0 = 4 * tj;
    if (c >= dk || j0 >= dv) continue;
    if (dv % 4 == 0) {
      store4(out + (size_t)c * dv + j0, acc[a]);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (j0 + b < dv) out[(size_t)c * dv + j0 + b] = acc[a][b];
      }
    }
  }
}

// B: the scan over chunks, one thread per state element, WKV_PF chunks' loads in flight.
constexpr int WKV_PF = 16;

__global__ void __launch_bounds__(WKV_THREADS)
wkv_scan_kernel(float* __restrict__ ds, const float* __restrict__ dec,
                const float* __restrict__ s0, float* __restrict__ s_fin, int nch, int dk,
                int dv, int blocks_per_head) {
  const int bh = blockIdx.x / blocks_per_head;
  const int e = (blockIdx.x % blocks_per_head) * WKV_THREADS + threadIdx.x;
  const int dd = dk * dv;
  if (e >= dd) return;
  const int c = e / dv;
  float s = s0 != nullptr ? s0[(size_t)bh * dd + e] : 0.0f;
  float* d = ds + (size_t)bh * nch * dd + e;
  const float* w = dec + (size_t)bh * nch * dk + c;
  for (int ch = 0; ch < nch; ch += WKV_PF) {
    float inc[WKV_PF], wv[WKV_PF];
#pragma unroll
    for (int u = 0; u < WKV_PF; ++u) {
      if (ch + u < nch) {
        inc[u] = d[(size_t)(ch + u) * dd];
        wv[u] = w[(size_t)(ch + u) * dk];
      }
    }
#pragma unroll
    for (int u = 0; u < WKV_PF; ++u) {
      if (ch + u < nch) {
        d[(size_t)(ch + u) * dd] = s;  // chunk ch + u's incoming state
        s = fmaf(wv[u], s, inc[u]);
      }
    }
  }
  s_fin[(size_t)bh * dd + e] = s;
}

// C: per (head, chunk), the outputs from the chunk's incoming state.
template <typename T>
__global__ void __launch_bounds__(WKV_THREADS, 2)
wkv_out_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ lw, const float* __restrict__ u,
               const float* __restrict__ s_in, T* __restrict__ y, int s_len, int dk, int dv,
               int nch, int vec_k, int vec_v, int vec_l, int vec_s) {
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                 // r, then r (.) exp(cum_{t-1})
  float* ks = rs + WKV_TILE;      // k
  float* vs = ks + WKV_TILE;      // v
  float* cs = vs + WKV_TILE;      // lw, then cum (log2 units)
  float* fs = cs + WKV_TILE;      // the sub-chunks' cross factors, then the scores A[t][i]
  float* f2 = fs + WKV_TILE;      // the blocks' cross factors, then the incoming state S_in[c][j]
  float* segtot = f2 + WKV_TILE;  // WKV_SEG x WKV_D
  float* us = segtot + WKV_SEG * WKV_D;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / nch, ch = blockIdx.x % nch;
  const int rows = min(WKV_L, s_len - ch * WKV_L);
  const size_t row0 = (size_t)bh * s_len + (size_t)ch * WKV_L;
  const size_t chunk = (size_t)bh * nch + ch;
  const float* s0 = s_in + chunk * dk * dv;
  Slab<float> sst;  // the state: loaded with the rest, stored once f2 is free
  {
    Slab<T> sr, sk, sv;  // every load in flight before the first store
    Slab<float> sl;
    const T* r0 = r + row0 * dk;
    const T* k0 = k + row0 * dk;
    const T* v0 = v + row0 * dv;
    const float* l0 = lw + row0 * dk;
    if (vec_k) sr.load(r0, rows, dk), sk.load(k0, rows, dk);
    if (vec_v) sv.load(v0, rows, dv);
    if (vec_l) sl.load(l0, rows, dk);
    if (vec_s) sst.load(s0, dk, dv);
    if (tid < WKV_D) us[tid] = tid < dk ? u[(size_t)bh * dk + tid] : 0.0f;
    if (vec_k) sr.store(rs), sk.store(ks); else stage(r0, rows, dk, rs), stage(k0, rows, dk, ks);
    if (vec_v) sv.store(vs); else stage(v0, rows, dv, vs);
    if (vec_l) sl.store(cs); else stage(l0, rows, dk, cs);
  }
  __syncthreads();
  {
    const int col = tid % WKV_D, seg = tid / WKV_D;
    float l[WKV_SEGROWS], x[WKV_SEGROWS], off = 0.0f, last = 0.0f;
#pragma unroll
    for (int i = 0; i < WKV_SEGROWS; ++i) l[i] = cs[(seg * WKV_SEGROWS + i) * WKV_LD + col];
    column_cumsum(l, segtot, x, off, last);
#pragma unroll
    for (int i = 0; i < WKV_SEGROWS; ++i) cs[(seg * WKV_SEGROWS + i) * WKV_LD + col] = x[i] + off;
  }
  __syncthreads();

  // cross factors through a boundary row b: rows i <= b hold
  // k_i (.) exp(cum_b - cum_i), rows t > b r_t (.) exp(cum_{t-1} - cum_b).
  // fs: b = 31 for the two sub-chunks; f2: b = 15 and b = 47 for the two
  // blocks of each sub-chunk
  for (int e = tid; e < WKV_L * WKV_D; e += WKV_THREADS) {
    const int t = e / WKV_D, c = e % WKV_D;
    const float kt = ks[t * WKV_LD + c], rt = rs[t * WKV_LD + c];
    const float ct = cs[t * WKV_LD + c], cx = t > 0 ? cs[(t - 1) * WKV_LD + c] : 0.0f;
    const float c1 = cs[(WKV_SC - 1) * WKV_LD + c];
    const int b2 = (t / WKV_SC) * WKV_SC + WKV_PB - 1;
    const float c2 = cs[b2 * WKV_LD + c];
    fs[t * WKV_LD + c] = t < WKV_SC ? kt * ex2(c1 - ct) : rt * ex2(cx - c1);
    f2[t * WKV_LD + c] = t <= b2 ? kt * ex2(c2 - ct) : rt * ex2(cx - c2);
  }
  __syncthreads();

  // the scores, into registers: a 2 x 2 tile of the cross block (rows
  // 32 + ct + 16 a, columns ci + 16 b), a fold's columns, and the bonus
  const int ct = tid / (WKV_SC / 2), ci = tid % (WKV_SC / 2);
  float sc[2][2] = {};
#pragma unroll 4
  for (int c = 0; c < WKV_D; c += 4) {
    float ra[2][4], kb[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float4 q = *reinterpret_cast<const float4*>(fs + (WKV_SC + ct + 16 * a) * WKV_LD + c);
      ra[a][0] = q.x, ra[a][1] = q.y, ra[a][2] = q.z, ra[a][3] = q.w;
      const float4 w = *reinterpret_cast<const float4*>(fs + (ci + 16 * a) * WKV_LD + c);
      kb[a][0] = w.x, kb[a][1] = w.y, kb[a][2] = w.z, kb[a][3] = w.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) sc[a][b] = fmaf(ra[a][cc], kb[b][cc], sc[a][b]);
      }
    }
  }
  // the blocks' cross entries: rows 16 + 32 h + bt, columns 32 h + bi and + 8
  const int bh2 = tid / (WKV_THREADS / 2), bt = (tid / 8) % WKV_PB, bi = tid % 8;
  const int t2 = WKV_PB + WKV_SC * bh2 + bt, i2 = WKV_SC * bh2 + bi;
  float s2[2] = {};
#pragma unroll 4
  for (int c = 0; c < WKV_D; c += 4) {
    const float4 q = *reinterpret_cast<const float4*>(f2 + t2 * WKV_LD + c);
    const float4 w0 = *reinterpret_cast<const float4*>(f2 + i2 * WKV_LD + c);
    const float4 w1 = *reinterpret_cast<const float4*>(f2 + (i2 + 8) * WKV_LD + c);
    s2[0] = fmaf(q.x, w0.x, s2[0]);
    s2[0] = fmaf(q.y, w0.y, s2[0]);
    s2[0] = fmaf(q.z, w0.z, s2[0]);
    s2[0] = fmaf(q.w, w0.w, s2[0]);
    s2[1] = fmaf(q.x, w1.x, s2[1]);
    s2[1] = fmaf(q.y, w1.y, s2[1]);
    s2[1] = fmaf(q.z, w1.z, s2[1]);
    s2[1] = fmaf(q.w, w1.w, s2[1]);
  }
  // (q, i) for i < q and (p, i) for i < p in one 16-row block, i = s_col + 8 j:
  // the decay pairwise, exp2(cum_{t-1} - cum_i) <= 1.  Row p = 0 has no entry.
  const int fold = tid / WKV_FOLD_THREADS, s_col = tid % WKV_FOLD_THREADS;
  const int base = (fold / (WKV_PB / 2)) * WKV_PB, p = fold % (WKV_PB / 2);
  const int tp = base + p, tq = base + WKV_PB - 1 - p;
  float aq[WKV_PW_COLS] = {}, ap = 0.0f;
  {
    const float* rp = rs + tp * WKV_LD;
    const float* cp = cs + max(tp - 1, 0) * WKV_LD;
    const float* rq = rs + tq * WKV_LD;
    const float* cq = cs + (tq - 1) * WKV_LD;
#pragma unroll 2
    for (int c = 0; c < WKV_D; c += 4) {
      const float4 rp4 = *reinterpret_cast<const float4*>(rp + c);
      const float4 cp4 = *reinterpret_cast<const float4*>(cp + c);
      const float4 rq4 = *reinterpret_cast<const float4*>(rq + c);
      const float4 cq4 = *reinterpret_cast<const float4*>(cq + c);
#pragma unroll
      for (int j = 0; j < WKV_PW_COLS; ++j) {
        const int il = s_col + WKV_FOLD_THREADS * j;
        if (il >= WKV_PB - 1 - p) break;
        const float4 k4 = *reinterpret_cast<const float4*>(ks + (base + il) * WKV_LD + c);
        const float4 i4 = *reinterpret_cast<const float4*>(cs + (base + il) * WKV_LD + c);
        aq[j] = fmaf(rq4.x * k4.x, ex2(cq4.x - i4.x), aq[j]);
        aq[j] = fmaf(rq4.y * k4.y, ex2(cq4.y - i4.y), aq[j]);
        aq[j] = fmaf(rq4.z * k4.z, ex2(cq4.z - i4.z), aq[j]);
        aq[j] = fmaf(rq4.w * k4.w, ex2(cq4.w - i4.w), aq[j]);
        if (j == 0 && il < p) {
          ap = fmaf(rp4.x * k4.x, ex2(cp4.x - i4.x), ap);
          ap = fmaf(rp4.y * k4.y, ex2(cp4.y - i4.y), ap);
          ap = fmaf(rp4.z * k4.z, ex2(cp4.z - i4.z), ap);
          ap = fmaf(rp4.w * k4.w, ex2(cp4.w - i4.w), ap);
        }
      }
    }
  }
  float bonus = 0.0f;
  if (tid < WKV_L) {
    const float* rt = rs + tid * WKV_LD;
    const float* kt = ks + tid * WKV_LD;
#pragma unroll 4
    for (int c = 0; c < WKV_D; c += 4) {
      const float4 r4 = *reinterpret_cast<const float4*>(rt + c);
      const float4 k4 = *reinterpret_cast<const float4*>(kt + c);
      const float4 u4 = *reinterpret_cast<const float4*>(us + c);
      bonus = fmaf(r4.x * u4.x, k4.x, bonus);
      bonus = fmaf(r4.y * u4.y, k4.y, bonus);
      bonus = fmaf(r4.z * u4.z, k4.z, bonus);
      bonus = fmaf(r4.w * u4.w, k4.w, bonus);
    }
  }
  __syncthreads();  // fs, f2, rs and ks are read; fs becomes the scores, f2 the state

  float* as = fs;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) as[(WKV_SC + ct + 16 * a) * WKV_LD + ci + 16 * b] = sc[a][b];
  }
  as[t2 * WKV_LD + i2] = s2[0];
  as[t2 * WKV_LD + i2 + 8] = s2[1];
#pragma unroll
  for (int j = 0; j < WKV_PW_COLS; ++j) {
    const int il = s_col + WKV_FOLD_THREADS * j;
    if (il < WKV_PB - 1 - p) as[tq * WKV_LD + base + il] = aq[j];
  }
  if (s_col < p) as[tp * WKV_LD + base + s_col] = ap;
  if (tid < WKV_L) as[tid * WKV_LD + tid] = bonus;
  float* ss = f2;  // the incoming state S_in[c][j]
  if (vec_s) sst.store(ss); else stage(s0, dk, dv, ss);
  for (int e = tid; e < WKV_L * WKV_D; e += WKV_THREADS) {
    const int t = e / WKV_D, c = e % WKV_D;  // c: a column of the scores, or a channel of r
    if (c > t) as[t * WKV_LD + c] = 0.0f;  // above the diagonal
    if (t > 0) rs[t * WKV_LD + c] *= ex2(cs[(t - 1) * WKV_LD + c]);  // r to the chunk start
  }
  __syncthreads();

  // y[t][j], t = 4 ty + a, j = 4 tj + b: the scores (lower triangle only) times v,
  // then the decayed r times the incoming state
  const int ty = tid / 16, tj = tid % 16;
  float acc[4][4] = {};
  auto step = [&](const float* lhs, const float* rhs, int k0) {
    float la[4][4], rb[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 q = *reinterpret_cast<const float4*>(lhs + (4 * ty + a) * WKV_LD + k0);
      la[a][0] = q.x, la[a][1] = q.y, la[a][2] = q.z, la[a][3] = q.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 q = *reinterpret_cast<const float4*>(rhs + (k0 + kk) * WKV_LD + 4 * tj);
      rb[kk][0] = q.x, rb[kk][1] = q.y, rb[kk][2] = q.z, rb[kk][3] = q.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(la[a][kk], rb[kk][b], acc[a][b]);
      }
    }
  };
  for (int i0 = 0; i0 <= 4 * ty; i0 += 4) step(as, vs, i0);
#pragma unroll 4
  for (int c0 = 0; c0 < WKV_D; c0 += 4) step(rs, ss, c0);

  T* yo = y + row0 * dv;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int t = 4 * ty + a, j0 = 4 * tj;
    if (t >= rows || j0 >= dv) continue;
    if (dv % 4 == 0) {
      store4(yo + (size_t)t * dv + j0, acc[a]);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (j0 + b < dv) yo[(size_t)t * dv + j0 + b] = from_f32<T>(acc[a][b]);
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw, const void* u,
           const void* s0, void* y, void* s_fin, void* scratch, long long scratch_elems, int bh,
           int s_len, int dk, int dv, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nch = (s_len + WKV_L - 1) / WKV_L;
  const long long states = (long long)bh * nch;
  if (scratch_elems < states * dk * dv + states * dk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* ds = static_cast<float*>(scratch);
  float* dec = ds + states * dk * dv;
  constexpr int VW = 16 / sizeof(T);
  const int vec_k = dk % VW == 0 && aligned16(r) && aligned16(k);
  const int vec_v = dv % VW == 0 && aligned16(v);
  const int vec_l = dk % 4 == 0 && aligned16(lw);
  const int vec_s = dv % 4 == 0 && aligned16(scratch);
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* lwf = static_cast<const float*>(lw);
  cudaError_t err;
  if (nch > 0) {
    wkv_state_kernel<T><<<(unsigned)states, WKV_THREADS, 0, st>>>(kt, vt, lwf, ds, dec, s_len,
                                                                 dk, dv, nch, vec_k, vec_v);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const int per_head = (dk * dv + WKV_THREADS - 1) / WKV_THREADS;
  wkv_scan_kernel<<<(unsigned)(bh * per_head), WKV_THREADS, 0, st>>>(
      ds, dec, static_cast<const float*>(s0), static_cast<float*>(s_fin), nch, dk, dv, per_head);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (nch > 0) {
    const size_t smem = out_smem_bytes();
    err = cudaFuncSetAttribute(wkv_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    wkv_out_kernel<T><<<(unsigned)states, WKV_THREADS, smem, st>>>(
        rt, kt, vt, lwf, static_cast<const float*>(u), ds, static_cast<T*>(y), s_len, dk, dv,
        nch, vec_k, vec_v, vec_l, vec_s);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Three launches on `stream` (A, B, C above; A and C skipped when S = 0).
// s0 may be null (a zero state).  `scratch` holds BH ceil(S / 64) (dk dv + dk)
// floats (checked): each chunk's state increment, then incoming state, and its decay.
// The wrapper bounds dk, dv <= 64 and checks every shape and type.
extern "C" int rt_wkv(const void* r, const void* k, const void* v, const void* lw, const void* u,
                      const void* s0, void* y, void* s_fin, void* scratch,
                      long long scratch_elems, int bh, int s_len, int dk, int dv, int bf16,
                      void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(r, k, v, lw, u, s0, y, s_fin, scratch, scratch_elems, bh,
                                 s_len, dk, dv, stream);
  }
  return launch<float>(r, k, v, lw, u, s0, y, s_fin, scratch, scratch_elems, bh, s_len, dk, dv,
                       stream);
}
