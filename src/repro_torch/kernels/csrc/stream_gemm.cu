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
// stream_gemm: C = init + sign * (A @ B), init optional, C may alias init.
// Two routes, a fixed dispatch on n (the wrapper picks; neither falls back):
// * n > 32, the chain's K step (1314 x 1314) @ (1314 x 10512) + init.
//   Bound on an H100: operations, 36.3 GFLOP a step.  On the CUDA cores'
//   fp32 FFMA that is ~0.54 ms (67 TFLOP/s); the route runs it as three TF32
//   products on `wgmma` (tf32x3.cuh, the design of block_matmul.cu: the
//   chain amplifies rounding 2^d-fold, so one TF32 product is too coarse),
//   3 x 36.3 GFLOP at 495 TFLOP/s = 0.22 ms, with init and the sign in the
//   epilogue.  A bits operand is exact in TF32, so its split pass writes hi
//   only and the products that would read its lo are skipped.  The split
//   parts live in caller-allocated scratch, (NPA m + NPB n) round_up(k, 32)
//   floats (the out-of-core chain allocates it once per GEMM).
// * n <= 32, the chi build and CG's direction product (1314 x 10512) @
//   (10512 x 17).  Bound on an H100: bytes, 55 MB of A (~0.017 ms at 3.35
//   TB/s) against 0.47 GFLOP.  `skinny_kernel`: a block takes 64 rows of A
//   and a run of 64-deep k slabs; A streams in with 16-byte loads (prefetched
//   into registers while the previous slab is multiplied) and is widened to
//   fp32 in shared memory beside the slab of B, which all 64 rows share.  Its
//   256 threads are 64 rows x 4 k groups; a thread keeps its row's n sums in
//   registers (n padded to 8, 16, 20, 24 or 32).  The k range is split over
//   enough blocks to fill the card (a function of m and k only); the splits'
//   partials go to scratch and `skinny_finish` adds them in split order and
//   applies init and the sign.  Every output is summed over k in one fixed
//   order, with no atomics, so two runs are bitwise equal.
//
// rt_fused_panel_matvec: one pass over a row panel P (ph x K):
//   gy = chi + y_panel - P y,   delta = chi - P y,
//   colsum[c] = sum_rows delta[:, c],   sumsq = sum delta^2.
//   Bound on an H100: bytes.  P is read once (55 MB fp32 at ph=1314,
//   K=10512: ~0.017 ms at 3.35 TB/s; half of that as bits) against ~0.5
//   GFLOP, the chi build's shape.  So P y runs on the skinny route as it
//   stands (the same kernel, the same k split from skinny_plan), and a fused
//   finish takes skinny_finish's place: it sums the splits in split order,
//   writes gy = (chi + y_panel) - s exactly as skinny_finish does with that
//   init and neg = 1, so gy is bitwise stream_gemm(P, y, chi + y_panel,
//   sign=-1), and writes per-block partials of delta's column sums and sum
//   of squares; one block then sums those in block order.  Fixed-order
//   sums, no atomics: CachingHandle replays are bitwise.
#include "tf32x3.cuh"

namespace {

constexpr int SK_BM = 64;                   // rows of A per block
constexpr int SK_KG = 4;                    // k groups per block
constexpr int SK_THREADS = SK_BM * SK_KG;   // one thread per (row, k group)
constexpr int SK_KT = 64;                   // k of a slab
constexpr int SK_KPG = SK_KT / SK_KG;       // k of a slab per group
constexpr int SK_APITCH = SK_KT + 4;        // floats per A row in shared memory (16-byte rows)
constexpr int SK_NMAX = 32;
constexpr int SK_PER_THREAD = SK_BM * SK_KT / SK_THREADS;  // A elements a thread stages per slab

template <typename TA, typename TB, int NC>
__global__ void __launch_bounds__(SK_THREADS, 2)
skinny_kernel(const TA* __restrict__ A, const TB* __restrict__ B, float* __restrict__ part,
              int m, int n, int k, int slabs, int slabs_per_split, int vec) {
  // As (SK_BM x SK_APITCH) then Bs (SK_KT x NC); after the k loop the same
  // words hold the k groups' sums (SK_KG - 1 groups x SK_BM rows x NC + 1).
  __shared__ __align__(16) float smem[SK_BM * SK_APITCH + SK_KT * NC];
  static_assert((SK_KG - 1) * SK_BM * (NC + 1) <= SK_BM * SK_APITCH + SK_KT * NC,
                "the group sums fit in the staging buffers");
  static_assert(NC % 4 == 0 && NC <= SK_NMAX, "n is padded to a multiple of 4");
  float* As = smem;
  float* Bs = smem + SK_BM * SK_APITCH;

  constexpr int VW = 16 / sizeof(TA);           // A elements per 16-byte load
  constexpr int VPR = SK_KT / VW;                // 16-byte loads per row of a slab
  constexpr int NV = SK_PER_THREAD / VW;         // 16-byte loads a thread makes per slab
  constexpr int BT = SK_THREADS / SK_KT;        // threads per row of a B slab
  constexpr int NB = NC / BT;                    // B elements a thread stages per slab
  static_assert(BT * SK_KT == SK_THREADS && NC % BT == 0, "B slab rows split evenly");
  const int t = threadIdx.x;
  const int r = t % SK_BM, g = t / SK_BM;  // a warp is 32 rows of one k group
  const int row0 = blockIdx.x * SK_BM;
  const int sl0 = blockIdx.y * slabs_per_split;
  const int sl1 = min(slabs, sl0 + slabs_per_split);

  float ra[SK_PER_THREAD];
  float rb[NB];
  auto load = [&](int sl) {
    const int k0 = sl * SK_KT;
    if (vec) {  // k is a multiple of VW and A is 16-byte aligned: whole vectors in or out
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int e = t + i * SK_THREADS;
        const int gr = row0 + e / VPR, gk = k0 + (e % VPR) * VW;
        if (gr < m && gk < k) {
          widen16(A + (size_t)gr * k + gk, ra + i * VW);
        } else {
#pragma unroll
          for (int j = 0; j < VW; ++j) ra[i * VW + j] = 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < SK_PER_THREAD; ++i) {
        const int e = t + i * SK_THREADS;
        const int gr = row0 + e / SK_KT, gk = k0 + e % SK_KT;
        ra[i] = (gr < m && gk < k) ? to_f32(A[(size_t)gr * k + gk]) : 0.0f;
      }
    }
    const int bk = k0 + t / BT;  // this thread's B row; its columns t % BT, + BT, ...
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int c = t % BT + i * BT;
      rb[i] = (c < n && bk < k) ? to_f32(B[(size_t)bk * n + c]) : 0.0f;  // 0 past n
    }
  };
  auto store = [&]() {
    if (vec) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int e = t + i * SK_THREADS;
        float* dst = As + (e / VPR) * SK_APITCH + (e % VPR) * VW;
#pragma unroll
        for (int j = 0; j < VW; ++j) dst[j] = ra[i * VW + j];
      }
    } else {
#pragma unroll
      for (int i = 0; i < SK_PER_THREAD; ++i) {
        const int e = t + i * SK_THREADS;
        As[(e / SK_KT) * SK_APITCH + e % SK_KT] = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) Bs[(t / BT) * NC + t % BT + i * BT] = rb[i];
  };

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.0f;

  if (sl0 < sl1) load(sl0);
  for (int sl = sl0; sl < sl1; ++sl) {
    __syncthreads();  // the previous slab's reads are done
    store();
    __syncthreads();
    if (sl + 1 < sl1) load(sl + 1);  // in flight while this slab is multiplied
    const float* arow = As + r * SK_APITCH + g * SK_KPG;
#pragma unroll
    for (int j = 0; j < SK_KPG; j += 4) {
      const float4 av = *reinterpret_cast<const float4*>(arow + j);
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* brow = Bs + (g * SK_KPG + j + jj) * NC;  // one address per warp: broadcast
#pragma unroll
        for (int c = 0; c < NC; c += 4) {
          const float4 bv = *reinterpret_cast<const float4*>(brow + c);
          acc[c] = fmaf(a4[jj], bv.x, acc[c]);
          acc[c + 1] = fmaf(a4[jj], bv.y, acc[c + 1]);
          acc[c + 2] = fmaf(a4[jj], bv.z, acc[c + 2]);
          acc[c + 3] = fmaf(a4[jj], bv.w, acc[c + 3]);
        }
      }
    }
  }
  __syncthreads();  // the staging buffers become the group sums

  float* red = smem;
  if (g > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c) red[((g - 1) * SK_BM + r) * (NC + 1) + c] = acc[c];
  }
  __syncthreads();
  const int row = row0 + r;
  if (g == 0 && row < m) {
    float* out = part + (size_t)blockIdx.y * m * n + (size_t)row * n;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c < n) {
        float v = acc[c];
#pragma unroll
        for (int gg = 1; gg < SK_KG; ++gg) v += red[((gg - 1) * SK_BM + r) * (NC + 1) + c];
        out[c] = v;
      }
    }
  }
}

// Output i's partials (splits of m n floats) summed in split order.  Both
// finishes take it, which makes fused_panel_matvec's gy bitwise stream_gemm's.
__device__ __forceinline__ float split_sum(const float* __restrict__ part, int splits,
                                           long long mn, long long i) {
  float s = part[i];
#pragma unroll 4
  for (int sp = 1; sp < splits; ++sp) s += part[sp * mn + i];
  return s;
}

// C = init + sign * (the splits' partials summed in split order); C may alias init.
__global__ void skinny_finish(const float* __restrict__ part, int splits, const float* init,
                              int neg, float* c, long long mn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = split_sum(part, splits, mn, i);
  if (init != nullptr) {
    s = neg ? init[i] - s : init[i] + s;
  } else if (neg) {
    s = -s;
  }
  c[i] = s;
}

// The skinny product's split partials: splits x m x n floats at `part`.
template <typename TA, typename TB>
int skinny_partials(const void* a, const void* b, int m, int n, int k, int splits,
                    int slabs_per_split, float* part, long long part_elems, cudaStream_t s) {
  const int slabs = std::max((k + SK_KT - 1) / SK_KT, 1);  // k = 0: one empty slab, C = init
  if (n < 1 || n > SK_NMAX || slabs_per_split < 1 ||
      splits != (slabs + slabs_per_split - 1) / slabs_per_split ||
      part_elems < (long long)splits * m * n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = (k % (16 / (int)sizeof(TA)) == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const dim3 grid((m + SK_BM - 1) / SK_BM, splits);
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  if (n <= 8) {
    skinny_kernel<TA, TB, 8><<<grid, SK_THREADS, 0, s>>>(pa, pb, part, m, n, k, slabs,
                                                         slabs_per_split, vec);
  } else if (n <= 16) {
    skinny_kernel<TA, TB, 16><<<grid, SK_THREADS, 0, s>>>(pa, pb, part, m, n, k, slabs,
                                                          slabs_per_split, vec);
  } else if (n <= 20) {
    skinny_kernel<TA, TB, 20><<<grid, SK_THREADS, 0, s>>>(pa, pb, part, m, n, k, slabs,
                                                          slabs_per_split, vec);
  } else if (n <= 24) {
    skinny_kernel<TA, TB, 24><<<grid, SK_THREADS, 0, s>>>(pa, pb, part, m, n, k, slabs,
                                                          slabs_per_split, vec);
  } else {
    skinny_kernel<TA, TB, 32><<<grid, SK_THREADS, 0, s>>>(pa, pb, part, m, n, k, slabs,
                                                          slabs_per_split, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, typename TB>
int skinny_launch(const void* a, const void* b, const float* init, int neg, float* c, int m,
                  int n, int k, int splits, int slabs_per_split, float* scratch,
                  long long scratch_elems, cudaStream_t s) {
  const int err = skinny_partials<TA, TB>(a, b, m, n, k, splits, slabs_per_split, scratch,
                                          scratch_elems, s);
  if (err != 0) return err;
  const long long mn = (long long)m * n;
  skinny_finish<<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(scratch, splits, init, neg, c, mn);
  return static_cast<int>(cudaGetLastError());
}

constexpr int FM_ROWS = 8;  // rows per block of the fused finish: one warp each, lane = column
constexpr int FM_QMAX = SK_NMAX;

// The fused finish: skinny_finish's sum with init = chi + y_panel and neg = 1
// (the same operations in the same order), then delta = chi - P y into the
// block's column sums and sum of squares, each summed in row order.
__global__ void __launch_bounds__(FM_ROWS * RT_WARP)
fused_matvec_finish(const float* __restrict__ part, int splits, const float* __restrict__ chi,
                    const float* __restrict__ yp, float* __restrict__ gy,
                    float* __restrict__ part_cs, float* __restrict__ part_ss, int ph, int q) {
  __shared__ float dl[FM_ROWS][FM_QMAX + 1];
  const int r = threadIdx.x / RT_WARP, c = threadIdx.x % RT_WARP;
  const int row = blockIdx.x * FM_ROWS + r;
  float d = 0.0f;
  if (row < ph && c < q) {
    const long long i = (long long)row * q + c;
    const float s = split_sum(part, splits, (long long)ph * q, i);
    const float x = chi[i];
    gy[i] = (x + yp[i]) - s;
    d = x - s;
  }
  dl[r][c] = d;
  __syncthreads();
  if (threadIdx.x < q) {
    float t = 0.0f;
#pragma unroll
    for (int rr = 0; rr < FM_ROWS; ++rr) t += dl[rr][threadIdx.x];
    part_cs[(size_t)blockIdx.x * q + threadIdx.x] = t;
  } else if (threadIdx.x == FM_QMAX) {  // a lane of the second warp
    float t = 0.0f;
    for (int rr = 0; rr < FM_ROWS; ++rr) {
      for (int cc = 0; cc < q; ++cc) t = fmaf(dl[rr][cc], dl[rr][cc], t);
    }
    part_ss[blockIdx.x] = t;
  }
}

// Last stage, one block of FM_ROWS warps: lane c of warp w sums column c over
// blocks w, w + FM_ROWS, ... in order, then warp 0 adds the warps' sums in
// warp order (the sums of squares likewise, in lane FM_QMAX - 1 of each warp).
__global__ void __launch_bounds__(FM_ROWS * RT_WARP)
fused_matvec_reduce(const float* __restrict__ part_cs, const float* __restrict__ part_ss,
                    float* __restrict__ cs, float* __restrict__ ss, int n_blocks, int q) {
  __shared__ float wsum[FM_ROWS][FM_QMAX + 1];
  const int w = threadIdx.x / RT_WARP, c = threadIdx.x % RT_WARP;
  float t = 0.0f, u = 0.0f;
#pragma unroll 4
  for (int b = w; b < n_blocks; b += FM_ROWS) {
    if (c < q) t += part_cs[(size_t)b * q + c];
    if (c == FM_QMAX - 1) u += part_ss[b];
  }
  wsum[w][c] = t;
  if (c == FM_QMAX - 1) wsum[w][FM_QMAX] = u;
  __syncthreads();
  if (w == 0) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int ww = 0; ww < FM_ROWS; ++ww) {
      a += wsum[ww][c];
      b += wsum[ww][FM_QMAX];
    }
    if (c < q) cs[c] = a;
    if (c == 0) ss[0] = b;
  }
}

template <typename TP>
int fused_launch(const void* p, const float* y, const float* chi, const float* yp, float* gy,
                 float* cs, float* ss, int ph, int k, int q, int splits, int slabs_per_split,
                 float* scratch, long long scratch_elems, cudaStream_t s) {
  const int n_blocks = (ph + FM_ROWS - 1) / FM_ROWS;
  const long long part_elems = (long long)splits * ph * q;
  if (ph < 1 || scratch_elems < part_elems + (long long)n_blocks * (q + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = skinny_partials<TP, float>(p, y, ph, q, k, splits, slabs_per_split, scratch,
                                             part_elems, s);
  if (err != 0) return err;
  float* part_cs = scratch + part_elems;
  float* part_ss = part_cs + (size_t)n_blocks * q;
  fused_matvec_finish<<<n_blocks, FM_ROWS * RT_WARP, 0, s>>>(scratch, splits, chi, yp, gy,
                                                             part_cs, part_ss, ph, q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_matvec_reduce<<<1, FM_ROWS * RT_WARP, 0, s>>>(part_cs, part_ss, cs, ss, n_blocks, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tensor-core route (n > 32): `scratch` holds (NPA m + NPB n) round_up(k, 32)
// floats, NP = 2 for an fp32 operand and 1 for a bits one (`scratch_elems` is checked).
extern "C" int rt_stream_gemm_tc(const void* a, int a_bits, const void* b, int b_bits,
                                 const void* init, int neg, void* c, int m, int n, int k,
                                 void* scratch, long long scratch_elems, void* stream) {
  const float* in = static_cast<const float*>(init);
  float* out = static_cast<float*>(c);
  float* sc = static_cast<float*>(scratch);
  if (a_bits && b_bits) {
    return tf32x3_gemm<uint16_t, uint16_t, 1, 1>(a, b, 0, in, neg, out, m, n, k, sc,
                                                 scratch_elems, stream);
  }
  if (a_bits) {
    return tf32x3_gemm<uint16_t, float, 1, 2>(a, b, 0, in, neg, out, m, n, k, sc, scratch_elems,
                                              stream);
  }
  if (b_bits) {
    return tf32x3_gemm<float, uint16_t, 2, 1>(a, b, 0, in, neg, out, m, n, k, sc, scratch_elems,
                                              stream);
  }
  return tf32x3_gemm<float, float, 2, 2>(a, b, 0, in, neg, out, m, n, k, sc, scratch_elems,
                                         stream);
}

// The skinny route (n <= 32): the k range in `splits` runs of `slabs_per_split`
// 64-deep slabs (the wrapper's plan, checked here); `scratch` holds splits m n floats.
extern "C" int rt_stream_gemm_skinny(const void* a, int a_bits, const void* b, int b_bits,
                                     const void* init, int neg, void* c, int m, int n, int k,
                                     int splits, int slabs_per_split, void* scratch,
                                     long long scratch_elems, void* stream) {
  const float* in = static_cast<const float*>(init);
  float* out = static_cast<float*>(c);
  float* sc = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bits && b_bits) {
    return skinny_launch<uint16_t, uint16_t>(a, b, in, neg, out, m, n, k, splits,
                                             slabs_per_split, sc, scratch_elems, s);
  }
  if (a_bits) {
    return skinny_launch<uint16_t, float>(a, b, in, neg, out, m, n, k, splits, slabs_per_split,
                                          sc, scratch_elems, s);
  }
  if (b_bits) {
    return skinny_launch<float, uint16_t>(a, b, in, neg, out, m, n, k, splits, slabs_per_split,
                                          sc, scratch_elems, s);
  }
  return skinny_launch<float, float>(a, b, in, neg, out, m, n, k, splits, slabs_per_split, sc,
                                     scratch_elems, s);
}

// P y on the skinny route with the plan (splits, slabs_per_split) of
// skinny_plan(ph, k), then the fused finish.  `scratch` holds the splits'
// partials (splits ph q floats), then ceil(ph / 8) x (q + 1) floats of
// per-block column sums and sums of squares (both checked); q <= 32.
extern "C" int rt_fused_panel_matvec(const void* p, int p_bits, const void* y, const void* chi,
                                     const void* yp, void* gy, void* cs, void* ss, int ph, int k,
                                     int q, int splits, int slabs_per_split, void* scratch,
                                     long long scratch_elems, void* stream) {
  const float* yf = static_cast<const float*>(y);
  const float* chif = static_cast<const float*>(chi);
  const float* ypf = static_cast<const float*>(yp);
  float* gyf = static_cast<float*>(gy);
  float* csf = static_cast<float*>(cs);
  float* ssf = static_cast<float*>(ss);
  float* sc = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_bits) {
    return fused_launch<uint16_t>(p, yf, chif, ypf, gyf, csf, ssf, ph, k, q, splits,
                                  slabs_per_split, sc, scratch_elems, s);
  }
  return fused_launch<float>(p, yf, chif, ypf, gyf, csf, ssf, ph, k, q, splits, slabs_per_split,
                             sc, scratch_elems, s);
}
