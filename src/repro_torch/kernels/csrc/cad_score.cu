// Fused CAD node scores (paper Algorithm 4, lines 3-6):
//   F_i = sum_j |A1_ij - A2_ij| * |c1(i,j) - c2(i,j)|,
//   c_t(i,j) = vol_t * (|z_i|^2 + |z_j|^2 - 2 z_i . z_j).
//
// Replaces: src/repro/kernels/cad_score.py `cad_scores_tile` (Pallas
// `_cad_kernel`, pallas_call at :78; square wrapper `cad_scores` at :97).
// The sq_i + sq_j - 2 cross form of the TPU kernel is kept so the parity
// tolerances hold.
//
// Bound on an H100: bytes.  At n=10512 the two adjacencies are 2 n^2 * 4 B
// = 0.88 GB, ~0.26 ms at 3.35 TB/s; the two k-long dot products per pair
// (k=17) are ~0.1 ms of fp32 FFMA.  The n x n commute-distance matrices are
// never stored: each block rebuilds its tile of them from the embeddings.
//
// Three launches a call:
//   1. prep: |z|^2 of every row of the four embedding operands, each by one
//      fmaf chain in ascending c (the same for a square call and a panel),
//      and the embeddings transposed to (k, rows), zero-padded, so a tile's
//      z rows load as 16-byte copies whatever the alignment of Z's rows
//      (68 bytes at k=17) or of a panel's row slice;
//   2. chunks: the grid is (32-row blocks) x (1024-column chunks, fixed in
//      global columns).  A block walks its chunk in 128-column tiles through
//      a two-stage cp.async pipeline: the next tile's A1, A2, z_j and |z_j|^2
//      load while the current one is scored.  A rows go as 16-byte copies
//      when both adjacencies and their rows are 16-byte aligned, else as
//      4-byte copies, chosen per call.  A thread scores a 4-row x 4-column
//      register micro-tile, so each staged z value serves four products;
//      each row's terms add up in ascending column within a lane, then over
//      the 32 lanes by a fixed shuffle tree, into the (chunk, row) partial;
//   3. finish: F_i sums its chunk partials in ascending chunk.
// A row's sum depends only on its data and the global columns, never on m
// or its place in the block, so a row panel's scores are bitwise the same
// rows of the square call.  No atomics: bitwise repeatable.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;       // rows per block (8 row groups of 4)
constexpr int JT = 128;        // columns per tile (32 lanes x 4)
constexpr int CHUNK = 1024;    // columns per block: a fixed chunk of global columns
constexpr int THREADS = 256;
constexpr int K_MAX = 64;      // widest embedding (shared memory holds two stages of z_j)

__host__ __device__ constexpr int round_up(int v, int to) { return (v + to - 1) / to * to; }

// Floats of one pipeline stage: A1, A2 tiles, z_j of both embeddings, |z_j|^2 of both.
__host__ __device__ constexpr int stage_floats(int k) { return 2 * ROWS * JT + 2 * k * JT + 2 * JT; }

size_t smem_bytes(int k) { return ((size_t)2 * stage_floats(k) + 2 * (size_t)k * ROWS) * 4; }

// The scratch layout, in floats: transposed z_i (2, k, mp), z_j (2, k, np),
// |z_i|^2 (2, mp), |z_j|^2 (2, np), partials (chunks, m).
struct Layout {
  int mp, np, chunks;
  size_t zi, zj, sqi, sqj, part, total;
  __host__ __device__ Layout(int m, int n, int k) {
    mp = round_up(m, ROWS);
    np = round_up(n, JT);
    chunks = (n + CHUNK - 1) / CHUNK;
    zi = 0;
    zj = zi + 2 * (size_t)k * mp;
    sqi = zj + 2 * (size_t)k * np;
    sqj = sqi + 2 * (size_t)mp;
    part = sqj + 2 * (size_t)np;
    total = part + (size_t)chunks * m;
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// One thread per padded row of each operand (z1i, z2i over mp rows, z1j,
// z2j over np): |z|^2 by one fmaf chain, and the row into (k, rows).
__global__ void cad_scores_prep(const float* __restrict__ z1i, const float* __restrict__ z1j,
                                const float* __restrict__ z2i, const float* __restrict__ z2j,
                                float* __restrict__ scratch, int m, int n, int k) {
  const Layout L(m, n, k);
  const int total = 2 * (L.mp + L.np);
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    const bool side_i = e < 2 * L.mp;
    const int rows = side_i ? L.mp : L.np;
    const int f = side_i ? e : e - 2 * L.mp;
    const int emb = f / rows, r = f % rows;
    const float* z = side_i ? (emb == 0 ? z1i : z2i) : (emb == 0 ? z1j : z2j);
    const bool live = r < (side_i ? m : n);
    float* zt = scratch + (side_i ? L.zi : L.zj) + (size_t)emb * k * rows;
    float sq = 0.0f;
    for (int c = 0; c < k; ++c) {
      const float v = live ? z[(size_t)r * k + c] : 0.0f;
      sq = fmaf(v, v, sq);
      zt[(size_t)c * rows + r] = v;
    }
    scratch[(side_i ? L.sqi : L.sqj) + (size_t)emb * rows + r] = sq;
  }
}

template <bool ALIGNED>
__device__ __forceinline__ void load_a(float* dst, const float* __restrict__ A, int i0, int j0,
                                       int m, int n) {
  if (ALIGNED) {  // n % 4 == 0 and A 16-byte aligned: whole 16-byte vectors in or out
    for (int e = threadIdx.x; e < ROWS * JT / 4; e += THREADS) {
      const int r = e / (JT / 4), c = (e % (JT / 4)) * 4;
      const bool ok = i0 + r < m && j0 + c < n;
      cp_async16(dst + r * JT + c, ok ? A + (size_t)(i0 + r) * n + j0 + c : A, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * JT; e += THREADS) {
      const int r = e / JT, c = e % JT;
      const bool ok = i0 + r < m && j0 + c < n;
      cp_async4(dst + r * JT + c, ok ? A + (size_t)(i0 + r) * n + j0 + c : A, ok);
    }
  }
}

template <bool ALIGNED>
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ A1,
                                           const float* __restrict__ A2,
                                           const float* __restrict__ scratch, const Layout& L,
                                           int i0, int j0, int m, int n, int k) {
  load_a<ALIGNED>(st, A1, i0, j0, m, n);
  load_a<ALIGNED>(st + ROWS * JT, A2, i0, j0, m, n);
  float* zs = st + 2 * ROWS * JT;  // (2, k, JT) then (2, JT): always in the padded scratch
  for (int e = threadIdx.x; e < (2 * k + 2) * (JT / 4); e += THREADS) {
    const int row = e / (JT / 4), c = (e % (JT / 4)) * 4;  // row: emb * k + c, then 2 sq rows
    const float* src = row < 2 * k
                           ? scratch + L.zj + (size_t)row * L.np + j0 + c
                           : scratch + L.sqj + (size_t)(row - 2 * k) * L.np + j0 + c;
    cp_async16(zs + row * JT + c, src, true);
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(THREADS, 2)
cad_scores_chunks(const float* __restrict__ A1, const float* __restrict__ A2,
                  float* __restrict__ scratch, float v1, float v2, int m, int n, int k) {
  extern __shared__ __align__(16) float smem[];
  const Layout L(m, n, k);
  const int sf = stage_floats(k);
  float* zi = smem + 2 * sf;  // (2, k, ROWS): this block's z_i, transposed
  const int tid = threadIdx.x;
  const int rg = tid / 32;    // row group: rows 4 rg .. 4 rg + 3 (one warp)
  const int cg = tid % 32;    // column group: columns 4 cg .. 4 cg + 3 of a tile
  const int i0 = blockIdx.x * ROWS;
  const int jbeg = blockIdx.y * CHUNK;
  const int tiles = (min(n, jbeg + CHUNK) - jbeg + JT - 1) / JT;

  for (int e = tid; e < 2 * k * (ROWS / 4); e += THREADS) {
    const int row = e / (ROWS / 4), c = (e % (ROWS / 4)) * 4;  // row: emb * k + c
    cp_async16(zi + row * ROWS + c, scratch + L.zi + (size_t)row * L.mp + i0 + c, true);
  }
  load_stage<ALIGNED>(smem, A1, A2, scratch, L, i0, jbeg, m, n, k);
  cp_async_commit();
  const float4 sqi1 = *reinterpret_cast<const float4*>(scratch + L.sqi + i0 + 4 * rg);
  const float4 sqi2 = *reinterpret_cast<const float4*>(scratch + L.sqi + L.mp + i0 + 4 * rg);
  const float si1[4] = {sqi1.x, sqi1.y, sqi1.z, sqi1.w};
  const float si2[4] = {sqi2.x, sqi2.y, sqi2.z, sqi2.w};

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles)
      load_stage<ALIGNED>(smem + ((t + 1) & 1) * sf, A1, A2, scratch, L, i0, jbeg + (t + 1) * JT,
                          m, n, k);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const float* st = smem + (t & 1) * sf;
    const float* zj = st + 2 * ROWS * JT;
    float x1[4][4], x2[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) x1[r][q] = x2[r][q] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < k; ++c) {
      const float4 a1 = *reinterpret_cast<const float4*>(zi + c * ROWS + 4 * rg);
      const float4 a2 = *reinterpret_cast<const float4*>(zi + (k + c) * ROWS + 4 * rg);
      const float4 b1 = *reinterpret_cast<const float4*>(zj + c * JT + 4 * cg);
      const float4 b2 = *reinterpret_cast<const float4*>(zj + (k + c) * JT + 4 * cg);
      const float u1[4] = {a1.x, a1.y, a1.z, a1.w}, w1[4] = {b1.x, b1.y, b1.z, b1.w};
      const float u2[4] = {a2.x, a2.y, a2.z, a2.w}, w2[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x1[r][q] = fmaf(u1[r], w1[q], x1[r][q]);
          x2[r][q] = fmaf(u2[r], w2[q], x2[r][q]);
        }
    }
    const float4 q1 = *reinterpret_cast<const float4*>(zj + 2 * k * JT + 4 * cg);
    const float4 q2 = *reinterpret_cast<const float4*>(zj + (2 * k + 1) * JT + 4 * cg);
    const float sj1[4] = {q1.x, q1.y, q1.z, q1.w}, sj2[4] = {q2.x, q2.y, q2.z, q2.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 e1 = *reinterpret_cast<const float4*>(st + (4 * rg + r) * JT + 4 * cg);
      const float4 e2 = *reinterpret_cast<const float4*>(st + ROWS * JT + (4 * rg + r) * JT + 4 * cg);
      const float a1[4] = {e1.x, e1.y, e1.z, e1.w}, a2[4] = {e2.x, e2.y, e2.z, e2.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d1 = v1 * (si1[r] + sj1[q] - 2.0f * x1[r][q]);
        const float d2 = v2 * (si2[r] + sj2[q] - 2.0f * x2[r][q]);
        acc[r] += fabsf(a1[q] - a2[q]) * fabsf(d1 - d2);
      }
    }
    __syncthreads();  // the next load overwrites this stage
  }

  float* part = scratch + L.part + (size_t)blockIdx.y * m;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float v = rt_warp_sum(acc[r]);
    const int i = i0 + 4 * rg + r;
    if (cg == 0 && i < m) part[i] = v;
  }
}

// F_i = sum over chunks (ascending) of the chunk partials.
__global__ void cad_scores_finish(const float* __restrict__ scratch, float* __restrict__ F, int m,
                                  int n, int k) {
  const Layout L(m, n, k);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m; i += gridDim.x * blockDim.x) {
    float t = 0.0f;
    for (int ch = 0; ch < L.chunks; ++ch) t += scratch[L.part + (size_t)ch * m + i];
    F[i] = t;
  }
}

template <bool ALIGNED>
cudaError_t launch_chunks(const float* a1, const float* a2, float* scratch, float v1, float v2,
                          int m, int n, int k, cudaStream_t st) {
  const size_t smem = smem_bytes(k);
  const cudaError_t err = cudaFuncSetAttribute(
      cad_scores_chunks<ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + ROWS - 1) / ROWS, (n + CHUNK - 1) / CHUNK);
  cad_scores_chunks<ALIGNED><<<grid, THREADS, smem, st>>>(a1, a2, scratch, v1, v2, m, n, k);
  return cudaGetLastError();
}

int blocks_for(long long items) {
  const long long b = (items + 255) / 256;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// The widest embedding rt_cad_scores takes.
extern "C" int rt_cad_scores_k_max() { return K_MAX; }

// Floats of the scratch rt_cad_scores takes for an (m, n) tile and width k.
extern "C" long long rt_cad_scores_scratch_elems(int m, int n, int k) {
  return (long long)Layout(m, n, k).total;
}

// F (m,) for an (m, n) tile: z1i, z2i (m, k), z1j, z2j (n, k), fp32; m, n >= 1, 1 <= k <= K_MAX.
extern "C" int rt_cad_scores(const void* a1, const void* a2, const void* z1i, const void* z1j,
                             const void* z2i, const void* z2j, float v1, float v2, void* f,
                             void* scratch, int m, int n, int k, void* stream) {
  if (k < 1 || k > K_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Layout L(m, n, k);
  float* s = static_cast<float*>(scratch);
  cad_scores_prep<<<blocks_for(2LL * (L.mp + L.np)), 256, 0, st>>>(
      static_cast<const float*>(z1i), static_cast<const float*>(z1j),
      static_cast<const float*>(z2i), static_cast<const float*>(z2j), s, m, n, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p1 = static_cast<const float*>(a1);
  const float* p2 = static_cast<const float*>(a2);
  const bool aligned = n % 4 == 0 && reinterpret_cast<uintptr_t>(p1) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p2) % 16 == 0;
  err = aligned ? launch_chunks<true>(p1, p2, s, v1, v2, m, n, k, st)
                : launch_chunks<false>(p1, p2, s, v1, v2, m, n, k, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  cad_scores_finish<<<blocks_for(m), 256, 0, st>>>(s, static_cast<float*>(f), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
