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
// never stored: each block rebuilds its tile of them from the (n, k)
// embeddings, which stay in L2.
//
// Layout: a block owns ROWS=32 rows and walks all columns in tiles of
// JT=64 (32 for k > 32).  Per tile, the A1/A2 tiles and the tile's z_j rows
// of both embeddings are staged in shared memory with coalesced loads, and
// |z_j|^2 is computed once per column.  Thread (r, l) -- r = row in the block, l = warp -- keeps
// its row's z_i in registers and takes the tile's columns l, l+8, ...: the
// z_j reads are warp-wide broadcasts and the padded A tile reads are free of
// bank conflicts.  Each row's 8 partial sums are added in a fixed order: no
// atomics, bitwise repeatable.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 32;                // rows per block (one per lane)
constexpr int LANES = THREADS / ROWS;   // column lanes per row (one per warp)

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
cad_scores_kernel(const float* __restrict__ A1, const float* __restrict__ A2,
                  const float* __restrict__ Z1i, const float* __restrict__ Z1j,
                  const float* __restrict__ Z2i, const float* __restrict__ Z2j, float v1,
                  float v2, float* __restrict__ F, int m, int n, int k) {
  static_assert(KMAX % 4 == 0, "z rows are read as float4");
  constexpr int JT = KMAX <= 32 ? 64 : 32;  // columns per tile (keeps smem under 48 KB)
  constexpr int A_STRIDE = JT + 1;           // padding: column reads hit distinct banks
  constexpr int Z_STRIDE = KMAX + 4;         // padding, still 16-byte aligned rows
  __shared__ float a1s[ROWS][A_STRIDE];
  __shared__ float a2s[ROWS][A_STRIDE];
  __shared__ __align__(16) float z1s[JT][Z_STRIDE];
  __shared__ __align__(16) float z2s[JT][Z_STRIDE];
  __shared__ float sq1s[JT];
  __shared__ float sq2s[JT];
  __shared__ float red[LANES][ROWS];

  const int tid = threadIdx.x;
  const int r = tid % ROWS;
  const int l = tid / ROWS;
  const int i0 = blockIdx.x * ROWS;
  const int i = i0 + r;

  // This thread's row of both embeddings, zero-padded to KMAX.
  float zi1[KMAX], zi2[KMAX];
  float sqi1 = 0.0f, sqi2 = 0.0f;
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    zi1[c] = (i < m && c < k) ? Z1i[(size_t)i * k + c] : 0.0f;
    zi2[c] = (i < m && c < k) ? Z2i[(size_t)i * k + c] : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {  // the zero padding adds exact zeros
    sqi1 = fmaf(zi1[c], zi1[c], sqi1);
    sqi2 = fmaf(zi2[c], zi2[c], sqi2);
  }

  float acc = 0.0f;
  for (int j0 = 0; j0 < n; j0 += JT) {
    // Stage the A tiles (coalesced along j) and the tile's z_j rows.
    for (int e = tid; e < ROWS * JT; e += THREADS) {
      const int rr = e / JT, jj = e % JT;
      const bool ok = i0 + rr < m && j0 + jj < n;
      const size_t off = (size_t)(i0 + rr) * n + (j0 + jj);
      a1s[rr][jj] = ok ? A1[off] : 0.0f;
      a2s[rr][jj] = ok ? A2[off] : 0.0f;
    }
    for (int e = tid; e < JT * KMAX; e += THREADS) {
      const int jj = e / KMAX, c = e % KMAX;
      const bool ok = j0 + jj < n && c < k;
      z1s[jj][c] = ok ? Z1j[(size_t)(j0 + jj) * k + c] : 0.0f;
      z2s[jj][c] = ok ? Z2j[(size_t)(j0 + jj) * k + c] : 0.0f;
    }
    __syncthreads();
    if (tid < JT) {
      float s1 = 0.0f, s2 = 0.0f;
      for (int c = 0; c < k; ++c) {
        s1 = fmaf(z1s[tid][c], z1s[tid][c], s1);
        s2 = fmaf(z2s[tid][c], z2s[tid][c], s2);
      }
      sq1s[tid] = s1;
      sq2s[tid] = s2;
    }
    __syncthreads();

    for (int jj = l; jj < JT; jj += LANES) {
      float x1 = 0.0f, x2 = 0.0f;
#pragma unroll
      for (int c4 = 0; c4 < KMAX / 4; ++c4) {
        if (4 * c4 < k) {  // padded entries are zero on both sides
          const float4 b1 = *reinterpret_cast<const float4*>(&z1s[jj][4 * c4]);
          const float4 b2 = *reinterpret_cast<const float4*>(&z2s[jj][4 * c4]);
          x1 = fmaf(zi1[4 * c4 + 0], b1.x, x1);
          x1 = fmaf(zi1[4 * c4 + 1], b1.y, x1);
          x1 = fmaf(zi1[4 * c4 + 2], b1.z, x1);
          x1 = fmaf(zi1[4 * c4 + 3], b1.w, x1);
          x2 = fmaf(zi2[4 * c4 + 0], b2.x, x2);
          x2 = fmaf(zi2[4 * c4 + 1], b2.y, x2);
          x2 = fmaf(zi2[4 * c4 + 2], b2.z, x2);
          x2 = fmaf(zi2[4 * c4 + 3], b2.w, x2);
        }
      }
      const float d1 = v1 * (sqi1 + sq1s[jj] - 2.0f * x1);
      const float d2 = v2 * (sqi2 + sq2s[jj] - 2.0f * x2);
      acc += fabsf(a1s[r][jj] - a2s[r][jj]) * fabsf(d1 - d2);
    }
    __syncthreads();  // the next tile overwrites the staged operands
  }

  red[l][r] = acc;
  __syncthreads();
  if (l == 0 && i < m) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < LANES; ++w) t += red[w][r];
    F[i] = t;
  }
}

template <int KMAX>
int launch(const void* a1, const void* a2, const void* z1i, const void* z1j, const void* z2i,
           const void* z2j, float v1, float v2, void* f, int m, int n, int k, void* stream) {
  const int blocks = (m + ROWS - 1) / ROWS;
  cad_scores_kernel<KMAX><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a1), static_cast<const float*>(a2),
      static_cast<const float*>(z1i), static_cast<const float*>(z1j),
      static_cast<const float*>(z2i), static_cast<const float*>(z2j), v1, v2,
      static_cast<float*>(f), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k must be <= 64 (the wrapper checks); k <= 32 takes the leaner instance.
extern "C" int rt_cad_scores(const void* a1, const void* a2, const void* z1i, const void* z1j,
                             const void* z2i, const void* z2j, float v1, float v2, void* f,
                             int m, int n, int k, void* stream) {
  if (k <= 32) return launch<32>(a1, a2, z1i, z1j, z2i, z2j, v1, v2, f, m, n, k, stream);
  return launch<64>(a1, a2, z1i, z1j, z2i, z2j, v1, v2, f, m, n, k, stream);
}
