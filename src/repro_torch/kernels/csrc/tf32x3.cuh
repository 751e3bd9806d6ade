// The fp32 product on the tensor cores as three TF32 products ("3xTF32"),
// shared by block_matmul.cu (the resident chain's GEMMs) and stream_gemm.cu
// (the out-of-core chain's K steps):
//     C = init + sign * (A @ B)        (init optional, sign +-1)
// with A and B each fp32, bf16, or bf16 bit patterns carried as uint16.
//
// Numerics.  Each fp32 operand is split into a TF32 high part and the TF32
// rounding of the rest, x = hi + lo + O(2^-22 |x|), and
//     A B ~= A_lo B_hi + A_hi B_lo + A_hi B_hi
// (the A_lo B_lo term is below fp32's own rounding).  A bf16 operand (or its
// bits) is exact in TF32: its lo part is zero, so its pass writes hi only and
// the products that read its lo are skipped -- 3, 2, 2 or 1 products for
// (fp32, fp32), (bits, fp32), (fp32, bits), (bits, bits).  The small terms go
// into the accumulator first.  The tensor cores do not round to nearest as
// they accumulate, so each stage's 32-deep partial starts fresh and is added
// into an fp32 total with a round-to-nearest FADD on the CUDA cores.
//
// Design.
// * Split pass (`split_kernel`): hi = tf32_rna(x) (cvt.rna.tf32.f32), lo =
//   tf32_rna(x - hi), written row-major for A and transposed for B, since
//   wgmma takes TF32 operands K-major only.  Rows keep their count; the row
//   stride is k rounded up to the K tile (32, and at least 32), zero-filled,
//   so TMA's 16-byte stride rule holds at any k.  When B is A (the chain's
//   T T) one pass reads A once and writes both layouts.
// * Main kernel (`gemm_tf32_kernel<NPA, NPB>`): one block per 128 x 128 tile
//   of C, 2 consumer warpgroups (64 rows each) and a producer warp that keeps
//   a ring of 3 stages filled by TMA under mbarriers (each stage: NPA A tiles
//   and NPB B tiles of 128 x 32 fp32 in the 128-byte swizzle, 64 KB at most).
//   Per 8-deep k step a warpgroup issues its m64n128k8 products into a
//   register partial.  TMA zero-fills rows past m and n, so only the epilogue
//   masks.  Tiles are walked in groups of 8 tile rows so concurrent blocks
//   share operand panels in L2.
// * Epilogue: C = init +- acc, reading init at the index it writes, so C may
//   alias init (the out-of-core chain accumulates in place).
// * No split-K and no atomics: each output is summed over k in one order by
//   one warpgroup, so two runs are bitwise equal.
#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int TC_BM = 128;  // rows of a C tile (two warpgroups of 64)
constexpr int TC_BN = 128;  // columns of a C tile
constexpr int TC_BK = 32;   // k of a stage: one 128-byte fp32 row
constexpr int TC_NWG = 2;
constexpr int TC_NST = 3;
constexpr int TC_THREADS = 128 * TC_NWG + 32;  // + one producer warp
constexpr int TC_GROUP_M = 8;
constexpr int TC_TILE = TC_BM * TC_BK;  // fp32 elements of one operand tile (BM == BN)
static_assert(TC_BM == TC_BN, "A and B tiles share one size");

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// Splits src (rows x cols, row-major) into TF32 parts.  Row-major copy:
// rm_*[i][j] for i < rm_rows, j < rm_cols (leading dim rm_cols); transposed
// copy: t_*[j][i] for j < t_rows, i < t_cols (leading dim t_cols).  Positions
// outside src get zeros.  Any pointer may be null.  Block 32 x 8 over a 32 x
// 32 tile of source coordinates; the transpose goes through shared memory.
template <typename T>
__global__ void __launch_bounds__(256)
split_kernel(const T* __restrict__ src, int rows, int cols, float* rm_hi, float* rm_lo,
             int rm_rows, int rm_cols, float* t_hi, float* t_lo, int t_rows, int t_cols) {
  __shared__ float hs[32][33];
  __shared__ float ls[32][33];
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int i = i0 + r, j = j0 + tx;
    const float x = (i < rows && j < cols) ? to_f32(src[(size_t)i * cols + j]) : 0.0f;
    const float hi = tf32_rna(x);
    const float lo = tf32_rna(__fsub_rn(x, hi));
    if (rm_hi != nullptr && i < rm_rows && j < rm_cols) {
      rm_hi[(size_t)i * rm_cols + j] = hi;
      if (rm_lo != nullptr) rm_lo[(size_t)i * rm_cols + j] = lo;
    }
    hs[r][tx] = hi;
    ls[r][tx] = lo;
  }
  if (t_hi == nullptr) return;  // uniform over the block
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int tj = j0 + r, ti = i0 + tx;  // t row = source column, t column = source row
    if (tj < t_rows && ti < t_cols) {
      t_hi[(size_t)tj * t_cols + ti] = hs[tx][r];
      if (t_lo != nullptr) t_lo[(size_t)tj * t_cols + ti] = ls[tx][r];
    }
  }
}

// Operand parts per stage: 2 (hi, lo) for fp32, 1 (hi) for bf16 or its bits.
template <int NPA, int NPB>
struct Tf32Smem {
  float a[TC_NST][NPA][TC_TILE];
  float b[TC_NST][NPB][TC_TILE];
  uint64_t full[TC_NST];
  uint64_t empty[TC_NST];
};

template <int NPA, int NPB>
__global__ void __launch_bounds__(TC_THREADS, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap ta_hi,
                 const __grid_constant__ CUtensorMap ta_lo,
                 const __grid_constant__ CUtensorMap tb_hi,
                 const __grid_constant__ CUtensorMap tb_lo, const float* init, float* c, int m,
                 int n, int n_k, int neg, int pairs) {
  extern __shared__ uint8_t smem_raw[];
  Tf32Smem<NPA, NPB>& sm = *reinterpret_cast<Tf32Smem<NPA, NPB>*>(rt_smem_align1024(smem_raw));

  // Grouped raster: TC_GROUP_M tile rows are walked column by column.
  const int tiles_m = (m + TC_BM - 1) / TC_BM, tiles_n = (n + TC_BN - 1) / TC_BN;
  const int per_group = TC_GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * TC_GROUP_M;
  const int rows_g = min(tiles_m - first_m, TC_GROUP_M);
  const int r = blockIdx.x % per_group;
  const int m0 = (first_m + r % rows_g) * TC_BM;
  const int n0 = (r / rows_g) * TC_BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TC_NST; ++s) {
      rt_mbar_init(&sm.full[s], 1);
      rt_mbar_init(&sm.empty[s], 4 * TC_NWG);  // one arrival per consumer warp
    }
    rt_fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * TC_NWG) {  // producer
    if (lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int st = it % TC_NST;
        if (it >= TC_NST) rt_mbar_wait(&sm.empty[st], ((it / TC_NST) - 1) & 1);
        rt_mbar_expect_tx(&sm.full[st], (NPA + NPB) * TC_TILE * sizeof(float));
        rt_tma_load_2d(sm.a[st][0], &ta_hi, &sm.full[st], it * TC_BK, m0);
        rt_tma_load_2d(sm.b[st][0], &tb_hi, &sm.full[st], it * TC_BK, n0);
        if (NPA == 2) rt_tma_load_2d(sm.a[st][NPA - 1], &ta_lo, &sm.full[st], it * TC_BK, m0);
        if (NPB == 2) rt_tma_load_2d(sm.b[st][NPB - 1], &tb_lo, &sm.full[st], it * TC_BK, n0);
      }
    }
    return;
  }

  // The products of one stage (32 deep) go into a fresh register partial,
  // added into the fp32 total on the CUDA cores, one round-to-nearest add per
  // stage (see the top of the file).
  const int wg = warp / 4;
  float part[64], acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = acc[i] = 0.0f;

  for (int it = 0; it < n_k; ++it) {
    const int st = it % TC_NST;
    rt_mbar_wait(&sm.full[st], (it / TC_NST) & 1);
    __syncwarp();
    rt_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 8; ++kk) {  // 8 fp32 = 32 bytes per k step
      const uint64_t a_hi = rt_desc_sw128(&sm.a[st][0][wg * 64 * TC_BK] + 8 * kk, 16, 1024);
      const uint64_t b_hi = rt_desc_sw128(&sm.b[st][0][0] + 8 * kk, 16, 1024);
      int acc_in = kk > 0;  // the stage's first product starts the partial afresh
      if (NPA == 2) {
        const uint64_t a_lo =
            rt_desc_sw128(&sm.a[st][NPA - 1][wg * 64 * TC_BK] + 8 * kk, 16, 1024);
        rt_wgmma_m64n128k8_tf32_ss(part, a_lo, b_hi, acc_in);
        acc_in = 1;
      }
      if (NPB == 2) {
        const uint64_t b_lo = rt_desc_sw128(&sm.b[st][NPB - 1][0] + 8 * kk, 16, 1024);
        rt_wgmma_m64n128k8_tf32_ss(part, a_hi, b_lo, acc_in);
        acc_in = 1;
      }
      rt_wgmma_m64n128k8_tf32_ss(part, a_hi, b_hi, acc_in);
    }
    rt_wgmma_commit();
    rt_wgmma_wait<0>();
    rt_fence_regs(part);
    __syncwarp();
    if (lane == 0) rt_mbar_arrive(&sm.empty[st]);  // the stage is consumed
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    rt_fence_regs(part);  // this stage's reads of part stay before the next stage's products
  }

  // C = init +- acc; `pairs` says that n is even and C and init are 8-byte
  // aligned, so each thread's two neighbouring columns move as one float2.
  const int row_in = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int col_in = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_in + 8 * h;
    if (row >= m) continue;
    float* cr = c + (size_t)row * n;
    const float* ir = init == nullptr ? nullptr : init + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
      const int col = col_in + 8 * j;
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (pairs) {  // col is even, so the pair is in range together
        if (col < n) {
          if (ir != nullptr) {
            const float2 i2 = *reinterpret_cast<const float2*>(ir + col);
            v0 = neg ? i2.x - v0 : i2.x + v0;
            v1 = neg ? i2.y - v1 : i2.y + v1;
          } else if (neg) {
            v0 = -v0;
            v1 = -v1;
          }
          *reinterpret_cast<float2*>(cr + col) = make_float2(v0, v1);
        }
      } else {
        if (col < n) {
          if (ir != nullptr) v0 = neg ? ir[col] - v0 : ir[col] + v0;
          else if (neg) v0 = -v0;
          cr[col] = v0;
        }
        if (col + 1 < n) {
          if (ir != nullptr) v1 = neg ? ir[col + 1] - v1 : ir[col + 1] + v1;
          else if (neg) v1 = -v1;
          cr[col + 1] = v1;
        }
      }
    }
  }
}

inline int tc_split_blocks(int extent) { return (extent + 31) / 32; }

// The split parts' row stride: k rounded up to the K tile, at least one tile.
inline int tc_k_padded(int k) { return std::max((k + TC_BK - 1) / TC_BK, 1) * TC_BK; }

// C (m x n, fp32) = init + (neg ? -1 : 1) * A (m x k) @ B (k x n).  `scratch`
// holds (NPA m + NPB n) tc_k_padded(k) floats (`scratch_elems` is checked);
// `same` says that b is a (TA == TB, NPA == NPB, m == k == n), so the split
// pass reads it once.  init may be null, and c may alias init.
template <typename TA, typename TB, int NPA, int NPB>
int tf32x3_gemm(const void* a, const void* b, int same, const float* init, int neg, float* c,
                int m, int n, int k, float* scratch, long long scratch_elems, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = tc_k_padded(k);
  const long long a_elems = (long long)m * kp, b_elems = (long long)n * kp;
  if (scratch_elems < NPA * a_elems + NPB * b_elems) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* a_hi = scratch;
  float* a_lo = NPA == 2 ? a_hi + a_elems : nullptr;
  float* b_hi = scratch + NPA * a_elems;
  float* b_lo = NPB == 2 ? b_hi + b_elems : nullptr;

  const dim3 sblock(32, 8);
  if (same) {  // B is A (m == k == n): one read, both layouts
    const dim3 grid(tc_split_blocks(std::max(kp, n)), tc_split_blocks(std::max(m, kp)));
    split_kernel<TA><<<grid, sblock, 0, s>>>(static_cast<const TA*>(a), m, k, a_hi, a_lo, m, kp,
                                             b_hi, b_lo, n, kp);
  } else {
    split_kernel<TA><<<dim3(tc_split_blocks(kp), tc_split_blocks(m)), sblock, 0, s>>>(
        static_cast<const TA*>(a), m, k, a_hi, a_lo, m, kp, nullptr, nullptr, 0, 0);
    split_kernel<TB><<<dim3(tc_split_blocks(n), tc_split_blocks(kp)), sblock, 0, s>>>(
        static_cast<const TB*>(b), k, n, nullptr, nullptr, 0, 0, b_hi, b_lo, n, kp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap maps[4];
  const cuuint64_t stride[1] = {(cuuint64_t)kp * sizeof(float)};
  const cuuint32_t box[2] = {TC_BK, TC_BM};
  float* parts[4] = {a_hi, NPA == 2 ? a_lo : a_hi, b_hi, NPB == 2 ? b_lo : b_hi};
  for (int p = 0; p < 4; ++p) {
    const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)(p < 2 ? m : n)};
    err = rt_encode_sw128(&maps[p], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, parts[p], dims, stride,
                          box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(Tf32Smem<NPA, NPB>) + 1024;
  err = cudaFuncSetAttribute(gemm_tf32_kernel<NPA, NPB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pairs = (n % 2 == 0) && (reinterpret_cast<uintptr_t>(c) % 8 == 0) &&
                    (init == nullptr || reinterpret_cast<uintptr_t>(init) % 8 == 0);
  const int tiles = ((m + TC_BM - 1) / TC_BM) * ((n + TC_BN - 1) / TC_BN);
  gemm_tf32_kernel<NPA, NPB><<<tiles, TC_THREADS, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], init, c, m, n, kp / TC_BK, neg, pairs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
