// C = A @ B for the chain: fp32 as three TF32 tensor-core products ("3xTF32").
//
// Replaces: src/repro/kernels/block_matmul.py `block_matmul` (Pallas
// `_matmul_kernel`, pallas_call at :67), reached on the chain through
// core/distmatrix.py `_local_dot`.
//
// Bound on an H100: operations.  A chain GEMM at n=10512 is 2 n^3 = 2.3
// TFLOP against 1.3 GB of operands.  Full-precision FFMA on the CUDA cores
// has a floor of ~35 ms (67 TFLOP/s); the tensor cores' TF32 alone keeps 11
// significant bits, too few for a chain that squares S up to S^(2^d).  So
// each fp32 operand is split into a TF32 high part and the TF32 rounding of
// the rest, x = hi + lo + O(2^-22 |x|), and
//     A B ~= A_lo B_hi + A_hi B_lo + A_hi B_hi
// (the A_lo B_lo term is below fp32's own rounding): three TF32 products on
// `wgmma`, 3 x 2 n^3 at 495 TFLOP/s = 14.1 ms at n=10512.  The small terms
// go into the accumulator first.
//
// Design.
// * Split pass (`split_kernel`): hi = tf32_rna(x) (cvt.rna.tf32.f32), lo =
//   tf32_rna(x - hi), written row-major for A and transposed for B, since
//   wgmma takes TF32 operands K-major only.  Rows keep their count; the row
//   stride is k rounded up to the K tile (32), zero-filled, so TMA's 16-byte
//   stride rule holds at any k.  When B is A (the chain's T T) one pass reads
//   A once and writes both layouts.  bf16 operands are exact in TF32: their
//   pass writes hi only and the main kernel runs one product.
// * Main kernel: one block per 128 x 128 tile of C, 2 consumer warpgroups
//   (64 rows each) and a producer warp that keeps a ring of 3 stages filled
//   by TMA under mbarriers (each stage: A_hi, A_lo, B_hi, B_lo tiles of 128 x
//   32 fp32 in the 128-byte swizzle, 64 KB).  Per 8-deep k step a warpgroup
//   issues three m64n128k8 products into a register accumulator.  The tensor
//   cores do not round to nearest as they accumulate, and with one running
//   accumulator over all of k the error against float64 grows faster than
//   k; so each stage's 32-deep partial starts fresh and is added into an
//   fp32 total with a round-to-nearest FADD on the CUDA cores.  TMA
//   zero-fills rows past m and n, so only the epilogue masks.  Tiles are
//   walked in groups of 8 tile rows so concurrent blocks share operand panels
//   in L2.
// * No split-K and no atomics: each output is summed over k in one order by
//   one warpgroup, so two runs are bitwise equal.
#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // rows of a C tile (two warpgroups of 64)
constexpr int BN = 128;  // columns of a C tile
constexpr int BK = 32;   // k of a stage: one 128-byte fp32 row
constexpr int NWG = 2;
constexpr int NST = 3;
constexpr int THREADS = 128 * NWG + 32;  // + one producer warp
constexpr int GROUP_M = 8;
constexpr int TILE = BM * BK;  // fp32 elements of one operand tile (BM == BN)
static_assert(BM == BN, "A and B tiles share one size");

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

template <int NP>  // operand parts per stage: 2 (hi, lo) or 1 (hi)
struct GemmSmem {
  float a[NST][NP][TILE];
  float b[NST][NP][TILE];
  uint64_t full[NST];
  uint64_t empty[NST];
};

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
gemm_tf32_kernel(const __grid_constant__ CUtensorMap ta_hi,
                 const __grid_constant__ CUtensorMap ta_lo,
                 const __grid_constant__ CUtensorMap tb_hi,
                 const __grid_constant__ CUtensorMap tb_lo, float* __restrict__ c, int m, int n,
                 int n_k) {
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<NP>& sm = *reinterpret_cast<GemmSmem<NP>*>(rt_smem_align1024(smem_raw));

  // Grouped raster: GROUP_M tile rows are walked column by column.
  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int rows_g = min(tiles_m - first_m, GROUP_M);
  const int r = blockIdx.x % per_group;
  const int m0 = (first_m + r % rows_g) * BM;
  const int n0 = (r / rows_g) * BN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      rt_mbar_init(&sm.full[s], 1);
      rt_mbar_init(&sm.empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    rt_fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // producer
    if (lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int st = it % NST;
        if (it >= NST) rt_mbar_wait(&sm.empty[st], ((it / NST) - 1) & 1);
        rt_mbar_expect_tx(&sm.full[st], 2 * NP * TILE * sizeof(float));
        rt_tma_load_2d(sm.a[st][0], &ta_hi, &sm.full[st], it * BK, m0);
        rt_tma_load_2d(sm.b[st][0], &tb_hi, &sm.full[st], it * BK, n0);
        if (NP == 2) {
          rt_tma_load_2d(sm.a[st][NP - 1], &ta_lo, &sm.full[st], it * BK, m0);
          rt_tma_load_2d(sm.b[st][NP - 1], &tb_lo, &sm.full[st], it * BK, n0);
        }
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
    const int st = it % NST;
    rt_mbar_wait(&sm.full[st], (it / NST) & 1);
    __syncwarp();
    rt_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {  // 8 fp32 = 32 bytes per k step
      const uint64_t a_hi = rt_desc_sw128(&sm.a[st][0][wg * 64 * BK] + 8 * kk, 16, 1024);
      const uint64_t b_hi = rt_desc_sw128(&sm.b[st][0][0] + 8 * kk, 16, 1024);
      if (NP == 2) {
        const uint64_t a_lo = rt_desc_sw128(&sm.a[st][NP - 1][wg * 64 * BK] + 8 * kk, 16, 1024);
        const uint64_t b_lo = rt_desc_sw128(&sm.b[st][NP - 1][0] + 8 * kk, 16, 1024);
        rt_wgmma_m64n128k8_tf32_ss(part, a_lo, b_hi, kk > 0);
        rt_wgmma_m64n128k8_tf32_ss(part, a_hi, b_lo, 1);
        rt_wgmma_m64n128k8_tf32_ss(part, a_hi, b_hi, 1);
      } else {
        rt_wgmma_m64n128k8_tf32_ss(part, a_hi, b_hi, kk > 0);
      }
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

  const int row_in = m0 + 64 * wg + 16 * (warp % 4) + lane / 4;
  const int col_in = n0 + 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_in + 8 * h;
    if (row >= m) continue;
    float* cr = c + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col_in + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if ((n & 1) == 0) {  // col is even, so the pair is 8-byte aligned and in range together
        if (col < n) *reinterpret_cast<float2*>(cr + col) = make_float2(v0, v1);
      } else {
        if (col < n) cr[col] = v0;
        if (col + 1 < n) cr[col + 1] = v1;
      }
    }
  }
}

int split_blocks(int extent) { return (extent + 31) / 32; }

template <typename T, int NP>
int block_matmul_tc(const void* a, const void* b, int same, void* c, int m, int n, int k,
                    float* scratch, long long scratch_elems, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kp = (k + BK - 1) / BK * BK;
  const long long a_elems = (long long)m * kp, b_elems = (long long)n * kp;
  if (scratch_elems < NP * (a_elems + b_elems)) return static_cast<int>(cudaErrorInvalidValue);
  float* a_hi = scratch;
  float* a_lo = NP == 2 ? a_hi + a_elems : nullptr;
  float* b_hi = scratch + NP * a_elems;
  float* b_lo = NP == 2 ? b_hi + b_elems : nullptr;

  const dim3 sblock(32, 8);
  if (same) {  // B is A (m == k == n): one read, both layouts
    const dim3 grid(split_blocks(std::max(kp, n)), split_blocks(std::max(m, kp)));
    split_kernel<T><<<grid, sblock, 0, s>>>(static_cast<const T*>(a), m, k, a_hi, a_lo, m, kp,
                                            b_hi, b_lo, n, kp);
  } else {
    split_kernel<T><<<dim3(split_blocks(kp), split_blocks(m)), sblock, 0, s>>>(
        static_cast<const T*>(a), m, k, a_hi, a_lo, m, kp, nullptr, nullptr, 0, 0);
    split_kernel<T><<<dim3(split_blocks(n), split_blocks(kp)), sblock, 0, s>>>(
        static_cast<const T*>(b), k, n, nullptr, nullptr, 0, 0, b_hi, b_lo, n, kp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap maps[4];
  const cuuint64_t stride[1] = {(cuuint64_t)kp * sizeof(float)};
  const cuuint32_t box[2] = {BK, BM};
  float* parts[4] = {a_hi, NP == 2 ? a_lo : a_hi, b_hi, NP == 2 ? b_lo : b_hi};
  for (int p = 0; p < 4; ++p) {
    const cuuint64_t dims[2] = {(cuuint64_t)kp, (cuuint64_t)(p < 2 ? m : n)};
    err = rt_encode_sw128(&maps[p], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, parts[p], dims, stride,
                          box);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = sizeof(GemmSmem<NP>) + 1024;
  err = cudaFuncSetAttribute(gemm_tf32_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  gemm_tf32_kernel<NP><<<tiles, THREADS, smem, s>>>(maps[0], maps[1], maps[2], maps[3],
                                                    static_cast<float*>(c), m, n, kp / BK);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C (m x n, fp32) = A (m x k) @ B (k x n), both fp32: three TF32 products.
// `scratch` holds 2 (m + n) * round_up(k, 32) floats (`scratch_elems` is
// checked); `same` says that b is a, so the split pass reads it once.
extern "C" int rt_block_matmul_f32(const void* a, const void* b, void* c, int m, int n, int k,
                                   void* scratch, long long scratch_elems, int same, void* stream) {
  return block_matmul_tc<float, 2>(a, b, same, c, m, n, k, static_cast<float*>(scratch),
                                   scratch_elems, stream);
}

// The same for two bf16 operands: exact in TF32, so one product and half the scratch.
extern "C" int rt_block_matmul_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                    void* scratch, long long scratch_elems, int same,
                                    void* stream) {
  return block_matmul_tc<__nv_bfloat16, 1>(a, b, same, c, m, n, k, static_cast<float*>(scratch),
                                           scratch_elems, stream);
}

// The split pass alone, row-major (rows x cols): the check against ref.split_tf32.
extern "C" int rt_split_tf32(const void* x, void* hi, void* lo, int rows, int cols, void* stream) {
  split_kernel<float><<<dim3(split_blocks(cols), split_blocks(rows)), dim3(32, 8), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, cols, static_cast<float*>(hi), static_cast<float*>(lo),
      rows, cols, nullptr, nullptr, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
