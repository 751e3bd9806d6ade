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
// the rest, and the product is three TF32 products on `wgmma`, 3 x 2 n^3 at
// 495 TFLOP/s = 14.1 ms at n=10512; bf16 operands are exact in TF32 and take
// one.  The split pass and the TMA / mbarrier / wgmma kernel live in
// tf32x3.cuh, shared with stream_gemm.cu; this file holds the entries.
#include "tf32x3.cuh"

// C (m x n, fp32) = A (m x k) @ B (k x n), both fp32: three TF32 products.
// `scratch` holds 2 (m + n) * round_up(k, 32) floats (`scratch_elems` is
// checked); `same` says that b is a, so the split pass reads it once.
extern "C" int rt_block_matmul_f32(const void* a, const void* b, void* c, int m, int n, int k,
                                   void* scratch, long long scratch_elems, int same, void* stream) {
  return tf32x3_gemm<float, float, 2, 2>(a, b, same, nullptr, 0, static_cast<float*>(c), m, n, k,
                                         static_cast<float*>(scratch), scratch_elems, stream);
}

// The same for two bf16 operands: exact in TF32, so one product and half the scratch.
extern "C" int rt_block_matmul_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                    void* scratch, long long scratch_elems, int same,
                                    void* stream) {
  return tf32x3_gemm<__nv_bfloat16, __nv_bfloat16, 1, 1>(a, b, same, nullptr, 0,
                                                         static_cast<float*>(c), m, n, k,
                                                         static_cast<float*>(scratch),
                                                         scratch_elems, stream);
}

// The split pass alone, row-major (rows x cols): the check against ref.split_tf32.
extern "C" int rt_split_tf32(const void* x, void* hi, void* lo, int rows, int cols, void* stream) {
  split_kernel<float><<<dim3(tc_split_blocks(cols), tc_split_blocks(rows)), dim3(32, 8), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, cols, static_cast<float*>(hi), static_cast<float*>(lo),
      rows, cols, nullptr, nullptr, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
