// C = A @ B in fp32 on CUDA cores (FFMA, not TF32): the chain GEMM.
//
// Replaces: src/repro/kernels/block_matmul.py `block_matmul` (Pallas
// `_matmul_kernel`, pallas_call at :67), reached on the chain through
// core/distmatrix.py `_local_dot`.
//
// Bound on an H100: operations.  A chain GEMM at n=10512 is 2 n^3 = 2.3
// TFLOP against 1.3 GB of operands; at the 67 TFLOP/s fp32 peak that is
// ~35 ms against ~0.4 ms of HBM traffic.  The chain raises S~ to S~^(2^d),
// so rounding is amplified 2^d-fold and the tensor cores' TF32 is not an
// option: the kernel runs full-precision FFMA.
//
// Design: the register-blocked SIMT tile loop of gemm_tile.cuh (128x128
// output tiles, 8x8 per thread, double-buffered K slabs), with no init.
// bf16 inputs are widened to fp32 on their way into shared memory.
#include "gemm_tile.cuh"

extern "C" int rt_block_matmul_f32(const void* a, const void* b, void* c, int m, int n, int k,
                                   void* stream) {
  return launch_gemm<float, float>(a, b, nullptr, c, m, n, k, false, stream);
}

extern "C" int rt_block_matmul_bf16(const void* a, const void* b, void* c, int m, int n, int k,
                                    void* stream) {
  return launch_gemm<__nv_bfloat16, __nv_bfloat16>(a, b, nullptr, c, m, n, k, false, stream);
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
