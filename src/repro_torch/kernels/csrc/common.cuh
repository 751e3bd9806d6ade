// Shared helpers for the hand-written Hopper kernels of repro_torch.
//
// Every entry point is `extern "C"`, takes raw device pointers and the
// caller's cudaStream_t, launches on that stream without synchronising,
// and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RT_WARP 32

// Deterministic warp sum: a fixed shuffle tree, lane 0 holds the result.
__device__ __forceinline__ float rt_warp_sum(float v) {
#pragma unroll
  for (int off = RT_WARP / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Operand widening to fp32.  bf16 bit patterns (uint16, carried by PyTorch as
// int16) become the high half of a float32: the exact widening of the host
// codec `_bf16_u16_to_f32`.
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// 16 bytes (a 16-byte aligned address) widened to fp32: 4 floats, or 8 bf16
// (as __nv_bfloat16 or as bit patterns), each exactly as to_f32 widens it.
__device__ __forceinline__ void widen16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void widen16(const uint16_t* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // little endian: element 2i is the low half of word i
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* out) {
  widen16(reinterpret_cast<const uint16_t*>(p), out);
}

// Narrowing from fp32 to an output type: round to nearest even for bf16, as
// PyTorch's .to(torch.bfloat16) does.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// splitmix32 counter hash, bit-identical to repro_torch.core.rng (and to the
// JAX package's repro.core.rng): uint32_t arithmetic wraps natively.
// ---------------------------------------------------------------------------

#define RT_HASH_M1 0x7FEB352Du
#define RT_HASH_M2 0x846CA68Bu
#define RT_HASH_GOLD 0x9E3779B9u
#define RT_HASH_INIT 0x243F6A88u

__device__ __forceinline__ uint32_t rt_splitmix32(uint32_t h) {
  h = (h ^ (h >> 16)) * RT_HASH_M1;
  h = (h ^ (h >> 15)) * RT_HASH_M2;
  return h ^ (h >> 16);
}

// One step of hash_u32: fold the next integer part into the state.
__device__ __forceinline__ uint32_t rt_hash_fold(uint32_t h, uint32_t part) {
  return rt_splitmix32(h ^ (part * RT_HASH_GOLD + RT_HASH_GOLD));
}

// hash_u32(seed, min(i,j), max(i,j)): the per-pair prefix of the edge hash.
__device__ __forceinline__ uint32_t rt_pair_hash(uint32_t seed_state, uint32_t i, uint32_t j) {
  uint32_t lo = i < j ? i : j;
  uint32_t hi = i < j ? j : i;
  return rt_hash_fold(rt_hash_fold(seed_state, lo), hi);
}

// Q_c[i, j] sign bit: true when the entry is -1 (top hash bit, flipped for i > j).
__device__ __forceinline__ bool rt_rademacher_negative(uint32_t pair_state, uint32_t c, bool flip) {
  return ((rt_hash_fold(pair_state, c) >> 31) != 0u) != flip;
}
