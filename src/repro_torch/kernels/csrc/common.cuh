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
//
// hash_u32(p0, p1, ...) folds each part as h <- splitmix32(h ^ K(p)), with
// K(p) = p * GOLD + GOLD.  splitmix32 ends and starts with the same
// xor-shift by 16, xs16(v) = v ^ (v >> 16), which is its own inverse and
// distributes over xor.  So a fold's input after its first xor-shift is
// xs16(h) ^ xs16(K(p)) = w ^ key(p), where w is the previous fold's state
// before its last xor-shift: the helpers below carry w, never h, and each
// fold costs one xor, two multiplies and one xor-shift.  The top bit of h
// is the top bit of w (v >> 16 has a zero top bit), so a sign bit needs no
// last xor-shift either.
// ---------------------------------------------------------------------------

#define RT_HASH_M1 0x7FEB352Du
#define RT_HASH_M2 0x846CA68Bu
#define RT_HASH_GOLD 0x9E3779B9u
#define RT_HASH_INIT 0x243F6A88u

// xs16(K(p)): a part's key.  constexpr, so a column constant folds.
__host__ __device__ constexpr uint32_t rt_hash_key(uint32_t part) {
  return (part * RT_HASH_GOLD + RT_HASH_GOLD) ^ ((part * RT_HASH_GOLD + RT_HASH_GOLD) >> 16);
}

// The hash's initial state, as the w of a fold before the first part.
constexpr uint32_t RT_HASH_W0 = RT_HASH_INIT ^ (RT_HASH_INIT >> 16);

// v >> s on the multiply pipe (IMAD.HI) instead of the integer ALU, which
// the xors and shifts of the hash keep busy; 0 < s < 32.
__device__ __forceinline__ uint32_t rt_shr(uint32_t v, int s) {
  return __umulhi(v, 1u << (32 - s));
}

// One fold on the carried state: w of hash(..., p) from w of hash(...).
__device__ __forceinline__ uint32_t rt_fold_w(uint32_t w, uint32_t key) {
  uint32_t h = (w ^ key) * RT_HASH_M1;
  return (h ^ rt_shr(h, 15)) * RT_HASH_M2;
}

// w of hash(seed, v): the per-row prefix, one per id and call.
__device__ __forceinline__ uint32_t rt_row_w(uint32_t seed, uint32_t v) {
  return rt_fold_w(rt_fold_w(RT_HASH_W0, rt_hash_key(seed)), rt_hash_key(v));
}

// A word whose top bit is Q_c's sign bit for the unordered pair whose w of
// hash(seed, lo, hi) is `pair_w`: set when base(lo, hi, c) is -1 (the top
// bit of hash(seed, lo, hi, c)); the lower bits mean nothing.  Q_c[i, j] =
// base for i < j and -base for i > j.  Every kernel that regenerates the
// field takes its sign from here.
__device__ __forceinline__ uint32_t rt_sign_word(uint32_t pair_w, uint32_t col_key) {
  return rt_fold_w(pair_w, col_key);
}
