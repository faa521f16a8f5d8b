// Helpers shared by the port's CUDA sources: bf16 conversions and shared
// memory addresses.
//
// Every source compiles into its own shared library with a plain C
// interface (pointvit_tpu_torch/_build.py). Each entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError() so
// the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

extern "C" const char* pv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

// Element i of a bf16 or f32 array as f32, and an f32 value rounded to T
// (bf16 or f32): the kernels templated on their element type use these.
__device__ __forceinline__ float ld(const bf16* p, size_t i) { return bf2f(p[i]); }
__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
template <typename T>
__device__ __forceinline__ T cvt(float v);
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float v) { return f2bf(v); }
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
// v rounded to T and read back as f32.
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  const T t = cvt<T>(v);
  return ld(&t, 0);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 values as a bf16 pair (round to nearest even), low half first: an
// accumulator pair repacked as an A-operand register or stored as one word.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
