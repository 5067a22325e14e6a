// Loads and stores of activation rows in f32 or bf16, each value widened to
// f32 on the way in and rounded once (to nearest even) on the way out. A
// kernel templated on its element type T reads and writes its tensors
// through these, so its f32 and bf16-I/O instances share every line of the
// arithmetic between. Included by attention_packed.cu, flash_kernels.cuh
// (f32 only) and flash_bf16.cuh (bf16 in, bf16 or f32 out).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace io {

using bf16 = __nv_bfloat16;

// True for the bf16-I/O instances of a kernel templated on T.
template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float2 widen2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Four neighbouring values from p: 16-byte aligned for f32, 8 for bf16.
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = widen2(u.x), b = widen2(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Two neighbouring values from p: 8-byte aligned for f32, 4 for bf16.
__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const bf16* p) {
  return widen2(__ldg(reinterpret_cast<const unsigned int*>(p)));
}

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld1(const bf16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
}

}  // namespace io
