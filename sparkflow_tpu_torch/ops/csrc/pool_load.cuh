// Element access shared by the paged kernels (paged_attention.cu,
// paged_verify.cu): a lane's 8 consecutive elements of a pool row loaded as
// ONE vector load and widened to float32 — 32 bytes for float32, 16 for
// bfloat16, 8 for an int8 or fp8 (e4m3) quantized pool — the conversion of
// one element of any of those types to float32, and of float32 to the
// output type.
//
// The widening is exact for every pool type (int8 and e4m3 values are all
// float32 numbers); a quantized pool's per-page-per-head scale is applied by
// the caller, folded into the score and the PV update, never by dividing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = static_cast<float>(static_cast<int8_t>(raw.x >> (8 * i)));
    out[4 + i] = static_cast<float>(static_cast<int8_t>(raw.y >> (8 * i)));
  }
}

__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 a, b;
    a.__x = static_cast<__nv_fp8_storage_t>(raw.x >> (8 * i));
    b.__x = static_cast<__nv_fp8_storage_t>(raw.y >> (8 * i));
    out[i] = static_cast<float>(a);
    out[4 + i] = static_cast<float>(b);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace
