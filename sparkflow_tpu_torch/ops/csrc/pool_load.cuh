// Element access shared by the paged kernels (paged_attention.cu,
// paged_verify.cu): a lane's 8 consecutive elements of a pool row loaded as
// ONE vector load and widened to float32 — 32 bytes for float32, 16 for
// bfloat16, 8 for an int8 or fp8 (e4m3) quantized pool — a lane's run of a
// row loaded raw (one 16- or 8-byte load) and widened later, the conversion
// of one element of any of those types to float32, and of float32 to the
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

#include <type_traits>

namespace {

// A lane's run of a pool row split in two steps, so that a lane can issue
// the loads of several rows before it computes on any: raw_load fetches
// VEC elements of P with ONE vector load (16 bytes; 8 for an int8/fp8 run
// of 8 elements), held raw in registers, and widen converts them to float32.
template <typename P, int VEC>
struct PoolRun {
  static constexpr int kBytes = VEC * (int)sizeof(P);
  static_assert(kBytes == 16 || kBytes == 8, "a run is 8 or 16 bytes");
  using Raw = typename std::conditional<kBytes == 16, uint4, uint2>::type;
};

__device__ __forceinline__ uint4 raw_load(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint2 raw_load(const uint2* p) { return __ldg(p); }

__device__ __forceinline__ void widen_bytes(uint32_t w, const int8_t*,
                                            float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = static_cast<float>(static_cast<int8_t>(w >> (8 * i)));
}

__device__ __forceinline__ void widen_bytes(uint32_t w, const __nv_fp8_e4m3*,
                                            float* out) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_fp8_e4m3 a;
    a.__x = static_cast<__nv_fp8_storage_t>(w >> (8 * i));
    out[i] = static_cast<float>(a);
  }
}

// 4 float32 elements
__device__ __forceinline__ void widen(const uint4& r, const float*,
                                      float* out) {
  out[0] = __uint_as_float(r.x); out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z); out[3] = __uint_as_float(r.w);
}

// 8 bfloat16 elements
__device__ __forceinline__ void widen(const uint4& r, const __nv_bfloat16*,
                                      float* out) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 16 (uint4) or 8 (uint2) int8 / fp8 elements
template <typename P>
__device__ __forceinline__ void widen(const uint4& r, const P* tag,
                                      float* out) {
  widen_bytes(r.x, tag, out);
  widen_bytes(r.y, tag, out + 4);
  widen_bytes(r.z, tag, out + 8);
  widen_bytes(r.w, tag, out + 12);
}

template <typename P>
__device__ __forceinline__ void widen(const uint2& r, const P* tag,
                                      float* out) {
  widen_bytes(r.x, tag, out);
  widen_bytes(r.y, tag, out + 4);
}

// 8 consecutive elements of a row with ONE vector load, widened
__device__ __forceinline__ void load8(const float* p, float* out) {
  widen(*reinterpret_cast<const uint4*>(p), p, out);
  widen(*reinterpret_cast<const uint4*>(p + 4), p, out + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  widen(*reinterpret_cast<const uint4*>(p), p, out);
}

template <typename P>
__device__ __forceinline__ void load8(const P* p, float* out) {
  widen(*reinterpret_cast<const uint2*>(p), p, out);
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
