// The column-sliced flash attention kernels (flash_sliced.cu): the forward,
// dQ and dK/dV at a head_dim the tensor-core kernels do not take (above
// 256, or not a multiple of 8), declared for the C entries of flash_fwd.cu
// and flash_bwd.cu, which route such a head_dim here. Arguments as those
// entries' (dtype 0 = float32, 1 = bfloat16; strides in elements).

#pragma once

#include <cuda_runtime.h>

namespace sf_sliced {

cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                const float* mask, void* o, float* lse, int B, int H, int S,
                int Sk, int D, const long long* strides, float scale,
                int causal, cudaStream_t stream);
cudaError_t dq(int dtype, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const float* mask, void* dq, int B, int H, int S, int Sk,
               int D, const long long* strides, float scale, int causal,
               cudaStream_t stream);
cudaError_t dkv(int dtype, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* mask, void* dk, void* dv, int B, int H, int S,
                int Sk, int D, const long long* strides, float scale,
                int causal, cudaStream_t stream);

// whether the tensor-core kernels take this head_dim (else: sliced)
inline bool tensor_core_head_dim(int D) {
  return D % 8 == 0 && D >= 8 && D <= 256;
}

}  // namespace sf_sliced
