// Flash attention backward above head_dim 128 (GPT-J-6B's heads are 256),
// for NVIDIA Hopper, sm_90a: dQ and dK/dV at every head_dim that is a
// multiple of 8 in (128, 256], in bfloat16 (bf16 mma.sync) and float32
// (3xTF32). The same two TPU kernels as flash_bwd.cu
// (sparkflow_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// :_flash_bwd_dkv_kernel, which take any head_dim a multiple of 8) and the
// same function: P recomputed from the saved logsumexp, masked,
// causal-excluded and ragged entries exactly 0, a row whose keys are all
// padding zero gradient, and in bf16 P and dS rounded to bf16 before the
// second product. These are the instantiations of flash_bwd.cuh's
// templates above 128, in a source of their own so that the build's
// parallel nvcc processes compile them beside flash_bwd.cu's; the C entries
// in flash_bwd.cu route head_dim above 128 here.
//
// - Specialised on head_dim rounded up to 32 (HD = 160, 192, 224, 256: four
//   instantiations for the 16 head_dims), as the forward is above 128: the
//   columns past head_dim are zero-filled on load (cp.async's zero fill),
//   which adds nothing to Q K^T or dO V^T, and are not stored.
// - Registers. At HD = 256 one warp's 16-row HD-wide float32 accumulator is
//   HD / 2 = 128 registers a lane. The dk/dv kernel up to 128 holds two (dK
//   and dV), which here would be 256, past the 255 a thread may have. So dK
//   and dV are two kernels (one launch each from sf_flash_bwd_dkv, counted
//   as one call of its wrapper), each with one accumulator, as the dq
//   kernel has: the dV kernel (kPartDV) computes S^T = K Q^T and P^T and
//   accumulates P^T dO; the dK kernel (kPartDK) computes S^T, dP^T = V dO^T
//   and dS^T and accumulates dS^T Q. That is 5 products where the one
//   kernel does 4: K Q^T twice. Splitting the accumulator's columns over
//   the grid instead would recompute S and dP for every 128 columns (~1.5x
//   the products). The dq kernel's key tiles narrow from 64 to 32 (S and dP
//   16 registers each), as the forward's do above 128.
// - Shared memory. bf16 rows keep a pitch of HD + 8 (528 bytes at 256): a
//   block holds its 64 own rows of one operand (dV: K) or two (dq: Q, dO;
//   dK: K, V) and two stages of 32 visited rows of two (K, V; or Q, dO).
//   float32 rows (HD + 4 floats, 1,040 bytes at 256) would need 266 KB with
//   32 visited rows and two own operands, past the 227 KB a block may
//   take: the dq and dK kernels visit 16 rows a step (199,936 bytes at 256)
//   and the dV kernel, with one own operand, 32 (200,192 bytes). Dynamic
//   shared memory per block, bytes:
//     HD    bf16 dq / dK / dV            float32 dq / dK / dV
//     160    86,272 /  86,528 /  65,024   126,208 / 126,208 / 126,464
//     192   102,656 / 102,912 /  77,312   150,784 / 150,784 / 151,040
//     224   119,040 / 119,296 /  89,600   175,360 / 175,360 / 175,616
//     256   135,424 / 135,680 / 101,888   199,936 / 199,936 / 200,192
// - What bounds it is what bounds flash_bwd.cu's kernels: the tensor cores'
//   issue (mma.sync, 5 products of 2 * D flops per attending pair in all).
//
// ptxas -v on an H100 (sm_90a; chip_smoke.py prints it at set-up),
// registers / blocks per SM that registers and shared memory both allow, no
// instantiation spills:
//     HD    bf16 dq / dK / dV            float32 dq / dK / dV
//     160   166 / 2, 168 / 2, 130 / 3    171 / 1, 167 / 1, 175 / 1
//     192   173 / 2, 169 / 2, 164 / 2    184 / 1, 183 / 1, 196 / 1
//     224   242 / 1, 234 / 1, 168 / 2    200 / 1, 204 / 1, 208 / 1
//     256   247 / 1, 243 / 1, 230 / 2    224 / 1, 217 / 1, 218 / 1
// Measured (chip_smoke.py phase 27 (a), H100 80GB HBM3, 700 W) at B=1
// S=1024 H=16 D=256, causal: bf16 dq 0.095 ms, dk/dv 0.172 (136 and 100
// TFLOP/s of the functions' 3 and 4 products), the pair 2.0x SDPA's
// backward; float32 dq 0.510, dk/dv 0.824, the pair 1.2x SDPA's.

#include <cuda_runtime.h>

#include "flash_bwd.cuh"

namespace {

// dV's kernel, then dK's, on the same stream
template <int HD>
cudaError_t launch_dkv_mma_split(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const float* mask,
                                 void* dk, void* dv, int B, int H, int S,
                                 int Sk, int D, const long long* strides,
                                 float scale, int causal,
                                 cudaStream_t stream) {
  cudaError_t e = launch_dkv_mma<HD, kPartDV>(q, k, v, dout, lse, delta, mask,
                                              dk, dv, B, H, S, Sk, D, strides,
                                              scale, causal, stream);
  if (e != cudaSuccess) return e;
  return launch_dkv_mma<HD, kPartDK>(q, k, v, dout, lse, delta, mask, dk, dv,
                                     B, H, S, Sk, D, strides, scale, causal,
                                     stream);
}

template <int HD>
cudaError_t launch_dkv_tf32_split(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  const float* mask, void* dk, void* dv,
                                  int B, int H, int S, int Sk, int D,
                                  const long long* strides, float scale,
                                  int causal, cudaStream_t stream) {
  cudaError_t e = launch_dkv_tf32<HD, kPartDV>(q, k, v, dout, lse, delta,
                                               mask, dk, dv, B, H, S, Sk, D,
                                               strides, scale, causal, stream);
  if (e != cudaSuccess) return e;
  return launch_dkv_tf32<HD, kPartDK>(q, k, v, dout, lse, delta, mask, dk, dv,
                                      B, H, S, Sk, D, strides, scale, causal,
                                      stream);
}

}  // namespace

namespace sf_bwd {

cudaError_t wide_dq_mma(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        const float* mask, void* dq, int B, int H, int S,
                        int Sk, int D, const long long* strides, float scale,
                        int causal, cudaStream_t stream) {
  SF_DISPATCH_WIDE(launch_dq_mma, D, q, k, v, dout, lse, delta, mask, dq, B,
                   H, S, Sk, D, strides, scale, causal, stream)
}

cudaError_t wide_dkv_mma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* mask, void* dk,
                         void* dv, int B, int H, int S, int Sk, int D,
                         const long long* strides, float scale, int causal,
                         cudaStream_t stream) {
  SF_DISPATCH_WIDE(launch_dkv_mma_split, D, q, k, v, dout, lse, delta, mask,
                   dk, dv, B, H, S, Sk, D, strides, scale, causal, stream)
}

cudaError_t wide_dq_tf32(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* mask, void* dq,
                         int B, int H, int S, int Sk, int D,
                         const long long* strides, float scale, int causal,
                         cudaStream_t stream) {
  SF_DISPATCH_WIDE(launch_dq_tf32, D, q, k, v, dout, lse, delta, mask, dq, B,
                   H, S, Sk, D, strides, scale, causal, stream)
}

cudaError_t wide_dkv_tf32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* mask, void* dk,
                          void* dv, int B, int H, int S, int Sk, int D,
                          const long long* strides, float scale, int causal,
                          cudaStream_t stream) {
  SF_DISPATCH_WIDE(launch_dkv_tf32_split, D, q, k, v, dout, lse, delta, mask,
                   dk, dv, B, H, S, Sk, D, strides, scale, causal, stream)
}

}  // namespace sf_bwd
