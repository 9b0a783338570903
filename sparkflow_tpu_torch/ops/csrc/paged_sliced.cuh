// The column-sliced paged attention kernel (paged_sliced.cu): decode and
// verify attention at a head_dim the vector kernels do not take (above
// 256, or not a multiple of 8), declared for the C entries of
// paged_attention.cu and paged_verify.cu, which route such a head_dim here.

#pragma once

#include <cuda_runtime.h>

namespace sf_paged_sliced {

// dtype: 0 = float32, 1 = bfloat16 (q and out); pool: -1 = the pool holds
// dtype itself, 0 = int8, 1 = fp8 e4m3 with [num_pages, H] float32 scales.
// q [B, H, S, D] with strides (qsb, qsh, qss), out likewise (osb, osh,
// oss); per_slot [B] int32: lengths (verify = 0; query s of a slot attends
// its first lengths[b] tokens) or start (verify = 1; query s attends tokens
// <= start[b] + s).
cudaError_t run(int dtype, int pool, const void* q, long long qsb,
                long long qsh, long long qss, const void* k_pages,
                const void* v_pages, const void* k_scales,
                const void* v_scales, const int* table, int maxp,
                const int* per_slot, int verify, void* out, long long osb,
                long long osh, long long oss, int B, int H, int S, int D,
                int page, float scale, cudaStream_t stream);

// whether the vector kernels take this head_dim (else: sliced)
inline bool vector_head_dim(int D) { return D % 8 == 0 && D >= 8 && D <= 256; }

}  // namespace sf_paged_sliced
