// Decode and verify attention through a page table at any head_dim, the
// output columns sliced over the grid, for NVIDIA Hopper, sm_90a, over a
// plain or a quantized KV pool: where the vector kernels (paged_attention.cu,
// paged_verify.cu) stop — above head_dim 256 or at a head_dim that is not a
// multiple of 8 (the pool is the whole KV cache: it is never copied to a
// padded layout; a row of an int8 pool at D = 25 is 25 bytes).
//
// Replaces, at those head_dims, the four TPU kernels of
// sparkflow_tpu/ops/attention.py launched by paged_attention and
// paged_attention_verify: _paged_kernel, _paged_kernel_quant,
// _paged_verify_kernel and _paged_verify_kernel_quant (JAX sends a head_dim
// whose tiles do not fit to its plain versions). Same functions: query s of
// slot b attends the first lengths[b] tokens of its pages (decode, S = 1; an
// empty slot gives exact zeros) or the tokens <= start[b] + s (verify); a
// quantized pool's [num_pages, H] scales fold into the score (K) and the PV
// update (V), never divided by.
//
// Design, a simple kernel that is right: grid (slices, H, B * S), one block
// of 8 warps per (slot, query, head, column slice). A slice is at most 256
// output columns (ceil(D / 256) slices of equal width), so a lane holds 8
// accumulators at any head_dim; each slice recomputes the scores over the
// whole row. The query row waits in shared memory as float32. Warp w walks
// tiles of 32 tokens (w * 32, then + 256), as the split verify kernel
// walks its tiles: lane r scores token r of the tile over the whole row in
// element order (scalar loads of the raw pool type, so any row width and
// alignment; the lane's consecutive loads share cache lines), the warp
// folds the tile's 32 scores into its online softmax state with shuffles,
// then adds the tokens' V slices in token order, each lane its columns
// lane + 32e. The 8 warps' states merge in shared memory in warp order.
// No atomics: two launches give the same bits. A verify query re-reads its
// slot's rows (S times the bytes of the vector kernel's one pass), and the
// walk is not split over blocks: at B = 8 slots and H = 4 heads of 512 a
// decode call is 64 blocks. (A two-pass form that normalised p before the
// V sum, in the plain version's order, read K twice and still rounded as
// many bf16 outputs away from the plain version's.)
//
// What bounds it: the bytes of the walked rows (3.35 TB/s), from which this
// first version is far — a lane's dot product is a chain of D dependent
// FMAs, and each tile waits on its table -> row loads.
//
// Interface: called by the C entries sf_paged_attention,
// sf_paged_attention_quant and sf_paged_verify (declared in
// paged_sliced.cuh), on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_sliced.cuh"
#include "pool_load.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 256;            // output columns a block owns, at most
constexpr int kE = kSlice / 32;        // accumulators a lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// grid (slices, H, B * S); block kThreads; dynamic shared memory D floats.
// Two blocks an SM asked for: with the thread count alone ptxas held this
// kernel to 64 registers and spilled (as paged_attention.cu's header
// reports for its own kernel).
template <typename T, typename P, bool kQuant>
__global__ void __launch_bounds__(kThreads, 2)
paged_sliced_kernel(const T* __restrict__ q, long long qsb, long long qsh,
                    long long qss, const P* __restrict__ kp,
                    const P* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table, int maxp,
                    const int* __restrict__ per_slot, int verify,
                    T* __restrict__ out, long long osb, long long osh,
                    long long oss, int H, int S, int D, int W, int page,
                    float scale) {
  extern __shared__ float s_q[];                 // [D]
  __shared__ float s_m[kWarps], s_l[kWarps];
  __shared__ float s_acc[kWarps][kSlice];
  const int c0 = blockIdx.x * W, w = min(W, D - c0), h = blockIdx.y;
  const int b = blockIdx.z / S, s = blockIdx.z % S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int walk = verify ? per_slot[b] + s + 1 : per_slot[b];
  const int n = min(walk, maxp * page);          // tokens this query attends
  const long long row = (long long)H * D;        // between consecutive tokens
  const T* qr = q + b * qsb + h * qsh + s * qss;
  for (int i = tid; i < D; i += kThreads) s_q[i] = to_f(qr[i]);
  __syncthreads();

  float m = kNegInf, l = 0.f, acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.f;
  for (int t0 = warp * 32; t0 < n; t0 += kWarps * 32) {
    const int tok = t0 + lane;                   // this lane's token
    const bool live = tok < n;
    long long off = 0;                           // its row's element offset
    float sc = -INFINITY, vsc = 1.f;
    if (live) {
      const long long pid = table[(long long)b * maxp + tok / page];
      off = (pid * page + tok % page) * row + (long long)h * D;
      const P* kr = kp + off;
      float dot = 0.f;
#pragma unroll 4
      for (int i = 0; i < D; ++i) dot = fmaf(s_q[i], to_f(kr[i]), dot);
      sc = dot * (kQuant ? ks[pid * H + h] * scale : scale);
      if (kQuant) vsc = vs[pid * H + h];
    }
    const float mn = fmaxf(m, warp_max(sc));     // lane 0's token is live
    const float alpha = expf(m - mn);
    const float p = live ? expf(sc - mn) : 0.f;
    l = l * alpha + warp_sum(p);
    const float pv = p * vsc;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[e] *= alpha;
    const int rows = min(32, n - t0);
    for (int r = 0; r < rows; ++r) {
      const float pr = __shfl_sync(0xffffffffu, pv, r);
      const P* vr = vp + __shfl_sync(0xffffffffu, off, r) + c0;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int col = lane + 32 * e;
        if (col < w) acc[e] = fmaf(pr, to_f(vr[col]), acc[e]);
      }
    }
    m = mn;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < kE; ++e) s_acc[warp][lane + 32 * e] = acc[e];
  __syncthreads();
  if (tid >= w) return;
  float mmax = kNegInf;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) mmax = fmaxf(mmax, s_m[i]);
  float lsum = 0.f, a = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const float f = expf(s_m[i] - mmax);
    lsum = fmaf(s_l[i], f, lsum);
    a = fmaf(s_acc[i][tid], f, a);
  }
  // an empty slot (no token walked): exact zeros
  store(out + b * osb + h * osh + s * oss + c0 + tid,
        lsum > 0.f ? a / lsum : 0.f);
}

template <typename T, typename P, bool kQuant>
cudaError_t launch(const void* q, long long qsb, long long qsh, long long qss,
                   const void* kp, const void* vp, const void* ks,
                   const void* vs, const int* table, int maxp,
                   const int* per_slot, int verify, void* out, long long osb,
                   long long osh, long long oss, int B, int H, int S, int D,
                   int page, float scale, cudaStream_t stream) {
  auto kern = paged_sliced_kernel<T, P, kQuant>;
  const size_t smem = sizeof(float) * (size_t)D;
  if (smem > 38 * 1024) {   // with the ~8 KB of static merge state, > 48 KB
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int n = (D + kSlice - 1) / kSlice;
  const int W = (D + n - 1) / n;
  kern<<<dim3(n, H, B * S), kThreads, smem, stream>>>(
      static_cast<const T*>(q), qsb, qsh, qss, static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), table, maxp, per_slot, verify,
      static_cast<T*>(out), osb, osh, oss, H, S, D, W, page, scale);
  return cudaGetLastError();
}

}  // namespace

namespace sf_paged_sliced {

cudaError_t run(int dtype, int pool, const void* q, long long qsb,
                long long qsh, long long qss, const void* k_pages,
                const void* v_pages, const void* k_scales,
                const void* v_scales, const int* table, int maxp,
                const int* per_slot, int verify, void* out, long long osb,
                long long osh, long long oss, int B, int H, int S, int D,
                int page, float scale, cudaStream_t stream) {
  if (D < 1 || S < 1 || page < 1 || pool < -1 || pool > 1 ||
      (pool >= 0 && (k_scales == nullptr || v_scales == nullptr)))
    return cudaErrorInvalidValue;
#define SF_SLICED_ARGS                                                      \
  q, qsb, qsh, qss, k_pages, v_pages, k_scales, v_scales, table, maxp,      \
      per_slot, verify, out, osb, osh, oss, B, H, S, D, page, scale, stream
  if (dtype == 0) {
    if (pool < 0) return launch<float, float, false>(SF_SLICED_ARGS);
    if (pool == 0) return launch<float, int8_t, true>(SF_SLICED_ARGS);
    return launch<float, __nv_fp8_e4m3, true>(SF_SLICED_ARGS);
  }
  if (pool < 0)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(SF_SLICED_ARGS);
  if (pool == 0) return launch<__nv_bfloat16, int8_t, true>(SF_SLICED_ARGS);
  return launch<__nv_bfloat16, __nv_fp8_e4m3, true>(SF_SLICED_ARGS);
#undef SF_SLICED_ARGS
}

}  // namespace sf_paged_sliced
