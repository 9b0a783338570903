// Fused attention forward (flash attention) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel sparkflow_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_pallas_forward). Same function: O = softmax(scale *
// Q K^T [+ causal mask] [+ key-padding mask]) V with the softmax statistics
// kept in float32 and folded online over key tiles, so the S x Sk score
// matrix never reaches device memory; also writes the per-row logsumexp
// (lse = m + log l) that a backward pass recomputes P from.
//
// Translation from the TPU kernel:
// - the TPU grid's sequential key axis (ki), which carried m / l / acc in VMEM
//   scratch from one grid step to the next, becomes a loop inside the block;
//   the running statistics live in registers for the whole loop;
// - one thread block per (batch*head, 32-row query tile); blocks are
//   independent, so the (B*H, S/32) grid fills the card's 132 SMs in any
//   order;
// - key tiles wholly above the causal diagonal are not visited (the TPU
//   kernel's pl.when skip), and the ragged edges of S and Sk are masked here,
//   so any sequence length works (no % 128 tile rule);
// - masked scores use -1e30 exactly like the TPU kernel (a row whose keys
//   are all padding averages them uniformly, as there), while keys past Sk
//   contribute exactly nothing.
//
// What bounds it on the H100: at the prefill shapes of the serving path
// (B=1, H=12, D=64, S up to 1024, causal) the work is ~2*S*S*D*H flops over
// ~4*S*D*H*2 bytes, i.e. a few hundred flops per byte — near the bf16 ridge
// line, so a fast kernel would be bound by tensor-core throughput. This first
// kernel computes on the CUDA cores in float32 (operands converted once into
// shared memory), so it is bound by shared-memory and FMA issue rate: each
// lane owns one key of the tile for Q K^T and a strip of head_dim columns
// for P V, Q rows are read as float4 broadcasts and P through a per-warp
// shared buffer, and K is stored with a padded row so the per-lane key reads
// do not bank-conflict. wgmma / TMA tiles are later work.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per block
constexpr int kBlockK = 32;               // keys per tile: one per lane
constexpr float kNegInf = -1e30f;         // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int D) {
  return sizeof(float) * (size_t(kBlockQ) * D + size_t(kBlockK) * (D + 1) +
                          size_t(kBlockK) * D + kWarps * kRows * kBlockK +
                          kBlockK);
}

// NC = ceil(D / 32): head_dim columns each lane accumulates for P V.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ lse, int H, int S,
                 int Sk, int D, long long qsb, long long qsh, long long qss,
                 long long ksb, long long ksh, long long kss, long long vsb,
                 long long vsh, long long vss, long long osb, long long osh,
                 long long oss, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 1;                     // padded K row: no bank conflicts
  float* sq = smem;                         // [kBlockQ][D]
  float* sk = sq + kBlockQ * D;             // [kBlockK][D + 1]
  float* sv = sk + kBlockK * DP;            // [kBlockK][D]
  float* sp = sv + kBlockK * D;             // [kWarps][kRows][kBlockK]
  float* sm = sp + kWarps * kRows * kBlockK;  // [kBlockK] key mask

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, qi = q0 + r;
    sq[i] = qi < S ? to_f(qb[qi * qss + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int ntiles = (Sk + kBlockK - 1) / kBlockK;
  if (causal) {
    const int q_last = min(q0 + kBlockQ, S) - 1;
    ntiles = min(ntiles, q_last / kBlockK + 1);
  }
  const int rbase = warp * kRows;
  float* spw = sp + warp * kRows * kBlockK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kBlockK * D; i += blockDim.x) {
      const int j = i / D, d = i - j * D, kj = k0 + j;
      const bool in = kj < Sk;
      sk[j * DP + d] = in ? to_f(kb[kj * kss + d]) : 0.f;
      sv[j * D + d] = in ? to_f(vb[kj * vss + d]) : 0.f;
    }
    if (mask != nullptr && tid < kBlockK) {
      const int kj = k0 + tid;
      sm[tid] = kj < Sk ? mask[(long long)b * Sk + kj] : 0.f;
    }
    __syncthreads();

    // scores: lane j holds s[r] = q[rbase + r] . k[k0 + j]
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = sk + lane * DP;
    for (int d = 0; d < D; d += 4) {
      const float k0v = krow[d], k1v = krow[d + 1], k2v = krow[d + 2],
                  k3v = krow[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(sq + (rbase + r) * D + d);
        s[r] = fmaf(qq.x, k0v, s[r]);
        s[r] = fmaf(qq.y, k1v, s[r]);
        s[r] = fmaf(qq.z, k2v, s[r]);
        s[r] = fmaf(qq.w, k3v, s[r]);
      }
    }

    const int kj = k0 + lane;
    const bool in = kj < Sk;
    const bool keep = mask == nullptr || sm[lane] > 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + rbase + r;
      float x = s[r] * scale;
      if ((causal && kj > qi) || !keep) x = kNegInf;
      if (!in) x = -CUDART_INF_F;  // past Sk: contributes exactly nothing
      const float mn = fmaxf(m[r], warp_max(x));
      const float p = expf(x - mn);
      const float alpha = expf(m[r] - mn);
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      m[r] = mn;
      spw[r * kBlockK + lane] = p;
    }
    __syncwarp();

    // acc[r][c] += sum_j p[r][j] * v[j][lane + 32c]
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? sv[(j + jj) * D + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pp =
            *reinterpret_cast<const float4*>(spw + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float a = acc[r][c];
          a = fmaf(pp.x, vv[0][c], a);
          a = fmaf(pp.y, vv[1][c], a);
          a = fmaf(pp.z, vv[2][c], a);
          a = fmaf(pp.w, vv[3][c], a);
          acc[r][c] = a;
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + rbase + r;
    if (qi >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + b * osb + h * osh + qi * oss;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[r][c] / denom);
    }
    if (lse != nullptr && lane == 0)
      lse[(long long)bh * S + qi] = m[r] + logf(denom);
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* mask, void* o, float* lse, int B, int H,
                   int S, int Sk, int D, const long long* st, float scale,
                   int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, NC>;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, S, Sk, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nc, const void* q, const void* k, const void* v,
                     const float* mask, void* o, float* lse, int B, int H,
                     int S, int Sk, int D, const long long* st, float scale,
                     int causal, cudaStream_t stream) {
  switch (nc) {
    case 1: return launch<T, 1>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 2: return launch<T, 2>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 3: return launch<T, 3>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 4: return launch<T, 4>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o are [B, H, S|Sk, D] with D
// contiguous; strides[12] = (q, k, v, o) x (batch, head, seq) in elements.
// mask: [B, Sk] float32 (> 0 attends) or null; lse: [B, H, S] float32 or
// null. Requires D % 8 == 0 and 8 <= D <= 128 (the wrapper checks).
extern "C" int sf_flash_fwd(int dtype, const void* q, const void* k,
                            const void* v, const void* mask, void* o,
                            void* lse, int B, int H, int S, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            void* stream) {
  if (D % 8 != 0 || D < 8 || D > 128) return (int)cudaErrorInvalidValue;
  const int nc = (D + 31) / 32;
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch<float>(nc, q, k, v, m, o, l, B, H, S, Sk, D, strides, scale, causal, s)
      : dispatch<__nv_bfloat16>(nc, q, k, v, m, o, l, B, H, S, Sk, D, strides, scale, causal, s);
  return (int)e;
}

extern "C" const char* sf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
