// Flash attention at any head_dim, its output columns sliced over the grid,
// for NVIDIA Hopper, sm_90a: the forward, dQ and dK/dV where the tensor-core
// kernels (flash_fwd.cu, flash_bwd.cu, flash_bwd_wide.cu) stop — above
// head_dim 256 (a transformer_lm of 2 heads of 512 runs here) or at a
// head_dim that is not a multiple of 8 handed to the C entries as it is (the
// wrapper pads those to a multiple of 8 and runs the tensor cores instead).
//
// Replaces the same three TPU kernels, sparkflow_tpu/ops/attention.py:
// _flash_kernel, _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel, which take
// any head_dim a multiple of 8 (JAX sends others to its plain attention).
// Same functions and masking as the tensor-core kernels: masked and
// causal-excluded scores are -1e30 in the forward (a row whose keys are all
// padding averages them uniformly), keys past Sk add nothing, the
// logsumexp is m + log(max(l, 1e-30)); in the backward P = exp(S - L) is
// exactly 0 where masked (the TPU gate s > 0.5 * NEG_INF), so a row whose
// keys are all padding gets zero gradient.
//
// Why slices: at head_dim 256 one warp's 16-row float32 accumulator is
// already 128 registers a lane in the tensor-core kernels, and at 512 no
// HD-wide accumulator fits. Here a block owns 32 rows (queries; keys for
// dK/dV) and at most kSlice = 256 output columns, one slice a grid index:
// a head_dim D takes ceil(D / 256) slices of equal width. The contractions
// that need the whole row — Q K^T, and dO V^T in the backward — stream the
// full head_dim through shared memory in chunks of 32 columns, so every
// slice recomputes S (and dP) for its 256 columns: at D = 512 the forward
// does 3 products of 2 * 256 flops per (query, key) pair where a fused
// kernel would do 2 of 2 * 512 (~1.5x), the dq kernel 5 where 3, the dk/dv
// kernel 6 where 4. The logsumexp is written once, by slice 0.
//
// A simple kernel that is right, on the CUDA cores in float32: 256 threads,
// thread t owns row t / 8 and, of each 32-row visited tile, the 4 rows
// t % 8 + 8j of the score tile, and of the output slice the 32 columns
// t % 8 + 8j. A row's softmax state is reduced over its 8 lanes with
// shuffles. bfloat16 operands are widened on load; in the forward P is
// rounded to bfloat16 before P V, as the tensor-core kernel and the TPU
// kernel do; the backward keeps P and dS in float32, as the plain version
// does. Every load is a scalar load, so any alignment and any head_dim
// work. No atomics and a fixed order: two launches give the same bits.
// Shared memory per block: two 32 x 33 float chunk tiles, one (forward,
// dq) or two (dk/dv) 32 x 33 float P / dS tiles and a 32 x 256 float slice
// of the visited V, K, dO or Q rows: 45,440 / 45,440 / 49,664 bytes. The
// kernels ask for two blocks an SM (128 registers at most): with the
// thread count alone ptxas holds a kernel like these to 64 registers and
// may spill (paged_attention.cu's header).
//
// What bounds it: the CUDA cores' issue (67 TFLOP/s float32 on an H100
// SXM), far from it in this first version — every product reads one
// operand from shared memory per FMA.
//
// Interface: called by the C entries sf_flash_fwd, sf_flash_bwd_dq and
// sf_flash_bwd_dkv (declared in flash_sliced.cuh), on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_sliced.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 32;             // the block's own rows
constexpr int kTile = 32;             // visited rows a step
constexpr int kChunk = 32;            // contraction columns staged a step
constexpr int kPitch = kChunk + 1;    // conflict-free column reads
constexpr int kSlice = 256;           // output columns a block owns, at most
constexpr int kCols = kSlice / 8;     // a thread's output columns
constexpr float kNegInf = -1e30f;

// (batch, head, seq) element strides of up to six [B, H, S, D] operands
struct Strides {
  long long s[18];
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
// P as the second product reads it: rounded to bf16 for bf16 operands
__device__ __forceinline__ float as_operand(float x, const float*) {
  return x;
}
__device__ __forceinline__ float as_operand(float x, const bf16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// reductions over the 8 lanes that share a row (t / 8)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// out[j] = a[t / 8] . b[t % 8 + 8j] over all D columns: a and b point at
// row 0 of 32 rows (row stride as / bs; rows at or past na / nb read as
// zeros), staged 32 columns at a time through sa / sb.
template <typename T>
__device__ __forceinline__ void dot_tile(const T* __restrict__ a,
                                         long long as, int na,
                                         const T* __restrict__ b,
                                         long long bs, int nb, int D,
                                         float* sa, float* sb,
                                         float (&out)[4]) {
  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;
#pragma unroll
  for (int j = 0; j < 4; ++j) out[j] = 0.f;
  for (int d0 = 0; d0 < D; d0 += kChunk) {
    __syncthreads();  // the last readers of sa / sb are done
#pragma unroll
    for (int u = 0; u < kRows * kChunk / kThreads; ++u) {
      const int i = (tid >> 5) + 8 * u, jj = tid & 31, d = d0 + jj;
      sa[i * kPitch + jj] = i < na && d < D ? ld(a + i * as + d) : 0.f;
      sb[i * kPitch + jj] = i < nb && d < D ? ld(b + i * bs + d) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kChunk; ++kk) {
      const float x = sa[r * kPitch + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[j] = fmaf(x, sb[(c + 8 * j) * kPitch + kk], out[j]);
    }
  }
}

// sv[i][col] = rows[i][c0 + col] for 32 rows (stride rs; rows at or past n
// and columns at or past w read as zeros)
template <typename T>
__device__ __forceinline__ void load_slice(const T* __restrict__ rows,
                                           long long rs, int n, int c0, int w,
                                           float* sv) {
#pragma unroll 4
  for (int u = 0; u < kTile * kSlice / kThreads; ++u) {
    const int idx = threadIdx.x + kThreads * u;
    const int i = idx / kSlice, col = idx % kSlice;
    sv[idx] = i < n && col < w ? ld(rows + i * rs + c0 + col) : 0.f;
  }
}

// acc[j] += sum_i p[t / 8][i] * sv[i][t % 8 + 8j]
__device__ __forceinline__ void slice_product(const float* sp, const float* sv,
                                              float (&acc)[kCols]) {
  const int r = threadIdx.x >> 3, c = threadIdx.x & 7;
#pragma unroll 4
  for (int i = 0; i < kTile; ++i) {
    const float x = sp[r * kPitch + i];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      acc[j] = fmaf(x, sv[i * kSlice + c + 8 * j], acc[j]);
  }
}

constexpr size_t kChunkFloats = 2 * kRows * kPitch;   // sa, sb
constexpr size_t kTileFloats = kRows * kPitch;        // one P / dS tile
constexpr size_t kSliceFloats = kTile * kSlice;

// grid (B * H, query tiles, slices). Strides: q, k, v, o.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ mask, T* __restrict__ o,
                        float* __restrict__ lse, int H, int S, int Sk, int D,
                        int W, Strides st, float scale, int causal) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + kRows * kPitch;
  float* sp = smem + kChunkFloats;
  float* sv = sp + kTileFloats;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kRows, c0 = blockIdx.z * W;
  const int w = min(W, D - c0);
  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7, qi = q0 + r;
  const long long* s_ = st.s;
  const T* qb = q + b * s_[0] + h * s_[1] + q0 * s_[2];
  const T* kb = k + b * s_[3] + h * s_[4];
  const T* vb = v + b * s_[6] + h * s_[7];

  float m = -INFINITY, l = 0.f, acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  // key tiles past the causal diagonal of the block's last row: not visited
  const int kend = causal ? min(Sk, q0 + kRows) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    float s[4];
    dot_tile(qb, s_[2], S - q0, kb + k0 * s_[5], s_[5], Sk - k0, D, sa, sb,
             s);
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + c + 8 * j;
      if (kj >= Sk) {
        s[j] = -INFINITY;                       // past Sk: adds nothing
      } else {
        const bool live = (!causal || qi >= kj) &&
                          (mask == nullptr || mask[(long long)b * Sk + kj] > 0.f);
        s[j] = live ? s[j] * scale : kNegInf;
      }
      tmax = fmaxf(tmax, s[j]);
    }
    const float mn = fmaxf(m, row_max(tmax));
    const float alpha = expf(m - mn);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - mn);
      psum += p;
      sp[r * kPitch + c + 8 * j] = as_operand(p, q);
    }
    l = l * alpha + row_sum(psum);
    m = mn;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    load_slice(vb + k0 * s_[8], s_[8], Sk - k0, c0, w, sv);
    __syncthreads();
    slice_product(sp, sv, acc);
    __syncthreads();  // sp and sv are read before the next tile's writes
  }
  if (qi >= S) return;
  const float den = fmaxf(l, 1e-30f);
  T* row = o + b * s_[9] + h * s_[10] + qi * s_[11] + c0;
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (c + 8 * j < w) put(row + c + 8 * j, acc[j] / den);
  if (lse != nullptr && blockIdx.z == 0 && c == 0)
    lse[(long long)bh * S + qi] = m + logf(den);
}

// grid (B * H, query tiles, slices). Strides: q, k, v, dout, dq.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const float* __restrict__ mask, T* __restrict__ dq,
                           int H, int S, int Sk, int D, int W, Strides st,
                           float scale, int causal) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + kRows * kPitch;
  float* sp = smem + kChunkFloats;
  float* sv = sp + kTileFloats;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kRows, c0 = blockIdx.z * W;
  const int w = min(W, D - c0);
  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7, qi = q0 + r;
  const long long* s_ = st.s;
  const T* qb = q + b * s_[0] + h * s_[1] + q0 * s_[2];
  const T* kb = k + b * s_[3] + h * s_[4];
  const T* vb = v + b * s_[6] + h * s_[7];
  const T* ob = dout + b * s_[9] + h * s_[10] + q0 * s_[11];
  const float lr = qi < S ? lse[(long long)bh * S + qi] : 0.f;
  const float dr = qi < S ? delta[(long long)bh * S + qi] : 0.f;

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  const int kend = causal ? min(Sk, q0 + kRows) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kTile) {
    float s[4], dp[4];
    dot_tile(qb, s_[2], S - q0, kb + k0 * s_[5], s_[5], Sk - k0, D, sa, sb,
             s);
    dot_tile(ob, s_[11], S - q0, vb + k0 * s_[8], s_[8], Sk - k0, D, sa, sb,
             dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + c + 8 * j;
      const bool live = qi < S && kj < Sk && (!causal || qi >= kj) &&
                        (mask == nullptr || mask[(long long)b * Sk + kj] > 0.f);
      const float p = live ? expf(s[j] * scale - lr) : 0.f;
      sp[r * kPitch + c + 8 * j] = p * (dp[j] - dr);
    }
    load_slice(kb + k0 * s_[5], s_[5], Sk - k0, c0, w, sv);
    __syncthreads();
    slice_product(sp, sv, acc);
    __syncthreads();
  }
  if (qi >= S) return;
  T* row = dq + b * s_[12] + h * s_[13] + qi * s_[14] + c0;
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (c + 8 * j < w) put(row + c + 8 * j, scale * acc[j]);
}

// grid (B * H, key tiles, slices): the block owns 32 keys and visits the
// query tiles. Strides: q, k, v, dout, dk, dv.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_sliced_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ mask,
                            T* __restrict__ dk, T* __restrict__ dv, int H,
                            int S, int Sk, int D, int W, Strides st,
                            float scale, int causal) {
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = sa + kRows * kPitch;
  float* sp = smem + kChunkFloats;
  float* sds = sp + kTileFloats;
  float* sv = sds + kTileFloats;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * kRows, c0 = blockIdx.z * W;
  const int w = min(W, D - c0);
  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7, kj = k0 + r;
  const long long* s_ = st.s;
  const T* qb = q + b * s_[0] + h * s_[1];
  const T* kb = k + b * s_[3] + h * s_[4] + k0 * s_[5];
  const T* vb = v + b * s_[6] + h * s_[7] + k0 * s_[8];
  const T* ob = dout + b * s_[9] + h * s_[10];
  const float* lb = lse + (long long)bh * S;
  const float* db = delta + (long long)bh * S;
  const bool key_live = kj < Sk &&
      (mask == nullptr || mask[(long long)b * Sk + kj] > 0.f);

  float acc_k[kCols], acc_v[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc_k[j] = acc_v[j] = 0.f;
  // query tiles wholly before the causal diagonal of the block's first key:
  // not visited
  const int qstart = causal ? k0 / kTile * kTile : 0;
  for (int q0 = qstart; q0 < S; q0 += kTile) {
    float s[4], dp[4];
    dot_tile(kb, s_[5], Sk - k0, qb + q0 * s_[2], s_[2], S - q0, D, sa, sb,
             s);
    dot_tile(vb, s_[8], Sk - k0, ob + q0 * s_[11], s_[11], S - q0, D, sa, sb,
             dp);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = q0 + c + 8 * j;
      const bool live = key_live && qi < S && (!causal || qi >= kj);
      const float p = live ? expf(s[j] * scale - lb[qi]) : 0.f;
      sp[r * kPitch + c + 8 * j] = p;
      sds[r * kPitch + c + 8 * j] = live ? p * (dp[j] - db[qi]) : 0.f;
    }
    load_slice(ob + q0 * s_[11], s_[11], S - q0, c0, w, sv);
    __syncthreads();
    slice_product(sp, sv, acc_v);                 // dV += P^T dO
    __syncthreads();
    load_slice(qb + q0 * s_[2], s_[2], S - q0, c0, w, sv);
    __syncthreads();
    slice_product(sds, sv, acc_k);                // dK += dS^T Q
    __syncthreads();
  }
  if (kj >= Sk) return;
  T* krow = dk + b * s_[12] + h * s_[13] + kj * s_[14] + c0;
  T* vrow = dv + b * s_[15] + h * s_[16] + kj * s_[17] + c0;
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (c + 8 * j < w) {
      put(krow + c + 8 * j, scale * acc_k[j]);
      put(vrow + c + 8 * j, acc_v[j]);
    }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// (grid, slice width) for a [B, H, rows, D] output: ceil(D / 256) slices
// of equal width
dim3 grid_of(int B, int H, int rows, int D, int* W) {
  const int n = (D + kSlice - 1) / kSlice;
  *W = (D + n - 1) / n;
  return dim3(B * H, (rows + kRows - 1) / kRows, n);
}

Strides copy_strides(const long long* src, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) st.s[i] = src[i];
  return st;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* lse, int B, int H,
                       int S, int Sk, int D, const long long* strides,
                       float scale, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_sliced_kernel<T>;
  const size_t smem = sizeof(float) * (kChunkFloats + kTileFloats +
                                       kSliceFloats);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int W;
  const dim3 grid = grid_of(B, H, S, D, &W);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(o), lse, H, S, Sk, D,
      W, copy_strides(strides, 12), scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* mask, void* dq, int B, int H, int S, int Sk,
                      int D, const long long* strides, float scale, int causal,
                      cudaStream_t stream) {
  auto kern = flash_bwd_dq_sliced_kernel<T>;
  const size_t smem = sizeof(float) * (kChunkFloats + kTileFloats +
                                       kSliceFloats);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int W;
  const dim3 grid = grid_of(B, H, S, D, &W);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dq), H, S, Sk, D, W, copy_strides(strides, 15), scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* mask, void* dk, void* dv, int B, int H,
                       int S, int Sk, int D, const long long* strides,
                       float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_sliced_kernel<T>;
  const size_t smem = sizeof(float) * (kChunkFloats + 2 * kTileFloats +
                                       kSliceFloats);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  int W;
  const dim3 grid = grid_of(B, H, Sk, D, &W);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dk), static_cast<T*>(dv), H, S, Sk, D, W,
      copy_strides(strides, 18), scale, causal);
  return cudaGetLastError();
}

}  // namespace

namespace sf_sliced {

cudaError_t fwd(int dtype, const void* q, const void* k, const void* v,
                const float* mask, void* o, float* lse, int B, int H, int S,
                int Sk, int D, const long long* strides, float scale,
                int causal, cudaStream_t stream) {
  return dtype == 0
      ? launch_fwd<float>(q, k, v, mask, o, lse, B, H, S, Sk, D, strides,
                          scale, causal, stream)
      : launch_fwd<bf16>(q, k, v, mask, o, lse, B, H, S, Sk, D, strides,
                         scale, causal, stream);
}

cudaError_t dq(int dtype, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const float* mask, void* dq, int B, int H, int S, int Sk,
               int D, const long long* strides, float scale, int causal,
               cudaStream_t stream) {
  return dtype == 0
      ? launch_dq<float>(q, k, v, dout, lse, delta, mask, dq, B, H, S, Sk, D,
                         strides, scale, causal, stream)
      : launch_dq<bf16>(q, k, v, dout, lse, delta, mask, dq, B, H, S, Sk, D,
                        strides, scale, causal, stream);
}

cudaError_t dkv(int dtype, const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const float* mask, void* dk, void* dv, int B, int H, int S,
                int Sk, int D, const long long* strides, float scale,
                int causal, cudaStream_t stream) {
  return dtype == 0
      ? launch_dkv<float>(q, k, v, dout, lse, delta, mask, dk, dv, B, H, S,
                          Sk, D, strides, scale, causal, stream)
      : launch_dkv<bf16>(q, k, v, dout, lse, delta, mask, dk, dv, B, H, S,
                         Sk, D, strides, scale, causal, stream);
}

}  // namespace sf_sliced
