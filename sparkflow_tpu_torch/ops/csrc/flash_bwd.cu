// Flash attention backward for NVIDIA Hopper, sm_90a: dQ and dK/dV.
//
// Replaces the TPU kernels sparkflow_tpu/ops/attention.py:_flash_bwd_dq_kernel
// and :_flash_bwd_dkv_kernel (both launched by _flash_pallas_backward_flat).
// Same function, the FlashAttention-2 recurrence: with L = logsumexp saved by
// the forward (flash_fwd.cu) and D = rowsum(dO * O) (a plain reduction the
// wrapper computes first),
//   P = exp(S - L);  dV = P^T dO;  dP = dO V^T;  dS = P * (dP - D);
//   dQ = scale * dS K;  dK = scale * dS^T Q
// with P recomputed tile by tile, so no S x Sk matrix reaches device memory.
// Masked and causal-excluded entries of P are exactly 0 (the TPU kernel's
// gate s > 0.5 * NEG_INF): a query row whose keys are all padding gets zero
// gradient, and keys past Sk add nothing.
//
// Translation from the TPU kernels:
// - the TPU keeps the split into two kernels, one accumulating dQ over key
//   tiles and one accumulating dK and dV over query tiles, so that no output
//   is summed across blocks: no atomics, and the result does not depend on
//   the order blocks run in. That split is kept;
// - each TPU grid's sequential axis, which carried the accumulators in VMEM
//   from one grid step to the next, becomes a loop inside the block with the
//   accumulators in registers; dQ, dK and dV are written once;
// - one block per (batch*head, 32-row tile) of 4 warps x 8 rows; the dq
//   kernel visits key tiles up to the causal diagonal and the dkv kernel
//   query tiles from the diagonal on (the TPU kernels' pl.when skip);
// - the ragged edges of S and Sk are masked here: no % 128 tile rule.
//
// What bounds it on the H100: at the training shape (B=8, H=12, S=1024,
// D=64, causal) the dq kernel does 3 and the dkv kernel 4 products of
// ~2*S*S/2*D flops per head over ~8*S*D bytes per head of operands — well
// above the bf16 ridge, so a fast kernel is bound by tensor-core throughput.
// These first kernels compute on the CUDA cores in float32 (bf16 operands
// converted once into shared memory), like flash_fwd.cu, so they are bound
// by FMA throughput and shared-memory bandwidth: in the score loop each lane
// owns one key (dq) or one query (dkv) of the tile and reads its row from
// shared memory with a padded stride (no bank conflicts), while the 8 rows
// of the warp's own side are read as float4 broadcasts; in the accumulation
// loop each lane owns a strip of head_dim columns and reads P / dS through a
// per-warp shared buffer. mma / wgmma tiles are later work.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // rows of the block's own side per warp
constexpr int kBlock = kWarps * kRows;    // the block's own rows (q or k)
constexpr int kTile = 32;                 // rows of the visited side: one per lane
constexpr float kNegInf = -1e30f;         // the TPU kernels' NEG_INF

// (batch, head, seq) element strides of up to six [B, H, S, D] operands
struct Strides {
  long long s[18];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy rows [r0, r0 + nrows) of one head of a [B, H, S, D] operand into
// shared memory as float, with row pitch `pitch`; rows past `n` read 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      long long ss, int r0, int nrows, int n,
                                      int D) {
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, row = r0 + r;
    dst[r * pitch + d] = row < n ? to_f(src[row * ss + d]) : 0.f;
  }
}

// P for one (row of the warp's side, lane of the visited side) pair, with
// the TPU kernel's masking: causal (key > query) and padded keys get
// NEG_INF, then the gate leaves exactly 0; `valid` covers the ragged edges.
__device__ __forceinline__ float recompute_p(float s, float scale, float lse,
                                             int qi, int kj, bool keep,
                                             bool valid, int causal) {
  float x = s * scale;
  if ((causal && kj > qi) || !keep) x = kNegInf;
  return (valid && x > 0.5f * kNegInf) ? expf(x - lse) : 0.f;
}

size_t dq_smem_bytes(int D) {
  return sizeof(float) * (2 * size_t(kBlock) * D + 2 * size_t(kTile) * (D + 1) +
                          size_t(kWarps) * kRows * kTile + kTile);
}

size_t dkv_smem_bytes(int D) {
  return sizeof(float) * (2 * size_t(kBlock) * D + 2 * size_t(kTile) * (D + 1) +
                          2 * size_t(kWarps) * kRows * kTile + 2 * kTile);
}

// dQ: one block per (batch*head, 32-query tile); loops over key tiles.
// Strides: q, k, v, dout, dq.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ mask, T* __restrict__ dq, int H,
                    int S, int Sk, int D, Strides st, float scale,
                    int causal) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 1;
  float* sq = smem;                          // [kBlock][D]
  float* sdo = sq + kBlock * D;              // [kBlock][D]
  float* sk = sdo + kBlock * D;              // [kTile][D + 1]
  float* sv = sk + kTile * DP;               // [kTile][D + 1]
  float* sds = sv + kTile * DP;              // [kWarps][kRows][kTile]
  float* sm = sds + kWarps * kRows * kTile;  // [kTile] key mask

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBlock;
  const long long* s_ = st.s;
  const T* qb = q + b * s_[0] + h * s_[1];
  const T* kb = k + b * s_[3] + h * s_[4];
  const T* vb = v + b * s_[6] + h * s_[7];
  const T* dob = dout + b * s_[9] + h * s_[10];

  stage(sq, D, qb, s_[2], q0, kBlock, S, D);
  stage(sdo, D, dob, s_[11], q0, kBlock, S, D);

  const int rbase = warp * kRows;
  float lse_r[kRows], delta_r[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + rbase + r;
    lse_r[r] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
    delta_r[r] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  int ntiles = (Sk + kTile - 1) / kTile;
  if (causal) {
    const int q_last = min(q0 + kBlock, S) - 1;
    ntiles = min(ntiles, q_last / kTile + 1);
  }
  float* sdw = sds + warp * kRows * kTile;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile is consumed (and Q, dO are staged)
    stage(sk, DP, kb, s_[5], k0, kTile, Sk, D);
    stage(sv, DP, vb, s_[8], k0, kTile, Sk, D);
    if (mask != nullptr && tid < kTile) {
      const int kj = k0 + tid;
      sm[tid] = kj < Sk ? mask[(long long)b * Sk + kj] : 0.f;
    }
    __syncthreads();

    // lane j: s[r] = q[rbase + r] . k[k0 + j], dp[r] = dO[rbase + r] . v[k0 + j]
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* krow = sk + lane * DP;
    const float* vrow = sv + lane * DP;
    for (int d = 0; d < D; d += 4) {
      const float ka = krow[d], kb1 = krow[d + 1], kc = krow[d + 2],
                  kd = krow[d + 3];
      const float va = vrow[d], vb1 = vrow[d + 1], vc = vrow[d + 2],
                  vd = vrow[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qq =
            *reinterpret_cast<const float4*>(sq + (rbase + r) * D + d);
        const float4 gg =
            *reinterpret_cast<const float4*>(sdo + (rbase + r) * D + d);
        s[r] = fmaf(qq.x, ka, fmaf(qq.y, kb1, fmaf(qq.z, kc, fmaf(qq.w, kd, s[r]))));
        dp[r] = fmaf(gg.x, va, fmaf(gg.y, vb1, fmaf(gg.z, vc, fmaf(gg.w, vd, dp[r]))));
      }
    }

    const int kj = k0 + lane;
    const bool keep = mask == nullptr || sm[lane] > 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + rbase + r;
      const float p = recompute_p(s[r], scale, lse_r[r], qi, kj, keep,
                                  qi < S && kj < Sk, causal);
      sdw[r * kTile + lane] = p * (dp[r] - delta_r[r]);
    }
    __syncwarp();

    // acc[r][c] += sum_j dS[r][j] * k[j][lane + 32c]
    for (int j = 0; j < kTile; j += 4) {
      float kk[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          kk[jj][c] = d < D ? sk[(j + jj) * DP + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 g4 = *reinterpret_cast<const float4*>(sdw + r * kTile + j);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = fmaf(g4.x, kk[0][c], fmaf(g4.y, kk[1][c],
                      fmaf(g4.z, kk[2][c], fmaf(g4.w, kk[3][c], acc[r][c]))));
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + rbase + r;
    if (qi >= S) continue;
    T* row = dq + b * s_[12] + h * s_[13] + qi * s_[14];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(row + d, scale * acc[r][c]);
    }
  }
}

// dK, dV: one block per (batch*head, 32-key tile); loops over query tiles.
// Strides: q, k, v, dout, dk, dv.
template <typename T, int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ mask, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int S, int Sk, int D,
                     Strides st, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 1;
  float* sk = smem;                           // [kBlock][D]
  float* sv = sk + kBlock * D;                // [kBlock][D]
  float* sq = sv + kBlock * D;                // [kTile][D + 1]
  float* sdo = sq + kTile * DP;               // [kTile][D + 1]
  float* sp = sdo + kTile * DP;               // [kWarps][kRows][kTile]
  float* sds = sp + kWarps * kRows * kTile;   // [kWarps][kRows][kTile]
  float* slse = sds + kWarps * kRows * kTile; // [kTile]
  float* sdelta = slse + kTile;               // [kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kBlock;
  const long long* s_ = st.s;
  const T* qb = q + b * s_[0] + h * s_[1];
  const T* kb = k + b * s_[3] + h * s_[4];
  const T* vb = v + b * s_[6] + h * s_[7];
  const T* dob = dout + b * s_[9] + h * s_[10];

  stage(sk, D, kb, s_[5], k0, kBlock, Sk, D);
  stage(sv, D, vb, s_[8], k0, kBlock, Sk, D);

  const int rbase = warp * kRows;
  bool keep_r[kRows];
  float acck[kRows][NC], accv[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + rbase + r;
    keep_r[r] = kj < Sk && (mask == nullptr || mask[(long long)b * Sk + kj] > 0.f);
#pragma unroll
    for (int c = 0; c < NC; ++c) acck[r][c] = accv[r][c] = 0.f;
  }

  const int ntiles = (S + kTile - 1) / kTile;
  // causal: query tiles wholly above this key tile's diagonal see P = 0
  const int t0 = causal ? min(k0 / kTile, ntiles) : 0;
  float* spw = sp + warp * kRows * kTile;
  float* sdw = sds + warp * kRows * kTile;

  for (int t = t0; t < ntiles; ++t) {
    const int q0 = t * kTile;
    __syncthreads();  // the previous tile is consumed (and K, V are staged)
    stage(sq, DP, qb, s_[2], q0, kTile, S, D);
    stage(sdo, DP, dob, s_[11], q0, kTile, S, D);
    if (tid < kTile) {
      const int qi = q0 + tid;
      slse[tid] = qi < S ? lse[(long long)bh * S + qi] : 0.f;
      sdelta[tid] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
    }
    __syncthreads();

    // lane i: s[r] = q[q0 + i] . k[rbase + r], dp[r] = dO[q0 + i] . v[rbase + r]
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
    const float* qrow = sq + lane * DP;
    const float* grow = sdo + lane * DP;
    for (int d = 0; d < D; d += 4) {
      const float qa = qrow[d], qb1 = qrow[d + 1], qc = qrow[d + 2],
                  qd = qrow[d + 3];
      const float ga = grow[d], gb = grow[d + 1], gc = grow[d + 2],
                  gd = grow[d + 3];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 kk =
            *reinterpret_cast<const float4*>(sk + (rbase + r) * D + d);
        const float4 vv =
            *reinterpret_cast<const float4*>(sv + (rbase + r) * D + d);
        s[r] = fmaf(qa, kk.x, fmaf(qb1, kk.y, fmaf(qc, kk.z, fmaf(qd, kk.w, s[r]))));
        dp[r] = fmaf(ga, vv.x, fmaf(gb, vv.y, fmaf(gc, vv.z, fmaf(gd, vv.w, dp[r]))));
      }
    }

    const int qi = q0 + lane;
    const float lse_i = slse[lane], delta_i = sdelta[lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int kj = k0 + rbase + r;
      const float p = recompute_p(s[r], scale, lse_i, qi, kj, keep_r[r],
                                  qi < S, causal);
      spw[r * kTile + lane] = p;
      sdw[r * kTile + lane] = p * (dp[r] - delta_i);
    }
    __syncwarp();

    // accv[r][c] += sum_i P[r][i] dO[i][lane + 32c];
    // acck[r][c] += sum_i dS[r][i] q[i][lane + 32c]
    for (int i = 0; i < kTile; i += 4) {
      float gg[4][NC], qq[4][NC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          gg[ii][c] = d < D ? sdo[(i + ii) * DP + d] : 0.f;
          qq[ii][c] = d < D ? sq[(i + ii) * DP + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(spw + r * kTile + i);
        const float4 d4 = *reinterpret_cast<const float4*>(sdw + r * kTile + i);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          accv[r][c] = fmaf(p4.x, gg[0][c], fmaf(p4.y, gg[1][c],
                       fmaf(p4.z, gg[2][c], fmaf(p4.w, gg[3][c], accv[r][c]))));
          acck[r][c] = fmaf(d4.x, qq[0][c], fmaf(d4.y, qq[1][c],
                       fmaf(d4.z, qq[2][c], fmaf(d4.w, qq[3][c], acck[r][c]))));
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kj = k0 + rbase + r;
    if (kj >= Sk) continue;
    T* krow_out = dk + b * s_[12] + h * s_[13] + kj * s_[14];
    T* vrow_out = dv + b * s_[15] + h * s_[16] + kj * s_[17];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        store(krow_out + d, scale * acck[r][c]);
        store(vrow_out + d, accv[r][c]);
      }
    }
  }
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

Strides copy_strides(const long long* src, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) st.s[i] = src[i];
  return st;
}

template <typename T, int NC>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* mask, void* dq, int B, int H, int S, int Sk,
                      int D, const long long* strides, float scale, int causal,
                      cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, NC>;
  const size_t smem = dq_smem_bytes(D);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + kBlock - 1) / kBlock, B * H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dq), H, S, Sk, D, copy_strides(strides, 15), scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const float* mask, void* dk, void* dv, int B, int H,
                       int S, int Sk, int D, const long long* strides,
                       float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_kernel<T, NC>;
  const size_t smem = dkv_smem_bytes(D);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sk + kBlock - 1) / kBlock, B * H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, mask,
      static_cast<T*>(dk), static_cast<T*>(dv), H, S, Sk, D,
      copy_strides(strides, 18), scale, causal);
  return cudaGetLastError();
}

#define SF_DISPATCH_NC(fn, T, nc, ...)            \
  switch (nc) {                                   \
    case 1: return fn<T, 1>(__VA_ARGS__);         \
    case 2: return fn<T, 2>(__VA_ARGS__);         \
    case 3: return fn<T, 3>(__VA_ARGS__);         \
    case 4: return fn<T, 4>(__VA_ARGS__);         \
    default: return cudaErrorInvalidValue;        \
  }

template <typename T>
cudaError_t dispatch_dq(int nc, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse,
                        const float* delta, const float* mask, void* dq,
                        int B, int H, int S, int Sk, int D,
                        const long long* strides, float scale, int causal,
                        cudaStream_t stream) {
  SF_DISPATCH_NC(launch_dq, T, nc, q, k, v, dout, lse, delta, mask, dq, B, H,
                 S, Sk, D, strides, scale, causal, stream)
}

template <typename T>
cudaError_t dispatch_dkv(int nc, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* mask, void* dk,
                         void* dv, int B, int H, int S, int Sk, int D,
                         const long long* strides, float scale, int causal,
                         cudaStream_t stream) {
  SF_DISPATCH_NC(launch_dkv, T, nc, q, k, v, dout, lse, delta, mask, dk, dv,
                 B, H, S, Sk, D, strides, scale, causal, stream)
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq are [B, H, S, D] and k/v
// [B, H, Sk, D] with D contiguous; strides[15] = (q, k, v, dout, dq) x
// (batch, head, seq) in elements. lse, delta: [B, H, S] float32 contiguous;
// mask: [B, Sk] float32 (> 0 attends) or null. Requires D % 8 == 0 and
// 8 <= D <= 128 (the wrapper checks).
extern "C" int sf_flash_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* lse, const void* delta,
                               const void* mask, void* dq, int B, int H, int S,
                               int Sk, int D, const long long* strides,
                               float scale, int causal, void* stream) {
  if (D % 8 != 0 || D < 8 || D > 128) return (int)cudaErrorInvalidValue;
  const int nc = (D + 31) / 32;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_dq<float>(nc, q, k, v, dout, l, dl, m, dq, B, H, S, Sk, D, strides, scale, causal, s)
      : dispatch_dq<__nv_bfloat16>(nc, q, k, v, dout, l, dl, m, dq, B, H, S, Sk, D, strides, scale, causal, s);
  return (int)e;
}

// As sf_flash_bwd_dq; dk/dv are [B, H, Sk, D]; strides[18] = (q, k, v,
// dout, dk, dv) x (batch, head, seq).
extern "C" int sf_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta,
                                const void* mask, void* dk, void* dv, int B,
                                int H, int S, int Sk, int D,
                                const long long* strides, float scale,
                                int causal, void* stream) {
  if (D % 8 != 0 || D < 8 || D > 128) return (int)cudaErrorInvalidValue;
  const int nc = (D + 31) / 32;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_dkv<float>(nc, q, k, v, dout, l, dl, m, dk, dv, B, H, S, Sk, D, strides, scale, causal, s)
      : dispatch_dkv<__nv_bfloat16>(nc, q, k, v, dout, l, dl, m, dk, dv, B, H, S, Sk, D, strides, scale, causal, s);
  return (int)e;
}
