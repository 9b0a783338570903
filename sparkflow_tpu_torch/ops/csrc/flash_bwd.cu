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
//   the order blocks run in — two launches on the same inputs are
//   bit-identical. That split is kept (it costs 7 products where the fused
//   FlashAttention-2 backward with float32 atomics on dQ does 5);
// - each TPU grid's sequential axis, which carried the accumulators in VMEM
//   from one grid step to the next, becomes a loop inside the block with the
//   accumulators in registers; dQ, dK and dV are written once;
// - the dq kernel visits key tiles up to the causal diagonal and the dkv
//   kernel query tiles from the diagonal on (the TPU kernels' pl.when skip);
// - the ragged edges of S and Sk are masked here: no % 128 tile rule.
//
// What bounds it on the H100: at the training shape (B=8, H=12, S=1024,
// D=64, causal) the dq kernel does 3 and the dkv kernel 4 products of
// ~2*S*S/2*D flops per head over ~8*S*D bytes per head of operands — well
// above the bf16 ridge, so the kernels are bound by tensor-core throughput.
// mma.sync, issued by each warp on its own, does not reach the card's
// 989 TFLOP/s; Hopper's wgmma (a warpgroup's asynchronous product fed by
// TMA) is the way there, and later work.
//
// bfloat16 operands (the training path) run on the tensor cores:
// - every product is mma.sync m16n8k16 bf16 -> float32 (mma_bf16.cuh),
//   its fragments loaded from shared memory with ldmatrix (.trans where the
//   product needs the transposed operand);
// - a block owns 64 rows (4 warps x 16) of its side — queries (dq) or keys
//   (dkv) — loaded once, and streams the visited side's tiles (K, V and the
//   key mask; or Q, dO, L and D) through a two-stage cp.async ring: tile
//   t+1 loads while tile t is computed. Operands stay bf16 in shared memory
//   with rows padded by 16 bytes, so ldmatrix's eight 16-byte row reads land
//   on distinct bank groups at every head_dim;
// - the dkv kernel computes S^T = K Q^T and dP^T = V dO^T with its own keys
//   as the M side, so the accumulators of P^T and dS^T are, rounded to bf16
//   once, the A fragments of dV += P^T dO and dK += dS^T Q (the standard
//   FlashAttention-2 rounding); the dq kernel likewise feeds dS as the A
//   operand of dQ += dS K with K read through ldmatrix.trans. No P or dS
//   goes through shared memory;
// - the mask (causal, ragged edge, key padding) is evaluated only on tiles
//   that need it: with 64-row tiles, the diagonal tile and the last ragged
//   one; interior tiles take exp2 and the FMA alone;
// - the grid is (batch*head, row tile) with the row tile slow, ordered so
//   the blocks with the most causal tiles start first and the grid's tail
//   is short;
// - the kernels are specialised on head_dim rounded up to 16 (HD = 16..128);
//   a head_dim that is a multiple of 8 but not of 16 is zero-padded to HD in
//   shared memory (cp.async's zero fill), which adds nothing to Q K^T, and
//   the padded output columns are not written;
// - visited tiles are 64 rows, except 32 in the dkv kernel above HD = 64,
//   where its two HD-wide accumulators need the registers; 128 threads a
//   block, two cp.async stages. ptxas -v on an H100 (sm_90a; chip_smoke.py
//   prints it at set-up), registers / dynamic shared memory per block /
//   blocks per SM that both allow, no instantiation spills:
//     HD    dq                  dkv (visited tile)
//     16    102 / 18,944 / 4    128 / 19,456 / 4   (64)
//     32    128 / 31,232 / 4    148 / 31,744 / 3   (64)
//     48    128 / 43,520 / 4    166 / 44,032 / 3   (64)
//     64    164 / 55,808 / 3    176 / 56,320 / 2   (64)
//     80    168 / 68,096 / 3    168 / 45,568 / 3   (32)
//     96    168 / 80,384 / 2    178 / 53,760 / 2   (32)
//    112    168 / 92,672 / 2    232 / 61,952 / 2   (32)
//    128    172 / 104,960 / 2   242 / 70,144 / 2   (32)
// cp.async needs 16-byte aligned rows: the wrapper checks each operand's
// pointer and strides and makes a copy where they are not, and the entry
// points refuse (cudaErrorInvalidValue) what is not aligned.
//
// float32 operands (the exactness arm, held to 1e-4 of the largest
// gradient; TF32 tensor cores would miss that) keep the CUDA-core kernels:
// one block per (batch*head, 32-row tile) of 4 warps x 8 rows; in the score
// loop each lane owns one key (dq) or one query (dkv) of the tile and reads
// its row from shared memory with a padded stride, while the 8 rows of the
// warp's own side are read as float4 broadcasts; in the accumulation loop
// each lane owns a strip of head_dim columns and reads P / dS through a
// per-warp shared buffer.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;    // 4 warps
constexpr int kOwn = 64;            // the block's own rows: 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

// visited-side tile rows: 64, or 32 in the dkv kernel above HD = 64
template <int HD>
__host__ __device__ constexpr int dkv_tile() { return HD <= 64 ? 64 : 32; }
constexpr int kDqTile = 64;

template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int nrows,
                                          int n, int D) {
  sf_mma::load_rows<HD, kMmaThreads>(dst, src, ss, r0, nrows, n, D);
}

template <int HD>
size_t dq_mma_smem() {
  return sizeof(bf16) * (HD + 8) * (2 * kOwn + 2 * 2 * kDqTile) +
         sizeof(float) * 2 * kDqTile;
}

template <int HD>
size_t dkv_mma_smem() {
  return sizeof(bf16) * (HD + 8) * (2 * kOwn + 2 * 2 * dkv_tile<HD>()) +
         sizeof(float) * 2 * 2 * dkv_tile<HD>();
}

// dQ: one block per (batch*head, 64-query tile); loops over 64-key tiles.
// Strides: q, k, v, dout, dq.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ mask, bf16* __restrict__ dq,
                        int H, int S, int Sk, int D, Strides st, float scale,
                        int causal) {
  constexpr int P = HD + 8, BC = kDqTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kOwn][P]
  bf16* sdo = sq + kOwn * P;                     // [kOwn][P]
  bf16* skv = sdo + kOwn * P;                    // [2 stages][K, V][BC][P]
  float* smask = reinterpret_cast<float*>(skv + 2 * 2 * BC * P);  // [2][BC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the last query tiles see the most keys: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const long long* s_ = st.s;
  const bf16* qb = q + b * s_[0] + h * s_[1];
  const bf16* kb = k + b * s_[3] + h * s_[4];
  const bf16* vb = v + b * s_[6] + h * s_[7];
  const bf16* dob = dout + b * s_[9] + h * s_[10];

  load_rows<HD>(sq, qb, s_[2], q0, kOwn, S, D);
  load_rows<HD>(sdo, dob, s_[11], q0, kOwn, S, D);
  int ntiles = (Sk + BC - 1) / BC;
  if (causal) ntiles = min(ntiles, (min(q0 + kOwn, S) - 1) / BC + 1);

  auto load_tile = [&](int t) {
    const int k0 = t * BC;
    bf16* dst = skv + (t & 1) * 2 * BC * P;
    load_rows<HD>(dst, kb, s_[5], k0, BC, Sk, D);
    load_rows<HD>(dst + BC * P, vb, s_[8], k0, BC, Sk, D);
    if (mask != nullptr && tid < BC) {
      const int kj = k0 + tid;
      sf_mma::cp_async4(smask + (t & 1) * BC + tid,
                        mask + (long long)b * Sk + (kj < Sk ? kj : 0),
                        kj < Sk ? 4 : 0);
    }
  };
  if (ntiles > 0) load_tile(0);
  sf_mma::cp_async_commit();

  // this lane's two rows of the warp's 16 (accumulator rows g and g + 8)
  const int g = lane >> 2, c2 = (lane & 3) * 2, rw = warp * 16;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rw + g + 8 * r;
    lse2[r] = qi < S ? lse[(long long)bh * S + qi] * kLog2e : 0.f;
    dlt[r] = qi < S ? delta[(long long)bh * S + qi] : 0.f;
  }
  const float sl2 = scale * kLog2e;

  float acc[HD / 8][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    sf_mma::cp_async_commit();
    sf_mma::cp_async_wait<1>();  // tile t (and Q, dO) landed for this thread
    __syncthreads();             // ... and for every thread
    const bf16* sk = skv + (t & 1) * 2 * BC * P;
    const bf16* sv = sk + BC * P;
    const float* sm = smask + (t & 1) * BC;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x BC keys
    float s[BC / 8][4] = {}, dp[BC / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ag[4];
      sf_mma::ldmatrix_x4(aq, sq + sf_mma::a_offset(lane, P, rw, kk * 16));
      sf_mma::ldmatrix_x4(ag, sdo + sf_mma::a_offset(lane, P, rw, kk * 16));
#pragma unroll
      for (int n = 0; n < BC / 16; ++n) {
        uint32_t bk[4], bv[4];
        sf_mma::ldmatrix_x4(bk, sk + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        sf_mma::ldmatrix_x4(bv, sv + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        sf_mma::mma_bf16(s[2 * n], aq, bk[0], bk[1]);
        sf_mma::mma_bf16(s[2 * n + 1], aq, bk[2], bk[3]);
        sf_mma::mma_bf16(dp[2 * n], ag, bv[0], bv[1]);
        sf_mma::mma_bf16(dp[2 * n + 1], ag, bv[2], bv[3]);
      }
    }

    // dS = P (dP - D), P = exp(scale S - L), 0 where masked; as A fragments
    const int k0 = t * BC;
    const bool edge = mask != nullptr || k0 + BC > Sk ||
                      (causal && k0 + BC - 1 > q0);
    uint32_t ads[BC / 16][4];
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = exp2f(fmaf(s[n][e], sl2, -lse2[r]));
        float x = p * (dp[n][e] - dlt[r]);
        if (edge) {
          const int col = n * 8 + c2 + (e & 1), kj = k0 + col;
          const int qi = q0 + rw + g + 8 * r;
          const bool keep = kj < Sk && !(causal && kj > qi) &&
                            (mask == nullptr || sm[col] > 0.f);
          x = keep ? x : 0.f;
        }
        s[n][e] = x;
      }
    }
#pragma unroll
    for (int j = 0; j < BC / 16; ++j)
      sf_mma::accum_to_a(ads[j], s[2 * j], s[2 * j + 1]);

    // dQ += dS K
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bk[4];
        sf_mma::ldmatrix_x4_trans(bk, sk + sf_mma::b_offset(lane, P, j * 16, n * 16));
        sf_mma::mma_bf16(acc[2 * n], ads[j], bk[0], bk[1]);
        sf_mma::mma_bf16(acc[2 * n + 1], ads[j], bk[2], bk[3]);
      }
    }
    __syncthreads();  // stage t & 1 is consumed before tile t + 2 fills it
  }
  sf_mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rw + g + 8 * r;
    if (qi >= S) continue;
    bf16* row = dq + b * s_[12] + h * s_[13] + qi * s_[14];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + c2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
            scale * acc[n][2 * r], scale * acc[n][2 * r + 1]);
    }
  }
}

// dK, dV: one block per (batch*head, 64-key tile); loops over query tiles.
// Strides: q, k, v, dout, dk, dv.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ mask,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int H,
                         int S, int Sk, int D, Strides st, float scale,
                         int causal) {
  constexpr int P = HD + 8, BC = dkv_tile<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [kOwn][P]
  bf16* sv = sk + kOwn * P;                      // [kOwn][P]
  bf16* sqg = sv + kOwn * P;                     // [2 stages][Q, dO][BC][P]
  // [2 stages][L, D][BC]
  float* sstat = reinterpret_cast<float*>(sqg + 2 * 2 * BC * P);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the first key tiles see the most queries: they start first
  const int k0 = blockIdx.y * kOwn;
  const long long* s_ = st.s;
  const bf16* qb = q + b * s_[0] + h * s_[1];
  const bf16* kb = k + b * s_[3] + h * s_[4];
  const bf16* vb = v + b * s_[6] + h * s_[7];
  const bf16* dob = dout + b * s_[9] + h * s_[10];

  load_rows<HD>(sk, kb, s_[5], k0, kOwn, Sk, D);
  load_rows<HD>(sv, vb, s_[8], k0, kOwn, Sk, D);
  const int ntiles = (S + BC - 1) / BC;
  // causal: query tiles wholly above this key tile's diagonal see P = 0
  const int t0 = causal ? min(k0 / BC, ntiles) : 0;

  auto load_tile = [&](int t) {
    const int q0 = t * BC, stage = (t - t0) & 1;
    bf16* dst = sqg + stage * 2 * BC * P;
    load_rows<HD>(dst, qb, s_[2], q0, BC, S, D);
    load_rows<HD>(dst + BC * P, dob, s_[11], q0, BC, S, D);
    if (tid < 2 * BC) {
      const int qi = q0 + (tid < BC ? tid : tid - BC);
      sf_mma::cp_async4(sstat + stage * 2 * BC + tid,
                        (tid < BC ? lse : delta) + (long long)bh * S +
                            (qi < S ? qi : 0),
                        qi < S ? 4 : 0);
    }
  };
  if (t0 < ntiles) load_tile(t0);
  sf_mma::cp_async_commit();

  // this lane's two keys of the warp's 16 (accumulator rows g and g + 8)
  const int g = lane >> 2, c2 = (lane & 3) * 2, rw = warp * 16;
  bool keep_k[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + rw + g + 8 * r;
    keep_k[r] = kj < Sk && (mask == nullptr ||
                            mask[(long long)b * Sk + kj] > 0.f);
  }
  const float sl2 = scale * kLog2e;

  float acck[HD / 8][4] = {}, accv[HD / 8][4] = {};
  for (int t = t0; t < ntiles; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < ntiles) load_tile(t + 1);
    sf_mma::cp_async_commit();
    sf_mma::cp_async_wait<1>();  // tile t (and K, V) landed for this thread
    __syncthreads();             // ... and for every thread
    const bf16* sq = sqg + stage * 2 * BC * P;
    const bf16* sdo = sq + BC * P;
    const float* slse = sstat + stage * 2 * BC;
    const float* sdl = slse + BC;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x BC queries
    float s[BC / 8][4] = {}, dp[BC / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      sf_mma::ldmatrix_x4(ak, sk + sf_mma::a_offset(lane, P, rw, kk * 16));
      sf_mma::ldmatrix_x4(av, sv + sf_mma::a_offset(lane, P, rw, kk * 16));
#pragma unroll
      for (int n = 0; n < BC / 16; ++n) {
        uint32_t bq[4], bg[4];
        sf_mma::ldmatrix_x4(bq, sq + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        sf_mma::ldmatrix_x4(bg, sdo + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        sf_mma::mma_bf16(s[2 * n], ak, bq[0], bq[1]);
        sf_mma::mma_bf16(s[2 * n + 1], ak, bq[2], bq[3]);
        sf_mma::mma_bf16(dp[2 * n], av, bg[0], bg[1]);
        sf_mma::mma_bf16(dp[2 * n + 1], av, bg[2], bg[3]);
      }
    }

    // P^T and dS^T = P^T (dP^T - D), 0 where masked; as A fragments
    const int q0 = t * BC;
    const bool edge = mask != nullptr || q0 + BC > S ||
                      (causal && q0 < k0 + kOwn - 1);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(slse + n * 8 + c2);
      const float2 dl = *reinterpret_cast<const float2*>(sdl + n * 8 + c2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, cq = e & 1;
        float p = exp2f(fmaf(s[n][e], sl2, -(cq ? l.y : l.x) * kLog2e));
        if (edge) {
          const int qi = q0 + n * 8 + c2 + cq, kj = k0 + rw + g + 8 * r;
          const bool keep = qi < S && keep_k[r] && !(causal && kj > qi);
          p = keep ? p : 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - (cq ? dl.y : dl.x));
      }
    }
    uint32_t ap[BC / 16][4], ads[BC / 16][4];
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      sf_mma::accum_to_a(ap[j], s[2 * j], s[2 * j + 1]);
      sf_mma::accum_to_a(ads[j], dp[2 * j], dp[2 * j + 1]);
    }

    // dV += P^T dO;  dK += dS^T Q
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bg[4], bq[4];
        sf_mma::ldmatrix_x4_trans(bg, sdo + sf_mma::b_offset(lane, P, j * 16, n * 16));
        sf_mma::mma_bf16(accv[2 * n], ap[j], bg[0], bg[1]);
        sf_mma::mma_bf16(accv[2 * n + 1], ap[j], bg[2], bg[3]);
        sf_mma::ldmatrix_x4_trans(bq, sq + sf_mma::b_offset(lane, P, j * 16, n * 16));
        sf_mma::mma_bf16(acck[2 * n], ads[j], bq[0], bq[1]);
        sf_mma::mma_bf16(acck[2 * n + 1], ads[j], bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is consumed before tile t + 2 fills it
  }
  sf_mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + rw + g + 8 * r;
    if (kj >= Sk) continue;
    bf16* krow = dk + b * s_[12] + h * s_[13] + kj * s_[14];
    bf16* vrow = dv + b * s_[15] + h * s_[16] + kj * s_[17];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + c2;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(krow + d) = __floats2bfloat162_rn(
            scale * acck[n][2 * r], scale * acck[n][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow + d) =
            __floats2bfloat162_rn(accv[n][2 * r], accv[n][2 * r + 1]);
      }
    }
  }
}

template <int HD>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* mask, void* dq,
                          int B, int H, int S, int Sk, int D,
                          const long long* strides, float scale, int causal,
                          cudaStream_t stream) {
  auto kern = flash_bwd_dq_mma_kernel<HD>;
  const size_t smem = dq_mma_smem<HD>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + kOwn - 1) / kOwn);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      mask, static_cast<bf16*>(dq), H, S, Sk, D, copy_strides(strides, 15),
      scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* mask, void* dk,
                           void* dv, int B, int H, int S, int Sk, int D,
                           const long long* strides, float scale, int causal,
                           cudaStream_t stream) {
  auto kern = flash_bwd_dkv_mma_kernel<HD>;
  const size_t smem = dkv_mma_smem<HD>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sk + kOwn - 1) / kOwn);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      mask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, Sk, D,
      copy_strides(strides, 18), scale, causal);
  return cudaGetLastError();
}

// head_dim rounded up to a multiple of 16
#define SF_DISPATCH_HD(fn, d, ...)                \
  switch ((d + 15) / 16 * 16) {                   \
    case 16: return fn<16>(__VA_ARGS__);          \
    case 32: return fn<32>(__VA_ARGS__);          \
    case 48: return fn<48>(__VA_ARGS__);          \
    case 64: return fn<64>(__VA_ARGS__);          \
    case 80: return fn<80>(__VA_ARGS__);          \
    case 96: return fn<96>(__VA_ARGS__);          \
    case 112: return fn<112>(__VA_ARGS__);        \
    case 128: return fn<128>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;        \
  }

// cp.async reads 16-byte chunks: the four bf16 operands' pointers must be
// 16-byte aligned and their (batch, head, seq) strides multiples of 8
bool cp_async_ready(const void* q, const void* k, const void* v,
                    const void* dout, const long long* strides) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

cudaError_t dispatch_dq_mma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* mask, void* dq,
                            int B, int H, int S, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            cudaStream_t stream) {
  if (!cp_async_ready(q, k, v, dout, strides)) return cudaErrorInvalidValue;
  SF_DISPATCH_HD(launch_dq_mma, D, q, k, v, dout, lse, delta, mask, dq, B, H,
                 S, Sk, D, strides, scale, causal, stream)
}

cudaError_t dispatch_dkv_mma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* mask, void* dk,
                             void* dv, int B, int H, int S, int Sk, int D,
                             const long long* strides, float scale,
                             int causal, cudaStream_t stream) {
  if (!cp_async_ready(q, k, v, dout, strides)) return cudaErrorInvalidValue;
  SF_DISPATCH_HD(launch_dkv_mma, D, q, k, v, dout, lse, delta, mask, dk, dv,
                 B, H, S, Sk, D, strides, scale, causal, stream)
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq are [B, H, S, D] and k/v
// [B, H, Sk, D] with D contiguous; strides[15] = (q, k, v, dout, dq) x
// (batch, head, seq) in elements. lse, delta: [B, H, S] float32 contiguous;
// mask: [B, Sk] float32 (> 0 attends) or null. Requires D % 8 == 0 and
// 8 <= D <= 128 (the wrapper checks); for bfloat16 also 16-byte aligned
// q/k/v/dout pointers and their strides multiples of 8 (cp_async_ready).
// float32 runs the CUDA-core kernel, bfloat16 the tensor-core one.
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
      : dispatch_dq_mma(q, k, v, dout, l, dl, m, dq, B, H, S, Sk, D, strides, scale, causal, s);
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
      : dispatch_dkv_mma(q, k, v, dout, l, dl, m, dk, dv, B, H, S, Sk, D, strides, scale, causal, s);
  return (int)e;
}
