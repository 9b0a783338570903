// Fused attention forward (flash attention) for NVIDIA Hopper, sm_90a.
//
// Replaces the TPU kernel sparkflow_tpu/ops/attention.py:_flash_kernel
// (launched by _flash_pallas_forward). Same function: O = softmax(scale *
// Q K^T [+ causal mask] [+ key-padding mask]) V with the softmax statistics
// kept in float32 and folded online over key tiles, so the S x Sk score
// matrix never reaches device memory; also writes the per-row logsumexp
// (lse = m + log max(l, 1e-30), a contiguous [B, H, S] float32 tensor) that
// the backward kernels (flash_bwd.cu) recompute P from.
//
// Translation from the TPU kernel:
// - the TPU grid's sequential key axis (ki), which carried m / l / acc in VMEM
//   scratch from one grid step to the next, becomes a loop inside the block;
//   the running statistics live in registers for the whole loop;
// - blocks are independent, one per (batch*head, query tile), so the grid
//   fills the card's 132 SMs in any order;
// - key tiles wholly above the causal diagonal are not visited (the TPU
//   kernel's pl.when skip), and the ragged edges of S and Sk are masked here,
//   so any sequence length works (no % 128 tile rule);
// - masked scores are -1e30 exactly like the TPU kernel (a row whose keys
//   are all padding averages them uniformly, as there), while keys past Sk
//   contribute exactly nothing (-inf). The mask selects, never multiplies.
//
// bfloat16 operands (the serving prefill and the training step) run on the
// tensor cores, FlashAttention-2 on mma.sync (building blocks in
// mma_bf16.cuh, shared with the backward kernels):
// - one block of 4 warps per (batch*head, 64-row query tile); each warp owns
//   16 query rows, whose Q fragments are loaded into registers once;
// - K and V tiles of 64 keys (and the key mask) flow through a two-stage
//   cp.async ring of 16-byte copies, zero-filled past Sk and past D: the
//   load of tile t+1 is in flight while tile t is computed. Tiles stay bf16
//   in shared memory with rows padded by 16 bytes (conflict-free ldmatrix);
// - S = Q K^T with K read as the B^T tile; each thread holds 2 rows x 16
//   columns of S; the row max is reduced over the 4 lanes of a quad with
//   shuffles, m and l stay in float32 registers (2 rows per thread; l is
//   summed per thread and reduced over the quad once, at the end), and the
//   exponentials are exp2 of scores pre-scaled by scale * log2(e);
// - P is rounded to bf16 in registers (accum_to_a), as the TPU kernel's
//   p.astype(v.dtype) does, and O += P V with V through ldmatrix.trans;
//   l sums the float32 P, unrounded, as the TPU kernel does;
// - the mask path (causal, ragged Sk, key padding) runs only on tiles that
//   need it: every tile with a key mask, the tile that crosses Sk and the
//   tiles that cross the causal diagonal; interior tiles scale and exp2;
// - the grid is (batch*head, query tile) with the tile index reversed, so
//   the longest causal tiles start first and the short ones fill the tail
//   (at B=1, 192 blocks on 132 SMs);
// - specialised on head_dim rounded up to 16 (HD = 16..128); a head_dim
//   that is a multiple of 8 but not of 16 is zero-padded in shared memory
//   (cp.async's zero fill), which adds nothing to Q K^T, and the padded
//   output columns are not written; query rows past S are zero-filled and
//   never stored.
//
// What bounds it on the H100: at the training shape (B=8, H=12, S=1024,
// D=64, causal) the work is 2 products of ~2*S*S/2*D flops per head over
// ~4*S*D*2 bytes per head, ~256 flops per byte: near the bf16 ridge
// (~295), so the limit is tensor-core issue. mma.sync, issued by each warp
// on its own, does not reach the card's 989 TFLOP/s (Hopper's wgmma does).
// ptxas -v on an H100 (sm_90a; chip_smoke.py prints it at set-up), no
// instantiation spills; registers / dynamic shared memory per block / blocks
// per SM that both allow:
//   HD  16:  77 / 15,872 / 6     HD  80: 129 / 56,832 / 3
//   HD  32:  92 / 26,112 / 5     HD  96: 140 / 67,072 / 3
//   HD  48: 104 / 36,352 / 4     HD 112: 171 / 77,312 / 2
//   HD  64: 134 / 46,592 / 3     HD 128: 174 / 87,552 / 2
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W): 0.0872 ms at the training
// shape, 148 TFLOP/s, 1.80x SDPA; 0.0261 ms at B=1 S=1024, 1.72x SDPA.
// cp.async needs 16-byte aligned rows: the wrapper checks each operand's
// pointer and strides and makes a copy where they are not, and the entry
// point refuses (cudaErrorInvalidValue) what is not aligned.
//
// float32 operands (the exactness arm, held to 1e-4; TF32 tensor cores
// would miss that) keep a CUDA-core kernel: one block per (batch*head,
// 32-row query tile) of 4 warps x 8 rows; operands converted once into
// shared memory; each lane owns one key of the 32-key tile for Q K^T and a
// strip of head_dim columns for P V, Q rows are read as float4 broadcasts
// and P through a per-warp shared buffer, K with a padded row.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;         // the TPU kernel's NEG_INF

// (batch, head, seq) element strides of q, k, v and o
struct Strides {
  long long s[12];
};

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBlockQ = kWarps * kRows;   // query rows per block
constexpr int kBlockK = 32;               // keys per tile: one per lane

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
template <int NC>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ mask,
                 float* __restrict__ o, float* __restrict__ lse, int H, int S,
                 int Sk, int D, Strides st, float scale, int causal) {
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
  const long long* s_ = st.s;
  const float* qb = q + b * s_[0] + h * s_[1];
  const float* kb = k + b * s_[3] + h * s_[4];
  const float* vb = v + b * s_[6] + h * s_[7];

  for (int i = tid; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, qi = q0 + r;
    sq[i] = qi < S ? qb[qi * s_[2] + d] : 0.f;
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
      sk[j * DP + d] = in ? kb[kj * s_[5] + d] : 0.f;
      sv[j * D + d] = in ? vb[kj * s_[8] + d] : 0.f;
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
    float* orow = o + b * s_[9] + h * s_[10] + qi * s_[11];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = acc[r][c] / denom;
    }
    if (lse != nullptr && lane == 0)
      lse[(long long)bh * S + qi] = m[r] + logf(denom);
  }
}

template <int NC>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* lse, int B, int H,
                       int S, int Sk, int D, const Strides& st, float scale,
                       int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<NC>;
  const size_t smem = smem_bytes(D);
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), lse, H, S,
      Sk, D, st, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const float* mask, void* o, float* lse, int B, int H,
                         int S, int Sk, int D, const Strides& st, float scale,
                         int causal, cudaStream_t stream) {
  switch ((D + 31) / 32) {
    case 1: return launch_f32<1>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 2: return launch_f32<2>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 3: return launch_f32<3>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 4: return launch_f32<4>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;    // 4 warps
constexpr int kBlockM = 64;         // query rows per block: 16 per warp
constexpr int kBlockN = 64;         // keys per visited tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = kNegInf * kLog2e;   // NEG_INF in the exp2 domain

template <int HD>
size_t mma_smem() {
  return sizeof(bf16) * (HD + 8) * (kBlockM + 2 * 2 * kBlockN) +
         sizeof(float) * 2 * kBlockN;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One block per (batch*head, 64-query tile); loops over 64-key tiles.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const float* __restrict__ mask, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int S, int Sk, int D,
                     Strides st, float scale, int causal) {
  constexpr int P = HD + 8, BN = kBlockN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kBlockM][P]
  bf16* skv = sq + kBlockM * P;                  // [2 stages][K, V][BN][P]
  float* smask = reinterpret_cast<float*>(skv + 2 * 2 * BN * P);  // [2][BN]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the last query tiles see the most keys: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const long long* s_ = st.s;
  const bf16* qb = q + b * s_[0] + h * s_[1];
  const bf16* kb = k + b * s_[3] + h * s_[4];
  const bf16* vb = v + b * s_[6] + h * s_[7];

  int ntiles = (Sk + BN - 1) / BN;
  if (causal) ntiles = min(ntiles, (min(q0 + kBlockM, S) - 1) / BN + 1);

  auto load_tile = [&](int t) {
    const int k0 = t * BN;
    bf16* dst = skv + (t & 1) * 2 * BN * P;
    sf_mma::load_rows<HD, kMmaThreads>(dst, kb, s_[5], k0, BN, Sk, D);
    sf_mma::load_rows<HD, kMmaThreads>(dst + BN * P, vb, s_[8], k0, BN, Sk, D);
    if (mask != nullptr && tid < BN) {
      const int kj = k0 + tid;
      sf_mma::cp_async4(smask + (t & 1) * BN + tid,
                        mask + (long long)b * Sk + (kj < Sk ? kj : 0),
                        kj < Sk ? 4 : 0);
    }
  };
  sf_mma::load_rows<HD, kMmaThreads>(sq, qb, s_[2], q0, kBlockM, S, D);
  if (ntiles > 0) load_tile(0);
  sf_mma::cp_async_commit();
  sf_mma::cp_async_wait<0>();
  __syncthreads();

  // this lane's two rows of the warp's 16 (accumulator rows g and g + 8),
  // and the warp's Q fragments, held for the whole loop
  const int g = lane >> 2, c2 = (lane & 3) * 2, rw = warp * 16;
  uint32_t aq[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    sf_mma::ldmatrix_x4(aq[kk], sq + sf_mma::a_offset(lane, P, rw, kk * 16));
  const float sl2 = scale * kLog2e;

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    sf_mma::cp_async_commit();
    sf_mma::cp_async_wait<1>();  // tile t landed for this thread
    __syncthreads();             // ... and for every thread
    const bf16* sk = skv + (t & 1) * 2 * BN * P;
    const bf16* sv = sk + BN * P;
    const float* sm = smask + (t & 1) * BN;

    // S = Q K^T for the warp's 16 rows x BN keys
    float s[BN / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        uint32_t bk[4];
        sf_mma::ldmatrix_x4(bk, sk + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        sf_mma::mma_bf16(s[2 * n], aq[kk], bk[0], bk[1]);
        sf_mma::mma_bf16(s[2 * n + 1], aq[kk], bk[2], bk[3]);
      }
    }

    // scores in the exp2 domain, masked where the tile needs it; row max
    const int k0 = t * BN;
    const bool edge = mask != nullptr || k0 + BN > Sk ||
                      (causal && k0 + BN - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[n][e] * sl2;
        if (edge) {
          const int col = n * 8 + c2 + (e & 1), kj = k0 + col;
          const int qi = q0 + rw + g + 8 * r;
          const bool drop = (causal && kj > qi) ||
                            (mask != nullptr && !(sm[col] > 0.f));
          x = kj >= Sk ? -CUDART_INF_F : (drop ? kMasked : x);
        }
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // P = exp2(x - m) in float32 (l sums it unrounded), then rounded to bf16
    // as the A fragments of O += P V
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = p;
      }
    }
    uint32_t ap[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      sf_mma::accum_to_a(ap[j], s[2 * j], s[2 * j + 1]);

#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        uint32_t bv[4];
        sf_mma::ldmatrix_x4_trans(bv, sv + sf_mma::b_offset(lane, P, j * 16, n * 16));
        sf_mma::mma_bf16(acc[2 * n], ap[j], bv[0], bv[1]);
        sf_mma::mma_bf16(acc[2 * n + 1], ap[j], bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage t & 1 is consumed before tile t + 2 fills it
  }
  sf_mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(l[r]), 1e-30f);
    const int qi = q0 + rw + g + 8 * r;
    if (qi >= S) continue;
    bf16* row = o + b * s_[9] + h * s_[10] + qi * s_[11];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + c2;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
            acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
    }
    if (lse != nullptr && (lane & 3) == 0)
      lse[(long long)bh * S + qi] = m[r] * kLn2 + logf(den);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const float* mask, void* o, float* lse, int B, int H,
                       int S, int Sk, int D, const Strides& st, float scale,
                       int causal, cudaStream_t stream) {
  auto kern = flash_fwd_mma_kernel<HD>;
  const size_t smem = mma_smem<HD>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + kBlockM - 1) / kBlockM);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), mask, static_cast<bf16*>(o), lse, H, S, Sk,
      D, st, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const float* mask, void* o, float* lse, int B, int H,
                         int S, int Sk, int D, const Strides& st, float scale,
                         int causal, cudaStream_t stream) {
  // cp.async reads 16-byte chunks: 16-byte aligned q/k/v pointers and
  // (batch, head, seq) strides that are multiples of 8 elements
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (st.s[i] % 8 != 0) return cudaErrorInvalidValue;
  switch ((D + 15) / 16 * 16) {   // head_dim rounded up to 16
    case 16: return launch_mma<16>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 32: return launch_mma<32>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 48: return launch_mma<48>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 64: return launch_mma<64>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 80: return launch_mma<80>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 96: return launch_mma<96>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 112: return launch_mma<112>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    case 128: return launch_mma<128>(q, k, v, mask, o, lse, B, H, S, Sk, D, st, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o are [B, H, S|Sk, D] with D
// contiguous; strides[12] = (q, k, v, o) x (batch, head, seq) in elements.
// mask: [B, Sk] float32 (> 0 attends) or null; lse: [B, H, S] float32
// contiguous, or null. Requires D % 8 == 0 and 8 <= D <= 128 (the wrapper
// checks); for bfloat16 also 16-byte aligned q/k/v pointers and their
// strides multiples of 8. float32 runs the CUDA-core kernel, bfloat16 the
// tensor-core one.
extern "C" int sf_flash_fwd(int dtype, const void* q, const void* k,
                            const void* v, const void* mask, void* o,
                            void* lse, int B, int H, int S, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            void* stream) {
  if (D % 8 != 0 || D < 8 || D > 128) return (int)cudaErrorInvalidValue;
  Strides st{};
  for (int i = 0; i < 12; ++i) st.s[i] = strides[i];
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_f32(q, k, v, m, o, l, B, H, S, Sk, D, st, scale, causal, s)
      : dispatch_mma(q, k, v, m, o, l, B, H, S, Sk, D, st, scale, causal, s);
  return (int)e;
}

extern "C" const char* sf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
