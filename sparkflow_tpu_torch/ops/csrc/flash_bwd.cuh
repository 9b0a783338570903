// The flash attention backward kernels for sm_90a (dQ; dK and dV), as
// templates on head_dim: flash_bwd.cu instantiates them up to HD = 128 and
// holds the C entries, flash_bwd_wide.cu above 128 (HD = 160..256). The
// design, and ptxas's registers and shared memory of each instantiation,
// are in those two files' headers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

// (batch, head, seq) element strides of up to six [B, H, S, D] operands
struct Strides {
  long long s[18];
};

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

constexpr int kMmaThreads = 128;    // 4 warps
constexpr int kOwn = 64;            // the block's own rows: 16 per warp
constexpr float kLog2e = 1.4426950408889634f;

// What a dk/dv kernel computes: both gradients in one block (up to HD =
// 128), or, above, dV (kPartDV: S and P, dV += P^T dO) and dK (kPartDK: S,
// dP and dS, dK += dS^T Q) in two kernels, each with one HD-wide
// accumulator — two would be 256 floats a thread at HD = 256.
constexpr int kPartDK = 1, kPartDV = 2, kPartBoth = 3;

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// visited-side tile rows: the dq kernel's 64, 32 above HD = 128 (where its
// HD-wide accumulator is 128 registers a lane); the dkv kernels' 64, 32
// above HD = 64
template <int HD>
__host__ __device__ constexpr int dq_tile() { return HD <= 128 ? 64 : 32; }
template <int HD>
__host__ __device__ constexpr int dkv_tile() { return HD <= 64 ? 64 : 32; }

template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ss, int r0, int nrows,
                                          int n, int D) {
  sf_mma::load_rows<HD, kMmaThreads>(dst, src, ss, r0, nrows, n, D);
}

template <int HD>
size_t dq_mma_smem() {
  return sizeof(bf16) * (HD + 8) * (2 * kOwn + 2 * 2 * dq_tile<HD>()) +
         sizeof(float) * 2 * dq_tile<HD>();
}

// own K (and V, which dP needs, in the parts that compute dK), two stages
// of Q and dO, two stages of L and D
template <int HD, int kPart>
size_t dkv_mma_smem() {
  constexpr int own = (kPart & kPartDK) ? 2 : 1;
  return sizeof(bf16) * (HD + 8) * (own * kOwn + 2 * 2 * dkv_tile<HD>()) +
         sizeof(float) * 2 * 2 * dkv_tile<HD>();
}

// dQ: one block per (batch*head, 64-query tile); loops over key tiles.
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
  constexpr int P = HD + 8, BC = dq_tile<HD>();
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

// dK and/or dV (kPart): one block per (batch*head, 64-key tile); loops over
// query tiles. Strides: q, k, v, dout, dk, dv.
template <int HD, int kPart>
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
  constexpr bool kDK = kPart & kPartDK, kDV = kPart & kPartDV;
  constexpr int P = HD + 8, BC = dkv_tile<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [kOwn][P]
  bf16* sv = sk + kOwn * P;                      // [kOwn][P], dK only
  bf16* sqg = sk + (kDK ? 2 : 1) * kOwn * P;     // [2 stages][Q, dO][BC][P]
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
  if constexpr (kDK) load_rows<HD>(sv, vb, s_[8], k0, kOwn, Sk, D);
  const int ntiles = (S + BC - 1) / BC;
  // causal: query tiles wholly above this key tile's diagonal see P = 0
  const int t0 = causal ? min(k0 / BC, ntiles) : 0;

  auto load_tile = [&](int t) {
    const int q0 = t * BC, stage = (t - t0) & 1;
    bf16* dst = sqg + stage * 2 * BC * P;
    load_rows<HD>(dst, qb, s_[2], q0, BC, S, D);
    load_rows<HD>(dst + BC * P, dob, s_[11], q0, BC, S, D);
    // L, and D where dS is computed
    if (tid < (kDK ? 2 : 1) * BC) {
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

  float acck[kDK ? HD / 8 : 1][4] = {}, accv[kDV ? HD / 8 : 1][4] = {};
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

    // S^T = K Q^T, and dP^T = V dO^T for dK, for the warp's 16 keys x BC
    // queries
    float s[BC / 8][4] = {}, dp[kDK ? BC / 8 : 1][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      sf_mma::ldmatrix_x4(ak, sk + sf_mma::a_offset(lane, P, rw, kk * 16));
      if constexpr (kDK)
        sf_mma::ldmatrix_x4(av, sv + sf_mma::a_offset(lane, P, rw, kk * 16));
#pragma unroll
      for (int n = 0; n < BC / 16; ++n) {
        uint32_t bq[4], bg[4];
        sf_mma::ldmatrix_x4(bq, sq + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        if constexpr (kDK)
          sf_mma::ldmatrix_x4(bg, sdo + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        sf_mma::mma_bf16(s[2 * n], ak, bq[0], bq[1]);
        sf_mma::mma_bf16(s[2 * n + 1], ak, bq[2], bq[3]);
        if constexpr (kDK) {
          sf_mma::mma_bf16(dp[2 * n], av, bg[0], bg[1]);
          sf_mma::mma_bf16(dp[2 * n + 1], av, bg[2], bg[3]);
        }
      }
    }

    // P^T and dS^T = P^T (dP^T - D), 0 where masked; as A fragments
    const int q0 = t * BC;
    const bool edge = mask != nullptr || q0 + BC > S ||
                      (causal && q0 < k0 + kOwn - 1);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(slse + n * 8 + c2);
      float2 dl = make_float2(0.f, 0.f);
      if constexpr (kDK)
        dl = *reinterpret_cast<const float2*>(sdl + n * 8 + c2);
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
        if constexpr (kDK) dp[n][e] = p * (dp[n][e] - (cq ? dl.y : dl.x));
      }
    }
    uint32_t ap[kDV ? BC / 16 : 1][4], ads[kDK ? BC / 16 : 1][4];
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
      if constexpr (kDV) sf_mma::accum_to_a(ap[j], s[2 * j], s[2 * j + 1]);
      if constexpr (kDK) sf_mma::accum_to_a(ads[j], dp[2 * j], dp[2 * j + 1]);
    }

    // dV += P^T dO;  dK += dS^T Q
#pragma unroll
    for (int j = 0; j < BC / 16; ++j) {
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        if constexpr (kDV) {
          uint32_t bg[4];
          sf_mma::ldmatrix_x4_trans(bg, sdo + sf_mma::b_offset(lane, P, j * 16, n * 16));
          sf_mma::mma_bf16(accv[2 * n], ap[j], bg[0], bg[1]);
          sf_mma::mma_bf16(accv[2 * n + 1], ap[j], bg[2], bg[3]);
        }
        if constexpr (kDK) {
          uint32_t bq[4];
          sf_mma::ldmatrix_x4_trans(bq, sq + sf_mma::b_offset(lane, P, j * 16, n * 16));
          sf_mma::mma_bf16(acck[2 * n], ads[j], bq[0], bq[1]);
          sf_mma::mma_bf16(acck[2 * n + 1], ads[j], bq[2], bq[3]);
        }
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
        if constexpr (kDK)
          *reinterpret_cast<__nv_bfloat162*>(krow + d) = __floats2bfloat162_rn(
              scale * acck[n][2 * r], scale * acck[n][2 * r + 1]);
        if constexpr (kDV)
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

template <int HD, int kPart = kPartBoth>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* mask, void* dk,
                           void* dv, int B, int H, int S, int Sk, int D,
                           const long long* strides, float scale, int causal,
                           cudaStream_t stream) {
  auto kern = flash_bwd_dkv_mma_kernel<HD, kPart>;
  const size_t smem = dkv_mma_smem<HD, kPart>();
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 tensor-core kernels
// ---------------------------------------------------------------------------

// Visited tile rows: up to HD = 128 sf_mma::tf32_tile (64, 32 above HD =
// 64); above, 16 where the block holds two own operands (dq: Q, dO; dK: K,
// V) and 32 where it holds one (dV: K), so that a block's shared memory
// stays within the 227 KB it may take (about 200 KB at HD = 256).
template <int HD, int kOwnOps>
__host__ __device__ constexpr int tf32_bwd_tile() {
  return HD <= 128 ? sf_mma::tf32_tile<HD>() : (kOwnOps == 2 ? 16 : 32);
}

// own rows (kOwnOps operands), two stages of two visited operands, and two
// stages of two per-row floats (the dq kernel's key mask uses half)
template <int HD, int kOwnOps>
size_t tf32_smem() {
  constexpr int BC = tf32_bwd_tile<HD, kOwnOps>();
  return sizeof(float) *
         ((HD + 4) * (kOwnOps * kOwn + 2 * 2 * BC) + 2 * 2 * BC);
}

// dQ: one block per (batch*head, 64-query tile); loops over key tiles. Two
// blocks an SM up to HD = 128, one above. Strides: q, k, v, dout, dq.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, HD <= 128 ? 2 : 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ mask,
                         float* __restrict__ dq, int H, int S, int Sk, int D,
                         Strides st, float scale, int causal) {
  constexpr int P = HD + 4, BC = tf32_bwd_tile<HD, 2>();
  // up to HD = 128 specialised on head_dim itself; above, on head_dim
  // rounded up to 32, columns past D zero-filled on load and not stored
  const int Dc = HD <= 128 ? HD : D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kOwn][P]
  float* sdo = sq + kOwn * P;                      // [kOwn][P]
  float* skv = sdo + kOwn * P;                     // [2 stages][K, V][BC][P]
  float* smask = skv + 2 * 2 * BC * P;             // [2 stages][BC]
  __shared__ int last_key;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the last query tiles see the most keys: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const long long* s_ = st.s;
  const float* qb = q + b * s_[0] + h * s_[1];
  const float* kb = k + b * s_[3] + h * s_[4];
  const float* vb = v + b * s_[6] + h * s_[7];
  const float* dob = dout + b * s_[9] + h * s_[10];
  const float* mrow = mask != nullptr ? mask + (long long)b * Sk : nullptr;

  sf_mma::load_rows_f32<HD, kMmaThreads>(sq, qb, s_[2], q0, kOwn, S, Dc);
  sf_mma::load_rows_f32<HD, kMmaThreads>(sdo, dob, s_[11], q0, kOwn, S, Dc);
  int ntiles = (Sk + BC - 1) / BC;
  if (causal) ntiles = min(ntiles, (min(q0 + kOwn, S) - 1) / BC + 1);
  if (mrow != nullptr) {
    // keys after the row's last unpadded one add nothing: the walk ends
    // with the tile that holds it (none: dQ is zero)
    if (tid == 0) last_key = -1;
    __syncthreads();
    int last = -1;
    for (int j = tid; j < min(Sk, ntiles * BC); j += kMmaThreads)
      if (mrow[j] > 0.f) last = j;
    if (last >= 0) atomicMax(&last_key, last);
    __syncthreads();
    ntiles = min(ntiles, (last_key + BC) / BC);
  }

  auto load_tile = [&](int t) {
    const int k0 = t * BC;
    float* dst = skv + (t & 1) * 2 * BC * P;
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst, kb, s_[5], k0, BC, Sk, Dc);
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst + BC * P, vb, s_[8], k0, BC,
                                           Sk, Dc);
    if (mrow != nullptr && tid < BC) {
      const int kj = k0 + tid;
      sf_mma::cp_async4(smask + (t & 1) * BC + tid, mrow + (kj < Sk ? kj : 0),
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
    const int k0 = t * BC;
    const float* sk = skv + (t & 1) * 2 * BC * P;
    const float* sv = sk + BC * P;
    const float* sm = smask + (t & 1) * BC;
    // ... and for every thread; with a mask, the same barrier counts the
    // tile's keys that attend (0: the tile adds nothing)
    int live = BC;
    if (mrow != nullptr)
      live = __syncthreads_count(tid < BC && sm[tid] > 0.f);
    else
      __syncthreads();

    if (live > 0) {
      // S = Q K^T and dP = dO V^T for the warp's 16 rows x BC keys
      float s[BC / 8][4] = {}, dp[BC / 8][4] = {};
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t qa[4], qa_s[4], ga[4], ga_s[4];
        sf_mma::load_a_split(qa, qa_s, sq, P, rw, kk * 8, lane);
        sf_mma::load_a_split(ga, ga_s, sdo, P, rw, kk * 8, lane);
#pragma unroll
        for (int n = 0; n < BC / 8; ++n) {
          uint32_t kf[2], kf_s[2], vf[2], vf_s[2];
          sf_mma::load_bt_split(kf, kf_s, sk, P, n * 8, kk * 8, lane);
          sf_mma::load_bt_split(vf, vf_s, sv, P, n * 8, kk * 8, lane);
          sf_mma::mma_3xtf32(s[n], qa, qa_s, kf, kf_s);
          sf_mma::mma_3xtf32(dp[n], ga, ga_s, vf, vf_s);
        }
      }

      // dS = P (dP - D), P = exp(scale S - L), 0 where masked
      const bool edge = live < BC || k0 + BC > Sk ||
                        (causal && k0 + BC - 1 > q0);
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
                              (mrow == nullptr || sm[col] > 0.f);
            x = keep ? x : 0.f;
          }
          s[n][e] = x;
        }
      }

      // dQ += dS K, dS straight from its accumulators
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        uint32_t da[4], da_s[4];
        sf_mma::accum_to_a_split(da, da_s, s[j]);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t kf[2], kf_s[2];
          sf_mma::load_b_perm_split(kf, kf_s, sk, P, j * 8, n * 8, lane);
          sf_mma::mma_3xtf32(acc[n], da, da_s, kf, kf_s);
        }
      }
    }
    __syncthreads();  // stage t & 1 is consumed before tile t + 2 fills it
  }
  sf_mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + rw + g + 8 * r;
    if (qi >= S) continue;
    float* row = dq + b * s_[12] + h * s_[13] + qi * s_[14];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      if (HD <= 128 || n * 8 + c2 < D)
        sf_mma::store2(row + n * 8 + c2, scale * acc[n][2 * r],
                       scale * acc[n][2 * r + 1]);
  }
}

// dK and/or dV (kPart): one block per (batch*head, 64-key tile); loops over
// query tiles. Two blocks an SM up to HD = 128, one above. Strides: q, k,
// v, dout, dk, dv.
template <int HD, int kPart>
__global__ void __launch_bounds__(kMmaThreads, HD <= 128 ? 2 : 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ mask,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int S, int Sk, int D, Strides st,
                          float scale, int causal) {
  constexpr bool kDK = kPart & kPartDK, kDV = kPart & kPartDV;
  constexpr int P = HD + 4, BC = tf32_bwd_tile<HD, kDK ? 2 : 1>();
  const int Dc = HD <= 128 ? HD : D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // [kOwn][P]
  float* sv = sk + kOwn * P;                       // [kOwn][P], dK only
  float* sqg = sk + (kDK ? 2 : 1) * kOwn * P;      // [2 stages][Q, dO][BC][P]
  float* sstat = sqg + 2 * 2 * BC * P;             // [2 stages][L, D][BC]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the first key tiles see the most queries: they start first
  const int k0 = blockIdx.y * kOwn;
  const long long* s_ = st.s;
  const float* qb = q + b * s_[0] + h * s_[1];
  const float* kb = k + b * s_[3] + h * s_[4];
  const float* vb = v + b * s_[6] + h * s_[7];
  const float* dob = dout + b * s_[9] + h * s_[10];

  // the block's own keys that attend: none, and its dK / dV rows are zero;
  // all, and no key mask below
  bool own_all = true;
  if (mask != nullptr) {
    const int kj = k0 + tid;
    const bool live = tid < kOwn && kj < Sk &&
                      mask[(long long)b * Sk + kj] > 0.f;
    if (!__syncthreads_or(live)) {
      const int nrows = min(kOwn, Sk - k0), half = Dc / 2;
      float* dkb = dk + b * s_[12] + h * s_[13];
      float* dvb = dv + b * s_[15] + h * s_[16];
      for (int i = tid; i < nrows * half; i += kMmaThreads) {
        const int r = i / half, d = (i - r * half) * 2;
        if constexpr (kDK) sf_mma::store2(dkb + (k0 + r) * s_[14] + d, 0.f, 0.f);
        if constexpr (kDV) sf_mma::store2(dvb + (k0 + r) * s_[17] + d, 0.f, 0.f);
      }
      return;
    }
    own_all = __syncthreads_and(tid >= kOwn || live);
  }

  sf_mma::load_rows_f32<HD, kMmaThreads>(sk, kb, s_[5], k0, kOwn, Sk, Dc);
  if constexpr (kDK)
    sf_mma::load_rows_f32<HD, kMmaThreads>(sv, vb, s_[8], k0, kOwn, Sk, Dc);
  const int ntiles = (S + BC - 1) / BC;
  // causal: query tiles wholly above this key tile's diagonal see P = 0
  const int t0 = causal ? min(k0 / BC, ntiles) : 0;

  auto load_tile = [&](int t) {
    const int q0 = t * BC, stage = (t - t0) & 1;
    float* dst = sqg + stage * 2 * BC * P;
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst, qb, s_[2], q0, BC, S, Dc);
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst + BC * P, dob, s_[11], q0, BC,
                                           S, Dc);
    // L, and D where dS is computed
    if (tid < (kDK ? 2 : 1) * BC) {
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

  float acck[kDK ? HD / 8 : 1][4] = {}, accv[kDV ? HD / 8 : 1][4] = {};
  for (int t = t0; t < ntiles; ++t) {
    const int stage = (t - t0) & 1;
    if (t + 1 < ntiles) load_tile(t + 1);
    sf_mma::cp_async_commit();
    sf_mma::cp_async_wait<1>();  // tile t (and K, V) landed for this thread
    __syncthreads();             // ... and for every thread
    const float* sq = sqg + stage * 2 * BC * P;
    const float* sdo = sq + BC * P;
    const float* slse = sstat + stage * 2 * BC;
    const float* sdl = slse + BC;

    // S^T = K Q^T, and dP^T = V dO^T for dK, for the warp's 16 keys x BC
    // queries
    float s[BC / 8][4] = {}, dp[kDK ? BC / 8 : 1][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ka[4], ka_s[4], va[4], va_s[4];
      sf_mma::load_a_split(ka, ka_s, sk, P, rw, kk * 8, lane);
      if constexpr (kDK)
        sf_mma::load_a_split(va, va_s, sv, P, rw, kk * 8, lane);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t qf[2], qf_s[2], gf[2], gf_s[2];
        sf_mma::load_bt_split(qf, qf_s, sq, P, n * 8, kk * 8, lane);
        if constexpr (kDK)
          sf_mma::load_bt_split(gf, gf_s, sdo, P, n * 8, kk * 8, lane);
        sf_mma::mma_3xtf32(s[n], ka, ka_s, qf, qf_s);
        if constexpr (kDK) sf_mma::mma_3xtf32(dp[n], va, va_s, gf, gf_s);
      }
    }

    // P^T and dS^T = P^T (dP^T - D), 0 where masked
    const int q0 = t * BC;
    const bool edge = !own_all || q0 + BC > S ||
                      (causal && q0 < k0 + kOwn - 1);
#pragma unroll
    for (int n = 0; n < BC / 8; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(slse + n * 8 + c2);
      float2 dl = make_float2(0.f, 0.f);
      if constexpr (kDK)
        dl = *reinterpret_cast<const float2*>(sdl + n * 8 + c2);
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
        if constexpr (kDK) dp[n][e] = p * (dp[n][e] - (cq ? dl.y : dl.x));
      }
    }

    // dV += P^T dO;  dK += dS^T Q, P^T and dS^T straight from their
    // accumulators
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      uint32_t pa[4], pa_s[4], da[4], da_s[4];
      if constexpr (kDV) sf_mma::accum_to_a_split(pa, pa_s, s[j]);
      if constexpr (kDK) sf_mma::accum_to_a_split(da, da_s, dp[j]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bf[2], bf_s[2];
        if constexpr (kDV) {
          sf_mma::load_b_perm_split(bf, bf_s, sdo, P, j * 8, n * 8, lane);
          sf_mma::mma_3xtf32(accv[n], pa, pa_s, bf, bf_s);
        }
        if constexpr (kDK) {
          sf_mma::load_b_perm_split(bf, bf_s, sq, P, j * 8, n * 8, lane);
          sf_mma::mma_3xtf32(acck[n], da, da_s, bf, bf_s);
        }
      }
    }
    __syncthreads();  // this stage is consumed before tile t + 2 fills it
  }
  sf_mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + rw + g + 8 * r;
    if (kj >= Sk) continue;
    float* krow = dk + b * s_[12] + h * s_[13] + kj * s_[14];
    float* vrow = dv + b * s_[15] + h * s_[16] + kj * s_[17];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (HD > 128 && n * 8 + c2 >= D) continue;
      if constexpr (kDK)
        sf_mma::store2(krow + n * 8 + c2, scale * acck[n][2 * r],
                       scale * acck[n][2 * r + 1]);
      if constexpr (kDV)
        sf_mma::store2(vrow + n * 8 + c2, accv[n][2 * r],
                       accv[n][2 * r + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* mask, void* dq,
                           int B, int H, int S, int Sk, int D,
                           const long long* strides, float scale, int causal,
                           cudaStream_t stream) {
  auto kern = flash_bwd_dq_tf32_kernel<HD>;
  const size_t smem = tf32_smem<HD, 2>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + kOwn - 1) / kOwn);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, mask, static_cast<float*>(dq), H, S, Sk, D,
      copy_strides(strides, 15), scale, causal);
  return cudaGetLastError();
}

template <int HD, int kPart = kPartBoth>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* mask, void* dk,
                            void* dv, int B, int H, int S, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            cudaStream_t stream) {
  auto kern = flash_bwd_dkv_tf32_kernel<HD, kPart>;
  const size_t smem = tf32_smem<HD, (kPart & kPartDK) ? 2 : 1>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sk + kOwn - 1) / kOwn);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, mask, static_cast<float*>(dk), static_cast<float*>(dv), H, S, Sk,
      D, copy_strides(strides, 18), scale, causal);
  return cudaGetLastError();
}

}  // namespace

// The instantiations above HD = 128 (flash_bwd_wide.cu), for head_dim D in
// (128, 256], a multiple of 8; the operands as the C entries of
// flash_bwd.cu take them, already checked there.
namespace sf_bwd {

cudaError_t wide_dq_mma(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        const float* mask, void* dq, int B, int H, int S,
                        int Sk, int D, const long long* strides, float scale,
                        int causal, cudaStream_t stream);
cudaError_t wide_dkv_mma(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* mask, void* dk,
                         void* dv, int B, int H, int S, int Sk, int D,
                         const long long* strides, float scale, int causal,
                         cudaStream_t stream);
cudaError_t wide_dq_tf32(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const float* mask, void* dq,
                         int B, int H, int S, int Sk, int D,
                         const long long* strides, float scale, int causal,
                         cudaStream_t stream);
cudaError_t wide_dkv_tf32(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const float* mask, void* dk,
                          void* dv, int B, int H, int S, int Sk, int D,
                          const long long* strides, float scale, int causal,
                          cudaStream_t stream);

}  // namespace sf_bwd
