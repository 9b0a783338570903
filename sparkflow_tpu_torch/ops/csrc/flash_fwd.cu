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
//   never stored;
// - above 128 (GPT-J-6B's heads are 256), on head_dim rounded up to 32
//   (HD = 160, 192, 224, 256: four instantiations for the 16 head_dims,
//   zero-padded the same way). There one warp's 16-row O accumulator alone
//   is HD / 2 float registers a lane (128 at HD = 256), so the warp's Q
//   fragments (64 more registers at HD = 128) are no longer held: they are
//   read from the shared Q tile with ldmatrix at each key tile, and the
//   key tiles narrow to 32 (S and P 16 and 8 registers). The arithmetic is
//   the same; only the tiles whose maxima P is rounded against are
//   narrower;
// - every other head_dim (above 256, or not a multiple of 8) the C entry
//   sends to the column-sliced kernel of flash_sliced.cu; the wrapper
//   stages a head_dim below 256 that is not a multiple of 8 into operands
//   zero-padded to one (ops/attention.py _pad_head), so those run here.
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
//   HD 160: 130 / 64,768 / 3     HD 224: 167 / 89,344 / 2
//   HD 192: 167 / 77,056 / 2     HD 256: 237 / 101,632 / 2
// Measured (chip_smoke.py, H100 80GB HBM3, 700 W): 0.0872 ms at the training
// shape, 148 TFLOP/s, 1.80x SDPA; 0.0261 ms at B=1 S=1024, 1.72x SDPA.
// cp.async needs 16-byte aligned rows: the wrapper checks each operand's
// pointer and strides and makes a copy where they are not, and the entry
// point refuses (cudaErrorInvalidValue) what is not aligned.
//
// float32 operands (the Spark ML estimator, which gives its Trainer no
// compute dtype, and the exactness checks, held to 1e-4) run on the tensor
// cores too, in 3xTF32 (mma_tf32.cuh, shared with the float32 backward):
// every product is three mma.sync m16n8k8 TF32 products of a big/small
// split of its operands (big = tf32(x), small = tf32(x - big), cvt.rna),
// summed in float32, small terms first — a float32 product to ~2^-21, where
// one TF32 product keeps 2^-11 and misses 1e-4. What bounds it: 2 products
// of 2*D flops per attending (query, key) pair over 16 bytes per query
// row and head_dim column of q, k, v and o: L / 4 flops per byte for L
// attended keys a query, ~96 at the estimator's shape (B=32, H=12, S=512,
// D=64, keys 256-512 of 512 unpadded) and ~128 at the training shape
// (S=1024, causal), above the ridge of the 3xTF32 rate (495 / 3 TFLOP/s
// over 3.35 TB/s, ~49), so the tensor cores' issue is the limit. The
// kernel follows the bf16 one:
// - one block of 4 warps per (batch*head, 64-row query tile), the tile
//   index reversed; each warp owns 16 query rows. K and V tiles (and the
//   key mask) flow through the same two-stage cp.async ring of 16-byte
//   copies, zero-filled past Sk; rows are float32 at a pitch of HD + 4
//   floats, so every fragment load hits 32 distinct banks. Tiles are 64
//   keys, 32 above HD = 64 (two blocks an SM in shared memory; one above
//   HD = 128, where the Q tile and the ring take 199,936 bytes at HD =
//   256);
// - S = Q K^T with Q as the A operand and K read as B^T; an operand is
//   split as its fragment is loaded from shared memory. Up to HD = 64 the
//   warp's Q fragments are split once and held for the whole walk (64
//   registers at HD = 64); above, they are split again at each tile, where
//   the HD-wide accumulator needs the registers;
// - P = exp2(x - m) stays float32: for float32 operands the TPU kernel's
//   p.astype(v.dtype) is a no-op, so P is split (not rounded) and its
//   accumulators are the A operand of O += P V in registers, with no
//   shuffle and no shared buffer: the product's k-slots take the
//   accumulator's columns in the order its registers hold them (2c in slot
//   c, 2c+1 in slot c+4) and V's B fragment reads rows 2c and 2c+1;
// - padding is skipped and the function stays the same: with a key mask the
//   block reads its batch row's mask once; when every one of its rows
//   attends a live key, key tiles all of padding are skipped (a
//   __syncthreads_count over the tile's mask, which is also the barrier the
//   tile needs) and the walk ends with the tile of the last live key. A row
//   with no live key visits every tile and averages them uniformly. The
//   mask, causal test and ragged edge run only on the tiles that need them;
// - specialised on head_dim itself (HD = 8..128 in steps of 8): m16n8k8's
//   k-step of 8 covers every head_dim up to 128 with no padding; above,
//   on head_dim rounded up to 32 (160..256), columns past D zero-filled
//   on load (zero k-steps add nothing) and not stored, as in bf16;
// - no atomics: a second launch gives the same bits.
// The kernel asks for two blocks an SM (__launch_bounds__(128, 2), what
// shared memory allows at HD = 64), so ptxas may spend up to 255 registers
// a thread: holding Q's fragments costs no block at HD = 64, and splitting
// them again at each tile (146 registers there) was slower at the
// estimator's, training and serving shapes in a variant build. ptxas -v on
// an H100 (sm_90a; chip_smoke.py prints it at set-up), registers / dynamic
// shared memory per block / blocks per SM that both allow, no
// instantiation spills (Q held up to HD = 64; 32-key tiles above):
//   HD   8: 140 / 15,872 / 3     HD  72: 133 / 58,624 / 3
//   HD  16: 149 / 26,112 / 3     HD  80: 128 / 64,768 / 3
//   HD  24: 143 / 36,352 / 3     HD  88: 132 / 70,912 / 3
//   HD  32: 167 / 46,592 / 3     HD  96: 141 / 77,056 / 2
//   HD  40: 167 / 56,832 / 3     HD 104: 144 / 83,200 / 2
//   HD  48: 188 / 67,072 / 2     HD 112: 150 / 89,344 / 2
//   HD  56: 204 / 77,312 / 2     HD 120: 151 / 95,488 / 2
//   HD  64: 222 / 87,552 / 2     HD 128: 159 / 101,632 / 2
//   HD 160: 176 / 126,208 / 1    HD 224: 207 / 175,360 / 1
//   HD 192: 198 / 150,784 / 1    HD 256: 228 / 199,936 / 1
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "flash_sliced.cuh"

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
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;    // 4 warps
constexpr int kBlockM = 64;         // query rows per block: 16 per warp
constexpr int kBlockN = 64;         // keys per visited tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMasked = kNegInf * kLog2e;   // NEG_INF in the exp2 domain

// Keys per visited tile: 64 up to HD = 128; above, 32. Up to HD = 128 a
// warp also holds its Q fragments in registers for the whole walk (64
// registers at HD = 128); above, the HD-wide accumulator alone is 4 * HD / 8
// registers a lane (128 at HD = 256), so Q is read from shared memory at
// each tile and the narrower tiles keep S and P at 16 and 8 registers.
template <int HD>
__host__ __device__ constexpr int mma_tile() {
  return HD <= 128 ? kBlockN : 32;
}

template <int HD>
size_t mma_smem() {
  constexpr int BN = mma_tile<HD>();
  return sizeof(bf16) * (HD + 8) * (kBlockM + 2 * 2 * BN) +
         sizeof(float) * 2 * BN;
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
  constexpr int P = HD + 8, BN = mma_tile<HD>();
  constexpr bool kQRegs = HD <= 128;
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
  // and the warp's Q fragments, held for the whole loop up to HD = 128
  const int g = lane >> 2, c2 = (lane & 3) * 2, rw = warp * 16;
  uint32_t aq[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sf_mma::ldmatrix_x4(aq[kk], sq + sf_mma::a_offset(lane, P, rw, kk * 16));
  }
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
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = aq[kk][i];
      } else {
        sf_mma::ldmatrix_x4(a, sq + sf_mma::a_offset(lane, P, rw, kk * 16));
      }
#pragma unroll
      for (int n = 0; n < BN / 16; ++n) {
        uint32_t bk[4];
        sf_mma::ldmatrix_x4(bk, sk + sf_mma::bt_offset(lane, P, n * 16, kk * 16));
        sf_mma::mma_bf16(s[2 * n], a, bk[0], bk[1]);
        sf_mma::mma_bf16(s[2 * n + 1], a, bk[2], bk[3]);
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

// cp.async reads 16-byte chunks: 16-byte aligned q/k/v pointers and
// (batch, head, seq) strides that are multiples of `vec` elements (8 bf16,
// 4 float32)
bool cp_async_ready(const void* q, const void* k, const void* v,
                    const Strides& st, int vec) {
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < 9; ++i)
    if (st.s[i] % vec != 0) return false;
  return true;
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const float* mask, void* o, float* lse, int B, int H,
                         int S, int Sk, int D, const Strides& st, float scale,
                         int causal, cudaStream_t stream) {
  if (!cp_async_ready(q, k, v, st, 8)) return cudaErrorInvalidValue;
  if (D > 128) {
    SF_DISPATCH_WIDE(launch_mma, D, q, k, v, mask, o, lse, B, H, S, Sk, D, st,
                     scale, causal, stream)
  }
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 tensor-core kernel
// ---------------------------------------------------------------------------

// the Q tile, two stages of K and V, and two stages of the key mask
template <int HD>
size_t tf32_smem() {
  constexpr int BN = sf_mma::tf32_tile<HD>();
  return sizeof(float) * ((HD + 4) * (kBlockM + 2 * 2 * BN) + 2 * BN);
}

// One block per (batch*head, 64-query tile); loops over key tiles. Two
// blocks an SM up to HD = 128; above, shared memory holds one (199,936
// bytes at HD = 256).
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, HD <= 128 ? 2 : 1)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ mask, float* __restrict__ o,
                      float* __restrict__ lse, int H, int S, int Sk, int D,
                      Strides st, float scale, int causal) {
  constexpr int P = HD + 4, BN = sf_mma::tf32_tile<HD>();
  // up to HD = 128 the kernel is specialised on head_dim itself; above, on
  // head_dim rounded up to 32, with columns past D zero-filled on load and
  // not stored
  const int Dc = HD <= 128 ? HD : D;
  // Q's split fragments stay in registers for the whole walk up to HD = 64
  // (64 registers there); above, they are split again from shared memory
  // at each tile
  constexpr bool kQRegs = HD <= 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kBlockM][P]
  float* skv = sq + kBlockM * P;                   // [2 stages][K, V][BN][P]
  float* smask = skv + 2 * 2 * BN * P;             // [2 stages][BN]
  __shared__ int warp_last[kMmaThreads / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  // the last query tiles see the most keys: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  const long long* s_ = st.s;
  const float* qb = q + b * s_[0] + h * s_[1];
  const float* kb = k + b * s_[3] + h * s_[4];
  const float* vb = v + b * s_[6] + h * s_[7];
  const float* mrow = mask != nullptr ? mask + (long long)b * Sk : nullptr;

  sf_mma::load_rows_f32<HD, kMmaThreads>(sq, qb, s_[2], q0, kBlockM, S, Dc);
  sf_mma::cp_async_commit();
  int ntiles = (Sk + BN - 1) / BN;
  if (causal) ntiles = min(ntiles, (min(q0 + kBlockM, S) - 1) / BN + 1);
  // A key tile whose keys are all padding adds exactly nothing to a row
  // that attends a live key: once m is a score, exp2(kMasked - m) is 0, and
  // what such a tile added before the first live key, the rescale by
  // alpha = exp2(kMasked - m) = 0 wipes out. So when every row of the block
  // attends a live key (one at or before q0 if causal, anywhere if not),
  // the walk skips those tiles and ends with the tile of the row's last
  // live key. Otherwise every tile is visited, and a row with no live key
  // averages its visited keys uniformly, as the TPU kernel does.
  bool skip = false;
  if (mrow != nullptr) {
    const int lim = causal ? min(q0 + 1, Sk) : Sk;
    int last = -1;
    bool attended = false;
    for (int j = tid; j < min(Sk, ntiles * BN); j += kMmaThreads)
      if (mrow[j] > 0.f) {
        last = j;
        attended |= j < lim;
      }
    skip = __syncthreads_or(attended);
    if (skip) {
      last = __reduce_max_sync(0xffffffffu, last);
      if (lane == 0) warp_last[warp] = last;
      __syncthreads();
      for (int w = 0; w < kMmaThreads / 32; ++w)
        last = max(last, warp_last[w]);
      ntiles = min(ntiles, last / BN + 1);
    }
  }

  auto load_tile = [&](int t) {
    const int k0 = t * BN;
    float* dst = skv + (t & 1) * 2 * BN * P;
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst, kb, s_[5], k0, BN, Sk, Dc);
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst + BN * P, vb, s_[8], k0, BN,
                                           Sk, Dc);
    if (mrow != nullptr && tid < BN) {
      const int kj = k0 + tid;
      sf_mma::cp_async4(smask + (t & 1) * BN + tid, mrow + (kj < Sk ? kj : 0),
                        kj < Sk ? 4 : 0);
    }
  };
  if (ntiles > 0) load_tile(0);
  sf_mma::cp_async_commit();

  // this lane's two rows of the warp's 16 (accumulator rows g and g + 8)
  const int g = lane >> 2, c2 = (lane & 3) * 2, rw = warp * 16;
  uint32_t qf[kQRegs ? HD / 8 : 1][4], qf_s[kQRegs ? HD / 8 : 1][4];
  if constexpr (kQRegs) {
    sf_mma::cp_async_wait<1>();  // Q landed for this thread
    __syncthreads();             // ... and for every thread
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk)
      sf_mma::load_a_split(qf[kk], qf_s[kk], sq, P, rw, kk * 8, lane);
  }
  const float sl2 = scale * kLog2e;

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[HD / 8][4] = {};
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    sf_mma::cp_async_commit();
    sf_mma::cp_async_wait<1>();  // tile t (and Q) landed for this thread
    const float* sk = skv + (t & 1) * 2 * BN * P;
    const float* sv = sk + BN * P;
    const float* sm = smask + (t & 1) * BN;
    // ... and for every thread; with a mask, the same barrier counts the
    // tile's keys that attend
    int live = BN;
    if (mrow != nullptr)
      live = __syncthreads_count(tid < BN && sm[tid] > 0.f);
    else
      __syncthreads();

    if (live > 0 || !skip) {
      // S = Q K^T for the warp's 16 rows x BN keys
      float s[BN / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t a[4], a_s[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = qf[kk][i];
            a_s[i] = qf_s[kk][i];
          }
        } else {
          sf_mma::load_a_split(a, a_s, sq, P, rw, kk * 8, lane);
        }
#pragma unroll
        for (int n = 0; n < BN / 8; ++n) {
          uint32_t kf[2], kf_s[2];
          sf_mma::load_bt_split(kf, kf_s, sk, P, n * 8, kk * 8, lane);
          sf_mma::mma_3xtf32(s[n], a, a_s, kf, kf_s);
        }
      }

      // scores in the exp2 domain, masked where the tile needs it; row max
      const int k0 = t * BN;
      const bool edge = live < BN || k0 + BN > Sk ||
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
                              (mrow != nullptr && !(sm[col] > 0.f));
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
      // P = exp2(x - m) in float32, not rounded: l sums it and O += P V
      // takes it split, as the A operand straight from its accumulators
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m[e >> 1]);
          l[e >> 1] += p;
          s[n][e] = p;
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t pa[4], pa_s[4];
        sf_mma::accum_to_a_split(pa, pa_s, s[j]);
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          uint32_t vf[2], vf_s[2];
          sf_mma::load_b_perm_split(vf, vf_s, sv, P, j * 8, n * 8, lane);
          sf_mma::mma_3xtf32(acc[n], pa, pa_s, vf, vf_s);
        }
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
    float* row = o + b * s_[9] + h * s_[10] + qi * s_[11];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      if (n * 8 + c2 < Dc)
        sf_mma::store2(row + n * 8 + c2, acc[n][2 * r] / den,
                       acc[n][2 * r + 1] / den);
    // a row with no live key: NEG_INF itself, as the TPU kernel's m is
    if (lse != nullptr && (lane & 3) == 0)
      lse[(long long)bh * S + qi] =
          (m[r] == kMasked ? kNegInf : m[r] * kLn2) + logf(den);
  }
}

template <int HD>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        const float* mask, void* o, float* lse, int B, int H,
                        int S, int Sk, int D, const Strides& st, float scale,
                        int causal, cudaStream_t stream) {
  auto kern = flash_fwd_tf32_kernel<HD>;
  const size_t smem = tf32_smem<HD>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + kBlockM - 1) / kBlockM);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mask, static_cast<float*>(o), lse, H, S,
      Sk, D, st, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_tf32(const void* q, const void* k, const void* v,
                          const float* mask, void* o, float* lse, int B,
                          int H, int S, int Sk, int D, const Strides& st,
                          float scale, int causal, cudaStream_t stream) {
  // the output is written two columns at a time: 8-byte aligned, even
  // (batch, head, seq) strides
  if (!cp_async_ready(q, k, v, st, 4) ||
      reinterpret_cast<uintptr_t>(o) % 8 != 0 || st.s[9] % 2 != 0 ||
      st.s[10] % 2 != 0 || st.s[11] % 2 != 0)
    return cudaErrorInvalidValue;
  if (D > 128) {
    SF_DISPATCH_WIDE(launch_tf32, D, q, k, v, mask, o, lse, B, H, S, Sk, D,
                     st, scale, causal, stream)
  }
  SF_DISPATCH_HD8(launch_tf32, D, q, k, v, mask, o, lse, B, H, S, Sk, D, st,
                  scale, causal, stream)
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o are [B, H, S|Sk, D] with D
// contiguous; strides[12] = (q, k, v, o) x (batch, head, seq) in elements.
// mask: [B, Sk] float32 (> 0 attends) or null; lse: [B, H, S] float32
// contiguous, or null. Any D >= 1: a multiple of 8 up to 256 runs on the
// tensor cores — float32 the 3xTF32 kernel, bfloat16 the bf16 one — and
// needs 16-byte aligned q/k/v pointers and their strides multiples of 8
// (bfloat16) or 4 (float32) elements (cp_async_ready), a float32 o 8-byte
// aligned with even strides; every other D runs the column-sliced kernel
// of flash_sliced.cu, which takes any alignment.
extern "C" int sf_flash_fwd(int dtype, const void* q, const void* k,
                            const void* v, const void* mask, void* o,
                            void* lse, int B, int H, int S, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sf_sliced::tensor_core_head_dim(D))
    return (int)sf_sliced::fwd(dtype, q, k, v, m, o, l, B, H, S, Sk, D,
                               strides, scale, causal, s);
  Strides st{};
  for (int i = 0; i < 12; ++i) st.s[i] = strides[i];
  cudaError_t e = dtype == 0
      ? dispatch_tf32(q, k, v, m, o, l, B, H, S, Sk, D, st, scale, causal, s)
      : dispatch_mma(q, k, v, m, o, l, B, H, S, Sk, D, st, scale, causal, s);
  return (int)e;
}

extern "C" const char* sf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
