// Flash attention backward for NVIDIA Hopper, sm_90a: dQ and dK/dV.
//
// Replaces the TPU kernels sparkflow_tpu/ops/attention.py:_flash_bwd_dq_kernel
// and :_flash_bwd_dkv_kernel (both launched by _flash_pallas_backward_flat,
// P from _bwd_p_block), in both of the port's dtypes: bfloat16 (the
// training path's compute dtype) and float32 (the Spark ML estimator, which
// gives its Trainer no compute dtype, and the exactness checks).
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
// What bounds it on the H100: the dq kernel does 3 and the dkv kernel 4
// products of 2*D flops per attending (query, key) pair over ~8*S*D bytes
// per head of operands — well above the ridge in either dtype (at the
// training shape, B=8, H=12, S=1024, D=64, causal; and at the estimator's,
// B=32, S=512, D=64, padded keys), so the kernels are bound by the tensor
// cores' throughput: 989 TFLOP/s in bf16; in float32 three TF32 products per
// product (below), 495 / 3 = 165 TFLOP/s, above the CUDA cores' 67.
// mma.sync, issued by each warp on its own, does not reach those peaks;
// Hopper's wgmma (a warpgroup's asynchronous product fed by TMA) is the way
// there, and later work.
//
// bfloat16 operands run on the tensor cores:
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
//
// float32 operands run on the tensor cores too, in 3xTF32 (mma_tf32.cuh):
// every product is three mma.sync m16n8k8 TF32 products of a big/small
// split of its operands (big = tf32(x), small = tf32(x - big)), summed in
// float32, small terms first — a float32 product to ~2^-21, where one TF32
// product keeps 2^-11 and would miss the exactness checks' 1e-4 of the
// largest gradient. It is the arithmetic of PyTorch's own float32 attention
// (CUTLASS OpMultiplyAddFastF32). The kernels follow the bf16 ones:
// - a block owns 64 rows (4 warps x 16) of its side and streams the visited
//   side's tiles through the same two-stage ring of 16-byte cp.async copies;
//   visited tiles are 64 rows, 32 above HD = 64 (registers in dkv, shared
//   memory in both). Rows are float32 with a pitch of HD + 4 floats, so the
//   fragment loads (rows g with columns c, or rows 2c and 2c+1 with columns
//   g) hit 32 distinct banks;
// - an operand is split as each fragment is loaded from shared memory, not
//   once as it lands: stored split, every tile would take twice the shared
//   memory and at HD = 64 a second block would no longer fit on an SM. The
//   split costs three ALU instructions per fragment element, issued between
//   the mma's;
// - P (dkv) and dS go from their accumulators straight into the A operand
//   of the next product, in registers, with no shuffle and no shared
//   buffer: the next product's k-slots take the accumulator's columns in the
//   order its registers hold them (column 2c in slot c, 2c+1 in slot c+4),
//   and its B fragment reads tile rows 2c and 2c+1 to match;
// - masked work is skipped and the function stays the same: the dq kernel
//   ends its walk after the row's last unpadded key and skips a key tile
//   whose keys are all padding (a __syncthreads_count over the tile's mask,
//   which is also the barrier the tile needs); a dkv block whose own keys
//   are all padding writes zeros and returns. The mask, causal test and
//   ragged edge are evaluated only on the tiles that need them: the
//   diagonal tile, the last ragged one, a tile partly padding;
// - the kernels are specialised on head_dim itself (HD = 8..128 in steps of
//   8): m16n8k8's k-step of 8 covers every head_dim the entry takes, with
//   no padding;
// - the head_dim loop of the first two products is unrolled by two, not
//   fully, and the kernels ask for two blocks an SM (what shared memory
//   allows at HD = 64). Fully unrolled, ptxas held the dq kernel to 168
//   registers and spilled at HD = 64, and both kernels ran slower at the
//   estimator's and the training shape; 32-row dq tiles (three blocks an
//   SM) and a rolled loop were no faster over both shapes.
//   ptxas -v on an H100 (sm_90a; chip_smoke.py prints it at set-up),
//   registers / dynamic shared memory per block / blocks per SM that both
//   allow, no instantiation spills:
//     HD    dq                   dkv                  (visited tile)
//      8    178 / 19,456 / 2     137 / 19,456 / 3     (64)
//     16    192 / 31,744 / 2     168 / 31,744 / 3     (64)
//     24    204 / 44,032 / 2     185 / 44,032 / 2     (64)
//     32    198 / 56,320 / 2     194 / 56,320 / 2     (64)
//     40    194 / 68,608 / 2     205 / 68,608 / 2     (64)
//     48    192 / 80,896 / 2     209 / 80,896 / 2     (64)
//     56    195 / 93,184 / 2     219 / 93,184 / 2     (64)
//     64    195 / 105,472 / 2    220 / 105,472 / 2    (64)
//     72    152 / 78,336 / 2     188 / 78,336 / 2     (32)
//     80    150 / 86,528 / 2     192 / 86,528 / 2     (32)
//     88    160 / 94,720 / 2     201 / 94,720 / 2     (32)
//     96    162 / 102,912 / 2    200 / 102,912 / 2    (32)
//    104    167 / 111,104 / 2    219 / 111,104 / 2    (32)
//    112    165 / 119,296 / 1    235 / 119,296 / 1    (32)
//    120    182 / 127,488 / 1    233 / 127,488 / 1    (32)
//    128    180 / 135,680 / 1    243 / 135,680 / 1    (32)
//
// cp.async needs 16-byte aligned rows: the wrapper checks each operand's
// pointer and strides (multiples of 8 bf16 or 4 float32 elements) and makes
// a copy where they are not, and the entry points refuse
// (cudaErrorInvalidValue) what is not aligned.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

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

// ---------------------------------------------------------------------------
// float32: 3xTF32 tensor-core kernels
// ---------------------------------------------------------------------------

// own rows (two operands), two stages of two visited operands, and two
// stages of two per-row floats (the dq kernel's key mask uses half)
template <int HD>
size_t tf32_smem() {
  constexpr int BC = sf_mma::tf32_tile<HD>();
  return sizeof(float) * ((HD + 4) * (2 * kOwn + 2 * 2 * BC) + 2 * 2 * BC);
}

// dQ: one block per (batch*head, 64-query tile); loops over key tiles.
// Strides: q, k, v, dout, dq.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ mask,
                         float* __restrict__ dq, int H, int S, int Sk,
                         Strides st, float scale, int causal) {
  constexpr int P = HD + 4, BC = sf_mma::tf32_tile<HD>();
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

  sf_mma::load_rows_f32<HD, kMmaThreads>(sq, qb, s_[2], q0, kOwn, S);
  sf_mma::load_rows_f32<HD, kMmaThreads>(sdo, dob, s_[11], q0, kOwn, S);
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
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst, kb, s_[5], k0, BC, Sk);
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst + BC * P, vb, s_[8], k0, BC,
                                           Sk);
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
      sf_mma::store2(row + n * 8 + c2, scale * acc[n][2 * r],
                     scale * acc[n][2 * r + 1]);
  }
}

// dK, dV: one block per (batch*head, 64-key tile); loops over query tiles.
// Strides: q, k, v, dout, dk, dv.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ mask,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int H, int S, int Sk, Strides st, float scale,
                          int causal) {
  constexpr int P = HD + 4, BC = sf_mma::tf32_tile<HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // [kOwn][P]
  float* sv = sk + kOwn * P;                       // [kOwn][P]
  float* sqg = sv + kOwn * P;                      // [2 stages][Q, dO][BC][P]
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

  // the block's own keys that attend: none, and dK = dV = 0; all, and no
  // key mask below
  bool own_all = true;
  if (mask != nullptr) {
    const int kj = k0 + tid;
    const bool live = tid < kOwn && kj < Sk &&
                      mask[(long long)b * Sk + kj] > 0.f;
    if (!__syncthreads_or(live)) {
      const int nrows = min(kOwn, Sk - k0);
      float* dkb = dk + b * s_[12] + h * s_[13];
      float* dvb = dv + b * s_[15] + h * s_[16];
      for (int i = tid; i < nrows * (HD / 2); i += kMmaThreads) {
        const int r = i / (HD / 2), d = (i - r * (HD / 2)) * 2;
        sf_mma::store2(dkb + (k0 + r) * s_[14] + d, 0.f, 0.f);
        sf_mma::store2(dvb + (k0 + r) * s_[17] + d, 0.f, 0.f);
      }
      return;
    }
    own_all = __syncthreads_and(tid >= kOwn || live);
  }

  sf_mma::load_rows_f32<HD, kMmaThreads>(sk, kb, s_[5], k0, kOwn, Sk);
  sf_mma::load_rows_f32<HD, kMmaThreads>(sv, vb, s_[8], k0, kOwn, Sk);
  const int ntiles = (S + BC - 1) / BC;
  // causal: query tiles wholly above this key tile's diagonal see P = 0
  const int t0 = causal ? min(k0 / BC, ntiles) : 0;

  auto load_tile = [&](int t) {
    const int q0 = t * BC, stage = (t - t0) & 1;
    float* dst = sqg + stage * 2 * BC * P;
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst, qb, s_[2], q0, BC, S);
    sf_mma::load_rows_f32<HD, kMmaThreads>(dst + BC * P, dob, s_[11], q0, BC,
                                           S);
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
    const float* sq = sqg + stage * 2 * BC * P;
    const float* sdo = sq + BC * P;
    const float* slse = sstat + stage * 2 * BC;
    const float* sdl = slse + BC;

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x BC queries
    float s[BC / 8][4] = {}, dp[BC / 8][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < HD / 8; ++kk) {
      uint32_t ka[4], ka_s[4], va[4], va_s[4];
      sf_mma::load_a_split(ka, ka_s, sk, P, rw, kk * 8, lane);
      sf_mma::load_a_split(va, va_s, sv, P, rw, kk * 8, lane);
#pragma unroll
      for (int n = 0; n < BC / 8; ++n) {
        uint32_t qf[2], qf_s[2], gf[2], gf_s[2];
        sf_mma::load_bt_split(qf, qf_s, sq, P, n * 8, kk * 8, lane);
        sf_mma::load_bt_split(gf, gf_s, sdo, P, n * 8, kk * 8, lane);
        sf_mma::mma_3xtf32(s[n], ka, ka_s, qf, qf_s);
        sf_mma::mma_3xtf32(dp[n], va, va_s, gf, gf_s);
      }
    }

    // P^T and dS^T = P^T (dP^T - D), 0 where masked
    const int q0 = t * BC;
    const bool edge = !own_all || q0 + BC > S ||
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

    // dV += P^T dO;  dK += dS^T Q, P^T and dS^T straight from their
    // accumulators
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
      uint32_t pa[4], pa_s[4], da[4], da_s[4];
      sf_mma::accum_to_a_split(pa, pa_s, s[j]);
      sf_mma::accum_to_a_split(da, da_s, dp[j]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        uint32_t bf[2], bf_s[2];
        sf_mma::load_b_perm_split(bf, bf_s, sdo, P, j * 8, n * 8, lane);
        sf_mma::mma_3xtf32(accv[n], pa, pa_s, bf, bf_s);
        sf_mma::load_b_perm_split(bf, bf_s, sq, P, j * 8, n * 8, lane);
        sf_mma::mma_3xtf32(acck[n], da, da_s, bf, bf_s);
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
      sf_mma::store2(krow + n * 8 + c2, scale * acck[n][2 * r],
                     scale * acck[n][2 * r + 1]);
      sf_mma::store2(vrow + n * 8 + c2, accv[n][2 * r],
                     accv[n][2 * r + 1]);
    }
  }
}

template <int HD>
cudaError_t launch_dq_tf32(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const float* mask, void* dq,
                           int B, int H, int S, int Sk,
                           const long long* strides, float scale, int causal,
                           cudaStream_t stream) {
  auto kern = flash_bwd_dq_tf32_kernel<HD>;
  const size_t smem = tf32_smem<HD>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (S + kOwn - 1) / kOwn);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, mask, static_cast<float*>(dq), H, S, Sk,
      copy_strides(strides, 15), scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_tf32(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* mask, void* dk,
                            void* dv, int B, int H, int S, int Sk,
                            const long long* strides, float scale, int causal,
                            cudaStream_t stream) {
  auto kern = flash_bwd_dkv_tf32_kernel<HD>;
  const size_t smem = tf32_smem<HD>();
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sk + kOwn - 1) / kOwn);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, mask, static_cast<float*>(dk), static_cast<float*>(dv), H, S, Sk,
      copy_strides(strides, 18), scale, causal);
  return cudaGetLastError();
}

// cp.async reads 16-byte chunks: the four operands' pointers must be
// 16-byte aligned and their (batch, head, seq) strides multiples of `vec`
// elements (8 bf16, 4 float32)
bool cp_async_ready(const void* q, const void* k, const void* v,
                    const void* dout, const long long* strides, int vec) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % vec != 0) return false;
  return true;
}

// the float32 kernels write two columns at a time: an 8-byte aligned
// output with even (batch, head, seq) strides
bool pairs_ready(const void* out, const long long* strides) {
  return reinterpret_cast<uintptr_t>(out) % 8 == 0 && strides[0] % 2 == 0 &&
         strides[1] % 2 == 0 && strides[2] % 2 == 0;
}

cudaError_t dispatch_dq_mma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const float* mask, void* dq,
                            int B, int H, int S, int Sk, int D,
                            const long long* strides, float scale, int causal,
                            cudaStream_t stream) {
  if (!cp_async_ready(q, k, v, dout, strides, 8)) return cudaErrorInvalidValue;
  SF_DISPATCH_HD(launch_dq_mma, D, q, k, v, dout, lse, delta, mask, dq, B, H,
                 S, Sk, D, strides, scale, causal, stream)
}

cudaError_t dispatch_dkv_mma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* mask, void* dk,
                             void* dv, int B, int H, int S, int Sk, int D,
                             const long long* strides, float scale,
                             int causal, cudaStream_t stream) {
  if (!cp_async_ready(q, k, v, dout, strides, 8)) return cudaErrorInvalidValue;
  SF_DISPATCH_HD(launch_dkv_mma, D, q, k, v, dout, lse, delta, mask, dk, dv,
                 B, H, S, Sk, D, strides, scale, causal, stream)
}

cudaError_t dispatch_dq_tf32(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const float* mask, void* dq,
                             int B, int H, int S, int Sk, int D,
                             const long long* strides, float scale,
                             int causal, cudaStream_t stream) {
  if (!cp_async_ready(q, k, v, dout, strides, 4) ||
      !pairs_ready(dq, strides + 12))
    return cudaErrorInvalidValue;
  SF_DISPATCH_HD8(launch_dq_tf32, D, q, k, v, dout, lse, delta, mask, dq, B,
                  H, S, Sk, strides, scale, causal, stream)
}

cudaError_t dispatch_dkv_tf32(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const float* mask,
                              void* dk, void* dv, int B, int H, int S, int Sk,
                              int D, const long long* strides, float scale,
                              int causal, cudaStream_t stream) {
  if (!cp_async_ready(q, k, v, dout, strides, 4) ||
      !pairs_ready(dk, strides + 12) || !pairs_ready(dv, strides + 15))
    return cudaErrorInvalidValue;
  SF_DISPATCH_HD8(launch_dkv_tf32, D, q, k, v, dout, lse, delta, mask, dk,
                  dv, B, H, S, Sk, strides, scale, causal, stream)
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq are [B, H, S, D] and k/v
// [B, H, Sk, D] with D contiguous; strides[15] = (q, k, v, dout, dq) x
// (batch, head, seq) in elements. lse, delta: [B, H, S] float32 contiguous;
// mask: [B, Sk] float32 (> 0 attends) or null. Requires D % 8 == 0 and
// 8 <= D <= 128 (the wrapper checks), 16-byte aligned q/k/v/dout pointers
// and their strides multiples of 8 (bfloat16) or 4 (float32) elements
// (cp_async_ready); a float32 dq 8-byte aligned with even strides.
// float32 runs the 3xTF32 kernel, bfloat16 the bf16 one.
extern "C" int sf_flash_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* lse, const void* delta,
                               const void* mask, void* dq, int B, int H, int S,
                               int Sk, int D, const long long* strides,
                               float scale, int causal, void* stream) {
  if (D % 8 != 0 || D < 8 || D > 128) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_dq_tf32(q, k, v, dout, l, dl, m, dq, B, H, S, Sk, D, strides, scale, causal, s)
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
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_dkv_tf32(q, k, v, dout, l, dl, m, dk, dv, B, H, S, Sk, D, strides, scale, causal, s)
      : dispatch_dkv_mma(q, k, v, dout, l, dl, m, dk, dv, B, H, S, Sk, D, strides, scale, causal, s);
  return (int)e;
}
