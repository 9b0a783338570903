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
// - the ragged edges of S and Sk are masked here: no % 128 tile rule;
// - the TPU kernels take any head_dim a multiple of 8: here this file's
//   instantiations go up to 128 and flash_bwd_wide.cu's from 136 to 256,
//   where dK and dV are two kernels (the templates are in flash_bwd.cuh).
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
//      8    181 / 19,456 / 2     137 / 19,456 / 3     (64)
//     16    195 / 31,744 / 2     168 / 31,744 / 3     (64)
//     24    203 / 44,032 / 2     185 / 44,032 / 2     (64)
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_bwd.cuh"
#include "flash_sliced.cuh"

namespace {

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
  if (D > 128)
    return sf_bwd::wide_dq_mma(q, k, v, dout, lse, delta, mask, dq, B, H, S,
                               Sk, D, strides, scale, causal, stream);
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
  if (D > 128)
    return sf_bwd::wide_dkv_mma(q, k, v, dout, lse, delta, mask, dk, dv, B, H,
                                S, Sk, D, strides, scale, causal, stream);
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
  if (D > 128)
    return sf_bwd::wide_dq_tf32(q, k, v, dout, lse, delta, mask, dq, B, H, S,
                                Sk, D, strides, scale, causal, stream);
  SF_DISPATCH_HD8(launch_dq_tf32, D, q, k, v, dout, lse, delta, mask, dq, B,
                  H, S, Sk, D, strides, scale, causal, stream)
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
  if (D > 128)
    return sf_bwd::wide_dkv_tf32(q, k, v, dout, lse, delta, mask, dk, dv, B,
                                 H, S, Sk, D, strides, scale, causal, stream);
  SF_DISPATCH_HD8(launch_dkv_tf32, D, q, k, v, dout, lse, delta, mask, dk,
                  dv, B, H, S, Sk, D, strides, scale, causal, stream)
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq are [B, H, S, D] and k/v
// [B, H, Sk, D] with D contiguous; strides[15] = (q, k, v, dout, dq) x
// (batch, head, seq) in elements. lse, delta: [B, H, S] float32 contiguous;
// mask: [B, Sk] float32 (> 0 attends) or null. Any D >= 1: a multiple of 8
// up to 256 runs on the tensor cores (above 128 the kernels of
// flash_bwd_wide.cu) — float32 the 3xTF32 kernel, bfloat16 the bf16 one —
// and needs 16-byte aligned q/k/v/dout pointers and their strides
// multiples of 8 (bfloat16) or 4 (float32) elements (cp_async_ready), a
// float32 dq 8-byte aligned with even strides; every other D runs the
// column-sliced kernels of flash_sliced.cu, which take any alignment.
extern "C" int sf_flash_bwd_dq(int dtype, const void* q, const void* k,
                               const void* v, const void* dout,
                               const void* lse, const void* delta,
                               const void* mask, void* dq, int B, int H, int S,
                               int Sk, int D, const long long* strides,
                               float scale, int causal, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sf_sliced::tensor_core_head_dim(D))
    return (int)sf_sliced::dq(dtype, q, k, v, dout, l, dl, m, dq, B, H, S, Sk,
                              D, strides, scale, causal, s);
  cudaError_t e = dtype == 0
      ? dispatch_dq_tf32(q, k, v, dout, l, dl, m, dq, B, H, S, Sk, D, strides, scale, causal, s)
      : dispatch_dq_mma(q, k, v, dout, l, dl, m, dq, B, H, S, Sk, D, strides, scale, causal, s);
  return (int)e;
}

// As sf_flash_bwd_dq; dk/dv are [B, H, Sk, D]; strides[18] = (q, k, v,
// dout, dk, dv) x (batch, head, seq). Above D = 128 this launches two
// kernels, dV's and dK's.
extern "C" int sf_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta,
                                const void* mask, void* dk, void* dv, int B,
                                int H, int S, int Sk, int D,
                                const long long* strides, float scale,
                                int causal, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sf_sliced::tensor_core_head_dim(D))
    return (int)sf_sliced::dkv(dtype, q, k, v, dout, l, dl, m, dk, dv, B, H,
                               S, Sk, D, strides, scale, causal, s);
  cudaError_t e = dtype == 0
      ? dispatch_dkv_tf32(q, k, v, dout, l, dl, m, dk, dv, B, H, S, Sk, D, strides, scale, causal, s)
      : dispatch_dkv_mma(q, k, v, dout, l, dl, m, dk, dv, B, H, S, Sk, D, strides, scale, causal, s);
  return (int)e;
}
