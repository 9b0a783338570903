// Warp-level 3xTF32 tensor-core building blocks for sm_80+ (used on sm_90a):
// float32 products on the tensor cores at float32 accuracy, as inline PTX.
//
// 3xTF32: a float32 x is split into big = tf32(x) and small = tf32(x - big)
// (cvt.rna: nearest, ties away from zero, 10 mantissa bits kept). x - big
// is exact in float32, so big + small carries ~21 bits of x's 24 where big
// alone carries 11. A product a*b is then taken as three TF32 products
// summed in float32, the small terms first,
//   small_a * big_b + big_a * small_b + big_a * big_b,
// and small_a * small_b (below 2^-22 of |a*b|) is dropped. That is CUTLASS's
// OpMultiplyAddFastF32, the arithmetic of PyTorch's own float32 attention.
//
// Fragment layouts of mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32
// (g = lane / 4, c = lane % 4), one 32-bit register per element:
// - A (16 x 8, row-major): a[0] = A[g][c], a[1] = A[g+8][c],
//   a[2] = A[g][c+4], a[3] = A[g+8][c+4];
// - B (8 x 8, "col": B[k][n]): b[0] = B[c][g], b[1] = B[c+4][g];
// - C/D (16 x 8, float32): d[0..1] = C[g][2c..2c+1], d[2..3] = C[g+8][2c..2c+1].
//
// From an accumulator to an A operand. C holds columns 2c and 2c+1 of a row
// and A wants columns c and c+4, so the bf16 kernels' accum_to_a does not
// carry over. No data moves instead: the order in which an mma sums over
// its 8 k-slots is free, as long as A and B agree on it. The product that
// contracts over an accumulator's columns puts column 2c in k-slot c and
// column 2c+1 in k-slot c+4 — on the A side that is exactly the
// accumulator's registers (accum_to_a_split), on the B side it is rows 2c
// and 2c+1 of the B tile (load_b_perm_split). No shuffle, no shared buffer.
//
// Shared-memory tiles are float32 rows of pitch P = HD + 4 (P = 4 mod 8):
// the fragment loads below then hit 32 distinct banks — rows g (stride P)
// with columns c: 4g + c mod 32 spread; rows 2c / 2c+1 (stride 2P = 8 mod
// 16) with columns g: 8c + g spread.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"

namespace sf_mma {

// x rounded to TF32 (cvt.rna): its float32 bits with the low 13 zeroed
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += A * B: m16n8k8, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A * B in 3xTF32, small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// The A fragment, split, of the 16 x 8 block at (row0, col0) of a
// row-major float tile of pitch P.
__device__ __forceinline__ void load_a_split(uint32_t (&big)[4],
                                             uint32_t (&small)[4],
                                             const float* tile, int P,
                                             int row0, int col0, int lane) {
  const float* p = tile + (row0 + (lane >> 2)) * P + col0 + (lane & 3);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[8 * P], big[1], small[1]);
  split_tf32(p[4], big[2], small[2]);
  split_tf32(p[8 * P + 4], big[3], small[3]);
}

// The B fragment, split, of n8 tile n0 at k8 step k0, where the tile holds
// B^T (rows are n, columns are k).
__device__ __forceinline__ void load_bt_split(uint32_t (&big)[2],
                                              uint32_t (&small)[2],
                                              const float* tile, int P,
                                              int n0, int k0, int lane) {
  const float* p = tile + (n0 + (lane >> 2)) * P + k0 + (lane & 3);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[4], big[1], small[1]);
}

// The B fragment, split, of n8 tile n0 at k8 step k0, where the tile holds
// B itself (rows are k, columns are n), with tile row k0 + 2c in k-slot c
// and row k0 + 2c + 1 in k-slot c + 4 — the order accum_to_a_split gives.
__device__ __forceinline__ void load_b_perm_split(uint32_t (&big)[2],
                                                  uint32_t (&small)[2],
                                                  const float* tile, int P,
                                                  int k0, int n0, int lane) {
  const float* p = tile + (k0 + 2 * (lane & 3)) * P + n0 + (lane >> 2);
  split_tf32(p[0], big[0], small[0]);
  split_tf32(p[P], big[1], small[1]);
}

// The accumulator of one n8 tile of a 16 x N product as the A fragment,
// split, of the k8 step over those 8 columns (column 2c -> k-slot c,
// 2c + 1 -> c + 4).
__device__ __forceinline__ void accum_to_a_split(uint32_t (&big)[4],
                                                 uint32_t (&small)[4],
                                                 const float (&acc)[4]) {
  split_tf32(acc[0], big[0], small[0]);
  split_tf32(acc[2], big[1], small[1]);
  split_tf32(acc[1], big[2], small[2]);
  split_tf32(acc[3], big[3], small[3]);
}

// Tile rows the float32 kernels visit per step: 64, or 32 above HD = 64,
// where shared memory (and in dkv the two HD-wide accumulators) would
// leave one block an SM; the forward's instantiations above HD = 128 keep
// 32 and one block an SM (the backward's there: flash_bwd.cuh
// tf32_bwd_tile).
template <int HD>
__host__ __device__ constexpr int tf32_tile() { return HD <= 64 ? 64 : 32; }

// Two float32 columns of an output row (8-byte aligned).
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Start cp.async copies, by a block of kThreads threads, of rows
// [r0, r0 + nrows) of one head of a float32 [B, H, S, D] operand
// (sequence stride ss, D a multiple of 4, HD by default) into an
// [nrows][HD + 4] tile. Rows past n and columns past D are zero-filled.
template <int HD, int kThreads>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ss, int r0,
                                              int nrows, int n, int D = HD) {
  constexpr int kChunks = HD / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks, row = r0 + r;
    const bool ok = row < n && c * 4 < D;
    cp_async16(dst + r * (HD + 4) + c * 4, ok ? src + row * ss + c * 4 : src,
               ok ? 16 : 0);
  }
}

}  // namespace sf_mma

// Dispatch on head_dim itself, a multiple of 8 in [8, 128]: the float32
// kernels' m16n8k8 k-step covers each with no padding.
#define SF_DISPATCH_HD8(fn, d, ...)               \
  switch (d) {                                    \
    case 8: return fn<8>(__VA_ARGS__);            \
    case 16: return fn<16>(__VA_ARGS__);          \
    case 24: return fn<24>(__VA_ARGS__);          \
    case 32: return fn<32>(__VA_ARGS__);          \
    case 40: return fn<40>(__VA_ARGS__);          \
    case 48: return fn<48>(__VA_ARGS__);          \
    case 56: return fn<56>(__VA_ARGS__);          \
    case 64: return fn<64>(__VA_ARGS__);          \
    case 72: return fn<72>(__VA_ARGS__);          \
    case 80: return fn<80>(__VA_ARGS__);          \
    case 88: return fn<88>(__VA_ARGS__);          \
    case 96: return fn<96>(__VA_ARGS__);          \
    case 104: return fn<104>(__VA_ARGS__);        \
    case 112: return fn<112>(__VA_ARGS__);        \
    case 120: return fn<120>(__VA_ARGS__);        \
    case 128: return fn<128>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;        \
  }

// Dispatch on head_dim in (128, 256] rounded up to 32 (160, 192, 224, 256):
// the instantiations above 128 of the forward and backward kernels, bf16 and
// float32, whose columns past head_dim are zero-filled on load and not
// stored.
#define SF_DISPATCH_WIDE(fn, d, ...)              \
  switch ((d + 31) / 32 * 32) {                   \
    case 160: return fn<160>(__VA_ARGS__);        \
    case 192: return fn<192>(__VA_ARGS__);        \
    case 224: return fn<224>(__VA_ARGS__);        \
    case 256: return fn<256>(__VA_ARGS__);        \
    default: return cudaErrorInvalidValue;        \
  }
