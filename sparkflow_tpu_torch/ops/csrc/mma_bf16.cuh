// Warp-level bf16 tensor-core building blocks for sm_80+ (used on sm_90a):
// cp.async copies into shared memory, ldmatrix fragment loads and the
// m16n8k16 bf16 mma with float32 accumulation, as inline PTX.
//
// Fragment layouts of mma.sync.m16n8k16.row.col (g = lane / 4, c = lane % 4):
// - A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//   a[0] = A[g][2c..2c+1],     a[1] = A[g+8][2c..2c+1],
//   a[2] = A[g][8+2c..8+2c+1], a[3] = A[g+8][8+2c..8+2c+1];
// - B (16 x 8, "col": B[k][n]), two registers:
//   b[0] = B[2c..2c+1][g], b[1] = B[8+2c..8+2c+1][g];
// - C/D (16 x 8, float32), four registers:
//   d[0..1] = C[g][2c..2c+1], d[2..3] = C[g+8][2c..2c+1].
// So the accumulators of two neighbouring n8 tiles of a product are, once
// rounded to bf16 and packed in pairs, the A fragment of one k16 step of the
// next product (accum_to_a): P and dS stay in registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sf_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes 16 zero bytes
// (and reads nothing). Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 8 bytes global -> shared; src_bytes 0 writes zeros. Both addresses 8-byte
// aligned.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += A * B: m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of n8 tiles 2j and 2j+1 of a 16 x N product as the A
// fragment of k16 step j of a product that contracts over those N columns.
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4],
                                           const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Shared-memory element offsets, within a row-major tile of pitch `pitch`
// (b16 elements), that lane `lane` hands to ldmatrix_x4 for:
// - the A fragment of the 16 x 16 block at (row0, col0);
__device__ __forceinline__ int a_offset(int lane, int pitch, int row0,
                                        int col0) {
  return (row0 + (lane & 15)) * pitch + col0 + (lane >> 4) * 8;
}
// - the B fragments of n8 tiles n0 and n0+8 at k16 step k0, where the tile
//   holds B^T (rows are n, columns are k): regs {0,1} -> tile n0, {2,3} ->
//   tile n0 + 8 (ldmatrix_x4, no transpose);
__device__ __forceinline__ int bt_offset(int lane, int pitch, int n0, int k0) {
  return (n0 + (lane & 7) + (lane >> 4) * 8) * pitch + k0 +
         ((lane >> 3) & 1) * 8;
}
// - the same B fragments where the tile holds B itself (rows are k,
//   columns are n): ldmatrix_x4_trans.
__device__ __forceinline__ int b_offset(int lane, int pitch, int k0, int n0) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * pitch + n0 +
         (lane >> 4) * 8;
}

// Start cp.async copies, by a block of kThreads threads, of rows
// [r0, r0 + nrows) of one head of a bf16 [B, H, S, D] operand (sequence
// stride ss, D columns) into an [nrows][HD + 8] tile (rows padded by 16
// bytes, so ldmatrix's eight row reads land on distinct bank groups). Rows
// past n and columns past D are zero-filled.
template <int HD, int kThreads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int nrows,
                                          int n, int D) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i - r * kChunks, row = r0 + r;
    const bool ok = row < n && c * 8 < D;
    cp_async16(dst + r * (HD + 8) + c * 8, ok ? src + row * ss + c * 8 : src,
               ok ? 16 : 0);
  }
}

}  // namespace sf_mma
