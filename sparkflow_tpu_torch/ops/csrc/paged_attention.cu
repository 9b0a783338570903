// Single-query decode attention through a page table, for NVIDIA Hopper,
// sm_90a, over a plain or a quantized KV pool.
//
// Replaces two TPU kernels of sparkflow_tpu/ops/attention.py, both launched
// by paged_attention:
// - _paged_kernel: for each slot b and head h,
//   out[b, h] = softmax(scale * q[b, h] . K[t, h]) V[t, h] over the slot's
//   tokens t < lengths[b], where token t lives in pool page table[b, t / page]
//   at row t % page. A slot with lengths[b] == 0 returns exact zeros.
// - _paged_kernel_quant: the same over an int8 or fp8 (e4m3) pool with
//   [num_pages, H] float32 scales, K[t, h] = Kq[t, h] * ks[page(t), h] and
//   likewise V. The K scale folds into the score,
//   s = (q . Kq[t]) * (ks * scale), and the V scale into the PV update,
//   acc += (p * vs) * Vq[t]; the softmax sum takes p itself. No row is ever
//   dequantized in memory and no scale is divided by; a page-head of scale 0
//   (never written) holds exact zeros and reads back as zeros.
//
// Translation from the TPU kernels:
// - the TPU grid (B, max_pages) walked a slot's pages in order, with the page
//   table (and the scales) scalar-prefetched into the BlockSpec index maps and
//   m / l / acc carried in VMEM across the sequential page axis. Here one
//   thread block owns one (slot, head) and reads its own table row; the page
//   walk is a loop split over the block's warps, each warp keeping its own
//   online softmax state, merged through shared memory at the end;
// - the loop visits only t < lengths[b] (the ragged last page is masked by
//   the bound itself, pages past the length are never touched), so a masked
//   lane of the engine (table row of scratch page 0, length 1) and aliased
//   pages shared between slots are just reads of valid pool rows.
//
// What bounds it on the H100: bytes. Each K/V row is read once and used for
// 2*D flops, far below the ~295 flops/byte ridge, so the time is the KV rows
// of the live tokens over HBM bandwidth — half of it for an int8/fp8 pool
// (plus one float32 scale per page-head, 4 bytes against page*D = 1024 of
// rows at the serving shape). The design therefore spends nothing on tensor
// cores and everything on keeping loads in flight: a lane reads 8 elements
// of a row with one vector load (16 bytes in bf16, 8 in int8/fp8), D/8 lanes
// cover a row, a warp covers several rows at once, each lane issues kUnroll
// rows' K and V loads (and their scales) before it computes on any of them,
// and eight warps share a (slot, head). Splitting one slot's sequence over
// several blocks (split-K flash decoding), which a long context at small
// batch needs to fill all 132 SMs, is later work.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include "pool_load.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kVec = 8;       // elements of a row per lane
constexpr int kUnroll = 4;    // rows per lane in flight
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

// grid (H, B); block kWarps * 32 threads. G = lanes per row, a power of two
// >= D / 8; 32 / G rows per warp per step. T: query/output type; P: pool
// element type (T itself, or int8_t / __nv_fp8_e4m3 with kQuant).
template <typename T, typename P, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, long long qsb, long long qsh,
                       const P* __restrict__ kp, const P* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table, int maxp,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int D, int page, float scale, int G) {
  __shared__ float s_acc[kWarps][kMaxD];
  __shared__ float s_m[kWarps], s_l[kWarps];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & (G - 1), grp = lane / G, groups = 32 / G;
  const int d0 = sub * kVec;
  const bool active = d0 < D;
  const int len = max(0, min(lengths[b], maxp * page));

  float qv[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    qv[e] = active ? to_f(q[b * qsb + h * qsh + d0 + e]) : 0.f;

  float m = kNegInf, l = 0.f, acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  const long long row = (long long)H * D;  // between consecutive tokens
  const int* trow = table + (long long)b * maxp;
  const int step = kWarps * groups;        // rows per block per unrolled row
  // every lane of a warp runs the same trip count (the shuffles below need
  // the whole warp); lanes past the length just skip their update
  for (int t0 = warp * groups + grp; t0 - grp < len; t0 += step * kUnroll) {
    float kv[kUnroll][kVec], vv[kUnroll][kVec];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * step;
      ksc[u] = vsc[u] = 1.f;
      if (t < len) {
        const int pg = t / page;
        const int pid = trow[pg];
        if (kQuant) {
          // every lane of a row group, active or not, takes the row's scale:
          // the reduced score below must be the same on all of them
          ksc[u] = ks[(long long)pid * H + h];
          vsc[u] = vs[(long long)pid * H + h];
        }
        if (active) {
          const long long base =
              ((long long)pid * page + (t - pg * page)) * row +
              (long long)h * D + d0;
          load8(kp + base, kv[u]);
          load8(vp + base, vv[u]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) kv[u][e] = vv[u][e] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) part = fmaf(qv[e], kv[u][e], part);
      for (int o = G >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (t0 + u * step >= len) continue;
      const float s = kQuant ? part * (ksc[u] * scale) : part * scale;
      const float mn = fmaxf(m, s);
      const float alpha = expf(m - mn), p = expf(s - mn);
      l = l * alpha + p;
      const float pv = kQuant ? p * vsc[u] : p;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[e] = fmaf(pv, vv[u][e], acc[e] * alpha);
      m = mn;
    }
  }

  // merge the row groups of this warp (lanes with the same sub)
  for (int o = G; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, m2);
    const float a1 = expf(m - mn), a2 = expf(m2 - mn);
    l = l * a1 + l2 * a2;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x2 = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * a1 + x2 * a2;
    }
    m = mn;
  }
  if (grp == 0 && active) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) s_acc[warp][d0 + e] = acc[e];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // merge the warps; an empty slot (no row visited) divides 0 by 1e-30
  if (tid < D) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w] - mx);
      lsum = fmaf(s_l[w], f, lsum);
      a = fmaf(s_acc[w][tid], f, a);
    }
    store(out + ((long long)b * H + h) * D + tid, a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, typename P, bool kQuant>
cudaError_t launch(const void* q, long long qsb, long long qsh,
                   const void* kp, const void* vp, const void* ks,
                   const void* vs, const int* table, int maxp,
                   const int* lengths, void* out, int B, int H, int D,
                   int page, float scale, cudaStream_t stream) {
  int G = 1;
  while (G * kVec < D) G <<= 1;
  dim3 grid(H, B);
  paged_attention_kernel<T, P, kQuant><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), qsb, qsh, static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), table, maxp, lengths,
      static_cast<T*>(out), H, D, page, scale, G);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (query, output and pool). q: [B, H, D]
// with D contiguous and strides (qsb, qsh) in elements; k_pages / v_pages:
// one layer's contiguous [num_pages, page, H, D] pool; table: [B, maxp] int32
// pool page ids; lengths: [B] int32; out: contiguous [B, H, D]. Requires
// D % 8 == 0 and 8 <= D <= 128 and 16-byte aligned pools (the wrapper
// checks).
extern "C" int sf_paged_attention(int dtype, const void* q, long long qsb,
                                  long long qsh, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  int maxp, const void* lengths, void* out,
                                  int B, int H, int D, int page, float scale,
                                  void* stream) {
  if (D % 8 != 0 || D < 8 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(table);
  const int* n = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? launch<float, float, false>(q, qsb, qsh, k_pages, v_pages, nullptr, nullptr, t, maxp, n, out, B, H, D, page, scale, s)
      : launch<__nv_bfloat16, __nv_bfloat16, false>(q, qsb, qsh, k_pages, v_pages, nullptr, nullptr, t, maxp, n, out, B, H, D, page, scale, s);
  return (int)e;
}

// The quantized pool: dtype as above for q and out; pool: 0 = int8,
// 1 = fp8 e4m3 (k_pages / v_pages); k_scales / v_scales: one layer's
// contiguous [num_pages, H] float32 scales. Other operands as
// sf_paged_attention.
extern "C" int sf_paged_attention_quant(
    int dtype, int pool, const void* q, long long qsb, long long qsh,
    const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* table, int maxp, const void* lengths,
    void* out, int B, int H, int D, int page, float scale, void* stream) {
  if (D % 8 != 0 || D < 8 || D > kMaxD || (pool != 0 && pool != 1) ||
      k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(table);
  const int* n = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = pool == 0
        ? launch<float, int8_t, true>(q, qsb, qsh, k_pages, v_pages, k_scales, v_scales, t, maxp, n, out, B, H, D, page, scale, s)
        : launch<float, __nv_fp8_e4m3, true>(q, qsb, qsh, k_pages, v_pages, k_scales, v_scales, t, maxp, n, out, B, H, D, page, scale, s);
  else
    e = pool == 0
        ? launch<__nv_bfloat16, int8_t, true>(q, qsb, qsh, k_pages, v_pages, k_scales, v_scales, t, maxp, n, out, B, H, D, page, scale, s)
        : launch<__nv_bfloat16, __nv_fp8_e4m3, true>(q, qsb, qsh, k_pages, v_pages, k_scales, v_scales, t, maxp, n, out, B, H, D, page, scale, s);
  return (int)e;
}
