// Multi-query (speculative verify) attention through a page table, for
// NVIDIA Hopper, sm_90a, over a plain or a quantized KV pool.
//
// Replaces two TPU kernels of sparkflow_tpu/ops/attention.py, both launched
// by paged_attention_verify:
// - _paged_verify_kernel: slot b holds S = spec_k + 1 consecutive queries;
//   query s sits at absolute position start[b] + s and attends causally,
//   out[b, h, s] = softmax_t(scale * q[b, h, s] . K[t, h]) V[t, h] over
//   t <= start[b] + s, token t in pool page table[b, t / page] at row
//   t % page. Every query attends at least itself, so no row is empty.
// - _paged_verify_kernel_quant: the same over an int8 or fp8 (e4m3) pool
//   with [num_pages, H] float32 scales, folded in as paged_attention.cu does:
//   the K scale into the score, the V scale into the PV update, never
//   divided by.
//
// Translation from the TPU kernels: the TPU grid (B, max_pages) carried S
// rows of online-softmax state per head in VMEM across the sequential page
// axis, skipping pages at or past start + S. Here one thread block owns one
// (slot, head) and walks the tokens t < start[b] + S in tiles of kTile rows:
// - the block stages a tile's K and V rows in shared memory, widened to
//   float32, with each row's page scales; every K/V row of the slot is read
//   from device memory ONCE and then used for all S queries, which is the
//   point of one verify call over S single-query calls;
// - warp w owns queries w, w + kWarps, ... and keeps their running max,
//   sum and output accumulators in registers (kMaxS / kWarps queries of
//   D / 32 values per lane): lane r scores tile row r, the warp reduces max
//   and sum with shuffles, and each lane accumulates its own D / 32 output
//   elements over the tile's rows;
// - the per-query causal mask t <= start[b] + s is applied per score; a
//   tile with no visible row for a query leaves its state untouched.
//
// What bounds it on the H100: bytes, like the single-query kernel: each K/V
// row is read once and used for 4*S*D flops (S = 5 at the serving shape),
// still far below the ~295 flops/byte ridge. The tile is loaded with one
// 8-element vector load per thread and per operand, then used from shared
// memory; the load of the next tile does not yet overlap the compute of this
// one (a cp.async / TMA ring is later work), nor is one slot split over
// several blocks.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launch.

#include "pool_load.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;                 // K/V rows staged per step = lanes
constexpr int kMaxD = 128;
constexpr int kMaxS = 16;                 // query rows per slot
constexpr int kQPerWarp = kMaxS / kWarps; // queries a warp owns, at most
constexpr int kDPerLane = kMaxD / 32;     // output elements a lane owns
constexpr int kPad = 4;                   // floats after each staged row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (H, B); block kThreads. T: query/output type; P: pool element type
// (T itself, or int8_t / __nv_fp8_e4m3 with kQuant). st: element strides
// (batch, head, seq) of q, then of out.
template <typename T, typename P, bool kQuant>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table, int maxp,
                    const int* __restrict__ start, T* __restrict__ out,
                    int H, int S, int D, int page, long long qsb,
                    long long qsh, long long qss, long long osb,
                    long long osh, long long oss, float scale) {
  __shared__ __align__(16) float s_q[kMaxS][kMaxD];
  __shared__ __align__(16) float s_k[kTile][kMaxD + kPad];
  __shared__ __align__(16) float s_v[kTile][kMaxD + kPad];
  __shared__ float s_ks[kTile], s_vs[kTile];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int st0 = start[b];
  const int end = min(st0 + S, maxp * page);   // tokens walked
  const int* trow = table + (long long)b * maxp;
  const long long row = (long long)H * D;      // between consecutive tokens

  for (int i = tid; i < S * D; i += kThreads) {
    const int s = i / D, d = i - s * D;
    s_q[s][d] = to_f(q[b * qsb + h * qsh + s * qss + d]);
  }

  float m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][kDPerLane];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[j][e] = 0.f;
  }

  const int vecs_per_row = D / 8;
  for (int t0 = 0; t0 < end; t0 += kTile) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kTile * vecs_per_row; i += kThreads) {
      const int r = i / vecs_per_row, c = (i - r * vecs_per_row) * 8;
      const int t = t0 + r;
      float kv[8], vv[8];
      if (t < end) {
        const int pg = t / page;
        const long long base =
            ((long long)trow[pg] * page + (t - pg * page)) * row +
            (long long)h * D + c;
        load8(kp + base, kv);
        load8(vp + base, vv);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(&s_k[r][c]);
      float4* vd = reinterpret_cast<float4*>(&s_v[r][c]);
      kd[0] = make_float4(kv[0], kv[1], kv[2], kv[3]);
      kd[1] = make_float4(kv[4], kv[5], kv[6], kv[7]);
      vd[0] = make_float4(vv[0], vv[1], vv[2], vv[3]);
      vd[1] = make_float4(vv[4], vv[5], vv[6], vv[7]);
    }
    if (tid < kTile) {
      const int t = t0 + tid;
      float a = 1.f, c = 1.f;
      if (kQuant && t < end) {
        const long long pid = trow[t / page];
        a = ks[pid * H + h];
        c = vs[pid * H + h];
      }
      s_ks[tid] = a;
      s_vs[tid] = c;
    }
    __syncthreads();

    const int t = t0 + lane;                   // this lane's tile row
    const float kscale = kQuant ? s_ks[lane] * scale : scale;
    const float vscale = s_vs[lane];
#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) {
      const int s = warp + j * kWarps;
      if (s >= S) break;                       // uniform across the warp
      float dot = 0.f;
      for (int c = 0; c < D; c += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&s_k[lane][c]);
        const float4 qq = *reinterpret_cast<const float4*>(&s_q[s][c]);
        dot = fmaf(qq.x, kk.x, dot);
        dot = fmaf(qq.y, kk.y, dot);
        dot = fmaf(qq.z, kk.z, dot);
        dot = fmaf(qq.w, kk.w, dot);
      }
      const bool visible = t < end && t <= st0 + s;
      const float sc = visible ? dot * kscale : kNegInf;
      const float mx = warp_max(sc);
      if (mx <= 0.5f * kNegInf) continue;      // no visible row in this tile
      const float mn = fmaxf(m[j], mx);
      const float alpha = expf(m[j] - mn);
      const float p = visible ? expf(sc - mn) : 0.f;
      l[j] = l[j] * alpha + warp_sum(p);
      const float pv = kQuant ? p * vscale : p;
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) acc[j][e] *= alpha;
      for (int r = 0; r < kTile; ++r) {
        const float pr = __shfl_sync(0xffffffffu, pv, r);
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) {
          const int d = lane + 32 * e;
          if (d < D) acc[j][e] = fmaf(pr, s_v[r][d], acc[j][e]);
        }
      }
      m[j] = mn;
    }
  }

#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    const int s = warp + j * kWarps;
    if (s >= S) break;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < D) store(out + b * osb + h * osh + s * oss + d, acc[j][e] * inv);
    }
  }
}

template <typename T, typename P, bool kQuant>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const int* table, int maxp,
                   const int* start, void* out, int B, int H, int S, int D,
                   int page, const long long* st, float scale,
                   cudaStream_t stream) {
  dim3 grid(H, B);
  paged_verify_kernel<T, P, kQuant><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), table, maxp, start,
      static_cast<T*>(out), H, S, D, page, st[0], st[1], st[2], st[3], st[4],
      st[5], scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). pool: -1 = the pool holds
// dtype itself (k_scales / v_scales unused), 0 = int8, 1 = fp8 e4m3 with
// one layer's contiguous [num_pages, H] float32 k_scales / v_scales.
// q: [B, H, S, D] and out: [B, H, S, D], each with D contiguous and
// (batch, head, seq) element strides in strides[0:3] / strides[3:6];
// k_pages / v_pages: one layer's contiguous [num_pages, page, H, D] pool;
// table: [B, maxp] int32 pool page ids; start: [B] int32. Requires
// 1 <= S <= 16, D % 8 == 0, 8 <= D <= 128 and 16-byte aligned pools (the
// wrapper checks).
extern "C" int sf_paged_verify(int dtype, int pool, const void* q,
                               const void* k_pages, const void* v_pages,
                               const void* k_scales, const void* v_scales,
                               const void* table, int maxp, const void* start,
                               void* out, int B, int H, int S, int D,
                               int page, const long long* strides,
                               float scale, void* stream) {
  if (D % 8 != 0 || D < 8 || D > kMaxD || S < 1 || S > kMaxS ||
      pool < -1 || pool > 1 ||
      (pool >= 0 && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(table);
  const int* n = static_cast<const int*>(start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* ks = k_scales;
  const void* vs = v_scales;
  cudaError_t e;
  if (dtype == 0) {
    if (pool < 0)
      e = launch<float, float, false>(q, k_pages, v_pages, ks, vs, t, maxp, n, out, B, H, S, D, page, strides, scale, s);
    else if (pool == 0)
      e = launch<float, int8_t, true>(q, k_pages, v_pages, ks, vs, t, maxp, n, out, B, H, S, D, page, strides, scale, s);
    else
      e = launch<float, __nv_fp8_e4m3, true>(q, k_pages, v_pages, ks, vs, t, maxp, n, out, B, H, S, D, page, strides, scale, s);
  } else {
    if (pool < 0)
      e = launch<__nv_bfloat16, __nv_bfloat16, false>(q, k_pages, v_pages, ks, vs, t, maxp, n, out, B, H, S, D, page, strides, scale, s);
    else if (pool == 0)
      e = launch<__nv_bfloat16, int8_t, true>(q, k_pages, v_pages, ks, vs, t, maxp, n, out, B, H, S, D, page, strides, scale, s);
    else
      e = launch<__nv_bfloat16, __nv_fp8_e4m3, true>(q, k_pages, v_pages, ks, vs, t, maxp, n, out, B, H, S, D, page, strides, scale, s);
  }
  return (int)e;
}
