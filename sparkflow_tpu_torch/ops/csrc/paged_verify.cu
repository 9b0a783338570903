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
// axis. Here the walk of each (slot, head) over its tokens t < start[b] + S
// is split into chunks of kChunk tokens (flash-decoding):
// 1. the split kernel, grid (chunks, H, B), sized on the host from
//    max_pages * page alone — the host never reads `start`, so a call needs
//    no synchronisation and can later be captured in a CUDA graph. It is
//    launched once for each group of 16 query rows (S = spec_k + 1 takes
//    ceil(S / 16) groups: one up to spec_k = 15, two at 16 to 31), each
//    group walking the chunks on its own, so a K/V row is read once a
//    group; a chunk at or past start[b] + 16g + 16 (the group's last
//    query's reach) exits at once. (A grid axis of groups, tried first,
//    took the block's group offset and row count into registers and
//    pushed 13 instantiations past the 64 registers ptxas gives them, into
//    spills; as kernel arguments they stay in the constant bank.) A live
//    chunk walks its tokens
//    in tiles of kTile rows and writes, for each of the S queries, its
//    partial softmax state (m, l and the unnormalised acc, float32) to
//    scratch that the wrapper allocates;
// 2. the combine kernel, grid (S, H, B), reads the partial states of the
//    chunks that query s reaches (those at or before start[b] + s) in
//    chunk order, rescales them to the common max and writes O. A
//    chunk in which a query sees no row (m = -1e30, l = 0, acc = 0) adds
//    exactly 0. The order is fixed and there are no atomics: two launches
//    give the same bits.
// Inside a chunk:
// - the pool rows, raw (int8 / fp8 / bf16 / f32 bytes), are staged through
//   a two-stage cp.async ring (16-byte copies; 8-byte ones for an int8/fp8
//   row whose D is not a multiple of 16), rows padded by 16 bytes, rows past
//   the walk zero-filled; tile t+1 is in flight while tile t is computed.
//   They are widened to float32 only when read from shared memory;
// - the page table and (quantized) the page-head scales are read once per
//   page of the chunk, into shared memory, not once per row;
// - every K/V row is read from device memory ONCE and used for all S
//   queries, which is the point of one verify call over S decode calls;
// - a block scores one group of at most kGroup = 16 consecutive queries,
//   so that warp w owns queries w, w + kWarps of its group: lane r scores
//   tile row r against them, the warp reduces max and sum with shuffles, and each lane
//   accumulates its own HD / 32 consecutive output elements; the kernels
//   are specialised on head_dim rounded up to 32 (HD = 32, 64, ..., 256),
//   so D = 64 does not run D = 128's idle lanes. At HD = 256 a lane holds
//   8 output elements for each of its 2 queries (16 float registers), and
//   the dynamic shared memory is the S x HD float32 queries (16 KB at S =
//   16) and the two-stage ring of 2 x 32 raw K and V rows of HD + 16 bytes
//   (133,120 bytes for a float32 pool, 67,584 bf16, 34,816 int8/fp8):
//   149,504 bytes at most, with ~2 KB static, under the 227 KB a block may
//   have. The float32 partials the wrapper allocates per call are B x H x
//   chunks x S x (D + 2) floats: 5.3 MB at the decode step's 8 slots of
//   1024 tokens, H = 16, D = 256, S = 5; 3.4 MB at GPT-2 small's H = 12,
//   D = 64 with spec_k = 16 (S = 17), growing linearly in S.
// Every other head_dim (above 256, or not a multiple of 8) the C entry sends
// to the column-sliced kernel of paged_sliced.cu (one block a query row and
// column slice, no scratch), which reads the same pool, never copied.
//
// kChunk = 128 tokens (8 pages of 16): at the serving shape (B=8, H=12,
// max 1024 tokens) the longest slot splits into 8 chunks and the call has
// ~290 live blocks for the card's 132 SMs, each walking at most 4 tiles;
// a smaller chunk would add combine work and scratch (B*H*chunks*S*(D+2)
// floats) for blocks that are already short.
//
// What bounds it on the H100: bytes, like the single-query kernel: each K/V
// row is read once and used for 4*S*D flops (S = 5 at the serving shape),
// far below the ~295 flops/byte ridge. At these sizes the call is bound by
// latency: the dependent table -> row loads of one chunk, and the launch of
// two kernels (measured with chip_smoke.py on an H100 80GB HBM3, 700 W:
// 0.023-0.026 ms at the decode step's shape against a 0.0012-0.0024 ms
// bound, 0.014-0.016 ms for one 1024-token slot).
// ptxas -v (sm_90a): no instantiation spills; the split kernel 46-64
// registers (bf16 query, int8 pool, HD 64: 64; 55-63 at HD 160-256), the
// combine kernel 32.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns cudaGetLastError() of the launches.

#include "mma_bf16.cuh"
#include "paged_sliced.cuh"
#include "pool_load.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;               // tokens per chunk of a slot's walk
constexpr int kTile = 32;                 // K/V rows staged per step = lanes
constexpr int kGroup = 16;                // query rows a block scores
constexpr int kQPerWarp = kGroup / kWarps;  // queries a warp owns, at most
constexpr int kMaxPages = kChunk + 1;     // pages a chunk touches, at most
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

// staged row pitch in bytes: HD pool elements and 16 bytes of padding
template <typename P, int HD>
__host__ __device__ constexpr int row_bytes() {
  return HD * (int)sizeof(P) + 16;
}

template <typename P, int HD>
size_t split_smem(int S) {
  return sizeof(float) * (size_t)S * HD + 2 * 2 * kTile * row_bytes<P, HD>();
}

// grid (chunks, H, B); block kThreads; one launch a group of Sg <= 16
// queries s0 .. s0 + Sg - 1 of the S. T: query type; P: pool element type
// (T itself, or int8_t / __nv_fp8_e4m3 with kQuant). part_acc [B, H,
// chunks, S, D] and part_ml [B, H, chunks, S, 2] float32 scratch; the
// launch writes its queries' rows.
template <typename T, typename P, bool kQuant, int HD>
__global__ void __launch_bounds__(kThreads)
paged_verify_split_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                          const P* __restrict__ vp,
                          const float* __restrict__ ks,
                          const float* __restrict__ vs,
                          const int* __restrict__ table, int maxp,
                          const int* __restrict__ start,
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml, int H, int S,
                          int s0, int Sg, int D,
                          int page, int nchunks, long long qsb, long long qsh,
                          long long qss, float scale, int vec16) {
  constexpr int E = HD / 32;                  // output elements per lane
  constexpr int RB = row_bytes<P, HD>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_q = reinterpret_cast<float*>(smem_raw);          // [Sg][HD]
  unsigned char* ring = smem_raw + sizeof(float) * Sg * HD;  // [2][K, V][kTile][RB]
  __shared__ long long s_base[kMaxPages];  // element offset of (page, row 0, h)
  __shared__ float s_ks[kMaxPages], s_vs[kMaxPages];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int st0 = start[b] + s0;               // the group's first query
  const int end = min(st0 + Sg, maxp * page);  // tokens the group walks
  const int c0 = c * kChunk;
  if (c0 >= end) return;                       // a chunk past the walk
  const int c1 = min(c0 + kChunk, end);
  const int p0 = c0 / page;
  const int np = (c1 - 1) / page - p0 + 1;
  const long long row = (long long)H * D;      // between consecutive tokens

  if (tid < np) {
    const long long pid = table[(long long)b * maxp + p0 + tid];
    s_base[tid] = pid * page * row + (long long)h * D;
    if (kQuant) {
      s_ks[tid] = ks[pid * H + h] * scale;
      s_vs[tid] = vs[pid * H + h];
    }
  }
  for (int i = tid; i < Sg * D; i += kThreads) {
    const int s = i / D, d = i - s * D;
    s_q[s * HD + d] = to_f(q[b * qsb + h * qsh + (s0 + s) * qss + d]);
  }
  __syncthreads();

  const int vbytes = vec16 ? 16 : 8;
  const int nvec = D * (int)sizeof(P) / vbytes;   // copies per row
  auto load_tile = [&](int t) {
    const int t0 = c0 + t * kTile;
    unsigned char* dst = ring + (t & 1) * 2 * kTile * RB;
    for (int i = tid; i < 2 * kTile * nvec; i += kThreads) {
      const int kv = i / (kTile * nvec);        // 0: K, 1: V
      const int rem = i - kv * kTile * nvec;
      const int r = rem / nvec, cc = rem - r * nvec, tok = t0 + r;
      const P* pool = kv ? vp : kp;
      const bool ok = tok < c1;
      const char* src = reinterpret_cast<const char*>(pool);
      if (ok) {
        const int pg = tok / page;
        src = reinterpret_cast<const char*>(
                  pool + s_base[pg - p0] + (long long)(tok - pg * page) * row) +
              cc * vbytes;
      }
      unsigned char* d = dst + (kv * kTile + r) * RB + cc * vbytes;
      if (vec16)
        sf_mma::cp_async16(d, src, ok ? 16 : 0);
      else
        sf_mma::cp_async8(d, src, ok ? 8 : 0);
    }
  };

  float m[kQPerWarp], l[kQPerWarp], acc[kQPerWarp][E];
#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  }

  const int ntiles = (c1 - c0 + kTile - 1) / kTile;
  load_tile(0);
  sf_mma::cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1);
    sf_mma::cp_async_commit();
    sf_mma::cp_async_wait<1>();  // tile t landed for this thread
    __syncthreads();             // ... and for every thread
    const unsigned char* sk = ring + (t & 1) * 2 * kTile * RB;
    const unsigned char* sv = sk + kTile * RB;

    const int tok = c0 + t * kTile + lane;     // this lane's tile row
    const bool live = tok < c1;
    float kscale = scale, vscale = 1.f;
    if (kQuant && live) {
      const int pg = tok / page - p0;
      kscale = s_ks[pg];
      vscale = s_vs[pg];
    }

    // dot[j] = q[warp + j * kWarps] . K[tok]
    float dot[kQPerWarp] = {};
    const P* krow = reinterpret_cast<const P*>(sk + lane * RB);
    for (int cc = 0; cc < D; cc += 8) {
      float kv[8];
      load8(krow + cc, kv);
#pragma unroll
      for (int j = 0; j < kQPerWarp; ++j) {
        const int s = warp + j * kWarps;
        if (s >= Sg) break;
        const float4 a = *reinterpret_cast<const float4*>(s_q + s * HD + cc);
        const float4 z = *reinterpret_cast<const float4*>(s_q + s * HD + cc + 4);
        float x = dot[j];
        x = fmaf(a.x, kv[0], x); x = fmaf(a.y, kv[1], x);
        x = fmaf(a.z, kv[2], x); x = fmaf(a.w, kv[3], x);
        x = fmaf(z.x, kv[4], x); x = fmaf(z.y, kv[5], x);
        x = fmaf(z.z, kv[6], x); x = fmaf(z.w, kv[7], x);
        dot[j] = x;
      }
    }

#pragma unroll
    for (int j = 0; j < kQPerWarp; ++j) {
      const int s = warp + j * kWarps;
      if (s >= Sg) break;                      // uniform across the warp
      const bool visible = live && tok <= st0 + s;
      const float sc = visible ? dot[j] * kscale : kNegInf;
      const float mx = warp_max(sc);
      if (mx <= 0.5f * kNegInf) continue;      // no visible row in this tile
      const float mn = fmaxf(m[j], mx);
      const float alpha = expf(m[j] - mn);
      const float p = visible ? expf(sc - mn) : 0.f;
      l[j] = l[j] * alpha + warp_sum(p);
      const float pv = kQuant ? p * vscale : p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] *= alpha;
      for (int r = 0; r < kTile; ++r) {
        const float pr = __shfl_sync(0xffffffffu, pv, r);
        const P* vrow = reinterpret_cast<const P*>(sv + r * RB);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane * E + e;
          if (d < D) acc[j][e] = fmaf(pr, to_f(vrow[d]), acc[j][e]);
        }
      }
      m[j] = mn;
    }
    __syncthreads();  // stage t & 1 is consumed before tile t + 2 fills it
  }
  sf_mma::cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < kQPerWarp; ++j) {
    const int s = warp + j * kWarps;
    if (s >= Sg) break;
    const long long idx = (((long long)b * H + h) * nchunks + c) * S + s0 + s;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int d = lane * E + e;
      if (d < D) part_acc[idx * D + d] = acc[j][e];
    }
    if (lane == 0) {
      part_ml[idx * 2] = m[j];
      part_ml[idx * 2 + 1] = l[j];
    }
  }
}

// grid (S, H, B); block kCombineThreads. Folds the partial states of the
// chunks query s reaches, in chunk order, into out [B, H, S, D] (strides
// (batch, head, seq)). A chunk its group walked past its reach holds (m =
// -1e30, l = 0, acc = 0) for it, which would add exactly nothing.
constexpr int kCombineThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_verify_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            const int* __restrict__ start, int maxp, int page,
                            T* __restrict__ out, int H, int S, int D,
                            int nchunks, long long osb, long long osh,
                            long long oss) {
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int end = min(start[b] + s + 1, maxp * page);
  const int live = (end + kChunk - 1) / kChunk;   // chunks s reaches
  const long long base = ((long long)b * H + h) * nchunks * S + s;
  float mmax = kNegInf;
  for (int c = 0; c < live; ++c)
    mmax = fmaxf(mmax, part_ml[(base + (long long)c * S) * 2]);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float lsum = 0.f, a = 0.f;
    for (int c = 0; c < live; ++c) {
      const long long idx = base + (long long)c * S;
      const float w = expf(part_ml[idx * 2] - mmax);
      lsum = fmaf(part_ml[idx * 2 + 1], w, lsum);
      a = fmaf(part_acc[idx * D + d], w, a);
    }
    store(out + b * osb + h * osh + s * oss + d, a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs;
  const int* table;
  int maxp;
  const int* start;
  float *part_acc, *part_ml;
  void* out;
  int B, H, S, D, page, nchunks;
  const long long* st;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename P, bool kQuant, int HD>
cudaError_t launch(const Args& a) {
  auto kern = paged_verify_split_kernel<T, P, kQuant, HD>;
  const size_t smem = split_smem<P, HD>(min(a.S, kGroup));
  if (smem > 40 * 1024) {  // with the ~2 KB of static page staging, > 48 KB
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  // 16-byte copies where a row's bytes allow them (the pool is 16-byte
  // aligned), else 8-byte ones: an int8/fp8 row of D % 16 != 0 elements
  const int vec16 = (a.D * (int)sizeof(P)) % 16 == 0;
  for (int s0 = 0; s0 < a.S; s0 += kGroup) {
    kern<<<dim3(a.nchunks, a.H, a.B), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const P*>(a.kp),
        static_cast<const P*>(a.vp), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), a.table, a.maxp, a.start,
        a.part_acc, a.part_ml, a.H, a.S, s0, min(kGroup, a.S - s0), a.D,
        a.page, a.nchunks, a.st[0], a.st[1], a.st[2], a.scale, vec16);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  paged_verify_combine_kernel<T><<<dim3(a.S, a.H, a.B), kCombineThreads, 0,
                                   a.stream>>>(
      a.part_acc, a.part_ml, a.start, a.maxp, a.page, static_cast<T*>(a.out),
      a.H, a.S, a.D, a.nchunks, a.st[3], a.st[4], a.st[5]);
  return cudaGetLastError();
}

template <typename T, typename P, bool kQuant>
cudaError_t dispatch(const Args& a) {
  switch ((a.D + 31) / 32) {   // head_dim rounded up to 32
    case 1: return launch<T, P, kQuant, 32>(a);
    case 2: return launch<T, P, kQuant, 64>(a);
    case 3: return launch<T, P, kQuant, 96>(a);
    case 4: return launch<T, P, kQuant, 128>(a);
    case 5: return launch<T, P, kQuant, 160>(a);
    case 6: return launch<T, P, kQuant, 192>(a);
    case 7: return launch<T, P, kQuant, 224>(a);
    case 8: return launch<T, P, kQuant, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out). pool: -1 = the pool holds
// dtype itself (k_scales / v_scales unused), 0 = int8, 1 = fp8 e4m3 with
// one layer's contiguous [num_pages, H] float32 k_scales / v_scales.
// q: [B, H, S, D] and out: [B, H, S, D], each with D contiguous and
// (batch, head, seq) element strides in strides[0:3] / strides[3:6];
// k_pages / v_pages: one layer's contiguous [num_pages, page, H, D] pool;
// table: [B, maxp] int32 pool page ids; start: [B] int32. part_acc /
// part_ml: float32 scratch of [B, H, nchunks, S, D] / [B, H, nchunks, S, 2]
// elements, nchunks = ceil(maxp * page / 128) (paged_verify_chunk()).
// Any S >= 1 and D >= 1: a multiple of 8 up to 256 runs this file's kernels
// and needs the scratch and 16-byte aligned pools (the wrapper checks);
// every other D the sliced kernel (paged_sliced.cu), where the scratch and
// nchunks are unused.
extern "C" int sf_paged_verify(int dtype, int pool, const void* q,
                               const void* k_pages, const void* v_pages,
                               const void* k_scales, const void* v_scales,
                               const void* table, int maxp, const void* start,
                               void* out, void* part_acc, void* part_ml,
                               int nchunks, int B, int H, int S, int D,
                               int page, const long long* strides,
                               float scale, void* stream) {
  if (D < 1 || S < 1 || pool < -1 || pool > 1 ||
      (pool >= 0 && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!sf_paged_sliced::vector_head_dim(D))
    return (int)sf_paged_sliced::run(
        dtype, pool, q, strides[0], strides[1], strides[2], k_pages, v_pages,
        k_scales, v_scales, static_cast<const int*>(table), maxp,
        static_cast<const int*>(start), 1, out, strides[3], strides[4],
        strides[5], B, H, S, D, page, scale,
        static_cast<cudaStream_t>(stream));
  if (part_acc == nullptr || part_ml == nullptr ||
      nchunks != (maxp * page + kChunk - 1) / kChunk)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales,
               static_cast<const int*>(table), maxp,
               static_cast<const int*>(start),
               static_cast<float*>(part_acc), static_cast<float*>(part_ml),
               out, B, H, S, D, page, nchunks, strides, scale,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (dtype == 0) {
    if (pool < 0) e = dispatch<float, float, false>(a);
    else if (pool == 0) e = dispatch<float, int8_t, true>(a);
    else e = dispatch<float, __nv_fp8_e4m3, true>(a);
  } else {
    if (pool < 0) e = dispatch<__nv_bfloat16, __nv_bfloat16, false>(a);
    else if (pool == 0) e = dispatch<__nv_bfloat16, int8_t, true>(a);
    else e = dispatch<__nv_bfloat16, __nv_fp8_e4m3, true>(a);
  }
  return (int)e;
}

// tokens per chunk of a slot's walk: the wrapper sizes the scratch by it
extern "C" int sf_paged_verify_chunk() { return kChunk; }
