// Single-query decode attention through a page table, for NVIDIA Hopper,
// sm_90a, over a plain or a quantized KV pool: flash-decoding over a
// thread-block cluster, in one launch.
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
// Translation from the TPU kernels: the TPU grid (B, max_pages) walked a
// slot's pages in order, with the page table (and the scales)
// scalar-prefetched into the BlockSpec index maps and m / l / acc carried in
// VMEM across the sequential page axis. Here the walk of each (slot, head)
// is split into C chunks, one thread block each, and the C blocks of a
// (slot, head) form one thread-block cluster that merges their partial
// softmax states through distributed shared memory (DSMEM). A block visits
// only the tokens of its chunk below lengths[b]: rows past the length are
// never loaded, so a masked lane of the engine (a table row of scratch page
// 0, length 1) and aliased pages shared between slots are just reads of
// valid pool rows.
//
// What bounds it on the H100: bytes. Each K/V row is read once and used for
// 2*D flops (4*D per K/V pair), far below the ~295 flops/byte ridge, so the
// least time is the live tokens' rows over HBM bandwidth — half of it for an
// int8/fp8 pool. At the serving sizes (at most 1024 tokens a slot, ~2.6k
// live tokens and ~0.8 MB of rows a call) latency bounds it instead: the
// launch, the dependent round trips to memory and the longest walk of one
// block. One block per (slot, head) walking its whole slot, as before, made
// a 1024-token slot 8 serial trips of (table -> row) loads while 36 of the
// 132 SMs idled, and a quantized pool bought nothing. So:
// 1. grid (C, H, B), cluster dims (C, 1, 1), launched with cudaLaunchKernelEx
//    so that C is chosen at run time. The wrapper sizes the chunk and C
//    from max_pages * page and the pool's row alone (ops/attention.py
//    _paged_split): a chunk is 128 tokens or, where larger, the rows one
//    block loads in a single trip (256 for an int8/fp8 row at D = 64);
//    C = ceil(tokens / chunk) up to 8, the portable cluster limit, past
//    which the chunk grows to ceil(tokens / 8); each rounded up to a whole
//    page. The host never reads `lengths`, so a call needs no
//    synchronisation and can be captured in a CUDA graph. At the decode
//    step's shape (64 pages of 16, D = 64) a bf16 pool gets C = 8 (768
//    blocks, 276 live, each one trip) and an int8/fp8 pool C = 4 (384
//    blocks, one trip each). Every block of a cluster, a dead one too,
//    holds its SM until the cluster's barrier, so fewer blocks a cluster
//    let more clusters run at once: at C = 4 the launch fits the card in
//    one wave (3 blocks an SM). A bf16 pool at C = 4 would walk two trips
//    a block, one after the other: a little faster at the decode step's
//    lengths, a third slower for one 1024-token slot.
// 2. Inside a block, two dependent round trips: lengths[b], q and the page
//    ids of the block's first trip (one table entry per thread, into shared
//    memory — a table entry does not depend on the length) together; then
//    every lane issues the K and V loads of all its rows of the trip
//    (kUnroll rows, one 16-byte load each: 4 f32, 8 bf16 or 16 int8/fp8
//    elements; 8-byte loads of 8 elements for an int8/fp8 row whose D is
//    not a multiple of 16, which is not 16-byte aligned) and, quantized,
//    the page-head K and V scales once per page into shared memory, before
//    it computes on any of them. A trip is kWarps * (32 / G) * kUnroll
//    tokens (G lanes a row): the whole 128-token chunk in bf16 at D = 64.
//    Up to D = 256 (GPT-J-6B's heads) a row of 16-byte runs needs at most
//    32 lanes in bf16 and int8/fp8; a float32 row above 128 elements needs
//    64, more than a warp, so there each of 32 lanes holds two runs (NR =
//    2, elements sub * 4 and 128 + sub * 4) and half as many rows in
//    flight: the same registers of raw rows a lane, one row a warp a step,
//    a trip of 16 rows.
// 3. Each warp keeps its online-softmax state (m, l, acc) in float32; the
//    row groups of a warp merge by shuffles, the warps through shared
//    memory. Then every block, live or dead, writes its (m, l, acc[D]) into
//    slot [rank] of rank 0's shared memory and the cluster meets at one
//    barrier (barrier.cluster.arrive.release / wait.acquire); rank 0 folds
//    the C slots in rank order, rescaled to their common max, and writes O.
//    A chunk at or past the length walks nothing and publishes
//    (m = -1e30, l = 0, acc = 0), which adds exactly nothing; a slot of
//    length 0 folds to 0 / 1e-30 = exact zeros. No atomics and no scratch
//    in device memory: two launches give the same bits.
// No block returns early: every block, a dead chunk's too, arrives at the
// cluster barriers, or rank 0 would wait forever. Blocks write only rank 0's
// shared memory and never read a peer's, so they may exit after the barrier;
// a first, relaxed cluster barrier split around the walk makes sure that
// rank 0 has started before any block writes into its shared memory.
//
// ptxas -v (sm_90a, CUDA 12.8): no instantiation spills. Registers: plain
// bf16 64, plain float32 59 (67 with two runs a lane); int8/fp8 pools 64
// with VEC 8 and 80 with VEC 16, float32 and bf16 queries alike. Shared
// memory, sized for D = 256: 21,636 bytes plain, 29,836 quantized.
//
// Every other head_dim (above 256, or not a multiple of 8: an int8 row at
// D = 25 is 25 bytes, with no 8-byte run) the C entries send to the
// column-sliced kernel of paged_sliced.cu, which reads the same pool, never
// copied.
//
// Interface: plain C, loaded with ctypes; launches on the caller's stream and
// returns the error of the launch.

#include "paged_sliced.cuh"
#include "pool_load.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;        // rows per lane in flight (one run each)
constexpr int kMaxD = 256;
constexpr int kMaxCluster = 8;    // the portable cluster size
// page ids of one trip: at most 32 rows a warp step (G = 1), kUnroll steps
constexpr int kMaxTripPages = kThreads * kUnroll + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// cluster barrier halves: arrive (release semantics unless relaxed), wait
// (acquire semantics); every thread of every block of the cluster takes each
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

// store x at `local` (this block's shared memory) as rank 0 of the
// cluster maps it
__device__ __forceinline__ void store_rank0(float* local, float x) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(local));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(a), "r"(0));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n"
               : : "r"(remote), "f"(x) : "memory");
}

// grid (C, H, B), cluster (C, 1, 1); block kThreads. G = lanes per row, a
// power of two with G * VEC * NR >= D, at most 32; 32 / G rows per warp per
// step. T: query/output type; P: pool element type (T itself, or int8_t /
// __nv_fp8_e4m3 with kQuant); VEC: pool elements a lane loads per run (16
// or 8 bytes); NR: runs a lane holds of a row, 1, or 2 where one run a
// lane would need more lanes than a warp has (a float32 pool at D > 128:
// run r of lane `sub` at elements (sub + r * 32) * 4), with half as many
// rows in flight, so a lane holds as many raw registers and a block's trip
// stays kWarps * 32 * kUnroll / (G * NR) rows. Resident blocks an SM: 4
// (64 registers a thread), which every instantiation fits without a spill
// except those holding 16 int8/fp8 elements a row or two runs: 3 (80
// registers). Given the block size alone, ptxas squeezed the bf16 plain
// instantiation to 64 registers and spilled.
template <typename T, typename P, bool kQuant, int VEC, int NR>
__global__ void __launch_bounds__(kThreads,
                                  (kQuant && VEC == 16) || NR > 1 ? 3 : 4)
paged_attention_kernel(const T* __restrict__ q, long long qsb, long long qsh,
                       const P* __restrict__ kp, const P* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table, int maxp,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int D, int page, int chunk, float scale, int G) {
  using Raw = typename PoolRun<P, VEC>::Raw;
  constexpr int kU = kUnroll / NR;   // rows per lane in flight
  __shared__ __align__(16) float s_q[kMaxD];
  __shared__ int s_pid[kMaxTripPages];
  __shared__ float s_ks[kQuant ? kMaxTripPages : 1];
  __shared__ float s_vs[kQuant ? kMaxTripPages : 1];
  __shared__ float s_acc[kWarps][kMaxD];
  __shared__ float s_m[kWarps], s_l[kWarps];
  // rank 0's: the partial state of each block of the cluster
  __shared__ float s_part[kMaxCluster][kMaxD];
  __shared__ float s_pm[kMaxCluster], s_pl[kMaxCluster];

  cluster_arrive_relaxed();   // this block has started

  const int h = blockIdx.y, b = blockIdx.z;
  const int rank = static_cast<int>(cluster_rank());   // == blockIdx.x
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane & (G - 1), grp = lane / G, groups = 32 / G;
  int d0[NR];          // the first element of each of the lane's runs
  bool active[NR];     // a run past D holds no K and reads no q
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    d0[r] = (sub + r * G) * VEC;
    active[r] = d0[r] < D;
  }
  const int total = maxp * page;
  const int c0 = rank * chunk, c1 = min(c0 + chunk, total);
  const int step = kWarps * groups;        // rows per block per unrolled row
  const int trip = step * kU;              // rows per block in flight
  const int* trow = table + (long long)b * maxp;

  // the page ids of the trip from token t0, whatever the slot's length
  auto load_pids = [&](int t0) {
    const int pa = t0 / page, pb = (min(t0 + trip, c1) - 1) / page;
    for (int i = tid; i <= pb - pa; i += kThreads) s_pid[i] = trow[pa + i];
  };
  if (c0 < c1) load_pids(c0);
  const int len = max(0, min(lengths[b], total));
  // q in shared memory, not registers: a lane's VEC registers go to the
  // rows in flight
  if (tid < D) s_q[tid] = to_f(q[b * qsb + h * qsh + tid]);

  float m = kNegInf, l = 0.f, acc[NR * VEC];
#pragma unroll
  for (int e = 0; e < NR * VEC; ++e) acc[e] = 0.f;

  const long long row = (long long)H * D;  // between consecutive tokens
  const int cend = min(c1, len);
  __syncthreads();
  // the trip count is the same for the whole block (the barriers below) and
  // every lane of a warp runs every row slot (the shuffles need the whole
  // warp); lanes past the length just skip their update
  for (int t0 = c0; t0 < cend; t0 += trip) {
    if (t0 != c0) {
      __syncthreads();   // the previous trip has read its page ids
      load_pids(t0);
      __syncthreads();
    }
    const int pa = t0 / page;
    Raw kr[kU][NR], vr[kU][NR];
    int slot[kU];   // the row's page within the trip
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + warp * groups + grp + u * step;
      const int pg = t / page;
      slot[u] = pg - pa;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (active[r] && t < cend) {
          const long long base =
              ((long long)s_pid[pg - pa] * page + (t - pg * page)) * row +
              (long long)h * D + d0[r];
          kr[u][r] = raw_load(reinterpret_cast<const Raw*>(kp + base));
          vr[u][r] = raw_load(reinterpret_cast<const Raw*>(vp + base));
        } else {
          kr[u][r] = Raw{};
          vr[u][r] = Raw{};
        }
      }
    }
    if (kQuant) {
      // once per page, while the rows are in flight
      const int np = (min(t0 + trip, cend) - 1) / page - pa + 1;
      for (int i = tid; i < np; i += kThreads) {
        const long long ph = (long long)s_pid[i] * H + h;
        s_ks[i] = ks[ph] * scale;
        s_vs[i] = vs[ph];
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float part = 0.f;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        if (active[r]) {
          float kf[VEC];
          widen(kr[u][r], static_cast<const P*>(nullptr), kf);
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 qq =
                *reinterpret_cast<const float4*>(s_q + d0[r] + e);
            part = fmaf(qq.x, kf[e], part);
            part = fmaf(qq.y, kf[e + 1], part);
            part = fmaf(qq.z, kf[e + 2], part);
            part = fmaf(qq.w, kf[e + 3], part);
          }
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (t0 + warp * groups + grp + u * step >= cend) continue;
      const float s = kQuant ? part * s_ks[slot[u]] : part * scale;
      const float mn = fmaxf(m, s);
      const float alpha = expf(m - mn), p = expf(s - mn);
      l = l * alpha + p;
      const float pv = kQuant ? p * s_vs[slot[u]] : p;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float vf[VEC];
        widen(vr[u][r], static_cast<const P*>(nullptr), vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[r * VEC + e] = fmaf(pv, vf[e], acc[r * VEC + e] * alpha);
      }
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
    for (int e = 0; e < NR * VEC; ++e) {
      const float x2 = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * a1 + x2 * a2;
    }
    m = mn;
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if (grp == 0 && active[r]) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_acc[warp][d0[r] + e] = acc[r * VEC + e];
    }
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // merge the warps into this block's state, and publish it in rank 0
  cluster_wait();   // every block of the cluster has started
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
    store_rank0(&s_part[rank][tid], a);
    if (tid == 0) {
      store_rank0(&s_pm[rank], mx);
      store_rank0(&s_pl[rank], lsum);
    }
  }
  cluster_arrive_release();
  cluster_wait();

  // rank 0 folds the blocks in rank order; an empty slot (no row visited
  // anywhere) divides 0 by 1e-30
  if (rank == 0 && tid < D) {
    const int nblocks = static_cast<int>(gridDim.x);
    float mx = kNegInf;
    for (int r = 0; r < nblocks; ++r) mx = fmaxf(mx, s_pm[r]);
    float lsum = 0.f, a = 0.f;
    for (int r = 0; r < nblocks; ++r) {
      const float f = expf(s_pm[r] - mx);
      lsum = fmaf(s_pl[r], f, lsum);
      a = fmaf(s_part[r][tid], f, a);
    }
    store(out + ((long long)b * H + h) * D + tid, a / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs;
  long long qsb, qsh;
  const int* table;
  int maxp;
  const int* lengths;
  void* out;
  int B, H, D, page, chunk, nchunks;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename P, bool kQuant, int VEC, int NR>
cudaError_t launch(const Args& a) {
  int G = 1;
  while (G * VEC * NR < a.D) G <<= 1;
  if (G > 32) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nchunks, a.H, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nchunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_attention_kernel<T, P, kQuant, VEC, NR>,
      static_cast<const T*>(a.q), a.qsb, a.qsh, static_cast<const P*>(a.kp),
      static_cast<const P*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), a.table, a.maxp, a.lengths,
      static_cast<T*>(a.out), a.H, a.D, a.page, a.chunk, a.scale, G);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// an int8/fp8 pool: 16-byte runs where a row's bytes allow them (the pool is
// 16-byte aligned), else 8-byte ones
template <typename T, typename P>
cudaError_t launch_quant(const Args& a) {
  return a.D % 16 == 0 ? launch<T, P, true, 16, 1>(a)
                       : launch<T, P, true, 8, 1>(a);
}

bool valid(int maxp, int page, int chunk, int nchunks) {
  const long long total = (long long)maxp * page;
  return page >= 1 && maxp >= 0 &&
         chunk >= 1 && nchunks >= 1 && nchunks <= kMaxCluster &&
         (long long)nchunks * chunk >= total &&
         (long long)(nchunks - 1) * chunk < (total > 0 ? total : 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (query, output and pool). q: [B, H, D]
// with D contiguous and strides (qsb, qsh) in elements; k_pages / v_pages:
// one layer's contiguous [num_pages, page, H, D] pool; table: [B, maxp] int32
// pool page ids; lengths: [B] int32; out: contiguous [B, H, D]. chunk /
// nchunks: tokens per block and blocks per (slot, head) cluster, from the
// table's width (ops/attention.py _paged_split): nchunks in [1, 8] and
// nchunks chunks cover maxp * page tokens, the last one not empty.
// Any D >= 1: a multiple of 8 up to 256 runs this file's kernel and needs
// 16-byte aligned pools (the wrapper checks); every other D the sliced
// kernel (paged_sliced.cu), where chunk / nchunks are unused.
extern "C" int sf_paged_attention(int dtype, const void* q, long long qsb,
                                  long long qsh, const void* k_pages,
                                  const void* v_pages, const void* table,
                                  int maxp, const void* lengths, void* out,
                                  int B, int H, int D, int page, int chunk,
                                  int nchunks, float scale, void* stream) {
  if (!sf_paged_sliced::vector_head_dim(D))
    return (int)sf_paged_sliced::run(
        dtype, -1, q, qsb, qsh, 0, k_pages, v_pages, nullptr, nullptr,
        static_cast<const int*>(table), maxp,
        static_cast<const int*>(lengths), 0, out, (long long)H * D, D, 0, B,
        H, 1, D, page, scale, static_cast<cudaStream_t>(stream));
  if (!valid(maxp, page, chunk, nchunks)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, nullptr, nullptr, qsb, qsh,
               static_cast<const int*>(table), maxp,
               static_cast<const int*>(lengths), out, B, H, D, page, chunk,
               nchunks, scale, static_cast<cudaStream_t>(stream)};
  // a float32 row above 128 elements is wider than 32 lanes of 4: two runs
  // a lane
  cudaError_t e = dtype == 0
      ? (D > 128 ? launch<float, float, false, 4, 2>(a)
                 : launch<float, float, false, 4, 1>(a))
      : launch<__nv_bfloat16, __nv_bfloat16, false, 8, 1>(a);
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
    void* out, int B, int H, int D, int page, int chunk, int nchunks,
    float scale, void* stream) {
  if ((pool != 0 && pool != 1) || k_scales == nullptr || v_scales == nullptr)
    return (int)cudaErrorInvalidValue;
  if (!sf_paged_sliced::vector_head_dim(D))
    return (int)sf_paged_sliced::run(
        dtype, pool, q, qsb, qsh, 0, k_pages, v_pages, k_scales, v_scales,
        static_cast<const int*>(table), maxp,
        static_cast<const int*>(lengths), 0, out, (long long)H * D, D, 0, B,
        H, 1, D, page, scale, static_cast<cudaStream_t>(stream));
  if (!valid(maxp, page, chunk, nchunks)) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, k_scales, v_scales, qsb, qsh,
               static_cast<const int*>(table), maxp,
               static_cast<const int*>(lengths), out, B, H, D, page, chunk,
               nchunks, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t e;
  if (dtype == 0)
    e = pool == 0 ? launch_quant<float, int8_t>(a)
                  : launch_quant<float, __nv_fp8_e4m3>(a);
  else
    e = pool == 0 ? launch_quant<__nv_bfloat16, int8_t>(a)
                  : launch_quant<__nv_bfloat16, __nv_fp8_e4m3>(a);
  return (int)e;
}
