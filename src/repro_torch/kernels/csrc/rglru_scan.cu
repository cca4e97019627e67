// RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (inclusive, h_{-1} = 0)
// over the time axis of (B, S, W) float32 tensors.
//
// Replaces src/repro/kernels/rglru_scan.py:_rglru_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.rglru_scan). The Pallas kernel walks time
// on its sequential grid axis, carrying the state in VMEM, and runs a
// log-depth prefix combine inside a chunk; its width blocks and 5-D
// transposes are TPU layout. Here: any S and W, read in place through the
// batch and time strides, no padding.
//
// What bounds it on an H100: bytes. The op reads a and b once and writes h
// once, 12 bytes per element, for 2 FLOP: at recurrentgemma-9b's prefill
// (B 4, S 2048, W 4096) 403 MB, 120 us at 3.35 TB/s. The earlier two-pass
// design read a and b twice (20 bytes per element, the second read mostly
// from HBM: 268 MB of inputs against a 50 MB L2), which capped it near 60%
// of the bound; it reached 49%, and 42% at B 1 (PERF.md).
//
// Design: one pass over device memory, time split across the blocks of a
// thread-block cluster, a carry in fixed order.
// * A cluster of C blocks (<= 8, the portable limit) owns one batch row
//   and G neighbouring channels (G = 32 or 64, template). Its blocks take
//   consecutive time chunks of T steps (a multiple of 8, at most 256 and
//   8192 / G): block `rank` of window k holds steps [(k C + rank) T, ...
//   + T). Where S is longer than C T the cluster walks ceil(S / (C T))
//   windows in order and carries the state from one to the next, so any S
//   works. grid = (C, ceil(W / G), B); the wrapper's launch_plan picks G,
//   C and T.
// * Each block stages its chunk's a and b tiles (T x G floats each) in
//   shared memory once. The route (tma_route in the wrapper): where the
//   base pointers and the batch and time strides are 16-byte aligned, one
//   thread issues two TMA tile loads over a 3-D tensor map (W, S, B) that
//   complete on an mbarrier; rows and channels outside the tensor arrive
//   as zeros. Otherwise (W not a multiple of 4, an offset view) every
//   thread issues 4-byte cp.async copies and writes zeros outside. Where
//   the cluster walks several windows, the tiles are double-buffered: the
//   next window's loads go out before this window's work, so a block
//   keeps a load in flight while it composes, waits on its cluster and
//   stores. (Single-buffered 8-block clusters of one window each, the
//   first cut, ran 155.5 us at the headline against 141.5 for the
//   double-buffered layouts launch_plan picks: PERF.md.)
// * 256 threads: thread (seg, c) owns channel c and segment seg of the
//   chunk's THREADS / G segments of L = T G / 256 steps. Pass 1 composes
//   its segment's affine maps from shared memory into (prod a, h from 0).
//   The threads of segment 0 fold the segments in order into the block's
//   aggregate and push it into every block of the cluster (distributed
//   shared memory, slot = rank, double-buffered by window parity); one
//   cluster.sync() per window publishes them. Each block then folds the
//   aggregates of ranks 0 .. rank-1 in rank order onto the window's
//   incoming state, which gives its own incoming state, and all C onto it,
//   which gives the next window's (the same operations in every block, so
//   every block holds the same bits). The segments' incoming states follow
//   by folding the segments in order.
// * Pass 2 walks each segment again from shared memory, h = a h + b, and
//   writes h over the staged b. The block then stores the tile: one TMA
//   tile store (clipped to the tensor) on the TMA route, coalesced 4-byte
//   stores otherwise.
// float32 throughout, fmaf for every step and fold. The composition order
// is fixed (segments, then ranks, then windows), with no atomics on values,
// so two launches give the same bits. It differs from the sequential
// recurrence and from the Pallas kernel's log-depth combine in the last
// bits only. rglru_scan.py:rglru_chunked_ref is the plain version of this
// decomposition.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_CHUNK = 256;   // a TMA box holds at most 256 rows
constexpr int MAX_TILE = 8192;   // floats of a (chunk x group) tile

struct Args {
  const float* a;
  const float* b;
  float* h;
  long long a_sb, a_ss, b_sb, b_ss, h_sb, h_ss;
  int S, W, chunk;
};

// Static shared memory beside the dynamic a and b tiles.
template <int G>
struct Shared {
  float2 agg[2][MAX_CLUSTER][G];  // pushed block aggregates, by parity
  float2 seg[THREADS / G][G];     // segment aggregates, then incoming states
  uint64_t bar[2];                // the TMA loads' mbarriers, by stage
};

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk stores have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every committed group but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Waits for the TMA loads' phase; a load that never lands (a tensor map the
// hardware refuses) traps after a second instead of hanging the card.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar,
                                                  uint32_t parity) {
  uint64_t start, now;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(start));
  while (!hopper::mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (now - start > 1000000000ull) __trap();
  }
}

// The cluster barrier split in two: a relaxed arrive at the start and the
// wait before the first push into another block's shared memory (every
// block of the cluster has started by then).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <int G, bool TMA>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const Args p, const __grid_constant__ CUtensorMap ma,
                  const __grid_constant__ CUtensorMap mb,
                  const __grid_constant__ CUtensorMap mh) {
  constexpr int SEGS = THREADS / G;
  extern __shared__ __align__(128) float smem[];  // [stage][a, b][T][G]
  __shared__ Shared<G> sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, c = tid % G, seg = tid / G;
  const int T = p.chunk, L = T / SEGS;
  const int w0 = blockIdx.y * G;
  const int bi = blockIdx.z;
  const int nwin = (p.S + C * T - 1) / (C * T);
  if (TMA && tid == 0) {
    hopper::mbar_init(hopper::smem_u32(&sh.bar[0]), 1);
    hopper::mbar_init(hopper::smem_u32(&sh.bar[1]), 1);
    hopper::mbar_fence_init();
  }
  cluster_arrive_relaxed();
  __syncthreads();

  // Issues the loads of window `win` into stage win % 2. A block whose
  // chunk starts past S (only in the last window, ranks above every live
  // one) loads nothing and composes the identity: its aggregate reaches no
  // stored step. The cp.async route commits a group either way.
  auto stage = [&](int win) {
    const int t0 = (win * C + rank) * T;
    float* sa = smem + (win & 1) * 2 * T * G;
    float* sb = sa + T * G;
    if constexpr (TMA) {
      if (tid == 0 && t0 < p.S) {
        const uint32_t bar = hopper::smem_u32(&sh.bar[win & 1]);
        hopper::mbar_arrive_expect_tx(bar, 2u * T * G * sizeof(float));
        tma_load_3d(hopper::smem_u32(sa), &ma, bar, w0, t0, bi);
        tma_load_3d(hopper::smem_u32(sb), &mb, bar, w0, t0, bi);
      }
    } else {
      const float* ab = p.a + (long long)bi * p.a_sb;
      const float* bb = p.b + (long long)bi * p.b_sb;
      for (int i = t0 < p.S ? tid : T * G; i < T * G; i += THREADS) {
        const int t = t0 + i / G, w = w0 + i % G;
        if (t < p.S && w < p.W) {
          cp_async4(hopper::smem_u32(sa + i), ab + t * p.a_ss + w);
          cp_async4(hopper::smem_u32(sb + i), bb + t * p.b_ss + w);
        } else {
          sa[i] = 0.f;
          sb[i] = 0.f;
        }
      }
      cp_async_commit();
    }
  };

  stage(0);
  float carry = 0.f;  // the window's incoming state (segment-0 threads)
  for (int win = 0; win < nwin; ++win) {
    const int t0 = (win * C + rank) * T;
    const bool live = t0 < p.S;
    const int Lw = live ? L : 0;
    float* sa = smem + (win & 1) * 2 * T * G;
    float* sb = sa + T * G;
    // ---- the next window's loads go out before this window's work: the
    // other stage was last read by the previous window's store
    if (win + 1 < nwin) {
      if (TMA && tid == 0) bulk_wait_read();
      stage(win + 1);
    } else if (!TMA) {
      cp_async_commit();  // an empty group keeps the count
    }
    // ---- this window's tiles
    if constexpr (TMA) {
      if (live) mbar_wait_or_trap(hopper::smem_u32(&sh.bar[win & 1]),
                                  (win >> 1) & 1);
    } else {
      cp_async_wait_prior();
      __syncthreads();
    }

    // ---- pass 1: the segment's map from a zero state
    const float* ra = sa + seg * L * G + c;
    float* rb = sb + seg * L * G + c;
    float P = 1.f, H = 0.f;
#pragma unroll 8
    for (int j = 0; j < Lw; ++j) {
      const float av = ra[j * G];
      H = fmaf(av, H, rb[j * G]);
      P *= av;
    }
    sh.seg[seg][c] = make_float2(P, H);
    __syncthreads();
    if (win == 0) cluster_wait();
    if (seg == 0) {  // the block's aggregate, segments in order
      float Pb = 1.f, Hb = 0.f;
      for (int q = 0; q < SEGS; ++q) {
        const float2 f = sh.seg[q][c];
        Hb = fmaf(f.x, Hb, f.y);
        Pb *= f.x;
      }
      for (int q = 0; q < C; ++q)
        *cluster.map_shared_rank(&sh.agg[win & 1][rank][c], q) =
            make_float2(Pb, Hb);
    }
    cluster.sync();  // every block's aggregate has landed in every block
    if (seg == 0) {
      float hh = carry, hin = 0.f;
      for (int q = 0; q < C; ++q) {  // rank order
        if (q == rank) hin = hh;
        const float2 f = sh.agg[win & 1][q][c];
        hh = fmaf(f.x, hh, f.y);
      }
      carry = hh;
      hh = hin;
      for (int q = 0; q < SEGS; ++q) {  // the segments' incoming states
        const float2 f = sh.seg[q][c];
        sh.seg[q][c].x = hh;
        hh = fmaf(f.x, hh, f.y);
      }
    }
    __syncthreads();

    // ---- pass 2: h from the segment's incoming state, over the staged b
    float hs = sh.seg[seg][c].x;
#pragma unroll 8
    for (int j = 0; j < Lw; ++j) {
      hs = fmaf(ra[j * G], hs, rb[j * G]);
      rb[j * G] = hs;
    }

    // ---- store the tile
    if constexpr (TMA) {
      hopper::fence_proxy_async();
      __syncthreads();
      if (tid == 0 && live)
        tma_store_3d(&mh, hopper::smem_u32(sb), w0, t0, bi);
    } else {
      __syncthreads();
      float* hb = p.h + (long long)bi * p.h_sb;
      for (int i = live ? tid : T * G; i < T * G; i += THREADS) {
        const int t = t0 + i / G, w = w0 + i % G;
        if (t < p.S && w < p.W) hb[t * p.h_ss + w] = sb[i];
      }
      __syncthreads();  // before the window after next stages over sb
    }
  }
  if (TMA && tid == 0) bulk_wait();
}

// A float32 tensor map over (W, S, B) with a box of G channels by T steps
// by one batch row. An extent-1 dimension gets the stride that continues
// the one before it. Elements outside the tensor read as zero and are not
// written.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int W,
             long long sb, long long ss, int G, int T) {
  hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (S == 1) ss = W;
  if (B == 1) sb = (long long)S * ss;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(ss * 4), (cuuint64_t)(sb * 4)};
  const cuuint32_t box[3] = {(cuuint32_t)G, (cuuint32_t)T, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
      strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int G, bool TMA>
int launch(const Args& p, int B, int cluster, cudaStream_t stream) {
  static bool ready[hopper::kMaxDevices] = {};
  auto kernel = rglru_scan_kernel<G, TMA>;
  cudaError_t err = hopper::allow_smem(
      kernel, 4 * MAX_TILE * (int)sizeof(float), ready);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ma = {}, mb = {}, mh = {};
  if (TMA) {
    int rc = make_map(&ma, p.a, B, p.S, p.W, p.a_sb, p.a_ss, G, p.chunk);
    if (rc == 0)
      rc = make_map(&mb, p.b, B, p.S, p.W, p.b_sb, p.b_ss, G, p.chunk);
    if (rc == 0)
      rc = make_map(&mh, p.h, B, p.S, p.W, p.h_sb, p.h_ss, G, p.chunk);
    if (rc != 0) return rc;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (p.W + G - 1) / G, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  // two stages (a and b tiles each) where the cluster walks several
  // windows, one where it walks one
  const int nwin = (p.S + cluster * p.chunk - 1) / (cluster * p.chunk);
  cfg.dynamicSmemBytes = (nwin > 1 ? 4 : 2) * p.chunk * G * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p, ma, mb, mh);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// a, b and h are float32; strides are in elements and W is contiguous. The
// wrapper's launch plan: `group` channels per cluster (32 or 64), `cluster`
// blocks per cluster (1..8), `chunk` steps per block and window (a multiple
// of 8, at most 256 and 8192 / group); tma = 1 takes the TMA route (16-byte
// aligned bases and strides). Returns the CUDA error of the launch (0 =
// launched).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h,
                                 long long a_sb, long long a_ss,
                                 long long b_sb, long long b_ss,
                                 long long h_sb, long long h_ss, int B, int S,
                                 int W, int group, int cluster, int chunk,
                                 int tma, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535 || cluster < 1 ||
      cluster > MAX_CLUSTER || chunk < 8 || chunk > MAX_CHUNK || chunk % 8 ||
      chunk * group > MAX_TILE)
    return (int)cudaErrorInvalidValue;
  const Args p{a, b, h, a_sb, a_ss, b_sb, b_ss, h_sb, h_ss, S, W, chunk};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group * 2 + (tma ? 1 : 0)) {
    case 64: return launch<32, false>(p, B, cluster, s);
    case 65: return launch<32, true>(p, B, cluster, s);
    case 128: return launch<64, false>(p, B, cluster, s);
    case 129: return launch<64, true>(p, B, cluster, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
