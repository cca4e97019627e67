// RG-LRU linear recurrence h_t = a_t h_{t-1} + b_t (inclusive, h_{-1} = 0)
// over the time axis of (B, S, W) tensors.
//
// Replaces src/repro/kernels/rglru_scan.py:_rglru_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.rglru_scan). The Pallas kernel chunks time
// on its sequential grid axis and runs a log-depth prefix combine inside a
// chunk, because that is how a recurrence maps onto the TPU's vector units;
// its width blocks and 5-D transposes are TPU layout. No padding, no
// assertion here: any S and any W, read in place through the batch and
// time strides.
//
// What bounds it on an H100: bytes. The op reads a and b once and writes h
// once (12 bytes per element in float32) for 2 FLOP: at recurrentgemma-9b's
// prefill (B 4, S 2048, W 4096) 403 MB, 120 us at 3.35 TB/s.
//
// Design: a two-pass chunked scan inside one block. A block owns 32
// neighbouring channels (one warp's width: every load and store of a warp
// is one coalesced row segment) and splits time into SEGS segments, one
// warp each, so that B * W / 32 blocks of SEGS warps fill the card even at
// B = 1. Pass 1: each thread composes its segment's affine maps into
// (prod a, h from 0). A carry pass (warp 0, SEGS steps) turns them into
// each segment's incoming state. Pass 2: each thread walks its segment
// again from that state, h_t = a_t h_{t-1} + b_t, and stores h. a and b
// are read twice (the second read partly from L2), in exchange for
// SEGS-fold parallelism over time; within a pass a thread loads U steps
// ahead before their dependent FMAs. (The first version, one thread per
// channel walking all of S, was latency-bound: PERF.md.)
//
// float32 throughout, as the model gives it (a and b come from the
// gates in float32). The fixed order of the two passes makes the result
// bitwise reproducible; it differs from the Pallas kernel's log-depth
// combine in the last bits only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 8;             // time steps loaded ahead per thread
constexpr int LANES = 32;        // channels per block
constexpr int SEGS = 16;         // time segments per block, one warp each
constexpr int NTHREADS = LANES * SEGS;

// Walk time steps [t0, t1) of one channel: h <- a_t h + b_t (and, when
// `prod` is given, *prod <- *prod * a_t); stores h when `hp` is given.
__device__ __forceinline__ float walk(const float* ap, const float* bp,
                                      float* hp, long long a_ss,
                                      long long b_ss, long long h_ss, int t0,
                                      int t1, float h, float* prod) {
  for (int tb = t0; tb < t1; tb += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u;
      av[u] = t < t1 ? ap[t * a_ss] : 1.f;
      bv[u] = t < t1 ? bp[t * b_ss] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = tb + u;
      if (t >= t1) break;
      h = fmaf(av[u], h, bv[u]);
      if (prod) *prod *= av[u];
      if (hp) hp[t * h_ss] = h;
    }
  }
  return h;
}

__global__ void __launch_bounds__(NTHREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, long long a_sb, long long a_ss,
                  long long b_sb, long long b_ss, long long h_sb,
                  long long h_ss, int S, int W) {
  __shared__ float carry[SEGS][LANES];   // prod a, then incoming state
  __shared__ float local[SEGS][LANES];   // segment's h from a zero state
  const int lane = threadIdx.x % LANES, seg = threadIdx.x / LANES;
  const int w = blockIdx.x * LANES + lane;
  const bool on = w < W;
  const long long bi = blockIdx.y;
  const float* ap = a + bi * a_sb + w;
  const float* bp = b + bi * b_sb + w;
  float* hp = h + bi * h_sb + w;
  const int L = (S + SEGS - 1) / SEGS;
  const int t0 = min(S, seg * L), t1 = min(S, t0 + L);

  float prod = 1.f, hl = 0.f;
  if (on) hl = walk(ap, bp, nullptr, a_ss, b_ss, h_ss, t0, t1, 0.f, &prod);
  carry[seg][lane] = prod;
  local[seg][lane] = hl;
  __syncthreads();
  if (seg == 0) {
    float c = 0.f;
    for (int s = 0; s < SEGS; ++s) {
      const float p = carry[s][lane];
      carry[s][lane] = c;
      c = fmaf(p, c, local[s][lane]);
    }
  }
  __syncthreads();
  if (on) walk(ap, bp, hp, a_ss, b_ss, h_ss, t0, t1, carry[seg][lane],
               nullptr);
}

}  // namespace

// a, b and h are float32. Strides are in elements; W is contiguous.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h,
                                 long long a_sb, long long a_ss,
                                 long long b_sb, long long b_ss,
                                 long long h_sb, long long h_ss, int B, int S,
                                 int W, void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + LANES - 1) / LANES, B);
  rglru_scan_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, h, a_sb, a_ss, b_sb, b_ss, h_sb, h_ss, S, W);
  return (int)cudaGetLastError();
}
