// GreedyTL leave-one-out trial scorer, batched over Data Collectors.
//
// Replaces src/repro/kernels/loo_trials.py:_loo_trials_kernel (the Pallas
// TPU kernel behind repro.kernels.ops.loo_trials). For every DC l and
// candidate j < M it computes
//
//   t      = (a_cand[l,:,j] - ut[l] @ cc[l,:,j]) * dinv[l,j]
//   fitted = fitted_base[l] + t * zj[l,j]
//   h      = h_base[l] + t*t
//   out[l,j] = sum_rows ((fitted - y[l]) * rmask[l] / max(1 - h, 0.1))^2
//
// Inputs are float32 and contiguous: ut (L,R,D), cc (L,D,M), a_cand (L,R,M),
// fitted_base/h_base/y/rmask (L,R), zj/dinv (L,M); out is (L,M).
//
// What bounds it on an H100: neither bytes nor FLOPs. At the main path's
// largest shape (L=16, R=1120, D=23, M=16) one launch reads about 3 MB
// (under 1 us at 3.35 TB/s) and does 2*R*D*M FLOPs per DC (13 MFLOP in
// all), so the launch latency dominates. The design's lever is therefore
// the launch count: ONE launch per greedy step serves the whole fleet
// bucket, where the reference launches once per DC under lax.map.
//
// Design (simple and right first): grid (L, ceil(M/MT)), one block per DC
// and tile of MT candidates. The block stages its cc tile, zj and dinv in
// shared memory; each thread walks rows with a stride of the block size
// and keeps its MT partial sums in registers. The block then reduces them
// in a fixed order (warp shuffles, then the warps' sums in warp order) —
// no float atomics, so two launches on the same inputs are bitwise equal
// and the port's fleet results do not depend on scheduling.
#include <cuda_runtime.h>

namespace {

constexpr int MT = 16;        // candidates per block (M_CAP = 16)
constexpr int MAX_D = 128;    // the wrapper refuses D > MAX_D
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
loo_trials_kernel(const float* __restrict__ ut, const float* __restrict__ cc,
                  const float* __restrict__ a_cand,
                  const float* __restrict__ fitted_base,
                  const float* __restrict__ h_base,
                  const float* __restrict__ y,
                  const float* __restrict__ rmask,
                  const float* __restrict__ zj,
                  const float* __restrict__ dinv, float* __restrict__ out,
                  int R, int D, int M) {
  __shared__ float cc_s[MAX_D * MT];
  __shared__ float zj_s[MT];
  __shared__ float dinv_s[MT];
  __shared__ float warp_s[WARPS][MT];

  const int l = blockIdx.x;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);
  const int tid = threadIdx.x;

  const float* cc_l = cc + (size_t)l * D * M;
  for (int i = tid; i < D * MT; i += THREADS) {
    const int d = i / MT, j = i % MT;
    cc_s[i] = j < mt ? cc_l[(size_t)d * M + m0 + j] : 0.0f;
  }
  if (tid < MT) {
    zj_s[tid] = tid < mt ? zj[(size_t)l * M + m0 + tid] : 0.0f;
    dinv_s[tid] = tid < mt ? dinv[(size_t)l * M + m0 + tid] : 0.0f;
  }
  __syncthreads();

  float part[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) part[j] = 0.0f;

  const float* ut_l = ut + (size_t)l * R * D;
  const float* ac_l = a_cand + (size_t)l * R * M;
  const size_t row0 = (size_t)l * R;
  for (int r = tid; r < R; r += THREADS) {
    float dot[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) dot[j] = 0.0f;
    const float* u = ut_l + (size_t)r * D;
    for (int d = 0; d < D; ++d) {
      const float ud = u[d];
#pragma unroll
      for (int j = 0; j < MT; ++j) dot[j] += ud * cc_s[d * MT + j];
    }
    const float fb = fitted_base[row0 + r], hb = h_base[row0 + r];
    const float yr = y[row0 + r], rm = rmask[row0 + r];
    const float* ac = ac_l + (size_t)r * M + m0;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const float a = j < mt ? ac[j] : 0.0f;
      const float t = (a - dot[j]) * dinv_s[j];
      const float resid = (fb + t * zj_s[j] - yr) * rm;
      const float h = hb + t * t;
      const float loo = resid / fmaxf(1.0f - h, 0.1f);
      part[j] += loo * loo;
    }
  }

  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    float v = part[j];
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_s[warp][j] = v;
  }
  __syncthreads();
  if (tid < mt) {
    float s = 0.0f;
    for (int w = 0; w < WARPS; ++w) s += warp_s[w][tid];
    out[(size_t)l * M + m0 + tid] = s;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError(); the Python wrapper raises when it is not 0.
extern "C" int loo_trials_launch(const void* ut, const void* cc,
                                 const void* a_cand, const void* fitted_base,
                                 const void* h_base, const void* y,
                                 const void* rmask, const void* zj,
                                 const void* dinv, void* out, int L, int R,
                                 int D, int M, void* stream) {
  if (L > 0 && M > 0) {
    dim3 grid(L, (M + MT - 1) / MT);
    loo_trials_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)ut, (const float*)cc, (const float*)a_cand,
        (const float*)fitted_base, (const float*)h_base, (const float*)y,
        (const float*)rmask, (const float*)zj, (const float*)dinv,
        (float*)out, R, D, M);
  }
  return (int)cudaGetLastError();
}
