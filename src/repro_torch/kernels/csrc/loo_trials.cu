// GreedyTL leave-one-out trial scorer, batched over Data Collectors, and the
// same scorer fused with the greedy step's prologue.
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
// fitted_base/h_base/y/rmask (L,R), zj/dinv (L,M); out is (L,M). The fused
// entry (loo_trials_step_launch) takes diag_g, aty_m, sel, src_mask (L,M)
// and z (L,D) in place of zj and dinv, and first computes, per candidate,
//
//   dinv = rsqrt(max(diag_g - sum_d cc^2, 1e-8)) * (1 - sel*src_mask)
//   zj   = (aty_m - cc^T z) * dinv
//
// (the step's prologue in core/greedytl.py), writing dinv and zj beside out.
//
// What bounds it on an H100: launch latency and a little memory. At the main
// path's largest shape (L=16, R=1120, D=23, M=16) one launch reads about
// 3 MB (0.9 us at 3.35 TB/s) and does 2*R*D*M FLOPs per DC (13 MFLOP in all,
// far under the float32 rate). The first version (one block per DC, a
// thread per row reading u[d] one float at a time from device memory) ran
// 16 blocks on 132 SMs and waited out a memory latency per row: 35 us.
//
// Design (the alternatives that each choice beat: PERF.md §6):
// * Enough blocks. One thread-block cluster per (DC, tile of MT = 16
//   candidates); its `cluster` blocks (<= 8, the portable limit) split the
//   DC's rows: the rows are cut into tiles of RT = 64 and block q of the
//   cluster takes tiles [q*nt/cluster, (q+1)*nt/cluster). grid.x =
//   cluster * L. The wrapper's launch_plan picks the cluster so that no
//   block holds more than 192 rows (one pass, below) and, where the rows
//   allow, the grid comes near 96 blocks: one wave of 8-block clusters was
//   slower, and so were 256-row blocks and a second pass
//   (scripts/torch_loo_plan.py times every cluster size).
// * Coalesced staging. A block's rows of ut are one contiguous span of
//   device memory, and its a_cand rows are 16-float segments at stride M.
//   A pass's 4 sub-tiles of RT rows go into shared memory together through
//   cp.async (neighbouring threads on neighbouring floats), all in flight at
//   once with the block's cc, so the block waits out one memory latency;
//   shared memory stays bounded at any R (a longer span takes more passes).
//   ut goes by 4-byte copies, not TMA bulk copies: its span is in general
//   not 16-byte aligned (D = 23 and 11; 92-byte rows at R = 1) and lands in
//   rows padded to an odd stride. (16-byte copies of the span into unpadded
//   rows were a little faster at D = 23 and much slower at even D, where a
//   warp's rows share banks.) a_cand goes by 16-byte copies where
//   M is a multiple of 4 (rows then stay 16-byte aligned), else by 4-byte
//   ones. cc (and for the fused entry z) is staged once per block,
//   zero-padded in D to the template's bucket DP (16, 32, 64 or 128); the
//   staged ut rows have stride DP + 1 (odd: a warp's 32 rows fall in 32
//   banks) and zero pad columns, so the dot loop runs to D rounded up to 4.
// * float32 on the CUDA cores, one row per thread and all 16 candidates:
//   16 independent FMA chains per thread, and every cc read is one float4
//   that the whole warp shares (a broadcast). TF32 wgmma would lose the
//   float32 exactness the 1e-5 tolerance and the greedy argmin rely on, and
//   there is nothing to gain at 0.8 MFLOP a DC. (Four threads per row with
//   four candidates each, the first cut, waited on shared memory.) The
//   epilogue divides with __fdividef (within 2 ulp; the denominator
//   max(1 - h, 0.1) lies in [0.1, 1]): 16 IEEE divisions per thread were
//   the largest single cost.
// * One launch, fixed-order sums, no atomics, no workspace: per thread over
//   its rows, per warp by a transposing xor-shuffle tree (16 shuffles leave
//   candidate j's sum in lanes 2j and 2j+1), per block in warp order in
//   shared memory; then every block writes its MT sums into cluster rank
//   0's shared memory (distributed shared memory, slot = rank), one
//   cluster.sync() publishes them, and rank 0 adds them in rank order and
//   writes out. Only rank 0's shared memory is read remotely, and it stays
//   alive because rank 0 is the last to leave; one barrier, not two (a
//   pull by rank 0 with a second barrier was slower). A one-block
//   cluster skips the barrier. Two launches on the same inputs are bitwise
//   equal.
// * The fused prologue is computed by every block for its 16 candidates
//   (inputs of D*16 + D + 64 floats), so no block waits for another; it
//   runs while the row sub-tiles are in flight. Rank 0 writes dinv and zj.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MT = 16;        // candidates per cluster (one tile)
constexpr int RT = 64;        // rows per staged sub-tile
constexpr int THREADS = 256;  // one row per thread in a pass
constexpr int WARPS = THREADS / 32;
constexpr int PASS = THREADS / RT;  // sub-tiles per pass
constexpr int AS = MT + 4;    // a_cand row stride: conflict-free float4 reads
constexpr int MAX_CLUSTER = 8;

// Shared-memory layout in floats (every offset a multiple of 4, so the
// float4 reads and 16-byte copies are aligned).
template <int DP>
struct Layout {
  static constexpr int US = DP + 1;                      // ut row stride
  static constexpr int A = 0;                            // a_cand RT x AS
  static constexpr int ROW = A + RT * AS;                // fb, hb, y, rm
  static constexpr int U = ROW + 4 * RT;                 // ut RT x US
  static constexpr int STAGE = U + RT * US;
  static constexpr int CC = PASS * STAGE;                // cc DP x MT
  static constexpr int ZJ = CC + DP * MT;
  static constexpr int DINV = ZJ + MT;
  static constexpr int WARP = DINV + MT;                 // WARPS x MT
  static constexpr int BLK = WARP + WARPS * MT;          // rank 0: all sums
  static constexpr int Z = BLK + MAX_CLUSTER * MT;       // fused: z (DP)
  static constexpr int DG = Z + DP;                      // fused: diag_g
  static constexpr int ATY = DG + MT;                    // fused: aty_m
  static constexpr int SEL = ATY + MT;                   // fused: sel
  static constexpr int SRC = SEL + MT;                   // fused: src_mask
  static constexpr int FLOATS = SRC + MT;
  static constexpr int BYTES = FLOATS * 4;
  static_assert(STAGE % 4 == 0 && CC % 4 == 0, "float4 alignment");
};

struct Args {
  const float* ut;
  const float* cc;
  const float* a_cand;
  const float* fitted_base;
  const float* h_base;
  const float* y;
  const float* rmask;
  const float* zj;      // unfused: input
  const float* dinv;    // unfused: input
  const float* diag_g;  // fused inputs
  const float* aty_m;
  const float* z;
  const float* sel;
  const float* src_mask;
  float* out;
  float* dinv_out;      // fused outputs
  float* zj_out;
  int R, D, M, cluster;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int DP, bool STEP>
__global__ void __launch_bounds__(THREADS)
loo_trials_kernel(const Args p) {
  using S = Layout<DP>;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int R = p.R, D = p.D, M = p.M, cs = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int l = blockIdx.x / cs;
  const int m0 = blockIdx.y * MT;
  const int mt = min(MT, M - m0);

  // this block's rows: tiles [t_lo, t_hi) of the DC's nt row tiles
  const int nt = (R + RT - 1) / RT;
  const int t_lo = rank * nt / cs, t_hi = (rank + 1) * nt / cs;
  const int lo = t_lo * RT, hi = min(R, t_hi * RT);
  const int ntiles = t_hi - t_lo;
  const int npass = (ntiles + PASS - 1) / PASS;

  float* cc_s = smem + S::CC;
  float* zj_s = smem + S::ZJ;
  float* dinv_s = smem + S::DINV;
  float* warp_s = smem + S::WARP;
  float* blk_s = smem + S::BLK;

  const float* ut_l = p.ut + (size_t)l * R * D;
  const float* ac_l = p.a_cand + (size_t)l * R * M + m0;
  const size_t row0 = (size_t)l * R;
  const size_t lm = (size_t)l * M + m0;

  // group 0: the block's fixed inputs
  const float* cc_l = p.cc + (size_t)l * D * M + m0;
  for (int i = tid; i < DP * MT; i += THREADS) {
    const int d = i / MT, j = i % MT;
    if (d < D && j < mt)
      cp_async4(cc_s + i, cc_l + (size_t)d * M + j);
    else
      cc_s[i] = 0.0f;
  }
  if constexpr (STEP) {
    float* z_s = smem + S::Z;
    for (int i = tid; i < DP; i += THREADS) {
      if (i < D)
        cp_async4(z_s + i, p.z + (size_t)l * D + i);
      else
        z_s[i] = 0.0f;
    }
    if (tid < 4 * MT) {
      const int which = tid / MT, j = tid % MT;
      const float* src = which == 0 ? p.diag_g : which == 1 ? p.aty_m
                         : which == 2 ? p.sel : p.src_mask;
      float* dst = smem + S::DG + which * MT + j;
      if (j < mt)
        cp_async4(dst, src + lm + j);
      else
        *dst = 0.0f;
    }
  } else if (tid < 2 * MT) {
    const int j = tid % MT;
    const float* src = tid < MT ? p.zj : p.dinv;
    float* dst = (tid < MT ? zj_s : dinv_s) + j;
    if (j < mt)
      cp_async4(dst, src + lm + j);
    else
      *dst = 0.0f;
  }
  cp_async_commit();

  // Where this thread's ut floats land: element i of a sub-tile's span is
  // row i / D, column i % D, and i steps by THREADS (one division, then
  // increments: the same for every sub-tile).
  const int r_step = THREADS / D, c_step = THREADS % D;
  const int r_first = tid / D, c_first = tid % D;
  const bool a_vec = M % 4 == 0 && (uintptr_t)p.a_cand % 16 == 0;

  // Issues the copies of this block's row sub-tile k into slot k % PASS.
  auto stage_tile = [&](int k) {
    float* st = smem + (k % PASS) * S::STAGE;
    const int r0 = lo + k * RT, nr = min(RT, hi - r0);
    const float* u = ut_l + (size_t)r0 * D;      // one contiguous span
    int r = r_first, c = c_first;
    for (int i = tid; i < nr * D; i += THREADS) {
      cp_async4(st + S::U + r * S::US + c, u + i);
      r += r_step;
      c += c_step;
      if (c >= D) {
        c -= D;
        ++r;
      }
    }
    if (a_vec) {                                 // 16-byte pieces of rows
      for (int i = tid; i < nr * (MT / 4); i += THREADS) {
        const int rj = i / (MT / 4), j = (i % (MT / 4)) * 4;
        if (j < mt)
          cp_async16(st + S::A + rj * AS + j,
                     ac_l + (size_t)(r0 + rj) * M + j);
      }
    } else {
      for (int i = tid; i < nr * MT; i += THREADS) {
        const int rj = i / MT, j = i % MT;
        if (j < mt)
          cp_async4(st + S::A + rj * AS + j, ac_l + (size_t)(r0 + rj) * M + j);
      }
    }
    const int which = tid / RT, rw = tid % RT;   // 4 row vectors x RT rows
    if (rw < nr) {
      const float* src = which == 0 ? p.fitted_base : which == 1 ? p.h_base
                         : which == 2 ? p.y : p.rmask;
      cp_async4(st + S::ROW + which * RT + rw, src + row0 + r0 + rw);
    }
  };
  auto stage_pass = [&](int pass) {
    for (int k = pass * PASS; k < min(ntiles, (pass + 1) * PASS); ++k)
      stage_tile(k);
  };

  // group 1: the first pass's sub-tiles, all in flight at once
  if (npass > 0) stage_pass(0);
  cp_async_commit();

  // Zeros that no copy overwrites, while the copies fly: the pad columns of
  // the staged ut rows and the a_cand columns past the tile's last
  // candidate, in every slot row that a pass will compute.
  for (int r = tid; r < min(PASS * RT, hi - lo); r += THREADS) {
    float* st = smem + (r / RT) * S::STAGE;
    for (int c = D; c < S::US; ++c) st[S::U + (r % RT) * S::US + c] = 0.0f;
    for (int j = mt; j < MT; ++j) st[S::A + (r % RT) * AS + j] = 0.0f;
  }

  if constexpr (STEP) {
    // the step's prologue, while the first sub-tiles are in flight
    cp_async_wait<1>();
    __syncthreads();
    if (tid < MT) {
      const float* z_s = smem + S::Z;
      float ss = 0.0f, cz = 0.0f;
#pragma unroll 8  // (full unrolling spills at DP = 128)
      for (int d = 0; d < DP; ++d) {
        const float c = cc_s[d * MT + tid];
        ss = fmaf(c, c, ss);
        cz = fmaf(c, z_s[d], cz);
      }
      const float dsq = smem[S::DG + tid] - ss;
      const float act = smem[S::SEL + tid] * smem[S::SRC + tid];
      const float dv = (1.0f / sqrtf(fmaxf(dsq, 1e-8f))) * (1.0f - act);
      const bool live = tid < mt;
      dinv_s[tid] = live ? dv : 0.0f;
      zj_s[tid] = live ? (smem[S::ATY + tid] - cz) * dv : 0.0f;
    }
  }

  const int rr = tid % RT;       // the thread's row in its sub-tile
  float part[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) part[j] = 0.0f;

  for (int pass = 0; pass < npass; ++pass) {
    if (pass > 0) stage_pass(pass);  // rows past the first 256 (off the
    cp_async_commit();               // main path: launch_plan avoids them)
    cp_async_wait<0>();
    __syncthreads();
    const int k = pass * PASS + tid / RT;
    const int nr = k < ntiles ? min(RT, hi - (lo + k * RT)) : 0;
    if (rr < nr) {
      const float* st = smem + (k % PASS) * S::STAGE;
      const float* u = st + S::U + rr * S::US;
      const float4* c4 = reinterpret_cast<const float4*>(cc_s);
      float dot[MT];
#pragma unroll
      for (int j = 0; j < MT; ++j) dot[j] = 0.0f;
      const int d_end = (D + 3) & ~3;  // zero pad columns up to it
#pragma unroll 4
      for (int d = 0; d < d_end; ++d) {
        const float ud = u[d];
#pragma unroll
        for (int q = 0; q < MT / 4; ++q) {
          const float4 c = c4[d * (MT / 4) + q];
          dot[4 * q + 0] = fmaf(ud, c.x, dot[4 * q + 0]);
          dot[4 * q + 1] = fmaf(ud, c.y, dot[4 * q + 1]);
          dot[4 * q + 2] = fmaf(ud, c.z, dot[4 * q + 2]);
          dot[4 * q + 3] = fmaf(ud, c.w, dot[4 * q + 3]);
        }
      }
      const float4* a4 = reinterpret_cast<const float4*>(st + S::A + rr * AS);
      const float fb = st[S::ROW + rr], hb = st[S::ROW + RT + rr];
      const float yr = st[S::ROW + 2 * RT + rr];
      const float rm = st[S::ROW + 3 * RT + rr];
#pragma unroll
      for (int q = 0; q < MT / 4; ++q) {
        const float4 a = a4[q];
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          const float t = (av[e] - dot[j]) * dinv_s[j];
          const float resid = (fb + t * zj_s[j] - yr) * rm;
          const float h = hb + t * t;
          const float loo = __fdividef(resid, fmaxf(1.0f - h, 0.1f));
          part[j] += loo * loo;
        }
      }
    }
    __syncthreads();
  }

  // Fixed-order sums. Per warp, a transposing xor tree: at offset 16, 8, 4,
  // 2 a lane keeps the half of its candidates that its lane bit selects and
  // adds its partner's sums of them; the last step (offset 1) leaves
  // candidate j's warp sum in lanes 2j and 2j+1. Then the warps in order,
  // leaving out those that held no row (their sums are +0: the result is
  // the same bit for bit).
  const int lane = tid % 32, warp = tid / 32;
  const int used = npass > 1 ? WARPS : (hi - lo + 31) / 32;
  if (warp < used) {
#pragma unroll
    for (int half = MT / 2; half >= 1; half /= 2) {
      const bool upper = lane & (2 * half);  // offsets 16, 8, 4, 2
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float send = upper ? part[i] : part[i + half];
        const float keep = upper ? part[i + half] : part[i];
        part[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * half);
      }
    }
    part[0] += __shfl_xor_sync(0xffffffffu, part[0], 1);
    if (lane % 2 == 0) warp_s[warp * MT + lane / 2] = part[0];
  }
  __syncthreads();
  if (tid < MT) {
    float s = 0.0f;
    for (int w = 0; w < used; ++w) s += warp_s[w * MT + tid];
    cluster.map_shared_rank(blk_s, 0)[rank * MT + tid] = s;
  }
  if (cs > 1)
    cluster.sync();  // every block's sums have landed in rank 0
  else
    __syncthreads();
  if (rank == 0 && tid < mt) {
    float s = 0.0f;
    for (int q = 0; q < cs; ++q) s += blk_s[q * MT + tid];  // rank order
    p.out[lm + tid] = s;
    if constexpr (STEP) {
      p.dinv_out[lm + tid] = dinv_s[tid];
      p.zj_out[lm + tid] = zj_s[tid];
    }
  }
}

template <int DP, bool STEP>
int launch(const Args& a, int L, void* stream) {
  static bool ready[hopper::kMaxDevices] = {};
  auto kernel = loo_trials_kernel<DP, STEP>;
  const int bytes = Layout<DP>::BYTES;
  cudaError_t err = hopper::allow_smem(kernel, bytes, ready);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster * L, (a.M + MT - 1) / MT, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return (int)(err != cudaSuccess ? err : last);
}

template <bool STEP>
int dispatch(const Args& a, int L, int d_bucket, void* stream) {
  if (L <= 0 || a.M <= 0) return (int)cudaGetLastError();
  if (a.cluster < 1 || a.cluster > MAX_CLUSTER || a.D > d_bucket ||
      a.M > 8 * MT || a.R < 0)
    return (int)cudaErrorInvalidValue;
  switch (d_bucket) {
    case 16: return launch<16, STEP>(a, L, stream);
    case 32: return launch<32, STEP>(a, L, stream);
    case 64: return launch<64, STEP>(a, L, stream);
    case 128: return launch<128, STEP>(a, L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both launchers run on `stream` (PyTorch's current stream) with the
// wrapper's launch plan (`cluster` blocks per DC and candidate tile, the D
// bucket) and return the launch's CUDA error code; the Python wrapper
// raises when it is not 0.
extern "C" int loo_trials_launch(const void* ut, const void* cc,
                                 const void* a_cand, const void* fitted_base,
                                 const void* h_base, const void* y,
                                 const void* rmask, const void* zj,
                                 const void* dinv, void* out, int L, int R,
                                 int D, int M, int cluster, int d_bucket,
                                 void* stream) {
  Args a = {};
  a.ut = (const float*)ut;
  a.cc = (const float*)cc;
  a.a_cand = (const float*)a_cand;
  a.fitted_base = (const float*)fitted_base;
  a.h_base = (const float*)h_base;
  a.y = (const float*)y;
  a.rmask = (const float*)rmask;
  a.zj = (const float*)zj;
  a.dinv = (const float*)dinv;
  a.out = (float*)out;
  a.R = R;
  a.D = D;
  a.M = M;
  a.cluster = cluster;
  return dispatch<false>(a, L, d_bucket, stream);
}

extern "C" int loo_trials_step_launch(
    const void* ut, const void* cc, const void* a_cand, const void* fitted,
    const void* h, const void* y, const void* rmask, const void* diag_g,
    const void* aty_m, const void* z, const void* sel, const void* src_mask,
    void* objs, void* dinv, void* zj, int L, int R, int D, int M, int cluster,
    int d_bucket, void* stream) {
  Args a = {};
  a.ut = (const float*)ut;
  a.cc = (const float*)cc;
  a.a_cand = (const float*)a_cand;
  a.fitted_base = (const float*)fitted;
  a.h_base = (const float*)h;
  a.y = (const float*)y;
  a.rmask = (const float*)rmask;
  a.diag_g = (const float*)diag_g;
  a.aty_m = (const float*)aty_m;
  a.z = (const float*)z;
  a.sel = (const float*)sel;
  a.src_mask = (const float*)src_mask;
  a.out = (float*)objs;
  a.dinv_out = (float*)dinv;
  a.zj_out = (float*)zj;
  a.R = R;
  a.D = D;
  a.M = M;
  a.cluster = cluster;
  return dispatch<true>(a, L, d_bucket, stream);
}
