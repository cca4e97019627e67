// Block-tiled online-softmax attention (flash attention), GQA-aware.
//
// Replaces src/repro/kernels/flash_attention.py:_flash_kernel (the Pallas
// TPU kernel behind repro.kernels.ops.flash_attention[_bshd]). For every
// batch b, query head h and query row i it computes
//
//   o[b,i,h,:] = softmax_j( q[b,i,h,:] . k[b,j,h/G,:] * d^-1/2 ) v[b,j,h/G,:]
//
// over the keys j that the mask keeps: j < Skv, and with causal
// q_pos >= j, and with window > 0 also q_pos - j < window, where
// q_pos = q_offset + i. G = H / KV query heads share one KV head (GQA and
// MQA); K and V are never repeated in memory.
//
// Inputs are float32 or bfloat16 (q, k, v and o of one type), head_dim D in
// {32, 64, 128, 256}, addressed through element strides (batch, seq, head)
// with the head_dim contiguous, so both the (B,S,H,D) and the (B,H,S,D)
// layouts are read in place. Scores, the running max and denominator and
// the output accumulator are float32, and p.v is float32 as in the Pallas
// kernel (which widens K and V to float32); o is rounded to the input type
// once, at the end.
//
// What bounds it on an H100: operations. At the serve path's prefill
// (B=4, H=24, S=2048, D=128, bf16, causal) the work is 1.0e11 FLOP against
// 134 MB of q/k/v/o: 104.28 us at the 989 TFLOP/s bf16 tensor-core peak,
// 40 us at 3.35 TB/s. Keeping p.v float32 (below) adds half again to the
// tensor-core work. Two kernels share the contract:
//
// * flash_attention_wgmma_kernel (bfloat16, 16-byte aligned rows: every
//   contiguous layout, so the serve path) is built for Hopper: TMA loads
//   into a shared-memory ring, a producer warpgroup and two consumer
//   warpgroups, both products on wgmma (float32 accumulate). Its design
//   notes are with it, below.
// * flash_attention_kernel (float32, or bfloat16 through unaligned strides)
//   runs float32 FMAs on the CUDA cores (67 TFLOP/s peak): exact float32
//   where the tensor cores would round to TF32.
//
// Shared design: one block per (query tile, head, batch). The block walks
// the key tiles inside the causal/window band (tiles wholly outside it are
// skipped). Key rows at or past Skv are never read: they are zero in shared
// memory and masked. Masked scores are -inf and give p = 0 exactly, so a
// tile in which a row has no valid key leaves its state untouched (the
// Pallas kernel instead accumulates garbage there that the first valid tile
// multiplies by exp(-1e30 - m) = 0: the same result). A row with no valid
// key at all gets o = 0.
//
// CUDA-core kernel: K is staged transposed and everything as float32. Each
// thread owns a TR x TC patch of the score tile and the matching TR rows x
// D/8 columns of the accumulator; the CG = 8 threads that share rows are
// neighbouring lanes and reduce the row max and row sum with warp shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BKV = 32;          // keys per tile
constexpr int TR = 4;            // score-tile rows per thread
constexpr int TC = 4;            // score-tile keys per thread
constexpr int CG = BKV / TC;     // threads sharing a row group (8 lanes)
constexpr int PAD = 4;           // floats of padding per transposed row

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, G, Sq, Skv;
  int causal, window, q_offset;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool keep(const Args& a, int qpos, int kpos) {
  bool ok = kpos < a.Skv;
  if (a.causal) ok = ok && qpos >= kpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok;
}

template <int D, int BQ>
constexpr int smem_floats() {
  return D * (BQ + PAD) + D * (BKV + PAD) + BKV * D + BQ * (BKV + PAD);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__((BQ / TR) * CG)
flash_attention_kernel(const Args a) {
  constexpr int NT = (BQ / TR) * CG;
  constexpr int QS = BQ + PAD;     // row stride of Qt (D rows of BQ)
  constexpr int KS = BKV + PAD;    // row stride of Kt (D rows of BKV) and Ps
  constexpr int DJ = D / 32;       // float4 column groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                // [D][QS]   Q tile, transposed
  float* Kt = Qt + D * QS;         // [D][KS]   K tile, transposed
  float* Vs = Kt + D * KS;         // [BKV][D]  V tile
  float* Ps = Vs + BKV * D;        // [BQ][KS]  probabilities

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x;
  const int rg = tid / CG;         // row group: rows rg*TR .. rg*TR+TR-1
  const int cg = tid % CG;         // column group

  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* og = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    Qt[d * QS + r] = q0 + r < a.Sq ? to_f32(qg[(q0 + r) * a.q_ss + d]) : 0.f;
  }

  // Key range that can hold a valid key for some row of this tile.
  const int rows = min(BQ, a.Sq - q0);
  const int qlo = a.q_offset + q0;
  const int qhi = qlo + rows - 1;
  int kend = a.Skv;
  if (a.causal) kend = min(kend, qhi + 1);
  int kbeg = 0;
  if (a.window > 0) kbeg = max(0, qlo - a.window + 1);
  kbeg = (kbeg / BKV) * BKV;

  float m[TR], l[TR], acc[TR][DJ * 4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DJ * 4; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BKV) {
    __syncthreads();               // previous tile fully consumed
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < a.Skv;
      Kt[d * KS + r] = in ? to_f32(kg[(k0 + r) * a.k_ss + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vg[(k0 + r) * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * QS + rg * TR]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * KS + cg * TC]);
      const float qv[TR] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[TC] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = qlo + rg * TR + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        s[i][j] = keep(a, qpos, k0 + cg * TC + j) ? s[i][j] * a.scale
                                                  : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float corr = 1.f, sum = 0.f;
      if (m_new != -INFINITY) {    // the row has a valid key so far
        corr = expf(m[i] - m_new);   // exp(-inf) = 0 on the first one
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          s[i][j] = expf(s[i][j] - m_new);   // masked: exp(-inf) = 0
          sum += s[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
      }
#pragma unroll
      for (int off = CG / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = m_new;
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < DJ * 4; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(&Ps[(rg * TR + i) * KS + cg * TC]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKV; kk += 4) {
      float4 pr[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        pr[i] = *reinterpret_cast<const float4*>(&Ps[(rg * TR + i) * KS + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = &Vs[(kk + t) * D + cg * 4];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + j * 32);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            const float p = t == 0 ? pr[i].x : t == 1 ? pr[i].y
                          : t == 2 ? pr[i].z : pr[i].w;
            acc[i][j * 4 + 0] = fmaf(p, vv.x, acc[i][j * 4 + 0]);
            acc[i][j * 4 + 1] = fmaf(p, vv.y, acc[i][j * 4 + 1]);
            acc[i][j * 4 + 2] = fmaf(p, vv.z, acc[i][j * 4 + 2]);
            acc[i][j * 4 + 3] = fmaf(p, vv.w, acc[i][j * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = q0 + rg * TR + i;
    if (r >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = og + r * a.o_ss;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(&orow[j * 32 + cg * 4 + c], acc[i][j * 4 + c] * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores, for Hopper (TMA ring, warp-specialised wgmma).
//
// Block = 3 warpgroups over a 128-row query tile; grid (H * B, query tiles).
// What each choice addresses:
//
// * Loads overlap the math. Warpgroup 0 is the producer: it gives up its
//   registers (setmaxnreg) and one thread issues every load, the Q tile
//   once, then the K and V tiles of the band into a ring of STAGES stages,
//   each guarded by a "full" mbarrier (the TMA's byte count) and an "empty"
//   one (one arrival per consumer warp). TMA reads q, k and v through
//   rank-4 tensor maps over (d, head, seq, batch) in the caller's strides,
//   so one kernel reads both layouts, and it zero-fills rows past Sq or Skv:
//   nothing past a sequence's end, or of a neighbouring head, is read.
// * Both products on wgmma, the only path to the tensor cores' full rate.
//   Warpgroups 1 and 2 are consumers, 64 query rows each, with raised
//   registers. S = Q.K^T is one wgmma per k16 step, both operands in shared
//   memory (128-byte swizzle, 64-byte at d 32: a d-128 or d-256 row is 2 or
//   4 column blocks that the descriptors walk). The two consumers run free:
//   one's softmax runs while the other's wgmma keep the tensor cores busy.
// * p.v float32-exact at wgmma rate: O += P.V takes P from registers (a
//   16-bit accumulator fragment is the A-operand layout), split into
//   hi = bf16(P) and lo = bf16(P - hi); both go through the tensor cores
//   into the same float32 accumulator. P keeps 16 significant bits and every
//   product with a bf16 v is exact, so p.v stays float32 to well below the
//   output's rounding, as in the Pallas kernel. V's tile (keys x d, d
//   contiguous) is the B operand in MN-major form (transpose bit set).
// * Little softmax work per score: base 2 with d^-1/2 log2(e) folded into
//   one FMA before exp2; masks only on tiles that cross the diagonal, the
//   window edge or Skv, as two compares against a row's key range; a
//   warpgroup skips the tiles in which none of its rows keeps a key.
// * No spills: K/V tiles are 128 keys at d <= 128 and 64 at d 256, which
//   keeps S, P and the 64 x d float32 accumulator within the consumers' 240
//   registers. Shared memory: Q + 2 stages of K and V, 160 KB at d 128 and
//   192 KB at d 256 (one block per SM).
// * No causal tail: query tiles run in descending order, so the longest
//   causal tiles start first and the short ones fill the end.
// * No driver call per launch: the shared-memory limit is raised once per
//   device; the tensor maps are encoded on the host at each launch.
// * Epilogue: normalise, round once to bfloat16, stage the rows in the
//   warpgroup's own part of the Q tile and store them with 16-byte stores,
//   the ragged last tile masked.
// Needs 16-byte aligned rows (strides multiples of 8 elements) and Skv > 0;
// the launcher sends anything else to the CUDA-core kernel above.
// ---------------------------------------------------------------------------

constexpr int WQ = 128;            // query rows per block
constexpr int WTHREADS = 384;      // producer + two consumer warpgroups
constexpr int STAGES = 2;          // K/V ring depth
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240; // 128 x (24 + 2 x 240) <= 65536

template <int D>
struct Tile {
  static constexpr int BN = D == 256 ? 64 : 128;   // keys per K/V tile
  static constexpr int CB = D < 64 ? D : 64;       // elements per swizzle row
  static constexpr int SW = 2 * CB;                // swizzle row, bytes
  static constexpr int SWZ = hopper::swizzle_mode(SW);
  static constexpr int Q_BYTES = WQ * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;      // one K or V tile
  // 1024 for aligning the tiles, then Q, the K ring, the V ring and the
  // barriers (Q, STAGES full, STAGES empty)
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

struct WArgs {
  void* o;
  long long o_sb, o_ss, o_sh;
  int H, G, Sq, Skv;
  int causal, window, q_offset;
  float scale_log2;                // d^-1/2 * log2(e)
  int qpos[3], kpos[3], vpos[3];   // tensor-map dimension of head, seq, batch
};

// The rows [row, row + ROWS) of (head, batch) as D / CB column blocks.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          const int (&pos)[3], uint32_t dst,
                                          uint32_t bar, int head, int row,
                                          int b) {
  using T = Tile<D>;
  int c[3];
#pragma unroll
  for (int d = 1; d <= 3; ++d)
    c[d - 1] = pos[0] == d ? head : pos[1] == d ? row : b;
#pragma unroll
  for (int cb = 0; cb < D / T::CB; ++cb)
    hopper::tma_load_4d(dst + cb * ROWS * T::SW, map, bar, cb * T::CB, c[0],
                        c[1], c[2]);
}

// Byte offset of (row, col) in a tile of `rows` rows stored as swizzled
// column blocks (the TMA layout).
template <int D>
__device__ __forceinline__ int tile_offset(int rows, int row, int col) {
  using T = Tile<D>;
  return (col / T::CB) * rows * T::SW + row * T::SW +
         ((((col % T::CB) / 8) ^ (row % (T::SW / 16))) * 16) + (col % 8) * 2;
}

// S = Q.K^T for the warpgroup's 64 query rows (at `qa` in the Q tile) and
// the key tile at `kt`: one wgmma per k16 step, both operands K-major.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<D>::BN / 2],
                                         uint32_t qa, uint32_t kt) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk * 16 / T::CB, kin = (kk * 16 % T::CB) * 2;
    hopper::wgmma_ss<T::BN>(
        sc, hopper::smem_desc(qa + cb * WQ * T::SW + kin, 16, 8 * T::SW,
                              T::SWZ),
        hopper::smem_desc(kt + cb * T::BN * T::SW + kin, 16, 8 * T::SW,
                          T::SWZ),
        kk > 0);
  }
}

// O += P.V for the value tile at `vt` (MN-major B): per k16 step of keys,
// the hi and then the lo term of P.
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&ph)[Tile<D>::BN / 16][4],
    const uint32_t (&pl)[Tile<D>::BN / 16][4], uint32_t vt) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < T::BN / 16; ++kk) {
    const uint64_t dv = hopper::smem_desc(vt + kk * 16 * T::SW,
                                          T::BN * T::SW, 8 * T::SW, T::SWZ);
    hopper::wgmma_rs_tb<D>(o, ph[kk], dv);
    hopper::wgmma_rs_tb<D>(o, pl[kk], dv);
  }
}

// One online-softmax step on a finished score tile, in place (scores ->
// p), for the thread's rows qp0 and qp1 = qp0 + 8: sc[4j + e] is (qp0, key
// k0 + 8j + 2 (lane % 4) + e), sc[4j + 2 + e] the same key for qp1. Updates
// the running max m (base 2: scores times d^-1/2 log2 e) and sum l, and
// returns in corr the factor by which o must be scaled.
template <int BN>
__device__ __forceinline__ void softmax_step(
    float (&sc)[BN / 2], const WArgs& a, int k0, int qw, int qp0, int lane,
    float (&m)[2], float (&l)[2], float (&corr)[2]) {
  const int qp1 = qp0 + 8;
  // Only a tile that crosses the diagonal, the window edge or Skv is
  // masked: a key outside a row's [lo, hi) (relative to the thread's first
  // key) scores -inf.
  if (k0 + BN > a.Skv || (a.causal && k0 + BN - 1 > qw) ||
      (a.window > 0 && qw + 63 - k0 >= a.window)) {
    const int c0 = k0 + 2 * (lane % 4);
    const int hi0 = (a.causal ? min(a.Skv, qp0 + 1) : a.Skv) - c0;
    const int hi1 = (a.causal ? min(a.Skv, qp1 + 1) : a.Skv) - c0;
    const int lo0 = a.window > 0 ? qp0 - a.window + 1 - c0 : -1;
    const int lo1 = a.window > 0 ? qp1 - a.window + 1 - c0 : -1;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + e;
        if (c < lo0 || c >= hi0) sc[4 * j + e] = -INFINITY;
        if (c < lo1 || c >= hi1) sc[4 * j + 2 + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  // exp2_ftz flushes results below 2^-126 to 0, which p and the
  // correction factor can take (they are summed against a row max of 1).
  float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * a.scale_log2);
    // A row with no valid key so far subtracts 0 instead of -inf: its p
    // are exp2(-inf) = 0 and its correction 0 keeps o = l = 0.
    ms[r] = mn == -INFINITY ? 0.f : mn;
    corr[r] = hopper::exp2_ftz(m[r] - ms[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] =
          hopper::exp2_ftz(fmaf(sc[4 * j + e], a.scale_log2, -ms[e / 2]));
      sum[e / 2] += sc[4 * j + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

// o *= corr row by row, then P (the finished p tile) -> its A fragments
// for keys 16 kk .. 16 kk + 15, hi and lo terms.
template <int D>
__device__ __forceinline__ void rescale_and_split(
    float (&o)[D / 2], const float (&corr)[2],
    const float (&sc)[Tile<D>::BN / 2], uint32_t (&ph)[Tile<D>::BN / 16][4],
    uint32_t (&pl)[Tile<D>::BN / 16][4]) {
#pragma unroll
  for (int n = 0; n < D / 2; ++n) o[n] *= corr[(n / 2) % 2];
#pragma unroll
  for (int kk = 0; kk < Tile<D>::BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      hopper::split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ph[kk][r],
                 pl[kk][r]);
}

template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const WArgs a) {
  using T = Tile<D>;
  constexpr int BN = T::BN, SW = T::SW;
  extern __shared__ unsigned char smem_w[];
  const uint32_t raw = hopper::smem_u32(smem_w);
  const uint32_t sq = (raw + 1023u) & ~1023u;             // Q tile
  const uint32_t sk = sq + T::Q_BYTES;                    // K ring
  const uint32_t sv = sk + STAGES * T::KV_BYTES;          // V ring
  const uint32_t bar_q = sv + STAGES * T::KV_BYTES;       // Q landed
  const uint32_t bar_full = bar_q + 8;                    // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;       // + 8 s

  const int nq = (a.Sq + WQ - 1) / WQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * WQ;        // longest first
  const int h = blockIdx.x % a.H, b = blockIdx.x / a.H, hk = h / a.G;
  const int qlo = a.q_offset + q0;
  int kend = a.Skv;
  if (a.causal) kend = min(kend, qlo + min(WQ, a.Sq - q0));
  int kbeg = 0;
  if (a.window > 0) kbeg = max(0, qlo - a.window + 1);
  kbeg = (kbeg / BN) * BN;
  const int ntiles = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(bar_full + 8 * s, 1);
      hopper::mbar_init(bar_empty + 8 * s, 8);   // the 8 consumer warps
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup's role, warp-uniform as the compiler can see (which
  // setmaxnreg needs to take effect).
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0 && ntiles > 0) {
      hopper::prefetch_tensormap(&tq);
      hopper::prefetch_tensormap(&tk);
      hopper::prefetch_tensormap(&tv);
      hopper::mbar_arrive_expect_tx(bar_q, T::Q_BYTES);
      load_tile<D, WQ>(&tq, a.qpos, sq, bar_q, h, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)      // the consumers released this stage's last use
          hopper::mbar_wait(bar_empty + 8 * s, (i / STAGES - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        hopper::mbar_arrive_expect_tx(full, 2 * T::KV_BYTES);
        const int k0 = kbeg + i * BN;
        load_tile<D, BN>(&tk, a.kpos, sk + s * T::KV_BYTES, full, hk, k0, b);
        load_tile<D, BN>(&tv, a.vpos, sv + s * T::KV_BYTES, full, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = q0 + 64 * cw;                  // the warpgroup's first row
    const int qw = a.q_offset + r0;               // and its position
    const int qp0 = qw + 16 * warp + lane / 4;    // the thread's first row
    const bool live = r0 < a.Sq;
    const uint32_t qa = sq + 64 * cw * SW;        // its rows of the Q tile

    // Tiles [ib, ie) of the block's band keep a key for some row of this
    // warpgroup; it only waits for and releases the others (in order, as
    // the ring's phases need).
    int ib = 0, ie = live ? ntiles : 0;
    if (live && a.causal) {
      const int t = qw + 63 - kbeg;
      ie = t < 0 ? 0 : min(ie, t / BN + 1);
    }
    if (live && a.window > 0) {
      const int t = qw - a.window - BN + 2 - kbeg;
      ib = t > 0 ? (t + BN - 1) / BN : 0;
    }
    ib = min(ib, ie);

    float o[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) o[n] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    if (ntiles > 0) hopper::mbar_wait(bar_q, 0);

    for (int i = 0; i < ntiles; ++i) {
      const int s = i % STAGES;
      hopper::mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
      if (ib <= i && i < ie) {
        float sc[BN / 2];
        hopper::wgmma_fence();
        issue_qk<D>(sc, qa, sk + s * T::KV_BYTES);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(sc);
        softmax_step<BN>(sc, a, kbeg + i * BN, qw, qp0, lane, m, l, corr);
        uint32_t ph[BN / 16][4], pl[BN / 16][4];
        rescale_and_split<D>(o, corr, sc, ph, pl);
        hopper::fence_operand(o);
        hopper::wgmma_fence();
        issue_pv<D>(o, ph, pl, sv + s * T::KV_BYTES);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(o);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar_empty + 8 * s);
    }
    if (!live) return;

    // Epilogue: o / l rounded once to bf16, staged in this warpgroup's rows
    // of the Q tile (no longer read), then 16-byte stores of the valid rows.
    const float inv0 = 1.f / fmaxf(l[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l[1], 1e-30f);
    unsigned char* qs = smem_w + (sq - raw);
    const int rr = 64 * cw + 16 * warp + lane / 4;
    hopper::fence_proxy_async();
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(qs + tile_offset<D>(WQ, rr, col)) =
          __floats2bfloat162_rn(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      *reinterpret_cast<__nv_bfloat162*>(qs +
                                         tile_offset<D>(WQ, rr + 8, col)) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
    hopper::named_sync(1 + cw, 128);
    __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                        h * a.o_sh;
    for (int idx = tid; idx < 64 * (D / 8); idx += 128) {
      const int r = idx / (D / 8), col = 8 * (idx % (D / 8));
      if (r0 + r < a.Sq)
        *reinterpret_cast<uint4*>(og + (r0 + r) * a.o_ss + col) =
            *reinterpret_cast<const uint4*>(
                qs + tile_offset<D>(WQ, 64 * cw + r, col));
    }
  }
}

template <int D>
int launch_wgmma(const Args& a, int B, int KV, cudaStream_t stream) {
  using T = Tile<D>;
  static bool ready[hopper::kMaxDevices] = {};
  cudaError_t err =
      hopper::allow_smem(flash_attention_wgmma_kernel<D>, T::SMEM, ready);
  if (err != cudaSuccess) return (int)err;
  WArgs w{a.o, a.o_sb, a.o_ss, a.o_sh, a.H, a.G, a.Sq, a.Skv,
          a.causal, a.window, a.q_offset,
          (float)(1.4426950408889634 / sqrt((double)D)), {}, {}, {}};
  CUtensorMap tq, tk, tv;
  const long long qext[3] = {a.H, a.Sq, B}, kext[3] = {KV, a.Skv, B};
  const long long qst[3] = {a.q_sh, a.q_ss, a.q_sb};
  const long long kst[3] = {a.k_sh, a.k_ss, a.k_sb};
  const long long vst[3] = {a.v_sh, a.v_ss, a.v_sb};
  int rc = hopper::make_tensor_map_4d(&tq, a.q, D, qext, qst, 1, T::CB, WQ,
                                      w.qpos);
  if (rc == 0)
    rc = hopper::make_tensor_map_4d(&tk, a.k, D, kext, kst, 1, T::CB, T::BN,
                                    w.kpos);
  if (rc == 0)
    rc = hopper::make_tensor_map_4d(&tv, a.v, D, kext, vst, 1, T::CB, T::BN,
                                    w.vpos);
  if (rc != 0) return rc;
  dim3 grid(a.H * B, (a.Sq + WQ - 1) / WQ);
  flash_attention_wgmma_kernel<D><<<grid, WTHREADS, T::SMEM, stream>>>(
      tq, tk, tv, w);
  return (int)cudaGetLastError();
}

int launch_wgmma_d(const Args& a, int B, int KV, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_wgmma<32>(a, B, KV, stream);
    case 64: return launch_wgmma<64>(a, B, KV, stream);
    case 128: return launch_wgmma<128>(a, B, KV, stream);
    case 256: return launch_wgmma<256>(a, B, KV, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D, int BQ>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, BQ>() * (int)sizeof(float);
  static bool ready[hopper::kMaxDevices] = {};
  cudaError_t err =
      hopper::allow_smem(flash_attention_kernel<T, D, BQ>, bytes, ready);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_attention_kernel<T, D, BQ><<<grid, (BQ / TR) * CG, bytes, stream>>>(
      a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32, 64>(a, B, stream);
    case 64: return launch<T, 64, 64>(a, B, stream);
    case 128: return launch<T, 128, 64>(a, B, stream);
    case 256: return launch<T, 256, 32>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() (or cudaErrorInvalidValue for an unsupported head_dim
// or dtype); the Python wrapper raises when it is not 0. Strides are in
// elements; dtype 0 = float32, 1 = bfloat16. tensor_cores = 1 (bfloat16
// only, every row 16-byte aligned) takes the wgmma kernel when there is at
// least one key, otherwise the CUDA-core kernel runs.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int B, int H, int KV, int Sq, int Skv, int D, int dtype,
    int causal, int window, int q_offset, int tensor_cores, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
         v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
         H, H / KV, Sq, Skv, causal, window, q_offset,
         (float)(1.0 / sqrt((double)D))};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(a, B, D, s);
  if (dtype == 1 && tensor_cores && Skv > 0)
    return launch_wgmma_d(a, B, KV, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}
