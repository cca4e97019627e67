// Mamba-2 SSD chunked scan (state-space duality), two routes:
//
// * bfloat16 at P 64, N 64 or 128, a chunk that is a multiple of 64 up to
//   256, and 16-byte aligned rows (mamba2-1.3b's prefill) runs on the tensor
//   cores: three chunk-parallel kernels with wgmma products (namespace tc
//   below, with its own design notes);
// * every other call (float32, other P, N or chunk, odd strides) runs
//   ssd_scan_kernel, one block per (batch, head) on the CUDA cores,
//   described here.
//
// Replaces src/repro/kernels/ssd_scan.py:_ssd_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.ssd_scan). Inputs: x (B,S,H,P), dt (B,S,H)
// float32 (post-softplus), A (H,) float32 (negative), Bm and Cm (B,S,N),
// one group shared by all heads. For every (b, h) it walks the sequence in
// chunks of Q steps, in order, carrying the state h (P x N, float32):
//
//   cs_i   = sum_{t <= i} dt_t A                   (within the chunk)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + exp(cs_i) C_i h^T
//   h     <- exp(cs_Q) h + sum_j exp(cs_Q - cs_j) dt_j x_j (x) B_j
//
// and writes y (B,S,H,P) and the final state (B,H,P,N), both in x's type
// (float32 or bfloat16). Everything is computed in float32 and rounded
// once, as in the Pallas kernel.
//
// Where the Pallas body differs from what a GPU wants:
// * The Pallas body takes exp(cs_i - cs_j) for every (i, j) and masks
//   afterwards; above the diagonal that exponential is +inf, and a 0/1
//   mask multiply would give inf * 0 = NaN. Here entries above the
//   diagonal are never exponentiated: they are set to 0 directly.
// * The Pallas wrapper asserts S % Q == 0. Here any S works: the ragged
//   last chunk is padded inside the block with x = B = C = 0 and dt = 0,
//   which leaves y and the final state exact (decay exp(0) = 1, no input),
//   and rows past S are never stored.
// * B and C are indexed by batch only (shared across heads), never
//   repeated; x and y are read and written in their (B,S,H,P) layout
//   through strides (the Pallas wrapper transposes to (B*H, S, P) and
//   broadcasts dt to 128 lanes: TPU layout).
// * One chunk's Q x Q score tile (256 KB in float32 at Q = 256) does not
//   fit a block's shared memory, so the block tiles the chunk into T = 64
//   row tiles: for each query tile it stages C, then walks the key tiles
//   at or below the diagonal (tiles above it are skipped), staging B and x.
//
// What bounds it on an H100: bytes. At mamba2-1.3b's prefill (B 4,
// S 2048, H 64, P 64, N 128, Q 256) the function needs 2.6e10 FLOP (C B^T
// once per batch and chunk, as B and C are shared by the heads, on the
// lower triangle; M x and the two state products per head) and moves
// 1.45e8 bytes in bf16: 43 us at 3.35 TB/s, 26 us of operations at the
// bf16 tensor-core peak. This kernel runs float32 FMAs on the CUDA cores
// from shared memory and recomputes the scores per head: exact float32
// where the tensor cores would round float32 inputs to TF32.
//
// Layout of the work: 256 threads, thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty + 16 r and columns tx + 16 c of each tile it computes. The
// state lives in shared memory (PM x NM floats). P and N are padded at
// run time up to the template's PM, NM in {64, 128} with zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int T = 64;            // rows of a query / key tile
constexpr int NTHREADS = 256;
constexpr int MAX_CHUNK = 1024;

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  void* y;
  void* state;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
  int S, H, P, N, Q;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename E> __device__ __forceinline__ E from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage rows [r0, r0 + T) of a (rows x width) tile from `src` (row stride
// `ss`, contiguous along width) into `dst` (row stride `ld`), row r scaled
// by `scale[r]` (or 1); rows >= nrows and columns >= width are 0.
template <typename E, int W>
__device__ __forceinline__ void stage(float* dst, int ld, const E* src,
                                      long long ss, int r0, int nrows,
                                      int width, const float* scale) {
  for (int idx = threadIdx.x; idx < T * W; idx += NTHREADS) {
    const int i = idx / W, n = idx % W;
    const int r = r0 + i;
    float v = 0.f;
    if (r < nrows && n < width) {
      v = to_f32(src[r * ss + n]);
      if (scale) v *= scale[r];
    }
    dst[i * ld + n] = v;
  }
}

template <typename E, int PM, int NM>
__global__ void __launch_bounds__(NTHREADS)
ssd_scan_kernel(Args a) {
  constexpr int RP = PM / 16;    // y columns per thread
  constexpr int RN = NM / 16;    // state columns per thread
  constexpr int LDN = NM + 1;    // padded row strides (no bank conflicts)
  constexpr int LDP = PM + 1;
  constexpr int LDT = T + 1;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int Qpad = (a.Q + T - 1) / T * T;

  extern __shared__ float smem[];
  float* hs = smem;                   // PM x LDN  carried state
  float* cs = hs + PM * LDN;          // Qpad      cumulative log decay
  float* dts = cs + Qpad;             // Qpad      dt (0 on padding)
  float* ws = dts + Qpad;             // Qpad      exp(cs_Q - cs_j) dt_j
  float* Cs = ws + Qpad;              // T x LDN
  float* Bs = Cs + T * LDN;           // T x LDN
  float* Xs = Bs + T * LDN;           // T x LDP
  float* Ms = Xs + T * LDP;           // T x LDT

  const E* x = static_cast<const E*>(a.x) + b * a.x_sb + h * a.x_sh;
  const float* dt = a.dt + b * a.dt_sb + h * a.dt_sh;
  const E* bm = static_cast<const E*>(a.bm) + b * a.b_sb;
  const E* cm = static_cast<const E*>(a.cm) + b * a.c_sb;
  E* y = static_cast<E*>(a.y) + b * a.y_sb + h * a.y_sh;
  const float A = a.A[h];

  for (int idx = tid; idx < PM * LDN; idx += NTHREADS) hs[idx] = 0.f;

  for (int c0 = 0; c0 < a.S; c0 += a.Q) {
    const int Qc = min(a.Q, a.S - c0);          // valid rows of the chunk
    const int nt = (Qc + T - 1) / T;            // row tiles
    const int Qt = nt * T;
    const E* xc = x + c0 * a.x_ss;
    const E* bc = bm + c0 * a.b_ss;
    const E* cc = cm + c0 * a.c_ss;
    E* yc = y + c0 * a.y_ss;

    // dt and the inclusive cumsum of dt * A over the (padded) chunk: each
    // lane of warp 0 sums Qt / 32 consecutive steps, then a shuffle scan.
    __syncthreads();
    for (int t = tid; t < Qt; t += NTHREADS) {
      const float d = t < Qc ? dt[(c0 + t) * a.dt_ss] : 0.f;
      dts[t] = d;
      cs[t] = d * A;
    }
    __syncthreads();
    if (tid < 32) {
      const int L = Qt / 32;
      float run = 0.f;
      for (int k = 0; k < L; ++k) {
        run += cs[tid * L + k];
        cs[tid * L + k] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int k = 0; k < L; ++k) cs[tid * L + k] += excl;
    }
    __syncthreads();
    const float seg = cs[Qt - 1];               // = cs of the last valid row
    for (int t = tid; t < Qt; t += NTHREADS)
      ws[t] = expf(seg - cs[t]) * dts[t];

    // ---- outputs, one query tile at a time ----
    for (int qi = 0; qi < nt; ++qi) {
      __syncthreads();
      stage<E, NM>(Cs, LDN, cc, a.c_ss, qi * T, Qc, a.N, nullptr);
      __syncthreads();

      // y_inter = exp(cs_i) * C_i . h^T
      float acc[4][RP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < RP; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < NM; ++n) {
        float cv[4], hv[RP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * LDN + n];
#pragma unroll
        for (int c = 0; c < RP; ++c) hv[c] = hs[(tx + 16 * c) * LDN + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(cv[r], hv[c],
                                                         acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(cs[qi * T + ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < RP; ++c) acc[r][c] *= e;
      }

      // y_intra over the key tiles at or below the diagonal
      for (int kj = 0; kj <= qi; ++kj) {
        __syncthreads();
        stage<E, NM>(Bs, LDN, bc, a.b_ss, kj * T, Qc, a.N, nullptr);
        stage<E, PM>(Xs, LDP, xc, a.x_ss, kj * T, Qc, a.P, nullptr);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
        for (int n = 0; n < NM; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = Cs[(ty + 16 * r) * LDN + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * LDN + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[r][c] = fmaf(cv[r], bv[c],
                                                       s[r][c]);
        }
        // mask first, then the exponential (never exp of cs_i - cs_j > 0)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r, gi = qi * T + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = tx + 16 * c, gj = kj * T + j;
            float m = 0.f;
            if (gj <= gi) m = s[r][c] * expf(cs[gi] - cs[gj]) * dts[gj];
            Ms[i * LDT + j] = m;
          }
        }
        __syncthreads();
        for (int j = 0; j < T; ++j) {
          float mv[4], xv[RP];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = Ms[(ty + 16 * r) * LDT + j];
#pragma unroll
          for (int c = 0; c < RP; ++c) xv[c] = Xs[j * LDP + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(mv[r], xv[c],
                                                          acc[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = qi * T + ty + 16 * r;
        if (i >= Qc) continue;
#pragma unroll
        for (int c = 0; c < RP; ++c) {
          const int p = tx + 16 * c;
          if (p < a.P) yc[i * a.y_ss + p] = from_f32<E>(acc[r][c]);
        }
      }
    }

    // ---- state: h <- exp(seg) h + sum_j (x_j w_j) (x) B_j ----
    float hacc[RP][RN];
    const float decay = expf(seg);
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        hacc[r][c] = decay * hs[(ty + 16 * r) * LDN + tx + 16 * c];
    for (int kj = 0; kj < nt; ++kj) {
      __syncthreads();
      stage<E, NM>(Bs, LDN, bc, a.b_ss, kj * T, Qc, a.N, nullptr);
      stage<E, PM>(Xs, LDP, xc, a.x_ss, kj * T, Qc, a.P, ws);
      __syncthreads();
      for (int j = 0; j < T; ++j) {
        float xv[RP], bv[RN];
#pragma unroll
        for (int r = 0; r < RP; ++r) xv[r] = Xs[j * LDP + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < RN; ++c) bv[c] = Bs[j * LDN + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int c = 0; c < RN; ++c) hacc[r][c] = fmaf(xv[r], bv[c],
                                                         hacc[r][c]);
      }
    }
    __syncthreads();   // every reader of hs (y_inter) is done
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        hs[(ty + 16 * r) * LDN + tx + 16 * c] = hacc[r][c];
  }
  __syncthreads();

  E* st = static_cast<E*>(a.state) + ((long long)b * a.H + h) * a.P * a.N;
  for (int idx = tid; idx < a.P * a.N; idx += NTHREADS) {
    const int p = idx / a.N, n = idx % a.N;
    st[idx] = from_f32<E>(hs[p * LDN + n]);
  }
}

template <int PM, int NM>
size_t smem_bytes(int Q) {
  const int Qpad = (Q + T - 1) / T * T;
  return sizeof(float) * (size_t)(PM * (NM + 1) + 3 * Qpad + 2 * T * (NM + 1)
                                  + T * (PM + 1) + T * (T + 1));
}

template <typename E, int PM, int NM>
int launch(const Args& a, int B, cudaStream_t stream) {
  // The limit is raised once per device, to what the longest chunk needs.
  static bool ready[hopper::kMaxDevices] = {};
  cudaError_t err = hopper::allow_smem(ssd_scan_kernel<E, PM, NM>,
                                       (int)smem_bytes<PM, NM>(MAX_CHUNK),
                                       ready);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<E, PM, NM><<<dim3(a.H, B), NTHREADS,
                               smem_bytes<PM, NM>(a.Q), stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.P <= 64 && a.N <= 64) return launch<E, 64, 64>(a, B, stream);
  if (a.P <= 64) return launch<E, 64, 128>(a, B, stream);
  if (a.N <= 64) return launch<E, 128, 64>(a, B, stream);
  return launch<E, 128, 128>(a, B, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: the GPU decomposition of SSD in three
// chunk-parallel kernels, for P = 64, N in {64, 128}, a chunk Q that is a
// multiple of 64 up to 256, and 16-byte aligned rows (every pointer 16-byte
// aligned, every stride a multiple of 8 elements): mamba2-1.3b's prefill
// (P 64, N 128, Q 256; x, B and C strided views of the conv output).
//
// Replaces src/repro/kernels/ssd_scan.py:22 (_ssd_kernel), as the kernel
// above does, with the same contract: any S (a ragged last chunk padded with
// x = B = C = 0 and dt = 0, no row past S stored), every product summed in
// float32, y and the state rounded once to bf16, entries above the diagonal
// never exponentiated, no atomics (two launches are bitwise equal).
//
// What bounds it on an H100: bytes, 43.20 us at the headline (B 4, S 2048,
// H 64): 145 MB of x, B, C, y and state at 3.35 TB/s. The chunk states this
// design passes between its kernels, (B, nc, H, P, N) = 67 MB there, add
// about 4 x 67 MB of traffic: written as float32 by kernel 1 and read by
// kernel 2, written again as bf16 hi + lo planes by kernel 2 and read by
// kernel 3.
//
//   1. ssd_chunk_state_kernel, grid (chunk, head, batch), one warpgroup:
//      cs, the within-chunk cumsum of dt A (a warp scan), and the chunk's
//      own state S_c = sum_j exp(cs_Q - cs_j) dt_j x_j^T B_j (P x N, f32).
//      A = (x w)^T comes from registers, built from the staged x tile and
//      split into bf16 hi + lo; B is the chunk's B tile, MN-major (N
//      contiguous). Writes cs and dt, then S_c (staged in shared memory for
//      16-byte stores), to scratch.
//   2. ssd_state_pass_kernel, elementwise over (slice of P x N, head,
//      batch): walks the chunks in order, h = exp(cs_Q) h + S_c, writes the
//      state entering each chunk as bf16 hi and lo planes (split once here,
//      not once per query tile) and the final state.
//   3. ssd_chunk_scan_kernel, grid (64-row query tile x chunk, group of up
//      to 8 heads, batch), the longest query tiles first, two warpgroups.
//      Together they compute the score tiles G = C B^T at or below the
//      diagonal once for the group, kept in shared memory as accumulator
//      fragments; then each walks its heads of the group: M = G exp(cs_i -
//      cs_j) dt_j where j <= i and 0 above, y = exp(cs_i) C h_prev^T + M x,
//      one bf16 rounding, staged in shared memory for 16-byte stores.
//
// What each choice addresses (the faults of the CUDA-core kernel above):
// (1) float32 FMAs fed from shared memory: every product is a wgmma with
//     float32 accumulation. Operands that are not bf16 (x w, M and the
//     float32 h_prev) go as bf16 hi + lo, two products into one
//     accumulator, so each keeps 16 significant bits, as flash's P does.
// (2) scores recomputed per head: G is computed once per group of heads
//     (B and C are shared by the heads), 8 at the headline; smaller groups
//     when the call is too short to fill the SMs otherwise.
// (3) a thin, sequential grid: chunks run in parallel (2048 blocks in
//     kernel 1 and 1024 of two warpgroups in kernel 3 at the headline);
//     only the elementwise state pass walks the chunks in order.
// (4) scalar synchronous staging with converts: every tile, cs, dt and the
//     h_prev planes are copied with 16-byte cp.async, tiles straight into
//     the 128-byte swizzled layout wgmma reads (chunk c of row r at r * 128
//     + ((c ^ (r & 7)) * 16)), rows past S zero-filled, two buffers so the
//     next key tile loads during the products; each is staged once per
//     block (per head for x, cs, dt and h_prev).
// (5) a driver call per launch: each kernel's shared-memory limit is
//     raised once per device.
// Beyond these, the decay costs one exponential per row and per column of
// a tile below the diagonal instead of one per entry: there exp(cs_i -
// cs_j) = exp(cs_i - cs_m) exp(cs_m - cs_j), m the key tile's last row,
// both exponents <= 0. The diagonal tile takes one per entry (ex2.approx),
// only where j <= i.
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using hopper::exp2_ftz;
using hopper::split_bf16;

constexpr int P = 64;            // head dim of the route
constexpr int T = 64;            // rows of a query / key tile
constexpr int WG = 128;          // threads of a warpgroup
constexpr int ROW = 128;         // bytes of a swizzled row (64 bf16)
constexpr int MAXQ = 256;        // longest chunk

struct TcArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* bm;
  const bf16* cm;
  bf16* y;
  bf16* state;
  float* cs;        // (B, nc, H, 2, Q): within-chunk cumsum of dt A, dt
  float* states;    // (B, nc, H, P, N): the chunks' own states
  bf16* planes;     // (B, nc, H, 2, P, N): entering states, bf16 hi and lo
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
  int S, H, N, Q, nc;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of (row, col) in a swizzled tile of `rows` rows stored as
// column blocks of 64 elements.
__device__ __forceinline__ int swz(int rows, int row, int col) {
  return (col / 64) * rows * ROW + row * ROW +
         ((((col % 64) / 8) ^ (row & 7)) << 4) + (col % 8) * 2;
}

// Rows [r0, r0 + T) of a (rows x W) bf16 matrix at `src` (row stride `ss`
// elements, W contiguous) into the swizzled tile at `dst` (W / 64 column
// blocks of T rows); rows at or past `nrows` are zero-filled, not read.
// NT threads share the copy: those of the block (NT = its size) or of one
// warpgroup (NT = 128).
template <int W, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ss, int r0, int nrows) {
  constexpr int CPR = W / 8;     // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < T * CPR / NT; ++i) {
    const int idx = threadIdx.x % NT + i * NT;
    const int r = idx / CPR, k = idx % CPR;
    const bool in = r0 + r < nrows;
    const bf16* g = in ? src + (long long)(r0 + r) * ss + 8 * k : src;
    cp_async16(dst + (k / 8) * T * ROW + r * ROW + (((k % 8) ^ (r & 7)) << 4),
               g, in ? 16 : 0);
  }
}

// K-major operand (rows of the tile along M or N, K contiguous): the
// descriptor of k16 step kk of a tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int kk) {
  return hopper::smem_desc(tile + (kk / 4) * rows * ROW + (kk % 4) * 32, 16,
                           8 * ROW, 1);
}
// MN-major operand (T rows along K, each holding 64-element column blocks
// along N): the descriptor of k16 step kk.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return hopper::smem_desc(tile + kk * 16 * ROW, T * ROW, 8 * ROW, 1);
}

// cs[0, Q) <- its inclusive prefix sums (Q a multiple of 32), by warp 0:
// each lane sums Q / 32 consecutive steps, then a shuffle scan.
__device__ __forceinline__ void warp_scan(float* cs, int Q) {
  const int lane = threadIdx.x;
  const int L = Q / 32;
  float run = 0.f;
  for (int k = 0; k < L; ++k) {
    run += cs[lane * L + k];
    cs[lane * L + k] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  for (int k = 0; k < L; ++k) cs[lane * L + k] += excl;
}

template <int N>
struct K1 {
  static constexpr int BT = T * N * 2;   // B tile bytes
  static constexpr int XT = T * P * 2;   // x tile bytes
  static constexpr int BUF = BT + XT;    // one key tile
  static constexpr int SMEM = 1024 + 2 * BUF + 3 * MAXQ * 4;
  static_assert(P * (N + 4) * 4 <= 2 * BUF, "S_c staging fits the buffers");
};

// Kernel 1: cs and the chunk state of (chunk, head, batch).
template <int N>
__global__ void __launch_bounds__(WG)
ssd_chunk_state_kernel(const TcArgs a) {
  using K = K1<N>;
  extern __shared__ unsigned char smem_tc[];
  const uint32_t raw = hopper::smem_u32(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sb = smem_tc + (base - raw);
  float* cs = reinterpret_cast<float*>(sb + 2 * K::BUF);
  float* dts = cs + MAXQ;
  float* w = dts + MAXQ;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = c * a.Q;
  const int Qc = min(a.Q, a.S - c0);            // valid rows of the chunk
  const int nk = (Qc + T - 1) / T;               // key tiles holding them
  const bf16* xg = a.x + b * a.x_sb + c0 * a.x_ss + h * a.x_sh;
  const bf16* bg = a.bm + b * a.b_sb + c0 * a.b_ss;

  auto load_keys = [&](int kt) {
    const uint32_t buf = base + (kt & 1) * K::BUF;
    load_tile<N, WG>(buf, bg, a.b_ss, kt * T, Qc);
    load_tile<P, WG>(buf + K::BT, xg, a.x_ss, kt * T, Qc);
    cp_async_commit();
  };
  load_keys(0);

  const float A = a.A[h];
  const float* dtg = a.dt + b * a.dt_sb + c0 * a.dt_ss + h * a.dt_sh;
  for (int t = tid; t < a.Q; t += WG) {
    const float d = t < Qc ? dtg[t * a.dt_ss] : 0.f;
    dts[t] = d;
    cs[t] = d * A;
  }
  __syncthreads();
  if (tid < 32) warp_scan(cs, a.Q);
  __syncthreads();
  const float seg = cs[a.Q - 1];                 // = cs of the last valid row
  float* csg = a.cs + (((long long)b * a.nc + c) * a.H + h) * 2 * a.Q;
  for (int t = tid; t < a.Q; t += WG) {
    w[t] = expf(seg - cs[t]) * dts[t];
    csg[t] = cs[t];
    csg[a.Q + t] = dts[t];
  }

  float acc[N / 2];
#pragma unroll
  for (int n = 0; n < N / 2; ++n) acc[n] = 0.f;
  const int p0 = 16 * warp + lane / 4;           // rows p0 and p0 + 8
  const int kq = 2 * (lane % 4);                 // first key of the pair
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_keys(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    hopper::fence_proxy_async();
    __syncthreads();                             // tile kt (and w) landed
    const uint32_t buf = base + (kt & 1) * K::BUF;
    const unsigned char* xs = sb + (kt & 1) * K::BUF + K::BT;
    // A = (x w)^T for keys 16 kk .. 16 kk + 15 of the tile, hi and lo
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + (r & 1) * 8;
        const int k = 16 * kk + kq + (r >> 1) * 8;
        const float v0 =
            __bfloat162float(*reinterpret_cast<const bf16*>(xs + swz(T, k, p)))
            * w[kt * T + k];
        const float v1 = __bfloat162float(*reinterpret_cast<const bf16*>(
                             xs + swz(T, k + 1, p))) * w[kt * T + k + 1];
        split_bf16(v0, v1, ah[kk][r], al[kk][r]);
      }
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mn(buf, kk);
      hopper::wgmma_rs_tb<N>(acc, ah[kk], db);
      hopper::wgmma_rs_tb<N>(acc, al[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(acc);
    __syncthreads();                             // buffer kt & 1 is free
  }

  // S_c through the free key-tile buffers (rows padded by 4 floats), then
  // 16-byte stores of whole rows.
  constexpr int LD = N + 4;
  float* ss = reinterpret_cast<float*>(sb);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int n = 8 * j + kq;
    *reinterpret_cast<float2*>(ss + p0 * LD + n) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(ss + (p0 + 8) * LD + n) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  float* st = a.states + (((long long)b * a.nc + c) * a.H + h) * (P * N);
#pragma unroll
  for (int i = 0; i < P * N / 4 / WG; ++i) {
    const int idx = tid + i * WG;
    const int p = idx / (N / 4), n = 4 * (idx % (N / 4));
    *reinterpret_cast<float4*>(st + p * N + n) =
        *reinterpret_cast<const float4*>(ss + p * LD + n);
  }
}

// Kernel 2: four elements of the P x N state of (head, batch) per thread,
// carried across the chunks in order; the state entering chunk c > 0 goes
// to kernel 3 as bf16 hi and lo planes.
__global__ void __launch_bounds__(256) ssd_state_pass_kernel(const TcArgs a) {
  const int e = 4 * (blockIdx.x * 256 + threadIdx.x);
  const int PN = P * a.N;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long blk = (long long)b * a.nc * a.H + h;   // chunk 0's block
  const float* s = a.states + blk * PN + e;
  bf16* pl = a.planes + blk * 2 * PN + e;
  const float* seg = a.cs + blk * 2 * a.Q + a.Q - 1;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cur = *reinterpret_cast<const float4*>(s);
  for (int c = 0; c < a.nc; ++c) {
    const long long off = (long long)c * a.H;            // blocks onward
    float4 nxt = cur;
    if (c + 1 < a.nc)
      nxt = *reinterpret_cast<const float4*>(s + (off + a.H) * PN);
    const float d = expf(seg[off * 2 * a.Q]);
    if (c > 0) {
      uint2 hi, lo;
      split_bf16(hv.x, hv.y, hi.x, lo.x);
      split_bf16(hv.z, hv.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(pl + off * 2 * PN) = hi;
      *reinterpret_cast<uint2*>(pl + off * 2 * PN + PN) = lo;
    }
    hv = make_float4(fmaf(d, hv.x, cur.x), fmaf(d, hv.y, cur.y),
                     fmaf(d, hv.z, cur.z), fmaf(d, hv.w, cur.w));
    cur = nxt;
  }
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
      a.state + ((long long)b * a.H + h) * PN + e);
  out[0] = __floats2bfloat162_rn(hv.x, hv.y);
  out[1] = __floats2bfloat162_rn(hv.z, hv.w);
}

template <int N>
struct K3 {
  static constexpr int CT = T * N * 2;   // C tile bytes (and B tile, h plane)
  static constexpr int GT = T * T * 4;   // one score tile, float32 fragments
  static constexpr int XT = T * P * 2;   // x tile (and the y staging tile)
  // per warpgroup: h_prev hi and lo, two x tiles, y, then cs, dt and the
  // decay factors of the tiles below the diagonal (rows, columns)
  static constexpr int WGB = 2 * CT + 3 * XT + 4 * MAXQ * 4;
  static constexpr int SMEM = 1024 + CT + (MAXQ / T) * GT + 2 * WGB;
};

// Kernel 3: y of one 64-row query tile of (chunk, batch) for a group of
// `hb` heads. Two warpgroups: together they stage C and the key tiles' B
// and compute the score tiles G = C B^T once for the group (B and C are
// shared by the heads), kept in shared memory as accumulator fragments;
// then each walks its own heads of the group (every other one).
template <int N>
__global__ void __launch_bounds__(2 * WG, 1)
ssd_chunk_scan_kernel(const TcArgs a, int hb) {
  using K = K3<N>;
  extern __shared__ unsigned char smem_tc[];
  const int nt = a.Q / T;
  const int qt = nt - 1 - (int)blockIdx.x / a.nc;   // longest tiles first
  const int c = blockIdx.x % a.nc, b = blockIdx.z;
  const int h0 = blockIdx.y * hb, nh = min(hb, a.H - h0);
  const int c0 = c * a.Q;
  const int Qc = min(a.Q, a.S - c0);
  const int q0 = qt * T;
  if (q0 >= Qc) return;                             // all padding

  const uint32_t raw = hopper::smem_u32(smem_tc);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sb = smem_tc + (base - raw);
  const uint32_t sC = base;                         // C tile
  const uint32_t sG = sC + K::CT;                   // score tiles
  const uint32_t sW = sG + (MAXQ / T) * K::GT;      // warpgroup regions
  const float4* gs = reinterpret_cast<const float4*>(sb + K::CT);

  const int tid = threadIdx.x, wg = tid / WG, t = tid % WG;
  const int warp = t / 32, lane = t % 32;
  const bf16* bg = a.bm + b * a.b_sb + c0 * a.b_ss;
  const bf16* cg = a.cm + b * a.c_sb + c0 * a.c_ss;

  // ---- the group's score tiles: B tiles staged in the warpgroup regions
  load_tile<N, 2 * WG>(sC, cg, a.c_ss, q0, Qc);
  for (int kt = 0; kt <= qt; ++kt)
    load_tile<N, 2 * WG>(sW + kt * K::CT, bg, a.b_ss, kt * T, Qc);
  cp_async_commit();
  cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();
  for (int kt = wg; kt <= qt; kt += 2) {
    float g[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      hopper::wgmma_ss<64>(g, desc_k(sC, T, kk), desc_k(sW + kt * K::CT, T,
                                                         kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(g);
    float4* dst = reinterpret_cast<float4*>(sb + K::CT + kt * K::GT);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      dst[r * WG + t] = make_float4(g[4 * r], g[4 * r + 1], g[4 * r + 2],
                                    g[4 * r + 3]);
  }
  __syncthreads();                                  // G ready, B tiles done

  // ---- each warpgroup: its heads of the group, one after another
  const uint32_t sH = sW + wg * K::WGB;             // h_prev hi, then lo
  const uint32_t sX = sH + 2 * K::CT;               // two x tiles
  const uint32_t sCs = sX + 3 * K::XT;              // cs, then dt
  unsigned char* ys = sb + (sX - base) + 2 * K::XT; // y staging
  float* cs = reinterpret_cast<float*>(ys + K::XT);
  float* dts = cs + MAXQ;
  float* rowf = dts + MAXQ;     // [kt][i]: exp(cs_{q0+i} - cs_{m(kt)})
  float* colf = rowf + MAXQ;    // [k]: exp(cs_{m(k)} - cs_k) dt_k, k < q0
  const int i0 = q0 + 16 * warp + lane / 4;         // rows i0 and i0 + 8
  const int kq = 2 * (lane % 4);
  const int nrow = q0 + T;                          // rows of cs / dt used
  constexpr float LOG2E = 1.4426950408889634f;
  for (int hh = wg; hh < nh; hh += 2) {
    const int h = h0 + hh;
    const long long blk = ((long long)b * a.nc + c) * a.H + h;
    const bf16* xg = a.x + b * a.x_sb + c0 * a.x_ss + h * a.x_sh;
    auto load_x = [&](int kt) {
      load_tile<P, WG>(sX + (kt & 1) * K::XT, xg, a.x_ss, kt * T, Qc);
      cp_async_commit();
    };
    // cs and dt of rows [0, q0 + T), h_prev's planes and x tile 0: one group
    const float* csg = a.cs + blk * 2 * a.Q;
    for (int i = t; i < nrow / 2; i += WG) {        // 16-byte chunks
      const int arr = i / (nrow / 4), k = i % (nrow / 4);
      cp_async16(sCs + arr * MAXQ * 4 + 16 * k, csg + arr * a.Q + 4 * k, 16);
    }
    if (c > 0) {
      const bf16* pg = a.planes + blk * 2 * (P * N);
      load_tile<N, WG>(sH, pg, N, 0, P);
      load_tile<N, WG>(sH + K::CT, pg + P * N, N, 0, P);
    }
    load_x(0);
    cp_async_wait<0>();
    hopper::named_sync(1 + wg, WG);                 // cs, dt landed
    // Below the diagonal exp(cs_i - cs_k) = rowf * colf, both exponents
    // <= 0, with m(k) the last row of k's key tile: one exponential per
    // row and per column instead of one per entry.
    for (int i = t; i < qt * T + q0; i += WG) {
      if (i < qt * T) {
        const int m = (i / T) * T + T - 1;
        rowf[i] = exp2f((cs[q0 + i % T] - cs[m]) * LOG2E);
      } else {
        const int k = i - qt * T, m = (k / T) * T + T - 1;
        colf[k] = exp2f((cs[m] - cs[k]) * LOG2E) * dts[k];
      }
    }
    float acc[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) acc[n] = 0.f;
    for (int kt = 0; kt <= qt; ++kt) {
      if (kt < qt) {
        load_x(kt + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, WG);               // x tile kt, factors
      if (kt == 0 && c > 0) {                       // exp(cs_i) C h_prev^T
        hopper::fence_operand(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const uint64_t dc = desc_k(sC, T, kk);
          hopper::wgmma_ss<64>(acc, dc, desc_k(sH, P, kk), 1);
          hopper::wgmma_ss<64>(acc, dc, desc_k(sH + K::CT, P, kk), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operand(acc);
        const float e0 = expf(cs[i0]), e1 = expf(cs[i0 + 8]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j] *= e0;
          acc[4 * j + 1] *= e0;
          acc[4 * j + 2] *= e1;
          acc[4 * j + 3] *= e1;
        }
      }
      float sc[32];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 v = gs[(kt * 8 + r) * WG + t];
        sc[4 * r] = v.x;
        sc[4 * r + 1] = v.y;
        sc[4 * r + 2] = v.z;
        sc[4 * r + 3] = v.w;
      }
      // M = G exp(cs_i - cs_k) dt_k at or below the diagonal, 0 above it
      if (kt < qt) {
        const float r0f = rowf[kt * T + i0 - q0];
        const float r1f = rowf[kt * T + i0 + 8 - q0];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float cf = colf[kt * T + 8 * j + kq + e];
            sc[4 * j + e] *= r0f * cf;
            sc[4 * j + 2 + e] *= r1f * cf;
          }
      } else {                                      // the diagonal tile
        const float ci0 = cs[i0], ci1 = cs[i0 + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = kt * T + 8 * j + kq + e;
            const float ck = cs[k], dk = dts[k];
            float m0 = 0.f, m1 = 0.f;
            if (k <= i0) m0 = sc[4 * j + e] * exp2_ftz((ci0 - ck) * LOG2E) * dk;
            if (k <= i0 + 8)
              m1 = sc[4 * j + 2 + e] * exp2_ftz((ci1 - ck) * LOG2E) * dk;
            sc[4 * j + e] = m0;
            sc[4 * j + 2 + e] = m1;
          }
      }
      uint32_t mh[4][4], ml[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], mh[kk][r],
                     ml[kk][r]);
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {              // y += M x
        const uint64_t dx = desc_mn(sX + (kt & 1) * K::XT, kk);
        hopper::wgmma_rs_tb<64>(acc, mh[kk], dx);
        hopper::wgmma_rs_tb<64>(acc, ml[kk], dx);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      hopper::named_sync(1 + wg, WG);               // x tile kt & 1 free
    }

    // y rounded once to bf16, staged, then 16-byte stores of valid rows
    const int r0 = 16 * warp + lane / 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + kq;
      *reinterpret_cast<__nv_bfloat162*>(ys + swz(T, r0, col)) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ys + swz(T, r0 + 8, col)) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    hopper::named_sync(1 + wg, WG);
    bf16* yg = a.y + b * a.y_sb + (long long)(c0 + q0) * a.y_ss + h * a.y_sh;
#pragma unroll
    for (int i = 0; i < T * 8 / WG; ++i) {
      const int idx = t + i * WG;
      const int r = idx / 8, k = idx % 8;
      if (q0 + r < Qc)
        *reinterpret_cast<uint4*>(yg + r * a.y_ss + 8 * k) =
            *reinterpret_cast<const uint4*>(ys + r * ROW +
                                            ((k ^ (r & 7)) << 4));
    }
  }
}

// Heads per block of kernel 3: the most (8, 4 or 2) that still gives two
// blocks per SM (one block fits an SM), so short calls keep the SMs busy.
int heads_per_block(const TcArgs& a, int B) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles = (a.nc - 1) * (a.Q / T) +
                    (a.S - (a.nc - 1) * a.Q + T - 1) / T;   // query tiles
  int hb = 8;
  while (hb > 2 && (long long)B * tiles * ((a.H + hb - 1) / hb) < 2 * sms)
    hb /= 2;
  return hb;
}

template <int N>
int launch(const TcArgs& a, int B, cudaStream_t s) {
  static bool ready1[hopper::kMaxDevices] = {};
  static bool ready3[hopper::kMaxDevices] = {};
  cudaError_t err =
      hopper::allow_smem(ssd_chunk_state_kernel<N>, K1<N>::SMEM, ready1);
  if (err != cudaSuccess) return (int)err;
  err = hopper::allow_smem(ssd_chunk_scan_kernel<N>, K3<N>::SMEM, ready3);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_state_kernel<N><<<dim3(a.nc, a.H, B), WG, K1<N>::SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_state_pass_kernel<<<dim3((P * N / 4 + 255) / 256, a.H, B), 256, 0,
                          s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hb = heads_per_block(a, B);
  ssd_chunk_scan_kernel<N><<<dim3((a.Q / T) * a.nc, (a.H + hb - 1) / hb, B),
                             2 * WG, K3<N>::SMEM, s>>>(a, hb);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, Bm, Cm, y and state share it; dt and A
// are float32). Strides are in elements; P and N are contiguous. Returns
// the CUDA error of the launch (0 = launched).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* bm,
    const void* cm, void* y, void* state, long long x_sb, long long x_ss,
    long long x_sh, long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss, long long y_sh, int B, int S, int H,
    int P, int N, int Q, int dtype, void* stream) {
  if (P < 1 || P > 128 || N < 1 || N > 128 || Q < 1 || Q > MAX_CHUNK ||
      S < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  Args a{x,    static_cast<const float*>(dt), static_cast<const float*>(A),
         bm,   cm,    y,     state, x_sb,  x_ss,  x_sh, dt_sb, dt_ss,
         dt_sh, b_sb, b_ss,  c_sb,  c_ss,  y_sb,  y_ss, y_sh,  S,
         H,    P,     N,     Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, B, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core route (bfloat16, P = 64, N in {64, 128}, Q a multiple of
// 64 up to 256, pointers 16-byte aligned and strides multiples of 8
// elements; the Python wrapper decides). Scratch, nc = ceil(S / Q): `cs`
// (B, nc, H, 2, Q) and `states` (B, nc, H, 64, N) float32, `planes` (B, nc,
// H, 2, 64, N) bf16; after the launch `cs` holds cs and dt, `states` the
// chunks' own states.
// Returns the CUDA error of the launches (0 = launched).
extern "C" int ssd_scan_tc_launch(
    const void* x, const void* dt, const void* A, const void* bm,
    const void* cm, void* y, void* state, void* cs, void* states,
    void* planes, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long y_sb,
    long long y_ss, long long y_sh, int B, int S, int H, int N, int Q,
    void* stream) {
  if (B < 1 || S < 1 || H < 1 || (N != 64 && N != 128) || Q < 64 ||
      Q > tc::MAXQ || Q % tc::T != 0)
    return (int)cudaErrorInvalidValue;
  using tc::bf16;
  tc::TcArgs a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(A), static_cast<const bf16*>(bm),
               static_cast<const bf16*>(cm), static_cast<bf16*>(y),
               static_cast<bf16*>(state), static_cast<float*>(cs),
               static_cast<float*>(states), static_cast<bf16*>(planes),
               x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
               y_sb, y_ss, y_sh, S, H, N, Q, (S + Q - 1) / Q};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N == 64 ? tc::launch<64>(a, B, s) : tc::launch<128>(a, B, s);
}
