// Mamba-2 SSD chunked scan (state-space duality), one block per
// (batch, head).
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
// bf16 tensor-core peak. This first version runs float32 FMAs on the CUDA
// cores from shared memory and recomputes the scores per head (simple
// and right first); sharing C B^T across heads and moving the products to
// the tensor cores come later.
//
// Layout of the work: 256 threads, thread (ty, tx) = (tid / 16, tid % 16)
// owns rows ty + 16 r and columns tx + 16 c of each tile it computes. The
// state lives in shared memory (PM x NM floats). P and N are padded at
// run time up to the template's PM, NM in {64, 128} with zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
  const size_t smem = smem_bytes<PM, NM>(a.Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<E, PM, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<E, PM, NM><<<dim3(a.H, B), NTHREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename E>
int dispatch(const Args& a, int B, cudaStream_t stream) {
  if (a.P <= 64 && a.N <= 64) return launch<E, 64, 64>(a, B, stream);
  if (a.P <= 64) return launch<E, 64, 128>(a, B, stream);
  if (a.N <= 64) return launch<E, 128, 64>(a, B, stream);
  return launch<E, 128, 128>(a, B, stream);
}

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
