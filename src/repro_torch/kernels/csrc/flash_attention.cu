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
// 134 MB of q/k/v/o: 104 us at the 989 TFLOP/s bf16 tensor-core peak,
// 40 us at 3.35 TB/s. Two kernels share the contract:
//
// * flash_attention_mma_kernel (bfloat16, 16-byte aligned rows: every
//   contiguous layout, so the serve path) runs both products on the tensor
//   cores with mma.sync (m16n8k16, float32 accumulate). It is the main
//   path's kernel; wgmma, TMA and warp specialisation are later work.
// * flash_attention_kernel (float32, or bfloat16 through unaligned strides)
//   runs float32 FMAs on the CUDA cores (67 TFLOP/s peak): exact float32
//   where the tensor cores would round to TF32.
//
// Shared design (simple and right first): grid (ceil(Sq/BQ), H, B), one
// block per (query tile, head, batch). The block stages its Q tile once,
// then walks the key tiles inside the causal/window band (tiles wholly
// outside it are skipped), staging each K and V tile in shared memory. Key
// rows at or past Skv are never loaded: they are stored as 0 and masked.
// Masked scores are -inf and give p = 0 exactly, so a tile in which a row
// has no valid key leaves its state untouched (the Pallas kernel instead
// accumulates garbage there that the first valid tile multiplies by
// exp(-1e30 - m) = 0: the same result). A row with no valid key at all gets
// o = 0.
//
// CUDA-core kernel: K is staged transposed and everything as float32. Each
// thread owns a TR x TC patch of the score tile and the matching TR rows x
// D/8 columns of the accumulator; the CG = 8 threads that share rows are
// neighbouring lanes and reduce the row max and row sum with warp shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
// bfloat16 on the tensor cores (mma.sync m16n8k16, float32 accumulate).
//
// Block = 4 warps = MBQ query rows; each warp owns 16 rows and walks the key
// tiles of the band. Q, K and V tiles sit in shared memory row-major as
// bfloat16 (rows padded by 8 elements, which makes the fragment loads
// bank-conflict free). S = Q.K^T runs on the tensor cores with bf16 x bf16
// products exact in float32. The online softmax works on the S fragments in
// registers (the 4 lanes of a quad share a row). For O += P.V, P is split
// into two bfloat16 terms, P = hi + lo with hi = bf16(P) and
// lo = bf16(P - hi), and both are multiplied: P keeps 16 significant bits
// and every product with a bf16 v is exact in float32, so p.v stays float32
// to well below the output's bfloat16 rounding, as in the Pallas kernel
// (which casts V to float32). V's B fragments come from ldmatrix.trans.
// Needs 16-byte aligned rows (strides multiples of 8 elements); the
// wrapper sends anything else to the CUDA-core kernel above.
// ---------------------------------------------------------------------------

constexpr int MBQ = 64;          // query rows per block (16 per warp)
constexpr int MBKV = 64;         // keys per tile
constexpr int MTHREADS = 128;

template <int D>
constexpr int mma_smem_bytes() {
  return (MBQ + 2 * MBKV) * (D + 8) * 2;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> packed bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi, y - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// rows r of src (row stride `ss` elements) -> dst rows of D + 8; rows at or
// past `valid` are written as zeros and never read from device memory.
template <int D, int ROWS>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, int valid) {
  constexpr int CH = D / 8;        // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += MTHREADS) {
    const int r = idx / CH, c = idx % CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) v = *reinterpret_cast<const uint4*>(src + r * ss + c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(MTHREADS)
flash_attention_mma_kernel(const Args a) {
  constexpr int ST = D + 8;        // shared row stride, elements
  constexpr int NS = MBKV / 8;     // score n-tiles per warp
  constexpr int NO = D / 8;        // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + MBQ * ST;
  __nv_bfloat16* Vs = Ks + MBKV * ST;

  const int q0 = blockIdx.x * MBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / a.G;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane / 4, tig = lane % 4;

  using bf16 = __nv_bfloat16;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  bf16* og = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;

  stage_rows<D, MBQ>(Qs, qg + q0 * a.q_ss, a.q_ss, a.Sq - q0);

  const int rows = min(MBQ, a.Sq - q0);
  const int qlo = a.q_offset + q0;
  int kend = a.Skv;
  if (a.causal) kend = min(kend, qlo + rows);
  int kbeg = 0;
  if (a.window > 0) kbeg = max(0, qlo - a.window + 1);
  kbeg = (kbeg / MBKV) * MBKV;

  const int wrow = warp * 16;               // the warp's first row
  const int qp0 = qlo + wrow + gid;         // positions of its two rows
  const int qp1 = qp0 + 8;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += MBKV) {
    __syncthreads();               // previous tile fully consumed
    stage_rows<D, MBKV>(Ks, kg + k0 * a.k_ss, a.k_ss, a.Skv - k0);
    stage_rows<D, MBKV>(Vs, vg + k0 * a.v_ss, a.v_ss, a.Skv - k0);
    __syncthreads();

    // Skip the tile for this warp when its 16 rows keep none of its keys.
    bool active = true;
    if (a.causal && k0 > qlo + wrow + 15) active = false;
    if (a.window > 0 && (qlo + wrow) - (k0 + MBKV - 1) >= a.window)
      active = false;
    if (!active) continue;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* qa = Qs + (wrow + gid) * ST + kk * 16 + tig * 2;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * ST);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * ST + 8);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bf16* kb = Ks + (j * 8 + gid) * ST + kk * 16 + tig * 2;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + tig * 2 + e;
        s[j][e] = keep(a, qp0, kpos) ? s[j][e] * a.scale : -INFINITY;
        s[j][2 + e] = keep(a, qp1, kpos) ? s[j][2 + e] * a.scale : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // A row with no valid key so far keeps p = 0 and its state (corr 1).
    const bool v0 = mn0 != -INFINITY, v1 = mn1 != -INFINITY;
    const float corr0 = v0 ? expf(m0 - mn0) : 1.f;
    const float corr1 = v1 ? expf(m1 - mn1) : 1.f;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = v0 ? expf(s[j][e] - mn0) : 0.f;        // masked: 0
        s[j][2 + e] = v1 ? expf(s[j][2 + e] - mn1) : 0.f;
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    m0 = mn0;
    m1 = mn1;
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr0;
      o[n][1] *= corr0;
      o[n][2] *= corr1;
      o[n][3] *= corr1;
    }

#pragma unroll
    for (int kk = 0; kk < MBKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      // lane's row address for ldmatrix: matrix lane/8 covers keys
      // +((lane/8)&1)*8 and columns +(lane/16)*8 of a 16x16 block
      const bf16* vrow = Vs + (kk * 16 + ((lane / 8) & 1) * 8 + lane % 8) * ST
                         + (lane / 16) * 8;
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + n * 16);
        mma_bf16(o[2 * n], hi[0], hi[1], hi[2], hi[3], bv[0], bv[1]);
        mma_bf16(o[2 * n], lo[0], lo[1], lo[2], lo[3], bv[0], bv[1]);
        mma_bf16(o[2 * n + 1], hi[0], hi[1], hi[2], hi[3], bv[2], bv[3]);
        mma_bf16(o[2 * n + 1], lo[0], lo[1], lo[2], lo[3], bv[2], bv[3]);
      }
    }
  }

  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int r0 = q0 + wrow + gid, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + tig * 2;
    if (r0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + r0 * a.o_ss + col) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(og + r1 * a.o_ss + col) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
int launch_mma(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + MBQ - 1) / MBQ, a.H, B);
  flash_attention_mma_kernel<D><<<grid, MTHREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_mma_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_mma<32>(a, B, stream);
    case 64: return launch_mma<64>(a, B, stream);
    case 128: return launch_mma<128>(a, B, stream);
    case 256: return launch_mma<256>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int D, int BQ>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, BQ>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
// only, every row 16-byte aligned) takes the mma.sync kernel, otherwise the
// CUDA-core kernel runs.
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
  if (dtype == 1 && tensor_cores) return launch_mma_d(a, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}
