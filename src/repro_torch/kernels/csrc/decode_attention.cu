// Split-K decode attention over a fixed-size KV buffer, read only up to each
// slot's position.
//
// Replaces no Pallas kernel. The JAX package decodes through plain einsums
// (repro.models.model._gqa_decode_buffered -> chunked_attention), and the
// port did the same until this kernel: it cast the whole bf16 buffer to
// float32, permuted K and V into copies for two batched M = 1 products, and
// masked the positions past each slot's depth after reading them. For
// every slot b, KV head c and query head h = c * G + g it computes
//
//   o[b,0,h,:] = softmax_j( q[b,0,h,:] . k[b,j,c,:] * D^-1/2 ) v[b,j,c,:]
//
// over the keys j < hi_b = min(pos_b + 1, S). pos is one shared position
// (stride 0) or one per slot, read on the device: no host sync, so one
// launch serves eager steps and the decode graph's replays alike. It takes
// no window: a windowed cache decodes through its own rolling buffer.
//
// Inputs are float32 or bfloat16 (q, k, v and o of one type), head_dim D in
// {32, 64, 128}, G = H / KV up to 8, addressed through element strides
// with the head_dim contiguous and every K/V row 16-byte aligned. Scores,
// the softmax and the p.v sums are float32; o is rounded to the input type
// once. A slot with no key at all (pos < 0) gets o = 0.
//
// What bounds it on an H100: bytes. Each filled K/V row is read once, in
// its own type: at olmoe-1b-7b chat's mean depth (482 of 1,537 positions,
// 64 slots, 16 KV heads of 128, bf16) that is 252 MB a layer, 75 us at
// 3.35 TB/s; the partials add 0.2% to it.
//
// Design:
// * Split-K. Grid (B * KV, ceil(S / SPLIT)); block (b, c, s) takes the
//   keys [s*SPLIT, min(hi_b, (s+1)*SPLIT)) and exits at once
//   when that is empty, so a slot's blocks stop at its depth and the grid
//   stays fixed for a buffer (a graph replays it at any position). One
//   block serves all G query heads of its KV head: each K/V row is read
//   once for the group.
// * Loads. K and then V tiles of 16 KB (SPLIT / ROWS of each) go through a
//   two-stage ring in shared memory by 16-byte cp.async copies,
//   neighbouring threads on neighbouring 16 bytes of a row; the next tile
//   is in flight while the block works on the current one, and the first V
//   tile while the softmax runs.
// * Work. LPR = min(D / VEC, 32) neighbouring lanes share a row (VEC
//   elements of 16 bytes each); the threads' RG = 128 / LPR row groups walk
//   a tile's rows. Scores: each lane's float32 products with the G
//   pre-scaled query heads (in registers), summed over the row's lanes by a
//   butterfly of shuffles, kept in shared memory for the split. Softmax: a
//   warp per head over the split's scores. p.v: each lane keeps G x EPL
//   float32 sums over its row group's rows; at the end a butterfly over the
//   warp's row groups and a sum over the four warps, in a fixed order.
// * Combine. decode_attention_combine_kernel, one block per (b, h), merges
//   the valid splits' (max, sum, p.v) in ascending split order: no atomics,
//   so two launches are bitwise equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 256;          // keys per block
constexpr int TILE_BYTES = 16384;   // one K or V tile
constexpr int STAGES = 2;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_o;    // (B * KV, n_splits, G, D)
  float* part_ml;   // (B * KV, n_splits, G, 2): max and sum of exp
  const long long* pos;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  long long pos_stride;
  int H, KV, G, S, n_splits;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
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

// The number of keys slot b attends to: [0, hi).
__device__ __forceinline__ int key_end(const Args& a, int b) {
  const long long p = a.pos[b * a.pos_stride];
  const long long h = p + 1 < a.S ? p + 1 : a.S;
  return (int)(h > 0 ? h : 0);
}

// 16 bytes of T widened to float32.
__device__ __forceinline__ void widen(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, float* f,
                                      __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D, int GM>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const Args a) {
  constexpr int VEC = 16 / (int)sizeof(T);      // elements per 16 bytes
  constexpr int CH = D / VEC;                   // 16-byte chunks per row
  constexpr int LPR = CH < 32 ? CH : 32;        // lanes per row
  constexpr int CPL = CH / LPR;                 // chunks per lane
  constexpr int EPL = CPL * VEC;                // elements per lane
  constexpr int RG = THREADS / LPR;             // row groups
  constexpr int ROWS = TILE_BYTES / (D * (int)sizeof(T));
  static_assert(SPLIT % ROWS == 0 && ROWS % RG == 0, "tile shape");
  static_assert(WARPS * GM * D * 4 <= STAGES * TILE_BYTES, "reduce buffer");

  __shared__ __align__(16) unsigned char tiles[STAGES][TILE_BYTES];
  __shared__ float sc[GM][SPLIT];
  __shared__ float ml[GM][2];

  const int bc = blockIdx.x, b = bc / a.KV, c = bc % a.KV;
  const int start = (int)blockIdx.y * SPLIT;
  const int end = min(key_end(a, b), start + SPLIT);
  if (start >= end) return;
  const int n = end - start, nt = (n + ROWS - 1) / ROWS;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int l = tid % LPR, rg = tid / LPR;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + c * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + c * a.v_sh;
  // Tile i < nt holds K rows, tile nt + i the same V rows.
  auto load_tile = [&](int i) {
    const bool is_k = i < nt;
    const int t0 = (is_k ? i : i - nt) * ROWS;
    const int rows = min(ROWS, n - t0);
    const long long ss = is_k ? a.k_ss : a.v_ss;
    const T* src = (is_k ? kb : vb) + (start + t0) * ss;
    unsigned char* dst = tiles[i % STAGES];
    for (int x = tid; x < rows * CH; x += THREADS)
      cp_async16(dst + 16 * x, src + (x / CH) * ss + (x % CH) * VEC);
  };

  // The lane's query elements, pre-scaled; chunk j of the lane is the
  // row's chunk j * LPR + l.
  float qr[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const T* qg = static_cast<const T*>(a.q) + b * a.q_sb +
                  (c * a.G + min(g, a.G - 1)) * a.q_sh;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qr[g][j * VEC + e] =
            to_float(qg[(j * LPR + l) * VEC + e]) * a.scale;
  }

  load_tile(0);
  cp_async_commit();
  for (int i = 0; i < nt; ++i) {
    load_tile(i + 1);          // the next K tile, or the first V tile
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* tile = tiles[i % STAGES];
    const int t0 = i * ROWS, rows = min(ROWS, n - t0);
    for (int r0 = 0; r0 < rows; r0 += RG) {  // uniform trip count: shuffles
      const int r = r0 + rg;
      float kf[EPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        widen(*reinterpret_cast<const uint4*>(
                  tile + 16 * (r * CH + j * LPR + l)),
              kf + j * VEC, T());
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) s[g] = fmaf(qr[g][e], kf[e], s[g]);
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off /= 2)
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] += __shfl_xor_sync(FULL, s[g], off);
      if (r < rows && l == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < a.G) sc[g][t0 + r] = s[g];
      }
    }
    __syncthreads();
  }

  // Softmax over the split's keys, a warp per head: p in place of s.
  for (int g = warp; g < a.G; g += WARPS) {
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, sc[g][t]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(sc[g][t] - m);
      sc[g][t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(FULL, sum, off);
    if (lane == 0) {
      ml[g][0] = m;
      ml[g][1] = sum;
    }
  }
  __syncthreads();

  float acc[GM][EPL];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  for (int i = nt; i < 2 * nt; ++i) {
    if (i + 1 < 2 * nt) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* tile = tiles[i % STAGES];
    const int t0 = (i - nt) * ROWS, rows = min(ROWS, n - t0);
    for (int r = rg; r < rows; r += RG) {
      float vf[EPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        widen(*reinterpret_cast<const uint4*>(
                  tile + 16 * (r * CH + j * LPR + l)),
              vf + j * VEC, T());
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = g < a.G ? sc[g][t0 + r] : 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();
  }

  // Sum over the warp's row groups, then over the warps, in a fixed order.
#pragma unroll
  for (int off = LPR; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], off);
  float* red = reinterpret_cast<float*>(&tiles[0][0]);   // (WARPS, GM, D)
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int j = 0; j < CPL; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          red[(warp * GM + g) * D + (j * LPR + l) * VEC + e] =
              acc[g][j * VEC + e];
  }
  __syncthreads();
  const long long part = (long long)bc * a.n_splits + blockIdx.y;
  float* po = a.part_o + part * a.G * D;
  for (int x = tid; x < a.G * D; x += THREADS) {
    const int g = x / D, d = x % D;
    float s = red[g * D + d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[(w * GM + g) * D + d];
    po[x] = s;
  }
  if (tid < a.G) {
    a.part_ml[(part * a.G + tid) * 2] = ml[tid][0];
    a.part_ml[(part * a.G + tid) * 2 + 1] = ml[tid][1];
  }
}

// One block per (b, h), a thread per output element: the valid splits'
// partials merged in ascending split order.
template <typename T, int D>
__global__ void __launch_bounds__(D)
    decode_attention_combine_kernel(const Args a) {
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int c = h / a.G, g = h % a.G, d = threadIdx.x;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + d;
  const int hi = key_end(a, b);
  if (hi == 0) {
    store(o, 0.f);
    return;
  }
  const int s1 = (hi - 1) / SPLIT;
  const long long part0 = (long long)(b * a.KV + c) * a.n_splits;
  float m = -INFINITY;
  for (int s = 0; s <= s1; ++s)
    m = fmaxf(m, a.part_ml[((part0 + s) * a.G + g) * 2]);
  float sum = 0.f, acc = 0.f;
  for (int s = 0; s <= s1; ++s) {
    const long long i = (part0 + s) * a.G + g;
    const float w = expf(a.part_ml[2 * i] - m);
    sum = fmaf(w, a.part_ml[2 * i + 1], sum);
    acc = fmaf(w, a.part_o[i * D + d], acc);
  }
  store(o, acc / sum);
}

template <typename T, int D, int GM>
int launch(const Args& a, int B, cudaStream_t stream) {
  decode_attention_kernel<T, D, GM>
      <<<dim3(B * a.KV, a.n_splits), THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_attention_combine_kernel<T, D><<<B * a.H, D, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const Args& a, int B, cudaStream_t stream) {
  if (a.G == 1) return launch<T, D, 1>(a, B, stream);
  if (a.G == 2) return launch<T, D, 2>(a, B, stream);
  if (a.G <= 4) return launch<T, D, 4>(a, B, stream);
  if (a.G <= 8) return launch<T, D, 8>(a, B, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch_g<T, 32>(a, B, stream);
    case 64: return launch_g<T, 64>(a, B, stream);
    case 128: return launch_g<T, 128>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Keys per split: the wrapper sizes the partials as (B * KV,
// ceil(S / split), G, D) and (B * KV, ceil(S / split), G, 2) float32.
extern "C" int decode_attention_split() { return SPLIT; }

// Launches both kernels on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape or dtype the
// kernel does not take); the Python wrapper raises when it is not 0.
// Strides are in elements; dtype 0 = float32, 1 = bfloat16; pos holds int64
// positions at stride pos_stride (0: one shared position).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* part_o,
    void* part_ml, const void* pos, long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_sh,
    long long pos_stride, int B, int H, int KV, int S, int D, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o,
         static_cast<float*>(part_o), static_cast<float*>(part_ml),
         static_cast<const long long*>(pos),
         q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
         pos_stride, H, KV, H / KV, S, (S + SPLIT - 1) / SPLIT,
         (float)(1.0 / sqrt((double)D))};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(a, B, D, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, B, D, s);
  return (int)cudaErrorInvalidValue;
}
