// The gradient of causal GQA attention (flash_attention_bwd): dQ, dK, dV.
//
// Replaces no TPU kernel: no Pallas kernel of the JAX package has a
// backward, and the JAX package trains through the jnp arm's
// chunked_attention (src/repro/models/transformer.py:246-251), whose
// gradients are XLA's. In the port a CUDA tensor takes the CUDA arm of
// attention, so training on the card needs this kernel behind the
// forward's torch.autograd.Function (kernels/flash_attention/ops.py).
//
// For every batch b, q-head h (kv-head h / G, G = Hq / Hkv), query row i
// and visible key j (j < kv_end and, when causal, j <= q_offset + i), with
// the forward's row log-sum-exp lse[b, h, i] (natural log, float32):
//
//   P[i, j]  = exp(q_i . k_j * scale - lse_i)
//   D_i      = sum_d dO[i, d] * O[i, d]                (attn_bwd_delta)
//   dS[i, j] = P[i, j] * (dO_i . v_j - D_i)
//   dV[j]    = sum_{h in group, i} P[i, j] dO_i         (attn_bwd_dkdv)
//   dK[j]    = scale * sum_{h in group, i} dS[i, j] q_i (attn_bwd_dkdv)
//   dQ[i]    = scale * sum_j dS[i, j] k_j               (attn_bwd_dq)
//
// Three launches: attn_bwd_delta_kernel (one warp a row), then the
// route's dK/dV kernel, one block per (key tile, kv-head, batch), which
// loops over the GQA group's query rows that the causal mask leaves (the
// rows r = i * G + h % G of the forward, so every q-head of the group is
// summed inside the block, with no atomics), and its dQ kernel, one block
// per (row tile, kv-head, batch), which recomputes P from lse over the
// key tiles its rows see. A row with lse = -inf (no visible key) has
// P = 0. Keys at or past kv_end get dK = dV = 0.
//
// Bound: operations. The backward does 5 products per visible pair
// (S = Q K^T, dV += P^T dO, dP = dO V^T, dQ += dS K, dK += dS^T Q), 10 hd
// operations; at granite-8b's training step (B 2, S 4096, Hq 32, hd 128,
// causal) 6.9e11 operations, 0.70 ms at the bf16 tensor-core peak. Two
// routes, by type and head dim (the wrapper's bwd_route):
//
//  * attn_bwd_dkdv_mma_kernel + attn_bwd_dq_mma_kernel -- bf16, hd <= 128,
//    the training path. mma.sync m16n8k16 on bf16 tiles staged in shared
//    memory (16-byte loads), float32 accumulators in registers: dK and dV
//    of 16 keys a warp (64 a block) over steps of 32 query rows, dQ of 16
//    rows a warp (64 a block) over steps of 32 keys. S and dP are products
//    of two row-major tiles; P and dS are rounded to bf16 as the A operand
//    of the dV, dK and dQ products, whose B operand is gathered from a
//    row-major tile, as the forward's attn_mma_kernel does for P V. S and
//    dP are computed in both kernels (14 hd operations a pair); nothing is
//    pipelined (each tile is loaded, then used). At the step's shape on an
//    H100: 14.5 ms; the first design, the CUDA-core route below, 67 ms;
//    SDPA's backward 1.7-2.0 ms.
//  * attn_bwd_dkdv_kernel + attn_bwd_dq_kernel -- float32, and bf16 above
//    hd 128: CUDA-core float32 FMAs on 64 x 64 tiles (32 x 32 above hd
//    128) staged in shared memory as float32, each thread a 4 x 4 (2 x 2)
//    register tile of the scores and 4 x hd/16 (2 x hd/16) of its dK and
//    dV rows; float32 accumulation throughout, results rounded once.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct BwdArgs {
  const void* q;     // (B, Sq, Hq, hd), last dimension contiguous
  const void* k;     // (B, Skv, Hkv, hd), last dimension contiguous
  const void* v;     // (B, Skv, Hkv, hd), last dimension contiguous
  const void* o;     // (B, Sq, Hq, hd) contiguous: the forward's output
  const void* dout;  // (B, Sq, Hq, hd) contiguous
  const float* lse;  // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq) scratch: D
  void* dq;          // (B, Sq, Hq, hd) contiguous
  void* dk;          // (B, Skv, Hkv, hd) contiguous
  void* dv;          // (B, Skv, Hkv, hd) contiguous
  int B, Sq, Skv, Hq, Hkv, hd, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, q_offset, kv_end;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr int B_THREADS = 256;  // 16 x 16 threads

// the tile of rows and of keys: 64 up to hd 128, else 32 (shared memory)
template <int HDP>
struct Tile {
  static constexpr int N = HDP <= 128 ? 64 : 32;
  static constexpr int R = N / 16;   // rows (keys) of a thread's tile
  static constexpr int W = HDP / 16;  // columns of hd a thread owns
  static constexpr int LD = HDP + 1;  // float32 row stride: no conflicts
  static constexpr int LDS = N + 1;
};

// one row of `src` (hd values, zeros past hd and for a null src) into HDP
// float32 values of shared memory; the threads of the block stride over
// the rows x columns of the tile
template <typename T, int HDP>
__device__ __forceinline__ void stage_rows(float* dst, int n_rows,
                                           const T* const* rows, int hd,
                                           int tid) {
  constexpr int LD = Tile<HDP>::LD;
  for (int e = tid; e < n_rows * HDP; e += B_THREADS) {
    const int rr = e / HDP, d = e - rr * HDP;
    const T* src = rows[rr];
    dst[rr * LD + d] = (src != nullptr && d < hd) ? to_f(src[d]) : 0.0f;
  }
}

// D = rowsum(dO * O) in float32: one warp a (batch, query, q-head) row
template <typename T>
__global__ void __launch_bounds__(B_THREADS)
    attn_bwd_delta_kernel(const BwdArgs a) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (B_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long n_rows = static_cast<long long>(a.B) * a.Sq * a.Hq;
  if (row >= n_rows) return;
  // row = (b * Sq + i) * Hq + h, the layout of O and dO
  const T* o = static_cast<const T*>(a.o) + row * a.hd;
  const T* g = static_cast<const T*>(a.dout) + row * a.hd;
  float s = 0.0f;
  for (int d = lane; d < a.hd; d += 32) s = fmaf(to_f(g[d]), to_f(o[d]), s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(~0u, s, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % a.Hq);
    const long long bi = row / a.Hq;
    const int i = static_cast<int>(bi % a.Sq);
    const int b = static_cast<int>(bi / a.Sq);
    a.delta[(static_cast<long long>(b) * a.Hq + h) * a.Sq + i] = s;
  }
}

// the block's rows r0 .. r0 + n of one (kv-head, batch): query i = r / G,
// q-head kvh * G + r % G; pointers into q (strided) and dO (contiguous),
// and the row's lse and D, into shared memory
template <typename T, int HDP>
__device__ __forceinline__ void stage_query_rows(
    const BwdArgs& a, int b, int kvh, int r0, float* sQ, float* sG,
    float* sLse, float* sDel, const T** ptrs, int tid) {
  constexpr int N = Tile<HDP>::N;
  const int R = a.Sq * a.group;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* g = static_cast<const T*>(a.dout);
  if (tid < N) {
    const int r = r0 + tid;
    if (r < R) {
      const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
      const long long st = (static_cast<long long>(b) * a.Hq + h) * a.Sq + i;
      sLse[tid] = a.lse[st];
      sDel[tid] = a.delta[st];
    } else {
      sLse[tid] = -INFINITY;
      sDel[tid] = 0.0f;
    }
  }
  // q rows first, then dO rows, through the same pointer table
  if (tid < N) {
    const int r = r0 + tid;
    const T* p = nullptr;
    if (r < R) {
      const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
      p = q + i * a.q_ss + h * a.q_sh;
    }
    ptrs[tid] = p;
  }
  __syncthreads();
  stage_rows<T, HDP>(sQ, N, ptrs, a.hd, tid);
  __syncthreads();
  if (tid < N) {
    const int r = r0 + tid;
    const T* p = nullptr;
    if (r < R) {
      const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
      p = g + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) * a.hd;
    }
    ptrs[tid] = p;
  }
  __syncthreads();
  stage_rows<T, HDP>(sG, N, ptrs, a.hd, tid);
}

// keys j0 .. j0 + nk of one (kv-head, batch) into shared memory (zeros
// past nk)
template <typename T, int HDP>
__device__ __forceinline__ void stage_key_rows(const BwdArgs& a, int b,
                                               int kvh, int j0, int nk,
                                               float* sK, float* sV,
                                               const T** ptrs, int tid) {
  constexpr int N = Tile<HDP>::N;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  if (tid < N)
    ptrs[tid] = tid < nk ? k + static_cast<long long>(j0 + tid) * a.k_ss
                         : nullptr;
  __syncthreads();
  stage_rows<T, HDP>(sK, N, ptrs, a.hd, tid);
  __syncthreads();
  if (tid < N)
    ptrs[tid] = tid < nk ? v + static_cast<long long>(j0 + tid) * a.v_ss
                         : nullptr;
  __syncthreads();
  stage_rows<T, HDP>(sV, N, ptrs, a.hd, tid);
}

// S = Q K^T and dP = dO V^T for the thread's rows ty + 16u and keys
// tx + 16v of the tile, then P and dS by the formulas above (0 where the
// pair is not visible): row r0 + row is query (r0 + row) / G
template <int HDP>
__device__ __forceinline__ void scores(const BwdArgs& a, const float* sQ,
                                       const float* sG, const float* sK,
                                       const float* sV, const float* sLse,
                                       const float* sDel, int r0, int j0,
                                       int nk, int ty, int tx,
                                       float (&p)[Tile<HDP>::R][Tile<HDP>::R],
                                       float (&ds)[Tile<HDP>::R][Tile<HDP>::R]) {
  constexpr int R = Tile<HDP>::R, LD = Tile<HDP>::LD;
  const int rows = a.Sq * a.group;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int w = 0; w < R; ++w) s[u][w] = dp[u][w] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float qv[R], gv[R], kv[R], vv[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      qv[u] = sQ[(ty + 16 * u) * LD + d];
      gv[u] = sG[(ty + 16 * u) * LD + d];
      kv[u] = sK[(tx + 16 * u) * LD + d];
      vv[u] = sV[(tx + 16 * u) * LD + d];
    }
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int w = 0; w < R; ++w) {
        s[u][w] = fmaf(qv[u], kv[w], s[u][w]);
        dp[u][w] = fmaf(gv[u], vv[w], dp[u][w]);
      }
  }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int row = ty + 16 * u, r = r0 + row;
    const float lse = sLse[row], del = sDel[row];
    const long long lim = static_cast<long long>(a.q_offset) + r / a.group;
#pragma unroll
    for (int w = 0; w < R; ++w) {
      const int c = tx + 16 * w, j = j0 + c;
      const bool vis = r < rows && c < nk && lse != -INFINITY &&
                       (!a.causal || j <= lim);
      const float pv = vis ? expf(s[u][w] * a.scale - lse) : 0.0f;
      p[u][w] = pv;
      ds[u][w] = pv * (dp[u][w] - del);
    }
  }
}

template <typename T, int HDP>
constexpr size_t dkdv_smem_bytes() {
  using Tl = Tile<HDP>;
  return sizeof(float) *
             (4 * static_cast<size_t>(Tl::N) * Tl::LD +
              2 * static_cast<size_t>(Tl::N) * Tl::LDS + 2 * Tl::N) +
         sizeof(void*) * Tl::N;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(B_THREADS)
    attn_bwd_dkdv_kernel(const BwdArgs a) {
  using Tl = Tile<HDP>;
  constexpr int N = Tl::N, R = Tl::R, W = Tl::W, LD = Tl::LD, LDS = Tl::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);  // N x LD
  float* sV = sK + N * LD;                           // N x LD
  float* sQ = sV + N * LD;                           // N x LD
  float* sG = sQ + N * LD;                           // N x LD: dO
  float* sP = sG + N * LD;                           // N x LDS
  float* sS = sP + N * LDS;                          // N x LDS: dS
  float* sLse = sS + N * LDS;                        // N
  float* sDel = sLse + N;                            // N
  const T** ptrs = reinterpret_cast<const T**>(sDel + N);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, kvh = blockIdx.y, j0 = blockIdx.x * N;
  const int nk = max(0, min(N, a.kv_end - j0));
  const int rows = a.Sq * a.group;

  float acc_k[R][W], acc_v[R][W];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int w = 0; w < W; ++w) acc_k[u][w] = acc_v[u][w] = 0.0f;

  if (nk > 0) {
    stage_key_rows<T, HDP>(a, b, kvh, j0, nk, sK, sV, ptrs, tid);
    // the first query that sees key j0 (every query without a mask)
    int r_begin = 0;
    if (a.causal) {
      const long long i0 = static_cast<long long>(j0) - a.q_offset;
      r_begin = static_cast<int>(i0 > 0 ? (i0 < a.Sq ? i0 : a.Sq) : 0) *
                a.group;
    }
    for (int r0 = r_begin; r0 < rows; r0 += N) {
      __syncthreads();  // the previous tile's sQ, sG, sP, sS are used up
      stage_query_rows<T, HDP>(a, b, kvh, r0, sQ, sG, sLse, sDel, ptrs, tid);
      __syncthreads();
      float p[R][R], ds[R][R];
      scores<HDP>(a, sQ, sG, sK, sV, sLse, sDel, r0, j0, nk, ty, tx, p, ds);
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int w = 0; w < R; ++w) {
          sP[(ty + 16 * u) * LDS + tx + 16 * w] = p[u][w];
          sS[(ty + 16 * u) * LDS + tx + 16 * w] = ds[u][w];
        }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: keys ty + 16u, columns tx + 16w
      for (int m = 0; m < N; ++m) {
        float pv[R], sv[R], gv[W], qv[W];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          pv[u] = sP[m * LDS + ty + 16 * u];
          sv[u] = sS[m * LDS + ty + 16 * u];
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          gv[w] = sG[m * LD + tx + 16 * w];
          qv[w] = sQ[m * LD + tx + 16 * w];
        }
#pragma unroll
        for (int u = 0; u < R; ++u)
#pragma unroll
          for (int w = 0; w < W; ++w) {
            acc_v[u][w] = fmaf(pv[u], gv[w], acc_v[u][w]);
            acc_k[u][w] = fmaf(sv[u], qv[w], acc_k[u][w]);
          }
      }
    }
  }

  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int j = j0 + ty + 16 * u;
    if (j >= a.Skv) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Skv + j) * a.Hkv + kvh) * a.hd;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int d = tx + 16 * w;
      if (d < a.hd) {
        dk[base + d] = from_f<T>(acc_k[u][w] * a.scale);
        dv[base + d] = from_f<T>(acc_v[u][w]);
      }
    }
  }
}

template <typename T, int HDP>
constexpr size_t dq_smem_bytes() {
  using Tl = Tile<HDP>;
  return sizeof(float) *
             (4 * static_cast<size_t>(Tl::N) * Tl::LD +
              static_cast<size_t>(Tl::N) * Tl::LDS + 2 * Tl::N) +
         sizeof(void*) * Tl::N;
}

template <typename T, int HDP>
__global__ void __launch_bounds__(B_THREADS)
    attn_bwd_dq_kernel(const BwdArgs a) {
  using Tl = Tile<HDP>;
  constexpr int N = Tl::N, R = Tl::R, W = Tl::W, LD = Tl::LD, LDS = Tl::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // N x LD
  float* sG = sQ + N * LD;                           // N x LD: dO
  float* sK = sG + N * LD;                           // N x LD
  float* sV = sK + N * LD;                           // N x LD
  float* sS = sV + N * LD;                           // N x LDS: dS
  float* sLse = sS + N * LDS;                        // N
  float* sDel = sLse + N;                            // N
  const T** ptrs = reinterpret_cast<const T**>(sDel + N);

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, kvh = blockIdx.y, r0 = blockIdx.x * N;
  const int rows = a.Sq * a.group;
  const int nr = min(N, rows - r0);

  stage_query_rows<T, HDP>(a, b, kvh, r0, sQ, sG, sLse, sDel, ptrs, tid);
  // the last key (exclusive) any row of the tile sees
  int kend = a.kv_end;
  if (a.causal) {
    const long long last =
        static_cast<long long>(a.q_offset) + (r0 + nr - 1) / a.group + 1;
    kend = static_cast<int>(last < kend ? (last > 0 ? last : 0) : kend);
  }

  float acc[R][W];
#pragma unroll
  for (int u = 0; u < R; ++u)
#pragma unroll
    for (int w = 0; w < W; ++w) acc[u][w] = 0.0f;

  for (int j0 = 0; j0 < kend; j0 += N) {
    const int nk = min(N, kend - j0);
    __syncthreads();  // sK, sV, sS are used up (first: the rows staged)
    stage_key_rows<T, HDP>(a, b, kvh, j0, nk, sK, sV, ptrs, tid);
    __syncthreads();
    float p[R][R], ds[R][R];
    scores<HDP>(a, sQ, sG, sK, sV, sLse, sDel, r0, j0, nk, ty, tx, p, ds);
#pragma unroll
    for (int u = 0; u < R; ++u)
#pragma unroll
      for (int w = 0; w < R; ++w)
        sS[(ty + 16 * u) * LDS + tx + 16 * w] = ds[u][w];
    __syncthreads();
    // dQ += dS K: rows ty + 16u, columns tx + 16w
    for (int c = 0; c < N; ++c) {
      float sv[R], kv[W];
#pragma unroll
      for (int u = 0; u < R; ++u) sv[u] = sS[(ty + 16 * u) * LDS + c];
#pragma unroll
      for (int w = 0; w < W; ++w) kv[w] = sK[c * LD + tx + 16 * w];
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[u][w] = fmaf(sv[u], kv[w], acc[u][w]);
    }
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int row = ty + 16 * u;
    if (row >= nr) continue;
    const int r = r0 + row, i = r / a.group;
    const int h = kvh * a.group + (r - i * a.group);
    T* out = dq + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) * a.hd;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int d = tx + 16 * w;
      if (d < a.hd) out[d] = from_f<T>(acc[u][w] * a.scale);
    }
  }
}

// ---------------------------------------------------------------------
// bf16, hd <= 128: tensor-core kernels (mma.sync m16n8k16), 4 warps
// ---------------------------------------------------------------------

constexpr int M_THREADS = 128;
constexpr int M_KEYS = 64;  // attn_bwd_dkdv_mma: keys a block (16 a warp)
constexpr int M_QROWS = 32;  // ... and query rows a step
constexpr int D_ROWS = 64;   // attn_bwd_dq_mma: query rows a block
constexpr int D_KEYS = 32;   // ... and keys a step

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t a0,
                                         const uint32_t a1, const uint32_t a2,
                                         const uint32_t a3, const uint32_t b0,
                                         const uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [0, n) of a tile of bf16 rows of HDP + 8 values: row rr from
// src(rr) (null: zeros), 8 values a chunk, zeros past hd; 16-byte copies
// where `vec`
template <int HDP, typename Src>
__device__ __forceinline__ void stage_bf16(bf16* dst, int n, Src src, int hd,
                                           int vec, int tid) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  for (int e = tid; e < n * CH; e += M_THREADS) {
    const int rr = e / CH, ch = e - rr * CH, d0 = ch * 8;
    const bf16* p = src(rr);
    bf16* out = dst + rr * LD + d0;
    if (p != nullptr && vec && d0 < hd) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(p + d0);
      continue;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      out[u] = (p != nullptr && d0 + u < hd) ? p[d0 + u]
                                             : __ushort_as_bfloat16(0);
  }
}

// C (16 x 8 NT) += A (16 rows of sA from row a0, HDP deep) * B^T (8 NT rows
// of sB from row b0): both operands row-major in shared memory, the rows
// of B the columns of C
template <int HDP, int NT>
__device__ __forceinline__ void mma_rows(float (&c)[NT][4], const bf16* sA,
                                         int a0, const bf16* sB, int b0,
                                         int g, int t) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const bf16* pa = sA + (a0 + g) * LD + kk * 16 + 2 * t;
    const uint32_t x0 = lds32(pa), x1 = lds32(pa + 8 * LD);
    const uint32_t x2 = lds32(pa + 8), x3 = lds32(pa + 8 * LD + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* pb = sB + (b0 + n * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(c[n], x0, x1, x2, x3, lds32(pb), lds32(pb + 8));
    }
  }
}

// acc (16 x HDP) += X (16 x 8 NT, registers, rounded to bf16) * sB (8 NT
// rows of HDP, row-major in shared memory: the k axis runs down the rows)
template <int HDP, int NT>
__device__ __forceinline__ void mma_acc(float (&acc)[HDP / 8][4],
                                        const float (&x)[NT][4],
                                        const bf16* sB, int g, int t) {
  constexpr int LD = HDP + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const bf16* pb = sB + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const bf16* pn = pb + n * 8;
      mma_bf16(acc[n], a0, a1, a2, a3, pack_raw(pn[0], pn[LD]),
               pack_raw(pn[8 * LD], pn[9 * LD]));
    }
  }
}

template <int HDP>
constexpr size_t dkdv_mma_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * M_KEYS + 2 * M_QROWS) *
             (HDP + 8) +
         sizeof(float) * 2 * M_QROWS;
}

// one block per (64-key tile, kv-head, batch); warp w owns keys 16w ..
// 16w + 15 of the tile and their dK, dV rows in registers. Per step of 32
// query rows (the GQA group's rows r = i * G + h % G that the causal mask
// leaves): S^T = K Q^T and dP^T = V dO^T on the tensor cores, P^T and dS^T
// in float32, rounded to bf16 for dV += P^T dO and dK += dS^T Q.
template <int HDP>
__global__ void __launch_bounds__(M_THREADS)
    attn_bwd_dkdv_mma_kernel(const BwdArgs a, const int vec) {
  constexpr int LD = HDP + 8, DT = HDP / 8, NT = M_QROWS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // M_KEYS x LD
  bf16* sV = sK + M_KEYS * LD;                    // M_KEYS x LD
  bf16* sQ = sV + M_KEYS * LD;                    // M_QROWS x LD
  bf16* sG = sQ + M_QROWS * LD;                   // M_QROWS x LD: dO
  float* sLse = reinterpret_cast<float*>(sG + M_QROWS * LD);
  float* sDel = sLse + M_QROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, j0 = blockIdx.x * M_KEYS;
  const int nk = max(0, min(M_KEYS, a.kv_end - j0));
  const int rows = a.Sq * a.group;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const bf16* dout = static_cast<const bf16*>(a.dout);

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.0f;

  if (nk > 0) {
    stage_bf16<HDP>(sK, M_KEYS, [&](int c) -> const bf16* {
      return c < nk ? k + static_cast<long long>(j0 + c) * a.k_ss : nullptr;
    }, a.hd, vec, tid);
    stage_bf16<HDP>(sV, M_KEYS, [&](int c) -> const bf16* {
      return c < nk ? v + static_cast<long long>(j0 + c) * a.v_ss : nullptr;
    }, a.hd, vec, tid);
    int r_begin = 0;
    if (a.causal) {
      const long long i0 = static_cast<long long>(j0) - a.q_offset;
      r_begin = static_cast<int>(i0 > 0 ? (i0 < a.Sq ? i0 : a.Sq) : 0) *
                a.group;
    }
    // the two keys of this thread's fragment rows
    const int jr0 = j0 + warp * 16 + g, jr1 = jr0 + 8;
    for (int r0 = r_begin; r0 < rows; r0 += M_QROWS) {
      __syncthreads();  // the previous step's sQ, sG are used up
      auto row_ptr = [&](int rr, bool grad) -> const bf16* {
        const int r = r0 + rr;
        if (r >= rows) return nullptr;
        const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
        return grad ? dout + ((static_cast<long long>(b) * a.Sq + i) * a.Hq +
                              h) * a.hd
                    : q + i * a.q_ss + h * a.q_sh;
      };
      stage_bf16<HDP>(sQ, M_QROWS, [&](int rr) { return row_ptr(rr, false); },
                      a.hd, vec, tid);
      stage_bf16<HDP>(sG, M_QROWS, [&](int rr) { return row_ptr(rr, true); },
                      a.hd, vec, tid);
      if (tid < M_QROWS) {
        const int r = r0 + tid;
        float lse = -INFINITY, del = 0.0f;
        if (r < rows) {
          const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
          const long long st =
              (static_cast<long long>(b) * a.Hq + h) * a.Sq + i;
          lse = a.lse[st];
          del = a.delta[st];
        }
        sLse[tid] = lse;
        sDel[tid] = del;
      }
      __syncthreads();
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      mma_rows<HDP, NT>(s, sK, warp * 16, sQ, 0, g, t);
      mma_rows<HDP, NT>(dp, sV, warp * 16, sG, 0, g, t);
      // s[n][e]: key jr0 (e < 2) or jr1, query row n * 8 + 2t + (e & 1)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = n * 8 + 2 * t + (e & 1), r = r0 + rr;
          const int j = e < 2 ? jr0 : jr1;
          const float lse = sLse[rr];
          const bool vis =
              r < rows && j - j0 < nk && lse != -INFINITY &&
              (!a.causal ||
               j <= static_cast<long long>(a.q_offset) + r / a.group);
          const float p = vis ? expf(s[n][e] * a.scale - lse) : 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sDel[rr]);
        }
      mma_acc<HDP, NT>(acc_v, s, sG, g, t);
      mma_acc<HDP, NT>(acc_k, dp, sQ, g, t);
    }
  }

  bf16* dk = static_cast<bf16*>(a.dk);
  bf16* dv = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + g + 8 * half;
    if (j >= a.Skv) continue;
    const long long base =
        ((static_cast<long long>(b) * a.Skv + j) * a.Hkv + kvh) * a.hd;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < a.hd) {
          dk[base + d] = __float2bfloat16_rn(acc_k[n][2 * half + e] * a.scale);
          dv[base + d] = __float2bfloat16_rn(acc_v[n][2 * half + e]);
        }
      }
  }
}

template <int HDP>
constexpr size_t dq_mma_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(2 * D_ROWS + 2 * D_KEYS) *
             (HDP + 8) +
         sizeof(float) * 2 * D_ROWS;
}

// one block per (64 query rows, kv-head, batch); warp w owns rows 16w ..
// 16w + 15 and their dQ rows in registers. Per step of 32 keys: S = Q K^T
// and dP = dO V^T on the tensor cores, P and dS in float32, dS rounded to
// bf16 for dQ += dS K.
template <int HDP>
__global__ void __launch_bounds__(M_THREADS)
    attn_bwd_dq_mma_kernel(const BwdArgs a, const int vec) {
  constexpr int LD = HDP + 8, DT = HDP / 8, NT = D_KEYS / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // D_ROWS x LD
  bf16* sG = sQ + D_ROWS * LD;                    // D_ROWS x LD: dO
  bf16* sK = sG + D_ROWS * LD;                    // D_KEYS x LD
  bf16* sV = sK + D_KEYS * LD;                    // D_KEYS x LD
  float* sLse = reinterpret_cast<float*>(sV + D_KEYS * LD);
  float* sDel = sLse + D_ROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y, r0 = blockIdx.x * D_ROWS;
  const int rows = a.Sq * a.group, nr = min(D_ROWS, rows - r0);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const bf16* dout = static_cast<const bf16*>(a.dout);

  auto row_ptr = [&](int rr, bool grad) -> const bf16* {
    const int r = r0 + rr;
    if (r >= rows) return nullptr;
    const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
    return grad ? dout + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) *
                             a.hd
                : q + i * a.q_ss + h * a.q_sh;
  };
  stage_bf16<HDP>(sQ, D_ROWS, [&](int rr) { return row_ptr(rr, false); },
                  a.hd, vec, tid);
  stage_bf16<HDP>(sG, D_ROWS, [&](int rr) { return row_ptr(rr, true); },
                  a.hd, vec, tid);
  if (tid < D_ROWS) {
    const int r = r0 + tid;
    float lse = -INFINITY, del = 0.0f;
    if (r < rows) {
      const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
      const long long st = (static_cast<long long>(b) * a.Hq + h) * a.Sq + i;
      lse = a.lse[st];
      del = a.delta[st];
    }
    sLse[tid] = lse;
    sDel[tid] = del;
  }
  int kend = a.kv_end;
  if (a.causal) {
    const long long last =
        static_cast<long long>(a.q_offset) + (r0 + nr - 1) / a.group + 1;
    kend = static_cast<int>(last < kend ? (last > 0 ? last : 0) : kend);
  }
  // this thread's two fragment rows
  const int rr0 = warp * 16 + g, rr1 = rr0 + 8;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int j0 = 0; j0 < kend; j0 += D_KEYS) {
    const int nk = min(D_KEYS, kend - j0);
    __syncthreads();  // sK, sV used up (first: the rows staged)
    stage_bf16<HDP>(sK, D_KEYS, [&](int c) -> const bf16* {
      return c < nk ? k + static_cast<long long>(j0 + c) * a.k_ss : nullptr;
    }, a.hd, vec, tid);
    stage_bf16<HDP>(sV, D_KEYS, [&](int c) -> const bf16* {
      return c < nk ? v + static_cast<long long>(j0 + c) * a.v_ss : nullptr;
    }, a.hd, vec, tid);
    __syncthreads();
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
    mma_rows<HDP, NT>(s, sQ, warp * 16, sK, 0, g, t);
    mma_rows<HDP, NT>(dp, sG, warp * 16, sV, 0, g, t);
    // s[n][e]: row rr0 (e < 2) or rr1, key j0 + n * 8 + 2t + (e & 1)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e < 2 ? rr0 : rr1, r = r0 + rr;
        const int c = n * 8 + 2 * t + (e & 1), j = j0 + c;
        const float lse = sLse[rr];
        const bool vis =
            r < rows && c < nk && lse != -INFINITY &&
            (!a.causal ||
             j <= static_cast<long long>(a.q_offset) + r / a.group);
        const float p = vis ? expf(s[n][e] * a.scale - lse) : 0.0f;
        dp[n][e] = p * (dp[n][e] - sDel[rr]);
      }
    mma_acc<HDP, NT>(acc, dp, sK, g, t);
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = rr0 + 8 * half;
    if (rr >= nr) continue;
    const int r = r0 + rr, i = r / a.group;
    const int h = kvh * a.group + (r - i * a.group);
    bf16* out = dq + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) *
                         a.hd;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < a.hd) out[d] = __float2bfloat16_rn(acc[n][2 * half + e] *
                                                   a.scale);
      }
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t s, const Args&... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_delta(const BwdArgs& a, cudaStream_t s) {
  const long long n_rows = static_cast<long long>(a.B) * a.Sq * a.Hq;
  attn_bwd_delta_kernel<T><<<blocks_for(n_rows * 32, B_THREADS), B_THREADS,
                             0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

unsigned tiles(long long n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

template <typename T, int HDP>
int launch_scalar(const BwdArgs& a, cudaStream_t s) {
  constexpr int N = Tile<HDP>::N;
  int rc = launch_delta<T>(a, s);
  if (rc != 0) return rc;
  rc = launch(attn_bwd_dkdv_kernel<T, HDP>, dim3(tiles(a.Skv, N), a.Hkv, a.B),
              B_THREADS, dkdv_smem_bytes<T, HDP>(), s, a);
  if (rc != 0) return rc;
  const long long rows = static_cast<long long>(a.Sq) * a.group;
  return launch(attn_bwd_dq_kernel<T, HDP>, dim3(tiles(rows, N), a.Hkv, a.B),
                B_THREADS, dq_smem_bytes<T, HDP>(), s, a);
}

template <typename T>
int launch_scalar_hd(const BwdArgs& a, cudaStream_t s) {
  if (a.hd <= 16) return launch_scalar<T, 16>(a, s);
  if (a.hd <= 32) return launch_scalar<T, 32>(a, s);
  if (a.hd <= 64) return launch_scalar<T, 64>(a, s);
  if (a.hd <= 128) return launch_scalar<T, 128>(a, s);
  return launch_scalar<T, 256>(a, s);
}

template <int HDP>
int launch_mma(const BwdArgs& a, int vec, cudaStream_t s) {
  int rc = launch_delta<bf16>(a, s);
  if (rc != 0) return rc;
  rc = launch(attn_bwd_dkdv_mma_kernel<HDP>,
              dim3(tiles(a.Skv, M_KEYS), a.Hkv, a.B), M_THREADS,
              dkdv_mma_smem_bytes<HDP>(), s, a, vec);
  if (rc != 0) return rc;
  const long long rows = static_cast<long long>(a.Sq) * a.group;
  return launch(attn_bwd_dq_mma_kernel<HDP>,
                dim3(tiles(rows, D_ROWS), a.Hkv, a.B), M_THREADS,
                dq_mma_smem_bytes<HDP>(), s, a, vec);
}

}  // namespace

// q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd): last dimension contiguous,
// strides in elements. o, dout and dq contiguous (B, Sq, Hq, hd); dk, dv
// contiguous (B, Skv, Hkv, hd); lse and delta (scratch) float32
// (B, Hq, Sq). dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dout and the
// three gradients). 1 <= hd <= 256, Hq % Hkv == 0, 0 <= kv_end <= Skv.
// route (the wrapper's choice): 0 the CUDA-core kernels, 1 the mma.sync
// kernels (bfloat16, hd <= 128); vec: 1 if 16-byte loads are allowed (hd
// and every q / k / v stride a multiple of 8, all five inputs aligned).
REPRO_EXPORT int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int kv_end, int dtype, int route, int vec,
    void* stream) {
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0 || kv_end < 0 ||
      kv_end > Skv || (dtype != 0 && dtype != 1) || (route != 0 && route != 1) ||
      (route == 1 && (dtype != 1 || hd > 128)))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q,     k,     v,      o,    dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                  hd,    Hq / Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                  v_ss,  v_sh,  causal, q_offset, kv_end,
                  1.0f / sqrtf(static_cast<float>(hd))};
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (hd <= 16) return launch_mma<16>(a, vec, s);
    if (hd <= 32) return launch_mma<32>(a, vec, s);
    if (hd <= 64) return launch_mma<64>(a, vec, s);
    return launch_mma<128>(a, vec, s);
  }
  return dtype == 0 ? launch_scalar_hd<float>(a, s)
                    : launch_scalar_hd<bf16>(a, s);
}
