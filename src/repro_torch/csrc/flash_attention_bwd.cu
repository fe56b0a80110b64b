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
// Every route: per (key tile, kv-head, batch) a block that loops over the
// GQA group's query rows that the causal mask leaves (the rows r = i * G +
// h % G of the forward, so every q-head of the group is summed inside the
// block, with no atomics) for dK and dV, and per (row tile, kv-head,
// batch) a block that loops over the key tiles its rows see for dQ. P is
// recomputed from lse; D = rowsum(dO * O) comes from a first launch. A
// row with lse = -inf (no visible key) has P = 0. Keys at or past kv_end
// get dK = dV = 0. Each gradient is summed in a fixed order: two launches
// on the same inputs give the same bits (exact crash-resume needs it).
//
// Bound: operations. The backward does 5 products per visible pair
// (S = Q K^T, dV += P^T dO, dP = dO V^T, dQ += dS K, dK += dS^T Q), 10 hd
// operations; at granite-8b's training step (B 2, S 4096, Hq 32, hd 128,
// causal) 6.9e11 operations, 0.695 ms at the bf16 tensor-core peak. Three
// routes, by type, head dim, alignment and group (the wrapper's bwd_route):
//
//  * attn_bwd_rows_kernel + attn_bwd_dkdv_wgmma_kernel +
//    attn_bwd_dq_wgmma_kernel -- bf16, hd 64 or 128, 16-byte aligned,
//    G <= 64: every LM training step. What bounded the first tensor-core
//    route (below, 14.5 ms at the step's shape on an H100 against SDPA's
//    backward at 1.7-1.9 ms): mma.sync, which cannot reach the wgmma
//    rate; nothing pipelined (a barrier, then every thread staging 32 rows
//    or keys, then the products, each step); B operands of the dV, dK and
//    dQ products gathered by scalar 16-bit shared-memory reads; a division
//    r / G and expf on every element of every tile; lse and D gathered a
//    row at a time across q-heads. This route is the FlashAttention-3
//    shape: two consumer warpgroups and a producer warp whose one thread
//    moves every tile by TMA into 128-byte-swizzled shared memory,
//    signalling mbarriers, through a ring of 2-3 stages; setmaxnreg
//    gives the consumers 240 registers. The rows kernel writes each row's
//    lse * log2 e and D in the kernels' row order into scratch, so a row
//    tile's 64 of each arrive as one bulk copy (rows with no key, and
//    padding rows, get +inf: P = exp2(S scale log2 e - lse2) = 0 there
//    unmasked). A row tile is P = 64 / G whole positions of the group's G
//    q-heads, one 4-D box (hd, head, position, batch) of the tensor, so Q
//    and dO are read in place, any strides. dK/dV: a block holds 128 keys
//    (64 a warpgroup, dK and dV in float32 registers), K and V loaded once,
//    Q, dO, lse2, D streamed; S^T = K Q^T and dP^T = V dO^T by wgmma from
//    shared memory, P^T and dS^T rounded to bf16 in registers as the A
//    operand of dV += P^T dO and dK += dS^T Q, dO and Q read MN-major from
//    the same stage. dQ: a block holds two 64-row tiles, Q and dO loaded
//    once, 128-key K and V tiles streamed; S = Q K^T, dP = dO V^T, dS the
//    A operand of dQ += dS K. S and dP are computed in both (14 hd
//    operations a pair, 0.97 ms at peak): a fused pass at 10 hd would add
//    dQ across key tiles in float32 scratch, in a fixed order only behind a
//    semaphore a row tile. Masks only where a tile crosses the diagonal or
//    kv_end; tiles that no row sees are skipped; the key tiles with the
//    most causal rows and the row tiles with the most keys run first. At
//    the step's shape on an H100: 1.63 device-ms by the profiler (rows
//    0.05, dK/dV 0.91, dQ 0.67), 1.68-1.76 in a CUDA graph; cuDNN's fused
//    backward (SDPA's) 1.53.
//  * attn_bwd_delta_kernel + attn_bwd_dkdv_mma_kernel +
//    attn_bwd_dq_mma_kernel -- the other bf16 shapes up to hd 128 (hd not
//    64 or 128, unaligned strides, G > 64): mma.sync m16n8k16 on bf16
//    tiles staged in shared memory (16-byte loads), float32 accumulators
//    in registers: dK and dV of 16 keys a warp (64 a block) over steps of
//    32 query rows, dQ of 16 rows a warp (64 a block) over steps of 32
//    keys, each tile loaded, then used. The granite-8b step's route until
//    the wgmma one: 14.5 ms; the first design, the CUDA-core route below,
//    67 ms.
//  * attn_bwd_delta_kernel + attn_bwd_dkdv_kernel + attn_bwd_dq_kernel --
//    float32, and bf16 above hd 128: CUDA-core float32 FMAs on 64 x 64
//    tiles (32 x 32 above hd 128) staged in shared memory as float32, each
//    thread a 4 x 4 (2 x 2) register tile of the scores and 4 x hd/16
//    (2 x hd/16) of its dK and dV rows; float32 accumulation throughout,
//    results rounded once.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------
// bf16, hd 64 or 128, aligned: warp-specialised wgmma kernels
// ---------------------------------------------------------------------

constexpr int BW_THREADS = 384;  // two consumer warpgroups, one producer
constexpr int BW_ROWS = 64;      // rows of a row tile (GQA rows)
constexpr int BW_KEYS = 128;     // keys of a key tile
// the rings of streamed tiles: row tiles (dK/dV), key tiles (dQ)
constexpr int DKV_STAGES = 3, DQ_STAGES = 2;
// one 64-column (128-byte) swizzle atom of a row tile, of a key tile
constexpr int BW_ATOM = BW_ROWS * 128;
constexpr int KEY_ATOM = BW_KEYS * 128;
constexpr float LOG2E = 1.4426950408889634f;

// The row tiles of one (batch, kv-head): P = 64 / G whole positions of the
// GQA group's G rows, row p * G + g of a tile being query pt * P + p of
// q-head kvh * G + g (the forward's order r = i * G + h % G). Per tile 64
// floats each of lse * log2 e and of D in that order; rows past P * G or
// past Sq hold +inf and 0, so P = 0 there without a mask.
struct RowTiles {
  int P, n_pt;  // positions a tile, tiles
  float* lse2;  // (B, Hkv, n_pt, 64)
  float* del;   // (B, Hkv, n_pt, 64)
};

// lse2 and D of every row-tile entry: 8 lanes an entry, 16-byte loads
// (bf16 rows of hd 64 or 128, 16-byte aligned), 32 entries a block
constexpr int ROWS_LANES = 8;

__global__ void __launch_bounds__(B_THREADS)
    attn_bwd_rows_kernel(const BwdArgs a, const RowTiles rt) {
  const long long e =
      static_cast<long long>(blockIdx.x) * (B_THREADS / ROWS_LANES) +
      threadIdx.x / ROWS_LANES;
  const int lane = threadIdx.x % ROWS_LANES;
  const long long n =
      static_cast<long long>(a.B) * a.Hkv * rt.n_pt * BW_ROWS;
  if (e >= n) return;  // whole warps leave: n is a multiple of 64
  const int rr = static_cast<int>(e % BW_ROWS);
  const long long tile = e / BW_ROWS;
  const int pt = static_cast<int>(tile % rt.n_pt);
  const long long bk = tile / rt.n_pt;
  const int kvh = static_cast<int>(bk % a.Hkv);
  const int b = static_cast<int>(bk / a.Hkv);
  const int G = a.group, i = pt * rt.P + rr / G;
  const bool live = rr < rt.P * G && i < a.Sq;
  const int h = kvh * G + rr % G;
  float s = 0.0f;
  if (live) {
    const long long row = (static_cast<long long>(b) * a.Sq + i) * a.Hq + h;
    const bf16* o = static_cast<const bf16*>(a.o) + row * a.hd;
    const bf16* g = static_cast<const bf16*>(a.dout) + row * a.hd;
    for (int d = 8 * lane; d < a.hd; d += 8 * ROWS_LANES) {
      const uint4 x = *reinterpret_cast<const uint4*>(g + d);
      const uint4 y = *reinterpret_cast<const uint4*>(o + d);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 xf = __bfloat1622float2(x2[u]);
        const float2 yf = __bfloat1622float2(y2[u]);
        s = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, s));
      }
    }
  }
  // the group's 8 lanes are adjacent lanes of one warp
  for (int off = ROWS_LANES / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(~0u, s, off);
  if (lane == 0) {
    float lse2 = INFINITY;
    if (live) {
      const float l =
          a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + i];
      lse2 = l == -INFINITY ? INFINITY : l * LOG2E;
    }
    rt.lse2[e] = lse2;
    rt.del[e] = s;
  }
}

// one box of 64 columns x 128 keys of a K / V tensor map (kv_tensor_map)
__device__ __forceinline__ void tma_keys(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, const KvDims& dims,
                                         int c0, int j, int kvh, int b) {
  auto at = [&](int pos) {
    return pos == dims.key ? j : pos == dims.head ? kvh : b;
  };
  tma_load_4d(dst, map, bar, c0, at(1), at(2), at(3));
}

// D (64 x HD, f32) += A (64 x 16, registers) * B (16 x HD, shared,
// MN-major)
template <int HD>
__device__ __forceinline__ void wgmma_rs_hd(float (&d)[HD / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (HD == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    wgmma_rs_n64(d, a, db);
  }
}

// the k-steps' A fragments of a 64 x 16 KS accumulator, rounded to bf16
// (k-step kk: columns 16kk .. 16kk + 15, as the forward feeds P)
template <int KS>
__device__ __forceinline__ void pack_frags(uint32_t (&f)[KS][4],
                                           const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      f[kk][u] = pack_bf16(x[8 * kk + 2 * u], x[8 * kk + 2 * u + 1]);
}

// rows from `first` to 63 of `n_atoms` consecutive atoms of 64-row tiles:
// zeros (the row tiles' rows past P * G, which no box writes)
__device__ __forceinline__ void zero_tail_rows(unsigned char* tiles,
                                               int n_atoms, int first,
                                               int tid) {
  const int per = (BW_ROWS - first) * 8;  // 16-byte chunks an atom
  for (int e = tid; e < n_atoms * per; e += BW_THREADS) {
    const int atom = e / per, c = e - atom * per;
    *reinterpret_cast<uint4*>(tiles + atom * BW_ATOM + first * 128 +
                              c * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int HD>
constexpr size_t bwd_dkdv_smem_bytes() {
  // 1024 of slack for the atoms' 1024-byte alignment; K and V of the
  // block's key tile; DKV_STAGES stages of a Q and a dO row tile and of
  // their rows' lse2 and D (256 bytes each); mbarriers
  return 1024 +
         static_cast<size_t>(HD / 64) *
             (2 * KEY_ATOM + 2 * DKV_STAGES * BW_ATOM) +
         2 * 256 * DKV_STAGES + 8 * (1 + 2 * DKV_STAGES);
}

// one block per (128-key tile, kv-head, batch); consumer warpgroup w owns
// keys 64w .. 64w + 63 of the tile and their dK, dV in float32 registers.
// The producer warp loads K and V once, then streams the row tiles that
// see the block's keys (Q, dO, lse2, D) through a ring of DKV_STAGES. Per
// row tile: S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in shared
// memory), P^T and dS^T in registers, rounded to bf16 as the A operand of
// dV += P^T dO and dK += dS^T Q (dO and Q read MN-major from the stage);
// P^T is formed while dP^T runs, dS^T while dV's product runs.
template <int HD>
__global__ void __launch_bounds__(BW_THREADS, 1)
    attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_g,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const BwdArgs a, const RowTiles rt,
                               const KvDims dims, const int n_ktiles) {
  constexpr int NA = HD / 64;          // swizzle atoms across hd
  constexpr int TILE = NA * BW_ATOM;   // bytes of a row tile
  constexpr int ACC = HD / 2;          // registers of a 64 x HD sum
  constexpr int STAGES = DKV_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sK = base;                // NA atoms of 128 keys
  const uint32_t sV = sK + NA * KEY_ATOM;  // NA atoms of 128 keys
  const uint32_t sQ = sV + NA * KEY_ATOM;  // STAGES row tiles
  const uint32_t sG = sQ + STAGES * TILE;  // STAGES row tiles: dO
  const uint32_t sL = sG + STAGES * TILE;  // STAGES x 64 floats
  const uint32_t sD = sL + STAGES * 256;   // STAGES x 64 floats
  const uint32_t bars = sD + STAGES * 256;
  // kv_full: K and V have landed; full[s]: stage s's tiles have landed;
  // empty[s]: all 8 consumer warps are done with stage s
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  // key tiles in order (the first sees the most causal rows), every
  // (kv-head, batch) of one tile together
  const int per = static_cast<int>(gridDim.x) / n_ktiles;  // Hkv * B
  const int kt = static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int kvh = rem % a.Hkv, b = rem / a.Hkv;
  const int j0 = kt * BW_KEYS, G = a.group, P = rt.P;
  // the row tiles [pt0, pt0 + n_tiles) whose rows see a key of the block
  int pt0 = 0, n_tiles = 0;
  if (j0 < a.kv_end) {
    n_tiles = rt.n_pt;
    if (a.causal) {
      const long long i_first = static_cast<long long>(j0) - a.q_offset;
      if (i_first >= a.Sq) {
        n_tiles = 0;
      } else if (i_first > 0) {
        pt0 = static_cast<int>(i_first / P);
        n_tiles -= pt0;
      }
    }
  }

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (P * G < BW_ROWS)
    zero_tail_rows(gbase + (sQ - base), 2 * STAGES * NA, P * G, tid);
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread loads K / V, then keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 2 * 128 && n_tiles > 0) {
      mbar_expect_tx(kv_full, 2 * NA * KEY_ATOM);
#pragma unroll
      for (int c = 0; c < NA; ++c) {
        tma_keys(sK + c * KEY_ATOM, &tm_k, kv_full, dims, c * 64, j0, kvh, b);
        tma_keys(sV + c * KEY_ATOM, &tm_v, kv_full, dims, c * 64, j0, kvh, b);
      }
      const uint32_t box = 128u * G * P;  // bytes of a row-tile box
      const long long lrow =
          (static_cast<long long>(b) * a.Hkv + kvh) * rt.n_pt;
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        const uint32_t ph = (n / STAGES) & 1;
        mbar_wait(empty(st), ph ^ 1);
        const int pt = pt0 + n;
        mbar_expect_tx(full(st), 2 * NA * box + 2 * 256);
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          tma_load_4d(sQ + st * TILE + c * BW_ATOM, &tm_q, full(st), c * 64,
                      kvh * G, pt * P, b);
          tma_load_4d(sG + st * TILE + c * BW_ATOM, &tm_g, full(st), c * 64,
                      kvh * G, pt * P, b);
        }
        bulk_load(sL + st * 256, rt.lse2 + (lrow + pt) * BW_ROWS, 256,
                  full(st));
        bulk_load(sD + st * 256, rt.del + (lrow + pt) * BW_ROWS, 256,
                  full(st));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys j0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int jw = j0 + wg * BW_ROWS;      // the warpgroup's first key
    const int jr = jw + warp * 16 + g;     // this thread's keys jr, jr + 8
    // the warpgroup's 64 keys: rows 64 wg .. of the 128-key atoms
    const uint32_t kA = sK + wg * BW_ATOM, vA = sV + wg * BW_ATOM;
    const float* Ls = reinterpret_cast<const float*>(gbase + (sL - base));
    const float* Ds = reinterpret_cast<const float*>(gbase + (sD - base));
    const float sl2 = a.scale * LOG2E;

    float dk[ACC], dv[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) dk[i] = dv[i] = 0.0f;
    if (n_tiles > 0) mbar_wait(kv_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % STAGES;
      const uint32_t ph = (n / STAGES) & 1;
      const int i0 = (pt0 + n) * P;  // the tile's first position
      // skip: no row of the tile sees a key of the warpgroup (or every
      // key is past kv_end); mask: some pair of the tile is not visible
      bool skip = jw >= a.kv_end, mask = false;
      if (a.causal) {
        const long long q0 = static_cast<long long>(a.q_offset) + i0;
        skip = skip || q0 + min(P, a.Sq - i0) - 1 < jw;
        mask = q0 < jw + BW_ROWS - 1;
      }
      mbar_wait(full(st), ph);
      if (!skip) {
        const uint32_t qt = sQ + st * TILE, gt = sG + st * TILE;
        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t ok = (kk >> 2) * KEY_ATOM + (kk & 3) * 32;
          const uint32_t oq = (kk >> 2) * BW_ATOM + (kk & 3) * 32;
          wgmma_ss_n64(s, smem_desc(kA + ok, 16, 1024),
                       smem_desc(qt + oq, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t ok = (kk >> 2) * KEY_ATOM + (kk & 3) * 32;
          const uint32_t oq = (kk >> 2) * BW_ATOM + (kk & 3) * 32;
          wgmma_ss_n64(dp, smem_desc(vA + ok, 16, 1024),
                       smem_desc(gt + oq, 16, 1024), kk > 0);
        }
        wgmma_commit();
        // P^T while dP^T runs
        wgmma_wait<1>();
        fence_regs(s);

        // s[i]: key jr + 8 * ((i >> 1) & 1), tile row c = (i >> 2) * 8 +
        // 2t + (i & 1), i.e. position i0 + c / G; key j is visible to row
        // c iff c >= G * (j - q_offset - i0)
        int thr[2] = {0, 0};
        if (mask) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const long long m = static_cast<long long>(jr + 8 * hh) -
                                a.q_offset - i0;
            thr[hh] = static_cast<int>(
                m <= 0 ? 0 : (m * G > BW_ROWS ? BW_ROWS : m * G));
          }
        }
        const float* lt = Ls + st * BW_ROWS;
        const float* dt = Ds + st * BW_ROWS;
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const int c = c8 * 8 + 2 * t;  // rows c, c + 1 of the tile
          const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * c8 + e;
            float p = exp2f(fmaf(s[i], sl2, -((e & 1) ? l2.y : l2.x)));
            if (mask && c + (e & 1) < thr[(e >> 1) & 1]) p = 0.0f;
            s[i] = p;
          }
        }
        uint32_t pa[4][4], da[4][4];
        pack_frags(pa, s);
        // dV += P^T dO (dO MN-major: hd contiguous), dS^T while it runs
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_hd<HD>(dv, pa[kk],
                          smem_desc(gt + kk * 16 * 128, BW_ATOM, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // dP^T
        fence_regs(dp);
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dt + c8 * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * c8 + e;
            dp[i] = s[i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
          }
        }
        pack_frags(da, dp);
        // dK += dS^T Q (Q MN-major)
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_hd<HD>(dk, da[kk],
                          smem_desc(qt + kk * 16 * 128, BW_ATOM, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          fence_regs(pa[kk]);
          fence_regs(da[kk]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // dK (scaled) and dV of keys jr, jr + 8; zeros at or past kv_end
    bf16* dkp = static_cast<bf16*>(a.dk);
    bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = jr + 8 * hh;
      if (j >= a.Skv) continue;
      const bool live = j < a.kv_end;
      const long long off =
          ((static_cast<long long>(b) * a.Skv + j) * a.Hkv + kvh) * HD;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const int i = 4 * n8 + 2 * hh, d = n8 * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dkp + off + d) =
            live ? pack_bf16(dk[i] * a.scale, dk[i + 1] * a.scale) : 0u;
        *reinterpret_cast<uint32_t*>(dvp + off + d) =
            live ? pack_bf16(dv[i], dv[i + 1]) : 0u;
      }
    }
  }
}

template <int HD>
constexpr size_t bwd_dq_smem_bytes() {
  // slack; Q and dO of the block's two row tiles; DQ_STAGES stages of a
  // 128-key K and V tile; mbarriers
  return 1024 +
         static_cast<size_t>(HD / 64) *
             (4 * BW_ATOM + 2 * DQ_STAGES * KEY_ATOM) +
         8 * (1 + 2 * DQ_STAGES);
}

// one block per (two row tiles, kv-head, batch); consumer warpgroup w owns
// row tile 2 rb + w and its dQ in float32 registers. The producer warp
// loads Q and dO once, then streams the 128-key K and V tiles that the
// block's rows see through a ring of DQ_STAGES. Per key tile: S = Q K^T
// and dP = dO V^T (wgmma, both operands in shared memory), P and dS in
// registers, dS rounded to bf16 as the A operand of dQ += dS K (K read
// MN-major); P is formed while dP runs. Every key tile is summed in
// order: dQ is deterministic.
template <int HD>
__global__ void __launch_bounds__(BW_THREADS, 1)
    attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_g,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const BwdArgs a, const RowTiles rt,
                             const KvDims dims, const int n_rblocks) {
  constexpr int NA = HD / 64;
  constexpr int TILE = NA * BW_ATOM;       // bytes of a row tile
  constexpr int KTILE = NA * KEY_ATOM;     // bytes of a key tile
  constexpr int ACC = HD / 2;
  constexpr int STAGES = DQ_STAGES;
  constexpr int KS = BW_KEYS / 16;         // k-steps of dS K
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;                 // 2 row tiles (2 rb, 2 rb + 1)
  const uint32_t sG = sQ + 2 * TILE;        // 2 row tiles: dO
  const uint32_t sK = sG + 2 * TILE;        // STAGES key tiles
  const uint32_t sV = sK + STAGES * KTILE;  // STAGES key tiles
  const uint32_t bars = sV + STAGES * KTILE;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  // the row blocks that see the most causal keys first
  const int per = static_cast<int>(gridDim.x) / n_rblocks;  // Hkv * B
  const int rb = n_rblocks - 1 - static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int kvh = rem % a.Hkv, b = rem / a.Hkv;
  const int G = a.group, P = rt.P;
  const int pt_first = 2 * rb;
  const int n_live = min(2, rt.n_pt - pt_first);
  // the keys [0, kend) that some row of the block sees
  int kend = a.kv_end;
  if (a.causal) {
    const long long e = static_cast<long long>(a.q_offset) +
                        min((pt_first + n_live) * P, a.Sq);
    kend = static_cast<int>(e < kend ? (e > 0 ? e : 0) : kend);
  }
  const int n_tiles = (kend + BW_KEYS - 1) / BW_KEYS;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (P * G < BW_ROWS)
    zero_tail_rows(gbase + (sQ - base), 4 * NA, P * G, tid);
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread loads Q / dO, then keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 2 * 128 && n_tiles > 0) {
      const uint32_t box = 128u * G * P;
      mbar_expect_tx(q_full, 2 * NA * box * n_live);
      for (int w = 0; w < n_live; ++w)
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          tma_load_4d(sQ + w * TILE + c * BW_ATOM, &tm_q, q_full, c * 64,
                      kvh * G, (pt_first + w) * P, b);
          tma_load_4d(sG + w * TILE + c * BW_ATOM, &tm_g, q_full, c * 64,
                      kvh * G, (pt_first + w) * P, b);
        }
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % STAGES;
        const uint32_t ph = (n / STAGES) & 1;
        mbar_wait(empty(st), ph ^ 1);
        mbar_expect_tx(full(st), 2 * KTILE);
#pragma unroll
        for (int c = 0; c < NA; ++c) {
          tma_keys(sK + st * KTILE + c * KEY_ATOM, &tm_k, full(st), dims,
                   c * 64, n * BW_KEYS, kvh, b);
          tma_keys(sV + st * KTILE + c * KEY_ATOM, &tm_v, full(st), dims,
                   c * 64, n * BW_KEYS, kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns row tile 2 rb + wg ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int pt = pt_first + wg;
    const bool live = wg < n_live;
    const int i0 = pt * P;
    const int rA = warp * 16 + g;  // this thread's rows rA, rA + 8
    const float sl2 = a.scale * LOG2E;
    // each row's lse2, D and last visible key (-1: none)
    float l2[2], dd[2];
    long long lim[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rA + 8 * hh;
      l2[hh] = INFINITY;
      dd[hh] = 0.0f;
      lim[hh] = -1;
      if (live && r < P * G) {
        const long long idx =
            ((static_cast<long long>(b) * a.Hkv + kvh) * rt.n_pt + pt) *
                BW_ROWS + r;
        l2[hh] = rt.lse2[idx];
        dd[hh] = rt.del[idx];
        lim[hh] = a.kv_end - 1;
        if (a.causal) {
          const long long c = static_cast<long long>(a.q_offset) + i0 + r / G;
          lim[hh] = c < lim[hh] ? c : lim[hh];
        }
      }
    }
    // the tile's first row sees the fewest keys, its last the most: key
    // tiles up to the first's last key need no mask, those past the
    // last's are skipped
    long long lim_lo = a.kv_end - 1, lim_hi = a.kv_end - 1;
    if (a.causal) {
      const long long q0 = static_cast<long long>(a.q_offset) + i0;
      lim_lo = q0 < lim_lo ? q0 : lim_lo;
      const long long q1 = q0 + min(P, a.Sq - i0) - 1;
      lim_hi = q1 < lim_hi ? q1 : lim_hi;
    }
    const uint32_t qa = sQ + wg * TILE, ga = sG + wg * TILE;

    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
    if (n_tiles > 0) mbar_wait(q_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % STAGES;
      const uint32_t ph = (n / STAGES) & 1;
      const int jt = n * BW_KEYS;
      mbar_wait(full(st), ph);
      if (live && jt <= lim_hi) {
        const bool mask = jt + BW_KEYS - 1 > lim_lo;
        const uint32_t kt = sK + st * KTILE, vt = sV + st * KTILE;
        float s[64], dp[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t oq = (kk >> 2) * BW_ATOM + (kk & 3) * 32;
          const uint32_t ok = (kk >> 2) * KEY_ATOM + (kk & 3) * 32;
          wgmma_ss_n128(s, smem_desc(qa + oq, 16, 1024),
                        smem_desc(kt + ok, 16, 1024), kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t oq = (kk >> 2) * BW_ATOM + (kk & 3) * 32;
          const uint32_t ok = (kk >> 2) * KEY_ATOM + (kk & 3) * 32;
          wgmma_ss_n128(dp, smem_desc(ga + oq, 16, 1024),
                        smem_desc(vt + ok, 16, 1024), kk > 0);
        }
        wgmma_commit();
        // P while dP runs. s[i]: row rA + 8 * ((i >> 1) & 1), key jt +
        // (i >> 2) * 8 + 2t + (i & 1)
        wgmma_wait<1>();
        fence_regs(s);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int hh = (i >> 1) & 1;
          float p = exp2f(fmaf(s[i], sl2, -l2[hh]));
          if (mask && jt + (i >> 2) * 8 + 2 * t + (i & 1) > lim[hh]) p = 0.0f;
          s[i] = p;
        }
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int i = 0; i < 64; ++i) dp[i] = s[i] * (dp[i] - dd[(i >> 1) & 1]);
        uint32_t da[KS][4];
        pack_frags(da, dp);
        // dQ += dS K, K MN-major (hd contiguous)
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_rs_hd<HD>(acc, da[kk],
                          smem_desc(kt + kk * 16 * 128, KEY_ATOM, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) fence_regs(da[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = rA + 8 * hh;
      if (!live || r >= P * G) continue;
      const int i = i0 + r / G;
      if (i >= a.Sq) continue;
      const int h = kvh * G + r % G;
      bf16* out = dq + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) * HD;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        const int i4 = 4 * n8 + 2 * hh;
        *reinterpret_cast<uint32_t*>(out + n8 * 8 + 2 * t) =
            pack_bf16(acc[i4] * a.scale, acc[i4 + 1] * a.scale);
      }
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

template <int HD>
int launch_wgmma(const BwdArgs& a, cudaStream_t s) {
  const int P = BW_ROWS / a.group;
  const int n_pt = (a.Sq + P - 1) / P;
  const long long n_entries =
      static_cast<long long>(a.B) * a.Hkv * n_pt * BW_ROWS;
  const RowTiles rt{P, n_pt, a.delta, a.delta + n_entries};
  if (n_entries > 0) {
    attn_bwd_rows_kernel<<<blocks_for(n_entries * ROWS_LANES, B_THREADS),
                           B_THREADS, 0, s>>>(a, rt);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  CUtensorMap mq, mg, mk, mv;
  KvDims dk, dv;
  const long long gh = HD, gs = gh * a.Hq, gb = gs * a.Sq;  // dO, contiguous
  int rc = row_tensor_map(&mq, a.q, HD, a.Hq, a.Sq, a.B, a.q_sh, a.q_ss,
                          a.q_sb, a.group, P);
  if (rc == 0)
    rc = row_tensor_map(&mg, a.dout, HD, a.Hq, a.Sq, a.B, gh, gs, gb, a.group,
                        P);
  if (rc == 0)
    rc = kv_tensor_map(&mk, &dk, a.k, HD, a.kv_end, a.Hkv, a.B, a.k_ss,
                       a.k_sh, a.k_sb, BW_KEYS);
  if (rc == 0)
    rc = kv_tensor_map(&mv, &dv, a.v, HD, a.kv_end, a.Hkv, a.B, a.v_ss,
                       a.v_sh, a.v_sb, BW_KEYS);
  if (rc != 0) return rc;
  if (dk.key != dv.key || dk.head != dv.head || dk.batch != dv.batch)
    return static_cast<int>(cudaErrorInvalidValue);  // k, v laid out alike
  const unsigned per = static_cast<unsigned>(a.Hkv) * a.B;
  const int n_kt = static_cast<int>(tiles(a.Skv, BW_KEYS));
  if (n_kt > 0) {
    rc = launch(attn_bwd_dkdv_wgmma_kernel<HD>, dim3(n_kt * per), BW_THREADS,
                bwd_dkdv_smem_bytes<HD>(), s, mq, mg, mk, mv, a, rt, dk, n_kt);
    if (rc != 0) return rc;
  }
  const int n_rb = (n_pt + 1) / 2;
  if (n_rb > 0)
    rc = launch(attn_bwd_dq_wgmma_kernel<HD>, dim3(n_rb * per), BW_THREADS,
                bwd_dq_smem_bytes<HD>(), s, mq, mg, mk, mv, a, rt, dk, n_rb);
  return rc;
}

// floats of the delta scratch a route needs (flash_attention_bwd_launch)
long long scratch_floats(int B, int Sq, int Hq, int Hkv, int route) {
  if (route != 2) return static_cast<long long>(B) * Hq * Sq;
  const int P = BW_ROWS / (Hq / Hkv);
  return 2LL * B * Hkv * ((Sq + P - 1) / P) * BW_ROWS;
}

}  // namespace

// q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd): last dimension contiguous,
// strides in elements. o, dout and dq contiguous (B, Sq, Hq, hd); dk, dv
// contiguous (B, Skv, Hkv, hd); lse float32 (B, Hq, Sq). dtype: 0 =
// float32, 1 = bfloat16 (q, k, v, o, dout and the three gradients).
// 1 <= hd <= 256, Hq % Hkv == 0, 0 <= kv_end <= Skv. route (the wrapper's
// choice): 0 the CUDA-core kernels, 1 the mma.sync kernels (bfloat16,
// hd <= 128), 2 the wgmma kernels (bfloat16, hd 64 or 128, vec, G =
// Hq / Hkv <= 64); vec: 1 if 16-byte loads are allowed (hd and every q /
// k / v stride a multiple of 8, all five inputs aligned). delta: float32
// scratch of delta_len floats, at least (B, Hq, Sq) for routes 0 and 1; for
// route 2 the row tiles' lse2 and then D, 2 x (B, Hkv, ceil(Sq / P), 64)
// with P = 64 / G; a shorter delta_len is refused (cudaErrorInvalidValue).
REPRO_EXPORT int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, int q_offset, int kv_end, int dtype, int route, int vec,
    long long delta_len, void* stream) {
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0 || kv_end < 0 ||
      kv_end > Skv || (dtype != 0 && dtype != 1) || route < 0 || route > 2 ||
      (route == 1 && (dtype != 1 || hd > 128)) ||
      (route == 2 && (dtype != 1 || (hd != 64 && hd != 128) || !vec ||
                      Hq / Hkv > BW_ROWS)) ||
      delta_len < scratch_floats(B, Sq, Hq, Hkv, route))
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q,     k,     v,      o,    dout, static_cast<const float*>(lse),
                  static_cast<float*>(delta), dq, dk, dv, B, Sq, Skv, Hq, Hkv,
                  hd,    Hq / Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                  v_ss,  v_sh,  causal, q_offset, kv_end,
                  1.0f / sqrtf(static_cast<float>(hd))};
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return hd == 64 ? launch_wgmma<64>(a, s) : launch_wgmma<128>(a, s);
  if (route == 1) {
    if (hd <= 16) return launch_mma<16>(a, vec, s);
    if (hd <= 32) return launch_mma<32>(a, vec, s);
    if (hd <= 64) return launch_mma<64>(a, vec, s);
    return launch_mma<128>(a, vec, s);
  }
  return dtype == 0 ? launch_scalar_hd<float>(a, s)
                    : launch_scalar_hd<bf16>(a, s);
}
