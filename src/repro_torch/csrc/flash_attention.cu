// Causal GQA attention with an online softmax, four routes by shape.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/
// kernel.py:79). For every batch b, query row i and q-head h, with
// kv-head h / G (G = Hq / Hkv, GQA by index: K and V are never expanded):
//
//   out[b, i, h, :] = sum_j softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(hd))
//                     * v[b, j, h/G, :]
//
// over the visible keys j: j < kv_end and, when causal, j <= q_offset + i.
// q_offset is the absolute position of q[:, 0] (the Pallas kernel fixes it
// to Skv - Sq); kv_end = min(kv_valid_len, Skv) ends the key loop, so a
// decode step reads only the filled part of its cache. A row that sees no
// key at all gives zeros. Layout (B, S, H, hd) with the last dimension
// contiguous and any batch / sequence / head strides, so q, k and v may be
// a per-layer slice of the (L, B, max_len, Hkv, hd) KV cache; out is
// contiguous (B, Sq, Hq, hd) in the input type. f32 accumulation. In
// bf16, P is rounded to bf16 before the PV product, as the Pallas kernel
// rounds p to V's type (kernel.py:64), and the row sums l add the
// unrounded f32 p, as there.
//
// Every route's rows are (query, q-head of the group) pairs,
// r = i * G + h % G, for one (kv-head, batch): the group's q-heads share
// each staging of a K/V tile, and at decode (Sq = 1) the four q-heads of a
// granite-8b kv-head are four rows. The online-softmax state stays on
// chip; no (Sq, Skv) buffer touches device memory. The wrapper
// (kernels/flash_attention/ops.py, attention_route) picks the route from
// (rows = Sq * G, hd, dtype, 16-byte alignment):
//
//  * attn_wgmma_kernel -- bf16, hd 64 or 128, aligned, rows > 16: the
//    prefill and long prompts, and prompt chunks of a few queries (their
//    padded rows of the 128-row tile cost operations, not bytes). Bound: the tensor cores (granite-8b
//    prefill, 4 x 2048 causal: 1.37e11 operations, 0.139 ms at 989
//    TFLOP/s). The first design (attn_mma_kernel below) used mma.sync,
//    which cannot reach that peak on Hopper, staged each K/V tile and then
//    used it, and served 64 rows per tile. This one is the FlashAttention-3
//    shape: a 128-row Q tile owned by two consumer warpgroups (64 rows
//    each), S = Q K^T by wgmma with both operands in shared memory, P
//    rounded to bf16 in registers as wgmma's A operand and O += P V with V
//    read transposed (MN-major) from shared memory. A producer warp keeps
//    a ring of two 128-key K/V tiles in flight by TMA (mbarriers; the
//    key extent of the tensor map is kv_end, so the hardware zero-fills
//    past it and a cache's stale tail is never read), and setmaxnreg
//    moves registers from the producer to the consumers. Q (whose GQA
//    rows need not tile by 128, e.g. G = 5) is loaded once by ordinary
//    16-byte loads into the same 128-byte swizzle. The causal mask is
//    applied only to tiles that cross a row's last key; tiles past the
//    block's last visible key are never loaded; the longest causal Q
//    tiles are scheduled first.
//  * attn_splitk_kernel + attn_combine_kernel -- bf16, rows <= 16, any hd:
//    decode. Bound: bytes (the valid cache's K and V, 8.9 MB at batch 4
//    and 544 positions, 0.0027 ms at 3.35 TB/s). One block per (kv-head,
//    batch) left 100 of 132 SMs idle and walked the cache's tiles in
//    order; here the key range [0, kv_end) is cut into chunks (a multiple
//    of 64 keys, as many as make B * Hkv * splits >= 2 x 132 blocks),
//    each block reads its chunk once for the whole GQA group on the CUDA
//    cores (at most 16 rows: the work is bytes, not operations; a 16-row
//    mma.sync tile is untried), K and V by cp.async in separate groups,
//    double-buffered over 32-key tiles, and writes float32 partials (m,
//    l, acc) to scratch; a second launch merges them by log-sum-exp. A
//    chunk that sees no key writes m = -inf, l = 0 and adds nothing.
//    The same kernel reads a float8 (e4m3) KV cache (route splitk_f8,
//    bf16 q): a tile is staged as stored, one byte a value, so the
//    cp.async copies and the shared memory halve, and each value is
//    widened exactly to float where the products read it (cvt.rn.f16x2.
//    e4m3x2); bound: half the bytes (4.5 MB at batch 4 and 544 keys).
//  * attn_mma_kernel -- every other bf16 shape (rows > 16 at hd not 64 or
//    128, or with unaligned strides): mma.sync m16n8k16, 4 warps x 16
//    rows, 64-key tiles loaded then used.
//  * attn_scalar_kernel -- float32: CUDA-core FMAs on 32 x 32 tiles staged
//    in shared memory; exact f32 softmax (no rounding of p). It exists for
//    the float32 model and for checks at the float32 tolerances; it is
//    bounded by shared-memory traffic, far from the f32 peak. Over a
//    float8 cache (round_p, the keys and values copied to float32 by the
//    wrapper) it rounds p to bf16 before the PV product, as the reference
//    does: a first pass over the key tiles finds each row's max, so that
//    p = exp(s - max) is rounded against the row's max and not against a
//    running one (the score products are done twice).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Hq, hd, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, q_offset, kv_end;
  float scale;
  int vec;  // 16-byte loads allowed (hd % 8 == 0, strides % 8, aligned)
  // (B, Hq, Sq) float32: each row's log-sum-exp m + log l (natural log;
  // -inf for a row that sees no key), for the backward; null to skip
  float* lse;
  // attn_scalar_kernel over a float8 cache: p rounded to bf16 for PV
  int round_p;
};

constexpr float LN2 = 0.6931471805599453f;

// lse of row i of q-head h, batch b, from m and l in log2 units
__device__ __forceinline__ void store_lse_log2(const AttnArgs& a, int b,
                                               int i, int h, float m,
                                               float l) {
  a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + i] =
      l > 0.0f ? (m + log2f(l)) * LN2 : -INFINITY;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// the last key (exclusive) that any row of tile [r0, r0 + nr) can see
__device__ __forceinline__ int tile_key_end(const AttnArgs& a, int r0,
                                            int nr) {
  int kend = a.kv_end;
  if (a.causal) {
    const long long last = static_cast<long long>(a.q_offset) +
                           (r0 + nr - 1) / a.group + 1;
    kend = static_cast<int>(last < kend ? last : kend);
  }
  return kend;
}

// ---------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------

constexpr int S_BM = 32, S_BN = 32, S_THREADS = 128, S_LDS = S_BN + 1;

size_t scalar_smem_bytes(int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         ((S_BM + 2 * S_BN) * static_cast<size_t>(ld) + S_BM * S_LDS +
          3 * S_BM);
}

// keys [j0, j0 + nk) of the tile into sK (and the values into sV unless
// it is null), zeros past nk
__device__ __forceinline__ void scalar_load_kv(const AttnArgs& a,
                                               const float* k,
                                               const float* v, float* sK,
                                               float* sV, int j0, int nk) {
  const int hd = a.hd, ld = hd + 1;
  for (int e = threadIdx.x; e < S_BN * hd; e += S_THREADS) {
    const int c = e / hd, d = e - c * hd;
    float kx = 0.0f, vx = 0.0f;
    if (c < nk) {
      const long long j = j0 + c;
      kx = k[j * a.k_ss + d];
      if (sV != nullptr) vx = v[j * a.v_ss + d];
    }
    sK[c * ld + d] = kx;
    if (sV != nullptr) sV[c * ld + d] = vx;
  }
}

// the tile's scaled scores into sS, -inf where a key is hidden: thread
// owns row tid / 4, columns tid % 4 + 4u
__device__ __forceinline__ void scalar_scores(const AttnArgs& a,
                                              const float* sQ,
                                              const float* sK, float* sS,
                                              int r0, int j0, int nk) {
  const int hd = a.hd, ld = hd + 1;
  const int rr = threadIdx.x >> 2, c0 = threadIdx.x & 3;
  float s[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) s[u] = 0.0f;
  for (int d = 0; d < hd; ++d) {
    const float qd = sQ[rr * ld + d];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      s[u] = fmaf(qd, sK[(c0 + 4 * u) * ld + d], s[u]);
  }
  const long long lim = static_cast<long long>(a.q_offset) +
                        (r0 + rr) / a.group;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int c = c0 + 4 * u, j = j0 + c;
    const bool vis = c < nk && (!a.causal || j <= lim);
    sS[rr * S_LDS + c] = vis ? s[u] * a.scale : -INFINITY;
  }
}

// KD = ceil(hd / 32): each thread owns 8 rows x KD columns of acc
template <int KD>
__global__ void __launch_bounds__(S_THREADS)
    attn_scalar_kernel(const AttnArgs a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ld = hd + 1;  // +1: no bank conflicts on sK rows
  float* sQ = smem;                  // S_BM x ld
  float* sK = sQ + S_BM * ld;        // S_BN x ld
  float* sV = sK + S_BN * ld;        // S_BN x ld
  float* sS = sV + S_BN * ld;        // S_BM x S_LDS: scores, then p
  float* sM = sS + S_BM * S_LDS;     // running row max
  float* sL = sM + S_BM;             // running row sum
  float* sA = sL + S_BM;             // this tile's rescale factor

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int r0 = blockIdx.x * S_BM;
  const int nr = min(S_BM, a.Sq * a.group - r0);
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int e = tid; e < S_BM * hd; e += S_THREADS) {
    const int rr = e / hd, d = e - rr * hd;
    float x = 0.0f;
    if (rr < nr) {
      const int r = r0 + rr, i = r / a.group;
      const int h = kvh * a.group + (r - i * a.group);
      x = q[i * a.q_ss + h * a.q_sh + d];
    }
    sQ[rr * ld + d] = x;
  }
  if (tid < S_BM) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.0f;
  }

  float acc[8][KD];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < KD; ++c) acc[j][c] = 0.0f;

  const int kend = tile_key_end(a, r0, nr);
  if (a.round_p) {
    // first pass: each row's max over all its keys into sM, so that the
    // second pass's running max is final from its first tile (alpha 1)
    for (int j0 = 0; j0 < kend; j0 += S_BN) {
      __syncthreads();  // the previous tile is used up (first: sQ, sM)
      const int nk = min(S_BN, kend - j0);
      scalar_load_kv(a, k, v, sK, nullptr, j0, nk);
      __syncthreads();
      scalar_scores(a, sQ, sK, sS, r0, j0, nk);
      __syncthreads();
      for (int t = 0; t < 8; ++t) {
        const int rr = warp * 8 + t;
        const float m = warp_max(sS[rr * S_LDS + lane]);
        if (lane == 0) sM[rr] = fmaxf(sM[rr], m);
      }
    }
  }
  for (int j0 = 0; j0 < kend; j0 += S_BN) {
    __syncthreads();  // the previous tile is used up (first: sQ written)
    const int nk = min(S_BN, kend - j0);
    scalar_load_kv(a, k, v, sK, sV, j0, nk);
    __syncthreads();
    scalar_scores(a, sQ, sK, sS, r0, j0, nk);
    __syncthreads();
    // online softmax: warp w updates rows 8w..8w+7, one column per lane
    for (int t = 0; t < 8; ++t) {
      const int rr = warp * 8 + t;
      const float x = sS[rr * S_LDS + lane];
      const float m_old = sM[rr];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float p = expf(x - m_use);
      const float psum = warp_sum(p);  // the row sum adds p unrounded
      sS[rr * S_LDS + lane] =
          a.round_p ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);
        sA[rr] = alpha;
        sL[rr] = sL[rr] * alpha + psum;
        sM[rr] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P V: thread owns rows warp + 4j, cols lane + 32c
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float alpha = sA[warp + 4 * j];
#pragma unroll
      for (int c = 0; c < KD; ++c) acc[j][c] *= alpha;
    }
    for (int kc = 0; kc < nk; ++kc) {
      float vv[KD];
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < hd ? sV[kc * ld + d] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = sS[(warp + 4 * j) * S_LDS + kc];
#pragma unroll
        for (int c = 0; c < KD; ++c) acc[j][c] = fmaf(p, vv[c], acc[j][c]);
      }
    }
  }
  __syncthreads();  // sL is final (and initialised when no tile ran)

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int rr = warp + 4 * j;
    if (rr >= nr) continue;
    const int r = r0 + rr, i = r / a.group;
    const int h = kvh * a.group + (r - i * a.group);
    const float l = sL[rr];
    const float inv = l > 0.0f ? 1.0f / l : 0.0f;
    if (a.lse != nullptr && lane == 0)
      a.lse[(static_cast<long long>(b) * a.Hq + h) * a.Sq + i] =
          l > 0.0f ? sM[rr] + logf(l) : -INFINITY;
    float* orow = o + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) *
                          hd;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) orow[d] = acc[j][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16)
// ---------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int M_BM = 64, M_BN = 64, M_THREADS = 128;

template <int HDP>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * static_cast<size_t>(M_BM + 2 * M_BN) * (HDP + 8);
}

// one row of HDP values (zeros past hd, or everywhere when src is null)
// into shared memory, 8 values per chunk; chunk ch of the row
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* src,
                                            int ch, int hd, int vec) {
  const int d0 = ch * 8;
  if (src != nullptr && vec && d0 < hd) {
    *reinterpret_cast<uint4*>(dst + d0) =
        *reinterpret_cast<const uint4*>(src + d0);
    return;
  }
  const bf16 zero = __ushort_as_bfloat16(0);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int d = d0 + e;
    dst[d] = (src != nullptr && d < hd) ? src[d] : zero;
  }
}

// LSE: write each row's log-sum-exp to a.lse (the backward's input); the
// serving instances (LSE false) compile without it
template <int HDP, bool LSE>
__global__ void __launch_bounds__(M_THREADS)
    attn_mma_kernel(const AttnArgs a) {
  constexpr int LD = HDP + 8;  // +16 bytes a row: conflict-free fragments
  constexpr int CH = HDP / 8;  // 16-byte chunks per row
  constexpr int NT = M_BN / 8;  // score n-tiles of a warp
  constexpr int DT = HDP / 8;   // output n-tiles of a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // M_BM x LD
  bf16* sK = sQ + M_BM * LD;                      // M_BN x LD
  bf16* sV = sK + M_BN * LD;                      // M_BN x LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int r0 = blockIdx.x * M_BM;
  const int nr = min(M_BM, a.Sq * a.group - r0);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int e = tid; e < M_BM * CH; e += M_THREADS) {
    const int rr = e / CH, ch = e - rr * CH;
    const bf16* src = nullptr;
    if (rr < nr) {
      const int r = r0 + rr, i = r / a.group;
      const int h = kvh * a.group + (r - i * a.group);
      src = q + i * a.q_ss + h * a.q_sh;
    }
    stage_chunk(sQ + rr * LD, src, ch, a.hd, a.vec);
  }

  // this thread's two rows: g and g + 8 of the warp's 16
  const int row0 = warp * 16 + g;
  const long long lim0 =
      static_cast<long long>(a.q_offset) + (r0 + row0) / a.group;
  const long long lim1 =
      static_cast<long long>(a.q_offset) + (r0 + row0 + 8) / a.group;
  const float scale_log2 = a.scale * 1.4426950408889634f;

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  const int kend = tile_key_end(a, r0, nr);
  for (int j0 = 0; j0 < kend; j0 += M_BN) {
    __syncthreads();  // the previous tile is used up (first: sQ written)
    const int nk = min(M_BN, kend - j0);
    for (int e = tid; e < M_BN * CH; e += M_THREADS) {
      const int c = e / CH, ch = e - c * CH;
      const bool ok = c < nk;
      const long long j = j0 + c;
      stage_chunk(sK + c * LD, ok ? k + j * a.k_ss : nullptr, ch, a.hd,
                       a.vec);
      stage_chunk(sV + c * LD, ok ? v + j * a.v_ss : nullptr, ch, a.hd,
                       a.vec);
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const bf16* qa = sQ + row0 * LD + kk * 16 + 2 * t;
      const uint32_t a0 = lds32(qa), a1 = lds32(qa + 8 * LD);
      const uint32_t a2 = lds32(qa + 8), a3 = lds32(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const bf16* kb = sK + (n * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[n], a0, a1, a2, a3, lds32(kb), lds32(kb + 8));
      }
    }

    // mask, scale to log2 units, row max over the quad
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int j = j0 + c;
        const long long lim = e < 2 ? lim0 : lim1;
        const bool vis = c < nk && (!a.causal || j <= lim);
        s[n][e] = vis ? s[n][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mu0);
      s[n][1] = exp2f(s[n][1] - mu0);
      s[n][2] = exp2f(s[n][2] - mu1);
      s[n][3] = exp2f(s[n][3] - mu1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;  // this thread's part; the quad sums at the end
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }

    // acc += P V: P (rounded to bf16) from the score registers, V^T
    // fragments gathered from the row-major V tile
#pragma unroll
    for (int kk = 0; kk < M_BN / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vb = sV + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const bf16* vn = vb + n * 8;
        mma_bf16(acc[n], a0, a1, a2, a3, pack_raw(vn[0], vn[LD]),
                 pack_raw(vn[8 * LD], vn[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(~0u, l0, o);
    l1 += __shfl_xor_sync(~0u, l1, o);
  }
  const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
  const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
  bf16* o = static_cast<bf16*>(a.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rr = row0 + 8 * half;
    if (rr >= nr) continue;
    const int r = r0 + rr, i = r / a.group;
    const int h = kvh * a.group + (r - i * a.group);
    const float inv = half ? inv1 : inv0;
    if constexpr (LSE) {
      if (t == 0) store_lse_log2(a, b, i, h, half ? m1 : m0, half ? l1 : l0);
    }
    bf16* orow =
        o + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) * a.hd;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = n * 8 + 2 * t + e;
        if (d < a.hd) orow[d] = __float2bfloat16_rn(acc[n][2 * half + e] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------
// bf16 prefill: warp-specialised wgmma kernel (FlashAttention-3 shape)
// ---------------------------------------------------------------------

constexpr int W_BM = 128, W_BN = 128, W_STAGES = 2, W_THREADS = 384;
// one 64-column (128-byte) swizzle atom of a 128-row tile (Q, or K / V)
constexpr int W_ATOM = 128 * 128;
static_assert(W_BM == 128 && W_BN == 128, "W_ATOM assumes 128-row tiles");

template <int HD>
constexpr size_t wgmma_smem_bytes() {
  // 1024 of slack for the 1024-byte alignment of the swizzle atoms, then
  // Q, the K and V rings, and 3 x W_STAGES mbarriers
  return 1024 + static_cast<size_t>(HD / 64) * W_ATOM * (1 + 2 * W_STAGES) +
         8 * 3 * W_STAGES;
}

template <int HD, bool LSE>  // LSE: as attn_mma_kernel's
__global__ void __launch_bounds__(W_THREADS, 1)
    attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const AttnArgs a, const KvDims dims, const int n_mtiles,
                      const int Hkv) {
  constexpr int NA = HD / 64;   // swizzle atoms across hd
  constexpr int ON = HD / 2;    // O registers of a thread (m64 x HD)
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base;                                // NA atoms
  const uint32_t sK = sQ + NA * W_ATOM;                    // W_STAGES x NA
  const uint32_t sV = sK + W_STAGES * NA * W_ATOM;         // W_STAGES x NA
  const uint32_t bars = sV + W_STAGES * NA * W_ATOM;
  // full_k[s], full_v[s]: the tile's K / V have landed; empty[s]: all 8
  // consumer warps are done with stage s
  auto full_k = [&](int s) { return bars + 8 * s; };
  auto full_v = [&](int s) { return bars + 8 * (W_STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * W_STAGES + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  // the longest causal Q tiles first: blockIdx.x walks the Q tiles from
  // the last one down, every (kv-head, batch) of one tile together
  const int per = static_cast<int>(gridDim.x) / n_mtiles;  // Hkv * B
  const int mt = n_mtiles - 1 - static_cast<int>(blockIdx.x) / per;
  const int rem = static_cast<int>(blockIdx.x) % per;
  const int kvh = rem % Hkv, b = rem / Hkv;
  const int rows = a.Sq * a.group;
  const int r0 = mt * W_BM;
  const int nr = min(W_BM, rows - r0);
  const int kend = tile_key_end(a, r0, nr);
  const int n_tiles = kend > 0 ? (kend + W_BN - 1) / W_BN : 0;

  if (tid == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the K / V ring full by TMA ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 2 * 128) {
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % W_STAGES;
        const uint32_t ph = (n / W_STAGES) & 1;
        mbar_wait(empty(st), ph ^ 1);
        const int j0 = n * W_BN;
        auto at = [&](int pos) {
          return pos == dims.key ? j0 : pos == dims.head ? kvh : b;
        };
        mbar_expect_tx(full_k(st), NA * W_ATOM);
#pragma unroll
        for (int c = 0; c < NA; ++c)
          tma_load_4d(sK + (st * NA + c) * W_ATOM, &tm_k, full_k(st), c * 64,
                      at(1), at(2), at(3));
        mbar_expect_tx(full_v(st), NA * W_ATOM);
#pragma unroll
        for (int c = 0; c < NA; ++c)
          tma_load_4d(sV + (st * NA + c) * W_ATOM, &tm_v, full_v(st), c * 64,
                      at(1), at(2), at(3));
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns tile rows wg * 64 .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t128 = tid & 127, warp = t128 >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;

    // Q rows into the 128-byte swizzle (16-byte chunk ch of row `row` at
    // chunk ch ^ (row % 8) of its atom row); zeros past the last row
    constexpr int CH = HD / 8;
    for (int e = t128; e < 64 * CH; e += 128) {
      const int rr = e / CH, ch = e - rr * CH;
      const int row = wg * 64 + rr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (row < nr) {
        const int r = r0 + row, i = r / a.group;
        const int h = kvh * a.group + (r - i * a.group);
        val = *reinterpret_cast<const uint4*>(q + i * a.q_ss + h * a.q_sh +
                                              ch * 8);
      }
      const int off = (ch >> 3) * W_ATOM + row * 128 +
                      (((ch & 7) ^ (row & 7)) << 4);
      *reinterpret_cast<uint4*>(gbase + off) = val;
    }
    // make the generic-proxy stores visible to wgmma, then sync the group
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    // this thread's two rows of the tile, and the last key each may see
    const int rowA = wg * 64 + warp * 16 + g;
    long long lim[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      long long l = a.kv_end - 1;
      if (a.causal) {
        const long long c =
            static_cast<long long>(a.q_offset) + (r0 + rowA + 8 * hh) / a.group;
        l = c < l ? c : l;
      }
      lim[hh] = l;
    }
    // the block's first row sees the fewest keys: tiles up to its last
    // key need no mask
    long long lim_block = a.kv_end - 1;
    if (a.causal) {
      const long long c = static_cast<long long>(a.q_offset) + r0 / a.group;
      lim_block = c < lim_block ? c : lim_block;
    }
    const float sl2 = a.scale * 1.4426950408889634f;

    float o[ON];
#pragma unroll
    for (int i = 0; i < ON; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    const uint32_t qa = sQ + wg * 64 * 128;

    for (int n = 0; n < n_tiles; ++n) {
      const int st = n % W_STAGES;
      const uint32_t ph = (n / W_STAGES) & 1;
      const int j0 = n * W_BN;
      const uint32_t kt = sK + st * NA * W_ATOM;
      const uint32_t vt = sV + st * NA * W_ATOM;

      // S = Q K^T (64 x 128 keys), both K-major in shared memory
      float s[64];
      mbar_wait(full_k(st), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk >> 2) * W_ATOM + (kk & 3) * 32;
        wgmma_ss_n128(s, smem_desc(qa + off, 16, 1024),
                      smem_desc(kt + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // s[i]: row rowA + 8 * ((i >> 1) & 1), key j0 + (i >> 2) * 8 + 2t +
      // (i & 1); scaled to log2 units, masked only where a row's last key
      // falls inside the tile
      if (j0 + W_BN - 1 > lim_block) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int j = j0 + (i >> 2) * 8 + 2 * t + (i & 1);
          s[i] = j <= lim[(i >> 1) & 1] ? s[i] * sl2 : -INFINITY;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= sl2;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float mu0 = mn0 == -INFINITY ? 0.0f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.0f : mn1;
      const float al0 = exp2f(m0 - mu0), al1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
        s[i] = exp2f(s[i] - mu0);
        s[i + 1] = exp2f(s[i + 1] - mu0);
        s[i + 2] = exp2f(s[i + 2] - mu1);
        s[i + 3] = exp2f(s[i + 3] - mu1);
        ps0 += s[i] + s[i + 1];
        ps1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * al0 + ps0;  // this thread's part; the quad sums at the end
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int i = 0; i < ON; ++i) o[i] *= ((i >> 1) & 1) ? al1 : al0;

      // P (rounded to bf16) as wgmma's register A operand: k-step kk
      // covers keys 16kk .. 16kk + 15, the S columns of groups 2kk, 2kk+1
      uint32_t pa[W_BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < W_BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P V, V MN-major (hd contiguous) in shared memory
      mbar_wait(full_v(st), ph);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BN / 16; ++kk) {
        const uint64_t dv = smem_desc(vt + kk * 16 * 128, W_ATOM, 1024);
        if constexpr (HD == 128) {
          wgmma_rs_n128(o, pa[kk], dv);
        } else {
          wgmma_rs_n64(o, pa[kk], dv);
        }
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(~0u, l0, off);
      l1 += __shfl_xor_sync(~0u, l1, off);
    }
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    bf16* out = static_cast<bf16*>(a.o);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = rowA + 8 * hh;
      if (row >= nr) continue;
      const int r = r0 + row, i = r / a.group;
      const int h = kvh * a.group + (r - i * a.group);
      const float inv = hh ? inv1 : inv0;
      if constexpr (LSE) {
        if (t == 0) store_lse_log2(a, b, i, h, hh ? m1 : m0, hh ? l1 : l0);
      }
      bf16* orow =
          out + ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) * HD;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        *reinterpret_cast<uint32_t*>(orow + n8 * 8 + 2 * t) =
            pack_bf16(o[4 * n8 + 2 * hh] * inv, o[4 * n8 + 2 * hh + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------
// decode: split-K over the cache, then a log-sum-exp merge
// ---------------------------------------------------------------------

// 32-key tiles keep a block's shared memory near 45 KB at hd 128, so the
// 288 blocks of a granite-8b decode step fit on the card in one wave
constexpr int K_TK = 32, K_THREADS = 128, K_ROWS = 16, K_LDS = K_TK + 1;
constexpr int K_MAX_SPLITS = 1024;  // attn_combine_kernel's weights

struct SplitArgs {
  int chunk, splits;  // keys of a split (a multiple of K_TK), splits
  float* part_o;      // (B, Hkv, splits, rows, hd): unnormalised acc
  float* part_ml;     // (B, Hkv, splits, rows, 2): m (log2 units), l
};

// The cache's element: KVB bytes a value, 2 for bf16, 1 for float8 e4m3
// (a KV cache made with kv_cache_dtype="f8"). A 16-byte copy carries
// kv_per16<KVB>() values; a staged row holds HDP values and one such
// copy of padding (so consecutive rows start 4 banks apart).
template <int KVB>
__host__ __device__ constexpr int kv_per16() {
  return 16 / KVB;
}

template <int HDP, int KVB>
constexpr size_t splitk_smem_bytes() {
  return static_cast<size_t>(KVB) * 4 * K_TK * (HDP + kv_per16<KVB>()) +
         sizeof(float) * (K_ROWS * HDP + K_ROWS * K_LDS + 3 * K_ROWS);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
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

// Two float8 e4m3 values (the low byte first) as floats: through f16
// (cvt.rn.f16x2.e4m3x2 on sm_90), which holds every e4m3 value exactly,
// subnormals and NaN included, then to f32. The same values as the bf16
// the plain version dequantises to.
__device__ __forceinline__ float2 e4m3x2_to_float2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  return __half22float2(__half2(h));
}

// the 16 / KVB values of a 16-byte staged chunk as floats
template <int KVB>
__device__ __forceinline__ void unpack16(const uint4 raw, float* f) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (KVB == 2) {  // a bf16 is the top half of its float
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    } else {
      const float2 lo = e4m3x2_to_float2(w[e]);
      const float2 hi = e4m3x2_to_float2(w[e] >> 16);
      f[4 * e] = lo.x;
      f[4 * e + 1] = lo.y;
      f[4 * e + 2] = hi.x;
      f[4 * e + 3] = hi.y;
    }
  }
}

// two neighbouring values of a staged row as floats
template <int KVB>
__device__ __forceinline__ float2 load2(const unsigned char* p) {
  if constexpr (KVB == 2) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  } else {
    return e4m3x2_to_float2(*reinterpret_cast<const uint16_t*>(p));
  }
}

// rows c < nk of a K or V tile (keys j0 + c) into shared memory rows of
// HDP + kv_per16 values: cp.async when 16-byte loads are allowed, else
// plain loads. Columns past hd and rows past nk keep the zeros the kernel
// wrote first (or, at a chunk's end, a finite earlier row whose p is 0).
// ss is the source's key stride in values.
template <int HDP, int KVB>
__device__ __forceinline__ void splitk_stage(unsigned char* dst,
                                             const unsigned char* src,
                                             long long ss, int j0, int nk,
                                             int hd, int vec, int tid) {
  constexpr int VPC = kv_per16<KVB>(), LD = HDP + VPC, CH = HDP / VPC;
  for (int e = tid; e < K_TK * CH; e += K_THREADS) {
    const int c = e / CH, ch = e - c * CH;
    if (c >= nk || ch * VPC >= hd) continue;
    const unsigned char* p = src + ((j0 + c) * ss + ch * VPC) * KVB;
    unsigned char* d = dst + (c * LD + ch * VPC) * KVB;
    if (vec) {
      cp_async16(d, p);
    } else {
#pragma unroll
      for (int u = 0; u < VPC * KVB; ++u)
        d[u] = ch * VPC + u / KVB < hd ? p[u] : 0;
    }
  }
}

// KVB 2: the bf16 cache (route splitk); KVB 1: the float8 e4m3 cache
// (route splitk_f8), staged as it is stored -- a tile's shared memory
// halves, each cp.async carries 16 values -- and widened to float where
// the products read it (unpack16, load2). Q, the scores, p (rounded to
// bf16) and the partials are the same for both.
template <int HDP, int KVB>
__global__ void __launch_bounds__(K_THREADS)
    attn_splitk_kernel(const AttnArgs a, const SplitArgs sp) {
  constexpr int VPC = kv_per16<KVB>(), LD = HDP + VPC;
  constexpr int TILE = K_TK * LD * KVB;  // bytes of one staged tile
  // P V: TPG threads across hd (two columns each) x NRG row groups
  constexpr int TPG = HDP / 2 < K_THREADS ? HDP / 2 : K_THREADS;
  constexpr int NRG = K_THREADS / TPG;
  constexpr int RPT = K_ROWS / NRG;
  static_assert(NRG <= K_ROWS, "HDP too small");
  static_assert(HDP % VPC == 0, "a row is whole 16-byte chunks");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = smem_raw;                    // 2 tiles
  unsigned char* sV = sK + 2 * TILE;               // 2 tiles
  float* sQ = reinterpret_cast<float*>(sV + 2 * TILE);  // rows x HDP
  float* sS = sQ + K_ROWS * HDP;  // K_ROWS x K_LDS: scores, then p
  float* sM = sS + K_ROWS * K_LDS;
  float* sL = sM + K_ROWS;
  float* sA = sL + K_ROWS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int R = a.Sq * a.group, hd = a.hd;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const unsigned char* k = static_cast<const unsigned char*>(a.k) +
                           (b * a.k_sb + kvh * a.k_sh) * KVB;
  const unsigned char* v = static_cast<const unsigned char*>(a.v) +
                           (b * a.v_sb + kvh * a.v_sh) * KVB;

  for (int e = tid; e < 4 * TILE / 16; e += K_THREADS)
    reinterpret_cast<uint4*>(sK)[e] = make_uint4(0u, 0u, 0u, 0u);
  // Q as float32, 8 values a thread (one 16-byte load where allowed), so
  // the block waits for one round trip, not one per value
  for (int e = tid; e < K_ROWS * HDP / 8; e += K_THREADS) {
    const int r = e / (HDP / 8), d0 = (e - r * (HDP / 8)) * 8;
    float x[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (r < R && d0 < hd) {
      const int i = r / a.group;
      const int h = kvh * a.group + (r - i * a.group);
      const bf16* src = q + i * a.q_ss + h * a.q_sh + d0;
      if (a.vec) {
        unpack16<2>(*reinterpret_cast<const uint4*>(src), x);
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (d0 + u < hd) x[u] = __bfloat162float(src[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) sQ[r * HDP + d0 + u] = x[u];
  }
  if (tid < K_ROWS) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.0f;
  }
  const int kend = tile_key_end(a, 0, R);
  const int c0 = split * sp.chunk;
  const int c1 = min(kend, c0 + sp.chunk);
  const int nt = c1 > c0 ? (c1 - c0 + K_TK - 1) / K_TK : 0;
  const float sl2 = a.scale * 1.4426950408889634f;
  float acc[RPT][2];
#pragma unroll
  for (int u = 0; u < RPT; ++u) acc[u][0] = acc[u][1] = 0.0f;
  __syncthreads();  // the zeros land before any cp.async

  if (nt > 0) {
    splitk_stage<HDP, KVB>(sK, k, a.k_ss, c0, min(K_TK, c1 - c0), hd, a.vec,
                           tid);
    cp_async_commit();
    splitk_stage<HDP, KVB>(sV, v, a.v_ss, c0, min(K_TK, c1 - c0), hd, a.vec,
                           tid);
    cp_async_commit();
  }
  for (int n = 0; n < nt; ++n) {
    const int buf = n & 1, j0 = c0 + n * K_TK, nk = min(K_TK, c1 - j0);
    const bool more = n + 1 < nt;
    if (more) {  // the next tile's K and V, in flight during this one
      const int j1 = j0 + K_TK, nk1 = min(K_TK, c1 - j1);
      splitk_stage<HDP, KVB>(sK + (buf ^ 1) * TILE, k, a.k_ss, j1, nk1, hd,
                             a.vec, tid);
      cp_async_commit();
      splitk_stage<HDP, KVB>(sV + (buf ^ 1) * TILE, v, a.v_ss, j1, nk1, hd,
                             a.vec, tid);
      cp_async_commit();
      cp_async_wait<3>();  // this tile's K has landed
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();

    {  // scores: thread owns key c and rows rh, rh + 4, ...
      constexpr int RS = K_ROWS * K_TK / K_THREADS;  // rows of a thread
      const int c = tid & (K_TK - 1), rh = tid / K_TK;
      float sacc[RS];
#pragma unroll
      for (int u = 0; u < RS; ++u) sacc[u] = 0.0f;
      const unsigned char* kr = sK + buf * TILE + c * LD * KVB;
#pragma unroll 4
      for (int d0 = 0; d0 < HDP; d0 += VPC) {
        float kf[VPC];
        unpack16<KVB>(*reinterpret_cast<const uint4*>(kr + d0 * KVB), kf);
#pragma unroll
        for (int u = 0; u < RS; ++u) {
          const int r = rh + (K_THREADS / K_TK) * u;
          if (r < R) {
            float x = sacc[u];
#pragma unroll
            for (int e = 0; e < VPC; e += 4) {
              const float4 qa = *reinterpret_cast<const float4*>(
                  sQ + r * HDP + d0 + e);
              x = fmaf(qa.x, kf[e], x);
              x = fmaf(qa.y, kf[e + 1], x);
              x = fmaf(qa.z, kf[e + 2], x);
              x = fmaf(qa.w, kf[e + 3], x);
            }
            sacc[u] = x;
          }
        }
      }
      const int j = j0 + c;
#pragma unroll
      for (int u = 0; u < RS; ++u) {
        const int r = rh + (K_THREADS / K_TK) * u;
        if (r < R) {
          const long long lim =
              static_cast<long long>(a.q_offset) + r / a.group;
          const bool vis = c < nk && (!a.causal || j <= lim);
          sS[r * K_LDS + c] = vis ? sacc[u] * sl2 : -INFINITY;
        }
      }
    }
    __syncthreads();
    // online softmax: warp w takes rows w, w + 4, ...; a key a lane
    static_assert(K_TK == 32, "one key a lane");
    for (int r = warp; r < R; r += K_THREADS / 32) {
      const float x = sS[r * K_LDS + lane];
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float p = exp2f(x - m_use);
      const float psum = warp_sum(p);
      sS[r * K_LDS + lane] = __bfloat162float(__float2bfloat16_rn(p));
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        sA[r] = alpha;
        sL[r] = sL[r] * alpha + psum;
        sM[r] = m_new;
      }
    }
    if (more) {
      cp_async_wait<2>();  // this tile's V has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {  // acc = acc * alpha + P V: columns 2cp, 2cp + 1, rows rg + NRG u
      const int cp = tid % TPG, rg = tid / TPG;
#pragma unroll
      for (int u = 0; u < RPT; ++u) {
        const int r = rg + NRG * u;
        if (r < R) {
          const float al = sA[r];
          acc[u][0] *= al;
          acc[u][1] *= al;
        }
      }
      const unsigned char* vc = sV + buf * TILE + 2 * cp * KVB;
#pragma unroll 4
      for (int c = 0; c < K_TK; ++c) {
        const float2 vv = load2<KVB>(vc + c * LD * KVB);
#pragma unroll
        for (int u = 0; u < RPT; ++u) {
          const int r = rg + NRG * u;
          if (r < R) {
            const float p = sS[r * K_LDS + c];
            acc[u][0] = fmaf(p, vv.x, acc[u][0]);
            acc[u][1] = fmaf(p, vv.y, acc[u][1]);
          }
        }
      }
    }
    __syncthreads();  // the buffer and sS are free again
  }

  const long long pbase =
      ((static_cast<long long>(b) * gridDim.y + kvh) * sp.splits + split) * R;
  {
    const int cp = tid % TPG, rg = tid / TPG;
#pragma unroll
    for (int u = 0; u < RPT; ++u) {
      const int r = rg + NRG * u;
      if (r >= R) continue;
      float* po = sp.part_o + (pbase + r) * hd;
      if (2 * cp < hd) po[2 * cp] = acc[u][0];
      if (2 * cp + 1 < hd) po[2 * cp + 1] = acc[u][1];
    }
  }
  if (tid < R) {
    sp.part_ml[(pbase + tid) * 2] = sM[tid];
    sp.part_ml[(pbase + tid) * 2 + 1] = sL[tid];
  }
}

// one block per (row, kv-head, batch): out = sum_s w_s acc_s / sum_s w_s
// l_s with w_s = 2^(m_s - max m); zeros where no split saw a key. The
// splits' (m, l) are read by the block's threads side by side, and the
// weights kept in shared memory, so the merge waits for few round trips.
__global__ void __launch_bounds__(128)
    attn_combine_kernel(const AttnArgs a, const SplitArgs sp) {
  __shared__ float sw[K_MAX_SPLITS];
  __shared__ float red[4];
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = a.Sq * a.group, hd = a.hd, S = sp.splits;
  const long long base =
      (static_cast<long long>(b) * gridDim.y + kvh) * S * R + r;
  float M = -INFINITY;
  for (int s = tid; s < S; s += 128)
    M = fmaxf(M, sp.part_ml[(base + static_cast<long long>(s) * R) * 2]);
  M = warp_max(M);
  if (lane == 0) red[warp] = M;
  __syncthreads();
  M = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
  bf16* orow = static_cast<bf16*>(a.o) +
               ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) * hd;
  if (M == -INFINITY) {
    for (int d = tid; d < hd; d += 128) orow[d] = __ushort_as_bfloat16(0);
    if (a.lse != nullptr && tid == 0) store_lse_log2(a, b, i, h, M, 0.0f);
    return;
  }
  float L = 0.0f;
  for (int s = tid; s < S; s += 128) {
    const float* ml = sp.part_ml + (base + static_cast<long long>(s) * R) * 2;
    const float w = exp2f(ml[0] - M);  // 0 for a split that saw no key
    sw[s] = w;
    L = fmaf(w, ml[1], L);
  }
  L = warp_sum(L);
  __syncthreads();  // red[] read above; sw[] written
  if (lane == 0) red[warp] = L;
  __syncthreads();
  const float L_all = red[0] + red[1] + red[2] + red[3];
  const float inv = 1.0f / L_all;
  if (a.lse != nullptr && tid == 0) store_lse_log2(a, b, i, h, M, L_all);
  for (int d = tid; d < hd; d += 128) {
    float x = 0.0f;
#pragma unroll 8
    for (int s = 0; s < S; ++s)
      x = fmaf(sw[s], sp.part_o[(base + static_cast<long long>(s) * R) * hd +
                                d],
               x);
    orow[d] = __float2bfloat16_rn(x * inv);
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

template <int KD>
int launch_scalar(const AttnArgs& a, dim3 grid, cudaStream_t s) {
  return launch(attn_scalar_kernel<KD>, grid, S_THREADS,
                scalar_smem_bytes(a.hd), s, a);
}

template <int HDP>
int launch_mma(const AttnArgs& a, dim3 grid, cudaStream_t s) {
  return a.lse != nullptr
             ? launch(attn_mma_kernel<HDP, true>, grid, M_THREADS,
                      mma_smem_bytes<HDP>(), s, a)
             : launch(attn_mma_kernel<HDP, false>, grid, M_THREADS,
                      mma_smem_bytes<HDP>(), s, a);
}

template <int HDP, int KVB>
int launch_splitk(const AttnArgs& a, const SplitArgs& sp, int B, int Hkv,
                  cudaStream_t s) {
  const int rc = launch(attn_splitk_kernel<HDP, KVB>,
                        dim3(sp.splits, Hkv, B), K_THREADS,
                        splitk_smem_bytes<HDP, KVB>(), s, a, sp);
  if (rc != 0) return rc;
  attn_combine_kernel<<<dim3(a.Sq * a.group, Hkv, B), 128, 0, s>>>(a, sp);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_wgmma(const AttnArgs& a, int B, int Hkv, cudaStream_t s) {
  CUtensorMap mk, mv;
  KvDims dk, dv;
  int rc = kv_tensor_map(&mk, &dk, a.k, HD, a.kv_end, Hkv, B, a.k_ss,
                         a.k_sh, a.k_sb, W_BN);
  if (rc == 0)
    rc = kv_tensor_map(&mv, &dv, a.v, HD, a.kv_end, Hkv, B, a.v_ss, a.v_sh,
                       a.v_sb, W_BN);
  if (rc != 0) return rc;
  if (dk.key != dv.key || dk.head != dv.head || dk.batch != dv.batch)
    return static_cast<int>(cudaErrorInvalidValue);  // k, v laid out alike
  const int n_mtiles = (a.Sq * a.group + W_BM - 1) / W_BM;
  const dim3 grid(static_cast<unsigned>(n_mtiles) * Hkv * B);
  return a.lse != nullptr
             ? launch(attn_wgmma_kernel<HD, true>, grid, W_THREADS,
                      wgmma_smem_bytes<HD>(), s, mk, mv, a, dk, n_mtiles, Hkv)
             : launch(attn_wgmma_kernel<HD, false>, grid, W_THREADS,
                      wgmma_smem_bytes<HD>(), s, mk, mv, a, dk, n_mtiles,
                      Hkv);
}

}  // namespace

// q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd): last dimension contiguous,
// strides in elements; out contiguous (B, Sq, Hq, hd), same type.
// dtype: 0 = float32, 1 = bfloat16 (q's; k and v the same, except at
// route 4). 1 <= hd <= 256, Hq % Hkv == 0, 0 <= kv_end <= Skv. vec: 1 if
// 16-byte loads are allowed (bf16 q; at route 4 also hd and the k / v
// strides multiples of 16). route (the wrapper's choice by shape): 0
// attn_scalar_kernel (float32), 1 attn_mma_kernel, 2 attn_wgmma_kernel
// (hd 64 or 128, vec), 3 attn_splitk_kernel + attn_combine_kernel
// (Sq * Hq / Hkv <= 16), 4 the same with float8 e4m3 k and v (a float8
// KV cache); 3 and 4 take `splits` chunks of `chunk` keys and float32
// scratch part_o (B, Hkv, splits, Sq * Hq / Hkv, hd) and part_ml
// (..., 2). round_p: 1 only at route 0 over the float32 copies of a
// float8 cache (p rounded to bf16 against the row's max). lse: null, or
// float32 (B, Hq, Sq) that every route fills with each row's log-sum-exp
// (the backward's input; the output is the same either way).
REPRO_EXPORT int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Hq, int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int q_offset, int kv_end,
    int dtype, int vec, int route, int chunk, int splits, int round_p,
    void* part_o, void* part_ml, void* lse, void* stream) {
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0 ||
      (dtype == 0) != (route == 0) || (round_p != 0 && route != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs a{q,      k,        v,      out,  Sq,   Hq,   hd,
                   Hq / Hkv, q_sb,   q_ss,     q_sh,   k_sb, k_ss, k_sh,
                   v_sb,   v_ss,     v_sh,   causal, q_offset, kv_end,
                   1.0f / sqrtf(static_cast<float>(hd)), vec,
                   static_cast<float*>(lse), round_p};
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(Sq) * a.group;
  if (route == 2) {
    if (!vec || (hd != 64 && hd != 128))
      return static_cast<int>(cudaErrorInvalidValue);
    return hd == 64 ? launch_wgmma<64>(a, B, Hkv, s)
                    : launch_wgmma<128>(a, B, Hkv, s);
  }
  if (route == 3 || route == 4) {
    if (rows > K_ROWS || splits < 1 || splits > K_MAX_SPLITS || chunk < 1 ||
        part_o == nullptr || part_ml == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const SplitArgs sp{chunk, splits, static_cast<float*>(part_o),
                       static_cast<float*>(part_ml)};
    if (route == 4) {  // float8 e4m3 keys and values
      if (hd <= 16) return launch_splitk<16, 1>(a, sp, B, Hkv, s);
      if (hd <= 32) return launch_splitk<32, 1>(a, sp, B, Hkv, s);
      if (hd <= 64) return launch_splitk<64, 1>(a, sp, B, Hkv, s);
      if (hd <= 128) return launch_splitk<128, 1>(a, sp, B, Hkv, s);
      return launch_splitk<256, 1>(a, sp, B, Hkv, s);
    }
    if (hd <= 16) return launch_splitk<16, 2>(a, sp, B, Hkv, s);
    if (hd <= 32) return launch_splitk<32, 2>(a, sp, B, Hkv, s);
    if (hd <= 64) return launch_splitk<64, 2>(a, sp, B, Hkv, s);
    if (hd <= 128) return launch_splitk<128, 2>(a, sp, B, Hkv, s);
    return launch_splitk<256, 2>(a, sp, B, Hkv, s);
  }
  if (route == 1) {
    const dim3 grid(static_cast<unsigned>((rows + M_BM - 1) / M_BM), Hkv, B);
    if (hd <= 16) return launch_mma<16>(a, grid, s);
    if (hd <= 32) return launch_mma<32>(a, grid, s);
    if (hd <= 64) return launch_mma<64>(a, grid, s);
    if (hd <= 128) return launch_mma<128>(a, grid, s);
    return launch_mma<256>(a, grid, s);
  }
  if (route != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((rows + S_BM - 1) / S_BM), Hkv, B);
  switch ((hd + 31) / 32) {
    case 1: return launch_scalar<1>(a, grid, s);
    case 2: return launch_scalar<2>(a, grid, s);
    case 3: return launch_scalar<3>(a, grid, s);
    case 4: return launch_scalar<4>(a, grid, s);
    case 5: return launch_scalar<5>(a, grid, s);
    case 6: return launch_scalar<6>(a, grid, s);
    case 7: return launch_scalar<7>(a, grid, s);
    default: return launch_scalar<8>(a, grid, s);
  }
}
