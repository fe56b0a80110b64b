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
//    and 544 positions, 0.0027 ms at 3.35 TB/s; 268 MB at 32,768, 0.160
//    ms). The key range [0, kv_end) is cut into chunks of whole rounds of
//    the block's four warps' 32-key tiles, about one wave of blocks (two
//    an SM); each block reads its chunk once for the whole GQA group.
//    Each warp owns every fourth tile of the chunk and streams its tiles
//    through a ring of its own (1-4 stages by cp.async, zeros past the
//    chunk's end), so the key loop never waits on the block; the scores
//    and P V run on the tensor cores (mma.sync m16n8k16, the group's rows
//    padded to 16), the online-softmax state stays in the warp's
//    registers, and the warps' states are merged by log-sum-exp at the
//    block's end into float32 partials (m, l, acc); a second launch, a
//    programmatic dependent of the first (its blocks start while the
//    first grid runs and wait for its end), merges the chunks' partials.
//    A chunk of one round (a short cache) gets a one-stage ring: more
//    blocks an SM. A chunk that sees no key writes m = -inf, l = 0 and
//    adds nothing; a launch whose rows see no key at all (kv_end 0: a
//    slot of a sharded cache past the decoded position) runs one empty
//    split and writes zeros and an lse of -inf. On request the merge
//    writes float32 out, a slot's partial for flash_decode's merge
//    across slots. The same kernel reads a float8 (e4m3) KV cache (route splitk_f8,
//    bf16 q): a tile is staged as stored, one byte a value, so the
//    copies and the rings halve, and each byte is widened once, exactly,
//    to bf16 where its fragment is built (cvt.rn.f16x2.e4m3x2); bound:
//    half the bytes (4.5 MB at batch 4 and 544 keys, 134 MB at 32,768).
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

// A block is K_WARPS warps over one chunk of the keys of one (kv-head,
// batch). The chunk is cut into 32-key tiles and warp w owns tiles w,
// w + K_WARPS, ...: it streams them through a ring of its own and keeps
// its rows' online-softmax state in registers, so the key loop waits on
// nothing but the warp's own copies (__syncwarp, never __syncthreads).
constexpr int K_TK = 32, K_WARPS = 4, K_THREADS = 32 * K_WARPS, K_ROWS = 16;
constexpr int K_MAX_SPLITS = 1024;  // the most splits a launch takes
// the rings' shared memory: as many stages (2..4) as let two blocks share
// an SM, else (long bf16 rows) as many as one block can hold
constexpr int K_RING_TWO = 96 * 1024, K_RING_ONE = 200 * 1024;

struct SplitArgs {
  int chunk, splits;  // keys of a split, splits
  float* part_o;      // (B, Hkv, splits, rows, hd): unnormalised acc
  float* part_ml;     // (B, Hkv, splits, rows, 2): m (log2 units), l
  int out_f32;        // the merge writes float32 out (a partial that a
                      // merge across slots reads), else bf16
};

__host__ __device__ constexpr int cmin(int x, int y) { return x < y ? x : y; }
__host__ __device__ constexpr int cmax(int x, int y) { return x > y ? x : y; }

// The cache's element: KVB bytes a value, 2 for bf16, 1 for float8 e4m3
// (a KV cache made with kv_cache_dtype="f8"). A tile is staged as stored
// (a float8 tile is half a bf16 one): K_TK rows of HDP values, K then V.
template <int HDP, int KVB>
struct SplitGeom {
  static constexpr int ROWB = HDP * KVB;     // bytes of a staged row
  static constexpr int CPR = ROWB / 16;      // its 16-byte chunks
  static constexpr int TILEB = K_TK * ROWB;  // a K or a V tile
  static constexpr int STAGEB = 2 * TILEB;
  static constexpr int FIT2 = K_RING_TWO / (K_WARPS * STAGEB);
  static constexpr int STAGES =
      FIT2 >= 2 ? cmin(FIT2, 4)
                : cmax(1, cmin(4, K_RING_ONE / (K_WARPS * STAGEB)));
  // the warps' states side by side for the block's merge (the rings'
  // memory, once every warp is done with its ring)
  static constexpr int OLD = HDP + HDP / 32;  // a merge row, padded
  static constexpr int MERGE = K_WARPS * K_ROWS * (OLD + 2) * 4;
  static constexpr int QLD = HDP + 8;        // sQ's row stride (bf16)
  // with ns stages a ring: the rings (or the merge), then Q
  __host__ __device__ static constexpr int scratch(int ns) {
    return cmax(K_WARPS * ns * STAGEB, MERGE);
  }
  __host__ __device__ static constexpr size_t smem(int ns) {
    return static_cast<size_t>(scratch(ns)) + K_ROWS * QLD * 2;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  // bytes < 16: the rest of the 16 arrive as zeros (0: no read at all)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A staged tile's 16-byte chunk L (row r, chunk c: L = r * CPR + c) lies
// at chunk L ^ ((L >> 3) & 7): the chunks of each 128-byte line are
// permuted by the line's index, so that a warp's fragment reads (8 rows
// at 4 offsets, or 4 rows at 8 offsets) fall on distinct banks.
__device__ __forceinline__ int swz(int L) { return L ^ ((L >> 3) & 7); }

// NB bytes (2 .. 64, a power of two) of staged row r from byte o (a
// multiple of min(NB, 16)) into w, low bytes first
template <int CPR, int NB>
__device__ __forceinline__ void lds_row(const unsigned char* tile, int r,
                                        int o, uint32_t* w) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int c = 0; c < NB / 16; ++c) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          tile + swz(r * CPR + (o >> 4) + c) * 16);
      w[4 * c] = x.x;
      w[4 * c + 1] = x.y;
      w[4 * c + 2] = x.z;
      w[4 * c + 3] = x.w;
    }
  } else {
    const unsigned char* p = tile + swz(r * CPR + (o >> 4)) * 16 + (o & 15);
    if constexpr (NB == 8) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x;
      w[1] = x.y;
    } else if constexpr (NB == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
  }
}

// Two float8 e4m3 values (the low byte first) as a bf16 pair, exactly:
// through f16 (cvt.rn.f16x2.e4m3x2), which holds every e4m3 value,
// subnormals and NaN included, and f32; every e4m3 value is a bf16 value,
// so the rounding to bf16 changes none. The same bits as the bf16 copy
// the plain version dequantises to.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t two) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(two & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return pack_bf16(f.x, f.y);
}

// keys [j0, j0 + K_TK) of K or V into a staged tile, zeros from key c1
// on: cp.async where 16-byte loads are allowed (columns past hd keep the
// zeros the kernel wrote first), else plain loads that write every column
// (zeros past hd). ss is the source's key stride in values.
template <int HDP, int KVB>
__device__ __forceinline__ void splitk_stage(unsigned char* dst,
                                             const unsigned char* src,
                                             long long ss, int j0, int c1,
                                             int hd, int vec, int lane) {
  using G = SplitGeom<HDP, KVB>;
  constexpr int VPC = 16 / KVB;  // values a chunk
  if (vec) {
#pragma unroll 4
    for (int e = lane; e < K_TK * G::CPR; e += 32) {
      const int r = e / G::CPR, c = e - r * G::CPR;
      if (c * VPC >= hd) continue;
      const int j = j0 + r;
      const bool ok = j < c1;
      cp_async16(dst + swz(e) * 16, ok ? src + (j * ss + c * VPC) * KVB : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = lane; e < K_TK * HDP; e += 32) {
      const int r = e / HDP, d = e - r * HDP;
      const int j = j0 + r;
      const bool ok = j < c1 && d < hd;
      const unsigned char* p = src + (j * ss + d) * KVB;
      unsigned char* o =
          dst + swz(r * G::CPR + d * KVB / 16) * 16 + (d * KVB) % 16;
      if constexpr (KVB == 2) {
        *reinterpret_cast<uint16_t*>(o) =
            ok ? *reinterpret_cast<const uint16_t*>(p) : 0;
      } else {
        *o = ok ? *p : 0;
      }
    }
  }
}

// tile i of a warp (keys from c0 + (warp + i K_WARPS) K_TK) into slot i %
// NS of its ring, K and V one commit group (empty past the warp's nw
// tiles, so that every lane counts the same groups)
template <int HDP, int KVB, int NS>
__device__ __forceinline__ void splitk_fetch(unsigned char* ring,
                                             const unsigned char* k,
                                             const unsigned char* v,
                                             const AttnArgs& a, int c0,
                                             int c1, int warp, int lane,
                                             int i, int nw) {
  using G = SplitGeom<HDP, KVB>;
  unsigned char* st = ring + (i % NS) * G::STAGEB;
  const int j0 = c0 + (warp + i * K_WARPS) * K_TK;
  if (i < nw) {
    splitk_stage<HDP, KVB>(st, k, a.k_ss, j0, c1, a.hd, a.vec, lane);
    splitk_stage<HDP, KVB>(st + G::TILEB, v, a.v_ss, j0, c1, a.hd, a.vec,
                           lane);
  }
  cp_async_commit();
}

// The decode kernel for both caches: KVB 2 the bf16 cache (route splitk),
// KVB 1 the float8 e4m3 cache (route splitk_f8). Both stage the cache as
// it is stored, hand the tensor cores the same bf16 values (a float8
// byte widened once, exactly, where its fragment is built) and run the
// same mma.sync m16n8k16 in the same order, so the float8 route equals
// the bf16 route on the dequantised copy bit for bit.
//
// A warp's 16 MMA rows are the (query, q-head) rows of the kv-head's
// group, R <= 16, padded with zero rows. Per 32-key tile:
//   S = Q K^T (4 n-tiles of 8 keys, HDP / 16 k-steps). Within a k-step,
//     lane t's four values are hd positions t * HDP / 4 + 4 kk .. + 3 (the
//     A and B fragments permute hd alike, so the sum is unchanged): a lane
//     reads a contiguous run of its K row, and a float8 pair widens to
//     one bf16x2 register with no shuffling.
//   the tile's scores masked (keys at or past the chunk's end c1, and
//     causal), the running max and sum updated, p = 2^(s - m) rounded to
//     bf16 into the A fragments of O += P V straight from the score
//     registers; the sum adds the unrounded p.
//   O += P V (2 k-steps of 16 keys, HDP / 8 n-tiles). Lane g's B column
//     of n-tile n is hd position g * HDP / 8 + n, so a lane reads a
//     contiguous run of each of its four key rows and pairs two keys of a
//     column with one byte permute.
// Keys at or past c1 are staged as zeros (a stale cache tail may be NaN,
// and 0 * NaN is NaN on the tensor cores). At the end the warps' states
// are merged by log-sum-exp in a fixed order and written as the block's
// float32 partial. NS: the ring's stages (1 where no warp has a second
// tile: less shared memory, more blocks an SM).
template <int HDP, int KVB, int NS>
__global__ void __launch_bounds__(K_THREADS)
    attn_splitk_kernel(const AttnArgs a, const SplitArgs sp) {
  using G = SplitGeom<HDP, KVB>;
  constexpr int NT = HDP / 8;                   // O's n-tiles
  constexpr int KGE = cmin(HDP / 4, 16);        // K values read at once
  constexpr int KGW = KGE * KVB / 4;            // ... as 32-bit words
  constexpr int NVG = cmin(NT, 16);             // V columns read at once
  constexpr int VGW = cmax(1, NVG * KVB / 4);   // ... as 32-bit words
  static_assert(HDP >= 16 && HDP % 16 == 0, "whole k-steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + G::scratch(NS));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int R = a.Sq * a.group, hd = a.hd;
  unsigned char* ring = smem_raw + warp * NS * G::STAGEB;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb;
  const unsigned char* k = static_cast<const unsigned char*>(a.k) +
                           (b * a.k_sb + kvh * a.k_sh) * KVB;
  const unsigned char* v = static_cast<const unsigned char*>(a.v) +
                           (b * a.v_sb + kvh * a.v_sh) * KVB;

  const int kend = tile_key_end(a, 0, R);
  const int c0 = split * sp.chunk;
  const int c1 = min(kend, c0 + sp.chunk);
  const int nt = c1 > c0 ? (c1 - c0 + K_TK - 1) / K_TK : 0;
  const int nw = nt > warp ? (nt - warp + K_WARPS - 1) / K_WARPS : 0;
  if (a.vec && hd < HDP) {  // the columns past hd that cp.async skips
    for (int e = lane; e < NS * G::STAGEB / 16; e += 32)
      reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();  // before any lane's copies land on them
  }
  // the first NS tiles in flight while Q is staged
#pragma unroll 1
  for (int i = 0; i < NS; ++i)
    splitk_fetch<HDP, KVB, NS>(ring, k, v, a, c0, c1, warp, lane, i, nw);

  // Q as bf16 rows, zeros past R and hd
  for (int e = tid; e < K_ROWS * HDP / 8; e += K_THREADS) {
    const int r = e / (HDP / 8), d0 = (e - r * (HDP / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < R && d0 < hd) {
      const int i = r / a.group;
      const int h = kvh * a.group + (r - i * a.group);
      const bf16* src = q + i * a.q_ss + h * a.q_sh + d0;
      if (a.vec) {
        x = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t u[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          u[c] = d0 + c < hd ? __bfloat16_as_ushort(src[c]) : 0u;
        x = make_uint4(u[0] | (u[1] << 16), u[2] | (u[3] << 16),
                       u[4] | (u[5] << 16), u[6] | (u[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(sQ + r * G::QLD + d0) = x;
  }
  // the last key each of this lane's rows (g, g + 8) sees
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    long long x = c1 - 1;
    if (a.causal) {
      const long long c = static_cast<long long>(a.q_offset) +
                          (g + 8 * h) / a.group;
      x = c < x ? c : x;
    }
    lim[h] = static_cast<int>(x);
  }
  const float sl2 = a.scale * 1.4426950408889634f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  __syncthreads();  // sQ written

#pragma unroll 1
  for (int i = 0; i < nw; ++i) {
    cp_async_wait<NS - 1>();  // this lane's copies of tile i
    __syncwarp();                 // ... and the other lanes'
    const unsigned char* sK = ring + (i % NS) * G::STAGEB;
    const unsigned char* sV = sK + G::TILEB;
    const int j0 = c0 + (warp + i * K_WARPS) * K_TK;

    // S = Q K^T: n-tile n holds keys j0 + 8n .. + 7 (lane g loads key 8n
    // + g); s[n][0..1] rows g, s[n][2..3] row g + 8, keys 2t, 2t + 1
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kg = 0; kg < HDP / 4 / KGE; ++kg) {
      uint32_t kw[4][KGW];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        lds_row<G::CPR, KGE * KVB>(sK, 8 * n + g,
                                   (t * (HDP / 4) + kg * KGE) * KVB, kw[n]);
#pragma unroll
      for (int kq = 0; kq < KGE / 4; ++kq) {
        const int d = t * (HDP / 4) + kg * KGE + 4 * kq;
        const uint2 qa = *reinterpret_cast<const uint2*>(sQ + g * G::QLD + d);
        const uint2 qb =
            *reinterpret_cast<const uint2*>(sQ + (g + 8) * G::QLD + d);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          uint32_t b0, b1;
          if constexpr (KVB == 2) {
            b0 = kw[n][2 * kq];
            b1 = kw[n][2 * kq + 1];
          } else {
            b0 = e4m3x2_to_bf16x2(kw[n][kq]);
            b1 = e4m3x2_to_bf16x2(kw[n][kq] >> 16);
          }
          mma_bf16(s[n], qa.x, qb.x, qa.y, qb.y, b0, b1);
        }
      }
    }

    // mask, scale to log2 units, the online softmax of rows g, g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * n + 2 * t + (e & 1);
        s[n][e] = key <= lim[e >> 1] ? s[n][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float al[2], mu[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      mu[h] = mn == -INFINITY ? 0.0f : mn;
      al[h] = exp2f(m[h] - mu[h]);
      m[h] = mn;
    }
    float ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        ps[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * al[h] + ps[h];  // lane's part
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= al[0];
      acc[n][1] *= al[0];
      acc[n][2] *= al[1];
      acc[n][3] *= al[1];
    }

    // O += P V: k-step kk takes keys j0 + 16 kk .. + 15 from n-tiles 2kk
    // and 2kk + 1 of S; lane (g, t) reads key rows 2t, 2t + 1, 2t + 8,
    // 2t + 9 of the step at columns g NT .. g NT + NT - 1
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t pa0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t pa1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t pa2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t pa3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int ra = 16 * kk + 2 * t;
#pragma unroll
      for (int vg = 0; vg < NT / NVG; ++vg) {
        uint32_t w[4][VGW];
        const int o = (g * NT + vg * NVG) * KVB;
        lds_row<G::CPR, NVG * KVB>(sV, ra, o, w[0]);
        lds_row<G::CPR, NVG * KVB>(sV, ra + 1, o, w[1]);
        lds_row<G::CPR, NVG * KVB>(sV, ra + 8, o, w[2]);
        lds_row<G::CPR, NVG * KVB>(sV, ra + 9, o, w[3]);
#pragma unroll
        for (int jj = 0; jj < NVG; ++jj) {
          uint32_t b0, b1;
          if constexpr (KVB == 2) {  // the jj-th bf16 of two rows
            const uint32_t sel = jj & 1 ? 0x7632u : 0x5410u;
            b0 = __byte_perm(w[0][jj >> 1], w[1][jj >> 1], sel);
            b1 = __byte_perm(w[2][jj >> 1], w[3][jj >> 1], sel);
          } else {  // the jj-th byte of two rows, widened
            const uint32_t sel = (jj & 3) | (((jj & 3) + 4) << 4);
            b0 = e4m3x2_to_bf16x2(
                __byte_perm(w[0][jj >> 2], w[1][jj >> 2], sel));
            b1 = e4m3x2_to_bf16x2(
                __byte_perm(w[2][jj >> 2], w[3][jj >> 2], sel));
          }
          mma_bf16(acc[vg * NVG + jj], pa0, pa1, pa2, pa3, b0, b1);
        }
      }
    }
    __syncwarp();  // every lane is done with the slot: tile i + NS into it
    splitk_fetch<HDP, KVB, NS>(ring, k, v, a, c0, c1, warp, lane, i + NS,
                               nw);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(~0u, l[h], 1);
    l[h] += __shfl_xor_sync(~0u, l[h], 2);
  }
  // the merge's blocks may launch once every block is past its keys (they
  // wait for this grid's end to read, and take no SM from its loads)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  // the block's merge: each warp's rows < R into shared memory (acc[n][e]
  // is row g (e < 2) or g + 8, hd position c = (2t + e % 2) NT + n, kept
  // at c + c / 32 so that the lanes t of a store fall on distinct banks),
  // then the log-sum-exp of the K_WARPS states, warp 0 first, as the
  // partial
  cp_async_wait<0>();
  __syncthreads();  // the rings are free
  float* sO = reinterpret_cast<float*>(smem_raw);  // K_WARPS x K_ROWS x OLD
  float* sML = sO + K_WARPS * K_ROWS * G::OLD;     // K_WARPS x K_ROWS x 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = g + 8 * h;
    if (r >= R) continue;
    float* o = sO + (warp * K_ROWS + r) * G::OLD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 2 * t * NT + n;
      o[c + c / 32] = acc[n][2 * h];
      o[c + NT + (c + NT) / 32] = acc[n][2 * h + 1];
    }
    if (t == 0) {
      sML[(warp * K_ROWS + r) * 2] = m[h];
      sML[(warp * K_ROWS + r) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  const long long pbase =
      ((static_cast<long long>(b) * gridDim.y + kvh) * sp.splits + split) * R;
  for (int e = tid; e < R * hd; e += K_THREADS) {
    const int r = e / hd, d = e - r * hd;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < K_WARPS; ++w)
      M = fmaxf(M, sML[(w * K_ROWS + r) * 2]);
    float x = 0.0f, L = 0.0f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < K_WARPS; ++w) {
        const float wt = exp2f(sML[(w * K_ROWS + r) * 2] - M);
        x = fmaf(wt, sO[(w * K_ROWS + r) * G::OLD + d + d / 32], x);
        L = fmaf(wt, sML[(w * K_ROWS + r) * 2 + 1], L);
      }
    }
    sp.part_o[(pbase + r) * hd + d] = x;
    if (d == 0) {
      sp.part_ml[(pbase + r) * 2] = M;
      sp.part_ml[(pbase + r) * 2 + 1] = L;
    }
  }
}

// one block per (row, kv-head, batch): out = sum_s w_s acc_s / sum_s w_s
// l_s with w_s = 2^(m_s - max m); zeros where no split saw a key. Each
// thread merges the splits for its columns, K_MERGE splits' (m, l) and acc
// loaded at once, rescaling when the max grows, so the merge waits for
// one round trip of loads a K_MERGE splits. It is launched as the split
// kernel's programmatic dependent: its blocks may start before that grid
// ends, and wait here for its partials.
constexpr int K_MERGE = 8;

__global__ void __launch_bounds__(128)
    attn_combine_kernel(const AttnArgs a, const SplitArgs sp) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int R = a.Sq * a.group, hd = a.hd, S = sp.splits;
  const long long base =
      (static_cast<long long>(b) * gridDim.y + kvh) * S * R + r;
  const int i = r / a.group, h = kvh * a.group + (r - i * a.group);
  const long long orow =
      ((static_cast<long long>(b) * a.Sq + i) * a.Hq + h) * hd;
  for (int d0 = 0; d0 < hd; d0 += 128) {
    const int d = d0 + threadIdx.x;
    float M = -INFINITY, L = 0.0f, x = 0.0f;
    for (int s0 = 0; s0 < S; s0 += K_MERGE) {
      float ms[K_MERGE], ls[K_MERGE], os[K_MERGE];
#pragma unroll
      for (int u = 0; u < K_MERGE; ++u) {
        const long long at = base + static_cast<long long>(s0 + u) * R;
        const bool ok = s0 + u < S;
        ms[u] = ok ? sp.part_ml[at * 2] : -INFINITY;
        ls[u] = ok ? sp.part_ml[at * 2 + 1] : 0.0f;
        os[u] = ok && d < hd ? sp.part_o[at * hd + d] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < K_MERGE; ++u) {
        if (ms[u] == -INFINITY) continue;  // a split that saw no key
        if (ms[u] > M) {  // a new max: rescale the sums so far
          const float c = exp2f(M - ms[u]);
          x = fmaf(x, c, os[u]);
          L = fmaf(L, c, ls[u]);
          M = ms[u];
        } else {
          const float w = exp2f(ms[u] - M);
          x = fmaf(w, os[u], x);
          L = fmaf(w, ls[u], L);
        }
      }
    }
    if (d < hd) {
      const float y = M == -INFINITY ? 0.0f : x / L;
      if (sp.out_f32)
        static_cast<float*>(a.o)[orow + d] = y;
      else
        static_cast<bf16*>(a.o)[orow + d] = __float2bfloat16_rn(y);
    }
    if (a.lse != nullptr && d == 0) store_lse_log2(a, b, i, h, M, L);
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

template <int HDP, int KVB, int NS>
int launch_splitk_ns(const AttnArgs& a, const SplitArgs& sp, int B, int Hkv,
                     cudaStream_t s) {
  // all of the SM's 228 KB as shared memory: two float8 blocks an SM
  const cudaError_t err = cudaFuncSetAttribute(
      attn_splitk_kernel<HDP, KVB, NS>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch(attn_splitk_kernel<HDP, KVB, NS>, dim3(sp.splits, Hkv, B),
                K_THREADS, SplitGeom<HDP, KVB>::smem(NS), s, a, sp);
}

template <int HDP, int KVB>
int launch_splitk(const AttnArgs& a, const SplitArgs& sp, int B, int Hkv,
                  cudaStream_t s) {
  // a chunk of one round of the warps' tiles gives no warp a second tile:
  // a ring of one stage
  const int rc =
      sp.chunk <= K_TK * K_WARPS
          ? launch_splitk_ns<HDP, KVB, 1>(a, sp, B, Hkv, s)
          : launch_splitk_ns<HDP, KVB, SplitGeom<HDP, KVB>::STAGES>(
                a, sp, B, Hkv, s);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Sq * a.group, Hkv, B);
  cfg.blockDim = dim3(128);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, attn_combine_kernel, a, sp));
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
// float8 cache (p rounded to bf16 against the row's max). out_f32: 1 only
// at routes 3 and 4, out then float32 (B, Sq, Hq, hd): a slot's partial
// that a merge across the slots of a layout reads unrounded
// (flash_decode), the same values as the bf16 out before its rounding.
// lse: null, or
// float32 (B, Hq, Sq) that every route fills with each row's log-sum-exp
// (the backward's input; the output is the same either way).
REPRO_EXPORT int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Hq, int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int q_offset, int kv_end,
    int dtype, int vec, int route, int chunk, int splits, int round_p,
    int out_f32, void* part_o, void* part_ml, void* lse, void* stream) {
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0 ||
      (dtype == 0) != (route == 0) || (round_p != 0 && route != 0) ||
      (out_f32 != 0 && route != 3 && route != 4))
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
                       static_cast<float*>(part_ml), out_f32};
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
