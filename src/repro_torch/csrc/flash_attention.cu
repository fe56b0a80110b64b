// Causal GQA attention with an online softmax (FlashAttention-2 schedule).
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
// contiguous (B, Sq, Hq, hd) in the input type. f32 accumulation.
//
// One block per (q-row tile, kv-head, batch). The tile's rows are
// (query, q-head of the group) pairs, r = i * G + h % G, so the group's
// q-heads share one staging of each K/V tile: at decode (Sq = 1) the four
// q-heads of a granite-8b kv-head are four rows of one tile, and K/V are
// read once per kv-head, not once per q-head. The online-softmax state (m,
// l, acc) stays in registers (bf16) or registers and shared memory (f32);
// no (Sq, Skv) buffer touches device memory.
//
// Bounds on the H100: at prefill (granite-8b, 4 x 2048 tokens, causal) the
// two products, 1.37e11 bf16 tensor-core operations, 0.139 ms at 989
// TFLOP/s (the 168 MB of q, k, v and out take 0.050 ms); at a decode step
// the K/V bytes of the valid cache, 8.9 MB at 544 positions and batch 4,
// 0.0027 ms.
// What the design does about them:
//
//  * bf16 (attn_mma_kernel): both products on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), 4 warps x 16 rows, K/V
//    tiles of 64 keys staged in shared memory; key tiles past the tile's
//    last causal key are never loaded (half the work of a causal prefill).
//    P is rounded to bf16 before the PV product, as the Pallas kernel
//    rounds p to V's type (kernel.py:64); the row sums l add the unrounded
//    f32 p, as there. No TMA, wgmma or software pipelining yet: each tile
//    is loaded, then used.
//  * f32 (attn_scalar_kernel): CUDA-core FMAs on 32 x 32 tiles staged in
//    shared memory; exact f32 softmax (no rounding of p). It exists for the
//    float32 model and for checks at the float32 tolerances; it is bounded
//    by shared-memory traffic, far from the f32 peak.
#include <cuda_bf16.h>

#include <cmath>

#include "common.cuh"

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
};

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
  for (int j0 = 0; j0 < kend; j0 += S_BN) {
    __syncthreads();  // the previous tile is used up (first: sQ written)
    const int nk = min(S_BN, kend - j0);
    for (int e = tid; e < S_BN * hd; e += S_THREADS) {
      const int c = e / hd, d = e - c * hd;
      float kx = 0.0f, vx = 0.0f;
      if (c < nk) {
        const long long j = j0 + c;
        kx = k[j * a.k_ss + d];
        vx = v[j * a.v_ss + d];
      }
      sK[c * ld + d] = kx;
      sV[c * ld + d] = vx;
    }
    __syncthreads();
    {  // scores: thread owns row tid / 4, columns tid % 4 + 4u
      const int rr = tid >> 2, c0 = tid & 3;
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
    __syncthreads();
    // online softmax: warp w updates rows 8w..8w+7, one column per lane
    for (int t = 0; t < 8; ++t) {
      const int rr = warp * 8 + t;
      const float x = sS[rr * S_LDS + lane];
      const float m_old = sM[rr];
      const float m_new = fmaxf(m_old, warp_max(x));
      const float m_use = m_new == -INFINITY ? 0.0f : m_new;
      const float p = expf(x - m_use);
      const float psum = warp_sum(p);
      sS[rr * S_LDS + lane] = p;
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

template <int HDP>
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

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           const AttnArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KD>
int launch_scalar(const AttnArgs& a, dim3 grid, cudaStream_t s) {
  return launch(attn_scalar_kernel<KD>, grid, S_THREADS,
                scalar_smem_bytes(a.hd), a, s);
}

template <int HDP>
int launch_mma(const AttnArgs& a, dim3 grid, cudaStream_t s) {
  return launch(attn_mma_kernel<HDP>, grid, M_THREADS,
                mma_smem_bytes<HDP>(), a, s);
}

}  // namespace

// q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd): last dimension contiguous,
// strides in elements; out contiguous (B, Sq, Hq, hd), same type.
// dtype: 0 = float32, 1 = bfloat16. 1 <= hd <= 256, Hq % Hkv == 0,
// 0 <= kv_end <= Skv. vec: 1 if 16-byte loads are allowed (bf16 only).
REPRO_EXPORT int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Hq, int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, int q_offset, int kv_end,
    int dtype, int vec, void* stream) {
  if (hd < 1 || hd > 256 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs a{q,      k,        v,      out,  Sq,   Hq,   hd,
                   Hq / Hkv, q_sb,   q_ss,     q_sh,   k_sb, k_ss, k_sh,
                   v_sb,   v_ss,     v_sh,   causal, q_offset, kv_end,
                   1.0f / sqrtf(static_cast<float>(hd)), vec};
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(Sq) * a.group;
  if (dtype == 1) {
    const dim3 grid(static_cast<unsigned>((rows + M_BM - 1) / M_BM), Hkv, B);
    if (hd <= 16) return launch_mma<16>(a, grid, s);
    if (hd <= 32) return launch_mma<32>(a, grid, s);
    if (hd <= 64) return launch_mma<64>(a, grid, s);
    if (hd <= 128) return launch_mma<128>(a, grid, s);
    return launch_mma<256>(a, grid, s);
  }
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
