// The similarity stage's two kernels: Gamma packing and the all-pairs
// popcount(AND) over the packed rows.
//
// pairwise_popcount replaces the TPU kernel pairwise_popcount_pallas
// (src/repro/kernels/pairwise_popcount/kernel.py:39):
//
//   out[i, j] = sum_w popcount(a[i, w] & a[j, w])      a: (Q, W) words
//
// This is |Gamma(q_i) ∩ Gamma(q_j)| for every query pair (32 vertices per
// word). out is symmetric, so the function needs only the Q(Q+1)/2 pairs
// i <= j. Bound on the H100: bytes (4*Q*W in, 4*Q*Q out: 10 us at Q = 256,
// W = 2**15), with the AND+popc work close behind on the tensor cores'
// 1-bit MMA (chip_smoke.py measures its peak in phase "peaks"), and about
// 100x above it on the CUDA cores' 32-bit popc.
//
// Design: the 1-bit MMA, mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc.
// A block computes one 128 x 128 output tile (I, J) with I <= J over a
// slice of the word axis; the tile is mirrored into the lower triangle on
// write, so only the upper triangle is computed. Both MMA operands are rows
// of a: the B operand's "col" layout is row j of the same matrix, so
// nothing is transposed. Each 256-bit k-step takes 8 words of a row; lane
// (g, t) of a warp loads words 2t and 2t + 1 of rows g and g + 8 with one
// 64-bit shared load each, as the low and high k halves of its fragments
// (AND+popc pairs the same k slots of A and B, so any assignment of words
// to k slots that A and B share gives the same sum). Rows are staged in
// shared memory by cp.async in two stages of 32 words a row, padded to 40
// words so the 64-bit fragment loads hit 32 distinct banks; rows past Q and
// words past W are zero-filled and add nothing. A diagonal tile stages its
// rows once. 8 warps of 64 x 32 outputs each, 16 MMAs per k-step.
// At Q = 256 there are 3 upper-triangle tiles, far too few for 132 SMs,
// so the word axis is split over blocks: 8 blocks of one tile form a
// thread-block cluster and sum their partial tiles through distributed
// shared memory, and where more than one cluster shares a tile, the
// clusters add into a zeroed output with int32 atomics (integer sums are
// exact in any order; counts are at most 2**20 per word axis of 2**15).
//
// gamma_pack builds the packed rows straight from the index's int8
// distances (the port's gamma_bits + pack_bits; in the JAX package
// gamma_matrix, src/repro/core/similarity.py:29, and pack_bits,
// src/repro/kernels/msbfs_expand/ref.py:10, no Pallas kernel of their own):
//
//   bit b of out[q, w] = dist[32w + b, col[q]] <= ks[q]   (32w + b < n)
//
// Bound: bytes, the (n, Su) distances read once (268 MB at n = 2**20,
// Su = 256). Design: a block stages 256 rows x up to 256 columns of dist
// in shared memory with coalesced loads (row stride padded to an odd
// number of words, so 32 lanes reading one column of 32 rows hit 32
// banks); then each warp takes queries in turn, compares column col[q] of
// 32 rows with ks[q] and __ballot_syncs one word, 8 words (32 bytes) a
// query per block.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define BT 128          // output tile rows and columns
#define KC 32           // words of a row per pipeline stage
#define NSTAGE 2        // pipeline stages
#define KP 40           // padded shared row (words): 40 = 8 mod 32
#define CL 8            // blocks of a cluster, one tile, summed through DSMEM
#define PP_THREADS 256  // 8 warps, 2 x 4, each 64 rows x 32 columns
#define RS 136          // padded row (int32) of the partial tile: 8 mod 32

constexpr int STAGE_WORDS = 2 * BT * KP;   // the A and B rows of a stage
// the pipeline's stages, or the partial tile and the summed stripe
constexpr int EPI_WORDS = BT * RS + (BT / CL) * (BT + 1);
constexpr int PP_SMEM = NSTAGE * STAGE_WORDS > EPI_WORDS
                            ? NSTAGE * STAGE_WORDS * 4 : EPI_WORDS * 4;

__device__ __forceinline__ void cp_async(uint32_t* dst, const void* src,
                                         int bytes, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? bytes : 0;   // 0: no read, zero fill
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(n) : "memory");
}

// BT rows from row0, KC words from k0, into dst (BT x KP words).
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint32_t* a,
                                           int row0, int Q, int W, int k0,
                                           bool vec) {
  if (vec) {  // W % 4 == 0 and a 16-byte aligned: 4 words per copy
    for (int e = threadIdx.x; e < BT * (KC / 4); e += PP_THREADS) {
      const int r = e / (KC / 4), q = e % (KC / 4);
      const int row = row0 + r, k = k0 + 4 * q;
      const bool ok = row < Q && k < W;
      cp_async(dst + r * KP + 4 * q,
               ok ? a + static_cast<long long>(row) * W + k : a, 16, ok);
    }
  } else {
    for (int e = threadIdx.x; e < BT * KC; e += PP_THREADS) {
      const int r = e / KC, c = e % KC;
      const int row = row0 + r, k = k0 + c;
      const bool ok = row < Q && k < W;
      cp_async(dst + r * KP + c,
               ok ? a + static_cast<long long>(row) * W + k : a, 4, ok);
    }
  }
}

__device__ __forceinline__ void mma_b1(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// grid (S, P): S = k-splits (a multiple of CL, one cluster per CL), P =
// upper-triangle tile pairs of T x T tiles. atomic: more than one cluster
// per tile, so out is zeroed first and the clusters add into it.
__global__ void __launch_bounds__(PP_THREADS, 2)
pairwise_popcount_kernel(const uint32_t* __restrict__ a,
                         int32_t* __restrict__ out, int Q, int W, int T,
                         int S, int vec, int atomic) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  int p = blockIdx.y, I = 0;
  while (p >= T - I) {
    p -= T - I;
    ++I;
  }
  const int J = I + p;
  const bool diag = I == J;
  const int nchunks = (W + KC - 1) / KC;
  const int c_begin =
      static_cast<int>(static_cast<long long>(blockIdx.x) * nchunks / S);
  const int c_end =
      static_cast<int>(static_cast<long long>(blockIdx.x + 1) * nchunks / S);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 2, wc = warp & 3;   // 64-row, 32-column warp tile

  int32_t acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[m][n][r] = 0;

  // chunk c of the word axis into stage s; every call commits one group
  // (empty past c_end), so wait_group NSTAGE - 2 means "chunk c landed"
  auto issue = [&](int c, int s) {
    if (c < c_end) {
      uint32_t* st = smem + s * STAGE_WORDS;
      stage_rows(st, a, I * BT, Q, W, c * KC, vec);
      if (!diag) stage_rows(st + BT * KP, a, J * BT, Q, W, c * KC, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int i = 0; i < NSTAGE - 1; ++i) issue(c_begin + i, i);
  for (int c = c_begin; c < c_end; ++c) {
    const int s = (c - c_begin) % NSTAGE;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(NSTAGE - 2) : "memory");
    __syncthreads();   // chunk c is visible; chunk c - 1's stage is free
    issue(c + NSTAGE - 1, (c - c_begin + NSTAGE - 1) % NSTAGE);
    const uint32_t* As = smem + s * STAGE_WORDS;
    const uint32_t* Bs = diag ? As : As + BT * KP;
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int kw = ks * 8 + 2 * t;
      uint2 alo[4], ahi[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = wr * 64 + m * 16 + g;
        alo[m] = *reinterpret_cast<const uint2*>(As + r * KP + kw);
        ahi[m] = *reinterpret_cast<const uint2*>(As + (r + 8) * KP + kw);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        b[n] = *reinterpret_cast<const uint2*>(
            Bs + (wc * 32 + n * 8 + g) * KP + kw);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_b1(acc[m][n], alo[m].x, ahi[m].x, alo[m].y, ahi[m].y, b[n].x,
                 b[n].y);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();   // every warp is done with the pipeline's buffers

  // the partial tile into shared memory, over the pipeline's buffers
  int32_t* part = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int r = wr * 64 + m * 16 + g, cc = wc * 32 + n * 8 + 2 * t;
      *reinterpret_cast<int2*>(part + r * RS + cc) =
          make_int2(acc[m][n][0], acc[m][n][1]);
      *reinterpret_cast<int2*>(part + (r + 8) * RS + cc) =
          make_int2(acc[m][n][2], acc[m][n][3]);
    }
  cluster.sync();
  // block rank k of the cluster sums rows [16k, 16k + 16) of the tile over
  // the cluster's partials (all its remote loads in flight at once) and
  // writes them along the rows; a copy of the stripe in shared memory, past
  // the partial tile, then gives the mirror's writes down the columns
  const int rank = static_cast<int>(cluster.block_rank());
  const int32_t* peer[CL];
#pragma unroll
  for (int k = 0; k < CL; ++k) peer[k] = cluster.map_shared_rank(part, k);
  constexpr int ROWS = BT / CL, PER = ROWS * BT / PP_THREADS;
  int32_t* stripe = part + BT * RS;   // ROWS x (BT + 1)
  int32_t sum[PER];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * PP_THREADS;
    const int off = (rank * ROWS + e / BT) * RS + e % BT;
    sum[t] = 0;
#pragma unroll
    for (int k = 0; k < CL; ++k) sum[t] += peer[k][off];
  }
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int e = threadIdx.x + t * PP_THREADS;
    const int r = e / BT, cc = e % BT;
    const int i = I * BT + rank * ROWS + r, j = J * BT + cc;
    stripe[r * (BT + 1) + cc] = sum[t];
    if (i < Q && j < Q) {
      int32_t* o = out + static_cast<long long>(i) * Q + j;
      if (atomic) atomicAdd(o, sum[t]); else *o = sum[t];
    }
  }
  if (!diag) {
    __syncthreads();
#pragma unroll
    for (int t = 0; t < PER; ++t) {
      const int e = threadIdx.x + t * PP_THREADS;
      const int r = e % ROWS, cc = e / ROWS;   // down a column
      const int i = I * BT + rank * ROWS + r, j = J * BT + cc;
      if (i < Q && j < Q) {
        int32_t* o = out + static_cast<long long>(j) * Q + i;
        const int32_t v = stripe[r * (BT + 1) + cc];
        if (atomic) atomicAdd(o, v); else *o = v;
      }
    }
  }
  cluster.sync();   // no block leaves while a peer still reads its tile
}

static int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

// a (Q, W) words, contiguous; out (Q, Q) int32. Q > 0, W > 0.
REPRO_EXPORT int pairwise_popcount_launch(const void* a, void* out, int Q,
                                          int W, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (Q + BT - 1) / BT, P = T * (T + 1) / 2;
  const int nchunks = (W + KC - 1) / KC;
  // about two blocks per SM, and at least one word chunk per block
  int G = (2 * sm_count() + P * CL - 1) / (P * CL);
  G = G < nchunks / CL ? G : nchunks / CL;
  G = G > 1 ? G : 1;
  const int S = G * CL, atomic = G > 1;
  if (atomic) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(Q) * Q * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaFuncSetAttribute(
      pairwise_popcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      PP_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, P, 1);
  cfg.blockDim = dim3(PP_THREADS, 1, 1);
  cfg.dynamicSmemBytes = PP_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, pairwise_popcount_kernel,
                           static_cast<const uint32_t*>(a),
                           static_cast<int32_t*>(out), Q, W, T, S, vec,
                           atomic);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#define GP_ROWS 128     // vertices of a tile: 4 words of each query
#define GP_WORDS (GP_ROWS / 32)
#define GP_COLS 256     // columns of dist staged at once
#define GP_THREADS 256

// odd row stride (words) of a staged tile of cw columns
__host__ __device__ __forceinline__ int gp_stride(int cw) {
  return ((cw + 3) / 4) | 1;
}

__global__ void __launch_bounds__(GP_THREADS)
gamma_pack_kernel(const int8_t* __restrict__ dist,
                  const int32_t* __restrict__ col,
                  const int8_t* __restrict__ ks, uint32_t* __restrict__ out,
                  int n, int Su, int Q, int Wn, int vec) {
  extern __shared__ __align__(16) uint32_t tile[];
  const int v0 = blockIdx.x * GP_ROWS, w0 = blockIdx.x * GP_WORDS;
  const int rows = n - v0 < GP_ROWS ? n - v0 : GP_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < Su; c0 += GP_COLS) {
    const int cw = Su - c0 < GP_COLS ? Su - c0 : GP_COLS;
    const int SW = gp_stride(cw);
    if (c0 > 0) __syncthreads();   // the last chunk's reads are done
    if (vec) {   // Su % 4 == 0 and dist 4-byte aligned: async word copies
      const int cw4 = cw / 4;
      for (int r = warp; r < rows; r += GP_THREADS / 32) {
        const int8_t* src = dist + static_cast<long long>(v0 + r) * Su + c0;
        for (int q = lane; q < cw4; q += 32)
          cp_async(tile + r * SW + q, src + 4 * q, 4, true);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    } else {
      int8_t* tb = reinterpret_cast<int8_t*>(tile);
      for (int r = warp; r < rows; r += GP_THREADS / 32) {
        const int8_t* src = dist + static_cast<long long>(v0 + r) * Su + c0;
        for (int c = lane; c < cw; c += 32) tb[r * SW * 4 + c] = src[c];
      }
    }
    __syncthreads();
    const int8_t* tb = reinterpret_cast<const int8_t*>(tile);
    for (int q = warp; q < Q; q += GP_THREADS / 32) {
      const int c = __ldg(col + q) - c0;
      if (c < 0 || c >= cw) continue;     // the column lies in another chunk
      const int8_t k = __ldg(ks + q);
      uint32_t mine = 0u;
#pragma unroll
      for (int r = 0; r < GP_WORDS; ++r) {
        const int row = r * 32 + lane;
        const bool bit = row < rows && tb[row * SW * 4 + c] <= k;
        const uint32_t word = __ballot_sync(0xffffffffu, bit);
        if (lane == r) mine = word;
      }
      if (lane < GP_WORDS && w0 + lane < Wn)
        out[static_cast<long long>(q) * Wn + w0 + lane] = mine;
    }
  }
}

// dist (>= n rows, Su) int8, contiguous; col (Q,) int32 in [0, Su);
// ks (Q,) int8; out (Q, Wn) words, Wn = ceil(n / 32). n > 0, Q > 0.
REPRO_EXPORT int gamma_pack_launch(const void* dist, const void* col,
                                   const void* ks, void* out, int n, int Su,
                                   int Q, void* stream) {
  const int Wn = (n + 31) / 32;
  const int cw = Su < GP_COLS ? Su : GP_COLS;
  const int smem = GP_ROWS * gp_stride(cw) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      gamma_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = Su % 4 == 0 && reinterpret_cast<uintptr_t>(dist) % 4 == 0;
  gamma_pack_kernel<<<(n + GP_ROWS - 1) / GP_ROWS, GP_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(dist), static_cast<const int32_t*>(col),
      static_cast<const int8_t*>(ks), static_cast<uint32_t*>(out), n, Su, Q,
      Wn, vec);
  return static_cast<int>(cudaGetLastError());
}
