// One fused multi-source BFS level over a padded ELL in-neighbour table.
//
// Replaces the TPU kernel msbfs_step_pallas
// (src/repro/kernels/msbfs_expand/kernel.py:95):
//
//   new[v, w]  = (OR_d fr[ell[v, d], w]) & ~vis[v, w]
//   vis[v, w] |= new[v, w]
//   dist[v, w*32 + b] = hop   for every bit b set in new[v, w]
//
// Words are 32 BFS sources each (bit b of word w is source w*32+b, little
// endian within the word, as pack_bits lays them out). The frontier has a
// sentinel row V of zeros, which the ELL pad entries (== V) point at.
//
// Bound on the H100: bytes. A level reads the (V, D) ELL table once, the
// frontier rows of the live in-neighbours (mostly from L2: the (V+1, W)
// frontier is 32 MB at V = 2^20, W = 8), reads and writes the (V, W)
// visited and new words once, and stamps one byte per newly reached
// (vertex, source) pair; there is no arithmetic to speak of. In practice
// the card moves 32-byte sectors, so a word with any new bit costs a
// 32-byte read and write of dist: at the last levels of a batch that is
// the largest term.
//
// Design: a thread takes N consecutive words of a vertex (N = 4 where W
// is a multiple of 4, so a W = 8 vertex is two threads; 2 or 1 otherwise),
// read and written as one 16-, 8- or 4-byte access. A warp first stages
// the ELL rows of its vertices in shared memory with coalesced 16-byte
// loads (row stride 33 words, so 32 rows read at one column hit 32 banks;
// D past 32 is staged 32 entries a pass); a thread then gathers only the
// live in-neighbours' N frontier words: pad entries (about 3/4 of a
// 32-wide row at an average degree of 8) are never read. A thread whose
// visited words are all ones cannot gain a bit and gathers nothing. The
// dist stamp touches only words with fresh bits: the 32-byte segments of
// a warp's 32 * N words are contiguous, so the warp walks them as 16-byte
// chunks, lane l taking chunk 32j + l, with byte stores of the hop where a
// bit is new (a read-modify-write of each such chunk was slower over a
// batch's levels, PERF.md). The ELL rows, visited and new words are read
// or written once and are marked evict-first, to keep the frontier in L2.
// Unlike the TPU kernel, which rewrote the whole (V, W*32) int8 distance
// tile every level, visited and dist are updated in place. The first W
// threads also write the zero sentinel row V of the output frontier, so
// the result feeds the next level as it is. Measured on the main batch's
// levels (PERF.md), the light levels are bound by the ELL read and the
// gathers' L2 traffic, the last ones by the dist segments' sector
// traffic. A warp per vertex with a ballot over the pads was slower on
// every level (probes/msbfs_step_designs.py), likely because one vertex
// a warp leaves each warp a chain of dependent loads and little else.
//
// msbfs_expand replaces the TPU kernel msbfs_expand_pallas
// (src/repro/kernels/msbfs_expand/kernel.py:44), the single hop of the ops
// API's msbfs_hop_packed:
//
//   next[v, w] = OR_d fr[ell[v, d], w]      for d with ell[v, d] != V
//
// It is msbfs_step_kernel with the visited and dist parts compiled out
// (STEP = false): the same staged rows, N words a thread, pads skipped,
// the ELL rows streamed evict-first so that the (V+1, W) frontier stays in
// L2, and the gathered words written as they are. Row V of the input
// frontier is never read (pads are skipped), so it may hold anything; the
// caller's tensor is never written; the first W threads zero row V of the
// output. Bound: bytes -- the (V, D) ELL read (134 MB of 201 at V = 2^20,
// D = 32, W = 8), the (V+1, W) frontier read once and the output written
// once. Other designs (a thread per word, the port's first kernel; each
// block's ELL slab streamed into shared memory by 1-D bulk asynchronous
// copies, double-buffered; every entry gathered; gathers marked L2
// evict-last) live in msbfs_step_designs.cu, and
// probes/ops_kernel_designs.py times them against this one (PERF.md).
#include "common.cuh"

#define STEP_THREADS 256
#define STEP_D 32   // ELL entries of a row staged per pass
#define FULL_MASK 0xffffffffu
// blocks an SM holds for msbfs_expand: registers capped at 40 a thread
// (44 uncapped held 5, and the gathers' latency wants the warps)
#define EXPAND_BLOCKS 6

// Streaming accesses (read or written once per level) are marked
// evict-first, so that the frontier rows, gathered once per out-edge, stay
// in L2.
template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) { return __ldcs(p); }

#define STEP_WARPS (STEP_THREADS / 32)
// odd row stride: 32 rows read at one column hit 32 banks
#define ROW_STRIDE (STEP_D + 1)

// The ELL rows of the vertices of a warp's 32 threads, G threads a vertex:
// at most 31 / G + 2.
__host__ __device__ __forceinline__ int rows_per_warp(int G) {
  const int r = 31 / G + 2;
  return r < 32 ? r : 32;
}

// Stage entries d0 .. d0 + dc of rows v_lo .. v_lo + nrows - 1 into the
// warp's rows (ROW_STRIDE words each) with coalesced loads: VEC takes 4
// entries a load (D % 4 == 0, the table 16-byte aligned), one entry else.
template <bool VEC>
__device__ __forceinline__ void stage_rows(const int32_t* __restrict__ ell,
                                           long long v_lo, int nrows, int D,
                                           int d0, int dc, int lane,
                                           int32_t* rows) {
  if (VEC) {
    const int q = (dc + 3) / 4;   // 16-byte pieces a row
    for (int e = lane; e < nrows * q; e += 32) {
      const int r = e / q, k = e - r * q;
      const int4 x = ld_stream(reinterpret_cast<const int4*>(
                                   ell + (v_lo + r) * D + d0) + k);
      int32_t* dst = rows + r * ROW_STRIDE + 4 * k;
      dst[0] = x.x;
      dst[1] = x.y;
      dst[2] = x.z;
      dst[3] = x.w;
    }
  } else {
    for (int e = lane; e < nrows * dc; e += 32) {
      const int r = e / dc, c = e - r * dc;
      rows[r * ROW_STRIDE + c] = ld_stream(ell + (v_lo + r) * D + d0 + c);
    }
  }
}

// N consecutive words, loaded and stored as one 4-, 8- or 16-byte access.
template <int N> struct Words { uint32_t w[N]; };
template <int N>
__device__ __forceinline__ Words<N> ld_words(const uint32_t* p, bool stream) {
  Words<N> x;
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const uint4* q = reinterpret_cast<const uint4*>(p) + k;
      const uint4 y = stream ? __ldcs(q) : __ldg(q);
      x.w[4 * k] = y.x; x.w[4 * k + 1] = y.y;
      x.w[4 * k + 2] = y.z; x.w[4 * k + 3] = y.w;
    }
  } else if constexpr (N == 2) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 y = stream ? __ldcs(q) : __ldg(q);
    x.w[0] = y.x; x.w[1] = y.y;
  } else {
    x.w[0] = stream ? __ldcs(p) : __ldg(p);
  }
  return x;
}
template <int N>
__device__ __forceinline__ void st_words(uint32_t* p, const Words<N>& x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      __stcs(reinterpret_cast<uint4*>(p) + k,
             make_uint4(x.w[4 * k], x.w[4 * k + 1], x.w[4 * k + 2],
                        x.w[4 * k + 3]));
  } else if constexpr (N == 2) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(x.w[0], x.w[1]));
  } else {
    __stcs(p, x.w[0]);
  }
}

// The hop into dist for every fresh bit of the warp's 32 * N words, whose
// 32-byte dist segments are contiguous (N KB for the warp): the
// warp walks them as 16-byte chunks, lane l taking chunk 32j + l, so every
// access is coalesced. fresh_s holds the warp's fresh words in order.
template <int N>
__device__ __forceinline__ void stamp_warp(int8_t* seg,
                                           const uint32_t* fresh_s, int lane,
                                           int8_t hop) {
  uint32_t f[2 * N];
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) {
    const int c = 32 * j + lane;
    f[j] = (fresh_s[c >> 1] >> (16 * (c & 1))) & 0xFFFFu;
  }
  uint4* chunk = reinterpret_cast<uint4*>(seg) + lane;
#pragma unroll
  for (int j = 0; j < 2 * N; ++j) {
    int8_t* bytes = reinterpret_cast<int8_t*>(chunk + 32 * j);
    for (uint32_t b = f[j]; b; b &= b - 1u) bytes[__ffs(b) - 1] = hop;
  }
}

// A thread takes N consecutive words of a vertex (G = W / N threads a
// vertex). dynamic shared memory: STEP_WARPS x rows_per_warp(G) x
// ROW_STRIDE words. STEP = false is msbfs_expand: no visited words (every
// thread gathers), the gathered words go to out as they are, no stamp.
template <int N, bool VEC, bool STEP>
__global__ void __launch_bounds__(STEP_THREADS, STEP ? 1 : EXPAND_BLOCKS)
msbfs_step_kernel(const int32_t* __restrict__ ell,
                  const uint32_t* __restrict__ fr,
                  uint32_t* __restrict__ vis, int8_t* __restrict__ dist,
                  uint32_t* __restrict__ out, int V, int D, int W,
                  int8_t hop) {
  extern __shared__ int32_t stage[];
  const int G = W / N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = rows_per_warp(G) * ROW_STRIDE;
  int32_t* rows = stage + warp * (per_warp > 32 * N ? per_warp : 32 * N);
  const long long total = static_cast<long long>(V) * G;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * STEP_THREADS + warp * 32;
  const long long i = i0 + lane;
  if (i < W) out[static_cast<long long>(V) * W + i] = 0u;   // sentinel row V
  if (i0 >= total) return;          // the whole warp
  const bool active = i < total;
  const long long v_lo = i0 / G;
  const long long last = (i0 + 32 < total ? i0 + 32 : total) - 1;
  const int nrows = static_cast<int>(last / G - v_lo + 1);
  const long long v = active ? i / G : v_lo;
  const long long word = v * W + (i - v * G) * N;   // the first of N words
  Words<N> seen{};
  bool need = active;
  if constexpr (STEP) {
#pragma unroll
    for (int k = 0; k < N; ++k) seen.w[k] = FULL_MASK;
    if (active) seen = ld_words<N>(vis + word, true);
    // a word reached from every source cannot gain a bit: no gathers
    need = false;
#pragma unroll
    for (int k = 0; k < N; ++k) need = need || seen.w[k] != FULL_MASK;
  }
  const int32_t* row = rows + (v - v_lo) * ROW_STRIDE;
  Words<N> acc;
#pragma unroll
  for (int k = 0; k < N; ++k) acc.w[k] = 0u;
  const uint32_t* frw = fr + (word - v * W);   // column of the N words
  for (int d0 = 0; d0 < D; d0 += STEP_D) {
    const int dc = D - d0 < STEP_D ? D - d0 : STEP_D;
    if (d0 > 0) __syncwarp();   // the last pass's rows are read
    stage_rows<VEC>(ell, v_lo, nrows, D, d0, dc, lane, rows);
    __syncwarp();
    if (need) {
#pragma unroll 4
      for (int c = 0; c < dc; ++c) {
        const int u = row[c];
        if (u != V) {
          const Words<N> x =
              ld_words<N>(frw + static_cast<long long>(u) * W, false);
#pragma unroll
          for (int k = 0; k < N; ++k) acc.w[k] |= x.w[k];
        }
      }
    }
  }
  if constexpr (!STEP) {
    if (active) st_words<N>(out + word, acc);
    return;
  }
  Words<N> fresh, now;
  bool any = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    fresh.w[k] = acc.w[k] & ~seen.w[k];   // 0 past total: seen is all ones
    now.w[k] = seen.w[k] | fresh.w[k];
    any = any || fresh.w[k] != 0u;
  }
  if (active) st_words<N>(out + word, fresh);
  if (any) st_words<N>(vis + word, now);
  if (!__any_sync(FULL_MASK, any)) return;
  // the warp's fresh words, in order, over its staged rows (read above)
  uint32_t* fresh_s = reinterpret_cast<uint32_t*>(rows);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k) fresh_s[lane * N + k] = fresh.w[k];
  __syncwarp();
  stamp_warp<N>(dist + i0 * N * 32, fresh_s, lane, hop);
}

template <int N, bool STEP, typename Run>
void launch_step(bool vec, Run run) {
  if (vec) run(msbfs_step_kernel<N, true, STEP>);
  else run(msbfs_step_kernel<N, false, STEP>);
}

// Launch msbfs_step_kernel<N, VEC, STEP>: N = 4 (or 2) words a thread
// where W and the rows of fr, vis and out allow 16-byte (8-byte)
// accesses, VEC where the ELL rows take 16-byte loads.
template <bool STEP>
int launch_level(const void* ell, const void* fr, void* vis, void* dist,
                 void* out, int V, int D, int W, int hop, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(fr) |
                          reinterpret_cast<uintptr_t>(vis) |
                          reinterpret_cast<uintptr_t>(out);
  const int N = W % 4 == 0 && align % 16 == 0 ? 4
                : W % 2 == 0 && align % 8 == 0 ? 2 : 1;
  const long long work = static_cast<long long>(V) * (W / N);
  const unsigned blocks = blocks_for(work > W ? work : W, STEP_THREADS);
  const int rows = rows_per_warp(W / N) * ROW_STRIDE;
  const int smem = STEP_WARPS * (rows > 32 * N ? rows : 32 * N) * 4;
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(ell) % 16 == 0;
  auto run = [&](auto kernel) {
    kernel<<<blocks, STEP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
        static_cast<uint32_t*>(vis), static_cast<int8_t*>(dist),
        static_cast<uint32_t*>(out), V, D, W, static_cast<int8_t>(hop));
  };
  if (N == 4) launch_step<4, STEP>(vec, run);
  else if (N == 2) launch_step<2, STEP>(vec, run);
  else launch_step<1, STEP>(vec, run);
  return static_cast<int>(cudaGetLastError());
}

// ell (V, D) int32; fr (V+1, W) words; vis (V, W) words, updated in place;
// dist (V, W*32) int8, updated in place; out (V+1, W) words.
REPRO_EXPORT int msbfs_step_launch(const void* ell, const void* fr, void* vis,
                                   void* dist, void* out, int V, int D, int W,
                                   int hop, void* stream) {
  return launch_level<true>(ell, fr, vis, dist, out, V, D, W, hop, stream);
}

// ell (V, D) int32, pad = V; fr (V+1, W) words (row V never read);
// out (V+1, W) words, row V zero.
REPRO_EXPORT int msbfs_expand_launch(const void* ell, const void* fr,
                                     void* out, int V, int D, int W,
                                     void* stream) {
  return launch_level<false>(ell, fr, nullptr, nullptr, out, V, D, W, 0,
                             stream);
}
