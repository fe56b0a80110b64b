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
// frontier words once per in-edge (mostly from L2: the (V+1, W) frontier is
// 32 MB at V = 2^20, W = 8), and reads/writes the (V, W) visited and new
// words once; there is no arithmetic to speak of.
//
// Design: one thread per (v, w) word with w fastest, so the W threads of a
// vertex read one ELL row (broadcast) and neighbouring words of each
// frontier row. Unlike the TPU kernel, which rewrote the whole (V, W*32)
// int8 distance tile every level, this one updates visited and dist in
// place and writes a distance byte only for the newly set bits: the same
// function, with the 268 MB tile rewrite of each level (V = 2^20, 256
// sources) cut to one byte per newly reached (vertex, source) pair.
// The first W threads also write the zero sentinel row V of the output
// frontier, so the result feeds the next level as it is.
//
// msbfs_expand replaces the TPU kernel msbfs_expand_pallas
// (src/repro/kernels/msbfs_expand/kernel.py:44), the single hop of the ops
// API's msbfs_hop_packed:
//
//   next[v, w] = OR_d fr[ell[v, d], w]      for d with ell[v, d] != V
//
// with the same thread-to-word map and none of the visited / dist traffic.
// The pad entries are skipped rather than gathered, so row V of the input
// frontier may hold anything (the JAX wrapper zeroes a copy of it; this
// kernel never reads it and never writes the caller's tensor). Bound: bytes
// -- the (V, D) ELL read, the frontier gathers and the (V+1, W) output, at
// one OR per gathered word.
#include "common.cuh"

__global__ void msbfs_step_kernel(const int32_t* __restrict__ ell,
                                  const uint32_t* __restrict__ fr,
                                  uint32_t* __restrict__ vis,
                                  int8_t* __restrict__ dist,
                                  uint32_t* __restrict__ out,
                                  int V, int D, int W, int8_t hop) {
  const long long total = static_cast<long long>(V) * W;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < W) out[total + i] = 0u;  // sentinel row V of the new frontier
  if (i >= total) return;
  const int v = static_cast<int>(i / W);
  const int w = static_cast<int>(i - static_cast<long long>(v) * W);
  const int32_t* row = ell + static_cast<long long>(v) * D;
  uint32_t acc = 0u;
  for (int d = 0; d < D; ++d) {
    const int u = __ldg(row + d);
    acc |= __ldg(fr + static_cast<long long>(u) * W + w);
  }
  const uint32_t seen = vis[i];
  uint32_t fresh = acc & ~seen;
  out[i] = fresh;
  vis[i] = seen | fresh;
  int8_t* drow = dist + i * 32;  // dist[v, w*32 .. w*32+31]
  while (fresh) {
    drow[__ffs(fresh) - 1] = hop;
    fresh &= fresh - 1u;
  }
}

// ell (V, D) int32; fr (V+1, W) words; vis (V, W) words, updated in place;
// dist (V, W*32) int8, updated in place; out (V+1, W) words.
REPRO_EXPORT int msbfs_step_launch(const void* ell, const void* fr, void* vis,
                                   void* dist, void* out, int V, int D, int W,
                                   int hop, void* stream) {
  const int threads = 256;
  const long long work = static_cast<long long>(V) * W;
  msbfs_step_kernel<<<blocks_for(work > W ? work : W, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
      static_cast<uint32_t*>(vis), static_cast<int8_t*>(dist),
      static_cast<uint32_t*>(out), V, D, W, static_cast<int8_t>(hop));
  return static_cast<int>(cudaGetLastError());
}

__global__ void msbfs_expand_kernel(const int32_t* __restrict__ ell,
                                    const uint32_t* __restrict__ fr,
                                    uint32_t* __restrict__ out, int V, int D,
                                    int W) {
  const long long total = static_cast<long long>(V) * W;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < W) out[total + i] = 0u;  // sentinel row V of the output
  if (i >= total) return;
  const int v = static_cast<int>(i / W);
  const int w = static_cast<int>(i - static_cast<long long>(v) * W);
  const int32_t* row = ell + static_cast<long long>(v) * D;
  uint32_t acc = 0u;
  for (int d = 0; d < D; ++d) {
    const int u = __ldg(row + d);
    if (u != V) acc |= __ldg(fr + static_cast<long long>(u) * W + w);
  }
  out[i] = acc;
}

// ell (V, D) int32, pad = V; fr (V+1, W) words (row V never read);
// out (V+1, W) words, row V zero.
REPRO_EXPORT int msbfs_expand_launch(const void* ell, const void* fr,
                                     void* out, int V, int D, int W,
                                     void* stream) {
  const int threads = 256;
  const long long work = static_cast<long long>(V) * W;
  msbfs_expand_kernel<<<blocks_for(work > W ? work : W, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
      static_cast<uint32_t*>(out), V, D, W);
  return static_cast<int>(cudaGetLastError());
}
