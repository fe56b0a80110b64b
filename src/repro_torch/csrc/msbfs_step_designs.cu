// Two other designs of one MS-BFS level (the contract of msbfs_step_kernel
// in msbfs_step.cu: new = (OR_d fr[ell[v, d]]) & ~vis, vis |= new, hop
// stamped into dist for every new bit, the output's sentinel row V zero),
// kept so that probes/msbfs_step_designs.py can time them against the
// kernel the port uses on the same levels. Nothing in the package calls
// them.
//
// step_thread_word: one thread per (vertex, word), every ELL entry of the
// row gathered, pads included (they point at the zero sentinel row), one
// byte store per new bit. The port's kernel before it was redesigned.
//
// step_warp_vertex: one warp per vertex. Lane d loads entry d of the ELL
// row (one coalesced 128-byte load per 32 entries, D past 32 in passes),
// __ballot_sync picks out the live entries and the warp compacts them in
// shared memory, so pads are never gathered; lane l then ORs word l % W
// of every (32 / W)-th live neighbour, and the 32 / W groups are ORed
// together with __shfl_xor_sync. A vertex whose visited words are all
// ones skips its row. The stamp: lane l writes byte l of each word's
// 32-byte dist segment where bit l is new. W must divide 32.
#include "common.cuh"

#define FULL_MASK 0xffffffffu
#define DESIGN_THREADS 256

__global__ void step_thread_word_kernel(const int32_t* __restrict__ ell,
                                        const uint32_t* __restrict__ fr,
                                        uint32_t* __restrict__ vis,
                                        int8_t* __restrict__ dist,
                                        uint32_t* __restrict__ out, int V,
                                        int D, int W, int8_t hop) {
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

__global__ void __launch_bounds__(DESIGN_THREADS)
step_warp_vertex_kernel(const int32_t* __restrict__ ell,
                        const uint32_t* __restrict__ fr,
                        uint32_t* __restrict__ vis, int8_t* __restrict__ dist,
                        uint32_t* __restrict__ out, int V, int D, int W,
                        int8_t hop) {
  __shared__ int32_t live_u[DESIGN_THREADS / 32][32];
  const int lane = threadIdx.x & 31;
  int32_t* lu = live_u[threadIdx.x >> 5];
  if (blockIdx.x == 0 && threadIdx.x < W)
    out[static_cast<long long>(V) * W + threadIdx.x] = 0u;   // row V
  const long long v =
      (static_cast<long long>(blockIdx.x) * DESIGN_THREADS + threadIdx.x) >>
      5;
  if (v >= V) return;              // the whole warp
  const int w = lane % W;          // the word this lane ORs
  const int groups = 32 / W;       // neighbours gathered a step
  const uint32_t seen = __ldcs(vis + v * W + w);
  uint32_t acc = 0u;
  if (!__all_sync(FULL_MASK, seen == FULL_MASK)) {
    const int32_t* row = ell + v * D;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int u = d0 + lane < D ? __ldcs(row + d0 + lane) : V;
      const uint32_t live = __ballot_sync(FULL_MASK, u != V);
      if (u != V) lu[__popc(live & ((1u << lane) - 1u))] = u;
      __syncwarp();
      for (int k = lane / W; k < __popc(live); k += groups)
        acc |= __ldg(fr + static_cast<long long>(lu[k]) * W + w);
      __syncwarp();
    }
    for (int off = W; off < 32; off <<= 1)
      acc |= __shfl_xor_sync(FULL_MASK, acc, off);
  }
  const uint32_t fresh = acc & ~seen;   // lane w < W holds word w
  if (lane < W) {
    out[v * W + lane] = fresh;
    if (fresh) vis[v * W + lane] = seen | fresh;
  }
  for (int k = 0; k < W; ++k) {
    const uint32_t f = __shfl_sync(FULL_MASK, fresh, k);
    if ((f >> lane) & 1u) dist[(v * W + k) * 32 + lane] = hop;
  }
}

// The arguments of msbfs_step_launch (msbfs_step.cu): ell (V, D) int32;
// fr (V+1, W) words; vis (V, W) words and dist (V, W*32) int8, updated in
// place; out (V+1, W) words.
REPRO_EXPORT int step_thread_word_launch(const void* ell, const void* fr,
                                         void* vis, void* dist, void* out,
                                         int V, int D, int W, int hop,
                                         void* stream) {
  const long long work = static_cast<long long>(V) * W;
  step_thread_word_kernel<<<blocks_for(work > W ? work : W, DESIGN_THREADS),
                            DESIGN_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
      static_cast<uint32_t*>(vis), static_cast<int8_t*>(dist),
      static_cast<uint32_t*>(out), V, D, W, static_cast<int8_t>(hop));
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int step_warp_vertex_launch(const void* ell, const void* fr,
                                         void* vis, void* dist, void* out,
                                         int V, int D, int W, int hop,
                                         void* stream) {
  if (W < 1 || W > 32 || 32 % W != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = 32LL * (V > 1 ? V : 1);
  step_warp_vertex_kernel<<<blocks_for(threads, DESIGN_THREADS),
                            DESIGN_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
      static_cast<uint32_t*>(vis), static_cast<int8_t*>(dist),
      static_cast<uint32_t*>(out), V, D, W, static_cast<int8_t>(hop));
  return static_cast<int>(cudaGetLastError());
}
