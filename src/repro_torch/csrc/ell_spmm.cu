// Padded-ELL gather-reduce (sum or max) of the walk-count DP.
//
// Replaces ell_spmm_pallas (src/repro/kernels/ell_spmm/kernel.py:47):
//
//   out[v, f] = reduce_d X[ell[v, d], f]       (V, D) int32 x (V+1, F) f32
//                                              -> (V, F) f32
//
// ell is the row-major (V, D) in-neighbour table, padded with V; row V of
// X holds the neutral element (0 for sum, -inf for max). The engine calls
// it with F = 1 once per level of index.walk_counts_ell (capacity planning
// and the "+" split): V = 2**20, D = 32 on the community graph.
//
// Order of summation: each output accumulates over d = 0..D-1 in
// ascending order from 0 (sum) or -inf (max), as the Pallas body's
// fori_loop does; a float add is not associative, so this is what makes
// the kernel, the plain version (one vectorised add per column d) and
// interpret-mode Pallas agree bit for bit for any values. There is no
// multiply, so no add can be contracted into an FMA. max propagates NaN,
// as torch.maximum does.
//
// Bound on the H100: bytes. At F = 1 each output reads its D indices
// (4 bytes each) and gathers D floats of X; ELL dominates: 134 MB of
// indices + 4 MB of X + 4 MB out = 142 MB, 0.042 ms at 3.35 TB/s. The
// bound counts the whole padded table: a kernel cannot know where a
// row's entries end without reading them. Two routes, chosen by shape in
// the wrapper (kernels/ell_spmm/ops.py):
//
//  * ell_gather_f1_kernel (F = 1, D % 4 == 0, D <= 128, a 16-byte aligned
//    table): the engine's walk counts. One thread per row (the first
//    design) made each lane of a warp walk its own 128-byte index row one
//    4-byte load at a time, so the loads were uncoalesced and few gathers
//    were in flight. Here a group of D / 4 lanes owns a row (8 at D = 32):
//    each lane reads 4 indices with one 16-byte load, so a warp reads 4
//    whole rows in one coalesced 512-byte access, and issues its 4
//    gathers at once. A pad entry (== V) issues no gather when row V is
//    neutral (checked once per thread): adding +-0 to a sum that starts at
//    +0 changes nothing under round-to-nearest (it never becomes -0), and
//    max(acc, -inf) is acc, NaN included, so skipping is exact wherever
//    the pads lie (the kernel does not stop at the first one). The sum
//    stays in ascending d: an ordered shuffle chain passes the running
//    value from lane j - 1 to lane j, which adds its 4 values in order.
//    At average degree 8 and cap 32, 75% of the gathers are skipped.
//  * ell_spmm_kernel (every other shape): one thread per (v, f), f
//    fastest, so for F > 1 a warp's gathers of one X row are coalesced.
#include <cmath>

#include "common.cuh"

template <bool kMax>
__global__ void ell_spmm_kernel(const int32_t* __restrict__ ell,
                                const float* __restrict__ x,
                                float* __restrict__ out, int V, int D,
                                int F) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(V) * F) return;
  const long long v = idx / F;
  const int f = static_cast<int>(idx - v * F);
  const int32_t* row = ell + v * D;
  float acc = kMax ? -INFINITY : 0.0f;
  for (int d = 0; d < D; ++d) {
    const float g =
        __ldg(x + static_cast<long long>(__ldg(row + d)) * F + f);
    if (kMax) {
      // NaN in either operand wins, as in torch.maximum / jnp.maximum
      acc = (g > acc || g != g) ? g : acc;
    } else {
      acc = __fadd_rn(acc, g);
    }
  }
  out[idx] = acc;
}

// F = 1: a group of D / 4 lanes per row (see the header). Lanes past the
// last whole group of a warp idle.
template <bool kMax>
__global__ void ell_gather_f1_kernel(const int32_t* __restrict__ ell,
                                     const float* __restrict__ x,
                                     float* __restrict__ out, int V, int D) {
  const int gs = D >> 2;                      // lanes per row, 1..32
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 / gs;
  const int slot = lane / gs, j = lane - slot * gs;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long v = warp * rows_per_warp + slot;
  const bool live = slot < rows_per_warp && v < V;
  const float pad = __ldg(x + V);
  const bool skip = kMax ? pad == -INFINITY : pad == 0.0f;
  float g[4];
  if (live) {
    const int4 e = __ldg(reinterpret_cast<const int4*>(ell + v * D) + j);
    const int idx[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      g[u] = (skip && idx[u] == V) ? (kMax ? -INFINITY : 0.0f)
                                   : __ldg(x + idx[u]);
  }
  // the ordered chain: lane j of the group takes the running value of
  // lane j - 1 and adds its 4 values, d = 4j .. 4j + 3, in order
  float run = kMax ? -INFINITY : 0.0f;
  for (int step = 0; step < gs; ++step) {
    const float prev = __shfl_up_sync(~0u, run, 1);
    if (j == step && live) {
      float acc = step == 0 ? run : prev;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (kMax) {
          acc = (g[u] > acc || g[u] != g[u]) ? g[u] : acc;
        } else {
          acc = __fadd_rn(acc, g[u]);
        }
      }
      run = acc;
    }
  }
  if (live && j == gs - 1) out[v] = run;
}

// ell (V, D) int32 contiguous, entries in [0, V]; x (V+1, F) f32
// contiguous; out (V, F) f32 contiguous. op: 0 = sum, 1 = max. f1: 1 to
// take ell_gather_f1_kernel (F == 1, D % 4 == 0, 4 <= D <= 128, ell
// 16-byte aligned; the wrapper decides).
REPRO_EXPORT int ell_spmm_launch(const void* ell, const void* x, void* out,
                                 int V, int D, int F, int op, int f1,
                                 void* stream) {
  const int threads = 256;
  auto s = static_cast<cudaStream_t>(stream);
  auto e = static_cast<const int32_t*>(ell);
  auto xs = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  if (f1) {
    if (F != 1 || D % 4 != 0 || D < 4 || D > 128 ||
        reinterpret_cast<uintptr_t>(ell) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long rows_per_block = (threads / 32) * (32 / (D / 4));
    const unsigned int blocks = static_cast<unsigned int>(
        (V + rows_per_block - 1) / rows_per_block);
    if (op == 1) {
      ell_gather_f1_kernel<true><<<blocks, threads, 0, s>>>(e, xs, o, V, D);
    } else {
      ell_gather_f1_kernel<false><<<blocks, threads, 0, s>>>(e, xs, o, V, D);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const unsigned int blocks =
      blocks_for(static_cast<long long>(V) * F, threads);
  if (op == 1) {
    ell_spmm_kernel<true><<<blocks, threads, 0, s>>>(e, xs, o, V, D, F);
  } else {
    ell_spmm_kernel<false><<<blocks, threads, 0, s>>>(e, xs, o, V, D, F);
  }
  return static_cast<int>(cudaGetLastError());
}
