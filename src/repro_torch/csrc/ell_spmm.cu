// Padded-ELL gather-reduce (sum or max) of the walk-count DP.
//
// Replaces ell_spmm_pallas (src/repro/kernels/ell_spmm/kernel.py:47):
//
//   out[v, f] = reduce_d X[ell[v, d], f]       (V, D) int32 x (V+1, F) f32
//                                              -> (V, F) f32
//
// ell is the row-major (V, D) in-neighbour table, padded with V; row V of
// X holds the neutral element (0 for sum, -inf for max), so a pad entry is
// read like any other row and changes nothing. The engine calls it with
// F = 1 once per level of index.walk_counts_ell (capacity planning and
// the "+" split): V = 2**20, D = 32 on the community graph.
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
// indices + 4 MB of X + 4 MB out = 142 MB, 0.042 ms at 3.35 TB/s. Design:
// one thread per (v, f), f fastest, so for F > 1 a warp's gathers of one
// X row are coalesced; at F = 1 the D index loads of a thread walk one
// 128-byte row, which L1 serves after the first miss. A warp per row with
// an ordered shuffle chain or a fused slack mask is later work.
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

// ell (V, D) int32 contiguous, entries in [0, V]; x (V+1, F) f32
// contiguous; out (V, F) f32 contiguous. op: 0 = sum, 1 = max.
REPRO_EXPORT int ell_spmm_launch(const void* ell, const void* x, void* out,
                                 int V, int D, int F, int op, void* stream) {
  const int threads = 256;
  const unsigned int blocks =
      blocks_for(static_cast<long long>(V) * F, threads);
  auto s = static_cast<cudaStream_t>(stream);
  auto e = static_cast<const int32_t*>(ell);
  auto xs = static_cast<const float*>(x);
  auto o = static_cast<float*>(out);
  if (op == 1) {
    ell_spmm_kernel<true><<<blocks, threads, 0, s>>>(e, xs, o, V, D, F);
  } else {
    ell_spmm_kernel<false><<<blocks, threads, 0, s>>>(e, xs, o, V, D, F);
  }
  return static_cast<int>(cudaGetLastError());
}
