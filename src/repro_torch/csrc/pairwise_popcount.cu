// All-pairs popcount(AND) over packed bitmaps.
//
// Replaces the TPU kernel pairwise_popcount_pallas
// (src/repro/kernels/pairwise_popcount/kernel.py:39):
//
//   out[i, j] = sum_w popcount(a[i, w] & a[j, w])      a: (Q, W) words
//
// This is |Gamma(q_i) ∩ Gamma(q_j)| for every query pair (32 vertices per
// word). out is symmetric, so the function needs only the Q(Q+1)/2 pairs
// i <= j. This kernel computes all Q*Q on the CUDA cores, whose 32-bit
// popc (16 results per clock per SM on compute capability 9.0) bounds it.
// The function's least time on the H100 is lower: the tensor cores' 1-bit
// AND+popc MMA does the same work far faster (chip_smoke.py measures
// both peaks; PERF.md has the numbers), which leaves the bytes (4*Q*W in,
// 4*Q*Q out) as the bound.
//
// Design: one block per TQ x TQ output tile, one thread per output, int32
// accumulation in registers. The block stages KW-word slices of its TQ
// A rows and TQ B rows in shared memory (rows padded by one word so the
// TQ threads of a warp that read different B rows hit different banks)
// and walks the word axis; the word axis is the TPU kernel's sequential
// grid dimension turned into a loop inside the block. Symmetry is not
// exploited, nor the 1-bit MMA: a kernel on mma.sync ... b1.and.popc over
// the upper triangle is the faster form.
#include "common.cuh"

#define TQ 16
#define KW 64

__global__ void pairwise_popcount_kernel(const uint32_t* __restrict__ a,
                                         int32_t* __restrict__ out, int Q,
                                         int W) {
  __shared__ uint32_t As[TQ][KW + 1];
  __shared__ uint32_t Bs[TQ][KW + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TQ + tx;
  const int row0 = blockIdx.y * TQ, col0 = blockIdx.x * TQ;
  int acc = 0;
  for (int k0 = 0; k0 < W; k0 += KW) {
    for (int e = tid; e < TQ * KW; e += TQ * TQ) {
      const int r = e / KW, c = e % KW, k = k0 + c;
      const int ra = row0 + r, rb = col0 + r;
      As[r][c] = (ra < Q && k < W)
                     ? __ldg(a + static_cast<long long>(ra) * W + k) : 0u;
      Bs[r][c] = (rb < Q && k < W)
                     ? __ldg(a + static_cast<long long>(rb) * W + k) : 0u;
    }
    __syncthreads();
#pragma unroll 16
    for (int c = 0; c < KW; ++c) acc += __popc(As[ty][c] & Bs[tx][c]);
    __syncthreads();
  }
  const int i = row0 + ty, j = col0 + tx;
  if (i < Q && j < Q) out[static_cast<long long>(i) * Q + j] = acc;
}

// a (Q, W) words, contiguous; out (Q, Q) int32.
REPRO_EXPORT int pairwise_popcount_launch(const void* a, void* out, int Q,
                                          int W, void* stream) {
  const dim3 block(TQ, TQ);
  const dim3 grid((Q + TQ - 1) / TQ, (Q + TQ - 1) / TQ);
  pairwise_popcount_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<int32_t*>(out), Q, W);
  return static_cast<int>(cudaGetLastError());
}
