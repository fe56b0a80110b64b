// Row-aligned vertex comparisons of the enumeration and join hot loops.
//
// path_member replaces path_member_pallas
// (src/repro/kernels/path_join/kernel.py:109):
//
//   out[i, d] = #{p : cand[i, d] == verts[i, p]}     (N, L) x (N, D) -> (N, D)
//
// the duplicate-vertex mask of one expand level: the D ELL candidates of
// every frontier path checked against its own L-vertex prefix.
//
// rowwise_overlap replaces rowwise_overlap_pallas
// (src/repro/kernels/path_join/kernel.py:70):
//
//   out[i] = #{(p, q) : A[i, p] == B[i, q], A[i, p] >= 0}   -> (N,)
//
// the simple-path check of the joins (keyed join valid <=> 1, splice
// join valid <=> 0).
//
// Bound on the H100: bytes. L <= k+1 <= 121 and D <= a few dozen, so each
// output costs a handful of integer compares against 4 bytes per input
// element read once. Design: one thread per output element (path_member)
// or row (rowwise_overlap); the D threads of one path read the same prefix
// row, which the L1 serves after the first. Inputs are row slices of wider
// path matrices, so each takes a row stride and only its last dimension
// must be contiguous; outputs are dense.
#include "common.cuh"

__global__ void path_member_kernel(const int32_t* __restrict__ verts,
                                   long long vstride,
                                   const int32_t* __restrict__ cand,
                                   long long cstride,
                                   int32_t* __restrict__ out, int N, int L,
                                   int D) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  if (idx >= static_cast<long long>(N) * D) return;
  const long long i = idx / D;
  const int d = static_cast<int>(idx - i * D);
  const int c = __ldg(cand + i * cstride + d);
  const int32_t* row = verts + i * vstride;
  int cnt = 0;
  for (int p = 0; p < L; ++p) cnt += (__ldg(row + p) == c);
  out[idx] = cnt;
}

__global__ void rowwise_overlap_kernel(const int32_t* __restrict__ a,
                                       long long astride,
                                       const int32_t* __restrict__ b,
                                       long long bstride,
                                       int32_t* __restrict__ out, int N,
                                       int LA, int LB) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= N) return;
  const int32_t* ra = a + i * astride;
  const int32_t* rb = b + i * bstride;
  int cnt = 0;
  for (int p = 0; p < LA; ++p) {
    const int x = __ldg(ra + p);
    if (x < 0) continue;
    for (int q = 0; q < LB; ++q) cnt += (__ldg(rb + q) == x);
  }
  out[i] = cnt;
}

// verts (N, L) rows vstride apart; cand (N, D) rows cstride apart;
// out (N, D) int32 contiguous.
REPRO_EXPORT int path_member_launch(const void* verts, long long vstride,
                                    const void* cand, long long cstride,
                                    void* out, int N, int L, int D,
                                    void* stream) {
  const int threads = 256;
  path_member_kernel<<<blocks_for(static_cast<long long>(N) * D, threads),
                       threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(verts), vstride,
      static_cast<const int32_t*>(cand), cstride, static_cast<int32_t*>(out),
      N, L, D);
  return static_cast<int>(cudaGetLastError());
}

// a (N, LA) rows astride apart; b (N, LB) rows bstride apart; out (N,).
REPRO_EXPORT int rowwise_overlap_launch(const void* a, long long astride,
                                        const void* b, long long bstride,
                                        void* out, int N, int LA, int LB,
                                        void* stream) {
  const int threads = 256;
  rowwise_overlap_kernel<<<blocks_for(N, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), astride,
      static_cast<const int32_t*>(b), bstride, static_cast<int32_t*>(out), N,
      LA, LB);
  return static_cast<int>(cudaGetLastError());
}
