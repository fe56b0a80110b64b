// Vertex comparisons of path rows: the row-aligned checks of the
// enumeration and join hot loops, and the all-pairs form of the ops API.
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
// Bound on the H100 of these two: bytes. L <= k+1 <= 121 and D <= a few
// dozen, so each output costs a handful of integer compares against 4 bytes
// per input element read once. Design: one thread per output element
// (path_member) or row (rowwise_overlap); the D threads of one path read
// the same prefix row, which the L1 serves after the first.
//
// path_overlap replaces path_overlap_pallas
// (src/repro/kernels/path_join/kernel.py:39), the all-pairs form behind the
// ops API's keyed_join_valid / splice_join_valid:
//
//   out[i, j] = #{(p, q) : A[i, p] == B[j, q], A[i, p] >= 0}
//                                          (NA, LA) x (NB, LB) -> (NA, NB)
//
// Bound on the H100: operations at the ops API's widths (NA = NB = 4096,
// LA = LB = 6: 36 compare-and-adds per output against 4 bytes written).
// Design: one block per 32 x 64 output tile (256 threads). Column chunks
// of up to 32 of the tile's A rows and B rows are staged in shared memory,
// B transposed so that a warp reads 32 consecutive words; each thread
// keeps 8 A values in registers against one B value per step and owns the
// 8 outputs of one column j, so a warp writes 32 consecutive int32 of a
// row. The chunk loop takes any LA and LB. A's negative entries are staged
// as -2 and B's as -1, so a pad never matches and the inner loop needs no
// ">= 0" test.
//
// Inputs are row slices of wider path matrices, so every kernel here takes
// row strides and only the last dimension must be contiguous; outputs are
// dense.
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

namespace {
constexpr int kTileJ = 64;              // B rows (output columns) per block
constexpr int kTileY = 4;               // thread rows per block
constexpr int kRowsI = 8;               // A rows (outputs) per thread
constexpr int kTileI = kTileY * kRowsI; // A rows per block
constexpr int kChunk = 32;              // columns of A and B staged at once
}  // namespace

__global__ void __launch_bounds__(kTileJ * kTileY)
path_overlap_kernel(const int32_t* __restrict__ a, long long astride,
                    const int32_t* __restrict__ b, long long bstride,
                    int32_t* __restrict__ out, int NA, int NB, int LA,
                    int LB) {
  __shared__ int32_t as[kTileI][kChunk];
  __shared__ int32_t bs[kChunk][kTileJ];
  const int tx = threadIdx.x % kTileJ;
  const int ty = threadIdx.x / kTileJ;
  const int j0 = blockIdx.x * kTileJ;
  const int tiles_i = (NA + kTileI - 1) / kTileI;
  for (int ti = blockIdx.y; ti < tiles_i; ti += gridDim.y) {
    const int i0 = ti * kTileI;
    int cnt[kRowsI];
#pragma unroll
    for (int r = 0; r < kRowsI; ++r) cnt[r] = 0;
    for (int p0 = 0; p0 < LA; p0 += kChunk) {
      const int pc = min(kChunk, LA - p0);
      for (int q0 = 0; q0 < LB; q0 += kChunk) {
        const int qc = min(kChunk, LB - q0);
        __syncthreads();  // the previous chunk is no longer read
        for (int e = threadIdx.x; e < kTileI * kChunk; e += blockDim.x) {
          const int il = e / kChunk, pp = e % kChunk;
          const int i = i0 + il;
          int x = -2;
          if (i < NA && pp < pc) x = __ldg(a + i * astride + p0 + pp);
          as[il][pp] = x < 0 ? -2 : x;
        }
        for (int e = threadIdx.x; e < kChunk * kTileJ; e += blockDim.x) {
          const int qq = e / kTileJ, jl = e % kTileJ;
          const int j = j0 + jl;
          int y = -1;
          if (j < NB && qq < qc) y = __ldg(b + j * bstride + q0 + qq);
          bs[qq][jl] = y < 0 ? -1 : y;
        }
        __syncthreads();
        for (int pp = 0; pp < pc; ++pp) {
          int x[kRowsI];
#pragma unroll
          for (int r = 0; r < kRowsI; ++r) x[r] = as[ty + kTileY * r][pp];
          for (int qq = 0; qq < qc; ++qq) {
            const int y = bs[qq][tx];
#pragma unroll
            for (int r = 0; r < kRowsI; ++r) cnt[r] += (x[r] == y);
          }
        }
      }
    }
    const int j = j0 + tx;
    if (j < NB) {
#pragma unroll
      for (int r = 0; r < kRowsI; ++r) {
        const int i = i0 + ty + kTileY * r;
        if (i < NA) out[static_cast<long long>(i) * NB + j] = cnt[r];
      }
    }
  }
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

// a (NA, LA) rows astride apart; b (NB, LB) rows bstride apart;
// out (NA, NB) int32 contiguous.
REPRO_EXPORT int path_overlap_launch(const void* a, long long astride,
                                     const void* b, long long bstride,
                                     void* out, int NA, int NB, int LA,
                                     int LB, void* stream) {
  const long long tiles_i = (static_cast<long long>(NA) + kTileI - 1) /
                            kTileI;
  const dim3 grid(blocks_for(NB, kTileJ),
                  static_cast<unsigned int>(tiles_i < 65535 ? tiles_i
                                                            : 65535));
  path_overlap_kernel<<<grid, kTileJ * kTileY, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), astride,
      static_cast<const int32_t*>(b), bstride, static_cast<int32_t*>(out),
      NA, NB, LA, LB);
  return static_cast<int>(cudaGetLastError());
}
