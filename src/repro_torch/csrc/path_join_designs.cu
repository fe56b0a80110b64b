// The port's first path_overlap kernel (the contract of path_overlap_launch in
// path_join.cu: out[i, j] = #{(p, q) : A[i, p] == B[j, q], A[i, p] >= 0},
// negative entries pads, row strides, any LA and LB), kept so that
// probes/ops_kernel_designs.py can time it against the kernel the port
// uses. Nothing in the package calls it.
//
// compare: one block per 32 x 64 output tile (256 threads). Column chunks
// of up to 32 of the tile's A rows and B rows are staged in shared memory,
// B transposed so that a warp reads 32 consecutive words; each thread
// keeps 8 A values in registers against one B value per step and owns the
// 8 outputs of one column j. A's negative entries are staged as -2 and
// B's as -1, so a pad never matches. An ISETP and an IADD a (p, q) pair.
#include "common.cuh"

namespace {
constexpr int kTileJ = 64;              // B rows (output columns) per block
constexpr int kTileY = 4;               // thread rows per block
constexpr int kRowsI = 8;               // A rows (outputs) per thread
constexpr int kTileI = kTileY * kRowsI; // A rows per block
constexpr int kChunk = 32;              // columns of A and B staged at once
}  // namespace

__global__ void __launch_bounds__(kTileJ * kTileY)
overlap_compare_kernel(const int32_t* __restrict__ a, long long astride,
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

// a (NA, LA) rows astride apart; b (NB, LB) rows bstride apart;
// out (NA, NB) int32 contiguous.
REPRO_EXPORT int overlap_compare_launch(const void* a, long long astride,
                                     const void* b, long long bstride,
                                     void* out, int NA, int NB, int LA,
                                     int LB, void* stream) {
  const long long tiles_i = (static_cast<long long>(NA) + kTileI - 1) /
                            kTileI;
  const dim3 grid(blocks_for(NB, kTileJ),
                  static_cast<unsigned int>(tiles_i < 65535 ? tiles_i
                                                            : 65535));
  overlap_compare_kernel<<<grid, kTileJ * kTileY, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), astride,
      static_cast<const int32_t*>(b), bstride, static_cast<int32_t*>(out),
      NA, NB, LA, LB);
  return static_cast<int>(cudaGetLastError());
}
