// Throughput probes for the two ways the card can compute popcount(AND)
// over packed words. They are not kernels of the engine: chip_smoke.py
// times them to get the peak rates that bound pairwise_popcount, since the
// H100 data sheet publishes neither.
//
//   popc_peak     -- 32-bit __popc on the CUDA cores (the operation
//                    pairwise_popcount.cu does), CHAINS independent
//                    accumulators per thread so the loop is bound by the
//                    popc issue rate, not by its latency.
//   b1_mma_peak   -- the tensor cores' 1-bit MMA
//                    mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc:
//                    one instruction is 16*8*256 AND+popc-accumulate bit
//                    pairs for the warp. CHAINS independent accumulator
//                    fragments per warp, operands fixed in registers.
//
// Each thread writes the sum of its accumulators, so nothing is dead code.
#include "common.cuh"

#define CHAINS 8

__global__ void popc_peak_kernel(const uint32_t* __restrict__ in,
                                 int32_t* __restrict__ out, int iters) {
  uint32_t x[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) x[j] = in[(threadIdx.x + j) & 255];
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      x[j] += __popc(x[j] ^ static_cast<uint32_t>(i));
  }
  uint32_t s = 0u;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += x[j];
  out[static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x] =
      static_cast<int32_t>(s);
}

__global__ void b1_mma_peak_kernel(const uint32_t* __restrict__ in,
                                   int32_t* __restrict__ out, int iters) {
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = in[lane], a1 = in[lane + 32], a2 = in[lane + 64],
                 a3 = in[lane + 96], b0 = in[lane + 128],
                 b1 = in[lane + 160];
  int32_t d[CHAINS][4];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};\n"
          : "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int32_t s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x] = s;
}

// in: at least 256 words; out: blocks * threads int32. Per launch,
// popc_peak does blocks * threads * iters * CHAINS population counts and
// b1_mma_peak does blocks * (threads / 32) * iters * CHAINS MMAs.
REPRO_EXPORT int popc_peak_launch(const void* in, void* out, int blocks,
                                  int threads, int iters, void* stream) {
  popc_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<int32_t*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int b1_mma_peak_launch(const void* in, void* out, int blocks,
                                    int threads, int iters, void* stream) {
  b1_mma_peak_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<int32_t*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int probe_chains() { return CHAINS; }
