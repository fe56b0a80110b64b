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

// ---------------------------------------------------------------------
// Other designs of msbfs_expand (the contract of msbfs_expand_launch
// in msbfs_step.cu: next[v, w] = OR of fr[ell[v, d], w] over the entries
// with ell[v, d] != V; row V of fr never read; row V of out zero), timed
// against it by probes/ops_kernel_designs.py.
//
// expand_thread_word: one thread per (v, w) word walking the whole ELL row
// with 4-byte loads (the port's kernel before its redesign).
//
// expand_bulk: persistent blocks, each walking tiles of 256 / G vertices
// (G = W / 4 threads a vertex, four words a thread). A tile's ELL rows are
// one contiguous slab, copied into shared memory by one 1-D bulk
// asynchronous copy (cp.async.bulk, its bytes counted on an mbarrier),
// with two slabs in flight: the next tile's copy is issued before the
// current tile is gathered; the copies are marked L2 evict-first. A
// thread walks its vertex's staged row from entry (vertex mod D), so the
// vertices of a warp read distinct banks.
// It takes W a multiple of 4 with W / 4 dividing 256, D a multiple of 4
// and 16-byte aligned tensors; the launcher refuses anything else.
// ---------------------------------------------------------------------

__global__ void expand_thread_word_kernel(const int32_t* __restrict__ ell,
                                          const uint32_t* __restrict__ fr,
                                          uint32_t* __restrict__ out, int V,
                                          int D, int W) {
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

REPRO_EXPORT int expand_thread_word_launch(const void* ell, const void* fr,
                                           void* out, int V, int D, int W,
                                           void* stream) {
  const long long work = static_cast<long long>(V) * W;
  expand_thread_word_kernel<<<blocks_for(work > W ? work : W,
                                         DESIGN_THREADS),
                              DESIGN_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
      static_cast<uint32_t*>(out), V, D, W);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, counted on the mbarrier `bar`; L2 evict-first
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

__global__ void __launch_bounds__(DESIGN_THREADS)
expand_bulk_kernel(const int32_t* __restrict__ ell,
                   const uint32_t* __restrict__ fr,
                   uint32_t* __restrict__ out, int V, int D, int W,
                   long long tiles) {
  extern __shared__ __align__(16) unsigned char bulk_smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(bulk_smem);
  int32_t* slabs = reinterpret_cast<int32_t*>(bulk_smem + 16);
  const int G = W / 4, TV = DESIGN_THREADS / G;
  const long long slab_words = static_cast<long long>(TV) * D;
  const int tid = threadIdx.x;
  if (blockIdx.x == 0)
    for (int k = tid; k < W; k += DESIGN_THREADS)
      out[static_cast<long long>(V) * W + k] = 0u;   // row V
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bars[0]))
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bars[1]))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long t, int s) {
    const long long v_lo = t * TV;
    const long long n = V - v_lo < TV ? V - v_lo : TV;
    bulk_load(smem_u32(slabs + s * slab_words), ell + v_lo * D,
              static_cast<uint32_t>(n * D * 4), smem_u32(&bars[s]));
  };
  long long t = blockIdx.x;
  if (tid == 0 && t < tiles) issue(t, 0);
  const int vl = tid / G, part = tid - vl * G;
  for (int it = 0; t < tiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    if (tid == 0 && t + gridDim.x < tiles) issue(t + gridDim.x, s ^ 1);
    mbar_wait(smem_u32(&bars[s]), (it >> 1) & 1);
    const long long v = t * TV + vl;
    if (v < V) {
      const int32_t* row = slabs + s * slab_words +
                           static_cast<long long>(vl) * D;
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      int c = vl % D;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const int u = row[c];
        c = c + 1 == D ? 0 : c + 1;
        if (u != V) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(
                                    fr + static_cast<long long>(u) * W) +
                                part);
          acc.x |= x.x;
          acc.y |= x.y;
          acc.z |= x.z;
          acc.w |= x.w;
        }
      }
      __stcs(reinterpret_cast<uint4*>(out + v * W) + part, acc);
    }
    __syncthreads();   // slab s is read before it is refilled
  }
}

REPRO_EXPORT int expand_bulk_launch(const void* ell, const void* fr,
                                    void* out, int V, int D, int W,
                                    void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(ell) |
                          reinterpret_cast<uintptr_t>(fr) |
                          reinterpret_cast<uintptr_t>(out);
  if (W < 4 || W % 4 != 0 || DESIGN_THREADS % (W / 4) != 0 || D < 4 ||
      D % 4 != 0 ||
      align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int TV = DESIGN_THREADS / (W / 4);
  const long long tiles = (static_cast<long long>(V) + TV - 1) / TV;
  const int smem = 16 + 2 * TV * D * 4;
  cudaError_t err = cudaFuncSetAttribute(
      expand_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, expand_bulk_kernel, DESIGN_THREADS, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                     (sms > 0 ? sms : 132);
  blocks = blocks < tiles ? blocks : tiles;
  expand_bulk_kernel<<<static_cast<unsigned>(blocks > 0 ? blocks : 1),
                       DESIGN_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
      static_cast<uint32_t*>(out), V, D, W, tiles);
  return static_cast<int>(cudaGetLastError());
}

// expand_staged*: the staged level of msbfs_expand (four words a thread;
// W a multiple of 4, D a multiple of 4, 16-byte aligned tensors), with
// one point changed at a time to test what bounds it. SU: a lane's
// staging loads in flight (1: each stored before the next is issued, as
// in the kept kernel). GM, the gathers: 0 predicated on the entry being
// live, four entries unrolled (the kept kernel); 1 the same, eight
// unrolled; 2 each staged row's live entries first moved to its front by
// a ballot, then gathered four at a time; 3 every entry gathered (a pad
// from row 0, the result masked), eight unrolled. LAST: 1 marks the
// frontier gathers L2 evict-last (createpolicy +
// ld.global.nc.L2::cache_hint), 2 keeps them out of L1
// (L1::no_allocate). MINB: blocks an SM must hold (__launch_bounds__),
// which caps registers.
#define EXP_D 32
#define EXP_STRIDE (EXP_D + 1)

__device__ __forceinline__ uint4 ld_last(const uint4* p, uint64_t pol) {
  uint4 x;
  asm volatile(
      "ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;\n"
      : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
      : "l"(p), "l"(pol));
  return x;
}

__device__ __forceinline__ uint4 ld_no_l1(const uint4* p) {
  uint4 x;
  asm volatile(
      "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(x.x), "=r"(x.y), "=r"(x.z), "=r"(x.w)
      : "l"(p));
  return x;
}

__device__ __forceinline__ void or4(uint4& acc, const uint4& x) {
  acc.x |= x.x;
  acc.y |= x.y;
  acc.z |= x.z;
  acc.w |= x.w;
}

template <int SU, int GM, int LAST, int MINB>
__global__ void __launch_bounds__(DESIGN_THREADS, MINB)
expand_staged_kernel(const int32_t* __restrict__ ell,
                     const uint32_t* __restrict__ fr,
                     uint32_t* __restrict__ out, int V, int D, int W) {
  extern __shared__ int32_t exp_stage[];
  const int G = W / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_warp = 31 / G + 2 < 32 ? 31 / G + 2 : 32;
  int32_t* rows = exp_stage + warp * rows_warp * EXP_STRIDE;
  const long long total = static_cast<long long>(V) * G;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * DESIGN_THREADS + warp * 32;
  const long long i = i0 + lane;
  if (i < W) out[static_cast<long long>(V) * W + i] = 0u;   // row V
  if (i0 >= total) return;
  const bool active = i < total;
  const long long v_lo = i0 / G;
  const long long last = (i0 + 32 < total ? i0 + 32 : total) - 1;
  const int nrows = static_cast<int>(last / G - v_lo + 1);
  const long long v = active ? i / G : v_lo;
  const int part = static_cast<int>(i - v * G);
  int32_t* row = rows + (v - v_lo) * EXP_STRIDE;
  uint64_t pol = 0;
  if (LAST == 1)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(pol));
  const uint4* frp = reinterpret_cast<const uint4*>(fr) + part;
  const int words4 = W / 4;   // 16-byte pieces of a frontier row
  auto gather = [&](int u) {
    const uint4* p = frp + static_cast<long long>(u) * words4;
    return LAST == 1 ? ld_last(p, pol) : LAST == 2 ? ld_no_l1(p) : __ldg(p);
  };
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int d0 = 0; d0 < D; d0 += EXP_D) {
    const int dc = D - d0 < EXP_D ? D - d0 : EXP_D;
    if (d0 > 0) __syncwarp();
    const int q = dc / 4, n = nrows * q;
    for (int e0 = lane; e0 < n; e0 += 32 * SU) {
      int4 x[SU];
#pragma unroll
      for (int s = 0; s < SU; ++s) {
        const int e = e0 + 32 * s, r = e / q, k = e - r * q;
        if (e < n)
          x[s] = __ldcs(reinterpret_cast<const int4*>(
                            ell + (v_lo + r) * D + d0) + k);
      }
#pragma unroll
      for (int s = 0; s < SU; ++s) {
        const int e = e0 + 32 * s, r = e / q, k = e - r * q;
        if (e < n) {
          int32_t* dst = rows + r * EXP_STRIDE + 4 * k;
          dst[0] = x[s].x;
          dst[1] = x[s].y;
          dst[2] = x[s].z;
          dst[3] = x[s].w;
        }
      }
    }
    __syncwarp();
    if (GM == 2) {
#pragma unroll 4
      for (int r = 0; r < nrows; ++r) {
        int32_t* rr = rows + r * EXP_STRIDE;
        const int u = lane < dc ? rr[lane] : V;
        const unsigned live = __ballot_sync(FULL_MASK, u != V);
        if (u != V) rr[__popc(live & ((1u << lane) - 1u))] = u;
        if (lane == 0) rr[EXP_D] = __popc(live);
      }
      __syncwarp();
    }
    if (!active) continue;
    if (GM == 0) {
#pragma unroll 4
      for (int c = 0; c < dc; ++c) {
        const int u = row[c];
        if (u != V) or4(acc, gather(u));
      }
    } else if (GM == 1) {
#pragma unroll 8
      for (int c = 0; c < dc; ++c) {
        const int u = row[c];
        if (u != V) or4(acc, gather(u));
      }
    } else if (GM == 2) {
      const int cnt = row[EXP_D];
      for (int c0 = 0; c0 < cnt; c0 += 4) {
        uint4 x[4];
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (c0 + s < cnt) x[s] = gather(row[c0 + s]);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (c0 + s < cnt) or4(acc, x[s]);
      }
    } else {
#pragma unroll 8
      for (int c = 0; c < dc; ++c) {
        const int u = row[c];
        uint4 x = gather(u == V ? 0 : u);
        if (u == V) x = make_uint4(0u, 0u, 0u, 0u);
        or4(acc, x);
      }
    }
  }
  if (active) __stcs(reinterpret_cast<uint4*>(out + v * W) + part, acc);
}

template <int SU, int GM, int LAST, int MINB>
int launch_staged(const void* ell, const void* fr, void* out, int V, int D,
                  int W, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(ell) |
                          reinterpret_cast<uintptr_t>(fr) |
                          reinterpret_cast<uintptr_t>(out);
  if (W < 4 || W % 4 != 0 || D < 4 || D % 4 != 0 || align % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = W / 4;
  const int rows_warp = 31 / G + 2 < 32 ? 31 / G + 2 : 32;
  const int smem = (DESIGN_THREADS / 32) * rows_warp * EXP_STRIDE * 4;
  const long long work = static_cast<long long>(V) * G;
  expand_staged_kernel<SU, GM, LAST, MINB>
      <<<blocks_for(work > W ? work : W, DESIGN_THREADS), DESIGN_THREADS,
         smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(ell), static_cast<const uint32_t*>(fr),
          static_cast<uint32_t*>(out), V, D, W);
  return static_cast<int>(cudaGetLastError());
}

#define EXPAND_STAGED(name, SU, GM, LAST, MINB)                             \
  REPRO_EXPORT int expand_##name##_launch(const void* ell, const void* fr, \
                                          void* out, int V, int D, int W,  \
                                          void* stream) {                  \
    return launch_staged<SU, GM, LAST, MINB>(ell, fr, out, V, D, W,        \
                                             stream);                      \
  }
EXPAND_STAGED(staged, 1, 0, 0, 1)
EXPAND_STAGED(staged_last, 1, 0, 1, 1)
EXPAND_STAGED(staged_no_l1, 1, 0, 2, 6)
EXPAND_STAGED(staged_all, 1, 3, 0, 1)
EXPAND_STAGED(staged_u4, 4, 0, 0, 1)
EXPAND_STAGED(staged_g8, 1, 1, 0, 1)
EXPAND_STAGED(staged_compact, 1, 2, 0, 1)
EXPAND_STAGED(staged_compact_occ6, 1, 2, 0, 6)
EXPAND_STAGED(staged_occ8, 1, 0, 0, 8)
EXPAND_STAGED(staged_compact_occ8, 1, 2, 0, 8)
