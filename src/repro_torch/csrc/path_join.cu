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
// counting repeats (a row [5, 5] against [5] counts 2); any negative entry
// is a pad. As an integer product: for a tile of A rows, number the
// distinct non-negative ids it holds (its dictionary, k = 0 .. K-1); then
// out[i, j] = sum_k cntA[i, k] * cntB[j, k], where cntA[i, k] counts id k
// in A row i and cntB[j, k] in B row j (ids outside the dictionary match
// nothing in the tile). Design: a block takes 32 A rows and builds their
// dictionary in shared memory (a 1024-slot hash table filled by atomicCAS,
// new keys numbered by an atomic counter, at most 256 ids), then the int8
// count rows cntA (32 x K); for each tile of 256 B rows, a thread looks
// its row's ids up (eight loads and eight first probes in flight, the
// next tile's first ids loaded a tile ahead) and counts them into cntB
// (256 x K), the tensor cores form the product (mma.sync m16n8k32 s8 x
// s8 -> s32, K rounded up to 32; a warp owns a 32 x 32 output block), and
// the 32 x 256 int32 tile goes out through shared memory in 16-byte
// stores, a warp writing 512 contiguous bytes. Count rows are K + 16
// bytes apart, so the fragment loads of 8 rows hit 32 distinct banks.
// The grid is one wave: B tiles are split over blocks only as far as the
// A tiles leave the card's block slots free, so a dictionary serves as
// many B tiles as it can. A tile whose dictionary overflows (more than
// 256 distinct ids: large LA with few repeats), and every tile when a row
// is longer than 127 (an int8 count could overflow), takes the compare
// loop instead: 32 x 64 output chunks, columns of A and B staged in
// shared memory 32 at a time, an ISETP and an IADD per (p, q) pair, pads
// staged as -2 (A) and -1 (B).
// Bound on the H100: the output bytes (67 MB at NA = NB = 4096, 0.020
// ms); the formulation's operations are 2 * 32 * 256 * K per tile pair at
// the int8 tensor-core rate, the dictionary and the count rows a handful
// of shared-memory operations per input id and per count byte.
//
// Inputs are row slices of wider path matrices, so every kernel here takes
// row strides and only the last dimension must be contiguous; outputs are
// dense.
//
// The engine does not call path_member and rowwise_overlap on their own:
// each is the heart of a larger pass that it runs as one kernel, so a level
// and a join cost two launches (a memset and the kernel) where the eager
// composition of their plain versions costs 25-40.
//
// expand_level_kernel (path_member's pass, core/enumerate.py): one expand
// level of the frontier. One warp per frontier row: lane d reads ELL entry
// d of the row's last vertex (one coalesced 128-byte row at D = 32, in
// 32-wide chunks past it), the row's prefix is read once and broadcast by
// __shfl_sync for the duplicate test, the prune entry (slack, splice
// budget) is one 2-byte load, and __ballot_sync / __popc give the row's
// survivors and each lane's rank among them. It writes nbrs and
// splice_hit for every row (rows at and past count read ELL row 0, as the
// plain version does) and the surviving (prefix ++ candidate) rows in
// (row, candidate) order.
//
// join_kernel (rowwise_overlap's pass, core/join.py): one thread per pair
// id of a keyed join (binary search of the id in the bucket offsets), a
// counting keyed join or a splice join (id // c_count, id % c_count, both
// counts read on the device). It gathers the two half rows, counts their
// shared vertices in registers (keyed valid <=> 1, splice valid <=> 0) and
// writes the assembled row, A ++ reversed(B[:b_col]) or prefix ++ child, of
// each valid pair in pair-id order; the counting join only adds its valid
// pairs up (a warp reduction and one atomic a warp).
//
// Compaction keeps the order with a single-pass scan across blocks
// (decoupled look-back): each block takes a tile ticket, publishes its
// survivor count, and warp 0 sums its predecessors' counts 32 tiles at a
// time, stopping at the first tile that has published its inclusive
// prefix. Tickets are taken in the order blocks start, so a block waits
// only on blocks that are running. A tile's state is one 64-bit word,
// status in the top two bits and the count below, so a status and its
// count are read and written together.
//
// The wrapper makes one allocation per call: the scan state (int64 words:
// count, overflow flag, tile ticket, then one word per tile) followed by
// the output rows. One cudaMemsetAsync fills it with 0xFF bytes, which is
// -1 in every output cell (only survivors are written) and "not ready" in
// every tile word; the counting join's state is zeroed instead. The last
// tile writes count = min(total, out_cap) and overflow = total > out_cap
// (keyed and splice joins: the pair count past out_cap) into words 0 and
// 1, so the host reads both with one copy. Nothing allocates or syncs
// inside, so the passes can be captured in a CUDA graph.
//
// Bound on the H100 of both passes: bytes. A level reads its frontier rows,
// their ELL rows and the candidates' prune entries and writes nbrs,
// splice_hit and the survivors; a join reads the half rows of its pairs
// and writes the valid ones. At the main path's sizes (a few hundred rows)
// both are far under a microsecond of traffic: what they save is launches.
#include <atomic>

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
// path_overlap: a block takes kOvA rows of A against kOvB rows of B at a
// time, a warp the 32 x 32 output block of its 32 B rows
constexpr int kOvThreads = 256;
constexpr int kOvBlocks = 3;           // an SM holds three (registers)
constexpr int kOvA = 32;               // two m16 MMA row tiles
constexpr int kOvB = kOvThreads;       // a B row per thread
constexpr int kDictMax = 256;          // distinct ids a dictionary holds
constexpr int kHashSlots = 4 * kDictMax;  // slots of {key, index}
constexpr int kMaxCount = 127;         // int8 counts
// the compare loop of an overflowed tile: 32 x 64 output chunks, columns
// of A and B staged 32 at a time
constexpr int kCmpJ = 64;
constexpr int kCmpChunk = 32;
constexpr int kCmpSmem = (kOvA * kCmpChunk + kCmpChunk * kCmpJ) * 4;
// the output tile staged in shared memory: rows 264 words apart, so the
// accumulators' 8-byte writes (4 rows a half warp) hit distinct banks
constexpr int kOutStride = kOvB + 8;
constexpr int kOutSmem = kOvA * kOutStride * 4;
// the most dynamic shared memory a launch asks for (kcap = kDictMax)
constexpr int kMaxOvSmem =
    kHashSlots * 8 + (kOvA + kOvB) * (kDictMax + 16);
static_assert(kOvB * (kDictMax + 16) >= kOutSmem, "");
constexpr int kMaxDevices = 64;
}  // namespace

__device__ __forceinline__ int dict_slot(int x) {
  return static_cast<int>((static_cast<uint32_t>(x) * 2654435761u) >>
                          (32 - 10)) & (kHashSlots - 1);
}

// The dictionary index of id x >= 0, or -1, probing from slot `from`. The
// table holds at most kDictMax keys in kHashSlots slots, so an empty slot
// ends every probe. A slot is {key, index}, key -1 when empty: one load
// reads both.
__device__ __forceinline__ int dict_find(const int2* table, int x,
                                         int from) {
  for (int s = from;; s = (s + 1) & (kHashSlots - 1)) {
    const int2 e = table[s];
    if (e.x == x) return e.y;
    if (e.x == -1) return -1;
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Up to kIdRun ids of a row from column q0 on, loaded together (-1 past
// the row's end), so that their latencies overlap.
constexpr int kIdRun = 8;
__device__ __forceinline__ void load_ids(int (&ids)[kIdRun],
                                         const int32_t* __restrict__ row,
                                         int q0, int L) {
#pragma unroll
  for (int u = 0; u < kIdRun; ++u)
    ids[u] = q0 + u < L ? __ldg(row + q0 + u) : -1;
}

// Add one to counts[k] for every id of `ids` found in the dictionary: the
// first probes of all ids are read together, and only an id whose first
// slot holds another key probes further.
__device__ __forceinline__ void count_ids(const int (&ids)[kIdRun],
                                          const int2* table,
                                          unsigned char* counts) {
  int slot[kIdRun];
  int2 first[kIdRun];
#pragma unroll
  for (int u = 0; u < kIdRun; ++u) {
    slot[u] = dict_slot(ids[u]);
    first[u] = ids[u] < 0 ? make_int2(-1, 0) : table[slot[u]];
  }
#pragma unroll
  for (int u = 0; u < kIdRun; ++u) {
    if (first[u].x == -1) continue;  // a pad, or an empty first slot
    const int k = first[u].x == ids[u]
                      ? first[u].y
                      : dict_find(table, ids[u],
                                  (slot[u] + 1) & (kHashSlots - 1));
    // a shared-memory add into the count's word (counts stay below 128,
    // so no carry crosses a byte): the adds of a run need not wait for
    // each other
    if (k >= 0)
      atomicAdd(reinterpret_cast<unsigned*>(counts + (k & ~3)),
                1u << (8 * (k & 3)));
  }
}

// The compare loop over the 32 x kOvB output tile at (i0, j0), in chunks
// of 32 x 64: A's negative entries staged as -2 and B's as -1, so a pad
// never matches; each thread holds 8 A values against one B value a step
// and owns 8 outputs of one column. smem: kCmpSmem bytes.
__device__ void compare_tile(const int32_t* __restrict__ a, long long astride,
                             const int32_t* __restrict__ b, long long bstride,
                             int32_t* __restrict__ out, int NA, int NB,
                             int LA, int LB, int i0, int j0, int32_t* smem) {
  int32_t (*as)[kCmpChunk] = reinterpret_cast<int32_t (*)[kCmpChunk]>(smem);
  int32_t (*bs)[kCmpJ] =
      reinterpret_cast<int32_t (*)[kCmpJ]>(smem + kOvA * kCmpChunk);
  constexpr int kRows = kOvA * kCmpJ / kOvThreads;   // outputs a thread
  const int tx = threadIdx.x % kCmpJ, ty = threadIdx.x / kCmpJ;
  for (int jc = j0; jc < j0 + kOvB && jc < NB; jc += kCmpJ) {
    int cnt[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) cnt[r] = 0;
    for (int p0 = 0; p0 < LA; p0 += kCmpChunk) {
      const int pc = min(kCmpChunk, LA - p0);
      for (int q0 = 0; q0 < LB; q0 += kCmpChunk) {
        const int qc = min(kCmpChunk, LB - q0);
        __syncthreads();  // the previous chunk is no longer read
        for (int e = threadIdx.x; e < kOvA * kCmpChunk; e += kOvThreads) {
          const int il = e / kCmpChunk, pp = e % kCmpChunk;
          int x = -2;
          if (i0 + il < NA && pp < pc)
            x = __ldg(a + (i0 + il) * astride + p0 + pp);
          as[il][pp] = x < 0 ? -2 : x;
        }
        for (int e = threadIdx.x; e < kCmpChunk * kCmpJ; e += kOvThreads) {
          const int qq = e / kCmpJ, jl = e % kCmpJ;
          int y = -1;
          if (jc + jl < NB && qq < qc)
            y = __ldg(b + (jc + jl) * bstride + q0 + qq);
          bs[qq][jl] = y < 0 ? -1 : y;
        }
        __syncthreads();
        for (int pp = 0; pp < pc; ++pp) {
          int x[kRows];
#pragma unroll
          for (int r = 0; r < kRows; ++r) x[r] = as[ty + 4 * r][pp];
          for (int qq = 0; qq < qc; ++qq) {
            const int y = bs[qq][tx];
#pragma unroll
            for (int r = 0; r < kRows; ++r) cnt[r] += (x[r] == y);
          }
        }
      }
    }
    if (jc + tx < NB) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + ty + 4 * r;
        if (i < NA) out[static_cast<long long>(i) * NB + jc + tx] = cnt[r];
      }
    }
  }
  __syncthreads();  // the staged chunks are read before smem is reused
}

// grid (tiles of kOvA A rows, up to 65,535 B tiles, each block looping
// over the B tiles of its column). kcap: dictionary columns (a multiple
// of 32, at most kDictMax; 0 = every tile takes the compare loop). smem:
// the hash table ({key, index} slots), then the count rows, cntA (kOvA) and
// cntB (kOvB), kcap + 16 bytes apart; cntB's space also holds the output
// tile, or the compare loop's chunks.
__global__ void __launch_bounds__(kOvThreads, kOvBlocks)
path_overlap_kernel(const int32_t* __restrict__ a, long long astride,
                    const int32_t* __restrict__ b, long long bstride,
                    int32_t* __restrict__ out, int NA, int NB, int LA,
                    int LB, int kcap) {
  extern __shared__ __align__(16) unsigned char ov_smem[];
  __shared__ int s_nk, s_over;
  int2* table = reinterpret_cast<int2*>(ov_smem);
  unsigned char* cnt_a = ov_smem + kHashSlots * 8;
  const int stride = kcap + 16;    // bytes: 8 rows at one column, 8 banks
  unsigned char* cnt_b = cnt_a + kOvA * stride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * kOvA;
  const int na = min(kOvA, NA - i0);
  const int tiles_j = (NB + kOvB - 1) / kOvB;

  // 1. the dictionary of the tile's non-negative A ids: a hash table
  // filled by atomicCAS, each new key numbered by an atomic counter
  bool over = kcap == 0;
  if (!over) {
    for (int e = tid; e < kHashSlots; e += kOvThreads)
      table[e] = make_int2(-1, 0);
    if (tid == 0) s_nk = s_over = 0;
    __syncthreads();
    for (int e = tid; e < na * LA; e += kOvThreads) {
      const int r = e / LA, p = e - r * LA;
      const int x = __ldg(a + (i0 + r) * astride + p);
      if (x < 0) continue;
      int s = dict_slot(x), n = 0;
      for (; n < kHashSlots; ++n, s = (s + 1) & (kHashSlots - 1)) {
        int* key = reinterpret_cast<int*>(table + s);
        const int old = atomicCAS(key, -1, x);
        if (old == -1) {
          const int k = atomicAdd(&s_nk, 1);
          if (k < kcap) key[1] = k;
          else s_over = 1;
          break;
        }
        if (old == x) break;
      }
      if (n == kHashSlots) s_over = 1;   // the table is full
    }
    __syncthreads();
    over = s_over != 0;
  }
  // 2. cntA[i, k]: how often dictionary id k occurs in A row i
  const int kp = over ? 0 : (s_nk + 31) & ~31;
  if (!over) {
    for (int e = tid; e < kOvA * (kp / 16); e += kOvThreads) {
      const int r = e / (kp / 16), c = e - r * (kp / 16);
      *reinterpret_cast<uint4*>(cnt_a + r * stride + 16 * c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    if (tid < na) {
      const int32_t* row = a + (i0 + tid) * astride;
      for (int p0 = 0; p0 < LA; p0 += kIdRun) {
        int ids[kIdRun];
        load_ids(ids, row, p0, LA);
        count_ids(ids, table, cnt_a + tid * stride);
      }
    }
  }
  // the first kIdRun ids of this thread's B row in the block's next B
  // tile, loaded a tile ahead
  int next[kIdRun];
  auto prefetch = [&](int jt) {
    const int j = jt * kOvB + tid;
    const int32_t* row = b + static_cast<long long>(j) * bstride;
    load_ids(next, row, 0, jt < tiles_j && j < NB ? LB : 0);
  };
  if (!over) prefetch(blockIdx.y);
  for (int jt = blockIdx.y; jt < tiles_j; jt += gridDim.y) {
    const int j0 = jt * kOvB;
    if (over) {
      compare_tile(a, astride, b, bstride, out, NA, NB, LA, LB, i0, j0,
                   reinterpret_cast<int32_t*>(cnt_b));
      continue;
    }
    // 3. cntB[j, k]: how often dictionary id k occurs in B row j (ids
    // outside the dictionary match no A entry of the tile)
    int ids[kIdRun];
#pragma unroll
    for (int u = 0; u < kIdRun; ++u) ids[u] = next[u];
    prefetch(jt + gridDim.y);
    unsigned char* mine = cnt_b + tid * stride;
    for (int c = 0; c < kp; c += 16)
      *reinterpret_cast<uint4*>(mine + c) = make_uint4(0u, 0u, 0u, 0u);
    count_ids(ids, table, mine);
    if (LB > kIdRun && j0 + tid < NB) {
      const int32_t* row = b + static_cast<long long>(j0 + tid) * bstride;
      for (int q0 = kIdRun; q0 < LB; q0 += kIdRun) {
        load_ids(ids, row, q0, LB);
        count_ids(ids, table, mine);
      }
    }
    __syncthreads();
    // 4. out[i, j] = sum_k cntA[i, k] * cntB[j, k] on the tensor cores:
    // warp w takes B rows 32w .. 32w + 31, two m16 tiles by four n8 tiles
    const int g = lane >> 2, t4 = (lane & 3) * 4;
    int32_t acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[m][n][r] = 0;
    for (int k0 = 0; k0 < kp; k0 += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const unsigned char* p = cnt_a + (16 * m + g) * stride + k0 + t4;
        af[m][0] = *reinterpret_cast<const uint32_t*>(p);
        af[m][1] = *reinterpret_cast<const uint32_t*>(p + 8 * stride);
        af[m][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[m][3] = *reinterpret_cast<const uint32_t*>(p + 8 * stride + 16);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const unsigned char* p =
            cnt_b + (32 * warp + 8 * n + g) * stride + k0 + t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_s8(acc[m][n], af[m], b0, b1);
      }
    }
    // 5. the output tile through shared memory (cntB's space, once every
    // warp has read it): accumulator r of an MMA tile is row g (r < 2) or
    // g + 8, column 2 (lane % 4) + r % 2; then rows of 1 KB go out in
    // 16-byte stores, a warp writing 512 contiguous bytes
    __syncthreads();
    int32_t* tile = reinterpret_cast<int32_t*>(cnt_b);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<int2*>(
              tile + (16 * m + g + 8 * h) * kOutStride + 32 * warp + 8 * n +
              (lane & 3) * 2) = make_int2(acc[m][n][2 * h],
                                          acc[m][n][2 * h + 1]);
    __syncthreads();
    const int cols = min(kOvB, NB - j0);
    const bool vec = NB % 4 == 0;    // 16-byte aligned output rows
    for (int e = tid; e < kOvA * (kOvB / 4); e += kOvThreads) {
      const int r = e / (kOvB / 4), c = 4 * (e % (kOvB / 4));
      if (i0 + r >= NA || c >= cols) continue;
      const int4 v = *reinterpret_cast<const int4*>(tile + r * kOutStride + c);
      int32_t* o = out + static_cast<long long>(i0 + r) * NB + j0 + c;
      if (vec && c + 3 < cols) {
        __stcs(reinterpret_cast<int4*>(o), v);
      } else {
        o[0] = v.x;
        if (c + 1 < cols) o[1] = v.y;
        if (c + 2 < cols) o[2] = v.z;
        if (c + 3 < cols) o[3] = v.w;
      }
    }
    __syncthreads();   // the tile is read before the next B tile's cntB
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
  // dictionary columns: every distinct id of a tile, up to kDictMax; a
  // row longer than kMaxCount could hold an id more often than int8
  // counts, so then every tile takes the compare loop
  const long long ids = static_cast<long long>(kOvA) * LA;  // per tile
  const int kcap = LA > kMaxCount || LB > kMaxCount ? 0
                   : ids < kDictMax ? static_cast<int>((ids + 31) & ~31LL)
                                    : kDictMax;
  // the hash table, cntA, then cntB's space, which also takes the output
  // tile and the compare loop's chunks
  const int tiles = kOutSmem > kCmpSmem ? kOutSmem : kCmpSmem;
  const int region = kOvB * (kcap + 16) > tiles ? kOvB * (kcap + 16) : tiles;
  const int smem = kHashSlots * 8 + kOvA * (kcap + 16) + region;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // per device, once: the shared memory allowance, and the blocks the
  // card holds at once for each dictionary width
  static std::atomic<int> allowed[kMaxDevices];
  static std::atomic<int> resident[kMaxDevices][kDictMax / 32 + 1];
  if (!allowed[dev].load()) {
    const cudaError_t err = cudaFuncSetAttribute(
        path_overlap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxOvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev].store(1);
  }
  int slots = resident[dev][kcap / 32].load();
  if (!slots) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, path_overlap_kernel, kOvThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 132);
    resident[dev][kcap / 32].store(slots);
  }
  // one wave: B tiles are split over blocks only as far as the A tiles
  // leave the card's block slots free, so a dictionary serves as many B
  // tiles as it can
  const long long tiles_i = (static_cast<long long>(NA) + kOvA - 1) / kOvA;
  const long long tiles_j = (static_cast<long long>(NB) + kOvB - 1) / kOvB;
  long long split = slots / tiles_i;
  split = split < tiles_j ? split : tiles_j;
  split = split < 65535 ? split : 65535;
  const dim3 grid(static_cast<unsigned int>(tiles_i),
                  static_cast<unsigned int>(split > 1 ? split : 1));
  path_overlap_kernel<<<grid, kOvThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), astride,
      static_cast<const int32_t*>(b), bstride, static_cast<int32_t*>(out),
      NA, NB, LA, LB, kcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The fused expand level and joins (see the top of this file).
// ---------------------------------------------------------------------

namespace {
constexpr int kFusedWarps = 8;                  // rows / warps per block
constexpr int kFusedThreads = kFusedWarps * 32;
constexpr unsigned kFullMask = 0xffffffffu;
// state words: [0] count, [1] overflow, [2] tile ticket, [3 + t] tile t
constexpr int kStateHead = 3;
// a tile word: status in bits 62-63, count below; 0xFF fill = not ready
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kNotReady = 3ull;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Thread 0 takes the block's tile ticket (tiles are numbered in the order
// blocks start; the ticket word starts at 0xFFFFFFFF).
__device__ __forceinline__ long long take_tile(unsigned long long* state,
                                               long long* s_tile) {
  if (threadIdx.x == 0) {
    *s_tile = static_cast<long long>(
        atomicAdd(reinterpret_cast<unsigned int*>(state + 2), 1u) + 1u);
  }
  __syncthreads();
  return *s_tile;
}

// Called by all 32 lanes of one warp: publish the tile's aggregate, sum
// the predecessors' (32 tiles per step, up to the nearest inclusive
// prefix), publish the inclusive prefix and return the exclusive one.
__device__ unsigned long long scan_lookback(unsigned long long* tiles,
                                            long long tile,
                                            unsigned long long aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_word(tiles, kInclusive | aggregate);
    return 0;
  }
  if (lane == 0) store_word(tiles + tile, kAggregate | aggregate);
  unsigned long long exclusive = 0;
  long long nearest = tile - 1;
  while (true) {
    const long long t = nearest - lane;
    unsigned long long s = t >= 0 ? load_word(tiles + t) : kInclusive;
    while (__any_sync(kFullMask, (s >> 62) == kNotReady)) {
      if ((s >> 62) == kNotReady) s = load_word(tiles + t);
    }
    const unsigned done = __ballot_sync(kFullMask, (s >> 62) == 2);
    const int stop = done ? __ffs(done) - 1 : 31;
    unsigned long long v = lane <= stop ? (s & kValueMask) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(kFullMask, v, off);
    exclusive += __shfl_sync(kFullMask, v, 0);
    if (done) break;
    nearest -= 32;
  }
  if (lane == 0) store_word(tiles + tile, kInclusive | (exclusive + aggregate));
  return exclusive;
}

// The block's exclusive prefix of its warps' counts: every warp's offset
// in s_warp (exclusive) and the block's offset among all tiles in *s_base.
// Only tiles 0..last_tile scan (the tiles after them hold no survivor);
// last_tile writes the totals. Called by every thread of the block.
__device__ void block_scan(unsigned long long warp_count,
                           unsigned long long* state, long long tile,
                           long long last_tile, long long out_cap,
                           bool pairs_overflow,
                           unsigned long long* s_warp,
                           unsigned long long* s_base) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s_warp[warp] = warp_count;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long own = lane < kFusedWarps ? s_warp[lane] : 0;
    unsigned long long v = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFullMask, v, off);
      if (lane >= off) v += y;
    }
    const unsigned long long aggregate = __shfl_sync(kFullMask, v, 31);
    if (lane < kFusedWarps) s_warp[lane] = v - own;
    const unsigned long long base =
        scan_lookback(state + kStateHead, tile, aggregate);
    if (lane == 0) {
      *s_base = base;
      if (tile == last_tile) {
        const unsigned long long total = base + aggregate;
        const unsigned long long cap = static_cast<unsigned long long>(out_cap);
        state[0] = total < cap ? total : cap;
        state[1] = (total > cap || pairs_overflow) ? 1ull : 0ull;
      }
    }
  }
  __syncthreads();
}

// True where candidate c occurs in prefix[0..len-1]; every lane of the
// warp calls it (the prefix is read once, 32 entries at a time, and
// broadcast by shuffles).
__device__ __forceinline__ bool on_prefix(int c, const int32_t* prefix,
                                          int len) {
  const int lane = threadIdx.x & 31;
  bool dup = false;
  for (int p0 = 0; p0 < len; p0 += 32) {
    const int x = p0 + lane < len ? __ldg(prefix + p0 + lane) : 0;
    const int m = min(32, len - p0);
    for (int q = 0; q < m; ++q) dup |= (c == __shfl_sync(kFullMask, x, q));
  }
  return dup;
}

struct LevelArgs {
  const int32_t* verts;
  long long vstride;
  const long long* count;  // () int64 on the device: valid frontier rows
  int cap, L;
  const int32_t* ell;      // (rows, D) contiguous, pad = n
  int D;
  const int8_t* prune;     // (n + 1, 2) contiguous: slack, splice budget
  int n, stop_vertex, level, remaining;
  int rows_per_warp;       // 1..32 consecutive rows per warp
  int32_t* out;            // (out_cap, L), prefilled with -1
  long long out_cap;
  int32_t* nbrs;           // (cap, D)
  bool* splice_hit;        // (cap, D)
  unsigned long long* state;
};

// One 32-wide chunk of a row's candidates: whether lane's candidate is
// kept, and whether it splices (kept and the splice budget covers the
// rest). Every lane of the warp calls it.
__device__ __forceinline__ void level_candidate(const LevelArgs& a, int c,
                                                bool in_row,
                                                const int32_t* prefix,
                                                bool* keep, bool* hit) {
  const bool dup = on_prefix(c, prefix, a.level + 1);
  *keep = false;
  *hit = false;
  if (in_row && c != a.n && !dup) {
    const char2 pr = reinterpret_cast<const char2*>(a.prune)[c];
    *keep = static_cast<int>(pr.x) >= a.level + 1;
    *hit = *keep && static_cast<int>(pr.y) >= a.remaining;
  }
}

// One frontier row of a warp: its last vertex (ELL row 0 past count)
// and whether it expands at all.
struct LevelRow {
  long long r;
  int last;
  bool expand;
};

__device__ __forceinline__ LevelRow level_row(const LevelArgs& a,
                                              long long r,
                                              long long valid_rows) {
  LevelRow row;
  row.r = r;
  const bool valid = r < valid_rows;
  row.last = valid ? __ldg(a.verts + r * a.vstride + a.level) : 0;
  row.expand = valid && row.last != a.stop_vertex;
  return row;
}

__global__ void __launch_bounds__(kFusedThreads)
expand_level_kernel(LevelArgs a) {
  __shared__ long long s_tile;
  __shared__ unsigned long long s_warp[kFusedWarps];
  __shared__ unsigned long long s_base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = take_tile(a.state, &s_tile);
  const long long tile_rows = static_cast<long long>(kFusedWarps) *
                              a.rows_per_warp;
  const long long first = tile * tile_rows +
                          static_cast<long long>(warp) * a.rows_per_warp;
  const long long valid_rows = min(*a.count, static_cast<long long>(a.cap));
  // the tile of the last valid row writes the totals; tiles past it hold
  // only rows past count (ELL row 0, no survivor) and take no part in
  // the scan
  const long long last_tile = valid_rows > 0 ? (valid_rows - 1) / tile_rows
                                             : 0;

  // pass 1: nbrs and splice_hit of every row, the warp's survivors, and
  // which of its rows have any (bit j: row first + j)
  unsigned long long survivors = 0;
  unsigned has = 0;
  for (int j = 0; j < a.rows_per_warp; ++j) {
    const LevelRow row = level_row(a, first + j, valid_rows);
    if (row.r >= a.cap) break;
    const int32_t* ell_row = a.ell + static_cast<long long>(row.last) * a.D;
    const int32_t* prefix = a.verts + row.r * a.vstride;
    unsigned row_survivors = 0;
    for (int d0 = 0; d0 < a.D; d0 += 32) {
      const int d = d0 + lane;
      const int c = d < a.D ? __ldg(ell_row + d) : a.n;
      bool keep = false, hit = false;
      if (row.expand) level_candidate(a, c, d < a.D, prefix, &keep, &hit);
      if (d < a.D) {
        a.nbrs[row.r * a.D + d] = c;
        a.splice_hit[row.r * a.D + d] = hit;
      }
      row_survivors += __popc(__ballot_sync(kFullMask, keep && !hit));
    }
    survivors += row_survivors;
    if (row_survivors) has |= 1u << j;
  }
  if (tile > last_tile) return;
  block_scan(survivors, a.state, tile, last_tile, a.out_cap, false, s_warp,
             &s_base);

  // pass 2: the survivors' rows at their places, recomputed chunk by chunk
  unsigned long long slot = s_base + s_warp[warp];
  const unsigned lower = (1u << lane) - 1u;
  while (has) {
    const int j = __ffs(has) - 1;
    has &= has - 1;
    const LevelRow row = level_row(a, first + j, valid_rows);
    const int32_t* ell_row = a.ell + static_cast<long long>(row.last) * a.D;
    const int32_t* prefix = a.verts + row.r * a.vstride;
    for (int d0 = 0; d0 < a.D; d0 += 32) {
      const int d = d0 + lane;
      const int c = d < a.D ? __ldg(ell_row + d) : a.n;
      bool keep, hit;
      level_candidate(a, c, d < a.D, prefix, &keep, &hit);
      const bool mine = keep && !hit;
      const unsigned ballot = __ballot_sync(kFullMask, mine);
      const unsigned long long k = slot + __popc(ballot & lower);
      if (mine && k < static_cast<unsigned long long>(a.out_cap)) {
        int32_t* o = a.out + static_cast<long long>(k) * a.L;
        for (int col = 0; col < a.L; ++col)
          o[col] = col == a.level + 1 ? c : __ldg(prefix + col);
      }
      slot += __popc(ballot);
    }
  }
}

enum JoinKind { kKeyedJoin = 0, kKeyedCount = 1, kSpliceJoin = 2 };

struct JoinArgs {
  const int32_t* a;        // keyed: sorted A rows; splice: prefix rows
  long long astride, a_rows;
  const int32_t* b;        // keyed: B rows; splice: child rows
  long long bstride, b_rows;
  const long long* lo;     // keyed: (b_rows,) first A row of each bucket
  const long long* offs;   // keyed: (b_rows,) inclusive pair offsets
  const long long* p_count;  // splice: () int64
  const long long* c_count;  // splice: () int64
  int a_len, b_len;        // columns of each half: a_col + 1, b_col + 1
  int32_t* out;            // (out_cap, width), prefilled with -1
  int width;
  long long out_cap;
  unsigned long long* state;
};

template <int kKind>
__global__ void __launch_bounds__(kFusedThreads) join_kernel(JoinArgs a) {
  __shared__ long long s_tile;
  __shared__ unsigned long long s_warp[kFusedWarps];
  __shared__ unsigned long long s_base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile =
      kKind == kKeyedCount ? blockIdx.x : take_tile(a.state, &s_tile);
  const long long i = tile * kFusedThreads + threadIdx.x;

  long long total;
  if (kKind == kSpliceJoin) {
    total = *a.p_count * *a.c_count;
  } else {
    total = a.b_rows > 0 ? __ldg(a.offs + a.b_rows - 1) : 0;
  }
  const long long limit = min(total, a.out_cap);
  const bool valid = i < limit;

  const int32_t* ra = a.a;
  const int32_t* rb = a.b;
  bool ok = false;
  if (valid) {
    long long ia, ib;
    if (kKind == kSpliceJoin) {
      const long long pc = *a.p_count, cc = *a.c_count;
      const long long denom = max(cc, 1LL);
      ia = min(i / denom, max(pc - 1, 0LL));
      ib = min(i % denom, max(cc - 1, 0LL));
    } else {
      // the bucket of pair i: the first b with offs[b] > i
      long long lo = 0, hi = a.b_rows;
      while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (__ldg(a.offs + mid) > i) hi = mid; else lo = mid + 1;
      }
      ib = min(lo, a.b_rows - 1);
      const long long prev = ib > 0 ? __ldg(a.offs + ib - 1) : 0;
      ia = __ldg(a.lo + ib) + (i - prev);
      ia = min(max(ia, 0LL), a.a_rows - 1);
    }
    ra = a.a + ia * a.astride;
    rb = a.b + ib * a.bstride;
    int shared = 0;
    for (int p = 0; p < a.a_len; ++p) {
      const int x = __ldg(ra + p);
      if (x < 0) continue;
      for (int q = 0; q < a.b_len; ++q) shared += (__ldg(rb + q) == x);
    }
    ok = kKind == kSpliceJoin ? shared == 0 : shared == 1;
  }
  const unsigned ballot = __ballot_sync(kFullMask, ok);

  if (kKind == kKeyedCount) {
    if (lane == 0 && ballot)
      atomicAdd(a.state, static_cast<unsigned long long>(__popc(ballot)));
    if (blockIdx.x == 0 && threadIdx.x == 0)
      a.state[1] = total > a.out_cap ? 1ull : 0ull;
    return;
  }
  // the tile of the last pair id below limit writes the totals; tiles past
  // it hold no valid pair and take no part in the scan
  const long long last_tile = limit > 0 ? (limit - 1) / kFusedThreads : 0;
  if (tile > last_tile) return;
  block_scan(__popc(ballot), a.state, tile, last_tile, a.out_cap,
             total > a.out_cap, s_warp, &s_base);
  if (!ok) return;
  const unsigned lower = (1u << lane) - 1u;
  const long long j = static_cast<long long>(s_base + s_warp[warp]) +
                      __popc(ballot & lower);
  int32_t* o = a.out + j * a.width;
  for (int p = 0; p < a.a_len; ++p) o[p] = __ldg(ra + p);
  if (kKind == kSpliceJoin) {
    for (int q = 0; q < a.b_len; ++q) o[a.a_len + q] = __ldg(rb + q);
  } else {
    // B's key vertex folded away, the rest reversed
    for (int q = 0; q + 1 < a.b_len; ++q)
      o[a.a_len + q] = __ldg(rb + a.b_len - 2 - q);
  }
}

inline long long tiles_for(long long work, int per_tile) {
  const long long t = (work + per_tile - 1) / per_tile;
  return t > 0 ? t : 1;
}

}  // namespace

// buf: one allocation of buf_bytes, the state (state_words int64) then the
// output rows (out_cap, L) int32. verts (cap, L) rows vstride apart; count
// () int64; ell (rows, D) and prune (n + 1, 2) int8 contiguous; nbrs
// (cap, D) int32 and splice_hit (cap, D) bool contiguous; each warp takes
// rows_per_warp consecutive rows (1..32).
REPRO_EXPORT int expand_level_launch(
    const void* verts, long long vstride, const void* count, int cap, int L,
    const void* ell, int D, const void* prune, int n, int stop_vertex,
    int level, int remaining, int rows_per_warp, void* buf,
    long long buf_bytes, long long state_words, long long out_cap,
    void* nbrs, void* splice_hit, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(buf, 0xFF, buf_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  LevelArgs a;
  a.verts = static_cast<const int32_t*>(verts);
  a.vstride = vstride;
  a.count = static_cast<const long long*>(count);
  a.cap = cap;
  a.L = L;
  a.ell = static_cast<const int32_t*>(ell);
  a.D = D;
  a.prune = static_cast<const int8_t*>(prune);
  a.n = n;
  a.stop_vertex = stop_vertex;
  a.level = level;
  a.remaining = remaining;
  a.rows_per_warp = rows_per_warp;
  a.state = static_cast<unsigned long long*>(buf);
  a.out = reinterpret_cast<int32_t*>(a.state + state_words);
  a.out_cap = out_cap;
  a.nbrs = static_cast<int32_t*>(nbrs);
  a.splice_hit = static_cast<bool*>(splice_hit);
  if (rows_per_warp < 1 || rows_per_warp > 32) return cudaErrorInvalidValue;
  const long long tiles = tiles_for(cap, kFusedWarps * rows_per_warp);
  if (kStateHead + tiles > state_words) return cudaErrorInvalidValue;
  expand_level_kernel<<<static_cast<unsigned int>(tiles), kFusedThreads, 0,
                        s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 keyed join, 1 counting keyed join, 2 splice join. buf as above
// (the counting join: the state only). a (a_rows, >= a_len) and b
// (b_rows, >= b_len) rows astride / bstride apart; keyed: lo and offs
// (b_rows,) int64; splice: p_count and c_count () int64; out (out_cap,
// width) after the state.
REPRO_EXPORT int join_launch(int kind, const void* a, long long astride,
                             long long a_rows, const void* b,
                             long long bstride, long long b_rows,
                             const void* lo, const void* offs,
                             const void* p_count, const void* c_count,
                             int a_len, int b_len, int width,
                             long long out_cap, void* buf,
                             long long buf_bytes, long long state_words,
                             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(buf, kind == kKeyedCount ? 0 : 0xFF,
                                    buf_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  JoinArgs j;
  j.a = static_cast<const int32_t*>(a);
  j.astride = astride;
  j.a_rows = a_rows;
  j.b = static_cast<const int32_t*>(b);
  j.bstride = bstride;
  j.b_rows = b_rows;
  j.lo = static_cast<const long long*>(lo);
  j.offs = static_cast<const long long*>(offs);
  j.p_count = static_cast<const long long*>(p_count);
  j.c_count = static_cast<const long long*>(c_count);
  j.a_len = a_len;
  j.b_len = b_len;
  j.width = width;
  j.out_cap = out_cap;
  j.state = static_cast<unsigned long long*>(buf);
  j.out = reinterpret_cast<int32_t*>(j.state + state_words);
  const long long tiles = tiles_for(out_cap, kFusedThreads);
  if (kStateHead + tiles > state_words) return cudaErrorInvalidValue;
  const unsigned int grid = static_cast<unsigned int>(tiles);
  switch (kind) {
    case kKeyedJoin:
      join_kernel<kKeyedJoin><<<grid, kFusedThreads, 0, s>>>(j);
      break;
    case kKeyedCount:
      join_kernel<kKeyedCount><<<grid, kFusedThreads, 0, s>>>(j);
      break;
    case kSpliceJoin:
      join_kernel<kSpliceJoin><<<grid, kFusedThreads, 0, s>>>(j);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
