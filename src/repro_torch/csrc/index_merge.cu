// index_merge: one batch of deletes + inserts merged into P sorted index
// segments, in one launch, the insert sort included.
//
// Replaces: src/repro/kernels/index_merge/kernel.py, _index_merge_kernel
// (:63, with _first_true :44) and its wrapper index_merge_pallas (:139),
// together with the stable per-segment insert argsort that the JAX wrapper
// hoists out of the kernel (kernels/index_merge/ops.py there).  The
// semantic source of truth is kernels/index_merge/ref.py
// segment_merge_ref, which kernels/index_merge/ref.py of this package
// ports as the plain version.
//
// Per segment: delete-compact (lower bound + hit test per delete, a hole
// flag per hit slot -- two deletes of one key make one hole -- and the
// exclusive prefix hb[p] = holes strictly below slot p), the live inserts
// (key != SENTINEL) compacted in column order and sorted by (key, column),
// which is the reference's stable argsort, insert ranks (upper bound, so
// existing keys stay first on ties, less the holes below), then for every
// destination slot o the source found by two binary searches: j_excl =
// #live inserts placed below o, and the first slot p whose live rank
// p - hb[p] exceeds r = o - j_excl.  Free slots are canonical
// (SENTINEL, 0, 0); overflow = max(n_live + n_ins - cap, 0).  TID words
// are int64 holding the uint32 value.
//
// What bounds it on the H100: not bytes (3 x cap words in and out per
// segment, 0.5 MB in all at the main path's shapes) nor operations, but
// the latency of each block's chain of phases, each a round of loads and
// binary searches of ~12 dependent steps, and before this design the
// host-side argsort and gathers (four more launches a call).
//
// What the design does about it.
// - Grid (P, tiles of TILE = 512 destination slots), as the Pallas grid
//   (P, capP // block_slots) tiles them: at cap 2,880 that is 6 tiles a
//   segment, 96 blocks of 512 threads for P = 16 where one block a segment
//   ran 16.  Every block of a segment recomputes the segment-wide part
//   (hole prefix, sorted inserts, insert positions), as each Pallas tile
//   does: one launch, no scratch shared between blocks, and the blocks of
//   a segment run that part side by side rather than one after another.
//   In trial runs on the H100, 256-slot tiles (twice the blocks, half the
//   threads each) were slower wherever a segment had many live inserts.
// - The segment's keys, deletes and inserts come to shared memory by
//   cp.async, every copy of a block in flight at once (a plain copy loop
//   waited one round trip to L2 after another), so the binary searches
//   and the compactions cost shared-memory latency, not L2's.
// - The live deletes and the live inserts are compacted first (warp
//   ballots), so the binary searches of a few live ops among thousands of
//   SENTINEL columns take one round, not one a column stride.
// - The insert sort runs in the block, on (key, column) packed in 64
//   bits, so ties keep their column order: up to 1,024 live inserts each
//   thread ranks its entries against all of them (every thread reads the
//   same word at once, a broadcast; one barrier), beyond that a bitonic
//   sort.  Payloads are read by column at the end: no gather before the
//   launch.  The SENTINEL columns never enter the sort.
// - Everything a phase hands to the next lives in shared memory:
//   2 cap + 1 + 2 Kd + 3 Ki int32 and pow2(Ki) uint64, 117 KB at cap 2,880
//   and Kd = Ki = 3,072 (one block an SM, which 96 blocks need).  Where
//   that does not fit, the wrapper passes a global scratch buffer with
//   one such area a block and the same kernel works there (reading keys,
//   deletes and inserts where they lie).
#include <cuda_runtime.h>
#include <stdint.h>

#define SENT 0x7FFFFFFF
#define FULL_MASK 0xffffffffu

namespace {

constexpr int THREADS = 512;
constexpr int TILE = THREADS;   // destination slots a block
constexpr int WARPS = THREADS / 32;
constexpr int RANK_MAX = 1024;  // live inserts sorted by rank, not bitonic

// first m in [0, n] with a[m] >= x (n if none)
__device__ __forceinline__ int first_ge(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] >= x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// first m in [0, n] with a[m] > x (n if none)
__device__ __forceinline__ int first_gt(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// exclusive prefix sum of v over the block
__device__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < WARPS ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    if (lane < WARPS) wsum[lane] = w;
  }
  __syncthreads();
  return (warp > 0 ? wsum[warp - 1] : 0) + x - v;
}

// (key, column) packed so that unsigned order is (signed key, column)
__device__ __forceinline__ unsigned long long pack(int key, int col) {
  return ((unsigned long long)((unsigned)key ^ 0x80000000u) << 32) |
         (unsigned)col;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int s = 1;
  while (s < n) s <<= 1;
  return s;
}

// int32 words of one block's work area: the packed live inserts (2 words
// each over the next power of two above Ki, 8-byte aligned), keys, hole
// prefix, insert positions, sorted insert columns, staged delete and
// insert keys, compacted live deletes; a multiple of 4 so that every area
// of a global scratch buffer starts 16-byte aligned
__host__ __device__ inline long long area_words(int cap, int Kd, int Ki) {
  const long long w =
      2LL * pow2_at_least(Ki) + cap + (cap + 1) + 2LL * Ki + 2LL * Kd + Ki;
  return (w + 3) & ~3LL;
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__global__ void __launch_bounds__(THREADS) index_merge_kernel(
    const int* __restrict__ key, const int* __restrict__ prow,
    const long long* __restrict__ tid, const int* __restrict__ dk,
    const int* __restrict__ ik, const int* __restrict__ ip,
    const long long* __restrict__ it, int cap, int Kd, int Ki, int* k2,
    int* p2, long long* t2, int* ov, int* gscratch) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int wsum[32];
  __shared__ int wcnt[2][WARPS];
  __shared__ int s_nseg;
  const int p = blockIdx.x, tile = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long so = (long long)p * cap;
  const int* seg_k = key + so;
  dk += (long long)p * Kd;
  ik += (long long)p * Ki;
  ip += (long long)p * Ki;
  it += (long long)p * Ki;
  const int SP = pow2_at_least(Ki);
  int* area = gscratch
      ? gscratch + ((long long)p * gridDim.y + tile) * area_words(cap, Kd, Ki)
      : smem;
  unsigned long long* srt = reinterpret_cast<unsigned long long*>(area);
  int* sk = area + 2 * SP;
  int* hb = sk + cap;
  int* ipos = hb + cap + 1;
  int* scol = ipos + Ki;         // column of the j-th insert in key order
  int* sdk = scol + Ki;
  int* sik = sdk + Kd;
  int* sdl = sik + Ki;           // live delete keys, compacted
  // read by phases 1-6: shared copies, or the inputs where they lie
  const int* keys = gscratch ? seg_k : sk;
  const int* dks = gscratch ? dk : sdk;
  const int* iks = gscratch ? ik : sik;

  // -- 1. keys, deletes and inserts to shared memory (cp.async: every
  // copy in flight at once), hole flags cleared
  if (!gscratch) {
    for (int i = t; i < cap; i += THREADS) cp_async4(sk + i, seg_k + i);
    for (int i = t; i < Kd; i += THREADS) cp_async4(sdk + i, dk + i);
    for (int i = t; i < Ki; i += THREADS) cp_async4(sik + i, ik + i);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int i = t; i <= cap; i += THREADS) hb[i] = 0;
  if (!gscratch) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // -- 2. live inserts (packed with their column) and live deletes
  // compacted in column order: warp w covers one run of each batch,
  // counts its live entries by ballots, then writes them after the
  // runs of the warps before it
  const int ri = ((Ki + THREADS - 1) / THREADS) * 32;
  const int rd = ((Kd + THREADS - 1) / THREADS) * 32;
  const int i0 = warp * ri, i1 = min(i0 + ri, Ki);
  const int d0 = warp * rd, d1 = min(d0 + rd, Kd);
  int ci = 0, cd = 0;
  for (int c = i0 + lane; c - lane < i1; c += 32)
    ci += __popc(__ballot_sync(FULL_MASK, c < i1 && iks[c] != SENT));
  for (int c = d0 + lane; c - lane < d1; c += 32)
    cd += __popc(__ballot_sync(FULL_MASK, c < d1 && dks[c] != SENT));
  if (lane == 0) {
    wcnt[0][warp] = ci;
    wcnt[1][warp] = cd;
  }
  if (t == 0) s_nseg = first_ge(keys, cap, SENT);   // keys before the tail
  __syncthreads();
  int oi = 0, od = 0, n_ilive = 0, n_dlive = 0;
  for (int w = 0; w < WARPS; ++w) {
    oi += w < warp ? wcnt[0][w] : 0;
    od += w < warp ? wcnt[1][w] : 0;
    n_ilive += wcnt[0][w];
    n_dlive += wcnt[1][w];
  }
  const unsigned below = (1u << lane) - 1;
  for (int c = i0 + lane; c - lane < i1; c += 32) {
    const int x = c < i1 ? iks[c] : SENT;
    const unsigned b = __ballot_sync(FULL_MASK, x != SENT);
    if (x != SENT) srt[oi + __popc(b & below)] = pack(x, c);
    oi += __popc(b);
  }
  for (int c = d0 + lane; c - lane < d1; c += 32) {
    const int x = c < d1 ? dks[c] : SENT;
    const unsigned b = __ballot_sync(FULL_MASK, x != SENT);
    if (x != SENT) sdl[od + __popc(b & below)] = x;
    od += __popc(b);
  }
  // the bitonic sort (more than RANK_MAX live inserts) pads to a power
  // of two with entries above every live one
  const int n_sort = n_ilive > RANK_MAX ? pow2_at_least(n_ilive) : 0;
  for (int i = n_ilive + t; i < n_sort; i += THREADS) srt[i] = ~0ULL;
  __syncthreads();

  // -- 3. delete pass: hole flags (a plain store dedups double deletes)
  for (int d = t; d < n_dlive; d += THREADS) {
    const int x = sdl[d];
    const int posc = min(first_ge(keys, cap, x), cap - 1);
    if (keys[posc] == x) hb[posc] = 1;
  }
  // -- 4. the live inserts in (key, column) order, which is the
  // reference's stable argsort.  Up to RANK_MAX of them: each one's rank
  // is the count of entries below it (all distinct: the column is in the
  // word), read by the whole block at once.  Beyond: bitonic sort.
  if (n_sort == 0) {
    for (int i = t; i < n_ilive; i += THREADS) {
      const unsigned long long v = srt[i];
      int rank = 0;
      for (int j = 0; j < n_ilive; ++j) rank += srt[j] < v;
      scol[rank] = (int)(unsigned)(v & 0xffffffffu);
    }
  } else {
    for (int k = 2; k <= n_sort; k <<= 1)
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = t; i < n_sort; i += THREADS) {
          const int l = i ^ j;
          if (l > i) {
            const unsigned long long a = srt[i], b = srt[l];
            if ((a > b) == ((i & k) == 0)) {
              srt[i] = b;
              srt[l] = a;
            }
          }
        }
        __syncthreads();
      }
    for (int i = t; i < n_ilive; i += THREADS)
      scol[i] = (int)(unsigned)(srt[i] & 0xffffffffu);
  }
  __syncthreads();

  // -- 5. hb[p] = holes strictly below slot p, hb[cap] = n_dead
  const int per = (cap + THREADS - 1) / THREADS;
  const int begin = min(t * per, cap), end = min(begin + per, cap);
  int s = 0;
  for (int i = begin; i < end; ++i) s += hb[i];
  int acc = block_exclusive_scan(s, wsum);
  for (int i = begin; i < end; ++i) {
    const int h = hb[i];
    hb[i] = acc;
    acc += h;
  }
  if (t == THREADS - 1) hb[cap] = acc;
  __syncthreads();
  const int n_live = s_nseg - hb[cap];
  const int n_merged = n_live + n_ilive;

  // -- 6. insert ranks: side="right" keeps existing keys first on ties
  for (int j = t; j < n_ilive; j += THREADS) {
    const int ss = first_gt(keys, cap, iks[scol[j]]);
    ipos[j] = min(j + ss - hb[ss], cap);
  }
  __syncthreads();

  // -- 7. this tile's destination slots, one a thread
  const int o = tile * TILE + t;
  if (o < cap) {
    const int j_excl = first_ge(ipos, n_ilive, o);  // #incoming below o
    const bool is_inc = j_excl < n_ilive && ipos[j_excl] == o;
    const int r = o - j_excl;                       // live-existing rank
    int lo = 0, hi = cap;                           // first p: p - hb[p] > r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mid - hb[mid] > r) hi = mid; else lo = mid + 1;
    }
    const int i_src = min(max(r + hb[lo], 0), cap - 1);
    const int col = is_inc ? scol[j_excl] : 0;
    const int kk = o < n_merged ? (is_inc ? iks[col] : keys[i_src]) : SENT;
    const bool live = kk != SENT;
    k2[so + o] = kk;
    p2[so + o] = live ? (is_inc ? ip[col] : prow[so + i_src]) : 0;
    t2[so + o] = live ? (is_inc ? it[col] : tid[so + i_src]) : 0;
  }
  if (tile == 0 && t == 0) ov[p] = max(n_merged - cap, 0);
}

}  // namespace

// Bytes of one block's work area: shared memory, or, when the wrapper
// passes gscratch, one area of it.
extern "C" long long index_merge_area_bytes(int cap, int Kd, int Ki) {
  return 4 * area_words(cap, Kd, Ki);
}

// Bytes of the global scratch buffer: one area a block of the grid.
extern "C" long long index_merge_scratch_bytes(int P, int cap, int Kd,
                                               int Ki) {
  return (long long)P * ((cap + TILE - 1) / TILE) * 4 *
         area_words(cap, Kd, Ki);
}

// key/prow (P, cap) int32, tid (P, cap) int64; dk (P, Kd) int32; ik/ip
// (P, Ki) int32 and it (P, Ki) int64 in any order (SENTINEL = masked out);
// k2/p2/t2 like key/prow/tid, ov (P,) int32; Kd and Ki may be 0.
// gscratch: null, or index_merge_scratch_bytes(P, cap, Kd, Ki) bytes.
extern "C" int index_merge(const void* key, const void* prow, const void* tid,
                           const void* dk, const void* ik, const void* ip,
                           const void* it, int P, int cap, int Kd, int Ki,
                           void* k2, void* p2, void* t2, void* ov,
                           void* gscratch, void* stream) {
  if (P <= 0 || cap <= 0) return (int)cudaGetLastError();
  if (Kd < 0 || Ki < 0) return (int)cudaErrorInvalidValue;
  const size_t smem =
      gscratch ? 0 : (size_t)index_merge_area_bytes(cap, Kd, Ki);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        index_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(P, (cap + TILE - 1) / TILE);
  index_merge_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)key, (const int*)prow, (const long long*)tid,
      (const int*)dk, (const int*)ik, (const int*)ip, (const long long*)it,
      cap, Kd, Ki, (int*)k2, (int*)p2, (long long*)t2, (int*)ov,
      (int*)gscratch);
  return (int)cudaGetLastError();
}
