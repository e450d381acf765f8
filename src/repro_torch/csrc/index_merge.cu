// index_merge: one batch of deletes + inserts merged into P sorted index
// segments, in one launch.
//
// Replaces: src/repro/kernels/index_merge/kernel.py, _index_merge_kernel
// (:63, with _first_true :44) and its wrapper index_merge_pallas (:139).
// The semantic source of truth is kernels/index_merge/ref.py
// segment_merge_ref, which kernels/index_merge/ref.py of this package
// ports as the plain version.
//
// Per segment (one block): delete-compact (lower bound + hit test per
// delete, a hole flag per hit slot -- two deletes of one key make one
// hole -- and the exclusive prefix hb[p] = holes strictly below slot p),
// insert ranks (upper bound, so existing keys stay first on ties, less the
// holes below), then for every destination slot o the source found by two
// binary searches: j_excl = #live inserts placed below o, and the first
// slot p whose live rank p - hb[p] exceeds r = o - j_excl.  Free slots are
// canonical (SENTINEL, 0, 0); overflow = max(n_live + n_ins - cap, 0).
// The inserts arrive sorted (stable argsort in the wrapper, where the JAX
// wrapper hoists it).  TID words are int64 holding the uint32 value.
//
// What bounds it on the H100: with P = 16 segments there are only 16
// blocks, so the kernel is bound by the latency of each block's chain of
// phases (hole flags, scan, insert ranks, slot resolution, each a binary
// search of ~12 dependent loads) rather than by bytes (3 x cap words in
// and out per segment, 0.5 MB in all) or operations.
//
// What the design does about it: everything a phase hands to the next
// (hole flags, their prefix sum, the insert positions) stays in shared
// memory -- (cap + 1 + Ki) int32, 24 KB at the main path's cap of 2,880
// and Ki = 3,072 -- with a global scratch buffer only when that does not
// fit; 512 threads a block resolve the slots of a segment in ~6 strides.
// Splitting a segment over several blocks, as the Pallas grid tiles
// destination slots, is left to a later change.
#include <cuda_runtime.h>
#include <stdint.h>

#define SENT 0x7FFFFFFF
#define FULL_MASK 0xffffffffu
#define THREADS 512

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

// exclusive prefix sum of v over the block (blockDim a multiple of 32)
__device__ int block_exclusive_scan(int v, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? wsum[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) wsum[lane] = w;
  }
  __syncthreads();
  return (warp > 0 ? wsum[warp - 1] : 0) + x - v;
}

__global__ void __launch_bounds__(THREADS) index_merge_kernel(
    const int* __restrict__ key, const int* __restrict__ prow,
    const long long* __restrict__ tid, const int* __restrict__ dk,
    const int* __restrict__ ik, const int* __restrict__ ip,
    const long long* __restrict__ it, int cap, int Kd, int Ki, int* k2,
    int* p2, long long* t2, int* ov, int* gscratch) {
  extern __shared__ int smem[];
  __shared__ int wsum[32];
  __shared__ int s_nseg, s_nilive;
  const int p = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  int* hb = gscratch ? gscratch + (long long)p * (cap + 1 + Ki) : smem;
  int* ipos = hb + cap + 1;
  const long long so = (long long)p * cap;
  const int* seg_k = key + so;
  dk += (long long)p * Kd;
  ik += (long long)p * Ki;
  ip += (long long)p * Ki;
  it += (long long)p * Ki;

  // -- delete pass: hole flags (a plain store dedups double deletes)
  for (int i = t; i <= cap; i += nt) hb[i] = 0;
  if (t == 0) {
    s_nseg = first_ge(seg_k, cap, SENT);       // keys before the free tail
    s_nilive = first_ge(ik, Ki, SENT);         // live inserts (sorted)
  }
  __syncthreads();
  for (int d = t; d < Kd; d += nt) {
    const int x = dk[d];
    if (x == SENT) continue;
    const int posc = min(first_ge(seg_k, cap, x), cap - 1);
    if (seg_k[posc] == x) hb[posc] = 1;
  }
  __syncthreads();
  // -- hb[p] = holes strictly below slot p, hb[cap] = n_dead
  const int chunk = (cap + nt - 1) / nt;
  const int begin = min(t * chunk, cap), end = min(begin + chunk, cap);
  int s = 0;
  for (int i = begin; i < end; ++i) s += hb[i];
  int run = block_exclusive_scan(s, wsum);
  for (int i = begin; i < end; ++i) {
    const int h = hb[i];
    hb[i] = run;
    run += h;
  }
  if (t == nt - 1) hb[cap] = run;
  __syncthreads();
  const int n_live = s_nseg - hb[cap];
  const int n_ilive = s_nilive;
  const int n_merged = n_live + n_ilive;

  // -- insert ranks: side="right" keeps existing keys first on ties
  for (int j = t; j < Ki; j += nt) {
    if (j < n_ilive) {
      const int ss = first_gt(seg_k, cap, ik[j]);
      ipos[j] = min(j + ss - hb[ss], cap);
    } else {
      ipos[j] = cap + 1;                       // dead tail past every slot
    }
  }
  __syncthreads();

  // -- destination slots
  for (int o = t; o < cap; o += nt) {
    const int j_excl = first_ge(ipos, Ki, o);  // #incoming below o
    const int jidx = min(j_excl, Ki - 1);
    const bool is_inc = j_excl < Ki && ipos[jidx] == o;
    const int r = o - j_excl;                  // live-existing rank
    int lo = 0, hi = cap;                      // first p: p - hb[p] > r
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (mid - hb[mid] > r) hi = mid; else lo = mid + 1;
    }
    const int i_src = min(max(r + hb[lo], 0), cap - 1);
    const int kk = o < n_merged ? (is_inc ? ik[jidx] : seg_k[i_src]) : SENT;
    const bool live = kk != SENT;
    k2[so + o] = kk;
    p2[so + o] = live ? (is_inc ? ip[jidx] : prow[so + i_src]) : 0;
    t2[so + o] = live ? (is_inc ? it[jidx] : tid[so + i_src]) : 0;
  }
  if (t == 0) ov[p] = max(n_merged - cap, 0);
}

extern "C" int index_merge(const void* key, const void* prow, const void* tid,
                           const void* dk, const void* ik, const void* ip,
                           const void* it, int P, int cap, int Kd, int Ki,
                           void* k2, void* p2, void* t2, void* ov,
                           void* gscratch, void* stream) {
  const size_t smem = gscratch ? 0 : (size_t)(cap + 1 + Ki) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        index_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (P > 0)
    index_merge_kernel<<<P, THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)key, (const int*)prow, (const long long*)tid,
        (const int*)dk, (const int*)ik, (const int*)ip, (const long long*)it,
        cap, Kd, Ki, (int*)k2, (int*)p2, (long long*)t2, (int*)ov,
        (int*)gscratch);
  return (int)cudaGetLastError();
}
