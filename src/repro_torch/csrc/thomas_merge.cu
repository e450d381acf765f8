// thomas_merge: the replica-side apply of a value-replication stream under
// the Thomas write rule, in one cooperative launch.
//
// Replaces: src/repro/kernels/thomas_merge/kernel.py, _merge_kernel (:24)
// and its wrapper thomas_merge_pallas (:68).  Same function as
// core/replication.py thomas_apply, which the JAX engine runs here.
//
// For each destination row, the incoming write with the largest TID
// replaces the row iff that TID is greater than the row's TID; writes with
// row -1 are skipped.  Among writes of one row with the same largest TID
// the LAST in stream order wins, as the reference's sequential scatter
// does.  (The stream's ties are not always equal in value: a TPC-C
// NewOrder may decrement one stock row twice, and both post-images carry
// the transaction's TID.)  The Pallas kernel's argmax keeps the first of
// equal TIDs instead; this kernel follows the reference.  TID words are
// int64 holding the uint32 value.
//
// The stream is K writes, contiguous: row (K,), values (K, C), TID (K,).
// The single-master log (round, lane, op) is contiguous once the executor
// has stacked it, and its rows are -1 where a write did not commit, so its
// flattened view is the stream in the reference's order with no copy.
//
// Three steps in one launch, separated by grid-wide barriers
// (cooperative_groups::this_grid().sync() on a grid launched with
// cudaLaunchCooperativeKernel, sized to be co-resident):
//   clear  best[row] = 0 for each live write (best is (N,) scratch the
//          wrapper allocates uninitialised: only written rows are read)
//   pick   atomicMax(&best[row], (tid << 32) | (i + 1)): the largest TID,
//          and among equal TIDs the largest stream index
//   apply  the one write whose index is in best[row] copies its C words
//          (as 8-byte vectors where C is even and aligned) and its TID
//          into the row iff its TID exceeds the row's TID
// Each row has one writer in the apply step, so val and tid are updated in
// place without a race.  A thread takes writes first, first + step, ...
// (step = the grid's threads), the first CACHED of them read once (row and
// TID, all in flight together) and kept in registers through the three
// steps; the grid has CACHED writes a thread where the card holds that
// many threads, and a longer stream is walked again in each step.
//
// What bounds it on the H100: latency.  The bytes (the whole stream's rows
// and TIDs, then the live writes' rows) take ~1 us at 3.35 TB/s; a call
// is a launch, a pass over the stream, two grid barriers (~1.1 us each at
// a few hundred blocks: the barrier is an atomic a block on one counter,
// which is why the grid is kept small) and two rounds of scattered
// accesses to the written rows.  What the design does about it: one launch
// a call where the port spent three; the stream is read once; the table
// (175 MB at P=16) and the scratch are touched only at written rows; the
// clear and pick steps bring the row's TID and the write's values into L2
// (prefetch), and the apply step loads them with best[row] in one round.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 512
#define MAX_DEVICES 64
// the widest row the 8-byte copy holds in registers
#define VEC2_MAX_C 16
// writes a thread keeps in registers from the first step to the last
#define CACHED 2

namespace {

struct Stream {
  const int* row;            // (K,) int32, -1 = skip
  const int* val;            // (K, C) int32
  const long long* tid;      // (K,) int64 holding uint32
  long long K;
};

struct Table {
  int* val;                  // (N, C) int32
  long long* tid;            // (N,) int64
  unsigned long long* best;  // (N,) scratch
  int C;
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];" ::"l"(p));
}

// the clear step for one write: row r (-1: skipped); the row's TID word is
// brought into L2 for the apply step (nothing writes it before then)
__device__ __forceinline__ void clear(const Table& t, int r) {
  if (r < 0) return;
  t.best[r] = 0ull;
  prefetch_l2(t.tid + r);
}

// the pick step for write i of row r with TID tid, its values brought
// into L2 for the apply step
__device__ __forceinline__ void pick(const Stream& s, const Table& t, int r,
                                     long long i, long long tid) {
  if (r < 0) return;
  atomicMax(t.best + r,
            ((unsigned long long)tid << 32) | (unsigned long long)(i + 1));
  const int* v = s.val + i * t.C;
  prefetch_l2(v);
  prefetch_l2(v + t.C - 1);
}

// the apply step for write i of row r with TID tid: best[r], the row's TID
// and (in 8-byte words, up to VEC2_MAX_C values) the write's values are
// loaded together, before the test, so that the step waits on memory once
template <bool VEC2>
__device__ __forceinline__ void apply(const Stream& s, const Table& t, int r,
                                      long long i, long long tid) {
  if (r < 0) return;
  const int* src = s.val + i * t.C;
  int* dst = t.val + (long long)r * t.C;
  if (VEC2) {
    const int2* s2 = reinterpret_cast<const int2*>(src);
    int2 v[VEC2_MAX_C / 2];
#pragma unroll
    for (int k = 0; k < VEC2_MAX_C / 2; ++k)
      if (k < t.C / 2) v[k] = s2[k];
    const unsigned long long b = t.best[r];
    const long long old = t.tid[r];
    if ((b & 0xffffffffull) != (unsigned long long)(i + 1) || tid <= old)
      return;
    int2* d2 = reinterpret_cast<int2*>(dst);
#pragma unroll
    for (int k = 0; k < VEC2_MAX_C / 2; ++k)
      if (k < t.C / 2) d2[k] = v[k];
  } else {
    const unsigned long long b = t.best[r];
    const long long old = t.tid[r];
    if ((b & 0xffffffffull) != (unsigned long long)(i + 1) || tid <= old)
      return;
    for (int k = 0; k < t.C; ++k) dst[k] = src[k];
  }
  t.tid[r] = tid;
}

// A thread takes writes first, first + step, ... (step = the grid's
// threads).  Its first CACHED writes are read once, each write's row and
// TID loaded without waiting on another's, and kept in registers through
// the three steps; a stream longer than CACHED writes a thread (the
// launcher sizes the grid so that the path's streams are not) walks the
// rest again in each step.
template <bool VEC2>
__global__ void __launch_bounds__(THREADS)
thomas_merge_kernel(Stream s, Table t) {
  cg::grid_group grid = cg::this_grid();
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long step = (long long)gridDim.x * THREADS;
  const long long rest = first + CACHED * step;
  int row[CACHED];
  long long tid[CACHED];
#pragma unroll
  for (int j = 0; j < CACHED; ++j) {
    const long long i = first + j * step;
    row[j] = i < s.K ? s.row[i] : -1;
    tid[j] = i < s.K ? s.tid[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < CACHED; ++j) clear(t, row[j]);
  for (long long i = rest; i < s.K; i += step) clear(t, s.row[i]);
  grid.sync();
#pragma unroll
  for (int j = 0; j < CACHED; ++j)
    pick(s, t, row[j], first + j * step, tid[j]);
  for (long long i = rest; i < s.K; i += step)
    pick(s, t, s.row[i], i, s.tid[i]);
  grid.sync();
#pragma unroll
  for (int j = 0; j < CACHED; ++j)
    apply<VEC2>(s, t, row[j], first + j * step, tid[j]);
  for (long long i = rest; i < s.K; i += step)
    apply<VEC2>(s, t, s.row[i], i, s.tid[i]);
}

// Blocks of `kernel` that the card holds at once (the answer is kept per
// device and per kernel).
template <bool VEC2>
int coresident_blocks() {
  static int cached[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, thomas_merge_kernel<VEC2>, THREADS, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <bool VEC2>
int launch(Stream& s, Table& t, cudaStream_t st) {
  const int most = coresident_blocks<VEC2>();
  if (most <= 0) return (int)cudaErrorInvalidConfiguration;
  // CACHED writes a thread where the card holds that many threads: each
  // grid barrier is an atomic a block on one counter, so the fewer blocks
  // the shorter the wait
  const long long need = (s.K + CACHED * THREADS - 1) / (CACHED * THREADS);
  const int grid = need < most ? (int)need : most;
  void* params[] = {&s, &t};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)thomas_merge_kernel<VEC2>, dim3(grid), dim3(THREADS),
      params, 0, st);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

// val (N, C) int32 and tid (N,) int64, contiguous, updated in place; best
// (N,) int64 scratch; the stream's row (K,) int32, wval (K, C) int32 and
// wtid (K,) int64, contiguous.  K = 0 launches nothing; K must fit in 32
// bits (the packed stream index i + 1).
extern "C" int thomas_merge(void* val, void* tid, void* best,
                            const void* row, const void* wval,
                            const void* wtid, long long K, int C,
                            void* stream) {
  if (K <= 0) return (int)cudaGetLastError();
  if (K > 0xffffffffll || C <= 0) return (int)cudaErrorInvalidValue;
  Stream s;
  s.row = (const int*)row;
  s.val = (const int*)wval;
  s.tid = (const long long*)wtid;
  s.K = K;
  Table t;
  t.val = (int*)val;
  t.tid = (long long*)tid;
  t.best = (unsigned long long*)best;
  t.C = C;
  // 8-byte copies: an even C, every write's words and every table row on
  // an 8-byte boundary
  const bool vec2 = C % 2 == 0 && C <= VEC2_MAX_C &&
                    (uintptr_t)wval % 8 == 0 && (uintptr_t)val % 8 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return vec2 ? launch<true>(s, t, st) : launch<false>(s, t, st);
}
