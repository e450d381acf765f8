// scan_window: the ordered-index probe of both STAR phases.
//
// Replaces: src/repro/kernels/occ/kernel.py, _scan_window_kernel (:65) and
// its wrapper scan_window_pallas (:103).
//
// Computes, per query i: pos[i] = the lower bound of q[i] inside its own
// sorted segment flat_key[base[i] : base[i] + cap[i]) (at most n_iters
// halvings), then an n_slots window of keys and TIDs starting there,
// clipped to the segment.  TID words are int64 holding the uint32 value.
//
// What bounds it on the H100: neither bytes nor operations.  Each query is a
// chain of ~12 dependent loads (the binary search over a segment of a few
// thousand slots) followed by n_slots independent ones; the work per query
// is tiny and the queries are few (P*K = 192 in the partitioned phase,
// B*K = 3,072 in the single-master one), so the kernel is latency-bound:
// its time is about n_iters L2 round trips.
//
// What the design does about it: one thread per query, no shared memory
// and no synchronisation, so every query's chain runs concurrently and the
// kernel ends after one chain.  The segments (3 indexes x P x cap int32,
// about 0.5 MB at P=16) stay in L2 across the whole epoch, so the chain's
// loads hit L2 rather than HBM.  Making the chain shorter (a cached top of
// the search tree in shared memory) is left to a later change.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void scan_window_kernel(const int* __restrict__ fkey,
                                   const long long* __restrict__ ftid,
                                   const int* __restrict__ q,
                                   const int* __restrict__ base,
                                   const int* __restrict__ cap, int Q,
                                   int n_slots, int n_iters, int* pos,
                                   int* keys, long long* tids) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int qi = q[i], b = base[i], c = cap[i];
  int lo = 0, hi = c;
  for (int it = 0; it < n_iters && lo < hi; ++it) {
    const int mid = (lo + hi) >> 1;  // in [lo, hi), both non-negative
    const int kmid = fkey[b + min(mid, c - 1)];
    if (kmid < qi) lo = mid + 1; else hi = mid;
  }
  pos[i] = lo;
  for (int s = 0; s < n_slots; ++s) {
    const int slot = min(max(lo + s, 0), c - 1);  // clip(window, 0, cap-1)
    keys[(long long)i * n_slots + s] = fkey[b + slot];
    tids[(long long)i * n_slots + s] = ftid[b + slot];
  }
}

extern "C" int scan_window(const void* fkey, const void* ftid, const void* q,
                           const void* base, const void* cap, int Q,
                           int n_slots, int n_iters, void* pos, void* keys,
                           void* tids, void* stream) {
  if (Q > 0) {
    const int threads = 128;
    scan_window_kernel<<<(Q + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
        (const int*)fkey, (const long long*)ftid, (const int*)q,
        (const int*)base, (const int*)cap, Q, n_slots, n_iters, (int*)pos,
        (int*)keys, (long long*)tids);
  }
  return (int)cudaGetLastError();
}
