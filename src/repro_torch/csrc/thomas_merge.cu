// thomas_merge: the replica-side apply of a value-replication stream under
// the Thomas write rule.
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
// the transaction's TID.)  TID words are int64 holding the uint32 value.
//
// Three launches over the K writes, all on the caller's stream:
//   clear  best[row] = 0 for each written row (best is scratch the wrapper
//          allocates uninitialised: only rows that are written are read)
//   pick   atomicMax(&best[row], (wtid << 32) | (i + 1)): the largest TID,
//          and among equal TIDs the largest stream index
//   apply  the one write whose index is in best[row] copies its C words
//          and TID into the row iff its TID exceeds the row's TID
// Each row has at most one writer in the apply launch, so val and tid are
// updated in place without a race.
//
// What bounds it on the H100: bytes of the write stream (4 + 4*C + 8 per
// write, 13 MB for 262,144 writes) and the scattered row updates; no pass
// over the whole table is needed.
//
// What the design does about it: the table (175 MB at P=16) is touched
// only at written rows, and the per-row argmax is one 64-bit atomic per
// write instead of the Pallas kernel's stream of every write through every
// row tile.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void clear_kernel(unsigned long long* best,
                             const int* __restrict__ wrows, long long K) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  const int r = wrows[i];
  if (r >= 0) best[r] = 0ull;
}

__global__ void pick_kernel(unsigned long long* best,
                            const int* __restrict__ wrows,
                            const long long* __restrict__ wtids, long long K) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  const int r = wrows[i];
  if (r >= 0)
    atomicMax(&best[r], ((unsigned long long)wtids[i] << 32) |
                            (unsigned long long)(i + 1));
}

__global__ void apply_kernel(int* val, long long* tid,
                             const unsigned long long* __restrict__ best,
                             const int* __restrict__ wrows,
                             const int* __restrict__ wvals,
                             const long long* __restrict__ wtids, long long K,
                             int C) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= K) return;
  const long long r = wrows[i];
  if (r < 0 || (best[r] & 0xffffffffull) != (unsigned long long)(i + 1))
    return;
  const long long t = wtids[i];
  if (t <= tid[r]) return;
  for (int c = 0; c < C; ++c) val[r * C + c] = wvals[i * C + c];
  tid[r] = t;
}

extern "C" int thomas_merge(void* val, void* tid, void* best,
                            const void* wrows, const void* wvals,
                            const void* wtids, long long K, int C,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (K > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((K + threads - 1) / threads);
    unsigned long long* b = (unsigned long long*)best;
    clear_kernel<<<blocks, threads, 0, s>>>(b, (const int*)wrows, K);
    pick_kernel<<<blocks, threads, 0, s>>>(b, (const int*)wrows,
                                           (const long long*)wtids, K);
    apply_kernel<<<blocks, threads, 0, s>>>(
        (int*)val, (long long*)tid, b, (const int*)wrows, (const int*)wvals,
        (const long long*)wtids, K, C);
  }
  return (int)cudaGetLastError();
}
