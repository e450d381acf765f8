// scan_window: the ordered-index probe of both STAR phases, in three launch
// configurations that share one warp-cooperative lower-bound search.
//
// Replaces: src/repro/kernels/occ/kernel.py, _scan_window_kernel (:65) and
// its wrapper scan_window_pallas (:103), together with the glue the JAX
// package runs around it under jit (kernels/occ/ops.py locate_index_ops
// and step_index_ops: segment selection, the concatenated index, the
// window's masks and addresses).
//
//   scan_window            bare: per query i, pos[i] = the lower bound of
//                          q[i] in flat_key[base[i] : base[i] + cap[i]),
//                          then an n_slots window of keys and TIDs from
//                          there, clipped to the segment (segment_scan).
//   probe_partitioned      one partitioned queue slot's index ops (P, K):
//                          writes consume_ok (P, K) and slot_tid (P, K),
//                          the outputs of step_index_ops.  Op (p, k)
//                          probes partition p of index delta[IX_ID].
//   probe_single_master    one OCC round's index ops (B, K): writes
//                          claim_addr, claim_tid, scan_addr / scan_tid /
//                          scan_valid (B, K, n_slots) and consume_ok, the
//                          outputs of locate_index_ops, in the flat
//                          row + index-slot address space (no_addr = the
//                          dump slot).  Op (b, k) probes partition
//                          clamp(lo >> 24, 0, P - 1) of index delta[IX_ID].
//
// The index tables are read in place: up to MAX_INDEXES (key (P, cap_i)
// int32, tid (P, cap_i) int64) pairs ride in a by-value argument struct,
// and index i's segments start at flat offset off_i = sum_{j<i} P * cap_j,
// so partition p of index i is flat slot off_i + p * cap_i (the address
// the OCC round locks).  An op whose kind or IX_ID selects no index
// searches nothing: its outputs are the masked values, as in the plain
// version, where such ops resolve against segment 0 and are masked out.
// TID words are int64 holding the uint32 value.
//
// The search: a warp per query.  While the interval [lo, hi) holds more
// than PROBE_LANES slots, lane j loads the pivot lo + (j + 1) * n / 33
// (n = hi - lo: 32 strictly increasing pivots cut it into 33 parts), and
// __popc(__ballot_sync(key < q)) counts the pivots below q; segments are
// sorted (SENTINEL-padded free slots at the end), so those pivots are a
// prefix and the count names the part that holds the lower bound.  Each
// step leaves at most ceil(n / 33) slots; once at most 32 remain, one key
// a lane and one more ballot give the answer.  Over 2,880 slots that is 3
// dependent loads (2,880 -> 88 -> 3 -> answer), not the 13 of a binary
// search; PROBE_STEPS bounds the loop for any cap below 2^31.  The result
// is searchsorted-left, as the plain version's binary search computes.
// Then lane s gathers window slot s: min(max(pos + s, 0), cap - 1), so a
// window's keys, TIDs, addresses and flags are stored by neighbouring
// lanes at neighbouring addresses.
//
// What bounds it on the H100: latency, not bytes or operations.  The work
// per query is a chain of 3 dependent L2 loads and one gather; the queries
// are few (192 in the partitioned phase, 3,072 in the single-master one),
// and the segments (3 indexes x P x cap int32 + int64, about 1.6 MB at
// P=16) stay in L2 across an epoch.  What the design does about it:
// shorter chains (k-ary, not binary), a warp's loads in flight together,
// and one launch a call that writes the caller's outputs itself, where
// the port ran ~60-94 eager PyTorch ops around the probe (a copy of the
// whole index, the per-op segment selection, the window's masks).
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define PROBE_LANES 32   // pivots a step = lanes a query
#define PROBE_PARTS 33   // PROBE_LANES pivots cut an interval into 33 parts
#define PROBE_STEPS 7    // k-ary steps before <= 32 slots remain (cap < 2^31)
#define MAX_INDEXES 8
#define WARPS_PER_BLOCK 4
#define SENTINEL 0x7FFFFFFF
#define PART_SHIFT 24

enum { IX_LO = 0, IX_HI = 1, IX_EXPECT = 2, IX_ID = 3 };
enum { SCAN_READ = 6, SCAN_CONSUME = 7 };

// First slot of key[0, cap) whose key is >= q, or cap.  key ascending.
// Called by all 32 lanes of a warp with the same arguments.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ key,
                                                int cap, int q, int lane) {
  int lo = 0, hi = cap;
#pragma unroll 1
  for (int it = 0; it < PROBE_STEPS && hi - lo > PROBE_LANES; ++it) {
    const long long n = hi - lo;
    const int p = lo + (int)((lane + 1) * n / PROBE_PARTS);
    const int c = __popc(__ballot_sync(FULL_MASK, key[p] < q));
    // pivots p_0 < ... < p_31 and p_j = lo + (j + 1) n / 33; the lower
    // bound lies in [p_{c-1} + 1, p_c]
    const int new_lo = c == 0 ? lo : lo + (int)(c * n / PROBE_PARTS) + 1;
    if (c < PROBE_LANES) hi = lo + (int)((c + 1) * n / PROBE_PARTS);
    lo = new_lo;
  }
  const bool below = lane < hi - lo && key[lo + lane] < q;
  return lo + __popc(__ballot_sync(FULL_MASK, below));
}

struct Segments {
  const int* key[MAX_INDEXES];
  const long long* tid[MAX_INDEXES];
  int cap[MAX_INDEXES];
  int off[MAX_INDEXES];   // flat offset of the index's partition 0
  int n;                  // indexes
  int P;                  // partitions (rows of every table)
};

// Index iid's table (0 <= iid < s.n), without indexing the parameter
// arrays dynamically (which would copy them to local memory).
__device__ __forceinline__ void pick(const Segments& s, int iid,
                                     const int** key, const long long** tid,
                                     int* cap, int* off) {
#pragma unroll
  for (int i = 0; i < MAX_INDEXES; ++i) {
    if (i == iid) {
      *key = s.key[i];
      *tid = s.tid[i];
      *cap = s.cap[i];
      *off = s.off[i];
    }
  }
}

struct OpsIn {
  const int* kinds;       // (rows, >= K), row stride kind_row
  const int* delta;       // (rows, >= K, >= 4), strides delta_row, delta_op
  long long kind_row, delta_row, delta_op;
  int rows, K;
};

// ---------------------------------------------------------------------------
// bare
// ---------------------------------------------------------------------------
__global__ void scan_window_kernel(const int* __restrict__ fkey,
                                   const long long* __restrict__ ftid,
                                   const int* __restrict__ q,
                                   const int* __restrict__ base,
                                   const int* __restrict__ cap, int Q,
                                   int n_slots, int* __restrict__ pos,
                                   int* __restrict__ keys,
                                   long long* __restrict__ tids) {
  const int i = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= Q) return;  // uniform across the warp
  const int c = cap[i];
  const int* key = fkey + base[i];
  const long long* tid = ftid + base[i];
  const int lb = warp_lower_bound(key, c, q[i], lane);
  if (lane == 0) pos[i] = lb;
  for (int s = lane; s < n_slots; s += 32) {
    const int slot = min(max(lb + s, 0), c - 1);
    keys[(long long)i * n_slots + s] = key[slot];
    tids[(long long)i * n_slots + s] = tid[slot];
  }
}

// ---------------------------------------------------------------------------
// partitioned: step_index_ops
// ---------------------------------------------------------------------------
__global__ void probe_partitioned_kernel(Segments s, OpsIn in,
                                         uint8_t* __restrict__ consume_ok,
                                         long long* __restrict__ slot_tid) {
  const int i = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= in.rows * in.K) return;
  const int p = i / in.K, k = i - p * in.K;
  const int kind = in.kinds[p * in.kind_row + k];
  const int* d = in.delta + p * in.delta_row + k * in.delta_op;
  const int iid = d[IX_ID];
  if (iid < 0 || iid >= s.n) {  // selects no index
    if (lane == 0) {
      consume_ok[i] = 1;
      slot_tid[i] = 0;
    }
    return;
  }
  const int* key;
  const long long* tid;
  int cap, off;
  pick(s, iid, &key, &tid, &cap, &off);
  key += (long long)p * cap;
  tid += (long long)p * cap;
  const int lb = warp_lower_bound(key, cap, d[IX_LO], lane);
  if (lane == 0) {
    const int slot = min(max(lb, 0), cap - 1);
    const int fk = key[slot];
    const bool ok = fk == d[IX_EXPECT] && fk < d[IX_HI] && fk != SENTINEL;
    consume_ok[i] = kind == SCAN_CONSUME ? ok : 1;
    slot_tid[i] = tid[slot];
  }
}

// ---------------------------------------------------------------------------
// single-master: locate_index_ops
// ---------------------------------------------------------------------------
struct SmOut {
  int* claim_addr;        // (B, K)
  long long* claim_tid;   // (B, K)
  int* scan_addr;         // (B, K, n_slots)
  long long* scan_tid;    // (B, K, n_slots)
  uint8_t* scan_valid;    // (B, K, n_slots)
  uint8_t* consume_ok;    // (B, K)
  int n_rows, no_addr, n_slots;
};

__global__ void probe_single_master_kernel(Segments s, OpsIn in, SmOut o) {
  const int i = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= in.rows * in.K) return;
  const int b = i / in.K, k = i - b * in.K;
  const int kind = in.kinds[b * in.kind_row + k];
  const int* d = in.delta + b * in.delta_row + k * in.delta_op;
  const int lo = d[IX_LO], hi = d[IX_HI], iid = d[IX_ID];
  const long long w0 = (long long)i * o.n_slots;
  if (kind < SCAN_READ || iid < 0 || iid >= s.n) {  // selects no index
    if (lane < o.n_slots) {
      o.scan_addr[w0 + lane] = o.no_addr;
      o.scan_tid[w0 + lane] = 0;
      o.scan_valid[w0 + lane] = 0;
    }
    if (lane == 0) {
      o.claim_addr[i] = o.no_addr;
      o.claim_tid[i] = 0;
      o.consume_ok[i] = 0;  // first_key = SENTINEL
    }
    return;
  }
  const int* key;
  const long long* tid;
  int cap, off;
  pick(s, iid, &key, &tid, &cap, &off);
  const int part = min(max(lo >> PART_SHIFT, 0), s.P - 1);
  key += (long long)part * cap;
  tid += (long long)part * cap;
  const int seg = o.n_rows + off + part * cap;  // flat address of slot 0
  const int lb = warp_lower_bound(key, cap, lo, lane);
  const int window = lb + lane;
  const int slot = min(max(window, 0), cap - 1);
  int ks = SENTINEL;
  long long ts = 0;
  if (lane < o.n_slots) {
    ks = key[slot];
    ts = tid[slot];
  }
  // slot s is read if it is the first, or the key before it is below hi
  // (the in-range slots plus exactly one boundary slot), inside the segment
  const int prev = __shfl_up_sync(FULL_MASK, ks, 1);
  const bool scans = kind == SCAN_READ || kind == SCAN_CONSUME;
  if (lane < o.n_slots) {
    const bool sv = scans && (lane == 0 || prev < hi) && window < cap;
    o.scan_addr[w0 + lane] = sv ? seg + slot : o.no_addr;
    o.scan_tid[w0 + lane] = sv ? ts : 0;
    o.scan_valid[w0 + lane] = sv;
  }
  if (lane == 0) {
    // insert / delete / consume claim the position slot (next-key locking)
    const bool claims = kind >= SCAN_CONSUME;
    o.claim_addr[i] = claims ? seg + slot : o.no_addr;
    o.claim_tid[i] = claims ? ts : 0;
    o.consume_ok[i] = ks == d[IX_EXPECT] && ks < hi && ks != SENTINEL;
  }
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
static int blocks_for(long long queries) {
  return (int)((queries + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
}

// keys/tids: host arrays of n device pointers; caps: host array of n ints
static int segments(const void* const* keys, const void* const* tids,
                    const int* caps, int n, int P, Segments* s) {
  if (n < 1 || n > MAX_INDEXES) return (int)cudaErrorInvalidValue;
  long long off = 0;
  for (int i = 0; i < MAX_INDEXES; ++i) {
    s->key[i] = i < n ? (const int*)keys[i] : nullptr;
    s->tid[i] = i < n ? (const long long*)tids[i] : nullptr;
    s->cap[i] = i < n ? caps[i] : 0;
    s->off[i] = (int)off;
    if (i < n) off += (long long)P * caps[i];
  }
  s->n = n;
  s->P = P;
  return 0;
}

extern "C" int scan_window(const void* fkey, const void* ftid, const void* q,
                           const void* base, const void* cap, int Q,
                           int n_slots, void* pos, void* keys, void* tids,
                           void* stream) {
  if (Q > 0)
    scan_window_kernel<<<blocks_for(Q), 32 * WARPS_PER_BLOCK, 0,
                         (cudaStream_t)stream>>>(
        (const int*)fkey, (const long long*)ftid, (const int*)q,
        (const int*)base, (const int*)cap, Q, n_slots, (int*)pos,
        (int*)keys, (long long*)tids);
  return (int)cudaGetLastError();
}

extern "C" int probe_partitioned(
    const void* const* keys, const void* const* tids, const int* caps,
    int n_idx, int P, const void* kinds, long long kind_row,
    const void* delta, long long delta_row, long long delta_op, int K,
    void* consume_ok, void* slot_tid, void* stream) {
  Segments s;
  const int err = segments(keys, tids, caps, n_idx, P, &s);
  if (err) return err;
  OpsIn in{(const int*)kinds, (const int*)delta, kind_row, delta_row,
           delta_op, P, K};
  if (P * K > 0)
    probe_partitioned_kernel<<<blocks_for((long long)P * K),
                               32 * WARPS_PER_BLOCK, 0,
                               (cudaStream_t)stream>>>(
        s, in, (uint8_t*)consume_ok, (long long*)slot_tid);
  return (int)cudaGetLastError();
}

extern "C" int probe_single_master(
    const void* const* keys, const void* const* tids, const int* caps,
    int n_idx, int P, const void* kinds, long long kind_row,
    const void* delta, long long delta_row, long long delta_op, int B,
    int K, int n_rows, int no_addr, int n_slots, void* claim_addr,
    void* claim_tid, void* scan_addr, void* scan_tid, void* scan_valid,
    void* consume_ok, void* stream) {
  Segments s;
  const int err = segments(keys, tids, caps, n_idx, P, &s);
  if (err) return err;
  if (n_slots < 1 || n_slots > 32) return (int)cudaErrorInvalidValue;
  OpsIn in{(const int*)kinds, (const int*)delta, kind_row, delta_row,
           delta_op, B, K};
  SmOut o{(int*)claim_addr, (long long*)claim_tid, (int*)scan_addr,
          (long long*)scan_tid, (uint8_t*)scan_valid, (uint8_t*)consume_ok,
          n_rows, no_addr, n_slots};
  if (B * K > 0)
    probe_single_master_kernel<<<blocks_for((long long)B * K),
                                 32 * WARPS_PER_BLOCK, 0,
                                 (cudaStream_t)stream>>>(s, in, o);
  return (int)cudaGetLastError();
}
