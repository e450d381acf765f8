// occ_round: one single-master Silo-OCC round (or one Calvin round) over the
// flat row + index-slot lock space, in one cooperative launch.
//
// Replaces: src/repro/kernels/occ/kernel.py, occ_round_pallas (:321) with
// its three Pallas kernels _lock_build_kernel (:152), _validate_kernel
// (:190) and _install_kernel (:273), and the claim streams the port built
// on the host around them (a torch.where + torch.cat per stream).
//
// The lock arrays are the caller's: lock (NT+1,) int32 and, for Calvin,
// rlock (NT+1,), every entry the sentinel lane B on entry to a round.  The
// round claims, reads and then releases exactly the entries it claimed, so
// every entry is B again on exit and nothing refills the 18 MB lock space
// (NT + 1 = 4.5 M entries at P=16) each round: the bytes a round moves
// scale with its claims (~20 k), not with the lock space.
//
// Three phases in one launch, separated by grid-wide barriers
// (cooperative_groups::this_grid().sync() on a grid launched with
// cudaLaunchCooperativeKernel, sized to be co-resident):
//   1. claim     a thread per claim, grid-strided, reads the claim streams
//                in place: rows where wmask (and, for Calvin, where amask,
//                into rlock), the index claim_addr where has_claim, and
//                (Calvin) scan_addr where scan_valid and the lane is
//                active; atomicMin(&lock[addr], lane).  min commutes, so
//                the result does not depend on the order the atomics land.
//   2. validate  a block per lane (transaction), grid-strided: a thread
//                per item of the lane (its M ops, K index claims and K*L
//                scan slots) loads the item's words, then the lock, TID
//                and row words they address, applies the op (apply_col
//                mirrors core/ops.py), and checks lock ownership and Silo
//                read validation (or Calvin's all-locks-held rule);
//                __syncthreads_and and a max reduction give the lane's
//                commit and observed TID, and thread 0 writes commit and
//                next_tid.
//   3. install   the same block: a winner's ops copy their C words and
//                TID into their rows.  Winner rows are unique across lanes
//                (one lock holder per row); within a lane the last op
//                writing a row stores (TPC-C NewOrder may decrement one
//                stock row twice).  Meanwhile every thread resets the lock
//                entries its claims of phase 1 touched back to B.
// Barrier 1 orders every claim before any lock read; barrier 2 orders
// every lock read and every read of val/tid before any install or release.
//
// TID words are int64 holding the uint32 value.  The arithmetic of
// apply_op is done in uint32 and cast back: signed overflow is undefined
// in C++, while the reference wraps.
//
// What bounds it on the H100: latency.  The validate phase gathers B*M
// rows of C int32 words at random addresses of a table of N rows (4.4 M
// rows, 175 MB at P=16), scattered 40-byte loads whose cost is round trips
// to HBM, not bytes; the claims, installs and releases are a few tens of
// thousands of scattered atomics and stores; each barrier is a round of
// atomics across the grid.  What the design does about it: one launch a
// round where the port spent four, no pass over the lock space, and a
// thread per item, so that each phase is one or two dependent round trips
// (a warp per lane, whose threads walk the items in turn, chains two for
// every item a thread holds).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define THREADS 256      // a block a lane: a thread per op, claim, scan slot
#define COLS 16          // an op's columns held in registers at once
#define MAX_DEVICES 64

#define FULL_MASK 0xffffffffu

enum { READ = 0, SET = 1, ADD = 2, APPEND = 3, STOCK_DECR = 4, PAY_CUST = 5,
       SCAN_CONSUME = 7 };
#define APPEND_CAP 500

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int hash_combine(int h, int x) {
  return (int)(((uint32_t)h * 1000003u + (uint32_t)x) & 0x7FFFFFFFu);
}

// Column c of apply_op(kind, old, delta) (core/ops.py:42): it reads only
// old[c], delta[c] and delta[0].
__device__ __forceinline__ int apply_col(int kind, int c, int o, int d,
                                         int d0) {
  switch (kind) {
    case SET: return d;
    case ADD: return wadd(o, d);
    case APPEND:
    case PAY_CUST:
      if (c == 0) return hash_combine(o, d);
      if (c == 1) return min(wadd(o, d), APPEND_CAP);
      return kind == PAY_CUST ? wadd(o, d) : o;
    case STOCK_DECR:
      if (c == 0) {
        const int q = wsub(o, d);
        return q >= 10 ? q : wadd(q, 91);
      }
      if (c == 1) return wadd(o, d0);
      if (c == 2) return wadd(o, 1);
      if (c == 3) return wadd(o, d);
      return o;
    case SCAN_CONSUME: return 0;
    default: return o;
  }
}

// new = apply_op(kind, old, delta) for one op of C words, COLS columns at
// a time: every load of a tile is issued before its first store, so a
// row's words arrive in one memory round trip.
__device__ __forceinline__ void apply_op_row(int kind,
                                             const int* __restrict__ old,
                                             const int* __restrict__ dl,
                                             int* __restrict__ out, int C) {
  const int d0 = dl[0];
  for (int cb = 0; cb < C; cb += COLS) {
    int o[COLS], d[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (cb + j < C) {
        o[j] = old[cb + j];
        d[j] = dl[cb + j];
      }
#pragma unroll
    for (int j = 0; j < COLS; ++j)
      if (cb + j < C) out[cb + j] = apply_col(kind, cb + j, o[j], d[j], d0);
  }
}

// core/tid.py next_tid: seq = max(seq_in_epoch(obs), seq_in_epoch(last))+1
__device__ __forceinline__ uint32_t next_tid(uint32_t epoch, uint32_t obs,
                                             uint32_t last) {
  const uint32_t o = obs & ~1u, l = last & ~1u;
  const uint32_t so = ((o >> 24) & 255u) == epoch ? (o >> 1) & 0x7FFFFFu : 0u;
  const uint32_t sl = ((l >> 24) & 255u) == epoch ? (l >> 1) & 0x7FFFFFu : 0u;
  const uint32_t seq = (so > sl ? so : sl) + 1u;
  return (epoch << 24) | (seq << 1);
}


struct RoundArgs {
  int* val;               // (N, C), updated in place
  long long* tid;         // (N,), updated in place
  const int* rows;        // (B, M)
  const int* kind;
  const int* delta;       // (B, M, C)
  const uint8_t* wmask;   // (B, M)
  const uint8_t* amask;
  const uint8_t* active;  // (B,)
  const long long* last_tid;
  const int* claim_addr;  // index args (B, K), (B, K, L), or null
  const long long* claim_tid;
  const int* scan_addr;
  const long long* scan_tid;
  const uint8_t* scan_valid;
  const uint8_t* has_claim;
  int* lock;              // (NT+1,), all B on entry and on exit
  int* rlock;             // Calvin read locks (NT+1,), or null (Silo)
  uint8_t* commit;        // (B,)
  long long* new_tid;     // (B,)
  int* newv;              // (B, M, C)
  uint8_t* w;             // (B, M)
  int B, M, C, K, L;
  uint32_t epoch;
};

// Phase 1 (release = false): atomicMin every claim's lane into its lock
// entry.  Phase 3 (release = true): set the same entries back to B.
__device__ void claims(const RoundArgs& a, bool release) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool calvin = a.rlock != nullptr;
  const long long BM = (long long)a.B * a.M;
  for (long long i = t0; i < BM; i += stride) {
    const int lane = (int)(i / a.M);
    const int row = a.rows[i];
    if (a.wmask[i]) {
      if (release) a.lock[row] = a.B;
      else atomicMin(&a.lock[row], lane);
    }
    if (calvin && a.amask[i]) {
      if (release) a.rlock[row] = a.B;
      else atomicMin(&a.rlock[row], lane);
    }
  }
  if (a.claim_addr == nullptr) return;
  const long long BK = (long long)a.B * a.K;
  for (long long i = t0; i < BK; i += stride) {
    if (!a.has_claim[i]) continue;
    const int lane = (int)(i / a.K);
    const int addr = a.claim_addr[i];
    if (release) a.lock[addr] = a.B;
    else atomicMin(&a.lock[addr], lane);
    if (calvin) {
      if (release) a.rlock[addr] = a.B;
      else atomicMin(&a.rlock[addr], lane);
    }
  }
  if (!calvin) return;
  const long long KL = (long long)a.K * a.L;
  for (long long i = t0; i < BK * a.L; i += stride) {
    const int lane = (int)(i / KL);
    if (!a.scan_valid[i] || !a.active[lane]) continue;
    const int addr = a.scan_addr[i];
    if (release) a.rlock[addr] = a.B;
    else atomicMin(&a.rlock[addr], lane);
  }
}

// Phase 2 for lane b, by one block.  The lane's items are its ops
// [0, M), its index claims [M, M + K) and its scan slots [M + K,
// M + K + K*L), a thread each (184 at TPC-C's M = 64, K = 12, L = 9), so a
// thread's loads take two dependent round trips: the item's own words,
// then the lock, TID and row words they address.  Unclaimed claim and
// scan slots hold no_addr, a real lock entry, so their locks are read
// without a branch and masked after.  __syncthreads_and and a max
// reduction gather the lane's verdict.
__device__ void validate(const RoundArgs& a, int b, uint32_t* s_obs) {
  const int t = threadIdx.x;
  const bool calvin = a.rlock != nullptr;
  const bool act = a.active[b];
  const int KC = a.claim_addr != nullptr ? a.K : 0;
  const int KL = KC * a.L;
  bool wins = true, read_ok = true, held = true;
  uint32_t obs = 0;
  for (int i = t; i < a.M + KC + KL; i += THREADS) {
    if (i < a.M) {
      const long long idx = (long long)b * a.M + i;
      const int row = a.rows[idx];
      const int kind = a.kind[idx];
      const bool wm = a.wmask[idx], am = a.amask[idx];
      const int holder = a.lock[row];
      const int rh = calvin ? a.rlock[row] : b;
      const uint32_t rt = (uint32_t)a.tid[row];
      apply_op_row(kind, a.val + (long long)row * a.C, a.delta + idx * a.C,
                   a.newv + idx * a.C, a.C);
      if (wm && holder != b) wins = false;
      if (am && holder < b) read_ok = false;
      if (am && rh != b) held = false;
      if (am) obs = max(obs, rt);
    } else if (i < a.M + KC) {
      const long long idx = (long long)b * a.K + (i - a.M);
      const bool hc = a.has_claim[idx];
      const int ca = a.claim_addr[idx];
      const uint32_t ct = (uint32_t)a.claim_tid[idx];
      const int lk = a.lock[ca];
      const int rk = calvin ? a.rlock[ca] : b;
      if (hc) {
        if (lk != b) wins = false;
        if (rk != b) held = false;
        obs = max(obs, ct);
      }
    } else {
      const long long idx = (long long)b * KL + (i - a.M - KC);
      const bool sv = a.scan_valid[idx];
      const int sa = a.scan_addr[idx];
      const uint32_t st = (uint32_t)a.scan_tid[idx];
      const int lk = a.lock[sa];
      const int rk = calvin ? a.rlock[sa] : b;
      if (sv) {
        if (act && lk < b) read_ok = false;
        if (act && rk != b) held = false;
        obs = max(obs, st);
      }
    }
  }
  wins = __syncthreads_and(wins);
  read_ok = __syncthreads_and(read_ok);
  held = __syncthreads_and(held);
  obs = __reduce_max_sync(FULL_MASK, obs);
  if ((t & 31) == 0) s_obs[t >> 5] = obs;
  __syncthreads();
  const bool commit = calvin ? (act && held) : (act && wins && read_ok);
  for (int m = t; m < a.M; m += THREADS) {
    const long long idx = (long long)b * a.M + m;
    a.w[idx] = (a.wmask[idx] && commit) ? 1 : 0;
  }
  if (t == 0) {
    for (int i = 1; i < THREADS / 32; ++i) obs = max(obs, s_obs[i]);
    a.commit[b] = commit ? 1 : 0;
    a.new_tid[b] = (long long)next_tid(a.epoch, obs,
                                       (uint32_t)a.last_tid[b]);
  }
  __syncthreads();  // s_obs serves the block's next lane
}

// Phase 3's install for lane b, by one block, a thread an op.  An op
// installs unless a later op of the same lane writes the same row (the
// reference's scatter is sequential, so the later one wins); the lane's
// written rows sit in shared memory for that test.
__device__ void install(const RoundArgs& a, int b, int* s_row) {
  const int t = threadIdx.x;
  const long long base = (long long)b * a.M;
  for (int m = t; m < a.M; m += THREADS)
    s_row[m] = a.w[base + m] ? a.rows[base + m] : -1;  // rows are >= 0
  __syncthreads();
  const long long tid = a.new_tid[b];
  for (int m = t; m < a.M; m += THREADS) {
    const int row = s_row[m];
    if (row < 0) continue;
    bool last = true;
    for (int j = m + 1; j < a.M; ++j) last &= s_row[j] != row;
    if (!last) continue;
    const int* src = a.newv + (base + m) * a.C;
    int* dst = a.val + (long long)row * a.C;
    for (int cb = 0; cb < a.C; cb += COLS) {
      int v[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (cb + j < a.C) v[j] = src[cb + j];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        if (cb + j < a.C) dst[cb + j] = v[j];
    }
    a.tid[row] = tid;
  }
  __syncthreads();  // s_row serves the block's next lane
}

// Dynamic shared memory: the per-warp TID maxima, then a lane's M rows.
__global__ void __launch_bounds__(THREADS)
occ_round_kernel(RoundArgs a) {
  extern __shared__ int smem[];
  uint32_t* s_obs = (uint32_t*)smem;
  int* s_row = smem + THREADS / 32;
  cg::grid_group grid = cg::this_grid();
  claims(a, false);
  grid.sync();
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) validate(a, b, s_obs);
  grid.sync();
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) install(a, b, s_row);
  claims(a, true);
}

// Blocks that the card holds at once with `smem` bytes of dynamic shared
// memory each (the last answer is kept per device).
static int coresident_blocks(size_t smem) {
  static int cached[MAX_DEVICES];
  static size_t cached_smem[MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return 0;
  if (cached[dev] == 0 || cached_smem[dev] != smem) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, occ_round_kernel, THREADS, smem) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
    cached_smem[dev] = smem;
  }
  return cached[dev];
}

extern "C" int occ_round(
    void* val, void* tid, const void* rows, const void* kind,
    const void* delta, const void* wmask, const void* amask,
    const void* active, const void* last_tid, const void* claim_addr,
    const void* claim_tid, const void* scan_addr, const void* scan_tid,
    const void* scan_valid, const void* has_claim, void* lock, void* rlock,
    void* commit, void* new_tid, void* newv, void* w, int B, int M, int C,
    int K, int L, unsigned int epoch, void* stream) {
  RoundArgs a;
  a.val = (int*)val;
  a.tid = (long long*)tid;
  a.rows = (const int*)rows;
  a.kind = (const int*)kind;
  a.delta = (const int*)delta;
  a.wmask = (const uint8_t*)wmask;
  a.amask = (const uint8_t*)amask;
  a.active = (const uint8_t*)active;
  a.last_tid = (const long long*)last_tid;
  a.claim_addr = (const int*)claim_addr;
  a.claim_tid = (const long long*)claim_tid;
  a.scan_addr = (const int*)scan_addr;
  a.scan_tid = (const long long*)scan_tid;
  a.scan_valid = (const uint8_t*)scan_valid;
  a.has_claim = (const uint8_t*)has_claim;
  a.lock = (int*)lock;
  a.rlock = (int*)rlock;
  a.commit = (uint8_t*)commit;
  a.new_tid = (long long*)new_tid;
  a.newv = (int*)newv;
  a.w = (uint8_t*)w;
  a.B = B; a.M = M; a.C = C; a.K = K; a.L = L;
  a.epoch = epoch;
  if (B <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(int) * (THREADS / 32 + (size_t)M);
  const int most = coresident_blocks(smem);
  if (most <= 0) return (int)cudaErrorInvalidConfiguration;
  // a block a lane, no more blocks than the card holds at once (the
  // phases stride over the rest); the claims stride over the grid
  const int grid = B < most ? B : most;
  void* params[] = {&a};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)occ_round_kernel, dim3(grid), dim3(THREADS), params, smem,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
