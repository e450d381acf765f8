// occ_round: one single-master Silo-OCC round (or one Calvin round) over the
// flat row + index-slot lock space, in three launches.
//
// Replaces: src/repro/kernels/occ/kernel.py, occ_round_pallas (:321) with
// its three Pallas kernels _lock_build_kernel (:152), _validate_kernel
// (:190) and _install_kernel (:273).
//
//   occ_lock_build  fill lock[0..NT] with the sentinel lane B, then one
//                   thread per claim does atomicMin(&lock[addr], lane).
//                   min commutes, so the result does not depend on the
//                   order the atomics land in.  Calvin mode calls it a
//                   second time for the read-lock array.
//   occ_validate    one warp per lane (transaction): its threads stride
//                   over the M ops and the K claim and K*L scan slots,
//                   apply the op (apply_op below mirrors core/ops.py),
//                   check lock ownership and Silo read validation (or
//                   Calvin's all-locks-held rule) and reduce with
//                   __all_sync; the observed TID max is a shuffle
//                   reduction; lane 0 writes commit and next_tid.
//   occ_install     one thread per (lane, op): a winner copies its C words
//                   and TID into its row.  Winner rows are unique across
//                   lanes (one lock holder per row); within a lane, the
//                   last op writing a row stores (TPC-C NewOrder may
//                   decrement one stock row twice), so no stores collide.
//
// TID words are int64 holding the uint32 value.  The arithmetic of
// apply_op is done in uint32 and cast back: signed overflow is undefined
// in C++, while the reference wraps.
//
// What bounds it on the H100: the validate launch gathers B*M rows of C
// int32 words at random addresses of a table of N rows (4.4 M rows, 175 MB
// at P=16), so it is bound by scattered 40-byte loads, i.e. by HBM
// transactions rather than bytes; the lock build and the install are a
// few thousand atomics or stores and are launch-latency bound.
//
// What the design does about it: a warp per lane keeps a transaction's
// loads in flight together and needs no shared memory or block barrier;
// the lock array is NT+1 int32 (about 18 MB at P=16), written once by the
// fill and touched only at claimed addresses afterwards.
#include <cuda_runtime.h>
#include <stdint.h>

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

// new = apply_op(kind, old, delta) for one op of C words (core/ops.py:71)
__device__ void apply_op_row(int kind, const int* old, const int* d,
                             int* out, int C) {
  for (int c = 0; c < C; ++c) {
    const int o = old[c];
    int r = o;
    switch (kind) {
      case SET: r = d[c]; break;
      case ADD: r = wadd(o, d[c]); break;
      case APPEND:
        if (c == 0) r = hash_combine(o, d[0]);
        else if (c == 1) r = min(wadd(o, d[1]), APPEND_CAP);
        break;
      case STOCK_DECR:
        if (c == 0) {
          const int q = wsub(o, d[0]);
          r = q >= 10 ? q : wadd(q, 91);
        } else if (c == 1) {
          r = wadd(o, d[0]);
        } else if (c == 2) {
          r = wadd(o, 1);
        } else if (c == 3) {
          r = wadd(o, d[3]);
        }
        break;
      case PAY_CUST:
        if (c == 0) r = hash_combine(o, d[0]);
        else if (c == 1) r = min(wadd(o, d[1]), APPEND_CAP);
        else r = wadd(o, d[c]);
        break;
      case SCAN_CONSUME: r = 0; break;
      default: break;
    }
    out[c] = r;
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

__global__ void fill_kernel(int* lock, long long n, int v) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) lock[i] = v;
}

__global__ void claim_kernel(int* lock, const int* __restrict__ addr,
                             const int* __restrict__ lane, int Kc,
                             int sentinel) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Kc) return;
  const int l = lane[i];
  if (l < sentinel) atomicMin(&lock[addr[i]], l);
}

extern "C" int occ_lock_build(const void* addr, const void* lane, int Kc,
                              void* lock, long long nt1, int sentinel,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = 256;
  fill_kernel<<<(unsigned)((nt1 + threads - 1) / threads), threads, 0, s>>>(
      (int*)lock, nt1, sentinel);
  if (Kc > 0)
    claim_kernel<<<(Kc + threads - 1) / threads, threads, 0, s>>>(
        (int*)lock, (const int*)addr, (const int*)lane, Kc, sentinel);
  return (int)cudaGetLastError();
}

struct ValidateArgs {
  const int* val;
  const long long* tid;
  const int* lock;
  const int* rlock;  // Calvin read-lock array, or null
  const int* rows;
  const int* kind;
  const int* delta;
  const uint8_t* wmask;
  const uint8_t* amask;
  const uint8_t* active;
  const long long* last_tid;
  const int* claim_addr;  // index args, or null
  const long long* claim_tid;
  const int* scan_addr;
  const long long* scan_tid;
  const uint8_t* scan_valid;
  const uint8_t* has_claim;
  uint8_t* commit;
  long long* new_tid;
  int* newv;
  uint8_t* w;
  int B, M, C, K, L;
  uint32_t epoch;
};

__global__ void validate_kernel(ValidateArgs a) {
  const int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int t = threadIdx.x & 31;
  if (b >= a.B) return;  // uniform across the warp
  const bool calvin = a.rlock != nullptr;
  const bool act = a.active[b];
  bool wins = true, read_ok = true, held = true;
  uint32_t obs = 0;
  for (int m = t; m < a.M; m += 32) {
    const long long idx = (long long)b * a.M + m;
    const int row = a.rows[idx];
    apply_op_row(a.kind[idx], a.val + (long long)row * a.C,
                 a.delta + idx * a.C, a.newv + idx * a.C, a.C);
    const bool wm = a.wmask[idx], am = a.amask[idx];
    const int holder = a.lock[row];
    if (wm && holder != b) wins = false;
    if (am && holder < b) read_ok = false;
    if (calvin && am && a.rlock[row] != b) held = false;
    if (am) obs = max(obs, (uint32_t)a.tid[row]);
  }
  if (a.claim_addr != nullptr) {
    for (int k = t; k < a.K; k += 32) {
      const long long idx = (long long)b * a.K + k;
      if (!a.has_claim[idx]) continue;
      const int ca = a.claim_addr[idx];
      if (a.lock[ca] != b) wins = false;
      if (calvin && a.rlock[ca] != b) held = false;
      obs = max(obs, (uint32_t)a.claim_tid[idx]);
    }
    const int KL = a.K * a.L;
    for (int s = t; s < KL; s += 32) {
      const long long idx = (long long)b * KL + s;
      if (!a.scan_valid[idx]) continue;
      const int sa = a.scan_addr[idx];
      if (act && a.lock[sa] < b) read_ok = false;
      if (calvin && act && a.rlock[sa] != b) held = false;
      obs = max(obs, (uint32_t)a.scan_tid[idx]);
    }
  }
  wins = __all_sync(FULL_MASK, wins);
  read_ok = __all_sync(FULL_MASK, read_ok);
  held = __all_sync(FULL_MASK, held);
  for (int off = 16; off > 0; off >>= 1)
    obs = max(obs, __shfl_xor_sync(FULL_MASK, obs, off));
  const bool commit = calvin ? (act && held) : (act && wins && read_ok);
  for (int m = t; m < a.M; m += 32) {
    const long long idx = (long long)b * a.M + m;
    a.w[idx] = (a.wmask[idx] && commit) ? 1 : 0;
  }
  if (t == 0) {
    a.commit[b] = commit ? 1 : 0;
    a.new_tid[b] = (long long)next_tid(a.epoch, obs,
                                       (uint32_t)a.last_tid[b]);
  }
}

extern "C" int occ_validate(
    const void* val, const void* tid, const void* lock, const void* rlock,
    const void* rows, const void* kind, const void* delta, const void* wmask,
    const void* amask, const void* active, const void* last_tid,
    const void* claim_addr, const void* claim_tid, const void* scan_addr,
    const void* scan_tid, const void* scan_valid, const void* has_claim,
    void* commit, void* new_tid, void* newv, void* w, int B, int M, int C,
    int K, int L, unsigned int epoch, void* stream) {
  ValidateArgs a;
  a.val = (const int*)val;
  a.tid = (const long long*)tid;
  a.lock = (const int*)lock;
  a.rlock = (const int*)rlock;
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
  a.commit = (uint8_t*)commit;
  a.new_tid = (long long*)new_tid;
  a.newv = (int*)newv;
  a.w = (uint8_t*)w;
  a.B = B; a.M = M; a.C = C; a.K = K; a.L = L;
  a.epoch = epoch;
  if (B > 0) {
    const int warps = 4;
    validate_kernel<<<(B + warps - 1) / warps, 32 * warps, 0,
                      (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

__global__ void install_kernel(int* val, long long* tid,
                               const int* __restrict__ rows,
                               const int* __restrict__ newv,
                               const uint8_t* __restrict__ w,
                               const long long* __restrict__ new_tid, int B,
                               int M, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * M || !w[i]) return;
  const long long row = rows[i];
  // a later op of the same lane writing the same row wins (the
  // reference's scatter is sequential)
  const long long end = (i / M + 1) * M;
  for (long long j = i + 1; j < end; ++j)
    if (w[j] && rows[j] == row) return;
  for (int c = 0; c < C; ++c) val[row * C + c] = newv[i * C + c];
  tid[row] = new_tid[i / M];
}

extern "C" int occ_install(void* val, void* tid, const void* rows,
                           const void* newv, const void* w,
                           const void* new_tid, int B, int M, int C,
                           void* stream) {
  const long long n = (long long)B * M;
  if (n > 0) {
    const int threads = 256;
    install_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     (cudaStream_t)stream>>>(
        (int*)val, (long long*)tid, (const int*)rows, (const int*)newv,
        (const uint8_t*)w, (const long long*)new_tid, B, M, C);
  }
  return (int)cudaGetLastError();
}
