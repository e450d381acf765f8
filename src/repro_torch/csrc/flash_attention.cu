// flash_attention: FlashAttention-2 style attention with explicit query and
// key positions and an explicit query-head -> kv-head map, in two launch
// configurations (prefill and decode).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, _flash_kernel
// (:27) and its wrapper flash_attention_pallas (:92).  Same function: key
// j is visible to query i iff k_pos[j] >= 0, and k_pos[j] <= q_pos[i] when
// causal, and k_pos[j] > q_pos[i] - window when windowed; softmax over the
// visible keys in float32 with an online (running max, running sum)
// rescaling; the unnormalised probabilities are rounded to v's type before
// the product with v, as the Pallas kernel does.  Query head h reads kv
// head kv_head[h] (any map: Hymba's padded 32 -> 7 is not h / groups), so
// K and V are read as they are stored, never expanded.  A query that sees
// no key gives the mean of v over all Sk keys (an f32 sum divided by Sk),
// as the Pallas kernel's finite -1e30 mask does (every p = 1, l = Sk).
//
// Layout: q (B, Sq, H, DK), k (B, Sk, Hkv, DK), v (B, Sk, Hkv, DV) and o
// (B, Sq, H, DV), read through element strides (batch, head, position)
// with the last axis contiguous.  float32 or bfloat16.  Head dims (DK, DV)
// in {(16, 16), (32, 32), (64, 64), (128, 128), (80, 80), (96, 64)}, the
// last two for HuBERT's heads of 80 and MiniCPM3's expanded MLA (q and k
// of 64 + 32 rotary, v of 64); decode takes DK == DV in {16, 32, 64, 128}
// (MLA decodes in its absorbed form, which has no attention kernel, and
// HuBERT is an encoder).
//
// Tiles at (80, 80) and (96, 64).  Products split into k-steps of 16
// (5 and 6 steps of q.k; 4 and 5 of P.v), so the mma.sync prefill needs
// nothing new: it keeps one m-tile of 16 rows a warp (64 rows a block, as
// at 128), since two m-tiles' Q fragments, S and O would pass the 255
// registers a thread that D = 64's 240 leave room for, and its shared rows
// stay padded by 16 bytes (176 and 208 bytes: 8 rows of an ldmatrix fall
// on 8 distinct 4-bank groups).  The backward's wgmma widths that are not
// a power of two (dK of 80 or 96 columns, dV of 80, dQ's half of 40 or 48)
// run as two products of the widths the kernel has (64 + 16, 64 + 32,
// 32 + 8, 32 + 16), the second's B operand one core-matrix group further;
// its query tiles are 64 rows, as at 128, for the registers: 128-row
// tiles would hold S^T, dP^T and their bf16 copies at twice the size
// beside dK and dV of up to 96 columns.  Shared memory: ~150 KB a block at
// (96, 64), ~141 KB at (80, 80); one block an SM, as at every head dim.
//
// What bounds it on the H100.  Prefill (8 requests x 32 heads x 2,048
// positions, window 1,024): operations, ~1.0e11 flops a call over the
// visible pairs against ~0.1 GB moved.  Decode (one query a head against a
// 1,024-slot ring): bytes, the unexpanded K and V cache once (14.7 MB).
//
// What the design does about it.
// - Prefill, bf16: one block of 4 warps per (query head, 128 query rows,
//   request) at D <= 64 (64 rows at D = 128); each warp owns two m-tiles
//   of 16 rows (one at D = 128), so every K and V fragment it loads from
//   shared memory serves two products.  Both products run on mma.sync
//   m16n8k16 (bf16 in, f32 accumulate) with operands loaded by ldmatrix
//   from shared rows padded by 16 bytes (conflict-free).  Q's fragments
//   are loaded once into registers; S stays in the accumulator registers
//   and is reused, packed to bf16, as P's A fragment; O stays in registers
//   and is rescaled there.  Row max and sum take quad shuffles (a row
//   spans 4 lanes); scores stay unscaled and each probability is one FMA
//   and one ex2.approx (scale * log2(e) folded in); the row sums stay per
//   thread until the end.  K and V tiles of 64 keys come through a
//   2-stage cp.async ring, the next visible tile loading while this one
//   computes: one barrier a tile.  Every key tile is classified once, at
//   the block's start, from the block's min/max query position and the
//   tile's min/max key position (positions are explicit): a tile no query
//   sees is skipped before it is loaded, a tile every query sees wholly
//   (no empty slot, inside the causal limit and the window) skips the
//   per-element mask.  Occupancy: at D = 64 a thread takes 240 registers
//   and a block ~57 KB of shared memory, so two blocks (8 warps) share an
//   SM.  In trial runs on the H100, one m-tile a warp (with four blocks
//   an SM), 8 warps a block, and key tiles of 32 or 128 were all slower.
//   The grid runs the heads fastest, so blocks that
//   share a kv head (adjacent heads under any monotone map) run together
//   and L2 serves their K and V.
// - Prefill, float32: plain FMAs (no TF32) with scores, probabilities and
//   the accumulator in shared memory; not on the timed path.
// - Decode: one block of 4 warps per (kv head, request, split of the
//   slots).  The block serves every query head mapped to its kv head, so
//   each K and V row is read once a step.  8 lanes x 16 bytes cover a
//   128-byte bf16 row (a warp instruction reads 4 rows, 4 such steps in
//   flight at once); each lane group keeps its own (m, l, acc) per query
//   head, combined by shuffles, then across the block's warps in shared
//   memory, then across the splits by the block that arrives last (a
//   counter per (request, kv head) that the last block resets to 0, so no
//   memset runs between calls): one launch a call.  The wrapper picks the
//   splits so that all blocks fit on the card at once (two an SM at 222
//   registers a thread): in trial runs a second wave cost more than the
//   extra blocks gained.
// - Masking never forms -inf - -inf: a masked score is -inf and the
//   running max starts at -1e30, finite.
// - Training: prefill also writes each row's log-sum-exp when the caller
//   passes an lse buffer (serving passes NULL and pays one branch a row),
//   and flash_attention_bwd below computes dQ, dK and dV.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;           // query rows a float32 prefill block
constexpr int BK = 64;           // keys a prefill tile
constexpr int PF_THREADS = 128;  // 4 warps x 16 query rows
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_U = 4;         // row steps a decode warp loads at once
constexpr int MAXG = 8;          // query heads a decode pass keeps
constexpr int MAX_HEADS = 256;
constexpr int MAX_SPLITS = 32;   // decode blocks per (request, kv head)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* qpos;
  const int* kpos;
  // kv_head[h]: query head h's kv head, then the heads grouped by kv head
  // (H), then where each group starts in that list (Hkv + 1)
  const int* kv_head;
  float* ws;                              // decode: partial (acc, m, l)
  int* counters;                          // decode: (B * Hkv,), all 0
  int B, H, Hkv, Sq, Sk, splits;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, position strides
  float scale;
  int causal, window;                     // window <= 0: none
  // prefill: NULL, or (B, H, Sq) float32 for each row's log-sum-exp of
  // its scaled scores (-inf for a row that sees no key), which the
  // backward needs; serving passes NULL
  float* lse;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ bool sees(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// mean over all Sk keys of v's rows into mean[0, D), lanes over d; the
// output of a query that sees no key
template <typename T, int D>
__device__ void warp_mean_v(const T* v, long long stride, int Sk,
                            float* mean) {
  for (int d = threadIdx.x & 31; d < D; d += 32) {
    float s = 0.f;
    for (int j = 0; j < Sk; ++j) s += to_f(v[j * stride + d]);
    mean[d] = s / (float)Sk;
  }
  __syncwarp();
}

// the block's min and max query position over its nq valid rows (every
// warp computes the same)
template <typename A>
__device__ __forceinline__ void q_range(const A& a, int q0, int nq,
                                        int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT32_MAX;
  hi = INT32_MIN;
  for (int i = lane; i < nq; i += 32) {
    lo = min(lo, a.qpos[q0 + i]);
    hi = max(hi, a.qpos[q0 + i]);
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
}

// classify every key tile (of TBK keys) once, a thread a tile, into
// cls[0, nT): 0 when no query of the block can see it (skipped before it
// is loaded), 2 when every query sees all of it (no per-element mask), 1
// otherwise.  Decided from the tile's min/max key position, which holds
// for any explicit positions; the caller synchronises before reading cls.
template <int TBK = BK, typename A>
__device__ void classify_tiles(const A& a, int nT, int qlo, int qhi,
                               unsigned char* cls) {
  const bool vec = (reinterpret_cast<uintptr_t>(a.kpos) & 15) == 0;
  for (int t = threadIdx.x; t < nT; t += blockDim.x) {
    const int k0 = t * TBK, n = min(TBK, a.Sk - k0);
    int lo = INT32_MAX, hi = -1;
    bool empty = n < TBK;
    auto upd = [&](int p) {
      if (p < 0) {
        empty = true;
      } else {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    };
    if (n == TBK && vec) {
      const int4* p4 = reinterpret_cast<const int4*>(a.kpos + k0);
#pragma unroll
      for (int i = 0; i < TBK / 4; ++i) {
        const int4 x = p4[i];
        upd(x.x);
        upd(x.y);
        upd(x.z);
        upd(x.w);
      }
    } else {
      for (int i = 0; i < n; ++i) upd(a.kpos[k0 + i]);
    }
    const bool vis = hi >= 0 && (!a.causal || lo <= qhi) &&
                     (a.window <= 0 || hi > qlo - a.window);
    const bool full = !empty && (!a.causal || hi <= qlo) &&
                      (a.window <= 0 || lo > qhi - a.window);
    cls[t] = vis ? (full ? 2 : 1) : 0;
  }
}

// the first tile at or after t that is not skipped (nT if none)
__device__ __forceinline__ int next_tile(const unsigned char* cls, int t,
                                         int nT) {
  while (t < nT && cls[t] == 0) ++t;
  return t;
}

// ---------------------------------------------------------------------------
// PTX wrappers: cp.async, ldmatrix, mma.sync
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x, flushing denormal results to 0 (MUFU.EX2 without exp2f's scaling)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// Hopper PTX for the bf16 backward: wgmma, proxy fences, bulk copies from
// shared memory, and the acquire / release pair of the dQ turns
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across this point
template <int R> __device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void reg_fence(float (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) reg_fence(d[i]);
}
template <int R, int C>
__device__ __forceinline__ void reg_fence(uint32_t (&d)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}
// this thread's shared-memory writes, visible to the async proxy (wgmma,
// bulk copies)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// global-memory writes of the async proxy (bulk copies) ordered with the
// generic proxy's (the turns' acquire and release)
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A wgmma shared-memory operand descriptor, no swizzle: the operand is
// stored as core matrices of 8 rows x 16 bytes (8 bf16), each 128
// contiguous bytes; `mn` and `k` are the byte distances between core
// matrices adjacent along M (or N) and along K.  The leading byte offset
// is the K distance and the stride byte offset the M/N distance, whether
// the 16 bytes of a core-matrix row run along K (K-major) or along M or N
// (MN-major, wgmma's transpose flag set): both held against matrix
// products on the H100.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t mn,
                                            uint32_t k) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((k >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((mn >> 4) & 0x3FFF) << 32);
}

// D (64 x N, float32, in registers) (+)= A (64 x 16) B (16 x N), bf16.
// wgmma_ss: A and B in shared memory (descriptors; TA / TB set = that
// operand MN-major); wgmma_rs: A in registers, in mma.sync's m16n8k16 A
// layout, each warp of the warpgroup holding its 16 rows.  acc = 0 writes
// D, 1 adds to it.  Accumulator layout: warp w of the warpgroup holds rows
// 16 w + lane / 4 (+ 8); d[4 c + 2 h + e] is row + 8 h, column
// 8 c + 2 (lane % 4) + e.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[4], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]),
        "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]),
        "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc),
        "n"(TB));
}

// wgmma_ss / wgmma_rs at any width N (a multiple of 8, at most 128): one
// product where the kernel has the width (8, 16, 32, 64, 128), else the
// largest of those below N and the rest, the rest's B operand (pieces of
// N adjacent columns, core matrices `bmn` bytes apart along N) starting
// where the first's ends and its accumulators after the first's (column
// 8 c of D is d[4 c ..]).  B is `b`'s descriptor with distances bmn, bk.
template <int N> struct WgPiece {
  static constexpr bool WHOLE =
      N == 8 || N == 16 || N == 32 || N == 64 || N == 128;
  static constexpr int P = N > 64 ? 64 : N > 32 ? 32 : N > 16 ? 16 : 8;
};
// the accumulators of a 64 x N product, and those of its two pieces
template <int N> using Acc = float[N / 2];
template <int N>
__device__ __forceinline__ Acc<WgPiece<N>::P>& head(Acc<N>& d) {
  return reinterpret_cast<Acc<WgPiece<N>::P>&>(d[0]);
}
template <int N>
__device__ __forceinline__ Acc<N - WgPiece<N>::P>& tail(Acc<N>& d) {
  return reinterpret_cast<Acc<N - WgPiece<N>::P>&>(d[WgPiece<N>::P / 2]);
}
template <int TA, int TB, int N>
__device__ __forceinline__ void wgmma_ss_n(Acc<N>& d, uint64_t da,
                                           const unsigned char* b,
                                           uint32_t bmn, uint32_t bk,
                                           int acc) {
  if constexpr (WgPiece<N>::WHOLE) {
    wgmma_ss<TA, TB>(d, da, wg_desc(b, bmn, bk), acc);
  } else {
    constexpr int P = WgPiece<N>::P;
    wgmma_ss<TA, TB>(head<N>(d), da, wg_desc(b, bmn, bk), acc);
    wgmma_ss_n<TA, TB, N - P>(tail<N>(d), da, b + (P / 8) * bmn, bmn, bk,
                              acc);
  }
}
template <int TB, int N>
__device__ __forceinline__ void wgmma_rs_n(Acc<N>& d, const uint32_t (&a)[4],
                                           const unsigned char* b,
                                           uint32_t bmn, uint32_t bk,
                                           int acc) {
  if constexpr (WgPiece<N>::WHOLE) {
    wgmma_rs<TB>(d, a, wg_desc(b, bmn, bk), acc);
  } else {
    constexpr int P = WgPiece<N>::P;
    wgmma_rs<TB>(head<N>(d), a, wg_desc(b, bmn, bk), acc);
    wgmma_rs_n<TB, N - P>(tail<N>(d), a, b + (P / 8) * bmn, bmn, bk, acc);
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
// bytes (a multiple of 16) from shared memory to global memory by the
// async proxy: a plain copy, or an add into float32
__device__ __forceinline__ void bulk_store(void* g, const void* s,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          g),
      "r"(smem_u32(s)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_add_f32(float* g, const void* s,
                                             uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(g),
      "r"(smem_u32(s)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// every bulk copy of this thread done (its writes performed)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// every bulk copy of this thread but the last done
__device__ __forceinline__ void bulk_wait_one() {
  asm volatile("cp.async.bulk.wait_group 1;\n" ::: "memory");
}
// mbarriers: init (one thread, then fence_mbar_init and a block barrier),
// arrive with the bytes the copies will bring, wait for a phase
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
// a TMA tile of a 5-D tensor map into shared memory, and a plain bulk
// copy from global memory, both completing on an mbarrier
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* m,
                                         int c0, int c1, int c2, int c3,
                                         int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_u32(dst)),
      "l"(m), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// prefill, bfloat16: mma.sync with registers for S, P and O
// ---------------------------------------------------------------------------
template <int DK, int DV> struct PFB {
  // m-tiles of 16 rows a warp: two share each K/V fragment loaded from
  // shared memory, halving ldmatrix traffic per product, where registers
  // allow (DK, DV <= 64)
  static constexpr int MT = DK <= 64 && DV <= 64 ? 2 : 1;
  static constexpr int BQ = 16 * MT * (PF_THREADS / 32);   // rows a block
  // elements a shared row of Q and K, and of V (16-byte pad)
  static constexpr int LDK = DK + 8, LDV = DV + 8;
  static constexpr int TK = BK * LDK, TV = BK * LDV;   // a K and a V tile
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t KV_OFF = BQ * LDK * 2;       // 2 x (K, V) stages
  static constexpr size_t KP_OFF = KV_OFF + 2 * (TK + TV) * 2;
  static constexpr size_t MEAN_OFF = KP_OFF + 2 * BK * 4;
  static constexpr size_t CLS_OFF = MEAN_OFF + (PF_THREADS / 32) * DV * 4;
  static constexpr size_t smem(int nT) { return CLS_OFF + nT; }
};

// issue the cp.async copies of key tile t (rows past Sk zero) into one
// stage, and its key positions (past Sk: -1) with plain stores
template <int DK, int DV>
__device__ __forceinline__ void load_kv(const Args& a, __nv_bfloat16* Ks,
                                        __nv_bfloat16* Vs, int* kps,
                                        const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, int t) {
  constexpr int LDK = PFB<DK, DV>::LDK, LDV = PFB<DK, DV>::LDV;
  // 16-byte chunks a row of K, of V, and of the wider; one pass issues a
  // chunk's K and V copies together (at DK == DV both always)
  constexpr int CK = DK / 8, CV = DV / 8, CM = CK > CV ? CK : CV;
  const int k0 = t * BK;
  for (int i = threadIdx.x; i < BK * CM; i += PF_THREADS) {
    const int r = i / CM, ch = i % CM, c = ch * 8;
    const bool ok = k0 + r < a.Sk;
    const long long j = ok ? k0 + r : 0;
    if (ch < CK) cp_async16(Ks + r * LDK + c, k + j * a.ks[2] + c, ok);
    if (ch < CV) cp_async16(Vs + r * LDV + c, v + j * a.vs[2] + c, ok);
  }
  if (threadIdx.x < BK)
    kps[threadIdx.x] =
        k0 + (int)threadIdx.x < a.Sk ? a.kpos[k0 + threadIdx.x] : -1;
}

template <int DK, int DV>
__global__ void __launch_bounds__(PF_THREADS, DK + DV <= 160 ? 2 : 1)
    prefill_bf16_kernel(Args a) {
  using L = PFB<DK, DV>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LDK, LDV = L::LDV, MT = L::MT, BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* KV = reinterpret_cast<bf16*>(smem + L::KV_OFF);
  int* KP = reinterpret_cast<int*>(smem + L::KP_OFF);
  unsigned char* cls = smem + L::CLS_OFF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, q0 = blockIdx.y * BQ, b = blockIdx.z;
  const int hk = a.kv_head[h];
  const int nq = min(BQ, a.Sq - q0);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  bf16* o = static_cast<bf16*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int i = tid; i < BQ * (DK / 8); i += PF_THREADS) {
    const int r = i / (DK / 8), c = (i % (DK / 8)) * 8;
    const bool ok = r < nq;
    cp_async16(Qs + r * LD + c, q + (long long)(q0 + (ok ? r : 0)) * a.qs[2] + c,
               ok);
  }
  int qlo, qhi;
  q_range(a, q0, nq, qlo, qhi);
  const int nT = (a.Sk + BK - 1) / BK;
  classify_tiles(a, nT, qlo, qhi, cls);
  __syncthreads();
  int t = next_tile(cls, 0, nT);
  if (t < nT) load_kv<DK, DV>(a, KV, KV + L::TK, KP, k, v, t);
  cp_async_commit();

  // this thread's rows: in m-tile i, rows r0 + 16 i + g and + 8 (mma
  // layout), with [i][0] and [i][1] their running max, sum and position
  const int r0 = warp * 16 * MT;
  int qp[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      qp[i][hf] = a.qpos[q0 + min(r0 + 16 * i + g + 8 * hf, nq - 1)];
  // scores stay unscaled: p = 2^(s * sl2 - m * sl2), one FMA and one ex2
  const float sl2 = a.scale * LOG2E;
  const float ninf = __int_as_float(0xff800000);
  float acc[MT][DV / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = NEG;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  uint32_t qf[MT][DK / 16][4];
  bool have_q = false;
  int stage = 0;

  while (t < nT) {
    const bool cur_full = cls[t] == 2;
    cp_async_wait_all();
    __syncthreads();          // tile t landed; the other stage is consumed
    if (!have_q) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int kk = 0; kk < DK / 16; ++kk)
          ldsm_x4(qf[i][kk], Qs + (r0 + 16 * i + (lane & 15)) * LD +
                                 kk * 16 + (lane >> 4) * 8);
      have_q = true;
    }
    const int tn = next_tile(cls, t + 1, nT);
    if (tn < nT) {
      bf16* nk = KV + (stage ^ 1) * (L::TK + L::TV);
      load_kv<DK, DV>(a, nk, nk + L::TK, KP + (stage ^ 1) * BK, k, v, tn);
    }
    cp_async_commit();
    const bf16* Ks = KV + stage * (L::TK + L::TV);
    const bf16* Vs = Ks + L::TK;
    const int* kps = KP + stage * BK;

    // S = Q K^T for this warp's rows and the tile's 64 keys; each K
    // fragment serves every m-tile
    float s[MT][BK / 8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, Ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816(s[i][2 * np], qf[i][kk], bfr[0], bfr[1]);
          mma16816(s[i][2 * np + 1], qf[i][kk], bfr[2], bfr[3]);
        }
      }
    }
    if (!cur_full) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kps[j * 8 + 2 * tq + (e & 1)];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            if (!sees(kp, qp[i][e >> 1], a.causal, a.window))
              s[i][j][e] = ninf;
        }
    }

    // online softmax: quad shuffles for the row max; the row sums stay
    // per thread until the end
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = m[i][hf];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[i][j][2 * hf], s[i][j][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float al = ex2((m[i][hf] - mx) * sl2), ms = mx * sl2;
        m[i][hf] = mx;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[i][j][2 * hf] = ex2(fmaf(s[i][j][2 * hf], sl2, -ms));
          s[i][j][2 * hf + 1] = ex2(fmaf(s[i][j][2 * hf + 1], sl2, -ms));
          rs += s[i][j][2 * hf] + s[i][j][2 * hf + 1];
        }
        l[i][hf] = l[i][hf] * al + rs;
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          acc[i][j][2 * hf] *= al;
          acc[i][j][2 * hf + 1] *= al;
        }
      }
    }

    // O += P V, P from S's registers packed to bf16 (A fragments); each V
    // fragment serves every m-tile
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        pa[i][0] = pack_bf16(s[i][2 * kk][0], s[i][2 * kk][1]);
        pa[i][1] = pack_bf16(s[i][2 * kk][2], s[i][2 * kk][3]);
        pa[i][2] = pack_bf16(s[i][2 * kk + 1][0], s[i][2 * kk + 1][1]);
        pa[i][3] = pack_bf16(s[i][2 * kk + 1][2], s[i][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LDV + dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816(acc[i][2 * dp], pa[i], bfr[0], bfr[1]);
          mma16816(acc[i][2 * dp + 1], pa[i], bfr[2], bfr[3]);
        }
      }
    }
    t = tn;
    stage ^= 1;
  }
  cp_async_wait_all();

  // rows that saw no key (l == 0) get the mean of v over all Sk keys
  bool dead[MT][2], any_dead = false;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[i][hf] += __shfl_xor_sync(FULL, l[i][hf], 1);
      l[i][hf] += __shfl_xor_sync(FULL, l[i][hf], 2);
      dead[i][hf] = l[i][hf] == 0.f && r0 + 16 * i + g + 8 * hf < nq;
      any_dead |= dead[i][hf];
      const int r = r0 + 16 * i + g + 8 * hf;
      if (a.lse != nullptr && tq == 0 && r < nq)
        a.lse[((long long)b * a.H + h) * a.Sq + q0 + r] =
            l[i][hf] == 0.f ? -INFINITY : m[i][hf] * a.scale + logf(l[i][hf]);
    }
  float* mean = reinterpret_cast<float*>(smem + L::MEAN_OFF) + warp * DV;
  if (__any_sync(FULL, any_dead)) warp_mean_v<bf16, DV>(v, a.vs[2], a.Sk,
                                                        mean);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 16 * i + g + 8 * hf;
      if (r >= nq) continue;
      const float inv = dead[i][hf] ? 0.f : 1.f / l[i][hf];
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int c = j * 8 + 2 * tq;
        const float x0 = dead[i][hf] ? mean[c] : acc[i][j][2 * hf] * inv;
        const float x1 = dead[i][hf] ? mean[c + 1] : acc[i][j][2 * hf + 1] * inv;
        *reinterpret_cast<__nv_bfloat162*>(o + (q0 + r) * a.os[2] + c) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
}

// ---------------------------------------------------------------------------
// prefill, float32: plain FMAs through shared memory
// ---------------------------------------------------------------------------
template <int DK, int DV> struct PFF {
  // odd row strides (words): lanes reading one column of 32 rows hit 32
  // banks
  static constexpr int LD = DK + 1;    // Q, K tiles
  static constexpr int LDV = DV + 1;   // V tile
  static constexpr int LDS = BK + 4;   // scores, then probabilities
  static constexpr int LDO = DV + 4;   // accumulator
  static constexpr size_t al(size_t b) { return (b + 127) / 128 * 128; }
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + al(BQ * LD * 4);
  static constexpr size_t V_OFF = K_OFF + al(BK * LD * 4);
  static constexpr size_t S_OFF = V_OFF + al(BK * LDV * 4);
  static constexpr size_t O_OFF = S_OFF + al(BQ * LDS * 4);
  static constexpr size_t M_OFF = O_OFF + al(BQ * LDO * 4);
  static constexpr size_t I_OFF = M_OFF + al(3 * BQ * 4);
  static constexpr size_t CLS_OFF = I_OFF + al((BQ + BK) * 4);
  static constexpr size_t smem(int nT) { return CLS_OFF + nT; }
};

// rows [0, BQ or BK) of a (rows, D) float tile into shared memory (row
// stride LD); rows at or past `valid` are zero
template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride, int valid,
                                              int nrows) {
  constexpr int CPR = D / 4;
  for (int i = threadIdx.x; i < nrows * CPR; i += PF_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) x = *reinterpret_cast<const float4*>(src + r * stride + c);
    dst[r * LD + c] = x.x;
    dst[r * LD + c + 1] = x.y;
    dst[r * LD + c + 2] = x.z;
    dst[r * LD + c + 3] = x.w;
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(PF_THREADS) prefill_f32_kernel(Args a) {
  using L = PFF<DK, DV>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::Q_OFF);
  float* Ks = reinterpret_cast<float*>(smem + L::K_OFF);
  float* Vs = reinterpret_cast<float*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* mrow = reinterpret_cast<float*>(smem + L::M_OFF);
  float* lrow = mrow + BQ;
  float* arow = lrow + BQ;
  int* qp = reinterpret_cast<int*>(smem + L::I_OFF);
  int* kp = qp + BQ;
  unsigned char* cls = smem + L::CLS_OFF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, q0 = blockIdx.y * BQ, b = blockIdx.z;
  const int hk = a.kv_head[h];
  const int nq = min(BQ, a.Sq - q0);
  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  float* o = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];

  load_tile_f32<DK, L::LD>(Qs, q + q0 * a.qs[2], a.qs[2], nq, BQ);
  for (int i = tid; i < BQ; i += PF_THREADS) {
    qp[i] = a.qpos[q0 + min(i, nq - 1)];   // padding rows repeat the last
    mrow[i] = NEG;
    lrow[i] = 0.f;
  }
  for (int i = tid; i < BQ * L::LDO; i += PF_THREADS) Os[i] = 0.f;
  int qlo, qhi;
  q_range(a, q0, nq, qlo, qhi);
  const int nT = (a.Sk + BK - 1) / BK;
  classify_tiles(a, nT, qlo, qhi, cls);
  __syncthreads();

  const int r0 = warp * 16;                // this warp's query rows
  for (int t = next_tile(cls, 0, nT); t < nT; t = next_tile(cls, t + 1, nT)) {
    const int k0 = t * BK, nk = min(BK, a.Sk - k0);
    __syncthreads();                       // the last tile is consumed
    for (int i = tid; i < BK; i += PF_THREADS)
      kp[i] = i < nk ? a.kpos[k0 + i] : -1;
    load_tile_f32<DK, L::LD>(Ks, k + k0 * a.ks[2], a.ks[2], nk, BK);
    load_tile_f32<DV, L::LDV>(Vs, v + k0 * a.vs[2], a.vs[2], nk, BK);
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
    for (int rr = 0; rr < 16; ++rr) {
      const float* qrow = Qs + (r0 + rr) * L::LD;
      for (int c = lane; c < BK; c += 32) {
        const float* krow = Ks + c * L::LD;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < DK; ++d) acc += qrow[d] * krow[d];
        Ss[(r0 + rr) * L::LDS + c] = acc * a.scale;
      }
    }
    __syncwarp();

    // online softmax over this warp's rows; probabilities overwrite scores
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      float sv[BK / 32];
      bool vis[BK / 32];
      float tmax = NEG;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        vis[u] = sees(kp[c], qp[r], a.causal, a.window);
        sv[u] = Ss[r * L::LDS + c];
        if (vis[u]) tmax = fmaxf(tmax, sv[u]);
      }
#pragma unroll
      for (int x = 16; x > 0; x >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, x));
      const float m_new = fmaxf(mrow[r], tmax);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = vis[u] ? expf(sv[u] - m_new) : 0.f;
        psum += p;
        Ss[r * L::LDS + lane + 32 * u] = p;
      }
#pragma unroll
      for (int x = 16; x > 0; x >>= 1)
        psum += __shfl_xor_sync(FULL, psum, x);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(mrow[r] - m_new);
        arow[r] = alpha;
        mrow[r] = m_new;
        lrow[r] = lrow[r] * alpha + psum;
      }
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const float* prow = Ss + r * L::LDS;
      for (int d = lane; d < DV; d += 32) {
        float acc = 0.f;
#pragma unroll 16
        for (int j = 0; j < BK; ++j) acc += prow[j] * Vs[j * L::LDV + d];
        Os[r * L::LDO + d] = Os[r * L::LDO + d] * arow[r] + acc;
      }
    }
  }
  __syncthreads();
  // rows that saw no key: the mean of v over all Sk keys (the warp's own
  // score rows hold it)
  bool dead = false;
  for (int rr = 0; rr < 16 && r0 + rr < nq; ++rr) dead |= lrow[r0 + rr] == 0.f;
  float* mean = Ss + r0 * L::LDS;
  if (dead) warp_mean_v<float, DV>(v, a.vs[2], a.Sk, mean);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    if (r >= nq) break;
    const float l = lrow[r];
    for (int d = lane; d < DV; d += 32)
      o[(q0 + r) * a.os[2] + d] = l > 0.f ? Os[r * L::LDO + d] / l : mean[d];
    if (a.lse != nullptr && lane == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + q0 + r] =
          l > 0.f ? mrow[r] + logf(l) : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// decode (one query a head): a block per (slot split, kv head, request)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(Args a) {
  constexpr int VEC = 16 / sizeof(T);    // elements a lane loads
  constexpr int LPR = D / VEC;           // lanes a K/V row
  constexpr int RPW = 32 / LPR;          // rows a warp instruction
  constexpr int STEP = DEC_WARPS * RPW;  // rows the block covers a step
  using P = Pack<T, VEC>;
  __shared__ int heads[MAX_HEADS];
  __shared__ int is_last;
  __shared__ float wm[DEC_WARPS][MAXG], wl[DEC_WARPS][MAXG];
  __shared__ float wacc[DEC_WARPS][MAXG][D];
  __shared__ float cf[MAXG][MAX_SPLITS], cden[MAXG];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int row = lane / LPR, c = (lane % LPR) * VEC;
  // the query heads of kv head hk: order[off[hk], off[hk + 1]) of the
  // table's grouped list
  const int* order = a.kv_head + a.H;
  const int off = order[a.H + hk], G = order[a.H + hk + 1] - off;
  for (int i = tid; i < G; i += DEC_THREADS) heads[i] = order[off + i];
  __syncthreads();
  const int per = (a.Sk + a.splits - 1) / a.splits;
  const int j0 = sp * per, j1 = min(a.Sk, j0 + per);
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const int qpos = a.qpos[0];
  const float sl2 = a.scale * LOG2E;
  float* ws = a.ws + (long long)b * a.H * a.splits * (D + 2);

  for (int g0 = 0; g0 < G; g0 += MAXG) {
    const int ng = min(MAXG, G - g0);
    float qv[MAXG][VEC], acc[MAXG][VEC], m[MAXG], l[MAXG];
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      m[gi] = NEG;
      l[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[gi][e] = acc[gi][e] = 0.f;
      if (gi < ng) {
        const T* qh = static_cast<const T*>(a.q) + b * a.qs[0] +
                      heads[g0 + gi] * a.qs[1];
        const P x = *reinterpret_cast<const P*>(qh + c);
#pragma unroll
        for (int e = 0; e < VEC; ++e) qv[gi][e] = to_f(x.v[e]) * sl2;
      }
    }
    for (int jb = j0 + warp * RPW; jb < j1; jb += STEP * DEC_U) {
      // positions, K and V of DEC_U rows, all loads in flight together
      P kr[DEC_U], vr[DEC_U];
      int kp[DEC_U];
#pragma unroll
      for (int u = 0; u < DEC_U; ++u) {
        const int j = jb + u * STEP + row;
        const long long jj = j < j1 ? j : j0;
        kp[u] = j < j1 ? a.kpos[j] : -1;
        kr[u] = *reinterpret_cast<const P*>(k + jj * a.ks[2] + c);
        vr[u] = *reinterpret_cast<const P*>(v + jj * a.vs[2] + c);
      }
#pragma unroll
      for (int u = 0; u < DEC_U; ++u) {
        const bool vis = sees(kp[u], qpos, a.causal, a.window);
        float kf[VEC], vf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kf[e] = to_f(kr[u].v[e]);
          vf[e] = to_f(vr[u].v[e]);
        }
#pragma unroll
        for (int gi = 0; gi < MAXG; ++gi) {
          if (gi >= ng) break;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) s += qv[gi][e] * kf[e];
#pragma unroll
          for (int x = 1; x < LPR; x <<= 1) s += __shfl_xor_sync(FULL, s, x);
          if (vis) {
            const float mn = fmaxf(m[gi], s);
            const float al = ex2(m[gi] - mn), p = ex2(s - mn);
            const float pr = to_f(from_f<T>(p));   // rounded as v's type
            l[gi] = l[gi] * al + p;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[gi][e] = acc[gi][e] * al + pr * vf[e];
            m[gi] = mn;
          }
        }
      }
    }
    // combine the warp's row groups (lanes LPR apart), then its warps
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      if (gi >= ng) break;
#pragma unroll
      for (int x = LPR; x < 32; x <<= 1) {
        const float mo = __shfl_xor_sync(FULL, m[gi], x);
        const float lo = __shfl_xor_sync(FULL, l[gi], x);
        const float mn = fmaxf(m[gi], mo);
        const float sa = ex2(m[gi] - mn), sb = ex2(mo - mn);
        l[gi] = l[gi] * sa + lo * sb;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[gi][e] = acc[gi][e] * sa +
                       __shfl_xor_sync(FULL, acc[gi][e], x) * sb;
        m[gi] = mn;
      }
      if (row == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) wacc[warp][gi][c + e] = acc[gi][e];
      }
      if (lane == 0) {
        wm[warp][gi] = m[gi];
        wl[warp][gi] = l[gi];
      }
    }
    __syncthreads();
    // this split's (acc[D], m, l) of each head, into the scratch
    for (int i = tid; i < ng * (D + 2); i += DEC_THREADS) {
      const int gi = i / (D + 2), d = i % (D + 2);
      float mn = NEG;
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) mn = fmaxf(mn, wm[w][gi]);
      float s = d == D ? mn : 0.f;
      if (d != D) {
#pragma unroll
        for (int w = 0; w < DEC_WARPS; ++w)
          s += (d < D ? wacc[w][gi][d] : wl[w][gi]) * ex2(wm[w][gi] - mn);
      }
      ws[((long long)heads[g0 + gi] * a.splits + sp) * (D + 2) + d] = s;
    }
    __syncthreads();                       // wm, wl, wacc are consumed
  }

  // the last block of (request, kv head) to arrive combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = a.counters + b * a.Hkv + hk;
    const int last = atomicAdd(cnt, 1) == a.splits - 1;
    if (last) *cnt = 0;                    // ready for the next call
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int g0 = 0; g0 < G; g0 += MAXG) {
    const int ng = min(MAXG, G - g0);
    // each split's m, one thread a (head, split); then per head the
    // weights 2^(m - max) and the sum of the weighted l
    for (int i = tid; i < ng * a.splits; i += DEC_THREADS) {
      const int gi = i / a.splits, s = i % a.splits;
      cf[gi][s] = __ldcg(ws + ((long long)heads[g0 + gi] * a.splits + s) *
                                  (D + 2) + D);
    }
    __syncthreads();
    if (tid < ng) {
      const float* w = ws + (long long)heads[g0 + tid] * a.splits * (D + 2);
      float mn = NEG, den = 0.f;
      for (int s = 0; s < a.splits; ++s) mn = fmaxf(mn, cf[tid][s]);
      for (int s = 0; s < a.splits; ++s) {
        cf[tid][s] = ex2(cf[tid][s] - mn);
        den += __ldcg(w + s * (D + 2) + D + 1) * cf[tid][s];
      }
      cden[tid] = den;
    }
    __syncthreads();
    for (int i = tid; i < ng * D; i += DEC_THREADS) {
      const int gi = i / D, d = i % D, h = heads[g0 + gi];
      const float* w = ws + (long long)h * a.splits * (D + 2) + d;
      float num = 0.f;
#pragma unroll 8
      for (int s = 0; s < a.splits; ++s) num += __ldcg(w + s * (D + 2)) * cf[gi][s];
      float out;
      if (cden[gi] > 0.f) {
        out = num / cden[gi];
      } else {                             // no visible key: mean of v
        float sum = 0.f;
        for (int j = 0; j < a.Sk; ++j) sum += to_f(v[j * a.vs[2] + d]);
        out = sum / (float)a.Sk;
      }
      T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
      o[d] = from_f<T>(out);
    }
    __syncthreads();                       // cf, cden are consumed
  }
}

template <typename T, int DK, int DV>
int launch(const Args& a, cudaStream_t st) {
  if (a.Sq == 1) {
    // decode: DK == DV, a power of two (a K/V row spans 2 to 32 lanes)
    if constexpr (DK == DV && (DK & (DK - 1)) == 0) {
      if (a.ws == nullptr || a.counters == nullptr || a.splits < 1 ||
          a.splits > MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
      decode_kernel<T, DK><<<dim3(a.splits, a.Hkv, a.B), DEC_THREADS, 0,
                             st>>>(a);
      return (int)cudaGetLastError();
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(a.H, (a.Sq + BQ - 1) / BQ, a.B);
    const size_t smem = PFF<DK, DV>::smem((a.Sk + BK - 1) / BK);
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_f32_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    prefill_f32_kernel<DK, DV><<<grid, PF_THREADS, smem, st>>>(a);
  } else {
    using L = PFB<DK, DV>;
    const dim3 grid(a.H, (a.Sq + L::BQ - 1) / L::BQ, a.B);
    const size_t smem = L::smem((a.Sk + BK - 1) / BK);
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_bf16_kernel<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    prefill_bf16_kernel<DK, DV><<<grid, PF_THREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

// every (DK, DV) instance of the kernels: X(DK, DV) for each pair
#define FA_HEAD_DIMS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(80, 80) X(96, 64)

template <typename T>
int launch_d(const Args& a, int DK, int DV, cudaStream_t st) {
#define FA_CASE(K, V) \
  if (DK == K && DV == V) return launch<T, K, V>(a, st);
  FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward: dQ, dK and dV of prefill.
//
// Replaces: no TPU kernel.  The JAX package differentiates its XLA
// attention (chunked_attention, src/repro/models/attention.py:61) and has
// no backward kernel; this one serves the port's training path.  Same
// function as autograd through the plain version: P = exp(scale S - LSE)
// over the visible keys, dV = P^T dO, dP = dO V^T, dS = P (dP - D_i) with
// D_i = sum_d dO_i O_i, dQ = scale dS K, dK = scale dS^T Q.  A row that saw
// no key (LSE -inf) got the mean of v over all Sk keys: its gradient is
// dO / Sk on every key's v and 0 on q and k.
//
// What bounds it on the H100: operations, five products of the forward's
// size (S, dP, dV, dK, dQ): at 8 x 2,048 x 16 heads x 64, causal, 172
// GFLOP in bf16 against ~117 MB of q, k, v, o, dO, the LSE and the three
// gradients.
//
// bf16, three kernels a call:
// 1. bwd_pre_kernel, a block per (BQ query rows, query head, request):
//    2,048 blocks at the training shape, so this bandwidth-bound pass over
//    O and dO covers the card.  Each row's D_i, and the rows' table the
//    main kernel reads (LSE log2 e, +inf for a row that saw no key or lies
//    past Sq; D_i; the position); whether the tile has a row that saw no
//    key; the tile's dQ turn counter set to 0.  The blocks of head 0,
//    request 0 also write the tile plan: for each query tile and key tile,
//    whether a query of the one may see a key of the other (from their
//    min and max positions, as the forward classifies its tiles), whether
//    every query sees every key (no mask), and the key tile's rank among
//    the query tile's visible key tiles, the highest key tile first; and
//    each query tile's count of them.
// 2. bwd_bf16_kernel, one fused kernel for the five products, a block per
//    BKT = 128 keys of one (kv head, request), warp-specialised: two
//    consumer warpgroups (64 keys each, 232 registers a thread) and a
//    producer warpgroup that gives its registers up (setmaxnreg), of which
//    one warp loads and one writes dQ.  The block keeps its K and V tile
//    in shared memory and walks every query head mapped to its kv head
//    (the head table's grouped list, so GQA and Hymba's padded map sum
//    inside the block) and their visible query tiles of BQ rows (128; 64
//    at D = 128).  Per visit each consumer warpgroup computes S^T = K Q^T
//    and dP^T = V dO^T (wgmma, both operands in shared memory, the two
//    chains' k-steps interleaved), P^T and dS^T in the accumulator
//    registers (no branch: the mask only in tiles that need one), then
//    dV += P^T dO and dK += dS^T Q (wgmma with P^T and dS^T as register A
//    operands: the accumulator layout packed to bf16, as the forward
//    packs P), in flight while dS goes to shared memory, then its half of
//    D's columns of dQ = dS K over all 128 keys (wgmma, both warpgroups'
//    dS and K read transposed from shared memory).  dK and dV stay in
//    registers over the walk.  Q, dO and the rows' table arrive
//    by TMA (a 5-D tensor map a tensor, encoded on the host each call
//    through the driver's cuTensorMapEncodeTiled, whose box lands as
//    wgmma's no-swizzle core matrices) into a 2-stage ring on mbarriers:
//    the next visit's tiles load while this one computes.
//    dQ without float atomics in a run-dependent order: each warpgroup
//    stages its columns of the tile in shared memory (in the accumulators'
//    own order: no bank conflicts), and the dQ warp copies the tile by
//    Hopper's bulk copy (rank 0) or bulk reduce-add (the rest) into a
//    float32 scratch tile per (request,
//    query head, query tile), in the order of the plan's ranks: it waits
//    until the tile's turn counter equals its rank (acquire), issues the
//    copy, and passes the turn on (release) once the copy has landed,
//    which it checks after issuing the next tile's.  So every element of
//    dQ is summed in one fixed order and dQ is the same bit for bit in
//    every run; two dQ buffers let the consumers run a visit ahead of the
//    turns.  Rank 0 is the highest visible key tile: under a causal mask
//    the diagonal one, whose block reaches that query tile first.
//    Why no wait can deadlock: each block takes a ticket (an atomic
//    counter) when it starts and maps it to its (key tile, kv head,
//    request), the highest key tile first within a (kv head, request).  A
//    block waits only for higher key tiles of its own (kv head, request),
//    whose tickets are lower: they started before it, are resident or
//    done, and wait in turn only on lower tickets; the block holding a
//    turn never waits for a block below it.
//    A row that saw no key takes no part in the walk (its P is 0 there);
//    its dO / Sk is added to every key's dV at the end, summed in a fixed
//    order, by the blocks whose query heads have such a row.
//    Shared memory at D = 64: K and V 32 KB, two stages of Q, dO and the
//    rows' table 68 KB, two warpgroups' dS 32 KB, two float32 dQ tiles
//    64 KB: ~197 KB, one block an SM.  D = 128 (BQ = 64): ~211 KB.
// 3. bwd_dq_kernel writes each scratch tile as bf16 dq x scale (0 for a
//    query tile that no key tile is visible to).
// float32 (not on the timed path): the same pre-pass (64-row tiles), then
// FlashAttention-2's split with plain FMAs through shared memory, dQ by a
// block per query tile and dK, dV by a block per key tile.
// ---------------------------------------------------------------------------
struct BArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  const float* lse;                       // (B, H, Sq)
  const int* qpos;
  const int* kpos;
  const int* kv_head;                     // the forward's head table
  void* dq;
  void* dk;
  void* dv;
  float* drow;                            // float32: (B, H, Sq) D_i
  // bf16 only (NULL for float32), see above
  float4* rows;                           // (B, H, nQT * BQ)
  int* plan;                              // (nQT, nKT), then nQT counts
  int* turn;                              // (B, H, nQT) dQ turn counters
  int* dead;                              // (B, H, nQT) a row saw no key
  unsigned* ticket;                       // the main kernel's tickets
  float* dqacc;                           // (B, H, nQT, BQ * D)
  int B, H, Hkv, Sq, Sk, nQT, nKT, bkt;   // bkt: keys a main-kernel block
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  float scale;
  int causal, window;
};

constexpr int PRE_THREADS = 128;
constexpr int MAX_KT = 4096;        // key tiles the plan classifies at most

// the bf16 main kernel: NWG consumer warpgroups of 128 threads, 64 keys
// each, and a producer warpgroup (a warp of loads, a warp of dQ); query
// tiles of BQ rows (64 where a head dim passes 64: the registers)
template <int DK, int DV> struct BW {
  static constexpr int NWG = 2;
  static constexpr int BKT = 64 * NWG;          // keys a block
  static constexpr int BQ = DK <= 64 && DV <= 64 ? 128 : 64;
  static constexpr int MT = BQ / 64;            // dQ's m-tiles
  static constexpr int NC = 128 * NWG;          // consumer threads
  static constexpr int NT = NC + 128;           // and the producer warpgroup
  // registers a thread after setmaxnreg: 8 warps at 232 and 4 at 40 fill
  // the 64 K registers of an SM (12 warps start at 168 each)
  static constexpr int REG_C = 232, REG_P = 40;
  static constexpr int S = 2;                   // stages of the Q/dO ring
  static constexpr int NB = 2;                  // dQ tiles in flight
  static constexpr int TQ = BQ * DK * 2;        // bytes of a Q tile
  static constexpr int TO = BQ * DV * 2;        // bytes of a dO tile
  static constexpr int TK = BKT * DK * 2;       // bytes of the K tile
  static constexpr int TV = BKT * DV * 2;       // bytes of the V tile
  static constexpr int TS = 64 * BQ * 2;        // a warpgroup's dS tile
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = TK;
  static constexpr size_t Q_OFF = TK + TV;                // S stages
  static constexpr size_t DO_OFF = Q_OFF + S * TQ;        // S stages
  static constexpr size_t R_OFF = DO_OFF + S * TO;        // S x the rows
  static constexpr size_t S_OFF = R_OFF + S * BQ * 16;    // NWG x dS
  static constexpr size_t DQ_OFF = S_OFF + NWG * TS;      // NB x dQ, f32
  static constexpr size_t X_OFF = DQ_OFF + NB * BQ * DK * 4;  // DV floats
  static constexpr size_t P_OFF = X_OFF + DV * 4;  // plan column, then the
                                                   // visible query tiles
  static constexpr size_t smem(int nQT) { return P_OFF + 8 * (size_t)nQT; }
  // named barriers (0 is __syncthreads): a stage is free; both dS tiles
  // are whole; both are free again; the consumers
  static constexpr int EMPTY = 1, DS = EMPTY + S, DS_FREE = DS + 1,
                       CONS = DS_FREE + 1;
};

// query rows a tile of the backward: the float32 path's pre-pass, 64
template <typename T, int DK, int DV>
__host__ __device__ constexpr int tile_rows() {
  return std::is_same<T, float>::value ? 64 : BW<DK, DV>::BQ;
}

// the least power of two >= n
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// the plan's row for query tile qt (rows [q0, q0 + nq)); a whole block
__device__ void plan_row(const BArgs& a, int qt, int q0, int nq) {
  __shared__ unsigned char cls[MAX_KT];
  int qlo, qhi;
  q_range(a, q0, nq, qlo, qhi);
  if (a.bkt == 64)
    classify_tiles<64>(a, a.nKT, qlo, qhi, cls);
  else
    classify_tiles<128>(a, a.nKT, qlo, qhi, cls);
  __syncthreads();
  int* row = a.plan + (long long)qt * a.nKT;
  for (int t = threadIdx.x; t < a.nKT; t += blockDim.x) {
    int rank = 0;
    for (int u = t + 1; u < a.nKT; ++u) rank += cls[u] != 0;
    row[t] = cls[t] == 0 ? 0 : (rank << 2) | (cls[t] == 2 ? 2 : 0) | 1;
    if (t == 0) a.plan[(long long)a.nQT * a.nKT + qt] = rank + (cls[0] != 0);
  }
}

// a block per (BQ query rows, query head, request); D_i over o's DV
// columns
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(PRE_THREADS) bwd_pre_kernel(BArgs a) {
  constexpr int BQ = tile_rows<T, DK, DV>();
  constexpr int VEC = 16 / sizeof(T);
  // lanes a row (2 to 32): a power of two for the shuffles, the lanes
  // past DV (at DV = 80) idle
  constexpr int LPR = pow2_at_least(DV / VEC);
  constexpr bool EXACT = LPR * VEC == DV;
  constexpr int RPW = 32 / LPR;           // rows a warp step
  constexpr int WARPS = PRE_THREADS / 32;
  using P = Pack<T, VEC>;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = qt * BQ, nq = min(BQ, a.Sq - q0);
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + h * a.os[1];
  const T* dO = static_cast<const T*>(a.dO) + b * a.dos[0] + h * a.dos[1];
  const long long bh = (long long)b * a.H + h;
  int dead = 0;
  // every step's loads are independent: unrolled, all are in flight at once
#pragma unroll
  for (int it = 0; it < BQ / (WARPS * RPW); ++it) {
    const int r = (it * WARPS + warp) * RPW + lane / LPR;
    const int c = (lane % LPR) * VEC, i = q0 + r;
    float s = 0.f;
    if (r < nq && (EXACT || c < DV)) {
      const P x = *reinterpret_cast<const P*>(o + i * a.os[2] + c);
      const P y = *reinterpret_cast<const P*>(dO + i * a.dos[2] + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += to_f(x.v[e]) * to_f(y.v[e]);
    }
#pragma unroll
    for (int x = 1; x < LPR; x <<= 1) s += __shfl_xor_sync(FULL, s, x);
    if (lane % LPR == 0) {
      const float l = r < nq ? a.lse[bh * a.Sq + i] : INFINITY;
      const bool none = r < nq && l == -INFINITY;
      dead |= none;
      if (r < nq && a.drow != nullptr) a.drow[bh * a.Sq + i] = s;
      if (a.rows != nullptr)
        a.rows[(bh * a.nQT + qt) * BQ + r] = make_float4(
            r < nq && !none ? l * LOG2E : INFINITY, r < nq ? s : 0.f,
            __int_as_float(a.qpos[min(i, a.Sq - 1)]), 0.f);
    }
  }
  dead = __syncthreads_or(dead);
  if (a.rows == nullptr) return;
  if (threadIdx.x == 0) {
    a.dead[bh * a.nQT + qt] = dead;
    a.turn[bh * a.nQT + qt] = 0;
    if (qt == 0 && bh == 0) *a.ticket = 0u;
  }
  if (bh == 0) plan_row(a, qt, q0, nq);
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

// P^T = exp(scale S^T - LSE) and dS^T = P^T (dP^T - D_i) in place, for
// this thread's keys kp (rows g, g + 8), the tile's rows RW and queries
// [16 kk, 16 kk + 16); query 8 c + 2 t4 + e is column e of n-tile c.
// Without branches, so that the compiler interleaves the exponentials: a
// masked score's exponential is computed and dropped.
template <bool MASK, int N>
__device__ __forceinline__ void grad_scores(float (&s)[N], float (&dp)[N],
                                            const float4* RW,
                                            const int (&kp)[2], float sl2,
                                            int causal, int window, int t4,
                                            int kk) {
#pragma unroll
  for (int c = 2 * kk; c < 2 * kk + 2; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 rw = RW[8 * c + 2 * t4 + e];
      const int qp = __float_as_int(rw.z);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 4 * c + 2 * hf + e;
        float p = ex2(fmaf(s[j], sl2, -rw.x));
        if (MASK) {
          const bool vis = (kp[hf] >= 0) & ((causal == 0) | (kp[hf] <= qp)) &
                           ((window <= 0) | (kp[hf] > qp - window));
          p = vis ? p : 0.f;
        }
        s[j] = p;
        dp[j] = p * (dp[j] - rw.y);
      }
    }
}

// TMA maps of q, dO (boxes of BQ rows) and k, v (BKT rows), from
// tile_map below
struct TMaps {
  CUtensorMap q, dO, k, v;
};

template <int DK, int DV>
__global__ void __launch_bounds__(BW<DK, DV>::NT, 1)
    bwd_bf16_kernel(BArgs a, const __grid_constant__ TMaps tm) {
  using L = BW<DK, DV>;
  using bf16 = __nv_bfloat16;
  constexpr int BKT = L::BKT, NC = L::NC, S = L::S, NB = L::NB;
  constexpr int BQ = L::BQ, MT = L::MT, DH = DK / 2;
  constexpr uint32_t CM = 128;               // bytes of a core matrix
  constexpr uint32_t QG = (BQ / 8) * CM;     // Q, dO, dS: column-group step
  constexpr int KS = (DK > DV ? DK : DV) / 16;   // the k-steps of S^T, dP^T
  constexpr uint32_t KG = (BKT / 8) * CM;    // K, V: column-group step
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned ticket;
  __shared__ int n_vis;
  // mbarriers: a stage has landed (TMA); a dQ tile is whole; its buffer
  // is free
  __shared__ __align__(8) uint64_t full[S], dq_full[NB], dq_free[NB];
  unsigned char* Ks = smem + L::K_OFF;
  unsigned char* Vs = smem + L::V_OFF;
  float2* DQs = reinterpret_cast<float2*>(smem + L::DQ_OFF);
  float* dsum = reinterpret_cast<float*>(smem + L::X_OFF);
  int* plan = reinterpret_cast<int*>(smem + L::P_OFF);
  int* vq = plan + a.nQT;                        // visible query tiles

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  if (tid == 0) {
    ticket = atomicAdd(a.ticket, 1u);
#pragma unroll
    for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      mbar_init(&dq_full[i], NC);
      mbar_init(&dq_free[i], 1);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int tk = (int)ticket, nQT = a.nQT;
  const int grp = tk / a.nKT;                    // b * Hkv + kv head
  const int kt = a.nKT - 1 - tk % a.nKT;
  const int b = grp / a.Hkv, hk = grp % a.Hkv;
  const int k0 = kt * BKT, nk = min(BKT, a.Sk - k0);
  for (int i = tid; i < nQT; i += L::NT)
    plan[i] = a.plan[(long long)i * a.nKT + kt];
  const int* order = a.kv_head + a.H;
  const int off = order[a.H + hk], G = order[a.H + hk + 1] - off;
  __syncthreads();
  if (tid < 32) {                                // the visible query tiles
    int n = 0;
    for (int q0 = 0; q0 < nQT; q0 += 32) {
      const bool v = q0 + lane < nQT && (plan[q0 + lane] & 1);
      const unsigned m = __ballot_sync(FULL, v);
      if (v) vq[n + __popc(m & ((1u << lane) - 1))] = q0 + lane;
      n += __popc(m);
    }
    if (lane == 0) n_vis = n;
  }
  __syncthreads();
  // visit v: query head order[off + v / nvq], query tile vq[v % nvq]
  const int nvq = n_vis, nv = G * nvq;
  auto tile_of = [&](int v) {
    return ((long long)b * a.H + order[off + v / nvq]) * nQT + vq[v % nvq];
  };

  if (wg == L::NWG) {
    // ---- the producer warpgroup: warp 0 loads, warp 1 writes dQ; it
    // gives its registers to the consumers and its other warps leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::REG_P));
    if (wi == 0) {
      // visit v's Q, dO and rows' table into stage v % S by TMA (lane 0);
      // the first visit also brings the block's K and V
      auto load = [&](int v) {
        const int h = order[off + v / nvq], qt = vq[v % nvq], st = v % S;
        mbar_expect(&full[st], L::TQ + L::TO + BQ * 16 +
                                   (v == 0 ? L::TK + L::TV : 0));
        if (v == 0) {
          tma_tile(Ks, &tm.k, 0, k0, 0, hk, b, &full[0]);
          tma_tile(Vs, &tm.v, 0, k0, 0, hk, b, &full[0]);
        }
        tma_tile(smem + L::Q_OFF + st * L::TQ, &tm.q, 0, qt * BQ, 0, h, b,
                 &full[st]);
        tma_tile(smem + L::DO_OFF + st * L::TO, &tm.dO, 0, qt * BQ, 0, h,
                 b, &full[st]);
        bulk_load(smem + L::R_OFF + st * BQ * 16,
                  a.rows + tile_of(v) * BQ, BQ * 16, &full[st]);
      };
      for (int v = 0; v < nv; ++v) {
        if (v >= S) named_sync(L::EMPTY + v % S, NC + 32);
        if (lane == 0) load(v);
      }
    } else if (wi == 1 && lane == 0) {
      // dQ: each tile in its turn.  A tile's copy lands while the next
      // tile's turn is polled: once the next copy is issued, the tile
      // before has its turn passed on and its buffer freed.  Holding a turn
      // while waiting for the next one cannot deadlock: only blocks of
      // lower key tiles wait for it, and this block waits only for higher
      // ones.
      int* held = nullptr;
      int held_rank = 0;
      for (int u = 0; u < nv; ++u) {
        const int bu = u % NB;
        mbar_wait(&dq_full[bu], (u / NB) & 1);
        const long long tile = tile_of(u);
        int* turn = a.turn + tile;
        const int rank = plan[vq[u % nvq]] >> 2;
        // a turn that never comes is a fault of the plan: trap (an error
        // on the stream) after ~2^26 polls rather than hold the card
        for (int n = 0; ld_acquire(turn) != rank; ++n)
          if (n == 1 << 26) __trap();
        fence_async_global();
        float* dst = a.dqacc + tile * (BQ * DK);
        const float2* src = DQs + bu * (BQ * DK / 2);
        if (rank == 0)
          bulk_store(dst, src, BQ * DK * 4);
        else
          bulk_add_f32(dst, src, BQ * DK * 4);
        bulk_commit();
        if (held != nullptr) {          // the tile before: landed, passed on
          bulk_wait_one();
          mbar_arrive(&dq_free[(u - 1) % NB]);
          fence_async_global();
          st_release(held, held_rank + 1);
        }
        held = turn;
        held_rank = rank;
      }
      if (held != nullptr) {
        bulk_wait_all();
        fence_async_global();
        st_release(held, held_rank + 1);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg owns keys [64 wg, 64 wg + 64) -------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::REG_C));
  unsigned char* Sw = smem + L::S_OFF + wg * L::TS;   // this one's dS
  // this thread's two keys: rows g and g + 8 of its warp's 16
  int kp[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 64 * wg + 16 * wi + g + 8 * hf;
    kp[hf] = r < nk ? a.kpos[k0 + r] : -1;
  }
  const float sl2 = a.scale * LOG2E;
  float dk[DK / 2], dv[DV / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) dv[i] = 0.f;
  for (int n = 0; n < nv; ++n) {
    const int st = n % S, qt = vq[n % nvq];
    const bool whole = (plan[qt] & 2) != 0;     // no mask in this tile
    const unsigned char* Qs = smem + L::Q_OFF + st * L::TQ;
    const unsigned char* dOs = smem + L::DO_OFF + st * L::TO;
    const float4* RW =
        reinterpret_cast<const float4*>(smem + L::R_OFF + st * BQ * 16);
    mbar_wait(&full[st], (n / S) & 1);          // the visit's tiles landed

    // S^T = K Q^T (DK / 16 k-steps) and dP^T = V dO^T (DV / 16), their
    // k-steps interleaved (two independent chains keep the tensor cores
    // busier than one)
    float s[BQ / 2], dp[BQ / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk < DK / 16)
        wgmma_ss<0, 0>(s, wg_desc(Ks + wg * 8 * CM + kk * 2 * KG, CM, KG),
                       wg_desc(Qs + kk * 2 * QG, CM, QG), kk > 0);
      if (kk < DV / 16)
        wgmma_ss<0, 0>(dp, wg_desc(Vs + wg * 8 * CM + kk * 2 * KG, CM, KG),
                       wg_desc(dOs + kk * 2 * QG, CM, QG), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    // P^T and dS^T in place, the mask only in tiles that need one, then
    // the bf16 A operands
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      if (whole)
        grad_scores<false>(s, dp, RW, kp, sl2, a.causal, a.window, t4, kk);
      else
        grad_scores<true>(s, dp, RW, kp, sl2, a.causal, a.window, t4, kk);
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        da[kk][i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
      }
    // dV += P^T dO, dK += dS^T Q (dO and Q read transposed), in flight
    // while dS goes to shared memory
    reg_fence(dv);
    reg_fence(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs_n<1, DV>(dv, pa[kk], dOs + kk * 2 * CM, QG, CM, 1);
      wgmma_rs_n<1, DK>(dk, da[kk], Qs + kk * 2 * CM, QG, CM, 1);
    }
    wg_commit();
    // dS to this warpgroup's tile, a key per core-matrix row (key group
    // 2 wi + hf, query group c), once both warpgroups' dQ products of the
    // last visit have read the tiles
    if (n > 0) named_sync(L::DS_FREE, NC);
#pragma unroll
    for (int c = 0; c < BQ / 8; ++c)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint32_t*>(
            Sw + (((2 * wi + hf) * (BQ / 8) + c) * 8 + g) * 16 + t4 * 4) =
            da[c >> 1][2 * (c & 1) + hf];
    fence_async_smem();
    named_sync(L::DS, NC);                      // both dS tiles are whole
    // this warpgroup's columns [wg DH, wg DH + DH) of dQ = dS K over the
    // block's 128 keys (m-tiles of 64 queries; dS read transposed)
    float dq[MT][DH / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_ss_n<1, 1, DH>(
            dq[mt],
            wg_desc(smem + L::S_OFF + (kk >> 2) * L::TS + mt * 8 * CM +
                        (kk & 3) * 2 * QG,
                    CM, QG),
            Ks + kk * 2 * CM + wg * (DH / 8) * KG, KG, CM, kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(dq);
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pa);
    reg_fence(da);
    if (n + S < nv) named_arrive(L::EMPTY + st, NC + 32);   // stage free
    // this warpgroup's columns of the block's dQ tile, in the
    // accumulators' order, for the producer to copy out
    const int bn = n % NB;
    float2* stg = DQs + bn * (BQ * DK / 2);
    if (n >= NB) mbar_wait(&dq_free[bn], (n / NB - 1) & 1);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jj = 0; jj < DH / 4; ++jj)
        stg[(((mt * 2 + wg) * 4 + wi) * (DH / 4) + jj) * 32 + lane] =
            make_float2(dq[mt][2 * jj], dq[mt][2 * jj + 1]);
    fence_async_smem();
    mbar_arrive(&dq_full[bn]);
  }

  // rows that saw no key: dO / Sk on every key's v
  bool any_dead = false;
  for (int i = 0; i < G; ++i) {
    const long long bh = (long long)b * a.H + order[off + i];
    for (int t = 0; t < nQT; ++t) any_dead |= a.dead[bh * nQT + t] != 0;
  }
  if (any_dead) {
    for (int d = tid; d < DV; d += NC) {
      float sum = 0.f;
      for (int i = 0; i < G; ++i) {
        const int h = order[off + i];
        const float* lse = a.lse + ((long long)b * a.H + h) * a.Sq;
        const bf16* dO = static_cast<const bf16*>(a.dO) + b * a.dos[0] +
                         h * a.dos[1] + d;
        for (int r = 0; r < a.Sq; ++r)
          if (lse[r] == -INFINITY) sum += to_f(dO[r * a.dos[2]]);
      }
      dsum[d] = sum / (float)a.Sk;
    }
    named_sync(L::CONS, NC);
#pragma unroll
    for (int c = 0; c < DV / 8; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dv[4 * c + j] += dsum[8 * c + 2 * t4 + (j & 1)];
  }
  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 64 * wg + 16 * wi + g + 8 * hf;
    if (r >= nk) continue;
#pragma unroll
    for (int c = 0; c < DK / 8; ++c) {
      const int col = 8 * c + 2 * t4, j = 4 * c + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(dkp + (k0 + r) * a.dks[2] + col) =
          __floats2bfloat162_rn(dk[j] * a.scale, dk[j + 1] * a.scale);
    }
#pragma unroll
    for (int c = 0; c < DV / 8; ++c) {
      const int col = 8 * c + 2 * t4, j = 4 * c + 2 * hf;
      *reinterpret_cast<__nv_bfloat162*>(dvp + (k0 + r) * a.dvs[2] + col) =
          __floats2bfloat162_rn(dv[j], dv[j + 1]);
    }
  }
}

// dq = scale x the scratch tile of (request, query head, query tile): read
// in the order the main kernel wrote it, transposed through shared memory,
// written a row at a time
template <int DK, int DV>
__global__ void __launch_bounds__(256) bwd_dq_kernel(BArgs a) {
  constexpr int D = DK, BQ = BW<DK, DV>::BQ, DH = D / 2;
  __shared__ float tile[BQ][D + 1];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ, nq = min(BQ, a.Sq - q0);
  const bool any = a.plan[(long long)a.nQT * a.nKT + qt] > 0;
  const float2* src = reinterpret_cast<const float2*>(
      a.dqacc + (((long long)b * a.H + h) * a.nQT + qt) * (BQ * D));
  for (int p = threadIdx.x; p < BQ * D / 2; p += 256) {
    // p = (((m-tile 2 + warpgroup) 4 + warp) DH / 4 + pair) 32 + lane
    const int lane = p & 31, jj = (p >> 5) % (DH / 4), w = (p >> 5) / (DH / 4);
    const int row = 64 * (w >> 3) + 16 * (w & 3) + (lane >> 2) + 8 * (jj & 1);
    const int col = ((w >> 2) & 1) * DH + 8 * (jj >> 1) + 2 * (lane & 3);
    const float2 x = any ? src[p] : make_float2(0.f, 0.f);
    tile[row][col] = x.x;
    tile[row][col + 1] = x.y;
  }
  __syncthreads();
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.dq) + b * a.dqs[0] +
                      h * a.dqs[1];
  for (int p = threadIdx.x; p < nq * (D / 2); p += 256) {
    const int row = p / (D / 2), col = 2 * (p % (D / 2));
    *reinterpret_cast<__nv_bfloat162*>(dq + (q0 + row) * a.dqs[2] + col) =
        __floats2bfloat162_rn(tile[row][col] * a.scale,
                              tile[row][col + 1] * a.scale);
  }
}

// ---- float32: plain FMAs through shared memory -----------------------------
constexpr int FB = 32;                   // query rows and keys a tile

template <int DK, int DV> struct BFL {
  // odd row strides (words); every (FB, DK) or (FB, DV) tile in the
  // room of the wider
  static constexpr int LD = (DK > DV ? DK : DV) + 1;
  static constexpr int LDS = FB + 1;
  static constexpr size_t al(size_t b) { return (b + 127) / 128 * 128; }
  static constexpr size_t T_BYTES = al(FB * LD * 4);
  // four (FB, D) tiles (Q, dO, K, V), two accumulators, two (FB, FB)
  static constexpr size_t A_OFF = 4 * T_BYTES;
  static constexpr size_t S_OFF = A_OFF + 2 * T_BYTES;
  static constexpr size_t I_OFF = S_OFF + 2 * al(FB * LDS * 4);
  static constexpr size_t SMEM = I_OFF + 4 * FB * 4;
};

template <int D, int LD>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int valid) {
  for (int i = threadIdx.x; i < FB * D; i += PF_THREADS) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// dQ: a block per (query head, FB query rows, request)
template <int DK, int DV>
__global__ void __launch_bounds__(PF_THREADS) bwd_dq_f32_kernel(BArgs a) {
  using L = BFL<DK, DV>;
  constexpr int LD = L::LD, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = reinterpret_cast<float*>(smem + L::T_BYTES);
  float* Ks = reinterpret_cast<float*>(smem + 2 * L::T_BYTES);
  float* Vs = reinterpret_cast<float*>(smem + 3 * L::T_BYTES);
  float* Acc = reinterpret_cast<float*>(smem + L::A_OFF);
  float* dS = reinterpret_cast<float*>(smem + L::S_OFF);
  int* QP = reinterpret_cast<int*>(smem + L::I_OFF);
  int* KP = QP + FB;
  float* LS = reinterpret_cast<float*>(KP + FB);
  float* DR = LS + FB;
  const int tid = threadIdx.x;
  const int h = blockIdx.x, q0 = blockIdx.y * FB, b = blockIdx.z;
  const int hk = a.kv_head[h];
  const int nq = min(FB, a.Sq - q0);
  const long long bh = ((long long)b * a.H + h) * a.Sq;
  const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* dO =
      static_cast<const float*>(a.dO) + b * a.dos[0] + h * a.dos[1];
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  float* dq = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
  load_f32<DK, LD>(Qs, q + q0 * a.qs[2], a.qs[2], nq);
  load_f32<DV, LD>(dOs, dO + q0 * a.dos[2], a.dos[2], nq);
  for (int i = tid; i < FB * LD; i += PF_THREADS) Acc[i] = 0.f;
  if (tid < FB) {
    QP[tid] = a.qpos[q0 + min(tid, nq - 1)];
    LS[tid] = tid < nq ? a.lse[bh + q0 + tid] : -INFINITY;
    DR[tid] = tid < nq ? a.drow[bh + q0 + tid] : 0.f;
  }
  for (int k0 = 0; k0 < a.Sk; k0 += FB) {
    const int nk = min(FB, a.Sk - k0);
    __syncthreads();                      // the last tile is consumed
    load_f32<DK, LD>(Ks, k + k0 * a.ks[2], a.ks[2], nk);
    load_f32<DV, LD>(Vs, v + k0 * a.vs[2], a.vs[2], nk);
    if (tid < FB) KP[tid] = tid < nk ? a.kpos[k0 + tid] : -1;
    __syncthreads();
    for (int idx = tid; idx < FB * FB; idx += PF_THREADS) {
      const int i = idx / FB, j = idx % FB;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < DK; ++d) s += Qs[i * LD + d] * Ks[j * LD + d];
      for (int d = 0; d < DV; ++d) dp += dOs[i * LD + d] * Vs[j * LD + d];
      const bool vis = LS[i] != -INFINITY &&
                       sees(KP[j], QP[i], a.causal, a.window);
      const float p = vis ? expf(s * a.scale - LS[i]) : 0.f;
      dS[i * LDS + j] = p * (dp - DR[i]);
    }
    __syncthreads();
    for (int idx = tid; idx < FB * DK; idx += PF_THREADS) {
      const int i = idx / DK, d = idx % DK;
      float s = 0.f;
      for (int j = 0; j < FB; ++j) s += dS[i * LDS + j] * Ks[j * LD + d];
      Acc[i * LD + d] += s;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * DK; idx += PF_THREADS) {
    const int i = idx / DK, d = idx % DK;
    dq[(q0 + i) * a.dqs[2] + d] = Acc[i * LD + d] * a.scale;
  }
}

// dK, dV: a block per (FB keys, kv head, request)
template <int DK, int DV>
__global__ void __launch_bounds__(PF_THREADS) bwd_dkdv_f32_kernel(BArgs a) {
  using L = BFL<DK, DV>;
  constexpr int LD = L::LD, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = reinterpret_cast<float*>(smem + L::T_BYTES);
  float* Ks = reinterpret_cast<float*>(smem + 2 * L::T_BYTES);
  float* Vs = reinterpret_cast<float*>(smem + 3 * L::T_BYTES);
  float* dK = reinterpret_cast<float*>(smem + L::A_OFF);
  float* dV = reinterpret_cast<float*>(smem + L::A_OFF + L::T_BYTES);
  float* Ps = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dS = Ps + FB * LDS;
  int* QP = reinterpret_cast<int*>(smem + L::I_OFF);
  int* KP = QP + FB;
  float* LS = reinterpret_cast<float*>(KP + FB);
  float* DR = LS + FB;
  const int tid = threadIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * FB, nk = min(FB, a.Sk - k0);
  const float* k = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* v = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  load_f32<DK, LD>(Ks, k + k0 * a.ks[2], a.ks[2], nk);
  load_f32<DV, LD>(Vs, v + k0 * a.vs[2], a.vs[2], nk);
  for (int i = tid; i < FB * LD; i += PF_THREADS) dK[i] = dV[i] = 0.f;
  if (tid < FB) KP[tid] = tid < nk ? a.kpos[k0 + tid] : -1;
  const float inv_sk = 1.f / (float)a.Sk;
  const int* order = a.kv_head + a.H;
  const int off = order[a.H + hk], G = order[a.H + hk + 1] - off;
  for (int gi = 0; gi < G; ++gi) {
    const int h = order[off + gi];
    const long long bh = ((long long)b * a.H + h) * a.Sq;
    const float* q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const float* dO =
        static_cast<const float*>(a.dO) + b * a.dos[0] + h * a.dos[1];
    for (int q0 = 0; q0 < a.Sq; q0 += FB) {
      const int nq = min(FB, a.Sq - q0);
      __syncthreads();                    // the last tile is consumed
      load_f32<DK, LD>(Qs, q + q0 * a.qs[2], a.qs[2], nq);
      load_f32<DV, LD>(dOs, dO + q0 * a.dos[2], a.dos[2], nq);
      if (tid < FB) {
        QP[tid] = a.qpos[q0 + min(tid, nq - 1)];
        LS[tid] = tid < nq ? a.lse[bh + q0 + tid] : INFINITY;
        DR[tid] = tid < nq ? a.drow[bh + q0 + tid] : 0.f;
      }
      __syncthreads();
      for (int idx = tid; idx < FB * FB; idx += PF_THREADS) {
        const int i = idx / FB, j = idx % FB;
        const float l = LS[i];
        float p = 0.f, ds = 0.f;
        if (l == -INFINITY) {
          p = inv_sk;                     // saw no key: the mean of v
        } else if (l != INFINITY && sees(KP[j], QP[i], a.causal, a.window)) {
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < DK; ++d) s += Qs[i * LD + d] * Ks[j * LD + d];
          for (int d = 0; d < DV; ++d)
            dp += dOs[i * LD + d] * Vs[j * LD + d];
          p = expf(s * a.scale - l);
          ds = p * (dp - DR[i]);
        }
        Ps[i * LDS + j] = p;
        dS[i * LDS + j] = ds;
      }
      __syncthreads();
      for (int idx = tid; idx < FB * DV; idx += PF_THREADS) {
        const int j = idx / DV, d = idx % DV;
        float sv = 0.f;
        for (int i = 0; i < FB; ++i) sv += Ps[i * LDS + j] * dOs[i * LD + d];
        dV[j * LD + d] += sv;
      }
      for (int idx = tid; idx < FB * DK; idx += PF_THREADS) {
        const int j = idx / DK, d = idx % DK;
        float sk = 0.f;
        for (int i = 0; i < FB; ++i) sk += dS[i * LDS + j] * Qs[i * LD + d];
        dK[j * LD + d] += sk;
      }
    }
  }
  __syncthreads();
  float* dkp = static_cast<float*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  float* dvp = static_cast<float*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
  for (int idx = tid; idx < nk * DK; idx += PF_THREADS) {
    const int j = idx / DK, d = idx % DK;
    dkp[(k0 + j) * a.dks[2] + d] = dK[j * LD + d] * a.scale;
  }
  for (int idx = tid; idx < nk * DV; idx += PF_THREADS) {
    const int j = idx / DV, d = idx % DV;
    dvp[(k0 + j) * a.dvs[2] + d] = dV[j * LD + d];
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the workspace's layout: sets a's scratch pointers into ws (when not
// NULL) and returns its bytes.  float32: D_i (B, H, Sq).  bf16: the rows'
// table, the plan and its counts, the turn counters, the dead flags, the
// ticket and the dQ scratch (see the note).
template <typename T, int DK, int DV>
size_t bwd_workspace(BArgs& a, char* ws) {
  const size_t bh = (size_t)a.B * a.H;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = ws == nullptr ? nullptr : ws + off;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  constexpr int BQ = tile_rows<T, DK, DV>();
  a.nQT = (a.Sq + BQ - 1) / BQ;
  if constexpr (std::is_same<T, float>::value) {
    a.bkt = FB;
    a.nKT = (a.Sk + FB - 1) / FB;
    a.drow = reinterpret_cast<float*>(take(bh * a.Sq * 4));
  } else {
    a.bkt = BW<DK, DV>::BKT;
    a.nKT = (a.Sk + a.bkt - 1) / a.bkt;
    a.rows = reinterpret_cast<float4*>(take(bh * a.nQT * BQ * 16));
    a.plan = reinterpret_cast<int*>(take(((size_t)a.nQT * a.nKT + a.nQT) * 4));
    a.turn = reinterpret_cast<int*>(take(bh * a.nQT * 4));
    a.dead = reinterpret_cast<int*>(take(bh * a.nQT * 4));
    a.ticket = reinterpret_cast<unsigned*>(take(4));
    a.dqacc = reinterpret_cast<float*>(take(bh * a.nQT * BQ * DK * 4));
  }
  return off;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, from the driver library the CUDA
// runtime has loaded (no link against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A TMA map over a (B, S, heads, D) bf16 tensor read through its element
// strides st (batch, head, position), whose box is `rows` positions of one
// (request, head): 5-D (8 elements, positions, D / 8 column groups, heads,
// requests), box (8, rows, D / 8, 1, 1), so a tile lands as D / 8 column
// groups of rows x 16 bytes: wgmma's no-swizzle core-matrix layout, 128
// contiguous bytes a core matrix.  Rows past S are zero-filled.
int tile_map(CUtensorMap* m, const void* base, const long long* st, int B,
             int S, int heads, int D, int rows) {
  const EncodeTiled f = encode_tiled();
  if (f == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[5] = {8, (cuuint64_t)S, (cuuint64_t)(D / 8),
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)st[2] * 2, 16,
                                 (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[5] = {8, (cuuint32_t)rows, (cuuint32_t)(D / 8), 1, 1};
  const cuuint32_t one[5] = {1, 1, 1, 1, 1};
  const CUresult r = f(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                       const_cast<void*>(base), dims, strides, box, one,
                       CU_TENSOR_MAP_INTERLEAVE_NONE,
                       CU_TENSOR_MAP_SWIZZLE_NONE,
                       CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                       CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int DK, int DV>
int launch_bwd(BArgs a, char* ws, cudaStream_t st) {
  bwd_workspace<T, DK, DV>(a, ws);
  if (a.nKT > MAX_KT) return (int)cudaErrorInvalidValue;
  const dim3 tiles(a.nQT, a.H, a.B);
  bwd_pre_kernel<T, DK, DV><<<tiles, PRE_THREADS, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if constexpr (std::is_same<T, float>::value) {
    using L = BFL<DK, DV>;
    if ((err = set_smem(bwd_dq_f32_kernel<DK, DV>, L::SMEM))) return err;
    bwd_dq_f32_kernel<DK, DV><<<dim3(a.H, (a.Sq + FB - 1) / FB, a.B),
                                PF_THREADS, L::SMEM, st>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = set_smem(bwd_dkdv_f32_kernel<DK, DV>, L::SMEM))) return err;
    bwd_dkdv_f32_kernel<DK, DV><<<dim3(a.nKT, a.Hkv, a.B), PF_THREADS,
                                  L::SMEM, st>>>(a);
  } else {
    using L = BW<DK, DV>;
    TMaps tm;
    if ((err = tile_map(&tm.q, a.q, a.qs, a.B, a.Sq, a.H, DK, L::BQ)) ||
        (err = tile_map(&tm.dO, a.dO, a.dos, a.B, a.Sq, a.H, DV, L::BQ)) ||
        (err = tile_map(&tm.k, a.k, a.ks, a.B, a.Sk, a.Hkv, DK, L::BKT)) ||
        (err = tile_map(&tm.v, a.v, a.vs, a.B, a.Sk, a.Hkv, DV, L::BKT)))
      return err;
    const size_t sm = L::smem(a.nQT);
    if ((err = set_smem(bwd_bf16_kernel<DK, DV>, sm))) return err;
    bwd_bf16_kernel<DK, DV><<<a.nKT * a.Hkv * a.B, L::NT, sm, st>>>(a, tm);
    if ((err = (int)cudaGetLastError())) return err;
    bwd_dq_kernel<DK, DV><<<tiles, 256, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_d(const BArgs& a, int DK, int DV, char* ws, cudaStream_t st) {
#define FA_CASE(K, V) \
  if (DK == K && DV == V) return launch_bwd<T, K, V>(a, ws, st);
  FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
size_t workspace_d(BArgs& a, int DK, int DV) {
#define FA_CASE(K, V) \
  if (DK == K && DV == V) return bwd_workspace<T, K, V>(a, nullptr);
  FA_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  return 0;
}

}  // namespace


// Strides are in elements, in the order (batch, head, position) for q, k,
// v and o; the last axis is contiguous.  q and k have head dim DK, v and o
// DV (a pair of FA_HEAD_DIMS).  kv_head: int32, the (H,) map of
// query heads to kv heads in [0, Hkv), then the H query heads ordered by
// kv head, then the Hkv + 1 offsets of each kv head's run in that order.
// dtype 0 = float32, 1 = bfloat16.  Sq == 1 runs the decode
// configuration, any other Sq the prefill one; decode splits the slots
// over `splits` blocks per (request, kv head) and needs `ws`, float32 of
// B * H * splits * (DV + 2), and `counters`, int32 of B * Hkv, zero before
// the first call (each call leaves them zero).  Prefill ignores all three.
// lse: NULL, or for prefill float32 (B, H, Sq), each row's log-sum-exp of
// its scaled visible scores (-inf where it sees no key) for the backward;
// decode ignores it.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* qpos,
    const void* kpos, const void* kv_head, void* ws, void* counters,
    void* lse, int B, int H, int Hkv, int Sq, int Sk, int DK, int DV,
    int splits,
    long long qsb,
    long long qsh, long long qss, long long ksb, long long ksh, long long kss,
    long long vsb, long long vsh, long long vss, long long osb, long long osh,
    long long oss, float scale, int causal, int window, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H > MAX_HEADS) return (int)cudaErrorInvalidValue;
  Args a{q,      k,   v,  o,  (const int*)qpos, (const int*)kpos,
         (const int*)kv_head, (float*)ws, (int*)counters,
         B,      H,   Hkv, Sq, Sk, splits,
         {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
         scale, causal, window, (float*)lse};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(a, DK, DV, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, DK, DV, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of prefill: dq, dk, dv (shaped and typed as q, k, v: head
// dims DK, DK, DV) from dO (as o), the forward's o and lse ((B, H, Sq)
// float32) and the same
// positions, head table, scale and masks.  Strides in elements, (batch,
// head, position), last axis contiguous, for q, k, v, o, dO, dq, dk, dv.
// ws: flash_attention_bwd_workspace(...) bytes of scratch on the card,
// 256-byte aligned, every byte written before it is read.  Three kernels
// on the stream (see above); no float atomics: each call gives the same
// gradients bit for bit.
extern "C" long long flash_attention_bwd_workspace(int B, int H, int Sq,
                                                   int Sk, int DK, int DV,
                                                   int dtype) {
  BArgs a{};
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  if (dtype == 0) return (long long)workspace_d<float>(a, DK, DV);
  if (dtype == 1) return (long long)workspace_d<__nv_bfloat16>(a, DK, DV);
  return 0;
}

extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, const void* qpos, const void* kpos,
    const void* kv_head, void* dq, void* dk, void* dv, void* ws, int B,
    int H, int Hkv, int Sq, int Sk, int DK, int DV, const long long* strides,
    float scale, int causal, int window, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaGetLastError();
  if (Hkv <= 0 || H > MAX_HEADS || Sq == 1) return (int)cudaErrorInvalidValue;
  BArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dO = dO;
  a.lse = (const float*)lse;
  a.qpos = (const int*)qpos;
  a.kpos = (const int*)kpos;
  a.kv_head = (const int*)kv_head;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  long long* dst[8] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_bwd_d<float>(a, DK, DV, (char*)ws, st);
  if (dtype == 1)
    return launch_bwd_d<__nv_bfloat16>(a, DK, DV, (char*)ws, st);
  return (int)cudaErrorInvalidValue;
}
