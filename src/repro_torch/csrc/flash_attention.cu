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
// Layout: q, o (B, Sq, H, D) and k, v (B, Sk, Hkv, D), read through
// element strides (batch, head, position) with the last axis contiguous.
// float32 or bfloat16; D in {16, 32, 64, 128}.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// prefill, bfloat16: mma.sync with registers for S, P and O
// ---------------------------------------------------------------------------
template <int D> struct PFB {
  // m-tiles of 16 rows a warp: two share each K/V fragment loaded from
  // shared memory, halving ldmatrix traffic per product, where registers
  // allow (D <= 64)
  static constexpr int MT = D <= 64 ? 2 : 1;
  static constexpr int BQ = 16 * MT * (PF_THREADS / 32);   // rows a block
  static constexpr int LD = D + 8;    // elements a shared row (16-byte pad)
  static constexpr int TILE = BK * LD;
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t KV_OFF = BQ * LD * 2;        // 2 x (K, V) stages
  static constexpr size_t KP_OFF = KV_OFF + 4 * TILE * 2;
  static constexpr size_t MEAN_OFF = KP_OFF + 2 * BK * 4;
  static constexpr size_t CLS_OFF = MEAN_OFF + (PF_THREADS / 32) * D * 4;
  static constexpr size_t smem(int nT) { return CLS_OFF + nT; }
};

// issue the cp.async copies of key tile t (rows past Sk zero) into one
// stage, and its key positions (past Sk: -1) with plain stores
template <int D>
__device__ __forceinline__ void load_kv(const Args& a, __nv_bfloat16* Ks,
                                        __nv_bfloat16* Vs, int* kps,
                                        const __nv_bfloat16* k,
                                        const __nv_bfloat16* v, int t) {
  constexpr int LD = PFB<D>::LD, CPR = D / 8;
  const int k0 = t * BK;
  for (int i = threadIdx.x; i < BK * CPR; i += PF_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = k0 + r < a.Sk;
    const long long j = ok ? k0 + r : 0;
    cp_async16(Ks + r * LD + c, k + j * a.ks[2] + c, ok);
    cp_async16(Vs + r * LD + c, v + j * a.vs[2] + c, ok);
  }
  if (threadIdx.x < BK)
    kps[threadIdx.x] =
        k0 + (int)threadIdx.x < a.Sk ? a.kpos[k0 + threadIdx.x] : -1;
}

template <int D>
__global__ void __launch_bounds__(PF_THREADS, D <= 64 ? 2 : 1)
    prefill_bf16_kernel(Args a) {
  using L = PFB<D>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD, MT = L::MT, BQ = L::BQ;
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

  for (int i = tid; i < BQ * (D / 8); i += PF_THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
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
  if (t < nT) load_kv<D>(a, KV, KV + L::TILE, KP, k, v, t);
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
  float acc[MT][D / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    m[i][0] = m[i][1] = NEG;
    l[i][0] = l[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  }
  uint32_t qf[MT][D / 16][4];
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
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[i][kk], Qs + (r0 + 16 * i + (lane & 15)) * LD +
                                 kk * 16 + (lane >> 4) * 8);
      have_q = true;
    }
    const int tn = next_tile(cls, t + 1, nT);
    if (tn < nT) {
      bf16* nk = KV + (stage ^ 1) * 2 * L::TILE;
      load_kv<D>(a, nk, nk + L::TILE, KP + (stage ^ 1) * BK, k, v, tn);
    }
    cp_async_commit();
    const bf16* Ks = KV + stage * 2 * L::TILE;
    const bf16* Vs = Ks + L::TILE;
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
    for (int kk = 0; kk < D / 16; ++kk) {
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
        for (int j = 0; j < D / 8; ++j) {
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
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, Vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                LD + dp * 16 + (lane >> 4) * 8);
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
  float* mean = reinterpret_cast<float*>(smem + L::MEAN_OFF) + warp * D;
  if (__any_sync(FULL, any_dead)) warp_mean_v<bf16, D>(v, a.vs[2], a.Sk,
                                                       mean);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 16 * i + g + 8 * hf;
      if (r >= nq) continue;
      const float inv = dead[i][hf] ? 0.f : 1.f / l[i][hf];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
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
template <int D> struct PFF {
  // odd row strides (words): lanes reading one column of 32 rows hit 32
  // banks
  static constexpr int LD = D + 1;     // Q, K, V tiles
  static constexpr int LDS = BK + 4;   // scores, then probabilities
  static constexpr int LDO = D + 4;    // accumulator
  static constexpr size_t al(size_t b) { return (b + 127) / 128 * 128; }
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + al(BQ * LD * 4);
  static constexpr size_t V_OFF = K_OFF + al(BK * LD * 4);
  static constexpr size_t S_OFF = V_OFF + al(BK * LD * 4);
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

template <int D>
__global__ void __launch_bounds__(PF_THREADS) prefill_f32_kernel(Args a) {
  using L = PFF<D>;
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

  load_tile_f32<D, L::LD>(Qs, q + q0 * a.qs[2], a.qs[2], nq, BQ);
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
    load_tile_f32<D, L::LD>(Ks, k + k0 * a.ks[2], a.ks[2], nk, BK);
    load_tile_f32<D, L::LD>(Vs, v + k0 * a.vs[2], a.vs[2], nk, BK);
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
    for (int rr = 0; rr < 16; ++rr) {
      const float* qrow = Qs + (r0 + rr) * L::LD;
      for (int c = lane; c < BK; c += 32) {
        const float* krow = Ks + c * L::LD;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc += qrow[d] * krow[d];
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
      for (int d = lane; d < D; d += 32) {
        float acc = 0.f;
#pragma unroll 16
        for (int j = 0; j < BK; ++j) acc += prow[j] * Vs[j * L::LD + d];
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
  if (dead) warp_mean_v<float, D>(v, a.vs[2], a.Sk, mean);
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    if (r >= nq) break;
    const float l = lrow[r];
    for (int d = lane; d < D; d += 32)
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

template <typename T, int D>
int launch(const Args& a, cudaStream_t st) {
  if (a.Sq == 1) {
    if (a.ws == nullptr || a.counters == nullptr || a.splits < 1 ||
        a.splits > MAX_SPLITS)
      return (int)cudaErrorInvalidValue;
    decode_kernel<T, D><<<dim3(a.splits, a.Hkv, a.B), DEC_THREADS, 0, st>>>(
        a);
    return (int)cudaGetLastError();
  }
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(a.H, (a.Sq + BQ - 1) / BQ, a.B);
    const size_t smem = PFF<D>::smem((a.Sk + BK - 1) / BK);
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    prefill_f32_kernel<D><<<grid, PF_THREADS, smem, st>>>(a);
  } else {
    const dim3 grid(a.H, (a.Sq + PFB<D>::BQ - 1) / PFB<D>::BQ, a.B);
    const size_t smem = PFB<D>::smem((a.Sk + BK - 1) / BK);
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    prefill_bf16_kernel<D><<<grid, PF_THREADS, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// backward (the port's own: the JAX package differentiates its XLA
// attention and has no backward kernel).  FlashAttention-2's split, three
// kernels in one call, no atomics (the gradients do not depend on the
// order in which blocks run):
// 1. pre: a block per (query head, request) computes each row's
//    D_i = sum_d dO_i * O_i (float32) and whether the head has a row that
//    saw no key (its LSE is -inf);
// 2. dQ: a block per (query head, 64 query rows, request), as the forward,
//    walks the visible key tiles: S = Q K^T, P = exp(scale S - LSE),
//    dP = dO V^T, dS = P (dP - D), dQ += dS K; dQ = scale dQ;
// 3. dK, dV: a block per (64 keys, kv head, request) walks every query
//    head mapped to its kv head (the head table's grouped list, so GQA and
//    padded heads sum inside the block) and their visible query tiles:
//    S^T = K Q^T, P^T, dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - D),
//    dK += dS^T Q; dK = scale dK.
// A row that saw no key got the mean of v over all Sk keys: its gradient
// is dO / Sk for every key's v and 0 for q and k (P = 1 / Sk, dS = 0).
// bf16: every product on mma.sync m16n8k16 with P and dS rounded to bf16
// as A operands (as the forward rounds P), operands by ldmatrix from
// shared rows padded by 16 bytes; no operand is kept in registers between
// tiles.  float32: plain FMAs through shared memory (not on the timed
// path).  What bounds it: operations, five products of the forward's size
// (seven here: dQ recomputes S and dP) against the bytes of q, k, v, o, dO
// and the three gradients.  Tiles are loaded and then computed, one
// barrier a step, with no overlap: a simple kernel first.
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
  float* drow;                            // (B, H, Sq): D_i
  int* dead;                              // (B, H): a row saw no key
  int B, H, Hkv, Sq, Sk;
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  float scale;
  int causal, window;
};

constexpr int PRE_THREADS = 256;

template <typename T, int D>
__global__ void __launch_bounds__(PRE_THREADS) bwd_pre_kernel(BArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int LPR = D / VEC;            // lanes a row (2 to 32)
  constexpr int RPW = 32 / LPR;           // rows a warp step
  constexpr int WARPS = PRE_THREADS / 32;
  using P = Pack<T, VEC>;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane / LPR, c = (lane % LPR) * VEC;
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + h * a.os[1];
  const T* dO = static_cast<const T*>(a.dO) + b * a.dos[0] + h * a.dos[1];
  const long long bh = ((long long)b * a.H + h) * a.Sq;
  int dead = 0;
  for (int i0 = warp * RPW; i0 < a.Sq; i0 += WARPS * RPW) {
    const int i = i0 + row;
    float s = 0.f;
    if (i < a.Sq) {
      const P x = *reinterpret_cast<const P*>(o + i * a.os[2] + c);
      const P y = *reinterpret_cast<const P*>(dO + i * a.dos[2] + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += to_f(x.v[e]) * to_f(y.v[e]);
    }
#pragma unroll
    for (int x = 1; x < LPR; x <<= 1) s += __shfl_xor_sync(FULL, s, x);
    if (i < a.Sq && lane % LPR == 0) {
      a.drow[bh + i] = s;
      dead |= a.lse[bh + i] == -INFINITY;
    }
  }
  dead = __syncthreads_or(dead);
  if (threadIdx.x == 0) a.dead[b * a.H + h] = dead;
}

// min and max of the valid (>= 0) positions pos[0, n) of a tile of `tile`
// rows (n <= tile <= 64), and whether any is missing (< 0 or past n);
// every lane of the warp gets the result
__device__ __forceinline__ void pos_range(const int* pos, int n, int tile,
                                          int& lo, int& hi, bool& empty) {
  const int lane = threadIdx.x & 31;
  lo = INT32_MAX;
  hi = -1;
  bool miss = n < tile;
  for (int i = lane; i < n; i += 32) {
    const int p = pos[i];
    if (p < 0) {
      miss = true;
    } else {
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
  lo = warp_min_i(lo);
  hi = warp_max_i(hi);
  empty = __any_sync(FULL, miss);
}

// ---- dQ, bfloat16 ----------------------------------------------------------
template <int D> struct BQL {
  static constexpr int BQ = 64;                  // query rows: 4 warps x 16
  static constexpr int BKT = D <= 64 ? 64 : 32;  // keys a tile
  static constexpr int LD = D + 8;
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t DO_OFF = Q_OFF + BQ * LD * 2;
  static constexpr size_t K_OFF = DO_OFF + BQ * LD * 2;
  static constexpr size_t V_OFF = K_OFF + BKT * LD * 2;
  static constexpr size_t KP_OFF = V_OFF + BKT * LD * 2;
  static constexpr size_t CLS_OFF = KP_OFF + BKT * 4;
  static constexpr size_t smem(int nT) { return CLS_OFF + nT; }
};

// rows [0, rows) of a (rows, D) bf16 tile from src (row stride `stride`)
// into shared memory (row stride LD); rows at or past `valid` are zero
template <int D, int LD>
__device__ __forceinline__ void tile_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int valid,
                                           int rows) {
  constexpr int CPR = D / 8;
  for (int i = threadIdx.x; i < rows * CPR; i += PF_THREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, src + (long long)(ok ? r : 0) * stride + c,
               ok);
  }
}

// C (16 x 8 n-tiles x N) += A (16 rows of a row-major shared tile at row
// r0, K = KD columns) * B^T, B a row-major shared tile (n rows, KD cols):
// the S = Q K^T pattern
template <int KD, int N, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[N / 8][4],
                                        const __nv_bfloat16* A, int r0,
                                        const __nv_bfloat16* Bm) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, A + (r0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bfr[4];
      ldsm_x4(bfr, Bm + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                       kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(c[2 * np], af, bfr[0], bfr[1]);
      mma16816(c[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// C (16 x D) += A (16 x K, accumulator layout in registers, rounded to
// bf16) * B, B a row-major shared tile (K rows, D cols): the O += P V
// pattern
template <int K, int D, int LD>
__device__ __forceinline__ void mma_pb(float (&c)[D / 8][4],
                                       const float (&p)[K / 8][4],
                                       const __nv_bfloat16* Bm) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bfr[4];
      ldsm_x4_t(bfr, Bm + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              LD + dp * 16 + (lane >> 4) * 8);
      mma16816(c[2 * dp], pa, bfr[0], bfr[1]);
      mma16816(c[2 * dp + 1], pa, bfr[2], bfr[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

template <int D>
__global__ void __launch_bounds__(PF_THREADS) bwd_dq_bf16_kernel(BArgs a) {
  using L = BQL<D>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD, BQ = L::BQ, BKT = L::BKT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  int* KP = reinterpret_cast<int*>(smem + L::KP_OFF);
  unsigned char* cls = smem + L::CLS_OFF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int h = blockIdx.x, q0 = blockIdx.y * BQ, b = blockIdx.z;
  const int hk = a.kv_head[h];
  const int nq = min(BQ, a.Sq - q0);
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const bf16* dO =
      static_cast<const bf16*>(a.dO) + b * a.dos[0] + h * a.dos[1];
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  bf16* dq = static_cast<bf16*>(a.dq) + b * a.dqs[0] + h * a.dqs[1];
  const long long bh = ((long long)b * a.H + h) * a.Sq;

  tile_async<D, LD>(Qs, q + q0 * a.qs[2], a.qs[2], nq, BQ);
  tile_async<D, LD>(dOs, dO + q0 * a.dos[2], a.dos[2], nq, BQ);
  cp_async_commit();
  int qlo, qhi;
  q_range(a, q0, nq, qlo, qhi);
  const int nT = (a.Sk + BKT - 1) / BKT;
  classify_tiles<BKT>(a, nT, qlo, qhi, cls);
  __syncthreads();                        // cls is written

  const int r0 = warp * 16;
  int qp[2];
  float lse2[2], dr[2];
  bool dead[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + min(r0 + g + 8 * hf, nq - 1);
    qp[hf] = a.qpos[r];
    const float l = a.lse[bh + r];
    dead[hf] = l == -INFINITY;
    lse2[hf] = dead[hf] ? 0.f : l * LOG2E;
    dr[hf] = a.drow[bh + r];
  }
  const float sl2 = a.scale * LOG2E;
  float acc[D / 8][4];
  zero<D / 8>(acc);

  for (int t = next_tile(cls, 0, nT); t < nT; t = next_tile(cls, t + 1, nT)) {
    const int k0 = t * BKT, nk = min(BKT, a.Sk - k0);
    __syncthreads();                      // the last tile is consumed
    tile_async<D, LD>(Ks, k + k0 * a.ks[2], a.ks[2], nk, BKT);
    tile_async<D, LD>(Vs, v + k0 * a.vs[2], a.vs[2], nk, BKT);
    if (tid < BKT) KP[tid] = tid < nk ? a.kpos[k0 + tid] : -1;
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    const bool full = cls[t] == 2;
    float s[BKT / 8][4], dp[BKT / 8][4];
    zero<BKT / 8>(s);
    zero<BKT / 8>(dp);
    mma_abt<D, BKT, LD>(s, Qs, r0, Ks);
    mma_abt<D, BKT, LD>(dp, dOs, r0, Vs);
#pragma unroll
    for (int j = 0; j < BKT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        const bool vis = !dead[hf] &&
            (full || sees(KP[j * 8 + 2 * tq + (e & 1)], qp[hf], a.causal,
                          a.window));
        const float p = vis ? ex2(fmaf(s[j][e], sl2, -lse2[hf])) : 0.f;
        s[j][e] = p * (dp[j][e] - dr[hf]);          // dS
      }
    mma_pb<BKT, D, LD>(acc, s, Ks);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dq + (q0 + r) * a.dqs[2] + c) =
          __floats2bfloat162_rn(acc[j][2 * hf] * a.scale,
                                acc[j][2 * hf + 1] * a.scale);
    }
  }
}

// ---- dK, dV, bfloat16 -----------------------------------------------------
template <int D> struct BKL {
  static constexpr int BKT = 64;                 // keys: 4 warps x 16
  static constexpr int BQT = D <= 64 ? 64 : 32;  // queries a tile
  static constexpr int LD = D + 8;
  static constexpr size_t K_OFF = 0;
  static constexpr size_t V_OFF = K_OFF + BKT * LD * 2;
  static constexpr size_t Q_OFF = V_OFF + BKT * LD * 2;
  static constexpr size_t DO_OFF = Q_OFF + BQT * LD * 2;
  static constexpr size_t QP_OFF = DO_OFF + BQT * LD * 2;
  static constexpr size_t LSE_OFF = QP_OFF + BQT * 4;
  static constexpr size_t DR_OFF = LSE_OFF + BQT * 4;
  static constexpr size_t SMEM = DR_OFF + BQT * 4;
};

template <int D>
__global__ void __launch_bounds__(PF_THREADS) bwd_dkdv_bf16_kernel(BArgs a) {
  using L = BKL<D>;
  using bf16 = __nv_bfloat16;
  constexpr int LD = L::LD, BKT = L::BKT, BQT = L::BQT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K_OFF);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V_OFF);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q_OFF);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::DO_OFF);
  int* QP = reinterpret_cast<int*>(smem + L::QP_OFF);
  float* LS = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* DR = reinterpret_cast<float*>(smem + L::DR_OFF);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BKT, nk = min(BKT, a.Sk - k0);
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  tile_async<D, LD>(Ks, k + k0 * a.ks[2], a.ks[2], nk, BKT);
  tile_async<D, LD>(Vs, v + k0 * a.vs[2], a.vs[2], nk, BKT);
  cp_async_commit();
  int klo, khi;
  bool kempty;
  pos_range(a.kpos + k0, nk, BKT, klo, khi, kempty);
  const int r0 = warp * 16;
  int kp[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    kp[hf] = r < nk ? a.kpos[k0 + r] : -1;
  }
  const float sl2 = a.scale * LOG2E, inv_sk = 1.f / (float)a.Sk;
  const int* order = a.kv_head + a.H;
  const int off = order[a.H + hk], G = order[a.H + hk + 1] - off;
  float dk[D / 8][4], dv[D / 8][4];
  zero<D / 8>(dk);
  zero<D / 8>(dv);

  for (int gi = 0; gi < G; ++gi) {
    const int h = order[off + gi];
    const bool any_dead = a.dead[b * a.H + h] != 0;
    const bf16* q = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const bf16* dO =
        static_cast<const bf16*>(a.dO) + b * a.dos[0] + h * a.dos[1];
    const long long bh = ((long long)b * a.H + h) * a.Sq;
    for (int q0 = 0; q0 < a.Sq; q0 += BQT) {
      const int nq = min(BQT, a.Sq - q0);
      int qlo, qhi;
      bool qempty;
      pos_range(a.qpos + q0, nq, nq, qlo, qhi, qempty);
      const bool vis = khi >= 0 && (!a.causal || klo <= qhi) &&
                       (a.window <= 0 || khi > qlo - a.window);
      if (!vis && !any_dead) continue;    // the same in every warp
      const bool full = !any_dead && !kempty &&
                        (!a.causal || khi <= qlo) &&
                        (a.window <= 0 || klo > qhi - a.window);
      __syncthreads();                    // the last tile is consumed
      tile_async<D, LD>(Qs, q + q0 * a.qs[2], a.qs[2], nq, BQT);
      tile_async<D, LD>(dOs, dO + q0 * a.dos[2], a.dos[2], nq, BQT);
      cp_async_commit();
      if (tid < BQT) {
        // a padding row: LSE +inf gives P = 0 (and it is not "dead")
        QP[tid] = a.qpos[q0 + min(tid, nq - 1)];
        LS[tid] = tid < nq ? a.lse[bh + q0 + tid] : INFINITY;
        DR[tid] = tid < nq ? a.drow[bh + q0 + tid] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      // S^T = K Q^T, then P^T, for this warp's 16 keys
      float st[BQT / 8][4];
      zero<BQT / 8>(st);
      mma_abt<D, BQT, LD>(st, Ks, r0, Qs);
#pragma unroll
      for (int j = 0; j < BQT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * tq + (e & 1);
          const float l = LS[qi];
          float p;
          if (l == -INFINITY)
            p = inv_sk;                   // saw no key: the mean of v
          else if (full || sees(kp[e >> 1], QP[qi], a.causal, a.window))
            p = ex2(fmaf(st[j][e], sl2, -l * LOG2E));
          else
            p = 0.f;
          st[j][e] = p;
        }
      mma_pb<BQT, D, LD>(dv, st, dOs);    // dV += P^T dO
      float dpt[BQT / 8][4];
      zero<BQT / 8>(dpt);
      mma_abt<D, BQT, LD>(dpt, Vs, r0, dOs);   // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < BQT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = j * 8 + 2 * tq + (e & 1);
          dpt[j][e] = LS[qi] == -INFINITY
                          ? 0.f
                          : st[j][e] * (dpt[j][e] - DR[qi]);   // dS^T
        }
      mma_pb<BQT, D, LD>(dk, dpt, Qs);    // dK += dS^T Q
    }
  }
  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= nk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = j * 8 + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dkp + (k0 + r) * a.dks[2] + c) =
          __floats2bfloat162_rn(dk[j][2 * hf] * a.scale,
                                dk[j][2 * hf + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (k0 + r) * a.dvs[2] + c) =
          __floats2bfloat162_rn(dv[j][2 * hf], dv[j][2 * hf + 1]);
    }
  }
}

// ---- float32: plain FMAs through shared memory -----------------------------
constexpr int FB = 32;                   // query rows and keys a tile

template <int D> struct BFL {
  static constexpr int LD = D + 1;       // odd row strides (words)
  static constexpr int LDS = FB + 1;
  static constexpr size_t al(size_t b) { return (b + 127) / 128 * 128; }
  static constexpr size_t T_BYTES = al(FB * LD * 4);
  // four (FB, D) tiles (Q, dO, K, V), two accumulators, two (FB, FB)
  static constexpr size_t A_OFF = 4 * T_BYTES;
  static constexpr size_t S_OFF = A_OFF + 2 * T_BYTES;
  static constexpr size_t I_OFF = S_OFF + 2 * al(FB * LDS * 4);
  static constexpr size_t SMEM = I_OFF + 4 * FB * 4;
};

template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* src,
                                         long long stride, int valid) {
  for (int i = threadIdx.x; i < FB * D; i += PF_THREADS) {
    const int r = i / D, c = i % D;
    dst[r * BFL<D>::LD + c] = r < valid ? src[r * stride + c] : 0.f;
  }
}

// dQ: a block per (query head, FB query rows, request)
template <int D>
__global__ void __launch_bounds__(PF_THREADS) bwd_dq_f32_kernel(BArgs a) {
  using L = BFL<D>;
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
  load_f32<D>(Qs, q + q0 * a.qs[2], a.qs[2], nq);
  load_f32<D>(dOs, dO + q0 * a.dos[2], a.dos[2], nq);
  for (int i = tid; i < FB * LD; i += PF_THREADS) Acc[i] = 0.f;
  if (tid < FB) {
    QP[tid] = a.qpos[q0 + min(tid, nq - 1)];
    LS[tid] = tid < nq ? a.lse[bh + q0 + tid] : -INFINITY;
    DR[tid] = tid < nq ? a.drow[bh + q0 + tid] : 0.f;
  }
  for (int k0 = 0; k0 < a.Sk; k0 += FB) {
    const int nk = min(FB, a.Sk - k0);
    __syncthreads();                      // the last tile is consumed
    load_f32<D>(Ks, k + k0 * a.ks[2], a.ks[2], nk);
    load_f32<D>(Vs, v + k0 * a.vs[2], a.vs[2], nk);
    if (tid < FB) KP[tid] = tid < nk ? a.kpos[k0 + tid] : -1;
    __syncthreads();
    for (int idx = tid; idx < FB * FB; idx += PF_THREADS) {
      const int i = idx / FB, j = idx % FB;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s += Qs[i * LD + d] * Ks[j * LD + d];
        dp += dOs[i * LD + d] * Vs[j * LD + d];
      }
      const bool vis = LS[i] != -INFINITY &&
                       sees(KP[j], QP[i], a.causal, a.window);
      const float p = vis ? expf(s * a.scale - LS[i]) : 0.f;
      dS[i * LDS + j] = p * (dp - DR[i]);
    }
    __syncthreads();
    for (int idx = tid; idx < FB * D; idx += PF_THREADS) {
      const int i = idx / D, d = idx % D;
      float s = 0.f;
      for (int j = 0; j < FB; ++j) s += dS[i * LDS + j] * Ks[j * LD + d];
      Acc[i * LD + d] += s;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < nq * D; idx += PF_THREADS) {
    const int i = idx / D, d = idx % D;
    dq[(q0 + i) * a.dqs[2] + d] = Acc[i * LD + d] * a.scale;
  }
}

// dK, dV: a block per (FB keys, kv head, request)
template <int D>
__global__ void __launch_bounds__(PF_THREADS) bwd_dkdv_f32_kernel(BArgs a) {
  using L = BFL<D>;
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
  load_f32<D>(Ks, k + k0 * a.ks[2], a.ks[2], nk);
  load_f32<D>(Vs, v + k0 * a.vs[2], a.vs[2], nk);
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
      load_f32<D>(Qs, q + q0 * a.qs[2], a.qs[2], nq);
      load_f32<D>(dOs, dO + q0 * a.dos[2], a.dos[2], nq);
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
          for (int d = 0; d < D; ++d) {
            s += Qs[i * LD + d] * Ks[j * LD + d];
            dp += dOs[i * LD + d] * Vs[j * LD + d];
          }
          p = expf(s * a.scale - l);
          ds = p * (dp - DR[i]);
        }
        Ps[i * LDS + j] = p;
        dS[i * LDS + j] = ds;
      }
      __syncthreads();
      for (int idx = tid; idx < FB * D; idx += PF_THREADS) {
        const int j = idx / D, d = idx % D;
        float sv = 0.f, sk = 0.f;
        for (int i = 0; i < FB; ++i) {
          sv += Ps[i * LDS + j] * dOs[i * LD + d];
          sk += dS[i * LDS + j] * Qs[i * LD + d];
        }
        dV[j * LD + d] += sv;
        dK[j * LD + d] += sk;
      }
    }
  }
  __syncthreads();
  float* dkp = static_cast<float*>(a.dk) + b * a.dks[0] + hk * a.dks[1];
  float* dvp = static_cast<float*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1];
  for (int idx = tid; idx < nk * D; idx += PF_THREADS) {
    const int j = idx / D, d = idx % D;
    dkp[(k0 + j) * a.dks[2] + d] = dK[j * LD + d] * a.scale;
    dvp[(k0 + j) * a.dvs[2] + d] = dV[j * LD + d];
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch_bwd(const BArgs& a, cudaStream_t st) {
  bwd_pre_kernel<T, D><<<dim3(a.H, a.B), PRE_THREADS, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int err;
  if constexpr (std::is_same<T, float>::value) {
    using L = BFL<D>;
    if ((err = set_smem(bwd_dq_f32_kernel<D>, L::SMEM))) return err;
    bwd_dq_f32_kernel<D><<<dim3(a.H, (a.Sq + FB - 1) / FB, a.B), PF_THREADS,
                           L::SMEM, st>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = set_smem(bwd_dkdv_f32_kernel<D>, L::SMEM))) return err;
    bwd_dkdv_f32_kernel<D><<<dim3((a.Sk + FB - 1) / FB, a.Hkv, a.B),
                             PF_THREADS, L::SMEM, st>>>(a);
  } else {
    using LQ = BQL<D>;
    using LK = BKL<D>;
    const size_t sq = LQ::smem((a.Sk + LQ::BKT - 1) / LQ::BKT);
    if ((err = set_smem(bwd_dq_bf16_kernel<D>, sq))) return err;
    bwd_dq_bf16_kernel<D><<<dim3(a.H, (a.Sq + LQ::BQ - 1) / LQ::BQ, a.B),
                            PF_THREADS, sq, st>>>(a);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = set_smem(bwd_dkdv_bf16_kernel<D>, LK::SMEM))) return err;
    bwd_dkdv_bf16_kernel<D><<<dim3((a.Sk + LK::BKT - 1) / LK::BKT, a.Hkv,
                                   a.B),
                              PF_THREADS, LK::SMEM, st>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_d(const BArgs& a, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(a, st);
    case 32: return launch_bwd<T, 32>(a, st);
    case 64: return launch_bwd<T, 64>(a, st);
    case 128: return launch_bwd<T, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements, in the order (batch, head, position) for q, k,
// v and o; the last axis is contiguous.  kv_head: int32, the (H,) map of
// query heads to kv heads in [0, Hkv), then the H query heads ordered by
// kv head, then the Hkv + 1 offsets of each kv head's run in that order.
// dtype 0 = float32, 1 = bfloat16.  Sq == 1 runs the decode
// configuration, any other Sq the prefill one; decode splits the slots
// over `splits` blocks per (request, kv head) and needs `ws`, float32 of
// B * H * splits * (D + 2), and `counters`, int32 of B * Hkv, zero before
// the first call (each call leaves them zero).  Prefill ignores all three.
// lse: NULL, or for prefill float32 (B, H, Sq), each row's log-sum-exp of
// its scaled visible scores (-inf where it sees no key) for the backward;
// decode ignores it.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* qpos,
    const void* kpos, const void* kv_head, void* ws, void* counters,
    void* lse, int B, int H, int Hkv, int Sq, int Sk, int D, int splits,
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
  if (dtype == 0) return launch_d<float>(a, D, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, D, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of prefill: dq, dk, dv (shaped and typed as q, k, v) from
// dO (as o), the forward's o and lse ((B, H, Sq) float32) and the same
// positions, head table, scale and masks.  Strides in elements, (batch,
// head, position), last axis contiguous, for q, k, v, o, dO, dq, dk, dv.
// Scratch: drow float32 (B, H, Sq), dead int32 (B, H), both written
// before they are read.  Three kernels on the stream (see above); every
// gradient element is written once, no atomics.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, const void* qpos, const void* kpos,
    const void* kv_head, void* dq, void* dk, void* dv, void* drow,
    void* dead, int B, int H, int Hkv, int Sq, int Sk, int D,
    const long long* strides, float scale, int causal, int window, int dtype,
    void* stream) {
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
  a.drow = (float*)drow;
  a.dead = (int*)dead;
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
  if (dtype == 0) return launch_bwd_d<float>(a, D, st);
  if (dtype == 1) return launch_bwd_d<__nv_bfloat16>(a, D, st);
  return (int)cudaErrorInvalidValue;
}
