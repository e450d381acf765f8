// ssd: the chunked Mamba-2 SSD scan (state-space duality), on the tensor
// cores.
//
// Replaces: src/repro/kernels/mamba2_ssd/kernel.py, _ssd_kernel (:22) and
// its wrapper ssd_pallas (:75).  Same function, per row bh of (BH, S):
// within a chunk of Q tokens, with cs = cumsum(logd) over the chunk,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j
//         + exp(cs_i) (C_i . h)                       (h: carried (P, N))
//   h'  = h exp(cs_last) + sum_j exp(cs_last - cs_j) xdt_j (x) B_j
// and returns y (without the D skip) and the final state, and, when asked
// (training), the state at the start of every 64-token tile, which the
// backward below reads instead of recomputing it.  All float32.
// B and C may be shared by `heads` consecutive rows (Mamba-2's ngroups =
// 1): row bh reads B and C row bh / heads.  The chunked form is exact for
// any chunk length, so a chunk longer than 64 tokens runs as chunks of 64
// (the tile below); only the order of the float sums changes.
//
// What bounds it on the H100: bytes.  At Hymba's prefill shapes (400 rows
// x 2,048 tokens, P = 64, N = 16) it must read xdt and write y, 0.42 GB,
// 0.127 ms at 3.35 TB/s; the products are ~7 Gflop at 64-token chunks, and
// three TF32 products each (below) still take under 0.05 ms at 495
// TFLOP/s.  The earlier design ran them as scalar float32 FMAs with two or
// three shared-memory loads each, 17x over the bound.
//
// What the design does about it.
// - Every product runs on mma.sync.m16n8k8 TF32 with float32 accumulation:
//   S = C B^T (k over N), Y += (S * L) X (k over the keys), the state's
//   part Y += C h^T (k over N), and the state update h += (X * dec)^T B
//   (k over the keys).  TF32 keeps 10 mantissa bits, too few for the
//   float32 tolerances, so each operand is split, a = big + small with
//   big = tf32(a) and small = tf32(a - big), and each product is
//   big.big + big.small + small.big (3xTF32): the dropped small.small term
//   is ~2^-22 relative.
// - The decay mask lives in registers: L = exp2(R_i - R_j) (one
//   subtraction and one MUFU ex2 an element, 0 above the
//   diagonal, tested only on diagonal tiles), where R is the sum of logd
//   (log2 units) from the first row of j's 8-key tile: a difference of two
//   prefix sums from the chunk's start lost ~ulp(|cs|) of the exponent,
//   1e-5 relative after strong decay, past the 1e-4 tolerance where
//   terms cancel; likewise the state's weights exp(cs_last - cs_j) come
//   from a suffix scan.  The masked S accumulator is then the A fragment
//   of the next product with no shuffle: the key axis of that product is
//   permuted so that logical column q holds key 2q and column q+4 key
//   2q+1, which is where the accumulator layout of m16n8 already holds
//   them (the same permutation is applied to X's rows).  Tiles above the
//   diagonal are skipped.
// - Loads: each 64-token chunk's X (64 x PB), B, C (64 x N) and logd come
//   once, by cp.async: X, B and logd into a two-stage ring, the next
//   chunk landing while this one computes, and C into one buffer, loaded
//   once the outputs are done with it, behind the state update (which
//   does not read C).  At Hymba's shapes a block then takes 57,088 bytes
//   and 4 blocks fit an SM (at most 128 registers a thread): the 400 rows
//   of a prefill all run at once, where with 3 an SM (396 at a time) the
//   last 4 rows ran as a second wave alone, which in a trial run on the
//   H100 made 400 rows far slower than 396.  A block whose two stages
//   would not fit shared memory (N above ~200) runs with one.  Rows of X,
//   B and C are padded by 4 words, so every fragment load of the products
//   hits 32 distinct banks (the state's rows are not: its loads are few).
// - One block of 4 warps per (row, block of PB <= 64 state rows p): the
//   state (PB x N) stays in shared memory across the chunks.  The warps
//   split the outputs into two column halves x two sets of query m-tiles,
//   {0, 3} and {1, 2}: each warp then sees 10 of the 20 key tiles on or
//   below the diagonal.  The two column halves each compute S themselves
//   (cheaper than a shared-memory round trip at N = 16).  Up to N = 32 a
//   warp keeps its m-tile's C fragments, split, in registers for S and
//   the state's part; in the state update one A fragment of (X * dec)
//   serves up to four n-tiles of N.  Both helped at Hymba's shapes in a
//   trial run on the H100.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;            // tokens a chunk tile
constexpr int THREADS = 128;      // 4 warps
constexpr float LOG2E = 1.4426950408889634f;
constexpr int LDR = TQ / 8;       // row of R: one sum a key tile
constexpr long long SMEM_LIMIT = 232448;  // shared memory a block (H100)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, zero-filled past `bytes` (0..16)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}
// 4 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
// a = big + small, both TF32
__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(a);
  small = to_tf32(a - __uint_as_float(big));
}
// c (16x8) += a (16x8, row) * b (8x8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The A operand of one m16n8k8 product, split.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};
// c += a * b in 3xTF32: the three products summed from zero on the
// tensor cores (the small terms first), then added to c by ordinary
// float32 adds, rounded to nearest, so the running sums (the state above
// all) never pass through the tensor cores' own accumulation.  (Three
// separate accumulators, to issue the products back to back, were
// slower in a trial run on the H100, with register spills.)
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.lo, bh0, bh1);
  mma_tf32(t, a.hi, bl0, bl1);
  mma_tf32(t, a.hi, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// 2^x by the MUFU unit (relative error ~2^-22), denormal results flushed
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int KC = 4;   // k-steps of C kept in registers (N <= 32)

// body(a, kb) for each 8-wide k-step kb of C's rows i0, i1 over N: the
// fragments from registers (`ca`, loaded once an m-tile) when CACHED,
// else loaded and split from shared memory each time
template <bool CACHED, typename F>
__device__ __forceinline__ void over_c(const FragA (&ca)[KC], const float* Cs,
                                       int LDN, int N8, int i0, int i1, int q,
                                       F&& body) {
  if constexpr (CACHED) {
#pragma unroll
    for (int u = 0; u < KC; ++u)
      if (8 * u < N8) body(ca[u], 8 * u);
  } else {
    for (int kb = 0; kb < N8; kb += 8) {
      FragA a;
      a.set(Cs[i0 * LDN + kb + q], Cs[i1 * LDN + kb + q],
            Cs[i0 * LDN + kb + q + 4], Cs[i1 * LDN + kb + q + 4]);
      body(a, kb);
    }
  }
}

// Copy a TQ-row tile: `width` words a row (a multiple of 4) into rows of
// `ld` words; rows past `rows` and words past `cols` are zero.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long ld_src, int rows, int cols,
                                          int width, bool vec) {
  if (vec) {
    const int per = width >> 2;
    for (int e = threadIdx.x; e < TQ * per; e += THREADS) {
      const int r = e / per, c = (e - r * per) << 2;
      const int nb = r < rows ? 4 * max(0, min(cols - c, 4)) : 0;
      cp_async16(dst + r * ld + c, nb ? src + r * ld_src + c : src, nb);
    }
  } else {
    for (int e = threadIdx.x; e < TQ * width; e += THREADS) {
      const int r = e / width, c = e - r * width;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * ld + c, ok ? src + r * ld_src + c : src, ok);
    }
  }
}

// NT: n-tiles of 8 state rows p that one warp's column half holds (PB/16);
// CACHED: N <= 8 KC, C's fragments stay in registers for an m-tile;
// STATES: hst is written (serving runs the kernel without that code)
template <int NT, bool CACHED, bool STATES>
__global__ void __launch_bounds__(THREADS, CACHED ? 4 : 1)
ssd_kernel(const float* __restrict__ xdt, const float* __restrict__ logd,
           const float* __restrict__ Bv, const float* __restrict__ Cv,
           float* __restrict__ y, float* __restrict__ hfin,
           float* __restrict__ hst, int S, int P, int N, int chunk,
           int heads, int stages, int vec) {
  constexpr int PB = 16 * NT;
  extern __shared__ __align__(16) float sm[];
  const int N8 = (N + 7) & ~7, LDN = N8 + 4, LDX = PB + 4;
  const int stage_f = TQ * (LDX + LDN) + TQ;   // X, B, logd
  float* Cs = sm + stages * stage_f;     // TQ x LDN: C, one buffer
  float* hs = Cs + TQ * LDN;             // PB x N8: the carried state
  float* R = hs + PB * N8;               // TQ x LDR: sums of logd, below
  float* dec = R + TQ * LDR;             // exp(cs_last - cs_j)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const long long bh = blockIdx.x, bc = bh / heads;
  const int pb0 = blockIdx.y * PB;
  const int pcols = min(PB, P - pb0);
  const float* x = xdt + bh * S * P + pb0;
  const float* ld = logd + bh * S;
  const float* Bp = Bv + bc * S * N;
  const float* Cp = Cv + bc * S * N;
  float* yo = y + bh * S * P;
  const int Qc = min(chunk, TQ);
  const int nch = (S + Qc - 1) / Qc;

  for (int e = tid; e < PB * N8; e += THREADS) hs[e] = 0.f;

  // X, B and logd of chunk c into stage st; C into its one buffer when
  // with_c (else the caller loads it once the buffer is free)
  auto load_chunk = [&](int c, int st, bool with_c) {
    const int s0 = c * Qc, Q = min(Qc, S - s0);
    float* Xs = sm + st * stage_f;
    float* Bs = Xs + TQ * LDX;
    float* Ls = Bs + TQ * LDN;
    load_tile(Xs, LDX, x + (long long)s0 * P, P, Q, pcols, PB, vec);
    load_tile(Bs, LDN, Bp + (long long)s0 * N, N, Q, N, N8, vec);
    if (with_c) load_tile(Cs, LDN, Cp + (long long)s0 * N, N, Q, N, N8, vec);
    if (tid < TQ) cp_async4(Ls + tid, ld + s0 + (tid < Q ? tid : 0), tid < Q);
    cp_async_commit();
  };
  if (stages == 2) load_chunk(0, 0, true);

  const int ch = warp >> 1, ms = warp & 1;   // column half, m-tile set
  const int cb = ch * (PB / 2);              // first local state row p

  for (int c = 0; c < nch; ++c) {
    const int s0 = c * Qc, Q = min(Qc, S - s0);
    const int st = stages == 2 ? (c & 1) : 0;
    __syncthreads();            // chunk c - 1 is done with h and its stage
    if constexpr (STATES) {     // the state at this tile's start
      float* ho = hst + ((bh * nch + c) * P + pb0) * N;
      if ((N & 3) == 0 && (reinterpret_cast<uintptr_t>(hst) & 15) == 0) {
        for (int e = 4 * tid; e < pcols * N; e += 4 * THREADS) {
          const int p = e / N, n = e - p * N;
          *reinterpret_cast<float4*>(ho + e) =
              *reinterpret_cast<const float4*>(hs + p * N8 + n);
        }
      } else {
        for (int e = tid; e < pcols * N; e += THREADS)
          ho[e] = hs[(e / N) * N8 + e % N];
      }
    }
    if (stages == 1) {
      load_chunk(c, 0, true);
      cp_async_wait<0>();
    } else if (c + 1 < nch) {   // all but this group: C(c) and X, B(c)
      load_chunk(c + 1, (c + 1) & 1, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Xs = sm + st * stage_f;
    const float* Bs = Xs + TQ * LDX;
    const float* Ls = Bs + TQ * LDN;

    // Sums of logd (log2 units), none formed as a difference of two long
    // sums: R[i][kt] = sum over rows 8kt..i (rows a lane: 2 lane, +1),
    // one scan per key tile, two a warp; R[i][0] is the chunk's prefix.
    // The decay of a pair is exp2(R[i][kt] - R[j][kt]) for the key tile
    // kt holding j, and the state's weights take a suffix scan.
    for (int u = 0; u < 2; ++u) {
      const int kt = 2 * warp + u, r0 = 2 * lane;
      const float v0 = r0 >= 8 * kt ? Ls[r0] : 0.f;
      const float v1 = r0 + 1 >= 8 * kt ? Ls[r0 + 1] : 0.f;
      const float pair = v0 + v1;
      float sc = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, sc, o);
        if (lane >= o) sc += t;
      }
      float ex = __shfl_up_sync(0xffffffffu, sc, 1);
      ex = lane ? ex : 0.f;
      const float a0 = (ex + v0) * LOG2E, a1 = (ex + pair) * LOG2E;
      R[r0 * LDR + kt] = a0;
      R[(r0 + 1) * LDR + kt] = a1;
    }
    if (warp == 0) {            // dec_j = exp(sum of logd over rows > j)
      const float w1 = Ls[2 * lane + 1];
      float sc = Ls[2 * lane] + w1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, sc, o);
        if (lane + o < 32) sc += t;
      }
      float ex = __shfl_down_sync(0xffffffffu, sc, 1);
      ex = lane < 31 ? ex : 0.f;
      dec[2 * lane] = exp2f((ex + w1) * LOG2E);
      dec[2 * lane + 1] = exp2f(ex * LOG2E);
    }
    __syncthreads();

    // -- outputs: m-tiles ms and 3 - ms, this warp's column half
    for (int mm = 0; mm < 2; ++mm) {
      const int mt = mm == 0 ? ms : 3 - ms;
      if (16 * mt >= Q) continue;
      const int i0 = 16 * mt + g, i1 = i0 + 8;
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      FragA ca[KC];
      if constexpr (CACHED) {
#pragma unroll
        for (int u = 0; u < KC; ++u)
          if (8 * u < N8)
            ca[u].set(Cs[i0 * LDN + 8 * u + q], Cs[i1 * LDN + 8 * u + q],
                      Cs[i0 * LDN + 8 * u + q + 4],
                      Cs[i1 * LDN + 8 * u + q + 4]);
      }
      if (c > 0) {              // the state's part: C h^T, k over N
        over_c<CACHED>(ca, Cs, LDN, N8, i0, i1, q,
                       [&](const FragA& a, int kb) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float* hr = hs + (cb + 8 * nt + g) * N8 + kb + q;
            mma3(acc[nt], a, hr[0], hr[4]);
          }
        });
        const float e0 = exp2f(R[i0 * LDR]), e1 = exp2f(R[i1 * LDR]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][0] *= e0;
          acc[nt][1] *= e0;
          acc[nt][2] *= e1;
          acc[nt][3] *= e1;
        }
      }
      const int kend = min(2 * mt + 2, (Q + 7) >> 3);
      for (int kt = 0; kt < kend; ++kt) {
        float s[4] = {0.f, 0.f, 0.f, 0.f};   // S = C B^T on keys 8kt..+7
        over_c<CACHED>(ca, Cs, LDN, N8, i0, i1, q,
                       [&](const FragA& a, int kb) {
          const float* br = Bs + (8 * kt + g) * LDN + kb + q;
          mma3(s, a, br[0], br[4]);
        });
        // s[0] (i0, j0), s[1] (i0, j1), s[2] (i1, j0), s[3] (i1, j1)
        const int j0 = 8 * kt + 2 * q, j1 = j0 + 1;
        const float c0 = R[i0 * LDR + kt], c1 = R[i1 * LDR + kt];
        const float d0 = R[j0 * LDR + kt], d1 = R[j1 * LDR + kt];
        const bool diag = kt >= 2 * mt;
        s[0] *= (diag && j0 > i0) ? 0.f : ex2(c0 - d0);
        s[1] *= (diag && j1 > i0) ? 0.f : ex2(c0 - d1);
        s[2] *= (diag && j0 > i1) ? 0.f : ex2(c1 - d0);
        s[3] *= (diag && j1 > i1) ? 0.f : ex2(c1 - d1);
        FragA pa;                // keys permuted: column q <- j0, q+4 <- j1
        pa.set(s[0], s[2], s[1], s[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = cb + 8 * nt + g;
          mma3(acc[nt], pa, Xs[j0 * LDX + col], Xs[j1 * LDX + col]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int pc = cb + 8 * nt + 2 * q;   // local state row of acc[.][0]
        float* r0 = yo + (long long)(s0 + i0) * P + pb0 + pc;
        float* r1 = r0 + 8LL * P;
        if (pc + 1 < pcols && (P & 1) == 0) {
          if (i0 < Q) *reinterpret_cast<float2*>(r0) =
              make_float2(acc[nt][0], acc[nt][1]);
          if (i1 < Q) *reinterpret_cast<float2*>(r1) =
              make_float2(acc[nt][2], acc[nt][3]);
        } else {
          if (i0 < Q && pc < pcols) r0[0] = acc[nt][0];
          if (i0 < Q && pc + 1 < pcols) r0[1] = acc[nt][1];
          if (i1 < Q && pc < pcols) r1[0] = acc[nt][2];
          if (i1 < Q && pc + 1 < pcols) r1[1] = acc[nt][3];
        }
      }
    }
    __syncthreads();            // every read of the old h and of C is done
    if (stages == 2 && c + 1 < nch) {   // C(c + 1), behind the state update
      const int s1 = (c + 1) * Qc;
      load_tile(Cs, LDN, Cp + (long long)s1 * N, N, min(Qc, S - s1), N, N8,
                vec);
      cp_async_commit();
    }

    // -- state update: h = h exp(cs_last) + (X * dec)^T B, k over keys
    const float dl = exp2f(R[(TQ - 1) * LDR]);
    // warps split the m-tiles of p (wpm warps an m-tile); each takes its
    // n-tiles of N four at a time, so one A fragment serves up to four
    const int NN = N8 >> 3, ksteps = (Q + 7) >> 3;
    const int wpm = 4 / NT, mp = warp / wpm;
    const int pr0 = 16 * mp + g, pr1 = pr0 + 8;
    for (int nb = warp % wpm; nb < NN; nb += 4 * wpm) {
      float a4[4][4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int nc = 8 * (nb + wpm * v) + 2 * q;
        if (nb + wpm * v < NN) {
          a4[v][0] = hs[pr0 * N8 + nc] * dl;
          a4[v][1] = hs[pr0 * N8 + nc + 1] * dl;
          a4[v][2] = hs[pr1 * N8 + nc] * dl;
          a4[v][3] = hs[pr1 * N8 + nc + 1] * dl;
        }
      }
      for (int ks = 0; ks < ksteps; ++ks) {
        const int j0 = 8 * ks + 2 * q, j1 = j0 + 1;
        const float e0 = dec[j0], e1 = dec[j1];
        FragA a;
        a.set(e0 * Xs[j0 * LDX + pr0], e0 * Xs[j0 * LDX + pr1],
              e1 * Xs[j1 * LDX + pr0], e1 * Xs[j1 * LDX + pr1]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int nn = nb + wpm * v;
          if (nn < NN)
            mma3(a4[v], a, Bs[j0 * LDN + 8 * nn + g],
                 Bs[j1 * LDN + 8 * nn + g]);
        }
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int nc = 8 * (nb + wpm * v) + 2 * q;
        if (nb + wpm * v < NN) {
          hs[pr0 * N8 + nc] = a4[v][0];
          hs[pr0 * N8 + nc + 1] = a4[v][1];
          hs[pr1 * N8 + nc] = a4[v][2];
          hs[pr1 * N8 + nc + 1] = a4[v][3];
        }
      }
    }
  }
  __syncthreads();
  float* hf = hfin + (bh * P + pb0) * N;
  for (int e = tid; e < pcols * N; e += THREADS)
    hf[e] = hs[(e / N) * N8 + e % N];
}

template <int NT, bool CACHED, bool STATES>
int launch(const float* xdt, const float* logd, const float* B,
           const float* C, float* y, float* hfin, float* hst, int BH, int S,
           int P, int N, int chunk, int heads, int stages, int vec,
           size_t smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<NT, CACHED, STATES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int PB = 16 * NT;
  const dim3 grid(BH, (P + PB - 1) / PB);
  ssd_kernel<NT, CACHED, STATES><<<grid, THREADS, smem, stream>>>(
      xdt, logd, B, C, y, hfin, hst, S, P, N, chunk, heads, stages, vec);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block: `stages` chunk tiles (X, B,
// logd), one of C, the state, the decay sums and weights.
long long smem_bytes(int p_block, int N, int stages) {
  const long long N8 = (N + 7) & ~7, LDN = N8 + 4, LDX = p_block + 4;
  const long long stage_f = TQ * (LDX + LDN) + TQ;
  return 4 * (stages * stage_f + TQ * LDN + p_block * N8 + (LDR + 1) * TQ);
}

}  // namespace

// xdt (BH, S, P), logd (BH, S), B and C (BH / heads, S, N), y (BH, S, P),
// hfin (BH, P, N); all float32, contiguous.  hst: NULL (serving), or
// (BH, ceil(S / 64), P, N) for the state at each 64-token tile's start,
// which needs tiles of 64 tokens (chunk >= 64, or one chunk: chunk >= S).
// A block takes the widest of 64, 32 and 16 state rows not wider than P
// rounded up to 16, with two chunk tiles in the load ring where they fit
// in shared memory, else one; a state that no block holds is refused
// (cudaErrorInvalidValue).
extern "C" int ssd_fwd(const void* xdt, const void* logd, const void* B,
                       const void* C, void* y, void* hfin, void* hst, int BH,
                       int S, int P, int N, int chunk, int heads,
                       void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
  if (P <= 0 || N <= 0 || chunk <= 0 || heads <= 0 || BH % heads)
    return (int)cudaErrorInvalidValue;
  if (hst != nullptr && chunk < TQ && chunk < S)
    return (int)cudaErrorInvalidValue;
  int p_block = 0, stages = 0;
  for (int pb = 64; pb >= 16 && !p_block; pb /= 2)
    if (pb <= (P + 15) / 16 * 16)
      for (int st = 2; st >= 1 && !p_block; --st)
        if (smem_bytes(pb, N, st) <= SMEM_LIMIT) p_block = pb, stages = st;
  if (!p_block) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes(p_block, N, stages);
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = P % 4 == 0 && N % 4 == 0 && al(xdt) && al(B) && al(C);
  const float *x = (const float*)xdt, *l = (const float*)logd,
              *b = (const float*)B, *c = (const float*)C;
  float *yy = (float*)y, *h = (float*)hfin, *hs = (float*)hst;
  cudaStream_t s = (cudaStream_t)stream;
  const bool cached = ((N + 7) & ~7) <= 8 * KC;
#define SSD_LAUNCH1(NT, ST)                                                \
  return cached ? launch<NT, true, ST>(x, l, b, c, yy, h, hs, BH, S, P, N, \
                                       chunk, heads, stages, vec, smem, s) \
                : launch<NT, false, ST>(x, l, b, c, yy, h, hs, BH, S, P,   \
                                        N, chunk, heads, stages, vec,      \
                                        smem, s)
#define SSD_LAUNCH(NT)           \
  if (hs) SSD_LAUNCH1(NT, true); \
  SSD_LAUNCH1(NT, false)
  switch (p_block) {
    case 16:
      SSD_LAUNCH(1);
    case 32:
      SSD_LAUNCH(2);
    case 64:
      SSD_LAUNCH(4);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SSD_LAUNCH
#undef SSD_LAUNCH1
}


// ===========================================================================
// ssd_bwd: the gradient of the scan above, the port's own kernel (the JAX
// package differentiates its chunked algorithm, src/repro/models/
// mamba2.py:63-118, in XLA; it has no backward kernel).
//
// The function, per row with a_t = exp(logd_t) and h_t = a_t h_{t-1} +
// xdt_t (x) B_t: with g_t = dy_t (x) C_t + a_{t+1} g_{t+1} the total
// gradient of h_t (P x N; past the last token, dh_final or zero),
//   dxdt_t = g_t B_t,   dB_t = g_t^T xdt_t,   dC_t = h_t^T dy_t,
//   dlogd_t = <g_t, a_t h_{t-1}>,
// dB and dC summed over the `heads` rows that share them.
//
// The chunked form, in chunks of TQB = 64 tokens (the function is the
// same for any chunk): with h0 the state before a chunk, G the gradient of
// its last state from the tokens after it, L[i][j] = exp(logd_{j+1} + ...
// + logd_i) for j <= i, din_i = exp(logd_0 + ... + logd_i), e_j =
// exp(logd_{j+1} + ... + logd_63) and dl = e_{-1},
//   dX = M^T dY + e o (B G^T),       M = C B^T o L
//   dC = din o (dY h0) + Z B,        Z = dY X^T o L
//   dB = Z^T C + e o (X G)
//   dlogd_i = sum_{j < i <= k} W[k][j] + sum_{k >= i} u_k
//             + sum_{j < i} v_j + dl <G, h0>
//       with W = Z o C B^T, u_k = din_k <C_k, (dY h0)_k>,
//       v_j = e_j <B_j, (X G)_j>
//   G <- dl G + dY^T (din o C)   (the gradient of h0: the previous
//                                 chunk's G)
// (the products L[k][i] L[i][j] = L[k][j], L[k][i] din_i = din_k and e_i
// L[i][j] = e_j fold a_i h_{i-1} and g_i into these sums).
//
// What bounds it on the H100: bytes.  At Hymba's training shape (400 rows
// x 2,048 tokens, P = 64, N = 16) it must read xdt and dy and write dxdt,
// 210 MB each, and move logd, dlogd, B, C, dB and dC: 0.64 GB, 0.19 ms at
// 3.35 TB/s.  The products it issues, over the triangles it computes, are
// 896 m16n8k8 products a 64-token chunk and block of state rows, each as
// three TF32 products: 70.5 GFLOP a call, 0.14 ms at 495 TFLOP/s.  It
// also reads the forward's chunk-start states (52 MB) and moves each
// row's dB and dC (105 MB out and back) to be summed over the heads.
//
// Two kernels.
// 1. ssd_bwd_kernel: one block of 4 warps per (row, block of PB state rows
//    p) walks the chunks backward, carrying G in shared memory.  A chunk's
//    X, dY (64 x PB), B, C (64 x N), logd and h0 (PB x N, the forward's
//    state at the chunk's start, `hst`) come by cp.async, issued for the
//    next chunk as soon as this one's last read of them is done; the
//    chunk's dlogd is written by one warp while the next chunk's tiles
//    land.  dX is final; dlogd, dB and dC are this block's part.
// 2. ssd_bwd_reduce (only when heads > 1 or P > 64): dB and dC summed over
//    the heads and the p blocks, dlogd over the p blocks, each output by
//    one thread in a fixed order.
// No atomics anywhere: two calls give the same bits.
//
// The design, for the tensor cores and one full wave:
// - Every product runs on mma.sync.m16n8k8 TF32 in 3xTF32 (big.big +
//   big.small + small.big, the small terms first).  The split is big = a
//   rounded to TF32 by integer operations and small = a - big exactly,
//   handed to the tensor cores as it is (they read its top 19 bits):
//   three full-rate ALU operations an operand where cvt.rna takes two
//   conversions (2.00 against 2.10 ms in a trial run on the H100), ~2^-21
//   of |a| against ~2^-22.  The three products go straight into the
//   accumulator: a temporary summed from zero and then added, as the
//   forward's mma3, took 1.50 against 1.39 ms (more registers, spills).
// - Only tiles on or below the diagonal of each 64 x 64 chunk are
//   computed: of 32 m16n8 tiles of a square, 20, in pairs of 8-key tiles
//   that share their A fragments.
// - The warps split the work into two halves x two sets of 16-row tiles,
//   {0, 3} and {1, 2} (10 of the 20 triangle tiles each, as the forward).
//   Both halves compute M^T on their j tiles (j rows x i columns, k over
//   N: cheaper than sharing it) and dX on their share of the p columns.
//   Half 0 also computes Z^T (j x i, k over p), dB = Z^T C + e o (X G), W
//   and v; half 1 computes Z (i x j), dC = Z B + din o (dY h0), u and the
//   G update's products dY^T (din o C), which it writes after the chunk's
//   last read of the old G.  An accumulator is contracted only over its
//   columns, so Z is computed in both layouts rather than moved through
//   shared memory, which has no room for a 64 x 64 tile at four blocks an
//   SM.  A masked accumulator feeds the next product as its A operand
//   with no shuffle (the forward's key permutation: column 2q at k = q,
//   2q + 1 at k = q + 4, and the B operand's rows read likewise).
// - dX's columns go 2 of 8 n-tiles to half 0 and 6 to half 1, which has
//   no W to form: 1.094 ms against 1.310 for 3 and 5, 1.206 for 1 and 7
//   in a trial run.
// - Registers: four blocks an SM leave 128 a thread, and their shared
//   memory leaves ~28 KB of L1, so a spill goes to L2 and costs a key
//   tile 2-3 thousand cycles (clock counters in a trial run).  Hence no
//   8-tile arrays in registers (the key tiles go in pairs), device
//   functions rather than lambdas (which left a 152-byte stack), and N's
//   width and each warp's row tiles as template arguments, so that
//   strides and loop bounds fold (N = 16: 8 bytes of spill, from 232).
//   Unrolling the k loops, or two accumulator chains for them, spilled
//   or issued more and was slower (1.51 and 1.27 against 1.09 ms).
// - Shared memory at PB = 64, N = 16: X and dY 16 KB each, their rows
//   swizzled (word c of row r at c ^ 4 (r & 7)) rather than padded, so
//   that the fragment loads hit 32 banks; B, C, G with rows of N + 4
//   words, h0 unpadded, and 64-word vectors: 56,608 bytes, four blocks an
//   SM at 128 registers a thread (launch bounds).  The 400 blocks of
//   Hymba's shape then run as one wave on 132 SMs (528 slots); at three an
//   SM (396) the last 4 would run alone as a second wave (without spills
//   at 168 registers: 1.45 against 1.38 ms in a trial run).
// - The walk stays one block a row: in a trial run 132 rows (a block an
//   SM) took 0.75 ms and 400 rows (three or four an SM) 1.10, so the
//   blocks of an SM already share its issue slots; Mamba-2's
//   chunk-parallel form would add blocks but no issue slots, and ~0.13 ms
//   of bytes (dY read twice, the chunk states of G out and back).
// - Other widths take the same kernel: a block holds 64 state rows (a
//   narrower P padded with zeros, P > 64 in several blocks); N of 8, 16
//   or 32 keeps dB's
//   and dC's accumulators for all of N in registers, any other N runs
//   them in groups of 32 columns over the same Z tiles (N = 128: one
//   block an SM).  A state whose tiles do not fit shared memory is
//   refused.
//
// Precision (held at <= 1e-4 of each gradient's largest magnitude against
// float64 autograd): no decay is a difference of two long sums.  L's
// exponent is R[i][kt] - R[j][kt], both sums from the first row of j's
// 8-key tile (the forward's R, one warp-scan a key tile): one of the two
// has at most 8 terms, so the exponent's error is ~ulp of the exponent
// itself.  din and e are a prefix and a suffix scan.  dlogd is a sum of
// signed terms that cancel after strong decay: its pair term is formed as
// nested sums of W, each row j's suffix over the keys k >= i (a running
// sum from the right, in registers and quad shuffles), then each column
// i's sum over the rows j < i (shuffles, then the four row tiles in
// order), never as a difference of prefix sums, so its error stays
// relative to the terms' own magnitudes.
// ===========================================================================
namespace {

constexpr int TQB = 64;           // tokens a chunk of the backward (= TQ)
constexpr int BT = 128;           // threads a block: 4 warps
constexpr int BLDR = 8;           // row of the decay sums: one a key tile

// a = big + small: big rounded to TF32 (ties away from zero) by integer
// operations, small = a - big exactly, read as TF32 by the tensor cores
__device__ __forceinline__ void split2(float a, uint32_t& big,
                                       uint32_t& small) {
  const uint32_t b = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  big = b;
  small = __float_as_uint(a - __uint_as_float(b));
}
// The A operand of one m16n8k8 product, split.
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split2(a0, hi[0], lo[0]);
    split2(a1, hi[1], lo[1]);
    split2(a2, hi[2], lo[2]);
    split2(a3, hi[3], lo[3]);
  }
  // from an m16n8 accumulator, its columns the k axis permuted: column
  // 2q at k = q, 2q + 1 at k = q + 4
  __device__ __forceinline__ void set_acc(const float (&c)[4]) {
    set(c[0], c[2], c[1], c[3]);
  }
};
// c += a * b in 3xTF32, the small terms first, each added by the tensor
// cores' float32 accumulation (a temporary summed from zero and then
// added, as mma3 does, was slower here: more registers, spills)
__device__ __forceinline__ void mma3b(float (&c)[4], const Frag& a, float b0,
                                      float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split2(b0, bh0, bl0);
  split2(b1, bh1, bl1);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}
__device__ __forceinline__ void zero4(float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
}

// word c of row r of a swizzled TQB x PB tile
template <int PB>
__device__ __forceinline__ int swz(int r, int c) {
  return r * PB + (c ^ ((r & 7) << 2));
}

// A tile of `trows` rows x `width` words (a multiple of 4) into dst, row r
// at r * ld (swizzled when SW, ld = width), from rows of `lds` words; rows
// past `rows` and words past `cols` are zero.
template <bool SW>
__device__ __forceinline__ void load_bwd(float* dst, int ld, int trows,
                                         int width, const float* src,
                                         long long lds, int rows, int cols,
                                         bool vec) {
  const auto at = [&](int r, int c) {
    return r * ld + (SW ? (c ^ ((r & 7) << 2)) : c);
  };
  if (vec) {
    const int per = width >> 2;
    for (int e = threadIdx.x; e < trows * per; e += BT) {
      const int r = e / per, c = (e - r * per) << 2;
      const int nb = r < rows ? 4 * max(0, min(cols - c, 4)) : 0;
      cp_async16(dst + at(r, c), nb ? src + r * lds + c : src, nb);
    }
  } else {
    for (int e = threadIdx.x; e < trows * width; e += BT) {
      const int r = e / width, c = e - r * width;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + at(r, c), ok ? src + r * lds + c : src, ok);
    }
  }
}

// Floats of shared memory of a block: PB state rows, N8 state columns.
long long bwd_floats(int PB, int N8) {
  const long long LDN = N8 + 4;
  return 2LL * TQB * PB + 2 * TQB * LDN + (long long)PB * N8 + PB * LDN +
         TQB * (BLDR + 9) + 8;
}

// What the device functions of one block share: its tiles in shared
// memory, its place and the lane's place in its warp.  N8C: N rounded up
// to 8 where it is fixed at compile time (0: read N8 at run time).
template <int N8C>
struct Bwd {
  float *Xs, *Ys, *Bs, *Cs, *Hs, *Gs, *R, *ev, *din, *us, *vs, *cs;
  int N, N8, LDN, g, q, S, P, pcols, pb0;
  long long bh, orow;
  __device__ __forceinline__ int n8() const { return N8C ? N8C : N8; }
  __device__ __forceinline__ int ldn() const { return N8C ? N8C + 4 : LDN; }
};

// Rows r0, r0 + 8 of a swizzled tile (k over p) as an A operand
template <int PB>
__device__ __forceinline__ void sw_rows(Frag& a, const float* T, int r0,
                                        int kb, int q) {
  a.set(T[swz<PB>(r0, kb + q)], T[swz<PB>(r0 + 8, kb + q)],
        T[swz<PB>(r0, kb + q + 4)], T[swz<PB>(r0 + 8, kb + q + 4)]);
}
// Rows j0, j0 + 8 of B (k over N) as an A operand
template <class K>
__device__ __forceinline__ void b_rows(const K& k, Frag& a, int j0,
                                       int kb) {
  const float* b = k.Bs + j0 * k.ldn() + kb + k.q;
  a.set(b[0], b[8 * k.ldn()], b[4], b[8 * k.ldn() + 4]);
}
// L on an m16n8 tile of (j rows, i columns) of row tile jt: the lane's
// (j0, i0), (j0, i0 + 1), (j0 + 8, i0), (j0 + 8, i0 + 1); 0 where i < j.
// The exponents are sums from the first row of j's 8-key tile.
template <class K>
__device__ __forceinline__ void decay_ji(const K& k, float (&l)[4], int jt,
                                         int it) {
  const int j0 = 16 * jt + k.g, j1 = j0 + 8, i0 = 8 * it + 2 * k.q;
  const int i1 = i0 + 1, k0 = 2 * jt, k1 = k0 + 1;
  const float r0 = k.R[j0 * BLDR + k0], r1 = k.R[j1 * BLDR + k1];
  const bool dg = it <= k1;
  l[0] = (dg && i0 < j0) ? 0.f : ex2(k.R[i0 * BLDR + k0] - r0);
  l[1] = (dg && i1 < j0) ? 0.f : ex2(k.R[i1 * BLDR + k0] - r0);
  l[2] = (dg && i0 < j1) ? 0.f : ex2(k.R[i0 * BLDR + k1] - r1);
  l[3] = (dg && i1 < j1) ? 0.f : ex2(k.R[i1 * BLDR + k1] - r1);
}

// A pair of m16n8 tiles of X^T-or-dY^T products on rows r0, r0 + 8 of
// tile T (A operand, k over p) against rows 8 ta + g and 8 tb + g of tile
// U (B operand): both from the same A fragments
template <int PB, class K>
__device__ __forceinline__ void pair_p(const K& k, float (&za)[4],
                                       float (&zb)[4], const float* T,
                                       const float* U, int r0, int ta,
                                       int tb) {
  const int g = k.g, q = k.q;
  zero4(za);
  zero4(zb);
  for (int kb = 0; kb < PB; kb += 8) {
    Frag a;
    sw_rows<PB>(a, T, r0, kb, q);
    mma3b(za, a, U[swz<PB>(8 * ta + g, kb + q)],
          U[swz<PB>(8 * ta + g, kb + q + 4)]);
    mma3b(zb, a, U[swz<PB>(8 * tb + g, kb + q)],
          U[swz<PB>(8 * tb + g, kb + q + 4)]);
  }
}
// B C^T on rows j0, j0 + 8 against the keys of tiles ta and tb (k over N)
template <class K>
__device__ __forceinline__ void pair_bc(const K& k, float (&ma)[4],
                                        float (&mb)[4], int j0, int ta,
                                        int tb) {
  const int g = k.g, q = k.q, LDN = k.ldn();
  zero4(ma);
  zero4(mb);
  for (int kb = 0; kb < k.n8(); kb += 8) {
    Frag a;
    b_rows(k, a, j0, kb);
    const float* ca = k.Cs + (8 * ta + g) * LDN + kb + q;
    const float* cb = k.Cs + (8 * tb + g) * LDN + kb + q;
    mma3b(ma, a, ca[0], ca[4]);
    mma3b(mb, a, cb[0], cb[4]);
  }
}
// acc (rows r0, r0 + 8; the half's NT n-tiles of p from cb) = e o (B G^T)
template <int NT, class K>
__device__ __forceinline__ void dx_state(const K& k, float (&ax)[NT][4],
                                         int cb, int j0) {
  const int g = k.g, q = k.q, LDN = k.ldn();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) zero4(ax[nt]);
  for (int kb = 0; kb < k.n8(); kb += 8) {
    Frag a;
    b_rows(k, a, j0, kb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* gr = k.Gs + (cb + 8 * nt + g) * LDN + kb + q;
      mma3b(ax[nt], a, gr[0], gr[4]);
    }
  }
  const float e0 = k.ev[j0], e1 = k.ev[j0 + 8];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    ax[nt][0] *= e0;
    ax[nt][1] *= e0;
    ax[nt][2] *= e1;
    ax[nt][3] *= e1;
  }
}
// dX += (M^T)(j, i) dY(i, p) on key tile it and NT n-tiles of p from cb,
// M^T = B C^T o L^T: the keys permuted as in the forward
template <int PB, int NT, class K>
__device__ __forceinline__ void dx_tile(const K& k, float (&ax)[NT][4],
                                        int cb, int it, const float (&m)[4],
                                        const float (&l)[4]) {
  float mm[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) mm[e] = m[e] * l[e];
  Frag pa;
  pa.set_acc(mm);
  const int i0 = 8 * it + 2 * k.q;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = cb + 8 * nt + k.g;
    mma3b(ax[nt], pa, k.Ys[swz<PB>(i0, col)], k.Ys[swz<PB>(i0 + 1, col)]);
  }
}
// dX's rows r0, r0 + 8 (the half's columns from cb) to device memory
template <int NT, class K>
__device__ __forceinline__ void dx_store(const K& k,
                                         const float (&ax)[NT][4], int cb,
                                         int j0, int s0, int Q,
                                         float* __restrict__ dxdt) {
  const int j1 = j0 + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int pc = cb + 8 * nt + 2 * k.q;    // local p of ax[.][0]
    float* r0 = dxdt + (k.bh * k.S + s0 + j0) * k.P + k.pb0 + pc;
    float* r1 = r0 + 8LL * k.P;
    if (pc + 1 < k.pcols && (k.P & 1) == 0) {
      if (j0 < Q) *reinterpret_cast<float2*>(r0) =
          make_float2(ax[nt][0], ax[nt][1]);
      if (j1 < Q) *reinterpret_cast<float2*>(r1) =
          make_float2(ax[nt][2], ax[nt][3]);
    } else {
      if (j0 < Q && pc < k.pcols) r0[0] = ax[nt][0];
      if (j0 < Q && pc + 1 < k.pcols) r0[1] = ax[nt][1];
      if (j1 < Q && pc < k.pcols) r1[0] = ax[nt][2];
      if (j1 < Q && pc + 1 < k.pcols) r1[1] = ax[nt][3];
    }
  }
}
// W = Z^T o (B C^T) on key tile it of row tile jt (zt masked): each row
// j's running suffix over the keys (from the right; carry0, carry1 hold
// the part right of this tile), then each column i's sum over the tile's
// rows j < i, into cs
template <class K>
__device__ __forceinline__ void w_tile(const K& k, int jt, int it,
                                       const float (&zt)[4],
                                       const float (&m)[4], float& carry0,
                                       float& carry1) {
  const int g = k.g, q = k.q;
  const int j0 = 16 * jt + g, j1 = j0 + 8, i0 = 8 * it + 2 * q, i1 = i0 + 1;
  float rs[4];                  // suffix sums at (j0, i0), (j0, i1), ...
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float wa = zt[2 * r] * m[2 * r], wb = zt[2 * r + 1] * m[2 * r + 1];
    float sv = wa + wb;         // inclusive suffix over the quad
    float t = __shfl_down_sync(0xffffffffu, sv, 1, 4);
    if (q < 3) sv += t;
    t = __shfl_down_sync(0xffffffffu, sv, 2, 4);
    if (q < 2) sv += t;
    float ex = __shfl_down_sync(0xffffffffu, sv, 1, 4);
    ex = q < 3 ? ex : 0.f;
    const float tot = __shfl_sync(0xffffffffu, sv, 0, 4);
    float& carry = r ? carry1 : carry0;
    rs[2 * r + 1] = wb + (ex + carry);
    rs[2 * r] = wa + rs[2 * r + 1];
    carry = tot + carry;
  }
  float c0 = (j0 < i0 ? rs[0] : 0.f) + (j1 < i0 ? rs[2] : 0.f);
  float c1 = (j0 < i1 ? rs[1] : 0.f) + (j1 < i1 ? rs[3] : 0.f);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, o);
    c1 += __shfl_xor_sync(0xffffffffu, c1, o);
  }
  if (g == 0) {
    k.cs[jt * TQB + i0] = c0;
    k.cs[jt * TQB + i1] = c1;
  }
}
// acc (NN n-tiles of N from n0) += (masked accumulator z, its columns the
// k axis permuted) x rows 8 t + 2q, + 1 of T (B or C)
template <int NN, class K>
__device__ __forceinline__ void n_tile(const K& k, float (&acc)[NN][4],
                                       const float (&z)[4], const float* T,
                                       int t, int n0) {
  Frag za;
  za.set_acc(z);
  const float* r = T + (8 * t + 2 * k.q) * k.ldn() + n0 + k.g;
#pragma unroll
  for (int nn = 0; nn < NN; ++nn)
    if (n0 + 8 * nn < k.n8()) mma3b(acc[nn], za, r[8 * nn], r[k.ldn() + 8 * nn]);
}
// acc (rows r0, r0 + 8; NN n-tiles of N from n0) = T's rows (k over p)
// times U (PB x ldu, rows p): X G or dY h0
template <int PB, int NN, class K>
__device__ __forceinline__ void p_times_state(const K& k,
                                              float (&acc)[NN][4],
                                              const float* T, int r0,
                                              const float* U, int ldu,
                                              int n0) {
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) zero4(acc[nn]);
  for (int kb = 0; kb < PB; kb += 8) {
    Frag a;
    sw_rows<PB>(a, T, r0, kb, k.q);
    const float* ur = U + (kb + k.q) * ldu + n0 + k.g;
#pragma unroll
    for (int nn = 0; nn < NN; ++nn)
      if (n0 + 8 * nn < k.n8())
        mma3b(acc[nn], a, ur[8 * nn], ur[4 * ldu + 8 * nn]);
  }
}

// Rows r0, r0 + 8 of an m16n8 tile group into out (this block's dB or
// dC), columns n0 + 8 nn + 2q, + 1
template <int NN, class K>
__device__ __forceinline__ void store_n(const K& k, float* out, int s0,
                                        int Q, int r0,
                                        const float (&acc)[NN][4], int n0) {
  const int N = k.N;
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
    const int n = n0 + 8 * nn + 2 * k.q;
    float* o0 = out + (k.orow * k.S + s0 + r0) * N + n;
    float* o1 = o0 + 8LL * N;
    if (n + 1 < N && (N & 1) == 0) {
      if (r0 < Q) *reinterpret_cast<float2*>(o0) =
          make_float2(acc[nn][0], acc[nn][1]);
      if (r0 + 8 < Q) *reinterpret_cast<float2*>(o1) =
          make_float2(acc[nn][2], acc[nn][3]);
    } else {
      if (r0 < Q && n < N) o0[0] = acc[nn][0];
      if (r0 < Q && n + 1 < N) o0[1] = acc[nn][1];
      if (r0 + 8 < Q && n < N) o1[0] = acc[nn][2];
      if (r0 + 8 < Q && n + 1 < N) o1[1] = acc[nn][3];
    }
  }
}
// The lane's part of <T_r, acc_r> for rows r0, r0 + 8 over this group's
// columns
template <int NN, class K>
__device__ __forceinline__ void row_dot(const K& k, float& s0v, float& s1v,
                                        const float* T, int r0,
                                        const float (&acc)[NN][4], int n0) {
  const int LDN = k.ldn();
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
    const int n = n0 + 8 * nn + 2 * k.q;
    if (n < k.n8()) {
      s0v += T[r0 * LDN + n] * acc[nn][0] + T[r0 * LDN + n + 1] * acc[nn][1];
      s1v += T[(r0 + 8) * LDN + n] * acc[nn][2] +
             T[(r0 + 8) * LDN + n + 1] * acc[nn][3];
    }
  }
}
// scale rows r0 (c[.][0..1]) by s0 and r0 + 8 (c[.][2..3]) by s1
template <int NN>
__device__ __forceinline__ void scale_rows(float (&c)[NN][4], float s0,
                                           float s1) {
#pragma unroll
  for (int nn = 0; nn < NN; ++nn) {
    c[nn][0] *= s0;
    c[nn][1] *= s0;
    c[nn][2] *= s1;
    c[nn][3] *= s1;
  }
}

// dX's columns: the first n-tiles of the block's p to half 0, the rest to
// half 1, which has no W to form: 2 of 8 (see the note)
template <int PB>
__host__ __device__ constexpr int dx0_tiles() { return PB / 32; }

// Half 0, rows j of tile jt: dX on its columns, Z^T, W's pair sums, dB =
// e o (X G) + Z^T C and v.  The key tiles go in pairs from the
// right (for W's suffix), each pair's Z^T and B C^T from shared A
// fragments; with N above 8 NN, dB's later groups of N take Z^T again.
template <int PB, int NN, int jt, class K>
__device__ __forceinline__ void half0_rows(const K& k, int s0, int Q,
                                           float* __restrict__ dxdt,
                                           float* __restrict__ dBo) {
  constexpr int DX0 = dx0_tiles<PB>();
  const int j0 = 16 * jt + k.g, j1 = j0 + 8;
  const float e0 = k.ev[j0], e1 = k.ev[j1];
  float vp0 = 0.f, vp1 = 0.f;
  for (int n0 = 0; n0 < k.n8(); n0 += 8 * NN) {
    const bool first = n0 == 0;
    float ab[NN][4];
    p_times_state<PB, NN>(k, ab, k.Xs, j0, k.Gs, k.ldn(), n0);   // X G
    row_dot<NN>(k, vp0, vp1, k.Bs, j0, ab, n0);
    scale_rows<NN>(ab, e0, e1);
    float ax[DX0][4];
    if (first) dx_state<DX0>(k, ax, 0, j0);
    float carry0 = 0.f, carry1 = 0.f;
#pragma unroll 1
    for (int p2 = 3; p2 >= jt; --p2) {
      float z[2][4], m[2][4];
      pair_p<PB>(k, z[0], z[1], k.Xs, k.Ys, j0, 2 * p2 + 1, 2 * p2);
      if (first) pair_bc(k, m[0], m[1], j0, 2 * p2 + 1, 2 * p2);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int it = 2 * p2 + 1 - u;           // the right tile first
        float l[4];
        decay_ji(k, l, jt, it);
#pragma unroll
        for (int e = 0; e < 4; ++e) z[u][e] *= l[e];
        if (first) {
          dx_tile<PB, DX0>(k, ax, 0, it, m[u], l);
          w_tile(k, jt, it, z[u], m[u], carry0, carry1);
        }
        n_tile<NN>(k, ab, z[u], k.Cs, it, n0);
      }
    }
    if (first) dx_store<DX0>(k, ax, 0, j0, s0, Q, dxdt);
    store_n<NN>(k, dBo, s0, Q, j0, ab, n0);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    vp0 += __shfl_xor_sync(0xffffffffu, vp0, o);
    vp1 += __shfl_xor_sync(0xffffffffu, vp1, o);
  }
  if (k.q == 0) {
    k.vs[j0] = e0 * vp0;
    k.vs[j1] = e1 * vp1;
  }
}

// Half 1, dX on rows j of tile jt, its columns.
template <int PB, int jt, class K>
__device__ __forceinline__ void half1_dx(const K& k, int s0, int Q,
                                         float* __restrict__ dxdt) {
  constexpr int DX1 = PB / 8 - dx0_tiles<PB>(), CB = 8 * dx0_tiles<PB>();
  const int j0 = 16 * jt + k.g;
  float ax[DX1][4];
  dx_state<DX1>(k, ax, CB, j0);
#pragma unroll 1
  for (int p2 = 3; p2 >= jt; --p2) {
    float m[2][4];
    pair_bc(k, m[0], m[1], j0, 2 * p2 + 1, 2 * p2);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float l[4];
      decay_ji(k, l, jt, 2 * p2 + 1 - u);
      dx_tile<PB, DX1>(k, ax, CB, 2 * p2 + 1 - u, m[u], l);
    }
  }
  dx_store<DX1>(k, ax, CB, j0, s0, Q, dxdt);
}

// Half 1, rows i of tile mt: Z, dC = din o (dY h0) + Z B and u; Z's key
// tiles in pairs from shared A fragments.
template <int PB, int NN, int mt, class K>
__device__ __forceinline__ void half1_rows(const K& k, int s0, int Q,
                                           float* __restrict__ dCo) {
  const int g = k.g, q = k.q;
  const int i0 = 16 * mt + g, i1 = i0 + 8;
  const float d0 = k.din[i0], d1 = k.din[i1];
  float up0 = 0.f, up1 = 0.f;
  for (int n0 = 0; n0 < k.n8(); n0 += 8 * NN) {
    float ac[NN][4];
    p_times_state<PB, NN>(k, ac, k.Ys, i0, k.Hs, k.n8(), n0);   // dY h0
    row_dot<NN>(k, up0, up1, k.Cs, i0, ac, n0);
    scale_rows<NN>(ac, d0, d1);
#pragma unroll 1
    for (int p2 = 0; p2 <= mt; ++p2) {
      float z[2][4];
      pair_p<PB>(k, z[0], z[1], k.Ys, k.Xs, i0, 2 * p2, 2 * p2 + 1);
      // L[i][j] = exp2(R[i][jt] - R[j][jt]), 0 where j > i
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jt = 2 * p2 + u;
        const int jj0 = 8 * jt + 2 * q, jj1 = jj0 + 1;
        const float ci0 = k.R[i0 * BLDR + jt], ci1 = k.R[i1 * BLDR + jt];
        const float dj0 = k.R[jj0 * BLDR + jt], dj1 = k.R[jj1 * BLDR + jt];
        const bool dg = jt >= 2 * mt;
        z[u][0] *= (dg && jj0 > i0) ? 0.f : ex2(ci0 - dj0);
        z[u][1] *= (dg && jj1 > i0) ? 0.f : ex2(ci0 - dj1);
        z[u][2] *= (dg && jj0 > i1) ? 0.f : ex2(ci1 - dj0);
        z[u][3] *= (dg && jj1 > i1) ? 0.f : ex2(ci1 - dj1);
        n_tile<NN>(k, ac, z[u], k.Bs, jt, n0);
      }
    }
    store_n<NN>(k, dCo, s0, Q, i0, ac, n0);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    up0 += __shfl_xor_sync(0xffffffffu, up0, o);
    up1 += __shfl_xor_sync(0xffffffffu, up1, o);
  }
  if (q == 0) {
    k.us[i0] = d0 * up0;
    k.us[i1] = d1 * up1;
  }
}

// dY^T (din o C) on the rows p of m-tiles h1 and h1 + 2 (PB = 64) and all
// of N (N8 <= 8 NN): half 1's share of the G update,
// formed while half 0 finishes and written after the chunk's last read of
// the old G
template <int PB, int NN, class K>
__device__ __forceinline__ void g_product(const K& k, int h1,
                                          float (&ga)[PB / 32][NN][4]) {
  const int g = k.g, q = k.q, LDN = k.ldn();
#pragma unroll
  for (int u = 0; u < PB / 32; ++u)
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) zero4(ga[u][nn]);
  for (int ks = 0; ks < TQB / 8; ++ks) {
    const int i0 = 8 * ks + q, i1 = i0 + 4;
    const float d0 = k.din[i0], d1 = k.din[i1];
#pragma unroll
    for (int u = 0; u < PB / 32; ++u) {
      const int pr0 = 16 * (2 * u + h1) + g, pr1 = pr0 + 8;
      Frag a;
      a.set(k.Ys[swz<PB>(i0, pr0)], k.Ys[swz<PB>(i0, pr1)],
            k.Ys[swz<PB>(i1, pr0)], k.Ys[swz<PB>(i1, pr1)]);
#pragma unroll
      for (int nn = 0; nn < NN; ++nn)
        if (8 * nn < k.n8())
          mma3b(ga[u][nn], a, d0 * k.Cs[i0 * LDN + 8 * nn + g],
                d1 * k.Cs[i1 * LDN + 8 * nn + g]);
    }
  }
}
// G <- dl G + ga on those tiles
template <int PB, int NN, class K>
__device__ __forceinline__ void g_write(const K& k, int h1, float dl,
                                        const float (&ga)[PB / 32][NN][4]) {
  const int LDN = k.ldn();
#pragma unroll
  for (int u = 0; u < PB / 32; ++u) {
    const int pr0 = 16 * (2 * u + h1) + k.g, pr1 = pr0 + 8;
#pragma unroll
    for (int nn = 0; nn < NN; ++nn) {
      const int nc = 8 * nn + 2 * k.q;
      if (nc < k.n8()) {
        float* g0 = k.Gs + pr0 * LDN + nc;
        float* g1 = k.Gs + pr1 * LDN + nc;
        g0[0] = fmaf(dl, g0[0], ga[u][nn][0]);
        g0[1] = fmaf(dl, g0[1], ga[u][nn][1]);
        g1[0] = fmaf(dl, g1[0], ga[u][nn][2]);
        g1[1] = fmaf(dl, g1[1], ga[u][nn][3]);
      }
    }
  }
}

// dlogd_i = pair_i + sum_{k >= i} u_k + sum_{j < i} v_j + dl <G, h0> of
// the chunk at s0 (Q tokens), by one warp: the pair sums of the four row
// tiles in order, a suffix scan of u, an exclusive prefix scan of v
template <class K>
__device__ __forceinline__ void dlogd_out(const K& k, const float* gh,
                                          float dl, int s0, int Q,
                                          float* __restrict__ dlo) {
  const int lane = threadIdx.x & 31, i0 = 2 * lane, i1 = i0 + 1;
  float p0 = 0.f, p1 = 0.f;
  for (int jt = 0; jt < 4; ++jt) {
    if (16 * jt <= i0) p0 += k.cs[jt * TQB + i0];
    if (16 * jt <= i1) p1 += k.cs[jt * TQB + i1];
  }
  const float ua = k.us[i0], ub = k.us[i1];
  float su = ua + ub;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_down_sync(0xffffffffu, su, o);
    if (lane + o < 32) su += t;
  }
  float ux = __shfl_down_sync(0xffffffffu, su, 1);
  ux = lane < 31 ? ux : 0.f;
  const float su1 = ub + ux, su0 = ua + su1;
  const float va = k.vs[i0], vb = k.vs[i1];
  float sv = va + vb;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, sv, o);
    if (lane >= o) sv += t;
  }
  float vx = __shfl_up_sync(0xffffffffu, sv, 1);
  vx = lane ? vx : 0.f;
  const float sv0 = vx, sv1 = vx + va;
  const float w = dl * (((gh[0] + gh[1]) + gh[2]) + gh[3]);
  float* o = dlo + k.orow * k.S + s0;
  if (i0 < Q) o[i0] = p0 + su0 + sv0 + w;
  if (i1 < Q) o[i1] = p1 + su1 + sv1 + w;
}

// NT: n-tiles of 8 state rows p that a half holds (PB / 16); NN: n-tiles
// of N that dB's and dC's accumulators hold; FULL: N8 = 8 NN, fixed at
// compile time (else N8 is read at run time, in groups of 8 NN columns).
// Each warp's row tiles are template arguments too, so that the tile
// loops' bounds and addresses fold.
template <int NT, int NN, bool FULL>
__global__ void __launch_bounds__(BT, 4)
ssd_bwd_kernel(const float* __restrict__ xdt, const float* __restrict__ logd,
               const float* __restrict__ Bv, const float* __restrict__ Cv,
               const float* __restrict__ dy, const float* __restrict__ dhf,
               const float* __restrict__ hst, float* __restrict__ dxdt,
               float* __restrict__ dlo, float* __restrict__ dBo,
               float* __restrict__ dCo, int S, int P, int N, int heads,
               int vec) {
  constexpr int PB = 16 * NT;
  extern __shared__ __align__(16) float sm[];
  Bwd<FULL ? 8 * NN : 0> k;
  k.N = N;
  k.N8 = (N + 7) & ~7;
  k.LDN = k.N8 + 4;
  const int N8 = k.n8(), LDN = k.ldn(), NNt = N8 >> 3;
  k.Xs = sm;                           // TQB x PB, swizzled: xdt
  k.Ys = k.Xs + TQB * PB;              // TQB x PB, swizzled: dy
  k.Bs = k.Ys + TQB * PB;              // TQB x LDN
  k.Cs = k.Bs + TQB * LDN;             // TQB x LDN
  k.Hs = k.Cs + TQB * LDN;             // PB x N8: h0
  k.Gs = k.Hs + PB * N8;               // PB x LDN: G
  float* Ls = k.Gs + PB * LDN;         // TQB: logd
  k.R = Ls + TQB;                      // TQB x BLDR: sums of logd (log2)
  k.ev = k.R + TQB * BLDR;             // TQB: e_j
  k.din = k.ev + TQB;                  // TQB: din_i
  k.us = k.din + TQB;                  // TQB: u_k
  k.vs = k.us + TQB;                   // TQB: v_j
  k.cs = k.vs + TQB;                   // 4 x TQB: pair sums by row tile
  float* gh = k.cs + 4 * TQB;          // 4 warps' <G, h0>
  float *Xs = k.Xs, *Ys = k.Ys, *Bs = k.Bs, *Cs = k.Cs, *Hs = k.Hs,
        *Gs = k.Gs, *R = k.R, *din = k.din;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  k.g = g;
  k.q = q;
  k.S = S;
  k.P = P;
  k.bh = blockIdx.x;
  const long long bh = k.bh, bc = bh / heads;
  const int npb = gridDim.y;
  k.pb0 = blockIdx.y * PB;
  const int pb0 = k.pb0;
  k.pcols = min(PB, P - pb0);
  const int pcols = k.pcols;
  const int nch = (S + TQB - 1) / TQB;
  k.orow = bh * npb + blockIdx.y;      // of dlo, dBo, dCo
  const float* xp = xdt + bh * S * P + pb0;
  const float* yp = dy + bh * S * P + pb0;
  const float* Bp = Bv + bc * S * N;
  const float* Cp = Cv + bc * S * N;
  const float* lp = logd + bh * S;

  for (int e = tid; e < PB * LDN; e += BT) {
    const int p = e / LDN, n = e - p * LDN;
    Gs[e] = (dhf && p < pcols && n < N) ? dhf[(bh * P + pb0 + p) * N + n]
                                        : 0.f;
  }
  // chunk c's X, B, h0 and logd (the buffers free first), then dY and C
  const auto load_first = [&](int c) {
    const int s0 = c * TQB, Q = min(TQB, S - s0);
    load_bwd<true>(Xs, PB, TQB, PB, xp + (long long)s0 * P, P, Q, pcols,
                   vec);
    load_bwd<false>(Bs, LDN, TQB, N8, Bp + (long long)s0 * N, N, Q, N, vec);
    load_bwd<false>(Hs, N8, PB, N8, hst + ((bh * nch + c) * P + pb0) * N, N,
                    pcols, N, vec);
    if (tid < TQB) cp_async4(Ls + tid, lp + s0 + (tid < Q ? tid : 0), tid < Q);
    cp_async_commit();
  };
  const auto load_second = [&](int c) {
    const int s0 = c * TQB, Q = min(TQB, S - s0);
    load_bwd<true>(Ys, PB, TQB, PB, yp + (long long)s0 * P, P, Q, pcols,
                   vec);
    load_bwd<false>(Cs, LDN, TQB, N8, Cp + (long long)s0 * N, N, Q, N, vec);
    cp_async_commit();
  };
  // Up to N = 8 NN half 1 forms the G update's products before the
  // chunk's last barrier, so that the next chunk's tiles are all loaded
  // from there on; wider N updates G after it, and dY and C wait for that.
  const bool gfused = FULL || N8 <= 8 * NN;
  load_first(nch - 1);
  if (gfused) load_second(nch - 1);

  const int half = warp >> 1, ms = warp & 1;
  float dl_next = 0.f;          // dl of chunk c + 1, for its dlogd
  float ga[PB / 32][NN][4];     // half 1's G products (gfused)

  for (int c = nch - 1; c >= 0; --c) {
    const int s0 = c * TQB, Q = min(TQB, S - s0);
    __syncthreads();            // chunk c + 1 is done with dY, C and G
    if (!gfused) load_second(c);
    // chunk c + 1's dlogd, while the loads land
    if (warp == 0 && c + 1 < nch)
      dlogd_out(k, gh, dl_next, s0 + TQB, min(TQB, S - s0 - TQB), dlo);
    if (gfused)
      cp_async_wait<0>();
    else
      cp_async_wait<1>();       // dY and C land behind the decays, <G, h0>
    __syncthreads();

    // -- decays, as the forward's: R[i][kt] the sum of logd (log2 units)
    // over rows 8kt..i, one scan a key tile, two a warp; din from R[.][0]
    for (int u = 0; u < 2; ++u) {
      const int kt = 2 * warp + u, r0 = 2 * lane;
      const float v0 = r0 >= 8 * kt ? Ls[r0] : 0.f;
      const float v1 = r0 + 1 >= 8 * kt ? Ls[r0 + 1] : 0.f;
      const float pair = v0 + v1;
      float sc = pair;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, sc, o);
        if (lane >= o) sc += t;
      }
      float ex = __shfl_up_sync(0xffffffffu, sc, 1);
      ex = lane ? ex : 0.f;
      const float a0 = (ex + v0) * LOG2E, a1 = (ex + pair) * LOG2E;
      R[r0 * BLDR + kt] = a0;
      R[(r0 + 1) * BLDR + kt] = a1;
      if (kt == 0) {
        din[r0] = exp2f(a0);
        din[r0 + 1] = exp2f(a1);
      }
    }
    if (warp == 0) {            // e_j = exp(sum of logd over rows > j)
      const float w1 = Ls[2 * lane + 1];
      float sc = Ls[2 * lane] + w1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, sc, o);
        if (lane + o < 32) sc += t;
      }
      float ex = __shfl_down_sync(0xffffffffu, sc, 1);
      ex = lane < 31 ? ex : 0.f;
      k.ev[2 * lane] = exp2f((ex + w1) * LOG2E);
      k.ev[2 * lane + 1] = exp2f(ex * LOG2E);
    }
    __syncthreads();
    const float dl = exp2f(R[(TQB - 1) * BLDR]);
    dl_next = dl;

    // <G, h0>: each warp's part, in a fixed order, 4 words a thread a step
    {
      float s = 0.f;
      for (int e = 4 * tid; e < PB * N8; e += 4 * BT) {
        const int p = e / N8, n = e - p * N8;
        const float4 gv = *reinterpret_cast<const float4*>(Gs + p * LDN + n);
        const float4 hv = *reinterpret_cast<const float4*>(Hs + e);
        s = fmaf(gv.x, hv.x, fmaf(gv.y, hv.y, fmaf(gv.z, hv.z,
                 fmaf(gv.w, hv.w, s))));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) gh[warp] = s;
    }
    if (!gfused) {
      cp_async_wait<0>();       // dY and C
      __syncthreads();
    }

    // -- the warps' tiles: half 0 rows j of tiles ms, 3 - ms (Z^T, dX, W,
    // dB, v); half 1 dX on the same rows, then rows i (Z, dC, u)
    if (half == 0 && ms == 0) {
      half0_rows<PB, NN, 0>(k, s0, Q, dxdt, dBo);
      half0_rows<PB, NN, 3>(k, s0, Q, dxdt, dBo);
    } else if (half == 0) {
      half0_rows<PB, NN, 1>(k, s0, Q, dxdt, dBo);
      half0_rows<PB, NN, 2>(k, s0, Q, dxdt, dBo);
    } else {
      if (ms == 0) {
        half1_dx<PB, 0>(k, s0, Q, dxdt);
        half1_dx<PB, 3>(k, s0, Q, dxdt);
        half1_rows<PB, NN, 0>(k, s0, Q, dCo);
        half1_rows<PB, NN, 3>(k, s0, Q, dCo);
      } else {
        half1_dx<PB, 1>(k, s0, Q, dxdt);
        half1_dx<PB, 2>(k, s0, Q, dxdt);
        half1_rows<PB, NN, 1>(k, s0, Q, dCo);
        half1_rows<PB, NN, 2>(k, s0, Q, dCo);
      }
      if (gfused) g_product<PB, NN>(k, ms, ga);
    }
    __syncthreads();            // every read of the tiles and the old G done
    if (c > 0) {
      load_first(c - 1);
      if (gfused) load_second(c - 1);
    }
    if (gfused) {
      if (half == 1) g_write<PB, NN>(k, ms, dl, ga);
      continue;
    }

    // -- (N above 8 NN) G <- dl G + dY^T (din o C): warps split the
    // m-tiles of p (wpm warps an m-tile), each takes its n-tiles of N four
    // at a time
    {
      const int wpm = 4 / NT, mp = warp / wpm;
      const int pr0 = 16 * mp + g, pr1 = pr0 + 8;
      for (int nb = warp % wpm; nb < NNt; nb += 4 * wpm) {
        float a4[4][4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int nc = 8 * (nb + wpm * v) + 2 * q;
          if (nb + wpm * v < NNt) {
            a4[v][0] = Gs[pr0 * LDN + nc] * dl;
            a4[v][1] = Gs[pr0 * LDN + nc + 1] * dl;
            a4[v][2] = Gs[pr1 * LDN + nc] * dl;
            a4[v][3] = Gs[pr1 * LDN + nc + 1] * dl;
          }
        }
        float b4[4][4];         // the odd key tiles: a second chain
#pragma unroll
        for (int v = 0; v < 4; ++v) zero4(b4[v]);
#pragma unroll 2
        for (int ks = 0; ks < TQB / 8; ++ks) {
          const int i0 = 8 * ks + q, i1 = i0 + 4;
          Frag a;
          a.set(Ys[swz<PB>(i0, pr0)], Ys[swz<PB>(i0, pr1)],
                Ys[swz<PB>(i1, pr0)], Ys[swz<PB>(i1, pr1)]);
          const float d0 = din[i0], d1 = din[i1];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int nn = nb + wpm * v;
            if (nn < NNt)
              mma3b(ks & 1 ? b4[v] : a4[v], a, d0 * Cs[i0 * LDN + 8 * nn + g],
                    d1 * Cs[i1 * LDN + 8 * nn + g]);
          }
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int nc = 8 * (nb + wpm * v) + 2 * q;
          if (nb + wpm * v < NNt) {
            Gs[pr0 * LDN + nc] = a4[v][0] + b4[v][0];
            Gs[pr0 * LDN + nc + 1] = a4[v][1] + b4[v][1];
            Gs[pr1 * LDN + nc] = a4[v][2] + b4[v][2];
            Gs[pr1 * LDN + nc + 1] = a4[v][3] + b4[v][3];
          }
        }
      }
    }
  }
  if (warp == 0) dlogd_out(k, gh, dl_next, 0, min(TQB, S), dlo);
}

// dB and dC summed over the heads and the p blocks; dlogd over the p
// blocks when there are several.  One thread an output, in a fixed order.
__global__ void ssd_bwd_reduce(const float* __restrict__ dlp,
                               const float* __restrict__ dBp,
                               const float* __restrict__ dCp,
                               float* __restrict__ dlogd,
                               float* __restrict__ dB, float* __restrict__ dC,
                               long long BH, long long S, int N, int heads,
                               int npb) {
  const long long nb = BH / heads * S * N, SN = S * N;
  const long long nl = npb > 1 ? BH * S : 0, total = 2 * nb + nl;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    if (e < 2 * nb) {
      const bool isc = e >= nb;
      const long long o = isc ? e - nb : e;
      const long long g = o / SN, r = o - g * SN;
      const float* src = (isc ? dCp : dBp) + g * heads * npb * SN + r;
      float s = 0.f;
      for (int h = 0; h < heads * npb; ++h) s += src[h * SN];
      (isc ? dC : dB)[o] = s;
    } else {
      const long long o = e - 2 * nb;
      const long long bh = o / S, t = o - bh * S;
      const float* src = dlp + bh * npb * S + t;
      float s = 0.f;
      for (int q = 0; q < npb; ++q) s += src[q * S];
      dlogd[o] = s;
    }
  }
}

// The state rows p a block of the backward takes: 64 (a narrower P runs
// padded with zeros: one set of template instances, half the build of
// two); 0 when its tiles do not fit shared memory (the state is too
// wide).
constexpr int BWD_PB = 64;
int bwd_pblock(int P, int N) {
  if (P <= 0 || N <= 0) return 0;
  return 4 * bwd_floats(BWD_PB, (N + 7) & ~7) <= SMEM_LIMIT ? BWD_PB : 0;
}

// The backward's scratch, all float32, each part 256-byte aligned: dBp and
// dCp (BH, npb, S, N), each block's part of dB and dC, when heads > 1 or
// npb = ceil(P / PB) > 1; dlp (BH, npb, S), its part of dlogd, when npb >
// 1.  Sets the pointers into ws (when not NULL); returns its bytes.
struct BwdScratch {
  float *dlp, *dBp, *dCp;
};

size_t bwd_scratch(int BH, int S, int P, int N, int heads, int PB, char* ws,
                   BwdScratch* out) {
  const size_t npb = (P + PB - 1) / PB;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* p = ws == nullptr ? nullptr : (float*)(ws + off);
    off += (4 * floats + 255) / 256 * 256;
    return p;
  };
  *out = BwdScratch{nullptr, nullptr, nullptr};
  if (npb > 1) out->dlp = take((size_t)BH * npb * S);
  if (npb > 1 || heads > 1) {
    out->dBp = take((size_t)BH * npb * S * N);
    out->dCp = take((size_t)BH * npb * S * N);
  }
  return off;
}

template <int NT, int NN, bool FULL>
int bwd_launch(const dim3& grid, size_t smem, cudaStream_t s,
               const float* x, const float* l, const float* b,
               const float* c, const float* dy, const float* dhf,
               const float* hst, float* dx, float* dlo, float* dBo,
               float* dCo, int S, int P, int N, int heads, int vec) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_kernel<NT, NN, FULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<NT, NN, FULL><<<grid, BT, smem, s>>>(
      x, l, b, c, dy, dhf, hst, dx, dlo, dBo, dCo, S, P, N, heads, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of ssd_bwd's workspace for these shapes (0: none); -1 when a P x
// N state fits no block of the kernel.
extern "C" long long ssd_bwd_workspace(int BH, int S, int P, int N,
                                       int heads) {
  const int PB = bwd_pblock(P, N);
  if (!PB) return -1;
  BwdScratch sc;
  return (long long)bwd_scratch(BH, S, P, N, heads, PB, nullptr, &sc);
}

// The gradient of ssd_fwd.  Inputs as ssd_fwd's, dy (BH, S, P), dh_final
// (BH, P, N) or NULL (zero), and hst (BH, ceil(S / 64), P, N), the states
// at the 64-token tile starts that ssd_fwd writes.  Outputs dxdt (BH, S,
// P), dlogd (BH, S), dB and dC (BH / heads, S, N).  ws:
// ssd_bwd_workspace(BH, S, P, N, heads) bytes on the card, every byte
// written before it is read.  One kernel on `stream`, two when heads > 1
// or P > 64.
extern "C" int ssd_bwd(const void* xdt, const void* logd, const void* B,
                       const void* C, const void* dy, const void* dh_final,
                       const void* hst, void* dxdt, void* dlogd, void* dB,
                       void* dC, void* ws, int BH, int S, int P, int N,
                       int heads, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
  if (P <= 0 || N <= 0 || heads <= 0 || BH % heads || hst == nullptr)
    return (int)cudaErrorInvalidValue;
  const int PB = bwd_pblock(P, N);
  if (!PB) return (int)cudaErrorInvalidValue;
  const int npb = (P + PB - 1) / PB, N8 = (N + 7) & ~7;
  BwdScratch sc;
  bwd_scratch(BH, S, P, N, heads, PB, (char*)ws, &sc);
  float* dlo = sc.dlp ? sc.dlp : (float*)dlogd;
  float* dBo = sc.dBp ? sc.dBp : (float*)dB;
  float* dCo = sc.dCp ? sc.dCp : (float*)dC;
  const auto al = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int vec = P % 4 == 0 && N % 4 == 0 && al(xdt) && al(dy) && al(B) &&
                  al(C) && al(hst);
  const size_t smem = 4 * (size_t)bwd_floats(PB, N8);
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(BH, npb);
  const float *x = (const float*)xdt, *l = (const float*)logd,
              *b = (const float*)B, *c = (const float*)C,
              *g = (const float*)dy, *hf = (const float*)dh_final,
              *h = (const float*)hst;
  float* dx = (float*)dxdt;
#define SSD_BWD(NN, FULL)                                                  \
  bwd_launch<BWD_PB / 16, NN, FULL>(grid, smem, s, x, l, b, c, g, hf, h,   \
                                    dx, dlo, dBo, dCo, S, P, N, heads, vec)
  // N8 of 8, 16 or 32 at compile time; any other in groups of 32
  const int err = N8 == 8    ? SSD_BWD(1, true)
                  : N8 == 16 ? SSD_BWD(2, true)
                  : N8 == 32 ? SSD_BWD(4, true)
                             : SSD_BWD(4, false);
#undef SSD_BWD
  if (err || (npb == 1 && heads == 1)) return err;
  const long long total = 2LL * (BH / heads) * S * N +
                          (npb > 1 ? (long long)BH * S : 0);
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  ssd_bwd_reduce<<<blocks, 256, 0, s>>>(sc.dlp, sc.dBp, sc.dCp,
                                        (float*)dlogd, (float*)dB, (float*)dC,
                                        BH, S, N, heads, npb);
  return (int)cudaGetLastError();
}
