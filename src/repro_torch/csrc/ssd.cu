// ssd: the chunked Mamba-2 SSD scan (state-space duality), on the tensor
// cores.
//
// Replaces: src/repro/kernels/mamba2_ssd/kernel.py, _ssd_kernel (:22) and
// its wrapper ssd_pallas (:75).  Same function, per row bh of (BH, S):
// within a chunk of Q tokens, with cs = cumsum(logd) over the chunk,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j
//         + exp(cs_i) (C_i . h)                       (h: carried (P, N))
//   h'  = h exp(cs_last) + sum_j exp(cs_last - cs_j) xdt_j (x) B_j
// and returns y (without the D skip) and the final state.  All float32.
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
// CACHED: N <= 8 KC, C's fragments stay in registers for an m-tile
template <int NT, bool CACHED>
__global__ void __launch_bounds__(THREADS, CACHED ? 4 : 1)
ssd_kernel(const float* __restrict__ xdt, const float* __restrict__ logd,
           const float* __restrict__ Bv, const float* __restrict__ Cv,
           float* __restrict__ y, float* __restrict__ hfin, int S, int P,
           int N, int chunk, int heads, int stages, int vec) {
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

template <int NT, bool CACHED>
int launch(const float* xdt, const float* logd, const float* B,
           const float* C, float* y, float* hfin, int BH, int S, int P, int N,
           int chunk, int heads, int stages, int vec, size_t smem,
           cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<NT, CACHED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int PB = 16 * NT;
  const dim3 grid(BH, (P + PB - 1) / PB);
  ssd_kernel<NT, CACHED><<<grid, THREADS, smem, stream>>>(
      xdt, logd, B, C, y, hfin, S, P, N, chunk, heads, stages, vec);
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
// hfin (BH, P, N); all float32, contiguous.  A block takes the widest of
// 64, 32 and 16 state rows not wider than P rounded up to 16, with two
// chunk tiles in the load ring where they fit in shared memory, else one;
// a state that no block holds is refused (cudaErrorInvalidValue).
extern "C" int ssd_fwd(const void* xdt, const void* logd, const void* B,
                       const void* C, void* y, void* hfin, int BH, int S,
                       int P, int N, int chunk, int heads, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
  if (P <= 0 || N <= 0 || chunk <= 0 || heads <= 0 || BH % heads)
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
  float *yy = (float*)y, *h = (float*)hfin;
  cudaStream_t s = (cudaStream_t)stream;
  const bool cached = ((N + 7) & ~7) <= 8 * KC;
#define SSD_LAUNCH(NT)                                                     \
  return cached ? launch<NT, true>(x, l, b, c, yy, h, BH, S, P, N, chunk,  \
                                   heads, stages, vec, smem, s)           \
                : launch<NT, false>(x, l, b, c, yy, h, BH, S, P, N, chunk, \
                                    heads, stages, vec, smem, s)
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
// The chunked form, in chunks of TQB = 64 tokens whatever the forward's
// chunk (the function is the same): with h0 the state before a chunk, G
// the gradient of its last state from the tokens after it, L[i][j] =
// exp(logd_{j+1} + ... + logd_i) for j <= i, din_i = exp(logd_0 + ... +
// logd_i), e_j = exp(logd_{j+1} + ... + logd_63) and dl = e_{-1},
//   dX = (CB^T o L)^T dY + e o (B G^T)
//   dC = din o (dY h0) + Z B,        Z = dY X^T o L
//   dB = Z^T C + e o (X G)
//   dlogd_i = sum_{j < i <= k} W[k][j] + sum_{k >= i} u_k
//             + sum_{j < i} v_j + dl <G, h0>
//       with W = Z o CB^T, u_k = din_k <C_k, (dY h0)_k>,
//       v_j = e_j <B_j, (X G)_j>
//   G <- dl G + dY^T (din o C)   (the gradient of h0: the previous
//                                 chunk's G)
// (the products L[k][i] L[i][j] = L[k][j], L[k][i] din_i = din_k and e_i
// L[i][j] = e_j fold a_i h_{i-1} and g_i into these sums).
//
// Three passes.
// 1. ssd_bwd_states: one block per (row, block of PB state rows p) walks
//    the chunks forward and writes the state at each chunk's start into
//    scratch (BH, chunks, P, N): h <- dl h + X^T (e o B).
// 2. ssd_bwd_chunks: the same blocks walk the chunks backward, carrying G
//    in shared memory, and form the four gradients of the chunk from its
//    tiles (X, dY, B, C, logd, h0) as above; dX is final, dlogd, dB and
//    dC are this block's part (its state rows p; its row, not yet summed
//    over heads) and go to scratch.
// 3. ssd_bwd_reduce: dB and dC summed over the heads and the p blocks,
//    dlogd over the p blocks, each output by one thread in a fixed order.
//    No atomics anywhere: two calls give the same bits.
//
// Precision (plain float32 FMAs, no tensor cores): no decay is a
// difference of two long sums.  L's exponents are running sums from key
// j + 1 (one thread a key), din and e a prefix and a suffix scan, so an
// exponent's error scales with the exponent itself and the factor's
// relative error stays ~ulp(|exponent|), negligible where the factor is
// not.  dlogd is a sum of signed terms that cancel after strong decay:
// its pair term is formed as nested sums of W (each row's exclusive
// prefix, then each column's suffix over rows), never as a difference of
// prefix sums, so its error is relative to the terms' own magnitudes,
// as the plain version's.  Held at <= 1e-4 of each gradient's largest
// magnitude against the plain version's autograd in float64.
//
// Bound at Hymba's training shape (400 rows x 2,048 tokens, P = 64,
// N = 16): bytes.  xdt, dy and dxdt at 210 MB each, logd, dlogd, B, C,
// dB and dC: 0.64 GB, 0.19 ms at 3.35 TB/s.  The function needs six
// products over the P x N state a token (h's and g's updates, the
// contractions for dxdt, dB, dC and dlogd): 12 S P N a row, 10.1 GFLOP a
// call, 0.06 ms as 3xTF32 on the tensor cores.  This simple design does
// 17.8 GFLOP in float32 FMAs (0.27 ms at the 67 TFLOP/s outside the
// tensor cores): it computes whole 64 x 64 tiles (about twice the
// triangle's work) from shared memory, half a load or more a
// multiply-add, recomputes the states, and also moves the state scratch
// (52 MB out and in) and the partials (105 MB out and in); the tensor
// cores (the forward's 3xTF32 products) are untried here.
//
// Shared memory of a pass-2 block, in floats: X and dY (64 x PB), B, C
// and the two (64 x N) products kept for u and v, h0 and G (PB x N),
// three 64 x 64 tiles (L, then W and its prefixes; CB, then M; dY X^T,
// then Z), rows padded to an odd length so that the column walks hit
// distinct banks.  At PB = 64, N = 16 that is 108 KB: two blocks an SM.
// A block takes the widest PB of 64, 32, 16 that fits; a state whose N
// no block holds (N above 148) is refused (cudaErrorInvalidValue).
// ===========================================================================
namespace {

constexpr int TQB = 64;           // tokens a chunk of the backward
constexpr int BT = 256;           // threads a block, passes 1 and 2

// floats of shared memory: pass 1 and pass 2 at PB state rows, NP
// (N rounded up to 4) state columns
long long states_floats(int PB, int NP) {
  return (long long)TQB * (PB + 1) + (long long)TQB * (NP + 1) +
         (long long)PB * (NP + 1) + TQB + 8;
}
long long chunks_floats(int PB, int NP) {
  const long long LDP = PB + 1, LDN = NP + 1, LDQ = TQB + 1;
  return 2 * TQB * LDP + 4 * TQB * LDN + 2LL * PB * LDN + 3 * TQB * LDQ +
         5 * TQB + 16;
}

// out(i, j, acc1, acc2) for each output of an (M x Nn) tile grid, with
// acc1 = sum_k<K1 a1(i, k) b1(k, j) and acc2 likewise over K2.  A thread
// takes TM consecutive rows i and TN columns j strided by Nn / TN, so
// that the lanes of a warp read consecutive columns.  M % TM == 0 and
// Nn % TN == 0 (the tiles are padded with zeros).
template <int TM, int TN, typename A1, typename B1, typename A2, typename B2,
          typename O>
__device__ __forceinline__ void mm2(int M, int Nn, int K1, A1 a1, B1 b1,
                                    int K2, A2 a2, B2 b2, O out) {
  const int TJ = Nn / TN, tiles = (M / TM) * TJ;
  for (int t = threadIdx.x; t < tiles; t += BT) {
    const int i0 = (t / TJ) * TM, tj = t % TJ;
    float c1[TM][TN], c2[TM][TN];
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) c1[u][v] = c2[u][v] = 0.f;
    for (int k = 0; k < K1; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = a1(i0 + u, k);
#pragma unroll
      for (int v = 0; v < TN; ++v) bv[v] = b1(k, tj + v * TJ);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) c1[u][v] = fmaf(av[u], bv[v], c1[u][v]);
    }
    for (int k = 0; k < K2; ++k) {
      float av[TM], bv[TN];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = a2(i0 + u, k);
#pragma unroll
      for (int v = 0; v < TN; ++v) bv[v] = b2(k, tj + v * TJ);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) c2[u][v] = fmaf(av[u], bv[v], c2[u][v]);
    }
#pragma unroll
    for (int u = 0; u < TM; ++u)
#pragma unroll
      for (int v = 0; v < TN; ++v) out(i0 + u, tj + v * TJ, c1[u][v], c2[u][v]);
  }
}
struct None {            // an empty second product
  __device__ float operator()(int, int) const { return 0.f; }
};

// rows [s0, s0 + Q) x columns [c0, c0 + cols) of a row-major source with
// `ld` words a row into a (TQB x width) tile with `lds` words a row,
// zeros elsewhere
__device__ __forceinline__ void load_rows(float* dst, int lds, int width,
                                          const float* src, long long ld,
                                          int Q, int cols) {
  for (int e = threadIdx.x; e < TQB * width; e += BT) {
    const int r = e / width, c = e - r * width;
    dst[r * lds + c] = (r < Q && c < cols) ? src[r * ld + c] : 0.f;
  }
}

// Pass 1: the state at the start of every chunk, into hst (BH, nch, P, N).
__global__ void __launch_bounds__(BT)
ssd_bwd_states(const float* __restrict__ xdt, const float* __restrict__ logd,
               const float* __restrict__ Bv, float* __restrict__ hst, int S,
               int P, int N, int heads, int PB) {
  extern __shared__ __align__(16) float sm[];
  const int NP = (N + 3) & ~3, LDP = PB + 1, LDN = NP + 1;
  float* Xs = sm;                      // TQB x LDP
  float* Bs = Xs + TQB * LDP;          // TQB x LDN
  float* hs = Bs + TQB * LDN;          // PB x LDN
  float* es = hs + PB * LDN;           // TQB: e_j
  float* dls = es + TQB;               // dl
  const long long bh = blockIdx.x, bc = bh / heads;
  const int pb0 = blockIdx.y * PB, pcols = min(PB, P - pb0);
  const int nch = (S + TQB - 1) / TQB;
  for (int e = threadIdx.x; e < PB * LDN; e += BT) hs[e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    const int s0 = c * TQB, Q = min(TQB, S - s0);
    __syncthreads();                   // the last update of h is done
    float* ho = hst + ((bh * nch + c) * P + pb0) * N;
    for (int e = threadIdx.x; e < pcols * N; e += BT)
      ho[e] = hs[(e / N) * LDN + e % N];
    load_rows(Xs, LDP, PB, xdt + (bh * S + s0) * P + pb0, P, Q, pcols);
    load_rows(Bs, LDN, NP, Bv + (bc * S + s0) * N, N, Q, N);
    if (threadIdx.x == 0) {            // e_j = exp(sum over keys > j)
      float s = 0.f;
      for (int j = TQB - 1; j >= 0; --j) {
        es[j] = expf(s);
        s += j < Q ? logd[bh * S + s0 + j] : 0.f;
      }
      dls[0] = expf(s);
    }
    __syncthreads();
    const float dl = dls[0];
    mm2<4, 2>(PB, NP, TQB,
              [&](int p, int k) { return Xs[k * LDP + p] * es[k]; },
              [&](int k, int n) { return Bs[k * LDN + n]; }, 0, None(), None(),
              [&](int p, int n, float a, float) {
                hs[p * LDN + n] = fmaf(dl, hs[p * LDN + n], a);
              });
  }
}

// Pass 2: the chunks backward.  dX final; dlogd, dB, dC this block's part.
__global__ void __launch_bounds__(BT, 2)
ssd_bwd_chunks(const float* __restrict__ xdt, const float* __restrict__ logd,
               const float* __restrict__ Bv, const float* __restrict__ Cv,
               const float* __restrict__ dy, const float* __restrict__ dhf,
               const float* __restrict__ hst, float* __restrict__ dxdt,
               float* __restrict__ dlp, float* __restrict__ dBp,
               float* __restrict__ dCp, int S, int P, int N, int heads,
               int PB) {
  extern __shared__ __align__(16) float sm[];
  const int NP = (N + 3) & ~3, LDP = PB + 1, LDN = NP + 1, LDQ = TQB + 1;
  float* Xs = sm;                      // TQB x LDP: xdt
  float* Ys = Xs + TQB * LDP;          // TQB x LDP: dy
  float* Bs = Ys + TQB * LDP;          // TQB x LDN
  float* Cs = Bs + TQB * LDN;          // TQB x LDN
  float* T1 = Cs + TQB * LDN;          // TQB x LDN: dY h0
  float* T2 = T1 + TQB * LDN;          // TQB x LDN: X G
  float* H0 = T2 + TQB * LDN;          // PB x LDN
  float* Gs = H0 + PB * LDN;           // PB x LDN
  float* Lm = Gs + PB * LDN;           // TQB x LDQ: L, then W's prefixes
  float* Mm = Lm + TQB * LDQ;          // TQB x LDQ: CB^T, then M
  float* Zm = Mm + TQB * LDQ;          // TQB x LDQ: dY X^T, then Z
  float* ls = Zm + TQB * LDQ;          // TQB: logd
  float* din = ls + TQB;               // TQB
  float* es = din + TQB;               // TQB
  float* us = es + TQB;                // TQB
  float* vs = us + TQB;                // TQB
  float* red = vs + TQB;               // 8 warps' <G, h0>, then dl
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x, bc = bh / heads;
  const int npb = gridDim.y, pb = blockIdx.y;
  const int pb0 = pb * PB, pcols = min(PB, P - pb0);
  const int nch = (S + TQB - 1) / TQB;
  for (int e = tid; e < PB * LDN; e += BT) {
    const int p = e / LDN, n = e - p * LDN;
    Gs[e] = (dhf && p < pcols && n < N) ? dhf[(bh * P + pb0 + p) * N + n]
                                        : 0.f;
  }
  for (int c = nch - 1; c >= 0; --c) {
    const int s0 = c * TQB, Q = min(TQB, S - s0);
    __syncthreads();                   // the previous chunk is done
    load_rows(Xs, LDP, PB, xdt + (bh * S + s0) * P + pb0, P, Q, pcols);
    load_rows(Ys, LDP, PB, dy + (bh * S + s0) * P + pb0, P, Q, pcols);
    load_rows(Bs, LDN, NP, Bv + (bc * S + s0) * N, N, Q, N);
    load_rows(Cs, LDN, NP, Cv + (bc * S + s0) * N, N, Q, N);
    const float* hp = hst + ((bh * nch + c) * P + pb0) * N;
    for (int e = tid; e < PB * LDN; e += BT) {
      const int p = e / LDN, n = e - p * LDN;
      H0[e] = (p < pcols && n < N) ? hp[p * N + n] : 0.f;
    }
    if (tid < TQB) ls[tid] = tid < Q ? logd[bh * S + s0 + tid] : 0.f;
    __syncthreads();

    // -- decays: L's column j by thread j; din and e by one thread each
    if (tid < TQB) {
      const int j = tid;
      float s = 0.f;
      for (int i = 0; i < j; ++i) Lm[i * LDQ + j] = 0.f;
      Lm[j * LDQ + j] = 1.f;
      for (int i = j + 1; i < TQB; ++i) {
        s += ls[i];
        Lm[i * LDQ + j] = expf(s);
      }
    } else if (tid == TQB) {
      float s = 0.f;
      for (int i = 0; i < TQB; ++i) {
        s += ls[i];
        din[i] = expf(s);
      }
    } else if (tid == 2 * TQB) {
      float s = 0.f;
      for (int j = TQB - 1; j >= 0; --j) {
        es[j] = expf(s);
        s += ls[j];
      }
      red[8] = expf(s);
    }
    // CB^T (C_i . B_j) and dY X^T (dy_i . x_j)
    mm2<4, 4>(TQB, TQB, NP, [&](int i, int k) { return Cs[i * LDN + k]; },
              [&](int k, int j) { return Bs[j * LDN + k]; }, PB,
              [&](int i, int k) { return Ys[i * LDP + k]; },
              [&](int k, int j) { return Xs[j * LDP + k]; },
              [&](int i, int j, float cb, float yx) {
                Mm[i * LDQ + j] = cb;
                Zm[i * LDQ + j] = yx;
              });
    __syncthreads();
    for (int e = tid; e < TQB * TQB; e += BT) {
      const int i = e / TQB, j = e - i * TQB;
      const float l = Lm[i * LDQ + j], cb = Mm[i * LDQ + j];
      const float z = Zm[i * LDQ + j] * l;
      Mm[i * LDQ + j] = cb * l;
      Zm[i * LDQ + j] = z;
      Lm[i * LDQ + j] = j < i ? z * cb : 0.f;      // W
    }
    __syncthreads();
    const float dl = red[8];

    // -- dX = M^T dY + e o (B G^T)
    float* dxo = dxdt + (bh * S + s0) * P + pb0;
    mm2<4, 4>(TQB, PB, TQB, [&](int j, int k) { return Mm[k * LDQ + j]; },
              [&](int k, int p) { return Ys[k * LDP + p]; }, NP,
              [&](int j, int n) { return Bs[j * LDN + n]; },
              [&](int n, int p) { return Gs[p * LDN + n]; },
              [&](int j, int p, float a, float b) {
                if (j < Q && p < pcols)
                  dxo[(long long)j * P + p] = fmaf(es[j], b, a);
              });
    // -- dC = din o (dY h0) + Z B, keeping dY h0
    float* dco = dCp + ((bh * npb + pb) * S + s0) * N;
    mm2<4, 2>(TQB, NP, PB, [&](int i, int k) { return Ys[i * LDP + k]; },
              [&](int k, int n) { return H0[k * LDN + n]; }, TQB,
              [&](int i, int k) { return Zm[i * LDQ + k]; },
              [&](int k, int n) { return Bs[k * LDN + n]; },
              [&](int i, int n, float t1, float zb) {
                T1[i * LDN + n] = t1;
                if (i < Q && n < N)
                  dco[(long long)i * N + n] = fmaf(din[i], t1, zb);
              });
    // -- dB = Z^T C + e o (X G), keeping X G
    float* dbo = dBp + ((bh * npb + pb) * S + s0) * N;
    mm2<4, 2>(TQB, NP, PB, [&](int j, int k) { return Xs[j * LDP + k]; },
              [&](int k, int n) { return Gs[k * LDN + n]; }, TQB,
              [&](int j, int k) { return Zm[k * LDQ + j]; },
              [&](int k, int n) { return Cs[k * LDN + n]; },
              [&](int j, int n, float t2, float zc) {
                T2[j * LDN + n] = t2;
                if (j < Q && n < N)
                  dbo[(long long)j * N + n] = fmaf(es[j], t2, zc);
              });
    // <G, h0>: each warp's part
    {
      float s = 0.f;
      for (int e = tid; e < PB * LDN; e += BT) s = fmaf(Gs[e], H0[e], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) red[warp] = s;
    }
    // W's rows: exclusive prefix sums over j, in place (row k by thread
    // 128 + k): Lm[k][i] = sum_{j < i} W[k][j] for i <= k
    if (tid >= 2 * TQB && tid < 3 * TQB) {
      const int k = tid - 2 * TQB;
      float s = 0.f;
      for (int i = 0; i <= k; ++i) {
        const float w = Lm[k * LDQ + i];
        Lm[k * LDQ + i] = s;
        s += w;
      }
    }
    __syncthreads();
    if (tid < TQB) {                   // u_k = din_k <C_k, (dY h0)_k>
      float s = 0.f;
      for (int n = 0; n < NP; ++n) s = fmaf(Cs[tid * LDN + n], T1[tid * LDN + n], s);
      us[tid] = din[tid] * s;
    } else if (tid < 2 * TQB) {        // v_j = e_j <B_j, (X G)_j>
      const int j = tid - TQB;
      float s = 0.f;
      for (int n = 0; n < NP; ++n) s = fmaf(Bs[j * LDN + n], T2[j * LDN + n], s);
      vs[j] = es[j] * s;
    }
    __syncthreads();
    // -- dlogd_i = sum_{k >= i} (W's prefix)[k][i] + sum_{k >= i} u_k
    //             + sum_{j < i} v_j + dl <G, h0>
    if (tid < TQB) {
      const int i = tid;
      float pw = 0.f, su = 0.f, sv = 0.f, gh = 0.f;
      for (int k = TQB - 1; k >= i; --k) {
        pw += Lm[k * LDQ + i];
        su += us[k];
      }
      for (int j = 0; j < i; ++j) sv += vs[j];
      for (int w = 0; w < BT / 32; ++w) gh += red[w];
      if (i < Q) dlp[(bh * npb + pb) * S + s0 + i] = pw + su + sv + dl * gh;
    }
    // -- G <- dl G + dY^T (din o C): the gradient of h0
    mm2<4, 2>(PB, NP, TQB,
              [&](int p, int k) { return Ys[k * LDP + p] * din[k]; },
              [&](int k, int n) { return Cs[k * LDN + n]; }, 0, None(), None(),
              [&](int p, int n, float a, float) {
                Gs[p * LDN + n] = fmaf(dl, Gs[p * LDN + n], a);
              });
  }
}

// Pass 3: dB, dC summed over the heads and the p blocks; dlogd over the p
// blocks.  One thread an output, in a fixed order.
__global__ void ssd_bwd_reduce(const float* __restrict__ dlp,
                               const float* __restrict__ dBp,
                               const float* __restrict__ dCp,
                               float* __restrict__ dlogd,
                               float* __restrict__ dB, float* __restrict__ dC,
                               long long BH, long long S, int N, int heads,
                               int npb) {
  const long long nb = BH / heads * S * N, nl = BH * S, SN = S * N;
  const long long total = 2 * nb + nl;
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

// The state rows p a block of the backward takes for these widths: the
// widest of 64, 32 and 16, not wider than P rounded up to 16, whose
// tiles fit shared memory; 0 when none does (the state is too wide).
int bwd_pblock(int P, int N) {
  if (P <= 0 || N <= 0) return 0;
  const int NP = (N + 3) & ~3;
  for (int pb = 64; pb >= 16; pb /= 2)
    if (pb <= (P + 15) / 16 * 16 && 4 * chunks_floats(pb, NP) <= SMEM_LIMIT &&
        4 * states_floats(pb, NP) <= SMEM_LIMIT)
      return pb;
  return 0;
}

// The backward's scratch, all float32, each part 256-byte aligned: hst
// (BH, ceil(S / 64), P, N), the chunk-start states; dlp (BH, npb, S), dBp
// and dCp (BH, npb, S, N), each block's partials, with npb = ceil(P /
// PB).  Sets the pointers into ws (when not NULL); returns its bytes.
struct BwdScratch {
  float *hst, *dlp, *dBp, *dCp;
};

size_t bwd_scratch(int BH, int S, int P, int N, int PB, char* ws,
                   BwdScratch* out) {
  const size_t npb = (P + PB - 1) / PB, nch = (S + TQB - 1) / TQB;
  size_t off = 0;
  auto take = [&](size_t floats) {
    float* p = ws == nullptr ? nullptr : (float*)(ws + off);
    off += (4 * floats + 255) / 256 * 256;
    return p;
  };
  out->hst = take((size_t)BH * nch * P * N);
  out->dlp = take((size_t)BH * npb * S);
  out->dBp = take((size_t)BH * npb * S * N);
  out->dCp = take((size_t)BH * npb * S * N);
  return off;
}

}  // namespace

// Bytes of ssd_bwd's workspace for these shapes; -1 when a P x N state
// fits no block of the kernel (N above 148).
extern "C" long long ssd_bwd_workspace(int BH, int S, int P, int N) {
  const int PB = bwd_pblock(P, N);
  if (!PB) return -1;
  BwdScratch sc;
  return (long long)bwd_scratch(BH, S, P, N, PB, nullptr, &sc);
}

// The gradient of ssd_fwd.  Inputs as ssd_fwd's, dy (BH, S, P) and
// dh_final (BH, P, N) or NULL (zero).  Outputs dxdt (BH, S, P), dlogd
// (BH, S), dB and dC (BH / heads, S, N).  ws: ssd_bwd_workspace(BH, S,
// P, N) bytes on the card, every byte written before it is read.  Three
// kernels on `stream`.
extern "C" int ssd_bwd(const void* xdt, const void* logd, const void* B,
                       const void* C, const void* dy, const void* dh_final,
                       void* dxdt, void* dlogd, void* dB, void* dC, void* ws,
                       int BH, int S, int P, int N, int heads, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
  if (P <= 0 || N <= 0 || heads <= 0 || BH % heads)
    return (int)cudaErrorInvalidValue;
  const int PB = bwd_pblock(P, N);
  if (!PB) return (int)cudaErrorInvalidValue;
  const int NP = (N + 3) & ~3, npb = (P + PB - 1) / PB;
  BwdScratch sc;
  bwd_scratch(BH, S, P, N, PB, (char*)ws, &sc);
  const size_t sm1 = 4 * states_floats(PB, NP), sm2 = 4 * chunks_floats(PB, NP);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_bwd_states, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_bwd_chunks,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm2);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(BH, npb);
  ssd_bwd_states<<<grid, BT, sm1, s>>>((const float*)xdt, (const float*)logd,
                                       (const float*)B, sc.hst, S, P, N,
                                       heads, PB);
  ssd_bwd_chunks<<<grid, BT, sm2, s>>>(
      (const float*)xdt, (const float*)logd, (const float*)B,
      (const float*)C, (const float*)dy, (const float*)dh_final, sc.hst,
      (float*)dxdt, sc.dlp, sc.dBp, sc.dCp, S, P, N, heads, PB);
  const long long total = 2LL * (BH / heads) * S * N + (long long)BH * S;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  ssd_bwd_reduce<<<blocks, 256, 0, s>>>(sc.dlp, sc.dBp, sc.dCp,
                                        (float*)dlogd, (float*)dB, (float*)dC,
                                        BH, S, N, heads, npb);
  return (int)cudaGetLastError();
}
