// ssd: the chunked Mamba-2 SSD scan (state-space duality).
//
// Replaces: src/repro/kernels/mamba2_ssd/kernel.py, _ssd_kernel (:22) and
// its wrapper ssd_pallas (:75).  Same function, per row bh of (BH, S):
// within a chunk of Q tokens, with cs = cumsum(logd) over the chunk,
//   y_i = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) xdt_j
//         + exp(cs_i) (C_i . h)                       (h: carried (P, N))
//   h'  = h exp(cs_last) + sum_j exp(cs_last - cs_j) xdt_j (x) B_j
// and returns y (without the D skip) and the final state.  All float32.
// B and C may be shared by `heads` consecutive rows (Mamba-2's ngroups =
// 1): row bh reads B and C row bh / heads.
//
// What bounds it on the H100: float32 operations without tensor cores
// (TF32 would not keep float32), ~20 Gflop a call at Hymba's prefill
// shapes (400 rows x 2,048 tokens, P = 64, N = 16, chunk 256) against
// ~0.42 GB of xdt in and y out.
//
// What the design does about it.  One block per row; a loop over the
// chunks inside the block carries h in shared memory, in place of the
// TPU's sequential grid axis.  The Pallas kernel holds a whole Q x Q tile
// of (C B^T) * L in VMEM; at Q = 256 that is 256 KB of float32, more than
// a block's 227 KB of shared memory, so the chunk is tiled: 64 query rows
// against 64 key rows at a time, and only tiles on or below the diagonal
// are computed.  Shared rows of B, C and h are padded to N + 1 words so
// that lanes reading one column hit distinct banks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;          // query rows a tile
constexpr int TK = 64;          // key rows a tile
constexpr int THREADS = 256;
constexpr int MAXH = 32;        // state entries a thread: P * N <= 8192

__global__ void __launch_bounds__(THREADS)
ssd_kernel(const float* __restrict__ xdt, const float* __restrict__ logd,
           const float* __restrict__ Bv, const float* __restrict__ Cv,
           float* __restrict__ y, float* __restrict__ hfin, int S, int P,
           int N, int chunk, int heads) {
  extern __shared__ float sm[];
  const int NP = N + 1;
  float* h = sm;                         // P x NP
  float* cs = h + P * NP;                // chunk
  float* dec = cs + chunk;               // chunk: exp(cs_last - cs_j)
  float* Ct = dec + chunk;               // TQ x NP
  float* Bt = Ct + TQ * NP;              // TK x NP
  float* Xt = Bt + TK * NP;              // TK x P
  float* G = Xt + TK * P;                // TQ x (TK + 1)
  float* Yt = G + TQ * (TK + 1);         // TQ x P

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long bh = blockIdx.x, bc = bh / heads;
  const float* x = xdt + bh * S * P;
  const float* ld = logd + bh * S;
  const float* Bp = Bv + bc * S * N;
  const float* Cp = Cv + bc * S * N;
  float* yo = y + bh * S * P;
  const int PN = P * N;

  for (int e = tid; e < P * NP; e += THREADS) h[e] = 0.f;

  for (int s0 = 0; s0 < S; s0 += chunk) {
    const int Q = min(chunk, S - s0);
    __syncthreads();
    if (warp == 0) {                      // inclusive cumsum of logd
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        float v = i < Q ? ld[s0 + i] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += t;
        }
        v += carry;
        if (i < Q) cs[i] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cl = cs[Q - 1];
    for (int i = tid; i < Q; i += THREADS) dec[i] = expf(cl - cs[i]);

    // -- outputs, 64 query rows at a time
    for (int qt = 0; qt < Q; qt += TQ) {
      const int nq = min(TQ, Q - qt);
      __syncthreads();
      for (int e = tid; e < TQ * N; e += THREADS) {
        const int i = e / N, n = e % N;
        Ct[i * NP + n] = i < nq ? Cp[(long long)(s0 + qt + i) * N + n] : 0.f;
      }
      for (int e = tid; e < TQ * P; e += THREADS) Yt[e] = 0.f;
      for (int kt = 0; kt < qt + nq; kt += TK) {
        const int nk = min(TK, Q - kt);
        __syncthreads();
        for (int e = tid; e < TK * N; e += THREADS) {
          const int j = e / N, n = e % N;
          Bt[j * NP + n] = j < nk ? Bp[(long long)(s0 + kt + j) * N + n] : 0.f;
        }
        for (int e = tid; e < TK * P; e += THREADS) {
          const int j = e / P;
          Xt[e] = j < nk ? x[(long long)(s0 + kt) * P + e] : 0.f;
        }
        __syncthreads();
        // G = (C B^T) * L on this tile, zero above the diagonal
        for (int e = tid; e < TQ * TK; e += THREADS) {
          const int i = e / TK, j = e % TK;
          const int gi = qt + i, gj = kt + j;
          float g = 0.f;
          if (i < nq && j < nk && gj <= gi) {
            float dot = 0.f;
            for (int n = 0; n < N; ++n) dot += Ct[i * NP + n] * Bt[j * NP + n];
            g = dot * expf(cs[gi] - cs[gj]);
          }
          G[i * (TK + 1) + j] = g;
        }
        __syncthreads();
        for (int e = tid; e < TQ * P; e += THREADS) {
          const int i = e / P, p = e % P;
          float acc = 0.f;
          for (int j = 0; j < nk; ++j) acc += G[i * (TK + 1) + j] * Xt[j * P + p];
          Yt[e] += acc;
        }
      }
      __syncthreads();
      // + the carried state's part, then out
      for (int e = tid; e < nq * P; e += THREADS) {
        const int i = e / P, p = e % P;
        float acc = 0.f;
        for (int n = 0; n < N; ++n) acc += Ct[i * NP + n] * h[p * NP + n];
        yo[(long long)(s0 + qt) * P + e] = Yt[e] + expf(cs[qt + i]) * acc;
      }
    }

    // -- state update: h = h exp(cs_last) + sum_j dec_j xdt_j (x) B_j
    float acc[MAXH];
#pragma unroll
    for (int u = 0; u < MAXH; ++u) acc[u] = 0.f;
    for (int kt = 0; kt < Q; kt += TK) {
      const int nk = min(TK, Q - kt);
      __syncthreads();
      for (int e = tid; e < TK * N; e += THREADS) {
        const int j = e / N, n = e % N;
        Bt[j * NP + n] = j < nk ? Bp[(long long)(s0 + kt + j) * N + n] : 0.f;
      }
      for (int e = tid; e < TK * P; e += THREADS) {
        const int j = e / P;
        Xt[e] = j < nk ? x[(long long)(s0 + kt) * P + e] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < MAXH; ++u) {
        const int e = tid + u * THREADS;
        if (e < PN) {
          const int p = e / N, n = e % N;
          float a = 0.f;
          for (int j = 0; j < nk; ++j)
            a += dec[kt + j] * Xt[j * P + p] * Bt[j * NP + n];
          acc[u] += a;
        }
      }
    }
    __syncthreads();                      // every read of the old h is done
    const float dl = expf(cl);
#pragma unroll
    for (int u = 0; u < MAXH; ++u) {
      const int e = tid + u * THREADS;
      if (e < PN) {
        const int p = e / N, n = e % N;
        h[p * NP + n] = h[p * NP + n] * dl + acc[u];
      }
    }
  }
  __syncthreads();
  float* hf = hfin + bh * PN;
  for (int e = tid; e < PN; e += THREADS) hf[e] = h[(e / N) * NP + e % N];
}

}  // namespace

// xdt (BH, S, P), logd (BH, S), B and C (BH / heads, S, N), y (BH, S, P),
// hfin (BH, P, N); all float32, contiguous.  Shared memory a block:
// 4 * (P (N+1) + 2 chunk + 2 * 64 (N+1) + 64 P + 64 * 65 + 64 P) bytes.
extern "C" int ssd_fwd(const void* xdt, const void* logd, const void* B,
                       const void* C, void* y, void* hfin, int BH, int S,
                       int P, int N, int chunk, int heads, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaGetLastError();
  if (P <= 0 || N <= 0 || P * N > THREADS * MAXH || chunk <= 0 ||
      heads <= 0 || BH % heads)
    return (int)cudaErrorInvalidValue;
  const int c = chunk < S ? chunk : S;
  const size_t smem = sizeof(float) *
      ((size_t)P * (N + 1) + 2 * (size_t)c + 2 * (size_t)TQ * (N + 1) +
       (size_t)TK * P + (size_t)TQ * (TK + 1) + (size_t)TQ * P);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<<<BH, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)xdt, (const float*)logd, (const float*)B,
      (const float*)C, (float*)y, (float*)hfin, S, P, N, c, heads);
  return (int)cudaGetLastError();
}
