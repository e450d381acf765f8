// flash_attention: FlashAttention-2 style attention with explicit query and
// key positions, in two launch configurations (prefill and decode).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, _flash_kernel
// (:27) and its wrapper flash_attention_pallas (:92).  Same function: key
// j is visible to query i iff k_pos[j] >= 0, and k_pos[j] <= q_pos[i] when
// causal, and k_pos[j] > q_pos[i] - window when windowed; softmax over the
// visible keys in float32 with an online (running max, running sum)
// rescaling; the probabilities are rounded to v's type before the product
// with v, as the Pallas kernel does.  GQA: query head h reads kv head
// h / groups.  A query that sees no key gives 0 (the Pallas kernel's
// finite -1e30 mask would give the mean of the keys it visited).
//
// Layout: q, o (B, Sq, H, D) and k, v (B, Sk, Hkv, D), read through
// element strides (batch, head, position) with the last axis contiguous,
// so the wrapper transposes nothing.  float32 or bfloat16; D in
// {16, 32, 64, 128}.
//
// What bounds it on the H100.  Prefill (8 requests x 32 heads x 2,048
// positions, window 1,024): operations, ~1.0e11 flops a call over the
// visible keys against ~0.27 GB moved.  Decode (one query a head against
// a 1,024-slot ring): bytes, the whole K and V cache once (67 MB).
//
// What the design does about it.
// - Prefill: one block of 4 warps per (64 query rows, head, batch).  K/V
//   tiles of 64 keys are staged in shared memory; each warp owns 16 query
//   rows and keeps their running max and sum, and an f32 accumulator in
//   shared memory.  In bf16 both products run on the tensor cores through
//   WMMA (16x16x16, f32 accumulate); in float32 they are plain FMAs, so
//   that float32 stays float32 (no TF32).  A key tile that no query of the
//   block can see (all slots empty, or wholly outside the causal window by
//   the tile's min/max position) is skipped before it is loaded: for
//   causal windowed prefill that drops every tile outside the band.
// - Masking never forms -inf - -inf: a masked score is not exponentiated
//   (its probability is 0) and the running max starts at -1e30, finite.
// - Decode: one block of 256 threads per (head, batch).  Each thread
//   scores one key of a 256-key tile (16-byte loads of its K row); the
//   tile's max and sum are block reductions; then each thread accumulates
//   one output dimension over a share of the tile's keys, reading V rows
//   with neighbouring threads on neighbouring addresses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;          // query rows a prefill block
constexpr int BK = 64;          // keys a prefill tile
constexpr int PF_THREADS = 128;  // 4 warps x 16 query rows
constexpr int DEC_THREADS = 256;
constexpr int DEC_TILE = 256;   // keys a decode tile: one a thread
constexpr float NEG = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* qpos;
  const int* kpos;
  int B, H, groups, Sq, Sk;
  long long qs[3], ks[3], vs[3], os[3];  // batch, head, position strides
  float scale;
  int causal, window;                     // window <= 0: none
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool sees(int kp, int qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// prefill
// ---------------------------------------------------------------------------
template <typename T, int D> struct PF {
  static constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  // row strides (elements) of the shared tiles: bf16 rows are padded to a
  // multiple of 16 bytes for WMMA; float rows to an odd count of words, so
  // that lanes reading one column of 32 rows hit 32 banks
  static constexpr int LD = BF ? D + 8 : D + 1;     // Q, K, V tiles (T)
  static constexpr int LDP = BF ? BK + 8 : BK + 4;  // probabilities (T)
  static constexpr int LDS = BK + 4;                // scores (float)
  static constexpr int LDO = D + 4;                 // accumulator (float)
  static constexpr size_t al(size_t b) { return (b + 127) / 128 * 128; }
  static constexpr size_t Q_OFF = 0;
  static constexpr size_t K_OFF = Q_OFF + al(BQ * LD * sizeof(T));
  static constexpr size_t V_OFF = K_OFF + al(BK * LD * sizeof(T));
  static constexpr size_t S_OFF = V_OFF + al(BK * LD * sizeof(T));
  static constexpr size_t P_OFF = S_OFF + al(BQ * LDS * sizeof(float));
  static constexpr size_t O_OFF = P_OFF + al(BQ * LDP * sizeof(T));
  static constexpr size_t M_OFF = O_OFF + al(BQ * LDO * sizeof(float));
  static constexpr size_t I_OFF = M_OFF + al(3 * BQ * sizeof(float));
  static constexpr size_t SMEM = I_OFF + al((BQ + BK + 4) * sizeof(int));
};

// rows [0, nrows) of a (rows, D) tile from global memory (row stride
// `stride` elements) into shared memory with row stride LD; rows at or
// past `valid` are zero
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, int valid,
                                          int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  using P = Pack<T, VEC>;
  for (int i = threadIdx.x; i < nrows * CPR; i += PF_THREADS) {
    const int r = i / CPR, c = (i % CPR) * VEC;
    P v;
    if (r < valid) {
      v = *reinterpret_cast<const P*>(src + r * stride + c);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v.v[j] = from_f<T>(0.f);
    }
    if constexpr (LD % VEC == 0) {
      *reinterpret_cast<P*>(dst + r * LD + c) = v;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * LD + c + j] = v.v[j];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(PF_THREADS) prefill_kernel(Args a) {
  using L = PF<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::Q_OFF);
  T* Ks = reinterpret_cast<T*>(smem + L::K_OFF);
  T* Vs = reinterpret_cast<T*>(smem + L::V_OFF);
  float* Ss = reinterpret_cast<float*>(smem + L::S_OFF);
  T* Ps = reinterpret_cast<T*>(smem + L::P_OFF);
  float* Os = reinterpret_cast<float*>(smem + L::O_OFF);
  float* mrow = reinterpret_cast<float*>(smem + L::M_OFF);
  float* lrow = mrow + BQ;
  float* arow = lrow + BQ;
  int* qp = reinterpret_cast<int*>(smem + L::I_OFF);
  int* kp = qp + BQ;
  int* flag = kp + BK;            // [0] tile visible, [1] qmin, [2] qmax

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int hk = h / a.groups;
  const int nq = min(BQ, a.Sq - q0);
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];

  load_tile<T, D, L::LD>(Qs, q + q0 * a.qs[2], a.qs[2], nq, BQ);
  for (int i = tid; i < BQ; i += PF_THREADS) {
    qp[i] = a.qpos[q0 + min(i, nq - 1)];   // padding rows repeat the last
    mrow[i] = NEG;
    lrow[i] = 0.f;
  }
  for (int i = tid; i < BQ * L::LDO; i += PF_THREADS) Os[i] = 0.f;
  __syncthreads();
  if (warp == 0) {
    int lo = INT32_MAX, hi = INT32_MIN;
    for (int i = lane; i < nq; i += 32) {
      lo = min(lo, qp[i]);
      hi = max(hi, qp[i]);
    }
    lo = warp_min_i(lo);
    hi = warp_max_i(hi);
    if (lane == 0) {
      flag[1] = lo;
      flag[2] = hi;
    }
  }

  const int r0 = warp * 16;                // this warp's query rows
  for (int k0 = 0; k0 < a.Sk; k0 += BK) {
    const int nk = min(BK, a.Sk - k0);
    __syncthreads();                       // the last tile is consumed
    for (int i = tid; i < BK; i += PF_THREADS)
      kp[i] = i < nk ? a.kpos[k0 + i] : -1;
    __syncthreads();
    if (warp == 0) {                       // can any query see this tile?
      int lo = INT32_MAX, hi = -1;
      for (int i = lane; i < BK; i += 32) {
        if (kp[i] >= 0) {
          lo = min(lo, kp[i]);
          hi = max(hi, kp[i]);
        }
      }
      lo = warp_min_i(lo);
      hi = warp_max_i(hi);
      if (lane == 0)
        flag[0] = hi >= 0 && (!a.causal || lo <= flag[2]) &&
                  (a.window <= 0 || hi > flag[1] - a.window);
    }
    __syncthreads();
    if (!flag[0]) continue;
    load_tile<T, D, L::LD>(Ks, k + k0 * a.ks[2], a.ks[2], nk, BK);
    load_tile<T, D, L::LD>(Vs, v + k0 * a.vs[2], a.vs[2], nk, BK);
    __syncthreads();

    // scores of this warp's 16 rows against the tile's 64 keys
    if constexpr (L::BF) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fill_fragment(fc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::load_matrix_sync(fa, Qs + r0 * L::LD + kk * 16, L::LD);
          wmma::load_matrix_sync(fb, Ks + n * 16 * L::LD + kk * 16, L::LD);
          wmma::mma_sync(fc, fa, fb, fc);
        }
#pragma unroll
        for (int e = 0; e < fc.num_elements; ++e) fc.x[e] *= a.scale;
        wmma::store_matrix_sync(Ss + r0 * L::LDS + n * 16, fc, L::LDS,
                                wmma::mem_row_major);
      }
    } else {
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
    }
    __syncwarp();

    // online softmax over this warp's rows
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const int qpr = qp[r];
      float sv[BK / 32];
      bool vis[BK / 32];
      float tmax = NEG;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u;
        vis[u] = sees(kp[c], qpr, a.causal, a.window);
        sv[u] = Ss[r * L::LDS + c];
        if (vis[u]) tmax = fmaxf(tmax, sv[u]);
      }
      tmax = warp_max(tmax);
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, tmax);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = vis[u] ? expf(sv[u] - m_new) : 0.f;
        psum += p;
        Ps[r * L::LDP + lane + 32 * u] = from_f<T>(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        arow[r] = alpha;
        mrow[r] = m_new;
        lrow[r] = lrow[r] * alpha + psum;
      }
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const float alpha = arow[r0 + rr];
      for (int d = lane; d < D; d += 32) Os[(r0 + rr) * L::LDO + d] *= alpha;
    }
    __syncwarp();

    // accumulator += P V for this warp's rows
    if constexpr (L::BF) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        float* op = Os + r0 * L::LDO + n * 16;
        wmma::load_matrix_sync(fc, op, L::LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(fa, Ps + r0 * L::LDP + kk * 16, L::LDP);
          wmma::load_matrix_sync(fb, Vs + kk * 16 * L::LD + n * 16, L::LD);
          wmma::mma_sync(fc, fa, fb, fc);
        }
        wmma::store_matrix_sync(op, fc, L::LDO, wmma::mem_row_major);
      }
    } else {
      for (int rr = 0; rr < 16; ++rr) {
        const float* prow = Ps + (r0 + rr) * L::LDP;
        for (int d = lane; d < D; d += 32) {
          float acc = 0.f;
#pragma unroll 16
          for (int j = 0; j < BK; ++j) acc += prow[j] * Vs[j * L::LD + d];
          Os[(r0 + rr) * L::LDO + d] += acc;
        }
      }
    }
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    if (r >= nq) break;
    const float l = lrow[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    for (int d = lane; d < D; d += 32)
      o[(q0 + r) * a.os[2] + d] = from_f<T>(Os[r * L::LDO + d] * inv);
  }
}

// ---------------------------------------------------------------------------
// decode (one query a head)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < DEC_THREADS / 32; ++i) r = fmaxf(r, red[i]);
  return r;
}
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < DEC_THREADS / 32; ++i) r += red[i];
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS) decode_kernel(Args a) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NG = DEC_THREADS / D;      // key groups of the V pass
  using P = Pack<T, VEC>;
  __shared__ float qs[D];
  __shared__ float pr[DEC_TILE];
  __shared__ float red[DEC_THREADS / 32];
  __shared__ float accs[DEC_THREADS];
  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.groups;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];
  const int qpos = a.qpos[0];
  for (int d = tid; d < D; d += DEC_THREADS) qs[d] = to_f(q[d]);
  __syncthreads();

  float m = NEG, l = 0.f, acc = 0.f;
  const int d = tid % D, g = tid / D;
  for (int k0 = 0; k0 < a.Sk; k0 += DEC_TILE) {
    const int j = k0 + tid;
    bool vis = false;
    float s = NEG;
    if (j < a.Sk && sees(a.kpos[j], qpos, a.causal, a.window)) {
      vis = true;
      const T* krow = k + j * a.ks[2];
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; c += VEC) {
        const P kv = *reinterpret_cast<const P*>(krow + c);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += qs[c + e] * to_f(kv.v[e]);
      }
      s = dot * a.scale;
    }
    if (!__syncthreads_or(vis)) continue;
    const float m_new = fmaxf(m, block_max(vis ? s : NEG, red));
    const float alpha = expf(m - m_new);
    const float p = vis ? expf(s - m_new) : 0.f;
    pr[tid] = to_f(from_f<T>(p));           // rounded as v's type
    l = l * alpha + block_sum(p, red);      // (its syncs publish pr)
    m = m_new;
    const int nk = min(DEC_TILE, a.Sk - k0);
    float part = 0.f;
    for (int jj = g; jj < nk; jj += NG)
      part += pr[jj] * to_f(v[(k0 + jj) * a.vs[2] + d]);
    acc = acc * alpha + part;
    __syncthreads();                        // pr is consumed
  }
  accs[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float out = 0.f;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) out += accs[gg * D + tid];
    o[tid] = from_f<T>(l > 0.f ? out / l : 0.f);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t st) {
  if (a.Sq == 1) {
    decode_kernel<T, D><<<dim3(a.H, a.B), DEC_THREADS, 0, st>>>(a);
  } else {
    const size_t smem = PF<T, D>::SMEM;
    const cudaError_t e = cudaFuncSetAttribute(
        prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    prefill_kernel<T, D>
        <<<dim3((a.Sq + BQ - 1) / BQ, a.H, a.B), PF_THREADS, smem, st>>>(a);
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

}  // namespace

// Strides are in elements, in the order (batch, head, position) for q, k,
// v and o; the last axis is contiguous.  dtype 0 = float32, 1 = bfloat16.
// Sq == 1 runs the decode configuration, any other Sq the prefill one.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* qpos,
    const void* kpos, int B, int H, int groups, int Sq, int Sk, int D,
    long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
    long long kss, long long vsb, long long vsh, long long vss, long long osb,
    long long osh, long long oss, float scale, int causal, int window,
    int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return (int)cudaGetLastError();
  if (groups <= 0 || H % groups) return (int)cudaErrorInvalidValue;
  Args a{q,   k,      v,  o,  (const int*)qpos, (const int*)kpos,
         B,   H,      groups, Sq, Sk,
         {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss}, {osb, osh, oss},
         scale, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_d<float>(a, D, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, D, st);
  return (int)cudaErrorInvalidValue;
}
