// rmsnorm: fused residual add + RMSNorm over the rows of a (T, D) matrix.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, _rms_kernel (:16) and its
// wrapper rmsnorm_pallas (:30).  Same function: s = x + r in float32 (r
// optional), y = s * rsqrt(mean(s^2) + eps) * w, both outputs rounded to
// x's type; returns y and s.  float32 or bfloat16, chosen at run time.
//
// What bounds it on the H100: bytes.  Per row it reads x, r and w and
// writes y and s (2 * D bytes each in bf16) for about 4 flops an element,
// far below the card's ~295 flops a byte.  At the decode shape (8 rows,
// ~105 KB) the bytes take ~0.03 us and what is left is latency: the launch
// and the chain of dependent loads, reductions and stores.
//
// Two forms, chosen by the launcher from the shape, both a block of
// THREADS threads a row:
// - the register form, for at most REG_ROWS rows (where the two forms'
//   times cross on an H100) of at most REG_MAX_VECS
//   16-byte vectors a thread: each thread loads its vectors of x, r and w
//   at once, none under a branch, and keeps them in registers; one warp-
//   shuffle and shared-memory reduction of the sum of squares, one
//   __syncthreads, then x + r is formed again in float32 for the scaling
//   pass.  So w's load overlaps x's and r's, and no row goes through
//   shared memory.  It is launched with cudaLaunchKernelEx and
//   programmatic stream serialization (Hopper's programmatic dependent
//   launch): the kernel then starts while the previous kernel
//   on the stream drains, prefetches w into L2 (a prefetch returns no
//   data, so it cannot see a w that kernel is still writing), and waits
//   (griddepcontrol.wait) before its first load.  It lets its own
//   dependents start at once (griddepcontrol.launch_dependents): they wait
//   in turn before reading its outputs.
// - the shared-memory form, for more rows (prefill) or wider rows: each
//   thread moves 16 bytes a load (8 bf16 or 4 float), neighbouring
//   threads on neighbouring addresses.  The float32 sum s is kept in
//   shared memory (D floats) between the sum-of-squares pass and the
//   scaling pass, so x and r are read once; the sum of squares is reduced
//   in float32 with warp shuffles.
// A warp a row, the row in a lane's registers, was tried and was slower
// than either at every row count: 8 rows are 8 warps on the whole card,
// and each lane runs ~50 elements' arithmetic in sequence.
//
// The backward (rmsnorm_bwd, the port's own: the JAX package has no
// backward kernel and differentiates its XLA RMSNorm).  Given dy and, in
// the residual form, d(x + r): with s = x + r in float32, inv =
// rsqrt(mean(s^2) + eps) and n = s * inv,
//   ds = inv * dy * w - s * inv^3 * sum(dy * w * s) / D  (+ d(x + r)),
//   dx = d(residual) = ds,  dw = sum over rows of dy * n.
// Bounded by bytes: it reads x, r, dy, d(x + r) and w and writes dx, for
// ~12 flops an element (16,384 x 1,024 bf16: 168 MB, 50 us at 3.35 TB/s).
// Two forms, chosen by the launcher from the width, as the forward
// chooses its two:
// - the register form, for rows of at most REG_BWD_VECS 16-byte vectors
//   a lane (1,024 bf16, 512 float32): a warp a row.  A lane loads its
//   vectors of x, r, dy and d(x + r) once, every load issued before the
//   row's arithmetic, and keeps them in registers; the two sums (s^2 and
//   dy w s) are warp shuffles, with no block barrier; dx is written from
//   the registers.  The warps of a grid of G blocks (as many as fit on
//   the card at once) walk the rows; with 8 warps a block and ~8 KB of
//   loads in flight a warp, the resident warps keep enough bytes in
//   flight to draw the card's bandwidth, so no warp prefetches its next
//   row.  Each lane keeps its columns of dw in registers sized for its
//   width (a template on vectors a lane), w once a warp.
// - the shared-memory form, for wider rows and widths that are not a
//   multiple of 16 bytes: a block a row, its threads as many as the row
//   has vectors (up to 256), so none sits idle through the barriers.  One
//   pass reads x, r and dy once, keeps s and dy in shared memory (float32)
//   and reduces the two sums across the block; the second pass reads them
//   back (each thread its own elements) with d(x + r) and writes dx.  w is
//   read once a block into shared memory, and the block's columns of dw
//   are summed there.
// Each block writes its partial dw (the register form sums its warps'
// shares in shared memory in warp order first); a second kernel adds the
// G partials of each column in block order.  No float atomics: the
// result does not depend on the order in which blocks run, and two calls
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;

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

// VEC elements of T moved as one load or store
template <typename T, int VEC> struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const T* __restrict__ w, T* __restrict__ y,
               T* __restrict__ res, int D, float eps) {
  extern __shared__ float s[];            // the row's float32 x + r
  __shared__ float red[THREADS / 32];
  using P = Pack<T, VEC>;
  const long long off = (long long)blockIdx.x * D;
  float sq = 0.f;
  for (int i = threadIdx.x * VEC; i < D; i += THREADS * VEC) {
    const P xv = *reinterpret_cast<const P*>(x + off + i);
    P rv, sv;
    if (r != nullptr) rv = *reinterpret_cast<const P*>(r + off + i);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = to_f(xv.v[j]);
      if (r != nullptr) v += to_f(rv.v[j]);
      s[i + j] = v;
      sq += v * v;
      sv.v[j] = from_f<T>(v);
    }
    if (res != nullptr) *reinterpret_cast<P*>(res + off + i) = sv;
  }
  sq = warp_sum(sq);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sq;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < THREADS / 32; ++k) tot += red[k];
  const float inv = rsqrtf(tot / (float)D + eps);
  // each thread reads back only the elements of s it wrote itself
  for (int i = threadIdx.x * VEC; i < D; i += THREADS * VEC) {
    const P wv = *reinterpret_cast<const P*>(w + i);
    P yv;
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      yv.v[j] = from_f<T>(s[i + j] * inv * to_f(wv.v[j]));
    *reinterpret_cast<P*>(y + off + i) = yv;
  }
}

// ---------------------------------------------------------------------------
// the register form: a block a row, the row in registers
// ---------------------------------------------------------------------------
constexpr int REG_MAX_VECS = 8;        // 16-byte vectors a thread holds at most
// at most this many rows take the register form, more the shared-memory
// form: on an H100 at D = 1,600 the register form is faster up to 64 rows
// and slower from 128 (CUDA events)
constexpr long long REG_ROWS = 64;

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(THREADS)
rmsnorm_reg_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ w, T* __restrict__ y,
                   T* __restrict__ res, int D, float eps) {
  __shared__ float red[THREADS / 32];
  using P = Pack<T, VEC>;
  const int t = threadIdx.x;
  // w into L2 before the wait: a 128-byte line a thread and step
  const char* wb = reinterpret_cast<const char*>(w);
  for (int o = t * 128; o < D * (int)sizeof(T); o += THREADS * 128)
    asm volatile("prefetch.L2 [%0];" ::"l"(wb + o));
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long off = (long long)blockIdx.x * D;
  // every load first, none of them under a branch, so that all 3 * NV are
  // in flight at once: a thread past the row's end reads its last vector
  // and stores nothing; without a residual, x stands in for r, unused
  const bool has_r = r != nullptr;
  const T* rr = has_r ? r : x;
  P xv[NV], rv[NV], wv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = min((j * THREADS + t) * VEC, D - VEC);
    xv[j] = *reinterpret_cast<const P*>(x + off + i);
    rv[j] = *reinterpret_cast<const P*>(rr + off + i);
    wv[j] = *reinterpret_cast<const P*>(w + i);
  }
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = (j * THREADS + t) * VEC;
    P sv;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a = to_f(xv[j].v[e]);
      const float v = has_r ? a + to_f(rv[j].v[e]) : a;
      if (i < D) sq += v * v;
      sv.v[e] = from_f<T>(v);
    }
    if (res != nullptr && i < D) *reinterpret_cast<P*>(res + off + i) = sv;
  }
  sq = warp_sum(sq);
  if ((t & 31) == 0) red[t >> 5] = sq;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int k = 0; k < THREADS / 32; ++k) tot += red[k];
  const float inv = rsqrtf(tot / (float)D + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = (j * THREADS + t) * VEC;
    if (i >= D) continue;
    P yv;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a = to_f(xv[j].v[e]);
      const float v = has_r ? a + to_f(rv[j].v[e]) : a;
      yv.v[e] = from_f<T>(v * inv * to_f(wv[j].v[e]));
    }
    *reinterpret_cast<P*>(y + off + i) = yv;
  }
}

template <typename T, int VEC, int NV>
int launch_reg(const void* x, const void* r, const void* w, void* y,
               void* res, long long T_, int D, float eps, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)T_);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, rmsnorm_reg_kernel<T, VEC, NV>, (const T*)x, (const T*)r,
      (const T*)w, (T*)y, (T*)res, D, eps);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// the register form's kernel for nv vectors a thread (1 <= nv <=
// REG_MAX_VECS)
template <typename T, int VEC, int NV = 1>
int dispatch_reg(int nv, const void* x, const void* r, const void* w,
                 void* y, void* res, long long T_, int D, float eps,
                 cudaStream_t st) {
  if constexpr (NV < REG_MAX_VECS) {
    if (nv > NV)
      return dispatch_reg<T, VEC, NV + 1>(nv, x, r, w, y, res, T_, D, eps,
                                          st);
  }
  return launch_reg<T, VEC, NV>(x, r, w, y, res, T_, D, eps, st);
}

template <typename T>
int launch(const void* x, const void* r, const void* w, void* y, void* res,
           long long T_, int D, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = (D + THREADS * VEC - 1) / (THREADS * VEC);
  if (T_ <= REG_ROWS && D % VEC == 0 && nv <= REG_MAX_VECS)
    return dispatch_reg<T, VEC>(nv, x, r, w, y, res, T_, D, eps, st);
  const size_t smem = (size_t)D * sizeof(float);
  void (*kernel)(const T*, const T*, const T*, T*, T*, int, float) =
      D % VEC == 0 ? rmsnorm_kernel<T, VEC> : rmsnorm_kernel<T, 1>;
  // with the static `red`, rows past 12,280 floats need more than the
  // 48 KB a block gets unasked
  if (smem + sizeof(float) * (THREADS / 32) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)T_, THREADS, smem, st>>>(
      (const T*)x, (const T*)r, (const T*)w, (T*)y, (T*)res, D, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------
constexpr int MAX_D = 12288;
constexpr int BWD_WARPS = 8;              // the register form's warps a block
constexpr int REG_BWD_VECS = 4;           // its 16-byte vectors a lane at most

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(32 * BWD_WARPS)
rmsnorm_bwd_reg_kernel(const T* __restrict__ x, const T* __restrict__ r,
                       const T* __restrict__ w, const T* __restrict__ dy,
                       const T* __restrict__ dres, T* __restrict__ dx,
                       float* __restrict__ part, long long T_, int D,
                       float eps) {
  extern __shared__ float red[];          // (BWD_WARPS, D): the warps' dw
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool has_r = r != nullptr, has_d = dres != nullptr;
  // lane's vector j covers columns [(32 j + lane) VEC, + VEC); a lane past
  // the row's end reads the last vector and adds and stores nothing
  int col[NV];
  bool in[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = (32 * j + lane) * VEC;
    in[j] = i < D;
    col[j] = min(i, D - VEC);
  }
  P wv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) wv[j] = *reinterpret_cast<const P*>(w + col[j]);
  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j][e] = 0.f;
  const float inv_d = 1.f / (float)D;
  for (long long row = (long long)blockIdx.x * BWD_WARPS + warp; row < T_;
       row += (long long)gridDim.x * BWD_WARPS) {
    const long long off = row * D;
    P xv[NV], rv[NV], gv[NV], dv[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      xv[j] = *reinterpret_cast<const P*>(x + off + col[j]);
      gv[j] = *reinterpret_cast<const P*>(dy + off + col[j]);
      if (has_r) rv[j] = *reinterpret_cast<const P*>(r + off + col[j]);
      if (has_d) dv[j] = *reinterpret_cast<const P*>(dres + off + col[j]);
    }
    float sv[NV][VEC], ss = 0.f, sd = 0.f;   // s, sum s^2, sum dy w s
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = to_f(xv[j].v[e]);
        if (has_r) v += to_f(rv[j].v[e]);
        sv[j][e] = v;
        if (in[j]) {
          ss += v * v;
          sd += to_f(gv[j].v[e]) * to_f(wv[j].v[e]) * v;
        }
      }
    ss = warp_sum(ss);
    sd = warp_sum(sd);
    const float inv = rsqrtf(ss * inv_d + eps);
    const float c = inv * inv * inv * sd * inv_d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      P ov;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float g = to_f(gv[j].v[e]);
        float ds = inv * g * to_f(wv[j].v[e]) - c * sv[j][e];
        if (has_d) ds += to_f(dv[j].v[e]);
        ov.v[e] = from_f<T>(ds);
        acc[j][e] += g * sv[j][e] * inv;
      }
      if (in[j]) *reinterpret_cast<P*>(dx + off + col[j]) = ov;
    }
  }
  // the block's dw: its warps' shares added in warp order
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (in[j])
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[warp * D + col[j] + e] = acc[j][e];
  __syncthreads();
  for (int i = threadIdx.x; i < D; i += 32 * BWD_WARPS) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_WARPS; ++k) sum += red[k * D + i];
    part[(long long)blockIdx.x * D + i] = sum;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_smem_kernel(const T* __restrict__ x, const T* __restrict__ r,
                        const T* __restrict__ w, const T* __restrict__ dy,
                        const T* __restrict__ dres, T* __restrict__ dx,
                        float* __restrict__ part, long long T_, int D,
                        float eps) {
  // float32 (D,) each: s and dy of the current row, w, the block's dw
  extern __shared__ float sm[];
  float* ss_ = sm;
  float* gs = sm + D;
  float* ws = sm + 2 * D;
  float* acc = sm + 3 * D;
  __shared__ float red[2][2][THREADS / 32];
  using P = Pack<T, VEC>;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5;
  const bool has_r = r != nullptr, has_d = dres != nullptr;
  for (int i = t * VEC; i < D; i += nt * VEC) {
    const P wv = *reinterpret_cast<const P*>(w + i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ws[i + e] = to_f(wv.v[e]);
      acc[i + e] = 0.f;
    }
  }
  const float inv_d = 1.f / (float)D;
  int par = 0;
  for (long long row = blockIdx.x; row < T_; row += gridDim.x, par ^= 1) {
    const long long off = row * D;
    float ss = 0.f, sd = 0.f;
    for (int i = t * VEC; i < D; i += nt * VEC) {
      const P xv = *reinterpret_cast<const P*>(x + off + i);
      const P gv = *reinterpret_cast<const P*>(dy + off + i);
      P rv;
      if (has_r) rv = *reinterpret_cast<const P*>(r + off + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = to_f(xv.v[e]);
        if (has_r) v += to_f(rv.v[e]);
        const float g = to_f(gv.v[e]);
        ss_[i + e] = v;
        gs[i + e] = g;
        ss += v * v;
        sd += g * ws[i + e] * v;
      }
    }
    ss = warp_sum(ss);
    sd = warp_sum(sd);
    if (lane == 0) {
      red[par][0][warp] = ss;
      red[par][1][warp] = sd;
    }
    // one barrier a row: red alternates between two buffers, and each
    // thread reads back only the elements of s and dy it wrote
    __syncthreads();
    float tss = 0.f, tsd = 0.f;
    for (int k = 0; k < (nt + 31) / 32; ++k) {
      tss += red[par][0][k];
      tsd += red[par][1][k];
    }
    const float inv = rsqrtf(tss * inv_d + eps);
    const float c = inv * inv * inv * tsd * inv_d;
    for (int i = t * VEC; i < D; i += nt * VEC) {
      P dv, ov;
      if (has_d) dv = *reinterpret_cast<const P*>(dres + off + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = ss_[i + e], g = gs[i + e];
        float ds = inv * g * ws[i + e] - c * v;
        if (has_d) ds += to_f(dv.v[e]);
        ov.v[e] = from_f<T>(ds);
        acc[i + e] += g * v * inv;
      }
      *reinterpret_cast<P*>(dx + off + i) = ov;
    }
  }
  // each thread wrote only its own columns of acc
  float* pb = part + (long long)blockIdx.x * D;
  for (int i = t * VEC; i < D; i += nt * VEC)
#pragma unroll
    for (int e = 0; e < VEC; ++e) pb[i + e] = acc[i + e];
}

// dw[i] = the G blocks' partials of column i, added in block order
template <typename T>
__global__ void rmsnorm_dw_kernel(const float* __restrict__ part, int G,
                                  int D, T* __restrict__ dw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int g = 0; g < G; ++g) s += part[(long long)g * D + i];
  dw[i] = from_f<T>(s);
}

// the backward's form for (D, T's vector width): its kernel, threads a
// block, rows a block at once and shared memory
struct BwdForm {
  const void* kernel;
  int threads, rows;
  size_t smem;
};

template <typename T, int VEC, int NV = 1>
BwdForm reg_form(int nv, int D) {
  if constexpr (NV < REG_BWD_VECS) {
    if (nv > NV) return reg_form<T, VEC, NV + 1>(nv, D);
  }
  return {(const void*)rmsnorm_bwd_reg_kernel<T, VEC, NV>, 32 * BWD_WARPS,
          BWD_WARPS, (size_t)BWD_WARPS * D * sizeof(float)};
}

template <typename T>
BwdForm bwd_form(int D) {
  constexpr int VEC = 16 / sizeof(T);
  const int nv = (D + 32 * VEC - 1) / (32 * VEC);
  if (D % VEC == 0 && nv <= REG_BWD_VECS) return reg_form<T, VEC>(nv, D);
  const int vec = D % VEC == 0 ? VEC : 1;
  const int vecs = D / vec;
  const int threads = min(THREADS, (vecs + 31) / 32 * 32);
  return {vec == VEC ? (const void*)rmsnorm_bwd_smem_kernel<T, VEC>
                     : (const void*)rmsnorm_bwd_smem_kernel<T, 1>,
          threads, 1, (size_t)4 * D * sizeof(float)};
}

// blocks of the backward's grid: as many as the card holds at once, and
// no more than the rows need
template <typename T>
int bwd_blocks(long long T_, int D) {
  const BwdForm f = bwd_form<T>(D);
  cudaError_t e = cudaFuncSetAttribute(
      f.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f.smem);
  if (e != cudaSuccess) return -(int)e;
  int dev = 0, sms = 0, per = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return -(int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return -(int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per, f.kernel, f.threads, f.smem)) != cudaSuccess)
    return -(int)e;
  const long long need = (T_ + f.rows - 1) / f.rows;
  return (int)std::max(1LL, std::min(need, (long long)std::max(per, 1) * sms));
}

template <typename T>
int launch_bwd(const void* x, const void* r, const void* w, const void* dy,
               const void* dres, void* dx, float* part, void* dw,
               long long T_, int D, int G, float eps, cudaStream_t st) {
  if (G > 0) {
    const BwdForm f = bwd_form<T>(D);
    cudaError_t err = cudaFuncSetAttribute(
        f.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f.smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&x, (void*)&r,    (void*)&w, (void*)&dy,
                    (void*)&dres, (void*)&dx, (void*)&part, (void*)&T_,
                    (void*)&D,  (void*)&eps};
    err = cudaLaunchKernel(f.kernel, dim3((unsigned)G), dim3(f.threads),
                           args, f.smem, st);
    if (err != cudaSuccess) return (int)err;
  }
  rmsnorm_dw_kernel<T><<<(D + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      part, G, D, (T*)dw);
  return (int)cudaGetLastError();
}

}  // namespace

// x, w, y: (T, D) / (D,) / (T, D); r and res NULL or (T, D); every pointer
// on a 16-byte boundary where D is a multiple of 16 bytes.  dtype 0 =
// float32, 1 = bfloat16.  At most REG_ROWS rows take the register form
// (where the width allows), launched with programmatic stream
// serialization; the rest take the shared-memory form, D * 4 bytes of
// shared memory a block (D <= 12288).
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* w,
                           void* y, void* res, long long T, int D, float eps,
                           int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D > 12288) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, r, w, y, res, T, D, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, r, w, y, res, T, D, eps, st);
  return (int)cudaErrorInvalidValue;
}

// The backward's grid for T rows of width D (dtype 0 = float32, 1 =
// bfloat16) on the current device: G blocks, so the caller allocates part
// (G, D); a negative value is -(the CUDA error).
extern "C" int rmsnorm_bwd_blocks(long long T, int D, int dtype) {
  if (D <= 0 || D > MAX_D || T <= 0) return 1;
  if (dtype == 0) return bwd_blocks<float>(T, D);
  if (dtype == 1) return bwd_blocks<__nv_bfloat16>(T, D);
  return -(int)cudaErrorInvalidValue;
}

// The backward: x, dy, dx (T, D); w, dw (D,); r and dres NULL or (T, D)
// (dres = d(x + r), the gradient of the residual form's second output);
// part float32 (G, D) scratch with G = rmsnorm_bwd_blocks(T, D, dtype)
// (G = 0 when T = 0: dw = 0).  dx is also d(residual).  Pointers on 16-byte
// boundaries where D is a multiple of 16 bytes; D <= 12288.  Two kernels
// on the stream: the rows (and the blocks' dw partials), then their sum.
extern "C" int rmsnorm_bwd(const void* x, const void* r, const void* w,
                           const void* dy, const void* dres, void* dx,
                           void* part, void* dw, long long T, int D, int G,
                           float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D > MAX_D || G < 0 || (T > 0 && (G == 0 || G > T)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, r, w, dy, dres, dx, (float*)part, dw, T, D,
                             G, eps, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, r, w, dy, dres, dx, (float*)part,
                                     dw, T, D, G, eps, st);
  return (int)cudaErrorInvalidValue;
}
