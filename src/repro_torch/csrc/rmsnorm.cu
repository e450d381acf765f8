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
// ~12 flops an element.  A grid of G blocks (the launcher's choice, a few
// a multiprocessor) walks the rows, a block a row at a time: one pass
// loads x, r, dy and w, reduces the row's two sums (s^2 and dy * w * s)
// across the block, a second pass (the row again, from L2) writes dx.
// Each thread keeps its columns' share of dw in registers over all its
// rows, and writes it as the block's partial sum; a second kernel adds the
// G partials of each column in a fixed order.  No float atomics: the
// result does not depend on the order in which blocks run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const T* __restrict__ w, const T* __restrict__ dy,
                   const T* __restrict__ dres, T* __restrict__ dx,
                   float* __restrict__ part, long long T_, int D, float eps) {
  // vectors a thread covers in a row at the widest D
  constexpr int NK = (MAX_D + THREADS * VEC - 1) / (THREADS * VEC);
  __shared__ float red[2][THREADS / 32];
  using P = Pack<T, VEC>;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float acc[NK][VEC];                     // this thread's columns of dw
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
  for (long long row = blockIdx.x; row < T_; row += gridDim.x) {
    const long long off = row * D;
    float ss = 0.f, sd = 0.f;             // sum s^2, sum dy * w * s
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int i = (k * THREADS + t) * VEC;
      if (i >= D) break;
      const P xv = *reinterpret_cast<const P*>(x + off + i);
      const P gv = *reinterpret_cast<const P*>(dy + off + i);
      const P wv = *reinterpret_cast<const P*>(w + i);
      P rv;
      if (r != nullptr) rv = *reinterpret_cast<const P*>(r + off + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = to_f(xv.v[e]);
        if (r != nullptr) v += to_f(rv.v[e]);
        ss += v * v;
        sd += to_f(gv.v[e]) * to_f(wv.v[e]) * v;
      }
    }
    ss = warp_sum(ss);
    sd = warp_sum(sd);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = sd;
    }
    __syncthreads();
    float tss = 0.f, tsd = 0.f;
#pragma unroll
    for (int k = 0; k < THREADS / 32; ++k) {
      tss += red[0][k];
      tsd += red[1][k];
    }
    __syncthreads();                      // red is free for the next row
    const float inv = rsqrtf(tss / (float)D + eps);
    const float c = inv * inv * inv * tsd / (float)D;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int i = (k * THREADS + t) * VEC;
      if (i >= D) break;
      const P xv = *reinterpret_cast<const P*>(x + off + i);
      const P gv = *reinterpret_cast<const P*>(dy + off + i);
      const P wv = *reinterpret_cast<const P*>(w + i);
      P rv, dv, ov;
      if (r != nullptr) rv = *reinterpret_cast<const P*>(r + off + i);
      if (dres != nullptr) dv = *reinterpret_cast<const P*>(dres + off + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float v = to_f(xv.v[e]);
        if (r != nullptr) v += to_f(rv.v[e]);
        const float g = to_f(gv.v[e]);
        float ds = inv * g * to_f(wv.v[e]) - c * v;
        if (dres != nullptr) ds += to_f(dv.v[e]);
        acc[k][e] += g * v * inv;
        ov.v[e] = from_f<T>(ds);
      }
      *reinterpret_cast<P*>(dx + off + i) = ov;
    }
  }
  float* pb = part + (long long)blockIdx.x * D;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int i = (k * THREADS + t) * VEC;
    if (i >= D) break;
#pragma unroll
    for (int e = 0; e < VEC; ++e) pb[i + e] = acc[k][e];
  }
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

template <typename T>
int launch_bwd(const void* x, const void* r, const void* w, const void* dy,
               const void* dres, void* dx, float* part, void* dw,
               long long T_, int D, int G, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*,
                 float*, long long, int, float) =
      D % VEC == 0 ? rmsnorm_bwd_kernel<T, VEC> : rmsnorm_bwd_kernel<T, 1>;
  if (G > 0) {
    kernel<<<(unsigned)G, THREADS, 0, st>>>(
        (const T*)x, (const T*)r, (const T*)w, (const T*)dy,
        (const T*)dres, (T*)dx, part, T_, D, eps);
    const cudaError_t err = cudaGetLastError();
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

// The backward: x, dy, dx (T, D); w, dw (D,); r and dres NULL or (T, D)
// (dres = d(x + r), the gradient of the residual form's second output);
// part float32 (G, D) scratch, 0 < G <= T (G = 0 only when T = 0).  dx
// is also d(residual).  Pointers on 16-byte boundaries where D is a
// multiple of 16 bytes; D <= 12288.  Two kernels on the stream: the rows,
// then the dw partials' sum.
extern "C" int rmsnorm_bwd(const void* x, const void* r, const void* w,
                           const void* dy, const void* dres, void* dx,
                           void* part, void* dw, long long T, int D, int G,
                           float eps, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D > MAX_D || G < 0 || (T > 0 && G == 0) || G > T)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, r, w, dy, dres, dx, (float*)part, dw, T, D,
                             G, eps, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, r, w, dy, dres, dx, (float*)part,
                                     dw, T, D, G, eps, st);
  return (int)cudaErrorInvalidValue;
}
