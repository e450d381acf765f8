// rmsnorm: fused residual add + RMSNorm over the rows of a (T, D) matrix.
//
// Replaces: src/repro/kernels/rmsnorm/kernel.py, _rms_kernel (:16) and its
// wrapper rmsnorm_pallas (:30).  Same function: s = x + r in float32 (r
// optional), y = s * rsqrt(mean(s^2) + eps) * w, both outputs rounded to
// x's type; returns y and s.  float32 or bfloat16, chosen at run time.
//
// What bounds it on the H100: bytes.  Per row it reads x, r and w and
// writes y and s (2 * D bytes each in bf16) for about 4 flops an element,
// far below the card's ~295 flops a byte.
//
// What the design does about it: one block per row; each thread moves 16
// bytes a load (8 bf16 or 4 float), neighbouring threads on neighbouring
// addresses.  The float32 sum s is kept in shared memory (D floats) between
// the sum-of-squares pass and the scaling pass, so x and r are read once;
// the sum of squares is reduced in float32 with warp shuffles.
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

template <typename T>
int launch(const void* x, const void* r, const void* w, void* y, void* res,
           long long T_, int D, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const size_t smem = (size_t)D * sizeof(float);
  if (D % VEC == 0)
    rmsnorm_kernel<T, VEC><<<(unsigned)T_, THREADS, smem, st>>>(
        (const T*)x, (const T*)r, (const T*)w, (T*)y, (T*)res, D, eps);
  else
    rmsnorm_kernel<T, 1><<<(unsigned)T_, THREADS, smem, st>>>(
        (const T*)x, (const T*)r, (const T*)w, (T*)y, (T*)res, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, w, y: (T, D) / (D,) / (T, D); r and res NULL or (T, D).  dtype 0 =
// float32, 1 = bfloat16.  D * 4 bytes of shared memory a block (D <= 12288).
extern "C" int rmsnorm_fwd(const void* x, const void* r, const void* w,
                           void* y, void* res, long long T, int D, float eps,
                           int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T <= 0) return (int)cudaGetLastError();
  if (D <= 0 || D > 12288) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, r, w, y, res, T, D, eps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, r, w, y, res, T, D, eps, st);
  return (int)cudaErrorInvalidValue;
}
