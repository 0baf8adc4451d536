// Fused residual add + RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_norm/kernel.py
// (fused_residual_rmsnorm_fwd, body _fused_kernel):
//   h = x + res               (fp32)
//   y = h * rsqrt(mean(h^2) + eps) * scale
// returning (y, h) in the input dtype.
//
// Bound on an H100: memory.  The work is 4*R*D*itemsize bytes (x and res
// read, y and h written) against ~6*R*D flops, far below the ~295 flop/byte
// ridge.  Design: one block of 256 threads per row; each thread moves 16
// bytes per access (8 bf16 or 4 fp32) when D and the pointers allow it, so
// a warp reads 512 contiguous bytes.  Pass 1 reads x and res, writes h and
// reduces sum(h^2) (warp shuffles, then one value per warp in shared
// memory).  Pass 2 recomputes h from x and res, which a row of at most
// 32 KB still finds in L1/L2, instead of re-reading the rounded h, so y is
// computed from the fp32 h as the TPU kernel does.  At decode (R = batch)
// the launch, not the bytes, bounds it.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_h(const T* x, const T* r, float (&h)[VEC]) {
  const Vec<T, VEC> a = *reinterpret_cast<const Vec<T, VEC>*>(x);
  const Vec<T, VEC> b = *reinterpret_cast<const Vec<T, VEC>*>(r);
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    h[k] = flare::to_float(a.v[k]) + flare::to_float(b.v[k]);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_residual_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                              const float* __restrict__ scale, T* __restrict__ y,
                              T* __restrict__ h_out, int D, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * D;
  const T* xr = x + base;
  const T* rr = res + base;

  float ss = 0.f;
  for (int i = threadIdx.x * VEC; i < D; i += kThreads * VEC) {
    float h[VEC];
    load_h<T, VEC>(xr + i, rr + i, h);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      ss += h[k] * h[k];
      o.v[k] = flare::from_float<T>(h[k]);
    }
    *reinterpret_cast<Vec<T, VEC>*>(h_out + base + i) = o;
  }

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (threadIdx.x == 0) inv_rms = rsqrtf(t / static_cast<float>(D) + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  for (int i = threadIdx.x * VEC; i < D; i += kThreads * VEC) {
    float h[VEC];
    load_h<T, VEC>(xr + i, rr + i, h);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o.v[k] = flare::from_float<T>(h[k] * inv * scale[i + k]);
    *reinterpret_cast<Vec<T, VEC>*>(y + base + i) = o;
  }
}

template <typename T>
void launch_typed(const void* x, const void* res, const void* scale, void* y,
                  void* h, int R, int D, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      D % VEC == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
        reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(h)) & 15) == 0;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  T* hp = static_cast<T*>(h);
  if (aligned)
    fused_residual_rmsnorm_kernel<T, VEC><<<R, kThreads, 0, stream>>>(
        xp, rp, sp, yp, hp, D, eps);
  else
    fused_residual_rmsnorm_kernel<T, 1><<<R, kThreads, 0, stream>>>(
        xp, rp, sp, yp, hp, D, eps);
}

}  // namespace

// x, res, y, h: [R, D] contiguous in `dtype`; scale: [D] float32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int fused_residual_rmsnorm_launch(const void* x, const void* res,
                                             const void* scale, void* y, void* h,
                                             int R, int D, float eps, int dtype,
                                             void* stream) {
  if (R == 0 || D == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FLARE_F32)
    launch_typed<float>(x, res, scale, y, h, R, D, eps, s);
  else if (dtype == FLARE_BF16)
    launch_typed<__nv_bfloat16>(x, res, scale, y, h, R, D, eps, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
