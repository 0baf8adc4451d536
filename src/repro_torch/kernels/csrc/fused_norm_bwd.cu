// Backward of the fused residual add + RMSNorm for Hopper (sm_90a).
//
// The JAX package differentiates its fused norm by autodiff of the oracle
// src/repro/kernels/fused_norm/ref.py::fused_ref (its Pallas kernel has no
// backward).  With h = x + res recomputed in fp32 from the saved x and res,
// r = rsqrt(mean(h^2) + eps) and g = dy * scale, this kernel computes
//   dh_total = dh + r*g - h * r^3 * mean(h * g)    (dh may be absent: 0)
//   dx = dres = dh_total                           (in x's dtype)
//   dscale    = sum over rows of dy * h * r        (fp32)
//
// Bound on an H100: memory.  The function reads x, res, dy and dh and
// writes dx (5 * R * D * itemsize bytes), against ~12 flops an element.
// The dscale partials below (2 * blocks * D * 4 bytes written and read)
// are this design's own traffic on top of that bound.
//
// Design: rows_kernel runs a grid of at most a few blocks per SM, each of
// 256 threads walking rows; one row at a time, pass 1 reads x, res and dy
// with 16-byte accesses and reduces sum(h^2) and sum(h*g) (warp shuffles,
// then one value per warp in shared memory), pass 2 reads them again (the
// row is still in L1/L2), writes dx and adds dy*h*r into the block's dscale
// partial.  A thread owns the same columns in every row, so the partial
// lives in shared memory without atomics and goes out as one row of
// `partial` [blocks, D]; reduce_kernel then sums the partials of each
// column in block order.  Deterministic: no atomics anywhere.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const Vec<T, VEC> a = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = flare::to_float(a.v[k]);
}

// both sums over the block; every thread gets them
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* warp_sums,
                                             float2* total) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  if (threadIdx.x < 32) {
    float2 t = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x]
                                           : make_float2(0.f, 0.f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      t.x += __shfl_xor_sync(0xffffffffu, t.x, off);
      t.y += __shfl_xor_sync(0xffffffffu, t.y, off);
    }
    if (threadIdx.x == 0) *total = t;
  }
  __syncthreads();
  return *total;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
            const float* __restrict__ scale, const T* __restrict__ dy,
            const T* __restrict__ dh, T* __restrict__ dx,
            float* __restrict__ partial, int R, int D, float eps) {
  extern __shared__ float ds_acc[];   // [D]: this block's dscale partial
  __shared__ float2 warp_sums[kThreads / 32];
  __shared__ float2 total;
  const int first = threadIdx.x * VEC;
  constexpr int kStep = kThreads * VEC;
  for (int i = first; i < D; i += kStep)
#pragma unroll
    for (int k = 0; k < VEC; ++k) ds_acc[i + k] = 0.f;

  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const size_t base = static_cast<size_t>(row) * D;
    float ss = 0.f, hg = 0.f;
    for (int i = first; i < D; i += kStep) {
      float xv[VEC], rv[VEC], gv[VEC];
      load_vec<T, VEC>(x + base + i, xv);
      load_vec<T, VEC>(res + base + i, rv);
      load_vec<T, VEC>(dy + base + i, gv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float h = xv[k] + rv[k];
        ss += h * h;
        hg += h * gv[k] * scale[i + k];
      }
    }
    const float2 sums = block_sum2(ss, hg, warp_sums, &total);
    const float r = rsqrtf(sums.x / static_cast<float>(D) + eps);
    const float c = r * r * r * (sums.y / static_cast<float>(D));
    for (int i = first; i < D; i += kStep) {
      float xv[VEC], rv[VEC], gv[VEC], hv[VEC];
      load_vec<T, VEC>(x + base + i, xv);
      load_vec<T, VEC>(res + base + i, rv);
      load_vec<T, VEC>(dy + base + i, gv);
      if (dh != nullptr) {
        load_vec<T, VEC>(dh + base + i, hv);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) hv[k] = 0.f;
      }
      Vec<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float h = xv[k] + rv[k];
        o.v[k] = flare::from_float<T>(hv[k] + r * gv[k] * scale[i + k] - h * c);
        ds_acc[i + k] += gv[k] * h * r;
      }
      *reinterpret_cast<Vec<T, VEC>*>(dx + base + i) = o;
    }
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * D;
  for (int i = first; i < D; i += kStep)
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[i + k] = ds_acc[i + k];
}

// dscale[i] = sum over blocks of partial[b][i], in block order
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
              int blocks, int D) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= D) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[static_cast<size_t>(b) * D + i];
  dscale[i] = s;
}

template <typename T, int VEC>
int launch_rows(const T* x, const T* res, const float* scale, const T* dy,
                const T* dh, T* dx, float* partial, int R, int D, int blocks,
                float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(D) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rows_kernel<T, VEC><<<blocks, kThreads, smem, stream>>>(
      x, res, scale, dy, dh, dx, partial, R, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* x, const void* res, const void* scale,
                 const void* dy, const void* dh, void* dx, void* partial,
                 void* dscale, int R, int D, int blocks, float eps,
                 cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      D % VEC == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(res) |
        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dh) |
        reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const float* sp = static_cast<const float*>(scale);
  const T* dyp = static_cast<const T*>(dy);
  const T* dhp = static_cast<const T*>(dh);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  const int e = aligned
      ? launch_rows<T, VEC>(xp, rp, sp, dyp, dhp, dxp, pp, R, D, blocks, eps,
                            stream)
      : launch_rows<T, 1>(xp, rp, sp, dyp, dhp, dxp, pp, R, D, blocks, eps,
                          stream);
  if (e != 0) return e;
  reduce_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      pp, static_cast<float*>(dscale), blocks, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res, dy, dx: [R, D] contiguous in `dtype`; dh: the same or null (no
// cotangent on h); scale, dscale: [D] float32; partial: [blocks, D] float32
// scratch, 1 <= blocks <= R.  Launches rows_kernel (blocks blocks) and
// reduce_kernel on `stream`.  Returns 0 or the first cudaError_t.
extern "C" int fused_residual_rmsnorm_bwd_launch(
    const void* x, const void* res, const void* scale, const void* dy,
    const void* dh, void* dx, void* partial, void* dscale, int R, int D,
    int blocks, float eps, int dtype, void* stream) {
  if (D == 0) return 0;
  if (R == 0 || blocks < 1 || blocks > R)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == FLARE_F32)
    return launch_typed<float>(x, res, scale, dy, dh, dx, partial, dscale, R,
                               D, blocks, eps, s);
  if (dtype == FLARE_BF16)
    return launch_typed<__nv_bfloat16>(x, res, scale, dy, dh, dx, partial,
                                       dscale, R, D, blocks, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
