// Shared by every kernel source of repro_torch.  Each source is built into
// its own shared library, so this header is included once per library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed by the Python wrappers
enum FlareDtype : int { FLARE_F32 = 0, FLARE_BF16 = 1 };

extern "C" const char* flare_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace flare {

// The SSD scan's widths (kernels/ssd_scan/ops.py's HEAD_DIMS and
// STATE_DIMS), the one list its launchers check: every route's tiles are
// head_dim padded to 64 columns and the state to 64 or 128, the true widths
// taken at run time
inline bool ssd_head_dim(int P) {
  return P == 8 || P == 16 || P == 32 || P == 64;
}
inline bool ssd_state_dim(int N) {
  return N == 8 || N == 16 || N == 32 || N == 64 || N == 128;
}

// Four consecutive elements <-> float4, for fp32 (one 16-byte access) and
// bf16 (one 8-byte access).  Callers keep the address aligned to the access.
template <typename T> struct Pack4;

template <> struct Pack4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <> struct Pack4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    *reinterpret_cast<uint32_t*>(&a) = u.x;
    *reinterpret_cast<uint32_t*>(&b) = u.y;
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&a);
    u.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace flare
