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
// The dscale partials below (2 * blocks * D * 4 bytes written and read,
// ~5 % of the function's bytes at the training shape) are this design's
// own traffic on top of that bound.
//
// Design: one pass over the function's bytes.  rows_kernel runs two blocks
// of 256 threads per SM, each walking rows, one row at a time across the
// whole block:
//   * one thread keeps the block's next rows in flight: x, res, dy and dh
//     of a row go by bulk copy (TMA, no tensor map) into a ring of 2-4
//     stages in shared memory (up to 96 KB a block), filled up to 3 rows
//     ahead, with an mbarrier per stage; a stage is refilled once every
//     thread has passed the next row's barrier;
//   * a thread owns NV vectors of VEC elements of a row (16-byte vectors
//     t, t + 256, ...: conflict-free reads of the stage) and the same
//     columns in every row, so scale is loaded into registers once per
//     block, and h = x + res and dy stay in fp32 registers across the
//     row's reduction of sum(h^2) and sum(h * dy * scale) (warp shuffles,
//     then the warps' sums through a double-buffered slot in shared
//     memory: one barrier per row), and dx is written from them;
//   * the dscale partial dy * h * r lives in registers and goes out once,
//     as the block's row of `partial` [blocks, D].
// reduce_kernel then sums the partials of 32 columns per block, a warp
// over every 8th partial row and the 8 warps' sums in warp order; it is
// launched while rows_kernel runs (programmatic dependent launch) and
// waits for the partials on the card, so no launch gap separates the two.
// Deterministic: no atomics anywhere.  The columns a thread owns (NV * VEC)
// are the template parameter: NV 1 covers D up to 2048 in bf16 (llama
// 2048, mamba2 1536, qwen2 896) and 1024 in fp32, NV 2 and 4 up to 4096.
// Wider rows (the MoE models' 6144 and 7168, up to kMaxD = 8192) take NV
// 3 and 4 in bf16 and 6 and 8 in fp32, the last pass partial where D is no
// multiple of 2048 (bf16) or 1024 (fp32) elements.  Two rows of four
// tensors at D 7168 are 115 KB in bf16 and 229 KB in fp32, more than two
// blocks' rings can hold on an SM, and h, dy, scale and the dscale partial
// of NV 8 fp32 vectors are 128 registers a thread.  So these instances
// skip the ring: every thread loads its own 16-byte vectors of a row from
// device memory (NV * 3-4 loads in flight a thread, 48-128 KB a block),
// and they are compiled for one block an SM (up to 255 registers, so
// nothing spills); the rows are still read once.
// Rows over 8192, up to kWideMaxD = 16384 (llama3-405b's), take
// wide_rows_kernel: 1024 threads a block, one block an SM, each thread NV
// 2 bf16 or 4 fp32 vectors of a row, loaded from device memory.  At 1024
// threads a thread has 64 registers, too few to keep its h and dy across
// the row's reduction (the first version of this kernel did, and spilled
// 196 bytes in bf16), so a row takes two passes over its vectors: the
// first reduces sum(h^2) and sum(h * dy * scale), the second reads x, res
// and dy again, which the first pass has just brought into L2 (the SMs'
// rows in flight are 132 * 3 * 32 KB in bf16, 13 MB of its 50 MB), and
// writes dx.  scale and the dscale partial live in shared
// memory (2 * D * 4 bytes, 128 KB at D 16384): each thread reads and
// accumulates only its own columns there, so no two threads touch one
// word and the partial stays deterministic.
// Rows without 16-byte alignment (D not a multiple of 16 bytes, or an
// unaligned pointer) take the generic instance: one element a vector, NV
// 8 (D up to 2048), each thread loading its own columns from device
// memory, no ring.  The wrapper refuses D above 16384.

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
constexpr size_t kRingBytes = 96 * 1024;   // the ring's budget per block
constexpr int kStagedMaxD = 4096;          // the widest row the ring takes
constexpr int kMaxD = 8192;                // the widest row of rows_kernel
constexpr int kWideThreads = 1024;         // wide_rows_kernel's block
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxD = 16384;           // the widest row of all

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC, int NV, bool kStaged, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
            const float* __restrict__ scale, const T* __restrict__ dy,
            const T* __restrict__ dh, T* __restrict__ dx,
            float* __restrict__ partial, int R, int D, float eps,
            int stages) {
  // the ring: [stages][x, res, dy, dh][D], then a full barrier per stage
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float2 sums[2][kWarps];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int vecs = D / VEC;
  const float inv_d = 1.f / static_cast<float>(D);
  const int tensors = dh != nullptr ? 4 : 3;
  const uint32_t row_bytes = static_cast<uint32_t>(D) * sizeof(T);
  T* ring = reinterpret_cast<T*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(stages) * tensors * row_bytes);
  // this block's rows: blockIdx.x + i * gridDim.x, i < rows
  const int rows =
      blockIdx.x < R ? (R - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                     : 0;
  auto stage_of = [&](int i) {
    return ring + static_cast<size_t>(i % stages) * tensors * D;
  };
  // thread 0: the inputs of this block's i-th row into its stage
  auto fill = [&](int i) {
    const size_t base = (blockIdx.x + static_cast<size_t>(i) * gridDim.x) * D;
    T* dst = stage_of(i);
    uint64_t* bar = &full[i % stages];
    mbar_expect_tx(bar, tensors * row_bytes);
    bulk_load(dst, x + base, row_bytes, bar);
    bulk_load(dst + D, res + base, row_bytes, bar);
    bulk_load(dst + 2 * D, dy + base, row_bytes, bar);
    if (dh != nullptr) bulk_load(dst + 3 * D, dh + base, row_bytes, bar);
  };
  if constexpr (kStaged) {
    if (threadIdx.x == 0) {
      for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
      fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < min(stages, rows); ++i) fill(i);
  }

  float sc[NV][VEC], ds[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = threadIdx.x + j * kThreads;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      sc[j][k] = v < vecs ? scale[v * VEC + k] : 0.f;
      ds[j][k] = 0.f;
    }
  }

  for (int i = 0; i < rows; ++i) {
    const size_t base = (blockIdx.x + static_cast<size_t>(i) * gridDim.x) * D;
    const T *xs, *rs, *ys, *hs;
    if constexpr (kStaged) {
      mbar_wait(&full[i % stages], (i / stages) & 1);
      xs = stage_of(i);
      rs = xs + D;
      ys = xs + 2 * D;
      hs = dh != nullptr ? xs + 3 * D : nullptr;
    } else {
      xs = x + base;
      rs = res + base;
      ys = dy + base;
      hs = dh != nullptr ? dh + base : nullptr;
    }
    float h[NV][VEC], g[NV][VEC];
    float ss = 0.f, hg = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = threadIdx.x + j * kThreads;
      Vec<T, VEC> xa, ra, ya;
      if (v < vecs) {
        xa = *reinterpret_cast<const Vec<T, VEC>*>(xs + v * VEC);
        ra = *reinterpret_cast<const Vec<T, VEC>*>(rs + v * VEC);
        ya = *reinterpret_cast<const Vec<T, VEC>*>(ys + v * VEC);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        h[j][k] = v < vecs ? flare::to_float(xa.v[k]) +
                                 flare::to_float(ra.v[k])
                           : 0.f;
        g[j][k] = v < vecs ? flare::to_float(ya.v[k]) : 0.f;
        ss += h[j][k] * h[j][k];
        hg += h[j][k] * g[j][k] * sc[j][k];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      hg += __shfl_xor_sync(0xffffffffu, hg, off);
    }
    // one barrier per row: the slot alternates, so a row's writes never
    // race the previous row's reads
    if (lane == 0) sums[i & 1][warp] = make_float2(ss, hg);
    __syncthreads();
    // every thread is done with row i - 1: its stage takes a row ahead
    if constexpr (kStaged) {
      if (threadIdx.x == 0 && i >= 1 && i - 1 + stages < rows)
        fill(i - 1 + stages);
    }
    float2 tot = sums[i & 1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      tot.x += sums[i & 1][w].x;
      tot.y += sums[i & 1][w].y;
    }
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float c = r * r * r * (tot.y * inv_d);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = threadIdx.x + j * kThreads;
      if (v >= vecs) continue;
      Vec<T, VEC> ha, o;
      if (hs != nullptr)
        ha = *reinterpret_cast<const Vec<T, VEC>*>(hs + v * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float dhk = hs != nullptr ? flare::to_float(ha.v[k]) : 0.f;
        o.v[k] = flare::from_float<T>(dhk + r * g[j][k] * sc[j][k] -
                                      h[j][k] * c);
        ds[j][k] += g[j][k] * h[j][k] * r;
      }
      *reinterpret_cast<Vec<T, VEC>*>(dx + base +
                                      static_cast<size_t>(v) * VEC) = o;
    }
  }

  // this block's rows are done: the reduce kernel may take its place
  pdl_launch_dependents();
  float* out = partial + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = threadIdx.x + j * kThreads;
    if (v < vecs)
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[v * VEC + k] = ds[j][k];
  }
}

// VEC floats of shared memory at p (16-byte aligned) as float4 accesses:
// a warp's thread t reads bytes t * 4 * VEC on, 2 passes of 512 bytes at
// VEC 8, one at VEC 4
template <int VEC>
__device__ __forceinline__ Vec<float, VEC> load_cols(const float* p) {
  Vec<float, VEC> o;
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 t = reinterpret_cast<const float4*>(p)[q];
    o.v[4 * q] = t.x;
    o.v[4 * q + 1] = t.y;
    o.v[4 * q + 2] = t.z;
    o.v[4 * q + 3] = t.w;
  }
  return o;
}

template <int VEC>
__device__ __forceinline__ void store_cols(float* p,
                                           const Vec<float, VEC>& o) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(o.v[4 * q], o.v[4 * q + 1], o.v[4 * q + 2],
                    o.v[4 * q + 3]);
}

// Rows of kMaxD < D <= kWideMaxD: as rows_kernel's unstaged instances, a
// block walks rows blockIdx.x + i * gridDim.x, each thread its NV vectors
// of every row, but 1024 threads a block, two passes over a row and scale
// and the dscale partial in shared memory (see the top of the file).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kWideThreads, 1)
wide_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                 const float* __restrict__ scale, const T* __restrict__ dy,
                 const T* __restrict__ dh, T* __restrict__ dx,
                 float* __restrict__ partial, int R, int D, float eps) {
  // [scale | dscale partial], D floats each
  extern __shared__ __align__(16) float cols[];
  __shared__ float2 sums[2][kWideWarps];
  float* sc = cols;
  float* ds = cols + D;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int vecs = D / VEC;
  const float inv_d = 1.f / static_cast<float>(D);
  for (int c = threadIdx.x; c < D; c += kWideThreads) {
    sc[c] = scale[c];
    ds[c] = 0.f;
  }
  __syncthreads();                     // a thread's vectors, others' writes
  const int rows =
      blockIdx.x < R ? (R - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                     : 0;
  for (int i = 0; i < rows; ++i) {
    const size_t base = (blockIdx.x + static_cast<size_t>(i) * gridDim.x) * D;
    // h = x + res and g = dy of vector v, and scale's columns
    auto load = [&](int v, float (&h)[VEC], float (&g)[VEC],
                    Vec<float, VEC>& sv) {
      const Vec<T, VEC> xa =
          *reinterpret_cast<const Vec<T, VEC>*>(x + base + v * VEC);
      const Vec<T, VEC> ra =
          *reinterpret_cast<const Vec<T, VEC>*>(res + base + v * VEC);
      const Vec<T, VEC> ya =
          *reinterpret_cast<const Vec<T, VEC>*>(dy + base + v * VEC);
      sv = load_cols<VEC>(sc + v * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        h[k] = flare::to_float(xa.v[k]) + flare::to_float(ra.v[k]);
        g[k] = flare::to_float(ya.v[k]);
      }
    };
    float ss = 0.f, hg = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = threadIdx.x + j * kWideThreads;
      if (v >= vecs) continue;
      float h[VEC], g[VEC];
      Vec<float, VEC> sv;
      load(v, h, g, sv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ss += h[k] * h[k];
        hg += h[k] * g[k] * sv.v[k];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      hg += __shfl_xor_sync(0xffffffffu, hg, off);
    }
    // one barrier per row: the slot alternates, so a row's writes never
    // race the previous row's reads
    if (lane == 0) sums[i & 1][warp] = make_float2(ss, hg);
    __syncthreads();
    float2 tot = sums[i & 1][0];
#pragma unroll
    for (int w = 1; w < kWideWarps; ++w) {
      tot.x += sums[i & 1][w].x;
      tot.y += sums[i & 1][w].y;
    }
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float c = r * r * r * (tot.y * inv_d);
    // the second pass: x, res and dy again (from L2), dh, and dx out
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = threadIdx.x + j * kWideThreads;
      if (v >= vecs) continue;
      float h[VEC], g[VEC];
      Vec<float, VEC> sv;
      load(v, h, g, sv);
      Vec<T, VEC> ha, o;
      if (dh != nullptr)
        ha = *reinterpret_cast<const Vec<T, VEC>*>(dh + base + v * VEC);
      Vec<float, VEC> dv = load_cols<VEC>(ds + v * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float dhk = dh != nullptr ? flare::to_float(ha.v[k]) : 0.f;
        o.v[k] = flare::from_float<T>(dhk + r * g[k] * sv.v[k] - h[k] * c);
        dv.v[k] += g[k] * h[k] * r;
      }
      store_cols<VEC>(ds + v * VEC, dv);
      *reinterpret_cast<Vec<T, VEC>*>(dx + base +
                                      static_cast<size_t>(v) * VEC) = o;
    }
  }

  // this block's rows are done: the reduce kernel may take its place
  pdl_launch_dependents();
  __syncthreads();                     // every thread's columns are summed
  float* out = partial + static_cast<size_t>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += kWideThreads) out[c] = ds[c];
}

// dscale[c] = sum over blocks b of partial[b][c]: a block owns 32 columns;
// warp w sums rows w, w + 8, ... in order, then the 8 warps' sums are
// added in warp order
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
              int blocks, int D) {
  __shared__ float warp_sums[kWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  pdl_wait();                          // rows_kernel's partials are written
  float s = 0.f;
  if (c < D) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kWarps)
      s += partial[static_cast<size_t>(b) * D + c];
  }
  warp_sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < D) {
    float t = warp_sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += warp_sums[w][lane];
    dscale[c] = t;
  }
}

template <typename T, int VEC, int NV, bool kStaged, int kMinBlocks>
int launch_rows(const T* x, const T* res, const float* scale, const T* dy,
                const T* dh, T* dx, float* partial, int R, int D, int blocks,
                float eps, cudaStream_t stream) {
  int stages = 0;
  size_t smem = 0;
  if (kStaged) {
    const size_t stage_bytes =
        static_cast<size_t>(dh != nullptr ? 4 : 3) * D * sizeof(T);
    stages = static_cast<int>(
        std::max<size_t>(2, std::min<size_t>(kMaxStages,
                                             kRingBytes / stage_bytes)));
    smem = stages * (stage_bytes + sizeof(uint64_t));
    const cudaError_t e = cudaFuncSetAttribute(
        rows_kernel<T, VEC, NV, kStaged, kMinBlocks>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rows_kernel<T, VEC, NV, kStaged, kMinBlocks>
      <<<blocks, kThreads, smem, stream>>>(
      x, res, scale, dy, dh, dx, partial, R, D, eps, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, int NV>
int launch_wide(const T* x, const T* res, const float* scale, const T* dy,
                const T* dh, T* dx, float* partial, int R, int D, int blocks,
                float eps, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      wide_rows_kernel<T, VEC, NV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  wide_rows_kernel<T, VEC, NV><<<blocks, kWideThreads, smem, stream>>>(
      x, res, scale, dy, dh, dx, partial, R, D, eps);
  return static_cast<int>(cudaGetLastError());
}

// the instance whose NV vectors a thread cover D
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
#define FLARE_ROWS(V, NV, STAGED, MIN_BLOCKS)                                \
  launch_rows<T, V, NV, STAGED, MIN_BLOCKS>(xp, rp, sp, dyp, dhp, dxp, pp, R, \
                                            D, blocks, eps, stream)
  constexpr int per_pass = kThreads * VEC;      // elements with NV 1
  int e = static_cast<int>(cudaErrorInvalidValue);
  if (!aligned) {
    if (D > kThreads * 8) return static_cast<int>(cudaErrorInvalidValue);
    e = FLARE_ROWS(1, 8, false, 2);
  } else if (D <= per_pass) {
    e = FLARE_ROWS(VEC, 1, true, 2);
  } else if (D <= 2 * per_pass) {
    e = FLARE_ROWS(VEC, 2, true, 2);
  } else if (D <= kStagedMaxD) {                // fp32: bf16's NV 2 is 4096
    if constexpr (VEC == 4) e = FLARE_ROWS(VEC, 4, true, 2);
  } else if (D <= 3 * kMaxD / 4) {              // 6144: bf16 NV 3, fp32 6
    e = FLARE_ROWS(VEC, 3 * kMaxD / 4 / per_pass, false, 1);
  } else if (D <= kMaxD) {                      // 8192: bf16 NV 4, fp32 8
    e = FLARE_ROWS(VEC, kMaxD / per_pass, false, 1);
  } else if (D <= kWideMaxD) {                  // 16384: bf16 NV 2, fp32 4
    e = launch_wide<T, VEC, kWideMaxD / (kWideThreads * VEC)>(
        xp, rp, sp, dyp, dhp, dxp, pp, R, D, blocks, eps, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLARE_ROWS
  if (e != 0) return e;
  // launched while rows_kernel runs; it waits for the partials itself
  return static_cast<int>(launch_overlapped(
      reduce_kernel, dim3((D + 31) / 32), dim3(kThreads), 0, stream, pp,
      static_cast<float*>(dscale), blocks, D));
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
