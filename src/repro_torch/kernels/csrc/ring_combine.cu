// Ring-combine step with host-visible progress for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ring_reduce/kernel.py
// (ring_combine_step, body _combine_kernel): one ring step of
// reduce-scatter, out = acc + incoming over C / block blocks, with
// progress[i] = i + 1 once block i has combined.  That counter array is
// FLARE's intra-kernel inspecting seam (paper section 5.1, Fig 6): under a
// hang its frozen values localise the stalled link.
//
// Bound on an H100: memory, 3 * C * itemsize bytes (acc and incoming read,
// out written) against C adds.  Design: one CUDA block of 256 threads per
// ring block; each thread moves 16 bytes per access (4 fp32 or 8 bf16)
// when the pointers and the block allow it, so a warp reads 512
// contiguous bytes.  The progress array is pinned host memory reached
// through its device pointer: after a block's sums are stored, thread 0
// issues a device-scope fence and a volatile store of the counter.  A
// volatile store is a relaxed store at system scope in the PTX memory
// model, so a host thread polling the array sees the counter while later
// blocks still run, and every observer on the card sees a block's counter
// only after its outputs.  (A system-scope fence would also order the
// outputs for the host, which reads them only after a synchronise anyway;
// measured on an H100 it made the kernel 1.5-2.6x slower.)  The add is
// one rounding of the fp32 sum to the output type, as acc + incoming in
// PyTorch, so the result is bitwise equal to the plain version.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ring_combine_kernel(const T* __restrict__ acc, const T* __restrict__ incoming,
                    T* __restrict__ out, volatile int* progress, int block) {
  const size_t base = static_cast<size_t>(blockIdx.x) * block;
  for (int i = threadIdx.x * VEC; i < block; i += kThreads * VEC) {
    const Vec<T, VEC> a = *reinterpret_cast<const Vec<T, VEC>*>(acc + base + i);
    const Vec<T, VEC> b =
        *reinterpret_cast<const Vec<T, VEC>*>(incoming + base + i);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      o.v[k] = flare::from_float<T>(flare::to_float(a.v[k]) +
                                    flare::to_float(b.v[k]));
    *reinterpret_cast<Vec<T, VEC>*>(out + base + i) = o;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    progress[blockIdx.x] = static_cast<int>(blockIdx.x) + 1;
  }
}

template <typename T>
void launch_typed(const void* acc, const void* incoming, void* out,
                  int* progress, int n_blocks, int block, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      block % VEC == 0 &&
      ((reinterpret_cast<uintptr_t>(acc) | reinterpret_cast<uintptr_t>(incoming) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const T* ap = static_cast<const T*>(acc);
  const T* bp = static_cast<const T*>(incoming);
  T* op = static_cast<T*>(out);
  if (aligned)
    ring_combine_kernel<T, VEC><<<n_blocks, kThreads, 0, stream>>>(
        ap, bp, op, progress, block);
  else
    ring_combine_kernel<T, 1><<<n_blocks, kThreads, 0, stream>>>(
        ap, bp, op, progress, block);
}

}  // namespace

// acc, incoming, out: [C] contiguous device memory in `dtype`, C = n_blocks
// * block.  progress_host: [n_blocks] int32 in pinned (page-locked) host
// memory; the kernel writes it through its device pointer.  Returns
// cudaGetLastError() after the launch (0 = launched), or the error of
// cudaHostGetDevicePointer if progress_host is not pinned.
extern "C" int ring_combine_launch(const void* acc, const void* incoming,
                                   void* out, void* progress_host,
                                   int n_blocks, int block, int dtype,
                                   void* stream) {
  if (n_blocks == 0) return 0;
  void* progress = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&progress, progress_host, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pp = static_cast<int*>(progress);
  if (dtype == FLARE_F32)
    launch_typed<float>(acc, incoming, out, pp, n_blocks, block, s);
  else if (dtype == FLARE_BF16)
    launch_typed<__nv_bfloat16>(acc, incoming, out, pp, n_blocks, block, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
