// Ring-combine step with host-visible progress for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ring_reduce/kernel.py
// (ring_combine_step, body _combine_kernel): one ring step of
// reduce-scatter, out = acc + incoming over C / block ring blocks, with
// progress[i] = i + 1 once ring block i has combined.  That counter array
// is FLARE's intra-kernel inspecting seam (paper section 5.1, Fig 6): under
// a hang its frozen values localise the stalled link.
//
// Bound on an H100: memory, 3 * C * itemsize bytes (acc and incoming read,
// out written) against C adds; at the ring's chunk (C 1,638,400 fp32)
// 19.7 MB, 0.0059 ms at 3.35 TB/s.
//
// Design: a warp takes whole ring blocks.  The grid is one wave of
// resident CUDA blocks of 4 warps (the wrapper sizes it, see
// ring_reduce/ops.py::combine_grid), and warp w of W takes ring blocks w,
// w + W, ... in order.  For each ring block a lane issues all its loads
// of acc and incoming, 1024 elements a warp at a time (8 loads of 16
// bytes an input at fp32, 4 at bf16, 32 scalar ones when the pointers or
// the block are not 16-byte multiples), before its first store, so that
// enough bytes are in flight to cover the memory latency.  The progress
// array is pinned host memory reached through its device pointer: once a ring
// block's sums are stored, the warp synchronises and lane 0 issues a
// device-scope fence and a volatile store of the counter.  A volatile
// store is a relaxed store at system scope in the PTX memory model, so a
// host thread polling the array sees the counter while later ring blocks
// still run, and every observer on the card sees a block's counter only
// after its outputs.  (A system-scope fence would also order the outputs
// for the host, which reads them only after a synchronise anyway; measured
// on an H100 it made the kernel 1.5-2.6x slower.)  The fence and the
// counter store are what the kernel costs beyond an add alone: without
// them the same loop keeps pace with torch.add from device memory
// (tools/combine_tail.py).  The add is one rounding of the fp32 sum to the
// output type, as acc + incoming in PyTorch, so the result is bitwise
// equal to the plain version.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;             // warps per CUDA block
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = 1024;           // elements a warp loads before storing

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 4)
ring_combine_kernel(const T* __restrict__ acc, const T* __restrict__ incoming,
                    T* __restrict__ out, volatile int* progress, int n_blocks,
                    int block) {
  using V = Vec<T, VEC>;
  constexpr int U = kStep / (32 * VEC);  // loads per lane per input
  const int lane = threadIdx.x % 32;
  const int workers = gridDim.x * kWarps;
  for (int rb = blockIdx.x * kWarps + threadIdx.x / 32; rb < n_blocks;
       rb += workers) {
    const size_t base = static_cast<size_t>(rb) * block;
    for (int i0 = 0; i0 < block; i0 += kStep) {
      V a[U], b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + (u * 32 + lane) * VEC;
        if (i < block) {
          a[u] = *reinterpret_cast<const V*>(acc + base + i);
          b[u] = *reinterpret_cast<const V*>(incoming + base + i);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + (u * 32 + lane) * VEC;
        if (i < block) {
          V o;
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            o.v[k] = flare::from_float<T>(flare::to_float(a[u].v[k]) +
                                          flare::to_float(b[u].v[k]));
          *reinterpret_cast<V*>(out + base + i) = o;
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence();
      progress[rb] = rb + 1;
    }
  }
}

template <typename T>
int launch_typed(const void* acc, const void* incoming, void* out,
                 int* progress, int n_blocks, int block, int vec, int grid,
                 cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* ap = static_cast<const T*>(acc);
  const T* bp = static_cast<const T*>(incoming);
  T* op = static_cast<T*>(out);
  if (vec == VEC) {
    const bool aligned =
        block % VEC == 0 &&
        ((reinterpret_cast<uintptr_t>(acc) |
          reinterpret_cast<uintptr_t>(incoming) |
          reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    ring_combine_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
        ap, bp, op, progress, n_blocks, block);
  } else if (vec == 1) {
    ring_combine_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        ap, bp, op, progress, n_blocks, block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// acc, incoming, out: [C] contiguous device memory in `dtype`, C = n_blocks
// * block.  progress_host: [n_blocks] int32 in pinned (page-locked) host
// memory; the kernel writes it through its device pointer.  vec: elements
// per access, 16 / itemsize (every pointer 16-byte aligned and block a
// multiple of it) or 1; grid: CUDA blocks of 4 warps.  Returns
// cudaGetLastError() after the launch (0 = launched), or the error of
// cudaHostGetDevicePointer if progress_host is not pinned.
extern "C" int ring_combine_launch(const void* acc, const void* incoming,
                                   void* out, void* progress_host,
                                   int n_blocks, int block, int dtype, int vec,
                                   int grid, void* stream) {
  if (n_blocks == 0) return 0;
  if (grid <= 0 || block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  void* progress = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&progress, progress_host, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pp = static_cast<int*>(progress);
  if (dtype == FLARE_F32)
    return launch_typed<float>(acc, incoming, out, pp, n_blocks, block, vec,
                               grid, s);
  if (dtype == FLARE_BF16)
    return launch_typed<__nv_bfloat16>(acc, incoming, out, pp, n_blocks,
                                       block, vec, grid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
