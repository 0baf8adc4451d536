#!/usr/bin/env python3
"""What the ring combine's progress counters cost, on one CUDA card.

    python3 tools/combine_tail.py

Builds variants of ``csrc/ring_combine.cu``'s loop (fp32, a warp a
1024-element ring block, 8 loads of 16 bytes an input a lane before the
stores, one wave of 4-warp blocks), which differ only in what follows a
ring block's stores: nothing; a device-scope fence (``fence.sc.gpu``, as
``__threadfence``, or ``fence.acq_rel.gpu``); the volatile counter store
into pinned host memory; a fence and the store (the port's kernel).  Times
each beside ``torch.add`` at the ring's chunk (C 1,638,400), in turns,
from device memory (5 input and output triples cycled, 98 MB) and in L2
(one triple), each call's device time behind a queued sleep.  The
variants are measurement aids, not kernels of the port.
"""
from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cuda_runtime.h>
struct alignas(16) V4 { float v[4]; };
// MODE bit 0: a device-scope fence after a ring block's stores (bit 2:
// fence.acq_rel.gpu, else fence.sc.gpu); bit 1: its counter stored
// (volatile) into pinned host memory
template <int MODE>
__global__ void __launch_bounds__(128, 4)
combine(const float* __restrict__ acc, const float* __restrict__ inc,
        float* __restrict__ out, volatile int* progress, int n_blocks) {
  const int lane = threadIdx.x % 32;
  for (int rb = blockIdx.x * 4 + threadIdx.x / 32; rb < n_blocks;
       rb += gridDim.x * 4) {
    const size_t base = (size_t)rb * 1024 + lane * 4;
    V4 a[8], b[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a[u] = *reinterpret_cast<const V4*>(acc + base + u * 128);
      b[u] = *reinterpret_cast<const V4*>(inc + base + u * 128);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      V4 o;
#pragma unroll
      for (int k = 0; k < 4; ++k) o.v[k] = a[u].v[k] + b[u].v[k];
      *reinterpret_cast<V4*>(out + base + u * 128) = o;
    }
    if (MODE == 0) continue;
    __syncwarp();
    if (lane == 0) {
      if ((MODE & 5) == 1) asm volatile("fence.sc.gpu;" ::: "memory");
      if ((MODE & 5) == 5) asm volatile("fence.acq_rel.gpu;" ::: "memory");
      if (MODE & 2) progress[rb] = rb + 1;
    }
  }
}
extern "C" int run(int mode, const float* a, const float* b, float* o,
                   void* progress_host, int n_blocks, int grid, void* stream) {
  void* p = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&p, progress_host, 0);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  int* pp = (int*)p;
  if (mode == 0) combine<0><<<grid, 128, 0, s>>>(a, b, o, pp, n_blocks);
  if (mode == 1) combine<1><<<grid, 128, 0, s>>>(a, b, o, pp, n_blocks);
  if (mode == 2) combine<2><<<grid, 128, 0, s>>>(a, b, o, pp, n_blocks);
  if (mode == 3) combine<3><<<grid, 128, 0, s>>>(a, b, o, pp, n_blocks);
  if (mode == 5) combine<5><<<grid, 128, 0, s>>>(a, b, o, pp, n_blocks);
  if (mode == 7) combine<7><<<grid, 128, 0, s>>>(a, b, o, pp, n_blocks);
  return (int)cudaGetLastError();
}
"""
VARIANTS = {0: "add only", 1: "add + fence.sc.gpu",
            5: "add + fence.acq_rel.gpu", 2: "add + host counter",
            3: "add + fence.sc.gpu + host counter",
            7: "add + fence.acq_rel.gpu + host counter"}


def main():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        sys.exit(1)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import RING_CHUNK, time_ms
    from repro_torch.kernels import NVCC_FLAGS, find_nvcc
    from repro_torch.kernels.ring_reduce import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = Path(tmp) / "combine_tail.cu", Path(tmp) / "combine_tail.so"
        cu.write_text(SOURCE)
        subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                       check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(str(so))
    lib.run.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    C = RING_CHUNK
    n = C // 1024
    grid = ops.combine_grid(n, torch.cuda.get_device_properties(
        0).multi_processor_count)
    progress = torch.zeros(n, dtype=torch.int32, pin_memory=True)
    triples = [(torch.randn(C, device="cuda"), torch.randn(C, device="cuda"),
                torch.empty(C, device="cuda")) for _ in range(5)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def variant(mode, pick):
        def call():
            a, b, o = pick()
            rc = lib.run(mode, a.data_ptr(), b.data_ptr(), o.data_ptr(),
                         progress.data_ptr(), n, grid, stream)
            if rc:
                raise RuntimeError(f"combine variant {mode}: CUDA error {rc}")
        return call

    for label, cycled in (("from device memory", True), ("in L2", False)):
        it = itertools.cycle(triples)
        pick = (lambda: next(it)) if cycled else (lambda: triples[0])

        def add():
            a, b, o = pick()
            torch.add(a, b, out=o)
        for mode, name in VARIANTS.items():
            f = variant(mode, pick)
            t = [time_ms(g, 200, behind_sleep=True) for g in (f, add, add, f)]
            print(f"[tail] C{C} fp32 {label}, {name}: {min(t[0], t[3]):.4f} "
                  f"ms, torch.add {min(t[1], t[2]):.4f} ms", flush=True)
    torch.cuda.synchronize()
    if not bool((progress == torch.arange(1, n + 1, dtype=torch.int32)).all()):
        print("FAIL: counters incomplete")
        sys.exit(1)


if __name__ == "__main__":
    main()
