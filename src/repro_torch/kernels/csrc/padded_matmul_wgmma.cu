// bf16 matmul with an fp32 accumulator on the Hopper tensor cores (sm_90a):
// the bf16 route of the Case-2 padded matmul.
//
// Replaces the TPU kernel src/repro/kernels/padded_matmul/kernel.py
// (matmul_tiled, body _mm_kernel) for bf16 inputs: out = a @ b, one fp32
// sum per output rounded once to bf16.  A bf16 x bf16 product is exact in
// fp32, so wgmma with an fp32 accumulator computes the reference's
// widen-then-dot; only the order of the sum differs.  (fp32 inputs take
// padded_matmul_tf32.cu, split TF32 on the tensor cores, so that their
// result stays a full fp32 product and not one TF32 pass.)
//
// Bound on an H100: operations.  At the Case-2 shape (M 4096, K 8192,
// N 8484 padded to 8576) ~5.8e11 flops against ~0.3 GB of operands, far
// above the ~295 flop/byte ridge of the bf16 tensor cores.
//
// Design (one output tile of 128 x 256 per block, 384 threads):
//   * warpgroup 2 is the producer: it gives registers back (setmaxnreg) and
//     one thread keeps a ring of 4 shared-memory stages filled by TMA, each
//     stage one K step of 64 (128 bytes of bf16, one 128-byte swizzle row):
//     a's 128 x 64 box (16 KB) and four 64 x 64 boxes of b (32 KB), b being
//     [K,N] row-major, so N-contiguous (an MN-major wgmma operand, read
//     with the transpose-B bit);
//   * warpgroups 0 and 1 are consumers of 64 rows each: per stage four
//     m64n256k16 wgmma from shared memory into 128 fp32 registers a
//     thread; each waits for the previous stage's products only after it
//     has issued the current stage's, then frees that stage for the
//     producer (full / empty mbarriers per stage);
//   * 128 x 256 rather than 128 x 128: half the shared-memory traffic per
//     flop, and 4 stages (192 KB) still fit the 227 KB of a block;
//   * the epilogue rounds to bf16 and stores pairs straight from the
//     registers, masked to M and N; TMA fills zeros past the edges of a
//     and b, so a ragged last tile (N 8576 is 33.5 tiles of 256) needs
//     no other care;
//   * blocks walk M fastest, so the blocks in flight share few b columns
//     and a stays in the 50 MB L2.
// TMA needs 16-byte row strides: K and N multiples of 8 (the wrapper pads
// a bf16 call's K and N to that and slices the result back).

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;

constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBoxN = 64;                        // b box: 64 n x 64 k
constexpr uint32_t kABytes = kBM * kBK * 2;      // 16 KB
constexpr uint32_t kBBoxBytes = kBoxN * kBK * 2; // 8 KB
constexpr uint32_t kBBytes = kBN * kBK * 2;      // 32 KB

struct Smem {
  __nv_bfloat16 a[kStages][kBM * kBK];
  __nv_bfloat16 b[kStages][kBK * kBN];   // kBN / 64 boxes of [64 k][64 n]
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;

__global__ void __launch_bounds__(kThreads, 1)
matmul_wgmma_kernel(__grid_constant__ const CUtensorMap map_a,
                    __grid_constant__ const CUtensorMap map_b,
                    __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int steps = (K + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kConsumers * 4);   // lane 0 of each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer
    regs_dealloc<40>();
    if (tid == 0) {
      for (int kt = 0; kt < steps; ++kt) {
        const int st = kt % kStages;
        mbar_wait(&s.empty[st], ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(&s.full[st], kABytes + kBBytes);
        tma_load_2d(s.a[st], &map_a, &s.full[st], kt * kBK, m0);
#pragma unroll
        for (int j = 0; j < kBN / kBoxN; ++j)
          tma_load_2d(s.b[st] + j * kBoxN * kBK, &map_b, &s.full[st],
                      n0 + j * kBoxN, kt * kBK);
      }
    }
  } else {
    // consumers
    regs_alloc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < steps; ++kt) {
      const int st = kt % kStages;
      mbar_wait(&s.full[st], (kt / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 16; ++k) {
        // a: this warpgroup's 64 rows, k16 step = 32 bytes along the row;
        // b: k16 step = 16 rows of 128 bytes; the next 64 n are 8 KB on
        const uint64_t da =
            desc_sw128(s.a[st] + wg * 64 * kBK + k * 16, 16, 1024);
        const uint64_t db =
            desc_sw128(s.b[st] + k * 16 * kBoxN, kBBoxBytes, 1024);
        wgmma_m64n256k16_ss<1>(acc, da, db, 1);
      }
      wgmma_commit();
      fence_regs(acc);
      // the previous stage's products are done: give its buffers back
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0 && lane == 0) mbar_arrive(&s.empty[(kt - 1) % kStages]);
      __syncwarp();
    }
    wgmma_wait<0>();
    fence_regs(acc);

    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = n0 + i * 8 + 2 * (lane % 4);
      if (col >= N) continue;
      if (row < M)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * N + col) =
            pack_bf16x2(acc[4 * i], acc[4 * i + 1]);
      if (row + 8 < M)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row + 8) * N +
                                     col) =
            pack_bf16x2(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

}  // namespace

// a [M,K], b [K,N], out [M,N]: contiguous, row-major bf16, 16-byte aligned,
// K and N multiples of 8.  Returns 0 or a cudaError_t (the launch's, or
// the tensor maps').
extern "C" int matmul_wgmma_launch(const void* a, const void* b, void* out,
                                   int M, int N, int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t box[2] = {kBK, kBM};
    if (int e = make_map_bf16(&map_a, a, 2, dims, strides, box)) return e;
  }
  {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * 2};
    const cuuint32_t box[2] = {kBoxN, kBK};
    if (int e = make_map_bf16(&map_b, b, 2, dims, strides, box)) return e;
  }
  cudaError_t e = cudaFuncSetAttribute(
      matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  matmul_wgmma_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
