// fp32 matmul on the Hopper tensor cores as split TF32 (sm_90a): the fp32
// route ("tf32x3") of the Case-2 padded matmul (bf16 takes
// padded_matmul_wgmma.cu).
//
// Replaces the TPU kernel src/repro/kernels/padded_matmul/kernel.py
// (matmul_tiled, body _mm_kernel) for fp32 inputs: out = a @ b, one fp32
// sum per output.
//
// Arithmetic: out = a_hi.b_hi + a_hi.b_lo + a_lo.b_hi by m64n256k8 tf32
// wgmma into fp32 accumulators (hopper.cuh, split_tf32: hi = x rounded to
// the nearest tf32, lo = the rest rounded likewise), held to a full-fp32
// reference (3e-4, atol at least 2e-3·√K; that width admits one TF32 pass
// too, so the card check also holds the result below half one pass's
// error against an fp64 product).
//
// Bound on an H100: operations.  At the Case-2 shape (M 4096, K 8192,
// N 8484 padded to 8576) 5.76e11 flops of the padded product, 1.16 ms at
// the 494.7 TFLOP/s of the TF32 tensor cores; the three passes make the
// design's floor three times that.  The bytes (a, b, out: ~0.55 GB) take
// 0.165 ms at 3.35 TB/s.
//
// Design:
//   * tf32 wgmma reads only K-major operands, and b [K,N] is N-major: a
//     pre-pass writes b^T split into hi and lo, [2][N][Kp] (Kp = K rounded
//     up to 4, the 16-byte row TMA needs; the columns past K zero), through
//     a 64 x 64 tile in shared memory.  a [M,K] is K-major as it lies: the
//     consumer warpgroup that reads a tile splits its rows in place in
//     shared memory (hi where the raw tile was, lo beside it), which needs
//     a TMA-able a (16-byte aligned, K a multiple of 4); any other a is
//     split into [2][M][Kp] by the pre-pass too (``split_a_in_kernel`` 0).
//     The pre-pass loads with masks, 16 bytes a thread where the address
//     and the row length allow it, so the route takes operands at any
//     address and of any shape;
//   * one output tile of 128 x 256 per block, 384 threads: warpgroup 2 is
//     the producer (it gives registers back; one thread keeps a ring of 2
//     stages filled by TMA, each stage one K step of 32 fp32, one 128-byte
//     swizzle row: a's 128 x 32 box (and its lo box) and b^T's hi and lo
//     256 x 32 boxes, 96 KB a stage, 192 KB for the two); warpgroups 0 and
//     1 are consumers of 64 rows each: per stage four k8 steps of three
//     m64n256k8 products from shared memory into 128 fp32 registers a
//     thread (the small terms hi.lo and lo.hi first); each waits for the
//     previous stage's products only after issuing the current stage's,
//     then frees that stage;
//   * n 256: an m64n256k8 product reads 2 KB of A and 8 KB of B for 128
//     cycles of tensor work, 80 B a cycle, inside the 128 B a cycle that
//     shared memory gives an SM (an m64n32k8 product needs 192);
//   * the epilogue stores fp32 pairs straight from the registers, masked
//     to M and N; TMA fills zeros past the edges of every operand.
//   * blocks walk M fastest, so the blocks in flight share few b^T columns
//     and a stays in the 50 MB L2.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;

constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBK = 32;                          // fp32: one swizzle row
constexpr int kStages = 2;
constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kATile = kBM * kBK * 4;       // 16 KB
constexpr uint32_t kBTile = kBN * kBK * 4;       // 32 KB

struct Smem {
  float a[kStages][kBM * kBK];       // a's hi terms (or the raw tile, split
                                     // in place)
  float a_lo[kStages][kBM * kBK];
  float b[kStages][kBN * kBK];       // b^T's hi terms, [n][k]
  float b_lo[kStages][kBN * kBK];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;

template <bool kSplitInKernel>
__global__ void __launch_bounds__(kThreads, 1)
matmul_tf32_kernel(__grid_constant__ const CUtensorMap map_a,
                   __grid_constant__ const CUtensorMap map_alo,
                   __grid_constant__ const CUtensorMap map_b,
                   __grid_constant__ const CUtensorMap map_blo,
                   float* __restrict__ out, int M, int N, int K) {
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
        mbar_expect_tx(&s.full[st],
                       (kSplitInKernel ? kATile : 2 * kATile) + 2 * kBTile);
        tma_load_2d(s.a[st], &map_a, &s.full[st], kt * kBK, m0);
        if (!kSplitInKernel)
          tma_load_2d(s.a_lo[st], &map_alo, &s.full[st], kt * kBK, m0);
        tma_load_2d(s.b[st], &map_b, &s.full[st], kt * kBK, n0);
        tma_load_2d(s.b_lo[st], &map_blo, &s.full[st], kt * kBK, n0);
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
      float* ah = s.a[st] + wg * 64 * kBK;
      float* al = s.a_lo[st] + wg * 64 * kBK;
      if (kSplitInKernel) {
        // this warpgroup's 64 rows of the raw tile into hi (in place) and
        // lo (the same offsets, so the same swizzle)
#pragma unroll
        for (int i = tid * 4; i < 64 * kBK; i += 128 * 4) {
          const float4 x = *reinterpret_cast<const float4*>(ah + i);
          uint4 hi, lo;
          split_tf32(x.x, hi.x, lo.x);
          split_tf32(x.y, hi.y, lo.y);
          split_tf32(x.z, hi.z, lo.z);
          split_tf32(x.w, hi.w, lo.w);
          *reinterpret_cast<uint4*>(ah + i) = hi;
          *reinterpret_cast<uint4*>(al + i) = lo;
        }
        fence_proxy_async();         // the writes, to the wgmma's proxy
        bar_sync(1 + wg, 128);
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kBK / 8; ++k) {
        // k8 step = 32 bytes along the 128-byte rows of both operands
        const uint64_t dah = desc_sw128(ah + k * 8, 16, 1024);
        const uint64_t dal = desc_sw128(al + k * 8, 16, 1024);
        const uint64_t dbh = desc_sw128(s.b[st] + k * 8, 16, 1024);
        const uint64_t dbl = desc_sw128(s.b_lo[st] + k * 8, 16, 1024);
        wgmma_m64n256k8_tf32_ss(acc, dah, dbl, 1);
        wgmma_m64n256k8_tf32_ss(acc, dal, dbh, 1);
        wgmma_m64n256k8_tf32_ss(acc, dah, dbh, 1);
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
    const bool pairs = N % 2 == 0;     // 8-byte aligned column pairs
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = n0 + i * 8 + 2 * (lane % 4);
      if (col >= N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = row + 8 * r;
        if (m >= M) continue;
        float* o = out + static_cast<size_t>(m) * N + col;
        if (pairs) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
        } else {
          o[0] = acc[4 * i + 2 * r];
          if (col + 1 < N) o[1] = acc[4 * i + 2 * r + 1];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- pre-pass --
constexpr int kPrepThreads = 256;
constexpr int kT = 64;                           // transpose tile

__device__ __forceinline__ void split4(const float (&v)[4], uint4& hi,
                                       uint4& lo) {
  split_tf32(v[0], hi.x, lo.x);
  split_tf32(v[1], hi.y, lo.y);
  split_tf32(v[2], hi.z, lo.z);
  split_tf32(v[3], hi.w, lo.w);
}

// four elements of a row of `len` from column c (zeros past its end):
// 16 bytes at once where `vec` (an aligned base, len a multiple of 4)
__device__ __forceinline__ void load4(const float* row, int c, int len,
                                      bool vec, float (&v)[4]) {
  if (vec && c + 4 <= len) {
    const float4 x = *reinterpret_cast<const float4*>(row + c);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c + j < len ? row[c + j] : 0.f;
  }
}

// a [M,K] -> pair [2][M][Kp], hi then lo
__global__ void __launch_bounds__(kPrepThreads)
split_rows_kernel(const float* __restrict__ a, float* __restrict__ pair,
                  int M, int K, int Kp, bool vec) {
  const size_t quads = static_cast<size_t>(M) * (Kp / 4);
  const size_t n = static_cast<size_t>(M) * Kp;
  for (size_t q = static_cast<size_t>(blockIdx.x) * kPrepThreads +
                  threadIdx.x;
       q < quads; q += static_cast<size_t>(gridDim.x) * kPrepThreads) {
    const int m = static_cast<int>(q / (Kp / 4));
    const int k = static_cast<int>(q % (Kp / 4)) * 4;
    float v[4];
    load4(a + static_cast<size_t>(m) * K, k, K, vec, v);
    uint4 hi, lo;
    split4(v, hi, lo);
    const size_t off = static_cast<size_t>(m) * Kp + k;
    *reinterpret_cast<uint4*>(pair + off) = hi;
    *reinterpret_cast<uint4*>(pair + n + off) = lo;
  }
}

// b [K,N] -> b^T pair [2][N][Kp], hi then lo; block (k tile, n tile) of
// 64 x 64 through shared memory
__global__ void __launch_bounds__(kPrepThreads)
split_transposed_kernel(const float* __restrict__ b, float* __restrict__ pair,
                        int K, int N, int Kp, bool vec) {
  __shared__ float tile[kT][kT + 1];
  const int k0 = blockIdx.x * kT;
  const int n0 = blockIdx.y * kT;
  for (int i = threadIdx.x; i < kT * kT / 4; i += kPrepThreads) {
    const int r = i / (kT / 4);
    const int c = (i % (kT / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (k0 + r < K) load4(b + static_cast<size_t>(k0 + r) * N, n0 + c, N, vec, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) tile[r][c + j] = v[j];
  }
  __syncthreads();
  const size_t n = static_cast<size_t>(N) * Kp;
  for (int i = threadIdx.x; i < kT * kT / 4; i += kPrepThreads) {
    const int r = i / (kT / 4);                  // n
    const int c = (i % (kT / 4)) * 4;            // k
    if (n0 + r >= N || k0 + c >= Kp) continue;
    const float v[4] = {tile[c][r], tile[c + 1][r], tile[c + 2][r],
                        tile[c + 3][r]};
    uint4 hi, lo;
    split4(v, hi, lo);
    const size_t off = static_cast<size_t>(n0 + r) * Kp + k0 + c;
    *reinterpret_cast<uint4*>(pair + off) = hi;
    *reinterpret_cast<uint4*>(pair + n + off) = lo;
  }
}

// [rows, cols] fp32 row-major (row stride `stride` floats, a multiple of 4)
// as a 2-D tensor map with a box of (32, box_rows)
int make_map(CUtensorMap* map, const void* p, int rows, int cols, int stride,
             int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  return make_map_f32(map, p, 2, dims, strides, box);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool kSplitInKernel>
int launch_main(const CUtensorMap& ma, const CUtensorMap& mal,
                const CUtensorMap& mb, const CUtensorMap& mbl, float* out,
                int M, int N, int K, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      matmul_tf32_kernel<kSplitInKernel>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  matmul_tf32_kernel<kSplitInKernel><<<grid, kThreads, kSmemBytes, stream>>>(
      ma, mal, mb, mbl, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [M,K], b [K,N], out [M,N]: contiguous, row-major fp32, at any address.
// Scratch the wrapper allocates (Kp = K rounded up to 4): bt_pair
// [2][N][Kp] (b^T's tf32 hi, then lo) and, unless split_a_in_kernel,
// a_pair [2][M][Kp] (may be null otherwise).  split_a_in_kernel 1 needs a
// 16-byte aligned and K a multiple of 4 (a TMA-able a).  Launches the
// pre-pass and the kernel on `stream`.  Returns 0 or a cudaError_t (a
// launch's, or the tensor maps').
extern "C" int matmul_tf32_launch(const void* a, const void* b, void* out,
                                  void* a_pair, void* bt_pair, int M, int N,
                                  int K, int split_a_in_kernel,
                                  void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || M < 0 || N < 0 || bt_pair == nullptr ||
      (split_a_in_kernel ? (K % 4 != 0 || !aligned16(a))
                         : a_pair == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Kp = (K + 3) / 4 * 4;
  const float* af = static_cast<const float*>(a);
  float* ap = static_cast<float*>(a_pair);
  float* bp = static_cast<float*>(bt_pair);

  const dim3 tgrid((Kp + kT - 1) / kT, (N + kT - 1) / kT);
  split_transposed_kernel<<<tgrid, kPrepThreads, 0, s>>>(
      static_cast<const float*>(b), bp, K, N, Kp, aligned16(b) && N % 4 == 0);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  if (!split_a_in_kernel) {
    const size_t quads = static_cast<size_t>(M) * (Kp / 4);
    const unsigned blocks = static_cast<unsigned>(
        (quads + kPrepThreads - 1) / kPrepThreads < 132 * 32
            ? (quads + kPrepThreads - 1) / kPrepThreads
            : 132 * 32);
    split_rows_kernel<<<blocks, kPrepThreads, 0, s>>>(
        af, ap, M, K, Kp, aligned16(a) && K % 4 == 0);
    if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  }

  CUtensorMap ma, mal, mb, mbl;
  if (split_a_in_kernel) {
    if (int e = make_map(&ma, af, M, K, K, kBM)) return e;
    mal = ma;                                    // unused
  } else {
    if (int e = make_map(&ma, ap, M, Kp, Kp, kBM)) return e;
    if (int e = make_map(&mal, ap + static_cast<size_t>(M) * Kp, M, Kp, Kp,
                         kBM))
      return e;
  }
  if (int e = make_map(&mb, bp, N, Kp, Kp, kBN)) return e;
  if (int e = make_map(&mbl, bp + static_cast<size_t>(N) * Kp, N, Kp, Kp,
                       kBN))
    return e;
  float* o = static_cast<float*>(out);
  return split_a_in_kernel ? launch_main<true>(ma, mal, mb, mbl, o, M, N, K, s)
                           : launch_main<false>(ma, mal, mb, mbl, o, M, N, K,
                                                s);
}
