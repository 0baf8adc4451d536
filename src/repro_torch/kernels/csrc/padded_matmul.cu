// Tiled fp32 matmul for Hopper (sm_90a) on the FP32 pipes: the fp32 route
// of the Case-2 padded matmul (bf16 takes padded_matmul_wgmma.cu).
//
// Replaces the TPU kernel src/repro/kernels/padded_matmul/kernel.py
// (matmul_tiled, body _mm_kernel) for fp32 inputs: out = a @ b over
// (M/128, N/128) output tiles, the K axis walked inside the tile, one fp32
// sum per output.
//
// Bound on an H100: operations.  This kernel runs on the FP32 pipes on
// purpose: IEEE fp32 fused multiply-adds, so the fp32 result is held to a
// full-fp32 reference and not to TF32 (the tensor cores take fp32 only as
// TF32); its ceiling is the 67 TFLOP/s of those pipes.
// Design: one block of 256 threads per 128x128 output tile; K steps of 16
// staged in shared memory as fp32 (a transposed, so each thread reads its
// rows as float4), double-buffered with the next step's loads held in
// registers during the products; each thread keeps an 8x8 fp32 micro-tile
// in registers, as two 4-row by two 4-column quadrants so the float4
// shared-memory reads of a warp are conflict-free.  Global loads move 16
// bytes a thread where the pointers and the row length allow it.  The
// ragged edges of M, N and K are masked (zeros in, nothing out), so any
// shape is taken; the op pads to the 128 tile before it calls the kernel.

#include "common.cuh"

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;

// eight consecutive elements from p[col .. col+8) of a row of `limit`,
// widened to fp32; zeros past the row's end (or for a row out of range)
template <typename T>
__device__ __forceinline__ void load8(const T* row, bool row_ok, int col,
                                     int limit, bool vec_ok, float (&v)[8]) {
  if (row_ok && vec_ok && col + 8 <= limit) {
    const float4 lo = flare::Pack4<T>::load(row + col);
    const float4 hi = flare::Pack4<T>::load(row + col + 4);
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (row_ok && col + j < limit) ? flare::to_float(row[col + j]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matmul_tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ out, int M, int N, int K, bool vec_a,
                    bool vec_b, bool vec_out) {
  __shared__ __align__(16) float As[2][kBK][kBM];   // a tile, transposed
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;          // output columns tx*4 and 64 + tx*4
  const int ty = tid / 16;          // output rows    ty*4 and 64 + ty*4
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // what this thread loads: a row m0 + am, k offsets ak .. ak+8 of the
  // step; b row bk of the step, columns n0 + bn .. +8
  const int am = tid % kBM;
  const int ak = (tid / kBM) * 8;
  const int bk = tid / 16;
  const int bn = (tid % 16) * 8;
  const bool a_row_ok = m0 + am < M;
  const T* a_row = a + static_cast<size_t>(a_row_ok ? m0 + am : 0) * K;

  float ra[8], rb[8];
  auto load_step = [&](int k0) {
    load8(a_row, a_row_ok, k0 + ak, K, vec_a, ra);
    const bool b_row_ok = k0 + bk < K;
    const T* b_row = b + static_cast<size_t>(b_row_ok ? k0 + bk : 0) * N;
    load8(b_row, b_row_ok, n0 + bn, N, vec_b, rb);
  };
  auto store_step = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) As[buf][ak + j][am] = ra[j];
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) =
        make_float4(rb[0], rb[1], rb[2], rb[3]);
    *reinterpret_cast<float4*>(&Bs[buf][bk][bn + 4]) =
        make_float4(rb[4], rb[5], rb[6], rb[7]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int steps = (K + kBK - 1) / kBK;
  load_step(0);
  store_step(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load_step((s + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read in step s - 1, before the barrier
    // that ended it
    if (s + 1 < steps) store_step(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
    T* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (vec_out && n + 4 <= N) {
        flare::Pack4<T>::store(
            orow + n, make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                                  acc[i][h * 4 + 2], acc[i][h * 4 + 3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) orow[n + j] = flare::from_float<T>(acc[i][h * 4 + j]);
      }
    }
  }
}

template <typename T>
void launch_typed(const void* a, const void* b, void* out, int M, int N, int K,
                  cudaStream_t stream) {
  auto al16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  // 8 elements a thread: 16 bytes of bf16, two float4 of fp32; rows must
  // keep that alignment, so the row length is a multiple of 8 (bf16) or 4
  constexpr int kRowAlign = 16 / sizeof(T) >= 8 ? 8 : 4;
  const bool vec_a = al16(a) && K % kRowAlign == 0;
  const bool vec_b = al16(b) && N % kRowAlign == 0;
  // a 4-element store: 16 bytes (fp32) or 8 bytes (bf16)
  const bool vec_out = al16(out) && N % 4 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_tiled_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, N, K, vec_a, vec_b, vec_out);
}

}  // namespace

// a [M,K], b [K,N], out [M,N]: contiguous, row-major fp32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int matmul_tiled_launch(const void* a, const void* b, void* out,
                                   int M, int N, int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  launch_typed<float>(a, b, out, M, N, K, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
