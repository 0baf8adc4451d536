// Mamba2 chunked SSD scan forward in fp32 on the FP32 pipes (sm_90a): the
// fp32 route of the port's SSD scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_fwd, body _ssd_kernel), and with it, on the prefill path, the
// model's ssd_chunked (src/repro/models/mamba2.py), for fp32 inputs (bf16
// inputs take ssd_scan_wgmma.cu, on the tensor cores).  For one (batch b,
// head h), with chunks of Q rows and the within-chunk inclusive cumulative
// decay cum_t = sum_{r <= t} dt_r * A:
//   y_t  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s   (intra)
//        + exp(cum_t) C_t . S                                     (inter)
//   S   <- exp(cum_last) S + sum_s x_s (exp(cum_last - cum_s) dt_s) B_s
// x [B,L,H,P], dt [B,L,H], A [H], Bm/Cm [B,L,N], all fp32; y [B,L,H,P]
// fp32; the state S is [P,N] per (b, h) and leaves as
// final_state [B,H,P,N] fp32, the model's layout (the TPU kernel keeps
// [N,P] and returns nothing).  An optional initial_state [B,H,P,N] seeds S.
//
// Bound on an H100 in fp32: operations.  At the serving shape (B 8,
// L 1024, H 48, P 64, N 128, chunk 256) the work is ~2.0e10 flops (C.B^T
// once per (b, chunk), since Bm and Cm do not depend on the head, and only
// the causal halves of the Q x Q products), ~0.29 ms at the 67 TFLOP/s of
// the FP32 pipes; the traffic is ~224 MB (x, y, Bm, Cm, dt, state),
// ~67 us at the HBM rate.  (The JAX _meta formula, which the trace keeps,
// counts C.B^T per head and whole: ~5.2e10.)
//
// It runs on the FP32 pipes, not the tensor cores, so that an fp32 result
// is held to a full-fp32 reference and not to TF32.  Design:
//   * one block of 256 threads per (b, h); blocks run in any order, so the
//     TPU grid's sequential chunk axis becomes a loop inside the block;
//   * the [P,N] fp32 state (32 KB at P 64, N 128) stays in shared memory
//     for the whole loop;
//   * per chunk, the 256 threads load dt and scan dt*A (warp shuffles, then
//     one value per warp) into cum[] in shared memory.  The scan sums in
//     fp64: at the model's dt, cum reaches ~-700 within a chunk for the
//     fastest-decaying head, where one fp32 ulp is ~6e-5 and becomes that
//     much relative error in exp(cum_t - cum_s); differences are taken in
//     fp64 and rounded to fp32 for expf;
//   * a chunk's Q x Q matrix C.B^T (256 KB at Q 256) does not fit in shared
//     memory, so it is tiled: for each 64-row t tile, the y tile [64,P]
//     sits in registers (4x4 per thread), starts as the inter-chunk term
//     from the chunk-start state, then walks the 64-row s tiles up to the
//     causal frontier: G = C_t.B_s^T (4x4 per thread, float4 reads of
//     padded rows, conflict-free), masked and weighted by
//     exp(cum_t - cum_s) dt_s (exp taken only for s <= t), then y += G x_s;
//   * after the chunk's last t tile the state is updated from the chunk's
//     s tiles (32 state entries per thread, in registers);
//   * the ragged last chunk is masked: rows past L load as dt = 0, x = 0,
//     B = C = 0, so they add nothing to y or S and leave cum at the last
//     real row's value, which is the chunk's cum_last.  Any L works; the
//     TPU kernel's L % chunk assert is dropped.
// ~139 KB of dynamic shared memory at N 128: one block per SM.
// P = 64 and N in {64, 128} are instances; chunk is a multiple of 64 up to
// 256.  The wrapper refuses others.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // rows of a t or s tile
constexpr int kP = 64;         // head_dim
constexpr int kMaxChunk = 256; // one scan element per thread
constexpr int kRowT = kTile + 4;  // padded row of a [*][64] tile (floats)

// Shared-memory layout, in floats; every float4-read region starts on a
// 16-byte boundary.
template <int N>
struct Layout {
  static constexpr int kRowN = N + 4;  // padded row of a [64][N] tile
  static constexpr int cum = 0;                          // [kMaxChunk] fp64
  static constexpr int dts = cum + 2 * kMaxChunk;        // [kMaxChunk]
  static constexpr int ws = dts + kMaxChunk;             // [kTile]
  static constexpr int wsum = ws + kTile;                // [8] fp64, in 16
  static constexpr int cs = wsum + 16;                   // C tile [64][kRowN]
  static constexpr int bs = cs + kTile * kRowN;          // B tile [64][kRowN]
  static constexpr int xs = bs + kTile * kRowN;          // x tile^T [P][kRowT]
  static constexpr int gs = xs + kP * kRowT;             // G [64][kRowT]
  static constexpr int ss = gs + kTile * kRowT;          // state [P][kRowN]
  static constexpr int total = ss + kP * kRowN;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [0, valid) of a [*, N] matrix (row stride N) into dst[64][N + 4] as
// fp32; rows >= valid are zero.
template <int N>
__device__ __forceinline__ void load_rows(const float* src, int valid, float* dst) {
  constexpr int C4 = N / 4;
  for (int i = threadIdx.x; i < kTile * C4; i += kThreads) {
    const int r = i / C4;
    const int c4 = i % C4;
    const float4 v = r < valid
                         ? flare::Pack4<float>::load(src + static_cast<size_t>(r) * N + 4 * c4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (N + 4) + 4 * c4) = v;
  }
}

// Rows [0, valid) of x (row stride `stride`, P = 64 columns) transposed into
// dst[P][kRowT] as fp32; rows >= valid are zero.  Neighbouring threads take
// neighbouring rows, so the transposed stores are conflict-free.
__device__ __forceinline__ void load_x_t(const float* src, size_t stride, int valid,
                                         float* dst) {
  for (int i = threadIdx.x; i < kTile * (kP / 4); i += kThreads) {
    const int r = i % kTile;
    const int g = i / kTile;
    const float4 v = r < valid ? flare::Pack4<float>::load(src + r * stride + 4 * g)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(4 * g + 0) * kRowT + r] = v.x;
    dst[(4 * g + 1) * kRowT + r] = v.y;
    dst[(4 * g + 2) * kRowT + r] = v.z;
    dst[(4 * g + 3) * kRowT + r] = v.w;
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ init,
                    float* __restrict__ y, float* __restrict__ final_state, int L,
                    int H, int chunk) {
  using Lay = Layout<N>;
  constexpr int kRowN = Lay::kRowN;
  constexpr int NJ = N / 16;  // state columns per thread
  extern __shared__ __align__(16) float smem[];
  double* cum = reinterpret_cast<double*>(smem + Lay::cum);
  float* dts = smem + Lay::dts;
  float* ws = smem + Lay::ws;
  double* wsum = reinterpret_cast<double*>(smem + Lay::wsum);
  float* cs = smem + Lay::cs;
  float* bs = smem + Lay::bs;
  float* xs = smem + Lay::xs;
  float* gs = smem + Lay::gs;
  float* ss = smem + Lay::ss;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = A[h];

  const size_t xrow = static_cast<size_t>(H) * kP;  // x/y stride per position
  const size_t xoff = static_cast<size_t>(b) * L * xrow + static_cast<size_t>(h) * kP;
  const float* xb = x + xoff;
  float* yb = y + xoff;
  const float* dtb = dt + static_cast<size_t>(b) * L * H + h;  // stride H
  const float* Bb = Bm + static_cast<size_t>(b) * L * N;
  const float* Cb = Cm + static_cast<size_t>(b) * L * N;
  const size_t st_off = (static_cast<size_t>(b) * H + h) * kP * N;

  for (int i = tid; i < kP * N; i += kThreads)
    ss[(i / N) * kRowN + i % N] = init ? init[st_off + i] : 0.f;

  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int lc = min(chunk, L - t0);
    const int ntile = (lc + kTile - 1) / kTile;
    __syncthreads();  // the previous chunk is done with shared memory

    // ---- dt and the inclusive scan of dt*A over the chunk -------------- //
    const float d = tid < lc ? dtb[static_cast<size_t>(t0 + tid) * H] : 0.f;
    dts[tid] = d;
    double v = static_cast<double>(d * a);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      double t = lane < kThreads / 32 ? wsum[lane] : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += u;
      }
      if (lane < kThreads / 32) wsum[lane] = t;
    }
    __syncthreads();
    if (warp > 0) v += wsum[warp - 1];
    cum[tid] = v;
    __syncthreads();

    // ---- y, one 64-row t tile at a time --------------------------------- //
    for (int ti = 0; ti < ntile; ++ti) {
      const int tr0 = t0 + ti * kTile;
      const int tvalid = min(kTile, L - tr0);
      __syncthreads();  // every thread is done with cs, bs, xs, gs
      load_rows<N>(Cb + static_cast<size_t>(tr0) * N, tvalid, cs);
      __syncthreads();

      // inter-chunk term: exp(cum_t) * C_t . S_p from the chunk-start state
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 c[4], s[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) c[i] = lds4(cs + (ty + 16 * i) * kRowN + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = lds4(ss + (tx + 16 * j) * kRowN + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = dot4(c[i], s[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(static_cast<float>(cum[ti * kTile + ty + 16 * i]));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // intra-chunk term over the s tiles up to the causal frontier
      for (int sj = 0; sj <= ti; ++sj) {
        const int sr0 = t0 + sj * kTile;
        const int svalid = min(kTile, L - sr0);
        __syncthreads();  // the previous s tile's bs, xs, gs are consumed
        load_rows<N>(Bb + static_cast<size_t>(sr0) * N, svalid, bs);
        load_x_t(xb + sr0 * xrow, xrow, svalid, xs);
        __syncthreads();

        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          float4 c[4], bb[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = lds4(cs + (ty + 16 * i) * kRowN + n);
#pragma unroll
          for (int j = 0; j < 4; ++j) bb[j] = lds4(bs + (tx + 16 * j) * kRowN + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = dot4(c[i], bb[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = ti * kTile + ty + 16 * i;  // chunk-local rows
          const double ct = cum[tl];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sl = sj * kTile + tx + 16 * j;
            const float w =
                sl <= tl ? g[i][j] * expf(static_cast<float>(ct - cum[sl])) * dts[sl]
                         : 0.f;
            gs[(ty + 16 * i) * kRowT + tx + 16 * j] = w;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int s = 0; s < kTile; s += 4) {
          float4 gg[4], xx[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gg[i] = lds4(gs + (ty + 16 * i) * kRowT + s);
#pragma unroll
          for (int j = 0; j < 4; ++j) xx[j] = lds4(xs + (tx + 16 * j) * kRowT + s);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = dot4(gg[i], xx[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < tvalid) {
          float* yr = yb + static_cast<size_t>(tr0 + r) * xrow;
#pragma unroll
          for (int j = 0; j < 4; ++j) yr[tx + 16 * j] = acc[i][j];
        }
      }
    }

    // ---- state update: S = exp(cum_last) S + sum_s x_s w_s B_s --------- //
    // rows past L have dt = 0, so cum at the last row of the last tile is
    // the last real row's cumulative decay
    const double cl = cum[ntile * kTile - 1];
    const float dl = expf(static_cast<float>(cl));
    float sacc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        sacc[i][j] = dl * ss[(ty + 16 * i) * kRowN + tx + 16 * j];
    for (int sj = 0; sj < ntile; ++sj) {
      const int sr0 = t0 + sj * kTile;
      const int svalid = min(kTile, L - sr0);
      __syncthreads();
      load_rows<N>(Bb + static_cast<size_t>(sr0) * N, svalid, bs);
      load_x_t(xb + sr0 * xrow, xrow, svalid, xs);
      if (tid < kTile) {
        const int sl = sj * kTile + tid;
        ws[tid] = expf(static_cast<float>(cl - cum[sl])) * dts[sl];
      }
      __syncthreads();
#pragma unroll 4
      for (int s = 0; s < kTile; ++s) {
        const float w = ws[s];
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 16 * i) * kRowT + s] * w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float bv = bs[s * kRowN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) sacc[i][j] = fmaf(xv[i], bv, sacc[i][j]);
        }
      }
    }
    // each thread rewrites only the entries it read above
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ss[(ty + 16 * i) * kRowN + tx + 16 * j] = sacc[i][j];
  }

  __syncthreads();
  for (int i = tid; i < kP * N; i += kThreads)
    final_state[st_off + i] = ss[(i / N) * kRowN + i % N];
}

template <int N>
int launch_typed(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* init, void* y, void* final_state,
                 int B, int L, int H, int chunk, cudaStream_t stream) {
  const int smem = Layout<N>::total * static_cast<int>(sizeof(float));
  auto kernel = ssd_scan_fwd_kernel<N>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(init),
      static_cast<float*>(y), static_cast<float*>(final_state), L, H, chunk);
  return static_cast<int>(cudaGetLastError());
}

int launch_n(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, void* y, void* final_state,
             int B, int L, int H, int N, int chunk, cudaStream_t stream) {
  if (N == 128)
    return launch_typed<128>(x, dt, A, Bm, Cm, init, y, final_state, B,
                                    L, H, chunk, stream);
  if (N == 64)
    return launch_typed<64>(x, dt, A, Bm, Cm, init, y, final_state, B,
                                   L, H, chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, y: [B,L,H,P]; Bm, Cm: [B,L,N]; dt: [B,L,H], A: [H], init (may be null)
// and final_state: [B,H,P,N]; all float32, contiguous and 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ssd_scan_fwd_launch(const void* x, const void* dt, const void* A,
                                   const void* Bm, const void* Cm,
                                   const void* init, void* y, void* final_state,
                                   int B, int L, int H, int P, int N, int chunk,
                                   void* stream) {
  if (B == 0 || H == 0) return 0;
  if (P != kP || chunk % kTile != 0 || chunk < kTile || chunk > kMaxChunk || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_n(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, N, chunk,
                  static_cast<cudaStream_t>(stream));
}
