// Backward of the Mamba2 chunked SSD scan in fp32 on the FP32 pipes
// (sm_90a): the fp32 route of the port's SSD-scan backward (bf16 inputs
// take ssd_scan_bwd_wgmma.cu, on the tensor cores).
//
// Port-only: the JAX package differentiates its chunked scan
// (src/repro/models/mamba2.py::ssd_chunked) by XLA autodiff, so its
// backward has no Pallas kernel; the forward's TPU kernel is
// src/repro/kernels/ssd_scan/kernel.py (ssd_scan_fwd).  The plain version is
// kernels/ssd_scan/ops.py::ssd_bwd_ref, the same passes in PyTorch.
//
// For one (batch b, head h), chunks of Q rows, a_t = dt_t * A,
// cum_t = sum_{r <= t} a_r within the chunk (fp64), L_ts = exp(cum_t - cum_s)
// for s <= t, G_ts = C_t . B_s, M_ts = dy_t . x_s, w_s = exp(cum_last -
// cum_s) dt_s, S_prev the chunk-start state [P,N] and dS the cotangent of the
// chunk-end state (from d_final_state, or zero, for the last chunk):
//   pass 1, chunks in order: S_prev into a workspace (the forward's
//     recurrence, recomputed in fp32, so the forward kernels keep nothing);
//   pass 2, chunks in reverse, per chunk:
//     dx_s  = sum_{t>=s} G_ts L_ts dt_s dy_t + w_s (dS B_s)
//     dC_t  = sum_{s<=t} M_ts L_ts dt_s B_s + exp(cum_t) S_prev^T dy_t
//     dB_s  = sum_{t>=s} M_ts L_ts dt_s C_t + w_s dS^T x_s
//     ddt_s = sum_{t>=s} G_ts L_ts M_ts + exp(cum_last - cum_s) x_s.(dS B_s)
//             + A da_s
//     dcum_t = sum_{s<=t} G L dt_s M - dt_t ddt_intra_t + exp(cum_t)
//              dy_t.(S_prev C_t) - dt_t ddt_state_t, and at the chunk's last
//              row + exp(cum_last) <dS, S_prev> + sum_s dt_s ddt_state_s;
//     da = reverse cumsum of dcum (fp64); dA += sum_t dt_t da_t;
//     dS <- exp(cum_last) dS + sum_t exp(cum_t) dy_t C_t^T.
// Bm and Cm are shared by the heads (ngroups 1) and A by the batch: the
// block writes dB and dC per head ([B,H,L,N] fp32) and dA per (b, h), and
// ssd_bwd_reduce_kernel sums them in a fixed order.  No atomics:
// deterministic.
//
// Bound on an H100: operations.  At the training shape (B 8, L 512, H 48,
// P 64, N 128, chunk 256) the function needs ~3.6e10 flops
// (chip_smoke.py::ssd_bwd_work_flops: C.B^T once per (b, chunk), the causal
// halves), 0.53 ms at the FP32 pipes' 67 TFLOP/s.  Every product runs on
// the FP32 pipes, so that the fp32 result is held to a full-fp32 reference
// and not to TF32; C.B^T per head, and the per-head partials (2 x 100 MB
// written and read at that shape) on top.  Its own work at that shape is
// ~4.8e10 flops: per (b, h) and 256-row chunk, 10 of the 16 pairs of
// 64-row tiles at 2 (3N + 2P) flops a pair element (G, M, dx, dB, dC), and
// five [P,N] products of 2 Q P N (pass 1's state, S_prev^T dy, dS B, dS^T
// x, dS's update), a 0.72 ms floor at 67 TFLOP/s.
//
// Design: one block of 256 threads per (b, h), walking the chunks; a chunk
// is 1 to 4 tiles of 64 rows.  A thread owns rows ty + 16i (i < 4) and
// columns tx + 16j of each 64-row result tile (ty = tid / 16, tx = tid % 16).
// Per chunk of pass 2:
//   1. over the t tiles: dC_t's inter-chunk term (it initialises the head's
//      dC rows), dy_t.(S_prev C_t) into dcum, and <dS, S_prev>, with S_prev
//      read from the workspace into shared memory;
//   2. for each s tile, dx_s and dB_s in registers (started from the state
//      terms through dS B_s and dS^T x_s), then over the t tiles t >= s:
//      G and M (float4 dot products of padded rows), masked and weighted
//      into the [t][s] tiles G L dt_s and M L dt_s in shared memory, which
//      give dx_s and dB_s (sums over t) and the t tile's share of dC (a sum
//      over s, added to the head's dC rows in device memory: each element
//      belongs to one thread, which reads back only what it wrote); the
//      row and column sums of G L M for dcum and ddt (warp shuffles across
//      a row's 16 threads, shared memory across the 16 row groups, in a
//      fixed order);
//   3. over the t tiles: dS's new value;
//   4. one row a thread: dcum, its reverse scan in fp64, ddt and the
//      chunk's share of dA.
// Rows past L load as zeros (and dt = 0), so they add nothing anywhere and
// leave cum at the last real row's value: any L is taken.  ~182 KB of
// dynamic shared memory at N 128: one block per SM.  P = 64 and N in
// {64, 128} are instances; chunk is a multiple of 64 up to 256.  The
// wrapper refuses others.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // rows of a t or s tile
constexpr int kP = 64;          // head_dim
constexpr int kMaxChunk = 256;  // one row a thread in the scans
constexpr int kRowP = kP + 4;   // padded row of a [64][P] or [64][64] tile

// Shared-memory layout, in floats; every float4-read region starts on a
// 16-byte boundary.
template <int N>
struct Layout {
  static constexpr int kRowN = N + 4;                 // padded [*][N] row
  static constexpr int cum = 0;                       // [kMaxChunk] fp64
  static constexpr int dts = cum + 2 * kMaxChunk;     // dt of the chunk
  static constexpr int et = dts + kMaxChunk;          // exp(cum_t); pass 1: w
  static constexpr int rowd = et + kMaxChunk;         // dcum accumulator
  static constexpr int ddi = rowd + kMaxChunk;        // ddt, intra-chunk
  static constexpr int dds = ddi + kMaxChunk;         // ddt, state term
  static constexpr int wsum = dds + kMaxChunk;        // [8] fp64 + scalars
  static constexpr int red = wsum + 32;               // [16][64]
  static constexpr int cs = red + 16 * kTile;         // C_t [64][kRowN]
  static constexpr int bs = cs + kTile * kRowN;       // B_s [64][kRowN]
  static constexpr int dys = bs + kTile * kRowN;      // dy_t [64][kRowP]
  static constexpr int xs = dys + kTile * kRowP;      // x_s [64][kRowP]
  static constexpr int gls = xs + kTile * kRowP;      // G L dt_s [t][s]
  static constexpr int mls = gls + kTile * kRowP;     // M L dt_s [t][s]
  static constexpr int sp = gls;                      // S_prev [P][kRowN]
  static constexpr int ds = mls + kTile * kRowP;      // dS [P][kRowN]
  static constexpr int total = ds + kP * kRowN;
  static_assert(kP * kRowN <= 2 * kTile * kRowP, "S_prev fits gls + mls");
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

// sum over the 16 threads of a row group (tx), the same in every lane
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [0, valid) of a [*, W] matrix (row stride `stride` elements) into
// dst[64][W + 4]; rows >= valid are zero.
template <int W>
__device__ __forceinline__ void load_rows(const float* src, size_t stride,
                                          int valid, float* dst) {
  constexpr int C4 = W / 4;
  for (int i = threadIdx.x; i < kTile * C4; i += kThreads) {
    const int r = i / C4;
    const int c4 = i % C4;
    const float4 v = r < valid ? flare::Pack4<float>::load(src + r * stride + 4 * c4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (W + 4) + 4 * c4) = v;
  }
}

// A whole-block sum (fixed order: lanes by shuffle, then the warps in
// order); every thread gets it.  `slot` holds kWarps doubles; the caller
// syncs before reusing it.
__device__ __forceinline__ double block_sum(double v, double* slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += slot[w];
  return t;
}

// dt of rows [t0, t0 + lc) into dts (zeros past lc) and the inclusive scan
// of dt*A, summed in fp64, into cum (as the forward kernels); the rows past
// lc hold the last real row's value.  Ends synchronised.
__device__ __forceinline__ void chunk_scan(const float* dtb, int H, int t0, int lc,
                                           float a, double* cum, float* dts,
                                           double* wsum) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
    double t = lane < kWarps ? wsum[lane] : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += u;
    }
    if (lane < kWarps) wsum[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v += wsum[warp - 1];
  cum[tid] = v;
  __syncthreads();
}

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ init,
               const float* __restrict__ dy, const float* __restrict__ dfinal,
               float* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ states, float* __restrict__ dB_part,
               float* __restrict__ dC_part, float* __restrict__ dA_part, int L,
               int H, int chunk) {
  using Lay = Layout<N>;
  constexpr int kRowN = Lay::kRowN;
  constexpr int NJ = N / 16;  // state columns a thread owns
  extern __shared__ __align__(16) float smem[];
  double* cum = reinterpret_cast<double*>(smem + Lay::cum);
  float* dts = smem + Lay::dts;
  float* et = smem + Lay::et;
  float* rowd = smem + Lay::rowd;
  float* ddi = smem + Lay::ddi;
  float* dds = smem + Lay::dds;
  double* wsum = reinterpret_cast<double*>(smem + Lay::wsum);
  float* red = smem + Lay::red;
  float* cs = smem + Lay::cs;
  float* bs = smem + Lay::bs;
  float* dys = smem + Lay::dys;
  float* xs = smem + Lay::xs;
  float* gls = smem + Lay::gls;
  float* mls = smem + Lay::mls;
  float* sp = smem + Lay::sp;
  float* dS = smem + Lay::ds;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = A[h];
  const int nc = (L + chunk - 1) / chunk;

  const size_t xrow = static_cast<size_t>(H) * kP;  // x/dy/dx row stride
  const size_t xoff = static_cast<size_t>(b) * L * xrow + static_cast<size_t>(h) * kP;
  const float* xb = x + xoff;
  const float* dyb = dy + xoff;
  float* dxb = dx + xoff;
  const float* dtb = dt + static_cast<size_t>(b) * L * H + h;  // stride H
  float* ddtb = ddt + static_cast<size_t>(b) * L * H + h;
  const float* Bb = Bm + static_cast<size_t>(b) * L * N;
  const float* Cb = Cm + static_cast<size_t>(b) * L * N;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t st_off = bh * kP * N;
  float* dBh = dB_part + bh * L * N;   // this head's [L][N] partials
  float* dCh = dC_part + bh * L * N;
  float* stb = states + bh * nc * kP * N;

  // ---- pass 1: the chunk-start states, in order ------------------------ //
  // a thread owns state entries (p, n) = (ty + 16i, tx + 16j)
  {
    float sacc[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        sacc[i][j] = init ? init[st_off + (ty + 16 * i) * N + tx + 16 * j] : 0.f;
    for (int c = 0; c < nc; ++c) {
      const int t0 = c * chunk;
      const int lc = min(chunk, L - t0);
      const int ntile = (lc + kTile - 1) / kTile;
      float* out = stb + static_cast<size_t>(c) * kP * N;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) out[(ty + 16 * i) * N + tx + 16 * j] = sacc[i][j];
      __syncthreads();  // the previous chunk is done with shared memory
      chunk_scan(dtb, H, t0, lc, a, cum, dts, wsum);
      const double cl = cum[ntile * kTile - 1];
      const float dl = expf(static_cast<float>(cl));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) sacc[i][j] *= dl;
      for (int sj = 0; sj < ntile; ++sj) {
        const int sr0 = t0 + sj * kTile;
        const int svalid = min(kTile, L - sr0);
        __syncthreads();
        load_rows<N>(Bb + static_cast<size_t>(sr0) * N, N, svalid, bs);
        load_rows<kP>(xb + sr0 * xrow, xrow, svalid, xs);
        if (tid < kTile) {
          const int sl = sj * kTile + tid;
          et[tid] = expf(static_cast<float>(cl - cum[sl])) * dts[sl];
        }
        __syncthreads();
#pragma unroll 4
        for (int s = 0; s < kTile; ++s) {
          const float w = et[s];
          float xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = xs[s * kRowP + ty + 16 * i] * w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float bv = bs[s * kRowN + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) sacc[i][j] = fmaf(xv[i], bv, sacc[i][j]);
          }
        }
      }
    }
  }

  // ---- pass 2: the gradients, chunks in reverse ------------------------ //
  for (int i = tid; i < kP * N; i += kThreads)
    dS[(i / N) * kRowN + i % N] = dfinal ? dfinal[st_off + i] : 0.f;
  double dA_acc = 0.0;  // this (b, h)'s sum of dt * da (every thread)

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int lc = min(chunk, L - t0);
    const int ntile = (lc + kTile - 1) / kTile;
    __syncthreads();  // the previous chunk is done with shared memory
    chunk_scan(dtb, H, t0, lc, a, cum, dts, wsum);
    et[tid] = expf(static_cast<float>(cum[tid]));
    rowd[tid] = 0.f;
    ddi[tid] = 0.f;
    dds[tid] = 0.f;
    const double cl = cum[ntile * kTile - 1];

    // -- 1. inter-chunk terms: dC_t = e_t S_prev^T dy_t, dcum_t += C_t.dC_t
    for (int i = tid; i < kP * N; i += kThreads)
      sp[(i / N) * kRowN + i % N] = stb[static_cast<size_t>(c) * kP * N + i];
    __syncthreads();
    {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int o = (ty + 16 * i) * kRowN + tx + 16 * j;
          part = fmaf(dS[o], sp[o], part);
        }
      const double dss = block_sum(static_cast<double>(part), wsum);
      if (tid == 0) wsum[kWarps] = dss;  // <dS, S_prev>, read in step 4
    }
    for (int ti = 0; ti < ntile; ++ti) {
      const int tr0 = t0 + ti * kTile;
      const int tvalid = min(kTile, L - tr0);
      __syncthreads();
      load_rows<N>(Cb + static_cast<size_t>(tr0) * N, N, tvalid, cs);
      load_rows<kP>(dyb + tr0 * xrow, xrow, tvalid, dys);
      __syncthreads();
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int p = 0; p < kP; ++p) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = dys[(ty + 16 * i) * kRowP + p];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float sv = sp[p * kRowN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], sv, acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float e = et[ti * kTile + r];
        float edot = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][j] *= e;
          edot = fmaf(cs[r * kRowN + tx + 16 * j], acc[i][j], edot);
        }
        edot = sum16(edot);
        if (tx == 0) rowd[ti * kTile + r] += edot;
        if (r < tvalid) {
          float* o = dCh + static_cast<size_t>(tr0 + r) * N;
#pragma unroll
          for (int j = 0; j < NJ; ++j) o[tx + 16 * j] = acc[i][j];
        }
      }
    }

    // -- 2. per s tile: dx_s, dB_s; the intra-chunk pairs t >= s ----------- //
    for (int sj = 0; sj < ntile; ++sj) {
      const int sr0 = t0 + sj * kTile;
      const int svalid = min(kTile, L - sr0);
      __syncthreads();  // sp (in gls/mls), bs, xs, red are free
      load_rows<N>(Bb + static_cast<size_t>(sr0) * N, N, svalid, bs);
      load_rows<kP>(xb + sr0 * xrow, xrow, svalid, xs);
      __syncthreads();
      // a thread owns s rows ty + 16i and p or n columns tx + 16j
      float dxa[4][4], dba[4][NJ];
      // V = B_s dS^T (dot products of padded rows)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dxa[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        float4 bv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = lds4(bs + (ty + 16 * i) * kRowN + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = lds4(dS + (tx + 16 * j) * kRowN + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dxa[i][j] = dot4(bv[i], sv[j], dxa[i][j]);
      }
      // dS^T x_s
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dba[i][j] = 0.f;
#pragma unroll 4
      for (int p = 0; p < kP; ++p) {
        float xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 16 * i) * kRowP + p];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float sv = dS[p * kRowN + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) dba[i][j] = fmaf(xv[i], sv, dba[i][j]);
        }
      }
      // ddt_state_s = exp(cl - cum_s) x_s.V_s; dx_s, dB_s start at w_s times
      // the state terms
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int sl = sj * kTile + r;
        const float es = expf(static_cast<float>(cl - cum[sl]));
        float xv = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          xv = fmaf(xs[r * kRowP + tx + 16 * j], dxa[i][j], xv);
        xv = sum16(xv);
        if (tx == 0) dds[sl] = es * xv;
        const float w = es * dts[sl];
#pragma unroll
        for (int j = 0; j < 4; ++j) dxa[i][j] *= w;
#pragma unroll
        for (int j = 0; j < NJ; ++j) dba[i][j] *= w;
      }

      float colp[4] = {0.f, 0.f, 0.f, 0.f};  // sum over t of G L M at s = tx + 16j
      for (int ti = sj; ti < ntile; ++ti) {
        const int tr0 = t0 + ti * kTile;
        const int tvalid = min(kTile, L - tr0);
        __syncthreads();  // cs, dys, gls, mls are free
        load_rows<N>(Cb + static_cast<size_t>(tr0) * N, N, tvalid, cs);
        load_rows<kP>(dyb + tr0 * xrow, xrow, tvalid, dys);
        __syncthreads();
        // G = C_t B_s^T and M = dy_t x_s^T, t rows ty + 16i, s columns
        // tx + 16j
        float g[4][4], m[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = m[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = lds4(cs + (ty + 16 * i) * kRowN + n);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = lds4(bs + (tx + 16 * j) * kRowN + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = dot4(cv[i], bv[j], g[i][j]);
        }
#pragma unroll 4
        for (int p = 0; p < kP; p += 4) {
          float4 yv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = lds4(dys + (ty + 16 * i) * kRowP + p);
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = lds4(xs + (tx + 16 * j) * kRowP + p);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) m[i][j] = dot4(yv[i], xv[j], m[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int tl = ti * kTile + ty + 16 * i;  // chunk-local rows
          const double ct = cum[tl];
          float rowp = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int sl = sj * kTile + tx + 16 * j;
            float gl = 0.f, ml = 0.f;
            if (sl <= tl) {
              const float l = expf(static_cast<float>(ct - cum[sl]));
              gl = g[i][j] * l;
              ml = m[i][j] * l;
              const float d = gl * m[i][j];
              colp[j] += d;
              rowp = fmaf(d, dts[sl], rowp);
            }
            gls[(ty + 16 * i) * kRowP + tx + 16 * j] = gl * dts[sl];
            mls[(ty + 16 * i) * kRowP + tx + 16 * j] = ml * dts[sl];
          }
          rowp = sum16(rowp);
          if (tx == 0) rowd[tl] += rowp;
        }
        __syncthreads();
        // dx_s += sum_t (G L dt_s)[t][s] dy_t; dB_s += sum_t (M L dt_s)[t][s] C_t
#pragma unroll 2
        for (int t = 0; t < kTile; ++t) {
          float gv[4], mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            gv[i] = gls[t * kRowP + ty + 16 * i];
            mv[i] = mls[t * kRowP + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float yv = dys[t * kRowP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) dxa[i][j] = fmaf(gv[i], yv, dxa[i][j]);
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float cv = cs[t * kRowN + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) dba[i][j] = fmaf(mv[i], cv, dba[i][j]);
          }
        }
        // dC_t += sum_s (M L dt_s)[t][s] B_s, t rows ty + 16i
        float dct[4][NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) dct[i][j] = 0.f;
#pragma unroll 2
        for (int s = 0; s < kTile; ++s) {
          float mv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = mls[(ty + 16 * i) * kRowP + s];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float bv = bs[s * kRowN + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) dct[i][j] = fmaf(mv[i], bv, dct[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          if (r < tvalid) {
            float* o = dCh + static_cast<size_t>(tr0 + r) * N;
#pragma unroll
            for (int j = 0; j < NJ; ++j) o[tx + 16 * j] += dct[i][j];
          }
        }
      }

      // this s tile is done: dx, dB partials, and ddt's intra-chunk sum
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < svalid) {
          float* o = dxb + (sr0 + r) * xrow;
#pragma unroll
          for (int j = 0; j < 4; ++j) o[tx + 16 * j] = dxa[i][j];
          float* ob = dBh + static_cast<size_t>(sr0 + r) * N;
#pragma unroll
          for (int j = 0; j < NJ; ++j) ob[tx + 16 * j] = dba[i][j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) red[ty * kTile + tx + 16 * j] = colp[j];
      __syncthreads();
      if (tid < kTile) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < 16; ++r) s += red[r * kTile + tid];
        ddi[sj * kTile + tid] = s;
      }
    }

    // -- 3. the state cotangent: dS <- exp(cl) dS + sum_t e_t dy_t C_t^T --- //
    {
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int ti = 0; ti < ntile; ++ti) {
        const int tr0 = t0 + ti * kTile;
        const int tvalid = min(kTile, L - tr0);
        __syncthreads();
        load_rows<N>(Cb + static_cast<size_t>(tr0) * N, N, tvalid, cs);
        load_rows<kP>(dyb + tr0 * xrow, xrow, tvalid, dys);
        __syncthreads();
#pragma unroll 4
        for (int t = 0; t < kTile; ++t) {
          const float e = et[ti * kTile + t];
          float yv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) yv[i] = dys[t * kRowP + ty + 16 * i] * e;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float cv = cs[t * kRowN + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(yv[i], cv, acc[i][j]);
          }
        }
      }
      const float dl = expf(static_cast<float>(cl));
      // each thread rewrites only its own entries; step 2 read dS before the
      // barriers above
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int o = (ty + 16 * i) * kRowN + tx + 16 * j;
          dS[o] = fmaf(dl, dS[o], acc[i][j]);
        }
    }

    // -- 4. dcum, its reverse scan (fp64), ddt and dA, one row a thread ---- //
    __syncthreads();  // rowd, ddi, dds are complete
    {
      const float f = tid < lc ? dts[tid] * dds[tid] : 0.f;
      const double sumF = block_sum(static_cast<double>(f), wsum);
      const double dss = wsum[kWarps];
      if (tid < lc) {
        float v = rowd[tid] - dts[tid] * (ddi[tid] + dds[tid]);
        if (tid == lc - 1)
          v += expf(static_cast<float>(cl)) * static_cast<float>(dss) +
               static_cast<float>(sumF);
        rowd[tid] = v;
      } else {
        rowd[tid] = 0.f;
      }
      __syncthreads();
      // reverse inclusive scan: thread tid holds row r = 255 - tid
      const int lane = tid & 31;
      const int warp = tid >> 5;
      const int r = kMaxChunk - 1 - tid;
      double v = static_cast<double>(rowd[r]);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      __syncthreads();  // block_sum's reads of wsum are done
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      if (warp == 0) {
        double t = lane < kWarps ? wsum[lane] : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, t, off);
          if (lane >= off) t += u;
        }
        if (lane < kWarps) wsum[lane] = t;
      }
      __syncthreads();
      if (warp > 0) v += wsum[warp - 1];   // da of row r
      double adt = 0.0;
      if (r < lc) {
        ddtb[static_cast<size_t>(t0 + r) * H] =
            ddi[r] + dds[r] + static_cast<float>(static_cast<double>(a) * v);
        adt = static_cast<double>(dts[r]) * v;
      }
      __syncthreads();  // the scan's reads of wsum are done
      dA_acc += block_sum(adt, wsum);
    }
  }
  if (tid == 0) dA_part[bh] = static_cast<float>(dA_acc);
}

// dBm[b,l,n] = sum_h dB_part[b,h,l,n] (the same for dC), heads in order;
// dA[h] = sum_b dA_part[b,h], batch rows in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dB_part,
                      const float* __restrict__ dC_part,
                      const float* __restrict__ dA_part, float* __restrict__ dBm,
                      float* __restrict__ dCm, float* __restrict__ dA, int B, int L,
                      int H, int N) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t per_b = static_cast<size_t>(L) * N;
  if (i < static_cast<size_t>(B) * per_b) {
    const size_t b = i / per_b;
    const size_t rem = i % per_b;
    const float* pb = dB_part + b * H * per_b + rem;
    const float* pc = dC_part + b * H * per_b + rem;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
      sb += pb[h * per_b];
      sc += pc[h * per_b];
    }
    dBm[i] = sb;
    dCm[i] = sc;
  }
  if (i < static_cast<size_t>(H)) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += dA_part[static_cast<size_t>(b) * H + i];
    dA[i] = s;
  }
}

template <int N>
int launch_main(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* init, const void* dy,
                const void* dfinal, void* dx, void* ddt, void* states,
                void* dB_part, void* dC_part, void* dA_part, int B, int L, int H,
                int chunk, cudaStream_t stream) {
  const int smem = Layout<N>::total * static_cast<int>(sizeof(float));
  auto kernel = ssd_bwd_kernel<N>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<B * H, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<const float*>(init),
      static_cast<const float*>(dy), static_cast<const float*>(dfinal),
      static_cast<float*>(dx), static_cast<float*>(ddt), static_cast<float*>(states),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dA_part), L, H, chunk);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* init, const void* dy,
               const void* dfinal, void* dx, void* ddt, void* dA, void* dBm,
               void* dCm, void* states, void* dB_part, void* dC_part,
               void* dA_part, int B, int L, int H, int P, int N, int chunk,
               void* stream) {
  if (H == 0) return 0;
  if (P != kP || chunk % kTile != 0 || chunk < kTile || chunk > kMaxChunk ||
      L < 0 || B < 0 || (N != 64 && N != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    const int e =
        N == 128 ? launch_main<128>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt,
                                    states, dB_part, dC_part, dA_part, B, L, H,
                                    chunk, s)
                 : launch_main<64>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt,
                                   states, dB_part, dC_part, dA_part, B, L, H,
                                   chunk, s);
    if (e != 0) return e;
  }
  const size_t n = std::max(static_cast<size_t>(B) * L * N, static_cast<size_t>(H));
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  ssd_bwd_reduce_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<float*>(dBm), static_cast<float*>(dCm),
      static_cast<float*>(dA), B, L, H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, dy, dx: [B,L,H,P]; Bm, Cm, dBm, dCm: [B,L,N]; dt, ddt: [B,L,H], A,
// dA: [H], init and dfinal (either may be null: zero) [B,H,P,N]; all
// float32.  Scratch, float32: states [B,H,ceil(L/chunk),P,N], dB_part and
// dC_part [B,H,L,N], dA_part [B,H].  Every tensor contiguous and 16-byte
// aligned.  Launches ssd_bwd_kernel (B*H blocks) and ssd_bwd_reduce_kernel
// on `stream`.  Returns 0 or the first cudaError_t.
extern "C" int ssd_scan_bwd_f32_launch(const void* x, const void* dt,
                                       const void* A, const void* Bm,
                                       const void* Cm, const void* init,
                                       const void* dy, const void* dfinal,
                                       void* dx, void* ddt, void* dA, void* dBm,
                                       void* dCm, void* states, void* dB_part,
                                       void* dC_part, void* dA_part, int B,
                                       int L, int H, int P, int N, int chunk,
                                       void* stream) {
  return launch_f32(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm, dCm,
                    states, dB_part, dC_part, dA_part, B, L, H, P, N, chunk,
                    stream);
}
