// Backward of the Mamba2 chunked SSD scan in bf16 on the Hopper tensor
// cores (sm_90a): the bf16 route of the port's SSD-scan backward.
//
// Port-only: the JAX package differentiates its chunked scan
// (src/repro/models/mamba2.py::ssd_chunked) by XLA autodiff, so its
// backward has no Pallas kernel; the forward's TPU kernel is
// src/repro/kernels/ssd_scan/kernel.py (ssd_scan_fwd).  The plain version is
// kernels/ssd_scan/ops.py::ssd_bwd_ref.  (fp32 inputs take
// ssd_scan_bwd_tf32.cu, split TF32.)  For one (batch b, head h), chunks of
// Q rows, cum_t = sum_{r <= t} dt_r A (fp64), L_ts = exp(cum_t - cum_s)
// for s <= t, G_ts = C_t . B_s, M_ts = dy_t . x_s, w_s = exp(cum_last -
// cum_s) dt_s, S_prev the chunk-start state [P,N], dS the cotangent of the
// chunk-end state:
//   dx_s  = sum_{t>=s} G_ts L_ts dt_s dy_t + w_s (B_s . dS^T)
//   dB_s  = sum_h [sum_{t>=s} M_ts L_ts dt_s C_t + w_s (x_s . dS)]
//   dC_t  = sum_h [sum_{s<=t} M_ts L_ts dt_s B_s + exp(cum_t) (dy_t . S_prev)]
//   ddt, dA from dcum, the cotangent of cum, by a reverse cumsum in fp64.
// It is an attention backward with a decay in place of the softmax: C, B,
// x, dy play Q, K, V, dO; dx and dB are the dV and dK analogs (sums over
// t >= s), dC the dQ analog (a sum over s <= t).  B and C are shared by
// all H heads (ngroups 1), so dB and dC are sums over heads.
//
// Bound on an H100: operations.  At the training shape (B 8, L 512, H 48,
// P 64, N 128, chunk 256) the function needs 3.56e10 flops
// (chip_smoke.py::ssd_bwd_work_flops), 0.036 ms at the bf16 peak, against
// 81 MB of inputs and outputs (0.024 ms).  This design does ~9.7e10: per
// (b, h, chunk) 10 causal pairs of 64-row tiles at ~8.4e6 flops (G^T, M^T,
// G, M, and the doubled dx, dB and dC products) and ~4.2e7 of doubled
// state products, G recomputed per head.
//
// Numerics.  Every product has one exact bf16 operand (an input: x, dy, B,
// C) and one that is an fp32 result (the scores G L dt_s and M L dt_s, w o x,
// exp(cum) o dy, S_prev, dS), which enters as a bf16 pair hi + lo, hi =
// bf16(v), lo = bf16(v - hi): both halves multiply the same bf16 operand
// into the fp32 accumulator, so the operand carries ~16 bits.  A plain bf16
// operand fails chip_smoke.py's check (ddt, dBm, dCm and dx elements
// outside TOLS; tests/test_torch_ssd_bwd.py shows it on the CPU at B 2,
// L 512, H 48, N 128 and shows that the split passes), so no lo half is
// dropped.  The state terms keep the per-row scales out of the operands:
// dx_s += w_s (B_s . dS^T), dB_s += w_s (x_s . dS), dC_t += exp(cum_t)
// (dy_t . S_prev), each product into a per-head accumulator scaled in
// registers.  Every exp takes an fp64 difference of cum rounded to fp32.
//
// Design: five launches on one stream, deterministic, no atomics.
//   1. ssd_bwd_state_kernel, a block (one warpgroup) per (b, h): the cum of
//      every chunk (fp64, into scratch for the others), then, chunks in
//      order, S_c = (w o x)^T . B on wgmma (the A operand by a transposed
//      ldmatrix of the TMA x tile, scaled and split), the chunk-start
//      states S_prev; then, chunks in reverse from d_final_state, U_c =
//      (exp(cum) o dy)^T . C the same way, the chunk-end cotangents dS and
//      <dS, S_prev>.  S_prev and dS go to scratch as bf16 hi and lo tiles
//      already in the 128-byte swizzle, [B,H,nc,2,P,N], so that the next
//      kernels bring each head's in one bulk copy.
//   2. ssd_bwd_dxdb_kernel, a block per (b, 64-row s tile, group of 8
//      heads), heaviest s tiles first.  B_s by TMA once; per head x_s by
//      TMA and dS by bulk copy; C_t and dy_t through a 2-stage TMA ring.
//      Per head: V = B_s . dS^T and x_s . dS (ss wgmma, dS MN-major for
//      the second) start dx_s and add into dB_s; ddt_state_s = e_s rowsum
//      (x_s o V); then over the t tiles t >= s of the chunk: G^T = B_s .
//      C_t^T and M^T = x_s . dy_t^T (ss), the decay, mask and dt_s in
//      registers, ddt_intra_s as row sums of G^T L M^T, then dx_s +=
//      (G^T L dt) . dy_t as rs wgmma, the hi and lo fragments on the same
//      dy_t (MN-major by the transpose bit), and dB_s += (M^T L dt) . C_t.
//      dx_s is written per head; dB_s stays in fp32 registers across the
//      group's heads and is written once per group.
//   3. ssd_bwd_dc_kernel, a block per (b, 64-row t tile, group of 8 heads),
//      heaviest t tiles first.  C_t by TMA once; per head dy_t and S_prev;
//      B_s and x_s through the ring over s <= t.  Per head: dy_t . S_prev
//      (ss) gives dC_t's state term and E_t = exp(cum_t) rowsum(. o C_t);
//      then G = C_t . B_s^T, M = dy_t . x_s^T, the row sums of G L M dt_s,
//      and dC_t += (M L dt) . B_s with the split fragments.  dC_t stays in
//      registers across the group's heads.
//   4. ssd_bwd_finish_kernel, a block per (b, h), one row a thread: dcum,
//      its reverse scan in fp64, ddt and the (b, h) share of dA;
//   5. ssd_bwd_sum_kernel: dBm and dCm as the sums of the groups'
//      partials in group order, dA over the batch in order.  (4 and 5 stay
//      apart: dA's sum over the batch needs every (b, h) finished.)  Both
//      are in ssd_bwd_common.cuh, shared with the fp32 route.
// Scratch at the training shape: the dB and dC partials [B, ceil(H/8), L,
// N] fp32 are 12.6 MB each, 25.2 MB together (per-head partials would be
// 201.3 MB); S_prev and dS in bf16 pairs 25.2 MB each; cum and the row
// terms ~4 MB.  Blocks are one warpgroup of at most 255 registers and
// ~108 KB of shared memory at N 128, two to an SM, so that one block's
// loads and scalar work overlap the other's products.
// Rows past L load as zeros (TMA fills them) with dt = 0, so they add
// nothing and leave cum at the last real row's value: any L is taken.
// The tiles are 64 columns of x and dy (kP) and N = 64 or 128 columns of
// Bm / Cm (the two instances); head_dim P in {8, 16, 32, 64} and state Ns
// in {8, 16, 32, 64, 128} are taken at run time: the tensor maps of x, dy,
// Bm and Cm have the true widths, so the box columns past them load as
// zeros, which add exact zeros to every product and leave the states' and
// cotangents' rows past P and columns past Ns zero; the initial state and
// the final state's cotangent are read, dx, dBm and dCm written at their
// true widths, and the scratch (S_prev, dS, the partials) keeps the padded
// tiles.  chunk is a multiple of 64 up to 256.  The wrapper refuses others.

#include "common.cuh"
#include "hopper.cuh"
#include "ssd_bwd_common.cuh"

namespace {

using namespace flare::hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = kScanThreads;  // one warpgroup
constexpr int kP = 64;                  // the columns of an x or dy tile
constexpr uint32_t kBlockBytes = 64 * 64 * 2;  // one swizzled [64][64] block

// ------------------------------------------------------------- helpers --

// the offset of element (r, col) in a tile of 64 rows stored as col / 64
// blocks of [64 rows][64] bf16 in the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int col) {
  return (col / 64) * 64 * 64 + r * 64 + ((((col % 64) / 8) ^ (r % 8)) * 8) +
         col % 8;
}

// the pair (r, col), (r, col + 1) of such a tile, col even
__device__ __forceinline__ float2 tile_pair(const bf16* t, int r, int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(t + swz(r, col)));
}

// hi = bf16(a, b), lo = bf16((a, b) - hi)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(a - f.x, b - f.y);
}

// a bf16 pair scaled by (fa, fb) and split
__device__ __forceinline__ void scale_split(uint32_t v, float fa, float fb,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split2(f.x * fa, f.y * fb, hi, lo);
}

// the accumulator fragment of D[64, 64] as the hi and lo A fragments of a
// product over its 64 columns (four k16 steps)
__device__ __forceinline__ void split_a(uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4],
                                        const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split2(d[8 * kk + 2 * q], d[8 * kk + 2 * q + 1], hi[kk][q], lo[kk][q]);
  }
}

// D[64,N] (+)= A[64,16] (shared, K-major) . B[16,N] (shared, MN-major)
__device__ __forceinline__ void ss_mn(float (&d)[32], uint64_t da,
                                      uint64_t db, int scale_d) {
  wgmma_m64n64k16_ss<1>(d, da, db, scale_d);
}
__device__ __forceinline__ void ss_mn(float (&d)[64], uint64_t da,
                                      uint64_t db, int scale_d) {
  wgmma_m64n128k16_ss<1>(d, da, db, scale_d);
}
// D[64,N] += A[64,16] (registers) . B[16,N] (shared, MN-major)
__device__ __forceinline__ void rs_mn(float (&d)[32], const uint32_t (&a)[4],
                                      uint64_t db) {
  wgmma_m64n64k16_rs<1>(d, a, db, 1);
}
__device__ __forceinline__ void rs_mn(float (&d)[64], const uint32_t (&a)[4],
                                      uint64_t db) {
  wgmma_m64n128k16_rs<1>(d, a, db, 1);
}

// D[64,64] (+)= A[64 rows of a, K] . B[64 rows of b, K]^T: both tiles
// K-major, K / 64 column blocks of [64][64]
template <int K>
__device__ __forceinline__ void issue_nt(float (&d)[32], const bf16* a,
                                         const bf16* b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const int off = (kk / 4) * 64 * 64 + (kk % 4) * 16;
    wgmma_m64n64k16_ss<0>(d, desc_sw128(a + off, 16, 1024),
                          desc_sw128(b + off, 16, 1024),
                          (kk > 0 || accumulate) ? 1 : 0);
  }
}

// D[64,N] (+)= A[64, 64] (shared, K-major, one block) . B[64, N] (shared,
// MN-major: rows K, N / 64 column blocks)
template <int N2>
__device__ __forceinline__ void issue_kn(float (&d)[N2], const bf16* a,
                                         const bf16* b, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ss_mn(d, desc_sw128(a + kk * 16, 16, 1024),
          desc_sw128(b + kk * 16 * 64, kBlockBytes, 1024),
          (kk > 0 || accumulate) ? 1 : 0);
}

// D[64,N] += A[64, 64] (registers, four k16 fragments) . B[64, N] (shared,
// MN-major)
template <int N2>
__device__ __forceinline__ void issue_rs(float (&d)[N2],
                                         const uint32_t (&a)[4][4],
                                         const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    rs_mn(d, a[kk], desc_sw128(b + kk * 16 * 64, kBlockBytes, 1024));
}

// --------------------------------------------------------------- state --

template <int N>
struct StateSmem {
  bf16 rows[2][kTile * N];   // ring: B_s (forward pass) or C_t (reverse)
  bf16 hd[2][kTile * kP];    // ring: x_s or dy_t
  double cum[kMaxChunk];
  float dts[kMaxChunk];
  float scale[kMaxChunk];    // w_s (forward pass) or exp(cum_t) (reverse)
  double wsum[kThreads / 32];
  float red[kThreads / 32];
  uint64_t full[2];
};

// the per-thread [P, N] state fragment (rows p = r0, r0 + 8, columns 8i +
// c0 + {0, 1}) as bf16 hi and lo tiles in the swizzle, at o and o + P*N
template <int N>
__device__ __forceinline__ void store_split(bf16* o, const float (&st)[N / 2],
                                            int r0, int c0) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t hi, lo;
      split2(st[4 * i + 2 * r], st[4 * i + 2 * r + 1], hi, lo);
      const int off = swz(r0 + 8 * r, 8 * i + c0);
      *reinterpret_cast<uint32_t*>(o + off) = hi;
      *reinterpret_cast<uint32_t*>(o + kP * N + off) = lo;
    }
  }
}

// acc[P, N] += (f o v)^T . rows: v the [64 rows][P] tile (x_s or dy_t),
// f the per-row scale (w or exp(cum)) from f0, its transpose built by
// ldmatrix, split; rows the [64 rows][N] tile, MN-major
template <int N>
__device__ __forceinline__ void state_product(float (&acc)[N / 2],
                                              const bf16* v, const bf16* rows,
                                              const float* f) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int c0 = 2 * (lane % 4);
  const int mj = lane / 8;
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t raw[4];
    const int s = kk * 16 + (mj / 2) * 8 + lane % 8;
    const int pc = 2 * warp + (mj % 2);
    ldmatrix_x4_trans(raw, v + s * 64 + ((pc ^ (s % 8)) * 8));
    const int sl = kk * 16 + c0;
    scale_split(raw[0], f[sl], f[sl + 1], hi[kk][0], lo[kk][0]);
    scale_split(raw[1], f[sl], f[sl + 1], hi[kk][1], lo[kk][1]);
    scale_split(raw[2], f[sl + 8], f[sl + 9], hi[kk][2], lo[kk][2]);
    scale_split(raw[3], f[sl + 8], f[sl + 9], hi[kk][3], lo[kk][3]);
  }
  fence_regs(acc);
  wgmma_fence();
  issue_rs(acc, hi, rows);
  issue_rs(acc, lo, rows);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_state_kernel(__grid_constant__ const CUtensorMap map_x,
                     __grid_constant__ const CUtensorMap map_dy,
                     __grid_constant__ const CUtensorMap map_b,
                     __grid_constant__ const CUtensorMap map_c,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ init,
                     const float* __restrict__ dfinal,
                     double* __restrict__ cum_out, bf16* __restrict__ sp16,
                     bf16* __restrict__ ds16, float* __restrict__ dss, int L,
                     int H, int chunk, int P, int Ns) {
  constexpr uint32_t kItemBytes = kTile * N * 2 + kTile * kP * 2;
  extern __shared__ uint8_t smem_raw[];
  StateSmem<N>& sm = *reinterpret_cast<StateSmem<N>*>(align_1024(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = A[h];
  const int nc = (L + chunk - 1) / chunk;
  const int tpc = chunk / kTile;
  const int Lp = nc * chunk;
  const int nt_last = (L - (nc - 1) * chunk + kTile - 1) / kTile;
  const int F = (nc - 1) * tpc + nt_last;  // tiles of one pass
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t st_off = bh * P * Ns;   // init and dfinal [P, Ns]
  const float* dtb = dt + static_cast<size_t>(b) * L * H + h;

  if (tid == 0) {
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // item n < F: tile n % tpc of chunk n / tpc (B_s, x_s); item F + m: the
  // reverse pass's m-th tile, chunks from the last (C_t, dy_t)
  auto issue = [&](int n) {
    if (tid != 0 || n >= 2 * F) return;
    const bool rev = n >= F;
    int row;
    if (!rev) {
      row = (n / tpc) * chunk + (n % tpc) * kTile;
    } else {
      const int m = n - F;
      if (m < nt_last) {
        row = (nc - 1) * chunk + m * kTile;
      } else {
        const int m2 = m - nt_last;
        row = (nc - 2 - m2 / tpc) * chunk + (m2 % tpc) * kTile;
      }
    }
    const int slot = n & 1;
    mbar_expect_tx(&sm.full[slot], kItemBytes);
#pragma unroll
    for (int cb = 0; cb < N / 64; ++cb)
      tma_load_3d(sm.rows[slot] + cb * 64 * 64, rev ? &map_c : &map_b,
                  &sm.full[slot], cb * 64, row, b);
    tma_load_4d(sm.hd[slot], rev ? &map_dy : &map_x, &sm.full[slot], 0, h,
                row, b);
  };
  issue(0);
  issue(1);
  int n = 0;

  // ---- chunks in order: S_prev, from the initial state ---------------- //
  float st[N / 2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 v = make_float2(0.f, 0.f);
      if (init && r0 + 8 * r < P && 8 * i < Ns)
        v = *reinterpret_cast<const float2*>(init + st_off +
                                             (r0 + 8 * r) * Ns + 8 * i + c0);
      st[4 * i + 2 * r] = v.x;
      st[4 * i + 2 * r + 1] = v.y;
    }
  }
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * chunk;
    const int lc = min(chunk, L - t0);
    const int nt = (lc + kTile - 1) / kTile;
    chunk_scan(dtb + static_cast<size_t>(t0) * H, H, lc, a, sm.cum, sm.dts,
               sm.wsum);
    for (int i = tid; i < chunk; i += kThreads)
      cum_out[bh * Lp + t0 + i] = sm.cum[i];
    const double cl = sm.cum[nt * kTile - 1];
    for (int i = tid; i < nt * kTile; i += kThreads)
      sm.scale[i] = expf(static_cast<float>(cl - sm.cum[i])) * sm.dts[i];
    store_split<N>(sp16 + (bh * nc + c) * 2 * kP * N, st, r0, c0);
    const float dl = expf(static_cast<float>(cl));
#pragma unroll
    for (int j = 0; j < N / 2; ++j) st[j] *= dl;
    __syncthreads();  // scale
    for (int k = 0; k < nt; ++k, ++n) {
      const int slot = n & 1;
      mbar_wait(&sm.full[slot], (n >> 1) & 1);
      state_product<N>(st, sm.hd[slot], sm.rows[slot], sm.scale + k * kTile);
      __syncthreads();  // every warp is done with the slot
      issue(n + 2);
    }
  }

  // ---- chunks in reverse: dS, from d_final_state ---------------------- //
  // st now holds dS
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 v = make_float2(0.f, 0.f);
      if (dfinal && r0 + 8 * r < P && 8 * i < Ns)
        v = *reinterpret_cast<const float2*>(dfinal + st_off +
                                             (r0 + 8 * r) * Ns + 8 * i + c0);
      st[4 * i + 2 * r] = v.x;
      st[4 * i + 2 * r + 1] = v.y;
    }
  }
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int lc = min(chunk, L - t0);
    const int nt = (lc + kTile - 1) / kTile;
    chunk_scan(dtb + static_cast<size_t>(t0) * H, H, lc, a, sm.cum, sm.dts,
               sm.wsum);
    const double cl = sm.cum[nt * kTile - 1];
    for (int i = tid; i < nt * kTile; i += kThreads)
      sm.scale[i] = expf(static_cast<float>(sm.cum[i]));
    const size_t o = (bh * nc + c) * 2 * kP * N;
    store_split<N>(ds16 + o, st, r0, c0);
    // <dS, S_prev>, S_prev as its hi + lo, read back from this thread's
    // own stores of the forward pass
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = swz(r0 + 8 * r, 8 * i + c0);
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sp16 + o + off));
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(sp16 + o + kP * N + off));
        part = fmaf(st[4 * i + 2 * r], hi.x + lo.x, part);
        part = fmaf(st[4 * i + 2 * r + 1], hi.y + lo.y, part);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) sm.red[warp] = part;
    const float dl = expf(static_cast<float>(cl));
#pragma unroll
    for (int j = 0; j < N / 2; ++j) st[j] *= dl;
    __syncthreads();  // scale, red
    if (tid == 0)
      dss[bh * nc + c] = (sm.red[0] + sm.red[1]) + (sm.red[2] + sm.red[3]);
    for (int k = 0; k < nt; ++k, ++n) {
      const int slot = n & 1;
      mbar_wait(&sm.full[slot], (n >> 1) & 1);
      state_product<N>(st, sm.hd[slot], sm.rows[slot], sm.scale + k * kTile);
      __syncthreads();
      issue(n + 2);
    }
  }
}

// ------------------------------------------------------------ dx and dB --

template <int N>
struct DxdbSmem {
  bf16 bs[kTile * N];      // B_s, the block's s tile
  bf16 ds[2 * kP * N];     // dS of the head, hi and lo tiles
  bf16 ct[2][kTile * N];   // ring: C_t
  bf16 dy[2][kTile * kP];  // ring: dy_t of the head
  bf16 xs[kTile * kP];     // x_s of the head
  double cum[kMaxChunk];   // the head's cum over the chunk
  float dts[kMaxChunk];
  uint64_t bs_full, ds_full, xs_full;
  uint64_t full[2];
};

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dxdb_kernel(__grid_constant__ const CUtensorMap map_x,
                    __grid_constant__ const CUtensorMap map_dy,
                    __grid_constant__ const CUtensorMap map_b,
                    __grid_constant__ const CUtensorMap map_c,
                    const float* __restrict__ dt,
                    const double* __restrict__ cum,
                    const bf16* __restrict__ ds16, bf16* __restrict__ dx,
                    float* __restrict__ ddi, float* __restrict__ dds,
                    float* __restrict__ db_part, int B, int L, int H,
                    int chunk, int group, int P) {
  constexpr uint32_t kRowsBytes = kTile * N * 2;
  constexpr uint32_t kHeadBytes = kTile * kP * 2;
  constexpr uint32_t kStateBytes = 2 * kP * N * 2;
  extern __shared__ uint8_t smem_raw[];
  DxdbSmem<N>& sm = *reinterpret_cast<DxdbSmem<N>*>(align_1024(smem_raw));

  const int nc = (L + chunk - 1) / chunk;
  const int ng = (H + group - 1) / group;
  const Item it = block_item(B, nc, ng);
  const int t0c = it.c * chunk;
  const int nt = (min(chunk, L - t0c) + kTile - 1) / kTile;
  if (it.j >= nt) return;
  const int b = it.b;
  const int j = it.j;
  const int s0 = t0c + j * kTile;
  const int h0 = it.g * group;
  const int hn = min(H, h0 + group) - h0;
  const int ntj = nt - j;            // t tiles per head
  const int items = hn * ntj;
  const int Lp = nc * chunk;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);

  if (tid == 0) {
    mbar_init(&sm.bs_full, 1);
    mbar_init(&sm.ds_full, 1);
    mbar_init(&sm.xs_full, 1);
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto load_xs = [&](int h) {
    mbar_expect_tx(&sm.xs_full, kHeadBytes);
    tma_load_4d(sm.xs, &map_x, &sm.xs_full, 0, h, s0, b);
  };
  auto load_ds = [&](int h) {
    mbar_expect_tx(&sm.ds_full, kStateBytes);
    bulk_load(sm.ds,
              ds16 + ((static_cast<size_t>(b) * H + h) * nc + it.c) * 2 * kP * N,
              kStateBytes, &sm.ds_full);
  };
  // item n: head h0 + n / ntj, t tile j + n % ntj
  auto issue = [&](int n) {
    if (tid != 0 || n >= items) return;
    const int slot = n & 1;
    const int row = t0c + (j + n % ntj) * kTile;
    mbar_expect_tx(&sm.full[slot], kRowsBytes + kHeadBytes);
#pragma unroll
    for (int cb = 0; cb < N / 64; ++cb)
      tma_load_3d(sm.ct[slot] + cb * 64 * 64, &map_c, &sm.full[slot], cb * 64,
                  row, b);
    tma_load_4d(sm.dy[slot], &map_dy, &sm.full[slot], 0, h0 + n / ntj, row, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&sm.bs_full, kRowsBytes);
#pragma unroll
    for (int cb = 0; cb < N / 64; ++cb)
      tma_load_3d(sm.bs + cb * 64 * 64, &map_b, &sm.bs_full, cb * 64, s0, b);
    load_xs(h0);
    load_ds(h0);
  }
  issue(0);
  issue(1);

  float db[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) db[i] = 0.f;
  mbar_wait(&sm.bs_full, 0);

  int n = 0;
  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const size_t bh = static_cast<size_t>(b) * H + h;
    // the head's cum and dt over the chunk (the previous head's last step
    // ended on a barrier)
    for (int i = tid; i < nt * kTile; i += kThreads) {
      sm.cum[i] = cum[bh * Lp + t0c + i];
      sm.dts[i] = t0c + i < L
                      ? dt[(static_cast<size_t>(b) * L + t0c + i) * H + h]
                      : 0.f;
    }
    __syncthreads();
    const double cl = sm.cum[nt * kTile - 1];
    double cs[2];
    float e[2], w[2], dtr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sl = j * kTile + r0 + 8 * r;
      cs[r] = sm.cum[sl];
      dtr[r] = sm.dts[sl];
      e[r] = expf(static_cast<float>(cl - cs[r]));
      w[r] = e[r] * dtr[r];
    }

    // ---- state terms: V = B_s . dS^T starts dx_s; x_s . dS adds to dB_s
    mbar_wait(&sm.ds_full, hh & 1);
    mbar_wait(&sm.xs_full, hh & 1);
    float dxa[32];
    {
      float tmp[N / 2];
      fence_regs(dxa);
      fence_regs(tmp);
      wgmma_fence();
      issue_nt<N>(dxa, sm.bs, sm.ds, false);
      issue_nt<N>(dxa, sm.bs, sm.ds + kP * N, true);
      issue_kn(tmp, sm.xs, sm.ds, false);
      issue_kn(tmp, sm.xs, sm.ds + kP * N, true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(tmp);
      __syncthreads();  // every warp is done with dS: the next head's
      if (tid == 0 && hh + 1 < hn) load_ds(h + 1);
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) db[4 * i + q] += w[q >> 1] * tmp[4 * i + q];
      }
    }
    float dsv[2] = {0.f, 0.f};  // x_s . V_s
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 xv = tile_pair(sm.xs, r0 + 8 * r, 8 * i + c0);
        dsv[r] = fmaf(xv.x, dxa[4 * i + 2 * r], dsv[r]);
        dsv[r] = fmaf(xv.y, dxa[4 * i + 2 * r + 1], dsv[r]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[4 * i + q] *= w[q >> 1];
    }

    // ---- the pairs t >= s of the chunk ---------------------------------- //
    float ddv[2] = {0.f, 0.f};  // sum_t G L M
    for (int ii = 0; ii < ntj; ++ii, ++n) {
      const int slot = n & 1;
      const int tt = (j + ii) * kTile;  // the t tile's first chunk row
      mbar_wait(&sm.full[slot], (n >> 1) & 1);
      float g[32], m[32];
      fence_regs(g);
      fence_regs(m);
      wgmma_fence();
      issue_nt<N>(g, sm.bs, sm.ct[slot], false);    // G^T [s, t]
      issue_nt<kP>(m, sm.xs, sm.dy[slot], false);   // M^T [s, t]
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(g);
      fence_regs(m);
      const bool diag = ii == 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q >> 1;
          const int tl = tt + 8 * i + c0 + (q & 1);
          const bool ok = !diag || tl >= j * kTile + r0 + 8 * r;
          const float lv =
              ok ? expf(static_cast<float>(sm.cum[tl] - cs[r])) : 0.f;
          const float gl = g[4 * i + q] * lv;
          ddv[r] = fmaf(gl, m[4 * i + q], ddv[r]);
          g[4 * i + q] = gl * dtr[r];
          m[4 * i + q] = m[4 * i + q] * lv * dtr[r];
        }
      }
      // both operands split before either product is issued: no register
      // is written while a wgmma that reads registers is in flight
      uint32_t gh[4][4], gl_[4][4], mh[4][4], ml[4][4];
      split_a(gh, gl_, g);
      split_a(mh, ml, m);
      fence_regs(dxa);
      fence_regs(db);
      wgmma_fence();
      issue_rs(dxa, gh, sm.dy[slot]);
      issue_rs(dxa, gl_, sm.dy[slot]);
      issue_rs(db, mh, sm.ct[slot]);
      issue_rs(db, ml, sm.ct[slot]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      fence_regs(db);
      __syncthreads();  // every warp is done with the slot (and, after the
      issue(n + 2);     // head's last step, with x_s)
    }
    if (tid == 0 && hh + 1 < hn) load_xs(h + 1);

    // ---- the head's rows: ddt's two parts and dx ------------------------ //
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float dd = quad_sum(ddv[r]);
      const float sv = quad_sum(dsv[r]);
      const int s = s0 + r0 + 8 * r;
      if (s < L) {
        if (lane % 4 == 0) {
          ddi[bh * Lp + s] = dd;
          dds[bh * Lp + s] = e[r] * sv;
        }
        bf16* o = dx + ((static_cast<size_t>(b) * L + s) * H + h) * P;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (8 * i < P)
            *reinterpret_cast<uint32_t*>(o + 8 * i + c0) =
                pack_bf16x2(dxa[4 * i + 2 * r], dxa[4 * i + 2 * r + 1]);
      }
    }
  }

  // the group's dB_s
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = s0 + r0 + 8 * r;
    if (s >= L) continue;
    float* o = db_part + ((static_cast<size_t>(b) * ng + it.g) * L + s) * N;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      *reinterpret_cast<float2*>(o + 8 * i + c0) =
          make_float2(db[4 * i + 2 * r], db[4 * i + 2 * r + 1]);
  }
}

// ------------------------------------------------------------------ dC --

template <int N>
struct DcSmem {
  bf16 ct[kTile * N];      // C_t, the block's t tile
  bf16 sp[2 * kP * N];     // S_prev of the head, hi and lo tiles
  bf16 bs[2][kTile * N];   // ring: B_s
  bf16 xs[2][kTile * kP];  // ring: x_s of the head
  bf16 dy[kTile * kP];     // dy_t of the head
  double cum[kMaxChunk];
  float dts[kMaxChunk];
  uint64_t ct_full, sp_full, dy_full;
  uint64_t full[2];
};

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dc_kernel(__grid_constant__ const CUtensorMap map_x,
                  __grid_constant__ const CUtensorMap map_dy,
                  __grid_constant__ const CUtensorMap map_b,
                  __grid_constant__ const CUtensorMap map_c,
                  const float* __restrict__ dt, const double* __restrict__ cum,
                  const bf16* __restrict__ sp16, float* __restrict__ rowe,
                  float* __restrict__ dc_part, int B, int L, int H, int chunk,
                  int group) {
  constexpr uint32_t kRowsBytes = kTile * N * 2;
  constexpr uint32_t kHeadBytes = kTile * kP * 2;
  constexpr uint32_t kStateBytes = 2 * kP * N * 2;
  extern __shared__ uint8_t smem_raw[];
  DcSmem<N>& sm = *reinterpret_cast<DcSmem<N>*>(align_1024(smem_raw));

  const int nc = (L + chunk - 1) / chunk;
  const int ng = (H + group - 1) / group;
  const int tpc = chunk / kTile;
  const Item it = block_item(B, nc, ng);
  const int i = tpc - 1 - it.j;      // the t tile: the last ones first
  const int t0c = it.c * chunk;
  const int nt = (min(chunk, L - t0c) + kTile - 1) / kTile;
  if (i >= nt) return;
  const int b = it.b;
  const int t0 = t0c + i * kTile;
  const int h0 = it.g * group;
  const int hn = min(H, h0 + group) - h0;
  const int nsi = i + 1;             // s tiles per head
  const int items = hn * nsi;
  const int Lp = nc * chunk;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);

  if (tid == 0) {
    mbar_init(&sm.ct_full, 1);
    mbar_init(&sm.sp_full, 1);
    mbar_init(&sm.dy_full, 1);
    mbar_init(&sm.full[0], 1);
    mbar_init(&sm.full[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto load_dy = [&](int h) {
    mbar_expect_tx(&sm.dy_full, kHeadBytes);
    tma_load_4d(sm.dy, &map_dy, &sm.dy_full, 0, h, t0, b);
  };
  auto load_sp = [&](int h) {
    mbar_expect_tx(&sm.sp_full, kStateBytes);
    bulk_load(sm.sp,
              sp16 + ((static_cast<size_t>(b) * H + h) * nc + it.c) * 2 * kP * N,
              kStateBytes, &sm.sp_full);
  };
  // item n: head h0 + n / nsi, s tile n % nsi
  auto issue = [&](int n) {
    if (tid != 0 || n >= items) return;
    const int slot = n & 1;
    const int row = t0c + (n % nsi) * kTile;
    mbar_expect_tx(&sm.full[slot], kRowsBytes + kHeadBytes);
#pragma unroll
    for (int cb = 0; cb < N / 64; ++cb)
      tma_load_3d(sm.bs[slot] + cb * 64 * 64, &map_b, &sm.full[slot], cb * 64,
                  row, b);
    tma_load_4d(sm.xs[slot], &map_x, &sm.full[slot], 0, h0 + n / nsi, row, b);
  };
  if (tid == 0) {
    mbar_expect_tx(&sm.ct_full, kRowsBytes);
#pragma unroll
    for (int cb = 0; cb < N / 64; ++cb)
      tma_load_3d(sm.ct + cb * 64 * 64, &map_c, &sm.ct_full, cb * 64, t0, b);
    load_dy(h0);
    load_sp(h0);
  }
  issue(0);
  issue(1);

  float dc[N / 2];
#pragma unroll
  for (int q = 0; q < N / 2; ++q) dc[q] = 0.f;
  mbar_wait(&sm.ct_full, 0);

  int n = 0;
  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const size_t bh = static_cast<size_t>(b) * H + h;
    for (int q = tid; q < nsi * kTile; q += kThreads) {
      sm.cum[q] = cum[bh * Lp + t0c + q];
      sm.dts[q] = t0c + q < L
                      ? dt[(static_cast<size_t>(b) * L + t0c + q) * H + h]
                      : 0.f;
    }
    __syncthreads();
    double ctr[2];
    float ec[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ctr[r] = sm.cum[i * kTile + r0 + 8 * r];
      ec[r] = expf(static_cast<float>(ctr[r]));
    }

    // ---- state term: dC_t += exp(cum_t) (dy_t . S_prev), E_t ----------- //
    mbar_wait(&sm.sp_full, hh & 1);
    mbar_wait(&sm.dy_full, hh & 1);
    float ev[2] = {0.f, 0.f};
    {
      float tmp[N / 2];
      fence_regs(tmp);
      wgmma_fence();
      issue_kn(tmp, sm.dy, sm.sp, false);
      issue_kn(tmp, sm.dy, sm.sp + kP * N, true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(tmp);
      __syncthreads();  // every warp is done with S_prev: the next head's
      if (tid == 0 && hh + 1 < hn) load_sp(h + 1);
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 cv = tile_pair(sm.ct, r0 + 8 * r, 8 * q + c0);
          ev[r] = fmaf(cv.x, tmp[4 * q + 2 * r], ev[r]);
          ev[r] = fmaf(cv.y, tmp[4 * q + 2 * r + 1], ev[r]);
          dc[4 * q + 2 * r] += ec[r] * tmp[4 * q + 2 * r];
          dc[4 * q + 2 * r + 1] += ec[r] * tmp[4 * q + 2 * r + 1];
        }
      }
    }

    // ---- the pairs s <= t of the chunk ---------------------------------- //
    float rowv[2] = {0.f, 0.f};  // sum_s G L M dt_s
    for (int jj = 0; jj < nsi; ++jj, ++n) {
      const int slot = n & 1;
      mbar_wait(&sm.full[slot], (n >> 1) & 1);
      float g[32], m[32];
      fence_regs(g);
      fence_regs(m);
      wgmma_fence();
      issue_nt<N>(g, sm.ct, sm.bs[slot], false);   // G [t, s]
      issue_nt<kP>(m, sm.dy, sm.xs[slot], false);  // M [t, s]
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(g);
      fence_regs(m);
      const bool diag = jj == i;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q >> 1;
          const int sl = jj * kTile + 8 * k + c0 + (q & 1);
          const bool ok = !diag || sl <= i * kTile + r0 + 8 * r;
          const float lv =
              ok ? expf(static_cast<float>(ctr[r] - sm.cum[sl])) : 0.f;
          const float d = sm.dts[sl];
          const float ml = m[4 * k + q] * lv;
          rowv[r] = fmaf(g[4 * k + q] * lv * m[4 * k + q], d, rowv[r]);
          m[4 * k + q] = ml * d;
        }
      }
      uint32_t mh[4][4], mlo[4][4];
      split_a(mh, mlo, m);
      fence_regs(dc);
      wgmma_fence();
      issue_rs(dc, mh, sm.bs[slot]);
      issue_rs(dc, mlo, sm.bs[slot]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dc);
      __syncthreads();  // every warp is done with the slot (and, after the
      issue(n + 2);     // head's last step, with dy_t)
    }
    if (tid == 0 && hh + 1 < hn) load_dy(h + 1);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float rv = quad_sum(rowv[r]);
      const float evs = quad_sum(ev[r]);
      const int t = t0 + r0 + 8 * r;
      if (t < L && lane % 4 == 0) rowe[bh * Lp + t] = rv + ec[r] * evs;
    }
  }

  // the group's dC_t
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + r0 + 8 * r;
    if (t >= L) continue;
    float* o = dc_part + ((static_cast<size_t>(b) * ng + it.g) * L + t) * N;
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
      *reinterpret_cast<float2*>(o + 8 * q + c0) =
          make_float2(dc[4 * q + 2 * r], dc[4 * q + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------- host --

// Bm / Cm [B,L,N] bf16 as a 3-D tensor map (N, L, B), box (64, 64, 1); the
// box columns past N load as zeros
int make_rows_map(CUtensorMap* map, const void* p, int B, int L, int N) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 2;
  const cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(L)};
  const cuuint32_t box[3] = {64, kTile, 1};
  return make_map_bf16(map, p, 3, dims, strides, box);
}

// x / dy [B,L,H,P] bf16 as a 4-D tensor map (P, H, L, B), box (64, 1, 64,
// 1); the box columns past P load as zeros
int make_head_map(CUtensorMap* map, const void* p, int B, int L, int H,
                  int P) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(P) * 2;
  const cuuint64_t strides[3] = {row, row * H,
                                 row * H * static_cast<cuuint64_t>(L)};
  const cuuint32_t box[4] = {64, 1, kTile, 1};
  return make_map_bf16(map, p, 4, dims, strides, box);
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int N>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, const void* dy,
             const void* dfinal, void* dx, void* ddt, void* dA, void* dBm,
             void* dCm, void* cum, void* sp16, void* ds16, void* dss,
             void* rowe, void* ddi, void* dds, void* db_part, void* dc_part,
             void* da_part, int B, int L, int H, int P, int Ns, int chunk,
             int group, cudaStream_t stream) {
  CUtensorMap mx{}, mdy{}, mb{}, mc{};
  if (int e = make_head_map(&mx, x, B, L, H, P)) return e;
  if (int e = make_head_map(&mdy, dy, B, L, H, P)) return e;
  if (int e = make_rows_map(&mb, Bm, B, L, Ns)) return e;
  if (int e = make_rows_map(&mc, Cm, B, L, Ns)) return e;
  const int nc = (L + chunk - 1) / chunk;
  const int ng = (H + group - 1) / group;
  const int tiles = (chunk / kTile) * nc * B * ng;
  const float* dtf = static_cast<const float*>(dt);
  const double* cumd = static_cast<double*>(cum);

  const size_t smem_state = sizeof(StateSmem<N>) + 1024;
  if (int e = set_smem(ssd_bwd_state_kernel<N>, smem_state)) return e;
  ssd_bwd_state_kernel<N><<<B * H, kThreads, smem_state, stream>>>(
      mx, mdy, mb, mc, dtf, static_cast<const float*>(A),
      static_cast<const float*>(init), static_cast<const float*>(dfinal),
      static_cast<double*>(cum), static_cast<bf16*>(sp16),
      static_cast<bf16*>(ds16), static_cast<float*>(dss), L, H, chunk, P, Ns);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  const size_t smem_dxdb = sizeof(DxdbSmem<N>) + 1024;
  if (int e = set_smem(ssd_bwd_dxdb_kernel<N>, smem_dxdb)) return e;
  ssd_bwd_dxdb_kernel<N><<<tiles, kThreads, smem_dxdb, stream>>>(
      mx, mdy, mb, mc, dtf, cumd, static_cast<const bf16*>(ds16),
      static_cast<bf16*>(dx), static_cast<float*>(ddi),
      static_cast<float*>(dds), static_cast<float*>(db_part), B, L, H, chunk,
      group, P);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  const size_t smem_dc = sizeof(DcSmem<N>) + 1024;
  if (int e = set_smem(ssd_bwd_dc_kernel<N>, smem_dc)) return e;
  ssd_bwd_dc_kernel<N><<<tiles, kThreads, smem_dc, stream>>>(
      mx, mdy, mb, mc, dtf, cumd, static_cast<const bf16*>(sp16),
      static_cast<float*>(rowe), static_cast<float*>(dc_part), B, L, H, chunk,
      group);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  return launch_finish_and_sum(
      dtf, static_cast<const float*>(A), cumd, static_cast<const float*>(dss),
      static_cast<const float*>(rowe), static_cast<const float*>(ddi),
      static_cast<const float*>(dds), static_cast<float*>(ddt),
      static_cast<float*>(da_part), static_cast<const float*>(db_part),
      static_cast<const float*>(dc_part), static_cast<bf16*>(dBm),
      static_cast<bf16*>(dCm), static_cast<float*>(dA), B, L, H, Ns, N, chunk,
      ng, stream);
}

}  // namespace

// x, dy, dx: [B,L,H,P]; Bm, Cm, dBm, dCm: [B,L,N], bf16; dt, ddt: [B,L,H],
// A, dA: [H], init and dfinal (either may be null: zero) [B,H,P,N],
// float32.  Scratch (nc = ceil(L / chunk), Lp = nc * chunk, ng =
// ceil(H / group), NP = N padded to 64 or 128): cum [B,H,Lp] float64;
// sp16, ds16 [B,H,nc,2,64,NP] bf16; dss [B,H,nc], rowe, ddi, dds [B,H,Lp],
// db_part, dc_part [B,ng,L,NP], da_part [B,H], float32.  Every tensor
// contiguous and 16-byte aligned.  Launches the state, dx/dB, dC, finish
// and sum kernels in that order on `stream`.  Returns 0 or the first cudaError_t (a launch's, or the tensor
// maps').
extern "C" int ssd_scan_bwd_wgmma_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, const void* dy, const void* dfinal,
    void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* cum,
    void* sp16, void* ds16, void* dss, void* rowe, void* ddi, void* dds,
    void* db_part, void* dc_part, void* da_part, int B, int L, int H, int P,
    int N, int chunk, int group, void* stream) {
  if (!flare::ssd_head_dim(P) || !flare::ssd_state_dim(N) ||
      chunk % kTile != 0 || chunk < kTile || chunk > kMaxChunk || L < 0 ||
      B < 0 || H < 0 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || L == 0)
    return static_cast<int>(
        cudaMemsetAsync(dA, 0, static_cast<size_t>(H) * sizeof(float), s));
  if (N > 64)
    return launch_n<128>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm,
                         dCm, cum, sp16, ds16, dss, rowe, ddi, dds, db_part,
                         dc_part, da_part, B, L, H, P, N, chunk, group, s);
  return launch_n<64>(x, dt, A, Bm, Cm, init, dy, dfinal, dx, ddt, dA, dBm,
                      dCm, cum, sp16, ds16, dss, rowe, ddi, dds, db_part,
                      dc_part, da_part, B, L, H, P, N, chunk, group, s);
}
