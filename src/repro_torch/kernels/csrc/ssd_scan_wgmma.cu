// Mamba2 chunked SSD scan forward in bf16 on the Hopper tensor cores
// (sm_90a): the bf16 route of the port's SSD scan.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_fwd, body _ssd_kernel), and with it, on the prefill path, the
// model's ssd_chunked (src/repro/models/mamba2.py), for bf16 inputs.  For
// one (batch b, head h), with chunks of Q rows and the within-chunk
// inclusive cumulative decay cum_t = sum_{r <= t} dt_r * A:
//   y_t  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s   (intra)
//        + exp(cum_t) C_t . S                                     (inter)
//   S   <- exp(cum_last) S + sum_s x_s (exp(cum_last - cum_s) dt_s) B_s
// x [B,L,H,P], Bm/Cm [B,L,N] bf16; dt [B,L,H], A [H] fp32; y [B,L,H,P]
// bf16; the state S is [P,N] fp32 per (b, h), seeded from an optional
// initial_state and returned as final_state [B,H,P,N] fp32.  Any L: rows
// past L load as zeros and dt = 0 there.  (fp32 inputs take
// ssd_scan_tf32.cu, split TF32 on the tensor cores.)
//
// Bound on an H100: bytes.  At the serving shape (B 8, L 1024, H 48, P 64,
// N 128, chunk 256) the traffic is ~119 MB (x, y, Bm, Cm, dt, state),
// 0.0355 ms at 3.35 TB/s; the work is 1.96e10 flops (C.B^T once per (b,
// chunk) over the causal pairs; per head the causal scores times x, C.S
// and the state update), 0.0198 ms at 989 TFLOP/s.
//
// What the design does about what held the FP32-pipe kernel back:
//   * tensor cores: all four products are bf16 wgmma with fp32
//     accumulators, one warpgroup per (b, h):
//       G = C_t . B_s^T       m64n64k16, both operands K-major in shared
//                             memory, causal tiles only (s <= t);
//       y += scores . x_s     m64n64k16, the scores G o exp(cum_t - cum_s)
//                             o dt_s, masked to s <= t and rounded to bf16,
//                             as the register A operand (G's accumulator
//                             fragment is the A fragment, as P in flash);
//                             x_s [s, p] is MN-major (the transpose-B bit);
//       y  = C_t . S16^T      m64n64k16, S16 a bf16 copy of the chunk-start
//                             state that the threads write into shared
//                             memory in the 128-byte swizzle; y is scaled by
//                             exp(cum_t) before the intra terms add in;
//       S += (w o x)^T . B_s  m64n{N}k16, w_s = exp(cum_last - cum_s) dt_s,
//                             (w o x)^T built in registers by a transposed
//                             ldmatrix of the x tile, scaled and rounded to
//                             bf16; B_s [s, n] MN-major.  The fp32 state
//                             lives in this product's accumulator registers
//                             (rows p of the warp, all N columns) for the
//                             whole chunk walk; it never leaves the block
//                             until the final state is written;
//   * the decay stays exact: cum is an inclusive scan of dt*A summed in
//     fp64, and every exp takes an fp64 difference rounded to fp32 (fp32
//     sums failed the check at the model's dt, where cum reaches ~-700);
//     the decay and the causal mask are applied to G's fragments in
//     registers, where each thread knows its (t, s).  Off the warp's
//     16-row diagonal block the decay is a product of two factors, each
//     at most 1: exp(cum_t - cum_ref) per row and exp(cum_ref - cum_s)
//     dt_s per column, with ref the warp's first row; so a score costs two
//     multiplies, and an exp (with its fp64 difference and conversion)
//     only on that diagonal block;
//   * occupancy: shared memory holds bf16 tiles only (C_t, B_s, x_s and
//     S16: 56 KB at N 128, 66 KB with the per-chunk decay arrays), and one
//     warpgroup of at most 168 registers a thread, so three blocks run on
//     each SM: the 384 (b, h) blocks of the serving shape fit in one wave
//     of 396 slots; a block that waits on a load leaves the SM to the
//     other two;
//   * fewer loads: tiles come by TMA (3-D maps over [B,L,N], 4-D over
//     [B,L,H,P], rows >= L zero-filled), C_t once per t tile.  The state
//     update rides on the last t tile's walk over every s tile, and each t
//     tile walks its s tiles starting with the one still resident from
//     the previous t tile: 7 s-tile loads per 4-tile chunk where the
//     FP32-pipe kernel made 14.  One buffer each: the next s tile loads
//     once the current one's products are done, while the SM's other two
//     blocks compute, and the next C_t under the scores and products of
//     its t tile's last step;
//   * synchronisation: one warpgroup, so a block barrier is four warps;
//     products are waited by wgmma.wait_group, loads by mbarriers.
// Left for later: C.B^T is recomputed per head (~1.3e10 tensor-core flops
// at the serving shape, ~13 us at peak); sharing it across the heads of a
// batch row needs a block per (b, chunk) and the state passed between
// them.
// The tiles are 64 columns of x (kP) and N = 64 or 128 columns of Bm / Cm
// (the two instances); head_dim P in {8, 16, 32, 64} and state Ns in {8,
// 16, 32, 64, 128} are taken at run time: the tensor maps have the true
// widths, so the box columns past them load as zeros, which add exact zeros
// to every product (the state's rows past P and columns past Ns stay zero),
// and the initial state, y and the final state are read and written at
// their true widths.  At P 16 and Ns 16 (the JAX package's reduced mamba2
// and zamba2) the tensor cores do 4x the products over p and n that the
// function needs.  chunk is a multiple of 64 up to 256.  The wrapper
// refuses others.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTile = 64;      // rows of a t or s tile (wgmma's M)
constexpr int kP = 64;         // the columns of an x tile: head_dim padded
constexpr int kMaxChunk = 256;

// Operand tiles are N / 64 (or 1) column blocks of [64 rows][64] bf16 in
// the 128-byte swizzle, each 8 KB, 1024-byte aligned.
template <int N>
struct Smem {
  __nv_bfloat16 c[kTile * N];     // C_t    [t][n]
  __nv_bfloat16 bm[kTile * N];    // B_s    [s][n]
  __nv_bfloat16 s16[kP * N];      // S16    [p][n], the chunk-start state
  __nv_bfloat16 x[kTile * kP];    // x_s    [s][p]
  double cum[kMaxChunk];          // the chunk's cumulative decay (fp64)
  float ecum[kMaxChunk];          // exp(cum_t)
  float w[kMaxChunk];             // exp(cum_last - cum_s) dt_s
  float dts[kMaxChunk];           // dt_s
  float es[kThreads / 32][kMaxChunk];  // per warp: exp(cum_ref - cum_s) dt_s
  double wsum[kThreads / 32];
  uint64_t c_full;
  uint64_t s_full;
};

// the s tile that step k of t tile ti walks: the one left resident by the
// previous t tile first (ti - 1), then 0 .. ti - 2, then the diagonal
__device__ __forceinline__ int s_tile_of(int ti, int k) {
  if (ti == 0) return 0;
  if (k == 0) return ti - 1;
  return k < ti ? k - 1 : ti;
}

// state update: S[64,N] += A[64,16] (registers) * B_s[16,N] (MN-major)
__device__ __forceinline__ void state_wgmma(float (&s)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_m64n64k16_rs<1>(s, a, db, 1);
}
__device__ __forceinline__ void state_wgmma(float (&s)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  wgmma_m64n128k16_rs<1>(s, a, db, 1);
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo,
                                                 float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16x2(f.x * lo, f.y * hi);
}

template <int N>
__global__ void __launch_bounds__(kThreads, 3)
ssd_wgmma_kernel(__grid_constant__ const CUtensorMap map_x,
                 __grid_constant__ const CUtensorMap map_b,
                 __grid_constant__ const CUtensorMap map_c,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ init,
                 __nv_bfloat16* __restrict__ y,
                 float* __restrict__ final_state, int L, int H, int chunk,
                 int P, int Ns) {
  constexpr int kCols = N / 64;                 // column blocks of C, B, S16
  constexpr uint32_t kCBytes = kTile * N * 2;
  constexpr uint32_t kSBytes = kTile * N * 2 + kTile * kP * 2;
  extern __shared__ uint8_t smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(align_1024(smem_raw));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = A[h];
  // this thread's accumulator rows in a 64-row tile, r0 and r0 + 8, and
  // columns 8i + c0 + {0, 1}
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);

  if (tid == 0) {
    mbar_init(&sm.c_full, 1);
    mbar_init(&sm.s_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const CUtensorMap* mx = &map_x;
  const CUtensorMap* mb = &map_b;
  const CUtensorMap* mc = &map_c;
  auto load_c = [&](int row) {
    if (tid == 0) {
      mbar_expect_tx(&sm.c_full, kCBytes);
#pragma unroll
      for (int cb = 0; cb < kCols; ++cb)
        tma_load_3d(sm.c + cb * kTile * 64, mc, &sm.c_full, cb * 64, row, b);
    }
  };
  auto load_s = [&](int row) {
    if (tid == 0) {
      mbar_expect_tx(&sm.s_full, kSBytes);
#pragma unroll
      for (int cb = 0; cb < kCols; ++cb)
        tma_load_3d(sm.bm + cb * kTile * 64, mb, &sm.s_full, cb * 64, row, b);
      tma_load_4d(sm.x, mx, &sm.s_full, 0, h, row, b);
    }
  };

  // the fp32 state [kP, N]: this thread's rows p = r0, r0 + 8, columns
  // n = 8i + c0 + {0, 1} (the accumulator fragment of the state update);
  // the initial state [P, Ns] fills rows p < P and columns n < Ns
  float st[N / 2];
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * Ns;
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

  float yacc[32];
  float g[32];
  uint32_t c_ph = 0;
  uint32_t s_ph = 0;
  int resident = 0;      // the first row of the s tile in (or bound for) sm.bm
  bool pending = L > 0;  // a load of it has been issued and not yet waited
  if (pending) {
    load_c(0);
    load_s(0);
  }

  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int lc = min(chunk, L - t0);
    const int nt = (lc + kTile - 1) / kTile;
    const bool last_chunk = t0 + chunk >= L;

    // ---- dt and the inclusive scan of dt*A over the chunk, in fp64 ---- //
    // each thread sums two neighbouring rows, then the warps' totals
    __syncthreads();  // the previous chunk is done with cum, w, S16
    const int i0 = 2 * tid;
    const size_t drow = (static_cast<size_t>(b) * L + t0 + i0) * H + h;
    const float d0 = i0 < lc ? dt[drow] : 0.f;
    const float d1 = i0 + 1 < lc ? dt[drow + H] : 0.f;
    const double v0 = static_cast<double>(d0 * a);
    const double v1 = static_cast<double>(d1 * a);
    double incl = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane == 31) sm.wsum[warp] = incl;
    __syncthreads();
    double base = incl - (v0 + v1);
    for (int j = 0; j < warp; ++j) base += sm.wsum[j];
    sm.cum[i0] = base + v0;
    sm.cum[i0 + 1] = base + v0 + v1;
    sm.dts[i0] = d0;
    sm.dts[i0 + 1] = d1;
    __syncthreads();
    // rows past L have dt = 0, so cum at the last row of the last tile is
    // the last real row's
    const double cl = sm.cum[nt * kTile - 1];
    for (int i = tid; i < nt * kTile; i += kThreads) {
      sm.ecum[i] = expf(static_cast<float>(sm.cum[i]));
      sm.w[i] = expf(static_cast<float>(cl - sm.cum[i])) * sm.dts[i];
    }

    // ---- S16: the chunk-start state in bf16, swizzled as TMA would ---- //
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = r0 + 8 * r;
        __nv_bfloat16* row = sm.s16 + (i / 8) * kP * 64 + p * 64;
        *reinterpret_cast<uint32_t*>(row + (((i % 8) ^ (p % 8)) * 8) + c0) =
            pack_bf16x2(st[4 * i + 2 * r], st[4 * i + 2 * r + 1]);
      }
    }
    fence_proxy_async();
    // then the fp32 state decays over the chunk, and the chunk's
    // contributions add into it during the last t tile
    const float dl = expf(static_cast<float>(cl));
#pragma unroll
    for (int j = 0; j < N / 2; ++j) st[j] *= dl;
    __syncthreads();

    for (int ti = 0; ti < nt; ++ti) {
      const int tl0 = ti * kTile + r0;  // chunk-local rows tl0, tl0 + 8
      const bool state_tile = ti == nt - 1;
      // the decay of a pair s <= t, factorised at the warp's first row
      // ref (cum_t <= cum_ref <= cum_s for s < ref <= t, so neither factor
      // exceeds 1):  exp(cum_t - cum_ref) * exp(cum_ref - cum_s), each from
      // an fp64 difference; the pairs ref <= s <= t, on the warp's 16-row
      // diagonal, take exp(cum_t - cum_s) directly
      const int ref = ti * kTile + 16 * warp;
      const double cref = sm.cum[ref];
      float* es = sm.es[warp];
      __syncwarp();
      for (int j = lane; j < ref; j += 32)
        es[j] = expf(static_cast<float>(cref - sm.cum[j])) * sm.dts[j];
      __syncwarp();
      const float et[2] = {expf(static_cast<float>(sm.cum[tl0] - cref)),
                           expf(static_cast<float>(sm.cum[tl0 + 8] - cref))};

      // inter-chunk term: y = C_t . S16^T, scaled by exp(cum_t) once done
      mbar_wait(&sm.c_full, c_ph);
      c_ph ^= 1;
      fence_regs(yacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int cb = kk / 4;
        const int off = (kk % 4) * 16;
        wgmma_m64n64k16_ss<0>(
            yacc, desc_sw128(sm.c + cb * kTile * 64 + off, 16, 1024),
            desc_sw128(sm.s16 + cb * kP * 64 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();

      for (int k = 0; k <= ti; ++k) {
        const int sj = s_tile_of(ti, k);
        if (pending) {
          mbar_wait(&sm.s_full, s_ph);
          s_ph ^= 1;
          pending = false;
        }
        // G = C_t . B_s^T over N
        fence_regs(g);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk) {
          const int cb = kk / 4;
          const int off = (kk % 4) * 16;
          wgmma_m64n64k16_ss<0>(
              g, desc_sw128(sm.c + cb * kTile * 64 + off, 16, 1024),
              desc_sw128(sm.bm + cb * kTile * 64 + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();  // G, and at k = 0 the inter-chunk term
        fence_regs(g);
        fence_regs(yacc);
        if (k == ti) {
          // the t tile's last read of C_t: load the next t tile's
          __syncthreads();
          if (ti + 1 < nt)
            load_c(t0 + (ti + 1) * kTile);
          else if (!last_chunk)
            load_c(t0 + chunk);
        }
        if (k == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            yacc[4 * i] *= sm.ecum[tl0];
            yacc[4 * i + 1] *= sm.ecum[tl0];
            yacc[4 * i + 2] *= sm.ecum[tl0 + 8];
            yacc[4 * i + 3] *= sm.ecum[tl0 + 8];
          }
        }
        // scores = G o exp(cum_t - cum_s) o dt_s for s <= t, in bf16: the
        // accumulator fragment of G is the A fragment of scores . x_s
        if (sj < ti) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              g[4 * i + e] = g[4 * i + e] * et[e >> 1] *
                             es[sj * kTile + 8 * i + c0 + (e & 1)];
          }
        } else {
          // the diagonal tile: the 16-column blocks left of the warp's rows
          // take the factorised decay, the warp's own 16 x 16 block the
          // direct one, masked to s <= t, and the blocks right of it are
          // zero; each branch is uniform across the warp
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (i / 2 < warp) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                g[4 * i + e] = g[4 * i + e] * et[e >> 1] *
                               es[sj * kTile + 8 * i + c0 + (e & 1)];
            } else if (i / 2 == warp) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int sl = sj * kTile + 8 * i + c0 + (e & 1);
                const int tl = tl0 + 8 * (e >> 1);
                g[4 * i + e] =
                    sl <= tl ? g[4 * i + e] *
                                   expf(static_cast<float>(sm.cum[tl] -
                                                           sm.cum[sl])) *
                                   sm.dts[sl]
                             : 0.f;
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) g[4 * i + e] = 0.f;
            }
          }
        }
        uint32_t sc[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          sc[kk][0] = pack_bf16x2(g[8 * kk], g[8 * kk + 1]);
          sc[kk][1] = pack_bf16x2(g[8 * kk + 2], g[8 * kk + 3]);
          sc[kk][2] = pack_bf16x2(g[8 * kk + 4], g[8 * kk + 5]);
          sc[kk][3] = pack_bf16x2(g[8 * kk + 6], g[8 * kk + 7]);
        }
        // y += scores . x_s
        fence_regs(yacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs<1>(
              yacc, sc[kk], desc_sw128(sm.x + kk * 16 * 64, kTile * 128, 1024),
              1);
        wgmma_commit();
        if (state_tile) {
          // on the last t tile, S += (w o x_s)^T . B_s once the scores are
          // consumed (so that they and w o x are not live together): rows
          // p of this warp, columns s, by a transposed ldmatrix of the
          // swizzled x tile [s][p], scaled by w and rounded to bf16
          wgmma_wait<0>();
          fence_regs(yacc);
          uint32_t wx[4][4];
          const int mj = lane / 8;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int s = kk * 16 + (mj / 2) * 8 + lane % 8;
            const int pc = 2 * warp + (mj % 2);
            ldmatrix_x4_trans(wx[kk], sm.x + s * 64 + ((pc ^ (s % 8)) * 8));
            const int sl = sj * kTile + kk * 16 + c0;
            const float w0 = sm.w[sl], w1 = sm.w[sl + 1];
            const float w8 = sm.w[sl + 8], w9 = sm.w[sl + 9];
            wx[kk][0] = scale_bf16x2(wx[kk][0], w0, w1);
            wx[kk][1] = scale_bf16x2(wx[kk][1], w0, w1);
            wx[kk][2] = scale_bf16x2(wx[kk][2], w8, w9);
            wx[kk][3] = scale_bf16x2(wx[kk][3], w8, w9);
          }
          fence_regs(st);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            state_wgmma(st, wx[kk],
                        desc_sw128(sm.bm + kk * 16 * 64, kTile * 128, 1024));
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs(yacc);
        fence_regs(st);

        // the next s tile into the freed buffer, unless it is this one
        int next = -1;
        if (k < ti)
          next = t0 + s_tile_of(ti, k + 1) * kTile;
        else if (ti + 1 < nt)
          next = t0 + s_tile_of(ti + 1, 0) * kTile;
        else if (!last_chunk)
          next = t0 + chunk;
        if (next >= 0 && next != resident) {
          __syncthreads();  // every warp is done with B_s and x_s
          load_s(next);
          resident = next;
          pending = true;
        }
      }

      // y rows < L, columns < P, in bf16
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + tl0 + 8 * r;
        if (t >= L) continue;
        __nv_bfloat16* yr =
            y + ((static_cast<size_t>(b) * L + t) * H + h) * P;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (8 * i < P)
            *reinterpret_cast<uint32_t*>(yr + 8 * i + c0) =
                pack_bf16x2(yacc[4 * i + 2 * r], yacc[4 * i + 2 * r + 1]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r0 + 8 * r < P && 8 * i < Ns)
        *reinterpret_cast<float2*>(final_state + st_off + (r0 + 8 * r) * Ns +
                                   8 * i + c0) =
            make_float2(st[4 * i + 2 * r], st[4 * i + 2 * r + 1]);
  }
}

// Bm / Cm [B,L,N] bf16 as a 3-D tensor map (N, L, B) with a box of
// (64, 64, 1); the box columns past N load as zeros
int make_rows_map(CUtensorMap* map, const void* p, int B, int L, int N) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(N) * 2;
  const cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(L)};
  const cuuint32_t box[3] = {64, kTile, 1};
  return make_map_bf16(map, p, 3, dims, strides, box);
}

// x [B,L,H,P] bf16 as a 4-D tensor map (P, H, L, B) with a box of
// (64, 1, 64, 1); the box columns past P load as zeros
int make_x_map(CUtensorMap* map, const void* p, int B, int L, int H, int P) {
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

template <int N>
int launch_n(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* init, void* y, void* final_state,
             int B, int L, int H, int P, int Ns, int chunk,
             cudaStream_t stream) {
  // at L = 0 the kernel only copies the initial state, and loads nothing
  CUtensorMap mx{}, mb{}, mc{};
  if (L > 0) {
    if (int e = make_x_map(&mx, x, B, L, H, P)) return e;
    if (int e = make_rows_map(&mb, Bm, B, L, Ns)) return e;
    if (int e = make_rows_map(&mc, Cm, B, L, Ns)) return e;
  }
  const size_t smem = sizeof(Smem<N>) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_wgmma_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_wgmma_kernel<N><<<B * H, kThreads, smem, stream>>>(
      mx, mb, mc, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(init), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(final_state), L, H, chunk, P, Ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [B,L,H,P] and Bm, Cm: [B,L,N] bf16; dt: [B,L,H], A: [H], init (may
// be null) and final_state: [B,H,P,N] float32.  All contiguous and 16-byte
// aligned.  Returns 0 or a cudaError_t (the launch's, or the tensor
// maps').
extern "C" int ssd_scan_wgmma_launch(const void* x, const void* dt,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* init, void* y,
                                     void* final_state, int B, int L, int H,
                                     int P, int N, int chunk, void* stream) {
  if (!flare::ssd_head_dim(P) || !flare::ssd_state_dim(N) ||
      chunk % kTile != 0 || chunk < kTile || chunk > kMaxChunk || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 64)
    return launch_n<128>(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, P,
                         N, chunk, s);
  return launch_n<64>(x, dt, A, Bm, Cm, init, y, final_state, B, L, H, P, N,
                      chunk, s);
}
