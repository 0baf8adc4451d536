// Mamba2 chunked SSD scan forward in fp32 on the Hopper tensor cores as
// split TF32 (sm_90a): the fp32 route ("tf32x3") of the port's SSD scan
// (bf16 takes ssd_scan_wgmma.cu).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_fwd, body _ssd_kernel), and with it, on the prefill path, the
// model's ssd_chunked (src/repro/models/mamba2.py), for fp32 inputs.  For
// one (batch b, head h), with chunks of Q rows and the within-chunk
// inclusive cumulative decay cum_t = sum_{r <= t} dt_r * A:
//   y_t  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s   (intra)
//        + exp(cum_t) C_t . S                                     (inter)
//   S   <- exp(cum_last) S + sum_s x_s (exp(cum_last - cum_s) dt_s) B_s
// x [B,L,H,P], dt [B,L,H], A [H], Bm/Cm [B,L,N], all fp32; y [B,L,H,P]
// fp32; the state S is [P,N] fp32 per (b, h), seeded from an optional
// initial_state and returned as final_state [B,H,P,N].  Any L: rows past
// L load as zeros and dt = 0 there.
//
// Arithmetic: each product X.Y is X_hi.Y_hi + X_hi.Y_lo + X_lo.Y_hi of
// tf32 terms (hopper.cuh, split_tf32) by m64n64k8 tf32 wgmma into fp32
// accumulators, so y and the state are held to a full-fp32 reference
// (3e-4).  The decay is the bf16 kernel's: cum summed in fp64, every exp
// of an fp64 difference, two factors off a warp's 16-row diagonal block.
//
// Bound on an H100: bytes.  At the serving shape (B 8, L 1024, H 48, P 64,
// N 128, chunk 256) the traffic is ~224 MB (x, y, Bm, Cm, dt, state),
// 0.067 ms at 3.35 TB/s; the work is 1.96e10 flops, 0.040 ms at the
// 494.7 TFLOP/s of the TF32 tensor cores; three passes make 0.119 ms.
//
// Design (one warpgroup per (b, h), walking the chunks in order; the fp32
// state [P,N] in the accumulator registers of its update, as S^T [n][p]):
//   * tf32 wgmma reads only K-major operands.  Bm and Cm do not depend on
//     the head: a pre-pass (flash_tf32_split.cuh) splits them once into hi
//     and lo [2][B,L,N], which TMA brings as tiles;
//       G = C_t . B_s^T     ss, both K-major over n as they lie;
//       y = C_t . S^T       ss: S, the chunk-start state, leaves the
//                           registers split into shared memory [p][n];
//       y += scores . x_s   rs: the scores G o exp(cum_t - cum_s) o dt_s,
//                           masked to s <= t, split in registers, are the
//                           A operand as they lie; B is x_s^T [p][s],
//                           which the block writes split from the raw x
//                           tile (only this block reads x of its head),
//                           each 8 s in the order 0,2,4,6,1,3,5,7 so that
//                           the accumulator fragment is the A fragment;
//       S^T += (w o B_s)^T . x_s   rs: A is built in registers from the
//                           B_s pair tile already in shared memory, scaled
//                           by w_s = exp(cum_last - cum_s) dt_s and split
//                           again; B is the same x_s^T tile, so the state
//                           update needs no transposed copy of Bm;
//   * shared memory: fp32 hi + lo is 4x bf16, so the products over n go by
//     halves of 64: B_s comes as (s tile, n half) items through a ring of
//     2 stages of 32 KB, the state's rows n of a half are one m64 product,
//     and the chunk-start state is written a half at a time for C.S^T.
//     At N 128: C_t 64 KB, the B_s ring 64 KB, S 32 KB, x_s^T 32 KB, raw
//     x_s 16 KB, the decay arrays 9 KB: 218 KB, one block per SM, so the
//     384 (b, h) blocks of the serving shape take three waves of 132;
//   * loads: C_t once per t tile; each t tile walks its s tiles starting
//     with the one still resident from the previous t tile (its B_s items
//     and x_s^T), so a 4-tile chunk loads and splits 7 s tiles for its 10
//     (t, s) pairs; the raw x tile one load ahead, the B_s items two
//     ahead; a B_s item's stage is freed once its G (and, on the chunk's
//     last t tile, its state update) is done, so the next load runs under
//     the scores and their products;
//   * synchronisation: one warpgroup, so a block barrier is four warps;
//     products are waited by wgmma.wait_group, loads by mbarriers.
// The tiles are 64 columns of x (kP) and N = 64 or 128 columns of Bm / Cm
// (the two instances); head_dim P in {8, 16, 32, 64} and state Ns in {8,
// 16, 32, 64, 128} are taken at run time: the tensor maps of x and of the
// Bm / Cm splits have the true widths, so the box columns past them load as
// zeros, which add exact zeros to every product (the state's rows past P
// and columns past Ns stay zero), and the initial state, y and the final
// state are read and written at their true widths.  chunk is a multiple of
// 64 up to 256.  The wrapper refuses others.

#include "common.cuh"
#include "flash_tf32_split.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;
using flare::tf32x3::launch_split_at;
using flare::tf32x3::map_rows;
using flare::tf32x3::permuted_row;
using flare::tf32x3::SplitJobs;

constexpr int kThreads = 128;  // one warpgroup
constexpr int kTile = 64;      // rows of a t or s tile (wgmma's M)
constexpr int kP = 64;         // the columns of an x tile: head_dim padded
constexpr int kHalf = 64;      // n columns of a B_s item and an S half
constexpr int kStages = 2;     // the B_s ring
constexpr int kMaxChunk = 256;

// the s tile that step k of t tile ti walks: the one left resident by the
// previous t tile first (ti - 1), then 0 .. ti - 2, then the diagonal
__device__ __forceinline__ int s_tile_of(int ti, int k) {
  if (ti == 0) return 0;
  if (k == 0) return ti - 1;
  return k < ti ? k - 1 : ti;
}

// Operand tiles are column blocks of [rows][32] fp32 in the 128-byte
// swizzle, 1024-byte aligned: element (row, col) of a tile of `rows` rows
template <int kRows>
__device__ __forceinline__ int swz(int row, int col) {
  return (col / 32) * kRows * 32 + row * 32 +
         ((((col % 32) / 4) ^ (row % 8)) * 4) + (col % 4);
}

// a float offset within a tile as the increment of a wgmma descriptor's
// start address (16-byte units)
__device__ __forceinline__ uint32_t desc_off(int floats) {
  return static_cast<uint32_t>(floats) / 4;
}

template <int N>
struct Smem {
  float c[kTile * N];                  // C_t hi [t][n]
  float c_lo[kTile * N];
  float b[kStages][kTile * kHalf];     // B_s hi [s][n] of an n half
  float b_lo[kStages][kTile * kHalf];
  float s[kP * kHalf];                 // the chunk-start state hi [p][n]
  float s_lo[kP * kHalf];              // of an n half
  float xt[kP * kTile];                // x_s^T hi [p][s], s permuted
  float xt_lo[kP * kTile];
  float x[kTile * kP];                 // the raw x_s tile [s][p]
  double cum[kMaxChunk];               // the chunk's cumulative decay (fp64)
  float ecum[kMaxChunk];               // exp(cum_t)
  float w[kMaxChunk];                  // exp(cum_last - cum_s) dt_s
  float dts[kMaxChunk];                // dt_s
  float es[kThreads / 32][kMaxChunk];  // per warp: exp(cum_ref - cum_s) dt_s
  double wsum[kThreads / 32];
  uint64_t c_full;
  uint64_t x_full;
  uint64_t b_full[kStages];
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_tf32_kernel(__grid_constant__ const CUtensorMap map_x,
                __grid_constant__ const CUtensorMap map_bh,
                __grid_constant__ const CUtensorMap map_bl,
                __grid_constant__ const CUtensorMap map_ch,
                __grid_constant__ const CUtensorMap map_cl,
                const float* __restrict__ dt, const float* __restrict__ A,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ final_state, int L, int H, int chunk,
                int P, int Ns) {
  constexpr int kHalves = N / kHalf;            // B_s items per s tile
  constexpr int kCols = N / 32;                 // column blocks of C_t
  constexpr uint32_t kCBytes = 2 * kTile * N * 4;
  constexpr uint32_t kBBytes = 2 * kTile * kHalf * 4;
  constexpr uint32_t kXBytes = kTile * kP * 4;
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
    mbar_init(&sm.x_full, 1);
    for (int st = 0; st < kStages; ++st) mbar_init(&sm.b_full[st], 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the walk: chunk by chunk, t tile by t tile, over the s tiles 0..t, the
  // one left resident by the previous t tile first (s_tile_of).  The
  // distinct s tiles it loads are counted by u: a chunk of nt tiles loads
  // 1 + nt (nt - 1) / 2 of them (7 at nt 4, against 10 pairs); load_row(u)
  // is the first row of load u
  const int nc = (L + chunk - 1) / chunk;
  const int nt_full = chunk / kTile;
  const int loads_full = 1 + nt_full * (nt_full - 1) / 2;
  const int nt_last = (L - (nc - 1) * chunk + kTile - 1) / kTile;
  const int loads = L > 0 ? (nc - 1) * loads_full + 1 +
                                nt_last * (nt_last - 1) / 2
                          : 0;
  auto load_row = [&](int u) {
    const int c = min(u / loads_full, nc - 1);
    int r = u - c * loads_full;
    int sj = 0;
    // load 0 of a chunk is s tile 0 of t tile 0; t tile ti >= 1 loads its
    // s tiles 0 .. ti - 2, then ti
    for (int ti = 1; r > 0; ++ti) {
      if (r <= ti) {
        sj = r < ti ? r - 1 : ti;
        break;
      }
      r -= ti;
    }
    return c * chunk + sj * kTile;
  };
  // loads, issued by thread 0: B_s item g = (load g / kHalves, n half
  // g % kHalves) into stage g % kStages; the raw x tile of load u; C_t
  const CUtensorMap* mx = &map_x;
  const CUtensorMap* mbh = &map_bh;
  const CUtensorMap* mbl = &map_bl;
  const CUtensorMap* mch = &map_ch;
  const CUtensorMap* mcl = &map_cl;
  auto load_item = [&](int g) {
    if (g >= loads * kHalves) return;
    const int st = g % kStages;
    const int row = load_row(g / kHalves);
    const int n0 = (g % kHalves) * kHalf;
    mbar_expect_tx(&sm.b_full[st], kBBytes);
#pragma unroll
    for (int cb = 0; cb < kHalf / 32; ++cb) {
      tma_load_4d(sm.b[st] + cb * kTile * 32, mbh, &sm.b_full[st],
                  n0 + cb * 32, 0, row, b);
      tma_load_4d(sm.b_lo[st] + cb * kTile * 32, mbl, &sm.b_full[st],
                  n0 + cb * 32, 0, row, b);
    }
  };
  auto load_x = [&](int u) {
    if (u >= loads) return;
    const int row = load_row(u);
    mbar_expect_tx(&sm.x_full, kXBytes);
#pragma unroll
    for (int cb = 0; cb < kP / 32; ++cb)
      tma_load_4d(sm.x + cb * kTile * 32, mx, &sm.x_full, cb * 32, h, row, b);
  };
  auto load_c = [&](int row) {
    mbar_expect_tx(&sm.c_full, kCBytes);
#pragma unroll
    for (int cb = 0; cb < kCols; ++cb) {
      tma_load_4d(sm.c + cb * kTile * 32, mch, &sm.c_full, cb * 32, 0, row,
                  b);
      tma_load_4d(sm.c_lo + cb * kTile * 32, mcl, &sm.c_full, cb * 32, 0,
                  row, b);
    }
  };

  // the fp32 state as S^T [n][p]: half hh holds rows n = 64 hh + r0,
  // r0 + 8, columns p = 8i + c0 + {0, 1} (the accumulator fragment of the
  // state update, whose M is n); the initial state [P, Ns] fills p < P,
  // n < Ns
  float st[kHalves][32];
  const size_t st_off = (static_cast<size_t>(b) * H + h) * P * Ns;
#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 8 * i + c0 + (e & 1);
        const int n = hh * kHalf + r0 + 8 * (e >> 1);
        st[hh][4 * i + e] =
            init && p < P && n < Ns ? init[st_off + p * Ns + n] : 0.f;
      }

  // wgmma descriptors of the tiles' starts; a k8 step adds its byte
  // offset / 16 (desc_off)
  const uint64_t dc_hi = desc_sw128(sm.c, 16, 1024);
  const uint64_t dc_lo = desc_sw128(sm.c_lo, 16, 1024);
  const uint64_t ds_hi = desc_sw128(sm.s, 16, 1024);
  const uint64_t ds_lo = desc_sw128(sm.s_lo, 16, 1024);
  const uint64_t dxt_hi = desc_sw128(sm.xt, 16, 1024);
  const uint64_t dxt_lo = desc_sw128(sm.xt_lo, 16, 1024);

  float yacc[32];
  float g[32];
  uint32_t c_ph = 0;
  uint32_t x_ph = 0;
  if (loads > 0 && tid == 0) {
    load_c(0);
    load_x(0);
    for (int i = 0; i < kStages; ++i) load_item(i);
  }
  // frees the B_s items of load u once every warp is done with them, and
  // loads the items kStages on
  auto release_items = [&](int u) {
    __syncthreads();
    if (tid == 0)
      for (int j = 0; j < kHalves; ++j) load_item(u * kHalves + kStages + j);
  };

  int u = -1;  // the load of the pair being walked
  for (int t0 = 0; t0 < L; t0 += chunk) {
    const int lc = min(chunk, L - t0);
    const int nt = (lc + kTile - 1) / kTile;
    const bool last_chunk = t0 + chunk >= L;

    // ---- dt and the inclusive scan of dt*A over the chunk, in fp64 ---- //
    // each thread sums two neighbouring rows, then the warps' totals
    __syncthreads();  // the previous chunk is done with cum, w
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
    const float dl = expf(static_cast<float>(cl));
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

      // ---- inter-chunk term: y = C_t . S^T by n halves, each half of the
      // chunk-start state split from the registers into shared memory ---- //
      mbar_wait(&sm.c_full, c_ph);
      c_ph ^= 1;
#pragma unroll
      for (int hh = 0; hh < kHalves; ++hh) {
        __syncthreads();  // every warp is done with the previous S half
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = swz<kP>(8 * i + c0 + (e & 1), r0 + 8 * (e >> 1));
            uint32_t hi, lo;
            split_tf32(st[hh][4 * i + e], hi, lo);
            sm.s[idx] = __uint_as_float(hi);
            sm.s_lo[idx] = __uint_as_float(lo);
          }
        fence_proxy_async();
        __syncthreads();
        fence_regs(yacc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kHalf / 8; ++kk) {
          const uint32_t co = desc_off((2 * hh + kk / 4) * kTile * 32 +
                                       (kk % 4) * 8);
          const uint32_t so = desc_off((kk / 4) * kP * 32 + (kk % 4) * 8);
          wgmma_m64n64k8_tf32_ss(yacc, dc_hi + co, ds_lo + so,
                                 hh > 0 || kk > 0);
          wgmma_m64n64k8_tf32_ss(yacc, dc_lo + co, ds_hi + so, 1);
          wgmma_m64n64k8_tf32_ss(yacc, dc_hi + co, ds_hi + so, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(yacc);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        yacc[4 * i] *= sm.ecum[tl0];
        yacc[4 * i + 1] *= sm.ecum[tl0];
        yacc[4 * i + 2] *= sm.ecum[tl0 + 8];
        yacc[4 * i + 3] *= sm.ecum[tl0 + 8];
      }
      // the chunk-start state has been read: on the chunk's last t tile it
      // decays over the chunk, and the chunk's contributions add into it
      if (state_tile) {
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
          for (int j = 0; j < 32; ++j) st[hh][j] *= dl;
      }

      for (int k = 0; k <= ti; ++k) {
        const int sj = s_tile_of(ti, k);  // the s tile, chunk-local
        // a pair's s tile is new but for t tile ti's first, which the
        // previous pair left resident (with its x_s^T); this pair's s tile
        // stays for the next pair if it is t tile ti's diagonal and another
        // t tile follows in the chunk
        const bool fresh = ti == 0 || k > 0;
        const bool kept = k == ti && ti + 1 < nt;
        if (fresh) {
          ++u;
          // ---- x_s^T split, s permuted in each 8, from the raw x tile, and
          // the B_s items ---- //
          mbar_wait(&sm.x_full, x_ph);
          x_ph ^= 1;
          __syncthreads();  // every warp is done with the previous x_s^T
#pragma unroll 2
          for (int j = 0; j < 8; ++j) {
            const int item = tid + kThreads * j;
            const int p = item % kP;
            const int pos0 = (item / kP) * 4;
            uint4 hi, lo;
            uint32_t* hv = reinterpret_cast<uint32_t*>(&hi);
            uint32_t* lv = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int pos = pos0 + e;
              const int s = (pos & ~15) | permuted_row(pos & 15);
              split_tf32(sm.x[swz<kTile>(s, p)], hv[e], lv[e]);
            }
            const int idx = swz<kP>(p, pos0);
            *reinterpret_cast<uint4*>(sm.xt + idx) = hi;
            *reinterpret_cast<uint4*>(sm.xt_lo + idx) = lo;
          }
          fence_proxy_async();
          __syncthreads();
          if (tid == 0) load_x(u + 1);  // the raw tile has been read
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh) {
            const int gi = u * kHalves + hh;
            mbar_wait(&sm.b_full[gi % kStages], (gi / kStages) & 1);
          }
        }

        // ---- G = C_t . B_s^T over n, by halves ---- //
        fence_regs(g);
        wgmma_fence();
#pragma unroll
        for (int hh = 0; hh < kHalves; ++hh) {
          const int sg = (u * kHalves + hh) % kStages;
          const uint64_t dbh = desc_sw128(sm.b[sg], 16, 1024);
          const uint64_t dbl = desc_sw128(sm.b_lo[sg], 16, 1024);
#pragma unroll
          for (int kk = 0; kk < kHalf / 8; ++kk) {
            const uint32_t co = desc_off((2 * hh + kk / 4) * kTile * 32 +
                                         (kk % 4) * 8);
            const uint32_t bo = desc_off((kk / 4) * kTile * 32 + (kk % 4) * 8);
            wgmma_m64n64k8_tf32_ss(g, dc_hi + co, dbl + bo, hh > 0 || kk > 0);
            wgmma_m64n64k8_tf32_ss(g, dc_lo + co, dbh + bo, 1);
            wgmma_m64n64k8_tf32_ss(g, dc_hi + co, dbh + bo, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(g);
        if (k == ti) {
          // the t tile's last read of C_t: load the next t tile's
          __syncthreads();
          if (tid == 0) {
            if (ti + 1 < nt)
              load_c(t0 + (ti + 1) * kTile);
            else if (!last_chunk)
              load_c(t0 + chunk);
          }
        }
        if (state_tile) {
          // ---- S^T += (w o B_s)^T . x_s by n halves: A from the B_s pair
          // tile (hi + lo), scaled by w_s and split again; A's column c of
          // a k8 step is the s that x_s^T holds at K position c ---- //
#pragma unroll
          for (int hh = 0; hh < kHalves; ++hh) {
            const int sg = (u * kHalves + hh) % kStages;
            const float* bh = sm.b[sg];
            const float* bl = sm.b_lo[sg];
            // the k8 step's A columns l%4 and l%4 + 4 are, in x_s^T's
            // order, s = 8kk + c0 and 8kk + c0 + 1
#pragma unroll
            for (int k4 = 0; k4 < kTile / 8; k4 += 4) {
              uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int s = 8 * (k4 + k) + c0;
                const float w0 = sm.w[sj * kTile + s];
                const float w1 = sm.w[sj * kTile + s + 1];
                const int i00 = swz<kTile>(s, r0);
                const int i01 = swz<kTile>(s, r0 + 8);
                const int i10 = swz<kTile>(s + 1, r0);
                const int i11 = swz<kTile>(s + 1, r0 + 8);
                split_tf32((bh[i00] + bl[i00]) * w0, a_hi[k][0], a_lo[k][0]);
                split_tf32((bh[i01] + bl[i01]) * w0, a_hi[k][1], a_lo[k][1]);
                split_tf32((bh[i10] + bl[i10]) * w1, a_hi[k][2], a_lo[k][2]);
                split_tf32((bh[i11] + bl[i11]) * w1, a_hi[k][3], a_lo[k][3]);
              }
              fence_regs(st[hh]);
              wgmma_fence();
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const uint32_t xo = desc_off(((k4 + k) / 4) * kP * 32 +
                                             ((k4 + k) % 4) * 8);
                wgmma_m64n64k8_tf32_rs(st[hh], a_hi[k], dxt_lo + xo, 1);
                wgmma_m64n64k8_tf32_rs(st[hh], a_lo[k], dxt_hi + xo, 1);
                wgmma_m64n64k8_tf32_rs(st[hh], a_hi[k], dxt_hi + xo, 1);
              }
              wgmma_commit();
              wgmma_wait<0>();
              fence_regs(st[hh]);
              fence_regs(a_hi);
              fence_regs(a_lo);
            }
          }
        }
        // the B_s items of this pair are done with, unless the next pair
        // reads them: the next load runs under the scores and their
        // products
        if (!kept) release_items(u);

        // ---- scores = G o exp(cum_t - cum_s) o dt_s for s <= t ---- //
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
        // ---- y += scores . x_s: the split scores as the A operand, four
        // k8 steps at a time (the fragments' registers are reused once their
        // products are done) ---- //
#pragma unroll
        for (int k4 = 0; k4 < kTile / 8; k4 += 4) {
          uint32_t sc_hi[4][4], sc_lo[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            split_tf32(g[4 * (k4 + k)], sc_hi[k][0], sc_lo[k][0]);
            split_tf32(g[4 * (k4 + k) + 2], sc_hi[k][1], sc_lo[k][1]);
            split_tf32(g[4 * (k4 + k) + 1], sc_hi[k][2], sc_lo[k][2]);
            split_tf32(g[4 * (k4 + k) + 3], sc_hi[k][3], sc_lo[k][3]);
          }
          fence_regs(yacc);
          wgmma_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t xo = desc_off(((k4 + k) / 4) * kP * 32 +
                                         ((k4 + k) % 4) * 8);
            wgmma_m64n64k8_tf32_rs(yacc, sc_hi[k], dxt_lo + xo, 1);
            wgmma_m64n64k8_tf32_rs(yacc, sc_lo[k], dxt_hi + xo, 1);
            wgmma_m64n64k8_tf32_rs(yacc, sc_hi[k], dxt_hi + xo, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(yacc);
          fence_regs(sc_hi);
          fence_regs(sc_lo);
        }

      }

      // y rows < L, columns < P, in fp32
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = t0 + tl0 + 8 * r;
        if (t >= L) continue;
        float* yr = y + ((static_cast<size_t>(b) * L + t) * H + h) * P;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (8 * i < P)
            *reinterpret_cast<float2*>(yr + 8 * i + c0) =
                make_float2(yacc[4 * i + 2 * r], yacc[4 * i + 2 * r + 1]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < kHalves; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 8 * i + c0 + (e & 1);
        const int n = hh * kHalf + r0 + 8 * (e >> 1);
        if (p < P && n < Ns)
          final_state[st_off + p * Ns + n] = st[hh][4 * i + e];
      }
}

template <int N>
int launch_n(const float* x, const float* dt, const float* A, const float* Bm,
             const float* Cm, const float* init, float* y, float* final_state,
             float* bm_pair, float* cm_pair, int B, int L, int H, int P,
             int Ns, int chunk, cudaStream_t stream) {
  // at L = 0 the kernel only copies the initial state, and loads nothing
  CUtensorMap mx{}, mbh{}, mbl{}, mch{}, mcl{};
  if (L > 0) {
    // the pre-pass: Bm and Cm split once for every head
    SplitJobs jobs = {};
    jobs.job[0] = {Bm, bm_pair, nullptr, nullptr, nullptr, 1};
    jobs.job[1] = {Cm, cm_pair, nullptr, nullptr, nullptr, 1};
    jobs.n = 2;
    if (int e = launch_split_at<8, 16, 32, 64, 128>(Ns, jobs, B, L, stream))
      return e;
    const size_t n = static_cast<size_t>(B) * L * Ns;
    if (int e = map_rows(&mx, x, B, L, H, P, kTile)) return e;
    if (int e = map_rows(&mbh, bm_pair, B, L, 1, Ns, kTile)) return e;
    if (int e = map_rows(&mbl, bm_pair + n, B, L, 1, Ns, kTile)) return e;
    if (int e = map_rows(&mch, cm_pair, B, L, 1, Ns, kTile)) return e;
    if (int e = map_rows(&mcl, cm_pair + n, B, L, 1, Ns, kTile)) return e;
  }
  const size_t smem = sizeof(Smem<N>) + 1024;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_tf32_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  ssd_tf32_kernel<N><<<B * H, kThreads, smem, stream>>>(
      mx, mbh, mbl, mch, mcl, dt, A, init, y, final_state, L, H, chunk, P,
      Ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, y: [B,L,H,P] and Bm, Cm: [B,L,N] fp32; dt: [B,L,H], A: [H], init (may
// be null) and final_state: [B,H,P,N] fp32.  All contiguous and 16-byte
// aligned.  Scratch the wrapper allocates: bm_pair and cm_pair [2][B,L,N]
// (Bm's and Cm's tf32 hi, then lo).  Launches the pre-pass and the kernel
// on `stream`.  Returns 0 or a cudaError_t (a launch's, or the tensor
// maps').
extern "C" int ssd_scan_tf32_launch(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* Cm, const void* init, void* y,
                                    void* final_state, void* bm_pair,
                                    void* cm_pair, int B, int L, int H, int P,
                                    int N, int chunk, void* stream) {
  if (!flare::ssd_head_dim(P) || !flare::ssd_state_dim(N) ||
      chunk % kTile != 0 || chunk < kTile || chunk > kMaxChunk || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* sf = static_cast<const float*>(init);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(final_state);
  float* bp = static_cast<float*>(bm_pair);
  float* cp = static_cast<float*>(cm_pair);
  if (N > 64)
    return launch_n<128>(xf, dtf, af, bf, cf, sf, yf, ff, bp, cp, B, L, H, P,
                         N, chunk, s);
  return launch_n<64>(xf, dtf, af, bf, cf, sf, yf, ff, bp, cp, B, L, H, P, N,
                      chunk, s);
}
