// Backward of the Mamba2 chunked SSD scan in fp32 on the Hopper tensor
// cores as split TF32 (sm_90a): the fp32 route ("tf32x3") of the port's
// SSD-scan backward (bf16 takes ssd_scan_bwd_wgmma.cu).
//
// Port-only: the JAX package differentiates its chunked scan
// (src/repro/models/mamba2.py::ssd_chunked) by XLA autodiff, so its
// backward has no Pallas kernel; the forward's TPU kernel is
// src/repro/kernels/ssd_scan/kernel.py (ssd_scan_fwd).  The plain version is
// kernels/ssd_scan/ops.py::ssd_bwd_ref.  For one (batch b, head h), chunks
// of Q rows, cum_t = sum_{r <= t} dt_r A (fp64), L_ts = exp(cum_t - cum_s)
// for s <= t, G_ts = C_t . B_s, M_ts = dy_t . x_s, w_s = exp(cum_last -
// cum_s) dt_s, S_prev the chunk-start state [P,N], dS the cotangent of the
// chunk-end state:
//   dx_s  = sum_{t>=s} G_ts L_ts dt_s dy_t + w_s (B_s . dS^T)
//   dB_s  = sum_h [sum_{t>=s} M_ts L_ts dt_s C_t + w_s (x_s . dS)]
//   dC_t  = sum_h [sum_{s<=t} M_ts L_ts dt_s B_s + exp(cum_t) (dy_t . S_prev)]
//   ddt, dA from dcum, the cotangent of cum, by a reverse cumsum in fp64.
// The products are those of the bf16 route; dB and dC are sums over heads
// (B and C are shared by all H heads, ngroups 1).
//
// Arithmetic: each product X.Y is X_hi.Y_lo + X_lo.Y_hi + X_hi.Y_hi of tf32
// terms (hopper.cuh, split_tf32) by m64n64k8 tf32 wgmma into fp32
// accumulators, so the fp32 result is held to a full-fp32 reference
// (3e-4): the inputs x, dy, Bm, Cm are split, and so is every operand that
// is an fp32 result (the scores G L dt_s and M L dt_s, w o B, exp(cum) o C,
// S_prev, dS).  cum is summed in fp64; every exp takes an fp64 difference
// rounded to fp32; off each warp's 16-row diagonal block the decay
// exp(cum_t - cum_s) is the product of two such exps at the warp's
// reference row, each at most 1 (the fp32 forward's factorisation).
//
// Bound on an H100: operations.  At the training shape (B 8, L 512, H 48,
// P 64, N 128, chunk 256) the function needs 3.564e10 flops
// (chip_smoke.py::ssd_bwd_work_flops), 0.072 ms at the 494.7 TFLOP/s of
// the TF32 tensor cores, against 1.61e8 bytes of inputs and outputs (0.048
// ms); three passes make 0.216 ms.  This design does 1.389e11 flops of
// three-pass work (chip_smoke.py::ssd_bwd_design_flops), a 0.281 ms floor:
// G = C.B^T, which does not depend on the head, once per block for its
// group of 8 heads (1.812e11 were it per head).
//
// Layouts.  tf32 wgmma reads only K-major operands, and nothing of the bf16
// route's transposed reads (the transpose bit, ldmatrix.trans) exists for
// 32-bit types.  So:
//   * a pre-pass (flash_tf32_split.cuh) splits, once for every block that
//     reads them, Bm and Cm [B,L,N] into direct pairs [2][B,L,N] (hi, lo)
//     and dy [B,L,H,P], Bm and Cm into transposed splits [B,heads,hd,2*L16]
//     whose each 8 rows run 0,2,4,6,1,3,5,7, so that an fp32 accumulator
//     over those rows is the tf32 A fragment as it lies (dy^T with heads H,
//     hd P; Bm^T, Cm^T with one head, hd N).  The blocks split the rest from
//     raw TMA tiles: the state kernel x_s^T into the same layout, the dx/dB
//     and dC kernels the direct dy_t and x_s items in place (hi where the
//     raw tile lies, lo beside it), which keeps 300 MB of pairs out of
//     device memory at the training shape;
//   * A operands that are inputs come from raw TMA tiles in shared memory,
//     split in registers four k8 steps at a time; A operands that are
//     accumulators (the scores) are split where they lie; B operands are
//     64 x 64 items of a split (32 KB, hi and lo) through a 3-stage ring:
//       G^T = B_s . C_t^T        B: C_t pair [t][n]           (dx/dB kernel)
//       M^T = x_s . dy_t^T       B: dy_t [t][p], split in place
//       dx_s += (G^T L dt) dy_t  B: dy_t^T [p][t], rows permuted
//       dB_s += (M^T L dt) C_t   B: C_t^T [n][t], rows permuted
//       V = B_s . dS^T           B: dS [p][n]     (the state kernel's)
//       x_s . dS                 B: dS^T [n][p]   (the state kernel's)
//       G = C_t . B_s^T          B: B_s pair [s][n]             (dC kernel)
//       M = dy_t . x_s^T         B: x_s [s][p], split in place
//       dC_t += (M L dt) B_s     B: B_s^T [n][s], rows permuted
//       dy_t . S_prev            B: S_prev^T [n][p] (the state kernel's)
//       S^T += (w o B_s)^T x_s   A built from the raw B_s (C_t) tile, scaled
//       dS^T += (e o C_t)^T dy_t  and split in the permuted order; B: x_s^T
//                                (split in the block), dy_t^T
//   * the state kernel holds S^T and dS^T [n][p] in accumulators and writes
//     S_prev^T, dS^T and dS as split items, already in the 128-byte swizzle,
//     which the others bring by one bulk copy.
//
// Design: seven launches on one stream, deterministic, no atomics.
//   1-2. the pre-pass (one launch when N = P, else two: one per width);
//   3. ssd_bwd_tf32_state_kernel, a block (one warpgroup) per (b, h): cum
//      (fp64, into scratch), then chunks in order S^T = (w o B)^T x, the
//      chunk-start states, and chunks in reverse dS^T from d_final_state
//      with (exp(cum) o C)^T dy, by n halves of 64, each tile's products
//      added to the carried state on the FP32 pipes; <dS, S_prev>;
//   4. ssd_bwd_tf32_dxdb_kernel, a block per (b, 64-row s tile, group of 8
//      heads), heaviest s tiles first: first the G^T tile of every t >= s of
//      the chunk, once for the group, into shared memory as the accumulators
//      lie; then per head the state terms (V starts dx_s, x_s . dS adds to
//      dB_s) and over the t tiles M^T, the decay, mask and dt_s in
//      registers, ddt_intra_s, dx_s += (G^T L dt) dy_t and dB_s += (M^T L
//      dt) C_t by n halves.  dx_s is written per head; dB_s stays in fp32
//      registers across the group's heads and is written once per group;
//      each head's cum and dt come by cp.async under the head before;
//   5. ssd_bwd_tf32_dc_kernel, a block per (b, 64-row t tile, group of 8
//      heads), heaviest t tiles first: the G tiles of every s <= t once for
//      the group, then per head dy_t . S_prev (dC_t's state term and E_t) and
//      over the s tiles M, the row sums of G L M dt_s, and dC_t += (M L dt)
//      B_s by n halves; dC_t stays in registers across the group's heads;
//   6-7. the finish and sum kernels of ssd_bwd_common.cuh (the bf16 route's).
// Shared memory at N 128: dx/dB 219 KB (the ring 96 KB, B_s 32 KB, x_s 16
// KB, the group's G^T tiles 64 KB, two heads' cum and dt, the decay's
// column factors) and dC 219 KB,
// one block per SM; the state kernel 85 KB, one tile's loads at a time,
// two blocks per SM.  Rows past L load as zeros (TMA fills them, the
// pre-pass writes them) with dt = 0, so they add nothing and leave cum at
// the last real row's value: any L is taken.  The tiles are 64 columns of
// x and dy (kP) and N = 64 or 128 columns of Bm / Cm (the two instances);
// head_dim P in {8, 16, 32, 64} and state Ns in {8, 16, 32, 64, 128} are
// taken at run time: the pre-pass splits dy, Bm and Cm at their true widths
// (its instance by width), and every tensor map of x, dy, Bm, Cm and their
// splits has the true widths, so the box columns (or, of a transposed
// split, the rows) past them load as zeros, which add exact zeros to every
// product and leave the states' and cotangents' rows past P and columns
// past Ns zero; the initial state and the final state's cotangent are read,
// dx, dBm and dCm written at their true widths, and the items and partials
// the kernels pass keep the padded tiles.  chunk is a multiple of 64 up to
// 256.  The wrapper refuses others.

#include "common.cuh"
#include "flash_tf32_split.cuh"
#include "hopper.cuh"
#include "ssd_bwd_common.cuh"

namespace {

using namespace flare::hopper;
using flare::tf32x3::launch_split_at;
using flare::tf32x3::map_rows;
using flare::tf32x3::map_transposed;
using flare::tf32x3::permuted_row;
using flare::tf32x3::SplitJobs;

constexpr int kThreads = kScanThreads;     // one warpgroup
constexpr int kP = 64;                     // the columns of an x or dy tile
constexpr int kHalf = 64;                  // columns of an item
constexpr int kItem = 2 * kTile * kHalf;   // floats of an item: hi, then lo
constexpr uint32_t kItemBytes = kItem * 4;
constexpr int kStages = 3;                 // the item ring
constexpr int kMaxTiles = kMaxChunk / kTile;

// ------------------------------------------------------------- helpers --

// element (r, c) of a 64-row fp32 tile held as c / 32 column blocks of
// [64][32] in the 128-byte swizzle (what TMA writes, what wgmma reads)
__device__ __forceinline__ int swz(int r, int c) {
  return (c / 32) * kTile * 32 + r * 32 + ((((c % 32) / 4) ^ (r % 8)) * 4) +
         c % 4;
}

// a float offset within a tile as the increment of a wgmma descriptor's
// start address (16-byte units)
__device__ __forceinline__ uint64_t desc_off(int floats) {
  return static_cast<uint64_t>(floats / 4);
}

using Frag = uint32_t[4][4];   // the tf32 A fragments of four k8 steps

// D[64,64] += A . B over four k8 steps k4..k4+3 of an item, three passes a
// step.  The item's K positions: direct (kT false), the hi tile's two
// column blocks, then the lo tile's; transposed (kT true), the pre-pass's
// four 16-row blocks, each a row of 16 hi then 16 lo
template <bool kT>
__device__ __forceinline__ void rs4(float (&d)[32], const Frag& hi,
                                    const Frag& lo, const float* item,
                                    int k4) {
  const uint64_t base = desc_sw128(item, 16, 1024);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kk = k4 + k;
    const int ho = kT ? (kk / 2) * kTile * 32 + (kk % 2) * 8
                      : (kk / 4) * kTile * 32 + (kk % 4) * 8;
    const int lo_off = kT ? ho + 16 : ho + kTile * kHalf;
    const uint64_t bh = base + desc_off(ho);
    const uint64_t bl = base + desc_off(lo_off);
    wgmma_m64n64k8_tf32_rs(d, hi[k], bl, 1);
    wgmma_m64n64k8_tf32_rs(d, lo[k], bh, 1);
    wgmma_m64n64k8_tf32_rs(d, hi[k], bh, 1);
  }
}

// D[64,64] += A . B over the 64 K positions of an item, four k8 steps a
// round: make(hi, lo, k4) builds A's fragments of the round
template <bool kT, typename MakeA>
__device__ __forceinline__ void product(float (&d)[32], const float* item,
                                        MakeA make) {
#pragma unroll
  for (int k4 = 0; k4 < 8; k4 += 4) {
    Frag hi, lo;
    make(hi, lo, k4);
    fence_regs(d);
    wgmma_fence();
    rs4<kT>(d, hi, lo, item, k4);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(d);
    fence_regs(hi);
    fence_regs(lo);
  }
}

// A fragments of k8 steps k4.. from a raw tile: rows r0, r0 + 8 of this
// thread, columns col0 + 8 kk + l%4 and + 4 (K as it lies), split
__device__ __forceinline__ void raw_a(Frag& hi, Frag& lo, const float* t,
                                      int col0, int k4) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = col0 + 8 * (k4 + k) + lane % 4;
    split_tf32(t[swz(r0, c)], hi[k][0], lo[k][0]);
    split_tf32(t[swz(r0 + 8, c)], hi[k][1], lo[k][1]);
    split_tf32(t[swz(r0, c + 4)], hi[k][2], lo[k][2]);
    split_tf32(t[swz(r0 + 8, c + 4)], hi[k][3], lo[k][3]);
  }
}

// A fragments of k8 steps k4.. from an accumulator D[64,64] whose columns
// are the K positions, B's rows in the pre-pass's order 0,2,4,6,1,3,5,7
// (d[4kk], d[4kk+2], d[4kk+1], d[4kk+3])
__device__ __forceinline__ void acc_a(Frag& hi, Frag& lo, const float (&d)[32],
                                      int k4) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int kk = k4 + k;
    split_tf32(d[4 * kk], hi[k][0], lo[k][0]);
    split_tf32(d[4 * kk + 2], hi[k][1], lo[k][1]);
    split_tf32(d[4 * kk + 1], hi[k][2], lo[k][2]);
    split_tf32(d[4 * kk + 3], hi[k][3], lo[k][3]);
  }
}

// A fragments of k8 steps k4.. of (f o rows)^T [n][s]: rows the raw [64 s]
// [N] tile (B_s or C_t), f the per-row scale; this thread's rows n0 + r0,
// + 8; the s of A's columns l%4 and l%4 + 4 are 8 kk + 2 (l%4) and + 1, as
// the transposed B (x_s^T, dy_t^T) holds them
__device__ __forceinline__ void state_a(Frag& hi, Frag& lo, const float* rows,
                                        const float* f, int n0, int k4) {
  const int lane = threadIdx.x % 32;
  const int n = n0 + (threadIdx.x / 32) * 16 + lane / 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = 8 * (k4 + k) + 2 * (lane % 4);
    split_tf32(rows[swz(s, n)] * f[s], hi[k][0], lo[k][0]);
    split_tf32(rows[swz(s, n + 8)] * f[s], hi[k][1], lo[k][1]);
    split_tf32(rows[swz(s + 1, n)] * f[s + 1], hi[k][2], lo[k][2]);
    split_tf32(rows[swz(s + 1, n + 8)] * f[s + 1], hi[k][3], lo[k][3]);
  }
}

// loads, issued by one thread; completion in bytes on `bar`
// a raw tile: 64 rows from `row` of columns 0 .. cols - 1
__device__ __forceinline__ void load_raw(float* dst, const CUtensorMap* m,
                                         uint64_t* bar, int cols, int h,
                                         int row, int b) {
  mbar_expect_tx(bar, kTile * cols * 4);
  for (int cb = 0; cb < cols / 32; ++cb)
    tma_load_4d(dst + cb * kTile * 32, m, bar, 32 * cb, h, row, b);
}
// an item of a direct pair (maps of its hi and lo): columns c0 .. c0 + 63
__device__ __forceinline__ void load_pair(float* dst, const CUtensorMap* mh,
                                          const CUtensorMap* ml, uint64_t* bar,
                                          int c0, int h, int row, int b) {
  mbar_expect_tx(bar, kItemBytes);
#pragma unroll
  for (int cb = 0; cb < kHalf / 32; ++cb) {
    tma_load_4d(dst + cb * kTile * 32, mh, bar, c0 + 32 * cb, h, row, b);
    tma_load_4d(dst + kTile * kHalf + cb * kTile * 32, ml, bar, c0 + 32 * cb,
                h, row, b);
  }
}
// an item of a transposed split: dims d0 .. d0 + 63 of the 64 rows from row
__device__ __forceinline__ void load_t(float* dst, const CUtensorMap* m,
                                       uint64_t* bar, int d0, int h, int row,
                                       int b) {
  mbar_expect_tx(bar, kItemBytes);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    tma_load_4d(dst + q * kTile * 32, m, bar, 2 * row + 32 * q, d0, h, b);
}
// a raw [64][64] tile (x_s, dy_t), loaded by load_raw into the first half
// of an item, split in place: its hi where it lies, its lo 4096 floats on.
// Each thread splits its own 32 values, so the reads and writes need no
// barrier between them; one after, for the wgmma that reads the item
__device__ __forceinline__ void split_in_place(float* item) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float* p = item + 4 * (threadIdx.x + kThreads * j);
    const float4 v = *reinterpret_cast<const float4*>(p);
    uint4 hi, lo;
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.y, hi.y, lo.y);
    split_tf32(v.z, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(p) = hi;
    *reinterpret_cast<uint4*>(p + kTile * kHalf) = lo;
  }
  fence_proxy_async();
  __syncthreads();
}

// an item the state kernel wrote
__device__ __forceinline__ void load_item(float* dst, const float* src,
                                          uint64_t* bar) {
  mbar_expect_tx(bar, kItemBytes);
  bulk_load(dst, src, kItemBytes, bar);
}

// a head's cum and dt over the chunk's rows [0, rows) into cum_s and dts
// (zeros past L), by cp.async, so that the copies run under the previous
// head's work; cp_wait() then a barrier before they are read
__device__ __forceinline__ void prefetch_rows(double* cum_s, float* dts,
                                              const double* cum,
                                              const float* dt, int rows,
                                              int L, int H) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(cum_s + i)),
                 "l"(cum + i)
                 : "memory");
    // a row past L copies no byte and reads as zero
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dts + i)),
                 "l"(dt + static_cast<size_t>(i < L ? i : 0) * H),
                 "r"(i < L ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// --------------------------------------------------------------- state --

template <int N>
struct StateSmem {
  float hdt[kItem];           // x_s^T (split here) or dy_t^T, transposed
  float rows[kTile * N];      // B_s or C_t, raw
  float x[kTile * kP];        // x_s, raw
  double cum[kMaxChunk];
  float dts[kMaxChunk];
  float scale[kMaxChunk];     // w_s (forward pass) or exp(cum_t) (reverse)
  double wsum[kThreads / 32];
  float red[kThreads / 32];
  uint64_t full;
};

// x_s^T split from the raw x tile [64 s][64 p] into an item in the
// pre-pass's transposed layout (column block q: row p holds the hi of s =
// 16q + permuted_row(pos) at pos, its lo at 16 + pos), as
// flash_tf32_split.cuh writes dy^T; a thread splits 4 positions at a time
__device__ __forceinline__ void split_transposed(float* item,
                                                 const float* raw) {
#pragma unroll 2
  for (int j = 0; j < 8; ++j) {
    const int idx = threadIdx.x + kThreads * j;
    const int p = idx % kP;
    const int q = idx / kP / 4;
    const int pos0 = (idx / kP) % 4 * 4;
    uint4 hi, lo;
    uint32_t* hv = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* lv = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(raw[swz(16 * q + permuted_row(pos0 + e), p)], hv[e], lv[e]);
    float* blk = item + q * kTile * 32;
    *reinterpret_cast<uint4*>(blk + swz(p, pos0)) = hi;
    *reinterpret_cast<uint4*>(blk + swz(p, 16 + pos0)) = lo;
  }
}

// the state S^T [n][p] of this thread (half hh: rows n = 64 hh + r0, + 8;
// columns p = 8i + c0, + 1) as items [n][p] split, at o (item hh at o +
// hh * kItem)
template <int N>
__device__ __forceinline__ void store_t_items(float* o,
                                              const float (&st)[N / kHalf][32],
                                              int r0, int c0) {
#pragma unroll
  for (int hh = 0; hh < N / kHalf; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        uint32_t h0, l0, h1, l1;
        split_tf32(st[hh][4 * i + 2 * r], h0, l0);
        split_tf32(st[hh][4 * i + 2 * r + 1], h1, l1);
        const int off = hh * kItem + swz(r0 + 8 * r, 8 * i + c0);
        *reinterpret_cast<float2*>(o + off) =
            make_float2(__uint_as_float(h0), __uint_as_float(h1));
        *reinterpret_cast<float2*>(o + off + kTile * kHalf) =
            make_float2(__uint_as_float(l0), __uint_as_float(l1));
      }
}

// the same state as items [p][n] split (dS, the B operand of B_s . dS^T)
template <int N>
__device__ __forceinline__ void store_items(float* o,
                                            const float (&st)[N / kHalf][32],
                                            int r0, int c0) {
#pragma unroll
  for (int hh = 0; hh < N / kHalf; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t hi, lo;
        split_tf32(st[hh][4 * i + e], hi, lo);
        const int off =
            hh * kItem + swz(8 * i + c0 + (e & 1), r0 + 8 * (e >> 1));
        o[off] = __uint_as_float(hi);
        o[off + kTile * kHalf] = __uint_as_float(lo);
      }
}

// the tile's products of the state kernel: st[hh] += (f o rows[:, half
// hh])^T . hdt, hdt the transposed split of x_s or dy_t.  The tile's sum
// goes into a fresh accumulator that the FP32 pipes add to the state,
// rounding to nearest: the tensor cores truncate the sums they
// accumulate, and a state carried in the accumulators took a bias of up
// to an ulp of the whole state a wgmma, over every tile of every chunk
// of the sequence; where the decay is slow (|A| 1) the state and that
// bias grow with L and reach ddt through <dS, S_prev> and the state terms
// (tools/ssd_bwd_tf32_precision.py)
template <int N>
__device__ __forceinline__ void state_tile(float (&st)[N / kHalf][32],
                                           const float* hdt, const float* rows,
                                           const float* f) {
#pragma unroll
  for (int hh = 0; hh < N / kHalf; ++hh) {
    float t[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) t[q] = 0.f;
    product<true>(t, hdt, [&](Frag& hi, Frag& lo, int k4) {
      state_a(hi, lo, rows, f, hh * kHalf, k4);
    });
#pragma unroll
    for (int q = 0; q < 32; ++q) st[hh][q] += t[q];
  }
}

// this thread's S^T fragment of a [P,Ns] state at src + st_off (null:
// zero), zero past P and Ns
template <int N>
__device__ __forceinline__ void load_state(float (&st)[N / kHalf][32],
                                           const float* src, size_t st_off,
                                           int r0, int c0, int P, int Ns) {
#pragma unroll
  for (int hh = 0; hh < N / kHalf; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 8 * i + c0 + (e & 1);
        const int n = hh * kHalf + r0 + 8 * (e >> 1);
        st[hh][4 * i + e] =
            src && p < P && n < Ns ? src[st_off + p * Ns + n] : 0.f;
      }
}

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_tf32_state_kernel(__grid_constant__ const CUtensorMap map_b,
                          __grid_constant__ const CUtensorMap map_c,
                          __grid_constant__ const CUtensorMap map_x,
                          __grid_constant__ const CUtensorMap map_dyt,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ init,
                          const float* __restrict__ dfinal,
                          double* __restrict__ cum_out,
                          float* __restrict__ spt, float* __restrict__ ds,
                          float* __restrict__ dst, float* __restrict__ dss,
                          int L, int H, int chunk, int P, int Ns) {
  constexpr int kH = N / kHalf;
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
    mbar_init(&sm.full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // one tile's loads at a time (two blocks share an SM): load n < F, tile
  // n % tpc of chunk n / tpc (B_s and x_s raw); load F + m, the reverse
  // pass's m-th tile, chunks from the last (C_t raw, dy_t^T split)
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
    mbar_expect_tx(&sm.full, (kTile * N + (rev ? kItem : kTile * kP)) * 4);
#pragma unroll
    for (int cb = 0; cb < N / 32; ++cb)
      tma_load_4d(sm.rows + cb * kTile * 32, rev ? &map_c : &map_b, &sm.full,
                  32 * cb, 0, row, b);
    if (rev) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_load_4d(sm.hdt + q * kTile * 32, &map_dyt, &sm.full,
                    2 * row + 32 * q, 0, h, b);
    } else {
#pragma unroll
      for (int cb = 0; cb < kP / 32; ++cb)
        tma_load_4d(sm.x + cb * kTile * 32, &map_x, &sm.full, 32 * cb, h,
                    row, b);
    }
  };
  issue(0);
  int n = 0;

  float st[kH][32];

  // ---- chunks in order: S_prev, from the initial state ---------------- //
  load_state<N>(st, init, st_off, r0, c0, P, Ns);
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
    store_t_items<N>(spt + (bh * nc + c) * kH * kItem, st, r0, c0);
    const float dl = expf(static_cast<float>(cl));
#pragma unroll
    for (int hh = 0; hh < kH; ++hh)
#pragma unroll
      for (int j = 0; j < 32; ++j) st[hh][j] *= dl;
    __syncthreads();  // scale
    for (int k = 0; k < nt; ++k, ++n) {
      mbar_wait(&sm.full, n & 1);
      split_transposed(sm.hdt, sm.x);
      fence_proxy_async();
      __syncthreads();  // x_s^T is written
      state_tile<N>(st, sm.hdt, sm.rows, sm.scale + k * kTile);
      __syncthreads();  // every warp is done with the tiles
      issue(n + 1);
    }
  }

  // ---- chunks in reverse: dS, from d_final_state ---------------------- //
  load_state<N>(st, dfinal, st_off, r0, c0, P, Ns);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int lc = min(chunk, L - t0);
    const int nt = (lc + kTile - 1) / kTile;
    chunk_scan(dtb + static_cast<size_t>(t0) * H, H, lc, a, sm.cum, sm.dts,
               sm.wsum);
    const double cl = sm.cum[nt * kTile - 1];
    for (int i = tid; i < nt * kTile; i += kThreads)
      sm.scale[i] = expf(static_cast<float>(sm.cum[i]));
    const size_t o = (bh * nc + c) * kH * kItem;
    store_t_items<N>(dst + o, st, r0, c0);
    store_items<N>(ds + o, st, r0, c0);
    // <dS, S_prev>, S_prev as its hi + lo, read back from this thread's
    // own stores of the forward pass
    float part = 0.f;
#pragma unroll
    for (int hh = 0; hh < kH; ++hh)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* sp = spt + o + hh * kItem + swz(r0 + 8 * r, 8 * i + c0);
          const float2 hi = *reinterpret_cast<const float2*>(sp);
          const float2 lo =
              *reinterpret_cast<const float2*>(sp + kTile * kHalf);
          part = fmaf(st[hh][4 * i + 2 * r], hi.x + lo.x, part);
          part = fmaf(st[hh][4 * i + 2 * r + 1], hi.y + lo.y, part);
        }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) sm.red[warp] = part;
    const float dl = expf(static_cast<float>(cl));
#pragma unroll
    for (int hh = 0; hh < kH; ++hh)
#pragma unroll
      for (int j = 0; j < 32; ++j) st[hh][j] *= dl;
    __syncthreads();  // scale, red
    if (tid == 0)
      dss[bh * nc + c] = (sm.red[0] + sm.red[1]) + (sm.red[2] + sm.red[3]);
    for (int k = 0; k < nt; ++k, ++n) {
      mbar_wait(&sm.full, n & 1);
      state_tile<N>(st, sm.hdt, sm.rows, sm.scale + k * kTile);
      __syncthreads();  // every warp is done with the tiles
      issue(n + 1);
    }
  }
}

// ------------------------------------------------------------ dx and dB --

template <int N>
struct DxdbSmem {
  float ring[kStages][kItem];
  float bs[kTile * N];                    // B_s raw [s][n]
  float xs[kTile * kP];                   // x_s raw [s][p] of the head
  float g[kMaxTiles][32 * kThreads];      // G^T of each t tile, as it lies
  double cum[2][kMaxChunk];               // a head's cum over the chunk and
  float dts[2][kMaxChunk];                // dt, this head's and the next's
  float ft[kThreads / 32][kMaxChunk];     // per warp: exp(cum_t - cum_ref)
  uint64_t bs_full, xs_full;
  uint64_t full[kStages];
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_tf32_dxdb_kernel(__grid_constant__ const CUtensorMap map_x,
                         __grid_constant__ const CUtensorMap map_b,
                         __grid_constant__ const CUtensorMap map_ch,
                         __grid_constant__ const CUtensorMap map_cl,
                         __grid_constant__ const CUtensorMap map_dy,
                         __grid_constant__ const CUtensorMap map_dyt,
                         __grid_constant__ const CUtensorMap map_ct,
                         const float* __restrict__ dt,
                         const double* __restrict__ cum,
                         const float* __restrict__ ds,
                         const float* __restrict__ dst, float* __restrict__ dx,
                         float* __restrict__ ddi, float* __restrict__ dds,
                         float* __restrict__ db_part, int B, int L, int H,
                         int chunk, int group, int P) {
  constexpr int kH = N / kHalf;
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
  const int Lp = nc * chunk;
  // the items, in the order they are used: C_t halves (G^T, t tile by t
  // tile); per head dS halves, dS^T halves, then per t tile dy_t, dy_t^T
  // and the C_t^T halves
  const int pre = ntj * kH;
  const int per_head = 2 * kH + ntj * (2 + kH);
  const int items = pre + hn * per_head;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);

  if (tid == 0) {
    mbar_init(&sm.bs_full, 1);
    mbar_init(&sm.xs_full, 1);
    for (int i = 0; i < kStages; ++i) mbar_init(&sm.full[i], 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int n) {
    if (tid != 0 || n >= items) return;
    float* dst_ = sm.ring[n % kStages];
    uint64_t* bar = &sm.full[n % kStages];
    if (n < pre) {
      load_pair(dst_, &map_ch, &map_cl, bar, (n % kH) * kHalf, 0,
                t0c + (j + n / kH) * kTile, b);
      return;
    }
    const int m = n - pre;
    const int h = h0 + m / per_head;
    int r = m % per_head;
    if (r < 2 * kH) {
      const float* src = r < kH ? ds : dst;
      load_item(dst_,
                src + ((static_cast<size_t>(b) * H + h) * nc + it.c) * kH *
                          kItem + (r % kH) * kItem,
                bar);
      return;
    }
    r -= 2 * kH;
    const int row = t0c + (j + r / (2 + kH)) * kTile;
    r %= 2 + kH;
    if (r == 0)
      load_raw(dst_, &map_dy, bar, kP, h, row, b);
    else if (r == 1)
      load_t(dst_, &map_dyt, bar, 0, h, row, b);
    else
      load_t(dst_, &map_ct, bar, (r - 2) * kHalf, 0, row, b);
  };
  auto wait_item = [&](int k) -> float* {
    mbar_wait(&sm.full[k % kStages], (k / kStages) & 1);
    return sm.ring[k % kStages];
  };
  // items k .. k + count - 1 are done with: their stages take the next
  auto release = [&](int k, int count) {
    __syncthreads();
    for (int i = 0; i < count; ++i) issue(k + i + kStages);
  };

  if (tid == 0) {
    load_raw(sm.bs, &map_b, &sm.bs_full, N, 0, s0, b);
    load_raw(sm.xs, &map_x, &sm.xs_full, kP, h0, s0, b);
  }
  for (int i = 0; i < kStages; ++i) issue(i);
  // the rows of head hh (local) of the group into buffer hh % 2
  auto prefetch = [&](int hh) {
    const size_t bh = static_cast<size_t>(b) * H + h0 + hh;
    prefetch_rows(sm.cum[hh & 1], sm.dts[hh & 1], cum + bh * Lp + t0c,
                  dt + (static_cast<size_t>(b) * L + t0c) * H + h0 + hh,
                  nt * kTile, L - t0c, H);
  };
  prefetch(0);
  mbar_wait(&sm.bs_full, 0);
  int n = 0;

  // ---- G^T [s, t] = B_s . C_t^T of each t tile, once for the group ---- //
  for (int ii = 0; ii < ntj; ++ii) {
    float g[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) g[q] = 0.f;
#pragma unroll
    for (int hf = 0; hf < kH; ++hf, ++n) {
      product<false>(g, wait_item(n), [&](Frag& hi, Frag& lo, int k4) {
        raw_a(hi, lo, sm.bs, hf * kHalf, k4);
      });
      release(n, 1);
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) sm.g[ii][q * kThreads + tid] = g[q];
  }

  float db[kH][32];
#pragma unroll
  for (int hf = 0; hf < kH; ++hf)
#pragma unroll
    for (int q = 0; q < 32; ++q) db[hf][q] = 0.f;

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const size_t bh = static_cast<size_t>(b) * H + h;
    cp_wait();
    __syncthreads();  // the head's rows are in, the previous head is done
    if (hh + 1 < hn) prefetch(hh + 1);
    const double* cumh = sm.cum[hh & 1];
    const float* dtsh = sm.dts[hh & 1];
    const double cl = cumh[nt * kTile - 1];
    // the decay of a pair s <= t, factorised at the warp's last row ref
    // (cum_t <= cum_ref <= cum_s for s <= ref <= t, so neither factor
    // exceeds 1): exp(cum_t - cum_ref) exp(cum_ref - cum_s), each from an
    // fp64 difference; the pairs on the warp's own 16-row diagonal block
    // take exp(cum_t - cum_s) directly
    const int ref = j * kTile + 16 * warp + 15;
    const double cref = cumh[ref];
    float* ft = sm.ft[warp];
    for (int t = ref + 1 + lane; t < nt * kTile; t += 32)
      ft[t] = expf(static_cast<float>(cumh[t] - cref));
    __syncwarp();
    double cs[2];
    float e[2], w[2], dtr[2], fs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sl = j * kTile + r0 + 8 * r;
      cs[r] = cumh[sl];
      dtr[r] = dtsh[sl];
      e[r] = expf(static_cast<float>(cl - cs[r]));
      w[r] = e[r] * dtr[r];
      fs[r] = expf(static_cast<float>(cref - cs[r]));
    }

    // ---- state terms: V = B_s . dS^T starts dx_s; x_s . dS adds to dB_s
    mbar_wait(&sm.xs_full, hh & 1);
    float dxa[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) dxa[q] = 0.f;
#pragma unroll
    for (int hf = 0; hf < kH; ++hf, ++n) {
      product<false>(dxa, wait_item(n), [&](Frag& hi, Frag& lo, int k4) {
        raw_a(hi, lo, sm.bs, hf * kHalf, k4);
      });
      release(n, 1);
    }
#pragma unroll
    for (int hf = 0; hf < kH; ++hf, ++n) {
      float tmp[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) tmp[q] = 0.f;
      product<false>(tmp, wait_item(n), [&](Frag& hi, Frag& lo, int k4) {
        raw_a(hi, lo, sm.xs, 0, k4);
      });
      release(n, 1);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          db[hf][4 * i + q] += w[q >> 1] * tmp[4 * i + q];
    }
    float dsv[2] = {0.f, 0.f};  // x_s . V_s
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 xv = *reinterpret_cast<const float2*>(
            sm.xs + swz(r0 + 8 * r, 8 * i + c0));
        dsv[r] = fmaf(xv.x, dxa[4 * i + 2 * r], dsv[r]);
        dsv[r] = fmaf(xv.y, dxa[4 * i + 2 * r + 1], dsv[r]);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) dxa[4 * i + q] *= w[q >> 1];

    // ---- the pairs t >= s of the chunk ---------------------------------- //
    float ddv[2] = {0.f, 0.f};  // sum_t G L M
    for (int ii = 0; ii < ntj; ++ii) {
      const int tt = (j + ii) * kTile;  // the t tile's first chunk row
      float m[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) m[q] = 0.f;
      float* dyt = wait_item(n);                 // dy_t raw: split it
      split_in_place(dyt);
      product<false>(m, dyt, [&](Frag& hi, Frag& lo, int k4) {
        raw_a(hi, lo, sm.xs, 0, k4);
      });                                        // M^T [s, t]
      release(n, 1);
      ++n;
      float g[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) g[q] = sm.g[ii][q * kThreads + tid];
      // the 16-column blocks right of the warp's rows (every block of a
      // later t tile) take the factorised decay, the warp's own 16 x 16
      // block the direct one, masked to t >= s, and the blocks left of it
      // are zero; each branch is uniform across the warp
      const bool diag = ii == 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int blk = diag ? i / 2 - warp : 1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q >> 1;
          const int tl = tt + 8 * i + c0 + (q & 1);
          float lv = 0.f;
          if (blk > 0)
            lv = ft[tl] * fs[r];
          else if (blk == 0 && tl >= j * kTile + r0 + 8 * r)
            lv = expf(static_cast<float>(cumh[tl] - cs[r]));
          const float gl = g[4 * i + q] * lv;
          ddv[r] = fmaf(gl, m[4 * i + q], ddv[r]);
          g[4 * i + q] = gl * dtr[r];
          m[4 * i + q] = m[4 * i + q] * lv * dtr[r];
        }
      }
      // dx_s += (G^T L dt) . dy_t; dB_s += (M^T L dt) . C_t by n halves
      product<true>(dxa, wait_item(n), [&](Frag& hi, Frag& lo, int k4) {
        acc_a(hi, lo, g, k4);
      });
      product<true>(db[0], wait_item(n + 1), [&](Frag& hi, Frag& lo, int k4) {
        acc_a(hi, lo, m, k4);
      });
      release(n, 2);
      n += 2;
      if (kH == 2) {
        product<true>(db[kH - 1], wait_item(n),
                      [&](Frag& hi, Frag& lo, int k4) {
                        acc_a(hi, lo, m, k4);
                      });
        release(n, 1);
        ++n;
      }
    }
    // every warp is done with x_s (the last release synchronised)
    if (tid == 0 && hh + 1 < hn)
      load_raw(sm.xs, &map_x, &sm.xs_full, kP, h + 1, s0, b);

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
        float* o = dx + ((static_cast<size_t>(b) * L + s) * H + h) * P;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (8 * i < P)
            *reinterpret_cast<float2*>(o + 8 * i + c0) =
                make_float2(dxa[4 * i + 2 * r], dxa[4 * i + 2 * r + 1]);
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
    for (int hf = 0; hf < kH; ++hf)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float2*>(o + hf * kHalf + 8 * i + c0) =
            make_float2(db[hf][4 * i + 2 * r], db[hf][4 * i + 2 * r + 1]);
  }
}

// ------------------------------------------------------------------ dC --

template <int N>
struct DcSmem {
  float ring[kStages][kItem];
  float ct[kTile * N];                    // C_t raw [t][n]
  float dy[kTile * kP];                   // dy_t raw [t][p] of the head
  float g[kMaxTiles][32 * kThreads];      // G of each s tile, as it lies
  double cum[2][kMaxChunk];               // a head's cum and dt over the
  float dts[2][kMaxChunk];                // chunk, this head's and the next's
  float es[kThreads / 32][kMaxChunk];     // per warp: exp(cum_ref - cum_s) dt_s
  uint64_t ct_full, dy_full;
  uint64_t full[kStages];
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_tf32_dc_kernel(__grid_constant__ const CUtensorMap map_c,
                       __grid_constant__ const CUtensorMap map_dy,
                       __grid_constant__ const CUtensorMap map_bh,
                       __grid_constant__ const CUtensorMap map_bl,
                       __grid_constant__ const CUtensorMap map_x,
                       __grid_constant__ const CUtensorMap map_bt,
                       const float* __restrict__ dt,
                       const double* __restrict__ cum,
                       const float* __restrict__ spt,
                       float* __restrict__ rowe, float* __restrict__ dc_part,
                       int B, int L, int H, int chunk, int group) {
  constexpr int kH = N / kHalf;
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
  const int Lp = nc * chunk;
  // the items, in the order they are used: B_s halves (G, s tile by s
  // tile); per head the S_prev^T halves, then per s tile x_s and the B_s^T
  // halves
  const int pre = nsi * kH;
  const int per_head = kH + nsi * (1 + kH);
  const int items = pre + hn * per_head;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);

  if (tid == 0) {
    mbar_init(&sm.ct_full, 1);
    mbar_init(&sm.dy_full, 1);
    for (int k = 0; k < kStages; ++k) mbar_init(&sm.full[k], 1);
    fence_barrier_init();
  }
  __syncthreads();

  auto issue = [&](int n) {
    if (tid != 0 || n >= items) return;
    float* dst_ = sm.ring[n % kStages];
    uint64_t* bar = &sm.full[n % kStages];
    if (n < pre) {
      load_pair(dst_, &map_bh, &map_bl, bar, (n % kH) * kHalf, 0,
                t0c + (n / kH) * kTile, b);
      return;
    }
    const int m = n - pre;
    const int h = h0 + m / per_head;
    int r = m % per_head;
    if (r < kH) {
      load_item(dst_,
                spt + ((static_cast<size_t>(b) * H + h) * nc + it.c) * kH *
                          kItem + r * kItem,
                bar);
      return;
    }
    r -= kH;
    const int row = t0c + (r / (1 + kH)) * kTile;
    r %= 1 + kH;
    if (r == 0)
      load_raw(dst_, &map_x, bar, kP, h, row, b);
    else
      load_t(dst_, &map_bt, bar, (r - 1) * kHalf, 0, row, b);
  };
  auto wait_item = [&](int k) -> float* {
    mbar_wait(&sm.full[k % kStages], (k / kStages) & 1);
    return sm.ring[k % kStages];
  };
  auto release = [&](int k) {
    __syncthreads();
    issue(k + kStages);
  };

  if (tid == 0) {
    load_raw(sm.ct, &map_c, &sm.ct_full, N, 0, t0, b);
    load_raw(sm.dy, &map_dy, &sm.dy_full, kP, h0, t0, b);
  }
  for (int k = 0; k < kStages; ++k) issue(k);
  // the rows of head hh (local) of the group into buffer hh % 2
  auto prefetch = [&](int hh) {
    const size_t bh = static_cast<size_t>(b) * H + h0 + hh;
    prefetch_rows(sm.cum[hh & 1], sm.dts[hh & 1], cum + bh * Lp + t0c,
                  dt + (static_cast<size_t>(b) * L + t0c) * H + h0 + hh,
                  nsi * kTile, L - t0c, H);
  };
  prefetch(0);
  mbar_wait(&sm.ct_full, 0);
  int n = 0;

  // ---- G [t, s] = C_t . B_s^T of each s tile, once for the group ------ //
  for (int jj = 0; jj < nsi; ++jj) {
    float g[32];
#pragma unroll
    for (int q = 0; q < 32; ++q) g[q] = 0.f;
#pragma unroll
    for (int hf = 0; hf < kH; ++hf, ++n) {
      product<false>(g, wait_item(n), [&](Frag& hi, Frag& lo, int k4) {
        raw_a(hi, lo, sm.ct, hf * kHalf, k4);
      });
      release(n);
    }
#pragma unroll
    for (int q = 0; q < 32; ++q) sm.g[jj][q * kThreads + tid] = g[q];
  }

  float dc[kH][32];
#pragma unroll
  for (int hf = 0; hf < kH; ++hf)
#pragma unroll
    for (int q = 0; q < 32; ++q) dc[hf][q] = 0.f;

  for (int hh = 0; hh < hn; ++hh) {
    const int h = h0 + hh;
    const size_t bh = static_cast<size_t>(b) * H + h;
    cp_wait();
    __syncthreads();  // the head's rows are in, the previous head is done
    if (hh + 1 < hn) prefetch(hh + 1);
    const double* cumh = sm.cum[hh & 1];
    const float* dtsh = sm.dts[hh & 1];
    // the decay of a pair s <= t, factorised at the warp's first row ref,
    // as the dx/dB kernel's: exp(cum_t - cum_ref) (exp(cum_ref - cum_s)
    // dt_s) off the warp's own 16-row diagonal block, both factors <= 1
    const int ref = i * kTile + 16 * warp;
    const double cref = cumh[ref];
    float* es = sm.es[warp];
    for (int q = lane; q < ref; q += 32)
      es[q] = expf(static_cast<float>(cref - cumh[q])) * dtsh[q];
    __syncwarp();
    double ctr[2];
    float ec[2], et[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ctr[r] = cumh[i * kTile + r0 + 8 * r];
      ec[r] = expf(static_cast<float>(ctr[r]));
      et[r] = expf(static_cast<float>(ctr[r] - cref));
    }

    // ---- state term: dC_t += exp(cum_t) (dy_t . S_prev), E_t ----------- //
    mbar_wait(&sm.dy_full, hh & 1);
    float ev[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < kH; ++hf, ++n) {
      float tmp[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) tmp[q] = 0.f;
      product<false>(tmp, wait_item(n), [&](Frag& hi, Frag& lo, int k4) {
        raw_a(hi, lo, sm.dy, 0, k4);
      });
      release(n);
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 cv = *reinterpret_cast<const float2*>(
              sm.ct + swz(r0 + 8 * r, hf * kHalf + 8 * q + c0));
          ev[r] = fmaf(cv.x, tmp[4 * q + 2 * r], ev[r]);
          ev[r] = fmaf(cv.y, tmp[4 * q + 2 * r + 1], ev[r]);
          dc[hf][4 * q + 2 * r] += ec[r] * tmp[4 * q + 2 * r];
          dc[hf][4 * q + 2 * r + 1] += ec[r] * tmp[4 * q + 2 * r + 1];
        }
    }

    // ---- the pairs s <= t of the chunk ---------------------------------- //
    float rowv[2] = {0.f, 0.f};  // sum_s G L M dt_s
    for (int jj = 0; jj < nsi; ++jj) {
      float m[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) m[q] = 0.f;
      float* xs = wait_item(n);                  // x_s raw: split it
      split_in_place(xs);
      product<false>(m, xs, [&](Frag& hi, Frag& lo, int k4) {
        raw_a(hi, lo, sm.dy, 0, k4);
      });                                        // M [t, s]
      release(n);
      ++n;
      float g[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) g[q] = sm.g[jj][q * kThreads + tid];
      // the 16-column blocks left of the warp's rows (every block of an
      // earlier s tile) take the factorised decay, the warp's own 16 x 16
      // block the direct one, masked to s <= t, and the blocks right of it
      // are zero; each branch is uniform across the warp
      const bool diag = jj == i;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int blk = diag ? k / 2 - warp : -1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = q >> 1;
          const int sl = jj * kTile + 8 * k + c0 + (q & 1);
          float ld = 0.f;  // L_ts dt_s
          if (blk < 0)
            ld = et[r] * es[sl];
          else if (blk == 0 && sl <= i * kTile + r0 + 8 * r)
            ld = expf(static_cast<float>(ctr[r] - cumh[sl])) * dtsh[sl];
          rowv[r] = fmaf(g[4 * k + q] * ld, m[4 * k + q], rowv[r]);
          m[4 * k + q] = m[4 * k + q] * ld;
        }
      }
      // dC_t += (M L dt) . B_s by n halves
#pragma unroll
      for (int hf = 0; hf < kH; ++hf, ++n) {
        product<true>(dc[hf], wait_item(n), [&](Frag& hi, Frag& lo, int k4) {
          acc_a(hi, lo, m, k4);
        });
        release(n);
      }
    }
    // every warp is done with dy_t (the last release synchronised)
    if (tid == 0 && hh + 1 < hn)
      load_raw(sm.dy, &map_dy, &sm.dy_full, kP, h + 1, t0, b);

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
    for (int hf = 0; hf < kH; ++hf)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        *reinterpret_cast<float2*>(o + hf * kHalf + 8 * q + c0) =
            make_float2(dc[hf][4 * q + 2 * r], dc[hf][4 * q + 2 * r + 1]);
  }
}

// ---------------------------------------------------------------- host --

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Scratch {
  float *dyt, *bm_pair, *cm_pair, *bmt, *cmt;
  double* cum;
  float *spt, *ds, *dst, *dss, *rowe, *ddi, *dds, *db_part, *dc_part,
      *da_part;
};

template <int N>
int launch_n(const float* x, const float* dt, const float* A, const float* Bm,
             const float* Cm, const float* init, const float* dy,
             const float* dfinal, float* dx, float* ddt, float* dA, float* dBm,
             float* dCm, const Scratch& w, int B, int L, int H, int P, int Ns,
             int chunk, int group, cudaStream_t stream) {
  // the pre-pass: dy transposed, Bm and Cm direct and transposed, split
  // once, at their true widths (one launch when they are equal)
  SplitJobs jobs = {};
  jobs.job[0] = {dy, nullptr, w.dyt, nullptr, nullptr, H};
  SplitJobs rows = {};
  rows.job[0] = {Bm, w.bm_pair, w.bmt, nullptr, nullptr, 1};
  rows.job[1] = {Cm, w.cm_pair, w.cmt, nullptr, nullptr, 1};
  if (Ns == P) {
    jobs.job[1] = rows.job[0];
    jobs.job[2] = rows.job[1];
    jobs.n = 3;
    if (int e = launch_split_at<8, 16, 32, 64>(P, jobs, B, L, stream))
      return e;
  } else {
    jobs.n = 1;
    rows.n = 2;
    if (int e = launch_split_at<8, 16, 32, 64>(P, jobs, B, L, stream))
      return e;
    if (int e = launch_split_at<8, 16, 32, 64, 128>(Ns, rows, B, L, stream))
      return e;
  }

  const size_t nb = static_cast<size_t>(B) * L * Ns;
  CUtensorMap mx{}, mdy{}, mb{}, mc{};          // raw
  CUtensorMap mbh{}, mbl{}, mch{}, mcl{};       // direct pairs
  CUtensorMap mdyt{}, mbt{}, mct{};             // transposed splits
  int r = 0;
  if ((r = map_rows(&mx, x, B, L, H, P, kTile)) ||
      (r = map_rows(&mdy, dy, B, L, H, P, kTile)) ||
      (r = map_rows(&mb, Bm, B, L, 1, Ns, kTile)) ||
      (r = map_rows(&mc, Cm, B, L, 1, Ns, kTile)) ||
      (r = map_rows(&mbh, w.bm_pair, B, L, 1, Ns, kTile)) ||
      (r = map_rows(&mbl, w.bm_pair + nb, B, L, 1, Ns, kTile)) ||
      (r = map_rows(&mch, w.cm_pair, B, L, 1, Ns, kTile)) ||
      (r = map_rows(&mcl, w.cm_pair + nb, B, L, 1, Ns, kTile)) ||
      (r = map_transposed(&mdyt, w.dyt, B, L, H, P, kP)) ||
      (r = map_transposed(&mbt, w.bmt, B, L, 1, Ns, kHalf)) ||
      (r = map_transposed(&mct, w.cmt, B, L, 1, Ns, kHalf)))
    return r;
  const int nc = (L + chunk - 1) / chunk;
  const int ng = (H + group - 1) / group;
  const int tiles = (chunk / kTile) * nc * B * ng;

  const size_t smem_state = sizeof(StateSmem<N>) + 1024;
  if (int e = set_smem(ssd_bwd_tf32_state_kernel<N>, smem_state)) return e;
  ssd_bwd_tf32_state_kernel<N><<<B * H, kThreads, smem_state, stream>>>(
      mb, mc, mx, mdyt, dt, A, init, dfinal, w.cum, w.spt, w.ds, w.dst,
      w.dss, L, H, chunk, P, Ns);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  const size_t smem_dxdb = sizeof(DxdbSmem<N>) + 1024;
  if (int e = set_smem(ssd_bwd_tf32_dxdb_kernel<N>, smem_dxdb)) return e;
  ssd_bwd_tf32_dxdb_kernel<N><<<tiles, kThreads, smem_dxdb, stream>>>(
      mx, mb, mch, mcl, mdy, mdyt, mct, dt, w.cum, w.ds, w.dst, dx,
      w.ddi, w.dds, w.db_part, B, L, H, chunk, group, P);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  const size_t smem_dc = sizeof(DcSmem<N>) + 1024;
  if (int e = set_smem(ssd_bwd_tf32_dc_kernel<N>, smem_dc)) return e;
  ssd_bwd_tf32_dc_kernel<N><<<tiles, kThreads, smem_dc, stream>>>(
      mc, mdy, mbh, mbl, mx, mbt, dt, w.cum, w.spt, w.rowe,
      w.dc_part, B, L, H, chunk, group);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  return launch_finish_and_sum<float>(dt, A, w.cum, w.dss, w.rowe, w.ddi,
                                      w.dds, ddt, w.da_part, w.db_part,
                                      w.dc_part, dBm, dCm, dA, B, L, H, Ns,
                                      N, chunk, ng, stream);
}

}  // namespace

// x, dy, dx: [B,L,H,P]; Bm, Cm, dBm, dCm: [B,L,N]; dt, ddt: [B,L,H]; A, dA:
// [H]; init and dfinal (either may be null: zero) [B,H,P,N]; all float32.
// Scratch (L16 = L rounded up to 16, nc = ceil(L / chunk), Lp = nc *
// chunk, ng = ceil(H / group), NP = N padded to 64 or 128, kH = NP / 64;
// ops.py::tf32_bwd_scratch): dyt [B,H,P,2*L16]; bm_pair, cm_pair
// [2,B,L,N]; bmt, cmt [B,N,2*L16]; cum [B,H,Lp] float64; spt, ds, dst
// [B,H,nc,kH,2,64,64]; dss [B,H,nc]; rowe, ddi, dds [B,H,Lp]; db_part,
// dc_part [B,ng,L,NP]; da_part [B,H];
// float32 but cum.  Every tensor
// contiguous and 16-byte aligned.  Launches the pre-pass, the state, dx/dB,
// dC, finish and sum kernels in that order on `stream`.  Returns 0 or the
// first cudaError_t (a launch's, or the tensor maps').
extern "C" int ssd_scan_bwd_tf32_launch(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* init, const void* dy, const void* dfinal,
    void* dx, void* ddt, void* dA, void* dBm, void* dCm, void* dyt,
    void* bm_pair, void* cm_pair, void* bmt, void* cmt, void* cum,
    void* spt, void* ds, void* dst, void* dss, void* rowe, void* ddi,
    void* dds, void* db_part, void* dc_part, void* da_part, int B, int L,
    int H, int P, int N, int chunk, int group, void* stream) {
  if (!flare::ssd_head_dim(P) || !flare::ssd_state_dim(N) ||
      chunk % kTile != 0 || chunk < kTile || chunk > kMaxChunk || L < 0 ||
      B < 0 || H < 0 || group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || L == 0)
    return static_cast<int>(
        cudaMemsetAsync(dA, 0, static_cast<size_t>(H) * sizeof(float), s));
  const Scratch w = {
      static_cast<float*>(dyt),
      static_cast<float*>(bm_pair), static_cast<float*>(cm_pair),
      static_cast<float*>(bmt),     static_cast<float*>(cmt),
      static_cast<double*>(cum),    static_cast<float*>(spt),
      static_cast<float*>(ds),      static_cast<float*>(dst),
      static_cast<float*>(dss),     static_cast<float*>(rowe),
      static_cast<float*>(ddi),     static_cast<float*>(dds),
      static_cast<float*>(db_part), static_cast<float*>(dc_part),
      static_cast<float*>(da_part)};
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  const float* sf = static_cast<const float*>(init);
  const float* dyf = static_cast<const float*>(dy);
  const float* df = static_cast<const float*>(dfinal);
  float* o[5] = {static_cast<float*>(dx), static_cast<float*>(ddt),
                 static_cast<float*>(dA), static_cast<float*>(dBm),
                 static_cast<float*>(dCm)};
  if (N > 64)
    return launch_n<128>(xf, dtf, af, bf, cf, sf, dyf, df, o[0], o[1], o[2],
                         o[3], o[4], w, B, L, H, P, N, chunk, group, s);
  return launch_n<64>(xf, dtf, af, bf, cf, sf, dyf, df, o[0], o[1], o[2],
                      o[3], o[4], w, B, L, H, P, N, chunk, group, s);
}
