// The pre-pass of the split-TF32 kernels (flash_attention_tf32.cu,
// flash_attention_bwd_tf32.cu, ssd_scan_tf32.cu, ssd_scan_bwd_tf32.cu): fp32
// operands split once into tf32 hi and lo terms, in the layouts their wgmma
// products read by TMA.
//
// A tf32 wgmma operand must be K-major in shared memory, so a product that
// reduces over the sequence (P.V, dS.K, P^T.dO, dS^T.Q) reads its B
// operand transposed, the sequence contiguous.  Operands that many blocks
// read again (K and V tiles are read by every q tile of every head of a
// group) are split here once, not in each block:
//   * direct: x [B,S,heads,hd] -> pair [2][B,S,heads,hd], hi then lo;
//   * transposed: x -> t [B,heads,hd,2*S16] (S16 = S rounded up to 16):
//     for each 16-row block j of the sequence, 32 floats, the 16 rows' hi
//     terms then their lo terms, so that one 128-byte swizzle row of a TMA
//     box holds a 16-row block's hi and lo and a k8 step reads its hi at
//     byte 32·(k%2) and its lo at 64 + 32·(k%2).  Within each 8 rows the
//     order is 0,2,4,6,1,3,5,7: the tf32 A fragment of a k8 step holds
//     columns l%4 and l%4 + 4 in lane l, where the fp32 accumulator that
//     becomes it (P, dS) holds columns 2(l%4) and 2(l%4) + 1, so the B rows
//     are permuted to match and the accumulator serves as A as it lies.
//     Rows >= S are zero.
// With `o` and `delta` given (x = dO), also delta[b,h,s] = sum_d dO * O in
// fp32, the backward's row term.

#pragma once

#include "hopper.cuh"

namespace flare {
namespace tf32x3 {

constexpr int kSplitRows = 64;      // sequence rows of a block
constexpr int kSplitThreads = 256;

__host__ __device__ constexpr int s16(int S) { return (S + 15) / 16 * 16; }

// the row of the 16-row block that position p (0..15) of the transposed
// layout holds
__device__ __forceinline__ int permuted_row(int p) {
  return (p & 8) | ((p & 3) << 1) | ((p >> 2) & 1);
}

struct SplitJob {
  const float* x;      // [B,S,heads,hd]
  float* pair;         // [2][B,S,heads,hd] hi then lo, or null
  float* t;            // [B,heads,hd,2*S16], or null
  const float* o;      // with delta: O [B,S,heads,hd] (x is dO), or null
  float* delta;        // [B,heads,S], or null
  int heads;
};

struct SplitJobs {
  SplitJob job[4];
  int n;
};

// grid (B * max heads * ceil(S / 64), jobs): block (b, h, 64-row chunk)
// of job blockIdx.y; each thread splits 4 elements at a time
template <int HD>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const SplitJobs jobs, int B, int S, int max_heads) {
  __shared__ float tile[kSplitRows][HD + 1];
  const SplitJob& jb = jobs.job[blockIdx.y];
  const int chunks = (S + kSplitRows - 1) / kSplitRows;
  const int chunk = blockIdx.x % chunks;
  const int h = (blockIdx.x / chunks) % max_heads;
  const int b = blockIdx.x / (chunks * max_heads);
  if (h >= jb.heads) return;
  const int s0 = chunk * kSplitRows;
  const size_t n = static_cast<size_t>(B) * S * jb.heads * HD;

  for (int i = threadIdx.x; i < kSplitRows * HD / 4; i += kSplitThreads) {
    const int r = i / (HD / 4);
    const int d = (i % (HD / 4)) * 4;
    const int s = s0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      const size_t off = ((static_cast<size_t>(b) * S + s) * jb.heads + h) *
                             HD + d;
      x = *reinterpret_cast<const float4*>(jb.x + off);
      if (jb.pair != nullptr) {
        uint4 hi, lo;
        hopper::split_tf32(x.x, hi.x, lo.x);
        hopper::split_tf32(x.y, hi.y, lo.y);
        hopper::split_tf32(x.z, hi.z, lo.z);
        hopper::split_tf32(x.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(jb.pair + off) = hi;
        *reinterpret_cast<uint4*>(jb.pair + n + off) = lo;
      }
    }
    tile[r][d] = x.x;
    tile[r][d + 1] = x.y;
    tile[r][d + 2] = x.z;
    tile[r][d + 3] = x.w;
  }
  __syncthreads();

  if (jb.delta != nullptr) {
    // a warp per row: delta = sum_d dO * O
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    for (int r = warp; r < kSplitRows; r += kSplitThreads / 32) {
      const int s = s0 + r;
      if (s >= S) break;
      const float* orow =
          jb.o + ((static_cast<size_t>(b) * S + s) * jb.heads + h) * HD;
      float acc = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) acc = fmaf(tile[r][d], orow[d], acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0)
        jb.delta[(static_cast<size_t>(b) * jb.heads + h) * S + s] = acc;
    }
  }

  if (jb.t != nullptr) {
    // per dim, each 16-row block of the chunk as 32 floats (hi, then lo):
    // a thread takes 4 positions p0..p0+3 of a block, their hi at p0 and
    // their lo at 16 + p0
    const int row_len = 2 * s16(S);
    constexpr int kGroups = kSplitRows / 4;        // per dim
    for (int i = threadIdx.x; i < HD * kGroups; i += kSplitThreads) {
      const int d = i / kGroups;
      const int blk = (i % kGroups) / 4;
      const int p0 = (i % 4) * 4;
      const int col = 2 * s0 + blk * 32 + p0;
      if (col >= row_len) continue;
      uint4 hi, lo;
      hopper::split_tf32(tile[blk * 16 + permuted_row(p0)][d], hi.x, lo.x);
      hopper::split_tf32(tile[blk * 16 + permuted_row(p0 + 1)][d], hi.y,
                         lo.y);
      hopper::split_tf32(tile[blk * 16 + permuted_row(p0 + 2)][d], hi.z,
                         lo.z);
      hopper::split_tf32(tile[blk * 16 + permuted_row(p0 + 3)][d], hi.w,
                         lo.w);
      float* row =
          jb.t + ((static_cast<size_t>(b) * jb.heads + h) * HD + d) * row_len;
      *reinterpret_cast<uint4*>(row + col) = hi;
      *reinterpret_cast<uint4*>(row + col + 16) = lo;
    }
  }
}

// launches split_kernel over `jobs` on `stream`; 0 or a cudaError_t
template <int HD>
int launch_split(const SplitJobs& jobs, int B, int S, cudaStream_t stream) {
  int max_heads = 0;
  for (int i = 0; i < jobs.n; ++i)
    max_heads = jobs.job[i].heads > max_heads ? jobs.job[i].heads : max_heads;
  const int chunks = (S + kSplitRows - 1) / kSplitRows;
  split_kernel<HD><<<dim3(B * max_heads * chunks, jobs.n), kSplitThreads, 0,
                     stream>>>(jobs, B, S, max_heads);
  return static_cast<int>(cudaGetLastError());
}

// launch_split at a width taken at run time, one of the instances W, Rest
// that the caller names (the SSD scan's head_dim and state width);
// cudaErrorInvalidValue for any other
template <int W, int... Rest>
int launch_split_at(int width, const SplitJobs& jobs, int B, int S,
                    cudaStream_t stream) {
  if (width == W) return launch_split<W>(jobs, B, S, stream);
  if constexpr (sizeof...(Rest) > 0)
    return launch_split_at<Rest...>(width, jobs, B, S, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// [B,S,heads,hd] fp32 (a direct split term) as a 4-D tensor map (hd,
// heads, S, B) with a box of (32, 1, rows, 1)
inline int map_rows(CUtensorMap* map, const void* p, int B, int S, int heads,
                    int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 4;
  const cuuint64_t strides[3] = {row, row * heads,
                                 row * heads * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  return hopper::make_map_f32(map, p, 4, dims, strides, box);
}

// the transposed split [B,heads,hd,2*S16] as a 4-D tensor map (2*S16, hd,
// heads, B) with a box of (32, rows, 1, 1): one 16-row block, hi and lo, of
// `rows` dims (rows 0: every dim)
inline int map_transposed(CUtensorMap* map, const void* p, int B, int S,
                          int heads, int hd, int rows = 0) {
  const cuuint64_t len = 2 * static_cast<cuuint64_t>(s16(S));
  const cuuint64_t dims[4] = {len, static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = len * 4;
  const cuuint64_t strides[3] = {row, row * hd, row * hd * heads};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows ? rows : hd),
                             1, 1};
  return hopper::make_map_f32(map, p, 4, dims, strides, box);
}

// the accumulator fragment of D[64, 8K] as the tf32 A fragments (hi, lo)
// of a product over its 8K columns, each k8 step's B rows in the order of
// `permuted_row`: a[0..3] = columns 2(l%4), 2(l%4) of row + 8, 2(l%4) + 1,
// 2(l%4) + 1 of row + 8 (d[4k], d[4k+2], d[4k+1], d[4k+3])
template <int N2>
__device__ __forceinline__ void split_a(uint32_t (&hi)[N2 / 4][4],
                                        uint32_t (&lo)[N2 / 4][4],
                                        const float (&d)[N2]) {
#pragma unroll
  for (int k = 0; k < N2 / 4; ++k) {
    hopper::split_tf32(d[4 * k], hi[k][0], lo[k][0]);
    hopper::split_tf32(d[4 * k + 2], hi[k][1], lo[k][1]);
    hopper::split_tf32(d[4 * k + 1], hi[k][2], lo[k][2]);
    hopper::split_tf32(d[4 * k + 3], hi[k][3], lo[k][3]);
  }
}

}  // namespace tf32x3
}  // namespace flare
