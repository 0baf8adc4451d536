// Pieces of the SSD-scan backward that do not depend on the operand type,
// shared by its two tensor-core routes (ssd_scan_bwd_wgmma.cu, bf16, and
// ssd_scan_bwd_tf32.cu, fp32 as split TF32): the chunk's cumulative decay
// in fp64, the tile and head-group order of the blocks, the finish kernel
// (dcum, its reverse scan in fp64, ddt and the (b, h) share of dA) and the
// sum kernel (dBm and dCm over the head groups' partials in order, dA over
// the batch in order).  Each route's source includes this header once, into
// its own library; the code sits in an unnamed namespace as theirs does.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 64;       // rows of an s or t tile (wgmma's M)
constexpr int kMaxChunk = 256;
constexpr int kScanThreads = 128;          // chunk_scan: two rows a thread
constexpr int kFinishThreads = kMaxChunk;  // one row a thread

// sum over the four lanes that hold one accumulator row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dt of the chunk's rows [0, lc) (zeros past lc, up to kMaxChunk) into dts
// and the inclusive scan of dt*A, summed in fp64, into cum; two rows a
// thread of kScanThreads.  Starts and ends synchronised.
__device__ __forceinline__ void chunk_scan(const float* dtb, int H, int lc,
                                           float a, double* cum, float* dts,
                                           double* wsum) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int i0 = 2 * tid;
  const float d0 = i0 < lc ? dtb[static_cast<size_t>(i0) * H] : 0.f;
  const float d1 = i0 + 1 < lc ? dtb[static_cast<size_t>(i0 + 1) * H] : 0.f;
  const double v0 = static_cast<double>(d0 * a);
  const double v1 = static_cast<double>(d1 * a);
  double incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  __syncthreads();
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  double base = incl - (v0 + v1);
  for (int j = 0; j < warp; ++j) base += wsum[j];
  cum[i0] = base + v0;
  cum[i0 + 1] = base + v0 + v1;
  dts[i0] = d0;
  dts[i0 + 1] = d1;
  __syncthreads();
}

// a block's (b, s or t tile j of chunk c, head group g), from the grid
// index, the tile the slowest axis so that tile 0 (dx/dB) or the last tile
// (dC), which walk the most tile pairs, go first
struct Item {
  int g, b, c, j;
};
__device__ __forceinline__ Item block_item(int B, int nc, int ng) {
  Item it;
  int idx = blockIdx.x;
  it.g = idx % ng;
  idx /= ng;
  it.b = idx % B;
  idx /= B;
  it.c = idx % nc;
  it.j = idx / nc;
  return it;
}

// A whole-block sum (fixed order: lanes by shuffle, then the warps in
// order); every thread gets it.  The caller syncs before reusing `slot`.
__device__ __forceinline__ double block_sum(double v, double* slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < kFinishThreads / 32; ++w) t += slot[w];
  return t;
}

// dcum = row + E - dt (ddt_intra + ddt_state), with exp(cum_last) <dS,
// S_prev> + sum_s dt_s ddt_state_s at the chunk's last row; da its reverse
// cumsum (fp64); ddt = ddt_intra + ddt_state + A da; the (b, h) share of
// dA = sum dt da.  A block per (b, h), one row a thread.
__global__ void __launch_bounds__(kFinishThreads)
ssd_bwd_finish_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const double* __restrict__ cum,
                      const float* __restrict__ dss,
                      const float* __restrict__ rowe,
                      const float* __restrict__ ddi,
                      const float* __restrict__ dds, float* __restrict__ ddt,
                      float* __restrict__ da_part, int L, int H, int chunk) {
  __shared__ float rowd[kMaxChunk];
  __shared__ double wsum[kFinishThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float a = A[h];
  const int nc = (L + chunk - 1) / chunk;
  const int Lp = nc * chunk;
  const size_t bh = static_cast<size_t>(b) * H + h;
  double dA_acc = 0.0;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * chunk;
    const int lc = min(chunk, L - t0);
    const int nt = (lc + kTile - 1) / kTile;
    const size_t base = bh * Lp + t0;
    float d = 0.f, ri = 0.f, rs = 0.f, re = 0.f;
    if (tid < lc) {
      d = dt[(static_cast<size_t>(b) * L + t0 + tid) * H + h];
      ri = ddi[base + tid];
      rs = dds[base + tid];
      re = rowe[base + tid];
    }
    const double sumF = block_sum(static_cast<double>(d * rs), wsum);
    const double cl = cum[base + nt * kTile - 1];
    float v = 0.f;
    if (tid < lc) {
      v = re - d * (ri + rs);
      if (tid == lc - 1)
        v += expf(static_cast<float>(cl)) * dss[bh * nc + c] +
             static_cast<float>(sumF);
    }
    rowd[tid] = v;
    __syncthreads();
    // reverse inclusive scan: thread tid holds row r = 255 - tid
    const int r = kMaxChunk - 1 - tid;
    double s = static_cast<double>(rowd[r]);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += u;
    }
    __syncthreads();  // block_sum's reads of wsum are done
    if (lane == 31) wsum[warp] = s;
    __syncthreads();
    if (warp == 0) {
      double t = lane < kFinishThreads / 32 ? wsum[lane] : 0.0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, t, off);
        if (lane >= off) t += u;
      }
      if (lane < kFinishThreads / 32) wsum[lane] = t;
    }
    __syncthreads();
    if (warp > 0) s += wsum[warp - 1];   // da of row r
    double adt = 0.0;
    if (r < lc) {
      const float dr = dt[(static_cast<size_t>(b) * L + t0 + r) * H + h];
      ddt[(static_cast<size_t>(b) * L + t0 + r) * H + h] =
          ddi[base + r] + dds[base + r] +
          static_cast<float>(static_cast<double>(a) * s);
      adt = static_cast<double>(dr) * s;
    }
    __syncthreads();  // the scan's reads of wsum and rowd are done
    dA_acc += block_sum(adt, wsum);
    __syncthreads();
  }
  if (tid == 0) da_part[bh] = static_cast<float>(dA_acc);
}

// dBm[b,l,n] = sum_g db_part[b,g,l,n] (the same for dC), groups in order,
// in the inputs' type T; dA[h] = sum_b da_part[b,h], batch rows in order.
// The partials' rows are NP wide (the kernels' padded state), dBm's and
// dCm's N
template <typename T>
__global__ void __launch_bounds__(256)
ssd_bwd_sum_kernel(const float* __restrict__ db_part,
                   const float* __restrict__ dc_part,
                   const float* __restrict__ da_part, T* __restrict__ dBm,
                   T* __restrict__ dCm, float* __restrict__ dA, int B, int L,
                   int H, int N, int NP, int ng) {
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  const size_t per_b = static_cast<size_t>(L) * N;
  const size_t part_b = static_cast<size_t>(L) * NP;
  if (i < static_cast<size_t>(B) * per_b) {
    const size_t b = i / per_b;
    const size_t rem = (i % per_b) / N * NP + i % N;
    const float* pb = db_part + b * ng * part_b + rem;
    const float* pc = dc_part + b * ng * part_b + rem;
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < ng; ++g) {
      sb += pb[g * part_b];
      sc += pc[g * part_b];
    }
    dBm[i] = flare::from_float<T>(sb);
    dCm[i] = flare::from_float<T>(sc);
  }
  if (i < static_cast<size_t>(H)) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += da_part[static_cast<size_t>(b) * H + i];
    dA[i] = s;
  }
}

// the finish kernel, then the sum kernel, on `stream`; 0 or a cudaError_t
template <typename T>
int launch_finish_and_sum(const float* dt, const float* A, const double* cum,
                          const float* dss, const float* rowe,
                          const float* ddi, const float* dds, float* ddt,
                          float* da_part, const float* db_part,
                          const float* dc_part, T* dBm, T* dCm, float* dA,
                          int B, int L, int H, int N, int NP, int chunk,
                          int ng, cudaStream_t stream) {
  ssd_bwd_finish_kernel<<<B * H, kFinishThreads, 0, stream>>>(
      dt, A, cum, dss, rowe, ddi, dds, ddt, da_part, L, H, chunk);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  const size_t n = static_cast<size_t>(B) * L * N > static_cast<size_t>(H)
                       ? static_cast<size_t>(B) * L * N
                       : static_cast<size_t>(H);
  ssd_bwd_sum_kernel<T><<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          stream>>>(db_part, dc_part, da_part, dBm, dCm, dA,
                                    B, L, H, N, NP, ng);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
