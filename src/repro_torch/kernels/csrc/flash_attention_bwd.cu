// Causal / full GQA flash-attention backward in fp32 on the FP32 pipes
// (sm_90a): the fp32 route of the port's flash-attention backward.  bf16
// inputs take flash_attention_bwd_wgmma.cu, on the tensor cores; this
// route serves the fp32 training step, whose result is held to a full-fp32
// reference and not to TF32 or bf16 operands.
//
// The JAX package trains attention through XLA: its backward is the
// recompute backward of src/repro/models/attention.py:164-235
// (_flash_attention_xla_bwd / _flash_bwd_body), which this kernel computes:
//   delta = rowsum(dO * O)                          (fp32)
//   P     = exp(s - lse),  s = (q . k) * scale      (recomputed, masked)
//   dP    = dO . V^T
//   dS    = P * (dP - delta) * scale
//   dQ    = dS . K;  dK = dS^T . Q;  dV = P^T . dO
// with dK and dV summed over the G = H / KV query heads of a KV head.  lse
// [B,H,S] is the forward's (flash_attention*.cu write it on request).
//
// Bound on an H100: operations.  Five products of the forward's size
// against its two, 2.5x the forward's 4*B*H*hd flops per (query, key) pair
// (half the pairs when causal), at the fp32 peak of 67 TFLOP/s.  This
// kernel recomputes S and dP in both of its passes (seven products).
//
// Design (deterministic: no atomics; every sum has one owner):
//   * delta_kernel: one warp per (b, s, h) row, delta[b,h,s] in fp32;
//   * dkdv_kernel: one block per (b, KV head, 64-key tile).  K and V stay in
//     shared memory; the block walks the G heads of its group and, for each,
//     the 64-row q tiles that see its keys (from the key tile on when
//     causal), recomputes S and dP for the tile (a 4x4 register tile per
//     thread), writes P and dS to shared memory and adds P^T.dO and dS^T.Q
//     into dV and dK, which each thread keeps in fp32 registers (4 keys x
//     hd/16 dims) to the end;
//   * dq_kernel: one block per (b, head, 64-row q tile) walks the key tiles
//     up to the causal frontier, recomputes S, dP and dS, and adds dS.K into
//     dQ in registers.
// All tiles live in shared memory as fp32 rows of hd + 4 floats, so that a
// warp's 16-byte reads of 16 different rows fall in different banks.  Rows
// and keys >= S load as zeros and are masked, so any S works.
// head_dim 64 and 128 are template instances; the wrapper refuses others.

#include "common.cuh"

namespace {

constexpr int kTile = 64;        // q rows and keys of a tile
constexpr int kThreads = 256;    // a 16 x 16 grid of 4 x 4 register tiles
constexpr int kPad = 4;          // floats of padding at the end of a row
constexpr int kTileStride = kTile + kPad;   // P / dS rows

template <int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + kPad;
}

// shared floats of each kernel: four [64, hd] tiles, plus P and dS (dK/dV)
// or dS^T (dQ), plus lse and delta of the q tile
template <int HD>
__host__ __device__ constexpr size_t dkdv_smem_floats() {
  return 4 * kTile * row_stride<HD>() + 2 * kTile * kTileStride + 2 * kTile;
}
template <int HD>
__host__ __device__ constexpr size_t dq_smem_floats() {
  return 4 * kTile * row_stride<HD>() + kTile * kTileStride + 2 * kTile;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// delta[b,h,s] = sum_d dO[b,s,h,d] * O[b,s,h,d]; rows in [b][s][h] order
template <int HD>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= B * S * H) return;
  const size_t base = static_cast<size_t>(row) * HD;
  float acc = 0.f;
  for (int d = 4 * lane; d < HD; d += 128)
    acc = dot4(flare::Pack4<float>::load(o + base + d),
               flare::Pack4<float>::load(dout + base + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % H;
    const int s = (row / H) % S;
    const int b = row / (H * S);
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

// rows r0 .. r0+63 of head hh of a [B,S,heads,HD] tensor into a shared
// [64][HD+4] fp32 tile; rows >= S are zeros
template <int HD>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int b, int S, int heads, int hh,
                                          int r0) {
  constexpr int C4 = HD / 4;
  for (int i = threadIdx.x; i < kTile * C4; i += kThreads) {
    const int r = i / C4;
    const int c = 4 * (i % C4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      v = flare::Pack4<float>::load(
          src + ((static_cast<size_t>(b) * S + r0 + r) * heads + hh) * HD + c);
    *reinterpret_cast<float4*>(dst + r * row_stride<HD>() + c) = v;
  }
}

// lse and delta of rows r0 .. r0+63 of (b, h) into shared; rows >= S are 0
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int b, int h, int H, int S,
                                               int r0) {
  if (threadIdx.x < kTile) {
    const int i = r0 + threadIdx.x;
    const size_t off = (static_cast<size_t>(b) * H + h) * S + i;
    lse_s[threadIdx.x] = i < S ? lse[off] : 0.f;
    delta_s[threadIdx.x] = i < S ? delta[off] : 0.f;
  }
}

// acc[a][c] = sum_d A[tm + 16a][d] * Bm[tn + 16c][d] over HD: a 64 x 64
// product of two row-major tiles, this thread's rows tm + 16a and columns
// tn + 16c
template <int HD>
__device__ __forceinline__ void nt_product(float (&acc)[4][4], const float* A,
                                           const float* Bm, int tm, int tn) {
  constexpr int ST = row_stride<HD>();
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      av[a] = *reinterpret_cast<const float4*>(A + (tm + 16 * a) * ST + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(Bm + (tn + 16 * c) * ST + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = dot4(av[a], bv[c], acc[a][c]);
  }
}

// acc[a][c] += sum_r A[r][4tm + a] * Bm[r][col(c)] over 64 rows r, with
// col(c) = 64 * (c / 4) + 4tn + c % 4: this thread's 4 rows of the output
// and NC = HD / 16 of its HD columns
template <int NC>
__device__ __forceinline__ void tn_product(float (&acc)[4][NC], const float* A,
                                           int sa, const float* Bm, int sb,
                                           int tm, int tn) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(A + r * sa + 4 * tm);
    const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int q = 0; q < NC / 4; ++q) {
      const float4 bv =
          *reinterpret_cast<const float4*>(Bm + r * sb + 64 * q + 4 * tn);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        acc[a][4 * q] = fmaf(am[a], bv.x, acc[a][4 * q]);
        acc[a][4 * q + 1] = fmaf(am[a], bv.y, acc[a][4 * q + 1]);
        acc[a][4 * q + 2] = fmaf(am[a], bv.z, acc[a][4 * q + 2]);
        acc[a][4 * q + 3] = fmaf(am[a], bv.w, acc[a][4 * q + 3]);
      }
    }
  }
}

// rows r0 + 4tm + a (< S) of an [.., HD] output held as acc[a][col(c)]
template <int NC>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[4][NC], int b,
                                           int S, int heads, int hh, int r0,
                                           int tm, int tn) {
  constexpr int HD = 16 * NC;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + 4 * tm + a;
    if (r >= S) continue;
    float* row = dst + ((static_cast<size_t>(b) * S + r) * heads + hh) * HD;
#pragma unroll
    for (int q = 0; q < NC / 4; ++q)
      flare::Pack4<float>::store(row + 64 * q + 4 * tn,
                             make_float4(acc[a][4 * q], acc[a][4 * q + 1],
                                         acc[a][4 * q + 2], acc[a][4 * q + 3]));
  }
}

// P and dS of this thread's (query, key) pairs from the recomputed scores s
// and dP; masked pairs (keys or queries >= S, keys after the query when
// causal) give 0
__device__ __forceinline__ void probs_and_dscores(
    float (&s)[4][4], float (&dp)[4][4], const float* lse_s,
    const float* delta_s, int q0, int k0, int S, int causal, float scale,
    int tm, int tn) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + tm + 16 * a;
    const float li = lse_s[tm + 16 * a];
    const float di = delta_s[tm + 16 * a];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = k0 + tn + 16 * c;
      const bool valid = i < S && j < S && !(causal && j > i);
      const float p = valid ? expf(s[a][c] * scale - li) : 0.f;
      s[a][c] = p;
      dp[a][c] = p * (dp[a][c] - di) * scale;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int S, int H,
            int KV, float scale, int causal) {
  constexpr int ST = row_stride<HD>();
  constexpr int NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;
  float* vs = ks + kTile * ST;
  float* qs = vs + kTile * ST;
  float* dos = qs + kTile * ST;
  float* ps = dos + kTile * ST;
  float* dss = ps + kTile * kTileStride;
  float* lse_s = dss + kTile * kTileStride;
  float* delta_s = lse_s + kTile;

  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
  const int k0 = blockIdx.x * kTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / KV;

  load_tile<HD>(ks, k, b, S, KV, kvh, k0);
  load_tile<HD>(vs, v, b, S, KV, kvh, k0);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int q_begin = causal ? k0 : 0;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    for (int q0 = q_begin; q0 < S; q0 += kTile) {
      __syncthreads();   // the previous tile's P, dS, Q and dO are read
      load_tile<HD>(qs, q, b, S, H, h, q0);
      load_tile<HD>(dos, dout, b, S, H, h, q0);
      load_row_stats(lse_s, delta_s, lse, delta, b, h, H, S, q0);
      __syncthreads();
      float s[4][4], dp[4][4];
      nt_product<HD>(s, qs, ks, tm, tn);
      nt_product<HD>(dp, dos, vs, tm, tn);
      probs_and_dscores(s, dp, lse_s, delta_s, q0, k0, S, causal, scale, tm,
                        tn);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ps[(tm + 16 * a) * kTileStride + tn + 16 * c] = s[a][c];
          dss[(tm + 16 * a) * kTileStride + tn + 16 * c] = dp[a][c];
        }
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
      tn_product<NC>(dv_acc, ps, kTileStride, dos, ST, tm, tn);
      tn_product<NC>(dk_acc, dss, kTileStride, qs, ST, tm, tn);
    }
  }
  store_rows<NC>(dk, dk_acc, b, S, KV, kvh, k0, tm, tn);
  store_rows<NC>(dv, dv_acc, b, S, KV, kvh, k0, tm, tn);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          float* __restrict__ dq, int S, int H, int KV, float scale,
          int causal) {
  constexpr int ST = row_stride<HD>();
  constexpr int NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;
  float* dos = qs + kTile * ST;
  float* ks = dos + kTile * ST;
  float* vs = ks + kTile * ST;
  float* dst = vs + kTile * ST;          // dS^T: [key][query]
  float* lse_s = dst + kTile * kTileStride;
  float* delta_s = lse_s + kTile;

  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  load_tile<HD>(qs, q, b, S, H, h, q0);
  load_tile<HD>(dos, dout, b, S, H, h, q0);
  load_row_stats(lse_s, delta_s, lse, delta, b, h, H, S, q0);

  float dq_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[a][c] = 0.f;

  const int k_end = causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();   // the previous tile's K and dS^T are read
    load_tile<HD>(ks, k, b, S, KV, kvh, k0);
    load_tile<HD>(vs, v, b, S, KV, kvh, k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    nt_product<HD>(s, qs, ks, tm, tn);
    nt_product<HD>(dp, dos, vs, tm, tn);
    probs_and_dscores(s, dp, lse_s, delta_s, q0, k0, S, causal, scale, tm,
                      tn);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst[(tn + 16 * c) * kTileStride + tm + 16 * a] = dp[a][c];
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
    tn_product<NC>(dq_acc, dst, kTileStride, ks, ST, tm, tn);
  }
  store_rows<NC>(dq, dq_acc, b, S, H, h, q0, tm, tn);
}

template <int HD>
int launch_typed(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const void* lse, void* delta, void* dq,
                 void* dk, void* dv, int B, int S, int H, int KV, int causal,
                 cudaStream_t stream) {
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  const int rows = B * S * H;
  delta_kernel<HD><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads,
                     0, stream>>>(static_cast<const float*>(o), dop, dp, B, S,
                                  H);
  if (cudaError_t e = cudaGetLastError()) return static_cast<int>(e);

  const int tiles = (S + kTile - 1) / kTile;
  const size_t smem_kv = dkdv_smem_floats<HD>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (e != cudaSuccess) return static_cast<int>(e);
  dkdv_kernel<HD><<<dim3(tiles, KV, B), kThreads, smem_kv, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<float*>(dk),
      static_cast<float*>(dv), S, H, KV, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  const size_t smem_q = dq_smem_floats<HD>() * sizeof(float);
  e = cudaFuncSetAttribute(dq_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_q));
  if (e != cudaSuccess) return static_cast<int>(e);
  dq_kernel<HD><<<dim3(tiles, H, B), kThreads, smem_q, stream>>>(
      qp, kp, vp, dop, lp, dp, static_cast<float*>(dq), S, H, KV, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: [B,S,H,hd]; k, v, dk, dv: [B,S,KV,hd]; contiguous, 16-byte
// aligned fp32.  lse: [B,H,S] fp32 from the forward; delta: [B,H,S] fp32
// scratch.  Launches delta_kernel, dkdv_kernel and dq_kernel in that order
// on `stream`.  Returns 0 or the first cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int hd, int causal, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch_typed<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H,
                            KV, causal, s);
  if (hd == 128)
    return launch_typed<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S,
                             H, KV, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
