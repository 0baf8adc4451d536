// Causal / full GQA flash-attention backward in bf16 on the Hopper tensor
// cores (sm_90a): the bf16 route of the port's flash-attention backward.
//
// The JAX package trains attention through XLA: its backward is the
// recompute backward of src/repro/models/attention.py:164-235
// (_flash_attention_xla_bwd / _flash_bwd_body), which this kernel computes
// for bf16 q/k/v/o/dO with fp32 lse [B,H,S] from the forward:
//   delta = rowsum(dO * O)                           (fp32)
//   P     = exp(s * scale - lse),  s = q . k         (recomputed, masked)
//   dS    = P * (dP - delta) * scale,  dP = dO . V^T
//   dQ    = dS . K;  dK = dS^T . Q;  dV = P^T . dO
// with dK and dV summed over the G = H / KV query heads of a KV head.  The
// roundings the fp32 reference does not make: P^T and dS^T (dS for dQ) are
// rounded to bf16 as the register A operands of their products, and the
// exponential is exp2 of s * scale * log2(e) - lse * log2(e).
// (fp32 inputs take flash_attention_bwd_tf32.cu, in split TF32.)
//
// Bound on an H100: operations.  The function is five products of the
// forward's size, 2.5x its 4*B*H*hd flops per (query, key) pair (half the
// pairs when causal): at the training shape (B 8, S 512, H 32, KV 8, hd 64)
// ~21.5 GFLOP, 22 us at the bf16 tensor-core peak.  This design does seven
// (S and dP are recomputed in both kernels), 1.4x that: the price of a
// deterministic backward with no atomics, ~30 us at peak.
//
// Design (three launches on one stream):
//   * delta_kernel: hd / 8 lanes per row (a power of two of them: 16 at
//     hd 80, 6 idle) read o and dO with 16-byte loads; delta [B,H,S] fp32;
//   * dkdv_kernel: a block owns (b, KV head, 128-key tile), 384 threads.
//     Warpgroup 2 is the producer: K and V of the block's keys by TMA once;
//     then, for each of the G heads and each 64-row q tile that sees the
//     keys (from the key tile on when causal), one warp brings that tile's
//     Q and dO by TMA and its lse * log2(e) and delta into shared memory,
//     through a ring of 3 stages.  Warpgroups 0 and 1 own 64 keys each, the
//     keys as the M dimension:
//       S^T = K.Q^T and dP^T = V.dO^T by m64n64k16 wgmma with both operands
//       in shared memory (K, V K-major A; Q, dO K-major B);
//       P^T and dS^T in the fp32 accumulator registers, lse and delta read
//       by column from shared memory, the mask only on tiles that cross
//       the diagonal or the end of the sequence;
//       dV += P^T.dO and dK += dS^T.Q with P^T and dS^T in bf16 registers
//       as the A operand and Q, dO as MN-major B (the transpose-B bit: the
//       same TMA-written 128-byte-swizzled tiles serve as both);
//       dK and dV stay in fp32 registers to the end (setmaxnreg: producer
//       40 registers, consumers 232);
//   * dq_kernel: persistent, one block per SM walking the work items
//     (b, head, 128-row q tile): the producer loads an item's Q and dO once
//     (when the previous item is done with them, so the loads overlap its
//     end) and streams K and V tiles (128 keys at hd 64, 64 at hd 128) up
//     to the causal frontier through 3 stages.  Each consumer warpgroup
//     owns 64 rows: S = Q.K^T and dP = dO.V^T (ss), dS in registers with
//     lse and delta per row, dQ += dS.K (rs, K MN-major).
// Both take their items heaviest-first (the tile is the slowest axis of the
// order, so the causal tiles with the most work go first).  dq_kernel is
// launched while dkdv_kernel runs (programmatic dependent launch): it
// needs only delta, so its blocks fill the SMs that dkdv_kernel's last
// wave leaves idle, and it waits for dkdv_kernel before it exits.  The
// 4-D tensor maps (hd, heads, S, B) load rows >= S as zeros, so any S needs
// no other load path; hd 128 is two 64-column boxes per tile, and so is hd
// 80: the second box's columns 80-127 lie past the map's inner dim and load
// as zeros, so the tiles and accumulators are hd 128's, the products over hd
// take the 5 k16 steps of the real dims, and the zero columns of dQ, dK and
// dV are not stored.  head_dim 8, 16 and 32 are one 64-column box the same
// way (hd 64's tiles and key counts): the products over hd take ceil(hd /
// 16) k16 steps, dV and dK and dQ run at N 64, and only the hd real columns
// are stored.  head_dim 8, 16, 32, 64, 80 and 128 are template instances;
// the wrapper refuses others.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 3;
constexpr int kBlockKeys = 128;     // keys of a dK/dV block
constexpr int kTileQ = 64;          // q rows of a dK/dV step
constexpr int kBlockQ = 128;        // q rows of a dQ block
constexpr float kLog2e = 1.4426950408889634f;

// the columns of a tile: hd rounded up to whole 64-column boxes
template <int HD>
__host__ __device__ constexpr int padded() {
  return (HD + 63) / 64 * 64;
}

// keys of a dQ step: 128 at hd 64, 64 at hd 80 and 128 (registers)
template <int HD>
__host__ __device__ constexpr int dq_keys() {
  return padded<HD>() == 64 ? 128 : 64;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[64,N] (+)= A[64,16] (shared, K-major) * B[16,N] (shared, K-major), by N
__device__ __forceinline__ void ss_wgmma(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_m64n64k16_ss<0>(d, da, db, scale_d);
}
__device__ __forceinline__ void ss_wgmma(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_m64n128k16_ss<0>(d, da, db, scale_d);
}
// D[64,N] += A[64,16] (registers) * B[16,N] (shared, MN-major), by N
__device__ __forceinline__ void rs_wgmma(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n64k16_rs<1>(d, a, db, 1);
}
__device__ __forceinline__ void rs_wgmma(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n128k16_rs<1>(d, a, db, 1);
}

// D[64,N] = A[64 rows of a, hd] . B[N rows of b, hd]^T over hd: both tiles
// K-major stacks of 64-column blocks (the k16 steps of the real dims, the
// last one half zeros at hd 8); a_rows / b_rows are the rows of each whole
// tile (the distance between its column blocks)
template <int HD, int N2>
__device__ __forceinline__ void issue_nt(float (&d)[N2],
                                         const __nv_bfloat16* a, int a_rows,
                                         const __nv_bfloat16* b, int b_rows) {
#pragma unroll
  for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
    const int c = kk / 4;
    const int off = (kk % 4) * 16;
    ss_wgmma(d, desc_sw128(a + c * a_rows * 64 + off, 16, 1024),
             desc_sw128(b + c * b_rows * 64 + off, 16, 1024), kk > 0);
  }
}

// D[64,hd] += A[64, K] (registers, K / 16 bf16 fragments) . B[K rows, hd]
// (MN-major): the k16 step is 16 rows of 128 bytes, the next 64 columns of
// hd one column block (rows * 128 bytes) on
template <int K, int N2>
__device__ __forceinline__ void issue_rs(float (&d)[N2],
                                         const uint32_t (&a)[K / 16][4],
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    rs_wgmma(d, a[kk], desc_sw128(b + kk * 16 * 64, K * 128, 1024));
}

// the accumulator fragment of D[64, N] as the bf16 A fragments of a
// product over N
template <int N2>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N2 / 8][4],
                                       const float (&d)[N2]) {
#pragma unroll
  for (int kk = 0; kk < N2 / 8; ++kk) {
    a[kk][0] = pack_bf16x2(d[8 * kk], d[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// hands a buffer back to the producer once this warp is done with it
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// lanes of a delta row: hd / 8 rounded up to a power of two
template <int HD>
__host__ __device__ constexpr int delta_lanes() {
  int n = 1;
  while (n < HD / 8) n *= 2;
  return n;
}

// delta[b,h,s] = sum_d dO[b,s,h,d] * O[b,s,h,d]: delta_lanes lanes per row,
// one 16-byte load of each a lane (lanes past hd / 8 load nothing); rows in
// [b][s][h] order
template <int HD>
__global__ void __launch_bounds__(256)
delta_kernel(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ dout,
             float* __restrict__ delta, int B, int S, int H) {
  constexpr int kLanes = delta_lanes<HD>();
  const int row = (blockIdx.x * 256 + threadIdx.x) / kLanes;
  const int part = threadIdx.x % kLanes;
  const bool live = row < B * S * H && part * 8 < HD;
  float acc = 0.f;
  if (live) {
    const size_t off = static_cast<size_t>(row) * HD + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + off);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + off);
    const uint32_t av[4] = {a.x, a.y, a.z, a.w};
    const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&av[i]));
      const float2 fb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&bv[i]));
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < B * S * H && part == 0) {
    const int h = row % H;
    const int s = (row / H) % S;
    const int b = row / (H * S);
    delta[(static_cast<size_t>(b) * H + h) * S + s] = acc;
  }
}

// ---------------------------------------------------------------- dK / dV --

template <int HD, int HDP = padded<HD>()>
struct DkdvSmem {
  // HDP / 64 column blocks of [rows][64] each
  __nv_bfloat16 k[kBlockKeys * HDP];
  __nv_bfloat16 v[kBlockKeys * HDP];
  __nv_bfloat16 q[kStages][kTileQ * HDP];
  __nv_bfloat16 dout[kStages][kTileQ * HDP];
  float lse2[kStages][kTileQ];      // lse * log2(e); 0 for rows >= S
  float delta[kStages][kTileQ];     // 0 for rows >= S
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(__grid_constant__ const CUtensorMap map_q,
            __grid_constant__ const CUtensorMap map_k,
            __grid_constant__ const CUtensorMap map_v,
            __grid_constant__ const CUtensorMap map_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk_out,
            __nv_bfloat16* __restrict__ dv_out, int B, int S, int H, int KV,
            float scale, int causal) {
  constexpr int HDP = padded<HD>();
  constexpr int kCols = HDP / 64;
  extern __shared__ uint8_t smem_raw[];
  DkdvSmem<HD>& s = *reinterpret_cast<DkdvSmem<HD>*>(align_1024(smem_raw));

  const int group = H / KV;
  // the key tile is the grid's slowest axis: with causal masking the first
  // keys see the most queries, so the heaviest blocks are dispatched first
  const int bk = blockIdx.x % (B * KV);
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int k0 = (blockIdx.x / (B * KV)) * kBlockKeys;
  const int q_begin = causal ? k0 : 0;
  const int q_tiles = (S - q_begin + kTileQ - 1) / kTileQ;
  const int steps = group * q_tiles;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  // dq_kernel (next in the stream, independent of dK and dV) may take the
  // SMs this grid's last wave leaves idle
  pdl_launch_dependents();

  if (threadIdx.x == 0) {
    mbar_init(&s.kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 32);                  // the producer warp
      mbar_init(&s.empty[st], kConsumers * 4);     // lane 0 of each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // step n: head kvh * group + n / q_tiles, q tile n % q_tiles, in stage
  // n % kStages, that stage's (n / kStages)-th round
  if (wg == kConsumers) {
    // producer: one warp
    regs_dealloc<40>();
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(&s.kv_full, 2 * kBlockKeys * HDP * 2);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          tma_load_4d(s.k + c * kBlockKeys * 64, &map_k, &s.kv_full, c * 64,
                      kvh, k0, b);
          tma_load_4d(s.v + c * kBlockKeys * 64, &map_v, &s.kv_full, c * 64,
                      kvh, k0, b);
        }
      }
      for (int n = 0; n < steps; ++n) {
        const int st = n % kStages;
        const int h = kvh * group + n / q_tiles;
        const int q0 = q_begin + (n % q_tiles) * kTileQ;
        mbar_wait(&s.empty[st], ((n / kStages) & 1) ^ 1);
        const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
        for (int j = tid; j < kTileQ; j += 32) {
          const int q = q0 + j;
          s.lse2[st][j] = q < S ? lse[row0 + q] * kLog2e : 0.f;
          s.delta[st][j] = q < S ? delta[row0 + q] : 0.f;
        }
        // each lane's arrival releases its own lse / delta stores
        if (tid == 0) {
          mbar_expect_tx(&s.full[st], 2 * kTileQ * HDP * 2);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            tma_load_4d(s.q[st] + c * kTileQ * 64, &map_q, &s.full[st],
                        c * 64, h, q0, b);
            tma_load_4d(s.dout[st] + c * kTileQ * 64, &map_do, &s.full[st],
                        c * 64, h, q0, b);
          }
        } else {
          mbar_arrive(&s.full[st]);
        }
      }
    }
  } else {
    // consumers: 64 keys each, the M dimension of every product
    regs_alloc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int kw0 = k0 + wg * 64;                    // this warpgroup's keys
    const int key0 = kw0 + warp * 16 + lane / 4;     // and key0 + 8
    const float scale_log2 = scale * kLog2e;
    const __nv_bfloat16* ka = s.k + wg * 64 * 64;
    const __nv_bfloat16* va = s.v + wg * 64 * 64;
    float dk[HDP / 2], dv[HDP / 2];
    float sacc[kTileQ / 2], dpacc[kTileQ / 2];
    uint32_t pa[kTileQ / 16][4], da[kTileQ / 16][4];
#pragma unroll
    for (int j = 0; j < HDP / 2; ++j) dk[j] = dv[j] = 0.f;
    mbar_wait(&s.kv_full, 0);

    for (int n = 0; n < steps; ++n) {
      const int st = n % kStages;
      const int q0 = q_begin + (n % q_tiles) * kTileQ;
      mbar_wait(&s.full[st], (n / kStages) & 1);
      if (causal && q0 + kTileQ <= kw0) {            // every key after every
        release(&s.empty[st]);                       // query of the tile
        continue;
      }
      // S^T = K.Q^T and dP^T = V.dO^T, one commit group
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
      issue_nt<HD>(sacc, ka, kBlockKeys, s.q[st], kTileQ);
      issue_nt<HD>(dpacc, va, kBlockKeys, s.dout[st], kTileQ);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);
      // P^T and dS^T: rows are keys, columns queries (lse, delta by column)
      const bool mask = (causal && q0 < kw0 + 64) || q0 + kTileQ > S;
#pragma unroll
      for (int i = 0; i < kTileQ / 8; ++i) {
        const int col = 8 * i + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(&s.lse2[st][col]);
        const float2 dl = *reinterpret_cast<const float2*>(&s.delta[st][col]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = q0 + col + (e & 1);
          const int key = key0 + (e >> 1) * 8;
          float p = fast_exp2(
              fmaf(sacc[4 * i + e], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (mask && (q >= S || (causal && key > q))) p = 0.f;
          sacc[4 * i + e] = p;
          dpacc[4 * i + e] =
              p * (dpacc[4 * i + e] - ((e & 1) ? dl.y : dl.x)) * scale;
        }
      }
      pack_a(pa, sacc);
      pack_a(da, dpacc);
      // dV += P^T.dO and dK += dS^T.Q
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      issue_rs<kTileQ>(dv, pa, s.dout[st]);
      issue_rs<kTileQ>(dk, da, s.q[st]);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      release(&s.empty[st]);
    }

    // dK and dV in bf16, keys < S
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + r * 8;
      if (key >= S) continue;
      const size_t row = ((static_cast<size_t>(b) * S + key) * KV + kvh) * HD;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = j * 8 + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(dk_out + row + col) =
            pack_bf16x2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + row + col) =
            pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

// -------------------------------------------------------------------- dQ --

template <int HD, int HDP = padded<HD>(), int BK = dq_keys<HD>()>
struct DqSmem {
  __nv_bfloat16 q[kBlockQ * HDP];
  __nv_bfloat16 dout[kBlockQ * HDP];
  __nv_bfloat16 k[kStages][BK * HDP];
  __nv_bfloat16 v[kStages][BK * HDP];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// dQ work item i (of B * H * q tiles) in the heaviest-first order: the q
// tile is the slowest axis, reversed, so the causal tiles with the most
// keys go first
struct DqItem {
  int b, h, q0, tiles;
};
template <int BK>
__device__ __forceinline__ DqItem dq_item(int i, int B, int H, int S,
                                          int q_tiles, int causal) {
  DqItem it;
  const int bh = i % (B * H);
  it.b = bh / H;
  it.h = bh % H;
  it.q0 = (q_tiles - 1 - i / (B * H)) * kBlockQ;
  const int kv_end = causal ? min(S, it.q0 + kBlockQ) : S;
  it.tiles = (kv_end + BK - 1) / BK;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(__grid_constant__ const CUtensorMap map_q,
          __grid_constant__ const CUtensorMap map_k,
          __grid_constant__ const CUtensorMap map_v,
          __grid_constant__ const CUtensorMap map_do,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq_out, int B, int S, int H, int KV,
          float scale, int causal) {
  constexpr int HDP = padded<HD>();
  constexpr int kCols = HDP / 64;
  constexpr int BK = dq_keys<HD>();
  extern __shared__ uint8_t smem_raw[];
  DqSmem<HD>& s = *reinterpret_cast<DqSmem<HD>*>(align_1024(smem_raw));

  const int q_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int items = B * H * q_tiles;
  const int group = H / KV;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, kConsumers * 4);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // persistent: block i walks items i, i + gridDim.x, ...; key tiles are
  // counted across its items: tile g sits in stage g % kStages, in that
  // stage's (g / kStages)-th round
  if (wg == kConsumers) {
    // producer: one thread; an item's Q and dO once the previous item is
    // done with them, then its K and V tiles
    regs_dealloc<40>();
    if (tid == 0) {
      int g = 0;
      int round = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
        const DqItem it = dq_item<BK>(i, B, H, S, q_tiles, causal);
        const int kvh = it.h / group;
        mbar_wait(&s.q_empty, (round & 1) ^ 1);
        mbar_expect_tx(&s.q_full, 2 * kBlockQ * HDP * 2);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          tma_load_4d(s.q + c * kBlockQ * 64, &map_q, &s.q_full, c * 64,
                      it.h, it.q0, it.b);
          tma_load_4d(s.dout + c * kBlockQ * 64, &map_do, &s.q_full, c * 64,
                      it.h, it.q0, it.b);
        }
        for (int n = 0; n < it.tiles; ++n, ++g) {
          const int st = g % kStages;
          mbar_wait(&s.empty[st], ((g / kStages) & 1) ^ 1);
          mbar_expect_tx(&s.full[st], 2 * BK * HDP * 2);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            tma_load_4d(s.k[st] + c * BK * 64, &map_k, &s.full[st], c * 64,
                        kvh, n * BK, it.b);
            tma_load_4d(s.v[st] + c * BK * 64, &map_v, &s.full[st], c * 64,
                        kvh, n * BK, it.b);
          }
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    regs_alloc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const float scale_log2 = scale * kLog2e;
    const __nv_bfloat16* qa = s.q + wg * 64 * 64;
    const __nv_bfloat16* doa = s.dout + wg * 64 * 64;
    float dq[HDP / 2];
    float sacc[BK / 2], dpacc[BK / 2];
    uint32_t da[BK / 16][4];

    int g = 0;
    int round = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
      const DqItem it = dq_item<BK>(i, B, H, S, q_tiles, causal);
      const int q_first = it.q0 + wg * 64;
      const int row0 = q_first + warp * 16 + lane / 4;   // and row0 + 8
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = row0 + r * 8;
        const size_t off = (static_cast<size_t>(it.b) * H + it.h) * S + q;
        lse2[r] = q < S ? lse[off] * kLog2e : 0.f;
        dl[r] = q < S ? delta[off] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) dq[j] = 0.f;
      mbar_wait(&s.q_full, round & 1);

      for (int n = 0; n < it.tiles; ++n, ++g) {
        const int st = g % kStages;
        const int k0 = n * BK;
        mbar_wait(&s.full[st], (g / kStages) & 1);
        // Q and dO go back to the producer after the item's last S and dP,
        // so the next item's loads overlap this one's end
        const bool last = n == it.tiles - 1;
        if (causal && k0 > q_first + 63) {          // every key after every
          release(&s.empty[st]);                    // row of this warpgroup
          if (last) release(&s.q_empty);
          continue;
        }
        // S = Q.K^T and dP = dO.V^T, one commit group
        fence_regs(sacc);
        fence_regs(dpacc);
        wgmma_fence();
        issue_nt<HD>(sacc, qa, kBlockQ, s.k[st], BK);
        issue_nt<HD>(dpacc, doa, kBlockQ, s.v[st], BK);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(dpacc);
        if (last) release(&s.q_empty);
        // dS: rows are queries (lse, delta per row), columns keys
        const bool mask = (causal && k0 + BK - 1 > q_first) || k0 + BK > S;
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int key = k0 + 8 * c + 2 * (lane % 4) + (e & 1);
            float p =
                fast_exp2(fmaf(sacc[4 * c + e], scale_log2, -lse2[r]));
            if (mask && (key >= S || (causal && key > row0 + r * 8)))
              p = 0.f;
            dpacc[4 * c + e] = p * (dpacc[4 * c + e] - dl[r]) * scale;
          }
        }
        pack_a(da, dpacc);
        // dQ += dS.K
        fence_regs(dq);
        wgmma_fence();
        issue_rs<BK>(dq, da, s.k[st]);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        release(&s.empty[st]);
      }
      // dQ in bf16, rows < S
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = row0 + r * 8;
        if (q >= S) continue;
        __nv_bfloat16* row =
            dq_out + ((static_cast<size_t>(it.b) * S + q) * H + it.h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(row + col) =
              pack_bf16x2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
    }
  }
  // overlapped with dkdv_kernel: end after it, so that what follows in the
  // stream sees dK and dV
  pdl_wait();
}

// [B,S,heads,hd] bf16 as a 4-D tensor map (hd, heads, S, B) with a box of
// (64, 1, rows, 1)
int make_map(CUtensorMap* map, const void* p, int B, int S, int heads, int hd,
             int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads,
                                 row * heads * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return make_map_bf16(map, p, 4, dims, strides, box);
}

// the four maps of one kernel: q and dO with q_rows a box, k and v with
// k_rows
struct Maps {
  CUtensorMap q, k, v, dout;
};
int make_maps(Maps* m, const void* q, const void* k, const void* v,
              const void* dout, int B, int S, int H, int KV, int hd,
              int q_rows, int k_rows) {
  if (int e = make_map(&m->q, q, B, S, H, hd, q_rows)) return e;
  if (int e = make_map(&m->dout, dout, B, S, H, hd, q_rows)) return e;
  if (int e = make_map(&m->k, k, B, S, KV, hd, k_rows)) return e;
  return make_map(&m->v, v, B, S, KV, hd, k_rows);
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* delta, void* dq,
              void* dk, void* dv, int B, int S, int H, int KV, int causal,
              cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  const long long lanes =
      static_cast<long long>(B) * S * H * delta_lanes<HD>();
  delta_kernel<HD><<<static_cast<int>((lanes + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), delta, B,
      S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  Maps m;
  if (int r = make_maps(&m, q, k, v, dout, B, S, H, KV, HD, kTileQ,
                        kBlockKeys))
    return r;
  const size_t smem_kv = sizeof(DkdvSmem<HD>) + 1024;
  e = cudaFuncSetAttribute(dkdv_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_kv));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int key_tiles = (S + kBlockKeys - 1) / kBlockKeys;
  dkdv_kernel<HD><<<B * KV * key_tiles, kThreads, smem_kv, stream>>>(
      m.q, m.k, m.v, m.dout, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), B, S, H, KV, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  if (int r = make_maps(&m, q, k, v, dout, B, S, H, KV, HD, kBlockQ,
                        dq_keys<HD>()))
    return r;
  const size_t smem_q = sizeof(DqSmem<HD>) + 1024;
  e = cudaFuncSetAttribute(dq_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_q));
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: one block per SM, each walks the work items
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int items = B * H * ((S + kBlockQ - 1) / kBlockQ);
  // overlapped with dkdv_kernel (programmatic dependent launch): dQ needs
  // only delta, which the launch before dkdv_kernel wrote
  return static_cast<int>(launch_overlapped(
      dq_kernel<HD>, dim3(min(items, sms)), dim3(kThreads), smem_q, stream,
      m.q, m.k, m.v, m.dout, lse, static_cast<const float*>(delta),
      static_cast<bf16*>(dq), B, S, H, KV, scale, causal));
}

}  // namespace

// q, o, dout, dq: [B,S,H,hd]; k, v, dk, dv: [B,S,KV,hd]; contiguous bf16,
// 16-byte aligned.  lse: [B,H,S] fp32 from the forward; delta: [B,H,S]
// fp32 scratch.  Launches delta_kernel, dkdv_kernel and dq_kernel in that
// order on `stream`.  Returns 0 or the first cudaError_t (a launch's, or
// the tensor maps').
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int H, int KV, int hd, int causal, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (hd == 8)
    return launch_hd<8>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KV,
                         causal, s);
  if (hd == 16)
    return launch_hd<16>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KV,
                         causal, s);
  if (hd == 32)
    return launch_hd<32>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KV,
                         causal, s);
  if (hd == 64)
    return launch_hd<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KV,
                         causal, s);
  if (hd == 80)
    return launch_hd<80>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KV,
                         causal, s);
  if (hd == 128)
    return launch_hd<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, S, H, KV,
                          causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
