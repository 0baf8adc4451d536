// Causal / full GQA flash-attention backward in fp32 on the Hopper tensor
// cores as split TF32 (sm_90a): the fp32 route ("tf32x3") of the port's
// flash-attention backward (bf16 takes flash_attention_bwd_wgmma.cu).
//
// The JAX package trains attention through XLA: its backward is the
// recompute backward of src/repro/models/attention.py:164-235
// (_flash_attention_xla_bwd / _flash_bwd_body), which this kernel computes
// for fp32 q/k/v/o/dO with fp32 lse [B,H,S] from the forward:
//   delta = rowsum(dO * O)
//   P     = exp(s * scale - lse),  s = q . k         (recomputed, masked)
//   dS    = P * (dP - delta) * scale,  dP = dO . V^T
//   dQ    = dS . K;  dK = dS^T . Q;  dV = P^T . dO
// with dK and dV summed over the G = H / KV query heads of a KV head.
// Each product X.Y is X_hi.Y_hi + X_hi.Y_lo + X_lo.Y_hi by m64nNk8 tf32
// wgmma into fp32 accumulators (hopper.cuh, split_tf32), so the result is
// held to a full-fp32 reference (3e-4); the exponential is exp2 of
// s * scale * log2(e) - lse * log2(e) by ex2.approx.
//
// Bound on an H100: bytes at the training shape (B 8, S 512, H 32, KV 8,
// hd 64): q, k, v, o, dO and lse read and dq, dk, dv written, ~1.68e8
// bytes, against the five products' 2.15e10 flops at the TF32 peak.  This
// design does seven products (S and dP in both passes), three TF32 passes
// each: its floor is 9.0e10 flops at 495 TFLOP/s.
//
// Design (three launches on one stream; deterministic: no atomics, one
// owner for each sum):
//   * split_kernel (flash_tf32_split.cuh): delta, k and v split into tf32
//     hi and lo [2][B,S,KV,hd] (every q tile of every head of a group
//     reads them again), and q, dO, k transposed (the sequence contiguous,
//     hi|lo per 16 rows, permuted within 8) for the products over the
//     sequence, since tf32 wgmma takes only K-major operands; q and dO for
//     the products over hd come raw, and the warpgroup that reads a tile
//     splits it in shared memory in place (its lo into a buffer beside);
//   * dkdv_kernel: a block owns (b, KV head, 64-key tile), 384 threads
//     (256 at hd 128).
//     Warpgroup 2 is the producer: K and V hi/lo of the block's keys by TMA
//     once; then, for each of the G heads and each q step (32 rows at hd
//     64, 16 at hd 80 and 128) that sees the keys (from the key tile on
//     when causal), one warp brings the step's raw Q, dO and Q^T, dO^T by
//     TMA and its lse * log2(e) and delta into shared memory, through 2
//     stages (hd 64, 80) or 1 (hd 128).  At hd 64 and 80 warpgroups 0 and
//     1 take the steps in turn, each on its own stage; at hd 128 warpgroup
//     0 takes them all.  The keys are the M dimension:
//       S^T = K.Q^T and dP^T = V.dO^T (both operands in shared memory);
//       P^T and dS^T in the fp32 accumulator registers, lse and delta by
//       column from shared memory, the mask only on steps that cross the
//       diagonal or the end of the sequence;
//       dV += P^T.dO and dK += dS^T.Q with P^T and dS^T split in registers
//       as the A operand and dO^T, Q^T as B;
//     each warpgroup keeps its dK and dV in fp32 registers to the end;
//     then (hd 64, 80) warpgroup 1's go through shared memory to warpgroup 0,
//     which adds them in a fixed order and writes dK and dV.  At hd 128
//     (one consumer) the accumulators hold at most a few heads' sums:
//     after the last step of a head that brings them to kFlushRows query
//     rows or more, they are added into dK and dV in device memory (stored
//     the first time) and start again from 0.  The tensor cores' fp32
//     accumulation drifts with the number of products it sums: summed
//     over all G heads at once, dV at llama3-405b's G 16 (B 8, S 512, 8192
//     rows) drifted 1.4e-3 from an fp64 sum, where the plain fp32 version
//     drifts 5.7e-5, past the route's 3e-4; qwen2-72b's G 8 (4096 rows)
//     4.6e-4, within it;
//   * dq_kernel: persistent, one block per SM walking the items (b, head,
//     q tile of 128 rows at hd 64, two consumer warpgroups of 64; 64 rows
//     at hd 80 and 128, one): the producer loads an item's raw Q and dO
//     once and streams K, V (hi, lo) and K^T tiles (32 keys at hd 64, 16 at
//     hd 80 and 128) up to the causal frontier through 2 stages.  Each consumer
//     warpgroup owns 64 rows: S = Q.K^T and dP = dO.V^T, dS in registers
//     with lse and delta per row, dQ += dS.K (K^T as B).
// Both take their items heaviest-first.  dq_kernel is launched while
// dkdv_kernel runs (programmatic dependent launch): it needs only the
// pre-pass, so its blocks fill the SMs that dkdv_kernel's last wave leaves
// idle, and it waits for dkdv_kernel before it exits.  The 4-D tensor maps
// load rows >= S as zeros, so any S needs no other load path.  At hd 80 the
// direct tiles (q, dO, k, v and their splits) are three 32-column boxes
// whose columns 80-95 lie past the maps' inner dim and load as zeros (never
// read: the products over hd take the 10 k8 steps of the real dims), and
// the products over the sequence run at N 80 on the transposed tiles' 80
// rows.  At hd 8, 16 and 32 the direct tiles are one 32-column box (the
// columns past hd zero, never read: the products over hd take the hd / 8
// k8 steps), the products over the sequence run at N hd on the transposed
// tiles' hd rows, and the steps, key tiles and warpgroups are hd 64's.
// head_dim 8, 16, 32, 64, 80 and 128 are template instances (dK/dV 192 KB
// and dQ 224 KB of shared memory at 64 and 128, 186 KB and 166 KB at 80);
// the wrapper refuses others.

#include "common.cuh"
#include "flash_tf32_split.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;
using namespace flare::tf32x3;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[64,N] (+)= A[64,8] (shared) . B[N,8]^T (shared), both K-major, by N
__device__ __forceinline__ void ss_wgmma(float (&d)[8], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_m64n16k8_tf32_ss(d, da, db, scale_d);
}
__device__ __forceinline__ void ss_wgmma(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_m64n32k8_tf32_ss(d, da, db, scale_d);
}
// D[64,hd] += A[64,8] (registers) . B[8,hd] (shared, K-major), by hd
__device__ __forceinline__ void rs_wgmma(float (&d)[4],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n8k8_tf32_rs(d, a, db, 1);
}
__device__ __forceinline__ void rs_wgmma(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n16k8_tf32_rs(d, a, db, 1);
}
__device__ __forceinline__ void rs_wgmma(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n32k8_tf32_rs(d, a, db, 1);
}
__device__ __forceinline__ void rs_wgmma(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n64k8_tf32_rs(d, a, db, 1);
}
__device__ __forceinline__ void rs_wgmma(float (&d)[40],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n80k8_tf32_rs(d, a, db, 1);
}
__device__ __forceinline__ void rs_wgmma(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n128k8_tf32_rs(d, a, db, 1);
}

// D[64,N] = A.B^T over hd in three passes: a / a_lo the 64 rows of an
// A tile's hi and lo (32-column blocks of a_rows rows), b / b_lo the N rows
// of a B tile's (column blocks of N rows); the k8 steps of the real dims
template <int HD, int N2>
__device__ __forceinline__ void issue_nt(float (&d)[N2], const float* a,
                                         const float* a_lo, int a_rows,
                                         const float* b, const float* b_lo) {
  constexpr int N = 2 * N2;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int aoff = (kk / 4) * a_rows * 32 + (kk % 4) * 8;
    const int boff = (kk / 4) * N * 32 + (kk % 4) * 8;
    const uint64_t ah = desc_sw128(a + aoff, 16, 1024);
    const uint64_t al = desc_sw128(a_lo + aoff, 16, 1024);
    const uint64_t bh = desc_sw128(b + boff, 16, 1024);
    const uint64_t bl = desc_sw128(b_lo + boff, 16, 1024);
    ss_wgmma(d, ah, bl, kk > 0);
    ss_wgmma(d, al, bh, 1);
    ss_wgmma(d, ah, bh, 1);
  }
}

// D[64,hd] += A[64,K] (registers, hi and lo fragments) . B[K,hd], B a
// transposed split tile (K / 16 column blocks of [hd][32]: k8 step kk
// reads the hi of block kk / 2 at byte 32 (kk % 2), its lo 64 bytes on)
template <int K, int HD, int N2>
__device__ __forceinline__ void issue_rs(float (&d)[N2],
                                         const uint32_t (&hi)[K / 8][4],
                                         const uint32_t (&lo)[K / 8][4],
                                         const float* bt) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const float* b = bt + (kk / 2) * HD * 32 + (kk % 2) * 8;
    const uint64_t bh = desc_sw128(b, 16, 1024);
    const uint64_t bl = desc_sw128(b + 16, 16, 1024);
    rs_wgmma(d, hi[kk], bl);
    rs_wgmma(d, lo[kk], bh);
    rs_wgmma(d, hi[kk], bh);
  }
}

// hands a buffer back to the producer once this warp is done with it
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// a warpgroup splits n floats of a raw tile (by TMA) in place into their
// tf32 hi terms, and their lo terms to the same offsets of `lo` (so the
// same swizzle); the caller then fences and syncs the warpgroup
__device__ __forceinline__ void split_tile(float* x, float* lo, int n) {
  for (int i = (threadIdx.x % 128) * 4; i < n; i += 128 * 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    uint32_t h[4], l[4];
    split_tf32(v.x, h[0], l[0]);
    split_tf32(v.y, h[1], l[1]);
    split_tf32(v.z, h[2], l[2]);
    split_tf32(v.w, h[3], l[3]);
    *reinterpret_cast<uint4*>(x + i) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + i) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// ---------------------------------------------------------------- dK / dV --

constexpr int kKeys = 64;             // keys of a dK/dV block

// the columns of a direct tile: hd rounded up to whole 32-column boxes
template <int HD>
__host__ __device__ constexpr int padded() {
  return (HD + 31) / 32 * 32;
}

// consumer warpgroups (taking the steps in turn, each on its own stage),
// q rows of a step and the ring's depth, per instance: with one stage a
// second consumer would wait on the stage's barrier two rounds ahead,
// which its parity cannot tell from the round before
template <int HD>
__host__ __device__ constexpr int kv_consumers() {
  return HD == 128 ? 1 : 2;
}
template <int HD>
__host__ __device__ constexpr int step_q() {
  return HD <= 64 ? 32 : 16;
}
template <int HD>
__host__ __device__ constexpr int kv_stages() {
  return HD == 128 ? 1 : 2;
}

template <int HD, int HDP = padded<HD>(), int NQ = step_q<HD>()>
struct KvStage {
  // HDP / 32 column blocks of [NQ][32]; q and dout hold the raw tiles,
  // split in place into their hi terms
  float q[NQ * HDP];
  float q_lo[NQ * HDP];
  float dout[NQ * HDP];
  float dout_lo[NQ * HDP];
  // transposed: NQ / 16 column blocks of [hd][32]
  float qt[HD * 2 * NQ];
  float dot[HD * 2 * NQ];
};

template <int HD, int HDP = padded<HD>(), int NQ = step_q<HD>(),
          int kStages = kv_stages<HD>()>
struct DkdvSmem {
  // HDP / 32 column blocks of [64 keys][32]
  float k[kKeys * HDP];
  float k_lo[kKeys * HDP];
  float v[kKeys * HDP];
  float v_lo[kKeys * HDP];
  KvStage<HD> st[kStages];
  float lse2[kStages][NQ];      // lse * log2(e); 0 for rows >= S
  float delta[kStages][NQ];     // 0 for rows >= S
  uint64_t kv_full;
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

// query rows the one-consumer dK/dV accumulators sum before they are
// added into device memory (see the top of the file)
constexpr int kFlushRows = 2048;

// the maps of dkdv_kernel: the block's K and V (hi and lo each), the
// steps' raw Q and dO and Q^T, dO^T
struct DkdvMaps {
  CUtensorMap k, k_lo, v, v_lo, q, dout, qt, dot;
};

template <int HD>
__global__ void __launch_bounds__(128 * (kv_consumers<HD>() + 1), 1)
dkdv_kernel(const __grid_constant__ DkdvMaps maps,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk_out, float* __restrict__ dv_out, int B,
            int S, int H, int KV, float scale, int causal) {
  constexpr int HDP = padded<HD>();
  constexpr int kCols = HDP / 32;
  constexpr int NQ = step_q<HD>();
  constexpr int kStages = kv_stages<HD>();
  constexpr int kConsumers = kv_consumers<HD>();
  static_assert(kConsumers == 1 || kStages == kConsumers,
                "each consumer on its own stage");
  static_assert(sizeof(KvStage<HD>) * kStages >= HD * 128 * 4,
                "the stages hold warpgroup 1's dK and dV");
  extern __shared__ uint8_t smem_raw[];
  DkdvSmem<HD>& s = *reinterpret_cast<DkdvSmem<HD>*>(align_1024(smem_raw));

  const int group = H / KV;
  // the key tile is the grid's slowest axis: with causal masking the first
  // keys see the most queries, so the heaviest blocks are dispatched first
  const int bk = blockIdx.x % (B * KV);
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int k0 = (blockIdx.x / (B * KV)) * kKeys;
  const int q_begin = causal ? k0 : 0;
  const int q_tiles = (S - q_begin + NQ - 1) / NQ;
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
      mbar_init(&s.empty[st], 4);                  // the consumer's warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  // step n: head kvh * group + n / q_tiles, q rows q_begin + (n % q_tiles)
  // * NQ, in stage n % kStages, that stage's (n / kStages)-th round, taken
  // by consumer warpgroup n % kConsumers
  if (wg == kConsumers) {
    // producer: one warp
    if constexpr (kConsumers == 2) regs_dealloc<40>();
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(&s.kv_full, 4 * kKeys * HDP * 4);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int off = c * kKeys * 32;
          tma_load_4d(s.k + off, &maps.k, &s.kv_full, c * 32, kvh, k0, b);
          tma_load_4d(s.k_lo + off, &maps.k_lo, &s.kv_full, c * 32, kvh, k0,
                      b);
          tma_load_4d(s.v + off, &maps.v, &s.kv_full, c * 32, kvh, k0, b);
          tma_load_4d(s.v_lo + off, &maps.v_lo, &s.kv_full, c * 32, kvh, k0,
                      b);
        }
      }
      for (int n = 0; n < steps; ++n) {
        const int st = n % kStages;
        const int h = kvh * group + n / q_tiles;
        const int q0 = q_begin + (n % q_tiles) * NQ;
        mbar_wait(&s.empty[st], ((n / kStages) & 1) ^ 1);
        const size_t row0 = (static_cast<size_t>(b) * H + h) * S;
        for (int j = tid; j < NQ; j += 32) {
          const int q = q0 + j;
          s.lse2[st][j] = q < S ? lse[row0 + q] * kLog2e : 0.f;
          s.delta[st][j] = q < S ? delta[row0 + q] : 0.f;
        }
        // each lane's arrival releases its own lse / delta stores
        if (tid == 0) {
          KvStage<HD>& t = s.st[st];
          // raw Q and dO (NQ x HDP each), Q^T and dO^T (hd x 2 NQ each)
          mbar_expect_tx(&s.full[st], (2 * HDP + 4 * HD) * NQ * 4);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int off = c * NQ * 32;
            tma_load_4d(t.q + off, &maps.q, &s.full[st], c * 32, h, q0, b);
            tma_load_4d(t.dout + off, &maps.dout, &s.full[st], c * 32, h, q0,
                        b);
          }
#pragma unroll
          for (int j = 0; j < NQ / 16; ++j) {
            const int x = (q0 / 16 + j) * 32;
            tma_load_4d(t.qt + j * HD * 32, &maps.qt, &s.full[st], x, 0, h,
                        b);
            tma_load_4d(t.dot + j * HD * 32, &maps.dot, &s.full[st], x, 0, h,
                        b);
          }
        } else {
          mbar_arrive(&s.full[st]);
        }
      }
    }
  } else {
    // consumers: the block's 64 keys are the M dimension of every product
    if constexpr (kConsumers == 2) regs_alloc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int key0 = k0 + warp * 16 + lane / 4;     // and key0 + 8
    const float scale_log2 = scale * kLog2e;
    float dk[HD / 2], dv[HD / 2];
    // dK and dV in fp32 at this thread's keys (< S): stored, or added to
    // what an earlier call stored
    auto write = [&](bool add) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + r * 8;
        if (key >= S) continue;
        const size_t row =
            ((static_cast<size_t>(b) * S + key) * KV + kvh) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * (lane % 4);
          float2 k2 = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
          float2 v2 = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
          float2* ko = reinterpret_cast<float2*>(dk_out + row + col);
          float2* vo = reinterpret_cast<float2*>(dv_out + row + col);
          if (add) {
            const float2 k1 = *ko, v1 = *vo;
            k2 = make_float2(k1.x + k2.x, k1.y + k2.y);
            v2 = make_float2(v1.x + v2.x, v1.y + v2.y);
          }
          *ko = k2;
          *vo = v2;
        }
      }
    };
    // one consumer: query rows in the accumulators, and whether dK and dV
    // in device memory hold a sum yet
    [[maybe_unused]] int rows = 0;
    [[maybe_unused]] bool stored = false;
    float sacc[NQ / 2], dpacc[NQ / 2];
    uint32_t p_hi[NQ / 8][4], p_lo[NQ / 8][4];
    uint32_t ds_hi[NQ / 8][4], ds_lo[NQ / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) dk[j] = dv[j] = 0.f;
    mbar_wait(&s.kv_full, 0);

    for (int n = wg; n < steps; n += kConsumers) {
      const int st = n % kStages;
      const int q0 = q_begin + (n % q_tiles) * NQ;
      KvStage<HD>& t = s.st[st];
      mbar_wait(&s.full[st], (n / kStages) & 1);
      // the step's raw Q and dO into hi and lo, visible to the wgmma's proxy
      split_tile(t.q, t.q_lo, NQ * HDP);
      split_tile(t.dout, t.dout_lo, NQ * HDP);
      fence_proxy_async();
      bar_sync(2 + wg, 128);
      // S^T = K.Q^T and dP^T = V.dO^T, one commit group
      fence_regs(sacc);
      fence_regs(dpacc);
      wgmma_fence();
      issue_nt<HD>(sacc, s.k, s.k_lo, kKeys, t.q, t.q_lo);
      issue_nt<HD>(dpacc, s.v, s.v_lo, kKeys, t.dout, t.dout_lo);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dpacc);
      // P^T and dS^T: rows are keys, columns queries (lse, delta by column)
      const bool mask = (causal && q0 < k0 + kKeys) || q0 + NQ > S;
#pragma unroll
      for (int i = 0; i < NQ / 8; ++i) {
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
      split_a(p_hi, p_lo, sacc);
      split_a(ds_hi, ds_lo, dpacc);
      // dV += P^T.dO and dK += dS^T.Q
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
      issue_rs<NQ, HD>(dv, p_hi, p_lo, t.dot);
      issue_rs<NQ, HD>(dk, ds_hi, ds_lo, t.qt);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      release(&s.empty[st]);
      if constexpr (kConsumers == 1) {
        // at a head's last step, once kFlushRows query rows are summed (or
        // at the last step): the sums leave the wgmma accumulators for dK
        // and dV in device memory, added there by ordinary fp32 adds
        rows += NQ;
        if (n % q_tiles == q_tiles - 1 &&
            (rows >= kFlushRows || n + 1 == steps)) {
          write(stored);
          stored = true;
          rows = 0;
#pragma unroll
          for (int j = 0; j < HD / 2; ++j) dk[j] = dv[j] = 0.f;
        }
      }
    }

    // warpgroup 1's sums to warpgroup 0 through the stages' memory (named
    // barrier 1: both consumers are past their last step), added in order
    if constexpr (kConsumers == 2) {
      float* red = reinterpret_cast<float*>(&s.st[0]);
      bar_sync(1, 256);
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) {
          red[j * 128 + tid] = dk[j];
          red[(HD / 2 + j) * 128 + tid] = dv[j];
        }
      }
      bar_sync(1, 256);
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) {
          dk[j] += red[j * 128 + tid];
          dv[j] += red[(HD / 2 + j) * 128 + tid];
        }
      }
    }
    if (kConsumers == 2 && wg == 0) write(false);
  }
}

// -------------------------------------------------------------------- dQ --

// consumer warpgroups (64 rows each) and keys of a tile, per instance
template <int HD>
__host__ __device__ constexpr int dq_consumers() {
  return HD <= 64 ? 2 : 1;
}
template <int HD>
__host__ __device__ constexpr int dq_keys() {
  return HD <= 64 ? 32 : 16;
}
constexpr int kDqStages = 2;

template <int HD, int HDP = padded<HD>(), int NK = dq_keys<HD>()>
struct DqStage {
  // HDP / 32 column blocks of [NK][32]
  float k[NK * HDP];
  float k_lo[NK * HDP];
  float v[NK * HDP];
  float v_lo[NK * HDP];
  // K^T: NK / 16 column blocks of [hd][32]
  float kt[HD * 2 * NK];
};

template <int HD, int HDP = padded<HD>(), int ROWS = 64 * dq_consumers<HD>()>
struct DqSmem {
  // HDP / 32 column blocks of [ROWS][32]; q and dout hold the raw tiles,
  // split in place into their hi terms
  float q[ROWS * HDP];
  float q_lo[ROWS * HDP];
  float dout[ROWS * HDP];
  float dout_lo[ROWS * HDP];
  DqStage<HD> st[kDqStages];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
};

struct DqMaps {
  CUtensorMap q, dout, k, k_lo, v, v_lo, kt;
};

// dQ work item i (of B * H * q tiles) in the heaviest-first order
struct DqItem {
  int b, h, q0, tiles;
};
template <int ROWS, int NK>
__device__ __forceinline__ DqItem dq_item(int i, int B, int H, int S,
                                          int q_tiles, int causal) {
  DqItem it;
  const int bh = i % (B * H);
  it.b = bh / H;
  it.h = bh % H;
  it.q0 = (q_tiles - 1 - i / (B * H)) * ROWS;
  const int kv_end = causal ? min(S, it.q0 + ROWS) : S;
  it.tiles = (kv_end + NK - 1) / NK;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(128 * (dq_consumers<HD>() + 1), 1)
dq_kernel(const __grid_constant__ DqMaps maps, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq_out, int B,
          int S, int H, int KV, float scale, int causal) {
  constexpr int HDP = padded<HD>();
  constexpr int kCols = HDP / 32;
  constexpr int kConsumers = dq_consumers<HD>();
  constexpr int ROWS = 64 * kConsumers;
  constexpr int NK = dq_keys<HD>();
  extern __shared__ uint8_t smem_raw[];
  DqSmem<HD>& s = *reinterpret_cast<DqSmem<HD>*>(align_1024(smem_raw));

  const int q_tiles = (S + ROWS - 1) / ROWS;
  const int items = B * H * q_tiles;
  const int group = H / KV;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, kConsumers * 4);
    for (int st = 0; st < kDqStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // persistent: block i walks items i, i + gridDim.x, ...; key tiles are
  // counted across its items: tile g sits in stage g % kDqStages, in that
  // stage's (g / kDqStages)-th round
  if (wg == kConsumers) {
    // producer: one thread; an item's Q and dO once the previous item is
    // done with them, then its K, V and K^T tiles
    if constexpr (kConsumers == 2) regs_dealloc<40>();
    if (tid == 0) {
      int g = 0;
      int round = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
        const DqItem it = dq_item<ROWS, NK>(i, B, H, S, q_tiles, causal);
        const int kvh = it.h / group;
        mbar_wait(&s.q_empty, (round & 1) ^ 1);
        mbar_expect_tx(&s.q_full, 2 * ROWS * HDP * 4);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int off = c * ROWS * 32;
          tma_load_4d(s.q + off, &maps.q, &s.q_full, c * 32, it.h, it.q0,
                      it.b);
          tma_load_4d(s.dout + off, &maps.dout, &s.q_full, c * 32, it.h,
                      it.q0, it.b);
        }
        for (int n = 0; n < it.tiles; ++n, ++g) {
          const int st = g % kDqStages;
          DqStage<HD>& t = s.st[st];
          mbar_wait(&s.empty[st], ((g / kDqStages) & 1) ^ 1);
          // K, V raw hi and lo (NK x HDP each), K^T (hd x 2 NK)
          mbar_expect_tx(&s.full[st], (4 * HDP + 2 * HD) * NK * 4);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int off = c * NK * 32;
            tma_load_4d(t.k + off, &maps.k, &s.full[st], c * 32, kvh, n * NK,
                        it.b);
            tma_load_4d(t.k_lo + off, &maps.k_lo, &s.full[st], c * 32, kvh,
                        n * NK, it.b);
            tma_load_4d(t.v + off, &maps.v, &s.full[st], c * 32, kvh, n * NK,
                        it.b);
            tma_load_4d(t.v_lo + off, &maps.v_lo, &s.full[st], c * 32, kvh,
                        n * NK, it.b);
          }
#pragma unroll
          for (int j = 0; j < NK / 16; ++j)
            tma_load_4d(t.kt + j * HD * 32, &maps.kt, &s.full[st],
                        (n * NK / 16 + j) * 32, 0, kvh, it.b);
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    if constexpr (kConsumers == 2) regs_alloc<232>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const float scale_log2 = scale * kLog2e;
    const int arow = wg * 64 * 32;           // this warpgroup's rows
    float dq[HD / 2];
    float sacc[NK / 2], dpacc[NK / 2];
    uint32_t ds_hi[NK / 8][4], ds_lo[NK / 8][4];

    int g = 0;
    int round = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
      const DqItem it = dq_item<ROWS, NK>(i, B, H, S, q_tiles, causal);
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
      for (int j = 0; j < HD / 2; ++j) dq[j] = 0.f;
      mbar_wait(&s.q_full, round & 1);
      // this warpgroup's rows of the raw Q and dO into hi and lo
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int off = c * ROWS * 32 + arow;
        split_tile(s.q + off, s.q_lo + off, 64 * 32);
        split_tile(s.dout + off, s.dout_lo + off, 64 * 32);
      }
      fence_proxy_async();
      bar_sync(1 + wg, 128);

      for (int n = 0; n < it.tiles; ++n, ++g) {
        const int st = g % kDqStages;
        const DqStage<HD>& t = s.st[st];
        const int k0 = n * NK;
        mbar_wait(&s.full[st], (g / kDqStages) & 1);
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
        issue_nt<HD>(sacc, s.q + arow, s.q_lo + arow, ROWS, t.k, t.k_lo);
        issue_nt<HD>(dpacc, s.dout + arow, s.dout_lo + arow, ROWS, t.v,
                     t.v_lo);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sacc);
        fence_regs(dpacc);
        if (last) release(&s.q_empty);
        // dS: rows are queries (lse, delta per row), columns keys
        const bool mask = (causal && k0 + NK - 1 > q_first) || k0 + NK > S;
#pragma unroll
        for (int c = 0; c < NK / 8; ++c) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int key = k0 + 8 * c + 2 * (lane % 4) + (e & 1);
            float p = fast_exp2(fmaf(sacc[4 * c + e], scale_log2, -lse2[r]));
            if (mask && (key >= S || (causal && key > row0 + r * 8)))
              p = 0.f;
            dpacc[4 * c + e] = p * (dpacc[4 * c + e] - dl[r]) * scale;
          }
        }
        split_a(ds_hi, ds_lo, dpacc);
        // dQ += dS.K
        fence_regs(dq);
        wgmma_fence();
        issue_rs<NK, HD>(dq, ds_hi, ds_lo, t.kt);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(ds_hi);
        fence_regs(ds_lo);
        release(&s.empty[st]);
      }
      // dQ in fp32, rows < S
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = row0 + r * 8;
        if (q >= S) continue;
        float* row =
            dq_out + ((static_cast<size_t>(it.b) * S + q) * H + it.h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * (lane % 4);
          *reinterpret_cast<float2*>(row + col) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
      }
    }
  }
  // overlapped with dkdv_kernel: end after it, so that what follows in the
  // stream sees dK and dV
  pdl_wait();
}

// the scratch of one call (the wrapper allocates it): the direct splits
// [2][B,S,KV,hd] of k, v and the transposed splits [B,heads,hd,2*S16] of
// q, dO, k
struct Scratch {
  float *k, *v, *qt, *dot, *kt;
};

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* delta, float* dq,
              float* dk, float* dv, const Scratch& w, int B, int S, int H,
              int KV, int causal, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));

  SplitJobs jobs = {};
  jobs.job[0] = {q, nullptr, w.qt, nullptr, nullptr, H};
  jobs.job[1] = {dout, nullptr, w.dot, o, delta, H};
  jobs.job[2] = {k, w.k, w.kt, nullptr, nullptr, KV};
  jobs.job[3] = {v, w.v, nullptr, nullptr, nullptr, KV};
  jobs.n = 4;
  if (int e = launch_split<HD>(jobs, B, S, stream)) return e;

  const size_t nk = static_cast<size_t>(B) * S * KV * HD;
  constexpr int NQ = step_q<HD>();
  DkdvMaps km;
  int r = 0;
  if ((r = map_rows(&km.k, w.k, B, S, KV, HD, kKeys)) ||
      (r = map_rows(&km.k_lo, w.k + nk, B, S, KV, HD, kKeys)) ||
      (r = map_rows(&km.v, w.v, B, S, KV, HD, kKeys)) ||
      (r = map_rows(&km.v_lo, w.v + nk, B, S, KV, HD, kKeys)) ||
      (r = map_rows(&km.q, q, B, S, H, HD, NQ)) ||
      (r = map_rows(&km.dout, dout, B, S, H, HD, NQ)) ||
      (r = map_transposed(&km.qt, w.qt, B, S, H, HD)) ||
      (r = map_transposed(&km.dot, w.dot, B, S, H, HD)))
    return r;
  const size_t smem_kv = sizeof(DkdvSmem<HD>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (e != cudaSuccess) return static_cast<int>(e);
  const int key_tiles = (S + kKeys - 1) / kKeys;
  dkdv_kernel<HD><<<B * KV * key_tiles, 128 * (kv_consumers<HD>() + 1),
                    smem_kv, stream>>>(
      km, lse, delta, dk, dv, B, S, H, KV, scale, causal);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  constexpr int ROWS = 64 * dq_consumers<HD>();
  constexpr int NK = dq_keys<HD>();
  DqMaps qm;
  if ((r = map_rows(&qm.q, q, B, S, H, HD, ROWS)) ||
      (r = map_rows(&qm.dout, dout, B, S, H, HD, ROWS)) ||
      (r = map_rows(&qm.k, w.k, B, S, KV, HD, NK)) ||
      (r = map_rows(&qm.k_lo, w.k + nk, B, S, KV, HD, NK)) ||
      (r = map_rows(&qm.v, w.v, B, S, KV, HD, NK)) ||
      (r = map_rows(&qm.v_lo, w.v + nk, B, S, KV, HD, NK)) ||
      (r = map_transposed(&qm.kt, w.kt, B, S, KV, HD)))
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
  const int items = B * H * ((S + ROWS - 1) / ROWS);
  // overlapped with dkdv_kernel (programmatic dependent launch): dQ needs
  // only the pre-pass, which ran before dkdv_kernel
  return static_cast<int>(launch_overlapped(
      dq_kernel<HD>, dim3(min(items, sms)), dim3(128 * (dq_consumers<HD>() + 1)),
      smem_q, stream, qm, lse, static_cast<const float*>(delta), dq, B, S, H,
      KV, scale, causal));
}

}  // namespace

// q, o, dout, dq: [B,S,H,hd]; k, v, dk, dv: [B,S,KV,hd]; contiguous fp32,
// 16-byte aligned.  lse: [B,H,S] fp32 from the forward; delta: [B,H,S]
// fp32 scratch.  The split scratch: k_pair, v_pair [2][B,S,KV,hd], qt, dot
// [B,H,hd,2*S16], kt [B,KV,hd,2*S16] (flash_tf32_split.cuh).  Launches split_kernel, dkdv_kernel and dq_kernel
// in that order on `stream`.  Returns 0 or the first cudaError_t (a
// launch's, or the tensor maps').
extern "C" int flash_attention_bwd_tf32_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* k_pair, void* v_pair, void* qt, void* dot, void* kt,
    int B, int S, int H, int KV, int hd, int causal, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch w{static_cast<float*>(k_pair), static_cast<float*>(v_pair),
                  static_cast<float*>(qt), static_cast<float*>(dot),
                  static_cast<float*>(kt)};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* df = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  float* gq = static_cast<float*>(dq);
  float* gk = static_cast<float*>(dk);
  float* gv = static_cast<float*>(dv);
  if (hd == 8)
    return launch_hd<8>(qf, kf, vf, of, df, l, d, gq, gk, gv, w, B, S, H, KV,
                         causal, s);
  if (hd == 16)
    return launch_hd<16>(qf, kf, vf, of, df, l, d, gq, gk, gv, w, B, S, H, KV,
                         causal, s);
  if (hd == 32)
    return launch_hd<32>(qf, kf, vf, of, df, l, d, gq, gk, gv, w, B, S, H, KV,
                         causal, s);
  if (hd == 64)
    return launch_hd<64>(qf, kf, vf, of, df, l, d, gq, gk, gv, w, B, S, H, KV,
                         causal, s);
  if (hd == 80)
    return launch_hd<80>(qf, kf, vf, of, df, l, d, gq, gk, gv, w, B, S, H, KV,
                         causal, s);
  if (hd == 128)
    return launch_hd<128>(qf, kf, vf, of, df, l, d, gq, gk, gv, w, B, S, H,
                          KV, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
