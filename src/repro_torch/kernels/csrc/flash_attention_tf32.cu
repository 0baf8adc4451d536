// Causal / full GQA flash-attention forward in fp32 on the Hopper tensor
// cores as split TF32 (sm_90a): the fp32 route ("tf32x3") of the port's
// flash attention (bf16 takes flash_attention_wgmma.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _attn_kernel) for fp32 inputs: q [B,S,H,hd],
// k/v [B,S,KV,hd], KV head h // (H/KV), scale hd^-0.5 applied to the fp32
// scores, online softmax (o, m, l) in fp32 with NEG_INF = -1e30, the KV
// loop stopped at the causal frontier; o fp32 and, on request, the rows'
// log-sum-exp lse [B,H,S] of the scaled scores (what the backward needs).
//
// Arithmetic: each product X.Y is X_hi.Y_hi + X_hi.Y_lo + X_lo.Y_hi by
// m64nNk8 tf32 wgmma into an fp32 accumulator (hopper.cuh, split_tf32), so
// the result is held to a full-fp32 reference (3e-4), which one TF32 pass
// misses at S 1024.  The exponential is ex2.approx.
//
// Bound on an H100: operations, 4*B*H*hd flops per (query, key) pair (half
// the pairs when causal) at the TF32 tensor-core peak (495 TFLOP/s); the
// three passes make the design's floor three times that.
//
// Design (work item = a 128-row q tile of one (b, h); 384 threads):
//   * a pre-pass (flash_tf32_split.cuh) splits K into hi and lo [B,S,KV,hd]
//     and V into V^T, the keys contiguous, hi|lo per 16 keys, permuted
//     within each 8 so that P's accumulator fragment is its A fragment:
//     every q tile of every head of a group reads them again, so they are
//     split once (tf32 operands must be K-major: P.V reads V^T);
//   * persistent: one block per SM walks the items heaviest-first (the q
//     tile is the slowest axis, reversed), so that the loads of its next
//     item overlap the end of the current one;
//   * warpgroup 2 is the producer: one thread loads an item's raw q tile
//     once (when the previous item's last Q.K^T has freed the buffer) and
//     streams key tiles (K hi, K lo, V^T) by TMA through a ring of 2
//     stages of 64 keys (hd 64), 2 of 32 keys (hd 80; 184 KB) or 1 of 32
//     keys (hd 128; 192 KB at 64 and 128), with separate K and V barriers;
//   * warpgroups 0 and 1 own 64 q rows each: each splits its rows of the
//     raw q tile in place into hi and a lo buffer (the same offsets, so the
//     same swizzle); S = Q.K^T by m64nBKk8 with both operands in shared
//     memory; the mask where a tile crosses the diagonal or the end of the
//     sequence; the online softmax on the accumulator fragments in
//     registers; P split into hi and lo in registers is the A operand of
//     O += P.V (V^T hi|lo in shared memory), so P never touches shared
//     memory;
//   * within a warpgroup, tile n's Q.K^T is issued ahead of tile n-1's
//     P.V; the two consumer warpgroups take turns to issue (named
//     barriers), so that one's softmax overlaps the other's products.
// The 4-D tensor maps load rows >= S as zeros, so any S needs no other load
// path.  At hd 80 the q and K tiles are three 32-column boxes whose columns
// 80-95 lie past the maps' inner dim and load as zeros (never read: Q.K^T
// takes the 10 k8 steps of the real dims), and P.V runs at N 80 on V^T's 80
// rows.  At hd 8 and 16 the q and K tiles are one 32-column box, the
// columns past hd zero (never read: Q.K^T takes the hd / 8 k8 steps of the
// real dims), and P.V runs at N hd (m64n8k8, m64n16k8) on V^T's hd rows; hd
// 32 is one whole box; these take hd 64's key tiles of 64 in 2 stages.
// head_dim 8, 16, 32, 64, 80 and 128 are template instances; the wrapper
// refuses others.

#include "common.cuh"
#include "flash_tf32_split.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;
using namespace flare::tf32x3;

constexpr int kBlockQ = 128;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the columns of a q or K tile: hd rounded up to whole 32-column boxes
template <int HD>
__host__ __device__ constexpr int padded() {
  return (HD + 31) / 32 * 32;
}
// keys of a tile and the ring's depth, per instance (184-192 KB each at
// hd 64 and up)
template <int HD>
__host__ __device__ constexpr int block_k() {
  return HD <= 64 ? 64 : 32;
}
template <int HD>
__host__ __device__ constexpr int stages() {
  return HD == 128 ? 1 : 2;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int HDP = padded<HD>(), int BK = block_k<HD>(),
          int kStages = stages<HD>()>
struct Smem {
  // HDP / 32 column blocks of [rows][32]; q holds the raw tile, split in
  // place into its hi terms
  float q[kBlockQ * HDP];
  float q_lo[kBlockQ * HDP];
  float k[kStages][BK * HDP];
  float k_lo[kStages][BK * HDP];
  // V^T: BK / 16 column blocks of [hd][32] (16 keys' hi, then their lo)
  float v[kStages][HD * 2 * BK];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_empty[kStages];
};

// S[64,BK] (+)= Q[64,8] . K[BK,8]^T, by BK
__device__ __forceinline__ void qk_wgmma(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_m64n64k8_tf32_ss(d, da, db, scale_d);
}
__device__ __forceinline__ void qk_wgmma(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  wgmma_m64n32k8_tf32_ss(d, da, db, scale_d);
}
// O[64,hd] += P[64,8] (registers) . V[8,hd] (V^T K-major), by hd
__device__ __forceinline__ void pv_wgmma(float (&o)[4],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n8k8_tf32_rs(o, a, db, 1);
}
__device__ __forceinline__ void pv_wgmma(float (&o)[8],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n16k8_tf32_rs(o, a, db, 1);
}
__device__ __forceinline__ void pv_wgmma(float (&o)[16],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n32k8_tf32_rs(o, a, db, 1);
}
__device__ __forceinline__ void pv_wgmma(float (&o)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n64k8_tf32_rs(o, a, db, 1);
}
__device__ __forceinline__ void pv_wgmma(float (&o)[40],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n80k8_tf32_rs(o, a, db, 1);
}
__device__ __forceinline__ void pv_wgmma(float (&o)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n128k8_tf32_rs(o, a, db, 1);
}

// Work item i (of B * H * q tiles) of the heaviest-first order
struct Item {
  int b, h, q0, tiles;
};
template <int BK>
__device__ __forceinline__ Item item_at(int i, int B, int H, int S,
                                        int q_tiles, int causal) {
  Item it;
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
flash_tf32_kernel(__grid_constant__ const CUtensorMap map_q,
                  __grid_constant__ const CUtensorMap map_k,
                  __grid_constant__ const CUtensorMap map_klo,
                  __grid_constant__ const CUtensorMap map_vt,
                  float* __restrict__ o, float* __restrict__ lse, int B,
                  int S, int H, int KV, float scale_log2, int causal) {
  constexpr int HDP = padded<HD>();
  constexpr int kCols = HDP / 32;                      // column blocks
  constexpr int BK = block_k<HD>();
  constexpr int kStages = stages<HD>();
  extern __shared__ uint8_t smem_raw[];
  Smem<HD>& s = *reinterpret_cast<Smem<HD>*>(align_1024(smem_raw));

  const int q_tiles = (S + kBlockQ - 1) / kBlockQ;
  const int items = B * H * q_tiles;
  const int group = H / KV;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    mbar_init(&s.q_empty, kConsumers * 4);         // lane 0 of each warp
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.k_full[st], 1);
      mbar_init(&s.v_full[st], 1);
      mbar_init(&s.k_empty[st], kConsumers * 4);
      mbar_init(&s.v_empty[st], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // key tiles are counted across the block's items: tile g sits in stage
  // g % kStages, in that stage's (g / kStages)-th round
  if (wg == kConsumers) {
    // producer
    regs_dealloc<24>();
    if (tid == 0) {
      int g = 0;
      int round = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
        const Item it = item_at<BK>(i, B, H, S, q_tiles, causal);
        const int kvh = it.h / group;
        mbar_wait(&s.q_empty, (round & 1) ^ 1);
        mbar_expect_tx(&s.q_full, kBlockQ * HDP * 4);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          tma_load_4d(s.q + c * kBlockQ * 32, &map_q, &s.q_full, c * 32,
                      it.h, it.q0, it.b);
        for (int n = 0; n < it.tiles; ++n, ++g) {
          const int st = g % kStages;
          const uint32_t ph = ((g / kStages) & 1) ^ 1;
          mbar_wait(&s.k_empty[st], ph);
          mbar_expect_tx(&s.k_full[st], 2 * BK * HDP * 4);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            tma_load_4d(s.k[st] + c * BK * 32, &map_k, &s.k_full[st],
                        c * 32, kvh, n * BK, it.b);
            tma_load_4d(s.k_lo[st] + c * BK * 32, &map_klo, &s.k_full[st],
                        c * 32, kvh, n * BK, it.b);
          }
          mbar_wait(&s.v_empty[st], ph);
          mbar_expect_tx(&s.v_full[st], 2 * BK * HD * 4);
#pragma unroll
          for (int j = 0; j < BK / 16; ++j)
            tma_load_4d(s.v[st] + j * HD * 32, &map_vt, &s.v_full[st],
                        (n * BK / 16 + j) * 32, 0, kvh, it.b);
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    regs_alloc<240>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;   // and r0 + 8
    float oacc[HD / 2];
    float m[2], l[2];
    float sacc[BK / 2];
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
    float alpha[2];
    int qpos0 = 0;
    int qfirst = 0;
    int tiles = 0;

    // this warpgroup's 64 rows of the raw q tile into hi (in place) and lo
    auto split_q = [&]() {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int base = c * kBlockQ * 32 + wg * 64 * 32;
        for (int i = tid * 4; i < 64 * 32; i += 128 * 4) {
          const float4 x = *reinterpret_cast<const float4*>(s.q + base + i);
          uint32_t h[4], lo[4];
          split_tf32(x.x, h[0], lo[0]);
          split_tf32(x.y, h[1], lo[1]);
          split_tf32(x.z, h[2], lo[2]);
          split_tf32(x.w, h[3], lo[3]);
          *reinterpret_cast<uint4*>(s.q + base + i) =
              make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(s.q_lo + base + i) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      }
      fence_proxy_async();               // the writes, to the wgmma's proxy
      bar_sync(3 + wg, 128);
    };
    // S = Q.K^T over hd, three passes a k8 step, issued and committed
    auto issue_qk = [&](int st) {
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        const int off = (kk / 4) * kBlockQ * 32 + wg * 64 * 32 + (kk % 4) * 8;
        const int koff = (kk / 4) * BK * 32 + (kk % 4) * 8;
        const uint64_t qh = desc_sw128(s.q + off, 16, 1024);
        const uint64_t ql = desc_sw128(s.q_lo + off, 16, 1024);
        const uint64_t kh = desc_sw128(s.k[st] + koff, 16, 1024);
        const uint64_t kl = desc_sw128(s.k_lo[st] + koff, 16, 1024);
        qk_wgmma(sacc, qh, kl, kk > 0);
        qk_wgmma(sacc, ql, kh, 1);
        qk_wgmma(sacc, qh, kh, 1);
      }
      wgmma_commit();
      fence_regs(sacc);
    };
    // O += P.V over the BK keys, issued and committed: k8 step kk reads the
    // hi of 16-key block kk / 2 at byte 32 (kk % 2), its lo 64 bytes on
    auto issue_pv = [&](int st) {
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const float* vb = s.v[st] + (kk / 2) * HD * 32 + (kk % 2) * 8;
        const uint64_t vh = desc_sw128(vb, 16, 1024);
        const uint64_t vl = desc_sw128(vb + 16, 16, 1024);
        pv_wgmma(oacc, p_hi[kk], vl);
        pv_wgmma(oacc, p_lo[kk], vh);
        pv_wgmma(oacc, p_hi[kk], vh);
      }
      wgmma_commit();
      fence_regs(oacc);
    };
    // the mask where tile n crosses this warpgroup's diagonal or the end of
    // the sequence, then the online softmax of the two rows this thread
    // holds: sacc becomes P (fp32), alpha the rescale of O
    auto softmax = [&](int n) {
      const int k0 = n * BK;
      if (k0 + BK > S || (causal && k0 + BK - 1 > qfirst)) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + i * 8 + 2 * (lane % 4) + (e & 1);
            const int qpos = qpos0 + (e >> 1) * 8;
            if (key >= S || (causal && key > qpos)) sacc[4 * i + e] = kNegInf;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
          mx = fmaxf(mx, fmaxf(sacc[4 * i + 2 * r], sacc[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = fast_exp2((m[r] - mx) * scale_log2);
        m[r] = mx;
        const float bias = mx * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe =
                fast_exp2(fmaf(sacc[4 * i + 2 * r + e], scale_log2, -bias));
            sacc[4 * i + 2 * r + e] = pe;
            sum += pe;
          }
        }
        l[r] = l[r] * alpha[r] + sum;   // this lane's share of the row
      }
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
      __syncwarp();
    };
    // the two warpgroups take turns to issue their products (named
    // barriers 1 and 2); warpgroup 0 goes first
    auto my_turn = [&]() { bar_sync(1 + wg, 256); };
    auto your_turn = [&]() { bar_arrive(2 - wg, 256); };
    if (wg == 1) your_turn();

    int g = 0;
    int round = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
      const Item it = item_at<BK>(i, B, H, S, q_tiles, causal);
      tiles = it.tiles;
      qpos0 = it.q0 + r0;
      qfirst = it.q0 + wg * 64;
#pragma unroll
      for (int j = 0; j < HD / 2; ++j) oacc[j] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;

      // tile 0: the q split, S, softmax, P
      mbar_wait(&s.q_full, round & 1);
      split_q();
      mbar_wait(&s.k_full[g % kStages], (g / kStages) & 1);
      my_turn();
      issue_qk(g % kStages);
      your_turn();
      wgmma_wait<0>();
      fence_regs(sacc);
      release(&s.k_empty[g % kStages]);
      if (tiles == 1) release(&s.q_empty);
      softmax(0);
      split_a(p_hi, p_lo, sacc);
      // tile n: S_n is issued ahead of P_{n-1}.V_{n-1}, and the softmax of
      // S_n runs while that product is on the tensor cores
      for (int n = 1; n < tiles; ++n) {
        const int st = (g + n) % kStages;
        const int pst = (g + n - 1) % kStages;
        mbar_wait(&s.k_full[st], ((g + n) / kStages) & 1);
        mbar_wait(&s.v_full[pst], ((g + n - 1) / kStages) & 1);
        my_turn();
        issue_qk(st);
        issue_pv(pst);
        your_turn();
        wgmma_wait<1>();               // S_n is done
        fence_regs(sacc);
        release(&s.k_empty[st]);
        if (n == tiles - 1) release(&s.q_empty);
        softmax(n);
        wgmma_wait<0>();               // P_{n-1}.V_{n-1} is done
        fence_regs(oacc);
        fence_regs(p_hi);
        fence_regs(p_lo);
        release(&s.v_empty[pst]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          oacc[4 * j] *= alpha[0];
          oacc[4 * j + 1] *= alpha[0];
          oacc[4 * j + 2] *= alpha[1];
          oacc[4 * j + 3] *= alpha[1];
        }
        split_a(p_hi, p_lo, sacc);
      }
      const int lst = (g + tiles - 1) % kStages;
      mbar_wait(&s.v_full[lst], ((g + tiles - 1) / kStages) & 1);
      my_turn();
      issue_pv(lst);
      // warpgroup 1 takes no turn after the block's last item
      if (wg == 0 || i + gridDim.x < items) your_turn();
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      release(&s.v_empty[lst]);
      g += tiles;

      // the row sums over the 4 lanes of a row; o / l in fp32, rows < S
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float t = l[r];
        t += __shfl_xor_sync(0xffffffffu, t, 1);
        t += __shfl_xor_sync(0xffffffffu, t, 2);
        const float inv = 1.f / fmaxf(t, 1e-30f);
        const int qpos = qpos0 + r * 8;
        if (qpos >= S) continue;
        // lse in the scaled-score domain: m is the raw score max, and the
        // exponentials took (s - m) * scale
        if (lse != nullptr && lane % 4 == 0)
          lse[(static_cast<size_t>(it.b) * H + it.h) * S + qpos] =
              m[r] * (scale_log2 / kLog2e) + logf(fmaxf(t, 1e-30f));
        float* orow = o + (static_cast<size_t>(it.b * S + qpos) * H + it.h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * (lane % 4);
          *reinterpret_cast<float2*>(orow + col) = make_float2(
              oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

template <int HD>
int launch_hd(const float* q, const float* k, const float* v, float* o,
              float* lse, float* k_pair, float* vt, int B, int S, int H,
              int KV, int causal, cudaStream_t stream) {
  constexpr int BK = block_k<HD>();
  // the pre-pass: K hi and lo, V^T split
  SplitJobs jobs = {};
  jobs.job[0] = {k, k_pair, nullptr, nullptr, nullptr, KV};
  jobs.job[1] = {v, nullptr, vt, nullptr, nullptr, KV};
  jobs.n = 2;
  if (int e = launch_split<HD>(jobs, B, S, stream)) return e;

  const size_t n = static_cast<size_t>(B) * S * KV * HD;
  CUtensorMap mq, mk, mkl, mv;
  if (int e = map_rows(&mq, q, B, S, H, HD, kBlockQ)) return e;
  if (int e = map_rows(&mk, k_pair, B, S, KV, HD, BK)) return e;
  if (int e = map_rows(&mkl, k_pair + n, B, S, KV, HD, BK)) return e;
  if (int e = map_transposed(&mv, vt, B, S, KV, HD)) return e;
  const size_t smem = sizeof(Smem<HD>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tf32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // persistent: one block per SM, each walks the work items
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int items = B * H * ((S + kBlockQ - 1) / kBlockQ);
  const float scale_log2 = kLog2e / sqrtf(static_cast<float>(HD));
  flash_tf32_kernel<HD><<<min(items, sms), kThreads, smem, stream>>>(
      mq, mk, mkl, mv, o, lse, B, S, H, KV, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B,S,H,hd]; k, v: [B,S,KV,hd]; contiguous fp32, 16-byte aligned.
// lse: [B,H,S] fp32, the rows' log-sum-exp of the scaled scores, or null
// to write none (serving).  Scratch the wrapper allocates: k_pair
// [2][B,S,KV,hd] (K's tf32 hi, then lo), vt [B,KV,hd,2*S16] (V^T split,
// flash_tf32_split.cuh).  Launches the pre-pass and the kernel on
// `stream`.  Returns 0 or a cudaError_t (a launch's, or the tensor maps').
extern "C" int flash_attention_tf32_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           void* k_pair, void* vt, int B,
                                           int S, int H, int KV, int hd,
                                           int causal, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* l = static_cast<float*>(lse);
  float* kp = static_cast<float*>(k_pair);
  float* t = static_cast<float*>(vt);
  if (hd == 8)
    return launch_hd<8>(qf, kf, vf, of, l, kp, t, B, S, H, KV, causal, s);
  if (hd == 16)
    return launch_hd<16>(qf, kf, vf, of, l, kp, t, B, S, H, KV, causal, s);
  if (hd == 32)
    return launch_hd<32>(qf, kf, vf, of, l, kp, t, B, S, H, KV, causal, s);
  if (hd == 64)
    return launch_hd<64>(qf, kf, vf, of, l, kp, t, B, S, H, KV, causal, s);
  if (hd == 80)
    return launch_hd<80>(qf, kf, vf, of, l, kp, t, B, S, H, KV, causal, s);
  if (hd == 128)
    return launch_hd<128>(qf, kf, vf, of, l, kp, t, B, S, H, KV, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
