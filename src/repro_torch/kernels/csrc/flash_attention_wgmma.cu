// Causal / full GQA flash-attention forward in bf16 on the Hopper tensor
// cores (sm_90a): the bf16 route of the port's flash attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _attn_kernel) for bf16 inputs: q [B,S,H,hd],
// k/v [B,S,KV,hd], KV head h // (H/KV), scale hd^-0.5 applied to the fp32
// scores, online softmax (o, m, l) in fp32 with NEG_INF = -1e30, the KV
// loop stopped at the causal frontier.  The one rounding the reference does
// not make: P is rounded to bf16 before P.V (about 2^-9 |v| on o).
// (fp32 inputs take flash_attention_tf32.cu, in split TF32.)
//
// Bound on an H100: operations, 4*B*H*hd flops per (query, key) pair
// (half the pairs when causal); at the serving shape (B 8, S 1024, H 32,
// hd 64) ~35 us of tensor-core time against ~25 us of memory time.
//
// Design (work item = a 128-row q tile of one (b, h); 384 threads):
//   * persistent: one block per SM walks the items in the heaviest-first
//     order (the q tile is the slowest axis, reversed, so the causal tiles
//     with the most keys go first), so that the loads of its next item
//     overlap the end of the current one;
//   * warpgroup 2 is the producer: one thread loads an item's q tile once
//     (when the previous item's last Q.K^T has freed the buffer) and
//     streams 128-key K and V tiles by TMA through a ring of 3 stages
//     (hd 64) or 2 (hd 80, 128), with separate K and V barriers: Q.K^T starts
//     before V lands, and a K buffer is refilled as soon as its Q.K^T is
//     done, a tile before its V buffer;
//   * the tensor maps are 4-D over [B,S,H(KV),hd] with a box of
//     (64 dims, 1 head, 128 rows, 1 batch): rows >= S of a batch load as
//     zeros, so any S needs no other load path; hd 128 is two such boxes
//     (two 128-byte swizzle rows) per tile, and so is hd 80: the second
//     box's columns 80-127 lie past the map's inner dim and load as zeros,
//     so the tiles are hd 128's; Q.K^T reads only the 5 k16 steps of the
//     real dims, P.V runs at N 128 and its zero columns are not stored;
//     head_dim 8, 16 and 32 (the JAX package's reduced configs and its
//     kernel sweep) are one box of 64 columns the same way: the columns
//     past hd load as zeros, Q.K^T takes ceil(hd / 16) k16 steps (at hd 8
//     the step's columns 8-15 are zeros), P.V runs at N 64, and only the
//     hd real columns of o are stored; the tensor cores do 64 / hd times
//     the P.V work the function needs there, and Q.K^T up to twice;
//   * warpgroups 0 and 1 own 64 q rows each: S = Q.K^T by m64n128k16 wgmma
//     with both operands in shared memory (K [keys,hd] is K-major); the
//     mask (keys >= S, and keys after the query when causal) only on the
//     last tile, which holds the diagonal; the online softmax on the fp32
//     accumulator fragments in registers (row max and sum over the 4
//     lanes that share a row); P rounded to bf16 in registers is the
//     register A operand of O += P.V (V [keys,hd] is MN-major: the
//     transpose-B bit), so P never touches shared memory;
//   * within a warpgroup, tile n's Q.K^T is issued ahead of tile n-1's
//     P.V, and tile n's softmax runs while that P.V is on the tensor
//     cores; O is rescaled once it has landed;
//   * the two consumer warpgroups take turns to issue (named barriers),
//     so that one's softmax overlaps the other's products.
// head_dim 8, 16, 32, 64, 80 and 128 are template instances; the wrapper
// refuses others.

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace flare::hopper;

constexpr int kBlockQ = 128;
constexpr int kBlockK = 128;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// the columns of a tile: hd rounded up to whole 64-column boxes
template <int HD>
__host__ __device__ constexpr int padded() {
  return (HD + 63) / 64 * 64;
}

// K/V ring depth: 3 stages at hd 64 (112 KB), 2 at hd 80 and 128 (160 KB)
template <int HD>
__host__ __device__ constexpr int stages() {
  return padded<HD>() == 64 ? 3 : 2;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int HDP = padded<HD>(), int kStages = stages<HD>()>
struct Smem {
  // HDP / 64 column blocks of [rows][64] each
  __nv_bfloat16 q[kBlockQ * HDP];
  __nv_bfloat16 k[kStages][kBlockK * HDP];
  __nv_bfloat16 v[kStages][kBlockK * HDP];
  uint64_t q_full;
  uint64_t q_empty;
  uint64_t k_full[kStages];
  uint64_t v_full[kStages];
  uint64_t k_empty[kStages];
  uint64_t v_empty[kStages];
};

// O[64,hd] += P[64,16] (registers) * V[16,hd] (MN-major), by hd
__device__ __forceinline__ void pv_wgmma(float (&o)[32],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n64k16_rs<1>(o, a, db, 1);
}
__device__ __forceinline__ void pv_wgmma(float (&o)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  wgmma_m64n128k16_rs<1>(o, a, db, 1);
}

// Work item i (of B * H * q tiles) of the heaviest-first order: the q tile
// is the slowest axis, reversed, so causal tiles with the most keys go first
struct Item {
  int b, h, q0, tiles;
};
__device__ __forceinline__ Item item_at(int i, int B, int H, int S,
                                        int q_tiles, int causal) {
  Item it;
  const int bh = i % (B * H);
  it.b = bh / H;
  it.h = bh % H;
  it.q0 = (q_tiles - 1 - i / (B * H)) * kBlockQ;
  const int kv_end = causal ? min(S, it.q0 + kBlockQ) : S;
  it.tiles = (kv_end + kBlockK - 1) / kBlockK;
  return it;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(__grid_constant__ const CUtensorMap map_q,
                   __grid_constant__ const CUtensorMap map_k,
                   __grid_constant__ const CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int B, int S, int H, int KV, float scale_log2, int causal) {
  constexpr int HDP = padded<HD>();
  constexpr int kCols = HDP / 64;                      // column blocks
  constexpr int kStages = stages<HD>();
  constexpr uint32_t kTileBytes = kBlockK * HDP * 2;
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

  // K/V tiles are counted across the block's items: tile g sits in stage
  // g % kStages, in that stage's (g / kStages)-th round
  if (wg == kConsumers) {
    // producer
    regs_dealloc<24>();
    if (tid == 0) {
      int g = 0;
      int round = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
        const Item it = item_at(i, B, H, S, q_tiles, causal);
        const int kvh = it.h / group;
        // the previous item's last Q.K^T is done with the q buffer
        mbar_wait(&s.q_empty, (round & 1) ^ 1);
        mbar_expect_tx(&s.q_full, kBlockQ * HDP * 2);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          tma_load_4d(s.q + c * kBlockQ * 64, &map_q, &s.q_full, c * 64, it.h,
                      it.q0, it.b);
        for (int n = 0; n < it.tiles; ++n, ++g) {
          const int st = g % kStages;
          const uint32_t ph = ((g / kStages) & 1) ^ 1;
          mbar_wait(&s.k_empty[st], ph);
          mbar_expect_tx(&s.k_full[st], kTileBytes);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            tma_load_4d(s.k[st] + c * kBlockK * 64, &map_k, &s.k_full[st],
                        c * 64, kvh, n * kBlockK, it.b);
          mbar_wait(&s.v_empty[st], ph);
          mbar_expect_tx(&s.v_full[st], kTileBytes);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            tma_load_4d(s.v[st] + c * kBlockK * 64, &map_v, &s.v_full[st],
                        c * 64, kvh, n * kBlockK, it.b);
        }
      }
    }
  } else {
    // consumers: 64 q rows each
    regs_alloc<240>();
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;   // and r0 + 8
    float oacc[HDP / 2];
    float m[2], l[2];
    float sacc[kBlockK / 2];
    uint32_t p[kBlockK / 16][4];
    float alpha[2];
    int qpos0 = 0;
    int tiles = 0;

    // S = Q.K^T over hd (64 rows x 128 keys), issued and committed: the
    // k16 steps of the real dims only (the last one half zeros at hd 8)
    auto issue_qk = [&](int st) {
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < (HD + 15) / 16; ++kk) {
        const int c = kk / 4;
        const int off = (kk % 4) * 16;
        const uint64_t da = desc_sw128(
            s.q + c * kBlockQ * 64 + wg * 64 * 64 + off, 16, 1024);
        const uint64_t db =
            desc_sw128(s.k[st] + c * kBlockK * 64 + off, 16, 1024);
        wgmma_m64n128k16_ss<0>(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      fence_regs(sacc);
    };
    // O += P.V over the 128 keys, issued and committed: V's k16 step is 16
    // rows of 128 bytes, its next 64 dims one column block on
    auto issue_pv = [&](int st) {
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint64_t db =
            desc_sw128(s.v[st] + kk * 16 * 64, kBlockK * 128, 1024);
        pv_wgmma(oacc, p[kk], db);
      }
      wgmma_commit();
      fence_regs(oacc);
    };
    // the mask on the last tile, then the online softmax of the two rows
    // this thread holds: sacc becomes P (fp32), alpha the rescale of O
    auto softmax = [&](int n) {
      if (n == tiles - 1) {
#pragma unroll
        for (int i = 0; i < kBlockK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = n * kBlockK + i * 8 + 2 * (lane % 4) + (e & 1);
            const int qpos = qpos0 + (e >> 1) * 8;
            if (key >= S || (causal && key > qpos)) sacc[4 * i + e] = kNegInf;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 0; i < kBlockK / 8; ++i)
          mx = fmaxf(mx, fmaxf(sacc[4 * i + 2 * r], sacc[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = fast_exp2((m[r] - mx) * scale_log2);
        m[r] = mx;
        const float bias = mx * scale_log2;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kBlockK / 8; ++i) {
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
    // P in bf16: the accumulator fragment of S is the A fragment of P.V
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        p[kk][0] = pack_bf16x2(sacc[8 * kk], sacc[8 * kk + 1]);
        p[kk][1] = pack_bf16x2(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        p[kk][2] = pack_bf16x2(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        p[kk][3] = pack_bf16x2(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    // a q, K or V buffer goes back to the producer once its product is done
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
      __syncwarp();
    };
    // the two warpgroups take turns to issue their products (named
    // barriers 1 and 2), so that one's softmax runs while the other's
    // products are on the tensor cores; warpgroup 0 goes first
    auto my_turn = [&]() { bar_sync(1 + wg, 256); };
    auto your_turn = [&]() { bar_arrive(2 - wg, 256); };
    if (wg == 1) your_turn();

    int g = 0;
    int round = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x, ++round) {
      const Item it = item_at(i, B, H, S, q_tiles, causal);
      tiles = it.tiles;
      qpos0 = it.q0 + r0;
#pragma unroll
      for (int j = 0; j < HDP / 2; ++j) oacc[j] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;

      // tile 0: S, softmax, P
      mbar_wait(&s.q_full, round & 1);
      mbar_wait(&s.k_full[g % kStages], (g / kStages) & 1);
      my_turn();
      issue_qk(g % kStages);
      your_turn();
      wgmma_wait<0>();
      fence_regs(sacc);
      release(&s.k_empty[g % kStages]);
      if (tiles == 1) release(&s.q_empty);
      softmax(0);
      pack_p();
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
        release(&s.v_empty[pst]);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          oacc[4 * j] *= alpha[0];
          oacc[4 * j + 1] *= alpha[0];
          oacc[4 * j + 2] *= alpha[1];
          oacc[4 * j + 3] *= alpha[1];
        }
        pack_p();
      }
      const int lst = (g + tiles - 1) % kStages;
      mbar_wait(&s.v_full[lst], ((g + tiles - 1) / kStages) & 1);
      my_turn();
      issue_pv(lst);
      // warpgroup 1 takes no turn after the block's last item
      if (wg == 0 || i + gridDim.x < items) your_turn();
      wgmma_wait<0>();
      fence_regs(oacc);
      release(&s.v_empty[lst]);
      g += tiles;

      // the row sums over the 4 lanes of a row; o / l in bf16, rows < S
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
        __nv_bfloat16* orow =
            o + (static_cast<size_t>(it.b * S + qpos) * H + it.h) * HD;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          const int col = j * 8 + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16x2(
              oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
        }
      }
    }
  }
}

// [B,S,heads,hd] bf16 as a 4-D tensor map (hd, heads, S, B) with a box of
// (64, 1, 128, 1)
int make_map(CUtensorMap* map, const void* p, int B, int S, int heads,
             int hd) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads,
                                 row * heads * static_cast<cuuint64_t>(S)};
  const cuuint32_t box[4] = {64, 1, kBlockQ, 1};
  return make_map_bf16(map, p, 4, dims, strides, box);
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int S, int H, int KV, int causal, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (int e = make_map(&mq, q, B, S, H, HD)) return e;
  if (int e = make_map(&mk, k, B, S, KV, HD)) return e;
  if (int e = make_map(&mv, v, B, S, KV, HD)) return e;
  const size_t smem = sizeof(Smem<HD>) + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  flash_wgmma_kernel<HD><<<min(items, sms), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, B, S, H, KV,
      scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B,S,H,hd]; k, v: [B,S,KV,hd]; contiguous bf16, 16-byte aligned.
// lse: [B,H,S] fp32, the rows' log-sum-exp of the scaled scores (what the
// backward needs), or null to write none (serving).
// Returns 0 or a cudaError_t (the launch's, or the tensor maps').
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            int B, int S, int H, int KV,
                                            int hd, int causal, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 8) return launch_hd<8>(q, k, v, o, l, B, S, H, KV, causal, s);
  if (hd == 16) return launch_hd<16>(q, k, v, o, l, B, S, H, KV, causal, s);
  if (hd == 32) return launch_hd<32>(q, k, v, o, l, B, S, H, KV, causal, s);
  if (hd == 64) return launch_hd<64>(q, k, v, o, l, B, S, H, KV, causal, s);
  if (hd == 80) return launch_hd<80>(q, k, v, o, l, B, S, H, KV, causal, s);
  if (hd == 128) return launch_hd<128>(q, k, v, o, l, B, S, H, KV, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
