// Blocked causal / full GQA flash-attention forward for Hopper (sm_90a) on
// the FP32 pipes: the fp32 route of the port's flash attention (bf16 takes
// flash_attention_wgmma.cu).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _attn_kernel): q [B,S,H,hd], k/v [B,S,KV,hd],
// KV head h // (H/KV), scale hd^-0.5, online softmax (o, m, l) in fp32 with
// NEG_INF = -1e30, KV loop stopped at the causal frontier.
//
// Bound on an H100: operations.  4*B*S^2*H*hd flops (half of it when
// causal) against ~(2*B*S*H*hd + 2*B*S*KV*hd) * itemsize bytes; at the
// serving shape (B 8, S 1024, H 32, hd 64, bf16) that is ~35 us of tensor-core
// time against ~25 us of memory time.
//
// It runs on the FP32 pipes on purpose, so that its fp32 result is held to
// a full-fp32 reference and not to TF32; it sits well above the bound.
// Design:
//   * grid (ceil(S/64), H, B): one block per 64-row q tile of one head;
//     blocks run in any order, so the TPU grid's sequential axis becomes the
//     KV loop inside the block;
//   * hd/32 threads per q row, each holding 32 of the row's dims of q (scaled)
//     and of the output accumulator in registers, as float4 chunks;
//   * K/V tiles of 32 rows are staged in shared memory as fp32; a thread
//     reads them as float4 (four FMAs per shared load), and the threads of
//     a row sum their partial dot products with warp shuffles;
//   * the kernel masks the ragged edge itself (keys and queries >= S), so
//     any S works: serving prompts have arbitrary lengths, and the TPU
//     kernel's S % block requirement is dropped.
// head_dim 64 and 128 are template instances; the wrapper refuses others.

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kDimsPerThread = 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBlockQ * (HD / kDimsPerThread))
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int S, int H, int KV,
                           float sm_scale, int causal) {
  constexpr int TPR = HD / kDimsPerThread;  // threads per q row
  constexpr int NCH = kDimsPerThread / 4;   // float4 chunks per thread
  constexpr int NT = kBlockQ * TPR;
  constexpr int C4 = HD / 4;                // float4 chunks per row
  __shared__ float4 ks[kBlockK][C4];
  __shared__ float4 vs[kBlockK][C4];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBlockQ;
  const int qpos = q0 + row;
  const bool valid = qpos < S;

  const size_t q_stride = static_cast<size_t>(H) * HD;   // per position
  const size_t kv_stride = static_cast<size_t>(KV) * HD;
  const size_t q_off = (static_cast<size_t>(b) * S + qpos) * q_stride +
                       static_cast<size_t>(h) * HD;
  const size_t kv_base = static_cast<size_t>(b) * S * kv_stride +
                         static_cast<size_t>(kvh) * HD;

  float4 qr[NCH], acc[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int d = 4 * (lane + TPR * c);
    float4 t = valid ? flare::Pack4<T>::load(q + q_off + d)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c] = make_float4(t.x * sm_scale, t.y * sm_scale, t.z * sm_scale,
                        t.w * sm_scale);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf;
  float l = 0.f;

  const int kv_end = causal ? min(S, q0 + kBlockQ) : S;
  for (int t0 = 0; t0 < kv_end; t0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kBlockK * C4; i += NT) {
      const int r = i / C4;
      const int c4 = i % C4;
      const int t = t0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (t < S) {
        const size_t off = kv_base + static_cast<size_t>(t) * kv_stride + 4 * c4;
        kk = flare::Pack4<T>::load(k + off);
        vv = flare::Pack4<T>::load(v + off);
      }
      ks[r][c4] = kk;
      vs[r][c4] = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) part = dot4(qr[c], ks[j][lane + TPR * c], part);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      const int t = t0 + j;
      if (t >= S || (causal && t > qpos)) part = kNegInf;
      s[j] = part;
      tile_max = fmaxf(tile_max, part);
    }

    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 vv = vs[j][lane + TPR * c];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (valid) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    // lse in the scaled-score domain (q was scaled on load), [B,H,S]
    if (lse != nullptr && lane == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qpos] =
          m + logf(fmaxf(l, 1e-30f));
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = 4 * (lane + TPR * c);
      flare::Pack4<T>::store(o + q_off + d,
                             make_float4(acc[c].x * inv, acc[c].y * inv,
                                         acc[c].z * inv, acc[c].w * inv));
    }
  }
}

template <typename T, int HD>
void launch_typed(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int S, int H, int KV, int causal,
                  cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  const int threads = kBlockQ * (HD / kDimsPerThread);
  const float sm_scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_attention_fwd_kernel<T, HD><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, H, KV, sm_scale,
      causal);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, float* lse,
              int B, int S, int H, int KV, int hd, int causal,
              cudaStream_t stream) {
  if (hd == 64)
    launch_typed<T, 64>(q, k, v, o, lse, B, S, H, KV, causal, stream);
  else if (hd == 128)
    launch_typed<T, 128>(q, k, v, o, lse, B, S, H, KV, causal, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: [B,S,H,hd]; k, v: [B,S,KV,hd]; all contiguous fp32 and 16-byte
// aligned.  lse: [B,H,S] fp32, the rows' log-sum-exp of the scaled scores
// (what the backward needs), or null to write none.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int S, int H, int KV, int hd,
                                          int causal, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_hd<float>(q, k, v, o, static_cast<float*>(lse), B, S, H, KV,
                          hd, causal, static_cast<cudaStream_t>(stream));
}
