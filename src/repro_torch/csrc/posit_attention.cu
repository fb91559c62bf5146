// Decode-step attention over a posit-coded KV cache (one query token per row).
//
// Replaces: src/repro/kernels/posit_attention/posit_attention.py,
// `posit_decode_attention` (Pallas body `_attn_kernel`).
//
// Bound on the H100: device-memory bytes. A decode step reads each live K/V
// code once (1 byte per value at p8) and does ~4 flops per q-head per value.
//
// Design:
// * One block per (batch row, KV head) serves all Hq/Hkv q-heads of that KV
//   head, so each K/V tile is read from device memory once, not once per
//   q-head as on the TPU grid (B*Hq, S/bs).
// * The block walks S tiles of 32 positions only up to ceil(len/32) of its own
//   row: a short row stops early, a length-0 row runs no tile and writes exact
//   zeros.
// * K/V codes are decoded into shared memory (p8 through a 256-entry table the
//   block fills from the device codec, p16 through the codec, f32/bf16 KV as a
//   plain load). The online-softmax state (m, l, acc) stays in f32: m and l in
//   shared memory, acc in registers (one head-dim column per thread).
// * Masked slots get an explicit 0 probability, so a fully masked tile cannot
//   leak a uniform average of stale V.
#include "posit_codec.cuh"

namespace {

using posit::kBF16;
using posit::kF32;
using posit::kP16;
using posit::kP8;

constexpr int kBS = 32;      // S positions per tile (one per lane)
constexpr int kThreads = 128;
constexpr int kDMax = 128;   // head_dim limit
constexpr int kGMax = 8;     // q-heads per KV head limit
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KV>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* __restrict__ q, const void* __restrict__ kc,
            const void* __restrict__ vc, const int* __restrict__ lengths,
            float* __restrict__ out, int Hq, int Hkv, int S, int d, int es, float scale) {
  __shared__ float qs[kGMax][kDMax];
  __shared__ float Ks[kBS][kDMax + 1];  // +1: the score loop reads a row per lane
  __shared__ float Vs[kBS][kDMax];
  __shared__ float ps[kGMax][kBS];
  __shared__ float m_s[kGMax], l_s[kGMax], alpha_s[kGMax];
  __shared__ float tab[KV == kP8 ? 256 : 1];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int g = Hq / Hkv;
  if constexpr (KV == kP8) posit::fill_p8_table(tab, es, tid, kThreads);
  for (int i = tid; i < g * d; i += kThreads) {
    const int j = i / d, c = i % d;
    qs[j][c] = q[(static_cast<long long>(b) * Hq + hk * g + j) * d + c];
  }
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }
  const int len = min(max(lengths[b], 0), S);
  const int n_tiles = (len + kBS - 1) / kBS;
  const long long base = (static_cast<long long>(b) * Hkv + hk) * S * d;
  float acc[kGMax];
#pragma unroll
  for (int j = 0; j < kGMax; ++j) acc[j] = 0.0f;
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = t * kBS;
    for (int i = tid; i < kBS * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const long long off = base + static_cast<long long>(s0 + r) * d + c;
      const bool in = s0 + r < len;  // masked slots load as 0: stale NaR cannot reach acc
      Ks[r][c] = in ? posit::load_elem<KV>(kc, off, es, tab) : 0.0f;
      Vs[r][c] = in ? posit::load_elem<KV>(vc, off, es, tab) : 0.0f;
    }
    __syncthreads();
    {  // scores: lane s of warp w dots q-heads w, w+4, ... with key s0+s
      const int s = tid % kBS;
      for (int j = tid / kBS; j < g; j += kThreads / kBS) {
        float dot = 0.0f;
        for (int c = 0; c < d; ++c) dot = fmaf(qs[j][c], Ks[s][c], dot);
        ps[j][s] = dot * scale;
      }
    }
    __syncthreads();
    {  // online softmax: warp w updates heads w, w+4, ...
      const int w = tid / 32, lane = tid % 32;
      const bool valid = s0 + lane < len;
      for (int j = w; j < g; j += kThreads / 32) {
        const float sc = valid ? ps[j][lane] : kNegInf;
        const float m_prev = m_s[j];
        const float m_new = fmaxf(m_prev, warp_max(sc));
        const float p = valid ? expf(sc - m_new) : 0.0f;
        const float sum = warp_sum(p);
        ps[j][lane] = p;
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          alpha_s[j] = alpha;
          l_s[j] = l_s[j] * alpha + sum;
          m_s[j] = m_new;
        }
      }
    }
    __syncthreads();
    if (tid < d) {
#pragma unroll
      for (int j = 0; j < kGMax; ++j) {
        if (j >= g) break;
        float a = acc[j] * alpha_s[j];
        for (int s = 0; s < kBS; ++s) a = fmaf(ps[j][s], Vs[s][tid], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }

  if (tid < d) {
#pragma unroll
    for (int j = 0; j < kGMax; ++j) {
      if (j >= g) break;
      const float l = l_s[j];
      out[(static_cast<long long>(b) * Hq + hk * g + j) * d + tid] = acc[j] / (l == 0.0f ? 1.0f : l);
    }
  }
}

}  // namespace

extern "C" {

// q (B, Hq, d) f32; k/v (B, Hkv, S, d) of kv_kind; lengths (B,) int32;
// out (B, Hq, d) f32.
int posit_attention_launch(const float* q, const void* k, const void* v, const int* lengths,
                           float* out, int B, int Hq, int Hkv, int S, int d, int kv_kind, int es,
                           float scale, void* stream) {
  if (B <= 0) return 0;
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kGMax || d <= 0 || d > kDMax || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  es = es < 0 ? 0 : (es > 3 ? 3 : es);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(B * Hkv);
  switch (kv_kind) {
    case kF32: attn_kernel<kF32><<<grid, kThreads, 0, s>>>(q, k, v, lengths, out, Hq, Hkv, S, d, es, scale); break;
    case kBF16: attn_kernel<kBF16><<<grid, kThreads, 0, s>>>(q, k, v, lengths, out, Hq, Hkv, S, d, es, scale); break;
    case kP8: attn_kernel<kP8><<<grid, kThreads, 0, s>>>(q, k, v, lengths, out, Hq, Hkv, S, d, es, scale); break;
    case kP16: attn_kernel<kP16><<<grid, kThreads, 0, s>>>(q, k, v, lengths, out, Hq, Hkv, S, d, es, scale); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
