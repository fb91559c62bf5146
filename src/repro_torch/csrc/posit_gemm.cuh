// Pieces the fused posit GEMM's kernels share: the launch arguments, the
// fused epilogue, the operand rounding and the split-K sum. posit_gemm.cu
// (decode tiles and the 64-row tiles) and posit_gemm_large.cu (the large-M
// tiles) include it, so both run the same epilogue on the same f32 sums.
#pragma once

#include "posit_codec.cuh"

namespace gemm {

using posit::kBF16;
using posit::kF32;
using posit::kP16;
using posit::kP8;

// Storage kind of a packed p8 B: two codes a uint16 word, split-K lanes.
constexpr int kP8x2 = 4;

struct GemmArgs {
  const void* a;
  const void* b;
  void* out;
  const float* bias;      // (N,) or null
  const float* residual;  // (M, N) or null
  float* partial;         // FMA: (splits, M, N) when splits > 1; tensor cores:
                          // (grid, 2, BM, 128), a block's first and last part
  int* counters;          // tensor cores: one zeroed counter per output tile
  int M, N, K;
  int kb;  // rows of B: K, or Kh = ceil(K / 2) packed rows
  int es_a, es_b, es_out;
  int out_kind;  // posit::Kind of the output
  int act;
  int bf16_compute;
  int splits;       // FMA: K splits (blockIdx.z)
  int k_per_split;
};

__device__ __forceinline__ void emit(const GemmArgs& g, long long idx, int n, float y) {
  if (g.bias != nullptr) y += g.bias[n];
  y = posit::activate(y, g.act);
  if (g.residual != nullptr) y += g.residual[idx];
  switch (g.out_kind) {
    case kF32:
      static_cast<float*>(g.out)[idx] = y;
      break;
    case kBF16:
      static_cast<__nv_bfloat16*>(g.out)[idx] = __float2bfloat16_rn(y);
      break;
    case kP8:
      static_cast<uint8_t*>(g.out)[idx] = static_cast<uint8_t>(posit::encode(y, 8, g.es_out));
      break;
    default:
      static_cast<uint16_t*>(g.out)[idx] = static_cast<uint16_t>(posit::encode(y, 16, g.es_out));
  }
}

__device__ __forceinline__ float to_compute(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Sum the K-split partials in split order, then the epilogue.
__global__ void __launch_bounds__(256) splitk_epilogue_kernel(GemmArgs g) {
  const long long MN = static_cast<long long>(g.M) * g.N;
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= MN) return;
  float y = g.partial[idx];
  for (int s = 1; s < g.splits; ++s) y += g.partial[s * MN + idx];
  emit(g, idx, static_cast<int>(idx % g.N), y);
}

// Launches the split-K sum over the (splits, M, N) partials.
inline cudaError_t launch_splitk_epilogue(const GemmArgs& g, cudaStream_t s) {
  const long long MN = static_cast<long long>(g.M) * g.N;
  splitk_epilogue_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, s>>>(g);
  return cudaGetLastError();
}

}  // namespace gemm
