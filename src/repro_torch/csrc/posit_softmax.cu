// Posit softmax: per row, decode -> stable f32 softmax -> encode in the same
// format (the paper's section IV-C softmax benchmark).
//
// Replaces: src/repro/kernels/posit_softmax/posit_softmax.py,
// `posit_softmax_kernel` (Pallas body `_softmax_kernel`).
//
// Bound on the H100: device-memory bytes. Each code is read once and each
// output code written once; the f32 work per element (a compare, a
// subtract, two expf, an add, a divide) is far below the card's rate.
//
// Design: one block per row. A row may be as wide as a vocabulary, so it is
// not held in shared memory: the block loops over it three times (max, sum
// of exp, encode), reading the codes again each time (they stay in L2).
// Columns beyond C do not exist here, so the TPU kernel's -inf padding
// becomes the loop bound. expf (not __expf) keeps the result within one
// posit ulp of the plain version.
#include <cmath>

#include "posit_codec.cuh"

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_warps = blockDim.x / 32;
  __syncthreads();  // red[] may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : (is_max ? -INFINITY : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, w) : v + w;
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <int NB>
__device__ __forceinline__ float load(const void* p, long long i, int es, const float* tab) {
  if constexpr (NB == 8) {
    return tab[static_cast<const uint8_t*>(p)[i]];
  } else {
    return posit::decode(static_cast<const uint16_t*>(p)[i], 16, es);
  }
}

template <int NB>
__global__ void __launch_bounds__(kMaxThreads)
softmax_kernel(const void* __restrict__ codes, void* __restrict__ out, int C, int es) {
  __shared__ float red[kMaxThreads / 32];
  __shared__ float tab[NB == 8 ? 256 : 1];
  if constexpr (NB == 8) posit::fill_p8_table(tab, es, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * C;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < C; c += blockDim.x) m = fmaxf(m, load<NB>(codes, base + c, es, tab));
  m = block_reduce(m, true, red);
  float s = 0.0f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) s += expf(load<NB>(codes, base + c, es, tab) - m);
  s = block_reduce(s, false, red);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float y = expf(load<NB>(codes, base + c, es, tab) - m) / s;
    const uint32_t code = posit::encode(y, NB, es);
    if constexpr (NB == 8) static_cast<uint8_t*>(out)[base + c] = static_cast<uint8_t>(code);
    else static_cast<uint16_t*>(out)[base + c] = static_cast<uint16_t>(code);
  }
}

}  // namespace

extern "C" {

// codes, out: (R, C) posit codes of nbits (8 or 16), contiguous.
int posit_softmax_launch(const void* codes, void* out, int R, int C, int nbits, int es,
                         void* stream) {
  if (R <= 0 || C <= 0) return 0;
  if (nbits != 8 && nbits != 16) return static_cast<int>(cudaErrorInvalidValue);
  es = es < 0 ? 0 : (es > 3 ? 3 : es);
  // a warp per 32 columns, up to kMaxThreads
  const int warps = (C + 31) / 32;
  const int threads = warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 8) softmax_kernel<8><<<R, threads, 0, s>>>(codes, out, C, es);
  else softmax_kernel<16><<<R, threads, 0, s>>>(codes, out, C, es);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
