// Elementwise posit codec kernels: p8/p16 codes -> f32/bf16, and f32 -> p8/p16.
//
// Replaces: src/repro/kernels/posit_codec/posit_codec.py, `decode_kernel` and
// `encode_kernel` (Pallas bodies `_decode_kernel` / `_encode_kernel`), which
// stream (rows, 128) lane tiles through VMEM.
//
// Bound on the H100: device-memory bytes. Decode reads 1-2 bytes and writes
// 2-4 bytes per element; encode reads 4 and writes 1-2. The integer pipeline
// is ~40 ALU operations per element, well under what the SMs issue per byte
// of memory traffic at 3.35 TB/s.
//
// Design: every thread moves 16 bytes in one load (16 p8 codes, 8 p16 codes,
// or two float4 of inputs for encode), runs the shared device codec of
// posit_codec.cuh on each element in registers, and writes the results with
// vector stores. A ragged tail, or a pointer that is not 16-byte aligned,
// takes the scalar path. es is a run-time argument: one build serves all es.
#include <type_traits>

#include "posit_codec.cuh"

namespace {

constexpr int kThreads = 256;

template <int NBITS, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ in, void* __restrict__ out, long long n, int es,
              bool vec_ok) {
  using code_t = typename std::conditional<NBITS == 8, uint8_t, uint16_t>::type;
  constexpr int VEC = 16 / sizeof(code_t);
  const code_t* src = static_cast<const code_t*>(in);
  const long long base = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (base >= n) return;
  if (vec_ok && base + VEC <= n) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src + base);
    const code_t* c = reinterpret_cast<const code_t*>(&raw);
    if constexpr (OUT_BF16) {
      __align__(16) __nv_bfloat16 v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __float2bfloat16_rn(posit::decode(c[i], NBITS, es));
      uint4* dst = reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + base);
#pragma unroll
      for (int i = 0; i < VEC / 8; ++i) dst[i] = reinterpret_cast<const uint4*>(v)[i];
    } else {
      __align__(16) float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = posit::decode(c[i], NBITS, es);
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + base);
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) dst[i] = reinterpret_cast<const float4*>(v)[i];
    }
    return;
  }
  const long long end = base + VEC < n ? base + VEC : n;
  for (long long i = base; i < end; ++i) {
    const float v = posit::decode(src[i], NBITS, es);
    if constexpr (OUT_BF16) static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
    else static_cast<float*>(out)[i] = v;
  }
}

template <int NBITS>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const float* __restrict__ in, void* __restrict__ out, long long n, int es,
              bool ftz, bool vec_ok) {
  using code_t = typename std::conditional<NBITS == 8, uint8_t, uint16_t>::type;
  constexpr int VEC = 8;
  code_t* dst = static_cast<code_t*>(out);
  const long long base = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (base >= n) return;
  if (vec_ok && base + VEC <= n) {
    const float4* src = reinterpret_cast<const float4*>(in + base);
    const float4 lo = src[0], hi = src[1];
    const float x[VEC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    __align__(16) code_t c[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) c[i] = static_cast<code_t>(posit::encode(x[i], NBITS, es, ftz));
    if constexpr (NBITS == 8) *reinterpret_cast<uint2*>(dst + base) = *reinterpret_cast<const uint2*>(c);
    else *reinterpret_cast<uint4*>(dst + base) = *reinterpret_cast<const uint4*>(c);
    return;
  }
  const long long end = base + VEC < n ? base + VEC : n;
  for (long long i = base; i < end; ++i)
    dst[i] = static_cast<code_t>(posit::encode(in[i], NBITS, es, ftz));
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

int clamp_es(int es) { return es < 0 ? 0 : (es > 3 ? 3 : es); }

}  // namespace

extern "C" {

// codes (n elements, uint8 for nbits 8, uint16 for 16) -> f32 or bf16.
int posit_decode_launch(const void* in, void* out, long long n, int nbits, int es,
                        int out_bf16, void* stream) {
  if (n <= 0) return 0;
  if (nbits != 8 && nbits != 16) return static_cast<int>(cudaErrorInvalidValue);
  es = clamp_es(es);
  const int vec = nbits == 8 ? 16 : 8;
  const long long blocks = ((n + vec - 1) / vec + kThreads - 1) / kThreads;
  const bool vec_ok = aligned16(in) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 8 && out_bf16)
    decode_kernel<8, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, out, n, es, vec_ok);
  else if (nbits == 8)
    decode_kernel<8, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, out, n, es, vec_ok);
  else if (out_bf16)
    decode_kernel<16, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, out, n, es, vec_ok);
  else
    decode_kernel<16, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, out, n, es, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

// f32 (n elements) -> codes (uint8 for nbits 8, uint16 for 16).
int posit_encode_launch(const float* in, void* out, long long n, int nbits, int es, int ftz,
                        void* stream) {
  if (n <= 0) return 0;
  if (nbits != 8 && nbits != 16) return static_cast<int>(cudaErrorInvalidValue);
  es = clamp_es(es);
  const long long blocks = ((n + 7) / 8 + kThreads - 1) / kThreads;
  const bool vec_ok = aligned16(in) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbits == 8)
    encode_kernel<8><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, out, n, es, ftz != 0, vec_ok);
  else
    encode_kernel<16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(in, out, n, es, ftz != 0, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
