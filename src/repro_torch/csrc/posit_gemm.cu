// Fused posit GEMM: O = encode(act(decode(A) @ decode(B) + bias) + residual).
//
// Replaces: src/repro/kernels/posit_gemm/posit_gemm.py, `posit_gemm` (Pallas
// body `_gemm_kernel`), unpacked operands, codec "bits".
//
// Bound on the H100, at the serving shapes: device-memory bytes. A decode step
// multiplies M = 1..8 activation rows into a (K, N) weight of p8 codes, so each
// weight byte read does 2*M flops, far below the ~295 flops per byte where the
// tensor cores would become the limit. Prefill (M = 64) is still below that
// line for the plain FMA datapath used here.
//
// Design:
// * Operands decode to float (posit codes through the device codec; a p8
//   operand through a 256-entry table each block fills from the same decode
//   at start), rounded to bf16 when the format-pair plan computes in bf16
//   (exact for p8 and bf16 storage).
// * Decode shape, M <= 8 (`gemv_kernel`): B is streamed once. A block owns
//   256 columns and a K range; each lane reads 8 consecutive columns of a row
//   with one vector load (8 rows' loads issued before any is used), decodes
//   them once in registers and multiplies them into all M rows, whose A
//   slice sits in shared memory. Two blocks per SM; the K splits are sized
//   so the grid is one wave of them.
// * M > 8 (`gemm_kernel`): each block owns one 64 x 64 output tile and loops
//   over its K range, staging decoded A and B tiles in shared memory.
// * f32 accumulation with FMA. bf16 x bf16 products are exact in f32, so the
//   result differs from a bf16 tensor-core product only in summation order;
//   no TF32 anywhere.
// * Ragged M/N/K edges are masked in the loads and the stores: no padding.
// * Few output tiles (a decode GEMV with N = 1024 has 4 of them) cannot fill
//   132 SMs, so K splits over blockIdx.z. Each split writes its f32 partial;
//   a second kernel sums the partials in split order and runs the epilogue.
//   For M <= 8 the split count depends on N and K only, and no sum order
//   depends on M, so a row's result does not depend on how many other rows
//   share the batch.
// * The epilogue (bias, activation, residual, posit encode or float store)
//   runs in registers.
#include "posit_codec.cuh"

namespace {

using posit::kBF16;
using posit::kF32;
using posit::kP16;
using posit::kP8;

struct GemmArgs {
  const void* a;
  const void* b;
  void* out;
  const float* bias;      // (N,) or null
  const float* residual;  // (M, N) or null
  float* partial;         // (splits, M, N) when splits > 1
  int M, N, K;
  int es_a, es_b, es_out;
  int out_kind;  // posit::Kind of the output
  int act;
  int bf16_compute;
  int splits;
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

template <int KA, int KB, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(GemmArgs g) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float tab_a[KA == kP8 ? 256 : 1];
  __shared__ float tab_b[KB == kP8 ? 256 : 1];
  const int tid = threadIdx.x;
  if constexpr (KA == kP8) posit::fill_p8_table(tab_a, g.es_a, tid, NT);
  if constexpr (KB == kP8) posit::fill_p8_table(tab_b, g.es_b, tid, NT);
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_per_split;
  const int k_end = min(g.K, k_begin + g.k_per_split);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.0f;
      if (m < g.M && k < k_end)
        v = to_compute(posit::load_elem<KA>(g.a, static_cast<long long>(m) * g.K + k, g.es_a, tab_a),
                       g.bf16_compute);
      As[c][r] = v;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      float v = 0.0f;
      if (k < k_end && n < g.N)
        v = to_compute(posit::load_elem<KB>(g.b, static_cast<long long>(k) * g.N + n, g.es_b, tab_b),
                       g.bf16_compute);
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long MN = static_cast<long long>(g.M) * g.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= g.N) continue;
      const long long idx = static_cast<long long>(m) * g.N + n;
      if (g.splits > 1) g.partial[blockIdx.z * MN + idx] = acc[i][j];
      else emit(g, idx, n, acc[i][j]);
    }
  }
}

// ---- decode shape (M <= 8): one pass over B with vector row loads ----
// A block owns 256 columns (8 per lane) and its K range; the 8 warps take
// interleaved rows of it (warp w: rows w, w+8, ...), so every row is one
// coalesced 256-column read. A warp issues the loads of several rows before
// it uses any of them; each B element is decoded once and used for all M
// rows, whose A slice sits in shared memory. The warps' sums meet in shared
// memory in warp order.
constexpr int kGvThreads = 256;
constexpr int kGvWarps = kGvThreads / 32;
constexpr int kGvVec = 8;                 // columns per lane
constexpr int kGvCols = 32 * kGvVec;      // columns per block
constexpr int kGvKChunk = 1024;           // k of A staged at a time

// kGvVec consecutive B values of one row as float32, one vector load.
template <int KB>
__device__ __forceinline__ void load_row(const void* b, long long off, float (&v)[kGvVec],
                                         const float* tab, int es) {
  if constexpr (KB == kP8) {
    const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(b) + off);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) v[j] = tab[c[j]];
  } else if constexpr (KB == kP16) {
    const uint4 r = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(b) + off);
    const uint16_t* c = reinterpret_cast<const uint16_t*>(&r);
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) v[j] = posit::decode(c[j], 16, es);
  } else if constexpr (KB == kBF16) {
    const uint4 r = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(b) + off);
    const __nv_bfloat16* c = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) v[j] = __bfloat162float(c[j]);
  } else {
    const float4* p = reinterpret_cast<const float4*>(static_cast<const float*>(b) + off);
    const float4 x = p[0], y = p[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  }
}

template <int KA, int KB, int MT>
__global__ void __launch_bounds__(kGvThreads, 2)
gemv_kernel(GemmArgs g, bool vec_ok) {
  constexpr int U = MT <= 4 ? 8 : 4;  // rows a warp has in flight (registers)
  __shared__ float As[MT][kGvKChunk];
  __shared__ float red[kGvWarps][kGvCols];
  __shared__ float tab_a[KA == kP8 ? 256 : 1];
  __shared__ float tab_b[KB == kP8 ? 256 : 1];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (KA == kP8) posit::fill_p8_table(tab_a, g.es_a, tid, kGvThreads);
  if constexpr (KB == kP8) posit::fill_p8_table(tab_b, g.es_b, tid, kGvThreads);

  const int n0 = blockIdx.x * kGvCols;
  const int nl = n0 + lane * kGvVec;
  const bool full = vec_ok && nl + kGvVec <= g.N;
  const int k_begin = blockIdx.z * g.k_per_split;
  const int k_end = min(g.K, k_begin + g.k_per_split);
  float acc[MT][kGvVec];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) acc[m][j] = 0.0f;

  for (int kc = k_begin; kc < k_end; kc += kGvKChunk) {
    const int kn = min(kGvKChunk, k_end - kc);
    __syncthreads();  // tables filled / previous chunk consumed
    for (int i = tid; i < MT * kGvKChunk; i += kGvThreads) {
      const int m = i / kGvKChunk, c = i % kGvKChunk;
      float v = 0.0f;
      if (m < g.M && c < kn)
        v = to_compute(posit::load_elem<KA>(g.a, static_cast<long long>(m) * g.K + kc + c,
                                            g.es_a, tab_a), g.bf16_compute);
      As[m][c] = v;
    }
    __syncthreads();
    for (int r0 = warp; r0 < kn; r0 += kGvWarps * U) {
      float bv[U][kGvVec];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * kGvWarps;
        const long long off = static_cast<long long>(kc + r) * g.N + nl;
        if (r < kn && full) {
          load_row<KB>(g.b, off, bv[u], tab_b, g.es_b);
        } else {
#pragma unroll
          for (int j = 0; j < kGvVec; ++j)
            bv[u][j] = (r < kn && nl + j < g.N)
                           ? posit::load_elem<KB>(g.b, off + j, g.es_b, tab_b) : 0.0f;
        }
        if constexpr (KB == kP16 || KB == kF32) {  // p8 and bf16 are bf16-exact
#pragma unroll
          for (int j = 0; j < kGvVec; ++j) bv[u][j] = to_compute(bv[u][j], g.bf16_compute);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * kGvWarps;
        if (r >= kn) break;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float a = As[m][r];
#pragma unroll
          for (int j = 0; j < kGvVec; ++j)
            acc[m][j] = fmaf(a, bv[u][j], acc[m][j]);
        }
      }
    }
  }

  const long long MN = static_cast<long long>(g.M) * g.N;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) red[warp][lane * kGvVec + j] = acc[m][j];
    __syncthreads();
    float y = red[0][tid];
#pragma unroll
    for (int w = 1; w < kGvWarps; ++w) y += red[w][tid];
    const int n = n0 + tid;
    if (m < g.M && n < g.N) {
      const long long idx = static_cast<long long>(m) * g.N + n;
      if (g.splits > 1) g.partial[blockIdx.z * MN + idx] = y;
      else emit(g, idx, n, y);
    }
  }
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

template <int KA, int KB, int BM, int BN, int BK, int TM, int TN>
void launch_tiles(const GemmArgs& g, cudaStream_t s) {
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, g.splits);
  gemm_kernel<KA, KB, BM, BN, BK, TM, TN><<<grid, (BM / TM) * (BN / TN), 0, s>>>(g);
}

template <int KA, int KB, int MT>
void launch_gemv(const GemmArgs& g, cudaStream_t s) {
  const dim3 grid((g.N + kGvCols - 1) / kGvCols, 1, g.splits);
  // row loads need every row start aligned: N a multiple of the vector width
  // and B itself 16-byte aligned
  const bool vec_ok = g.N % kGvVec == 0 && (reinterpret_cast<uintptr_t>(g.b) & 15u) == 0;
  gemv_kernel<KA, KB, MT><<<grid, kGvThreads, 0, s>>>(g, vec_ok);
}

template <int KA, int KB>
void launch_kinds(const GemmArgs& g, cudaStream_t s) {
  // repro_torch/kernels/posit_gemm/ops.py sizes the K splits from these tile widths
  if (g.M <= 1) launch_gemv<KA, KB, 1>(g, s);
  else if (g.M <= 4) launch_gemv<KA, KB, 4>(g, s);
  else if (g.M <= 8) launch_gemv<KA, KB, 8>(g, s);
  else launch_tiles<KA, KB, 64, 64, 16, 4, 4>(g, s);
}

template <int KA>
bool launch_b(const GemmArgs& g, int b_kind, cudaStream_t s) {
  switch (b_kind) {
    case kF32: launch_kinds<KA, kF32>(g, s); return true;
    case kBF16: launch_kinds<KA, kBF16>(g, s); return true;
    case kP8: launch_kinds<KA, kP8>(g, s); return true;
    case kP16: launch_kinds<KA, kP16>(g, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

int posit_gemm_launch(const void* a, const void* b, void* out, const float* bias,
                      const float* residual, float* partial, int M, int N, int K, int a_kind,
                      int b_kind, int out_kind, int es_a, int es_b, int es_out, int act,
                      int bf16_compute, int splits, int k_per_split, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || k_per_split < 1 || (splits > 1 && partial == nullptr) ||
      static_cast<long long>(splits) * k_per_split < K || out_kind < kF32 || out_kind > kP16 ||
      act < posit::kActNone || act > posit::kActRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  auto clamp_es = [](int es) { return es < 0 ? 0 : (es > 3 ? 3 : es); };
  GemmArgs g{a,     b,          out,   bias,          residual,  partial,
             M,     N,          K,     clamp_es(es_a), clamp_es(es_b), clamp_es(es_out),
             out_kind, act, bf16_compute, splits, k_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  switch (a_kind) {
    case kF32: ok = launch_b<kF32>(g, b_kind, s); break;
    case kBF16: ok = launch_b<kBF16>(g, b_kind, s); break;
    case kP8: ok = launch_b<kP8>(g, b_kind, s); break;
    case kP16: ok = launch_b<kP16>(g, b_kind, s); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  splitk_epilogue_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
