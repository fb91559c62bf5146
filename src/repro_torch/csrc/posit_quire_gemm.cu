// Exact-accumulation (quire) posit GEMM:
//   O = round_once(sum_k decode(A)[i,k] * decode(B)[k,j]), then the epilogue.
//
// Replaces: src/repro/kernels/posit_quire_gemm/posit_quire_gemm.py,
// `posit_quire_gemm` (Pallas body `_quire_gemm_kernel`).
//
// Bound on the H100: integer operations, not bytes. Each of the M*N*K posit
// products costs at least 4 int32 operations (significand multiply, offset
// add, placing shift, one limb add): at 16.7e12 int32 ops/s (132 SMs x 64
// INT32 lanes x 1.98 GHz) a decode step of phi3-mini-3.8b at 4 slots (1.45e10
// products) needs >= 3.5 ms, against ~2.2 ms to read its 7.2 GB of p16
// weights at 3.35 TB/s. chip_smoke.py states the bound with the same count:
// 4 * M * N * K operations.
//
// Design (one output element per thread):
// * The quire of each output lives in shared memory, limb-major
//   (q[limb][thread]), so a warp's 32 threads hit 32 banks whatever limbs
//   their products land in; the digit index is data-dependent, so registers
//   cannot hold it. Limb layout of core/quire.py: radix-2^16 int32 digits,
//   LSB first, anchored at the es-independent bias; one spare limb above the
//   top takes the high digit of a negative product placed at the very top of
//   a p8 quire and folds into the top limb at each normalisation.
// * The k loop runs inside the block (the TPU's sequential k grid and its
//   VMEM scratch). Each k tile of A and B is decoded once per block into
//   field words in shared memory (p8 through a 256-entry table): bits
//   [0, 9) scale + 128, bits [16, 32) the significand with its sign.
// * A product p = sig_a * sig_b (< 2^28 in magnitude) at quire bit offset
//   scale_a + scale_b + bias - (w_a - 1) - (w_b - 1) becomes the signed
//   64-bit value p << (offset % 16), whose two low 16-bit digits and signed
//   high word are added, without carries, to limbs offset / 16 .. + 2.
//   Carries propagate at most every MAX_DEFERRED = 8192 products.
// * Decode shapes (M = 4) have too few outputs to fill 132 SMs, so K splits
//   over blockIdx.z. Every split writes its normalised partial quire (and
//   its NaR flag) to a scratch the wrapper allocates; a second kernel sums
//   the partials limb-wise (exact integers), normalises, reads out once and
//   runs the epilogue. The sum is exact, so the result does not depend on
//   the split, the tile order or the batch.
// * Readout: `_readout_fields`, `quire_read` and `_f32_from_fields` of
//   core/quire.py, bit for bit (NaR included); the device codec supplies the
//   field decode and the final encode.
#include "posit_codec.cuh"

namespace {

using posit::kF32;
using posit::kP16;
using posit::kP8;

constexpr int kThreads = 256;      // one output element per thread
constexpr int kMaxDeferred = 8192;  // products between normalisations
constexpr int kScaleBias = 128;    // field word: scale + 128 in bits [0, 9)

// Quire geometry for operands of at most QN bits (core/quire.py).
template <int QN>
struct Quire {
  static constexpr int kSmax = (QN - 2) << 3;
  static constexpr int kSigw = QN == 8 ? 6 : 14;
  static constexpr int kBias = 2 * kSmax + 2 * (kSigw - 1);
  static constexpr int kLimbs = ((2 * kSmax + 1 + 20) + kBias + 1 + 15) / 16;
};
static_assert(Quire<8>::kLimbs == 14 && Quire<16>::kLimbs == 31,
              "limb counts of core/quire.py");

__host__ __device__ constexpr int sigw(int n) { return n == 8 ? 6 : 14; }

struct QArgs {
  const void* a;
  const void* b;
  void* out;
  const float* bias;      // (N,) or null
  const float* residual;  // (M, N) or null
  int* partial;           // (splits, limbs + 1, M * N)
  int M, N, K;
  int es_a, es_b, es_out;
  int out_kind;  // kF32, kP8 or kP16
  int act;
  int splits;
  int k_per_split;
};

// Field word of one n-bit code. Zero and NaR give scale 0 and significand
// 0, so they add nothing; the caller flags NaR.
template <int NB>
__device__ __forceinline__ uint32_t field_word(uint32_t code, int es) {
  const posit::Fields f = posit::decode_fields(code, NB, es);
  if (f.is_zero || f.is_nar) return kScaleBias;
  const int s = f.neg ? -static_cast<int>(f.sig) : static_cast<int>(f.sig);
  return (static_cast<uint32_t>(s) << 16) | static_cast<uint32_t>(f.scale + kScaleBias);
}

template <int NB>
__device__ __forceinline__ uint32_t load_word(const void* p, long long i, int es,
                                              const uint32_t* tab, bool& nar) {
  uint32_t code;
  if constexpr (NB == 8) {
    code = static_cast<const uint8_t*>(p)[i];
  } else {
    code = static_cast<const uint16_t*>(p)[i];
  }
  nar = code == (1u << (NB - 1));
  if constexpr (NB == 8) {
    return tab[code];
  } else {
    return field_word<16>(code, es);
  }
}

// q[limb] += digits of (sig_a * sig_b) << (offset % 16), no carries. C is
// the offset constant less the two scale biases; the low 10 bits of
// wa + wb + C are the offset (in [0, 1024) for every pair of words).
__device__ __forceinline__ void accumulate(int* qc, uint32_t wa, uint32_t wb, uint32_t c) {
  const int off = static_cast<int>((wa + wb + c) & 0x3FFu);
  const int p = (static_cast<int>(wa) >> 16) * (static_cast<int>(wb) >> 16);
  const uint64_t v = static_cast<uint64_t>(static_cast<int64_t>(p)) << (off & 15);
  const uint32_t lo = static_cast<uint32_t>(v);
  int* q = qc + (off >> 4) * kThreads;
  q[0] += static_cast<int>(lo & 0xFFFFu);
  q[kThreads] += static_cast<int>(lo >> 16);
  q[2 * kThreads] += static_cast<int>(v >> 32);
}

// Carry ripple over one thread's quire column: digits in [0, 2^16) below the
// top limb, which keeps the signed remainder; the spare limb L folds in.
template <int L>
__device__ __forceinline__ void normalize_column(int* qc) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    const int t = qc[i * kThreads] + c;
    qc[i * kThreads] = t & 0xFFFF;
    c = t >> 16;  // arithmetic: the floor carry of a negative t
  }
  qc[(L - 1) * kThreads] += c + qc[L * kThreads] * 65536;
  qc[L * kThreads] = 0;
}

template <int KA, int KB, int BM>
__global__ void __launch_bounds__(kThreads)
quire_gemm_kernel(QArgs g) {
  constexpr int NA = KA == kP16 ? 16 : 8;
  constexpr int NB = KB == kP16 ? 16 : 8;
  constexpr int QN = NA > NB ? NA : NB;
  constexpr int L = Quire<QN>::kLimbs;
  constexpr int BN = kThreads / BM;
  constexpr int BK = 2048 / BN;  // 8 KB of B field words a tile
  static_assert(kMaxDeferred % BK == 0, "normalise on tile boundaries");
  constexpr int kOffset = Quire<QN>::kBias - (sigw(NA) - 1) - (sigw(NB) - 1) - 2 * kScaleBias;
  __shared__ int qs[(L + 1) * kThreads];
  __shared__ uint32_t As[BK][BM];
  __shared__ uint32_t Bs[BK][BN];
  __shared__ uint32_t tab_a[NA == 8 ? 256 : 1];
  __shared__ uint32_t tab_b[NB == 8 ? 256 : 1];
  __shared__ int nar_a[BM];
  __shared__ int nar_b[BN];

  const int tid = threadIdx.x;
  const int ml = tid / BN, nl = tid % BN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_per_split;
  const int k_end = min(g.K, k_begin + g.k_per_split);
  int* qc = qs + tid;
#pragma unroll
  for (int i = 0; i <= L; ++i) qc[i * kThreads] = 0;
  if (tid < BM) nar_a[tid] = 0;
  if (tid < BN) nar_b[tid] = 0;
  if constexpr (NA == 8) tab_a[tid] = field_word<8>(static_cast<uint32_t>(tid), g.es_a);
  if constexpr (NB == 8) tab_b[tid] = field_word<8>(static_cast<uint32_t>(tid), g.es_b);
  __syncthreads();

  int since = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      uint32_t w = kScaleBias;
      if (m < g.M && k < k_end) {
        bool nar;
        w = load_word<NA>(g.a, static_cast<long long>(m) * g.K + k, g.es_a, tab_a, nar);
        if (nar) nar_a[r] = 1;
      }
      As[c][r] = w;
    }
    for (int i = tid; i < BK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      uint32_t w = kScaleBias;
      if (k < k_end && n < g.N) {
        bool nar;
        w = load_word<NB>(g.b, static_cast<long long>(k) * g.N + n, g.es_b, tab_b, nar);
        if (nar) nar_b[c] = 1;
      }
      Bs[r][c] = w;
    }
    __syncthreads();
    if (since == kMaxDeferred) {
      normalize_column<L>(qc);
      since = 0;
    }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk)
      accumulate(qc, As[kk][ml], Bs[kk][nl], static_cast<uint32_t>(kOffset));
    since += BK;
    __syncthreads();
  }
  normalize_column<L>(qc);

  const int m = m0 + ml, n = n0 + nl;
  if (m >= g.M || n >= g.N) return;
  const long long MN = static_cast<long long>(g.M) * g.N;
  int* out = g.partial + static_cast<long long>(blockIdx.z) * (L + 1) * MN +
             static_cast<long long>(m) * g.N + n;
#pragma unroll
  for (int i = 0; i < L; ++i) out[i * MN] = qc[i * kThreads];
  out[L * MN] = nar_a[ml] | nar_b[nl];
}

// ------------------------------------------------------------- readout ----

struct Readout {
  bool neg;
  int scale;
  uint32_t frac_la;  // fraction without the hidden bit, left-aligned at 31
  bool sticky;
  bool is_zero;
};

// core/quire.py `_readout_fields`: normalise, take the magnitude, find the
// MSB, keep the 48-bit window below it and the sticky of everything lower.
template <int L, int BIAS>
__device__ __forceinline__ Readout readout_fields(int (&q)[L]) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    const int t = q[i] + c;
    q[i] = t & 0xFFFF;
    c = t >> 16;
  }
  q[L - 1] += c;
  Readout r;
  r.neg = q[L - 1] < 0;
  uint32_t d[L];
  c = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const int t = (r.neg ? -q[i] : q[i]) + c;
    d[i] = static_cast<uint32_t>(t & 0xFFFF);
    c = t >> 16;
  }
  int P = -1;
#pragma unroll
  for (int i = 0; i < L; ++i)
    if (d[i] > 0u) P = 16 * i + posit::floor_log2(d[i]);
  const int i_top = P >> 4;
  const uint32_t rr = static_cast<uint32_t>(P & 15);
  uint32_t D2 = 0u, D1 = 0u, D0 = 0u;
  bool sticky = false;
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (i_top == i) D2 = d[i];
    if (i_top == i + 1) D1 = d[i];
    if (i_top == i + 2) D0 = d[i];
    sticky = sticky || (i_top > i + 2 && d[i] != 0u);
  }
  const uint32_t hi = (D2 << 16) | D1;  // MSB (hidden bit) at 16 + rr
  r.frac_la = (hi << (16u - rr)) | (D0 >> rr);
  r.sticky = sticky || (D0 & ((1u << rr) - 1u)) != 0u;
  r.scale = P - BIAS;
  r.is_zero = P < 0;
  return r;
}

// core/quire.py `_f32_from_fields`: one RNE into float32, subnormals
// included; overflow -> +-inf, below half the smallest subnormal -> +-0.
__device__ __forceinline__ float f32_from_fields(const Readout& r) {
  const uint32_t sig_la = 0x80000000u | (r.frac_la >> 1);
  const bool sticky = r.sticky || (r.frac_la & 1u) != 0u;
  const uint32_t sh = static_cast<uint32_t>(min(max(-126 - r.scale, 0), 24));
  uint32_t mant = (sig_la >> 8) >> sh;
  const uint32_t guard = ((sig_la >> 7) >> sh) & 1u;
  const uint32_t low = sig_la & ((1u << (7u + sh)) - 1u);
  const bool st = sticky || low != 0u;
  mant += (guard == 1u && (st || (mant & 1u) != 0u)) ? 1u : 0u;
  const int base = sh > 0u ? 0 : r.scale + 126;
  uint32_t fbits = (static_cast<uint32_t>(base) << 23) + mant;
  if (r.scale >= 128) fbits = 0x7F800000u;
  if (r.scale < -150) fbits = 0u;
  fbits |= (r.neg ? 1u : 0u) << 31;
  return __uint_as_float(fbits);
}

// Sum the split partials, read out once, run the epilogue, store.
template <int QN>
__global__ void __launch_bounds__(256) quire_readout_kernel(QArgs g) {
  constexpr int L = Quire<QN>::kLimbs;
  const long long MN = static_cast<long long>(g.M) * g.N;
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  if (idx >= MN) return;
  int q[L];
#pragma unroll
  for (int i = 0; i < L; ++i) q[i] = 0;
  int flag = 0;
  for (int s = 0; s < g.splits; ++s) {
    const int* p = g.partial + static_cast<long long>(s) * (L + 1) * MN + idx;
#pragma unroll
    for (int i = 0; i < L; ++i) q[i] += p[i * MN];
    flag |= p[L * MN];
  }
  const Readout r = readout_fields<L, Quire<QN>::kBias>(q);
  const bool nar = flag != 0;
  const bool epilogue = g.bias != nullptr || g.residual != nullptr || g.act != posit::kActNone;
  if (g.out_kind != kF32 && !epilogue) {
    // exact single rounding straight into the posit rd
    const int n = g.out_kind == kP8 ? 8 : 16;
    uint32_t code = posit::encode_fields(r.neg, r.scale, r.frac_la, r.sticky, n, g.es_out);
    if (r.is_zero) code = 0u;
    if (nar) code = 1u << (n - 1);
    if (n == 8) static_cast<uint8_t*>(g.out)[idx] = static_cast<uint8_t>(code);
    else static_cast<uint16_t*>(g.out)[idx] = static_cast<uint16_t>(code);
    return;
  }
  float y = f32_from_fields(r);
  if (r.is_zero) y = 0.0f;
  if (nar) y = __uint_as_float(posit::kNaNBits);
  if (g.bias != nullptr) y += g.bias[idx % g.N];
  y = posit::activate(y, g.act);
  if (g.residual != nullptr) y += g.residual[idx];
  switch (g.out_kind) {
    case kF32:
      static_cast<float*>(g.out)[idx] = y;
      break;
    case kP8:
      static_cast<uint8_t*>(g.out)[idx] = static_cast<uint8_t>(posit::encode(y, 8, g.es_out));
      break;
    default:
      static_cast<uint16_t*>(g.out)[idx] = static_cast<uint16_t>(posit::encode(y, 16, g.es_out));
  }
}

// repro_torch/kernels/posit_quire_gemm/ops.py `TILES` mirrors these tiles.
template <int KA, int KB, int BM>
void launch_tiles(const QArgs& g, cudaStream_t s) {
  constexpr int BN = kThreads / BM;
  const dim3 grid((g.N + BN - 1) / BN, (g.M + BM - 1) / BM, g.splits);
  quire_gemm_kernel<KA, KB, BM><<<grid, kThreads, 0, s>>>(g);
}

template <int KA, int KB>
void launch_rows(const QArgs& g, cudaStream_t s) {
  if (g.M <= 1) launch_tiles<KA, KB, 1>(g, s);
  else if (g.M <= 4) launch_tiles<KA, KB, 4>(g, s);
  else launch_tiles<KA, KB, 8>(g, s);
}

}  // namespace

extern "C" {

// a (M, K), b (K, N) posit codes of a_bits / b_bits; out (M, N) of out_kind;
// partial: int32 scratch of splits * (limbs + 1) * M * N.
int posit_quire_gemm_launch(const void* a, const void* b, void* out, const float* bias,
                            const float* residual, int* partial, int M, int N, int K,
                            int a_bits, int b_bits, int out_kind, int es_a, int es_b,
                            int es_out, int act, int splits, int k_per_split, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((a_bits != 8 && a_bits != 16) || (b_bits != 8 && b_bits != 16) || K < 0 ||
      (out_kind != kF32 && out_kind != kP8 && out_kind != kP16) || act < posit::kActNone ||
      act > posit::kActRelu || splits < 1 || k_per_split < 1 || partial == nullptr ||
      static_cast<long long>(splits) * k_per_split < K)
    return static_cast<int>(cudaErrorInvalidValue);
  auto clamp_es = [](int es) { return es < 0 ? 0 : (es > 3 ? 3 : es); };
  const QArgs g{a, b, out, bias, residual, partial, M, N, K, clamp_es(es_a), clamp_es(es_b),
                clamp_es(es_out), out_kind, act, splits, k_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_bits == 16 && b_bits == 16) launch_rows<kP16, kP16>(g, s);
  else if (a_bits == 16) launch_rows<kP16, kP8>(g, s);
  else if (b_bits == 16) launch_rows<kP8, kP16>(g, s);
  else launch_rows<kP8, kP8>(g, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const unsigned blocks = static_cast<unsigned>((MN + 255) / 256);
  if (a_bits == 16 || b_bits == 16) quire_readout_kernel<16><<<blocks, 256, 0, s>>>(g);
  else quire_readout_kernel<8><<<blocks, 256, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
