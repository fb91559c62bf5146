// Exact-accumulation (quire) posit GEMM:
//   O = round_once(sum_k decode(A)[i,k] * decode(B)[k,j]), then the epilogue.
//
// Replaces: src/repro/kernels/posit_quire_gemm/posit_quire_gemm.py,
// `posit_quire_gemm` (Pallas body `_quire_gemm_kernel`).
//
// Bound on the H100: at the decode shapes, device-memory bytes (the p16
// weight read once). The least any implementation needs is one int8
// tensor-core MAC a product (1,979e12 ops/s) beside the operand and output
// bytes (3.35 TB/s); a loop that places every product on its own in the
// quire needs >= 4 int32 operations a product (16.7e12 ops/s), which this
// design no longer does. chip_smoke.py states both. What bounds this kernel
// in practice is the int32 pipe: ~25 integer operations decode and align
// each B code (16 lanes a clock per SM quarter), shared by BM rows.
//
// Design (one B column per thread, a tile of BM rows in int64 registers):
// * A live operand value is +-g * 2^(s - (w-1)), g < 2^w (w = 14 for p16, 6
//   for p8). Within a k chunk of 32, every A row gets an anchor alpha (the
//   chunk's largest scale less a window of 29 - w binades, at least -smax;
//   a NaR counts as maxpos, its row or column reading out NaR anyway) and
//   so does every B column (beta). An element inside its window becomes
//   the aligned integer +-g << (s - anchor), below 2^29 in magnitude, so 32
//   products (each below 2^58) sum exactly in an int64 register (below
//   2^63), one 32x32->64 multiply-add a product (IMAD.WIDE). The chunk sum
//   is placed into the quire once, at bit offset alpha + beta + bias -
//   (w_a-1) - (w_b-1), as a signed 64-bit value spread over five radix-2^16
//   limbs.
// * An element below its window (more than 29 - w binades under the
//   chunk's largest) aligns to 0, and each of its products with a live
//   element takes the exact per-product placement instead (`accumulate`:
//   the 64-bit product shifted into three limbs), visiting only those
//   elements. Both branches are exact; kernels/posit_quire_gemm/ref.py
//   `per_product_share` counts the products of the second and
//   `posit_quire_gemm_chunked_ref` emulates the whole accumulation.
// * A block is 64 columns x 4 k groups (256 threads): group c sums chunk c
//   of each 128-k stage, so four warps share one set of quires, added to
//   with shared-memory atomics. B streams through a two-slot ring in shared
//   memory filled by cp.async (16-byte copies of 128 k x 64 columns of raw
//   codes). A column's anchor
//   comes from its codes as signed integers (posits order as their codes:
//   the largest magnitude is max(largest, -smallest)), then each code is
//   decoded once, without a branch, for BM rows.
// * A is staged per 128 k: every element decoded once per block, its row's
//   anchor taken with a warp max (a warp covers one row's 32-k chunk), its
//   aligned integer read by every thread as a broadcast.
// * The quire of each output lives in dynamic shared memory, limb-major
//   (q[limb][row][column]), touched once a chunk (plus the rare per-product
//   adds), normalised every 128 stages (each limb takes at most 132 adds
//   below 2^16 a stage). Limb layout of core/quire.py: radix-2^16 int32
//   digits, LSB first, anchored at the es-independent bias, one spare limb
//   above the top that folds into it at each normalisation.
// * Split-K runs inside the kernel: the K ranges of one tile are the blocks
//   of a thread-block cluster (at most 8). At the end every block
//   normalises its quires; the cluster sums them over distributed shared
//   memory in rank order, each rank reading out a share of the tile's
//   outputs (`readout_fields` / `f32_from_fields` / `encode_fields`: the
//   readout of core/quire.py, bit for bit) and running the epilogue. The
//   sums are exact integers, so the result does not depend on the split,
//   the chunking, the order or the batch. No second kernel, no scratch in
//   device memory.
#include <cooperative_groups.h>

#include <type_traits>

#include "posit_codec.cuh"

namespace cg = cooperative_groups;

namespace {

using posit::kF32;
using posit::kP16;
using posit::kP8;

constexpr int kThreads = 64;        // one B column per thread
constexpr int kKC = 32;             // k chunk: one int64 sum an output
constexpr int kKS = 128;            // k staged from A at once
constexpr int kChunks = kKS / kKC;
constexpr int kGroups = 4;          // k groups of a block: chunk c goes to group c % 4
constexpr int kMaxSplits = 8;       // blocks of a cluster (the portable size)
constexpr int kNormStages = 128;    // 128-k stages between normalisations
constexpr int kScaleBias = 128;     // field word: scale + 128 in bits [0, 9)
constexpr int kNoScale = -(1 << 20);
static_assert(kKS % 32 == 0 && kKC == 32, "a warp stages one row's chunk of A");

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

// Window rule of one operand of NB bits (ref.py `window`, `smax`).
template <int NB>
struct Operand {
  static constexpr int kSigw = NB == 8 ? 6 : 14;
  static constexpr int kWindow = 29 - kSigw;   // aligned integers < 2^29
  static constexpr int kSmax = (NB - 2) << 3;  // |scale| of any es <= 3
};

// Dynamic shared memory: the quires, then two B stages of raw codes.
__host__ __device__ constexpr int smem_bytes(int limbs, int bm, int b_bits) {
  return (limbs + 1) * bm * kThreads * 4 + 2 * kKS * kThreads * (b_bits / 8);
}

struct QArgs {
  const void* a;
  const void* b;
  void* out;
  const float* bias;      // (N,) or null
  const float* residual;  // (M, N) or null
  int M, N, K;
  int es_a, es_b, es_out;
  int out_kind;  // kF32, kP8 or kP16
  int act;
  int splits;    // blocks of a cluster, one K range each
  int k_per_split;
};

// Field word of one n-bit code: the signed significand in bits [16, 32),
// scale + 128 in bits [0, 9). Zero and NaR give scale 0 and significand 0.
// posit::decode_fields without a branch (selects only), so the compiler
// interleaves the decodes of a chunk's 32 codes.
template <int NB>
__device__ __forceinline__ uint32_t field_word(uint32_t code, int es) {
  constexpr uint32_t kMask = (1u << NB) - 1u;
  constexpr int kSigw = NB == 8 ? 6 : 14;
  const uint32_t c = code & kMask;
  const bool neg = (c >> (NB - 1)) != 0u;
  const uint32_t absc = (neg ? (1u << NB) - c : c) & kMask;
  const bool r0 = ((absc >> (NB - 2)) & 1u) != 0u;
  const uint32_t w = r0 ? ~absc & (kMask >> 1) : absc;
  const int m = __clz(w) - (32 - (NB - 1));  // n - 1 when w == 0
  const int k = r0 ? m - 1 : -m;
  const uint32_t rem = (absc << (33 - NB)) << (m + 1);
  const uint32_t e = (rem >> 24) >> (8 - es);
  const int scale = k * (1 << es) + static_cast<int>(e);
  const int sig = static_cast<int>((1u << (kSigw - 1)) | ((rem << es) >> (33 - kSigw)));
  const uint32_t word = (static_cast<uint32_t>(neg ? -sig : sig) << 16) |
                        static_cast<uint32_t>(scale + kScaleBias);
  return (c == 0u || c == (1u << (NB - 1))) ? kScaleBias : word;
}

__device__ __forceinline__ int w_sig(uint32_t w) { return static_cast<int>(w) >> 16; }
__device__ __forceinline__ int w_scale(uint32_t w) {
  return static_cast<int>(w & 0x1FFu) - kScaleBias;
}

// Scale and significand (hidden bit at w - 1) of a live magnitude: the bit
// pipeline for p16, the block's field table for p8.
template <int NB>
__device__ __forceinline__ void mag_fields(uint32_t mag, int es, const uint32_t* tab, int& scale,
                                           int& sig) {
  if constexpr (NB == 8) {
    const uint32_t w = tab[mag];
    scale = w_scale(w);
    sig = w_sig(w);
  } else {
    const bool r0 = (mag & 0x4000u) != 0u;
    const uint32_t w = r0 ? ~mag & 0x7FFFu : mag;
    const int m = __clz(w) - 17;
    const int k = r0 ? m - 1 : -m;
    const uint32_t rem = (mag << 17) << (m + 1);
    // the top es bits of rem: 0 when es is 0 (a funnel shift, no shift by 32)
    scale = k * (1 << es) + static_cast<int>(__funnelshift_l(rem, 0u, es));
    sig = static_cast<int>(0x2000u | ((rem << es) >> 19));
  }
}

// The aligned integer g << (scale - beta) of a B code (as a signed int) and
// its shift scale - beta; 0 below the window (shift < 0), for zero and for
// NaR (whose column reads out NaR). No branch: the compiler interleaves the
// chunk's elements.
template <int NB>
__device__ __forceinline__ int aligned_b(int v, int es, int beta, const uint32_t* tab, int& sh) {
  const uint32_t mag = static_cast<uint32_t>(abs(v));
  int sc, sg;
  mag_fields<NB>(mag, es, tab, sc, sg);  // p8: NaR (128) and zero give significand 0
  const bool live = NB == 8 ? sg != 0 : (mag != 0u && mag != 0x8000u);
  sh = live ? sc - beta : 64;
  const uint32_t sig = static_cast<uint32_t>(sg);
  // a shift past 31 (or negative, as unsigned) clamps to 0
  const int bv = static_cast<int>(__funnelshift_lc(0u, sig, static_cast<uint32_t>(sh)));
  return v < 0 ? -bv : bv;
}

template <int NB>
__device__ __forceinline__ uint32_t load_code(const void* p, long long i) {
  if constexpr (NB == 8) return static_cast<const uint8_t*>(p)[i];
  else return static_cast<const uint16_t*>(p)[i];
}

template <int NB>
__device__ __forceinline__ uint32_t to_word(uint32_t code, int es, const uint32_t* tab) {
  if constexpr (NB == 8) return tab[code];
  else return field_word<16>(code, es);
}

// Exact per-product placement: q[limb * LS] += digits of (sig_a * sig_b) <<
// (offset % 16), no carries. C is the offset constant less the two scale
// biases; the low 10 bits of wa + wb + C are the offset.
template <int LS>
__device__ __forceinline__ void accumulate(int* qc, uint32_t wa, uint32_t wb, uint32_t c) {
  const int off = static_cast<int>((wa + wb + c) & 0x3FFu);
  const int p = w_sig(wa) * w_sig(wb);
  const uint64_t v = static_cast<uint64_t>(static_cast<int64_t>(p)) << (off & 15);
  const uint32_t lo = static_cast<uint32_t>(v);
  int* q = qc + (off >> 4) * LS;
  atomicAdd(q, static_cast<int>(lo & 0xFFFFu));
  atomicAdd(q + LS, static_cast<int>(lo >> 16));
  atomicAdd(q + 2 * LS, static_cast<int>(v >> 32));
}

// Chunk placement: q[limb * LS] += the five digits of v << (off % 16) at
// limbs off / 16 .. + 4: four unsigned 16-bit digits and the signed rest.
template <int LS>
__device__ __forceinline__ void place(int* qc, long long v, int off) {
  const int s = off & 15;
  const unsigned long long lo = static_cast<unsigned long long>(v) << s;
  const int hi = static_cast<int>(s == 0 ? (v >> 63) : (v >> (64 - s)));
  int* q = qc + (off >> 4) * LS;
  atomicAdd(q, static_cast<int>(lo & 0xFFFFu));
  atomicAdd(q + LS, static_cast<int>((lo >> 16) & 0xFFFFu));
  atomicAdd(q + 2 * LS, static_cast<int>((lo >> 32) & 0xFFFFu));
  atomicAdd(q + 3 * LS, static_cast<int>(lo >> 48));
  atomicAdd(q + 4 * LS, hi);
}

// Carry ripple over one quire column: digits in [0, 2^16) below the top
// limb, which keeps the signed remainder; the spare limb L folds in.
template <int L, int LS>
__device__ __forceinline__ void normalize_column(int* qc) {
  int c = 0;
#pragma unroll
  for (int i = 0; i < L - 1; ++i) {
    const int t = qc[i * LS] + c;
    qc[i * LS] = t & 0xFFFF;
    c = t >> 16;  // arithmetic: the floor carry of a negative t
  }
  qc[(L - 1) * LS] += c + qc[L * LS] * 65536;
  qc[L * LS] = 0;
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

// Read one summed quire out once, run the epilogue, store output idx.
template <int QN>
__device__ __forceinline__ void store_output(const QArgs& g, long long idx, int n,
                                             int (&q)[Quire<QN>::kLimbs], bool nar) {
  const Readout r = readout_fields<Quire<QN>::kLimbs, Quire<QN>::kBias>(q);
  const bool epilogue = g.bias != nullptr || g.residual != nullptr || g.act != posit::kActNone;
  if (g.out_kind != kF32 && !epilogue) {
    // exact single rounding straight into the posit rd
    const int nb = g.out_kind == kP8 ? 8 : 16;
    uint32_t code = posit::encode_fields(r.neg, r.scale, r.frac_la, r.sticky, nb, g.es_out);
    if (r.is_zero) code = 0u;
    if (nar) code = 1u << (nb - 1);
    if (nb == 8) static_cast<uint8_t*>(g.out)[idx] = static_cast<uint8_t>(code);
    else static_cast<uint16_t*>(g.out)[idx] = static_cast<uint16_t>(code);
    return;
  }
  float y = f32_from_fields(r);
  if (r.is_zero) y = 0.0f;
  if (nar) y = __uint_as_float(posit::kNaNBits);
  if (g.bias != nullptr) y += g.bias[n];
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

// ---------------------------------------------------------------- GEMM ----

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes to shared memory: `nb` bytes from `src`, zeros after them;
// cp.async when `vec` says the source is 16-byte aligned, plain loads else.
__device__ __forceinline__ void stage_piece(void* dst, const uint8_t* src, int nb, bool vec) {
  if (vec) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(nb)
                 : "memory");
    return;
  }
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q * 4 + j < nb) v |= static_cast<uint32_t>(src[q * 4 + j]) << (8 * j);
    w[q] = v;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// BM aligned A integers of one k, read by every thread (a broadcast).
template <int BM>
__device__ __forceinline__ void load_a_row(const int* p, int (&v)[BM]) {
  if constexpr (BM % 4 == 0) {
#pragma unroll
    for (int i = 0; i < BM; i += 4) {
      const int4 x = *reinterpret_cast<const int4*>(p + i);
      v[i] = x.x; v[i + 1] = x.y; v[i + 2] = x.z; v[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < BM; ++i) v[i] = p[i];
  }
}

// (three blocks share an SM at most, bounded by their shared memory, so the
// compiler may spend the registers of three)
template <int KA, int KB, int BM>
__global__ void __launch_bounds__(kThreads * kGroups, 3)
quire_gemm_kernel(QArgs g) {
  constexpr int NA = KA == kP16 ? 16 : 8;
  constexpr int NB = KB == kP16 ? 16 : 8;
  constexpr int QN = NA > NB ? NA : NB;
  constexpr int L = Quire<QN>::kLimbs;
  constexpr int LS = BM * kThreads;  // stride between limbs of one quire
  constexpr int kBlock = kThreads * kGroups;
  constexpr int EPT = (BM * kKS + kBlock - 1) / kBlock;  // A elements a thread stages
  using OA = Operand<NA>;
  using OB = Operand<NB>;
  using CodeB = std::conditional_t<NB == 8, uint8_t, uint16_t>;
  using SCodeB = std::conditional_t<NB == 8, int8_t, int16_t>;
  // quire offset of 2^(alpha + beta) * (aligned product): the bias less
  // both significands' fraction widths; the per-product form less the
  // field words' scale biases
  constexpr int kOffset = Quire<QN>::kBias - (OA::kSigw - 1) - (OB::kSigw - 1);
  constexpr uint32_t kProductOffset = static_cast<uint32_t>(kOffset - 2 * kScaleBias);
  constexpr uint32_t kNaRB = 1u << (NB - 1);
  constexpr uint32_t kNaRA = 1u << (NA - 1);
  // dynamic: (L + 1) limbs x BM rows x kThreads columns of quires, then the
  // ring of B stages (kKS k x kThreads columns of raw codes each)
  extern __shared__ __align__(16) int qs[];
  CodeB* const ring = reinterpret_cast<CodeB*>(qs + (L + 1) * LS);
  __shared__ __align__(16) int a_al[kKS][BM];   // aligned A integers
  __shared__ uint32_t a_w[kKS][BM];             // A field words
  __shared__ int a_anchor[kChunks][BM];
  __shared__ uint32_t a_low[kChunks][BM];       // k of a row's chunk below its window
  __shared__ uint32_t tab_a[NA == 8 ? 256 : 1];
  __shared__ uint32_t tab_b[NB == 8 ? 256 : 1];
  __shared__ int nar_a[BM];
  __shared__ int nar_b[kThreads];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int t = tid % kThreads, grp = tid / kThreads;  // column, k group
  const int lane = tid & 31;
  const int n0 = (blockIdx.x / g.splits) * kThreads, m0 = blockIdx.y * BM;
  const int k_begin = rank * g.k_per_split;
  const int k_end = min(g.K, k_begin + g.k_per_split);

  for (int i = tid; i < (L + 1) * LS; i += kBlock) qs[i] = 0;
  if (tid < BM) nar_a[tid] = 0;
  if (tid < kThreads) nar_b[tid] = 0;
  if constexpr (NA == 8)
    for (int c = tid; c < 256; c += kBlock) tab_a[c] = field_word<8>(c, g.es_a);
  if constexpr (NB == 8)
    for (int c = tid; c < 256; c += kBlock) tab_b[c] = field_word<8>(c, g.es_b);

  // B stage at ks (128 rows x 64 columns, zero past k_end and N) into ring
  // slot `slot`, 16 bytes a copy: cp.async where rows are 16-byte aligned,
  // plain loads otherwise
  constexpr int EB = NB / 8;
  constexpr int kPieces = kThreads * EB / 16;  // 16-byte pieces of a tile row
  const bool vec = reinterpret_cast<uintptr_t>(g.b) % 16 == 0 && (g.N * EB) % 16 == 0;
  auto stage = [&](int ks, int slot) {
#pragma unroll
    for (int q = tid; q < kKS * kPieces; q += kBlock) {
      const int r = q / kPieces, cc = q % kPieces;
      const int k = ks + r, col = n0 + cc * (16 / EB);
      const int nb = k < k_end ? max(0, min(16, (g.N - col) * EB)) : 0;
      const uint8_t* src = static_cast<const uint8_t*>(g.b) +
                           (nb > 0 ? (static_cast<long long>(k) * g.N + col) * EB : 0);
      stage_piece(ring + (slot * kKS + r) * kThreads + cc * (16 / EB), src, nb, vec);
    }
    cp_async_commit();
  };
  stage(k_begin, 0);
  // A codes of the next stage (this thread's EPT elements), loaded ahead
  uint32_t a_next[EPT];
  auto fetch_a = [&](int ks) {
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int e = tid + j * kBlock;
      const int m = m0 + e / kKS, k = ks + e % kKS;
      a_next[j] = (e < BM * kKS && m < g.M && k < k_end)
                      ? load_code<NA>(g.a, static_cast<long long>(m) * g.K + k) : 0u;
    }
  };
  fetch_a(k_begin);
  bool nar_col = false;
  int stages = 0;
  int slot = 0;

  for (int ks = k_begin; ks < k_end; ks += kKS, slot ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // stage ks has landed; the last stage is consumed
    if (stages == kNormStages) {  // carries, between two barriers
      if (grp == 0) {
#pragma unroll
        for (int i = 0; i < BM; ++i) normalize_column<L, LS>(qs + i * kThreads + t);
      }
      stages = 0;
    }
    stage(ks + kKS, slot ^ 1);  // in flight while this stage is summed
    // Stage BM x 128 of A: a warp holds one row's 32-k chunk, so the row's
    // anchor for the chunk is a warp max.
    uint32_t a_codes[EPT];
#pragma unroll
    for (int j = 0; j < EPT; ++j) a_codes[j] = a_next[j];
    fetch_a(ks + kKS);
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const int e = tid + j * kBlock;
      if (BM * kKS % kBlock != 0 && e >= BM * kKS) break;  // whole warps
      const int i = e / kKS, kk = e % kKS;
      if (a_codes[j] == kNaRA) nar_a[i] = 1;
      const uint32_t w = to_word<NA>(a_codes[j], g.es_a, tab_a);
      a_w[kk][i] = w;
      const int sig = w_sig(w), sc = w_scale(w);
      // NaR counts as maxpos, as on the B side
      const int mx = __reduce_max_sync(
          0xFFFFFFFFu, a_codes[j] == kNaRA ? (NA - 2) << g.es_a : (sig != 0 ? sc : kNoScale));
      const int anchor = max(mx - OA::kWindow, -OA::kSmax);
      const int sh = sc - anchor;
      const bool low = sig != 0 && sh < 0;
      a_al[kk][i] = sh >= 0 ? static_cast<int>(static_cast<uint32_t>(sig) << (sh & 31)) : 0;
      const unsigned any_low = __ballot_sync(0xFFFFFFFFu, low);
      if (lane == 0) {
        a_anchor[kk / kKC][i] = anchor;
        a_low[kk / kKC][i] = any_low;
      }
    }
    __syncthreads();
    ++stages;

    // k group grp sums chunks grp, grp + kGroups, ... of the stage
    for (int c = grp; c < kChunks; c += kGroups) {
      const int k0 = ks + c * kKC;
      if (k0 >= k_end) break;
      const CodeB* col = ring + (slot * kKS + c * kKC) * kThreads + t;
      const SCodeB* scol = reinterpret_cast<const SCodeB*>(col);  // codes as signed ints
      // The column's anchor: the largest magnitude's scale less the window.
      // Posits order as signed integers, so the largest magnitude is the
      // larger of the largest code and minus the smallest. NaR is the
      // smallest code; it makes the column's outputs NaR, so its anchor
      // (from maxpos) only has to be in range.
      constexpr int kMag = (1 << (NB - 1)) - 1;
      int hi = 0, lo = 0;
#pragma unroll 8
      for (int j = 0; j < kKC; ++j) {
        const int v = scol[j * kThreads];
        hi = max(hi, v);
        lo = min(lo, v);
      }
      nar_col |= lo == -kMag - 1;
      const uint32_t top = static_cast<uint32_t>(min(max(hi, -lo), kMag));
      int beta = -OB::kSmax;
      if (top != 0u) {
        int sc, sg;
        mag_fields<NB>(top, g.es_b, tab_b, sc, sg);
        beta = max(sc - OB::kWindow, -OB::kSmax);
      }

      long long acc[BM];
#pragma unroll
      for (int i = 0; i < BM; ++i) acc[i] = 0;
      int min_sh = 0;  // below 0: a B element of the chunk is below the window
#pragma unroll 8
      for (int j = 0; j < kKC; ++j) {
        int sh;
        const int bv = aligned_b<NB>(scol[j * kThreads], g.es_b, beta, tab_b, sh);
        min_sh = min(min_sh, sh);
        int av[BM];
        load_a_row<BM>(&a_al[c * kKC + j][0], av);
#pragma unroll
        for (int i = 0; i < BM; ++i) acc[i] += static_cast<long long>(av[i]) * bv;
      }

      // products with an element below its window: placed one by one,
      // visiting only those elements
      const bool any_low_b = min_sh < 0;
      uint32_t low_a[BM];
      uint32_t any_low = any_low_b ? 1u : 0u;
#pragma unroll
      for (int i = 0; i < BM; ++i) any_low |= low_a[i] = a_low[c][i];
      if (any_low != 0u) {
        const uint32_t* wa = &a_w[c * kKC][0];
        uint32_t low_b = 0u;  // k of the chunk whose B element is below the window
        if (any_low_b) {
          for (int j = 0; j < kKC; ++j) {
            const uint32_t wbj = to_word<NB>(col[j * kThreads], g.es_b, tab_b);
            if (w_sig(wbj) != 0 && w_scale(wbj) < beta) low_b |= 1u << j;
          }
        }
        for (uint32_t bits = low_b; bits != 0u; bits &= bits - 1u) {
          const int j = __ffs(bits) - 1;  // B below: with every live A of k
          const uint32_t wbj = to_word<NB>(col[j * kThreads], g.es_b, tab_b);
          for (int i = 0; i < BM; ++i)
            if (w_sig(wa[j * BM + i]) != 0)
              accumulate<LS>(qs + i * kThreads + t, wa[j * BM + i], wbj, kProductOffset);
        }
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          for (uint32_t bits = low_a[i] & ~low_b; bits != 0u; bits &= bits - 1u) {
            const int j = __ffs(bits) - 1;  // A below, B inside: with a live B
            const uint32_t code = col[j * kThreads];
            if (code != 0u && code != kNaRB)
              accumulate<LS>(qs + i * kThreads + t, wa[j * BM + i],
                             to_word<NB>(code, g.es_b, tab_b), kProductOffset);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < BM; ++i)
        if (acc[i] != 0)
          place<LS>(qs + i * kThreads + t, acc[i], a_anchor[c][i] + beta + kOffset);
    }
  }
  cp_async_wait<0>();  // the last, empty stage
  if (nar_col) nar_b[t] = 1;
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < BM; ++i) normalize_column<L, LS>(qs + i * kThreads + t);
  }

  // Sum the cluster's quires in rank order; rank r reads out outputs
  // r*kBlock + tid, (r + splits)*kBlock + tid, ... of the tile (row-major).
  cluster.sync();
  for (int o = rank * kBlock + tid; o < BM * kThreads; o += g.splits * kBlock) {
    const int i = o / kThreads, tt = o % kThreads;
    const int m = m0 + i, nn = n0 + tt;
    if (m >= g.M || nn >= g.N) continue;
    int q[L];
#pragma unroll
    for (int l = 0; l < L; ++l) q[l] = 0;
    int flag = 0;
    for (int r = 0; r < g.splits; ++r) {
      const int* rq = cluster.map_shared_rank(qs, r) + i * kThreads + tt;
#pragma unroll
      for (int l = 0; l < L; ++l) q[l] += rq[l * LS];
      flag |= *cluster.map_shared_rank(&nar_a[i], r) | *cluster.map_shared_rank(&nar_b[tt], r);
    }
    store_output<QN>(g, static_cast<long long>(m) * g.N + nn, nn, q, flag != 0);
  }
  cluster.sync();  // no block leaves while another reads its quires
}

// repro_torch/kernels/posit_quire_gemm/ops.py `TILES` mirrors these tiles.
// The launch config of one tile kind: dynamic shared memory for the quires
// (the attribute above 48 KB), all of the SM's shared memory asked for (the
// quires set how many blocks share an SM), one cluster per tile.
template <int KA, int KB, int BM>
cudaError_t configure(const QArgs& g, cudaStream_t s, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr) {
  constexpr int QN = (KA == kP16 || KB == kP16) ? 16 : 8;
  constexpr int smem = smem_bytes(Quire<QN>::kLimbs, BM, KB == kP16 ? 16 : 8);
  auto kern = quire_gemm_kernel<KA, KB, BM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  cfg = {};
  cfg.gridDim = dim3(((g.N + kThreads - 1) / kThreads) * g.splits, (g.M + BM - 1) / BM, 1);
  cfg.blockDim = dim3(kThreads * kGroups, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// Launch (clusters == nullptr), or report how many clusters of this tile
// kind fit on the card at once.
template <int KA, int KB, int BM>
cudaError_t run_tiles(const QArgs& g, cudaStream_t s, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = configure<KA, KB, BM>(g, s, cfg, attr);
  if (e != cudaSuccess) return e;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, quire_gemm_kernel<KA, KB, BM>, &cfg);
  e = cudaLaunchKernelEx(&cfg, quire_gemm_kernel<KA, KB, BM>, g);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int KA, int KB>
cudaError_t run_rows(const QArgs& g, cudaStream_t s, int* clusters) {
  if (g.M <= 1) return run_tiles<KA, KB, 1>(g, s, clusters);
  if (g.M <= 4) return run_tiles<KA, KB, 4>(g, s, clusters);
  return run_tiles<KA, KB, 8>(g, s, clusters);
}

cudaError_t run(const QArgs& g, int a_bits, int b_bits, cudaStream_t s, int* clusters) {
  if (a_bits == 16 && b_bits == 16) return run_rows<kP16, kP16>(g, s, clusters);
  if (a_bits == 16) return run_rows<kP16, kP8>(g, s, clusters);
  if (b_bits == 16) return run_rows<kP8, kP16>(g, s, clusters);
  return run_rows<kP8, kP8>(g, s, clusters);
}

bool bits_ok(int a_bits, int b_bits) {
  return (a_bits == 8 || a_bits == 16) && (b_bits == 8 || b_bits == 16);
}

}  // namespace

extern "C" {

// a (M, K), b (K, N) posit codes of a_bits / b_bits; out (M, N) of out_kind.
// K splits into `splits` (1..8) ranges of k_per_split (a multiple of 128),
// the blocks of one cluster.
int posit_quire_gemm_launch(const void* a, const void* b, void* out, const float* bias,
                            const float* residual, int M, int N, int K, int a_bits,
                            int b_bits, int out_kind, int es_a, int es_b, int es_out, int act,
                            int splits, int k_per_split, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (!bits_ok(a_bits, b_bits) || K < 0 ||
      (out_kind != kF32 && out_kind != kP8 && out_kind != kP16) || act < posit::kActNone ||
      act > posit::kActRelu || splits < 1 || splits > kMaxSplits || k_per_split < kKS ||
      k_per_split % kKS != 0 || static_cast<long long>(splits) * k_per_split < K)
    return static_cast<int>(cudaErrorInvalidValue);
  auto clamp_es = [](int es) { return es < 0 ? 0 : (es > 3 ? 3 : es); };
  const QArgs g{a, b, out, bias, residual, M, N, K, clamp_es(es_a), clamp_es(es_b),
                clamp_es(es_out), out_kind, act, splits, k_per_split};
  return static_cast<int>(run(g, a_bits, b_bits, static_cast<cudaStream_t>(stream), nullptr));
}

// *clusters = how many clusters of `splits` blocks of the tile kind for M
// rows fit on the card at once (cudaOccupancyMaxActiveClusters); for
// ops.py `split_plan`.
int posit_quire_gemm_max_clusters(int M, int a_bits, int b_bits, int splits, int* clusters) {
  if (M <= 0 || !bits_ok(a_bits, b_bits) || splits < 1 || splits > kMaxSplits ||
      clusters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  QArgs g{};
  g.M = M;
  g.N = kThreads;
  g.splits = splits;
  return static_cast<int>(run(g, a_bits, b_bits, nullptr, clusters));
}

}  // extern "C"
