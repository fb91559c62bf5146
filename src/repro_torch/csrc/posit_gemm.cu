// Fused posit GEMM: O = encode(act(decode(A) @ decode(B) + bias) + residual).
//
// Replaces: src/repro/kernels/posit_gemm/posit_gemm.py, `posit_gemm` (Pallas
// body `_gemm_kernel`), both of its branches: unpacked operands, and packed
// p8 B (`b_packed`, :68-98), which arrives as (ceil(K/2), N) uint16 split-K
// lanes (repro_torch/core/pack.py: word (r, c) holds code (r, c) in its low
// byte and code (r + Kh, c) in its high byte, Kh = ceil(K/2)). Either way
//   A @ decode(B) == A[:, :Kh] @ decode(lo) + A[:, Kh:] @ decode(hi),
// then the fused epilogue and the encode. The reference's `codec_impl`
// ("lut" feeds the Pallas body a (4, 256) table, "bits" the pipeline) does
// not reach these kernels: they decode p8 through tables they build with the
// bit pipeline, which is bit-exact either way (on the TPU the reference
// always runs "bits"); the plain version on the CPU honours the knob.
//
// Bound on the H100, at the serving shapes: device-memory bytes. A decode step
// multiplies M = 1..8 activation rows into a (K, N) weight of p8 codes, so each
// weight byte read does 2*M flops, far below the ~295 flops per byte where the
// bf16 tensor cores would become the limit; prefill (M = 64) does 128 flops a
// weight byte, still below it.
//
// Two datapaths, chosen by the format pair:
//
// * Tensor cores (`tc_gemm_kernel`), for the pairs computed in bf16 with B as
//   p8, p16 or bf16 codes. A p8 code decodes exactly to bf16 (DESIGN.md
//   section 2); a p16 code is rounded to bf16 from its exact value, as the
//   reference does (`posit_decode(...).astype(compute_dtype)`); bf16 x bf16
//   products are exact in f32, so `mma.sync.m16n8k16` bf16 -> f32 differs
//   from an f32 FMA loop only in the summation order.
//   - Raw codes stream: each stage of 64 k rows x 128 columns of B (1 byte an
//     element for p8) and the matching A slice arrive through cp.async, 16
//     bytes a thread, in a ring of shared memory (3 stages for the 8-row
//     tile, two blocks an SM, or 7 and one block for p16; 5 for the 64-row
//     tile, one block an SM), so ~45-120 KB per SM are in flight whatever
//     the register count. Ragged
//     edges are zero-filled by the copy (src-size < 16).
//   - The weights are the MMA's A operand (16 weight columns x 16 k), the
//     activations its B operand (8 rows). A lane reads 8 consecutive columns
//     of 4 k rows (two 16-k halves) and owns two columns of each of 4 MMAs,
//     so one 8-byte load per row feeds the fragments; the MMA's logical
//     rows map back to columns in the epilogue. Row strides are padded so
//     these loads and the activation fragment loads hit distinct banks.
//   - p8 decode: a 256-entry table of bf16 bits replicated once per lane
//     (entry (code, lane) at word code * 32 + lane, 32 KB, built once per
//     block), so every lookup of a warp hits 32 distinct banks.
//   - p16 decode: the class table below (`p16_magnitude`), about 8 integer
//     operations and one conflict-free shared-memory load a code in place of
//     the ~35 of the bit pipeline, then one hardware RNE to bf16 a pair
//     (`__floats2bfloat162_rn`). The int32 pipe, not the bytes, bounded the
//     f32-FMA kernel on p16 weights. The table fills while the ring's first
//     stages load; the 8-row tile runs one block an SM with a 7-stage ring
//     and 255 registers (measured faster than two blocks with 3 stages at
//     the k/v shape, no slower at q/o). With bf16 weights (the same bytes,
//     no decode) the kernel itself reads ~2 TB/s at these shapes; the decode
//     adds about a third to that.
//   - M <= 8 pads to the MMA's 8 rows and every weight element is decoded
//     once for all rows; M > 8 uses 64-row tiles of A (8 MMAs per decoded
//     fragment), which from 9 to 64 rows take only the shapes
//     posit_gemm_mid.cu refuses (kernels/posit_gemm/ops.py `gemm_route`).
//     Eight warps: two column halves x four 16-row k slices of a stage; the
//     slices' sums meet in shared memory in slice order.
//   - Stream-K: a persistent grid of `grid` blocks (one wave of resident
//     blocks, sized by kernels/posit_gemm/ops.py `split_plan`) walks the
//     (tile, k step) space in equal contiguous shares, so the load is even
//     whatever N is. A tile split between blocks gets each part's f32
//     partial; the last part to finish (an atomic counter per tile after
//     __threadfence) sums the parts in block order, which is k order, runs
//     the epilogue and resets the counter (the wrapper keeps one zeroed
//     counter buffer per device and stream, so two launches that share a
//     buffer never overlap). One launch, and a fixed sum order:
//     for M <= 8 the plan does not depend on M, so a row's result does not
//     depend on how many other rows share the batch. The walk advances its
//     cursor without divisions (64-bit divisions in the loop cost 2x).
// * f32 FMA, for pairs computed in f32 (p16 or f32 B; TF32 is not exact for
//   p16) and for p16 or f32 B, or p16 A, under bf16: `gemv_kernel` for M <= 8
//   (B streamed once, 8 columns a lane, each element decoded once for all
//   rows, p16 through the class table) and `gemm_kernel` (64 x 64 tiles)
//   above. K splits over blockIdx.z into f32 partials that a second kernel
//   sums in split order before the epilogue.
//
// Packed p8 B (kind kP8x2) takes both datapaths, walking the Kh packed rows:
// * tensor cores: a ring stage holds 64 packed rows x 128 columns (16 KB, 8
//   for p8) and two A slices, columns [k0, k0+64) and [Kh+k0, Kh+k0+64)
//   (the high slice zero past K for odd K). A lane's 16-byte row splits into
//   its low and high bytes with __byte_perm, and each half goes through the
//   p8 table into the fragments of one set of MMAs, so a packed stage is two
//   stages of MMAs. The ring keeps 2 stages for the 8-row tile (two blocks an
//   SM) and 3 for the 64-row tile, to fit shared memory with B's doubled share.
// * f32 FMA: each uint16 word decodes into two codes, which multiply A[m, r]
//   and A[m, r + Kh].
// The plan (kernels/posit_gemm/ops.py) walks Kh rows, so a decode row's sum
// order still does not depend on M <= 8.
//
// The epilogue (bias, activation, residual, posit encode or float store)
// runs in registers on both paths.
#include "posit_gemm.cuh"

namespace {

using posit::kBF16;
using posit::kF32;
using posit::kP16;
using posit::kP8;
using posit::fill_p16_table;
using posit::kP16TabBytes;
using posit::p16_f32;
using posit::p16_magnitude;
using gemm::GemmArgs;
using gemm::emit;
using gemm::kP8x2;
using gemm::splitk_epilogue_kernel;
using gemm::to_compute;

// Two p16 codes (a uint32 word: low half, high half) as two bf16, RNE from
// the exact values (NaR: a NaN).
__device__ __forceinline__ uint32_t p16_bf16x2(uint32_t w, const uint8_t* tab, uint32_t lane4) {
  const int lo = static_cast<int16_t>(w & 0xFFFFu), hi = static_cast<int>(w) >> 16;
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__uint_as_float(p16_magnitude(lo, tab, lane4)),
                            __uint_as_float(p16_magnitude(hi, tab, lane4)));
  return *reinterpret_cast<const uint32_t*>(&h) ^ (w & 0x80008000u);
}

// Element (k, n) of B as float32, two lanes for a packed B (lo: row k, hi:
// row k + Kh), through the block's p8 table `tab`.
template <int KB>
__device__ __forceinline__ void load_b(const void* b, long long i, int es, const float* tab,
                                       float (&v)[KB == kP8x2 ? 2 : 1]) {
  if constexpr (KB == kP8x2) {
    const uint32_t w = static_cast<const uint16_t*>(b)[i];
    v[0] = tab[w & 255u];
    v[1] = tab[w >> 8];
  } else {
    v[0] = posit::load_elem<KB>(b, i, es, tab);
  }
}

template <int KA, int KB, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
gemm_kernel(GemmArgs g) {
  constexpr int NT = (BM / TM) * (BN / TN);
  constexpr int TX = BN / TN;
  constexpr int NL = KB == kP8x2 ? 2 : 1;  // lanes of a B word
  __shared__ __align__(16) float As[NL][BK][BM];
  __shared__ __align__(16) float Bs[NL][BK][BN];
  __shared__ float tab_a[KA == kP8 ? 256 : 1];
  __shared__ float tab_b[KB == kP8 || KB == kP8x2 ? 256 : 1];
  const int tid = threadIdx.x;
  if constexpr (KA == kP8) posit::fill_p8_table(tab_a, g.es_a, tid, NT);
  if constexpr (KB == kP8 || KB == kP8x2) posit::fill_p8_table(tab_b, g.es_b, tid, NT);
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * g.k_per_split;
  const int k_end = min(g.kb, k_begin + g.k_per_split);
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        // lane l reads A's column l * Kh + k (the high half: zero past K)
        float v = 0.0f;
        if (m < g.M && k < k_end && l * g.kb + k < g.K)
          v = to_compute(posit::load_elem<KA>(g.a, static_cast<long long>(m) * g.K +
                                                       l * g.kb + k, g.es_a, tab_a),
                         g.bf16_compute);
        As[l][c][r] = v;
      }
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      float v[NL];
#pragma unroll
      for (int l = 0; l < NL; ++l) v[l] = 0.0f;
      if (k < k_end && n < g.N) load_b<KB>(g.b, static_cast<long long>(k) * g.N + n, g.es_b,
                                           tab_b, v);
#pragma unroll
      for (int l = 0; l < NL; ++l) Bs[l][r][c] = to_compute(v[l], g.bf16_compute);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        float av[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[l][kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = Bs[l][kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
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
// memory in warp order. A packed row's two codes meet A's columns r and
// r + Kh, both staged (half as many k a chunk).
constexpr int kGvThreads = 256;
constexpr int kGvWarps = kGvThreads / 32;
constexpr int kGvVec = 8;                 // columns per lane
constexpr int kGvCols = 32 * kGvVec;      // columns per block
constexpr int kGvKChunk = 1024;           // k of A staged at a time

// kGvVec consecutive B values of one row as float32, one vector load; a
// packed row gives its low lane in v[0..7] and its high lane in v[8..15].
// `tab` is the block's p8 table, `tab16` its p16 table.
template <int KB>
__device__ __forceinline__ void load_row(const void* b, long long off,
                                         float (&v)[KB == kP8x2 ? 2 * kGvVec : kGvVec],
                                         const float* tab, const uint8_t* tab16,
                                         uint32_t lane4) {
  if constexpr (KB == kP8) {
    const uint2 r = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(b) + off);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) v[j] = tab[c[j]];
  } else if constexpr (KB == kP8x2) {
    const uint4 r = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(b) + off);
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&r);
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) {
      v[j] = tab[c[2 * j]];
      v[kGvVec + j] = tab[c[2 * j + 1]];
    }
  } else if constexpr (KB == kP16) {
    const uint4 r = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(b) + off);
    const int16_t* c = reinterpret_cast<const int16_t*>(&r);
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) v[j] = p16_f32(c[j], tab16, lane4);
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
  constexpr int NL = KB == kP8x2 ? 2 : 1;      // lanes of a B word
  // B rows of a staged A chunk; fewer for p16, whose table takes the room
  // (static shared memory stays under 48 KB)
  constexpr int KC = KB == kP16 ? (MT == 1 ? 1024 : (MT <= 4 ? 256 : 128)) : kGvKChunk / NL;
  constexpr int U = (MT <= 4 ? 8 : 4) / NL;    // rows a warp has in flight (registers)
  __shared__ float As[NL][MT][KC];
  __shared__ float red[kGvWarps][kGvCols];
  __shared__ float tab_a[KA == kP8 ? 256 : 1];
  __shared__ float tab_b[KB == kP8 || KB == kP8x2 ? 256 : 1];
  __shared__ __align__(16) uint8_t tab16[KB == kP16 ? kP16TabBytes : 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if constexpr (KA == kP8) posit::fill_p8_table(tab_a, g.es_a, tid, kGvThreads);
  if constexpr (KB == kP8 || KB == kP8x2) posit::fill_p8_table(tab_b, g.es_b, tid, kGvThreads);
  if constexpr (KB == kP16) fill_p16_table(tab16, g.es_b, tid, kGvThreads);

  const int n0 = blockIdx.x * kGvCols;
  const int nl = n0 + lane * kGvVec;
  const bool full = vec_ok && nl + kGvVec <= g.N;
  const int k_begin = blockIdx.z * g.k_per_split;
  const int k_end = min(g.kb, k_begin + g.k_per_split);
  float acc[MT][kGvVec];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < kGvVec; ++j) acc[m][j] = 0.0f;

  for (int kc = k_begin; kc < k_end; kc += KC) {
    const int kn = min(KC, k_end - kc);
    __syncthreads();  // tables filled / previous chunk consumed
    for (int i = tid; i < NL * MT * KC; i += kGvThreads) {
      const int l = i / (MT * KC), m = i / KC % MT, c = i % KC;
      // lane l reads A's column l * Kh + k (the high half: zero past K)
      const int k = l * g.kb + kc + c;
      float v = 0.0f;
      if (m < g.M && c < kn && k < g.K)
        v = to_compute(posit::load_elem<KA>(g.a, static_cast<long long>(m) * g.K + k,
                                            g.es_a, tab_a), g.bf16_compute);
      As[l][m][c] = v;
    }
    __syncthreads();
    for (int r0 = warp; r0 < kn; r0 += kGvWarps * U) {
      float bv[U][NL * kGvVec];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u * kGvWarps;
        const long long off = static_cast<long long>(kc + r) * g.N + nl;
        if (r < kn && full) {
          load_row<KB>(g.b, off, bv[u], tab_b, tab16, lane * 4u);
        } else {
#pragma unroll
          for (int j = 0; j < kGvVec; ++j) {
            float v[NL];
#pragma unroll
            for (int l = 0; l < NL; ++l) v[l] = 0.0f;
            if (r < kn && nl + j < g.N) load_b<KB>(g.b, off + j, g.es_b, tab_b, v);
#pragma unroll
            for (int l = 0; l < NL; ++l) bv[u][l * kGvVec + j] = v[l];
          }
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
#pragma unroll
          for (int l = 0; l < NL; ++l) {
            const float a = As[l][m][r];
#pragma unroll
            for (int j = 0; j < kGvVec; ++j)
              acc[m][j] = fmaf(a, bv[u][l * kGvVec + j], acc[m][j]);
          }
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

// ---- tensor-core path: B as p8 (packed or not), p16 or bf16 codes, bf16 compute ----
constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcBN = 128;       // output columns of a tile
constexpr int kTcBK = 64;        // k rows of a stage

template <int KIND>
constexpr int elem_bytes() {
  return KIND == kF32 ? 4 : (KIND == kP8 ? 1 : 2);
}

// Tile geometry and shared-memory layout of the tensor-core kernel (bytes).
// A tile is BM rows x 128 columns; the 8 warps split it into CG = 2 column
// halves x KS = 4 16-row k slices of a stage. Row strides are padded for
// conflict-free fragment loads: B rows by 16 B (a stride of 16 mod 64
// spreads the four k rows a load phase touches over distinct banks), A rows
// by 32 B (f32: the eight rows of a phase) or 16 B. The 8-row tile keeps 3
// stages (two blocks an SM; 3 measured faster than 4 or 5); the 64-row
// tile, one block an SM with more work a stage, keeps 5 so its loads stay
// ahead (5 measured faster than 3 or 4). A packed stage (NL = 2 lanes) holds
// twice the B bytes and two A slices, so the rings keep 2 and 3 stages: the
// same B bytes in flight as 3 unpacked stages for the 8-row tile (two blocks
// an SM still fit), and what fits shared memory for the 64-row tile. p16's
// 8-row tile runs one block an SM with 7 stages (its 34 KB table beside).
template <int KA, int KB, int MT>
struct TcLayout {
  static constexpr int BM = 8 * MT;
  static constexpr int NL = KB == kP8x2 ? 2 : 1;
  // resident blocks an SM (kernels/posit_gemm/ops.py `split_plan` sizes the
  // grid from the same rule)
  static constexpr int BLOCKS = MT == 1 && KB != kP16 ? 2 : 1;
  static constexpr int EA = elem_bytes<KA>(), EB = elem_bytes<KB>();
  static constexpr int BN = kTcBN, CG = 2, KS = 4;
  static constexpr int STAGES =
      KB == kP16 && MT == 1 ? 7 : (NL == 2 ? (MT == 1 ? 2 : 3) : (MT == 1 ? 3 : 5));
  static constexpr int WS = BN * EB + 16;
  static constexpr int AS = kTcBK * EA + (EA == 4 ? 32 : 16);
  static constexpr int W_BYTES = kTcBK * WS;
  static constexpr int A_BYTES = BM * AS;  // one A slice
  static constexpr int STAGE = W_BYTES + NL * A_BYTES;
  // the replicated p8 table, or the p16 class table
  static constexpr int TAB = KB == kP8 || KB == kP8x2 ? 256 * 32 * 4
                             : (KB == kP16 ? kP16TabBytes : 0);
  static constexpr int TAB_A = KA == kP8 ? 256 * 4 : 0;
  static constexpr int RED = 8 * 16 * 32 * 4;               // warps x floats x lanes
  static constexpr int SMEM = TAB + TAB_A + RED + STAGES * STAGE;
  static_assert(SMEM * BLOCKS <= 227 * 1024, "the ring must fit its blocks an SM");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes to shared memory where a chunk may cross an edge of the matrix:
// `nb` bytes from `src`, zeros after them. `vec` says the source is 16-byte
// aligned (cp.async); otherwise plain byte loads.
__device__ __forceinline__ void stage_chunk(uint8_t* dst, const uint8_t* src, int nb, bool vec) {
  if (vec) {
    cp_async16(dst, src, nb);
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

// One stage: B rows k0..k0+63 x columns n0..n0+127 and A rows m0..m0+BM-1 x
// k0..k0+63, raw, zero past M, N and K; for a packed B, packed rows and two A
// slices, columns k0.. (zero from Kh on) and Kh+k0.. (zero from K on). A
// thread's chunks sit at fixed places of the tile, so a stage inside the
// matrix costs a 64-bit add and a cp.async a chunk; only edge stages count
// bytes.
template <int KA, int KB, int MT>
__device__ __forceinline__ void tc_load_stage(const GemmArgs& g, uint8_t* st, int m0, int n0,
                                              int k0, bool vec_a, bool vec_b) {
  using L = TcLayout<KA, KB, MT>;
  constexpr int WCH = L::BN * L::EB / 16;  // 16-byte chunks of a B row
  static_assert(kTcBK * WCH % kTcThreads == 0, "whole B chunks a thread");
  const uint8_t* b = static_cast<const uint8_t*>(g.b);
  const long long b_row = static_cast<long long>(g.N) * L::EB;
  const uint8_t* bt = b + static_cast<long long>(k0) * b_row + n0 * L::EB;
  const bool b_inside = vec_b && k0 + kTcBK <= g.kb && n0 + L::BN <= g.N;
  const int b_left = (g.N - n0) * L::EB;
#pragma unroll
  for (int j = 0; j < kTcBK * WCH / kTcThreads; ++j) {
    const int i = threadIdx.x + j * kTcThreads;
    const int r = i / WCH, c = i % WCH;
    uint8_t* dst = st + r * L::WS + c * 16;
    const uint8_t* src = bt + r * b_row + c * 16;
    if (b_inside) {
      cp_async16(dst, src, 16);
    } else {
      const int nb = k0 + r < g.kb ? max(0, min(16, b_left - c * 16)) : 0;
      stage_chunk(dst, nb > 0 ? src : b, nb, vec_b);
    }
  }
  constexpr int ACH = kTcBK * L::EA / 16;  // 16-byte chunks of an A row slice
  const uint8_t* a = static_cast<const uint8_t*>(g.a);
  const long long a_row = static_cast<long long>(g.K) * L::EA;
#pragma unroll
  for (int l = 0; l < L::NL; ++l) {
    // slice l: A's columns l * Kh + k0 .., valid below Kh (low) or K (high)
    const int col0 = l * g.kb + k0, lim = l == 0 ? g.kb : g.K;
    const uint8_t* at = a + static_cast<long long>(m0) * a_row +
                        static_cast<long long>(col0) * L::EA;
    const bool a_inside = vec_a && m0 + L::BM <= g.M && col0 + kTcBK <= lim;
    const int a_left = (lim - col0) * L::EA;
#pragma unroll
    for (int j = 0; j < (L::BM * ACH + kTcThreads - 1) / kTcThreads; ++j) {
      const int i = threadIdx.x + j * kTcThreads;
      if (L::BM * ACH % kTcThreads != 0 && i >= L::BM * ACH) break;
      const int r = i / ACH, c = i % ACH;
      uint8_t* dst = st + L::W_BYTES + l * L::A_BYTES + r * L::AS + c * 16;
      const uint8_t* src = at + r * a_row + c * 16;
      if (a_inside) {
        cp_async16(dst, src, 16);
      } else {
        const int nb = m0 + r < g.M ? max(0, min(16, a_left - c * 16)) : 0;
        stage_chunk(dst, nb > 0 ? src : a, nb, vec_a);
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The MMA's B fragment (8 activation rows x 16 k) of one lane, rounded to
// bf16: `p` points at row (lane / 4) and k offset 2 * (lane % 4) of the slice.
template <int KA>
__device__ __forceinline__ void act_frag(const uint8_t* p, const float* tab_a,
                                         uint32_t& b0, uint32_t& b1) {
  if constexpr (KA == kF32) {
    const float2 x0 = *reinterpret_cast<const float2*>(p);
    const float2 x1 = *reinterpret_cast<const float2*>(p + 32);
    b0 = pack_bf16(x0.x, x0.y);
    b1 = pack_bf16(x1.x, x1.y);
  } else if constexpr (KA == kBF16) {
    b0 = *reinterpret_cast<const uint32_t*>(p);
    b1 = *reinterpret_cast<const uint32_t*>(p + 16);
  } else {  // p8, exact in bf16
    const uint32_t c0 = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t c1 = *reinterpret_cast<const uint16_t*>(p + 8);
    b0 = pack_bf16(tab_a[c0 & 255u], tab_a[c0 >> 8]);
    b1 = pack_bf16(tab_a[c1 & 255u], tab_a[c1 >> 8]);
  }
}

// The MMA A fragments (16 weight columns x 16 k) of MMA j = 0..3 for one lane:
// rows r0..r3 hold k = 2t, 2t+1, 2t+8, 2t+9 (t = lane % 4) of the lane's 8
// columns; MMA j's logical rows g and g+8 are the lane's columns 2j and 2j+1.
// p8 codes go through the replicated table: entry (code, lane) is the word
// at byte code * 128 + lane * 4 of `tab` (`lane4` = lane * 4), reached with
// one shift, one and-or and the load.
__device__ __forceinline__ void p8_frags(const uint2 (&r)[4], const uint8_t* tab,
                                         uint32_t lane4, uint32_t (&f)[4][4]) {
  auto lut = [&](const uint2& w2, int byte) {
    const uint32_t w = byte < 4 ? w2.x : w2.y;
    const int sh = 8 * (byte & 3) - 7;  // code * 128 = byte shifted to bit 7
    const uint32_t off = ((sh < 0 ? w << 7 : w >> sh) & 0x7F80u) | lane4;
    return *reinterpret_cast<const uint32_t*>(tab + off);
  };
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j][0] = __byte_perm(lut(r[0], 2 * j), lut(r[1], 2 * j), 0x5410);
    f[j][1] = __byte_perm(lut(r[0], 2 * j + 1), lut(r[1], 2 * j + 1), 0x5410);
    f[j][2] = __byte_perm(lut(r[2], 2 * j), lut(r[3], 2 * j), 0x5410);
    f[j][3] = __byte_perm(lut(r[2], 2 * j + 1), lut(r[3], 2 * j + 1), 0x5410);
  }
}

// The four 16-byte rows (k = 2t, 2t+1, 2t+8, 2t+9) of a lane's 8 packed
// columns; `lane_codes` splits them into one lane's 8-byte p8 rows.
__device__ __forceinline__ void packed_rows(const uint8_t* p, int ws, uint4 (&r)[4]) {
  r[0] = *reinterpret_cast<const uint4*>(p);
  r[1] = *reinterpret_cast<const uint4*>(p + ws);
  r[2] = *reinterpret_cast<const uint4*>(p + 8 * ws);
  r[3] = *reinterpret_cast<const uint4*>(p + 9 * ws);
}

// The low (hi = false) or high bytes of each 16-bit word of a packed row:
// one __byte_perm per 8 bytes picks the even or the odd bytes.
__device__ __forceinline__ void lane_codes(const uint4 (&r)[4], bool hi, uint2 (&c)[4]) {
  const uint32_t sel = hi ? 0x7531u : 0x6420u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    c[q] = make_uint2(__byte_perm(r[q].x, r[q].y, sel), __byte_perm(r[q].z, r[q].w, sel));
}

template <int KB>
__device__ __forceinline__ void weight_frags(const uint8_t* p, int ws, const uint8_t* tab,
                                             uint32_t lane4, uint32_t (&f)[4][4]) {
  if constexpr (KB == kP8) {
    const uint2 r[4] = {*reinterpret_cast<const uint2*>(p),
                        *reinterpret_cast<const uint2*>(p + ws),
                        *reinterpret_cast<const uint2*>(p + 8 * ws),
                        *reinterpret_cast<const uint2*>(p + 9 * ws)};
    p8_frags(r, tab, lane4, f);
  } else {  // bf16, or p16 decoded to bf16: 8 columns = 16 bytes a row, two columns a word
    const uint4 r0 = *reinterpret_cast<const uint4*>(p);
    const uint4 r1 = *reinterpret_cast<const uint4*>(p + ws);
    const uint4 r2 = *reinterpret_cast<const uint4*>(p + 8 * ws);
    const uint4 r3 = *reinterpret_cast<const uint4*>(p + 9 * ws);
    uint32_t w0[4] = {r0.x, r0.y, r0.z, r0.w}, w1[4] = {r1.x, r1.y, r1.z, r1.w};
    uint32_t w2[4] = {r2.x, r2.y, r2.z, r2.w}, w3[4] = {r3.x, r3.y, r3.z, r3.w};
    if constexpr (KB == kP16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w0[j] = p16_bf16x2(w0[j], tab, lane4);
        w1[j] = p16_bf16x2(w1[j], tab, lane4);
        w2[j] = p16_bf16x2(w2[j], tab, lane4);
        w3[j] = p16_bf16x2(w3[j], tab, lane4);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j][0] = __byte_perm(w0[j], w1[j], 0x5410);
      f[j][1] = __byte_perm(w0[j], w1[j], 0x7632);
      f[j][2] = __byte_perm(w2[j], w3[j], 0x5410);
      f[j][3] = __byte_perm(w2[j], w3[j], 0x7632);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block b's share of the (tile, k step) items: [total * b / grid, total * (b+1) / grid).
__device__ __forceinline__ int share_start(int total, int b, int grid) {
  return static_cast<int>(static_cast<long long>(total) * b / grid);
}

// The block whose share holds item x.
__device__ __forceinline__ int share_owner(int total, int x, int grid) {
  return static_cast<int>((static_cast<long long>(x + 1) * grid - 1) / total);
}

// A walk over work items in order: tile, k step and the tile's origin,
// advanced without divisions (tiles are m-major inside a column range, so
// the blocks on one column range run together and share its weights in L2).
struct Cursor {
  int tile, step, m0, n0;
};

template <int KA, int KB, int MT>
__global__ void __launch_bounds__(kTcThreads, (TcLayout<KA, KB, MT>::BLOCKS))
tc_gemm_kernel(GemmArgs g, bool vec_a, bool vec_b) {
  using L = TcLayout<KA, KB, MT>;
  constexpr int BN = L::BN, S = L::STAGES;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_last;
  float* tab_a = reinterpret_cast<float*>(smem + L::TAB);
  float* red = reinterpret_cast<float*>(smem + L::TAB + L::TAB_A);
  uint8_t* ring = smem + L::TAB + L::TAB_A + L::RED;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = warp % L::CG, ks = warp / L::CG, gq = lane >> 2, tq = lane & 3;

  static_assert(kTcThreads == 256, "the p8 table takes one code a thread");
  if constexpr (KB == kP8 || KB == kP8x2) {
    // thread c decodes code c and writes its 32 lane copies, 16 bytes at a
    // time, rotated so a quarter warp's stores fall on distinct banks
    const uint32_t v = __bfloat16_as_ushort(
        __float2bfloat16_rn(posit::decode(static_cast<uint32_t>(tid), 8, g.es_b)));
    const uint4 v4 = make_uint4(v, v, v, v);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      reinterpret_cast<uint4*>(smem + tid * 128)[(q + tid) & 7] = v4;
  }
  if constexpr (KA == kP8) posit::fill_p8_table(tab_a, g.es_a, tid, kTcThreads);

  const int tiles_m = (g.M + L::BM - 1) / L::BM;
  const int iters = max(1, (g.kb + kTcBK - 1) / kTcBK);  // K = 0: one zero step
  const int total = tiles_m * ((g.N + BN - 1) / BN) * iters;
  const int grid = gridDim.x;
  const int w0 = share_start(total, blockIdx.x, grid);
  const int w1 = share_start(total, blockIdx.x + 1, grid);
  const int first_tile = w0 / iters;
  const int m_end = tiles_m * L::BM;
  auto advance = [&](Cursor& c) {
    if (++c.step < iters) return;
    c.step = 0;
    ++c.tile;
    c.m0 += L::BM;
    if (c.m0 == m_end) {
      c.m0 = 0;
      c.n0 += BN;
    }
  };
  Cursor load = {first_tile, w0 % iters, (first_tile % tiles_m) * L::BM,
                 (first_tile / tiles_m) * BN};
  Cursor cur = load;

  for (int s = 0; s < S - 1; ++s) {
    if (w0 + s < w1) {
      tc_load_stage<KA, KB, MT>(g, ring + s * L::STAGE, load.m0, load.n0, load.step * kTcBK,
                                vec_a, vec_b);
      advance(load);
    }
    cp_async_commit();
  }
  // the p16 table (33 KB) fills while the first stages are in flight
  if constexpr (KB == kP16) fill_p16_table(smem, g.es_b, tid, kTcThreads);

  float acc[4][MT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][mt][r] = 0.0f;
  int slot = 0;  // ring slot of the stage consumed next

  for (int w = w0; w < w1; ++w) {
    cp_async_wait<S - 2>();
    __syncthreads();  // this stage landed for every thread; the previous one is consumed
    if (w + S - 1 < w1) {
      const int fill = slot == 0 ? S - 1 : slot - 1;
      tc_load_stage<KA, KB, MT>(g, ring + fill * L::STAGE, load.m0, load.n0,
                                load.step * kTcBK, vec_a, vec_b);
      advance(load);
    }
    cp_async_commit();

    const uint8_t* st = ring + slot * L::STAGE;
    slot = slot == S - 1 ? 0 : slot + 1;
    const uint8_t* wp = st + (ks * 16 + 2 * tq) * L::WS + (cg * 64 + gq * 8) * L::EB;
    const uint8_t* ap = st + L::W_BYTES + gq * L::AS + (ks * 16 + 2 * tq) * L::EA;
    // a packed stage is two stages of MMAs: the low lanes against A's first
    // slice, then the high lanes against its second
    uint4 packed[KB == kP8x2 ? 4 : 1];
    if constexpr (KB == kP8x2) packed_rows(wp, L::WS, packed);
#pragma unroll
    for (int l = 0; l < L::NL; ++l) {
      uint32_t bf[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        act_frag<KA>(ap + l * L::A_BYTES + mt * 8 * L::AS, tab_a, bf[mt][0], bf[mt][1]);
      uint32_t af[4][4];
      if constexpr (KB == kP8x2) {
        uint2 codes[4];
        lane_codes(packed, l == 1, codes);
        p8_frags(codes, smem, lane * 4u, af);
      } else {
        weight_frags<KB>(wp, L::WS, smem, lane * 4u, af);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[j][mt], af[j], bf[mt][0], bf[mt][1]);
    }

    if (cur.step != iters - 1 && w != w1 - 1) {
      advance(cur);
      continue;
    }

    // ---- the block's part of cur.tile is done: reduce, then store or hand over
    const int tile = cur.tile, m0 = cur.m0, n0 = cur.n0;
    const bool whole = w - cur.step >= w0 && cur.step == iters - 1;
    advance(cur);
    float* part = g.partial +
                  (static_cast<long long>(blockIdx.x) * 2 + (tile == first_tile ? 0 : 1)) *
                      (L::BM * BN);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      __syncthreads();  // the previous round's reads of red[] are done
      // fragment order, the lane index swizzled (xor j into bits 0-1, the
      // register's column bit into bit 4) so the reads below, 32 columns of
      // one row a warp, hit 32 banks
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[((warp * 4 + j) * 4 + r) * 32 + (lane ^ j ^ ((r >> 1) << 4))] = acc[j][mt][r];
      __syncthreads();
      // not unrolled, and the finisher below goes through one site too:
      // unrolled copies of the inlined epilogue cost microseconds a tile
#pragma unroll 1
      for (int q = 0; q < 8 * BN / kTcThreads; ++q) {
        const int o = tid + q * kTcThreads;
        const int m = o / BN, col = o % BN;
        // the fragment slot of (m, col): column group, MMA j, register r, lane
        const int c = col & 63, j = (c & 7) >> 1, hi = c & 1;
        const int r = hi * 2 + (m & 1), ln = (c >> 3) * 4 + (m >> 1);
        const float* src = red + (((col >> 6) * 4 + j) * 4 + r) * 32 + (ln ^ j ^ (hi << 4));
        // the k slices in slice order (warp = slice * CG + column group)
        float y = src[0];
#pragma unroll
        for (int k = 1; k < L::KS; ++k) y += src[k * L::CG * 512];
        const int row = m0 + mt * 8 + m, n = n0 + col;
        if (!whole) part[(mt * 8 + m) * BN + col] = y;
        else if (row < g.M && n < g.N) emit(g, static_cast<long long>(row) * g.N + n, n, y);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][mt][r] = 0.0f;
    if (whole) continue;

    // the last part of the tile to finish sums all parts in block order
    const int b_first = share_owner(total, tile * iters, grid);
    const int b_last = share_owner(total, tile * iters + iters - 1, grid);
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(g.counters + tile, 1) == b_last - b_first;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    // b_first's part sits in its second slot unless its share starts at this
    // tile; every later contributor's share starts inside the tile
    const float* p0 = g.partial + (static_cast<long long>(b_first) * 2 +
                                   (share_start(total, b_first, grid) == tile * iters ? 0 : 1)) *
                                      (L::BM * BN);
    // a thread owns Q float4s of the tile; it loads QC of them for B
    // contributors at once, so a round trip to L2 carries 16 loads (8 for
    // the 64-row tile)
    constexpr int kPart = 2 * L::BM * BN;  // floats between two blocks' parts
    constexpr int Q = L::BM * BN / (4 * kTcThreads);
    constexpr int QC = Q < 4 ? Q : 4;
    constexpr int B = QC == 4 ? 2 : 16 / QC;  // the 64-row tile's accumulators hold registers
    for (int q0 = 0; q0 < Q; q0 += QC) {
      float4 y[QC];
#pragma unroll
      for (int q = 0; q < QC; ++q)
        y[q] = __ldcg(reinterpret_cast<const float4*>(p0 + (tid + (q0 + q) * kTcThreads) * 4));
      for (int b = b_first + 1; b <= b_last; b += B) {
        float4 v[B][QC];
#pragma unroll
        for (int u = 0; u < B; ++u)
#pragma unroll
          for (int q = 0; q < QC; ++q)
            if (b + u <= b_last)
              v[u][q] = __ldcg(reinterpret_cast<const float4*>(
                  g.partial + static_cast<long long>(b + u) * kPart +
                  (tid + (q0 + q) * kTcThreads) * 4));
#pragma unroll
        for (int u = 0; u < B; ++u)
#pragma unroll
          for (int q = 0; q < QC; ++q)
            if (b + u <= b_last) {
              y[q].x += v[u][q].x;
              y[q].y += v[u][q].y;
              y[q].z += v[u][q].z;
              y[q].w += v[u][q].w;
            }
      }
      // through red[] (free here) to a single epilogue site
#pragma unroll
      for (int q = 0; q < QC; ++q)
        reinterpret_cast<float4*>(red)[q * kTcThreads + tid] = y[q];
#pragma unroll 1
      for (int e = 0; e < 4 * QC; ++e) {
        const int o = (tid + (q0 + e / 4) * kTcThreads) * 4 + e % 4;
        const int row = m0 + o / BN, n = n0 + o % BN;
        if (row < g.M && n < g.N)
          emit(g, static_cast<long long>(row) * g.N + n, n,
               red[(e / 4 * kTcThreads + tid) * 4 + e % 4]);
      }
    }
    if (tid == 0) g.counters[tile] = 0;
  }
}

template <int KA, int KB, int MT>
cudaError_t launch_tc(const GemmArgs& g, int grid, cudaStream_t s) {
  using L = TcLayout<KA, KB, MT>;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_gemm_kernel<KA, KB, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    smem_set[dev] = true;
  }
  const long long items = static_cast<long long>((g.M + L::BM - 1) / L::BM) *
                          ((g.N + L::BN - 1) / L::BN) * max(1, (g.kb + kTcBK - 1) / kTcBK);
  // the kernel counts items in int, and the plan never has more blocks than items
  if (items >= (1LL << 31) / 2 || grid > items + 1) return cudaErrorInvalidValue;
  // 16-byte copies need every row start aligned (and a packed B's high A
  // slice start, column Kh)
  const bool vec_a = (static_cast<long long>(g.K) * L::EA) % 16 == 0 &&
                     (L::NL == 1 || (static_cast<long long>(g.kb) * L::EA) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(g.a) & 15u) == 0;
  const bool vec_b = (static_cast<long long>(g.N) * L::EB) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(g.b) & 15u) == 0;
  tc_gemm_kernel<KA, KB, MT><<<grid, kTcThreads, L::SMEM, s>>>(g, vec_a, vec_b);
  return cudaGetLastError();
}

template <int KA, int KB>
cudaError_t launch_tc_rows(const GemmArgs& g, int grid, cudaStream_t s) {
  // repro_torch/kernels/posit_gemm/ops.py plans the grid from these tile shapes
  return g.M <= 8 ? launch_tc<KA, KB, 1>(g, grid, s) : launch_tc<KA, KB, 8>(g, grid, s);
}

template <int KA>
cudaError_t launch_tc_b(const GemmArgs& g, int b_kind, int grid, cudaStream_t s) {
  switch (b_kind) {
    case kP8: return launch_tc_rows<KA, kP8>(g, grid, s);
    case kP8x2: return launch_tc_rows<KA, kP8x2>(g, grid, s);
    case kP16: return launch_tc_rows<KA, kP16>(g, grid, s);
    default: return launch_tc_rows<KA, kBF16>(g, grid, s);
  }
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
    case kP8x2: launch_kinds<KA, kP8x2>(g, s); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// b_kind: posit::Kind, or kP8x2 (4) for packed p8 B of ceil(K/2) rows.
// grid: tensor-core path (bf16 compute, B p8, packed p8, p16 or bf16, A
// f32/bf16/p8), the number of persistent blocks, with `partial` (grid, 2,
// BM, 128) f32 and `counters` (one zeroed int per output tile) when grid >
// 1; f32-FMA path, the split count of B's rows, with `partial` (grid, M, N)
// when grid > 1. kernels/posit_gemm/ops.py `uses_tensor_cores` makes the
// same choice.
int posit_gemm_launch(const void* a, const void* b, void* out, const float* bias,
                      const float* residual, float* partial, int* counters, int M, int N,
                      int K, int a_kind, int b_kind, int out_kind, int es_a, int es_b,
                      int es_out, int act, int bf16_compute, int grid, int k_per_split,
                      void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const bool tc = bf16_compute &&
                  (b_kind == kP8 || b_kind == kBF16 || b_kind == kP8x2 || b_kind == kP16) &&
                  (a_kind == kF32 || a_kind == kBF16 || a_kind == kP8);
  const int kb = b_kind == kP8x2 ? (K + 1) / 2 : K;
  if (grid < 1 || (grid > 1 && partial == nullptr) || out_kind < kF32 || out_kind > kP16 ||
      act < posit::kActNone || act > posit::kActRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc ? (grid > 1 && counters == nullptr)
         : (k_per_split < 1 || static_cast<long long>(grid) * k_per_split < kb))
    return static_cast<int>(cudaErrorInvalidValue);
  auto clamp_es = [](int es) { return es < 0 ? 0 : (es > 3 ? 3 : es); };
  GemmArgs g{a,        b,  out, bias,           residual,       partial,        counters,
             M,        N,  K,   kb,             clamp_es(es_a), clamp_es(es_b), clamp_es(es_out),
             out_kind, act, bf16_compute, grid, k_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tc) {
    switch (a_kind) {
      case kF32: return static_cast<int>(launch_tc_b<kF32>(g, b_kind, grid, s));
      case kBF16: return static_cast<int>(launch_tc_b<kBF16>(g, b_kind, grid, s));
      default: return static_cast<int>(launch_tc_b<kP8>(g, b_kind, grid, s));
    }
  }
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
  if (err != cudaSuccess || grid == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  splitk_epilogue_kernel<<<static_cast<unsigned>((MN + 255) / 256), 256, 0, s>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
