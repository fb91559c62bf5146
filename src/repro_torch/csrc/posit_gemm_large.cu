// Large-M tiles of the fused posit GEMM: O = encode(act(decode(A) @ decode(B)
// + bias) + residual) for M above the row count where the 64-row tiles of
// posit_gemm.cu stop paying (kernels/posit_gemm/ops.py `LARGE_M`, set by the
// crossover sweep in PERF.md): long prefills and training steps, where a
// weight element meets thousands of activation rows.
//
// Replaces: src/repro/kernels/posit_gemm/posit_gemm.py, `posit_gemm` (Pallas
// body `_gemm_kernel`), both branches (unpacked B, and packed p8 B,
// `b_packed`, :68-98), at large M. posit_gemm.cu keeps M up to the threshold.
//
// Bound on the H100: operations. At M = 4,096 a p8 weight byte meets 4,096
// rows, 8,192 flops, some 28x the ~295 flops a byte where the bf16 tensor
// cores, not the bytes, become the limit; f32 compute is bound by the f32
// FMA pipe (67e12 flop/s) further still.
//
// * `large_wgmma_kernel` (bf16 compute: B p8, packed p8, p16 or bf16; A
//   f32, bf16 or p8 -- kernels/posit_gemm/ops.py `uses_tensor_cores`).
//   It reads both operands as bf16, by TMA: an A that is not bf16 is
//   rounded (f32) or decoded (p8) first by `a_bf16_kernel`, and a posit B is
//   decoded once for the call by `b_bf16_kernel` into a (K, N) bf16 buffer
//   (p8 and packed p8 through a 256-entry table, p16 decoded exactly and
//   rounded once to bf16, as the reference does), one pass over each. A
//   128 x 256 output tile a block, three warpgroups: one produces, two
//   consume. Each of the 4 ring slots holds a 64-deep k stage of A (128 x
//   64, K-major) and of B (64 x 256, MN-major in 64-column boxes; wgmma
//   reads it transposed), both written by the TMA with the 128-byte swizzle
//   and counted on the slot's mbarrier. The two consumer warpgroups own 64
//   rows each and run `wgmma.mma_async m64n256k16` from the slot (f32
//   accumulators in registers, 128 a thread; `setmaxnreg` moves registers
//   from the producer to them), one stage's MMAs in flight while the next
//   stage's are issued, and release a slot through a second mbarrier. The
//   epilogue stages the tile through shared memory and runs `gemm::emit` on
//   4 columns a thread (one vector store of f32 out).
//   Earlier shapes of it, with A loaded by the consumers into registers one
//   stage ahead, or B's codes decoded in every row tile by the producer
//   warpgroup, left the tensor cores idle most of the time: loads in flight
//   and the shared-memory decode, not the MMAs, set the pace.
// * `large_fma_kernel` (f32 compute, and every pair the tensor cores do not
//   take). A 128 x 128 tile, 256 threads, 8 x 8 results a thread (two 4 x 4
//   sub-blocks 64 apart, so each k reads two float4 of A and two of B:
//   four conflict-free shared loads for 64 FMAs), k-major stages of 8, double
//   buffered: a stage's global loads (through `posit_gemm`'s decode, and the
//   rounding to the compute dtype, on the way to shared memory) are issued
//   before the previous stage's FMAs and stored after them, one barrier a
//   stage. Each output is one `fmaf` a product in k order (a packed row: its
//   low code, then its high one), as `gemm_kernel` sums it, so with one K
//   split the two tiles give the same bits.
//
// K splits (blockIdx.z) below a wave of tiles: f32 partials summed in split
// order by `gemm::splitk_epilogue_kernel`; no atomics, so two calls give the
// same bits. The launcher refuses what its copies cannot take: N must be a
// multiple of 16 (16-byte pieces of a B row of p8 codes), K of 8 (A's bf16
// rows 16-byte aligned for the TMA, and a packed B's high slice of A at
// column K / 2 aligned for the FMA tile's vector loads), A and B 16-byte
// aligned (ops.py `large_shape_ok` sends such shapes to the 64-row tiles).
#include <cuda.h>
#include <cudaTypedefs.h>

#include "posit_gemm.cuh"

namespace {

using gemm::GemmArgs;
using gemm::emit;
using gemm::kP8x2;
using gemm::to_compute;
using posit::kBF16;
using posit::kF32;
using posit::kP16;
using posit::kP16TabBytes;
using posit::kP8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four results of row m, columns n..n+3 (n a multiple of 4, N of 16, so all
// four are inside the matrix or none): one vector store of f32 out, else
// each through the epilogue; a K split's parts to its partial buffer.
__device__ __forceinline__ void emit4(const GemmArgs& g, int m, int n, float4 y) {
  if (m >= g.M || n >= g.N) return;
  const long long idx = static_cast<long long>(m) * g.N + n;
  if (g.splits > 1) {
    *reinterpret_cast<float4*>(g.partial + blockIdx.z * (static_cast<long long>(g.M) * g.N) +
                               idx) = y;
    return;
  }
  float v[4] = {y.x, y.y, y.z, y.w};
  if (g.out_kind != kF32) {
#pragma unroll
    for (int j = 0; j < 4; ++j) emit(g, idx + j, n + j, v[j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (g.bias != nullptr) v[j] += g.bias[n + j];
    v[j] = posit::activate(v[j], g.act);
    if (g.residual != nullptr) v[j] += g.residual[idx + j];
  }
  *reinterpret_cast<float4*>(static_cast<float*>(g.out) + idx) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// ================================ f32 FMA ================================
constexpr int kFmaThreads = 256;
constexpr int kFmaTile = 128;          // rows and columns of an output tile
constexpr int kFmaBK = 8;              // k rows of a stage
constexpr int kFmaAS = kFmaTile + 4;   // floats a k row of A's stage: stores hit 32 banks

template <int KA, int KB>
struct FmaLayout {
  static constexpr int NL = KB == kP8x2 ? 2 : 1;   // lanes of a B word
  static constexpr int A_FLOATS = NL * kFmaBK * kFmaAS;
  static constexpr int B_FLOATS = NL * kFmaBK * kFmaTile;
  static constexpr int BUF = (A_FLOATS + B_FLOATS) * 4;   // bytes of one stage
  static constexpr int TAB_B = KB == kP16 ? kP16TabBytes : (KB == kP8 || KB == kP8x2 ? 1024 : 0);
  static constexpr int TAB_A = KA == kP8 ? 1024 : 0;
  static constexpr int SMEM = 2 * BUF + TAB_B + TAB_A;
};

// Four consecutive elements of a row (uint16 words for a packed B), raw, or
// zeros where `ok` is false.
template <int KIND>
__device__ __forceinline__ uint4 load4(const void* p, long long i, bool ok) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return r;
  if constexpr (KIND == kF32) {
    r = *reinterpret_cast<const uint4*>(static_cast<const float*>(p) + i);
  } else if constexpr (KIND == kP8) {
    r.x = *reinterpret_cast<const uint32_t*>(static_cast<const uint8_t*>(p) + i);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const uint16_t*>(p) + i);
    r.x = v.x;
    r.y = v.y;
  }
  return r;
}

// Lane l (a packed word's low codes, l = 0, or high codes) of four raw
// elements as float32, exactly. p16 B decodes through the class table, p16
// A through the bit pipeline.
template <int KIND, bool IS_B>
__device__ __forceinline__ void vals4(const uint4& r, int l, int es, const float* tab8,
                                      const uint8_t* tab16, uint32_t lane4, float (&v)[4]) {
  if constexpr (KIND == kF32) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  } else if constexpr (KIND == kBF16) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xFFFF0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xFFFF0000u);
  } else if constexpr (KIND == kP8) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = tab8[(r.x >> (8 * j)) & 255u];
  } else if constexpr (KIND == kP8x2) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = tab8[((j < 2 ? r.x : r.y) >> (16 * (j & 1) + 8 * l)) & 255u];
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t c = ((j < 2 ? r.x : r.y) >> (16 * (j & 1))) & 0xFFFFu;
      if constexpr (IS_B) v[j] = posit::p16_f32(static_cast<int16_t>(c), tab16, lane4);
      else v[j] = posit::decode(c, 16, es);
    }
  }
}

// emit4 at one call site for the FMA tile's 16 groups of four.
__device__ __noinline__ void fma_store4(const GemmArgs& g, int m, int n, float4 y) {
  emit4(g, m, n, y);
}

template <int KA, int KB>
__global__ void __launch_bounds__(kFmaThreads, 2) large_fma_kernel(GemmArgs g) {
  using L = FmaLayout<KA, KB>;
  constexpr int NL = L::NL;
  extern __shared__ __align__(16) uint8_t fma_smem[];
  float* ring = reinterpret_cast<float*>(fma_smem);
  uint8_t* tab_b = fma_smem + 2 * L::BUF;
  float* tab_a = reinterpret_cast<float*>(tab_b + L::TAB_B);
  const int tid = threadIdx.x;
  const uint32_t lane4 = (tid & 31) << 2;
  if constexpr (KB == kP8 || KB == kP8x2)
    posit::fill_p8_table(reinterpret_cast<float*>(tab_b), g.es_b, tid, kFmaThreads);
  if constexpr (KB == kP16) posit::fill_p16_table(tab_b, g.es_b, tid, kFmaThreads);
  if constexpr (KA == kP8) posit::fill_p8_table(tab_a, g.es_a, tid, kFmaThreads);

  const int m0 = blockIdx.x * kFmaTile, n0 = blockIdx.y * kFmaTile;
  const int k_begin = blockIdx.z * g.k_per_split;
  const int k_end = min(g.kb, k_begin + g.k_per_split);
  // a thread stages A's row ar, k ak..ak+3 (each lane), and B's k row br,
  // columns bc..bc+3; K, Kh and N are multiples of 4, so a group of four is
  // inside or outside the matrix as a whole (a packed B's high slice,
  // columns Kh.., is as wide as its low one: K = 2 * Kh)
  const int ar = tid >> 1, ak = (tid & 1) * 4, br = tid >> 5, bc = (tid & 31) * 4;
  const bool a_in = m0 + ar < g.M, b_in = n0 + bc < g.N;
  const long long a_off = static_cast<long long>(m0 + ar) * g.K + ak;
  uint4 ra[NL], rb;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int l = 0; l < NL; ++l)
      ra[l] = load4<KA>(g.a, a_off + l * g.kb + k0, a_in && k0 + ak < k_end);
    rb = load4<KB>(g.b, static_cast<long long>(k0 + br) * g.N + n0 + bc,
                   b_in && k0 + br < k_end);
  };
  auto stash = [&](float* buf) {
    float* As = buf;
    float* Bs = buf + L::A_FLOATS;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      float v[4];
      vals4<KA, false>(ra[l], 0, g.es_a, tab_a, nullptr, 0u, v);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        As[(l * kFmaBK + ak + i) * kFmaAS + ar] = to_compute(v[i], g.bf16_compute);
      float w[4];
      vals4<KB, true>(rb, l, g.es_b, reinterpret_cast<const float*>(tab_b), tab_b, lane4, w);
      *reinterpret_cast<float4*>(Bs + (l * kFmaBK + br) * kFmaTile + bc) =
          make_float4(to_compute(w[0], g.bf16_compute), to_compute(w[1], g.bf16_compute),
                      to_compute(w[2], g.bf16_compute), to_compute(w[3], g.bf16_compute));
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int tx = tid & 15, ty = tid >> 4;
  __syncthreads();  // the tables
  if (k_begin < k_end) {
    fetch(k_begin);
    stash(ring);
  }
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kFmaBK) {
    const bool more = k0 + kFmaBK < k_end;
    if (more) fetch(k0 + kFmaBK);  // in flight during this stage's FMAs
    const float* As = ring + buf * (L::BUF / 4);
    const float* Bs = As + L::A_FLOATS;
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const float* ap = As + (l * kFmaBK + kk) * kFmaAS + ty * 4;
        const float* bp = Bs + (l * kFmaBK + kk) * kFmaTile + tx * 4;
        const float4 a0 = *reinterpret_cast<const float4*>(ap);
        const float4 a1 = *reinterpret_cast<const float4*>(ap + 64);
        const float4 b0 = *reinterpret_cast<const float4*>(bp);
        const float4 b1 = *reinterpret_cast<const float4*>(bp + 64);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (more) stash(ring + (buf ^ 1) * (L::BUF / 4));
    __syncthreads();  // the next stage landed; this one is consumed
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      fma_store4(g, m, n0 + h * 64 + tx * 4,
                 make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                             acc[i][4 * h + 3]));
  }
}

template <int KA, int KB>
cudaError_t launch_fma(const GemmArgs& g, cudaStream_t s) {
  using L = FmaLayout<KA, KB>;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        large_fma_kernel<KA, KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    smem_set[dev] = true;
  }
  const dim3 grid((g.M + kFmaTile - 1) / kFmaTile, (g.N + kFmaTile - 1) / kFmaTile, g.splits);
  large_fma_kernel<KA, KB><<<grid, kFmaThreads, L::SMEM, s>>>(g);
  return cudaGetLastError();
}

// ============================ bf16 wgmma ============================
constexpr int kWgThreads = 384;   // warpgroup 0 produces, 1 and 2 consume
constexpr int kWgProducers = 128;
constexpr int kWgBM = 128;        // rows of a tile, 64 a consumer warpgroup
constexpr int kWgBN = 256;        // columns of a tile: one m64n256k16 a k16
constexpr int kWgBK = 64;         // k of a stage: one 128-byte swizzle row a row or column
constexpr int kWgBTile = kWgBN * kWgBK * 2;   // a stage's bf16 B tile
constexpr int kWgATile = kWgBM * kWgBK * 2;   // a stage's bf16 A tile
constexpr int kWgSlot = kWgBTile + kWgATile;  // a ring slot: B, then A
constexpr int kWgEpiStride = kWgBN + 8;       // floats a row of the epilogue's tile
constexpr int kWgStages = 4;                  // ring slots
constexpr int kWgRing = kWgStages * kWgSlot;
constexpr int kWgEpi = kWgBM * kWgEpiStride * 4;   // the epilogue's tile, over the ring
constexpr int kWgBody = kWgRing > kWgEpi ? kWgRing : kWgEpi;
constexpr int kWgSmem = 1024 + kWgBody + 2 * kWgStages * 8;   // 1024: alignment slack
static_assert(kWgSmem <= 232448, "the ring must fit shared memory");
// registers a thread after setmaxnreg: 128 * 72 + 256 * 216 = 64,512, what the
// block holds at launch (384 x 168: ptxas compiles the whole kernel within
// that, and the m64n256 accumulators need 154); the consumers' raise waits
// for the producer's release, so the two must balance
constexpr int kWgProducerRegs = 72, kWgConsumerRegs = 216;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The TMA copy of a box of `map` at (inner x, outer y) into `dst` with the
// map's 128-byte swizzle (zeros outside the matrix), its bytes counted on
// `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Shared-memory descriptor of a K-major bf16 tile with the 128-byte swizzle
// (A's, as the TMA writes it): rows of 128 bytes (64 k), 8-row groups 1024
// bytes apart; the tile starts 1024-aligned. Adding 2 moves it 16 k (32
// bytes) along the row.
__device__ __forceinline__ uint64_t k_desc(const uint8_t* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Shared-memory descriptor of an MN-major bf16 tile with the 128-byte
// swizzle, as the TMA writes B's boxes: 64 columns (128 bytes) a k row, 8-k
// groups 1024 bytes apart (SBO), 64-column boxes 8 KB apart (LBO).
__device__ __forceinline__ uint64_t mn_desc(const uint8_t* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFu) >> 4) | (512ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 256, f32) += a (64 x 16 bf16) @ b (16 x 256 bf16), both from
// shared memory, A K-major, B MN-major; asynchronous until wgmma.wait_group.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "

      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// A as bf16, one thread 8 elements (M * K a multiple of 8): f32 rounded to
// nearest even, p8 decoded (exact in bf16). The wgmma kernel's TMA reads it.
template <int KA>
__global__ void __launch_bounds__(256) a_bf16_kernel(const void* a, __nv_bfloat16* out,
                                                     long long n, int es) {
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 8;
  if (i >= n) return;
  float v[8];
  if constexpr (KA == kF32) {
    const float4 x = *reinterpret_cast<const float4*>(static_cast<const float*>(a) + i);
    const float4 y = *reinterpret_cast<const float4*>(static_cast<const float*>(a) + i + 4);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
    const uint2 c = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(a) + i);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = posit::decode(((j < 4 ? c.x : c.y) >> (8 * (j & 3))) & 255u, 8, es);
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(out + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

// B as bf16 (K, N), one thread 8 columns of a row (N a multiple of 16): p8
// through a 256-entry table, a packed B's row k from packed row k's low
// codes (k < Kh) or row k - Kh's high codes, p16 decoded exactly and rounded
// once to bf16, as the reference rounds the decoded weight.
template <int KB>
__global__ void __launch_bounds__(256) b_bf16_kernel(const void* b, __nv_bfloat16* out, int K,
                                                     int N, int kb, int es) {
  __shared__ uint16_t tab[256];
  if constexpr (KB == kP8 || KB == kP8x2)
    tab[threadIdx.x] = __bfloat16_as_ushort(
        __float2bfloat16_rn(posit::decode(threadIdx.x, 8, es)));
  __syncthreads();
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 8;
  if (i >= static_cast<long long>(K) * N) return;
  const int k = static_cast<int>(i / N), n = static_cast<int>(i % N);
  uint16_t v[8];
  if constexpr (KB == kP8) {
    const uint2 c = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(b) + i);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = tab[((j < 4 ? c.x : c.y) >> (8 * (j & 3))) & 255u];
  } else {
    const int row = KB == kP8x2 && k >= kb ? k - kb : k;
    const uint4 c = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(b) +
                                                    static_cast<long long>(row) * N + n);
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t h = (w[j >> 1] >> (16 * (j & 1))) & 0xFFFFu;
      if constexpr (KB == kP8x2) v[j] = tab[(h >> (k >= kb ? 8 : 0)) & 255u];
      else v[j] = __bfloat16_as_ushort(__float2bfloat16_rn(posit::decode(h, 16, es)));
    }
  }
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) o[j] = v[2 * j] | (static_cast<uint32_t>(v[2 * j + 1]) << 16);
  *reinterpret_cast<uint4*>(out + i) = make_uint4(o[0], o[1], o[2], o[3]);
}

__global__ void __launch_bounds__(kWgThreads, 1)
large_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, GemmArgs g) {
  extern __shared__ uint8_t wg_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: the ring starts aligned
  uint8_t* smem = wg_smem + ((1024u - (smem_u32(wg_smem) & 1023u)) & 1023u);
  uint8_t* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgBody);
  uint64_t* empty = full + kWgStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(full + s, 1);    // the producer's arrive, with the TMA's bytes
      mbar_init(empty + s, 8);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int m0 = blockIdx.x * kWgBM, n0 = blockIdx.y * kWgBN;
  const int units = (g.kb + kWgBK - 1) / kWgBK;   // 64-row blocks of B
  const int u0 = blockIdx.z * g.k_per_split;      // this split's blocks
  const int u1 = min(units, u0 + g.k_per_split);
  const int steps = u1 - u0;                      // ring slots it fills

  if (tid < kWgProducers) {
    // ---- producer warpgroup: one thread puts A's tile and B's four
    // 64-column boxes (MN-major, 128-byte swizzle) into each slot ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgProducerRegs));
    if (tid == 0) {
      for (int j = 0; j < steps; ++j) {
        const int slot = j % kWgStages, k0 = (u0 + j) * kWgBK;
        mbar_wait(empty + slot, ((j / kWgStages) & 1) ^ 1);   // a fresh slot passes at once
        uint8_t* t = ring + slot * kWgSlot;
        mbar_arrive_expect_tx(full + slot, kWgATile + kWgBTile);
        tma_load(&map_a, t + kWgBTile, full + slot, k0, m0);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          tma_load(&map_b, t + q * (kWgBTile / 4), full + slot, n0 + 64 * q, k0);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));
  const int ct = tid - kWgProducers, wg = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  float acc[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) acc[j] = 0.0f;
  // each stage's MMAs stay in flight while the next stage's are issued; a
  // stage's slot goes back to the producer once its MMAs are done
  for (int i = 0; i < steps; ++i) {
    const int slot = i % kWgStages;
    mbar_wait(full + slot, (i / kWgStages) & 1);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint8_t* t = ring + slot * kWgSlot;
    const uint64_t da = k_desc(t + kWgBTile + wg * (kWgATile / 2));
    // MN-major B: 64-column boxes 8 KB apart, 8-row k groups 1 KB apart; a
    // k16 step is two groups
    const uint64_t db = mn_desc(t);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_256(acc, da + 2 * kk, db + 128 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    __syncwarp();
    if (i > 0 && lane == 0) mbar_arrive(empty + (i - 1) % kWgStages);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 128; ++j) asm volatile("" : "+f"(acc[j])::"memory");

  // ---- epilogue: the tile through shared memory, then 4 columns a thread ----
  asm volatile("bar.sync 1, 256;\n" ::: "memory");   // both warpgroups are done with the ring
  float* epi = reinterpret_cast<float*>(smem);
  const int lr = wg * 64 + warp * 16 + (lane >> 2), kq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    *reinterpret_cast<float2*>(epi + lr * kWgEpiStride + 8 * j + kq) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(epi + (lr + 8) * kWgEpiStride + 8 * j + kq) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll 1
  for (int e = ct * 4; e < kWgBM * kWgBN; e += 256 * 4) {
    const int r = e / kWgBN, c = e % kWgBN;
    emit4(g, m0 + r, n0 + c, *reinterpret_cast<const float4*>(epi + r * kWgEpiStride + c));
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (no
// link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 2-d bf16 tensor map: `inner` x `outer` elements, rows `inner` apart,
// boxes of 64 inner x `box_outer`, 128-byte swizzle, zeros outside.
bool bf16_map(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)}, elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch_wgmma(const GemmArgs& g, const __nv_bfloat16* a16, cudaStream_t s) {
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        large_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (e != cudaSuccess) return e;
    smem_set[dev] = true;
  }
  // A (M, K) bf16: boxes of 64 k x 128 rows; B (K, N) bf16: boxes of 64
  // columns x 64 k rows
  CUtensorMap map_a, map_b;
  if (!bf16_map(&map_a, a16, g.K, g.M, kWgBM) || !bf16_map(&map_b, g.b, g.N, g.K, kWgBK))
    return cudaErrorInvalidValue;
  const dim3 grid((g.M + kWgBM - 1) / kWgBM, (g.N + kWgBN - 1) / kWgBN, g.splits);
  large_wgmma_kernel<<<grid, kWgThreads, kWgSmem, s>>>(map_a, map_b, g);
  return cudaGetLastError();
}

template <int KA>
cudaError_t launch_fma_b(const GemmArgs& g, int b_kind, cudaStream_t s) {
  switch (b_kind) {
    case kF32: return launch_fma<KA, kF32>(g, s);
    case kBF16: return launch_fma<KA, kBF16>(g, s);
    case kP8: return launch_fma<KA, kP8>(g, s);
    case kP16: return launch_fma<KA, kP16>(g, s);
    default: return launch_fma<KA, kP8x2>(g, s);
  }
}

}  // namespace

extern "C" {

// The large-M route (kernels/posit_gemm/ops.py `gemm_route` picks it and
// mirrors the checks below). b_kind: posit::Kind, or 4 for packed p8 B of
// K / 2 rows. Tensor cores (bf16 compute, B p8/packed/p16/bf16, A
// f32/bf16/p8): the kernel reads A and B as bf16; an A that is not bf16 is
// first rounded (f32) or decoded (p8) into `a_bf16`, (M, K) bf16, and a
// posit B decoded into `b_bf16`, (K, N) bf16; k_per_split counts 64-row
// blocks of the K rows of that bf16 B. The f32-FMA tile: k_per_split counts
// rows of B (a packed B's K / 2), a multiple of 8. With splits > 1,
// `partial` holds (splits, M, N) f32 and the split-K epilogue kernel sums it.
int posit_gemm_large_launch(const void* a, const void* b, void* out, const float* bias,
                            const float* residual, float* partial, void* a_bf16, void* b_bf16,
                            int M, int N, int K, int a_kind, int b_kind, int out_kind, int es_a,
                            int es_b, int es_out, int act, int bf16_compute, int splits,
                            int k_per_split, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int kb = b_kind == kP8x2 ? (K + 1) / 2 : K;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const bool shape_ok = K > 0 && N % 16 == 0 && K % 8 == 0 && aligned(a) && aligned(b);
  if (!shape_ok || a_kind < kF32 || a_kind > kP16 || b_kind < kF32 || b_kind > kP8x2 ||
      out_kind < kF32 || out_kind > kP16 || act < posit::kActNone || act > posit::kActRelu ||
      splits < 1 || k_per_split < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tc = bf16_compute &&
                  (b_kind == kP8 || b_kind == kBF16 || b_kind == kP8x2 || b_kind == kP16) &&
                  (a_kind == kF32 || a_kind == kBF16 || a_kind == kP8);
  if (tc && ((a_kind != kBF16 && (a_bf16 == nullptr || !aligned(a_bf16))) ||
             (b_kind != kBF16 && (b_bf16 == nullptr || !aligned(b_bf16)))))
    return static_cast<int>(cudaErrorInvalidValue);
  // every split non-empty, all of B's rows covered
  const int span = tc ? (K + kWgBK - 1) / kWgBK : kb;
  if (static_cast<long long>(splits) * k_per_split < span ||
      static_cast<long long>(splits - 1) * k_per_split >= span ||
      (!tc && k_per_split % kFmaBK != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto clamp_es = [](int es) { return es < 0 ? 0 : (es > 3 ? 3 : es); };
  GemmArgs g{a,        b,   out, bias,           residual,       partial,        nullptr,
             M,        N,   K,   kb,             clamp_es(es_a), clamp_es(es_b), clamp_es(es_out),
             out_kind, act, bf16_compute, splits, k_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tc) {
    // A and B as bf16 for the TMA: as they are, or rounded / decoded first
    const __nv_bfloat16* a16 = static_cast<const __nv_bfloat16*>(a);
    if (a_kind != kBF16) {
      const long long n = static_cast<long long>(M) * K;
      const unsigned blocks = static_cast<unsigned>((n / 8 + 255) / 256);
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a_bf16);
      if (a_kind == kF32) a_bf16_kernel<kF32><<<blocks, 256, 0, s>>>(a, dst, n, g.es_a);
      else a_bf16_kernel<kP8><<<blocks, 256, 0, s>>>(a, dst, n, g.es_a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      a16 = dst;
    }
    if (b_kind != kBF16) {
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(b_bf16);
      const unsigned blocks =
          static_cast<unsigned>((static_cast<long long>(K) * N / 8 + 255) / 256);
      switch (b_kind) {
        case kP8: b_bf16_kernel<kP8><<<blocks, 256, 0, s>>>(b, dst, K, N, kb, g.es_b); break;
        case kP8x2: b_bf16_kernel<kP8x2><<<blocks, 256, 0, s>>>(b, dst, K, N, kb, g.es_b); break;
        default: b_bf16_kernel<kP16><<<blocks, 256, 0, s>>>(b, dst, K, N, kb, g.es_b);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      g.b = dst;
      g.kb = K;
    }
    err = launch_wgmma(g, a16, s);
  } else {
    switch (a_kind) {
      case kF32: err = launch_fma_b<kF32>(g, b_kind, s); break;
      case kBF16: err = launch_fma_b<kBF16>(g, b_kind, s); break;
      case kP8: err = launch_fma_b<kP8>(g, b_kind, s); break;
      default: err = launch_fma_b<kP16>(g, b_kind, s);
    }
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(gemm::launch_splitk_epilogue(g, s));
}

}  // extern "C"
