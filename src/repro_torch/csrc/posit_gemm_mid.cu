// Mid-M tiles of the fused posit GEMM: O = encode(act(decode(A) @ decode(B)
// + bias) + residual) for 9 to 64 rows under bf16 compute: decode steps of
// more than 8 slots (the paged engine's 16) and 64-token prefills.
//
// Replaces: src/repro/kernels/posit_gemm/posit_gemm.py, `posit_gemm` (Pallas
// body `_gemm_kernel`), both branches (unpacked B, and packed p8 B,
// `b_packed`, :68-98), at 9..64 rows on the tensor-core pairs
// (kernels/posit_gemm/ops.py `uses_tensor_cores`: B p8, packed p8, p16 or
// bf16; A f32, bf16 or p8). posit_gemm.cu keeps M <= 8, the shapes this
// kernel refuses (N not a multiple of 16, B or A not 16-byte aligned) and
// the f32-compute pairs; posit_gemm_large.cu takes M > 64.
//
// Bound on the H100: device-memory bytes. At M = 16 a weight byte does 32
// flops, at M = 64 128, both below the ~295 flops a byte where the bf16
// tensor cores become the limit. The work beside the bytes is the decode:
// every weight code goes through a table once, whatever M is.
//
// Design (operands swapped, as in posit_gemm.cu's tensor-core tiles): the
// weights are the A operand of `wgmma.mma_async m64nNk16`, 64 weight columns
// x 16 k, from registers; the activations are its B operand, N = 16, 32 or
// 64 rows (M rounded up), K-major bf16 in shared memory. A register A
// fragment of a warp is an `mma.sync` m16k16 fragment, so the decode of
// posit_gemm.cu carries over: the replicated p8 table, the p16 class table,
// the packed word's `__byte_perm` split. Each weight code is decoded once,
// whatever M is.
//   - `mid_a16_kernel` rounds (f32) or decodes (p8) A to bf16 once a call
//     into an (M, width) buffer, zero past K (a packed B's two A slices at
//     columns 0 and Kh64 = Kh rounded up to 64), so every 64-wide k step of
//     it is one TMA box. The GEMM is launched programmatically dependent on
//     it: its blocks start while the pass runs, fill their tables and put the
//     first stages' weight copies in flight (the weights depend on no kernel
//     before), and wait (griddepcontrol.wait) before the first copy of A.
//   - A block is one SM: a producer warpgroup, whose first thread keeps TMA
//     copies of raw B codes (64 rows x 128 columns a stage: 8 KB of p8, 16
//     KB of 2-byte codes, 128-byte boxes with the 128-byte swizzle) and of
//     the stage's bf16 activation slice (NR rows x 64 k) in flight in an
//     mbarrier ring of as many stages as shared memory holds (up to 12), and
//     two consumer warpgroups. Both take all 128 columns of the tile;
//     warpgroup c takes the 16-deep chunks 2c and 2c+1 of each stage, and at
//     the end of a tile the two swap halves of their accumulators through
//     shared memory and add them (a + b: the same bits in either order).
//     The k split keeps the tile narrow, so a 5120-column weight has 40
//     tiles: each is split between few blocks (~3 at q/o) and a block's
//     part, which the tile's last block reads back, is 128 x NR f32 (32 KB
//     at NR = 64). Those read-backs end every call, and at NR = 64 they
//     weigh on it.
//   - A lane reads 4 columns of 4 k rows (2t, 2t+1, 2t+8, 2t+9) of a chunk:
//     one 4-byte (p8) or 8-byte load a row; under the swizzle the lanes of a
//     load phase hit distinct banks. Its two fragments (columns 0-1 and 2-3)
//     feed two wgmma a chunk (four for a packed B: the low codes against A's
//     first slice, the high against its second). The p8 table sits in
//     static shared memory, so a lookup is a shift, an and-or and the load.
//     Chunk 1's decode runs while chunk 0's wgmma do: the fragments are
//     double-buffered by chunk and `wgmma.wait_group 1` follows each commit;
//     a stage's slot goes back to the producer once the next stage's first
//     chunk has waited. No instruction between a wgmma's fence and its
//     commit defines one of its operands and no branch of the kernel's own
//     sits between a wgmma and its wait (the ring's waits and arrives are
//     single asm blocks, p16's rare-row lookup a predicated load, the first
//     products of a part overwrite through scale-d): ptxas serializes every
//     wgmma of the kernel otherwise.
//   - Accumulators: NR a thread (f32, two m64nNR tiles). Registers go by
//     warpgroups, so the producer is a whole warpgroup that `setmaxnreg`
//     cuts to 40 registers a thread, raising the consumers' to 232: at the
//     launch's 168, NR = 64 spilled.
//   - Stream-K: a persistent grid (ops.py `mid_plan`) walks the (tile, k
//     step) items in equal contiguous shares; a split tile's parts go to
//     f32 partials and the last part to finish (a per-stream zeroed counter
//     a tile) sums them in block order, as posit_gemm.cu's tiles do. The
//     plan depends on N, K and the B kind only, so a row's sums run in the
//     same order for every M in 9..64; N (the instruction's width) follows
//     M, and each output element is the same k16 products summed in the
//     same order whatever N is (chip_smoke.py `check_gemm_batch_invariance`
//     holds rows 0-8 of M = 9, 16, 32 and 64 calls bit for bit).
//   - The epilogue (bias, activation, residual, posit encode or float
//     store) runs from registers: a thread holds 2 consecutive columns of
//     each of its rows.
// What sets the pace in practice is the decode: one shared-memory table load
// a code; the copies alone, without decode or wgmma, stream close to the
// card's memory rate.
// The launcher refuses N not a multiple of 16 (the 16-byte row stride of a
// p8 tensor map) and B not 16-byte aligned (ops.py `mid_shape_ok`); the
// TMA fills rows past K and columns past N with zeros.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "posit_gemm.cuh"

namespace {

using gemm::GemmArgs;
using gemm::emit;
using gemm::kP8x2;
using posit::kBF16;
using posit::kF32;
using posit::kP16;
using posit::kP16TabBytes;
using posit::kP8;

constexpr int kMidConsumers = 256;                // two warpgroups
constexpr int kMidThreads = kMidConsumers + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg: 128 * 40 + 256 * 232 = 64,512 of the
// SM's 65,536 (at launch 384 x 168; registers go by warpgroups, so a lone
// producer warp would cost as much as a warpgroup all the same). The
// consumers' raise waits for the producer's release: the two must balance.
constexpr int kMidProducerRegs = 40, kMidConsumerRegs = 232;
constexpr int kMidBN = 128;   // columns of a tile
constexpr int kMidBK = 64;    // B rows of a stage (packed rows if packed)
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared-memory layout of a block (bytes): the decode table (static), then,
// from a 1024-aligned base, the ring, the warpgroups' exchange area and the
// mbarriers. A stage holds B's tile (kMidBK rows x 128 columns in 128-byte
// boxes, box q at q * 8 KB) and NL activation slices (NR rows x 64 bf16,
// 128 bytes a row), each 1024-aligned for the swizzle. The exchange area
// holds one warpgroup's accumulators for the other (256 threads x NR / 2
// f32).
template <int KB, int NR>
struct MidLayout {
  static constexpr int EB = KB == kP8 ? 1 : 2;
  static constexpr int NL = KB == kP8x2 ? 2 : 1;
  static constexpr int BOX_COLS = 128 / EB;
  static constexpr int B_BOXES = kMidBN / BOX_COLS;
  static constexpr int B_TILE = kMidBK * kMidBN * EB;
  static constexpr int A_SLICE = NR * 128;
  static constexpr int STAGE = B_TILE + NL * A_SLICE;
  static constexpr int TAB = KB == kP8 || KB == kP8x2 ? 256 * 32 * 4
                             : (KB == kP16 ? (kP16TabBytes + 1023) / 1024 * 1024 : 0);
  static constexpr int XCH = kMidConsumers * NR / 2 * 4;
  static constexpr int FIXED = 1024 + XCH + 256;   // alignment slack, barriers
  static constexpr int FIT = (kSmemLimit - 128 - TAB - FIXED) / STAGE;
  static constexpr int STAGES = FIT > 12 ? 12 : FIT;
  static constexpr int SMEM = FIXED + STAGES * STAGE;   // dynamic; the table is static
  static_assert(STAGES >= 2 && TAB + 128 + SMEM <= kSmemLimit, "the ring must fit");
  static_assert(B_TILE % 1024 == 0 && A_SLICE % 1024 == 0, "1024-aligned boxes");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with the given parity, the loop inside one
// asm block (no branch of the kernel's own between a wgmma and its wait). A
// wait past 2e10 cycles (a fault in the ring's protocol) traps, so the
// launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "MID_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra MID_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.lt.u64 p, t1, 20000000000;\n"
      "@p bra MID_WAIT;\n"
      "trap;\n"
      "MID_DONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// An arrive on `bar` where `pred` is non-zero, predicated rather than
// branched.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, uint32_t pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(pred)
      : "memory");
}

// The TMA copy of a box of `map` at (inner x, outer y) into `dst`, zeros
// outside the matrix, its bytes counted on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar,
                                         int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory descriptor of a K-major bf16 tile with the 128-byte swizzle
// (an activation slice, as the TMA writes it): rows of 128 bytes (64 k),
// 8-row groups 1024 bytes apart; adding 2 moves it 16 k along the row.
__device__ __forceinline__ uint64_t k_desc(const uint8_t* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFu) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x NR, f32) = a (64 x 16 bf16, registers) @ b (16 x NR bf16, shared
// memory, K-major) + (scale_d ? d : 0); asynchronous until wgmma.wait_group.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                         uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                         uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma that own them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The bf16 bits (low half) of p8 code `byte` of word w, through the
// replicated table: entry (code, lane) at byte code * 128 + lane * 4.
__device__ __forceinline__ uint32_t lut8(uint32_t w, int byte, const uint8_t* tab,
                                         uint32_t lane4) {
  const int sh = 8 * byte - 7;   // code * 128 = the byte shifted to bit 7
  const uint32_t off = ((sh < 0 ? w << 7 : w >> sh) & 0x7F80u) | lane4;
  return *reinterpret_cast<const uint32_t*>(tab + off);
}

// A lane's two m16k16 fragments from four rows of p8 codes (k = 2t, 2t+1,
// 2t+8, 2t+9; 4 columns a row): fragment j's rows g and g+8 are the lane's
// columns 2j and 2j+1.
__device__ __forceinline__ void p8_frags(const uint32_t (&r)[4], const uint8_t* tab,
                                         uint32_t lane4, uint32_t (&f)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    f[j][0] = __byte_perm(lut8(r[0], 2 * j, tab, lane4), lut8(r[1], 2 * j, tab, lane4), 0x5410);
    f[j][1] = __byte_perm(lut8(r[0], 2 * j + 1, tab, lane4), lut8(r[1], 2 * j + 1, tab, lane4),
                          0x5410);
    f[j][2] = __byte_perm(lut8(r[2], 2 * j, tab, lane4), lut8(r[3], 2 * j, tab, lane4), 0x5410);
    f[j][3] = __byte_perm(lut8(r[2], 2 * j + 1, tab, lane4), lut8(r[3], 2 * j + 1, tab, lane4),
                          0x5410);
  }
}

// posit::p16_magnitude with the second level's load predicated instead of
// branched (a branch between a wgmma and its wait serializes them).
__device__ __forceinline__ uint32_t p16_mag(int s, const uint8_t* tab, uint32_t lane4) {
  const uint32_t a = static_cast<uint32_t>(abs(s));
  uint32_t t = *reinterpret_cast<const uint32_t*>(tab + ((a & 0xFF80u) | lane4));
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p ld.shared.u32 %0, [%2];\n}\n"
      : "+r"(t)
      : "r"(t & posit::kP16Rare), "r"(smem_u32(tab + posit::kP16L1) + (a & 0xFFu) * 4u));
  return (t & ~0x1Fu) + __funnelshift_l(0u, a, t);   // T + (a << sh)
}

// Two p16 codes (a word: low half, high half) as two bf16, RNE from the
// exact values (NaR: a NaN).
__device__ __forceinline__ uint32_t p16_bf16x2(uint32_t w, const uint8_t* tab, uint32_t lane4) {
  const int lo = static_cast<int16_t>(w & 0xFFFFu), hi = static_cast<int>(w) >> 16;
  const __nv_bfloat162 h = __floats2bfloat162_rn(__uint_as_float(p16_mag(lo, tab, lane4)),
                                                 __uint_as_float(p16_mag(hi, tab, lane4)));
  return *reinterpret_cast<const uint32_t*>(&h) ^ (w & 0x80008000u);
}

// The lane's fragments of 16-deep chunk kk of a stage's B tile `st`: o0 and
// o1 are the byte offsets of its rows 2t and 2t+1 in the tile (swizzle
// included); rows 2t+8 and 2t+9 sit 1024 bytes further, chunk kk 2048 x kk.
// A packed B gives the low codes' fragments in f[0], the high in f[1].
template <int KB>
__device__ __forceinline__ void mid_frags(const uint8_t* st, uint32_t o0, uint32_t o1, int kk,
                                          const uint8_t* tab, uint32_t lane4,
                                          uint32_t (&f)[KB == kP8x2 ? 2 : 1][2][4]) {
  const uint8_t* p = st + kk * 2048;
  if constexpr (KB == kP8) {
    const uint32_t r[4] = {*reinterpret_cast<const uint32_t*>(p + o0),
                           *reinterpret_cast<const uint32_t*>(p + o1),
                           *reinterpret_cast<const uint32_t*>(p + o0 + 1024),
                           *reinterpret_cast<const uint32_t*>(p + o1 + 1024)};
    p8_frags(r, tab, lane4, f[0]);
  } else {
    const uint2 r[4] = {*reinterpret_cast<const uint2*>(p + o0),
                        *reinterpret_cast<const uint2*>(p + o1),
                        *reinterpret_cast<const uint2*>(p + o0 + 1024),
                        *reinterpret_cast<const uint2*>(p + o1 + 1024)};
    if constexpr (KB == kP8x2) {
      // a word's low byte is row k's code, its high byte row k + Kh's
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        lo[q] = __byte_perm(r[q].x, r[q].y, 0x6420);
        hi[q] = __byte_perm(r[q].x, r[q].y, 0x7531);
      }
      p8_frags(lo, tab, lane4, f[0]);
      p8_frags(hi, tab, lane4, f[1]);
    } else {
      uint32_t w[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[q][0] = r[q].x;
        w[q][1] = r[q].y;
        if constexpr (KB == kP16) {
          w[q][0] = p16_bf16x2(w[q][0], tab, lane4);
          w[q][1] = p16_bf16x2(w[q][1], tab, lane4);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        f[0][j][0] = __byte_perm(w[0][j], w[1][j], 0x5410);
        f[0][j][1] = __byte_perm(w[0][j], w[1][j], 0x7632);
        f[0][j][2] = __byte_perm(w[2][j], w[3][j], 0x5410);
        f[0][j][3] = __byte_perm(w[2][j], w[3][j], 0x7632);
      }
    }
  }
}

// Two results of row m, columns n and n+1 (n even, N a multiple of 16, so
// both are inside the matrix or neither), f32 out: one vector store.
__device__ __forceinline__ void mid_store2(const GemmArgs& g, int m, int n, float y0, float y1) {
  if (m >= g.M || n >= g.N) return;
  const long long idx = static_cast<long long>(m) * g.N + n;
  float v[2] = {y0, y1};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (g.bias != nullptr) v[j] += g.bias[n + j];
    v[j] = posit::activate(v[j], g.act);
    if (g.residual != nullptr) v[j] += g.residual[idx + j];
  }
  *reinterpret_cast<float2*>(static_cast<float*>(g.out) + idx) = make_float2(v[0], v[1]);
}

// Block b's share of the (tile, k step) items: [total * b / grid, total * (b+1) / grid).
__device__ __forceinline__ int share_start(int total, int b, int grid) {
  return static_cast<int>(static_cast<long long>(total) * b / grid);
}

// The block whose share holds item x.
__device__ __forceinline__ int share_owner(int total, int x, int grid) {
  return static_cast<int>((static_cast<long long>(x + 1) * grid - 1) / total);
}

// A as bf16 (M, width), one thread 8 columns: column c < hi_at is A's column
// c (zero from `lo` on); column hi_at + c is A's column lo + c (zero from K
// on). Unpacked B: lo = K, hi_at = width; packed: lo = Kh, hi_at = Kh64.
// f32 rounded to nearest even, p8 decoded (exact in bf16).
template <int KA>
__global__ void __launch_bounds__(256) mid_a16_kernel(const void* a, __nv_bfloat16* out, int M,
                                                      int K, int lo, int hi_at, int width,
                                                      int es) {
  // the GEMM (launched programmatically dependent) may start now: it reads
  // this output only after its griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const long long i = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 8;
  if (i >= static_cast<long long>(M) * width) return;
  const int m = static_cast<int>(i / width), c0 = static_cast<int>(i % width);
  uint16_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j;
    const int src = c < hi_at ? (c < lo ? c : -1) : (lo + (c - hi_at) < K ? lo + (c - hi_at) : -1);
    float x = 0.0f;
    if (src >= 0) {
      const long long at = static_cast<long long>(m) * K + src;
      if constexpr (KA == kF32)
        x = static_cast<const float*>(a)[at];
      else if constexpr (KA == kBF16)
        x = __bfloat162float(static_cast<const __nv_bfloat16*>(a)[at]);
      else
        x = posit::decode(static_cast<const uint8_t*>(a)[at], 8, es);
    }
    v[j] = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = v[2 * j] | (static_cast<uint32_t>(v[2 * j + 1]) << 16);
  *reinterpret_cast<uint4*>(out + i) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int KB, int NR>
__global__ void __launch_bounds__(kMidThreads, 1)
mid_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, GemmArgs g, int a_hi) {
  using L = MidLayout<KB, NR>;
  constexpr int S = L::STAGES, NL = L::NL, NA = NR / 2;
  extern __shared__ uint8_t mid_smem[];
  __shared__ int s_last;
  // the decode table in static shared memory: its address is a constant,
  // so a lookup is one shift, one and-or and the load
  __shared__ __align__(128) uint8_t tab[L::TAB > 0 ? L::TAB : 16];
  // the 128-byte swizzle repeats every 1024 bytes: the boxes start aligned
  uint8_t* ring = mid_smem + ((1024u - (smem_u32(mid_smem) & 1023u)) & 1023u);
  float4* xch = reinterpret_cast<float4*>(ring + S * L::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::STAGE + L::XCH);
  uint64_t* empty = full + S;
  const int tid = threadIdx.x;

  if constexpr (KB == kP8 || KB == kP8x2) {
    // consumer thread c decodes code c and writes its 32 lane copies, 16
    // bytes at a time, rotated so a quarter warp's stores hit distinct banks
    if (tid < 256) {
      const uint32_t v = __bfloat16_as_ushort(
          __float2bfloat16_rn(posit::decode(static_cast<uint32_t>(tid), 8, g.es_b)));
      const uint4 v4 = make_uint4(v, v, v, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) reinterpret_cast<uint4*>(tab + tid * 128)[(q + tid) & 7] = v4;
    }
  }
  if constexpr (KB == kP16) posit::fill_p16_table(tab, g.es_b, tid, kMidThreads);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);    // the producer's arrive, with the TMA's bytes
      mbar_init(empty + s, 8);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int iters = max(1, (g.kb + kMidBK - 1) / kMidBK);  // K = 0: one zero step
  const int tiles = (g.N + kMidBN - 1) / kMidBN;
  const int total = tiles * iters;
  const int grid = gridDim.x;
  const int w0 = share_start(total, blockIdx.x, grid);
  const int w1 = share_start(total, blockIdx.x + 1, grid);

  if (tid >= kMidConsumers) {
    // ---- producer warpgroup: one thread fills the ring in the walk's order ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kMidProducerRegs));
    if (tid == kMidConsumers) {
      auto fill = [&](int j, int w, bool b_part, bool a_part) {
        const int slot = j % S, tile = w / iters, k0 = (w % iters) * kMidBK;
        uint8_t* st = ring + slot * L::STAGE;
        if (b_part) {
          mbar_wait(empty + slot, ((j / S) & 1) ^ 1);   // a fresh slot passes at once
          mbar_arrive_expect_tx(full + slot, L::STAGE);
#pragma unroll
          for (int q = 0; q < L::B_BOXES; ++q)
            tma_load(&map_b, st + q * 8192, full + slot, tile * kMidBN + q * L::BOX_COLS, k0);
        }
        if (a_part) {
#pragma unroll
          for (int l = 0; l < NL; ++l)
            tma_load(&map_a, st + L::B_TILE + l * L::A_SLICE, full + slot, l * a_hi + k0, 0);
        }
      };
      // the first stages' weights before the wait for A's rounding pass
      const int pre = min(S, w1 - w0);
      for (int j = 0; j < pre; ++j) fill(j, w0 + j, true, false);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int j = 0; j < pre; ++j) fill(j, w0 + j, false, true);
      for (int j = pre; w0 + j < w1; ++j) fill(j, w0 + j, true, true);
    }
    return;
  }

  // ---- consumer warpgroups: warpgroup c takes the 16-deep chunks 2c and
  // 2c+1 of every stage, all 128 columns ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kMidConsumerRegs));
  // the kernels before have finished (the epilogue reads their bias and
  // residual); the stages wait for A's copies anyway
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31, gq = lane >> 2,
            tq = lane & 3;
  const uint32_t lane4 = static_cast<uint32_t>(lane) * 4u;
  // the lane's 4 columns in the tile, and where its rows 2t and 2t+1 sit in a
  // stage's swizzled boxes (16-byte piece c of row r at piece c ^ (r & 7))
  const int col = warp * 32 + gq * 4;
  const int bx = col * L::EB;
  const uint32_t base = (bx >> 7) * 8192 + (bx & 15);
  const uint32_t piece = (bx & 127) >> 4;
  const uint32_t o0 = base + 2 * tq * 128 + ((piece ^ (2 * tq)) << 4);
  const uint32_t o1 = base + (2 * tq + 1) * 128 + ((piece ^ (2 * tq + 1)) << 4);
  constexpr int kPart = kMidConsumers * NA;   // floats of one block's part

  float acc[2][NA];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[jj][i] = 0.0f;
  // fragments of a chunk, two sets: chunk c's decode writes set c while the
  // other chunk's wgmma read the other set
  uint32_t frag[2][NL][2][4];
  int j = 0;   // stages consumed
  const int first_tile = w0 / iters;
  int tile = first_tile, step = w0 % iters;
  for (int w = w0; w < w1;) {
    // ---- the block's part of `tile`: steps step .. step + len - 1 ----
    const int len = min(iters - step, w1 - w);
    for (int i = 0; i < len; ++i, ++j) {
      const int slot = j % S;
      mbar_wait(full + slot, (j / S) & 1);
      const uint8_t* st = ring + slot * L::STAGE;
      const uint64_t da = k_desc(st + L::B_TILE) + 4 * wg;   // chunk 2 wg's first k
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        mid_frags<KB>(st, o0, o1, 2 * wg + c, tab, lane4, frag[c]);
        wgmma_fence();
#pragma unroll
        for (int l = 0; l < NL; ++l)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)   // the part's first products overwrite
            wgmma_rs(acc[jj], frag[c][l][jj], da + l * (L::A_SLICE >> 4) + 2 * c,
                     c == 0 && l == 0 ? static_cast<uint32_t>(i) : 1u);
        wgmma_commit();
        // the other chunk's wgmma are done: its fragments may be rewritten,
        // and at c = 0 the previous stage's slot goes back to the producer
        wgmma_wait<1>();
        if (c == 0)
          mbar_arrive_if(empty + (slot == 0 ? S - 1 : slot - 1), lane == 0 && j > 0);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) fence_acc(acc[jj]);
    // warpgroup c keeps accumulator set c (columns col + 2c, col + 2c + 1)
    // and adds the other warpgroup's: a + b, the same bits in either order
    float r[NA];
    asm volatile("bar.sync 1, %0;\n" ::"n"(kMidConsumers) : "memory");   // area free
    // (selects, not an index: the accumulators stay in registers)
#pragma unroll
    for (int q = 0; q < NA / 4; ++q) {
      const int k = 4 * q;
      xch[((wg ^ 1) * (NA / 4) + q) * 128 + wt] =
          wg ? make_float4(acc[0][k], acc[0][k + 1], acc[0][k + 2], acc[0][k + 3])
             : make_float4(acc[1][k], acc[1][k + 1], acc[1][k + 2], acc[1][k + 3]);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kMidConsumers) : "memory");
#pragma unroll
    for (int q = 0; q < NA / 4; ++q) {
      const int k = 4 * q;
      const float4 o = xch[(wg * (NA / 4) + q) * 128 + wt];
      r[k] = (wg ? acc[1][k] : acc[0][k]) + o.x;
      r[k + 1] = (wg ? acc[1][k + 1] : acc[0][k + 1]) + o.y;
      r[k + 2] = (wg ? acc[1][k + 2] : acc[0][k + 2]) + o.z;
      r[k + 3] = (wg ? acc[1][k + 3] : acc[0][k + 3]) + o.w;
    }
    const int cur_tile = tile;
    const bool whole = len == iters;
    w += len;
    step = 0;
    ++tile;

    if (!whole) {
      float4* part = reinterpret_cast<float4*>(
          g.partial +
          (static_cast<long long>(blockIdx.x) * 2 + (cur_tile == first_tile ? 0 : 1)) * kPart);
#pragma unroll
      for (int q = 0; q < NA / 4; ++q)
        part[q * kMidConsumers + tid] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                                                    r[4 * q + 3]);
      const int b_first = share_owner(total, cur_tile * iters, grid);
      const int b_last = share_owner(total, cur_tile * iters + iters - 1, grid);
      __threadfence();
      asm volatile("bar.sync 1, %0;\n" ::"n"(kMidConsumers) : "memory");
      if (tid == 0) s_last = atomicAdd(g.counters + cur_tile, 1) == b_last - b_first;
      asm volatile("bar.sync 1, %0;\n" ::"n"(kMidConsumers) : "memory");
      if (!s_last) continue;
      __threadfence();
      // the last part to finish sums all parts in block order: b_first's
      // sits in its second slot unless its share starts at this tile; every
      // later contributor's share starts inside the tile
      const int s_first = share_start(total, b_first, grid) == cur_tile * iters ? 0 : 1;
      // a thread sums its NA / 4 float4s QC at a time, loading them from PB
      // parts at once, so a round trip to L2 carries 16 loads
      constexpr int QC = NA / 4 < 8 ? NA / 4 : 8;
      constexpr int PB = 16 / QC;
      const float4* p0 = reinterpret_cast<const float4*>(
          g.partial + (static_cast<long long>(b_first) * 2 + s_first) * kPart);
      const float4* pb = reinterpret_cast<const float4*>(g.partial);
#pragma unroll
      for (int q0 = 0; q0 < NA / 4; q0 += QC) {
        float4 y[QC];
#pragma unroll
        for (int q = 0; q < QC; ++q) y[q] = __ldcg(p0 + (q0 + q) * kMidConsumers + tid);
        for (int b = b_first + 1; b <= b_last; b += PB) {
          float4 v[PB][QC];
#pragma unroll
          for (int u = 0; u < PB; ++u)
#pragma unroll
            for (int q = 0; q < QC; ++q)
              if (b + u <= b_last)
                v[u][q] = __ldcg(pb + static_cast<long long>(b + u) * 2 * (kPart / 4) +
                                 (q0 + q) * kMidConsumers + tid);
#pragma unroll
          for (int u = 0; u < PB; ++u)
#pragma unroll
            for (int q = 0; q < QC; ++q)
              if (b + u <= b_last) {
                y[q].x += v[u][q].x;
                y[q].y += v[u][q].y;
                y[q].z += v[u][q].z;
                y[q].w += v[u][q].w;
              }
        }
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          r[4 * (q0 + q)] = y[q].x;
          r[4 * (q0 + q) + 1] = y[q].y;
          r[4 * (q0 + q) + 2] = y[q].z;
          r[4 * (q0 + q) + 3] = y[q].w;
        }
      }
      if (tid == 0) g.counters[cur_tile] = 0;
    }
    // r[4i + e]: row 8i + 2t + (e & 1) of A, column col + 2 wg + (e >> 1)
    const int n = cur_tile * kMidBN + col + 2 * wg;
    if (g.out_kind == kF32) {
#pragma unroll
      for (int e = 0; e < NA / 2; ++e)
        mid_store2(g, 8 * (e >> 1) + 2 * tq + (e & 1), n, r[4 * (e >> 1) + (e & 1)],
                   r[4 * (e >> 1) + 2 + (e & 1)]);
    } else {
      // bf16 and posit out through the epilogue's encode at one site (a
      // copy the loop indexes, in local memory, keeps r in registers)
      float rl[NA];
#pragma unroll
      for (int k = 0; k < NA; ++k) rl[k] = r[k];
#pragma unroll 1
      for (int e = 0; e < NA; ++e) {
        const int m = 8 * (e >> 2) + 2 * tq + (e & 1), cn = n + ((e >> 1) & 1);
        if (m < g.M && cn < g.N) emit(g, static_cast<long long>(m) * g.N + cn, cn, rl[e]);
      }
    }
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

// A 2-d tensor map of `inner` x `outer` elements of `bytes` each, rows
// `inner` apart, boxes of (128 / bytes) inner x `box_outer`, 128-byte
// swizzle, zeros outside.
bool map_2d(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base, int inner,
            int outer, int box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / bytes),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KB, int NR>
cudaError_t launch_mid(const GemmArgs& g, const CUtensorMap& map_a, const CUtensorMap& map_b,
                       int a_hi, int grid, cudaStream_t s) {
  using L = MidLayout<KB, NR>;
  static bool smem_set[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        mid_gemm_kernel<KB, NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return e;
    smem_set[dev] = true;
  }
  // programmatically dependent on the rounding pass launched just before
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kMidThreads);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mid_gemm_kernel<KB, NR>, map_a, map_b, g, a_hi);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int KB>
cudaError_t launch_mid_rows(const GemmArgs& g, const CUtensorMap& map_a,
                            const CUtensorMap& map_b, int a_hi, int grid, cudaStream_t s) {
  if (g.M <= 16) return launch_mid<KB, 16>(g, map_a, map_b, a_hi, grid, s);
  if (g.M <= 32) return launch_mid<KB, 32>(g, map_a, map_b, a_hi, grid, s);
  return launch_mid<KB, 64>(g, map_a, map_b, a_hi, grid, s);
}

}  // namespace

extern "C" {

// The mid-M route (kernels/posit_gemm/ops.py `gemm_route` picks it and
// mirrors the checks below): 9 <= M <= 64, bf16 compute, b_kind p8 (2),
// packed p8 (4, ceil(K/2) rows), p16 (3) or bf16 (1), a_kind f32, bf16 or
// p8, N a multiple of 16, B 16-byte aligned. `a_bf16` is an (M, width) bf16
// buffer, width = K rounded up to 64 (packed: twice Kh rounded up to 64),
// that the launch fills first. grid: the persistent blocks of ops.py
// `mid_plan`, with `partial` (grid, 2, 256, NR / 2) f32 (NR = M rounded up
// to 16, 32 or 64) and `counters` (one zeroed int a 128-column tile) when
// grid > 1.
int posit_gemm_mid_launch(const void* a, const void* b, void* out, const float* bias,
                          const float* residual, float* partial, int* counters, void* a_bf16,
                          int M, int N, int K, int a_kind, int b_kind, int out_kind, int es_a,
                          int es_b, int es_out, int act, int grid, void* stream) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  const int kb = b_kind == kP8x2 ? (K + 1) / 2 : K;
  const int kb64 = (kb + kMidBK - 1) / kMidBK * kMidBK;
  const int width = b_kind == kP8x2 ? 2 * kb64 : kb64;
  const int tiles = (N + kMidBN - 1) / kMidBN;
  const long long items = static_cast<long long>(tiles) * (kb64 / kMidBK);
  if (M < 9 || M > 64 || N <= 0 || K <= 0 || N % 16 != 0 || !aligned(b) || a_bf16 == nullptr ||
      !aligned(a_bf16) || (a_kind != kF32 && a_kind != kBF16 && a_kind != kP8) ||
      (b_kind != kP8 && b_kind != kBF16 && b_kind != kP16 && b_kind != kP8x2) ||
      out_kind < kF32 || out_kind > kP16 || act < posit::kActNone || act > posit::kActRelu ||
      grid < 1 || grid > items || items >= (1LL << 30) ||
      (grid > 1 && (partial == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto clamp_es = [](int es) { return es < 0 ? 0 : (es > 3 ? 3 : es); };
  GemmArgs g{a,        b,   out, bias, residual,       partial,        counters,
             M,        N,   K,   kb,   clamp_es(es_a), clamp_es(es_b), clamp_es(es_out),
             out_kind, act, 1,   1,    0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* a16 = static_cast<__nv_bfloat16*>(a_bf16);
  const int lo = b_kind == kP8x2 ? kb : K, hi_at = b_kind == kP8x2 ? kb64 : width;
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(M) * width / 8 + 255) / 256);
  switch (a_kind) {
    case kF32:
      mid_a16_kernel<kF32><<<blocks, 256, 0, s>>>(a, a16, M, K, lo, hi_at, width, g.es_a);
      break;
    case kBF16:
      mid_a16_kernel<kBF16><<<blocks, 256, 0, s>>>(a, a16, M, K, lo, hi_at, width, g.es_a);
      break;
    default:
      mid_a16_kernel<kP8><<<blocks, 256, 0, s>>>(a, a16, M, K, lo, hi_at, width, g.es_a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nr = M <= 16 ? 16 : (M <= 32 ? 32 : 64);
  const int eb = b_kind == kP8 ? 1 : 2;
  CUtensorMap map_a, map_b;
  if (!map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a16, width, M, nr) ||
      !map_2d(&map_b, eb == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
              eb, b, N, kb, kMidBK))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (b_kind) {
    case kP8: err = launch_mid_rows<kP8>(g, map_a, map_b, kb64, grid, s); break;
    case kP8x2: err = launch_mid_rows<kP8x2>(g, map_a, map_b, kb64, grid, s); break;
    case kP16: err = launch_mid_rows<kP16>(g, map_a, map_b, kb64, grid, s); break;
    default: err = launch_mid_rows<kBF16>(g, map_a, map_b, kb64, grid, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
