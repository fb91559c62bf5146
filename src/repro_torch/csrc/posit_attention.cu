// Decode-step attention over a posit-coded KV cache (one query token per row),
// with the decode step's KV-row append fused in.
//
// Replaces: src/repro/kernels/posit_attention/posit_attention.py,
// `posit_decode_attention` (Pallas body `_attn_kernel`). With `k_new`/`v_new`
// given, the same launch also does the decode step's KV write, which the
// reference runs as the encode kernel (src/repro/kernels/posit_codec/
// posit_codec.py `encode_kernel`) and a scatter (src/repro/models/attention.py
// `_store`).
//
// Bound on the H100: device-memory bytes. A decode step reads each live K/V
// code once (1 byte a value at p8) and does ~4 flops a q-head a value. As f32
// FMAs beside a table decode, the instructions an SM issues for a position
// outlast its bytes, so both products run on the tensor cores, with f32
// accuracy kept by splitting operands into bf16 pieces. A single bf16 P would
// not hold the f32 tolerance, 4 (d + 2S) 2^-24 max|V|, at short S: at S = 80
// its error is ~9x that limit (chip_smoke.py's bf16 control); from S = 512
// the limit is loose enough to pass it, and only chip_smoke.py's tight limit,
// 64 * 2^-24 max|V|, tells the two apart.
//
// Design:
// * S is cut into splits of kChunk positions, one block each: the grid is
//   (batch row x KV head x group of 8 q-heads, split). The caller plans it
//   (kernels/posit_attention/ops.py `_plan`, which also sizes the scratch)
//   and the launch refuses any plan but this one. A row's split count
//   comes from its own length alone, so its output bits do not depend on the
//   other rows of the batch or on S; blocks past a row's length exit at once,
//   and a length-0 row runs one block that writes exact zeros.
// * One block serves the q-heads of one KV head (up to 8; more take more
//   blocks), so each K/V tile is read from device memory once for all of them.
// * Each warp streams its own positions, 16 a step, through a 2-stage
//   cp.async ring of its own (16-byte copies, each row's chunks rotated so
//   fragment loads hit distinct banks; positions past the split are
//   zero-filled, so masked V loads as 0 and stale NaR codes cannot reach
//   acc): no block barrier in the loop. The block has as many warps as two
//   blocks an SM leave shared memory for (`plan_warps`).
// * Scores: S (16 positions x 8 q-heads) = K (16 x d) . Q^T with
//   mma.sync.m16n8k16 bf16 -> f32. A p8 or bf16 code is exact in bf16, a p16
//   code is the sum of two bf16 pieces and an f32 value of three; q is split
//   into three (hi + mid + lo, the f32 value to ~2^-24), and the products of
//   the pieces that matter accumulate in f32. Within a k step the columns are
//   permuted so a lane's fragment is 4 consecutive codes of a row (one load),
//   with q's fragments (built once a block) permuted alike.
// * Online softmax per warp in f32 on the score fragments (3 shuffles a max
//   or a sum), then acc^T (d x 8 q-heads) += V^T . P on the tensor cores:
//   P in three bf16 pieces, V exact (p8, bf16) or in two (p16) or three (f32)
//   pieces; V's fragment is 2 consecutive codes of 4 rows. Each lane keeps
//   its accumulator fragments (d / 8 floats) and its q-heads' (m, l) in
//   registers.
// * Decode at use: p8 through a 256-entry table with one copy a lane
//   (conflict-free), p16 through the class table of posit_codec.cuh
//   (`p16_f32`), f32 and bf16 as plain loads.
// * The warps merge in warp order at the end of the block. A row with one
//   split writes its output there. Otherwise each split writes (m, l, acc) to
//   scratch, and the last block of the (row, KV head, q-head group) to finish
//   (an atomic counter, reset by that block) combines the splits in split
//   order: one launch, the same bits every run.
// * Append: the block whose split holds pos[b] encodes the new K/V row
//   (posit::encode, no ftz, as `_store`), writes it to the cache and then
//   loads its tiles, so it attends to the new position through the codes it
//   wrote. No block reads a code another block writes (the blocks of other
//   q-head groups write the same bytes, and read their own). Rows with pos[b]
//   outside [0, S) are not written.
// * Paged mode (`table` given; kernels/posit_attention/ops.py
//   `decode_attention_paged`, the reference's `posit_decode_attention_paged`,
//   which de-pages through one XLA gather before its tiled loop): K/V live in
//   pools (N, Hkv, bt, d) and position p of row b in block table[b, p / bt] at
//   offset p % bt. Only the addresses change: the split plan, the warp steps,
//   the MMAs and the merge order are the dense mode's, with S = W * bt, so a
//   row's output is bit for bit the dense kernel's on the de-paged cache. A
//   block stages the pool row of each of its split's positions in shared
//   memory once (kChunk ints), so the loads do no division. A table entry
//   outside [0, N) (the sentinel) is never dereferenced: its rows load as
//   zeros, like positions past the length (code 0 is exact 0.0), so a
//   recycled page's stale NaR codes cannot reach acc. The append writes to
//   table[b, p / bt] and drops the write when p / bt >= W or the entry is a
//   sentinel (an inactive slot's table is all sentinels).
#include <type_traits>

#include "posit_codec.cuh"

namespace {

using posit::kBF16;
using posit::kF32;
using posit::kP16;
using posit::kP8;

constexpr int kChunk = 512;   // positions a split: the only plan the launch takes
constexpr int kGP = 8;        // q-heads a block: the MMA's n
constexpr int kStep = 16;     // positions a warp step: the MMA's m (scores) and k (PV)
constexpr int kBlockSmem = 112640;  // shared bytes a block may plan on: two blocks an SM
constexpr int kP8TabBytes = 256 * 32 * 4;  // code c, lane l at word c * 32 + l
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

__host__ __device__ constexpr int imax(int x, int y) { return x > y ? x : y; }
__host__ __device__ constexpr int imin(int x, int y) { return x < y ? x : y; }

__host__ __device__ constexpr int elem_bytes(int kind) {
  return kind == kF32 ? 4 : (kind == kP8 ? 1 : 2);
}

__host__ __device__ constexpr int tab_bytes(int kind) {
  return kind == kP8 ? kP8TabBytes : (kind == kP16 ? posit::kP16TabBytes : 0);
}

// bf16 pieces of a K or V value: 1 for p8 and bf16 (exact), 2 for p16, 3 for f32
__host__ __device__ constexpr int pieces(int kind) {
  return kind == kF32 ? 3 : (kind == kP16 ? 2 : 1);
}

// q's MMA fragments: (k step, piece, lane) x 2 words
__host__ __device__ constexpr int qfrag_bytes(int d) { return d / 16 * 3 * 32 * 8; }

// Warps of the largest block (MT 16-column tiles a row, 16 * MT >= d).
template <int MT>
struct Shape {
  static constexpr int NW_MAX = MT <= 8 ? 8 : 4;
  static constexpr int WS = 2 * kGP + kGP * 16 * MT;  // merge floats a warp: m, l, acc
};

// Warps a block at head_dim d: as many 2-stage rings (16 K rows and 16 V rows
// a stage) as fit beside the decode table and q's fragments in kBlockSmem.
template <int KIND, int MT>
__host__ __device__ int plan_warps(int d) {
  const int ring = 2 * 2 * kStep * d * elem_bytes(KIND);
  const int free = kBlockSmem - tab_bytes(KIND) - qfrag_bytes(d);
  return imax(1, imin(Shape<MT>::NW_MAX, free / ring));
}

struct AttnArgs {
  const float* q;
  uint8_t* k;  // written only by an append
  uint8_t* v;
  const int* lengths;
  float* out;
  const float* k_new;  // append: (B, Hkv, d) f32, or null
  const float* v_new;
  const int* pos;      // append: (B,) write positions, or null
  float* part;         // (Y, nsx, kGP, 2 + d) split partials when nsx > 1
  int* counters;       // (Y,) zeroed, when nsx > 1
  const int* table;    // paged: (B, W) block ids, or null (dense)
  int W, bt, N;        // paged: table width, positions a block, pool blocks
  int Hq, Hkv, S, d, es, n_hg, nsx, nw;
  float scale;
};

// Bytes of the shared region used first by the table, q's fragments and the
// warps' rings, then by the warps' merge, then by the split combine's
// weights; the warps' probability buffers (kStep x kGP floats each) follow.
template <int KIND, int MT>
__host__ __device__ int region_bytes(int d, int nsx, int nw) {
  const int loop =
      tab_bytes(KIND) + qfrag_bytes(d) + nw * 2 * 2 * kStep * d * elem_bytes(KIND);
  const int merge = (nw * Shape<MT>::WS + nw * kGP + 2 * kGP) * 4;
  const int comb = (nsx + 1) * kGP * 4;
  return (imax(loop, imax(merge, comb)) + 15) & ~15;
}

// ... then, in paged mode, the split's pool rows (kChunk ints).
template <int KIND, int MT>
int smem_bytes(int d, int nsx, int nw, bool paged) {
  return region_bytes<KIND, MT>(d, nsx, nw) + nw * kStep * kGP * 4 + (paged ? kChunk * 4 : 0);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as N packed bf16 pieces (low half x, high half y): the
// pieces sum to the values, exactly when N covers their significant bits.
template <int N>
__device__ __forceinline__ void split2(float x, float y, uint32_t (&w)[N]) {
#pragma unroll
  for (int p = 0; p < N; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    w[p] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

// Element i of a fragment's codes `w` (consecutive codes of one row), as f32.
template <int KIND>
__device__ __forceinline__ float elem(const uint32_t* w, int i, const uint8_t* tab, int lane) {
  if constexpr (KIND == kP8) {
    const uint32_t c = (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
    return reinterpret_cast<const float*>(tab)[c * 32 + lane];
  } else if constexpr (KIND == kP16) {
    const int s = static_cast<int16_t>(w[i / 2] >> (16 * (i % 2)));
    return posit::p16_f32(s, tab, static_cast<uint32_t>(lane) * 4u);
  } else if constexpr (KIND == kBF16) {
    return __uint_as_float((w[i / 2] >> (16 * (i % 2))) << 16);
  } else {
    return __uint_as_float(w[i]);
  }
}

// NB consecutive bytes (NB in 2, 4, 8, 16, aligned) as words.
template <int NB>
__device__ __forceinline__ void load_words(const uint8_t* p, uint32_t (&w)[NB < 4 ? 1 : NB / 4]) {
  if constexpr (NB == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NB == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    w[0] = t.x;
    w[1] = t.y;
  } else {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    w[0] = t.x;
    w[1] = t.y;
    w[2] = t.z;
    w[3] = t.w;
  }
}

template <int KIND>
__device__ __forceinline__ void store_elem(uint8_t* base, long long i, float x, int es) {
  if constexpr (KIND == kF32) {
    reinterpret_cast<float*>(base)[i] = x;
  } else if constexpr (KIND == kBF16) {
    reinterpret_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  } else if constexpr (KIND == kP8) {
    base[i] = static_cast<uint8_t>(posit::encode(x, 8, es));
  } else {
    reinterpret_cast<uint16_t*>(base)[i] = static_cast<uint16_t>(posit::encode(x, 16, es));
  }
}

// MT 16-column tiles a row; EXACT: d == 16 * MT, else d <= 16 * MT and the
// tile loops test each tile (a branch that keeps the compiler from hoisting
// one tile's loads above the last one's MMAs).
template <int KIND, int MT, bool EXACT>
__global__ void __launch_bounds__(Shape<MT>::NW_MAX * 32, 2) attn_kernel(AttnArgs a) {
  constexpr int WS = Shape<MT>::WS, EB = elem_bytes(KIND), NP = pieces(KIND);
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = a.nw * 32;
  const int gq = lane >> 2, tq = lane & 3;  // the MMA fragments' row group and column pair
  const int y = blockIdx.x, split = blockIdx.y;
  const int hg = y % a.n_hg, bh = y / a.n_hg, b = bh / a.Hkv, hk = bh % a.Hkv;
  const int g = a.Hq / a.Hkv, j0 = hg * kGP, gp = min(kGP, g - j0);
  const int d = a.d, S = a.S, nmt = d / 16;
  const int rb = d * EB, cpr = rb / 16;  // bytes and 16-byte chunks a row
  const bool paged = a.table != nullptr;  // S = W * bt in paged mode
  const long long row0 = static_cast<long long>(bh) * S;  // dense: the row's first K/V row

  if (a.pos != nullptr) {  // the append: uniform over the block
    const int p = a.pos[b];
    if (p >= 0 && p < S && p / kChunk == split) {
      long long dst = (row0 + p) * d;
      if (paged) {
        const int blk = a.table[static_cast<long long>(b) * a.W + p / a.bt];
        dst = blk >= 0 && blk < a.N
                  ? ((static_cast<long long>(blk) * a.Hkv + hk) * a.bt + p % a.bt) * d
                  : -1;  // a sentinel entry: the write is dropped
      }
      if (dst >= 0) {
        const long long src = static_cast<long long>(bh) * d;
        for (int c = tid; c < d; c += nt) {
          store_elem<KIND>(a.k, dst + c, a.k_new[src + c], a.es);
          store_elem<KIND>(a.v, dst + c, a.v_new[src + c], a.es);
        }
        __threadfence();
      }
    }
    __syncthreads();  // the row is in place before any thread loads its tile
  }
  const int len = min(max(a.lengths[b], 0), S);
  const int n_split = max(1, (len + kChunk - 1) / kChunk);
  if (split >= n_split) return;

  uint8_t* tab = smem;
  uint2* qf = reinterpret_cast<uint2*>(smem + tab_bytes(KIND));
  uint8_t* rings = smem + tab_bytes(KIND) + qfrag_bytes(d);
  float* pw = reinterpret_cast<float*>(smem + region_bytes<KIND, MT>(d, a.nsx, a.nw)) +
              warp * kStep * kGP;  // the step's probabilities, (position, q-head)

  // Warp w takes positions t * kStep * nw + w * kStep .. + kStep of the split in
  // step t. A stage holds 16 K rows then 16 V rows; row r's 16-byte chunk j
  // sits at chunk (j + rot(r)) % cpr, rot(r) = r & (R - 1), R the largest
  // power of two up to min(8, cpr).
  const int s_lo = split * kChunk, nrows = min(kChunk, len - s_lo);
  const int bstep = kStep * a.nw;
  const int n_it = (nrows + bstep - 1) / bstep;
  // paged: the pool row of each position of the split (-1: a sentinel entry)
  int* prow = reinterpret_cast<int*>(smem + region_bytes<KIND, MT>(d, a.nsx, a.nw) +
                                     a.nw * kStep * kGP * 4);
  if (paged) {
    const int* tb = a.table + static_cast<long long>(b) * a.W;
    for (int j = tid; j < nrows; j += nt) {
      const int p = s_lo + j, blk = tb[p / a.bt];
      prow[j] = blk >= 0 && blk < a.N ? (blk * a.Hkv + hk) * a.bt + p % a.bt : -1;
    }
    __syncthreads();
  }
  const uint8_t* kg = paged ? a.k : a.k + (row0 + s_lo) * rb;
  const uint8_t* vg = paged ? a.v : a.v + (row0 + s_lo) * rb;
  const int wst = 2 * kStep * rb;
  uint8_t* wring = rings + warp * 2 * wst;
  const int rmask = (cpr >= 8 ? 8 : (cpr >= 4 ? 4 : (cpr >= 2 ? 2 : 1))) - 1;
  const int lr0 = lane / cpr, lc0 = lane - lr0 * cpr;  // the lane's first chunk of a tile
  const int dr = 32 / cpr, dc = 32 - dr * cpr;
  // One loop a mode (PAGED a compile-time constant inside it), chosen by a
  // uniform branch: the dense loop is the same code as without a paged mode.
  auto load_mode = [&](auto mode, int t) {
    constexpr bool PAGED = decltype(mode)::value;
    uint8_t* dst = wring + (t & 1) * wst;
    const int r0 = t * bstep + warp * kStep;
    const int valid = max(0, min(kStep, nrows - r0)) * cpr;  // chunks
    const uint8_t* ks = PAGED ? kg : kg + static_cast<long long>(r0) * rb;
    const uint8_t* vs = PAGED ? vg : vg + static_cast<long long>(r0) * rb;
    int r = lr0, c = lc0;
#pragma unroll 4
    for (int i = lane; i < kStep * cpr; i += 32) {
      bool in = i < valid;
      const uint8_t* kc = ks + (in ? i * 16 : 0);  // dense: chunk c of row r (i = r * cpr + c)
      const uint8_t* vc = vs + (in ? i * 16 : 0);
      if constexpr (PAGED) {  // chunk c of the row's pool row
        const int pr = in ? prow[r0 + r] : -1;
        in = pr >= 0;
        const long long src = in ? static_cast<long long>(pr) * rb + c * 16 : 0;
        kc = kg + src;
        vc = vg + src;
      }
      int pc = c + (r & rmask);
      pc = pc >= cpr ? pc - cpr : pc;
      cp_async16(dst + r * rb + pc * 16, kc, in);
      cp_async16(dst + kStep * rb + r * rb + pc * 16, vc, in);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  };
  auto load = [&](int t) {
    if (paged)
      load_mode(std::true_type{}, t);
    else
      load_mode(std::false_type{}, t);
  };
  if (n_it > 0) load(0);
  cp_async_commit();

  if constexpr (KIND == kP8) {
    for (int c = tid; c < 256; c += nt) {  // code c's 32 lane copies, 16 bytes a store
      const float v = posit::decode(static_cast<uint32_t>(c), 8, a.es);
      const float4 v4 = make_float4(v, v, v, v);
#pragma unroll
      for (int u = 0; u < 8; ++u) reinterpret_cast<float4*>(tab + c * 128)[(u + c) & 7] = v4;
    }
  } else if constexpr (KIND == kP16) {
    posit::fill_p16_table(tab, a.es, tid, nt);
  }
  // q's B fragments: (k step, piece, lane) = q[head gq][16 ks + 4 tq .. + 3] in
  // three bf16 pieces (0 for the heads past gp)
  {
    const float* qb = a.q + (static_cast<long long>(b) * a.Hq + hk * g + j0) * d;
    for (int i = tid; i < nmt * 32; i += nt) {
      const int ks = i >> 5, l = i & 31, h = l >> 2, c = 16 * ks + 4 * (l & 3);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (h < gp) v = *reinterpret_cast<const float4*>(qb + h * d + c);
      uint32_t lo[3], hi[3];
      split2<3>(v.x, v.y, lo);
      split2<3>(v.z, v.w, hi);
#pragma unroll
      for (int p = 0; p < 3; ++p) qf[(ks * 3 + p) * 32 + l] = make_uint2(lo[p], hi[p]);
    }
  }

  // the lane's softmax state: q-heads 2 tq and 2 tq + 1 (alike in every gq)
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const bool h0 = 2 * tq < gp, h1 = 2 * tq + 1 < gp;
  // acc^T fragments: tile mi, (column 16 mi + 2 gq (+1 for 2, 3), q-head 2 tq (+1 for 1, 3))
  float acc[MT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[mi][u] = 0.0f;
  // this lane's fragments inside a row: K rows gq and gq + 8 (one rotation),
  // V rows 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9 (rotations of 2 tq and 2 tq + 1)
  const int krot = gq & rmask;
  const int vrot0 = (2 * tq) & rmask, vrot1 = (2 * tq + 1) & rmask;
  auto chunk_off = [&](int byte, int rot) {  // logical byte of a row -> its place
    int c = (byte >> 4) + rot;
    c = c >= cpr ? c - cpr : c;
    return c * 16 + (byte & 15);
  };
  __syncthreads();  // the table and q's fragments

  for (int t = 0; t < n_it; ++t) {
    cp_async_wait<0>();
    __syncwarp();
    if (t + 1 < n_it) load(t + 1);
    cp_async_commit();
    const int r0 = t * bstep + warp * kStep;
    if (r0 >= nrows) break;
    const uint8_t* Ks = wring + (t & 1) * wst;
    const uint8_t* Vs = Ks + kStep * rb;

    // scores (16 positions x 8 q-heads), one accumulator a q piece so the
    // MMA chains run side by side
    float sc[3][4] = {};
#pragma unroll
    for (int ks = 0; ks < MT; ++ks) {
      if (EXACT || ks < nmt) {
        const int off = chunk_off((16 * ks + 4 * tq) * EB, krot);
        uint32_t w0[EB], w1[EB];  // 4 codes of rows gq and gq + 8
        load_words<4 * EB>(Ks + gq * rb + off, w0);
        load_words<4 * EB>(Ks + (gq + 8) * rb + off, w1);
        uint32_t p0[NP], p1[NP], p2[NP], p3[NP];
        split2<NP>(elem<KIND>(w0, 0, tab, lane), elem<KIND>(w0, 1, tab, lane), p0);
        split2<NP>(elem<KIND>(w1, 0, tab, lane), elem<KIND>(w1, 1, tab, lane), p1);
        split2<NP>(elem<KIND>(w0, 2, tab, lane), elem<KIND>(w0, 3, tab, lane), p2);
        split2<NP>(elem<KIND>(w1, 2, tab, lane), elem<KIND>(w1, 3, tab, lane), p3);
        uint2 qv[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) qv[p] = qf[(ks * 3 + p) * 32 + lane];
        // K piece p x q piece j for p + j < 3
#pragma unroll
        for (int p = NP - 1; p >= 0; --p) {
          const uint32_t ap[4] = {p0[p], p1[p], p2[p], p3[p]};
#pragma unroll
          for (int j = 2 - p; j >= 0; --j) mma(sc[j], ap, qv[j].x, qv[j].y);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) sc[0][u] += sc[1][u] + sc[2][u];  // the small sums first

    // online softmax on the fragments: rows gq, gq + 8; q-heads 2 tq, 2 tq + 1
    const bool va = r0 + gq < nrows, vb = r0 + gq + 8 < nrows;
    const bool ok0 = va && h0, ok1 = va && h1, ok2 = vb && h0, ok3 = vb && h1;
    const float s0 = ok0 ? sc[0][0] * a.scale : kNegInf, s1 = ok1 ? sc[0][1] * a.scale : kNegInf;
    const float s2 = ok2 ? sc[0][2] * a.scale : kNegInf, s3 = ok3 ? sc[0][3] * a.scale : kNegInf;
    float mx0 = fmaxf(s0, s2), mx1 = fmaxf(s1, s3);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // an explicit 0 for masked slots: a fully masked step keeps m at kNegInf
    const float e0 = ok0 ? __expf(s0 - mn0) : 0.0f, e1 = ok1 ? __expf(s1 - mn1) : 0.0f;
    const float e2 = ok2 ? __expf(s2 - mn0) : 0.0f, e3 = ok3 ? __expf(s3 - mn1) : 0.0f;
    float sum0 = e0 + e2, sum1 = e1 + e3;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
    }
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
    reinterpret_cast<float2*>(pw + gq * kGP)[tq] = make_float2(e0, e1);
    reinterpret_cast<float2*>(pw + (gq + 8) * kGP)[tq] = make_float2(e2, e3);
    __syncwarp();
    // P's B fragments: positions 2 tq, 2 tq + 1 (b0), 2 tq + 8, 2 tq + 9 (b1), q-head gq
    uint32_t pb0[3], pb1[3];
    split2<3>(pw[(2 * tq) * kGP + gq], pw[(2 * tq + 1) * kGP + gq], pb0);
    split2<3>(pw[(2 * tq + 8) * kGP + gq], pw[(2 * tq + 9) * kGP + gq], pb1);
    __syncwarp();

    // acc^T += V^T . P, tile by tile of 16 columns
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      acc[mi][0] *= al0;
      acc[mi][1] *= al1;
      acc[mi][2] *= al0;
      acc[mi][3] *= al1;
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (EXACT || mi < nmt) {
        const int o0 = chunk_off((16 * mi + 2 * gq) * EB, vrot0);
        const int o1 = chunk_off((16 * mi + 2 * gq) * EB, vrot1);
        uint32_t w[4][EB < 2 ? 1 : EB / 2];  // 2 codes of rows 2tq, 2tq+1, 2tq+8, 2tq+9
        load_words<2 * EB>(Vs + (2 * tq) * rb + o0, w[0]);
        load_words<2 * EB>(Vs + (2 * tq + 1) * rb + o1, w[1]);
        load_words<2 * EB>(Vs + (2 * tq + 8) * rb + o0, w[2]);
        load_words<2 * EB>(Vs + (2 * tq + 9) * rb + o1, w[3]);
        uint32_t q0[NP], q1[NP], q2[NP], q3[NP];
        // (column 2 gq, 2 gq + 1) x (rows 2 tq, 2 tq + 1 | 2 tq + 8, 2 tq + 9)
        split2<NP>(elem<KIND>(w[0], 0, tab, lane), elem<KIND>(w[1], 0, tab, lane), q0);
        split2<NP>(elem<KIND>(w[0], 1, tab, lane), elem<KIND>(w[1], 1, tab, lane), q1);
        split2<NP>(elem<KIND>(w[2], 0, tab, lane), elem<KIND>(w[3], 0, tab, lane), q2);
        split2<NP>(elem<KIND>(w[2], 1, tab, lane), elem<KIND>(w[3], 1, tab, lane), q3);
#pragma unroll
        for (int p = NP - 1; p >= 0; --p) {
          const uint32_t ap[4] = {q0[p], q1[p], q2[p], q3[p]};
#pragma unroll
          for (int j = 2 - p; j >= 0; --j) mma(acc[mi], ap, pb0[j], pb1[j]);
        }
      }
    }
  }

  // the warps merge in warp order: gp threads weigh each warp's state once
  cp_async_wait<0>();
  __syncthreads();
  float* mg = reinterpret_cast<float*>(smem);
  float* wt = mg + a.nw * WS;  // (nw, kGP) warp weights, then M (kGP)
  {
    float* mw = mg + warp * WS;
    if (gq == 0) {
      mw[2 * tq] = m0;
      mw[2 * tq + 1] = m1;
      mw[kGP + 2 * tq] = l0;
      mw[kGP + 2 * tq + 1] = l1;
    }
    float* aw = mw + 2 * kGP;  // (q-head, column)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (EXACT || mi < nmt) {
        const int c = 16 * mi + 2 * gq;
        aw[(2 * tq) * d + c] = acc[mi][0];
        aw[(2 * tq + 1) * d + c] = acc[mi][1];
        aw[(2 * tq) * d + c + 1] = acc[mi][2];
        aw[(2 * tq + 1) * d + c + 1] = acc[mi][3];
      }
    }
  }
  __syncthreads();
  // e (w, j) = exp(m_w,j - M_j), every pair at once; the threads that need L_j
  // sum it in warp order themselves
  for (int i = tid; i < a.nw * kGP; i += nt) {
    const int w = i / kGP, j = i - w * kGP;
    float M = kNegInf;
    for (int u = 0; u < a.nw; ++u) M = fmaxf(M, mg[u * WS + j]);
    wt[i] = __expf(mg[w * WS + j] - M);
    if (w == 0) wt[a.nw * kGP + j] = M;
  }
  __syncthreads();
  const bool whole = n_split == 1;
  const long long ps = static_cast<long long>(kGP) * (2 + d);  // partial floats a split
  float* pbase = a.part + (static_cast<long long>(y) * a.nsx + split) * ps;
  float* ob = a.out + (static_cast<long long>(b) * a.Hq + hk * g + j0) * d;
  for (int o = 4 * tid; o < gp * d; o += 4 * nt) {  // 4 columns of q-head j a thread
    const int j = o / d;
    float L = 0.0f;
    float4 A = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w = 0; w < a.nw; ++w) {
      const float e = wt[w * kGP + j];
      const float4 x = *reinterpret_cast<const float4*>(mg + w * WS + 2 * kGP + o);
      L += mg[w * WS + kGP + j] * e;
      A.x += x.x * e;
      A.y += x.y * e;
      A.z += x.z * e;
      A.w += x.w * e;
    }
    if (whole) {  // a length-0 row: exact zeros
      const float r = L == 0.0f ? 1.0f : L;
      *reinterpret_cast<float4*>(ob + o) = make_float4(A.x / r, A.y / r, A.z / r, A.w / r);
    } else {
      *reinterpret_cast<float4*>(pbase + 2 * kGP + o) = A;
      if (o == j * d) {
        pbase[j] = wt[a.nw * kGP + j];
        pbase[kGP + j] = L;
      }
    }
  }
  if (whole) return;

  // the last split block of this (row, KV head, q-head group) combines them
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(a.counters + y, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* p0 = a.part + static_cast<long long>(y) * a.nsx * ps;
  float* ew = reinterpret_cast<float*>(smem);  // (n_split, kGP) weights
  float* Ls = ew + a.nsx * kGP;
  for (int j = warp; j < gp; j += a.nw) {
    float M = kNegInf;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, __ldcg(p0 + s * ps + j));
    M = warp_max(M);
    float L = 0.0f;
    for (int s = lane; s < n_split; s += 32) {
      const float e = expf(__ldcg(p0 + s * ps + j) - M);
      ew[s * kGP + j] = e;
      L += __ldcg(p0 + s * ps + kGP + j) * e;
    }
    L = warp_sum(L);
    if (lane == 0) Ls[j] = L;
  }
  __syncthreads();
  for (int o = 4 * tid; o < gp * d; o += 4 * nt) {  // 4 columns of q-head j a thread
    const int j = o / d;
    const float* pc = p0 + 2 * kGP + o;
    float4 A = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float e = ew[s * kGP + j];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(pc + s * ps));
      A.x = fmaf(e, x.x, A.x);
      A.y = fmaf(e, x.y, A.y);
      A.z = fmaf(e, x.z, A.z);
      A.w = fmaf(e, x.w, A.w);
    }
    const float r = Ls[j] == 0.0f ? 1.0f : Ls[j];
    *reinterpret_cast<float4*>(ob + o) = make_float4(A.x / r, A.y / r, A.z / r, A.w / r);
  }
  if (tid == 0) a.counters[y] = 0;
}

template <int KIND, int MT, bool EXACT>
int launch(AttnArgs a, int B, cudaStream_t s) {
  a.nw = plan_warps<KIND, MT>(a.d);
  const int smem = smem_bytes<KIND, MT>(a.d, a.nsx, a.nw, a.table != nullptr);
  if (smem > kMaxSmem - 1024) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed = 0;  // the largest dynamic shared memory set so far
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<KIND, MT, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  const dim3 grid(static_cast<unsigned>(B * a.Hkv * a.n_hg), static_cast<unsigned>(a.nsx));
  attn_kernel<KIND, MT, EXACT><<<grid, a.nw * 32, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// head_dim 32, 64, 96, 128 and 256 (every config of src/repro/configs but
// zamba2-7b's 112 and xlstm-125m's 192) run exact; the others a guarded tile
// loop of the next size up
template <int KIND>
int launch_kind(const AttnArgs& a, int B, cudaStream_t s) {
  switch (a.d) {
    case 32: return launch<KIND, 2, true>(a, B, s);
    case 64: return launch<KIND, 4, true>(a, B, s);
    case 96: return launch<KIND, 6, true>(a, B, s);
    case 128: return launch<KIND, 8, true>(a, B, s);
    case 256: return launch<KIND, 16, true>(a, B, s);
    default: return a.d <= 128 ? launch<KIND, 8, false>(a, B, s) : launch<KIND, 16, false>(a, B, s);
  }
}

template <int KIND>
int warps_kind(int d) {
  return d <= 128 ? plan_warps<KIND, 8>(d) : plan_warps<KIND, 16>(d);
}

int launch_checked(AttnArgs a, int B, int kv_kind, int chunk, void* stream) {
  if (B <= 0) return 0;
  if (kv_kind < kF32 || kv_kind > kP16 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.d <= 0 ||
      a.d > 256 || a.d % 16 != 0 || a.S <= 0 ||
      (reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v) |
       reinterpret_cast<uintptr_t>(a.q)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the plan must be the kernel's (a compile-time split length keeps the
  // step loop's bounds constant), cover S and the q-heads, and have its scratch
  if (chunk != kChunk || a.nsx != (a.S + kChunk - 1) / kChunk ||
      a.n_hg != (a.Hq / a.Hkv + kGP - 1) / kGP ||
      (a.nsx > 1 && (a.part == nullptr || a.counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.es = a.es < 0 ? 0 : (a.es > 3 ? 3 : a.es);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kv_kind) {
    case kF32: return launch_kind<kF32>(a, B, s);
    case kBF16: return launch_kind<kBF16>(a, B, s);
    case kP8: return launch_kind<kP8>(a, B, s);
    default: return launch_kind<kP16>(a, B, s);
  }
}

}  // namespace

extern "C" {

// Warps a block of the kernel at head_dim d and kv_kind (the split order's
// CPU emulation, kernels/posit_attention/ref.py `kernel_warps`, is held to it).
int posit_attention_warps(int kv_kind, int d) {
  switch (kv_kind) {
    case kF32: return warps_kind<kF32>(d);
    case kBF16: return warps_kind<kBF16>(d);
    case kP8: return warps_kind<kP8>(d);
    default: return warps_kind<kP16>(d);
  }
}

// q (B, Hq, d) f32; k/v (B, Hkv, S, d) of kv_kind; lengths (B,) int32;
// out (B, Hq, d) f32. Append: k_new/v_new (B, Hkv, d) f32 and pos (B,) int32,
// or all null. The grid's plan: splits of `chunk` (= kChunk) positions, nsx
// of them over S, n_hg groups of 8 q-heads a KV head; part (B * Hkv * n_hg, nsx, 8, d + 2)
// f32 and counters (B * Hkv * n_hg) int32 zeroed are the split scratch, null
// when nsx == 1. head_dim: a multiple of 16 up to 256.
int posit_attention_launch(const float* q, void* k, void* v, const int* lengths, float* out,
                           const float* k_new, const float* v_new, const int* pos, float* part,
                           int* counters, int B, int Hq, int Hkv, int S, int d, int kv_kind,
                           int es, int chunk, int nsx, int n_hg, float scale, void* stream) {
  const AttnArgs a{q, static_cast<uint8_t*>(k), static_cast<uint8_t*>(v), lengths, out, k_new,
                   v_new, pos, part, counters, nullptr, 0, 0, 0, Hq, Hkv, S, d, es, n_hg, nsx,
                   0, scale};
  return launch_checked(a, B, kv_kind, chunk, stream);
}

// Paged mode: k/v are pools (N, Hkv, bt, d) of kv_kind, table (B, W) int32
// block ids (an entry outside [0, N) is empty); the plan covers S = W * bt.
// The other arguments are posit_attention_launch's.
int posit_attention_paged_launch(const float* q, void* k, void* v, const int* table,
                                 const int* lengths, float* out, const float* k_new,
                                 const float* v_new, const int* pos, float* part, int* counters,
                                 int B, int Hq, int Hkv, int N, int W, int bt, int d, int kv_kind,
                                 int es, int chunk, int nsx, int n_hg, float scale,
                                 void* stream) {
  const long long S = static_cast<long long>(W) * bt;
  if (table == nullptr || N <= 0 || W <= 0 || bt <= 0 || S > (1 << 30) ||
      static_cast<long long>(N) * Hkv * bt > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const AttnArgs a{q, static_cast<uint8_t*>(k), static_cast<uint8_t*>(v), lengths, out, k_new,
                   v_new, pos, part, counters, table, W, bt, N, Hq, Hkv,
                   static_cast<int>(S), d, es, n_hg, nsx, 0, scale};
  return launch_checked(a, B, kv_kind, chunk, stream);
}

}  // extern "C"
