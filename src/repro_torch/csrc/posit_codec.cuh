// Device-side posit <-> IEEE-754 codec, shared by every kernel of the port.
//
// The same integer pipeline as the plain-torch codec (repro_torch/core/codec.py)
// and the reference package's core/codec.py: decode is exact, encode rounds to
// nearest-even on the posit encoding with posit saturation (never 0, never NaR
// for a finite non-zero input). Every shift amount stays in [0, 31] for any es
// in [0, 3] and any n in {8, 16}. The f32-exponent floor-log2 of the reference
// becomes 31 - __clz(w), which agrees for w >= 1.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace posit {

constexpr uint32_t kNaNBits = 0x7FC00000u;

// Storage kinds of a kernel operand (the pcsr's pfmt/pprec pair).
enum Kind : int { kF32 = 0, kBF16 = 1, kP8 = 2, kP16 = 3 };

__device__ __forceinline__ int floor_log2(uint32_t w) { return 31 - __clz(w); }

// (m, k): regime run length and regime value of |code| (n-bit body).
__device__ __forceinline__ void regime(uint32_t absc, int n, int& m, int& k) {
  const uint32_t r0 = (absc >> (n - 2)) & 1u;
  const uint32_t w = r0 ? (~absc) & ((1u << (n - 1)) - 1u) : absc;
  m = (w == 0u) ? n - 1 : (n - 2) - floor_log2(w);
  k = r0 ? m - 1 : -m;
}

// n-bit posit code -> float32, exactly. NaR -> 0x7FC00000, 0 -> +0.0f.
__device__ __forceinline__ float decode(uint32_t code, int n, int es) {
  const uint32_t mask = (1u << n) - 1u;
  const uint32_t c = code & mask;
  if (c == 0u) return 0.0f;
  if (c == (1u << (n - 1))) return __uint_as_float(kNaNBits);
  const uint32_t sign = (c >> (n - 1)) & 1u;
  const uint32_t absc = sign ? ((1u << n) - c) & mask : c;
  int m, k;
  regime(absc, n, m, k);
  const uint32_t y = absc << (33 - n);          // body left-aligned at bit 31
  const uint32_t rem = y << (m + 1);            // m + 1 <= n <= 16
  const uint32_t e = (rem >> 24) >> (8 - es);   // top es bits via an 8-bit window
  const uint32_t mant23 = (rem << es) >> 9;
  const int scale = k * (1 << es) + static_cast<int>(e);  // |scale| <= 112
  return __uint_as_float((sign << 31) | (static_cast<uint32_t>(scale + 127) << 23) |
                         mant23);
}

struct Fields {
  bool neg;
  int scale;
  uint32_t sig;  // hidden bit at SIGW-1: 6 bits for p8, 14 for p16
  bool is_zero;
  bool is_nar;
};

// n-bit posit code -> integer fields. Fields of zero/NaR are garbage: mask
// them with the flags.
__device__ __forceinline__ Fields decode_fields(uint32_t code, int n, int es) {
  const uint32_t mask = (1u << n) - 1u;
  const uint32_t c = code & mask;
  Fields f;
  f.is_zero = c == 0u;
  f.is_nar = c == (1u << (n - 1));
  f.neg = ((c >> (n - 1)) & 1u) == 1u;
  const uint32_t absc = f.neg ? ((1u << n) - c) & mask : c;
  int m, k;
  regime(absc, n, m, k);
  const uint32_t rem = (absc << (33 - n)) << (m + 1);
  const uint32_t e = (rem >> 24) >> (8 - es);
  const uint32_t frac_la = rem << es;
  f.scale = k * (1 << es) + static_cast<int>(e);
  const int sigw = (n == 8) ? 6 : 14;
  f.sig = (1u << (sigw - 1)) | (frac_la >> (32 - (sigw - 1)));
  return f;
}

// (sign, scale, fraction left-aligned at bit 31, sticky) -> n-bit posit code.
// RNE on the encoding: the increment is added to the integer body, so carries
// run into exponent and regime as in hardware.
__device__ __forceinline__ uint32_t encode_fields(bool neg, int scale, uint32_t frac_la,
                                                  bool sticky, int n, int es) {
  const int smax = (n - 2) << es;
  const bool sat_hi = scale >= smax;
  const bool sat_lo = scale < -smax;
  const int sc = min(max(scale, -smax), smax - 1);
  // floor(sc / 2^es) without shifting a negative value
  const int k = sc >= 0 ? (sc >> es) : -((-sc + (1 << es) - 1) >> es);
  const uint32_t e = static_cast<uint32_t>(sc - k * (1 << es));  // 0 .. 2^es-1
  uint32_t reg;
  int r_len;
  if (k >= 0) {
    reg = ((1u << (k + 1)) - 1u) << 1;
    r_len = k + 2;
  } else {
    reg = 1u;
    r_len = 1 - k;
  }
  const uint32_t t = static_cast<uint32_t>((n - 1) - r_len);  // 0 .. n-3
  const uint32_t e_la = (e << 29) << (3 - es);
  const uint32_t lost = frac_la & ((1u << es) - 1u);
  const uint32_t u_la = e_la | (frac_la >> es);
  const uint32_t tail = (u_la >> 16) >> (16 - t);
  const uint32_t g_rest = u_la << t;
  const uint32_t g = g_rest >> 31;
  const bool st = sticky || lost != 0u || (g_rest << 1) != 0u;
  uint32_t body = (reg << t) | tail;
  body += (g == 1u && (st || (body & 1u))) ? 1u : 0u;
  const uint32_t maxbody = (1u << (n - 1)) - 1u;
  body = min(body, maxbody);
  if (sat_hi) body = maxbody;
  else if (sat_lo) body = 1u;
  return (neg ? (1u << n) - body : body) & ((1u << n) - 1u);
}

// float32 -> n-bit posit code. NaN/Inf -> NaR; +-0 -> 0. ftz: |x| <= minpos/2
// rounds to 0 instead of saturating to minpos.
__device__ __forceinline__ uint32_t encode(float x, int n, int es, bool ftz = false) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t a = bits & 0x7FFFFFFFu;
  if (a == 0u) return 0u;
  if (a >= 0x7F800000u) return 1u << (n - 1);
  const int scale = static_cast<int>(a >> 23) - 127;  // subnormals -> -127 -> minpos
  const uint32_t frac_la = (a & 0x7FFFFFu) << 9;
  if (ftz) {
    const int smax = (n - 2) << es;
    if (scale < -(smax + 1) || (scale == -(smax + 1) && frac_la == 0u)) return 0u;
  }
  return encode_fields((bits >> 31) == 1u, scale, frac_la, false, n, es);
}

// Decode table of all 256 p8 codes, filled by the block's threads. A p8
// operand then decodes with one shared-memory read per element.
__device__ __forceinline__ void fill_p8_table(float* tab, int es, int tid, int nthreads) {
  for (int c = tid; c < 256; c += nthreads) tab[c] = decode(static_cast<uint32_t>(c), 8, es);
}

// One element of an operand of storage kind KIND, as float32. `tab` is the
// block's p8 table (read only when KIND == kP8).
template <int KIND>
__device__ __forceinline__ float load_elem(const void* p, long long i, int es,
                                           const float* tab) {
  if constexpr (KIND == kF32) {
    return static_cast<const float*>(p)[i];
  } else if constexpr (KIND == kBF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else if constexpr (KIND == kP8) {
    return tab[static_cast<const uint8_t*>(p)[i]];
  } else {
    return decode(static_cast<const uint16_t*>(p)[i], 16, es);
  }
}

// Epilogue activations (the order of ACTIVATIONS in core/dot.py). gelu is
// the tanh form; silu and gelu follow PyTorch's formulas, so a kernel's f32
// epilogue matches the plain version's on the card.
enum Act : int { kActNone = 0, kActGelu = 1, kActSilu = 2, kActRelu = 3 };

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kActGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2/pi): the tanh form
      const float y3 = y * y * y;
      return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y3)));
    }
    case kActSilu:
      return y / (1.0f + expf(-y));
    case kActRelu:
      return y != y ? y : fmaxf(y, 0.0f);
    default:
      return y;
  }
}

// ---- p16 decode through a class table ----
// Within one class of magnitude codes a (regime run m, first regime bit r0),
// the f32 bits of the value are linear in a:
//   bits = ((k * 2^es + 127) << 23) + (ef << sh),  sh = 9 + m + es,
// where ef is the field after the regime's terminator (exponent bits, then
// fraction; a truncated exponent lands in the exponent field all the same).
// The bits above ef are the class's regime, so bits = T + (a << sh) mod 2^32
// with one word T a class, whose low 23 bits are zero. `a >> 7` fixes the
// class unless the run reaches bit 7 (rows 0 and 255: values below
// 2^(-7 * 2^es) or from 2^(7 * 2^es) on); those rows point to a second level
// of one word per code, indexed by `a & 0xFF`. Row 256 is NaR's. A word
// holds T + sh (sh in bits 0-4); the rare rows hold only the flag bit 5. A
// row holds one copy a lane, so a warp's 32 loads hit 32 distinct banks.
// core/lut.py's split table is the same idea with OR in place of the add,
// which needs the exponent bits inside the first byte too (its second level
// takes 16 of 128 rows at es 3); the add needs only the regime there. bf16
// is one hardware RNE of the exact value, two codes at a time.
// repro_torch/kernels/posit_gemm/ref.py `p16_table_decode` emulates it on the
// CPU, tested bit for bit against the reference decode for every code.
// Shared by the GEMM (p16 weights) and decode attention (p16 KV).
constexpr int kP16Rows = 257;              // a >> 7: 0..255, and NaR's 256
constexpr int kP16L1 = kP16Rows * 128;     // bytes: row r, lane l at r * 128 + l * 4
constexpr int kP16TabBytes = kP16L1 + 256 * 4;
constexpr uint32_t kP16Rare = 0x20u;

// The table word T + sh of magnitude code a (0 .. 0x8000) at `es`.
__device__ inline uint32_t p16_word(uint32_t a, int es) {
  // NaR: T + (0x8000 << 16) = 0xFFC00000, whose sign the code's sign clears
  if (a == 0x8000u) return 0x7FC00000u + 16u;
  int m, k;
  regime(a, 16, m, k);
  const int sh = 9 + m + es;  // 10 .. 27
  return __float_as_uint(decode(a, 16, es)) - (a << sh) + static_cast<uint32_t>(sh);
}

// Fills the table at `tab` (kP16TabBytes, 16-byte aligned) for the block.
__device__ inline void fill_p16_table(uint8_t* tab, int es, int tid, int nthreads) {
  for (int r = tid; r < kP16Rows; r += nthreads) {
    const uint32_t v = r == 0 || r == 255 ? kP16Rare : p16_word(r << 7, es);
    const uint4 v4 = make_uint4(v, v, v, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) reinterpret_cast<uint4*>(tab + r * 128)[(q + r) & 7] = v4;
  }
  uint32_t* second = reinterpret_cast<uint32_t*>(tab + kP16L1);
  for (int i = tid; i < 256; i += nthreads) second[i] = p16_word(i < 128 ? i : 0x7F00 + i, es);
}

// The f32 bits of the magnitude of the sign-extended p16 code s. `lane4` =
// lane * 4, the lane's copy of each row.
__device__ __forceinline__ uint32_t p16_magnitude(int s, const uint8_t* tab, uint32_t lane4) {
  const uint32_t a = static_cast<uint32_t>(abs(s));
  uint32_t t = *reinterpret_cast<const uint32_t*>(tab + ((a & 0xFF80u) | lane4));
  if (t & kP16Rare) t = reinterpret_cast<const uint32_t*>(tab + kP16L1)[a & 0xFFu];
  return (t & ~0x1Fu) + __funnelshift_l(0u, a, t);  // T + (a << sh)
}

// The p16 code s as float32, exactly (NaR: 0x7FC00000).
__device__ __forceinline__ float p16_f32(int s, const uint8_t* tab, uint32_t lane4) {
  return __uint_as_float(p16_magnitude(s, tab, lane4) ^
                         (static_cast<uint32_t>(s) & 0x80000000u));
}

}  // namespace posit
