"""Plain-torch, bit-exact posit <-> IEEE-754 codec.

The same integer pipeline as the reference codec and as the device functions
in ``csrc/posit_codec.cuh``: ``posit_decode`` is the FPU-boundary input
decoder (posit -> f32), ``posit_encode`` the output encoder (f32 -> posit,
round-to-nearest-even on the encoding, posit saturation).

torch's unsigned 16/32-bit integers lack shifts and compares on the CPU, so
the bits travel in int64 with explicit 32-bit masks wherever a left shift
could carry past bit 31. ``es`` is a Python int, clamped to [0, 3]; every
shift amount stays in [0, 31] for any es and any input pattern.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.types import PositFmt

_M32 = 0xFFFFFFFF
_NAN_BITS = 0x7FC00000


def _es(es) -> int:
    return min(max(int(es), 0), 3)


def _floor_log2_small(w: torch.Tensor) -> torch.Tensor:
    """floor(log2(w)) for integer w in [1, 2^24): exact via the f32 exponent."""
    f = w.to(torch.float32)
    return (f.view(torch.int32).to(torch.int64) >> 23) - 127


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 pattern -> the float32 with those bits."""
    signed = bits - ((bits >> 31) << 32)
    return signed.to(torch.int32).view(torch.float32)


def _f32_to_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 holding its uint32 bit pattern."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32


def _regime(absc: torch.Tensor, n: int):
    """(m, k): regime run length and regime value of |code|."""
    r0 = (absc >> (n - 2)) & 1
    w = torch.where(r0 == 1, (~absc) & ((1 << (n - 1)) - 1), absc)
    p = _floor_log2_small(torch.clamp(w, min=1))
    m = torch.where(w == 0, n - 1, (n - 2) - p)
    k = torch.where(r0 == 1, m - 1, -m)
    return m, k


# =====================================================================
# decode: posit bits -> float32 (exact)
# =====================================================================

def posit_decode(codes: torch.Tensor, nbits: int, es) -> torch.Tensor:
    """Decode n-bit posit codes (uint8/uint16/int) to float32, exactly.

    NaR (0b10..0) decodes to the NaN with bits 0x7FC00000; 0 to +0.0.
    """
    assert nbits in (8, 16), nbits
    n = nbits
    esl = _es(es)
    c = codes.to(torch.int64) & ((1 << n) - 1)
    sign = (c >> (n - 1)) & 1
    absc = torch.where(sign == 1, ((1 << n) - c) & ((1 << n) - 1), c)
    m, k = _regime(absc, n)
    y = absc << (33 - n)                       # body left-aligned at bit 31
    rem = (y << (m + 1)) & _M32                # regime + terminator shifted out
    e = (rem >> 24) >> (8 - esl)               # top `es` bits via an 8-bit window
    frac_la = (rem << esl) & _M32
    mant23 = frac_la >> 9
    scale = k * (1 << esl) + e                 # |scale| <= 112
    fbits = (sign << 31) | ((scale + 127) << 23) | mant23
    fbits = torch.where(c == 0, 0, fbits)
    fbits = torch.where(c == (1 << (n - 1)), _NAN_BITS, fbits)
    return _bits_to_f32(fbits)


# =====================================================================
# field decode: posit bits -> integer (sign, scale, significand) fields
# =====================================================================

def _sigw(nbits: int) -> int:
    """Significand width incl. hidden bit: 6 for p8, 14 for p16."""
    return 6 if nbits == 8 else 14


def _decode_fields(codes: torch.Tensor, nbits: int, es):
    """posit bits -> (neg, scale, sig hidden@SIGW-1, is_zero, is_nar).

    Fields of zero/NaR inputs are garbage and must be masked by the flags.
    """
    n = nbits
    esl = _es(es)
    c = codes.to(torch.int64) & ((1 << n) - 1)
    is_zero = c == 0
    is_nar = c == (1 << (n - 1))
    neg = ((c >> (n - 1)) & 1) == 1
    absc = torch.where(neg, ((1 << n) - c) & ((1 << n) - 1), c)
    m, k = _regime(absc, n)
    y = absc << (33 - n)
    rem = (y << (m + 1)) & _M32
    e = (rem >> 24) >> (8 - esl)
    frac_la = (rem << esl) & _M32
    scale = k * (1 << esl) + e
    sigw = _sigw(n)
    sig = (1 << (sigw - 1)) | (frac_la >> (32 - (sigw - 1)))
    return neg, scale, sig, is_zero, is_nar


# =====================================================================
# encode core: (sign, scale, fraction, sticky) -> posit bits
# =====================================================================

def _encode_fields(neg: torch.Tensor, scale: torch.Tensor, frac_la: torch.Tensor,
                   sticky: torch.Tensor, nbits: int, es) -> torch.Tensor:
    """Assemble + round an n-bit posit from sign/scale/fraction fields.

    ``frac_la`` holds the fraction (no hidden bit) left-aligned at bit 31.
    RNE on the encoding: the increment is added to the integer body so
    carries propagate into exponent and regime as in hardware. Saturation:
    scale >= smax -> maxpos; scale < -smax -> minpos (never 0/NaR).
    Returns int64 codes.
    """
    n = nbits
    esl = _es(es)
    smax = (n - 2) << esl
    sat_hi = scale >= smax
    sat_lo = scale < -smax
    scale_c = torch.clamp(scale, -smax, smax - 1)

    k = scale_c >> esl                         # arithmetic: floor(scale / 2^es)
    e = scale_c - (k << esl)                   # 0 .. 2^es-1
    kp = torch.clamp(k, min=0)
    reg = torch.where(k >= 0, ((1 << (kp + 1)) - 1) << 1, 1)
    r_len = torch.where(k >= 0, k + 2, 1 - k)
    t = (n - 1) - r_len                        # 0 .. n-3

    e_la = ((e << 29) << (3 - esl)) & _M32
    lost = frac_la & ((1 << esl) - 1)
    u_la = e_la | (frac_la >> esl)

    tail = (u_la >> 16) >> (16 - t)
    g_rest = (u_la << t) & _M32
    g = g_rest >> 31
    st = sticky | (lost != 0) | (((g_rest << 1) & _M32) != 0)

    body = (reg << t) | tail
    inc = (g == 1) & (st | ((body & 1) == 1))
    body = body + inc.to(torch.int64)
    maxbody = (1 << (n - 1)) - 1
    body = torch.clamp(body, max=maxbody)
    body = torch.where(sat_hi, maxbody, torch.where(sat_lo, 1, body))
    return torch.where(neg, (1 << n) - body, body) & ((1 << n) - 1)


def posit_encode(x: torch.Tensor, nbits: int, es, ftz: bool = False) -> torch.Tensor:
    """Encode float values to n-bit posit codes (RNE + posit saturation).

    NaN/Inf -> NaR; +-0 -> 0; 0<|x|<minpos -> +-minpos; |x|>maxpos -> +-maxpos.
    ``ftz=True``: |x| <= minpos/2 rounds to 0 instead of saturating to minpos.
    Returns uint8 (n=8) or uint16 (n=16).
    """
    assert nbits in (8, 16), nbits
    n = nbits
    esl = _es(es)
    bits = _f32_to_bits(x)
    neg = (bits >> 31) == 1
    a_bits = bits & 0x7FFFFFFF
    is_zero = a_bits == 0
    is_nar = a_bits >= 0x7F800000
    scale = (a_bits >> 23) - 127               # subnormals -> -127 -> sat_lo
    frac_la = (a_bits & 0x7FFFFF) << 9
    sticky = torch.zeros_like(neg)
    code = _encode_fields(neg, scale, frac_la, sticky, n, esl)
    if ftz:
        smax = (n - 2) << esl
        below = scale < -(smax + 1)
        at_half = (scale == -(smax + 1)) & (frac_la == 0)
        code = torch.where(below | at_half, 0, code)
    code = torch.where(is_zero, 0, code)
    code = torch.where(is_nar, 1 << (n - 1), code)
    return code.to(torch.uint8 if n == 8 else torch.uint16)


# =====================================================================
# value-level quantization
# =====================================================================

def quantize(x: torch.Tensor, fmt: PositFmt, es: Optional[int] = None) -> torch.Tensor:
    """Round-trip x through the posit format (value-level quantization)."""
    e = fmt.es if es is None else es
    return posit_decode(posit_encode(x, fmt.nbits, e), fmt.nbits, e).to(x.dtype)
