"""Pure-posit integer ALU: the PERCIVAL-style "parallel PAU" baseline.

The paper argues against this design point: PERCIVAL / CLARINET embed a
complete posit arithmetic unit next to the FPU (+132% LUTs / +135% FFs at
FPU level, Table II). This module is the true posit arithmetic, add and
multiply computed in integer bit manipulation and never through a float,
which rounds the *exact* sum or product once; the paper's codec+FPU path
rounds in FP32 first and in the posit encode second.

The port's copy of the reference's ``core/alu.py``, bit for bit: the same
fields (``core/codec.py`` ``_decode_fields`` / ``_encode_fields``), the
hidden bit of the add datapath at bit 27 with 14 guard bits below it, and
the floor/fraction trick that keeps RNE exact when an alignment shift drops
bits. These are element-wise torch ops on whatever device the codes lie
on. torch's 32-bit unsigned integers lack shifts and compares on some
devices, so the bits travel in int64 with explicit 32-bit masks, as in the
codec; the most significant bit of a sum comes from its float64 exponent
(exact below 2^53), where the reference counts leading zeros.

The quire ops (``qclr`` / ``qma`` / ``qms`` / ``qneg`` / ``qround``) are
PERCIVAL's quire ISA at op granularity over ``core/quire.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.codec import _M32, _decode_fields, _encode_fields, _es, _sigw
from repro_torch.core.device import resolve_device
from repro_torch.core.quire import (QuireFmt, quire_accumulate, quire_negate, quire_read,
                                    quire_zero)

__all__ = ["posit_mul", "posit_add", "posit_sub", "qclr", "qma", "qms", "qneg", "qround"]

_HID = 27  # hidden-bit position in the add datapath


def _code_dtype(nbits: int) -> torch.dtype:
    return torch.uint8 if nbits == 8 else torch.uint16


def _floor_log2(w: torch.Tensor) -> torch.Tensor:
    """floor(log2(w)) for integer w in [1, 2^53): the float64 exponent. (The
    codec's f32 version rounds 2^k - 1 up to 2^k past 24 bits, and a sum
    here has up to 29.)"""
    f = w.to(torch.float64)
    return (f.view(torch.int64) >> 52) - 1023


def posit_mul(a: torch.Tensor, b: torch.Tensor, nbits: int, es: int) -> torch.Tensor:
    """True posit multiply: exact product, single RNE rounding."""
    n = nbits
    esl = _es(es)
    na, sa, ga, za, ra = _decode_fields(a, n, esl)
    nb, sb, gb, zb, rb = _decode_fields(b, n, esl)

    neg = na ^ nb
    scale = sa + sb
    p = ga * gb  # <= 28 bits: [2^(2w-2), 2^(2w-1))
    w = _sigw(n)
    hi = p >= (1 << (2 * w - 1))  # product in [2, 4)
    scale = scale + hi.to(torch.int64)
    # drop the hidden bit, left-align the fraction at bit 31
    frac = torch.where(hi, p - (1 << (2 * w - 1)), p - (1 << (2 * w - 2)))
    frac_la = torch.where(hi, frac << (32 - (2 * w - 1)), frac << (32 - (2 * w - 2))) & _M32
    sticky = torch.zeros_like(neg)

    code = _encode_fields(neg, scale, frac_la, sticky, n, esl)
    code = torch.where(za | zb, 0, code)
    code = torch.where(ra | rb, 1 << (n - 1), code)
    return code.to(_code_dtype(n))


def posit_add(a: torch.Tensor, b: torch.Tensor, nbits: int, es: int) -> torch.Tensor:
    """True posit add: exact sum, single RNE rounding (floor/fraction sticky)."""
    n = nbits
    esl = _es(es)
    mask = (1 << n) - 1
    na, sa, ga, za, ra = _decode_fields(a, n, esl)
    nb, sb, gb, zb, rb = _decode_fields(b, n, esl)
    w = _sigw(n)

    # promote significands: hidden bit at _HID (14 guard bits below)
    ma = ga << (_HID - (w - 1))
    mb = gb << (_HID - (w - 1))

    a_big = (sa > sb) | ((sa == sb) & (ma >= mb))
    s_hi = torch.where(a_big, sa, sb)
    s_lo = torch.where(a_big, sb, sa)
    m_hi = torch.where(a_big, ma, mb)
    m_lo = torch.where(a_big, mb, ma)
    n_hi = torch.where(a_big, na, nb)
    n_lo = torch.where(a_big, nb, na)

    shift = torch.clamp(s_hi - s_lo, max=31)
    lost = (m_lo & ((1 << shift) - 1)) != 0
    m_lo_sh = m_lo >> shift

    sgn_hi = torch.where(n_hi, -1, 1)
    sgn_lo = torch.where(n_lo, -1, 1)
    v = sgn_hi * m_hi + sgn_lo * m_lo_sh
    # exact value = v + sgn_lo * eps, eps in (0,1) iff lost. Take floor:
    v = v - (lost & n_lo).to(torch.int64)
    neg_r = v < 0
    mag = torch.where(neg_r, -v, v)
    # if floor < 0 and a fraction exists, magnitude = |floor| - (1 - eps')
    mag = mag - (lost & neg_r).to(torch.int64)
    sticky = lost

    exact_zero = (mag == 0) & ~sticky
    mag_safe = torch.clamp(mag, min=1)
    h = _floor_log2(mag_safe)  # MSB position
    scale = s_hi + (h - _HID)
    frac_la = ((mag_safe << (31 - h)) << 1) & _M32

    code = _encode_fields(neg_r, scale, frac_la, sticky, n, esl)
    code = torch.where(exact_zero, 0, code)
    code = torch.where(za, b.to(torch.int64) & mask, code)
    code = torch.where(zb & ~za, a.to(torch.int64) & mask, code)
    code = torch.where(ra | rb, 1 << (n - 1), code)
    return code.to(_code_dtype(n))


def posit_sub(a: torch.Tensor, b: torch.Tensor, nbits: int, es: int) -> torch.Tensor:
    """a - b via two's-complement negation of b (posit negation is exact)."""
    n = nbits
    nb = ((1 << n) - b.to(torch.int64)) & ((1 << n) - 1)
    return posit_add(a, nb.to(b.dtype), n, es)


# =====================================================================
# fused quire ops: PERCIVAL's quire ISA (qmadd.s / qmsub.s / qclr / qneg /
# qround.p) at op granularity, a multiply whose exact product accumulates
# with no intermediate rounding. The quire state lives in core/quire.py.
# =====================================================================

def qclr(batch_shape, nbits: int, es: int = 2, *, device="cuda") -> torch.Tensor:
    """Cleared quire for P(nbits, es) (PERCIVAL ``qclr``) on ``device``."""
    return quire_zero(batch_shape, QuireFmt(nbits, es), resolve_device(device))


def qma(q: torch.Tensor, a: torch.Tensor, b: torch.Tensor, nbits: int,
        es: int) -> torch.Tensor:
    """q += a * b exactly (PERCIVAL ``qmadd.s``): no rounding until qround."""
    return quire_accumulate(q, a, b, QuireFmt(nbits), es_a=es, es_b=es)


def qms(q: torch.Tensor, a: torch.Tensor, b: torch.Tensor, nbits: int,
        es: int) -> torch.Tensor:
    """q -= a * b exactly (PERCIVAL ``qmsub.s``)."""
    return quire_accumulate(q, a, b, QuireFmt(nbits), es_a=es, es_b=es, subtract=True)


def qneg(q: torch.Tensor, nbits: int) -> torch.Tensor:
    """Exact quire negation (PERCIVAL ``qneg``)."""
    return quire_negate(q, QuireFmt(nbits))


def qround(q: torch.Tensor, nbits: int, es: int) -> torch.Tensor:
    """quire -> posit code, the single terminal RNE (PERCIVAL ``qround.p``)."""
    return quire_read(q, QuireFmt(nbits), es_out=es)
