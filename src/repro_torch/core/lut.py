"""Table-driven codec paths (torch side): LUT decode and bucketize encode.

The same tables as the reference package's ``core/lut.py``, built here with
numpy, bit-exact against the bit pipeline (``core/codec.py``):

* **p8 decode**: one dense ``(4 es, 256)`` float32 table (NaR as NaN, zero
  as +0.0); decode is one gather.
* **p16 decode**: a two-level split table. After the sign strip the 16-bit
  code splits into ``hi = absc >> 8`` and ``lo = absc & 0xFF``; where the
  regime, its terminator and every exponent bit fit in ``hi``, the f32 bits
  are ``L1_BITS[es, hi] | (lo << L1_SHIFT[es, hi])``, else a dense second
  level ``LO[es, slot, lo]`` holds the values.
* **p8 encode**: ``searchsorted`` of the input against the rounding
  boundaries between adjacent p8 values (the values of the 9-bit posits with
  odd codes), exact ties to the even code, plus the posit specials.

``codec_impl`` (``OperandSlots.codec_impl`` / ``TransPolicy.codec_impl``):
"bits" forces the pipeline, "lut" the tables, "auto" picks the tables only
for the p8 decode where the device gathers well. The reference keys "auto"
on its default backend (cpu/gpu gather well, the TPU does not); the port
keys it on the tensor's device type, and both CPU and CUDA gather well.
Either way the result is the same bits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.codec import _bits_to_f32, _es, _f32_to_bits, posit_decode, posit_encode

CODEC_IMPLS = ("auto", "lut", "bits")

_MASK32 = 0xFFFFFFFF
_NAN_BITS = 0x7FC00000
# device types whose gathers beat the bit pipeline for the p8 decode
_GATHER_FRIENDLY = ("cpu", "cuda")


# =====================================================================
# table construction (numpy)
# =====================================================================

def _np_decode(codes: np.ndarray, nbits: int, es: int) -> np.ndarray:
    """Vectorized numpy posit decode (the tables' build-time oracle), the
    same integer pipeline as ``core.codec.posit_decode``."""
    n = nbits
    c = codes.astype(np.int64) & ((1 << n) - 1)
    sign = (c >> (n - 1)) & 1
    absc = np.where(sign == 1, ((1 << n) - c) & ((1 << n) - 1), c)
    r0 = (absc >> (n - 2)) & 1
    w = np.where(r0 == 1, (~absc) & ((1 << (n - 1)) - 1), absc)
    p = np.frexp(np.maximum(w, 1).astype(np.float64))[1] - 1
    m = np.where(w == 0, n - 1, (n - 2) - p)
    k = np.where(r0 == 1, m - 1, -m)
    y = (absc << (33 - n)) & _MASK32
    rem = (y << (m + 1)) & _MASK32
    e = (rem >> 24) >> (8 - es)
    frac_la = (rem << es) & _MASK32
    mant23 = frac_la >> 9
    scale = k * (1 << es) + e
    fbits = (sign << 31) | (((scale + 127) & 0xFF) << 23) | mant23
    out = fbits.astype(np.uint32).view(np.float32)
    out = np.where(c == 0, np.float32(0.0), out)
    nan = np.uint32(_NAN_BITS).view(np.float32)
    return np.where(c == (1 << (n - 1)), nan, out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _p8_decode_table() -> np.ndarray:
    """(4, 256) f32: table[es, code] == posit_decode(code, 8, es)."""
    return np.stack([_np_decode(np.arange(256), 8, es) for es in range(4)])


def _p16_hi_class(hi: int, es: int):
    """(scale, m) of a high byte of absc whose regime, terminator and es
    exponent bits fit in its 7 body bits, else None."""
    body = hi & 0x7F
    r0 = (body >> 6) & 1
    run = 0
    for i in range(6, -1, -1):
        if ((body >> i) & 1) == r0:
            run += 1
        else:
            break
    if run == 7 or run + 1 + es > 7:
        return None
    m = run
    k = m - 1 if r0 == 1 else -m
    e = (body >> (6 - m - es)) & ((1 << es) - 1)
    return k * (1 << es) + e, m


@functools.lru_cache(maxsize=None)
def _p16_decode_tables():
    """(l1_bits (4,128) int32, l1_shift (4,128) int32, lo_tab (4, S, 256) f32).

    l1_bits >= 0 is the base f32 pattern of the absolute value without the
    low byte's fraction; l1_bits < 0 is ``-(slot + 1)`` into lo_tab."""
    l1_bits = np.zeros((4, 128), np.int32)
    l1_shift = np.zeros((4, 128), np.int32)
    slot_codes: list[list[np.ndarray]] = []
    max_slots = 0
    for es in range(4):
        rows = []
        for hi in range(128):
            cls = _p16_hi_class(hi, es)
            if cls is None:
                l1_bits[es, hi] = -(len(rows) + 1)
                rows.append(_np_decode((hi << 8) | np.arange(256), 16, es))
            else:
                scale, m = cls
                base_mant = (hi << (17 + m + es)) & 0x7FFFFF
                l1_bits[es, hi] = ((scale + 127) << 23) | base_mant
                l1_shift[es, hi] = 9 + m + es
        slot_codes.append(rows)
        max_slots = max(max_slots, len(rows))
    lo_tab = np.zeros((4, max_slots, 256), np.float32)
    for es in range(4):
        for s, row in enumerate(slot_codes[es]):
            lo_tab[es, s] = row
    return l1_bits, l1_shift, lo_tab


@functools.lru_cache(maxsize=None)
def _p8_encode_tables(ftz: bool):
    """Per es: (codes (4,V) uint8 in ascending value order, mids (4,V-1) f32
    rounding boundaries, tie_up (4,V-1) bool: an exact tie goes up). V = 255
    with zero in the lattice (ftz) else 254. The boundary between adjacent
    codes c and c+1 (signed) is the value of the 9-bit posit 2c+1; every one
    is exactly representable in f32 (asserted)."""
    V = 255 if ftz else 254
    codes_t = np.zeros((4, V), np.uint8)
    mids_t = np.zeros((4, V - 1), np.float32)
    tie_t = np.zeros((4, V - 1), bool)
    for es in range(4):
        codes = np.array([c for c in range(256) if c != 0x80 and (ftz or c != 0)], np.uint8)
        signed = codes.astype(np.int8)
        order = np.argsort(signed)
        codes = codes[order]
        vals = _np_decode(codes, 8, es).astype(np.float64)
        assert (np.diff(vals) > 0).all(), "p8 values must be strictly ordered"
        s = signed[order].astype(np.int64)
        mids = _np_decode((2 * s[:-1] + 1) & 0x1FF, 9, es).astype(np.float64)
        assert (mids > vals[:-1]).all() and (mids < vals[1:]).all(), \
            "P9 boundaries must interleave the p8 lattice"
        assert (mids.astype(np.float32).astype(np.float64) == mids).all(), \
            "p8 rounding boundaries must be exactly f32-representable"
        codes_t[es] = codes
        mids_t[es] = mids.astype(np.float32)
        tie_t[es] = (codes[1:] % 2) == 0
    return codes_t, mids_t, tie_t


@functools.lru_cache(maxsize=None)
def _device_tables(kind: str, device: torch.device, ftz: bool = False):
    """The numpy tables of ``kind`` as tensors on ``device`` (built once)."""
    if kind == "p8_decode":
        return torch.from_numpy(_p8_decode_table()).to(device)
    if kind == "p16_decode":
        return tuple(torch.from_numpy(t).to(device) for t in _p16_decode_tables())
    codes, mids, tie = _p8_encode_tables(ftz)
    return (torch.from_numpy(codes.astype(np.int64)).to(device),
            torch.from_numpy(mids).to(device), torch.from_numpy(tie).to(device))


# =====================================================================
# table codec ops
# =====================================================================

def lut_decode_p8(codes: torch.Tensor, es) -> torch.Tensor:
    """p8 decode as one (4, 256)-table gather; bit-exact vs posit_decode."""
    tab = _device_tables("p8_decode", codes.device)
    return tab[_es(es)][codes.to(torch.int64) & 0xFF]


def lut_decode_p16(codes: torch.Tensor, es) -> torch.Tensor:
    """p16 decode through the two-level split table; bit-exact vs posit_decode."""
    l1b, l1s, lo_tab = _device_tables("p16_decode", codes.device)
    esl = _es(es)
    c = codes.to(torch.int64) & 0xFFFF
    neg = (c >> 15) == 1
    absc = torch.where(neg, ((1 << 16) - c) & 0xFFFF, c)
    hi = absc >> 8                      # 0..128 (128 only for NaR)
    lo = absc & 0xFF
    hic = torch.clamp(hi, max=127)
    b = l1b[esl][hic].to(torch.int64)
    sh = l1s[esl][hic].to(torch.int64)
    fast = _bits_to_f32((b | (lo << sh)) & _MASK32)
    slot = torch.clamp(-b - 1, 0, lo_tab.shape[1] - 1)
    slow = lo_tab[esl][slot, lo]
    v = torch.where(b >= 0, fast, slow)
    v = torch.where(neg, -v, v)
    nan = _bits_to_f32(torch.full_like(c, _NAN_BITS))
    return torch.where(c == (1 << 15), nan, v)


def lut_encode_p8(x: torch.Tensor, es, ftz: bool = False) -> torch.Tensor:
    """p8 encode by bucketizing against the rounding boundaries.

    RNE with exact ties to the even code; NaN/Inf -> NaR; +-0 -> 0; never
    round to zero below minpos (ftz=True: |x| <= minpos/2 -> 0, the ftz
    contract of ``posit_encode``). Returns uint8 codes.
    """
    codes_t, mids_t, tie_t = _device_tables("p8_encode", x.device, ftz)
    esl = _es(es)
    xf = x.to(torch.float32).contiguous()
    bits = _f32_to_bits(xf)
    a_bits = bits & 0x7FFFFFFF
    is_zero = a_bits == 0
    is_nar = a_bits >= 0x7F800000

    mids, tie_up, codes = mids_t[esl], tie_t[esl], codes_t[esl]
    n_mids = mids.shape[0]
    idx = torch.searchsorted(mids, xf.reshape(-1), side="left").reshape(xf.shape)
    i2 = torch.clamp(idx, max=n_mids - 1)
    tie = (idx < n_mids) & (mids[i2] == xf)
    idx = idx + (tie & tie_up[i2]).to(torch.int64)
    code = codes[idx]

    # below minpos by an exact integer compare of the bit patterns (a float
    # compare might see a subnormal as zero); minpos = 2^-(6 << es) is normal
    neg = (bits >> 31) == 1
    minpos_bits = (127 - (6 << esl)) << 23
    tiny = (~is_zero) & (a_bits < minpos_bits)
    sat = torch.where(neg, 0xFF, 1)
    if ftz:
        half_bits = minpos_bits - (1 << 23)
        code = torch.where(tiny, torch.where(a_bits <= half_bits, 0, sat), code)
    else:
        code = torch.where(tiny, sat, code)
    code = torch.where(is_zero, 0, code)
    return torch.where(is_nar, 0x80, code).to(torch.uint8)


# =====================================================================
# implementation choice: the codec_impl knob
# =====================================================================

def resolve_codec_impl(impl: str, nbits: int = 8, op: str = "decode",
                       device_type: str = "cpu") -> str:
    """'auto' -> a concrete implementation for (op, format, device type).

    'auto' takes the tables only for the p8 decode on a device that gathers
    well (both CPU and CUDA); the p16 split-table decode and the p8
    bucketize encode lose to the pipeline, so 'auto' keeps 'bits' for them.
    'lut' forces the tables wherever they exist.
    """
    if impl not in CODEC_IMPLS:
        raise ValueError(f"codec_impl must be one of {CODEC_IMPLS}, got {impl!r}")
    if impl == "auto":
        if op == "decode" and nbits == 8 and device_type in _GATHER_FRIENDLY:
            return "lut"
        return "bits"
    return impl


def decode_with_impl(codes: torch.Tensor, nbits: int, es, impl: str = "auto") -> torch.Tensor:
    """posit -> f32 through the chosen implementation (the same bits either way)."""
    if resolve_codec_impl(impl, nbits, "decode", codes.device.type) == "lut":
        return lut_decode_p8(codes, es) if nbits == 8 else lut_decode_p16(codes, es)
    return posit_decode(codes, nbits, es)


def encode_with_impl(x: torch.Tensor, nbits: int, es, impl: str = "auto",
                     ftz: bool = False) -> torch.Tensor:
    """f32 -> posit through the chosen implementation. The bucketize path
    exists for p8 only; p16 always takes the bit pipeline."""
    if nbits == 8 and resolve_codec_impl(impl, nbits, "encode", x.device.type) == "lut":
        return lut_encode_p8(x, es, ftz=ftz)
    return posit_encode(x, nbits, es, ftz=ftz)
