"""Plain-torch version of the fused posit GEMM kernel (untiled, same math)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codec import (_M32, _bits_to_f32, _f32_to_bits, _regime, posit_decode,
                                    posit_encode)
from repro_torch.core.dot import apply_epilogue, format_pair_plan
from repro_torch.core.lut import decode_with_impl
from repro_torch.core.pack import split_activations, unpack_p8
from repro_torch.core.types import Fmt, PositFmt


def posit_gemm_ref(
    a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: Fmt, b_fmt: Fmt, out_fmt: Fmt,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
    b_packed: bool = False,
    codec_impl: str = "auto",
) -> torch.Tensor:
    """decode, round both operands to the compute dtype, multiply with f32
    accumulation (bf16 products are exact in f32), epilogue, encode.

    A packed B ((ceil(K/2), N) uint16 lanes) takes the kernel's two
    contractions: A's low half against the low lanes plus A's high half
    (zero-padded for odd K) against the high lanes. ``codec_impl`` picks
    B's decode (the same bits either way)."""
    if compute_dtype is None:
        compute_dtype = format_pair_plan(a_fmt, b_fmt, packed_b=b_packed).compute_dtype
    es_a, es_b, es_out = (int(e) for e in es)
    af = posit_decode(a, a_fmt.nbits, es_a) if isinstance(a_fmt, PositFmt) else a
    af = af.to(compute_dtype).to(torch.float32)

    def dec_b(codes):
        bf = decode_with_impl(codes, b_fmt.nbits, es_b, codec_impl) \
            if isinstance(b_fmt, PositFmt) else codes
        return bf.to(compute_dtype).to(torch.float32)

    if b_packed:
        kh = b.shape[0]
        lanes = unpack_p8(b)
        a_lo, a_hi = split_activations(af, kh)
        y = torch.matmul(a_lo, dec_b(lanes[:kh])) + torch.matmul(a_hi, dec_b(lanes[kh:]))
    else:
        y = torch.matmul(af, dec_b(b))
    if bias is not None or activation != "none" or residual is not None:
        y = apply_epilogue(y, bias, activation, residual)
    if isinstance(out_fmt, PositFmt):
        return posit_encode(y, out_fmt.nbits, es_out)
    return y.to(out_fmt.dtype)


# The kernel's p16 class table (csrc/posit_gemm.cu ``fill_p16_table`` and
# ``p16_magnitude``): 257 first-level rows (a >> 7, NaR's 256) of one word
# T + sh, one copy a lane, and a second level of one word per code of rows 0
# and 255.
P16_RARE = 0x20


def _p16_word(a: torch.Tensor, es: int) -> torch.Tensor:
    """``p16_word``: T + sh of magnitude codes ``a`` (int64, 0 .. 0x8000),
    T = bits(decode(a)) - (a << sh) mod 2^32, sh = 9 + m + es."""
    m, _ = _regime(a, 16)
    sh = 9 + m + es
    t = (_f32_to_bits(posit_decode(a, 16, es)) - ((a << sh) & _M32)) & _M32
    return torch.where(a == 0x8000, torch.full_like(a, 0x7FC00000 + 16), t + sh)


def p16_table_words(es: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(first level (257 * 32,) int64, word r * 32 + lane; second level
    (256,)): the words the kernel fills its shared-memory table with."""
    rows = torch.arange(257, dtype=torch.int64)
    l1 = torch.where((rows == 0) | (rows == 255), torch.full_like(rows, P16_RARE),
                     _p16_word(rows << 7, es))
    i = torch.arange(256, dtype=torch.int64)
    return l1.repeat_interleave(32), _p16_word(torch.where(i < 128, i, 0x7F00 + i), es)


def _p16_table_magnitude(codes: torch.Tensor, es: int) -> torch.Tensor:
    """``p16_magnitude`` on p16 codes (any integer dtype), each read by lane
    ``index % 32``: the f32 bits of the magnitude, int64."""
    l1, l2 = p16_table_words(es)
    c = codes.to(torch.int64) & 0xFFFF
    a = torch.where(c >= 0x8000, 0x10000 - c, c)            # abs of the sign-extended code
    lane4 = (torch.arange(c.numel(), dtype=torch.int64) % 32).reshape(c.shape) * 4
    t = l1[((a & 0xFF80) | lane4) >> 2]                      # the kernel's byte offset / 4
    t = torch.where((t & P16_RARE) != 0, l2[a & 0xFF], t)
    return ((t & ~0x1F) + ((a << (t & 31)) & _M32)) & _M32


def p16_table_decode(codes: torch.Tensor, es, bf16: bool = False) -> torch.Tensor:
    """The kernel's p16 decode, emulated: f32 (``p16_f32``; NaR 0x7FC00000),
    or bf16 as ``p16_bf16x2`` makes it from a uint32 of two codes: the RNE
    of each exact magnitude, then the codes' signs (NaR: a NaN)."""
    es = min(max(int(es), 0), 3)
    c = codes.to(torch.int64) & 0xFFFF
    mag = _p16_table_magnitude(c, es)
    if not bf16:
        return _bits_to_f32(mag ^ ((c >> 15) << 31))
    flat, mflat = c.reshape(-1), mag.reshape(-1)
    if flat.numel() % 2:                                     # a half-filled last word
        flat = torch.cat([flat, flat.new_zeros(1)])
        mflat = torch.cat([mflat, mflat.new_zeros(1)])
    half = _bits_to_f32(mflat).to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    word = flat[0::2] | (flat[1::2] << 16)
    packed = (half[0::2] | (half[1::2] << 16)) ^ (word & 0x80008000)
    out = torch.stack([packed & 0xFFFF, packed >> 16], dim=1).reshape(-1)[:c.numel()]
    out = torch.where(out >= 0x8000, out - 0x10000, out)
    return out.to(torch.int16).view(torch.bfloat16).reshape(c.shape)
