"""Plain-torch version of the fused posit GEMM kernel (untiled, same math)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codec import posit_decode, posit_encode
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
