"""Plain-torch version of the fused posit GEMM kernel (untiled, same math)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codec import posit_decode, posit_encode
from repro_torch.core.dot import apply_epilogue, format_pair_plan
from repro_torch.core.types import Fmt, PositFmt


def posit_gemm_ref(
    a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: Fmt, b_fmt: Fmt, out_fmt: Fmt,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """decode, round both operands to the compute dtype, multiply with f32
    accumulation (bf16 products are exact in f32), epilogue, encode."""
    if compute_dtype is None:
        compute_dtype = format_pair_plan(a_fmt, b_fmt).compute_dtype
    es_a, es_b, es_out = (int(e) for e in es)
    af = posit_decode(a, a_fmt.nbits, es_a) if isinstance(a_fmt, PositFmt) else a
    bf = posit_decode(b, b_fmt.nbits, es_b) if isinstance(b_fmt, PositFmt) else b
    y = torch.matmul(af.to(compute_dtype).to(torch.float32),
                     bf.to(compute_dtype).to(torch.float32))
    if bias is not None or activation != "none" or residual is not None:
        y = apply_epilogue(y, bias, activation, residual)
    if isinstance(out_fmt, PositFmt):
        return posit_encode(y, out_fmt.nbits, es_out)
    return y.to(out_fmt.dtype)
