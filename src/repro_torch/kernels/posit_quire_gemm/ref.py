"""Plain-torch version of the quire GEMM kernel (same exact math, untiled)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codec import posit_encode
from repro_torch.core.dot import apply_epilogue
from repro_torch.core.quire import quire_matmul
from repro_torch.core.types import Fmt, PositFmt


def posit_quire_gemm_ref(
    a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: PositFmt, b_fmt: PositFmt,
    out_fmt: Fmt,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
) -> torch.Tensor:
    """A posit ``out_fmt`` without an epilogue reads the quire out once into
    it; otherwise the exact sum rounds once into f32, the epilogue applies,
    and a posit ``out_fmt`` encodes the result (an F32 one returns it)."""
    es_a, es_b, es_out = (int(e) for e in es)
    wide = a_fmt if a_fmt.nbits >= b_fmt.nbits else b_fmt
    kw = dict(es_a=es_a, es_b=es_b, nbits_a=a_fmt.nbits, nbits_b=b_fmt.nbits)
    posit_out = isinstance(out_fmt, PositFmt)
    if posit_out and bias is None and activation == "none" and residual is None:
        return quire_matmul(a, b, wide, out_nbits=out_fmt.nbits, es_out=es_out, **kw)
    y = quire_matmul(a, b, wide, as_float=True, **kw)
    y = apply_epilogue(y, bias, activation, residual)
    if posit_out:
        return posit_encode(y, out_fmt.nbits, es_out)
    return y
