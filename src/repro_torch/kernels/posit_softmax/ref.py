"""Plain-torch version of the posit softmax kernel."""
from __future__ import annotations

import torch

from repro_torch.core.codec import posit_decode, posit_encode


def posit_softmax_ref(codes: torch.Tensor, es: int, *, nbits: int) -> torch.Tensor:
    """Per row: decode, stable f32 softmax (exp(x - max) / sum), encode in
    the same format. A row holding NaR comes out all NaR."""
    x = posit_decode(codes, nbits, es)
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return posit_encode(p / p.sum(dim=-1, keepdim=True), nbits, es)
