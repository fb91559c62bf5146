"""Plain-torch versions of the streaming codec kernels."""
from __future__ import annotations

import torch

from repro_torch.core.codec import posit_decode, posit_encode


def decode_ref(codes: torch.Tensor, es: int, *, nbits: int,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return posit_decode(codes, nbits, es).to(out_dtype)


def encode_ref(x: torch.Tensor, es: int, *, nbits: int, ftz: bool = False) -> torch.Tensor:
    return posit_encode(x.to(torch.float32), nbits, es, ftz=ftz)
