"""Plain-torch versions of the streaming codec kernels, through the bit
pipeline or the tables (``codec_impl``, ``core/lut.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.lut import decode_with_impl, encode_with_impl


def decode_ref(codes: torch.Tensor, es: int, *, nbits: int,
               out_dtype: torch.dtype = torch.float32, codec_impl: str = "bits") -> torch.Tensor:
    return decode_with_impl(codes, nbits, es, codec_impl).to(out_dtype)


def encode_ref(x: torch.Tensor, es: int, *, nbits: int, ftz: bool = False,
               codec_impl: str = "bits") -> torch.Tensor:
    return encode_with_impl(x.to(torch.float32), nbits, es, codec_impl, ftz=ftz)
