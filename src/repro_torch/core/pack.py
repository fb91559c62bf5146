"""Packed posit-8 lanes: two p8 codes per 16-bit word, split-K layout.

For a (K, N) weight matrix with half-K ``Kh = ceil(K/2)``:

    packed[r, c] = codes[r, c]  |  codes[r + Kh, c] << 8        (r < Kh)

The low byte carries row ``r``, the high byte row ``r + Kh``; an odd K pads
one zero row (0-codes decode to 0.0 and add nothing). Lane extraction gives
two contiguous (Kh, N) halves, so a GEMM becomes

    A @ decode(packed) == A[:, :Kh] @ decode(lo) + A[:, Kh:] @ decode(hi)

Packing applies along the contraction axis of the last two dims; leading
(stacked-layer) batch dims pass through. The layout is the reference
package's ``core/pack.py``. On the H100 a packed p8 weight moves the same
bytes as an unpacked one (1 byte a code); only the word count halves.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lut import decode_with_impl


def packed_half_k(k: int) -> int:
    """Rows of the packed array for a K-row unpacked operand."""
    return (k + 1) // 2


def pack_p8(codes: torch.Tensor) -> torch.Tensor:
    """(..., K, N) uint8 p8 codes -> (..., ceil(K/2), N) uint16 packed lanes."""
    k = codes.shape[-2]
    kh = packed_half_k(k)
    lo = codes[..., :kh, :].to(torch.int32)
    hi = codes[..., kh:, :].to(torch.int32)
    if k % 2:  # zero-pad the missing high lane of the last row
        hi = F.pad(hi, (0, 0, 0, 1))
    return (lo | (hi << 8)).to(torch.uint16)


def unpack_p8(packed: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """Inverse of ``pack_p8``: (..., Kh, N) uint16 -> (..., K, N) uint8 codes.

    ``k`` trims the zero pad row of an odd-K pack (default: 2*Kh).
    """
    w = packed.to(torch.int32)
    out = torch.cat([(w & 0xFF).to(torch.uint8), (w >> 8).to(torch.uint8)], dim=-2)
    if k is not None:
        out = out[..., :k, :]
    return out


def packed_decode_p8(packed: torch.Tensor, es, *, codec_impl: str = "auto",
                     k: Optional[int] = None) -> torch.Tensor:
    """Decode both lanes of a packed array -> (..., K, N) f32: one byte
    extract per lane (``unpack_p8``), then the p8 decode through
    ``codec_impl``."""
    return decode_with_impl(unpack_p8(packed, k), 8, es, codec_impl)


def split_activations(x: torch.Tensor, kh: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Split the contraction axis of ``x`` (..., K) into the (lo, hi) halves
    matching a split-K packed weight: ``x_lo`` pairs with the low lanes
    (rows [0, Kh)), ``x_hi`` with the high lanes (rows [Kh, 2*Kh), zero-padded
    when K is odd)."""
    k = x.shape[-1]
    x_lo = x[..., :kh]
    x_hi = x[..., kh:]
    if k < 2 * kh:
        x_hi = F.pad(x_hi, (0, 2 * kh - k))
    return x_lo, x_hi
