"""Table I: the paper's custom fcvt.* conversion ops.

Three instruction families, each with an ``es`` field (a Python int here,
clamped to [0, 3]):

  fcvt.p8.s   / fcvt.p16.s    : FP32  -> P8/P16      -> fcvt_p8_s,  fcvt_p16_s
  fcvt.s.p8   / fcvt.s.p16    : P8/P16 -> FP32       -> fcvt_s_p8,  fcvt_s_p16
  fcvt.p8.p8  / fcvt.p8.p16   : posit -> posit       -> fcvt_p8_p8, fcvt_p8_p16
  fcvt.p16.p8 / fcvt.p16.p16    (cross precision/es)   fcvt_p16_p8, fcvt_p16_p16

Every op goes through the codec's front door (``kernels.posit_codec.ops``):
the codec kernel on a CUDA tensor, its plain version on a CPU tensor.
posit -> posit passes through the f32 datapath: the decode is exact, so there
is exactly one rounding, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.posit_codec import ops as codec_ops

__all__ = [
    "fcvt_p8_s", "fcvt_p16_s", "fcvt_s_p8", "fcvt_s_p16",
    "fcvt_p8_p8", "fcvt_p8_p16", "fcvt_p16_p8", "fcvt_p16_p16",
]


def _encode(x: torch.Tensor, nbits: int, es: int) -> torch.Tensor:
    return codec_ops.encode(x.to(torch.float32).contiguous(), es, nbits=nbits)


def _decode(codes: torch.Tensor, nbits: int, es: int) -> torch.Tensor:
    return codec_ops.decode(codes.contiguous(), es, nbits=nbits)


# ---- fcvt.pfmt.fmt : FP32 -> posit (funct5=0x10) --------------------------------

def fcvt_p8_s(x: torch.Tensor, es: int = 0) -> torch.Tensor:
    """FP32 -> P(8, es)."""
    return _encode(x, 8, es)


def fcvt_p16_s(x: torch.Tensor, es: int = 1) -> torch.Tensor:
    """FP32 -> P(16, es)."""
    return _encode(x, 16, es)


# ---- fcvt.fmt.pfmt : posit -> FP32 (funct5=0x12) --------------------------------

def fcvt_s_p8(codes: torch.Tensor, es: int = 0) -> torch.Tensor:
    """P(8, es) -> FP32 (exact)."""
    return _decode(codes, 8, es)


def fcvt_s_p16(codes: torch.Tensor, es: int = 1) -> torch.Tensor:
    """P(16, es) -> FP32 (exact)."""
    return _decode(codes, 16, es)


# ---- fcvt.pfmt.pfmt : posit -> posit (funct5=0x11) ------------------------------

def _pp(codes, n_in, es_in, n_out, es_out):
    return _encode(_decode(codes, n_in, es_in), n_out, es_out)


def fcvt_p8_p8(codes: torch.Tensor, es_in: int, es_out: int) -> torch.Tensor:
    """P(8, es_in) -> P(8, es_out): dynamic-es re-rounding within one precision."""
    return _pp(codes, 8, es_in, 8, es_out)


def fcvt_p8_p16(codes: torch.Tensor, es_in: int = 1, es_out: int = 0) -> torch.Tensor:
    """P(16, es_in) -> P(8, es_out). (rd is p8; rs1 is p16, the paper's naming order.)"""
    return _pp(codes, 16, es_in, 8, es_out)


def fcvt_p16_p8(codes: torch.Tensor, es_in: int = 0, es_out: int = 1) -> torch.Tensor:
    """P(8, es_in) -> P(16, es_out). Exact (p8 values are a subset of p16)."""
    return _pp(codes, 8, es_in, 16, es_out)


def fcvt_p16_p16(codes: torch.Tensor, es_in: int, es_out: int) -> torch.Tensor:
    """P(16, es_in) -> P(16, es_out)."""
    return _pp(codes, 16, es_in, 16, es_out)
