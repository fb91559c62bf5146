"""Front door for the posit softmax: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build, check_rc, on_cpu, require, stream_handle
from repro_torch.kernels.posit_softmax import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"posit_softmax_launch": (_P, _P, _I, _I, _I, _I, _P)}
_CODE_DTYPE = {8: torch.uint8, 16: torch.uint16}


def _lib():
    return build.load("posit_softmax", _SIGNATURES)


def softmax(codes: torch.Tensor, es: int, *, nbits: int) -> torch.Tensor:
    """(R, C) posit codes -> (R, C) codes of softmax over each row."""
    require(nbits in (8, 16), f"nbits must be 8 or 16, got {nbits}")
    require(codes.dim() == 2, f"softmax takes (rows, columns) codes, got {tuple(codes.shape)}")
    if on_cpu(codes):
        return ref.posit_softmax_ref(codes, int(es), nbits=nbits)
    require(codes.dtype == _CODE_DTYPE[nbits],
            f"p{nbits} codes must be {_CODE_DTYPE[nbits]}, got {codes.dtype}")
    require(codes.is_contiguous(), "softmax needs contiguous codes")
    out = torch.empty_like(codes)
    R, C = codes.shape
    if R == 0 or C == 0:
        return out
    rc = _lib().posit_softmax_launch(codes.data_ptr(), out.data_ptr(), R, C, nbits, int(es),
                                     stream_handle(codes))
    check_rc(rc, "posit_softmax")
    kernels.LAUNCHES["posit_softmax"] += 1
    return out
