"""Front door for the posit softmax: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build, check_rc, on_cpu, require, stream_handle
from repro_torch.kernels.posit_softmax import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"posit_softmax_launch": (_P, _P) + (_I,) * 6 + (_P,)}
_CODE_DTYPE = {8: torch.uint8, 16: torch.uint16}
NARROW_MAX = 1024      # widest row a warp holds (32 values a lane)
MAX_CLUSTER = 16       # blocks per row (a non-portable cluster size on Hopper)
COLS_PER_BLOCK = 2048  # a wide row gets a block per this many columns, up to 16


def _lib():
    return build.load("posit_softmax", _SIGNATURES)


def row_plan(C: int) -> tuple[int, int]:
    """(cluster, chunk) of a row of C columns for csrc/posit_softmax.cu.

    cluster 0: a warp per row (C <= NARROW_MAX). Otherwise ``cluster`` blocks
    of one thread-block cluster split the row, block r owning columns
    [r * chunk, min(C, (r + 1) * chunk)).
    """
    if C <= NARROW_MAX:
        return 0, C
    cluster = min(MAX_CLUSTER, -(-C // COLS_PER_BLOCK))
    return cluster, -(-C // cluster)


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
    cluster, chunk = row_plan(C)
    rc = _lib().posit_softmax_launch(codes.data_ptr(), out.data_ptr(), R, C, nbits, int(es),
                                     cluster, chunk, stream_handle(codes))
    check_rc(rc, "posit_softmax")
    kernels.LAUNCHES["posit_softmax"] += 1
    return out
