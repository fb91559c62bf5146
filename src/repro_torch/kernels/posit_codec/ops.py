"""Front door for the streaming codec: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors.

``codec_impl`` ("auto" | "lut" | "bits") picks the plain version's
implementation (``core/lut.py``); the kernel always runs its bit pipeline.
Both give the same bits."""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build, check_rc, on_cpu, require, stream_handle
from repro_torch.kernels.posit_codec import ref

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "posit_decode_launch": (_P, _P, _LL, _I, _I, _I, _P),
    "posit_encode_launch": (_P, _P, _LL, _I, _I, _I, _P),
}
_CODE_DTYPE = {8: torch.uint8, 16: torch.uint16}


def _lib():
    return build.load("posit_codec", _SIGNATURES)


def decode(codes: torch.Tensor, es: int, *, nbits: int,
           out_dtype: torch.dtype = torch.float32, codec_impl: str = "bits") -> torch.Tensor:
    """posit codes (any shape) -> float tensor of the same shape."""
    require(nbits in (8, 16), f"nbits must be 8 or 16, got {nbits}")
    require(out_dtype in (torch.float32, torch.bfloat16),
            f"decode writes float32 or bfloat16, got {out_dtype}")
    if on_cpu(codes):
        return ref.decode_ref(codes, es, nbits=nbits, out_dtype=out_dtype,
                              codec_impl=codec_impl)
    require(codes.dtype == _CODE_DTYPE[nbits],
            f"p{nbits} codes must be {_CODE_DTYPE[nbits]}, got {codes.dtype}")
    require(codes.is_contiguous(), "decode needs contiguous codes")
    out = torch.empty(codes.shape, dtype=out_dtype, device=codes.device)
    if codes.numel() == 0:
        return out
    rc = _lib().posit_decode_launch(
        codes.data_ptr(), out.data_ptr(), codes.numel(), nbits, int(es),
        int(out_dtype == torch.bfloat16), stream_handle(codes))
    check_rc(rc, "posit_decode")
    kernels.LAUNCHES["posit_decode"] += 1
    return out


def encode(x: torch.Tensor, es: int, *, nbits: int, ftz: bool = False,
           codec_impl: str = "bits") -> torch.Tensor:
    """float32 tensor (any shape) -> posit codes of the same shape."""
    require(nbits in (8, 16), f"nbits must be 8 or 16, got {nbits}")
    if on_cpu(x):
        return ref.encode_ref(x, es, nbits=nbits, ftz=ftz, codec_impl=codec_impl)
    require(x.dtype == torch.float32, f"encode reads float32, got {x.dtype}")
    require(x.is_contiguous(), "encode needs a contiguous input")
    out = torch.empty(x.shape, dtype=_CODE_DTYPE[nbits], device=x.device)
    if x.numel() == 0:
        return out
    rc = _lib().posit_encode_launch(
        x.data_ptr(), out.data_ptr(), x.numel(), nbits, int(es), int(ftz),
        stream_handle(x))
    check_rc(rc, "posit_encode")
    kernels.LAUNCHES["posit_encode"] += 1
    return out
