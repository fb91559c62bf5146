"""Front door for posit-KV decode attention: the CUDA kernel for CUDA tensors,
the plain version (``ref.py``) for CPU tensors.

``kv_bits=0`` means a float KV cache (f32 or bf16): the codec is bypassed.
``rolling=True`` is circular-buffer validity: every slot written so far is
valid, so lengths clamp to the buffer size.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build, check_rc, on_cpu, require, stream_handle
from repro_torch.kernels.posit_attention import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "posit_attention_launch": (_P,) * 5 + (_I,) * 7 + (ctypes.c_float, _P),
}
_KV_KIND = {(8, torch.uint8): 2, (16, torch.uint16): 3,
            (0, torch.float32): 0, (0, torch.bfloat16): 1}
MAX_HEAD_DIM = 128
MAX_HEADS_PER_KV = 8


def _lib():
    return build.load("posit_attention", _SIGNATURES)


def decode_attention(q: torch.Tensor, k_codes: torch.Tensor, v_codes: torch.Tensor,
                     lengths: torch.Tensor, es: int, *, kv_bits: int,
                     scale: Optional[float] = None, rolling: bool = False) -> torch.Tensor:
    """One decode-attention step. q (B, Hq, d) float32; k/v (B, Hkv, S, d);
    lengths (B,) int32 valid KV length per row. Returns (B, Hq, d)."""
    require(q.dim() == 3 and k_codes.dim() == 4 and k_codes.shape == v_codes.shape,
            f"shapes q {tuple(q.shape)}, k {tuple(k_codes.shape)}, v {tuple(v_codes.shape)}")
    B, Hq, d = q.shape
    Bk, Hkv, S, dk = k_codes.shape
    require((B, d) == (Bk, dk) and Hq % Hkv == 0,
            f"q {tuple(q.shape)} does not match KV {tuple(k_codes.shape)}")
    require(tuple(lengths.shape) == (B,), f"lengths must be ({B},)")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if rolling:
        lengths = torch.clamp(lengths, max=S)
    if on_cpu(q, k_codes, v_codes, lengths):
        return ref.posit_decode_attention_ref(q, k_codes, v_codes, lengths, es,
                                              kv_bits=kv_bits, scale=scale)
    kind = _KV_KIND.get((kv_bits, k_codes.dtype))
    require(kind is not None and v_codes.dtype == k_codes.dtype,
            f"kv_bits={kv_bits} does not take a {k_codes.dtype} cache")
    require(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    require(lengths.dtype == torch.int32, f"lengths must be int32, got {lengths.dtype}")
    require(d <= MAX_HEAD_DIM, f"head_dim {d} > {MAX_HEAD_DIM}")
    require(Hq // Hkv <= MAX_HEADS_PER_KV,
            f"{Hq // Hkv} q-heads per KV head > {MAX_HEADS_PER_KV}")
    for name, t in (("q", q), ("k", k_codes), ("v", v_codes), ("lengths", lengths)):
        require(t.is_contiguous(), f"{name} must be contiguous")
    out = torch.empty((B, Hq, d), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    rc = _lib().posit_attention_launch(
        q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), B, Hq, Hkv, S, d, kind, int(es), float(scale),
        stream_handle(q))
    check_rc(rc, "posit_attention")
    kernels.LAUNCHES["posit_attention"] += 1
    return out
