"""Posit GEMM front door: the epilogue contract, the format-pair plan, the
weights-only ``posit_matmul_wx`` every fused linear calls, ``posit_dot``'s
quire dataflow and ``posit_softmax``.

Each goes through a kernel wrapper (``kernels.<name>.ops``): the
hand-written kernel for CUDA tensors, its plain version for CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.types import BF16, F32, Fmt, FloatFmt, PositFmt, compute_dtype_for

# Activations a fused epilogue can apply. gelu is the tanh approximation,
# the reference's default.
ACTIVATIONS = ("none", "gelu", "silu", "relu")


def _apply_activation(y: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "none":
        return y
    if activation == "gelu":
        return F.gelu(y, approximate="tanh")
    if activation == "silu":
        return F.silu(y)
    if activation == "relu":
        return F.relu(y)
    raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")


def apply_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                   activation: str, residual: Optional[torch.Tensor]) -> torch.Tensor:
    """The GEMM epilogue contract: ``act(y + bias) + residual``, in f32.

    Each stage is a torch op of its own, materialized as it runs, which is
    what the reference's ``chained=True`` forces with barriers: the
    ``epilogue="chained"`` baseline calls this after a GEMM without
    epilogue, where the fused form runs it inside the kernel.
    """
    y = y.to(torch.float32)
    if bias is not None:
        y = y + bias.to(torch.float32)
    y = _apply_activation(y, activation)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y


@dataclasses.dataclass(frozen=True)
class FormatPlan:
    """Resolved dispatch plan for one (rs1, rs2) format pair.

    The compute dtype is the lossless-decode meet of the two operands: bf16
    only when both decode exactly into bf16, else f32.
    """

    compute_dtype: torch.dtype
    decode_a: bool
    decode_b: bool
    packed_b: bool     # B arrives as packed uint16 p8 lanes (core/pack.py)
    encode_out: bool


def format_pair_plan(a_fmt: Fmt, b_fmt: Fmt, out_fmt: Fmt = F32, *,
                     packed_b: bool = False) -> FormatPlan:
    """A packed B decodes both lanes and is otherwise p8: packing changes
    the words moved, never the numerics."""
    if packed_b and not (isinstance(b_fmt, PositFmt) and b_fmt.nbits == 8):
        raise ValueError(f"packed B requires p8, got {b_fmt}")
    ca, cb = compute_dtype_for(a_fmt), compute_dtype_for(b_fmt)
    return FormatPlan(
        compute_dtype=ca if ca == cb else torch.float32,
        decode_a=isinstance(a_fmt, PositFmt),
        decode_b=isinstance(b_fmt, PositFmt),
        packed_b=packed_b,
        encode_out=isinstance(out_fmt, PositFmt),
    )


def float_fmt(dtype: torch.dtype) -> FloatFmt:
    """The float pcsr slot that stores ``dtype``."""
    return {torch.float32: F32, torch.bfloat16: BF16}[dtype]


def posit_matmul_wx(
    x: torch.Tensor,
    w_codes: torch.Tensor,
    w_fmt: PositFmt,
    *,
    es: Optional[int] = None,
    compute_dtype: Optional[torch.dtype] = None,
    out_dtype: Optional[torch.dtype] = None,
    bias: Optional[torch.Tensor] = None,
    activation: str = "none",
    residual: Optional[torch.Tensor] = None,
    out_fmt: Optional[PositFmt] = None,
    es_out: Optional[int] = None,
    codec_impl: str = "auto",
    epilogue: str = "fused",
    packed: bool = False,
) -> torch.Tensor:
    """x @ decode(W) with the fused epilogue, the weights-only linear path.

    x: (..., K) float; w_codes: (K, N) posit codes, or with ``packed=True``
    (ceil(K/2), N) uint16 packed p8 lanes (core/pack.py, the same numerics);
    bias (N,); residual of the output's shape. Output float (..., N) in
    ``out_dtype`` (default x.dtype), or posit codes when ``out_fmt`` is given.
    ``epilogue="chained"`` is the materialize-every-stage baseline: the
    weight decodes whole (the codec kernel), a GEMM without epilogue runs on
    the decoded weight, then bias, activation, residual and the encode each
    take a pass of their own. ``codec_impl`` picks the plain version's codec
    on the CPU; the kernels decode with their own tables (the same bits).
    """
    from repro_torch.kernels.posit_gemm.ops import posit_gemm

    if packed and w_fmt.nbits != 8:
        raise ValueError(f"packed weights require p8, got {w_fmt}")
    if epilogue not in ("fused", "chained"):
        raise ValueError(f"epilogue must be fused or chained, got {epilogue!r}")
    if compute_dtype is None:
        compute_dtype = compute_dtype_for(w_fmt)
    e = w_fmt.es if es is None else es
    K = x.shape[-1]
    N = w_codes.shape[-1]
    lead = x.shape[:-1]
    # the kernel rounds A to the compute dtype as it stages it (a separate
    # cast would be one more launch per linear)
    a = x.reshape(-1, K).contiguous()
    res = None if residual is None else residual.reshape(-1, N).contiguous()
    if out_fmt is not None:
        ofmt = out_fmt
    else:
        ofmt = float_fmt(out_dtype if out_dtype is not None else x.dtype)
    e_out = 0 if out_fmt is None else (out_fmt.es if es_out is None else es_out)
    if epilogue == "chained":
        y = _chained_matmul(a, w_codes, w_fmt, e, compute_dtype, codec_impl, packed)
        y = apply_epilogue(y, bias, activation, res)
        if out_fmt is not None:
            from repro_torch.kernels.posit_codec import ops as codec_ops

            y = codec_ops.encode(y.contiguous(), e_out, nbits=out_fmt.nbits,
                                 codec_impl=codec_impl)
        else:
            y = y.to(ofmt.dtype)
        return y.reshape(*lead, N)
    y = posit_gemm(
        a, w_codes, (0, e, e_out),
        a_fmt=float_fmt(x.dtype), b_fmt=w_fmt, out_fmt=ofmt,
        bias=bias, residual=res, activation=activation,
        compute_dtype=compute_dtype, b_packed=packed, codec_impl=codec_impl)
    return y.reshape(*lead, N)


def _chained_matmul(a: torch.Tensor, w_codes: torch.Tensor, w_fmt: PositFmt, es: int,
                    compute_dtype: torch.dtype, codec_impl: str, packed: bool) -> torch.Tensor:
    """The chained baseline's first two passes: decode the whole weight into
    the compute dtype (the codec kernel; packed lanes are split first), then
    the GEMM kernel on that float weight, f32 out, no epilogue."""
    from repro_torch.core.pack import unpack_p8
    from repro_torch.kernels.posit_codec import ops as codec_ops
    from repro_torch.kernels.posit_gemm.ops import posit_gemm

    codes = unpack_p8(w_codes, a.shape[1]).contiguous() if packed else w_codes
    wf = codec_ops.decode(codes, es, nbits=w_fmt.nbits, codec_impl=codec_impl)
    wf = wf.to(compute_dtype).contiguous()
    return posit_gemm(a, wf, (0, 0, 0), a_fmt=float_fmt(a.dtype),
                      b_fmt=float_fmt(compute_dtype), out_fmt=F32,
                      compute_dtype=compute_dtype)


def posit_dot(a: torch.Tensor, b: torch.Tensor, slots, *, es_b: Optional[int] = None,
              bias: Optional[torch.Tensor] = None, activation: str = "none",
              residual: Optional[torch.Tensor] = None,
              epilogue: str = "fused") -> torch.Tensor:
    """(M, K) @ (K, N) with per-operand pcsr formats and the fused epilogue.

    ``slots.dataflow == "quire"`` accumulates exactly through the quire GEMM
    kernel (a packed rs2 is split into p8 codes first). rs1/rs2 must be
    posit (float inputs have no exact quire representation); rd may be F32,
    read out by one RNE of the exact sum (the layer-level contract: no
    accumulation rounding, no float matmul). ``epilogue="chained"`` reads
    the exact sum out into f32 and runs the epilogue and the encode as
    passes of their own. The fused and unfused dataflows of the reference's
    ``posit_dot`` are reached in the port through ``posit_matmul_wx`` and
    ``kernels.posit_gemm.ops.gemm`` instead.
    """
    if slots.dataflow != "quire":
        raise NotImplementedError(
            f"posit_dot(dataflow={slots.dataflow!r}) is not ported: use "
            "posit_matmul_wx or kernels.posit_gemm.ops.gemm")
    from repro_torch.kernels.posit_quire_gemm.ops import quire_gemm

    has_epilogue = bias is not None or activation != "none" or residual is not None
    if epilogue != "chained" or not has_epilogue:
        return quire_gemm(a, b, slots, es_b=es_b, bias=bias, activation=activation,
                          residual=residual)
    y = quire_gemm(a, b, dataclasses.replace(slots, rd=F32), es_b=es_b)
    y = apply_epilogue(y, bias, activation, residual)
    if isinstance(slots.rd, PositFmt):
        from repro_torch.kernels.posit_codec import ops as codec_ops

        return codec_ops.encode(y.contiguous(), slots.rd.es, nbits=slots.rd.nbits,
                                codec_impl=slots.codec_impl)
    return y.to(slots.rd.dtype)


def posit_softmax(codes: torch.Tensor, fmt: PositFmt, *, es: Optional[int] = None,
                  axis: int = -1) -> torch.Tensor:
    """softmax over posit-stored logits, result re-encoded (paper §IV-C),
    through the posit softmax kernel's front door."""
    from repro_torch.kernels.posit_softmax.ops import softmax

    x = codes.movedim(axis, -1)
    shape = x.shape
    y = softmax(x.reshape(-1, shape[-1]).contiguous(), fmt.es if es is None else es,
                nbits=fmt.nbits)
    return y.reshape(shape).movedim(-1, axis)
