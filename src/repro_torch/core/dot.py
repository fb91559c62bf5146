"""Posit GEMM front door: the epilogue contract, the format-pair plan, the
weights-only ``posit_matmul_wx`` every fused linear calls, ``posit_dot``'s
fused, unfused and quire dataflows, ``posit_gemv`` and ``posit_softmax``.

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


def _operand_fmt(t: torch.Tensor, fmt: Fmt) -> Fmt:
    """The slot a GEMM operand goes in as: a posit slot as it is, a float
    slot as the tensor's own float dtype (the kernel rounds it to the
    compute dtype, as the reference's ``astype`` does)."""
    return fmt if isinstance(fmt, PositFmt) else float_fmt(t.dtype)


def _es_of(es: Optional[int], fmt: Fmt) -> int:
    if es is not None:
        return int(es)
    return fmt.es if isinstance(fmt, PositFmt) else 0


def _unfused_operand(t: torch.Tensor, fmt: Fmt, es: int, compute_dtype: torch.dtype,
                     codec_impl: str) -> torch.Tensor:
    """The unfused dataflow's conversion pass: the whole operand decoded by
    the codec kernel into a float tensor of the compute dtype (the kernel
    writes bf16 by RNE, the same bits as a cast of its exact f32), or a
    float operand cast to it."""
    from repro_torch.kernels.posit_codec import ops as codec_ops

    if isinstance(fmt, PositFmt):
        return codec_ops.decode(t.contiguous(), es, nbits=fmt.nbits, out_dtype=compute_dtype,
                                codec_impl=codec_impl)
    return t.to(compute_dtype).contiguous()


def posit_dot(a: torch.Tensor, b: torch.Tensor, slots, *, es_a: Optional[int] = None,
              es_b: Optional[int] = None, es_out: Optional[int] = None,
              impl: Optional[str] = None, compute_dtype: Optional[torch.dtype] = None,
              dimension_numbers=None, bias: Optional[torch.Tensor] = None,
              activation: str = "none", residual: Optional[torch.Tensor] = None,
              epilogue: str = "fused") -> torch.Tensor:
    """(..., M, K) @ (K, N) with per-operand pcsr formats.

    a/b: float tensors, or uint8/uint16 posit codes per ``slots`` (a packed
    rs2 is (ceil(K/2), N) uint16 lanes). ``impl``: "fused" | "unfused" |
    "quire"; ``None`` defers to ``slots.dataflow``. ``es_a``/``es_b``/
    ``es_out`` override the slots' es; ``compute_dtype`` the format pair's
    (``format_pair_plan``).

    * **fused** (the paper's): one launch of the posit GEMM kernel; the
      operands decode inside it, the epilogue ``act(y + bias) + residual``
      runs on its f32 sums and a posit rd encodes on the way out.
    * **unfused** (the [7]-style baseline): the codec kernel decodes A and B
      into whole float tensors, the GEMM kernel multiplies the floats (f32
      out, no epilogue), then the epilogue and the encode kernel each take a
      pass of their own.
    * **quire**: every product accumulates exactly in the quire GEMM kernel
      and rounds once. rs1/rs2 must be posit; rd may be F32.
      ``epilogue="chained"`` reads the exact sum out into f32 and runs the
      epilogue and the encode as passes of their own.

    fused and unfused accumulate in f32 and give the same bits wherever the
    kernel's summation order is the same for both operand kinds.
    ``dimension_numbers`` (a general contraction) is not ported.
    """
    if dimension_numbers is not None:
        raise NotImplementedError(
            "posit_dot(dimension_numbers=...) is not ported: the port contracts "
            "(..., M, K) @ (K, N)")
    if impl is None:
        impl = slots.dataflow
    if impl not in ("fused", "unfused", "quire"):
        raise ValueError(f"impl must be fused|unfused|quire, got {impl}")
    if b.dim() != 2:
        raise NotImplementedError(
            f"posit_dot contracts (..., M, K) @ (K, N), got B of shape {tuple(b.shape)}")
    if a.dim() < 2:
        raise ValueError(f"posit_dot needs A of shape (..., M, K), got {tuple(a.shape)}")
    lead, K = a.shape[:-1], a.shape[-1]
    N = b.shape[-1]
    a2 = a.reshape(-1, K)
    res = None
    if residual is not None:
        res = residual.expand(*lead, N).reshape(-1, N).to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if impl == "quire":
        y = _quire_dot(a2.contiguous(), b.contiguous(), slots, es_a, es_b, es_out, bias,
                       activation, res, epilogue)
        return y.reshape(*lead, N)
    from repro_torch.kernels.posit_gemm.ops import posit_gemm

    rs1 = _operand_fmt(a2, slots.rs1)
    rs2 = _operand_fmt(b, slots.rs2)
    if compute_dtype is None:
        compute_dtype = format_pair_plan(slots.rs1, slots.rs2,
                                         packed_b=slots.rs2_packed).compute_dtype
    ea, eb, eo = _es_of(es_a, slots.rs1), _es_of(es_b, slots.rs2), _es_of(es_out, slots.rd)
    rd = slots.rd if isinstance(slots.rd, PositFmt) else float_fmt(compute_dtype_for(slots.rd))
    if impl == "fused":
        y = posit_gemm(a2.contiguous(), b.contiguous(), (ea, eb, eo),
                       a_fmt=rs1, b_fmt=rs2, out_fmt=rd, bias=bias, residual=res,
                       activation=activation, compute_dtype=compute_dtype,
                       b_packed=slots.rs2_packed, codec_impl=slots.codec_impl)
        return y.reshape(*lead, N)
    from repro_torch.core.pack import unpack_p8
    from repro_torch.kernels.posit_codec import ops as codec_ops

    bb = unpack_p8(b, K).contiguous() if slots.rs2_packed else b
    af = _unfused_operand(a2, slots.rs1, ea, compute_dtype, slots.codec_impl)
    bf = _unfused_operand(bb, slots.rs2, eb, compute_dtype, slots.codec_impl)
    cf = float_fmt(compute_dtype)
    y = posit_gemm(af, bf, (0, 0, 0), a_fmt=cf, b_fmt=cf, out_fmt=F32,
                   compute_dtype=compute_dtype)
    if bias is not None or activation != "none" or res is not None:
        y = apply_epilogue(y, bias, activation, res)
    if isinstance(slots.rd, PositFmt):
        y = codec_ops.encode(y.contiguous(), eo, nbits=slots.rd.nbits,
                             codec_impl=slots.codec_impl)
    else:
        y = y.to(rd.dtype)
    return y.reshape(*lead, N)


def _quire_dot(a, b, slots, es_a, es_b, es_out, bias, activation, residual,
               epilogue) -> torch.Tensor:
    """``posit_dot``'s quire dataflow on 2-D operands: the quire GEMM kernel
    (a packed rs2 is split into p8 codes first). rs1/rs2 must be posit
    (float inputs have no exact quire representation); rd may be F32, read
    out by one RNE of the exact sum (the layer-level contract: no
    accumulation rounding, no float matmul)."""
    from repro_torch.kernels.posit_quire_gemm.ops import quire_gemm

    has_epilogue = bias is not None or activation != "none" or residual is not None
    if epilogue != "chained" or not has_epilogue:
        return quire_gemm(a, b, slots, es_a=es_a, es_b=es_b, es_out=es_out, bias=bias,
                          activation=activation, residual=residual)
    y = quire_gemm(a, b, dataclasses.replace(slots, rd=F32), es_a=es_a, es_b=es_b)
    y = apply_epilogue(y, bias, activation, residual)
    if isinstance(slots.rd, PositFmt):
        from repro_torch.kernels.posit_codec import ops as codec_ops

        return codec_ops.encode(y.contiguous(), _es_of(es_out, slots.rd),
                                nbits=slots.rd.nbits, codec_impl=slots.codec_impl)
    return y.to(slots.rd.dtype)


def posit_gemv(A: torch.Tensor, x: torch.Tensor, slots, *, impl: str = "fused") -> torch.Tensor:
    """A (..., M, K) @ x (K,) -> (..., M), the paper's section IV-C GEMV:
    ``posit_dot`` with x as a one-column B (N = 1)."""
    return posit_dot(A, x[..., None], slots, impl=impl)[..., 0]


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
