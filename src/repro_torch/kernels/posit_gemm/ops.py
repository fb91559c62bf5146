"""Front door for the fused posit GEMM: the CUDA kernel for CUDA tensors, the
plain version (``ref.py``) for CPU tensors.

B may arrive as packed p8 lanes (``b_packed``, core/pack.py): (ceil(K/2), N)
uint16, two codes a word. The kernel's packed variants walk the packed rows
and split each word into its two codes; their launches count under
``posit_gemm_packed`` (tensor cores) and ``posit_gemm_packed_fma`` (f32
FMA). p16 weights on the tensor cores (bf16 compute, decoded through the
kernel's class table) count under ``posit_gemm_p16``; every other launch of
the unpacked kernel under ``posit_gemm``.

Above ``LARGE_M`` rows (long prefills, training) a GEMM whose shape the
large-M kernels take (``large_shape_ok``) goes to csrc/posit_gemm_large.cu
instead: the ``wgmma`` kernel for the tensor-core pairs
(``posit_gemm_large_tc``; a posit B is decoded to bf16 once for the call)
and the 128 x 128 f32-FMA tile for the rest (``posit_gemm_large_fma``),
whatever the B kind. From 9 to ``MID_M`` rows the tensor-core pairs take
csrc/posit_gemm_mid.cu (``posit_gemm_mid_tc``, every B kind: ``wgmma`` with
the weights decoded into register fragments) where its copies take the shape
(``mid_shape_ok``); the 64-row tile of csrc/posit_gemm.cu keeps the rest.
``gemm_route`` is the choice.

``float_linear`` is the float-weight linear as autograd sees it: the kernel
in the forward, plain products in the backward."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.core.dot import ACTIVATIONS, _apply_activation, float_fmt, format_pair_plan
from repro_torch.core.pcsr import OperandSlots
from repro_torch.core.types import BF16, F32, Fmt, PositFmt
from repro_torch.kernels import build, check_rc, on_cpu, require, stream_handle
from repro_torch.kernels.posit_gemm import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "posit_gemm_launch": (_P,) * 7 + (_I,) * 13 + (_P,),
}
_LARGE_SIGNATURES = {
    "posit_gemm_large_launch": (_P,) * 8 + (_I,) * 13 + (_P,),
}
_MID_SIGNATURES = {
    "posit_gemm_mid_launch": (_P,) * 8 + (_I,) * 11 + (_P,),
}
# Tile of the tensor-core kernel (csrc/posit_gemm.cu kTcBN, kTcBK): 128
# output columns, 64 k rows a pipeline stage; 8 rows for M <= 8, else 64.
TC_COLS, TC_STEP = 128, 64
_ACT = {a: i for i, a in enumerate(ACTIVATIONS)}


# Rows above which a GEMM takes the large-M kernels (PERF.md: the crossover
# sweep); decode batches and 64-token prefills keep the tiles above.
LARGE_M = 64
# Tiles of the large-M kernels (csrc/posit_gemm_large.cu): tensor cores 128
# rows x 256 columns, 64-row k blocks of B; f32 FMA 128 x 128, 8-row stages.
LARGE_TC_ROWS, LARGE_TC_COLS, LARGE_TC_STEP = 128, 256, 64
LARGE_FMA_TILE, LARGE_FMA_STEP = 128, 8
# The mid-M kernel (csrc/posit_gemm_mid.cu): 9..MID_M rows, 128-column
# tiles, 64 rows of B (packed rows for a packed B) a k step, 256 consumer
# threads a block.
MID_M = 64
MID_COLS, MID_STEP, MID_THREADS = 128, 64, 256


def _lib():
    return build.load("posit_gemm", _SIGNATURES)


def _large_lib():
    return build.load("posit_gemm_large", _LARGE_SIGNATURES)


def _mid_lib():
    return build.load("posit_gemm_mid", _MID_SIGNATURES)


# Storage kind of a packed p8 B operand, two codes a uint16 (csrc/posit_gemm.cu kP8x2)
PACKED_KIND = 4


def _kind(fmt: Fmt, packed: bool = False) -> tuple[int, torch.dtype]:
    """(storage kind of csrc/posit_codec.cuh, torch dtype) of a pcsr slot."""
    if packed:
        return PACKED_KIND, torch.uint16
    if isinstance(fmt, PositFmt):
        return (2 if fmt.nbits == 8 else 3), fmt.storage_dtype
    require(fmt in (F32, BF16), f"the GEMM kernel takes f32/bf16 float slots, got {fmt}")
    return (0 if fmt == F32 else 1), fmt.dtype


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def uses_tensor_cores(a_kind: int, b_kind: int, bf16_compute: bool) -> bool:
    """The pairs the kernel computes on bf16 tensor cores: bf16 compute, B as p8
    (packed or not), p16 or bf16 codes, A as f32, bf16 or p8
    (``posit_gemm_launch`` in csrc/posit_gemm.cu makes the same choice). Other
    pairs take the f32 FMA kernels."""
    return bf16_compute and b_kind in (1, 2, 3, PACKED_KIND) and a_kind in (0, 1, 2)


def large_shape_ok(N: int, K: int) -> bool:
    """The shapes the large-M kernels take, whatever the B kind: their copies
    need N to be a multiple of 16 (16-byte pieces of a row of p8 codes) and
    K of 8 (A's bf16 rows 16-byte aligned for the TMA; a packed B's high
    slice of A, at column K / 2, aligned for the f32-FMA tile's vector
    loads); ``posit_gemm_large_launch`` refuses anything else."""
    return K > 0 and N % 16 == 0 and K % 8 == 0


def mid_shape_ok(N: int, K: int) -> bool:
    """The shapes the mid-M kernel takes, whatever the B kind: its TMA copies
    of B need a row stride that is a multiple of 16 bytes (N a multiple of
    16 for p8 codes); rows past K and columns past N come in as zeros, so K
    is free. ``posit_gemm_mid_launch`` refuses anything else."""
    return K > 0 and N % 16 == 0


def gemm_route(M: int, N: int, K: int, a_kind: int, b_kind: int, bf16_compute: bool,
               aligned: bool = True) -> str:
    """The kernel a GEMM launches: "large_tc" or "large_fma" above ``LARGE_M``
    rows for a shape the large-M kernels take, with A and B 16-byte aligned
    (``aligned``); "mid_tc" for a tensor-core pair at 9 to ``MID_M`` rows
    (and at most ``LARGE_M``) on a shape the mid-M kernel takes, aligned;
    else "tc" or "fma", the kernels of csrc/posit_gemm.cu."""
    tc = uses_tensor_cores(a_kind, b_kind, bf16_compute)
    if M > LARGE_M and aligned and large_shape_ok(N, K):
        return "large_tc" if tc else "large_fma"
    if tc and 8 < M <= min(MID_M, LARGE_M) and aligned and mid_shape_ok(N, K):
        return "mid_tc"
    return "tc" if tc else "fma"


def launch_counter(b_kind: int, tensor_cores: bool, large: bool = False,
                   mid: bool = False) -> str:
    """The ``kernels.LAUNCHES`` key a launch of this B kind and datapath adds to."""
    if mid:
        return "posit_gemm_mid_tc"
    if large:
        return "posit_gemm_large_tc" if tensor_cores else "posit_gemm_large_fma"
    if b_kind == PACKED_KIND:
        return "posit_gemm_packed" if tensor_cores else "posit_gemm_packed_fma"
    return "posit_gemm_p16" if b_kind == 3 and tensor_cores else "posit_gemm"


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The tensor-core kernel's stream-K grid: ``grid`` persistent blocks walk
    the ``tiles * steps`` (output tile, 64-row k step) items in equal
    contiguous shares; block b takes items [total * b // grid,
    total * (b + 1) // grid) (``share_start`` in csrc/posit_gemm.cu). For a
    packed B a step is 64 packed rows, so ``steps`` walks ceil(K/2)."""
    rows: int    # tile height: 8 (M <= 8, padded) or 64
    tiles: int   # output tiles, ``rows`` x 128 columns
    steps: int   # k steps of a tile
    grid: int    # persistent blocks


def split_plan(M: int, N: int, K: int, sms: int, b_kind: int = 2) -> StreamPlan:
    """The tensor-core kernel's grid: one wave of resident blocks (two per SM
    for the 8-row tile, one for the 64-row tile and for p16 B's 8-row tile,
    whose ring is deeper: ``TcLayout::BLOCKS`` in csrc/posit_gemm.cu), fewer
    when the work would give a block under 4 (8-row) or 8 (64-row) k steps,
    since every extra block splits a tile once more and its part must be
    read back by the tile's last block (a 64-row part is 32 KB). Every
    block's share is within one k step of every other's, whatever N is, so
    no partial wave runs at the end. For M <= 8 the plan does not depend on
    M, so the rows of a decode batch get the same summation order whatever
    the batch size."""
    rows = 8 if M <= 8 else 64
    tiles = -(-N // TC_COLS) * -(-M // rows)
    steps = max(1, -(-K // TC_STEP))
    resident = sms * (2 if rows == 8 and b_kind != 3 else 1)
    least = 4 if rows == 8 else 8
    return StreamPlan(rows, tiles, steps, max(1, min(resident, tiles * steps // least)))


def fma_split_plan(M: int, N: int, K: int, sms: int) -> tuple[int, int]:
    """(splits, k_per_split) of the K dimension over blockIdx.z for the f32
    FMA kernels (p16 or f32 B).

    M <= 8 (the decode kernel, 256 columns a block, two blocks per SM): as
    many splits as fit the grid into one wave of two blocks per SM. Larger M
    (64 x 64 tiles): about two blocks per SM. The widths mirror
    ``launch_kinds`` in csrc/posit_gemm.cu. For M <= 8 the plan does not
    depend on M.
    """
    if M <= 8:
        tiles = -(-N // 256)
        splits = max(1, min(2 * sms // tiles, K // 128))
    else:
        tiles = -(-N // 64) * -(-M // 64)
        splits = max(1, min(-(-2 * sms // tiles), K // 64))
    bk = 32 if M <= 8 else 16
    k_per_split = -(-(-(-K // splits)) // bk) * bk
    return -(-K // k_per_split), k_per_split


@dataclasses.dataclass(frozen=True)
class LargePlan:
    """The large-M kernels' grid: ``tiles_m`` x ``tiles_n`` output tiles, each
    in ``splits`` K splits (blockIdx.z) of ``k_per_split`` (64-row blocks of
    B on the tensor cores, rows of B on the f32-FMA tile); split s takes
    [s * k_per_split, (s + 1) * k_per_split), the last one cut at the end.
    With more than one split the parts go to an f32 buffer that a second
    kernel sums in split order."""
    tiles_m: int
    tiles_n: int
    splits: int
    k_per_split: int


def large_split_plan(M: int, N: int, kb: int, sms: int, tensor_cores: bool) -> LargePlan:
    """K splits only where the tiles fill less than a wave: one block an SM
    for the wgmma kernel (at least 8 blocks of 64 rows a split), two for the
    f32-FMA tile (at least 128 rows a split, a multiple of its 8-row
    stage). At M = 4,096 and the training shapes every tile takes one split,
    so the FMA tile sums each output in ``gemm_kernel``'s order."""
    if tensor_cores:
        tm, tn = -(-M // LARGE_TC_ROWS), -(-N // LARGE_TC_COLS)
        span = -(-kb // LARGE_TC_STEP)
        splits = max(1, min(sms // (tm * tn), span // 8))
        kps = -(-span // splits)
    else:
        tm, tn = -(-M // LARGE_FMA_TILE), -(-N // LARGE_FMA_TILE)
        span = kb
        splits = max(1, min(-(-2 * sms // (tm * tn)), kb // 128))
        kps = -(-(-(-kb // splits)) // LARGE_FMA_STEP) * LARGE_FMA_STEP
    return LargePlan(tm, tn, -(-span // kps), kps)


def large_plan(M: int, N: int, K: int, b_kind: int, sms: int, tensor_cores: bool) -> LargePlan:
    """The plan of a large-M launch: the wgmma kernel reads every B as (K, N)
    bf16 (a posit B decoded once for the call, a packed one unpacked), so
    its splits walk K rows; the f32-FMA tile reads B as it is, ceil(K/2)
    rows of a packed B."""
    kb = -(-K // 2) if b_kind == PACKED_KIND and not tensor_cores else K
    return large_split_plan(M, N, kb, sms, tensor_cores)


@dataclasses.dataclass(frozen=True)
class MidPlan:
    """The mid-M kernel's stream-K grid: ``grid`` persistent blocks (one an
    SM) walk the ``tiles * steps`` (128-column tile, 64-row k step) items
    in equal contiguous shares, as ``StreamPlan``'s blocks do. For a packed
    B a step is 64 packed rows, so ``steps`` walks ceil(K/2)."""
    tiles: int   # output tiles, all M rows x 128 columns
    steps: int   # k steps of a tile
    grid: int    # persistent blocks


def mid_rows(M: int) -> int:
    """The width of the mid-M kernel's ``wgmma`` (A's rows padded to it), which
    also sizes its partials: (grid, 2, 256, ``mid_rows(M) // 2``) f32."""
    return 16 if M <= 16 else 32 if M <= 32 else 64


def mid_plan(N: int, K: int, sms: int, b_kind: int = 2) -> MidPlan:
    """The mid-M kernel's grid: one block an SM, fewer when the work would
    give a block under 8 k steps, since every extra block splits a tile
    once more and its part (128 x ``mid_rows(M)`` f32) must be read back by
    the tile's last block. Every block's share is within one k step of every
    other's. The plan takes no M: a row's sum order is the same for every M
    in 9..64 (the instruction's width follows M, the sums do not)."""
    kb = -(-K // 2) if b_kind == PACKED_KIND else K
    tiles = -(-N // MID_COLS)
    steps = max(1, -(-kb // MID_STEP))
    return MidPlan(tiles, steps, max(1, min(sms, tiles * steps // 8)))


def posit_gemm(
    a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: Fmt, b_fmt: Fmt, out_fmt: Fmt,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
    compute_dtype: Optional[torch.dtype] = None,
    b_packed: bool = False,
    codec_impl: str = "auto",
) -> torch.Tensor:
    """O = epilogue(decode(A) @ decode(B)), encoded per ``out_fmt``.

    A (M, K), B (K, N): posit codes or float per their slots; with
    ``b_packed`` B is (ceil(K/2), N) uint16 packed p8 lanes. es = (es_a,
    es_b, es_out) ints; bias (N,) f32; residual (M, N) f32; epilogue =
    ``act(acc + bias) + residual``. ``codec_impl`` picks the plain version's
    B decode; the kernel decodes p8 with its own tables either way (the same
    bits).
    """
    require(activation in ACTIVATIONS,
            f"activation must be one of {ACTIVATIONS}, got {activation!r}")
    kb = (a.shape[-1] + 1) // 2 if b_packed else a.shape[-1]
    require(a.dim() == 2 and b.dim() == 2 and kb == b.shape[0],
            f"GEMM shapes {tuple(a.shape)} @ {tuple(b.shape)}"
            + (" (packed B has ceil(K/2) rows)" if b_packed else ""))
    require(not b_packed or (isinstance(b_fmt, PositFmt) and b_fmt.nbits == 8),
            f"packed B requires a p8 slot, got {b_fmt}")
    M, K = a.shape
    N = b.shape[1]
    require(bias is None or tuple(bias.shape) == (N,), f"bias must be ({N},)")
    require(residual is None or tuple(residual.shape) == (M, N),
            f"residual must be ({M}, {N})")
    if compute_dtype is None:
        compute_dtype = format_pair_plan(a_fmt, b_fmt, packed_b=b_packed).compute_dtype
    require(compute_dtype in (torch.float32, torch.bfloat16),
            f"compute dtype must be float32 or bfloat16, got {compute_dtype}")
    es = tuple(int(e) for e in es)
    extra = [t for t in (bias, residual) if t is not None]
    if on_cpu(a, b, *extra):
        return ref.posit_gemm_ref(a, b, es, a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=out_fmt,
                                  bias=bias, residual=residual, activation=activation,
                                  compute_dtype=compute_dtype, b_packed=b_packed,
                                  codec_impl=codec_impl)
    a_kind, a_dtype = _kind(a_fmt)
    b_kind, b_dtype = _kind(b_fmt, b_packed)
    out_kind, out_dtype = _kind(out_fmt)
    require(a.dtype == a_dtype, f"A must be {a_dtype} for slot {a_fmt}, got {a.dtype}")
    require(b.dtype == b_dtype, f"B must be {b_dtype} for slot {b_fmt}, got {b.dtype}")
    for name, t in (("A", a), ("B", b), ("bias", bias), ("residual", residual)):
        if t is None:
            continue
        require(t.is_contiguous(), f"{name} must be contiguous")
        if name in ("bias", "residual"):
            require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M == 0 or N == 0:
        return out
    sms = _sm_count(a.device.index or 0)
    stream = stream_handle(a)
    counters = None
    bf16 = compute_dtype == torch.bfloat16
    tensor_cores = uses_tensor_cores(a_kind, b_kind, bf16)
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    route = gemm_route(M, N, K, a_kind, b_kind, bf16, aligned)
    if route == "mid_tc":
        plan = mid_plan(N, K, sms, b_kind)
        partial = (torch.empty((plan.grid, 2, MID_THREADS, mid_rows(M) // 2),
                               dtype=torch.float32, device=a.device)
                   if plan.grid > 1 else None)
        counters = (kernels.zeroed_counters(a.device, stream, plan.tiles) if plan.grid > 1
                    else None)
        # A rounded or decoded to bf16 once a call, zero past K (a packed B's
        # two slices each padded to whole 64-wide steps), inside the launch
        width = plan.steps * MID_STEP * (2 if b_kind == PACKED_KIND else 1)
        a16 = torch.empty((M, width), dtype=torch.bfloat16, device=a.device)
        rc = _mid_lib().posit_gemm_mid_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(), a16.data_ptr(),
            M, N, K, a_kind, b_kind, out_kind, es[0], es[1], es[2], _ACT[activation],
            plan.grid, stream)
        check_rc(rc, "posit_gemm_mid")
        kernels.LAUNCHES[launch_counter(b_kind, True, mid=True)] += 1
        return out
    if route.startswith("large"):
        plan = large_plan(M, N, K, b_kind, sms, tensor_cores)
        partial = (torch.empty((plan.splits, M, N), dtype=torch.float32, device=a.device)
                   if plan.splits > 1 else None)
        # the wgmma kernel reads A and B as bf16: f32 and p8 A, and posit B,
        # are rounded or decoded into these buffers first, inside the launch
        a16 = (torch.empty((M, K), dtype=torch.bfloat16, device=a.device)
               if tensor_cores and a_kind != 1 else None)
        b16 = (torch.empty((K, N), dtype=torch.bfloat16, device=a.device)
               if tensor_cores and b_kind != 1 else None)
        rc = _large_lib().posit_gemm_large_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            None if partial is None else partial.data_ptr(),
            None if a16 is None else a16.data_ptr(),
            None if b16 is None else b16.data_ptr(),
            M, N, K, a_kind, b_kind, out_kind, es[0], es[1], es[2], _ACT[activation],
            int(bf16), plan.splits, plan.k_per_split, stream)
        check_rc(rc, "posit_gemm_large")
        kernels.LAUNCHES[launch_counter(b_kind, tensor_cores, large=True)] += 1
        return out
    if tensor_cores:
        plan = split_plan(M, N, kb, sms, b_kind)
        grid, k_per_split = plan.grid, 0
        partial = (torch.empty((grid, 2, plan.rows, TC_COLS), dtype=torch.float32,
                               device=a.device) if grid > 1 else None)
        counters = (kernels.zeroed_counters(a.device, stream, plan.tiles) if grid > 1
                    else None)
    else:
        grid, k_per_split = fma_split_plan(M, N, kb, sms)
        partial = (torch.empty((grid, M, N), dtype=torch.float32, device=a.device)
                   if grid > 1 else None)
    rc = _lib().posit_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        M, N, K, a_kind, b_kind, out_kind, es[0], es[1], es[2], _ACT[activation],
        int(bf16), grid, k_per_split, stream)
    check_rc(rc, "posit_gemm")
    kernels.LAUNCHES[launch_counter(b_kind, tensor_cores)] += 1
    return out


class FloatLinear(torch.autograd.Function):
    """``act(x @ w + bias) + residual`` for float x (M, K) and w (K, N): the
    GEMM kernel in the forward (the same launch, fused epilogue included,
    whether or not a gradient is wanted), plain f32 products in the backward.

    The reference computes this linear as a plain ``jnp.matmul`` that XLA
    differentiates; no Pallas kernel has a backward. So the backward is
    ``torch.matmul`` on the saved operands, both as the kernel saw them
    (rounded to ``compute_dtype``, then f32): the pre-activation ``z = x @ w
    + bias`` recomputed in f32 where an activation needs it, ``dz = dy *
    act'(z)``, ``dx = dz @ w.T``, ``dw = x.T @ dz``, ``dbias = dz.sum(0)``,
    ``dresidual = dy``. Under bf16 compute ``dx`` stays f32 (the reference
    rounds it to bf16)."""

    @staticmethod
    def forward(ctx, x, w, bias, residual, activation, compute_dtype):
        y = posit_gemm(x, w, (0, 0, 0), a_fmt=float_fmt(x.dtype), b_fmt=float_fmt(w.dtype),
                       out_fmt=F32, compute_dtype=compute_dtype, bias=bias,
                       activation=activation, residual=residual)
        ctx.save_for_backward(x, w, bias)
        ctx.activation, ctx.compute_dtype = activation, compute_dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, bias = ctx.saved_tensors
        need_x, need_w, need_b, need_res = ctx.needs_input_grad[:4]
        with torch.profiler.record_function("posit_gemm_backward"):
            xf = x.to(ctx.compute_dtype).to(torch.float32)
            wf = w.to(torch.float32)
            dz = dy
            if ctx.activation != "none":
                z = torch.matmul(xf, wf)
                if bias is not None:
                    z = z + bias
                with torch.enable_grad():
                    z.requires_grad_(True)
                    dz, = torch.autograd.grad(_apply_activation(z, ctx.activation), z, dy)
            dx = torch.matmul(dz, wf.T).to(x.dtype) if need_x else None
            dw = torch.matmul(xf.T, dz).to(w.dtype) if need_w else None
            db = dz.sum(0) if need_b and bias is not None else None
        return dx, dw, db, dy if need_res else None, None, None


def float_linear(x: torch.Tensor, w: torch.Tensor, *, compute_dtype: torch.dtype,
                 bias: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None,
                 activation: str = "none") -> torch.Tensor:
    """``FloatLinear``: x (M, K) f32/bf16, w (K, N) in ``compute_dtype``,
    bias (N,) and residual (M, N) f32 -> (M, N) f32, differentiable in all
    four."""
    return FloatLinear.apply(x, w, bias, residual, activation, compute_dtype)


GEMM_IMPLS = ("auto", "pallas", "xla", "unfused", "quire")


def gemm(a: torch.Tensor, b: torch.Tensor, slots: OperandSlots, *,
         es_a: Optional[int] = None, es_b: Optional[int] = None,
         es_out: Optional[int] = None, bias=None, activation: str = "none",
         residual=None, impl: str = "auto") -> torch.Tensor:
    """O = epilogue(decode(A) @ decode(B)) -> encode, per the pcsr slots.

    ``impl`` as in the reference: "pallas" and "xla" both mean the fused
    kernel here (one launch of ``posit_gemm``); "unfused" the codec kernel's
    decode passes, the GEMM kernel on floats, then the epilogue and encode
    passes; "quire" the exact-accumulation kernel
    (``kernels.posit_quire_gemm``, which unpacks a packed B first); "auto"
    the quire where ``slots.dataflow`` says so, else the fused kernel
    (``core.dot.posit_dot`` dataflows)."""
    from repro_torch.core.dot import posit_dot

    if impl not in GEMM_IMPLS:
        raise ValueError(f"unknown impl {impl!r}: one of {GEMM_IMPLS}")
    if impl == "auto":
        impl = "quire" if slots.dataflow == "quire" else "fused"
    elif impl in ("pallas", "xla"):
        impl = "fused"
    return posit_dot(a, b, slots, es_a=es_a, es_b=es_b, es_out=es_out, impl=impl, bias=bias,
                     activation=activation, residual=residual)
