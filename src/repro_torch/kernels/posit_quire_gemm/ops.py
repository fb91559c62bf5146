"""Front door for the exact-accumulation (quire) posit GEMM: the CUDA kernel
for CUDA tensors, the plain version (``ref.py``) for CPU tensors."""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional

import torch

from repro_torch import kernels
from repro_torch.core.dot import ACTIVATIONS
from repro_torch.core.pack import unpack_p8
from repro_torch.core.pcsr import OperandSlots
from repro_torch.core.types import F32, Fmt, PositFmt
from repro_torch.kernels import build, check_rc, on_cpu, require, stream_handle
from repro_torch.kernels.posit_gemm.ops import _sm_count
from repro_torch.kernels.posit_quire_gemm import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "posit_quire_gemm_launch": (_P,) * 5 + (_I,) * 12 + (_P,),
    "posit_quire_gemm_max_clusters": (_I,) * 4 + (_P,),
}
_ACT = {a: i for i, a in enumerate(ACTIVATIONS)}
_OUT_KIND = {"f32": 0, 8: 2, 16: 3}   # storage kinds of csrc/posit_codec.cuh
# (BM, BN, BK) of the kernel's tile per row-tile kind, mirroring `run_rows`
# in csrc/posit_quire_gemm.cu: 64 columns x 4 k groups of threads, BM rows;
# K splits in whole 128-k stages over the blocks of one cluster.
TILES = {1: (1, 64, ref.K_TILE), 4: (4, 64, ref.K_TILE), 8: (8, 64, ref.K_TILE)}
MAX_SPLITS = 8      # blocks of a thread-block cluster (the portable size)


def _lib():
    return build.load("posit_quire_gemm", _SIGNATURES)


def tile_of(M: int) -> tuple[int, int, int]:
    return TILES[1 if M <= 1 else (4 if M <= 4 else 8)]


def _split_k(K: int, splits: int, bk: int) -> tuple[int, int]:
    """(splits, k_per_split) for about ``splits`` ranges of whole k tiles."""
    k_per_split = max(bk, -(-(-(-K // splits)) // bk) * bk)
    return max(1, -(-K // k_per_split)), k_per_split


def split_plan(M: int, N: int, K: int, sms: int,
               clusters: Optional[Callable[[int], int]] = None) -> tuple[int, int]:
    """(splits, k_per_split) of the K dimension over a cluster's blocks.

    ``clusters(s)`` is how many clusters of ``s`` blocks the card holds at
    once (the kernel's occupancy query on the card; without one, four
    blocks an SM). Each split count costs its rounds of clusters (one a
    tile) times a block's work: its k range plus about four k tiles of fixed
    work (zeroing the quires, the cluster's sum and readout; fitted to H100
    timings of the phi3 shapes). The cheapest wins, the fewer splits on a
    tie. Each split is a whole number of k tiles, at most one cluster of
    them. The quire sum is exact, so the split changes no bit of the result.
    """
    bm, bn, bk = tile_of(M)
    tiles = -(-N // bn) * -(-M // bm)
    if clusters is None:
        clusters = lambda s: 4 * sms // s  # noqa: E731
    best = None
    for s in range(1, min(MAX_SPLITS, max(1, -(-K // bk))) + 1):
        n_splits, k_per_split = _split_k(K, s, bk)
        cost = -(-tiles // max(1, clusters(n_splits))) * (k_per_split + 4 * bk)
        if best is None or cost < best[0]:
            best = (cost, n_splits, k_per_split)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _card_plan(device: int, M: int, N: int, K: int, a_bits: int,
               b_bits: int) -> tuple[int, int]:
    """``split_plan`` with the card's occupancy query, once a shape."""
    def clusters(splits: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = _lib().posit_quire_gemm_max_clusters(tile_of(M)[0], a_bits, b_bits, splits,
                                                      ctypes.addressof(out))
        check_rc(rc, "posit_quire_gemm_max_clusters")
        return out.value
    return split_plan(M, N, K, _sm_count(device), clusters)


def posit_quire_gemm(
    a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: PositFmt, b_fmt: PositFmt,
    out_fmt: Fmt,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
    splits: Optional[int] = None,
) -> torch.Tensor:
    """O = round_once(sum_k decode(A)[i,k] * decode(B)[k,j]), then the epilogue.

    A (M, K), B (K, N) posit codes (p8/p16, mixed allowed); es = (es_a, es_b,
    es_out); bias (N,) f32; residual (M, N) f32. ``out_fmt`` is a posit
    format (exact readout into it, or f32 readout -> epilogue -> encode when
    there is an epilogue) or F32 (f32 readout -> epilogue). ``splits`` forces
    the K split count on the card, 1 to ``MAX_SPLITS`` (default:
    ``split_plan``).
    """
    for name, f in (("a_fmt", a_fmt), ("b_fmt", b_fmt)):
        require(isinstance(f, PositFmt), f"quire GEMM needs a posit {name}, got {f}")
    require(isinstance(out_fmt, PositFmt) or out_fmt == F32,
            f"quire GEMM reads out into a posit format or f32, got {out_fmt}")
    require(activation in ACTIVATIONS,
            f"activation must be one of {ACTIVATIONS}, got {activation!r}")
    require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
            f"GEMM shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    require(bias is None or tuple(bias.shape) == (N,), f"bias must be ({N},)")
    require(residual is None or tuple(residual.shape) == (M, N),
            f"residual must be ({M}, {N})")
    es = tuple(int(e) for e in es)
    extra = [t for t in (bias, residual) if t is not None]
    if on_cpu(a, b, *extra):
        return ref.posit_quire_gemm_ref(a, b, es, a_fmt=a_fmt, b_fmt=b_fmt,
                                        out_fmt=out_fmt, bias=bias, residual=residual,
                                        activation=activation)
    for name, t, fmt in (("A", a, a_fmt), ("B", b, b_fmt)):
        require(t.dtype == fmt.storage_dtype,
                f"{name} must be {fmt.storage_dtype} for slot {fmt}, got {t.dtype}")
    for name, t in (("A", a), ("B", b), ("bias", bias), ("residual", residual)):
        if t is None:
            continue
        require(t.is_contiguous(), f"{name} must be contiguous")
        if name in ("bias", "residual"):
            require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    posit_out = isinstance(out_fmt, PositFmt)
    out = torch.empty((M, N), dtype=out_fmt.storage_dtype if posit_out else torch.float32,
                      device=a.device)
    if M == 0 or N == 0:
        return out
    if splits is None:
        n_splits, k_per_split = _card_plan(a.device.index or 0, M, N, K, a_fmt.nbits,
                                           b_fmt.nbits)
    else:
        require(1 <= splits <= MAX_SPLITS,
                f"splits must be in [1, {MAX_SPLITS}] (one cluster), got {splits}")
        n_splits, k_per_split = _split_k(K, splits, tile_of(M)[2])
    rc = _lib().posit_quire_gemm_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        M, N, K, a_fmt.nbits, b_fmt.nbits, _OUT_KIND[out_fmt.nbits if posit_out else "f32"],
        es[0], es[1], es[2], _ACT[activation], n_splits, k_per_split, stream_handle(a))
    check_rc(rc, "posit_quire_gemm")
    kernels.LAUNCHES["posit_quire_gemm"] += 1
    return out


def quire_gemm(a: torch.Tensor, b: torch.Tensor, slots: OperandSlots, *,
               es_a: Optional[int] = None, es_b: Optional[int] = None,
               es_out: Optional[int] = None, bias=None, activation: str = "none",
               residual=None) -> torch.Tensor:
    """O = round_once(sum decode(A)*decode(B)) per the pcsr operand slots.

    With an epilogue (bias/activation/residual) the exact sum rounds once
    into f32, the epilogue applies, and a posit rd encodes the result. rd may
    be F32: the single rounding of the exact sum is then the output. A
    packed rs2 (``slots.rs2_packed``) is split into plain p8 codes first
    (``core.pack.unpack_p8``): the quire's sum does not depend on the
    layout, so packed and unpacked B give the same bits.
    """
    for name, f in (("rs1", slots.rs1), ("rs2", slots.rs2)):
        if not isinstance(f, PositFmt):
            raise ValueError(
                f"quire dataflow requires posit {name}, got {f}: the quire "
                "accumulates posit products exactly; float slots have no "
                "quire representation")
    if slots.rs2_packed:
        b = unpack_p8(b, a.shape[1]).contiguous()

    def _es(x, fmt):
        if x is not None:
            return x
        return fmt.es if isinstance(fmt, PositFmt) else 0

    return posit_quire_gemm(a, b, (_es(es_a, slots.rs1), _es(es_b, slots.rs2),
                                   _es(es_out, slots.rd)),
                            a_fmt=slots.rs1, b_fmt=slots.rs2, out_fmt=slots.rd,
                            bias=bias, residual=residual, activation=activation)
