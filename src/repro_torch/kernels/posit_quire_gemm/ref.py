"""Plain-torch versions of the quire GEMM kernel (same exact math).

``posit_quire_gemm_ref`` is the untiled plain version the front door takes
for CPU tensors. ``posit_quire_gemm_chunked_ref`` emulates, in plain torch,
what ``csrc/posit_quire_gemm.cu`` does: k chunks with a window anchor per A
row and B column, int64 chunk sums of aligned integers placed into the
quire once a chunk, the exact per-product placement for elements below
their window, and the split-K sum of normalised quires. ``per_product_share``
applies the same window rule to count the products of the second branch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codec import _decode_fields, _es, _sigw, posit_encode
from repro_torch.core.dot import apply_epilogue
from repro_torch.core.quire import (QuireFmt, _normalize_limbs, _product_parts,
                                    quire_matmul, quire_read, quire_read_f32)
from repro_torch.core.types import Fmt, PositFmt

CHUNK = 32        # k values summed in one int64 register (the kernel's kKC)
K_TILE = 128      # a K split is a whole number of these (the kernel's kKS)


def window(nbits: int) -> int:
    """Binades an anchor spans: aligned integers stay below 2^29, so a
    chunk's 32 products sum below 2^63."""
    return 29 - _sigw(nbits)


def smax(nbits: int) -> int:
    """Largest |scale| of a P(nbits, es <= 3): the anchors' floor is -smax."""
    return (nbits - 2) << 3


def posit_quire_gemm_ref(
    a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: PositFmt, b_fmt: PositFmt,
    out_fmt: Fmt,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
) -> torch.Tensor:
    """A posit ``out_fmt`` without an epilogue reads the quire out once into
    it; otherwise the exact sum rounds once into f32, the epilogue applies,
    and a posit ``out_fmt`` encodes the result (an F32 one returns it)."""
    es_a, es_b, es_out = (int(e) for e in es)
    wide = a_fmt if a_fmt.nbits >= b_fmt.nbits else b_fmt
    kw = dict(es_a=es_a, es_b=es_b, nbits_a=a_fmt.nbits, nbits_b=b_fmt.nbits)
    posit_out = isinstance(out_fmt, PositFmt)
    if posit_out and bias is None and activation == "none" and residual is None:
        return quire_matmul(a, b, wide, out_nbits=out_fmt.nbits, es_out=es_out, **kw)
    y = quire_matmul(a, b, wide, as_float=True, **kw)
    y = apply_epilogue(y, bias, activation, residual)
    if posit_out:
        return posit_encode(y, out_fmt.nbits, es_out)
    return y


def _window_parts(codes: torch.Tensor, nbits: int, es: int, kdim: int):
    """The kernel's window rule along the k axis ``kdim`` of an operand.

    Returns (fields, anchor per element, aligned int64, live, low): the
    anchor of a chunk of ``CHUNK`` k is its largest live scale less
    ``window(nbits)``, at least ``-smax(nbits)``, a NaR counting as maxpos
    (its row or column reads out NaR whatever the anchor); a live element at
    or above it aligns to +-sig << (scale - anchor), one below it is
    ``low`` and aligns to 0, as zero and NaR do.
    """
    fields = _decode_fields(codes, nbits, _es(es))
    neg, scale, sig, zero, nar = fields
    live = ~(zero | nar)
    x = torch.where(live, scale, torch.where(nar, (nbits - 2) << _es(es), -(1 << 20)))
    if kdim == 1:
        x = x.T
    K = x.shape[0]
    pad = -K % CHUNK
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad), value=-(1 << 20))
    mx = xp.reshape(-1, CHUNK, xp.shape[1]).amax(dim=1)
    anchor = torch.clamp(mx - window(nbits), min=-smax(nbits))
    anchor = anchor.repeat_interleave(CHUNK, dim=0)[:K]
    if kdim == 1:
        anchor = anchor.T
    sh = scale - anchor
    low = live & (sh < 0)
    keep = live & ~low
    mag = sig << torch.where(keep, sh, 0)
    aligned = torch.where(keep, torch.where(neg, -mag, mag), 0)
    return fields, anchor, aligned, live, low


def per_product_share(a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: PositFmt,
                      b_fmt: PositFmt) -> tuple[int, float]:
    """(count, share of all M*K*N) of the products that take the kernel's
    exact per-product branch: both operands live and at least one below its
    window. O(M*K + K*N), on any device."""
    M, K = a.shape
    N = b.shape[1]
    _, _, _, live_a, low_a = _window_parts(a, a_fmt.nbits, es[0], kdim=1)
    _, _, _, live_b, low_b = _window_parts(b, b_fmt.nbits, es[1], kdim=0)
    la, lb = live_a.sum(0), live_b.sum(1)
    ia, ib = (live_a & ~low_a).sum(0), (live_b & ~low_b).sum(1)
    count = int((la * lb - ia * ib).sum())
    return count, count / max(1, M * K * N)


def _place(limbs: torch.Tensor, v: torch.Tensor, off: torch.Tensor) -> None:
    """limbs[..., off/16 + t] += the kernel's five digits of v << (off % 16):
    four unsigned 16-bit digits of the low 64 bits and the signed rest."""
    s = off & 15
    lo = v << s                                      # two's complement wrap
    hi = torch.where(s == 0, v >> 63, v >> (64 - s).clamp(max=63))
    digits = [(lo >> (16 * t)) & 0xFFFF for t in range(4)] + [hi]
    li = off >> 4
    for t, d in enumerate(digits):
        limbs.scatter_add_(-1, (li + t)[..., None], d[..., None])


def posit_quire_gemm_chunked_ref(
    a: torch.Tensor, b: torch.Tensor, es, *, a_fmt: PositFmt, b_fmt: PositFmt,
    out_fmt: Fmt,
    bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    activation: str = "none",
    splits: int = 1,
) -> torch.Tensor:
    """The kernel's accumulation on the CPU, step by step; the readout and
    epilogue are ``posit_quire_gemm_ref``'s. K splits into ``splits`` ranges
    of whole ``K_TILE``s, each summed into its own quire (int64 limbs here),
    normalised, then added limb-wise, as the kernel's cluster does."""
    es_a, es_b, es_out = (int(e) for e in es)
    M, K = a.shape
    N = b.shape[1]
    na, nb = a_fmt.nbits, b_fmt.nbits
    qf = QuireFmt(max(na, nb))
    L = qf.n_limbs
    fa, alpha, a_al, live_a, low_a = _window_parts(a, na, es_a, kdim=1)
    fb, beta, b_al, live_b, low_b = _window_parts(b, nb, es_b, kdim=0)
    assert all(int(t.abs().max()) < 1 << 29 for t in (a_al, b_al) if t.numel())
    offset = qf.bias - (_sigw(na) - 1) - (_sigw(nb) - 1)
    k_per_split = max(K_TILE, -(-(-(-K // splits)) // K_TILE) * K_TILE)
    total = torch.zeros((M, N, L), dtype=torch.int64)
    for k_begin in range(0, max(K, 1), k_per_split):
        limbs = torch.zeros((M, N, L + 2), dtype=torch.int64)
        for k0 in range(k_begin, min(K, k_begin + k_per_split), CHUNK):
            ks = slice(k0, min(K, k0 + CHUNK))
            acc = a_al[:, ks] @ b_al[ks, :]          # exact: 32 products below 2^58
            _place(limbs, acc, alpha[:, k0, None] + beta[None, k0, :] + offset)
            # per-product branch: live x live with an element below its window
            pp = (live_a[:, ks, None] & live_b[None, ks, :]
                  & (low_a[:, ks, None] | low_b[None, ks, :]))
            i, kk, j = pp.nonzero(as_tuple=True)
            if i.numel():
                k = kk + k0
                sgn, idx, g0, g1, g2, _ = _product_parts(
                    tuple(f[i, k] for f in fa), tuple(f[k, j] for f in fb), na, nb,
                    qf.bias, False)
                flat = limbs.view(-1, L + 2)
                at = (i * N + j) * (L + 2) + idx
                for t, gt in enumerate((g0, g1, g2)):
                    flat.view(-1).scatter_add_(0, at + t, sgn * gt)
        # the spare limbs fold into the top one, as the kernel's normalisation
        top = limbs[..., L - 1] + limbs[..., L] * 65536 + limbs[..., L + 1] * (1 << 32)
        total += _normalize_limbs(torch.cat([limbs[..., :L - 1], top[..., None]], dim=-1))
    nar = ((a.to(torch.int64) == 1 << (na - 1)).any(1)[:, None]
           | (b.to(torch.int64) == 1 << (nb - 1)).any(0)[None, :])
    q = torch.cat([_normalize_limbs(total).to(torch.int32), nar[..., None].to(torch.int32)],
                  dim=-1)
    posit_out = isinstance(out_fmt, PositFmt)
    if posit_out and bias is None and activation == "none" and residual is None:
        return quire_read(q, qf, out_nbits=out_fmt.nbits, es_out=es_out)
    y = apply_epilogue(quire_read_f32(q, qf), bias, activation, residual)
    if posit_out:
        return posit_encode(y, out_fmt.nbits, es_out)
    return y
