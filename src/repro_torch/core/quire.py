"""Software quire: an exact Kulisch accumulator for posit products.

The port's copy of the reference package's ``core/quire.py``, with the same
representation, so quire states, digits and readouts agree bit for bit:

* A quire value is an int32 tensor whose **last axis** holds ``n_limbs + 1``
  limbs: ``n_limbs`` radix-2^16 digits (LSB first) plus one NaR flag limb.
  value = sum_i limb[i] * 2^(16*i - BIAS); any nonzero flag limb == NaR.
* Digits are lazy: ``quire_accumulate`` adds signed 16-bit digit
  contributions without propagating carries; up to ``MAX_DEFERRED``
  accumulations fit the int32 headroom between ``quire_normalize`` calls.
  Canonical form after normalize: digits in [0, 2^16), the top limb carries
  the signed remainder.
* The binary-point anchor ``BIAS`` is static per nbits (sized for
  es = ES_MAX), so es never changes the layout and operands of different es
  or nbits (p8 x p16) share one quire.
* ``quire_read`` rounds once (RNE) against the exact sum; ``quire_read_f32``
  rounds once into float32 for a fused epilogue.

torch has no shifts or compares on uint32 on the CPU, so the arithmetic runs
in int64 with explicit 32-bit masks (as ``core/codec.py`` does); limbs are
stored as int32. ``quire_matmul`` sums a block of k products at once with
``scatter_add_``: the sums are exact integers, so the normalized quire, and
every readout, do not depend on the order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.codec import (_M32, _NAN_BITS, _bits_to_f32, _decode_fields,
                                    _encode_fields, _es, _floor_log2_small, _sigw)
from repro_torch.core.types import ES_MAX, PositFmt

RADIX = 16          # bits per digit; int32 limbs leave lazy-carry headroom
CARRY_GUARD = 20    # MSB headroom: >= 2^20 products accumulate exactly
MAX_DEFERRED = 8192  # accumulate calls allowed between quire_normalize calls
_MATMUL_BLOCK_ELEMS = 1 << 22  # products per scatter in quire_matmul


def _static_smax(nbits: int) -> int:
    """Worst-case |scale| of a posit P(nbits, es<=ES_MAX): (n-2) * 2^ES_MAX."""
    return (nbits - 2) << ES_MAX


def _static_bias(nbits: int) -> int:
    """Quire bit position of weight 2^0: the smallest product bit of two
    P(n, es<=3) posits lands at bit 0."""
    return 2 * _static_smax(nbits) + 2 * (_sigw(nbits) - 1)


def _limb_count(nbits: int) -> int:
    width = (2 * _static_smax(nbits) + 1 + CARRY_GUARD) + _static_bias(nbits) + 1
    return -(-width // RADIX)


@dataclasses.dataclass(frozen=True)
class QuireFmt:
    """Static descriptor of the quire serving posit format P(nbits, es).

    ``es`` is only the default exponent size for ops that take codes; the
    limb layout is sized for ES_MAX.
    """

    nbits: int  # 8 or 16: the widest operand format this quire serves
    es: int = 2

    def __post_init__(self):
        if self.nbits not in (8, 16):
            raise ValueError(f"quire nbits must be 8 or 16, got {self.nbits}")
        if not (0 <= self.es <= ES_MAX):
            raise ValueError(f"quire es must be in [0,{ES_MAX}], got {self.es}")

    @classmethod
    def for_posit(cls, fmt: PositFmt) -> "QuireFmt":
        return cls(fmt.nbits, fmt.es)

    @property
    def n_limbs(self) -> int:
        return _limb_count(self.nbits)

    @property
    def bias(self) -> int:
        return _static_bias(self.nbits)

    @property
    def limbs_axis(self) -> int:
        """Size of the trailing limb axis: digits + 1 NaR flag limb."""
        return self.n_limbs + 1

    @property
    def storage_bits(self) -> int:
        return self.n_limbs * RADIX


# =====================================================================
# digit generation: posit codes / products -> signed radix-2^16 digits
# =====================================================================

def _split_digits(p: torch.Tensor, offset: torch.Tensor):
    """Value ``p`` (< 2^29) placed at quire bit ``offset`` -> (limb index,
    three 16-bit digits occupying limbs idx, idx+1, idx+2)."""
    idx = offset >> 4
    s = offset & 15
    d0 = p & 0xFFFF
    d1 = p >> 16
    t0 = d0 << s                      # <= 0xFFFF << 15 < 2^31
    t1 = (d1 << s) + (t0 >> 16)
    return idx, t0 & 0xFFFF, t1 & 0xFFFF, t1 >> 16


def _product_parts(fields_a, fields_b, nbits_a: int, nbits_b: int,
                   bias: int, subtract: bool):
    """Decoded operand fields -> (sgn, idx, g0, g1, g2, nar) for one product."""
    na, sa, ga, za, ra = fields_a
    nb, sb, gb, zb, rb = fields_b
    neg = na ^ nb
    if subtract:
        neg = ~neg
    p = ga * gb  # < 2^28 (sig < 2^14 each)
    offset = sa + sb + (bias - (_sigw(nbits_a) - 1) - (_sigw(nbits_b) - 1))
    nar = ra | rb
    live = ~(za | zb | nar)
    sgn = torch.where(live, torch.where(neg, -1, 1), 0)
    idx, g0, g1, g2 = _split_digits(p, offset)
    return sgn, idx, g0, g1, g2, nar


def _posit_parts(fields, nbits: int, bias: int, subtract: bool):
    """Decoded posit fields -> scatter parts for exact single-value injection."""
    neg, s, sig, z, r = fields
    if subtract:
        neg = ~neg
    offset = s + (bias - (_sigw(nbits) - 1))
    live = ~(z | r)
    sgn = torch.where(live, torch.where(neg, -1, 1), 0)
    idx, g0, g1, g2 = _split_digits(sig, offset)
    return sgn, idx, g0, g1, g2, r


def _scatter(q: torch.Tensor, parts, n_limbs: int) -> torch.Tensor:
    """Add signed digit contributions into last-axis limbs (lazy, no carries).
    Digits that would land above the top limb are dropped, as in the
    reference (they are zero for every live product)."""
    sgn, idx, g0, g1, g2, nar = parts
    L = n_limbs
    lids = torch.arange(L, device=q.device)

    def b(x):
        return x[..., None]

    contrib = (torch.where(b(idx) == lids, b(g0), 0)
               + torch.where(b(idx) == lids - 1, b(g1), 0)
               + torch.where(b(idx) == lids - 2, b(g2), 0))
    limbs = q[..., :L].to(torch.int64) + b(sgn) * contrib
    flag = q[..., L:] | b(nar).to(torch.int32)
    limbs = limbs.to(torch.int32)
    return torch.cat([limbs, flag.expand(*limbs.shape[:-1], 1)], dim=-1)


# =====================================================================
# public quire ops
# =====================================================================

def quire_zero(batch_shape, qfmt: QuireFmt, device="cpu") -> torch.Tensor:
    """A cleared quire (PERCIVAL ``qclr``): all digits and the NaR flag zero."""
    return torch.zeros(tuple(batch_shape) + (qfmt.limbs_axis,), dtype=torch.int32,
                       device=device)


def quire_accumulate(q: torch.Tensor, a: torch.Tensor, b: torch.Tensor, qfmt: QuireFmt,
                     *, es_a: Optional[int] = None, es_b: Optional[int] = None,
                     nbits_a: Optional[int] = None, nbits_b: Optional[int] = None,
                     subtract: bool = False) -> torch.Tensor:
    """q +/- = a * b, exactly. a/b are posit codes broadcastable to q's batch.

    Call ``quire_normalize`` at least every ``MAX_DEFERRED`` accumulations.
    Mixed precision is allowed (p8 operand x p16 operand into a p16 quire).
    """
    na_, nb_ = nbits_a or qfmt.nbits, nbits_b or qfmt.nbits
    ea = _es(qfmt.es if es_a is None else es_a)
    eb = _es(qfmt.es if es_b is None else es_b)
    parts = _product_parts(_decode_fields(a, na_, ea), _decode_fields(b, nb_, eb),
                           na_, nb_, qfmt.bias, subtract)
    return _scatter(q, parts, qfmt.n_limbs)


def quire_add_posit(q: torch.Tensor, codes: torch.Tensor, qfmt: QuireFmt, *,
                    es: Optional[int] = None, nbits: Optional[int] = None,
                    subtract: bool = False) -> torch.Tensor:
    """q +/- = value(codes), exactly (every posit value is a quire value)."""
    n = nbits or qfmt.nbits
    esl = _es(qfmt.es if es is None else es)
    parts = _posit_parts(_decode_fields(codes, n, esl), n, qfmt.bias, subtract)
    return _scatter(q, parts, qfmt.n_limbs)


def quire_from_posit(codes: torch.Tensor, qfmt: QuireFmt, *, es: Optional[int] = None,
                     nbits: Optional[int] = None) -> torch.Tensor:
    """Exact posit -> quire conversion (NaR sets the flag limb)."""
    return quire_add_posit(quire_zero(codes.shape, qfmt, codes.device), codes, qfmt,
                           es=es, nbits=nbits)


def quire_negate(q: torch.Tensor, qfmt: QuireFmt) -> torch.Tensor:
    """Exact negation (PERCIVAL ``qneg``): digit-wise negate, flag preserved."""
    L = qfmt.n_limbs
    return torch.cat([-q[..., :L], q[..., L:]], dim=-1)


def _normalize_limbs(limbs: torch.Tensor) -> torch.Tensor:
    """Carry ripple over the last axis (int64): canonical digits below the
    top limb, which keeps the signed remainder. ``>>`` on negative ints is
    arithmetic in torch, so ``t >> 16`` is the floor carry."""
    n = limbs.shape[-1]
    c = torch.zeros_like(limbs[..., 0])
    outs = []
    for i in range(n - 1):
        t = limbs[..., i] + c
        outs.append(t & 0xFFFF)
        c = t >> RADIX
    outs.append(limbs[..., n - 1] + c)
    return torch.stack(outs, dim=-1)


def quire_normalize(q: torch.Tensor, qfmt: QuireFmt) -> torch.Tensor:
    """Propagate lazy carries -> canonical digits in [0, 2^16), signed top
    limb. Exact-value-preserving."""
    L = qfmt.n_limbs
    limbs = _normalize_limbs(q[..., :L].to(torch.int64)).to(torch.int32)
    return torch.cat([limbs, q[..., L:]], dim=-1)


def quire_is_nar(q: torch.Tensor, qfmt: QuireFmt) -> torch.Tensor:
    return q[..., qfmt.n_limbs] != 0


def _readout_fields(q: torch.Tensor, qfmt: QuireFmt):
    """Normalize + extract (neg, scale, frac_la hidden bit dropped and the
    fraction left-aligned at bit 31, sticky, is_zero, is_nar) from a quire,
    the shared front half of both readouts. Guard and sticky downstream see
    the full digit magnitude, so a rounding built on these fields is a
    single rounding of the exact sum."""
    L = qfmt.n_limbs
    q = quire_normalize(q, qfmt)
    limbs = q[..., :L].to(torch.int64)
    top = limbs[..., L - 1]
    neg = top < 0
    mag = torch.where(neg[..., None], -limbs, limbs)
    c = torch.zeros_like(top)
    d = []
    for i in range(L):
        t = mag[..., i] + c
        d.append(t & 0xFFFF)
        c = t >> RADIX

    # MSB position over all digits (ascending: the highest nonzero digit wins)
    P = torch.full(top.shape, -1, dtype=torch.int64, device=q.device)
    for i, di in enumerate(d):
        h = _floor_log2_small(torch.clamp(di, min=1))
        P = torch.where(di > 0, 16 * i + h, P)
    i_top = P >> 4
    r = P & 15

    # 48-bit window below the MSB (3 digits) + sticky of everything lower
    zero_d = torch.zeros_like(d[0])
    D2, D1, D0 = zero_d, zero_d, zero_d
    sticky = torch.zeros(top.shape, dtype=torch.bool, device=q.device)
    for i, di in enumerate(d):
        D2 = torch.where(i_top == i, di, D2)
        D1 = torch.where(i_top == i + 1, di, D1)
        D0 = torch.where(i_top == i + 2, di, D0)
        sticky = sticky | ((i_top > i + 2) & (di != 0))
    hi = (D2 << 16) | D1                       # MSB (hidden bit) at 16 + r
    frac_la = ((hi << (16 - r)) & _M32) | (D0 >> r)
    sticky = sticky | ((D0 & ((torch.ones_like(r) << r) - 1)) != 0)

    scale = P - qfmt.bias
    return neg, scale, frac_la, sticky, P < 0, quire_is_nar(q, qfmt)


def quire_read(q: torch.Tensor, qfmt: QuireFmt, *, out_nbits: Optional[int] = None,
               es_out: Optional[int] = None) -> torch.Tensor:
    """quire -> posit codes: the single terminal rounding (PERCIVAL ``qround``).

    RNE against the exact accumulated value. Exact zero -> 0; flagged -> NaR;
    magnitudes beyond the posit range saturate to maxpos/minpos.
    """
    out_n = qfmt.nbits if out_nbits is None else out_nbits
    oesl = _es(qfmt.es if es_out is None else es_out)
    neg, scale, frac_la, sticky, is_zero, is_nar = _readout_fields(q, qfmt)
    code = _encode_fields(neg, scale, frac_la, sticky, out_n, oesl)
    code = torch.where(is_zero, 0, code)
    code = torch.where(is_nar, 1 << (out_n - 1), code)
    return code.to(torch.uint8 if out_n == 8 else torch.uint16)


def _f32_from_fields(neg: torch.Tensor, scale: torch.Tensor, frac_la: torch.Tensor,
                     sticky: torch.Tensor) -> torch.Tensor:
    """RNE-assemble a float32 from (sign, scale, fraction left-aligned at 31,
    sticky): the field convention of ``_encode_fields``, rounded into IEEE.

    Exact single rounding incl. subnormals; overflow -> +-inf, magnitudes
    below half the smallest subnormal -> +-0.
    """
    sig_la = 0x80000000 | (frac_la >> 1)
    sticky = sticky | ((frac_la & 1) != 0)
    sh = torch.clamp(-126 - scale, 0, 24)      # subnormal pre-shift
    mant = (sig_la >> 8) >> sh
    guard = ((sig_la >> 7) >> sh) & 1
    low = sig_la & ((torch.ones_like(sh) << (7 + sh)) - 1)
    st = sticky | (low != 0)
    inc = (guard == 1) & (st | ((mant & 1) == 1))
    mant = mant + inc.to(torch.int64)
    # adding the hidden bit of `mant` lands the biased exponent; a rounding
    # carry increments it for free (subnormals use base 0)
    base = torch.where(sh > 0, 0, scale + 126)
    fbits = (((base & _M32) << 23) + mant) & _M32
    fbits = torch.where(scale >= 128, 0x7F800000, fbits)     # overflow
    fbits = torch.where(scale < -150, 0, fbits)              # underflow
    fbits = fbits | (neg.to(torch.int64) << 31)
    return _bits_to_f32(fbits)


def quire_read_f32(q: torch.Tensor, qfmt: QuireFmt) -> torch.Tensor:
    """quire -> float32: single RNE of the exact sum into the FPU domain.

    Exact zero -> +0; NaR -> NaN; |sum| beyond f32 range -> +-inf.
    """
    neg, scale, frac_la, sticky, is_zero, is_nar = _readout_fields(q, qfmt)
    v = _f32_from_fields(neg, scale, frac_la, sticky)
    v = torch.where(is_zero, 0.0, v)
    nan = _bits_to_f32(torch.full(v.shape, _NAN_BITS, dtype=torch.int64, device=v.device))
    return torch.where(is_nar, nan, v)


# =====================================================================
# quire dataflow: exact GEMM
# =====================================================================

def quire_matmul(a: torch.Tensor, b: torch.Tensor, fmt: PositFmt, *,
                 es_a: Optional[int] = None, es_b: Optional[int] = None,
                 nbits_a: Optional[int] = None, nbits_b: Optional[int] = None,
                 out_nbits: Optional[int] = None, es_out: Optional[int] = None,
                 block_k: int = 256, as_float: bool = False) -> torch.Tensor:
    """Exact-accumulation GEMM: every a[i,k]*b[k,j] lands in a per-output
    quire; one rounding at readout. a: (M, K), b: (K, N) posit codes ->
    (M, N) posit codes (``as_float``: float32 through ``quire_read_f32``).
    ``fmt`` is the widest operand format (it sizes the quire);
    ``nbits_a/nbits_b`` override per operand.

    A block of k (at most ``block_k`` and ``MAX_DEFERRED``, fewer when M*N
    is large) adds all its products at once into int64 limbs, then
    normalizes; two spare limbs above the top take the digits the reference
    drops there (zero for every live product) and are discarded.
    """
    M, K = a.shape
    K2, N = b.shape
    assert K == K2, (tuple(a.shape), tuple(b.shape))
    na_, nb_ = nbits_a or fmt.nbits, nbits_b or fmt.nbits
    qf = QuireFmt(max(na_, nb_), fmt.es)
    ea = _es(fmt.es if es_a is None else es_a)
    eb = _es(fmt.es if es_b is None else es_b)
    eo = ea if es_out is None else _es(es_out)
    L = qf.n_limbs
    W = L + 2
    dev = a.device
    fa = _decode_fields(a, na_, ea)
    fb = _decode_fields(b, nb_, eb)
    limbs = torch.zeros((M * N * W,), dtype=torch.int64, device=dev)
    nar = torch.zeros((M, N), dtype=torch.bool, device=dev)
    base = (torch.arange(M * N, device=dev, dtype=torch.int64) * W).reshape(M, 1, N)
    bk = max(1, min(block_k, MAX_DEFERRED, _MATMUL_BLOCK_ELEMS // max(1, M * N)))
    for k0 in range(0, K, bk):
        ks = slice(k0, k0 + bk)
        sgn, idx, g0, g1, g2, nar_p = _product_parts(
            tuple(f[:, ks, None] for f in fa), tuple(f[None, ks, :] for f in fb),
            na_, nb_, qf.bias, False)
        nar |= nar_p.any(dim=1)
        # dead products (zero/NaR operands) have garbage fields and sgn 0
        at = base + torch.where(sgn != 0, idx, 0)
        for j, g in enumerate((g0, g1, g2)):
            limbs.scatter_add_(0, (at + j).reshape(-1), (sgn * g).reshape(-1))
        limbs = _normalize_limbs(limbs.reshape(M * N, W)[:, :L])
        limbs = torch.nn.functional.pad(limbs, (0, 2)).reshape(-1)
    q = torch.cat([limbs.reshape(M, N, W)[..., :L].to(torch.int32),
                   nar[..., None].to(torch.int32)], dim=-1)
    if as_float:
        return quire_read_f32(q, qf)
    return quire_read(q, qf, out_nbits=out_nbits, es_out=eo)


def quire_dot(a: torch.Tensor, b: torch.Tensor, fmt: PositFmt, *, es: Optional[int] = None,
              es_out: Optional[int] = None, block_k: int = 256) -> torch.Tensor:
    """Exact dot product of two 1-D posit-code vectors -> one posit code."""
    assert a.dim() == b.dim() == 1, (tuple(a.shape), tuple(b.shape))
    out = quire_matmul(a[None, :], b[:, None], fmt, es_a=es, es_b=es, es_out=es_out,
                       block_k=block_k)
    return out[0, 0]
