"""Analytic posit round-trip error model over log2-magnitude histograms.

Posit tapered accuracy in one formula: a value with binary scale
``s = floor(log2|x|)`` stored as P(n, es) gets

    k  = floor(s / 2^es)                  regime value
    r  = k + 2   (k >= 0)                 regime run incl. terminator
         1 - k   (k < 0)
    f  = max(0, n - 1 - r - es)           fraction bits (the significand
                                          width the paper's Fig. 1(d)
                                          accuracy wedge is made of)

so precision is maximal near |x| = 1 and decays by one fraction bit per
regime step — *which* binades get the bits is exactly what ``es`` selects.
This module turns a calibration histogram (``calib.observe``) into the
expected round-trip squared relative error for every (p8|p16) x es candidate,
closed-form per binade:

* in-range binade, f fraction bits: RNE on a uniform grid of spacing
  ``2^(s-f)`` over values ``m * 2^s`` with m ~ U[1, 2):
      E[(dx/x)^2] = (2^-2f / 12) * E[1/m^2] = 2^-2f / 24
* saturation (s >= max_scale) / underflow-to-minpos (s < -max_scale): the
  codec clamps to ``v = c * 2^s`` (c = maxpos/2^s resp. minpos/2^s), exactly:
      E[(v/x - 1)^2] = c^2/2 - 2 c ln2 + 1
* regime-truncated exponent (es bits cut off by a long regime, te bits
  missing): representable scales thin out to every ``g = 2^te``-th binade.
  The codec rounds at the *encoding* level (RNE on the code integer, not at
  arithmetic value midpoints — DESIGN.md §8): the first dropped bit is the
  MSB of the truncated exponent field, so a binade at offset ``d = s mod g``
  inside the scale gap rounds down to ``2^(s-d)`` when ``d < g/2`` and up to
  ``2^(s-d+g)`` when ``d >= g/2`` — each a clamp-to-one-value with
  ``c = 2^-d`` resp. ``2^(g-d)``, closed-form exact.

The reference package's model (``calib/errmodel.py``), copied: the same
formulas in the same order, so every function returns the reference's
float bit for bit. ``measured_sq_rel_err`` measures through the port's
codec (``kernels.posit_codec``: the kernels on a CUDA device, their plain
versions on the CPU).
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

from repro_torch.calib.observe import BIN_LO, NBINS, TensorStats
from repro_torch.core.types import ES_MAX, ES_MIN, PositFmt

_LN2 = math.log(2.0)

#: Second moment of m ~ U[1, 2): E[m^2] = 7/3 — converts per-binade relative
#: error into absolute squared error (E[x^2 | binade s] = 7/3 * 4^s).
_M2 = 7.0 / 3.0

#: Every weight-format candidate the calibration search scores.
CANDIDATES = tuple(PositFmt(n, es) for n in (8, 16)
                   for es in range(ES_MIN, ES_MAX + 1))

#: Exact E[rel^2] for a zero-fraction-bit binade (neighbors one binade apart,
#: encoding-level RNE boundary at m = 1.5):
#:   int_1^1.5 (1/m - 1)^2 dm  +  int_1.5^2 (2/m - 1)^2 dm  ~= 0.03834
_F0_SQ_ERR = (1.5 - 2.0 / 3.0 - 2.0 * math.log(1.5)) \
    + (7.0 / 6.0 - 4.0 * math.log(4.0 / 3.0))


def significand_bits(nbits: int, es: int, s: int) -> Tuple[int, int]:
    """(fraction bits, truncated es bits) for binade ``s`` under P(nbits, es).

    The regime-dependent significand width — posit tapered accuracy as an
    integer function of the binade.
    """
    k = math.floor(s / (1 << es))
    r = k + 2 if k >= 0 else 1 - k
    t = nbits - 1 - r                    # bits left after sign + regime
    f = max(0, t - es)
    es_avail = min(es, max(0, t))
    return f, es - es_avail


def _clamp_sq_err(c: float) -> float:
    """E[(c/m - 1)^2] for m ~ U[1, 2): exact clamp-to-one-value error."""
    return c * c / 2.0 - 2.0 * c * _LN2 + 1.0


def expected_sq_rel_err(nbits: int, es: int, s: int) -> float:
    """Expected squared relative round-trip error for values uniform in the
    binade [2^s, 2^(s+1)) encoded to P(nbits, es) and decoded back."""
    max_scale = (nbits - 2) << es
    if s >= max_scale:                       # saturate to maxpos
        return _clamp_sq_err(2.0 ** (max_scale - s))
    if s < -max_scale:                       # round up to minpos (no ftz)
        return _clamp_sq_err(2.0 ** (-max_scale - s))
    f, te = significand_bits(nbits, es, s)
    if te > 0:
        g = 1 << te                          # binades per representable scale
        d = s % g                            # offset inside the scale gap
        c = 2.0 ** (g - d) if d >= g // 2 else 2.0 ** (-d)
        return _clamp_sq_err(c)
    if f == 0:
        return _F0_SQ_ERR
    return 4.0 ** (-f) / 24.0


def _bin_scales() -> np.ndarray:
    return np.arange(BIN_LO, BIN_LO + NBINS)


@functools.lru_cache(maxsize=None)
def _err_profile(nbits: int, es: int) -> np.ndarray:
    """Vector of expected_sq_rel_err over every histogram binade (read-only:
    callers only np.dot against it)."""
    return np.asarray([expected_sq_rel_err(nbits, es, int(s))
                       for s in _bin_scales()])


def tensor_sq_rel_err(stats: TensorStats, fmt: PositFmt) -> float:
    """Histogram-weighted expected squared *relative* round-trip error.

    Zeros encode exactly and contribute 0; the result is a mean over all
    elements (zero mass included in the denominator), matching a measured
    ``mean(((decode(encode(x)) - x) / x)^2, where x != 0 else 0)``.
    """
    return float(np.dot(stats.probs, _err_profile(fmt.nbits, fmt.es)))


def tensor_abs_sq_err(stats: TensorStats, fmt: PositFmt) -> float:
    """Expected *absolute* squared error per element, E[(dx)^2].

    Couples the per-binade relative error with the per-binade magnitude
    (E[x^2 | s] = 7/3 * 4^s for in-binade-uniform values), so binades where
    tapered accuracy runs out of fraction bits are charged by how much signal
    actually lives there — this is the quantity the byte-budgeted search
    minimizes (propagated through x @ W, see calib.search).
    """
    scales = _bin_scales().astype(np.float64)
    mag2 = _M2 * np.exp2(2.0 * scales)
    return float(np.dot(stats.probs,
                        _err_profile(fmt.nbits, fmt.es) * mag2))


def outlier_mass(stats: TensorStats, fmt: PositFmt) -> float:
    """Fraction of (nonzero) mass outside the format's representable range —
    the saturation/underflow witness reported per layer in the artifact."""
    s = _bin_scales()
    out = (s >= fmt.max_scale) | (s < -fmt.max_scale)
    return float(np.sum(stats.probs[out]))


def measured_sq_rel_err(nbits: int, es: int, s: int,
                        n_samples: int = 65536, seed: int = 0, device="cuda") -> float:
    """Mean squared relative round-trip error measured through the codec
    for values uniform in the binade [2^s, 2^(s+1)): the validation oracle
    of the analytic model. Uniform random samples, not a linspace: an even
    grid phase-locks with the 2^f-cell quantization grid."""
    import torch

    from repro_torch.core.device import resolve_device
    from repro_torch.kernels.posit_codec import ops as codec_ops

    m = np.random.default_rng(seed).uniform(1.0, 2.0, n_samples)
    x = (m * 2.0 ** float(s)).astype(np.float32)
    xt = torch.from_numpy(x).to(resolve_device(device))
    back = codec_ops.decode(codec_ops.encode(xt, es, nbits=nbits), es, nbits=nbits)
    back = back.cpu().numpy().astype(np.float64)
    rel = (back - x.astype(np.float64)) / x.astype(np.float64)
    return float(np.mean(rel * rel))
