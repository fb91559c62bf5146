"""The analytic posit error model (``calib/errmodel.py``, a copy of the
reference's) against ``repro.calib.errmodel``: every function on every
candidate format and every histogram binade (and past both ends) equal bit
for bit; the histogram-weighted errors on random histograms bit for bit;
``measured_sq_rel_err`` through the port's codec bit for bit the
reference's through its own, on every candidate at binades inside, at and
past each format's range."""
import numpy as np
import pytest

from repro.calib import errmodel as jerr
from repro.calib import observe as jobserve
from repro_torch.calib import errmodel, observe

BINADES = range(observe.BIN_LO - 4, observe.BIN_HI + 5)
CANDS = [(c.nbits, c.es) for c in errmodel.CANDIDATES]


def test_candidates_and_bins_are_the_reference():
    assert [(c.nbits, c.es, c.name, c.max_scale) for c in errmodel.CANDIDATES] == \
        [(c.nbits, c.es, c.name, c.max_scale) for c in jerr.CANDIDATES]
    assert (observe.BIN_LO, observe.NBINS, observe.BIN_HI, observe.KINDS) == \
        (jobserve.BIN_LO, jobserve.NBINS, jobserve.BIN_HI, jobserve.KINDS)


@pytest.mark.parametrize("nbits,es", CANDS)
def test_per_binade_functions_bit_for_bit(nbits, es):
    for s in BINADES:
        assert errmodel.significand_bits(nbits, es, s) == jerr.significand_bits(nbits, es, s)
        a, b = errmodel.expected_sq_rel_err(nbits, es, s), jerr.expected_sq_rel_err(nbits, es, s)
        assert a.hex() == b.hex(), (nbits, es, s)
    np.testing.assert_array_equal(errmodel._err_profile(nbits, es), jerr._err_profile(nbits, es))


def _stats_pair(seed: int):
    rng = np.random.default_rng(seed)
    hist = np.zeros(observe.NBINS)
    lo = int(rng.integers(0, observe.NBINS - 40))
    hist[lo:lo + 40] = rng.integers(0, 10_000, 40)
    hist[rng.integers(0, observe.NBINS, 3)] += 7          # a few outliers anywhere
    zeros = float(rng.integers(0, 500))
    pair = []
    for mod in (jobserve, observe):
        st = mod.TensorStats()
        st.hist = hist.copy()
        st.n = float(hist.sum()) + zeros
        st.zeros = zeros
        st.sum_sq = float(rng.uniform(1, 100))
        pair.append(st)
    return pair


@pytest.mark.parametrize("seed", range(6))
def test_histogram_weighted_errors_bit_for_bit(seed):
    want, got = _stats_pair(seed)
    for jc, tc in zip(jerr.CANDIDATES, errmodel.CANDIDATES):
        for fn in ("tensor_sq_rel_err", "tensor_abs_sq_err", "outlier_mass"):
            a, b = getattr(errmodel, fn)(got, tc), getattr(jerr, fn)(want, jc)
            assert a.hex() == b.hex(), (fn, tc)


@pytest.mark.parametrize("nbits,es", CANDS)
def test_measured_error_through_the_port_codec(nbits, es):
    top = (nbits - 2) << es
    for s in sorted({-top - 1, -top, -3, 0, 1, top - 1, top}):
        a = errmodel.measured_sq_rel_err(nbits, es, s, n_samples=2048, seed=s & 7,
                                          device="cpu")
        b = jerr.measured_sq_rel_err(nbits, es, s, n_samples=2048, seed=s & 7)
        assert a.hex() == b.hex(), (nbits, es, s, a, b)
