"""Port softmax parity: the posit softmax front door's CPU route (its plain
version) and ``core.dot.posit_softmax`` against the reference's Pallas
``posit_softmax_kernel`` (interpret=True), its ``posit_softmax_ref`` and
``repro.core.dot.posit_softmax``.

Contract: at most 1 posit ulp in signed code space (posit codes are
value-ordered, so one rounding flip is distance 1): both sides compute an
f32 softmax and encode it, but sum the row in another order and take exp
from another library.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import types as jtypes
from repro.core.codec import posit_encode as jax_encode
from repro.core.dot import posit_softmax as jax_posit_softmax
from repro.kernels.posit_softmax.posit_softmax import posit_softmax_kernel
from repro.kernels.posit_softmax.ref import posit_softmax_ref as jax_softmax_ref
from repro_torch import kernels
from repro_torch.core import types
from repro_torch.core.dot import posit_softmax
from repro_torch.kernels.posit_softmax.ops import MAX_CLUSTER, NARROW_MAX, row_plan, softmax
from repro_torch.kernels.posit_softmax.ref import posit_softmax_ref


def _ulps(got, want, n):
    full, half = 1 << n, 1 << (n - 1)
    g = np.asarray(got).astype(np.int64)
    w = np.asarray(want).astype(np.int64)
    g = np.where(g >= half, g - full, g)
    w = np.where(w >= half, w - full, w)
    return int(np.abs(g - w).max())


def _logit_codes(R, C, nbits, es, seed=14):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (R, C)).astype(np.float32)
    return np.array(jax_encode(jnp.asarray(logits), nbits, es))


@pytest.mark.parametrize("nbits,es", [(8, 0), (16, 1)])
@pytest.mark.parametrize("R,C", [(8, 8), (64, 128), (10, 300)])
def test_softmax_matches_pallas_and_ref(nbits, es, R, C):
    codes = _logit_codes(R, C, nbits, es)
    pallas = np.asarray(posit_softmax_kernel(jnp.asarray(codes), es, nbits=nbits,
                                             interpret=True))
    jref = np.asarray(jax_softmax_ref(jnp.asarray(codes), es, nbits=nbits))
    before = dict(kernels.LAUNCHES)
    got = softmax(torch.from_numpy(codes), es, nbits=nbits).numpy()
    assert kernels.LAUNCHES == before          # the CPU route is the plain version
    assert got.dtype == pallas.dtype and got.shape == (R, C)
    assert _ulps(got, pallas, nbits) <= 1
    assert _ulps(got, jref, nbits) <= 1
    np.testing.assert_array_equal(got, posit_softmax_ref(torch.from_numpy(codes), es,
                                                         nbits=nbits).numpy())


@pytest.mark.parametrize("nbits", [8, 16])
def test_softmax_nar_row_and_wide_row(nbits):
    """A NaR logit makes its row all NaR; a vocabulary-wide row stays within
    1 ulp of the reference."""
    codes = _logit_codes(3, 4096, nbits, 1, seed=3)
    codes[1, 17] = 1 << (nbits - 1)
    got = softmax(torch.from_numpy(codes), 1, nbits=nbits).numpy()
    want = np.asarray(jax_softmax_ref(jnp.asarray(codes), 1, nbits=nbits))
    assert (got[1] == 1 << (nbits - 1)).all() and (want[1] == got[1]).all()
    assert _ulps(got, want, nbits) <= 1


@pytest.mark.parametrize("axis", [-1, 0])
def test_posit_softmax_matches_reference(axis):
    codes = _logit_codes(6, 40, 16, 2, seed=9).reshape(2, 3, 40)
    want = np.asarray(jax_posit_softmax(jnp.asarray(codes), jtypes.P16_2, axis=axis))
    got = posit_softmax(torch.from_numpy(codes), types.P16_2, axis=axis).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _ulps(got, want, 16) <= 1


def test_softmax_refuses_bad_inputs():
    with pytest.raises(ValueError):
        softmax(torch.zeros((2, 3, 4), dtype=torch.uint8), 0, nbits=8)
    with pytest.raises(ValueError):
        softmax(torch.zeros((2, 3), dtype=torch.uint8), 0, nbits=12)


@pytest.mark.parametrize("C", [1, 31, 128, 1024, 1025, 2500, 32064, 152064, 300000])
def test_row_plan_covers_each_row_once(C):
    """The kernel's row split: a warp per row up to NARROW_MAX columns, else a
    cluster of at most MAX_CLUSTER blocks whose chunks cover each column of
    the row exactly once, none empty."""
    cluster, chunk = row_plan(C)
    if C <= NARROW_MAX:
        assert cluster == 0
        lanes = [c for j in range(32) for c in range(j * 32, (j + 1) * 32)]
        assert sorted(c for c in lanes if c < C) == list(range(C))
        return
    assert 1 <= cluster <= MAX_CLUSTER
    cover = np.zeros(C, np.int64)
    for r in range(cluster):
        lo, hi = r * chunk, min(C, (r + 1) * chunk)
        assert hi > lo
        cover[lo:hi] += 1
    assert (cover == 1).all()
    if C >= 32064:
        assert cluster == MAX_CLUSTER   # a vocabulary row spreads over 16 SMs
