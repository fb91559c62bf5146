"""The port's true-posit ALU (``core/alu.py``), its quire ops and the Table-I
fcvt ops (``core/convert.py``) on the CPU, bit for bit against the reference
package (``repro.core.alu``, ``repro.core.convert``) and, on a sample,
against the exact-rational oracle ``repro.core.ref_codec``.

* add / sub / mul on every p8 pair at es 0-3, and on 24,000 sampled p16
  pairs at es 0-3 plus every pair of NaR, zero, +-maxpos, +-minpos and
  their neighbours;
* qclr / qma / qms / qneg / qround: a chain of fused multiply-adds, the
  quire's limbs and its single rounding bit for bit;
* fcvt: all eight ops on every p8 and p16 code, and the float -> posit ops
  on a float sweep (+-0, +-inf, NaN, subnormals, maxpos * 2, magnitudes
  from 2^-140 to 2^120), at es 0-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alu as jalu
from repro.core import convert as jconvert
from repro.core import ref_codec
from repro.core.quire import QuireFmt as JQuireFmt
from repro_torch.core import alu, convert

OPS = ("posit_add", "posit_sub", "posit_mul")


def _codes(n, size, seed):
    return np.random.default_rng(seed).integers(0, 1 << n, size).astype(
        np.uint8 if n == 8 else np.uint16)


def _specials(n):
    """NaR, 0, +-minpos, +-maxpos and their code neighbours."""
    m = 1 << n
    base = [0, 1, 2, (m >> 1) - 2, (m >> 1) - 1, m >> 1]
    return sorted({c % m for c in base + [m - c for c in base]})


def _both(op, a, b, n, es):
    got = getattr(alu, op)(torch.from_numpy(a), torch.from_numpy(b), n, es).numpy()
    want = np.asarray(getattr(jalu, op)(jnp.asarray(a), jnp.asarray(b), n, es))
    return got, want


@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_alu_every_p8_pair(es):
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    for op in OPS:
        got, want = _both(op, a, b, 8, es)
        assert got.dtype == want.dtype == np.uint8
        bad = got != want
        assert not bad.any(), (op, a[bad][:5], b[bad][:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_alu_p16_sampled_and_specials(es):
    sp = np.array(_specials(16), np.uint16)
    a = np.concatenate([_codes(16, 24000, es), np.repeat(sp, len(sp))])
    b = np.concatenate([_codes(16, 24000, 10 + es), np.tile(sp, len(sp))])
    for op in OPS:
        got, want = _both(op, a, b, 16, es)
        assert got.dtype == want.dtype == np.uint16
        bad = got != want
        assert not bad.any(), (op, a[bad][:5], b[bad][:5], got[bad][:5], want[bad][:5])


@pytest.mark.parametrize("n", [8, 16])
def test_alu_against_the_exact_oracle(n):
    """One rounding of the exact sum / product (``ref_codec``, rationals)."""
    for es in (0, 1, 2, 3):
        a, b = _codes(n, 300, 20 + es), _codes(n, 300, 30 + es)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
        add = alu.posit_add(ta, tb, n, es).numpy()
        mul = alu.posit_mul(ta, tb, n, es).numpy()
        for i in range(len(a)):
            assert add[i] == ref_codec.ref_add(int(a[i]), int(b[i]), n, es)
            assert mul[i] == ref_codec.ref_mul(int(a[i]), int(b[i]), n, es)


@pytest.mark.parametrize("n", [8, 16])
def test_quire_ops_bit_exact(n):
    """qclr, then qma and qms of 24 code pairs a row (mixed es) with a qneg
    between, then qround: limbs and codes the reference's."""
    rng = np.random.default_rng(n)
    rows, steps = 32, 24
    a = _codes(n, (steps, rows), 1)
    b = _codes(n, (steps, rows), 2)
    a[3, 0], b[5, 1] = 1 << (n - 1), 1 << (n - 1)       # NaR poisons rows 0 and 1
    ops = rng.integers(0, 3, steps)
    ops[3], ops[5] = 0, 1
    jq = jalu.qclr((rows,), n, es=1)
    tq = alu.qclr((rows,), n, es=1, device="cpu")
    assert tuple(tq.shape) == tuple(jq.shape) and tq.dtype == torch.int32
    for t in range(steps):
        ta, tb = torch.from_numpy(a[t]), torch.from_numpy(b[t])
        if ops[t] == 0:
            jq = jalu.qma(jq, jnp.asarray(a[t]), jnp.asarray(b[t]), n, 1)
            tq = alu.qma(tq, ta, tb, n, 1)
        elif ops[t] == 1:
            jq = jalu.qms(jq, jnp.asarray(a[t]), jnp.asarray(b[t]), n, 2)
            tq = alu.qms(tq, ta, tb, n, 2)
        else:
            jq = jalu.qneg(jq, n)
            tq = alu.qneg(tq, n)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert JQuireFmt(n).limbs_axis == tq.shape[-1]
    for es in (0, 1, 2, 3):
        got = alu.qround(tq, n, es).numpy()
        want = np.asarray(jalu.qround(jq, n, es))
        np.testing.assert_array_equal(got, want)
        assert got[0] == got[1] == 1 << (n - 1)


FCVT_FROM_POSIT = (("fcvt_s_p8", 8), ("fcvt_s_p16", 16), ("fcvt_p8_p8", 8),
                   ("fcvt_p8_p16", 16), ("fcvt_p16_p8", 8), ("fcvt_p16_p16", 16))


@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_fcvt_every_code(es):
    """Every p8 and p16 code through the six ops that read posit codes, the
    posit -> posit ones to the smallest and the largest es_out."""
    for name, n in FCVT_FROM_POSIT:
        codes = np.arange(1 << n).astype(np.uint8 if n == 8 else np.uint16)
        tc, jc = torch.from_numpy(codes), jnp.asarray(codes)
        if name.startswith("fcvt_s_"):
            got = getattr(convert, name)(tc, es).numpy()
            want = np.asarray(getattr(jconvert, name)(jc, es))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
            continue
        for es_out in (0, 3):
            got = getattr(convert, name)(tc, es, es_out).numpy()
            want = np.asarray(getattr(jconvert, name)(jc, es, es_out))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def _float_sweep():
    rng = np.random.default_rng(0)
    mags = np.ldexp(1.0 + rng.random(4000), rng.integers(-140, 121, 4000))
    special = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40, -3e-39,
               np.finfo(np.float32).tiny, np.finfo(np.float32).max, 1.0, -1.0, 0.5]
    # maxpos * 2 and minpos / 2 of every format in reach, and each maxpos itself
    for n in (8, 16):
        for es in range(4):
            maxpos = 2.0 ** ((n - 2) * 2 ** es)
            special += [maxpos, maxpos * 2, -maxpos * 2, 1 / maxpos, 0.5 / maxpos]
    x = np.concatenate([mags * rng.choice([-1.0, 1.0], 4000), np.array(special)])
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["fcvt_p8_s", "fcvt_p16_s"])
def test_fcvt_float_sweep(name):
    x = _float_sweep()
    for es in (0, 1, 2, 3):
        got = getattr(convert, name)(torch.from_numpy(x), es).numpy()
        want = np.asarray(getattr(jconvert, name)(jnp.asarray(x), es))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the oracle on a sample of the sweep (its exact rounding of each value)
    n = 8 if name == "fcvt_p8_s" else 16
    for v in x[::37]:
        if np.isfinite(v):
            assert int(getattr(convert, name)(torch.tensor([v]), 1).item()) == \
                ref_codec.ref_encode(float(v), n, 1)
