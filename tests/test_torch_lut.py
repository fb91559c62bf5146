"""Port LUT codec parity: ``repro_torch.core.lut`` against ``repro.core.lut``.

Contract: bit-exact. Decode compares f32 bit patterns (NaN payloads
included) over every code of every es; encode compares codes over a dense
f32 sweep (every rounding boundary and its two neighbours, powers of two,
random normals at several scales, the saturation and sub-minpos regions,
subnormals, +-0, +-inf, NaN), with and without ``ftz``. The tables
themselves must equal the reference's arrays.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import lut as jlut
from repro_torch.core import codec, lut

ALL_ES = (0, 1, 2, 3)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("es", ALL_ES)
def test_lut_decode_p8_exhaustive(es):
    codes = np.arange(256, dtype=np.uint8)
    got = lut.lut_decode_p8(torch.from_numpy(codes), es).numpy()
    want = np.asarray(jlut.lut_decode_p8(jnp.asarray(codes), es))
    assert (_bits(got) == _bits(want)).all()
    assert (_bits(got) == _bits(codec.posit_decode(torch.from_numpy(codes), 8, es))).all()


@pytest.mark.parametrize("es", ALL_ES)
def test_lut_decode_p16_exhaustive(es):
    codes = np.arange(65536, dtype=np.uint16)
    got = lut.lut_decode_p16(torch.from_numpy(codes), es).numpy()
    want = np.asarray(jlut.lut_decode_p16(jnp.asarray(codes), es))
    assert (_bits(got) == _bits(want)).all()
    assert (_bits(got) == _bits(codec.posit_decode(torch.from_numpy(codes), 16, es))).all()


def test_tables_equal_the_reference():
    np.testing.assert_array_equal(_bits(lut._p8_decode_table()),
                                  _bits(jlut._p8_decode_table()))
    for got, want in zip(lut._p16_decode_tables(), jlut._p16_decode_tables()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32) if got.dtype == np.float32 else got,
                                      want.view(np.uint32) if want.dtype == np.float32 else want)
    for ftz in (False, True):
        for got, want in zip(lut._p8_encode_tables(ftz), jlut._p8_encode_tables(ftz)):
            np.testing.assert_array_equal(got, want)


def _encode_sweep() -> np.ndarray:
    rng = np.random.default_rng(42)
    parts = [
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32),
        (np.float32(2.0) ** rng.integers(-60, 60, 4000)
         * rng.choice([-1, 1], 4000)).astype(np.float32),
        rng.normal(0, 1, 20000).astype(np.float32),
        rng.normal(0, 1e14, 4000).astype(np.float32),    # saturation
        rng.normal(0, 1e-14, 4000).astype(np.float32),   # below minpos
        rng.integers(0, 1 << 32, 4000, dtype=np.uint64).astype(np.uint32).view(np.float32),
        np.array([1e-45, -1e-45, 1e-40, -1e-40, 2.0 ** -149, -(2.0 ** -149),
                  2.0 ** -126, -(2.0 ** -126)], np.float32),   # subnormals
    ]
    for es in ALL_ES:
        for ftz in (False, True):
            mids = jlut._p8_encode_tables(ftz)[1][es]
            parts += [mids, np.nextafter(mids, np.float32(np.inf)),
                      np.nextafter(mids, np.float32(-np.inf)), -mids]
            minpos = np.float32(2.0) ** -(6 << es)
            parts.append(np.array([minpos, minpos / 2, np.nextafter(minpos / 2, 1),
                                   np.nextafter(minpos / 2, 0), -minpos / 2], np.float32))
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("es", ALL_ES)
@pytest.mark.parametrize("ftz", [False, True])
def test_lut_encode_p8_sweep(es, ftz):
    xs = _encode_sweep()
    got = lut.lut_encode_p8(torch.from_numpy(xs), es, ftz=ftz).numpy()
    want = np.asarray(jlut.lut_encode_p8(jnp.asarray(xs), es, ftz=ftz))
    assert got.dtype == np.uint8
    bad = got != want
    assert not bad.any(), (xs[bad][:10], got[bad][:10], want[bad][:10])
    np.testing.assert_array_equal(
        got, np.asarray(jcodec.posit_encode(jnp.asarray(xs), 8, es, ftz=ftz)))


@pytest.mark.parametrize("impl", ["auto", "lut", "bits"])
@pytest.mark.parametrize("nbits", [8, 16])
def test_with_impl_matches_reference(impl, nbits):
    """decode_with_impl / encode_with_impl give the reference's bits under
    every codec_impl; 'auto' resolves as the reference does on its CPU
    backend (the p8 decode to the tables, everything else to the pipeline)."""
    rng = np.random.default_rng(nbits)
    codes = np.arange(1 << nbits, dtype=np.uint8 if nbits == 8 else np.uint16)
    got = lut.decode_with_impl(torch.from_numpy(codes), nbits, 1, impl).numpy()
    want = np.asarray(jlut.decode_with_impl(jnp.asarray(codes), nbits, 1, impl))
    assert (_bits(got) == _bits(want)).all()
    xs = np.concatenate([rng.normal(0, s, 5000) for s in (1e-3, 1.0, 1e3)]).astype(np.float32)
    got_c = lut.encode_with_impl(torch.from_numpy(xs), nbits, 2, impl).numpy()
    want_c = np.asarray(jlut.encode_with_impl(jnp.asarray(xs), nbits, 2, impl))
    np.testing.assert_array_equal(got_c, want_c)
    for op in ("decode", "encode"):
        assert lut.resolve_codec_impl(impl, nbits, op, "cpu") == \
            jlut.resolve_codec_impl(impl, nbits, op)


def test_resolve_codec_impl_keys_on_the_device_type():
    assert lut.resolve_codec_impl("auto", 8, "decode", "cuda") == "lut"
    assert lut.resolve_codec_impl("auto", 16, "decode", "cuda") == "bits"
    assert lut.resolve_codec_impl("auto", 8, "encode", "cuda") == "bits"
    assert lut.resolve_codec_impl("auto", 8, "decode", "meta") == "bits"
    with pytest.raises(ValueError):
        lut.resolve_codec_impl("table")
    with pytest.raises(ValueError):
        jlut.resolve_codec_impl("table")
