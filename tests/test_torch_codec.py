"""Port codec parity: repro_torch's plain codec and codec wrappers against the
reference's vectorized codec, its Pallas codec kernels (interpret=True) and
the scalar ``ref_codec`` oracle.

Contract: bit-exact. Decode runs exhaustively over every p8 and p16 code for
es 0..3; encode over a boundary sweep plus random f32 (normals, subnormals,
+-0, +-inf, NaN), with and without ftz. Floats compare as bit patterns, so a
NaN must be the same NaN.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import ref_codec
from repro.core.codec import _decode_fields as jax_decode_fields
from repro.core.codec import posit_decode as jax_decode
from repro.core.codec import posit_encode as jax_encode
from repro.kernels.posit_codec.posit_codec import decode_kernel, encode_kernel
from repro_torch.core import codec
from repro_torch.core.types import P8_2, P16_1
from repro_torch.kernels.posit_codec import ops


def _codes(nbits):
    return np.arange(1 << nbits, dtype=np.uint8 if nbits == 8 else np.uint16)


def _f32_bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _encode_inputs(seed=0):
    rng = np.random.default_rng(seed)
    edges = np.asarray([2.0 ** e for e in range(-126, 128)], np.float32)
    parts = [
        rng.normal(0, 1, 20000), rng.normal(0, 1e-3, 5000), rng.normal(0, 1e4, 5000),
        rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32).view(np.float32),
        edges, -edges, edges * 1.5, edges * np.float32(1 + 2.0 ** -23),
        edges * np.float32(1 - 2.0 ** -24),
        np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-42, 1e-45, 3.4e38],
                   np.float32),
    ]
    return np.concatenate([np.asarray(p, np.float32) for p in parts])


@pytest.mark.parametrize("nbits", [8, 16])
@pytest.mark.parametrize("es", [0, 1, 2, 3])
def test_decode_exhaustive_matches_reference(nbits, es):
    codes = _codes(nbits)
    want = _f32_bits(jax_decode(jnp.asarray(codes), nbits, es))
    got = codec.posit_decode(torch.from_numpy(codes), nbits, es).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    # the scalar oracle: exact values, NaR -> the canonical NaN 0x7FC00000
    oracle = np.asarray([ref_codec.ref_decode_float(int(c), nbits, es) for c in codes],
                        np.float32)
    oracle_bits = oracle.view(np.uint32).copy()
    oracle_bits[np.isnan(oracle)] = 0x7FC00000
    np.testing.assert_array_equal(got, oracle_bits)


@pytest.mark.parametrize("nbits", [8, 16])
@pytest.mark.parametrize("es", [0, 1, 2, 3])
@pytest.mark.parametrize("ftz", [False, True])
def test_encode_matches_reference(nbits, es, ftz):
    x = _encode_inputs()
    want = np.asarray(jax_encode(jnp.asarray(x), nbits, es, ftz=ftz))
    got = codec.posit_encode(torch.from_numpy(x), nbits, es, ftz=ftz).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nbits,es", [(8, 0), (8, 3), (16, 1), (16, 2)])
def test_encode_matches_scalar_oracle(nbits, es):
    x = _encode_inputs(seed=1)[::10]
    got = codec.posit_encode(torch.from_numpy(x), nbits, es).numpy()
    want = np.asarray([ref_codec.ref_encode(float(v), nbits, es) for v in x])
    np.testing.assert_array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("nbits", [8, 16])
@pytest.mark.parametrize("es", [0, 2])
def test_decode_fields_match_reference(nbits, es):
    codes = _codes(nbits)
    want = jax_decode_fields(jnp.asarray(codes), nbits, jnp.uint32(es))
    got = codec._decode_fields(torch.from_numpy(codes), nbits, es)
    live = ~(np.asarray(want[3]) | np.asarray(want[4]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g.numpy(), np.int64)[live],
                                      np.asarray(w, np.int64)[live])


@pytest.mark.parametrize("nbits,es", [(8, 0), (8, 2), (16, 1), (16, 3)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_ops_decode_matches_pallas_kernel(nbits, es, out_dtype):
    """The wrapper's CPU route against the Pallas decode kernel (interpret)."""
    codes = np.resize(_codes(nbits), 4000).reshape(40, 100)
    name = "float32" if out_dtype == torch.float32 else "bfloat16"
    want = np.asarray(decode_kernel(jnp.asarray(codes), es, nbits=nbits,
                                    out_dtype_name=name, interpret=True))
    got = ops.decode(torch.from_numpy(codes), es, nbits=nbits, out_dtype=out_dtype)
    assert got.dtype == out_dtype and tuple(got.shape) == codes.shape
    got_bits = got.to(torch.float32).numpy().view(np.uint32)
    want_f = want.astype(np.float32)
    if out_dtype == torch.bfloat16:
        # NaR: XLA's bf16 cast may set the NaN's sign bit; any NaN will do
        nar = codes == (1 << (nbits - 1))
        assert np.isnan(want_f[nar]).all() and np.isnan(got.to(torch.float32).numpy()[nar]).all()
        got_bits, want_f = got_bits[~nar], want_f[~nar]
    np.testing.assert_array_equal(got_bits, want_f.view(np.uint32))


@pytest.mark.parametrize("nbits,es", [(8, 1), (16, 0)])
def test_ops_encode_matches_pallas_kernel(nbits, es):
    x = _encode_inputs(seed=2)[:6000].reshape(60, 100)
    want = np.asarray(encode_kernel(jnp.asarray(x), es, nbits=nbits, interpret=True))
    got = ops.encode(torch.from_numpy(x), es, nbits=nbits).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_is_the_round_trip():
    x = torch.from_numpy(_encode_inputs(seed=3)[:1000])
    for fmt in (P8_2, P16_1):
        q = codec.quantize(x, fmt)
        rt = codec.posit_decode(codec.posit_encode(x, fmt.nbits, fmt.es), fmt.nbits, fmt.es)
        np.testing.assert_array_equal(q.numpy().view(np.uint32), rt.numpy().view(np.uint32))


def test_bf16_decode_of_p8_is_exact():
    codes = torch.from_numpy(_codes(8))
    for es in range(4):
        f = ops.decode(codes, es, nbits=8)
        b = ops.decode(codes, es, nbits=8, out_dtype=torch.bfloat16).to(torch.float32)
        live = np.arange(256) != 128   # NaR: any NaN will do in bf16
        np.testing.assert_array_equal(f.numpy().view(np.uint32)[live],
                                      b.numpy().view(np.uint32)[live])
