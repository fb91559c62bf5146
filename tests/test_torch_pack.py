"""Port packed-p8 lanes parity: ``repro_torch.core.pack`` against
``repro.core.pack``, bit-exact, for even and odd K and with a leading
(stacked-layer) batch dim."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import pack as jpack
from repro_torch.core import pack

SHAPES = [(8, 5), (7, 3), (1, 4), (2, 33, 6), (3, 64, 9)]


def _codes(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_and_unpack_match_reference(shape):
    codes = _codes(shape, len(shape) * 100 + shape[-2])
    got = pack.pack_p8(torch.from_numpy(codes))
    want = np.asarray(jpack.pack_p8(jnp.asarray(codes)))
    assert got.dtype == torch.uint16 and got.shape == want.shape
    assert got.shape[-2] == pack.packed_half_k(shape[-2]) == jpack.packed_half_k(shape[-2])
    np.testing.assert_array_equal(got.numpy(), want)
    k = shape[-2]
    back = pack.unpack_p8(got, k)
    np.testing.assert_array_equal(back.numpy(), codes)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jpack.unpack_p8(jnp.asarray(want), k)))
    # without k, an odd pack keeps its zero pad row
    full = pack.unpack_p8(got).numpy()
    np.testing.assert_array_equal(full, np.asarray(jpack.unpack_p8(jnp.asarray(want))))
    if k % 2:
        assert (full[..., -1, :] == 0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("es", [0, 3])
@pytest.mark.parametrize("impl", ["bits", "lut"])
def test_packed_decode_matches_reference(shape, es, impl):
    codes = _codes(shape, es + shape[-1])
    packed = jpack.pack_p8(jnp.asarray(codes))
    k = shape[-2]
    got = pack.packed_decode_p8(torch.from_numpy(np.array(packed)), es, codec_impl=impl,
                                k=k).numpy()
    want = np.asarray(jpack.packed_decode_p8(packed, es, codec_impl=impl, k=k))
    assert got.shape == want.shape == codes.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("k", [8, 7, 1])
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_split_activations_matches_reference(k, lead):
    x = np.random.default_rng(k).normal(0, 1, lead + (k,)).astype(np.float32)
    kh = pack.packed_half_k(k)
    got = pack.split_activations(torch.from_numpy(x), kh)
    want = jpack.split_activations(jnp.asarray(x), kh)
    for g, w in zip(got, want):
        assert g.shape == w.shape == lead + (kh,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
