"""Port decode-attention parity: ``kernels.posit_attention.ops.decode_attention``
(CPU route = its plain version) against the reference's Pallas
``posit_decode_attention`` (interpret=True) and its length-bounded tiled path.

Cases: kv_bits 0/8/16, GQA 2:1 and 4:1, ragged lengths including 0 and S,
and rolling (lengths past S clamp to S).

Tolerance: everything is f32 on both sides; the score dot (d terms), the
softmax sum and the PV sum (S terms each) run in other orders and the online
softmax rescales by exp(m_old - m_new), so with |V| <= vmax the outputs agree
within 8 * (d + 2S) * 2^-24 * vmax. A length-0 row is exact zeros.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.codec import posit_decode as jax_decode
from repro.core.codec import posit_encode as jax_encode
from repro.kernels.posit_attention import ops as jax_ops
from repro.kernels.posit_attention.posit_attention import posit_decode_attention
from repro_torch.kernels.posit_attention import ops

U = 2.0 ** -24
S, D = 64, 32


def _inputs(kv_bits, es, B, Hq, Hkv, lengths, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Hq, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Hkv, S, D)).astype(np.float32)
    if kv_bits:
        k = np.asarray(jax_encode(jnp.asarray(k), kv_bits, es))
        v = np.asarray(jax_encode(jnp.asarray(v), kv_bits, es))
        vmax = float(np.abs(np.asarray(jax_decode(jnp.asarray(v), kv_bits, es))).max())
    else:
        vmax = float(np.abs(v).max())
    return q, k, v, np.asarray(lengths, np.int32), vmax


@pytest.mark.parametrize("kv_bits,es", [(8, 0), (8, 2), (16, 1), (0, 0)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 2)])
def test_decode_attention_matches_reference(kv_bits, es, Hq, Hkv):
    lengths = [0, 1, 37, S]
    q, k, v, lens, vmax = _inputs(kv_bits, es, 4, Hq, Hkv, lengths, seed=Hq + kv_bits)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lens), es, kv_bits=kv_bits).numpy()
    pallas = np.asarray(posit_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), es,
        kv_bits=kv_bits, block_s=16, interpret=True))
    tiled = np.asarray(jax_ops.posit_decode_attention_tiled(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), es,
        kv_bits=kv_bits, block_s=16))
    tol = 8 * (D + 2 * S) * U * vmax
    assert got.shape == (4, Hq, D)
    assert np.abs(got - pallas).max() <= tol
    assert np.abs(got - tiled).max() <= tol
    assert (got[0] == 0).all()


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_rolling_clamps_lengths(kv_bits):
    lengths = [S + 5, 3 * S, 10, 0]
    q, k, v, lens, vmax = _inputs(kv_bits, 1, 4, 4, 2, lengths, seed=3)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lens), 1, kv_bits=kv_bits,
                               rolling=True).numpy()
    want = np.asarray(jax_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), 1,
        kv_bits=kv_bits, impl="tiled", rolling=True))
    assert np.abs(got - want).max() <= 8 * (D + 2 * S) * U * vmax
    full = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                torch.full((4,), S, dtype=torch.int32), 1,
                                kv_bits=kv_bits).numpy()
    np.testing.assert_array_equal(got[:2], full[:2])


def test_masked_slots_cannot_leak_nar():
    """Stale NaR codes past a row's length stay out of its output."""
    q, k, v, lens, _ = _inputs(8, 0, 2, 4, 2, [5, 0], seed=4)
    k, v = k.copy(), v.copy()
    k[:, :, 5:] = 0x80
    v[:, :, 5:] = 0x80
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               torch.from_numpy(lens), 0, kv_bits=8).numpy()
    assert np.isfinite(got).all() and (got[1] == 0).all()


def test_bf16_float_cache_and_scale():
    q, k, v, lens, vmax = _inputs(0, 0, 2, 4, 4, [S, 17], seed=5)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    got = ops.decode_attention(torch.from_numpy(q), kb, vb, torch.from_numpy(lens), 0,
                               kv_bits=0, scale=0.3).numpy()
    want = np.asarray(posit_decode_attention(
        jnp.asarray(q), jnp.asarray(kb.to(torch.float32).numpy()),
        jnp.asarray(vb.to(torch.float32).numpy()), jnp.asarray(lens), 0, kv_bits=0,
        scale=0.3, block_s=32, interpret=True))
    assert np.abs(got - want).max() <= 8 * (D + 2 * S) * U * vmax
