"""The decode step's fused KV append and the decode-attention kernel's
split-and-combine order, on the CPU.

* ``ops.decode_attention_append`` (CPU route = its plain version) against
  the reference's ``_store`` (src/repro/models/attention.py) followed by its
  Pallas ``posit_decode_attention`` (interpret=True): the written caches bit
  for bit, a row whose write position is past the cache left as it was, the
  output within tolerance. Head dims 32, 96 and 256; 1, 5, 7 and 10 q-heads a
  KV head; p8, p16 and f32 caches.
* ``ref.posit_decode_attention_split_ref`` (the CUDA kernel's splits of 512
  positions, 16 positions a warp step, warps' online softmax merged in warp
  order, splits combined in split order) against the plain version, and a row's bits whatever the
  other rows of the batch hold.

Tolerance: f32 throughout; the score dot (d terms), the softmax sum and the
PV sum (S terms each) run in other orders and the online softmax rescales,
so with |V| <= vmax the outputs agree within 8 * (d + 2S) * 2^-24 * vmax. A
length-0 row is exact zeros.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codec import posit_decode as jax_decode
from repro.core.codec import posit_encode as jax_encode
from repro.kernels.posit_attention.posit_attention import posit_decode_attention
from repro.models.attention import _store as jax_store
from repro_torch.kernels.posit_attention import ops, ref

U = 2.0 ** -24


def _cache(rng, shape, kv_bits, es):
    x = rng.normal(0, 1, shape).astype(np.float32)
    return np.array(jax_encode(jnp.asarray(x), kv_bits, es)) if kv_bits else x


def _vmax(v, kv_bits, es):
    vals = np.asarray(jax_decode(jnp.asarray(v), kv_bits, es)) if kv_bits else v
    return float(np.abs(vals).max())


@pytest.mark.parametrize("d,g,kv_bits", [
    (32, 1, 8), (32, 5, 16), (32, 7, 0), (32, 10, 8),
    (96, 1, 16), (96, 5, 8), (96, 7, 16), (96, 10, 0),
    (256, 1, 0), (256, 5, 16), (256, 7, 8), (256, 10, 16),
])
def test_append_matches_reference_store_and_attention(d, g, kv_bits):
    B, Hkv, S, es = 4, 2 if g < 10 else 1, 48, 1
    rng = np.random.default_rng(d * 100 + g * 10 + kv_bits)
    q = rng.normal(0, 1, (B, Hkv * g, d)).astype(np.float32)
    kc, vc = (_cache(rng, (B, Hkv, S, d), kv_bits, es) for _ in range(2))
    kn, vn = (rng.normal(0, 1, (B, Hkv, d)).astype(np.float32) for _ in range(2))
    pos = np.array([5, S, S - 1, 0], np.int32)       # row 1's write is dropped
    lens = np.array([6, S, S, 0], np.int32)          # row 3 attends to nothing
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = ops.decode_attention_append(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t, v_t,
        torch.from_numpy(pos), torch.from_numpy(lens), es, kv_bits=kv_bits).numpy()

    policy = SimpleNamespace(kv_cache=SimpleNamespace(nbits=kv_bits, es=es) if kv_bits
                             else None)
    k_ref = np.asarray(jax_store(jnp.asarray(kc), jnp.asarray(kn)[:, :, None], jnp.asarray(pos),
                                 policy))
    v_ref = np.asarray(jax_store(jnp.asarray(vc), jnp.asarray(vn)[:, :, None], jnp.asarray(pos),
                                 policy))
    np.testing.assert_array_equal(k_t.numpy(), k_ref)
    np.testing.assert_array_equal(v_t.numpy(), v_ref)
    np.testing.assert_array_equal(k_t.numpy()[1], kc[1])     # dropped: unchanged
    want = np.asarray(posit_decode_attention(
        jnp.asarray(q), jnp.asarray(k_ref), jnp.asarray(v_ref), jnp.asarray(lens), es,
        kv_bits=kv_bits, block_s=16, interpret=True))
    tol = 8 * (d + 2 * S) * U * _vmax(v_ref, kv_bits, es)
    assert got.shape == (B, Hkv * g, d)
    assert np.abs(got - want).max() <= tol
    assert (got[3] == 0).all()


def _split_inputs(kv_bits, d, g, lengths, S, seed, es=0):
    rng = np.random.default_rng(seed)
    B, Hkv = len(lengths), 2
    q = torch.from_numpy(rng.normal(0, 1, (B, Hkv * g, d)).astype(np.float32))
    k, v = (torch.from_numpy(_cache(rng, (B, Hkv, S, d), kv_bits, es)) for _ in range(2))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize("kv_bits,d,g,S,lengths", [
    (8, 32, 3, 1100, [0, 1, 700, 1100]),        # three splits, one part-filled
    (16, 96, 5, 1030, [1030, 512, 513, 37]),    # split edges
    (0, 256, 7, 600, [600, 0, 511, 100]),       # one warp a block
])
def test_split_order_matches_plain(kv_bits, d, g, S, lengths):
    q, k, v, lens = _split_inputs(kv_bits, d, g, lengths, S, seed=d + S)
    got = ref.posit_decode_attention_split_ref(q, k, v, lens, 0, kv_bits=kv_bits)
    want = ref.posit_decode_attention_ref(q, k, v, lens, 0, kv_bits=kv_bits)
    vmax = float(ref._decoded(k, v, 0, kv_bits)[1].abs().max())
    assert float((got - want).abs().max()) <= 8 * (d + 2 * S) * U * vmax
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())


@pytest.mark.parametrize("kv_bits,d", [(8, 128), (16, 256)])
def test_split_order_row_bits_do_not_depend_on_other_rows(kv_bits, d):
    """Row 2 alone against row 2 beside other rows of other data and
    lengths: the same bits (a row's splits come from its own length)."""
    S = 1100
    q, k, v, lens = _split_inputs(kv_bits, d, 5, [300, 1100, 900, 0], S, seed=1)
    q2, k2, v2, lens2 = _split_inputs(kv_bits, d, 5, [1100, 20, 900, 600], S, seed=2)
    q2[2], k2[2], v2[2] = q[2], k[2], v[2]
    a = ref.posit_decode_attention_split_ref(q, k, v, lens, 0, kv_bits=kv_bits)
    b = ref.posit_decode_attention_split_ref(q2, k2, v2, lens2, 0, kv_bits=kv_bits)
    assert torch.equal(a[2].view(torch.int32), b[2].view(torch.int32))


def test_plan_follows_the_kernel():
    """The CUDA kernel's plan: splits of 512 positions and groups of 8
    q-heads (handed to the launch), as many warps as two blocks an SM leave
    room for (the emulation's copy, held to the kernel's on the card)."""
    assert ops._plan(80, 5) == (1, 1)
    assert ops._plan(4096, 5) == (8, 1)
    assert ops._plan(4097, 16) == (9, 2)
    assert ops._plan(32768, 7) == (64, 1)
    assert ref.kernel_warps(128, 1, 8) == 8       # qwen2.5-14b, p8
    assert ref.kernel_warps(128, 2, 16) == 4      # p16
    assert ref.kernel_warps(96, 2, 16) == 6       # phi3-mini-3.8b, p16
    assert ref.kernel_warps(256, 4, 0) == 1       # f32 rows of 1 KB
