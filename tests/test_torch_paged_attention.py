"""Paged decode attention on the CPU: ``ops.decode_attention_paged`` /
``ops.decode_attention_append_paged`` (CPU route = their plain versions) and
``ref.posit_decode_attention_paged_split_ref`` (the CUDA kernel's splits and
table addressing, emulated) against the reference.

* Both against the reference's ``posit_decode_attention_paged`` at bt 1, 3
  and 16 and head_dim 32, 96 and 128, over shuffled pools with sentinel
  tails and NaR-filled recycled pages past each row's length, within
  8 * (d + 2S) * 2^-24 * max|V| (the bound of tests/test_torch_attention.py:
  f32 throughout, the sums in other orders). Active rows only: a row whose
  length runs into empty (sentinel) entries reads zeros in the port, and
  the reference's gather reads the clamped block N - 1 there (ROADMAP
  Queue 3); such a row (an inactive slot, every entry empty) is exact zeros
  in the port.
* The paged append's pool codes bit for bit against the reference's
  ``_store_paged``; a write past W * bt is dropped.
* The paged emulation bit for bit against the dense emulation on the
  de-paged cache (``ref.depage``), and the paged plain version bit for bit
  against the dense plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pcsr as jpcsr
from repro.core.codec import posit_decode as jax_decode
from repro.core.codec import posit_encode as jax_encode
from repro.kernels.posit_attention.ops import posit_decode_attention_paged
from repro.models.attention import _store_paged as jax_store_paged
from repro_torch.kernels.posit_attention import ops, ref

U = 2.0 ** -24
HKV, G = 2, 3


def _nar(kv_bits):
    return {8: 0x80, 16: 0x8000}.get(kv_bits, np.nan)


def _paged(rng, kv_bits, es, bt, W, lengths, d, extra=5):
    """Pools (N, HKV, bt, d) and a table (B, W): row b's first
    ceil(len / bt) pages at shuffled block ids (every entry of a row with
    length < 0 empty: an inactive slot), the rest of its entries >= N; every
    unused row of the pool NaR. Returns numpy pools, table, the live V's
    max |value|."""
    B = len(lengths)
    N = B * W + extra
    ids = rng.permutation(N)[:B * W].reshape(B, W).astype(np.int32)
    dt = {8: np.uint8, 16: np.uint16}.get(kv_bits, np.float32)
    pools, vmax = [], 0.0
    for which in range(2):
        pool = np.full((N, HKV, bt, d), _nar(kv_bits), dt)
        for b, n in enumerate(lengths):
            x = rng.normal(0, 1, (HKV, max(n, 0), d)).astype(np.float32)
            if kv_bits:
                x = np.asarray(jax_encode(jnp.asarray(x), kv_bits, es))
                vals = np.asarray(jax_decode(jnp.asarray(x), kv_bits, es))
            else:
                vals = x
            if which == 1 and n > 0:
                vmax = max(vmax, float(np.abs(vals).max()))
            for p in range(max(n, 0)):
                pool[ids[b, p // bt], :, p % bt] = x[:, p]
        pools.append(pool)
    table = ids.copy()
    for b, n in enumerate(lengths):
        table[b, (-(-n // bt) if n >= 0 else 0):] = N + 3 * (b % 2)
    return pools[0], pools[1], table, vmax


CASES = [(bt, d, kv_bits) for bt, d, kv_bits in zip(
    (1, 1, 1, 3, 3, 3, 16, 16, 16), (32, 96, 128) * 3, (8, 16, 0, 16, 0, 8, 0, 8, 16))]


@pytest.mark.parametrize("bt,d,kv_bits", CASES)
def test_paged_plain_and_emulation_match_reference(bt, d, kv_bits):
    es = 1 if kv_bits else 0
    rng = np.random.default_rng(bt * 1000 + d + kv_bits)
    W = -(-600 // bt)
    S = W * bt
    # rows: empty, one position, ragged mid (crossing a split), full, inactive
    lengths = [0, 1, 517, S, -1]
    kp, vp, table, vmax = _paged(rng, kv_bits, es, bt, W, lengths, d)
    lens = np.array([0, 1, 517, S, 9], np.int32)      # the inactive row still counts up
    q = rng.normal(0, 1, (len(lengths), HKV * G, d)).astype(np.float32)
    want = np.asarray(posit_decode_attention_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens), es, kv_bits=kv_bits))
    args = (torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(table), torch.from_numpy(lens), es)
    plain = ops.decode_attention_paged(*args, kv_bits=kv_bits).numpy()
    split = ref.posit_decode_attention_paged_split_ref(*args, kv_bits=kv_bits).numpy()
    tol = 8 * (d + 2 * S) * U * vmax
    active = slice(0, 4)
    for got in (plain, split):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert np.abs(got[active] - want[active]).max() <= tol
        assert (got[0] == 0).all() and (got[4] == 0).all()


@pytest.mark.parametrize("kv_bits,es", [(8, 0), (8, 2), (16, 1), (0, 0)])
@pytest.mark.parametrize("bt", [1, 3, 16])
def test_paged_append_codes_match_reference_store(kv_bits, es, bt):
    d = 32
    rng = np.random.default_rng(kv_bits * 10 + es + bt)
    W = -(-40 // bt)
    lengths = [5, 17, W * bt - 1, -1]
    kp, vp, table, _ = _paged(rng, kv_bits, es, bt, W, lengths, d)
    # each row writes at its length: rows 0-2 into their last (or a fresh,
    # here empty and so dropped) page, row 3 (inactive) through a sentinel
    pos = np.array([5, 16, W * bt - 1, 7], np.int32)
    kn, vn = (rng.normal(0, 1, (4, HKV, d)).astype(np.float32) for _ in range(2))
    q = rng.normal(0, 1, (4, HKV * G, d)).astype(np.float32)
    fmt = None if not kv_bits else f"p{kv_bits}_{es}"
    jpol = jpcsr.TransPolicy.from_names(kv_cache=fmt, compute_dtype="f32")
    jtable = jnp.asarray(table)
    bids = jnp.take_along_axis(jtable, jnp.asarray(pos // bt)[:, None], axis=1)[:, 0]
    offs = jnp.asarray(pos % bt)
    k_want = np.asarray(jax_store_paged(jnp.asarray(kp), jnp.asarray(kn)[:, :, None], bids,
                                        offs, jpol))
    v_want = np.asarray(jax_store_paged(jnp.asarray(vp), jnp.asarray(vn)[:, :, None], bids,
                                        offs, jpol))
    k_t, v_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    lens = torch.from_numpy(pos + 1)
    out = ops.decode_attention_append_paged(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), k_t, v_t,
        torch.from_numpy(table), torch.from_numpy(pos), lens, es, kv_bits=kv_bits)
    if kv_bits:
        np.testing.assert_array_equal(k_t.numpy(), k_want)
        np.testing.assert_array_equal(v_t.numpy(), v_want)
    else:
        np.testing.assert_array_equal(k_t.numpy().view(np.int32), k_want.view(np.int32))
        np.testing.assert_array_equal(v_t.numpy().view(np.int32), v_want.view(np.int32))
    again = ops.decode_attention_paged(torch.from_numpy(q), k_t, v_t, torch.from_numpy(table),
                                       lens, es, kv_bits=kv_bits)
    assert torch.equal(out, again)


def test_paged_append_drops_writes_past_the_table():
    rng = np.random.default_rng(5)
    kp, vp, table, _ = _paged(rng, 8, 0, 4, 3, [12, 12], 32)
    k_t, v_t = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    new = torch.from_numpy(rng.normal(0, 1, (2, HKV, 32)).astype(np.float32))
    ref.store_row_paged(k_t, new, torch.from_numpy(table),
                        torch.tensor([12, -1], dtype=torch.int32), 0, kv_bits=8)
    np.testing.assert_array_equal(k_t.numpy(), kp)


@pytest.mark.parametrize("kv_bits,bt", [(8, 1), (16, 3), (0, 16), (8, 32)])
def test_paged_emulation_bit_for_bit_dense_on_depaged_cache(kv_bits, bt):
    d = 32
    rng = np.random.default_rng(77 + bt)
    W = -(-1100 // bt)
    S = W * bt
    lengths = [0, 3, 700, S, -1]
    kp, vp, table, _ = _paged(rng, kv_bits, 1, bt, W, lengths, d)
    lens = torch.tensor([0, 3, 700, S, 40], dtype=torch.int32)
    q = torch.from_numpy(rng.normal(0, 1, (5, HKV * G, d)).astype(np.float32))
    kp, vp, table = torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table)
    kd, vd = ref.depage(kp, table), ref.depage(vp, table)
    assert kd.shape == (5, HKV, S, d)
    paged = ref.posit_decode_attention_paged_split_ref(q, kp, vp, table, lens, 1,
                                                       kv_bits=kv_bits)
    dense = ref.posit_decode_attention_split_ref(q, kd, vd, lens, 1, kv_bits=kv_bits)
    assert torch.equal(paged.view(torch.int32), dense.view(torch.int32))
    plain = ops.decode_attention_paged(q, kp, vp, table, lens, 1, kv_bits=kv_bits)
    dense_plain = ops.decode_attention(q, kd, vd, lens, 1, kv_bits=kv_bits)
    assert torch.equal(plain.view(torch.int32), dense_plain.view(torch.int32))
    assert (paged[4] == 0).all()
