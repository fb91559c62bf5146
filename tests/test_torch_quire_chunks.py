"""The quire GEMM kernel's chunked accumulation, emulated on the CPU
(``kernels/posit_quire_gemm/ref.py`` ``posit_quire_gemm_chunked_ref``),
against the reference's ``repro.core.quire.quire_matmul`` (through its
``posit_quire_gemm_ref``) and its Pallas ``posit_quire_gemm``
(interpret=True).

The emulation does what ``csrc/posit_quire_gemm.cu`` does: 32-k chunks with
a window anchor per A row and B column, int64 sums of aligned integers
placed once a chunk, the exact per-product placement for elements below
their window, and a split-K sum of normalised quires. The sum is exact, so
every readout is bit-exact; silu and gelu epilogues stay within 1 posit ulp
(``exp``/``tanh`` of XLA and torch differ by a few f32 ulps).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import types as jtypes
from repro.core.codec import posit_encode as jax_encode
from repro.kernels.posit_quire_gemm.posit_quire_gemm import posit_quire_gemm as jax_quire_gemm
from repro.kernels.posit_quire_gemm.ref import posit_quire_gemm_ref as jax_quire_gemm_ref
from repro_torch.core import types
from repro_torch.kernels.posit_quire_gemm import ref
from repro_torch.kernels.posit_quire_gemm.ops import MAX_SPLITS, split_plan

ROWS = {
    "p16xp16": ("p16_1", "p16_1", "p16_1"),
    "p16xp8": ("p16_1", "p8_2", "p16_3"),
    "p8xp16_p8out": ("p8_1", "p16_0", "p8_2"),
    "p8_0": ("p8_0", "p8_0", "p8_0"),
    "p8_3": ("p8_3", "p8_3", "p8_1"),
}
M, K, N = 13, 200, 27   # K off the 32-k chunk and the 128-k stage


def _codes(rng, fmt, shape, kind, scale=1.0):
    """gauss: codes of normal values; all_codes: uniform over every non-NaR
    code; minmax: gauss with +-maxpos and +-minpos in one chunk of a row and
    of a column (spans far beyond any window)."""
    n = fmt.nbits
    dt = np.uint8 if n == 8 else np.uint16
    if kind == "all_codes":
        c = rng.integers(0, (1 << n) - 1, shape)
        c = np.where(c >= 1 << (n - 1), c + 1, c)
        return c.astype(dt)
    x = rng.normal(0, scale, shape).astype(np.float32)
    c = np.array(jax_encode(jnp.asarray(x), n, fmt.es)).astype(np.int64)
    if kind == "minmax":
        maxpos, minpos = (1 << (n - 1)) - 1, 1
        neg = lambda v: (1 << n) - v
        c[0, :4] = [maxpos, minpos, neg(maxpos), neg(minpos)]
        c[:4, 0] = [minpos, neg(maxpos), maxpos, neg(minpos)]
        c[-1, -4:] = [maxpos, 0, minpos, 1 << (n - 1)]      # with a NaR
    return c.astype(dt)


def _inputs(row, kind, seed, k=K):
    rng = np.random.default_rng(seed)
    jf = [jtypes.get_format(x) for x in ROWS[row]]
    tf = [types.get_format(x) for x in ROWS[row]]
    a = _codes(rng, jf[0], (M, k), kind)
    b = _codes(rng, jf[1], (k, N), kind, scale=k ** -0.5)
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32)
    res = rng.normal(0, 1.0, (M, N)).astype(np.float32)
    return jf, tf, [f.es for f in jf], a, b, bias, res


def _spans_window(*fmts):
    """Whether an operand's scales span more than its window: only then can
    an element fall below its anchor (p8 at es 0 spans 12 binades of 21)."""
    return any(2 * ((f.nbits - 2) << f.es) > ref.window(f.nbits) for f in fmts)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _reference(jf, es, a, b, *, bias=None, res=None, act="none", pallas=True):
    """(reference plain version, Pallas interpret) outputs."""
    kw = dict(activation=act, bias=None if bias is None else jnp.asarray(bias),
              residual=None if res is None else jnp.asarray(res))
    jref = np.asarray(jax_quire_gemm_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(es),
                                         a_fmt=jf[0], b_fmt=jf[1], out_fmt=jf[2], **kw))
    if not pallas:
        return jref, None
    pal = np.asarray(jax_quire_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(es, jnp.int32),
                                    a_fmt=jf[0], b_fmt=jf[1], out_fmt=jf[2], interpret=True,
                                    block_m=8, block_n=128, block_k=128, **kw))
    return jref, pal


def _chunked(tf, es, a, b, *, bias=None, res=None, act="none", splits=1):
    return ref.posit_quire_gemm_chunked_ref(
        torch.from_numpy(a), torch.from_numpy(b), es, a_fmt=tf[0], b_fmt=tf[1],
        out_fmt=tf[2], bias=None if bias is None else torch.from_numpy(bias),
        residual=None if res is None else torch.from_numpy(res), activation=act,
        splits=splits).numpy()


def _code_ulps(got, want, n):
    full, half = 1 << n, 1 << (n - 1)
    g, w = (np.asarray(x).astype(np.int64) for x in (got, want))
    g = np.where(g >= half, g - full, g)
    w = np.where(w >= half, w - full, w)
    return int(np.abs(g - w).max())


@pytest.mark.parametrize("kind", ["gauss", "all_codes", "minmax"])
@pytest.mark.parametrize("row", list(ROWS))
def test_chunked_emulation_bit_exact(row, kind):
    jf, tf, es, a, b, _, _ = _inputs(row, kind, seed=len(row) + len(kind))
    got = _chunked(tf, es, a, b)
    jref, pal = _reference(jf, es, a, b)
    np.testing.assert_array_equal(_bits(got), _bits(jref))
    np.testing.assert_array_equal(_bits(got), _bits(pal))
    if kind != "gauss":   # both branches ran where the formats allow it
        count, _ = ref.per_product_share(torch.from_numpy(a), torch.from_numpy(b), es,
                                         a_fmt=tf[0], b_fmt=tf[1])
        assert (count > 0) == _spans_window(tf[0], tf[1])


@pytest.mark.parametrize("k,splits", [(45, 2), (200, 3), (300, 2), (513, 5)])
def test_chunked_split_k_and_ragged_chunks(k, splits):
    """K off the chunk (45, 200, 300, 513), several K splits: each split's
    quire normalised, then summed, as the kernel's cluster does."""
    jf, tf, es, a, b, _, _ = _inputs("p16xp16", "minmax", seed=k, k=k)
    one = _chunked(tf, es, a, b)
    split = _chunked(tf, es, a, b, splits=splits)
    jref, _ = _reference(jf, es, a, b, pallas=False)
    np.testing.assert_array_equal(_bits(split), _bits(one))
    np.testing.assert_array_equal(_bits(one), _bits(jref))


@pytest.mark.parametrize("row", ["p16xp16", "p16xp8", "p8_0"])
@pytest.mark.parametrize("act,has_bias,has_res",
                         [("none", True, False), ("relu", True, True), ("none", False, True)])
def test_chunked_exact_epilogues_bit_exact(row, act, has_bias, has_res):
    jf, tf, es, a, b, bias, res = _inputs(row, "minmax", seed=3)
    kw = dict(bias=bias if has_bias else None, res=res if has_res else None, act=act)
    got = _chunked(tf, es, a, b, splits=2, **kw)
    jref, pal = _reference(jf, es, a, b, **kw)
    np.testing.assert_array_equal(got, jref)
    np.testing.assert_array_equal(got, pal)


@pytest.mark.parametrize("row", ["p16xp16", "p8xp16_p8out"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_chunked_transcendental_epilogues_within_one_ulp(row, act):
    jf, tf, es, a, b, bias, res = _inputs(row, "all_codes", seed=4)
    got = _chunked(tf, es, a, b, bias=bias, res=res, act=act)
    jref, pal = _reference(jf, es, a, b, bias=bias, res=res, act=act)
    assert _code_ulps(got, pal, jf[2].nbits) <= 1
    assert _code_ulps(got, jref, jf[2].nbits) <= 1


@pytest.mark.parametrize("row", list(ROWS))
def test_per_product_share_counts_the_window_rule(row):
    """The share function's count equals a product-by-product count of the
    window rule; a wide span sends products to the per-product branch, and
    operands all within one window send none."""
    _, tf, es, a, b, _, _ = _inputs(row, "all_codes", seed=9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    count, share = ref.per_product_share(ta, tb, es, a_fmt=tf[0], b_fmt=tf[1])
    _, _, _, live_a, low_a = ref._window_parts(ta, tf[0].nbits, es[0], kdim=1)
    _, _, _, live_b, low_b = ref._window_parts(tb, tf[1].nbits, es[1], kdim=0)
    brute = (live_a[:, :, None] & live_b[None] & (low_a[:, :, None] | low_b[None])).sum()
    assert count == int(brute) and share == count / (M * K * N)
    assert (count > 0) == _spans_window(tf[0], tf[1])
    one = torch.full((M, K), 0x40 << (tf[0].nbits - 8), dtype=ta.dtype)   # all 1.0
    onb = torch.full((K, N), 0x40 << (tf[1].nbits - 8), dtype=tb.dtype)
    assert ref.per_product_share(one, onb, es, a_fmt=tf[0], b_fmt=tf[1]) == (0, 0.0)


@pytest.mark.parametrize("m,k,n", [(1, 3072, 3072), (4, 3072, 8192), (4, 8192, 3072),
                                   (4, 3072, 32064), (32, 3072, 8192), (6, 20000, 40),
                                   (4, 7, 5)])
def test_split_plan_fits_one_cluster(m, k, n):
    """At most one cluster of K ranges, each a whole number of 128-k stages,
    covering K."""
    splits, kps = split_plan(m, n, k, 132)
    assert 1 <= splits <= MAX_SPLITS and kps % ref.K_TILE == 0
    assert splits * kps >= k and (splits - 1) * kps < max(k, 1)
