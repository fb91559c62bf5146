"""``posit_dot``'s three dataflows, ``posit_gemv`` and ``gemm(impl=...)`` on
the CPU against the reference package (``repro.core.dot``,
``repro.kernels.posit_gemm.ops``), on identical numpy inputs from a seed.

Each format pair (p8 x p8, p16 x p16, p8 x p16, p8 x f32, f32 x f32, p8 x
packed p8) runs fused, unfused and (all-posit pairs) quire, with ``es_*``
overrides and the epilogue ``silu(y + bias) + residual``:
* a posit rd within 1 posit ulp of the reference (an f32 sum in another
  order, or silu one f32 ulp apart, can flip the last rounding); the
  quire's single rounding of the exact sum bit for bit;
* an f32 rd within 1e-5 relative of the reference's sums;
* fused and unfused bit for bit the same in the port, as in the reference
  (tests/test_dot_pcsr.py::test_fused_equals_unfused_numerics): the decode
  is exact and both run the same GEMM kernel order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core.dot import posit_dot as jdot
from repro.core.dot import posit_gemv as jgemv
from repro.core.pack import pack_p8 as jpack
from repro.core.pcsr import OperandSlots as JOS
from repro.kernels.posit_gemm.ops import gemm as jgemm
import repro_torch.core as tc
from repro_torch.core.pcsr import OperandSlots as TOS
from repro_torch.kernels.posit_gemm import ops as gemm_ops

# (rs1, rs2, rd, packed rs2, es_a, es_b, es_out)
PAIRS = {
    "p8xp8": ("P8_0", "P8_0", "P8_0", False, 1, 2, 1),
    "p16xp16": ("P16_1", "P16_1", "P16_1", False, 2, 0, 1),
    "p8xp16": ("P8_1", "P16_1", "F32", False, 0, 2, None),
    "p8xf32": ("P8_0", "F32", "F32", False, 2, None, None),
    "f32xf32": ("F32", "F32", "F32", False, None, None, None),
    "p8xpacked": ("P8_0", "P8_0", "P16_1", True, 1, 1, 2),
}
M, K, N = 8, 41, 24


def _fmt(name):
    return getattr(jc, name), getattr(tc, name)


def _encode(x: np.ndarray, fmt) -> jnp.ndarray:
    """Codes of ``x`` (the port's plain encoder, bit for bit the reference's:
    tests/test_torch_codec.py), handed to both packages."""
    return jnp.asarray(tc.posit_encode(torch.from_numpy(x), fmt.nbits, fmt.es).numpy())


def _inputs(key, lead=(3,), seed=0):
    r1, r2, rd, packed, *_ = PAIRS[key]
    rng = np.random.default_rng(seed)
    a = rng.normal(size=lead + (M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    bias = rng.normal(size=(N,)).astype(np.float32)
    res = rng.normal(size=lead + (M, N)).astype(np.float32)
    f1, f2 = _fmt(r1)[0], _fmt(r2)[0]
    ja = _encode(a, f1) if isinstance(f1, jc.PositFmt) else jnp.asarray(a)
    jb = _encode(b, f2) if isinstance(f2, jc.PositFmt) else jnp.asarray(b)
    if packed:
        jb = jpack(jb)
    return ja, jb, jnp.asarray(bias), jnp.asarray(res)


def _slots(key, dataflow="fused"):
    r1, r2, rd, packed, *_ = PAIRS[key]
    (j1, t1), (j2, t2), (jd, td) = _fmt(r1), _fmt(r2), _fmt(rd)
    return (JOS(rs1=j1, rs2=j2, rd=jd, dataflow=dataflow, rs2_packed=packed),
            TOS(rs1=t1, rs2=t2, rd=td, dataflow=dataflow, rs2_packed=packed))


def _t(x):
    return torch.from_numpy(np.array(x))


def _ulps(got, want, nbits):
    d = (got.astype(np.int64) - want.astype(np.int64)) % (1 << nbits)
    return np.minimum(d, (1 << nbits) - d)


def _close(got, want, rd):
    assert got.shape == want.shape and got.dtype == want.dtype
    if isinstance(rd, jc.PositFmt):
        assert _ulps(got, want, rd.nbits).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _impls(key):
    r1, r2 = PAIRS[key][:2]
    posit = r1 != "F32" and r2 != "F32"
    return ("fused", "unfused") + (("quire",) if posit else ())


@pytest.mark.parametrize("key", list(PAIRS))
def test_dataflows_match_reference(key):
    js, ts = _slots(key)
    es = dict(zip(("es_a", "es_b", "es_out"), PAIRS[key][4:]))
    ja, jb, jbias, jres = _inputs(key)
    rd = js.rd
    outs = {}
    for impl in _impls(key):
        # the reference's quire dataflow contracts 2-D operands; its f32 sums
        # are the same per 2-D slice
        a2, r2 = (ja[0], jres[0]) if impl == "quire" else (ja, jres)
        want = np.asarray(jdot(a2, jb, js, impl=impl, bias=jbias, activation="silu",
                               residual=r2, **es))
        got = tc.posit_dot(_t(a2), _t(jb), ts, impl=impl, bias=_t(jbias), activation="silu",
                           residual=_t(r2), **es).numpy()
        if impl == "quire" and isinstance(rd, jc.PositFmt):
            np.testing.assert_array_equal(got, want)
        else:
            _close(got, want, rd)
        outs[impl] = got
    np.testing.assert_array_equal(outs["fused"], outs["unfused"])


@pytest.mark.parametrize("key", ["p8xp8", "p16xp16", "p8xpacked"])
def test_quire_without_epilogue_is_the_exact_rounding(key):
    """No epilogue: one rounding of the exact sum straight into rd, bit for
    bit the reference's, fused and unfused within 1 ulp of it."""
    js, ts = _slots(key)
    ja, jb, _, _ = _inputs(key, lead=())
    want = np.asarray(jdot(ja, jb, js, impl="quire"))
    np.testing.assert_array_equal(tc.posit_dot(_t(ja), _t(jb), ts, impl="quire").numpy(), want)
    for impl in ("fused", "unfused"):
        got = tc.posit_dot(_t(ja), _t(jb), ts, impl=impl).numpy()
        assert _ulps(got, want, js.rd.nbits).max() <= 1


@pytest.mark.parametrize("n", [4, 256])
@pytest.mark.parametrize("fmt", ["P8_0", "P16_1"])
def test_posit_gemv_matches_reference(fmt, n):
    """The paper's GEMV (section IV-C): A (n, n) @ x (n,) with f32 rd, the
    benchmark's slots, fused and unfused."""
    jf, tf = _fmt(fmt)
    rng = np.random.default_rng(n)
    A = _encode(rng.normal(size=(n, n)).astype(np.float32), jf)
    x = _encode(rng.normal(size=(n,)).astype(np.float32), jf)
    outs = []
    for impl in ("fused", "unfused"):
        want = np.asarray(jgemv(A, x, JOS(rs1=jf, rs2=jf, rd=jc.F32), impl=impl))
        got = tc.posit_gemv(_t(A), _t(x), TOS(rs1=tf, rs2=tf, rd=tc.F32), impl=impl).numpy()
        assert got.shape == want.shape == (n,)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        outs.append(got)
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla", "unfused", "quire"])
@pytest.mark.parametrize("n", [4, 20])
def test_gemm_impl_matches_reference(impl, n):
    """``kernels.posit_gemm.ops.gemm(impl=...)`` at Table IV's p8 slots
    (rd p8): within 1 ulp of the reference's same impl, and bit for bit the
    port's ``posit_dot`` dataflow it stands for."""
    rng = np.random.default_rng(n)
    a = _encode(rng.normal(size=(n, n)).astype(np.float32), jc.P8_0)
    b = _encode(rng.normal(size=(n, n)).astype(np.float32), jc.P8_0)
    js, ts = JOS(rs1=jc.P8_0, rs2=jc.P8_0, rd=jc.P8_0), TOS(rs1=tc.P8_0, rs2=tc.P8_0, rd=tc.P8_0)
    kw = {"interpret": True} if impl == "pallas" else {}
    want = np.asarray(jgemm(a, b, js, impl=impl, **kw))
    got = gemm_ops.gemm(_t(a), _t(b), ts, impl=impl).numpy()
    assert _ulps(got, want, 8).max() <= (0 if impl == "quire" else 1)
    flow = {"auto": "fused", "pallas": "fused", "xla": "fused"}.get(impl, impl)
    np.testing.assert_array_equal(got, tc.posit_dot(_t(a), _t(b), ts, impl=flow).numpy())


def test_gemv_and_table4_shapes_route_to_a_tile_that_computes_them():
    """N = 1 (a GEMV) and K down to 4 (Table IV's smallest GEMM) are refused
    by the mid-M and large-M kernels' copies, so they take the tiles of
    csrc/posit_gemm.cu: the tensor-core tile for p8, the f32-FMA kernels for
    p16 (f32 compute) and f32."""
    for m in (4, 8, 20, 256, 4096):
        assert gemm_ops.gemm_route(m, 1, m, 2, 2, True) == "tc"
        assert gemm_ops.gemm_route(m, 1, m, 3, 3, False) == "fma"
        assert gemm_ops.gemm_route(m, 1, m, 0, 0, False) == "fma"
    assert gemm_ops.gemm_route(4, 4, 4, 2, 2, True) == "tc"
    assert gemm_ops.gemm_route(20, 20, 20, 2, 2, True) == "tc"
    assert gemm_ops.gemm_route(256, 256, 256, 2, 2, True) == "large_tc"


def test_unported_and_invalid_forms_raise():
    js, ts = _slots("p8xf32")
    a = torch.zeros((4, 8), dtype=torch.uint8)
    b = torch.zeros((8, 4), dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="dimension_numbers"):
        tc.posit_dot(a, b, ts, dimension_numbers=(((1,), (0,)), ((), ())))
    with pytest.raises(ValueError, match="impl"):
        tc.posit_dot(a, b, ts, impl="pallas")
    with pytest.raises(ValueError, match="quire dataflow requires posit"):
        tc.posit_dot(a, b, ts, impl="quire")
    with pytest.raises(ValueError, match="unknown impl"):
        gemm_ops.gemm(a, b, ts, impl="fused-ish")
