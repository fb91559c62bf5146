"""Port quire parity: ``repro_torch.core.quire`` and the quire GEMM's CPU
route (its plain version) against the reference's ``repro.core.quire``, its
Pallas ``posit_quire_gemm`` (interpret=True) and ``posit_dot(impl="quire")``,
then a reduced dense model served under ``dataflow="quire"``.

Contract, stated once:
* quire states, normalised limbs and readouts: bit-exact (the quire is exact
  integer arithmetic; the readout is one RNE of the exact sum);
* the quire GEMM with no epilogue, or with bias / relu / residual: bit-exact;
* with silu or gelu (tanh): at most 1 posit ulp in signed code space, or
  for an f32 readout 2^-21 * (|z| + |y| + |residual|) with z the
  activation's input, because ``exp``/``tanh`` of XLA and torch differ by a
  few ulps before the encode or the residual add.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.core import quire as JQ
from repro.core import types as jtypes
from repro.core.codec import posit_encode as jax_encode
from repro.core.dot import posit_dot as jax_posit_dot
from repro.kernels.posit_quire_gemm.posit_quire_gemm import posit_quire_gemm as jax_quire_gemm
from repro.kernels.posit_quire_gemm.ref import posit_quire_gemm_ref as jax_quire_gemm_ref
from repro.models.layers import quantize_params as jax_quantize
from repro.models.registry import build_model as jax_build
from repro_torch import kernels
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import pcsr
from repro_torch.core import quire as TQ
from repro_torch.core import types
from repro_torch.core.dot import posit_dot
from repro_torch.kernels.posit_gemm.ops import gemm
from repro_torch.kernels.posit_quire_gemm.ops import (posit_quire_gemm, quire_gemm,
                                                      split_plan)
from repro_torch.models.registry import build_model

FMTS = [(n, es) for n in (8, 16) for es in range(4)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _codes(rng, nbits, es, shape, scale=1.0, special=True):
    """Codes of normal values, with zeros and (optionally) NaR sprinkled in."""
    x = rng.normal(0, scale, shape).astype(np.float32)
    c = np.array(jax_encode(jnp.asarray(x), nbits, es))
    if special:
        flat = c.reshape(-1)
        idx = rng.choice(flat.size, size=max(1, flat.size // 16), replace=False)
        flat[idx[: len(idx) // 2]] = 0
        flat[idx[len(idx) // 2:][:1]] = 1 << (nbits - 1)
    return c


def _raw(rng, nbits, shape):
    return rng.integers(0, 1 << nbits, shape).astype(np.uint8 if nbits == 8 else np.uint16)


def _same_quire(jq, tq):
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())


def _code_ulps(got, want, n):
    full, half = 1 << n, 1 << (n - 1)
    g = np.asarray(got).astype(np.int64)
    w = np.asarray(want).astype(np.int64)
    g = np.where(g >= half, g - full, g)
    w = np.where(w >= half, w - full, w)
    return int(np.abs(g - w).max())


# ------------------------------------------------------ quire arithmetic ----

@pytest.mark.parametrize("nbits", [8, 16])
def test_quire_fmt_matches_reference(nbits):
    for es in range(4):
        j, t = JQ.QuireFmt(nbits, es), TQ.QuireFmt(nbits, es)
        assert (t.n_limbs, t.bias, t.limbs_axis, t.storage_bits) == \
            (j.n_limbs, j.bias, j.limbs_axis, j.storage_bits)
    assert TQ.QuireFmt(nbits).limbs_axis == {8: 15, 16: 32}[nbits]
    assert TQ.MAX_DEFERRED == JQ.MAX_DEFERRED == 8192


@pytest.mark.parametrize("nbits,es", FMTS)
def test_accumulate_normalize_read_bit_exact(nbits, es):
    """Raw codes (zeros and NaR at their natural frequency), lazy
    accumulate and subtract, then normalize and both readouts."""
    rng = np.random.default_rng(nbits * 10 + es)
    jf, tf = JQ.QuireFmt(nbits, es), TQ.QuireFmt(nbits, es)
    a, b = _raw(rng, nbits, (96,)), _raw(rng, nbits, (96,))
    a[:3] = [0, 1 << (nbits - 1), 1]
    jq, tq = JQ.quire_zero((96,), jf), TQ.quire_zero((96,), tf)
    for j in range(6):
        bj = np.roll(b, j)
        jq = JQ.quire_accumulate(jq, jnp.asarray(a), jnp.asarray(bj), jf, subtract=j % 2 == 1)
        tq = TQ.quire_accumulate(tq, _t(a), _t(bj), tf, subtract=j % 2 == 1)
        _same_quire(jq, tq)
    jq = JQ.quire_add_posit(jq, jnp.asarray(b), jf)
    tq = TQ.quire_add_posit(tq, _t(b), tf)
    _same_quire(jq, tq)
    _same_quire(JQ.quire_normalize(jq, jf), TQ.quire_normalize(tq, tf))
    _same_quire(JQ.quire_negate(jq, jf), TQ.quire_negate(tq, tf))
    np.testing.assert_array_equal(np.asarray(JQ.quire_is_nar(jq, jf)),
                                  TQ.quire_is_nar(tq, tf).numpy())
    for out_n in (8, 16):
        for eo in range(4):
            np.testing.assert_array_equal(
                np.asarray(JQ.quire_read(jq, jf, out_nbits=out_n, es_out=eo)),
                TQ.quire_read(tq, tf, out_nbits=out_n, es_out=eo).numpy())
    np.testing.assert_array_equal(np.asarray(JQ.quire_read_f32(jq, jf)).view(np.int32),
                                  TQ.quire_read_f32(tq, tf).numpy().view(np.int32))


@pytest.mark.parametrize("es_a,es_b", [(0, 3), (1, 1), (3, 0)])
def test_mixed_p16_x_p8_bit_exact(es_a, es_b):
    rng = np.random.default_rng(es_a * 4 + es_b)
    jf, tf = JQ.QuireFmt(16, 1), TQ.QuireFmt(16, 1)
    a, b = _raw(rng, 16, (4, 64)), _raw(rng, 8, (4, 64))
    jq, tq = JQ.quire_zero((4,), jf), TQ.quire_zero((4,), tf)
    for k in range(64):
        kw = dict(es_a=es_a, es_b=es_b, nbits_a=16, nbits_b=8)
        jq = JQ.quire_accumulate(jq, jnp.asarray(a[:, k]), jnp.asarray(b[:, k]), jf, **kw)
        tq = TQ.quire_accumulate(tq, _t(a[:, k]), _t(b[:, k]), tf, **kw)
    _same_quire(jq, tq)
    np.testing.assert_array_equal(np.asarray(JQ.quire_read(jq, jf, out_nbits=8, es_out=2)),
                                  TQ.quire_read(tq, tf, out_nbits=8, es_out=2).numpy())


@pytest.mark.parametrize("nbits,es", [(8, 0), (16, 1), (16, 3)])
def test_exact_cancellation_and_beyond_maxpos(nbits, es):
    """x + (-x) + tiny reads out tiny exactly; sums beyond maxpos saturate
    to maxpos; both against the reference's bits."""
    jf, tf = JQ.QuireFmt(nbits, es), TQ.QuireFmt(nbits, es)
    maxpos = (1 << (nbits - 1)) - 1
    big = np.array([maxpos - 3, maxpos, maxpos - 1], np.int64)
    tiny = np.array([1, 2, 3], np.int64)
    dt = np.uint8 if nbits == 8 else np.uint16
    states = []
    for mod in (JQ, TQ):
        f = jf if mod is JQ else tf
        cv = (lambda x: jnp.asarray(x.astype(dt))) if mod is JQ else (lambda x: _t(x.astype(dt)))
        q = mod.quire_from_posit(cv(big), f)
        q = mod.quire_accumulate(q, cv(big), cv(big), f)
        q = mod.quire_accumulate(q, cv(big), cv(big), f, subtract=True)
        q = mod.quire_add_posit(q, cv(big), f, subtract=True)
        q = mod.quire_add_posit(q, cv(tiny), f)
        states.append(q)
        q2 = mod.quire_zero((3,), f)
        for _ in range(16):
            q2 = mod.quire_accumulate(q2, cv(big), cv(big), f)
        states.append(q2)
    _same_quire(states[0], states[2])
    _same_quire(states[1], states[3])
    np.testing.assert_array_equal(TQ.quire_read(states[2], tf).numpy(), tiny.astype(dt))
    np.testing.assert_array_equal(TQ.quire_read(states[3], tf).numpy(),
                                  np.full(3, maxpos, dt))
    np.testing.assert_array_equal(np.asarray(JQ.quire_read(states[1], jf)),
                                  TQ.quire_read(states[3], tf).numpy())


def test_lazy_accumulation_up_to_max_deferred():
    """MAX_DEFERRED same-sign products of the largest significand at the
    same place, with no normalize between them: every limb stays exact."""
    jf, tf = JQ.QuireFmt(16, 1), TQ.QuireFmt(16, 1)
    # 0x5FFF..0x7FFF: the widest significands, at several offsets (mod 16)
    a = np.array([0x5FFF, 0x7FFE, 0x4FFF, 0xA001], np.uint16)
    b = np.array([0x5FFF, 0x3FFF, 0x6FFF, 0x5FFF], np.uint16)
    jq = jax.lax.fori_loop(0, JQ.MAX_DEFERRED,
                           lambda i, q: JQ.quire_accumulate(q, jnp.asarray(a), jnp.asarray(b), jf),
                           JQ.quire_zero((4,), jf))
    tq = TQ.quire_zero((4,), tf)
    ta, tb = _t(a), _t(b)
    for _ in range(TQ.MAX_DEFERRED):
        tq = TQ.quire_accumulate(tq, ta, tb, tf)
    _same_quire(jq, tq)
    assert int(tq.abs().max()) > (1 << 28)       # the budget was really used
    np.testing.assert_array_equal(np.asarray(JQ.quire_read(jq, jf)),
                                  TQ.quire_read(tq, tf).numpy())
    np.testing.assert_array_equal(np.asarray(JQ.quire_read_f32(jq, jf)).view(np.int32),
                                  TQ.quire_read_f32(tq, tf).numpy().view(np.int32))


@pytest.mark.parametrize("nbits", [8, 16])
def test_normalize_and_read_negative_limbs(nbits):
    """Lazy states with negative limbs (torch's >> is the floor carry)."""
    rng = np.random.default_rng(nbits)
    jf, tf = JQ.QuireFmt(nbits, 2), TQ.QuireFmt(nbits, 2)
    L = tf.n_limbs
    q = np.zeros((64, L + 1), np.int32)
    q[:, :L] = rng.integers(-(1 << 24), 1 << 24, (64, L))
    q[:, L - 4:L] = rng.integers(-3, 3, (64, 4))    # keep the value in range
    q[:8, :L] = -np.abs(q[:8, :L])
    q[8, :] = 0
    q[9, L] = 1                                    # a NaR flag
    q[10, :L] = 0
    q[10, 0] = -1                                  # the smallest negative value
    jq, tq = jnp.asarray(q), _t(q)
    _same_quire(JQ.quire_normalize(jq, jf), TQ.quire_normalize(tq, tf))
    assert (TQ.quire_normalize(tq, tf)[:, : L - 1] >= 0).all()
    for out_n in (8, 16):
        np.testing.assert_array_equal(np.asarray(JQ.quire_read(jq, jf, out_nbits=out_n)),
                                      TQ.quire_read(tq, tf, out_nbits=out_n).numpy())
    np.testing.assert_array_equal(np.asarray(JQ.quire_read_f32(jq, jf)).view(np.int32),
                                  TQ.quire_read_f32(tq, tf).numpy().view(np.int32))


@pytest.mark.parametrize("nbits,es", [(8, 1), (16, 2)])
def test_quire_dot_and_matmul_bit_exact(nbits, es):
    rng = np.random.default_rng(5 + nbits)
    a, b = _raw(rng, nbits, (9, 70)), _raw(rng, nbits, (70, 11))
    jfmt, tfmt = jtypes.PositFmt(nbits, es), types.PositFmt(nbits, es)
    for kw in (dict(block_k=16), dict(out_nbits=8, es_out=3), dict(as_float=True)):
        want = np.asarray(JQ.quire_matmul(jnp.asarray(a), jnp.asarray(b), jfmt, **kw))
        got = TQ.quire_matmul(_t(a), _t(b), tfmt, **kw).numpy()
        if kw.get("as_float"):
            want, got = want.view(np.int32), got.view(np.int32)
        np.testing.assert_array_equal(got, want)
    assert int(TQ.quire_dot(_t(a[0]), _t(b[:, 0]), tfmt)) == \
        int(JQ.quire_dot(jnp.asarray(a[0]), jnp.asarray(b[:, 0]), jfmt))


# ------------------------------------------------- the plain quire GEMM ----

GEMM_FMTS = {
    "p8xp8": ("p8_0", "p8_0", "p8_0"),
    "p16xp16": ("p16_1", "p16_1", "p16_1"),
    "p16xp8": ("p16_1", "p8_2", "p16_3"),
    "p8xp16_p8out": ("p8_1", "p16_0", "p8_2"),
}
M, K, N = 13, 200, 27   # K and N off every block size of both kernels


def _gemm_inputs(row, seed):
    a_name, b_name, o_name = GEMM_FMTS[row]
    rng = np.random.default_rng(seed)
    jf = [jtypes.get_format(x) for x in (a_name, b_name, o_name)]
    a = _codes(rng, jf[0].nbits, jf[0].es, (M, K))
    b = _codes(rng, jf[1].nbits, jf[1].es, (K, N), scale=K ** -0.5)
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32)
    res = rng.normal(0, 1.0, (M, N)).astype(np.float32)
    tf = [types.get_format(x) for x in (a_name, b_name, o_name)]
    es = [f.es for f in jf]
    return jf, tf, es, a, b, bias, res


def _both(jf, tf, es, a, b, *, bias=None, res=None, act="none"):
    kw = dict(activation=act)
    jkw = dict(kw, bias=None if bias is None else jnp.asarray(bias),
               residual=None if res is None else jnp.asarray(res))
    pallas = np.asarray(jax_quire_gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(es, jnp.int32),
                                       a_fmt=jf[0], b_fmt=jf[1], out_fmt=jf[2], interpret=True,
                                       block_m=8, block_n=128, block_k=128, **jkw))
    jref = np.asarray(jax_quire_gemm_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(es),
                                         a_fmt=jf[0], b_fmt=jf[1], out_fmt=jf[2], **jkw))
    got = posit_quire_gemm(_t(a), _t(b), es, a_fmt=tf[0], b_fmt=tf[1], out_fmt=tf[2],
                           bias=None if bias is None else _t(bias),
                           residual=None if res is None else _t(res), **kw).numpy()
    assert got.shape == (M, N) and got.dtype == pallas.dtype
    return got, pallas, jref


@pytest.mark.parametrize("row", list(GEMM_FMTS))
def test_quire_gemm_no_epilogue_bit_exact(row):
    jf, tf, es, a, b, _, _ = _gemm_inputs(row, seed=len(row))
    got, pallas, jref = _both(jf, tf, es, a, b)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, jref)


@pytest.mark.parametrize("row", ["p16xp16", "p16xp8", "p8xp8"])
@pytest.mark.parametrize("act,has_bias,has_res",
                         [("none", True, False), ("relu", True, True), ("none", False, True)])
def test_quire_gemm_exact_epilogues_bit_exact(row, act, has_bias, has_res):
    jf, tf, es, a, b, bias, res = _gemm_inputs(row, seed=3)
    got, pallas, jref = _both(jf, tf, es, a, b, bias=bias if has_bias else None,
                              res=res if has_res else None, act=act)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, jref)


@pytest.mark.parametrize("row", ["p16xp16", "p8xp16_p8out"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_quire_gemm_transcendental_epilogues_within_one_ulp(row, act):
    jf, tf, es, a, b, bias, res = _gemm_inputs(row, seed=4)
    got, pallas, jref = _both(jf, tf, es, a, b, bias=bias, res=res, act=act)
    n = jf[2].nbits
    assert _code_ulps(got, pallas, n) <= 1
    assert _code_ulps(got, jref, n) <= 1


@pytest.mark.parametrize("act,has_bias,has_res",
                         [("none", False, False), ("none", True, True), ("relu", True, True),
                          ("silu", False, True), ("gelu", True, False)])
def test_quire_f32_readout_matches_posit_dot(act, has_bias, has_res):
    """rd = F32, the layer path's readout: the reference's
    ``posit_dot(impl="quire")`` with a float rd."""
    jf, tf, es, a, b, bias, res = _gemm_inputs("p16xp16", seed=6)
    bias = bias if has_bias else None
    res = res if has_res else None
    jslots = jpcsr.OperandSlots(rs1=jf[0], rs2=jf[1], rd=jtypes.F32, dataflow="quire")
    tslots = pcsr.OperandSlots(rs1=tf[0], rs2=tf[1], rd=types.F32, dataflow="quire")
    want = np.asarray(jax_posit_dot(jnp.asarray(a), jnp.asarray(b), jslots, impl="quire",
                                    bias=None if bias is None else jnp.asarray(bias),
                                    activation=act,
                                    residual=None if res is None else jnp.asarray(res)))
    targs = dict(bias=None if bias is None else _t(bias), activation=act,
                 residual=None if res is None else _t(res))
    got = posit_dot(_t(a), _t(b), tslots, **targs).numpy()
    assert got.dtype == np.float32
    if act in ("silu", "gelu"):
        # exp/tanh may be a few ulps apart: the activation of z (the exact
        # readout plus bias) moves by <= 2^-21 * |z| before the residual add
        z = posit_dot(_t(a), _t(b), tslots, bias=targs["bias"]).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        live = ~np.isnan(want)
        tol = 2.0 ** -21 * (np.abs(z) + np.abs(want) + (0 if res is None else np.abs(res)))
        assert (np.abs(got - want)[live] <= tol[live]).all()
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the slot-driven GEMM front door routes dataflow="quire" to the same kernel
    np.testing.assert_array_equal(gemm(_t(a), _t(b), tslots, **targs).numpy().view(np.int32),
                                  got.view(np.int32))


def test_quire_front_doors_refuse_what_they_cannot_take():
    a = torch.zeros((2, 4), dtype=torch.uint16)
    with pytest.raises(ValueError):
        quire_gemm(a.float(), a.T.contiguous(),
                   pcsr.OperandSlots(rs1=types.F32, rs2=types.P16_1, dataflow="quire"))
    with pytest.raises(ValueError):
        posit_quire_gemm(a, a.T.contiguous(), (1, 1, 1), a_fmt=types.P16_1,
                         b_fmt=types.P16_1, out_fmt=types.BF16)
    with pytest.raises(NotImplementedError):   # a general contraction
        posit_dot(a, a.T.contiguous(), pcsr.OperandSlots.uniform(types.P16_1),
                  dimension_numbers=(((1,), (0,)), ((), ())))
    # packed p8 B, once refused, is ported: it unpacks ahead of the quire
    # (held against the reference in test_quire_gemm_packed_b_bit_exact)
    from repro_torch.core.pack import pack_p8
    rng = np.random.default_rng(3)
    a8 = _t(rng.integers(0, 256, (2, 5)).astype(np.uint8))
    b8 = _t(rng.integers(0, 256, (5, 3)).astype(np.uint8))
    slots = pcsr.OperandSlots(rs1=types.P8_0, rs2=types.P8_0, dataflow="quire")
    np.testing.assert_array_equal(quire_gemm(a8, pack_p8(b8), slots.with_packed()).numpy(),
                                  quire_gemm(a8, b8, slots).numpy())


@pytest.mark.parametrize("k", [33, 64])
@pytest.mark.parametrize("a_fmt,rd", [("p16_1", "p16_1"), ("p8_2", "p8_0"), ("p8_0", "f32")])
def test_quire_gemm_packed_b_bit_exact(k, a_fmt, rd):
    """A packed rs2 through the quire (``quire_gemm``, ``gemm`` and
    ``posit_dot``, fused and chained epilogues) gives the reference's
    ``posit_dot(dataflow="quire")`` bits on the same packed operand, and the
    same bits as the unpacked codes: the quire's sum does not depend on the
    layout. Odd K unpacks to K rows (the pad row is trimmed)."""
    from repro.core.pack import pack_p8 as jax_pack
    from repro_torch.core.pack import pack_p8

    rng = np.random.default_rng(k)
    ja, jd = jtypes.get_format(a_fmt), jtypes.get_format(rd)
    a = _codes(rng, ja.nbits, ja.es, (5, k))
    b = _codes(rng, 8, 1, (k, 7), scale=k ** -0.5)
    bp = np.asarray(jax_pack(jnp.asarray(b)))
    jslots = jpcsr.OperandSlots(rs1=ja, rs2=jtypes.P8_1, rd=jd, dataflow="quire",
                                rs2_packed=True)
    want = np.asarray(jax_posit_dot(jnp.asarray(a), jnp.asarray(bp), jslots))
    tslots = pcsr.OperandSlots(rs1=types.get_format(a_fmt), rs2=types.P8_1,
                               rd=types.get_format(rd), dataflow="quire", rs2_packed=True)
    np.testing.assert_array_equal(pack_p8(_t(b)).numpy(), bp)
    def bits(x):
        return x.view(np.uint32) if rd == "f32" else x

    for got in (quire_gemm(_t(a), _t(bp), tslots), gemm(_t(a), _t(bp), tslots),
                posit_dot(_t(a), _t(bp), tslots),
                quire_gemm(_t(a), _t(b), tslots.with_packed(False))):
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))
    # the epilogue: fused in the kernel, or chained after an f32 readout
    bias = rng.normal(0, 0.1, (7,)).astype(np.float32)
    want_b = np.asarray(jax_posit_dot(jnp.asarray(a), jnp.asarray(bp), jslots,
                                      bias=jnp.asarray(bias), activation="relu"))
    for epilogue in ("fused", "chained"):
        got = posit_dot(_t(a), _t(bp), tslots, bias=_t(bias), activation="relu",
                        epilogue=epilogue).numpy()
        np.testing.assert_array_equal(got, want_b)


def test_plain_route_and_split_plan():
    """CPU tensors take the plain version (no launch counted); the split
    plan covers K with whole k tiles for every tile kind."""
    before = dict(kernels.LAUNCHES)
    a = torch.ones((3, 5), dtype=torch.uint16)
    posit_quire_gemm(a, a.T.contiguous(), (1, 1, 1), a_fmt=types.P16_1, b_fmt=types.P16_1,
                     out_fmt=types.F32)
    assert kernels.LAUNCHES == before
    for Md, Kd, Nd in ((1, 3072, 3072), (4, 3072, 8192), (4, 8192, 3072), (32, 3072, 32064),
                       (4, 7, 5), (6, 0, 9)):
        splits, kps = split_plan(Md, Nd, Kd, 132)
        assert splits >= 1 and splits * kps >= Kd and (splits - 1) * kps < max(Kd, 1)


# ----------------------------------------------------- the whole model ------

def test_reduced_model_under_quire_matches_reference():
    """Reduced qwen2.5-14b (GQA, QKV bias) under weights=p16_1, kv=p16_1,
    dataflow=quire: prefill + 3 decode steps, both sides fed the
    reference's greedy token.

    Bound 2e-3 on the logits: every quire linear is bit-exact given equal
    inputs, but RMSNorm, RoPE, attention and silu run in f32 in another
    order and with another exp, so an activation's or a K/V row's p16 encode
    can land one code (2^-13 relative) apart, which moves a logit by ~1e-3.
    """
    spec = "weights=p16_1,kv=p16_1,dataflow=quire"
    jpol = jpcsr.TransPolicy.from_names(weights="p16_1", kv_cache="p16_1", dataflow="quire")
    pol = pcsr.parse_policy(spec)
    assert pol.to_json() == jpol.to_json() and pol.describe() == jpol.describe()
    bound = 2e-3
    jcfg = jax_arch("qwen2.5-14b").reduced()
    jm = jax_build(jcfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    rng = np.random.default_rng(1)
    for w in ("wq", "wk", "wv"):
        bshape = jparams["blocks"]["attn"][w]["b"].shape
        jparams["blocks"]["attn"][w]["b"] = jnp.asarray(rng.normal(0, 0.1, bshape).astype(np.float32))
    jparams = jax_quantize(jparams, jpol)
    cfg = get_arch("qwen2.5-14b").reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, jpol, S_max=20))(jparams, jnp.asarray(tokens))
    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, jpol))
    tl, tc = model.prefill(params, torch.from_numpy(tokens), pol, S_max=20)
    worst, clear = 0.0, 0
    for step in range(4):
        ref, got = np.asarray(jl), tl.numpy()
        assert got.shape == ref.shape == (2, cfg.vocab) and np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - ref).max()))
        top2 = np.sort(ref, axis=-1)[:, -2:]
        margin_clear = top2[:, 1] - top2[:, 0] > 2 * bound
        assert (got.argmax(-1)[margin_clear] == ref.argmax(-1)[margin_clear]).all(), step
        clear += int(margin_clear.sum())
        if step == 3:
            break
        tok = ref.argmax(-1).astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(tok), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(tok), tc, pol)
    assert worst <= bound, worst
    assert clear >= 4
