"""Port GEMM parity: ``kernels.posit_gemm.ops.posit_gemm`` (CPU route = its
plain version) and ``core.dot.posit_matmul_wx`` against the reference's
Pallas ``posit_gemm`` (interpret=True) and its XLA ``posit_matmul_wx``.

Tolerances, stated once:
* float out: both sides sum K products that are exact in f32 (bf16 x bf16,
  or f32 rounded once) in different orders, so
  |port - ref| <= 4*K*2^-24*(|A|@|B| + |bias|) + 16*2^-24*(|ref| + |residual|);
  the second term covers the epilogue's adds and the activation's last-ulp
  differences between XLA and torch.
* posit out: the f32 results may round to neighbouring codes: <= 1 posit ulp
  in code space.
"""
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import types as jtypes
from repro.core.codec import posit_decode as jax_decode
from repro.core.codec import posit_encode as jax_encode
from repro.core.dot import posit_matmul_wx as jax_matmul_wx
from repro.kernels.posit_gemm.posit_gemm import posit_gemm as jax_posit_gemm
from repro_torch.core import types
from repro_torch.core.dot import format_pair_plan, posit_matmul_wx
from repro_torch.core.pcsr import OperandSlots
from repro_torch.kernels.posit_gemm.ops import (TC_COLS, TC_STEP, fma_split_plan, gemm,
                                             posit_gemm, split_plan, uses_tensor_cores)

U = 2.0 ** -24
M, K, N = 5, 70, 45   # ragged against every tile size

# (name, a_fmt, b_fmt, out_fmt) by format name; one row per format-table row
ROWS = {
    "p8xp8": ("p8_0", "p8_2", "f32"),
    "p16xp16": ("p16_1", "p16_2", "f32"),
    "bf16xp8": ("bf16", "p8_0", "f32"),
    "f32xp8": ("f32", "p8_1", "f32"),
    "f32xf32": ("f32", "f32", "f32"),
    "p8out": ("p8_0", "p8_0", "p8_2"),
    "p16out": ("p16_1", "p16_1", "p16_1"),
}
CASES = ([(row, act, True, True) for row in ROWS for act in ("silu", "gelu", "relu")]
         + [(row, "none", False, False) for row in ROWS]
         + [("bf16xp8", "none", True, False), ("bf16xp8", "none", False, True)])


def _operand(fmt_name, shape, rng, scale):
    """numpy operand in its storage dtype: posit codes or float values."""
    x = (rng.normal(0, scale, shape)).astype(np.float32)
    fmt = jtypes.get_format(fmt_name)
    if isinstance(fmt, jtypes.PositFmt):
        return np.asarray(jax_encode(jnp.asarray(x), fmt.nbits, fmt.es))
    return np.asarray(jnp.asarray(x).astype(fmt.dtype))


def _to_torch(a):
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _values(a, fmt_name):
    fmt = jtypes.get_format(fmt_name)
    if isinstance(fmt, jtypes.PositFmt):
        return np.asarray(jax_decode(jnp.asarray(a), fmt.nbits, fmt.es), np.float64)
    return np.asarray(a, np.float64)


def _check(got, want, out_fmt_name, a_vals, b_vals, bias, res, k=K):
    out_fmt = jtypes.get_format(out_fmt_name)
    if isinstance(out_fmt, jtypes.PositFmt):
        n = out_fmt.nbits
        d = (got.astype(np.int64) - want.astype(np.int64)) & ((1 << n) - 1)
        assert np.minimum(d, (1 << n) - d).max() <= 1
        return
    want = np.asarray(want, np.float64)
    scale = np.abs(a_vals) @ np.abs(b_vals) + (0 if bias is None else np.abs(bias))
    tol = 4 * k * U * scale + 16 * U * (np.abs(want) + (0 if res is None else np.abs(res)))
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= tol).all(), float((err / tol).max())


@pytest.mark.parametrize("row,act,has_bias,has_res", CASES)
def test_posit_gemm_matches_pallas(row, act, has_bias, has_res):
    a_name, b_name, o_name = ROWS[row]
    rng = np.random.default_rng(zlib.crc32(f"{row}/{act}".encode()))
    a = _operand(a_name, (M, K), rng, 1.0)
    b = _operand(b_name, (K, N), rng, K ** -0.5)
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32) if has_bias else None
    res = rng.normal(0, 1.0, (M, N)).astype(np.float32) if has_res else None
    jf = [jtypes.get_format(x) for x in (a_name, b_name, o_name)]
    es = [getattr(f, "es", 0) for f in jf]
    want = np.asarray(jax_posit_gemm(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(es, jnp.int32),
        a_fmt=jf[0], b_fmt=jf[1], out_fmt=jf[2],
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), activation=act,
        block_m=8, block_n=128, block_k=128, interpret=True))
    tf = [types.get_format(x) for x in (a_name, b_name, o_name)]
    got = posit_gemm(_to_torch(a), _to_torch(b), es, a_fmt=tf[0], b_fmt=tf[1], out_fmt=tf[2],
                     bias=None if bias is None else torch.from_numpy(bias),
                     residual=None if res is None else torch.from_numpy(res),
                     activation=act)
    got = got.numpy()
    assert got.shape == (M, N) and got.dtype == want.dtype
    _check(got, want, o_name, _values(a, a_name), _values(b, b_name), bias, res)
    # the slot-driven front door is the same function
    slots = OperandSlots(rs1=tf[0], rs2=tf[1], rd=tf[2])
    again = gemm(_to_torch(a), _to_torch(b), slots,
                 bias=None if bias is None else torch.from_numpy(bias),
                 residual=None if res is None else torch.from_numpy(res),
                 activation=act).numpy()
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("w_name,cd", [("p8_0", "bf16"), ("p16_1", "f32"), ("p8_3", "f32")])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_matmul_wx_matches_reference(w_name, cd, act):
    """The weights-only linear path: x (batch, seq, K) float, W codes."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 3, K)).astype(np.float32)
    w = _operand(w_name, (K, N), rng, K ** -0.5)
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32)
    res = rng.normal(0, 1, (2, 3, N)).astype(np.float32)
    jdt = jnp.bfloat16 if cd == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cd == "bf16" else torch.float32
    jw = jtypes.get_format(w_name)
    want = np.asarray(jax_matmul_wx(jnp.asarray(x).astype(jdt), jnp.asarray(w), jw,
                                    compute_dtype=jdt, out_dtype=jnp.float32,
                                    bias=jnp.asarray(bias), activation=act,
                                    residual=jnp.asarray(res)))
    got = posit_matmul_wx(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                          types.get_format(w_name), compute_dtype=tdt,
                          out_dtype=torch.float32, bias=torch.from_numpy(bias),
                          activation=act, residual=torch.from_numpy(res)).numpy()
    assert got.shape == (2, 3, N)
    xa = np.asarray(jnp.asarray(x).astype(jdt), np.float64).reshape(-1, K)
    _check(got.reshape(-1, N), want.reshape(-1, N), "f32", xa, _values(w, w_name), bias,
           res.reshape(-1, N))


@pytest.mark.parametrize("out_name", ["p8_1", "p16_2"])
def test_matmul_wx_posit_out(out_name):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, K)).astype(np.float32)
    w = _operand("p16_1", (K, N), rng, K ** -0.5)
    jo, to = jtypes.get_format(out_name), types.get_format(out_name)
    want = np.asarray(jax_matmul_wx(jnp.asarray(x), jnp.asarray(w), jtypes.P16_1,
                                    activation="gelu", out_fmt=jo))
    got = posit_matmul_wx(torch.from_numpy(x), torch.from_numpy(w), types.P16_1,
                          activation="gelu", out_fmt=to).numpy()
    assert got.dtype == want.dtype
    _check(got, want, out_name, None, None, None, None)


def test_format_pair_plan_matches_reference():
    from repro.core.dot import format_pair_plan as jax_plan
    from repro.core.pcsr import OperandSlots as JaxSlots
    names = ("p8_0", "p8_3", "p16_1", "f32", "bf16")
    for a in names:
        for b in names:
            want = jax_plan(JaxSlots(rs1=jtypes.get_format(a), rs2=jtypes.get_format(b)))
            got = format_pair_plan(types.get_format(a), types.get_format(b))
            assert str(got.compute_dtype).endswith(want.compute_dtype_name), (a, b)
            assert (got.decode_a, got.decode_b) == (want.decode_a, want.decode_b)
            assert got.packed_b is want.packed_b is False
            if b.startswith("p8"):   # packed lanes: p8's plan, decoding both lanes
                want = jax_plan(JaxSlots(rs1=jtypes.get_format(a), rs2=jtypes.get_format(b),
                                         rs2_packed=True))
                got = format_pair_plan(types.get_format(a), types.get_format(b), packed_b=True)
                assert str(got.compute_dtype).endswith(want.compute_dtype_name), (a, b)
                assert got.packed_b is want.packed_b is True
            else:
                with pytest.raises(ValueError):
                    format_pair_plan(types.get_format(a), types.get_format(b), packed_b=True)


QWEN_KN = ((5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120), (5120, 152064))
SMS = 132


def _shares(plan):
    """Each block's [start, end) of the plan's work items (csrc/posit_gemm.cu
    ``share_start``)."""
    total = plan.tiles * plan.steps
    return [(total * b // plan.grid, total * (b + 1) // plan.grid) for b in range(plan.grid)]


def _owner(total, x, grid):
    """csrc/posit_gemm.cu ``share_owner``: the block whose share holds item x."""
    return ((x + 1) * grid - 1) // total


def test_split_plan_is_row_count_independent_for_decode():
    """A decode batch of 1..8 rows gets one plan (grid and shares), so a
    row's sum order does not depend on how many other rows share the batch."""
    for Kd, Nd in QWEN_KN:
        plans = {split_plan(m, Nd, Kd, SMS) for m in range(1, 9)}
        assert len(plans) == 1
        plan = plans.pop()
        assert plan.rows == 8 and plan.steps * TC_STEP >= Kd > (plan.steps - 1) * TC_STEP


@pytest.mark.parametrize("M", [1, 4, 8, 9, 64, 300])
@pytest.mark.parametrize("K,N", QWEN_KN + ((999, 1001), (1, 7), (70, 45)))
def test_split_plan_covers_k_and_fills_whole_waves(M, K, N):
    """Every (tile, k step) item belongs to exactly one block, each tile's
    steps cover K, the kernel's owner formula finds each item's block, and
    the blocks' shares differ by at most one step: no block runs a second
    wave. The grid is the resident count (2 blocks an SM for 8-row tiles, 1
    for 64-row tiles) unless that would leave a block under its least share.
    Past 8 rows the 64-row tile now takes only the shapes the mid-M kernel
    refuses (N not a multiple of 16, as 999 x 1001 and 70 x 45 here, or
    unaligned operands): the qwen shapes go to the mid-M kernel, whose plan
    tests/test_torch_gemm_mid.py holds."""
    from repro_torch.kernels.posit_gemm.ops import gemm_route

    plan = split_plan(M, N, K, SMS)
    rows = 8 if M <= 8 else 64
    assert plan.rows == rows
    if 8 < M <= 64:
        assert gemm_route(M, N, K, 0, 2, True) == ("tc" if N % 16 else "mid_tc")
    assert plan.tiles == -(-N // TC_COLS) * -(-M // rows)
    assert plan.steps * TC_STEP >= K > (plan.steps - 1) * TC_STEP
    total = plan.tiles * plan.steps
    shares = _shares(plan)
    assert shares[0][0] == 0 and shares[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [e - s for s, e in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    resident = SMS * (2 if rows == 8 else 1)
    least = 4 if rows == 8 else 8
    assert plan.grid == resident or plan.grid == max(1, total // least) < resident
    for x in range(0, total, max(1, total // 997)):
        b = _owner(total, x, plan.grid)
        assert shares[b][0] <= x < shares[b][1]


@pytest.mark.parametrize("M", [1, 4, 8, 9, 64])
@pytest.mark.parametrize("K,N", QWEN_KN[:2] + ((999, 1001), (1, 7)))
def test_p16_split_plan_runs_one_block_an_sm(M, K, N):
    """p16 B's 8-row tile runs one block an SM (its deeper ring), so its
    grid is at most the SM count and the same for every M <= 8; the 64-row
    tile's plan is the other kinds'. Shares cover every item once."""
    plan = split_plan(M, N, K, SMS, b_kind=3)
    if M <= 8:
        assert plan == split_plan(1, N, K, SMS, b_kind=3)
        assert plan.grid == SMS or plan.grid == max(1, plan.tiles * plan.steps // 4) < SMS
    else:
        assert plan == split_plan(M, N, K, SMS)
    shares = _shares(plan)
    assert shares[0][0] == 0 and shares[-1][1] == plan.tiles * plan.steps
    sizes = [e - s for s, e in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("M", [1, 8, 9, 64])
@pytest.mark.parametrize("K,N", QWEN_KN + ((999, 1001),))
def test_fma_split_plan_covers_k(M, K, N):
    """The f32 FMA kernels' K splits: every k in exactly one split, no empty
    split, and for M <= 8 the same splits whatever M."""
    splits, kps = fma_split_plan(M, N, K, SMS)
    assert splits * kps >= K > (splits - 1) * kps
    if M <= 8:
        assert (splits, kps) == fma_split_plan(1, N, K, SMS)


@pytest.mark.parametrize("a_fmt,b_fmt,cd,want", [
    ("f32", "p8_0", "bf16", True), ("bf16", "p8_3", "bf16", True), ("p8_0", "p8_0", "bf16", True),
    ("f32", "packed", "bf16", True), ("p8_0", "packed", "bf16", True),
    ("f32", "packed", "f32", False), ("p16_1", "packed", "bf16", False),
    ("f32", "bf16", "bf16", True), ("p16_1", "p8_0", "bf16", False),
    ("f32", "p8_0", "f32", False), ("f32", "p16_1", "bf16", True),
    ("bf16", "p16_1", "bf16", True), ("p8_0", "p16_1", "bf16", True),
    ("f32", "p16_1", "f32", False), ("p16_1", "p16_1", "bf16", False),
    ("f32", "f32", "bf16", False)])
def test_tensor_core_pairs(a_fmt, b_fmt, cd, want):
    """The pairs that go to the bf16 tensor cores: bf16 compute, B p8, p16 or
    bf16, A f32/bf16/p8; f32 B, p16 A and f32 compute stay on the FMA
    kernels."""
    kind = {"f32": 0, "bf16": 1, "p8_0": 2, "p8_3": 2, "p16_1": 3, "packed": 4}
    assert uses_tensor_cores(kind[a_fmt], kind[b_fmt], cd == "bf16") is want


@pytest.mark.parametrize("b_kind,tc,want", [
    (2, True, "posit_gemm"), (1, True, "posit_gemm"), (3, True, "posit_gemm_p16"),
    (3, False, "posit_gemm"), (0, False, "posit_gemm"), (4, True, "posit_gemm_packed"),
    (4, False, "posit_gemm_packed_fma")])
def test_launch_counter_names_each_route(b_kind, tc, want):
    """Each route's launches count under a key of their own: p16 B on the
    tensor cores apart from the unpacked kernel's other launches."""
    from repro_torch import kernels
    from repro_torch.kernels.posit_gemm.ops import launch_counter

    assert launch_counter(b_kind, tc) == want and want in kernels.LAUNCHES


@pytest.mark.parametrize("a_name", ["f32", "bf16", "p8_0"])
@pytest.mark.parametrize("act,has_bias,has_res", [("silu", True, True), ("none", False, False)])
def test_p16_weights_bf16_compute_match_pallas(a_name, act, has_bias, has_res):
    """p16 B under bf16 compute (the mixed path's q/k/v/o, the pairs the
    kernel runs on tensor cores): the port's plain version against the
    Pallas kernel in interpret mode with ``compute_dtype_name="bfloat16"``,
    both rounding the decoded weight and A to bf16; ``_check``'s bound on
    the bf16-rounded values."""
    rng = np.random.default_rng(zlib.crc32(f"p16bf16/{a_name}/{act}".encode()))
    a = _operand(a_name, (M, K), rng, 1.0)
    b = _operand("p16_1", (K, N), rng, K ** -0.5).copy()
    b[3, :5] = [0x7FFF, 0x0001, 0x8001, 0xFFFF, 0]   # +-maxpos, +-minpos, zero
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32) if has_bias else None
    res = rng.normal(0, 1.0, (M, N)).astype(np.float32) if has_res else None
    ja, jb = jtypes.get_format(a_name), jtypes.P16_1
    es = [getattr(ja, "es", 0), 1, 0]
    want = np.asarray(jax_posit_gemm(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(es, jnp.int32), a_fmt=ja, b_fmt=jb,
        out_fmt=jtypes.F32, bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), activation=act,
        compute_dtype_name="bfloat16", block_m=8, block_n=128, block_k=128,
        interpret=True))
    got = posit_gemm(_to_torch(a), _to_torch(b), es, a_fmt=types.get_format(a_name),
                     b_fmt=types.P16_1, out_fmt=types.F32,
                     bias=None if bias is None else torch.from_numpy(bias),
                     residual=None if res is None else torch.from_numpy(res),
                     activation=act, compute_dtype=torch.bfloat16).numpy()
    assert got.shape == (M, N) and np.isfinite(got).all()

    def rounded(x):
        return np.asarray(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16), np.float64)

    _check(got, want, "f32", rounded(_values(a, a_name)), rounded(_values(b, "p16_1")),
           bias, res)


def test_unported_variants_raise():
    """What stays unported raises: ``posit_dot`` with a general
    ``dimension_numbers`` contraction (its fused and unfused dataflows are
    ported: tests/test_torch_dot_dataflows.py). Packed
    B, once refused here, is ported: the slot-driven front door takes it and
    gives the packed plain version's bits (held against the Pallas
    ``b_packed`` kernel in ``test_packed_gemm_matches_pallas``). A packed B
    of the wrong height, a packed non-p8 slot and an unknown activation are
    refused."""
    from repro_torch.core.dot import posit_dot
    from repro_torch.core.pack import pack_p8

    a = torch.zeros((2, 4), dtype=torch.uint8)
    with pytest.raises(NotImplementedError):
        posit_dot(a, a.T.contiguous(), OperandSlots.uniform(types.P8_0),
                  dimension_numbers=(((1,), (0,)), ((), ())))
    with pytest.raises(ValueError):
        posit_gemm(a, a.T.contiguous(), (0, 0, 0), a_fmt=types.P8_0, b_fmt=types.P8_0,
                   out_fmt=types.F32, activation="tanh")
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(0, 256, (3, 7)).astype(np.uint8))
    w = torch.from_numpy(rng.integers(0, 256, (7, 5)).astype(np.uint8))
    slots = OperandSlots(rs1=types.P8_0, rs2=types.P8_1, rd=types.P16_1, rs2_packed=True)
    got = gemm(x, pack_p8(w), slots, activation="relu")
    want = posit_gemm(x, pack_p8(w), (0, 1, 1), a_fmt=types.P8_0, b_fmt=types.P8_1,
                      out_fmt=types.P16_1, activation="relu", b_packed=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    with pytest.raises(ValueError):   # 7 rows need ceil(7/2) = 4 packed rows
        posit_gemm(x, pack_p8(w)[:3].contiguous(), (0, 0, 0), a_fmt=types.P8_0,
                   b_fmt=types.P8_0, out_fmt=types.F32, b_packed=True)
    with pytest.raises(ValueError):
        posit_gemm(x.float(), pack_p8(w), (0, 0, 0), a_fmt=types.F32, b_fmt=types.P16_1,
                   out_fmt=types.F32, b_packed=True)


# (name, a_fmt, out_fmt, activation, bias, residual, K): packed p8 B against
# A of every kind the layers feed it; odd K pads the packed B's last high lane
PACKED_CASES = [
    ("f32-odd", "f32", "f32", "silu", True, True, 71),
    ("f32-even", "f32", "f32", "none", False, False, 70),
    ("bf16", "bf16", "f32", "gelu", True, False, 70),
    ("p8-out", "p8_0", "p8_2", "relu", True, True, 71),
    ("p16", "p16_1", "p16_1", "none", False, True, 33),
]


@pytest.mark.parametrize("codec_impl", ["bits", "lut"])
@pytest.mark.parametrize("case", PACKED_CASES, ids=lambda c: c[0])
def test_packed_gemm_matches_pallas(case, codec_impl):
    """The packed plain version (split A, two contractions) against the
    interpret-mode Pallas kernel with ``b_packed=True``, whose lane decode is
    the (4, 256) table input under "lut" and the bit pipeline under "bits";
    within the module's tolerance, and within it of the unpacked plain
    version on ``unpack_p8`` of the same codes."""
    from repro.core.pack import pack_p8 as jax_pack
    from repro_torch.core.pack import unpack_p8

    _, a_name, o_name, act, has_bias, has_res, k = case
    rng = np.random.default_rng(k + len(a_name))
    a = _operand(a_name, (M, k), rng, 1.0)
    w = _operand("p8_1", (k, N), rng, k ** -0.5)
    bp = np.asarray(jax_pack(jnp.asarray(w)))
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32) if has_bias else None
    res = rng.normal(0, 1.0, (M, N)).astype(np.float32) if has_res else None
    jf = [jtypes.get_format(x) for x in (a_name, "p8_1", o_name)]
    es = [getattr(f, "es", 0) for f in jf]
    want = np.asarray(jax_posit_gemm(
        jnp.asarray(a), jnp.asarray(bp), jnp.asarray(es, jnp.int32),
        a_fmt=jf[0], b_fmt=jf[1], out_fmt=jf[2],
        bias=None if bias is None else jnp.asarray(bias),
        residual=None if res is None else jnp.asarray(res), activation=act,
        block_m=8, block_n=128, block_k=128, interpret=True, b_packed=True,
        codec_impl=codec_impl))
    tf = [types.get_format(x) for x in (a_name, "p8_1", o_name)]
    kw = dict(a_fmt=tf[0], b_fmt=tf[1], out_fmt=tf[2],
              bias=None if bias is None else torch.from_numpy(bias),
              residual=None if res is None else torch.from_numpy(res), activation=act)
    got = posit_gemm(_to_torch(a), torch.from_numpy(bp), es, b_packed=True,
                     codec_impl=codec_impl, **kw).numpy()
    assert got.shape == (M, N) and got.dtype == want.dtype
    _check(got, want, o_name, _values(a, a_name), _values(w, "p8_1"), bias, res, k)
    unpacked = posit_gemm(_to_torch(a), unpack_p8(torch.from_numpy(bp), k), es, **kw)
    _check(got, unpacked.numpy(), o_name, _values(a, a_name), _values(w, "p8_1"), bias, res,
           k)


@pytest.mark.parametrize("w_name,cd", [("p8_0", "bf16"), ("p8_2", "f32")])
@pytest.mark.parametrize("epilogue", ["fused", "chained"])
def test_matmul_wx_packed_and_chained_match_reference(w_name, cd, epilogue):
    """``posit_matmul_wx(packed=True)`` and ``epilogue="chained"`` against the
    reference's ``posit_matmul_wx`` with the same knobs (x (batch, seq, K),
    even K as ``quantize_params`` packs)."""
    from repro.core.pack import pack_p8 as jax_pack

    rng = np.random.default_rng(17)
    x = rng.normal(0, 1, (2, 3, 64)).astype(np.float32)
    w = _operand(w_name, (64, N), rng, 64 ** -0.5)
    wp = np.asarray(jax_pack(jnp.asarray(w)))
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32)
    res = rng.normal(0, 1, (2, 3, N)).astype(np.float32)
    jdt = jnp.bfloat16 if cd == "bf16" else jnp.float32
    tdt = torch.bfloat16 if cd == "bf16" else torch.float32
    jw = jtypes.get_format(w_name)
    outs = []
    for packed, wc in ((True, wp), (False, w)):
        want = np.asarray(jax_matmul_wx(jnp.asarray(x).astype(jdt), jnp.asarray(wc), jw,
                                        compute_dtype=jdt, out_dtype=jnp.float32,
                                        bias=jnp.asarray(bias), activation="silu",
                                        residual=jnp.asarray(res), epilogue=epilogue,
                                        packed=packed))
        got = posit_matmul_wx(torch.from_numpy(x).to(tdt), torch.from_numpy(wc),
                              types.get_format(w_name), compute_dtype=tdt,
                              out_dtype=torch.float32, bias=torch.from_numpy(bias),
                              activation="silu", residual=torch.from_numpy(res),
                              epilogue=epilogue, packed=packed).numpy()
        assert got.shape == (2, 3, N)
        xa = np.asarray(jnp.asarray(x).astype(jdt), np.float64).reshape(-1, 64)
        _check(got.reshape(-1, N), want.reshape(-1, N), "f32", xa, _values(w, w_name),
               bias, res.reshape(-1, N), 64)
        outs.append(got)
    # packing changes the words moved, never the numerics (within tolerance)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M", [1, 8, 9, 64])
@pytest.mark.parametrize("K", [5120, 13824, 71])
def test_packed_split_plans_walk_the_packed_rows(M, K):
    """A packed B's plans walk ceil(K/2) packed rows: 64-row steps for the
    tensor-core kernel (one plan for every M <= 8), K splits over the packed
    rows for the FMA kernels."""
    kh = (K + 1) // 2
    plan = split_plan(M, 13824, kh, SMS)
    assert plan.steps * TC_STEP >= kh > (plan.steps - 1) * TC_STEP
    if M <= 8:
        assert plan == split_plan(1, 13824, kh, SMS)
    splits, kps = fma_split_plan(M, 5120, kh, SMS)
    assert splits * kps >= kh > (splits - 1) * kps
