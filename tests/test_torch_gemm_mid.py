"""Mid-M GEMM (9 to 64 rows, bf16 compute): ``kernels.posit_gemm.ops.posit_gemm``
at those rows (CPU route = its plain version, which the card holds
csrc/posit_gemm_mid.cu to) against the reference's Pallas ``posit_gemm``
(interpret=True), and the route, launch key, plan and activation layout the
wrapper gives a CUDA call there.

Tolerances, as tests/test_torch_gemm.py states them: float out within
4*K*2^-24*(|A|@|B| + |bias|) + 16*2^-24*(|ref| + |residual|) on the values
the products see (rounded to bf16); posit out within 1 posit ulp in code
space.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.core.pack import pack_p8 as jax_pack
from repro.kernels.posit_gemm.posit_gemm import posit_gemm as jax_posit_gemm
from repro_torch import kernels
from repro_torch.core import types
from repro_torch.core.pack import pack_p8, unpack_p8
from repro_torch.kernels.posit_gemm.ops import (LARGE_M, MID_COLS, MID_M, MID_STEP,
                                             PACKED_KIND, gemm_route, launch_counter,
                                             mid_plan, mid_rows, mid_shape_ok, posit_gemm,
                                             uses_tensor_cores)
from test_torch_gemm import _check, _operand, _to_torch, _values

SMS = 132
B_KINDS = {"bf16": 1, "p8": 2, "p16": 3, "packed": PACKED_KIND}
QWEN_KN = ((5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120), (5120, 152064))

# (name, a_fmt, b_fmt, out_fmt, packed B): every B kind the tensor cores take,
# every A kind they take, posit out
ROWS = [
    ("f32xp8", "f32", "p8_1", "f32", False),
    ("bf16xp8", "bf16", "p8_2", "f32", False),
    ("p8xp8-p8out", "p8_0", "p8_0", "p8_2", False),
    ("f32xpacked", "f32", "p8_1", "f32", True),
    ("p8xpacked", "p8_0", "p8_0", "f32", True),
    ("f32xp16", "f32", "p16_1", "f32", False),
    ("bf16xp16-p16out", "bf16", "p16_1", "p16_1", False),
    ("p8xp16", "p8_0", "p16_2", "f32", False),
    ("f32xbf16", "f32", "bf16", "f32", False),
]
# (M, K, N, activation): the route's row counts, K ragged against the 64-row
# step (odd for the packed lanes), N a multiple of 16
SHAPES = [(9, 70, 48, "silu"), (16, 135, 32, "gelu"), (33, 64, 48, "relu"),
          (64, 77, 16, "none")]


@pytest.mark.parametrize("M,K,N,act", SHAPES)
@pytest.mark.parametrize("row", ROWS, ids=lambda r: r[0])
def test_mid_m_matches_pallas(row, M, K, N, act):
    name, a_name, b_name, o_name, packed = row
    rng = np.random.default_rng(zlib.crc32(f"mid/{name}/{M}/{K}/{N}".encode()))
    a = _operand(a_name, (M, K), rng, 1.0)
    w = _operand(b_name, (K, N), rng, K ** -0.5)
    b = np.asarray(jax_pack(jnp.asarray(w))) if packed else w
    bias = rng.normal(0, 0.1, (N,)).astype(np.float32)
    res = rng.normal(0, 1.0, (M, N)).astype(np.float32)
    jf = [jtypes.get_format(x) for x in (a_name, b_name, o_name)]
    es = [getattr(f, "es", 0) for f in jf]
    want = np.asarray(jax_posit_gemm(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(es, jnp.int32),
        a_fmt=jf[0], b_fmt=jf[1], out_fmt=jf[2], bias=jnp.asarray(bias),
        residual=jnp.asarray(res), activation=act, compute_dtype_name="bfloat16",
        block_m=64, block_n=128, block_k=128, interpret=True, b_packed=packed))
    tf = [types.get_format(x) for x in (a_name, b_name, o_name)]
    got = posit_gemm(_to_torch(a), torch.from_numpy(b) if packed else _to_torch(b), es,
                     a_fmt=tf[0], b_fmt=tf[1], out_fmt=tf[2], bias=torch.from_numpy(bias),
                     residual=torch.from_numpy(res), activation=act,
                     compute_dtype=torch.bfloat16, b_packed=packed).numpy()
    assert got.shape == (M, N) and got.dtype == want.dtype

    def seen(x, fmt):   # the values the products see: rounded to bf16
        v = _values(x, fmt)
        return np.asarray(jnp.asarray(v, jnp.float32).astype(jnp.bfloat16), np.float64)

    _check(got, want, o_name, seen(a, a_name), seen(w, b_name), bias, res, K)
    # a CUDA call of this shape takes the mid-M route
    a_kind = {"f32": 0, "bf16": 1, "p8_0": 2}[a_name]
    b_kind = PACKED_KIND if packed else B_KINDS[b_name.split("_")[0]]
    assert gemm_route(M, N, K, a_kind, b_kind, True) == "mid_tc"


@pytest.mark.parametrize("b_kind", list(B_KINDS.values()), ids=list(B_KINDS))
@pytest.mark.parametrize("a_kind", [0, 1, 2], ids=["f32", "bf16", "p8"])
@pytest.mark.parametrize("M", [1, 8, 9, 16, 33, 64, 65, 4096])
def test_route_by_rows(M, a_kind, b_kind):
    """Under bf16 compute every tensor-core pair takes the mid-M kernel from 9
    to ``MID_M`` rows on an aligned shape it takes; M <= 8 keeps the decode
    tile, M > 64 the large-M kernels; refused shapes and unaligned operands
    keep the 64-row tile (among them chip_smoke.py's ragged tensor-core cases,
    999 x 1001, 1030 x 1000 and 777 x 1001, so that tile keeps its checks on
    the card); f32 compute never takes the mid route."""
    assert MID_M == LARGE_M == 64
    N, K = 5120, 13824
    assert uses_tensor_cores(a_kind, b_kind, True)
    want = "tc" if M <= 8 else "mid_tc" if M <= 64 else "large_tc"
    assert gemm_route(M, N, K, a_kind, b_kind, True) == want
    assert gemm_route(M, N, K, a_kind, b_kind, False) == ("large_fma" if M > 64 else "fma")
    if 8 < M <= 64:
        for n, k in ((1001, 999), (1000, 1030), (1001, 777), (264, 5120)):
            assert not mid_shape_ok(n, k)
            assert gemm_route(M, n, k, a_kind, b_kind, True) == "tc"
        assert gemm_route(M, N, K, a_kind, b_kind, True, aligned=False) == "tc"


@pytest.mark.parametrize("b_kind", list(B_KINDS.values()), ids=list(B_KINDS))
def test_launch_counter_is_one_key_for_every_b_kind(b_kind):
    assert launch_counter(b_kind, True, mid=True) == "posit_gemm_mid_tc"
    assert "posit_gemm_mid_tc" in kernels.LAUNCHES
    assert launch_counter(b_kind, True) != "posit_gemm_mid_tc"


def _shares(plan):
    total = plan.tiles * plan.steps
    return [(total * b // plan.grid, total * (b + 1) // plan.grid) for b in range(plan.grid)]


def _owner(total, x, grid):
    """csrc/posit_gemm_mid.cu ``share_owner``: the block whose share holds item x."""
    return ((x + 1) * grid - 1) // total


@pytest.mark.parametrize("b_kind", list(B_KINDS.values()), ids=list(B_KINDS))
@pytest.mark.parametrize("K,N", QWEN_KN + ((70, 48), (1, 16), (13824, 1024), (3072, 32064)))
def test_mid_plan_covers_every_item_once(K, N, b_kind):
    """Every (128-column tile, 64-row k step) item belongs to exactly one
    block, the blocks' shares differ by at most one step and hold at least
    8 steps unless one block an SM would be too many, the kernel's owner
    formula finds each item's block, and a block's share meets at most two
    tiles it does not hold whole (the two slots of its partials)."""
    plan = mid_plan(N, K, SMS, b_kind)
    kb = -(-K // 2) if b_kind == PACKED_KIND else K
    assert plan.tiles == -(-N // MID_COLS)
    assert plan.steps * MID_STEP >= kb > (plan.steps - 1) * MID_STEP or (kb <= 0)
    total = plan.tiles * plan.steps
    shares = _shares(plan)
    assert shares[0][0] == 0 and shares[-1][1] == total
    assert all(x[1] == y[0] for x, y in zip(shares, shares[1:]))
    sizes = [e - s for s, e in shares]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert plan.grid == SMS or plan.grid == max(1, total // 8) < SMS
    for x in range(0, total, max(1, total // 997)):
        b = _owner(total, x, plan.grid)
        assert shares[b][0] <= x < shares[b][1]
    for s, e in shares:
        tiles = range(s // plan.steps, (e - 1) // plan.steps + 1)
        partial = [t for t in tiles if s > t * plan.steps or e < (t + 1) * plan.steps]
        assert len(partial) <= 2 and all(t in (tiles[0], tiles[-1]) for t in partial)


@pytest.mark.parametrize("K,N", QWEN_KN)
def test_mid_plan_is_the_same_for_every_row_count(K, N):
    """The plan is a function of N, K and the B kind: the wrapper passes no M,
    so a row's sums run in one order for every M in 9..64 (rows 0-8 of an M
    = 16 call are those of M = 9 and M = 64 calls, bit for bit on the card).
    Only the instruction's width follows M."""
    import inspect

    assert "M" not in inspect.signature(mid_plan).parameters
    for b_kind in B_KINDS.values():
        assert len({mid_plan(N, K, SMS, b_kind) for _ in range(9, 65)}) == 1
    assert [mid_rows(m) for m in (9, 16, 17, 32, 33, 64)] == [16, 16, 32, 32, 64, 64]
    assert all(mid_rows(m) >= m for m in range(9, 65))


def _a16(a: np.ndarray, K: int, packed: bool) -> np.ndarray:
    """The kernel's bf16 activation buffer (``mid_a16_kernel``): (M, width), A
    rounded to bf16, zero past K; for a packed B its low slice (columns 0..Kh)
    at column 0 and its high slice (Kh..K) at Kh64 = Kh rounded up to 64."""
    M = a.shape[0]
    kb = -(-K // 2) if packed else K
    kb64 = -(-kb // MID_STEP) * MID_STEP
    width = 2 * kb64 if packed else kb64
    out = np.zeros((M, width), np.float32)
    r = np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float32)
    if packed:
        out[:, :kb] = r[:, :kb]
        out[:, kb64:kb64 + K - kb] = r[:, kb:]
    else:
        out[:, :K] = r
    return out


@pytest.mark.parametrize("K", [64, 70, 129, 5120])
@pytest.mark.parametrize("packed", [False, True])
def test_activation_layout_walks_the_steps(K, packed):
    """Step s of the kernel multiplies B's rows [64s, 64s + 64) (packed rows:
    both codes of each word) by A16's columns [64s, 64s + 64) and, for a
    packed B, [Kh64 + 64s, ...): summed over the steps that is A @ decode(B)
    on the bf16-rounded A, with zeros past K on both sides. The buffer's
    width is the wrapper's (``plan.steps * MID_STEP``, twice for packed)."""
    rng = np.random.default_rng(K + packed)
    M, N = 16, 32
    a = rng.normal(0, 1, (M, K)).astype(np.float32)
    codes = torch.from_numpy(rng.integers(0, 256, (K, N)).astype(np.uint8))
    codes[codes == 0x80] = 0   # no NaR: zeros past K must stay zeros
    w = _values(codes.numpy(), "p8_0").astype(np.float32)
    a16 = _a16(a, K, packed)
    plan = mid_plan(N, K, SMS, PACKED_KIND if packed else 2)
    assert a16.shape[1] == plan.steps * MID_STEP * (2 if packed else 1)
    kb = -(-K // 2) if packed else K
    rows = np.zeros((plan.steps * MID_STEP, N), np.float32)   # B's rows, zero past kb
    if packed:
        words = pack_p8(codes)
        assert torch.equal(unpack_p8(words, K), codes)
        lo = _values((words.numpy() & 0xFF).astype(np.uint8), "p8_0")
        hi = _values((words.numpy() >> 8).astype(np.uint8), "p8_0")
        rows_hi = np.zeros_like(rows)
        rows[:kb], rows_hi[:kb] = lo, hi
    else:
        rows[:K] = w
    acc = np.zeros((M, N), np.float64)
    kb64 = plan.steps * MID_STEP
    for s in range(plan.steps):
        ks = slice(s * MID_STEP, (s + 1) * MID_STEP)
        acc += a16[:, ks].astype(np.float64) @ rows[ks]
        if packed:
            hs = slice(kb64 + s * MID_STEP, kb64 + (s + 1) * MID_STEP)
            acc += a16[:, hs].astype(np.float64) @ rows_hi[ks]
    ar = np.asarray(jnp.asarray(a).astype(jnp.bfloat16), np.float64)
    np.testing.assert_allclose(acc, ar @ w.astype(np.float64), rtol=1e-12, atol=1e-9)
