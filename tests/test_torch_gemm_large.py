"""Large-M GEMM: ``kernels.posit_gemm.ops.posit_gemm`` past ``LARGE_M`` rows
(CPU route = its plain version, which the card holds csrc/posit_gemm_large.cu
to) against the reference's Pallas ``posit_gemm`` (interpret=True), and the
route, launch key and K-split plan the wrapper gives a CUDA call there.

Tolerances, as tests/test_torch_gemm.py states them: float out within
4*K*2^-24*(|A|@|B| + |bias|) + 16*2^-24*(|ref| + |residual|) on the values
the products see (rounded to bf16 under bf16 compute); posit out within 1
posit ulp in code space.
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
from repro_torch.kernels.posit_gemm.ops import (LARGE_FMA_STEP, LARGE_FMA_TILE, LARGE_M,
                                             LARGE_TC_COLS, LARGE_TC_ROWS, LARGE_TC_STEP,
                                             PACKED_KIND, fma_split_plan, gemm_route,
                                             large_plan, large_shape_ok, large_split_plan,
                                             launch_counter, posit_gemm, split_plan,
                                             uses_tensor_cores)
from test_torch_gemm import _check, _operand, _to_torch, _values

SMS = 132
KIND = {"f32": 0, "bf16": 1, "p8_0": 2, "p8_1": 2, "p8_2": 2, "p16_1": 3, "p16_2": 3,
        "packed": PACKED_KIND}

# (name, a_fmt, b_fmt, out_fmt, compute, packed B): every B kind under both
# computes, A of each kind the layers feed
ROWS = [
    ("f32xp8-bf16", "f32", "p8_1", "f32", "bf16", False),
    ("bf16xp8-bf16", "bf16", "p8_2", "f32", "bf16", False),
    ("p8xp8-p8out", "p8_0", "p8_0", "p8_2", "bf16", False),
    ("f32xp16-bf16", "f32", "p16_1", "f32", "bf16", False),
    ("f32xbf16-bf16", "f32", "bf16", "f32", "bf16", False),
    ("f32xpacked-bf16", "f32", "p8_1", "f32", "bf16", True),
    ("f32xf32-f32", "f32", "f32", "f32", "f32", False),
    ("f32xp16-f32", "f32", "p16_1", "f32", "f32", False),
    ("f32xp8-f32", "f32", "p8_1", "f32", "f32", False),
    ("f32xpacked-f32", "f32", "p8_1", "f32", "f32", True),
    ("p16xp16-f32", "p16_1", "p16_2", "p16_1", "f32", False),
]
# (M, K, N, activation): past the threshold with ragged tiles; N a multiple
# of 16 and K of 8 (the large route's copies)
SHAPES = [(130, 80, 48, "silu"), (257, 112, 32, "gelu"), (257, 48, 112, "relu")]


@pytest.mark.parametrize("M,K,N,act", SHAPES)
@pytest.mark.parametrize("row", ROWS, ids=lambda r: r[0])
def test_large_m_matches_pallas(row, M, K, N, act):
    name, a_name, b_name, o_name, cd, packed = row
    rng = np.random.default_rng(zlib.crc32(f"{name}/{M}/{K}/{N}".encode()))
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
        residual=jnp.asarray(res), activation=act,
        compute_dtype_name="bfloat16" if cd == "bf16" else "float32",
        block_m=128, block_n=128, block_k=128, interpret=True, b_packed=packed))
    tf = [types.get_format(x) for x in (a_name, b_name, o_name)]
    tcd = torch.bfloat16 if cd == "bf16" else torch.float32
    got = posit_gemm(_to_torch(a), torch.from_numpy(b) if packed else _to_torch(b), es,
                     a_fmt=tf[0], b_fmt=tf[1], out_fmt=tf[2], bias=torch.from_numpy(bias),
                     residual=torch.from_numpy(res), activation=act, compute_dtype=tcd,
                     b_packed=packed).numpy()
    assert got.shape == (M, N) and got.dtype == want.dtype

    def seen(x, fmt):   # the values the products see
        v = _values(x, fmt)
        if cd == "bf16":
            v = np.asarray(jnp.asarray(v, jnp.float32).astype(jnp.bfloat16), np.float64)
        return v

    _check(got, want, o_name, seen(a, a_name), seen(w, b_name), bias, res, K)
    # a CUDA call of this shape takes the large-M route
    b_kind = PACKED_KIND if packed else KIND[b_name]
    assert gemm_route(M, N, K, KIND[a_name], b_kind, cd == "bf16").startswith("large")


@pytest.mark.parametrize("a_kind,b_kind,bf16", [
    (0, 2, True), (1, 2, True), (2, 2, True), (0, 1, True), (0, 3, True), (2, 3, True),
    (0, PACKED_KIND, True), (0, 0, True), (3, 2, True), (3, PACKED_KIND, True),
    (0, 0, False), (0, 1, False), (0, 2, False), (0, 3, False), (0, PACKED_KIND, False),
    (3, 3, False)])
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 64, 65, 128, 4032, 4096])
def test_route_and_counter_by_rows(a_kind, b_kind, bf16, M):
    """Up to ``LARGE_M`` rows a GEMM takes the kernels below it: for the
    pairs the tensor cores take, the decode tile at M <= 8 and the mid-M
    kernel (csrc/posit_gemm_mid.cu, one launch key whatever the B kind)
    from 9 rows on; the FMA kernels (decode tile, 64 x 64 tile) for the
    rest, with their plans and launch keys; past it, the wgmma kernel for
    the tensor-core pairs and the 128 x 128 FMA tile for the rest, each
    with a key of its own, whatever the B kind."""
    N, K = 5120, 13824
    tc = uses_tensor_cores(a_kind, b_kind, bf16)
    route = gemm_route(M, N, K, a_kind, b_kind, bf16)
    if tc and 8 < M <= LARGE_M:
        assert route == "mid_tc"
        key = launch_counter(b_kind, tc, mid=True)
        assert key == "posit_gemm_mid_tc"
    elif M <= LARGE_M:
        assert route == ("tc" if tc else "fma")
        key = launch_counter(b_kind, tc)
        assert key in ("posit_gemm", "posit_gemm_p16", "posit_gemm_packed",
                       "posit_gemm_packed_fma")
        kb = -(-K // 2) if b_kind == PACKED_KIND else K
        # the parent's plans, unchanged
        plan = split_plan(M, N, kb, SMS, b_kind)
        assert plan.rows == (8 if M <= 8 else 64)
        splits, kps = fma_split_plan(M, N, kb, SMS)
        assert splits * kps >= kb > (splits - 1) * kps
    else:
        assert route == ("large_tc" if tc else "large_fma")
        key = launch_counter(b_kind, tc, large=True)
        assert key == ("posit_gemm_large_tc" if tc else "posit_gemm_large_fma")
    assert key in kernels.LAUNCHES


@pytest.mark.parametrize("N,K,packed,ok", [
    (5120, 5120, False, True), (1008, 1032, False, True), (48, 80, True, True),
    (32064, 3072, False, True), (152064, 5120, False, True), (1008, 1040, True, True),
    (1000, 1032, False, False), (1001, 1032, False, False), (1008, 1028, False, False),
    (1008, 1030, False, False), (1008, 1032, True, True), (1016, 1032, False, False),
    (1008, 0, False, False), (16, 8, False, True), (16, 16, True, True), (16, 8, True, True),
    (1008, 1028, True, False), (1000, 1040, True, False)])
def test_alignment_rule_sends_refused_shapes_to_the_64_row_tiles(N, K, packed, ok):
    """The large-M kernels copy B's rows in 16-byte pieces and A's bf16 rows
    through the TMA: N must be a multiple of 16 and K of 8, whatever the B
    kind (a packed B is unpacked to bf16 for wgmma; its high slice of A, at
    K / 2, stays aligned for the FMA tile), and A and B 16-byte aligned;
    any other shape or pointer stays on the 64-row tiles at every M
    (``posit_gemm_large_launch`` refuses it)."""
    b_kind = PACKED_KIND if packed else 2
    assert large_shape_ok(N, K) is ok
    for bf16 in (True, False):
        tc = uses_tensor_cores(0, b_kind, bf16)
        small = "tc" if tc else "fma"
        assert gemm_route(4096, N, K, 0, b_kind, bf16) == ("large_" + small if ok else small)
        assert gemm_route(4096, N, K, 0, b_kind, bf16, aligned=False) == small


def _items(M, N, kb, tc):
    """Every (tile row, tile column, k block) the large plan's grid computes,
    in launch order (blockIdx x, y, z; a block walks its k blocks in order)."""
    plan = large_split_plan(M, N, kb, SMS, tc)
    step = LARGE_TC_STEP if tc else LARGE_FMA_STEP
    span = -(-kb // LARGE_TC_STEP) if tc else kb
    out = []
    for z in range(plan.splits):
        for y in range(plan.tiles_n):
            for x in range(plan.tiles_m):
                lo, hi = z * plan.k_per_split, min(span, (z + 1) * plan.k_per_split)
                assert lo < hi, "an empty split"
                if tc:
                    out += [(x, y, u) for u in range(lo, hi)]
                else:
                    out += [(x, y, k0 // step) for k0 in range(lo, hi, step)]
    return plan, out


# (M, N, K): the training shapes (phi3-mini-3.8b at 8 x 512 tokens), qwen2.5-14b's
# prefills at 4,032 and 1,024 tokens, the crossover sweep's rows, ragged tiles
PLAN_SHAPES = ([(4096, n, k) for k, n in ((3072, 3072), (3072, 8192), (8192, 3072),
                                           (3072, 32064))]
               + [(m, n, k) for m in (4032, 1024, 128, 512)
                  for k, n in ((5120, 5120), (5120, 1024), (5120, 13824), (13824, 5120))]
               + [(130, 48, 72), (257, 1008, 1032), (65, 16, 8)])


@pytest.mark.parametrize("tc", [True, False], ids=["wgmma", "fma"])
@pytest.mark.parametrize("M,N,K", PLAN_SHAPES)
def test_large_plan_covers_every_tile_and_k_step_once(M, N, K, tc):
    """The grid covers every (output tile, k step) exactly once, each split
    non-empty and in a fixed order (k blocks of a split in order, splits
    summed in split order by the epilogue kernel); splits only below a wave
    of tiles (one block an SM for wgmma, two for the FMA tile)."""
    plan, items = _items(M, N, K, tc)
    rows, cols = (LARGE_TC_ROWS, LARGE_TC_COLS) if tc else (LARGE_FMA_TILE, LARGE_FMA_TILE)
    assert (plan.tiles_m, plan.tiles_n) == (-(-M // rows), -(-N // cols))
    steps = -(-K // LARGE_TC_STEP) if tc else -(-K // LARGE_FMA_STEP)
    assert len(items) == len(set(items)) == plan.tiles_m * plan.tiles_n * steps
    tiles = plan.tiles_m * plan.tiles_n
    if tiles >= (SMS if tc else 2 * SMS):
        assert plan.splits == 1
    if not tc:
        assert plan.k_per_split % LARGE_FMA_STEP == 0
    assert plan == large_split_plan(M, N, K, SMS, tc)   # a pure function of the shape


@pytest.mark.parametrize("K,N", [(3072, 3072), (3072, 8192), (8192, 3072), (3072, 32064)])
def test_training_shapes_take_one_split(K, N):
    """At the train path's M = 4,096 the FMA tile runs one K split, so each
    output is the parent's ``gemm_kernel`` sum: one fmaf a product in k
    order, which the parent's plan also ran in one split."""
    assert large_split_plan(4096, N, K, SMS, False).splits == 1
    assert fma_split_plan(4096, N, K, SMS)[0] == 1


@pytest.mark.parametrize("b_kind", [1, 2, 3, PACKED_KIND])
@pytest.mark.parametrize("M", [65, 128, 255, 256, 1024, 4032])
def test_posit_b_decoded_once_for_long_prefills(b_kind, M):
    """Past ``LARGE_M`` rows the wgmma kernel reads every B as (K, N) bf16: a
    posit B (p8, packed p8, p16) is decoded once for the call, so the plan
    walks all K rows (a packed B's ceil(K/2) rows unpacked), as for bf16 B
    at the same shape. The f32-FMA tile reads a packed B as it is."""
    K, N = 5120, 13824
    tc = uses_tensor_cores(0, b_kind, True)
    assert tc and gemm_route(M, N, K, 0, b_kind, True) == "large_tc"
    plan = large_plan(M, N, K, b_kind, SMS, tc)
    assert plan == large_plan(M, N, K, 1, SMS, True) == large_split_plan(M, N, K, SMS, True)
    assert plan.splits * plan.k_per_split * LARGE_TC_STEP >= K
    assert (plan.splits - 1) * plan.k_per_split * LARGE_TC_STEP < K
    kb = -(-K // 2) if b_kind == PACKED_KIND else K
    fma = large_plan(M, N, K, b_kind, SMS, False)
    assert fma == large_split_plan(M, N, kb, SMS, False)
    assert fma.splits * fma.k_per_split >= kb > (fma.splits - 1) * fma.k_per_split
