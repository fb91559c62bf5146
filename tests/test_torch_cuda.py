"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``cuda`` and
skips without one. It imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest
import torch

from chip_smoke import (EagerTwin, assert_bit_identical, attn_inputs, check_small_moe_loss,
                        check_small_whisper, eager_twin, live_codes, page_cache,
                        prefix_requests, recorded_binds, serve_recorded_timed, served_recorded)
from repro_torch import kernels
from repro_torch.calib import observe
from repro_torch.configs import get_arch
from repro_torch.core.pack import pack_p8, unpack_p8
from repro_torch.core.pcsr import P8_SERVE, OperandSlots, parse_policy
from repro_torch.core.policy import get_precision_policy
from repro_torch.core.types import BF16, F32, P8_0, P8_1, P8_2, P8_3, P16_1
from repro_torch.kernels.posit_attention import ops as attn_ops
from repro_torch.kernels.posit_attention import ref as attn_ref
from repro_torch.kernels.posit_attention.ref import posit_decode_attention_ref
from repro_torch.kernels.posit_codec import ops as codec_ops
from repro_torch.kernels.posit_codec import ref as codec_ref
from repro_torch.kernels.posit_gemm.ops import posit_gemm
from repro_torch.kernels.posit_gemm.ref import posit_gemm_ref
from repro_torch.kernels.posit_quire_gemm.ops import posit_quire_gemm, quire_gemm
from repro_torch.kernels.posit_quire_gemm.ref import posit_quire_gemm_ref
from repro_torch.kernels.posit_softmax.ops import softmax
from repro_torch.kernels.posit_softmax.ref import posit_softmax_ref
from repro_torch.launch.engine import (CapturedStep, ContinuousBatchingEngine, Request,
                                       poisson_requests)
from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine
from repro_torch.models.registry import build_model

pytestmark = pytest.mark.cuda
U = 2.0 ** -24


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("nbits", [8, 16])
def test_codec_kernels_bit_exact(dev, nbits):
    dt = torch.uint8 if nbits == 8 else torch.uint16
    codes = torch.arange(1 << nbits, device=dev, dtype=torch.int32).to(dt)
    x = torch.cat([torch.randn(10001, device=dev) * s for s in (1e-3, 1.0, 1e3)])
    for es in range(4):
        got = codec_ops.decode(codes, es, nbits=nbits)
        want = codec_ref.decode_ref(codes, es, nbits=nbits)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(codec_ops.encode(x, es, nbits=nbits).to(torch.int32),
                           codec_ref.encode_ref(x, es, nbits=nbits).to(torch.int32))


@pytest.mark.parametrize("M", [1, 3, 6, 9, 33])
@pytest.mark.parametrize("b_fmt,a_dtype", [(P8_0, torch.bfloat16), (P16_1, torch.float32)])
def test_gemm_kernel_matches_plain(dev, M, b_fmt, a_dtype):
    K, N = 300, 257 if M % 2 else 264   # ragged and vector-width column counts
    g = torch.Generator(device=dev).manual_seed(M)
    a = torch.randn((M, K), generator=g, device=dev).to(a_dtype)
    b = codec_ops.encode(torch.randn((K, N), generator=g, device=dev) * K ** -0.5, b_fmt.es,
                         nbits=b_fmt.nbits)
    bias = torch.randn((N,), generator=g, device=dev)
    res = torch.randn((M, N), generator=g, device=dev)
    a_fmt = BF16 if a_dtype == torch.bfloat16 else F32
    kw = dict(a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=F32, bias=bias, residual=res,
              activation="silu")
    before = kernels.LAUNCHES["posit_gemm"]
    got = posit_gemm(a, b, (0, b_fmt.es, 0), **kw)
    assert kernels.LAUNCHES["posit_gemm"] == before + 1
    want = posit_gemm_ref(a, b, (0, b_fmt.es, 0), **kw)
    bvals = codec_ref.decode_ref(b, b_fmt.es, nbits=b_fmt.nbits)
    tol = 4 * K * U * (a.float().abs() @ bvals.abs() + bias.abs()) \
        + 16 * U * (want.abs() + res.abs())
    assert ((got - want).abs() <= tol).all()


def _gemm_operands(dev, M, K, N, b_fmt, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((M, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    b = w.to(torch.bfloat16) if b_fmt == BF16 else codec_ops.encode(w, b_fmt.es,
                                                                      nbits=b_fmt.nbits)
    bias = torch.randn((N,), generator=g, device=dev)
    res = torch.randn((M, N), generator=g, device=dev)
    return a, b, bias, res


@pytest.mark.parametrize("M", [1, 4, 8, 9, 64])
@pytest.mark.parametrize("K,N", [(999, 1001), (1030, 1000), (640, 384)])
@pytest.mark.parametrize("b_fmt", [P8_1, P8_2, P8_3, BF16])
def test_gemm_tensor_core_shapes_match_plain(dev, M, K, N, b_fmt):
    """The tensor-core path (bf16 compute, p8 at es 1..3 or bf16 weights) at
    ragged K and N, decode and prefill row counts; same bound as above."""
    a, b, bias, res = _gemm_operands(dev, M, K, N, b_fmt, M + K)
    kw = dict(a_fmt=F32, b_fmt=b_fmt, out_fmt=F32, bias=bias, residual=res,
              activation="gelu", compute_dtype=torch.bfloat16)
    es = (0, getattr(b_fmt, "es", 0), 0)
    got = posit_gemm(a, b, es, **kw)
    want = posit_gemm_ref(a, b, es, **kw)
    bvals = b.float() if b_fmt == BF16 else codec_ref.decode_ref(b, b_fmt.es, nbits=b_fmt.nbits)
    tol = 4 * K * U * (a.to(torch.bfloat16).float().abs() @ bvals.abs() + bias.abs()) \
        + 16 * U * (want.abs() + res.abs())
    assert ((got - want).abs() <= tol).all()


@pytest.mark.parametrize("K,N", [(5120, 5120), (5120, 1024), (777, 1001)])
def test_gemm_decode_rows_batch_invariant(dev, K, N):
    """Decode rows (M <= 8) are bit for bit the same whatever the batch."""
    a, b, bias, res = _gemm_operands(dev, 8, K, N, P8_0, 3)
    kw = dict(a_fmt=F32, b_fmt=P8_0, out_fmt=F32, activation="silu",
              compute_dtype=torch.bfloat16)
    full = posit_gemm(a, b, (0, 0, 0), bias=bias, residual=res, **kw).view(torch.int32)
    for M in (1, 4):
        part = posit_gemm(a[:M].contiguous(), b, (0, 0, 0), bias=bias,
                          residual=res[:M].contiguous(), **kw).view(torch.int32)
        assert torch.equal(part, full[:M])
    again = posit_gemm(a, b, (0, 0, 0), bias=bias, residual=res, **kw).view(torch.int32)
    assert torch.equal(again, full)


@pytest.mark.parametrize("M", [1, 4, 8, 9, 64])
@pytest.mark.parametrize("K,N", [(999, 1001), (1030, 1000), (640, 384)])
@pytest.mark.parametrize("a_fmt", [F32, BF16, P8_0], ids=["f32", "bf16", "p8"])
def test_gemm_p16_tensor_cores_match_plain(dev, M, K, N, a_fmt):
    """p16 weights under bf16 compute run on the tensor cores (their own
    launch count; past 8 rows on an N the mid-M kernel takes, its key) and
    agree with the plain version within the GEMM bound on the bf16-rounded
    operands, at ragged K and N, decode and prefill rows."""
    a, b, bias, res = _gemm_operands(dev, M, K, N, P16_1, M + K + 2)
    if a_fmt == BF16:
        a = a.to(torch.bfloat16)
    elif a_fmt == P8_0:
        a = codec_ops.encode(a, 0, nbits=8)
    kw = dict(a_fmt=a_fmt, b_fmt=P16_1, out_fmt=F32, bias=bias, residual=res,
              activation="silu", compute_dtype=torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    got = posit_gemm(a, b, (0, 1, 0), **kw)
    # 9-64 rows on a shape the mid-M kernel takes run there, under its key
    key = "posit_gemm_mid_tc" if M > 8 and N % 16 == 0 else "posit_gemm_p16"
    assert kernels.LAUNCHES[key] == before[key] + 1
    assert kernels.LAUNCHES["posit_gemm"] == before["posit_gemm"]
    want = posit_gemm_ref(a, b, (0, 1, 0), **kw)
    avals = codec_ref.decode_ref(a, 0, nbits=8) if a_fmt == P8_0 else a.float()
    bvals = codec_ref.decode_ref(b, 1, nbits=16).to(torch.bfloat16).float()
    tol = 4 * K * U * (avals.to(torch.bfloat16).float().abs() @ bvals.abs() + bias.abs()) \
        + 16 * U * (want.abs() + res.abs())
    assert ((got - want).abs() <= tol).all()


@pytest.mark.parametrize("es", [0, 1, 2, 3])
@pytest.mark.parametrize("M", [8, 16, 64])
def test_gemm_p16_tensor_cores_decode_every_code(dev, es, M):
    """Every p16 code through one-hot activation rows (one k step): the
    tensor-core route's result is the bf16 rounding of each decoded code,
    bit for bit the plain version's; NaR's column reads NaN. M = 16 pads
    to a column count the mid-M kernel takes (16 extra, not 8)."""
    codes = torch.arange(1 << 16, device=dev, dtype=torch.int32)
    codes = torch.cat([codes[codes != 0x8000], codes.new_zeros(1)])
    pad = 16 if M == 16 else 8
    b = torch.cat([codes.reshape(M, -1), codes.new_zeros((M, pad))], dim=1)
    b[0, -pad] = 0x8000
    b = b.to(torch.uint16).contiguous()
    a = torch.eye(M, device=dev)
    kw = dict(a_fmt=F32, b_fmt=P16_1, out_fmt=F32, compute_dtype=torch.bfloat16)
    got = posit_gemm(a, b, (0, es, 0), **kw)
    want = posit_gemm_ref(a, b, (0, es, 0), **kw)
    assert torch.equal(got.isnan(), want.isnan()) and bool(got[:, -pad].isnan().all())
    live = ~want.isnan()
    assert torch.equal(got[live].view(torch.int32), want[live].view(torch.int32))


@pytest.mark.parametrize("K,N", [(5120, 5120), (5120, 1024), (777, 1001)])
def test_gemm_p16_decode_rows_batch_invariant(dev, K, N):
    """p16 decode rows (M <= 8) on the tensor cores are bit for bit the same
    whatever the batch."""
    a, b, bias, res = _gemm_operands(dev, 8, K, N, P16_1, 4)
    kw = dict(a_fmt=F32, b_fmt=P16_1, out_fmt=F32, activation="none",
              compute_dtype=torch.bfloat16)
    full = posit_gemm(a, b, (0, 1, 0), bias=bias, residual=res, **kw).view(torch.int32)
    for M in (1, 4):
        part = posit_gemm(a[:M].contiguous(), b, (0, 1, 0), bias=bias,
                          residual=res[:M].contiguous(), **kw).view(torch.int32)
        assert torch.equal(part, full[:M])


@pytest.mark.parametrize("M", [1, 4, 8, 9, 64])
@pytest.mark.parametrize("K,N", [(999, 1001), (1030, 1000), (640, 384), (5120, 264)])
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32], ids=["tc", "fma"])
def test_packed_gemm_kernel_matches_plain(dev, M, K, N, cd):
    """The packed variants (tensor cores under bf16 compute, f32 FMA under
    f32) against the packed plain version and against the unpacked kernel on
    ``unpack_p8`` of the same codes, at odd and even K, ragged N, decode and
    prefill rows; each launch counts under its own variant (the mid-M
    kernel's key at 9-64 rows on an N it takes)."""
    a, b, bias, res = _gemm_operands(dev, M, K, N, P8_2, M + K + 1)
    bp = pack_p8(b)
    kw = dict(a_fmt=F32, b_fmt=P8_2, out_fmt=F32, bias=bias, residual=res,
              activation="silu", compute_dtype=cd)
    name = "posit_gemm_packed" if cd == torch.bfloat16 else "posit_gemm_packed_fma"
    if cd == torch.bfloat16 and M > 8 and N % 16 == 0:
        name = "posit_gemm_mid_tc"   # 9-64 rows on a shape the mid-M kernel takes
    before = dict(kernels.LAUNCHES)
    got = posit_gemm(a, bp, (0, 2, 0), b_packed=True, **kw)
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert kernels.LAUNCHES["posit_gemm"] == before["posit_gemm"]
    bvals = codec_ref.decode_ref(b, 2, nbits=8)
    tol = 4 * K * U * (a.to(cd).float().abs() @ bvals.abs() + bias.abs()) \
        + 16 * U * (got.abs() + res.abs())
    for want in (posit_gemm_ref(a, bp, (0, 2, 0), b_packed=True, **kw),
                 posit_gemm(a, unpack_p8(bp, K).contiguous(), (0, 2, 0), **kw)):
        assert ((got - want).abs() <= tol).all()


@pytest.mark.parametrize("K,N", [(5120, 13824), (13824, 5120), (777, 1001)])
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32], ids=["tc", "fma"])
def test_packed_gemm_decode_rows_batch_invariant(dev, K, N, cd):
    """Packed decode rows (M <= 8) are bit for bit the same whatever the batch."""
    a, b, bias, res = _gemm_operands(dev, 8, K, N, P8_0, 5)
    bp = pack_p8(b)
    kw = dict(a_fmt=F32, b_fmt=P8_0, out_fmt=F32, activation="silu", compute_dtype=cd,
              b_packed=True)
    full = posit_gemm(a, bp, (0, 0, 0), bias=bias, residual=res, **kw).view(torch.int32)
    for M in (1, 4):
        part = posit_gemm(a[:M].contiguous(), bp, (0, 0, 0), bias=bias,
                          residual=res[:M].contiguous(), **kw).view(torch.int32)
        assert torch.equal(part, full[:M])


@pytest.mark.parametrize("M", [1, 4, 13])
def test_quire_gemm_packed_b_same_bits(dev, M):
    """A packed rs2 through the quire front door gives the unpacked bits."""
    K, N = 1001, 301
    g = torch.Generator(device=dev).manual_seed(M + 40)
    a, b = _quire_operands(g, dev, M, K, N, P16_1, P8_0)
    slots = OperandSlots(rs1=P16_1, rs2=P8_0, rd=F32, dataflow="quire")
    got = quire_gemm(a, pack_p8(b), slots.with_packed()).view(torch.int32)
    assert torch.equal(got, quire_gemm(a, b, slots).view(torch.int32))


@pytest.mark.parametrize("Hq,Hkv,d,kv_bits", [(10, 2, 64, 8), (32, 32, 96, 16)])
def test_attention_kernel_matches_plain(dev, Hq, Hkv, d, kv_bits):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((4, Hq, d), generator=g, device=dev)
    k = codec_ops.encode(torch.randn((4, Hkv, 100, d), generator=g, device=dev), 0,
                         nbits=kv_bits)
    v = codec_ops.encode(torch.randn((4, Hkv, 100, d), generator=g, device=dev), 0,
                         nbits=kv_bits)
    lens = torch.tensor([0, 1, 33, 100], dtype=torch.int32, device=dev)
    got = attn_ops.decode_attention(q, k, v, lens, 0, kv_bits=kv_bits)
    want = posit_decode_attention_ref(q, k, v, lens, 0, kv_bits=kv_bits)
    vmax = float(codec_ref.decode_ref(v, 0, nbits=kv_bits).abs().max())
    assert float((got - want).abs().max()) <= 8 * (d + 200) * U * vmax
    assert bool((got[0] == 0).all())


def _attn_case(dev, g_heads, d, kv_bits, S, lengths, seed, Hkv=2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    q = torch.randn((B, Hkv * g_heads, d), generator=gen, device=dev)
    k, v = (torch.randn((B, Hkv, S, d), generator=gen, device=dev) for _ in range(2))
    if kv_bits:
        k, v = (codec_ops.encode(t, 1, nbits=kv_bits) for t in (k, v))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _vmax(v, kv_bits):
    return float((codec_ref.decode_ref(v, 1, nbits=kv_bits) if kv_bits else v).abs().max())


@pytest.mark.parametrize("d", [96, 128, 256])
@pytest.mark.parametrize("g_heads,kv_bits,S", [(1, 16, 4096), (5, 8, 4096), (7, 0, 1000),
                                               (16, 8, 600)])
def test_attention_splits_match_plain(dev, d, g_heads, kv_bits, S):
    """Splits of 512 positions over ragged rows (0, 1, mid, full), any number
    of q-heads a KV head, head_dim up to 256, within 4 * (d + 2S) * u * max|V|."""
    q, k, v, lens = _attn_case(dev, g_heads, d, kv_bits, S, [0, 1, S // 2 + 3, S], seed=d + S)
    got = attn_ops.decode_attention(q, k, v, lens, 1, kv_bits=kv_bits)
    want = posit_decode_attention_ref(q, k, v, lens, 1, kv_bits=kv_bits)
    assert float((got - want).abs().max()) <= 4 * (d + 2 * S) * U * _vmax(v, kv_bits)
    assert bool((got[0] == 0).all())


@pytest.mark.parametrize("d,g_heads,kv_bits,S", [(128, 5, 8, 80), (128, 5, 8, 2048),
                                                 (96, 1, 16, 700), (256, 7, 0, 520)])
def test_attention_append_writes_and_attends_like_unfused(dev, d, g_heads, kv_bits, S):
    """The fused call's cache codes are those of encode + the row write (a
    row at pos >= S untouched), and its output has the bits of the unfused
    kernel on the written cache."""
    q, k, v, lens = _attn_case(dev, g_heads, d, kv_bits, S, [3, S, S, 0], seed=S)
    pos = torch.tensor([2, S, S - 1, 0], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    kn, vn = (torch.randn((4, 2, d), generator=gen, device=dev) for _ in range(2))
    k_want, v_want = k.clone(), v.clone()
    for cache, new in ((k_want, kn), (v_want, vn)):
        attn_ref.store_row(cache, new, pos, 1, kv_bits=kv_bits)
    got = attn_ops.decode_attention_append(q, kn, vn, k, v, pos, lens, 1, kv_bits=kv_bits)
    assert torch.equal(k.view(torch.uint8), k_want.view(torch.uint8))
    assert torch.equal(v.view(torch.uint8), v_want.view(torch.uint8))
    unfused = attn_ops.decode_attention(q, k_want, v_want, lens, 1, kv_bits=kv_bits)
    assert torch.equal(got.view(torch.int32), unfused.view(torch.int32))
    assert bool((got[3] == 0).all())


@pytest.mark.parametrize("kv_bits,S", [(8, 80), (8, 4096), (16, 3000)])
def test_attention_row_bits_do_not_depend_on_the_batch(dev, kv_bits, S):
    """A row alone and inside a batch of other rows: the same bits."""
    q, k, v, lens = _attn_case(dev, 5, 128, kv_bits, S, [S, 7, S // 3, 0], seed=11)
    batch = attn_ops.decode_attention(q, k, v, lens, 1, kv_bits=kv_bits)
    for b in range(4):
        alone = attn_ops.decode_attention(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                                          v[b:b + 1].contiguous(), lens[b:b + 1], 1,
                                          kv_bits=kv_bits)
        assert torch.equal(alone[0].view(torch.int32), batch[b].view(torch.int32))


@pytest.mark.parametrize("kv_bits,dtype", [(8, torch.uint8), (16, torch.uint16),
                                            (0, torch.float32), (0, torch.bfloat16)])
def test_attention_emulation_plans_the_kernels_warps(dev, kv_bits, dtype):
    """The split order's CPU emulation runs as many warps a block as the
    kernel, and the launch refuses a split plan that does not cover S."""
    for d in (32, 96, 128, 160, 256):
        assert attn_ref.kernel_warps(d, dtype.itemsize, kv_bits) == \
            attn_ops.kernel_warps(kv_bits, dtype, d)
    q, k, v, lens = _attn_case(dev, 5, 128, 8, 1030, [1030, 7], seed=3)
    out = torch.empty_like(q)
    rc = attn_ops._lib().posit_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), out.data_ptr(), None, None,
        None, None, None, 2, 10, 2, 1030, 128, 2, 1, attn_ops.CHUNK, 1, 1, 0.1, None)
    assert rc != 0


def _quire_operands(g, dev, M, K, N, a_fmt, b_fmt):
    """Codes of normal values with zeros, one NaR in A and a block of
    +-maxpos x -+maxpos products (the quire's widest digits)."""
    a = codec_ops.encode(torch.randn((M, K), generator=g, device=dev), a_fmt.es,
                         nbits=a_fmt.nbits).to(torch.int32)
    b = codec_ops.encode(torch.randn((K, N), generator=g, device=dev) * K ** -0.5, b_fmt.es,
                         nbits=b_fmt.nbits).to(torch.int32)
    a[:, ::7] = 0
    a[M - 1, K // 2] = 1 << (a_fmt.nbits - 1)
    a[0, :16] = (1 << (a_fmt.nbits - 1)) - 1
    b[:16, 0] = (1 << b_fmt.nbits) - ((1 << (b_fmt.nbits - 1)) - 1)
    return a.to(a_fmt.storage_dtype), b.to(b_fmt.storage_dtype)


@pytest.mark.parametrize("M", [1, 4, 13])
@pytest.mark.parametrize("a_fmt,b_fmt,out_fmt,act", [
    (P16_1, P16_1, F32, "silu"), (P16_1, P16_1, F32, "none"), (P8_3, P8_3, P8_3, "none"),
    (P16_1, P8_0, P16_1, "relu"), (P8_0, P16_1, F32, "gelu")])
def test_quire_gemm_kernel_bit_exact(dev, M, a_fmt, b_fmt, out_fmt, act):
    K, N = 1000, 301                      # off every k tile and column block
    g = torch.Generator(device=dev).manual_seed(M)
    a, b = _quire_operands(g, dev, M, K, N, a_fmt, b_fmt)
    epi = act != "none"
    bias = torch.randn((N,), generator=g, device=dev) if epi else None
    res = torch.randn((M, N), generator=g, device=dev) if epi else None
    es = (a_fmt.es, b_fmt.es, getattr(out_fmt, "es", 0))
    kw = dict(a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=out_fmt, bias=bias, residual=res,
              activation=act)
    before = kernels.LAUNCHES["posit_quire_gemm"]
    got = posit_quire_gemm(a, b, es, **kw)
    assert kernels.LAUNCHES["posit_quire_gemm"] == before + 1
    want = posit_quire_gemm_ref(a, b, es, **kw)
    one = posit_quire_gemm(a, b, es, splits=1, **kw)
    if out_fmt == F32:
        got, want, one = (t.view(torch.int32) for t in (got, want, one))
    assert torch.equal(got, want)
    assert torch.equal(one, got)


def _wide_codes(g, dev, shape, fmt, kind):
    """Every non-NaR code drawn uniformly (all_codes), or normal values with
    +-maxpos and +-minpos in the first 32-k chunk of row 0 and column 0
    (minmax): spans far beyond the kernel's window."""
    n = fmt.nbits
    if kind == "all_codes":
        c = torch.randint(0, (1 << n) - 1, shape, generator=g, device=dev, dtype=torch.int32)
        return torch.where(c >= 1 << (n - 1), c + 1, c).to(fmt.storage_dtype)
    c = codec_ops.encode(torch.randn(shape, generator=g, device=dev), fmt.es,
                         nbits=n).to(torch.int32)
    edge = torch.tensor([(1 << (n - 1)) - 1, 1, (1 << (n - 1)) + 1, (1 << n) - 1],
                        dtype=torch.int32, device=dev)
    c[0, :4] = edge
    c[:4, 0] = edge.flip(0)[:shape[0]]
    return c.to(fmt.storage_dtype)


@pytest.mark.parametrize("kind", ["all_codes", "minmax"])
@pytest.mark.parametrize("M,a_fmt,b_fmt,out_fmt,act", [
    (4, P16_1, P16_1, P16_1, "none"), (8, P16_1, P16_1, F32, "silu"),
    (4, P8_0, P16_1, F32, "none"), (6, P16_1, P8_3, P16_1, "relu"),
    (32, P8_3, P8_3, P8_3, "none"), (1, P8_0, P8_0, F32, "gelu")])
def test_quire_gemm_kernel_wide_span_bit_exact(dev, kind, M, a_fmt, b_fmt, out_fmt, act):
    """Operands whose scales leave the window: the per-product branch runs
    beside the chunk sums (p8 at es 0 spans only 12 binades, so there none
    leave it), bit for bit the plain version at every split."""
    from repro_torch.kernels.posit_quire_gemm.ref import per_product_share, window
    K, N = 1000, 301
    g = torch.Generator(device=dev).manual_seed(M + len(kind))
    a = _wide_codes(g, dev, (M, K), a_fmt, kind)
    b = _wide_codes(g, dev, (K, N), b_fmt, kind)
    epi = act != "none"
    kw = dict(a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=out_fmt, activation=act,
              bias=torch.randn((N,), generator=g, device=dev) if epi else None,
              residual=torch.randn((M, N), generator=g, device=dev) if epi else None)
    es = (a_fmt.es, b_fmt.es, getattr(out_fmt, "es", 0))
    count, _ = per_product_share(a, b, es, a_fmt=a_fmt, b_fmt=b_fmt)
    wide = any(2 * ((f.nbits - 2) << f.es) > window(f.nbits) for f in (a_fmt, b_fmt))
    assert (count > 0) == wide
    as_bits = (lambda t: t.view(torch.int32)) if out_fmt == F32 else (lambda t: t)
    want = as_bits(posit_quire_gemm_ref(a, b, es, **kw))
    for splits in (None, 1, 3, 8):
        assert torch.equal(as_bits(posit_quire_gemm(a, b, es, splits=splits, **kw)), want)


def test_quire_gemm_kernel_refuses_splits_past_one_cluster(dev):
    """K splits over the blocks of one cluster, at most 8: more raise."""
    a = torch.ones((4, 4096), dtype=torch.uint16, device=dev)
    b = torch.ones((4096, 64), dtype=torch.uint16, device=dev)
    with pytest.raises(ValueError):
        posit_quire_gemm(a, b, (1, 1, 1), a_fmt=P16_1, b_fmt=P16_1, out_fmt=F32, splits=9)


def test_quire_gemm_kernel_normalises_past_max_deferred(dev):
    """K = 20000 in one split: 157 stages of 128 k, so the kernel
    normalises its quires once on the way (every 128 stages) besides the
    final one."""
    g = torch.Generator(device=dev).manual_seed(7)
    a, b = _quire_operands(g, dev, 2, 20000, 40, P16_1, P16_1)
    kw = dict(a_fmt=P16_1, b_fmt=P16_1, out_fmt=P16_1)
    want = posit_quire_gemm_ref(a, b, (1, 1, 1), **kw)
    assert torch.equal(posit_quire_gemm(a, b, (1, 1, 1), splits=1, **kw), want)
    assert torch.equal(posit_quire_gemm(a, b, (1, 1, 1), **kw), want)


@pytest.mark.parametrize("R,C,nbits", [
    (1024, 8, 16), (64, 300, 8), (4, 32064, 16), (64, 1, 16), (64, 31, 8), (3, 1025, 8),
    (8, 2500, 16), (4, 152064, 8), (4, 152064, 16), (2, 300000, 16)])
def test_softmax_kernel_within_one_ulp(dev, R, C, nbits):
    g = torch.Generator(device=dev).manual_seed(C)
    codes = codec_ops.encode(torch.randn((R, C), generator=g, device=dev) * 3, 1,
                             nbits=nbits).to(torch.int32)
    codes[0, min(1, C - 1)] = 1 << (nbits - 1)
    codes = codes.to(torch.uint8 if nbits == 8 else torch.uint16)
    before = kernels.LAUNCHES["posit_softmax"]
    got = softmax(codes, 1, nbits=nbits)
    assert kernels.LAUNCHES["posit_softmax"] == before + 1
    want = posit_softmax_ref(codes, 1, nbits=nbits)
    half, full = 1 << (nbits - 1), 1 << nbits
    sg, sw = got.to(torch.int64), want.to(torch.int64)
    sg = torch.where(sg >= half, sg - full, sg)
    sw = torch.where(sw >= half, sw - full, sw)
    assert int((sg - sw).abs().max()) <= 1
    assert bool((got[0] == half).all())
    assert torch.equal(softmax(codes, 1, nbits=nbits), got)   # a fixed sum order


def test_reduced_engine_on_card(dev):
    cfg = get_arch("qwen2.5-14b").reduced()
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    eng = ContinuousBatchingEngine(model, params, P8_SERVE, max_slots=2, S_max=20)
    kernels.reset_launches()
    done = eng.run(poisson_requests(3, arrival_rate=0.0, prompt_lens=(8,),
                                    max_new_tokens=4, vocab=cfg.vocab))
    assert len(done) == 3 and all(len(c.tokens) == 4 for c in done)
    assert kernels.LAUNCHES["posit_gemm"] > 0 and kernels.LAUNCHES["posit_attention"] > 0
    assert kernels.LAUNCHES["posit_encode"] > 0


def test_reduced_quire_engine_on_card(dev):
    cfg = get_arch("phi3-mini-3.8b").reduced()
    pol = parse_policy("weights=p16_1,kv=p16_1,dataflow=quire")
    model = build_model(cfg)
    params = model.init(0, pol)
    eng = ContinuousBatchingEngine(model, params, pol, max_slots=2, S_max=20)
    kernels.reset_launches()
    done = eng.run(poisson_requests(3, arrival_rate=0.0, prompt_lens=(8,),
                                    max_new_tokens=4, vocab=cfg.vocab))
    assert len(done) == 3 and all(len(c.tokens) == 4 for c in done)
    assert kernels.LAUNCHES["posit_quire_gemm"] > 0 and kernels.LAUNCHES["posit_gemm"] == 0
    assert kernels.LAUNCHES["posit_attention"] > 0 and kernels.LAUNCHES["posit_encode"] > 0


@pytest.mark.parametrize("base", [P8_SERVE, parse_policy("none")], ids=["p8-serve", "f32"])
def test_reduced_mixed_precision_engine_on_card(dev, base):
    """The reduced qwen2.5-14b under attn-p16-mlp-p8: p16 attention on the
    unpacked kernel (its tensor-core p16 route under bf16 compute, the
    f32-FMA kernels under f32), MLP and head on the packed variant of the
    base's compute dtype."""
    cfg = get_arch("qwen2.5-14b").reduced()
    pol = get_precision_policy("attn-p16-mlp-p8", base=base)
    model = build_model(cfg)
    params = model.init(0, pol)
    assert "w_packed" in params["blocks"][0]["mlp"]["up"]
    eng = ContinuousBatchingEngine(model, params, pol, max_slots=2, S_max=20)
    kernels.reset_launches()
    done = eng.run(poisson_requests(3, arrival_rate=0.0, prompt_lens=(8,),
                                    max_new_tokens=4, vocab=cfg.vocab))
    assert len(done) == 3 and all(len(c.tokens) == 4 for c in done)
    bf16 = base.compute_dtype == "bf16"
    packed = "posit_gemm_packed" if bf16 else "posit_gemm_packed_fma"
    p16, idle = ("posit_gemm_p16", "posit_gemm") if bf16 else ("posit_gemm", "posit_gemm_p16")
    assert kernels.LAUNCHES[packed] > 0 and kernels.LAUNCHES[p16] > 0
    assert kernels.LAUNCHES[idle] == 0


def _serve_recorded(eng, prompts):
    """Staggered admission; every sampled row of logits (prefill and decode)
    cloned as the sampler saw it, the tokens and the launches of the run."""
    seen = []
    sample = eng._next_token
    eng._next_token = lambda logits: (seen.append(logits.clone()), sample(logits))[1]
    kernels.reset_launches()
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(prompts)]
    eng.submit(reqs[0])
    eng.admit()
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    while eng.queue or eng.active.any():
        eng.admit()
        eng.step()
    torch.cuda.synchronize()
    eng._next_token = sample
    return {c.rid: c.tokens for c in eng.completions}, seen, dict(kernels.LAUNCHES)


GRAPH_POLICIES = {
    "p8-serve": ("qwen2.5-14b", lambda: P8_SERVE),
    "mixed": ("qwen2.5-14b", lambda: get_precision_policy("attn-p16-mlp-p8", base=P8_SERVE)),
    "quire": ("phi3-mini-3.8b", lambda: parse_policy("weights=p16_1,kv=p16_1,dataflow=quire")),
    "moe": ("olmoe-1b-7b", lambda: P8_SERVE),
    "moe-mixed": ("granite-moe-3b-a800m",
                  lambda: get_precision_policy("attn-p16-mlp-p8", base=P8_SERVE)),
    # two local layers, rolling buffers of 16 rows: the longer requests wrap
    "gemma3": ("gemma3-4b", lambda: P8_SERVE),
}


@pytest.mark.parametrize("name", list(GRAPH_POLICIES))
def test_graph_engine_matches_its_eager_twin_bit_for_bit(dev, name):
    """The captured decode step replays the eager step's kernels: the same
    tokens, every sampled logit bit for bit, the same launch counts; the
    buffers the graph reads keep their addresses through a reset."""
    arch, make = GRAPH_POLICIES[name]
    cfg, pol = get_arch(arch).reduced(), make()
    model = build_model(cfg)
    params = model.init(0, pol)
    g = torch.Generator().manual_seed(0)
    prompts = [(torch.randint(0, cfg.vocab, (n,), generator=g).numpy().astype("int32"), m)
               for n, m in ((8, 6), (12, 5), (5, 7), (10, 4), (6, 6))]
    graph = ContinuousBatchingEngine(model, params, pol, max_slots=4, S_max=24)
    assert isinstance(graph._decode, CapturedStep)
    decode, ptrs = graph._decode, [t.data_ptr() for t in (graph.cache["lens"],
                                                          graph.cache["kv"]["k"],
                                                          graph.last_token)]
    want = _serve_recorded(EagerTwin(model, params, pol, max_slots=4, S_max=24), prompts)
    for _ in range(2):      # a fresh graph engine, then the same one after a reset
        got = _serve_recorded(graph, prompts)
        assert got[0] == want[0] and got[2] == want[2]
        assert len(got[1]) == len(want[1])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        graph.reset()
        assert graph._decode is decode
        assert [t.data_ptr() for t in (graph.cache["lens"], graph.cache["kv"]["k"],
                                       graph.last_token)] == ptrs


def test_graph_engine_apply_policy_recaptures(dev):
    """A legal swap (fused -> chained epilogue, the same p8 params) captures
    a new graph, which serves what a fresh engine under that policy serves;
    a KV-format change raises and keeps the old graph."""
    cfg = get_arch("qwen2.5-14b").reduced()
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    chained = dataclasses.replace(P8_SERVE, epilogue="chained")
    reqs = poisson_requests(3, arrival_rate=0.0, prompt_lens=(8,), max_new_tokens=5,
                            vocab=cfg.vocab)
    eng = ContinuousBatchingEngine(model, params, P8_SERVE, max_slots=2, S_max=20)
    old = eng._decode
    with pytest.raises(ValueError, match="KV-cache format"):
        eng.apply_policy(parse_policy("weights=p8_0,kv=p16_1,compute=bf16"))
    assert eng._decode is old
    eng.apply_policy(chained)
    assert isinstance(eng._decode, CapturedStep) and eng._decode is not old
    want = ContinuousBatchingEngine(model, params, chained, max_slots=2, S_max=20).run(reqs)
    got = eng.run(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in want]


def test_graph_engine_single_slot_matches_its_eager_twin(dev):
    """One slot: admission copies the whole B=1 prefill cache into the
    buffers the graph reads."""
    cfg = get_arch("qwen2.5-14b").reduced()
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    reqs = poisson_requests(3, arrival_rate=0.0, prompt_lens=(7, 11), max_new_tokens=6,
                            vocab=cfg.vocab)
    want = EagerTwin(model, params, P8_SERVE, max_slots=1, S_max=20).run(reqs)
    eng = ContinuousBatchingEngine(model, params, P8_SERVE, max_slots=1, S_max=20)
    assert isinstance(eng._decode, CapturedStep)
    assert [c.tokens for c in eng.run(reqs)] == [c.tokens for c in want]



@pytest.mark.parametrize("swap", [dict(epilogue="chained"), dict(compute_dtype="f32")],
                         ids=["chained", "f32-compute"])
def test_graph_engine_apply_policy_mid_flight_matches_its_eager_twin(dev, swap):
    """A swap over live rows: 4 requests admitted, 2 steps, ``apply_policy``
    (the new graph's warm-up writes into the live cache and puts back what
    the step advances), then run to the end; the tokens and every decode
    step's logits bit for bit those of an eager twin that makes the same
    swap at the same step."""
    cfg = get_arch("qwen2.5-14b").reduced()
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    new = dataclasses.replace(P8_SERVE, **swap)
    reqs = poisson_requests(4, arrival_rate=0.0, prompt_lens=(8, 13, 5, 11),
                            max_new_tokens=9, vocab=cfg.vocab, seed=3)
    eng = ContinuousBatchingEngine(model, params, P8_SERVE, max_slots=4, S_max=24)
    old = eng._decode
    got = served_recorded(eng, reqs, swap=new)
    want = served_recorded(EagerTwin(model, params, P8_SERVE, max_slots=4, S_max=24), reqs,
                           swap=new)
    assert isinstance(eng._decode, CapturedStep) and eng._decode is not old
    assert eng.policy is new and got[0] == want[0]
    assert len(got[1]) == eng.steps == 8
    assert_bit_identical(got[1], want[1], "graph against eager")


@pytest.mark.parametrize("kv_bits", [8, 16])
@pytest.mark.parametrize("bt", [1, 3, 16])
def test_paged_attention_kernel_matches_plain(dev, kv_bits, bt):
    """The paged mode over shuffled pools with sentinel tails and NaR-filled
    recycled pages: bit for bit the dense kernel on the de-paged cache,
    within 4 (d + 2S) u max|V| of the paged plain version, a length-0 row
    zeros; the paged append's codes bit for bit the encode kernel + the row
    write, its output the unfused paged call's."""
    d, Hq, Hkv = 64, 10, 2
    W = -(-700 // bt)
    S = W * bt
    lengths = (0, 1, 517, S)
    q, k, v, lens = attn_inputs(kv_bits, Hq=Hq, Hkv=Hkv, d=d, S=S, lengths=lengths,
                                seed=bt + kv_bits)
    kp, vp, table = page_cache(k, v, lengths, bt, seed=bt)
    got = attn_ops.decode_attention_paged(q, kp, vp, table, lens, 0, kv_bits=kv_bits)
    kd, vd = attn_ref.depage(kp, table), attn_ref.depage(vp, table)
    dense = attn_ops.decode_attention(q, kd, vd, lens, 0, kv_bits=kv_bits)
    assert torch.equal(got.view(torch.int32), dense.view(torch.int32))
    want = attn_ref.posit_decode_attention_paged_ref(q, kp, vp, table, lens, 0, kv_bits=kv_bits)
    vmax = float(codec_ref.decode_ref(live_codes(vd, lens), 0, nbits=kv_bits).abs().max())
    assert float((got - want).abs().max()) <= 4 * (d + 2 * S) * U * vmax
    assert bool((got[0] == 0).all())
    pos = torch.tensor([0, 1, 516, S], dtype=torch.int32, device=dev)
    kn, vn = (torch.randn((4, Hkv, d), device=dev) for _ in range(2))
    k_want, v_want = kp.clone(), vp.clone()
    for pool, new in ((k_want, kn), (v_want, vn)):
        attn_ref.store_row_paged(pool, codec_ops.encode(new, 0, nbits=kv_bits), table, pos, 0,
                                 kv_bits=0)
    out = attn_ops.decode_attention_append_paged(q, kn, vn, kp, vp, table, pos, lens, 0,
                                                 kv_bits=kv_bits)
    assert torch.equal(kp, k_want) and torch.equal(vp, v_want)
    again = attn_ops.decode_attention_paged(q, kp, vp, table, lens, 0, kv_bits=kv_bits)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def _paged_model(dev):
    """qwen2.5-14b at full width, two layers deep, P8_SERVE, seed 0."""
    cfg = dataclasses.replace(get_arch("qwen2.5-14b"), n_layers=2)
    model = build_model(cfg)
    return cfg, model, model.init(0, P8_SERVE)


def test_paged_engine_on_card_matches_grid_and_eager_twin(dev):
    """Prefix-sharing requests (8 of 64 tokens at 90% overlap, 4 slots):
    the paged engine (pages of 16) serves the slot grid's tokens and every
    sampled logits row bit for bit, replays its captured step bit for bit
    like its eager twin, and launches only the paged attention kernel."""
    cfg, model, params = _paged_model(dev)
    reqs = lambda: prefix_requests(8, 64, 0.9, 8, cfg.vocab)  # noqa: E731
    kw = dict(max_slots=4, S_max=72)
    runs = {}
    for name, make in (
            ("grid", lambda: ContinuousBatchingEngine(model, params, P8_SERVE, **kw)),
            ("paged", lambda: PagedContinuousBatchingEngine(model, params, P8_SERVE,
                                                            page_bytes=32768, **kw)),
            ("eager", lambda: eager_twin(PagedContinuousBatchingEngine)(
                model, params, P8_SERVE, page_bytes=32768, **kw))):
        eng = make()
        assert isinstance(eng._decode, CapturedStep) == (name != "eager")
        kernels.reset_launches()
        runs[name] = serve_recorded_timed(eng, reqs())
        runs[name]["launches"] = dict(kernels.LAUNCHES)
    for name in ("paged", "eager"):
        assert runs[name]["tokens"] == runs["grid"]["tokens"]
        assert_bit_identical(runs[name]["seen"], runs["grid"]["seen"], name)
        assert runs[name]["launches"]["posit_attention"] == 0
        assert runs[name]["prefix_cache"]["hits"] == 7
    assert runs["paged"]["launches"] == runs["eager"]["launches"]
    assert runs["paged"]["launches"]["posit_attention_paged"] == \
        runs["paged"]["decode_steps"] * cfg.n_layers


def test_paged_inject_nar_stays_in_its_slot_on_card(dev):
    """Two requests sharing a 2-page prefix; NaR injected into slot 0's
    tail: slot 0's logits go non-finite, slot 1 serves the tokens it serves
    without the fault, and the shared page keeps its codes."""
    cfg, model, params = _paged_model(dev)
    a, b = (r.prompt for r in prefix_requests(2, 40, 0.8, 6, cfg.vocab))
    eng = PagedContinuousBatchingEngine(model, params, P8_SERVE, max_slots=2, S_max=48,
                                        page_bytes=32768)
    runs = []
    for fault in (False, True):
        eng.reset()
        for i, p in enumerate((a, b)):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        eng.admit()
        shared = eng.manager.tables[0][0]
        assert eng.manager.tables[1][0] == shared
        kept = eng.cache["kv"]["k"][:, shared].clone()
        if fault:
            eng.inject_nar_into(0, 3)
        while eng.active.any():
            eng.step()
        torch.cuda.synchronize()
        assert torch.equal(eng.cache["kv"]["k"][:, shared], kept)
        runs.append(({c.rid: c.tokens for c in eng.completions}, eng.nonfinite_rows))
    (clean, bad0), (faulted, bad1) = runs
    assert bad0 == 0 and bad1 > 0
    assert faulted[1] == clean[1]


def test_float_linear_backward_on_card(dev):
    """The float linear's forward (the GEMM kernel) and backward (plain
    products) at 512 rows and phi3's shapes, f32 and bf16 compute, within
    chip_smoke.py's stated bounds of a float64 autograd."""
    from chip_smoke import check_linear_backward

    assert check_linear_backward(M=512)["worst_err_over_limit"] <= 1.0


def test_train_steps_on_card_match_cpu(dev):
    """Three train steps of reduced qwen2.5-14b and phi3-mini-3.8b under
    ``none`` and ``p16-train``, the card against the CPU from the card's
    state each step (chip_smoke.py's bounds)."""
    from chip_smoke import check_train_reduced

    res = check_train_reduced()
    assert res["worst"]["code_diff"] <= 1 and len(res["runs"]) == 4


# the large-M kernels (csrc/posit_gemm_large.cu): (B format, compute, packed)
LARGE_KINDS = [(P8_1, torch.bfloat16, False), (P8_2, torch.bfloat16, True),
               (P16_1, torch.bfloat16, False), (BF16, torch.bfloat16, False),
               (F32, torch.float32, False), (BF16, torch.float32, False),
               (P8_0, torch.float32, False), (P16_1, torch.float32, False),
               (P8_3, torch.float32, True)]


def _large_operands(dev, M, K, N, b_fmt, packed, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((M, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
    b = (w if b_fmt == F32 else w.to(torch.bfloat16) if b_fmt == BF16
         else codec_ops.encode(w, b_fmt.es, nbits=b_fmt.nbits))
    bvals = b.float() if b_fmt in (F32, BF16) else codec_ref.decode_ref(b, b_fmt.es,
                                                                         nbits=b_fmt.nbits)
    bias = torch.randn((N,), generator=g, device=dev)
    res = torch.randn((M, N), generator=g, device=dev)
    return a, pack_p8(b) if packed else b, bvals, bias, res


@pytest.mark.parametrize("act", ["none", "gelu", "silu", "relu"])
@pytest.mark.parametrize("M,K,N", [(65, 1032, 1008), (129, 528, 272), (4033, 1024, 1008)])
@pytest.mark.parametrize("b_fmt,cd,packed", LARGE_KINDS,
                         ids=lambda v: str(v).split(".")[-1] if not isinstance(v, bool) else
                         ("packed" if v else "unpacked"))
def test_large_m_gemm_matches_plain(dev, b_fmt, cd, packed, M, K, N, act):
    """Past LARGE_M rows every B kind under both computes goes to the large-M
    kernels (wgmma for the tensor-core pairs, the 128 x 128 FMA tile for the
    rest), counted under their own key, within the GEMM bound
    2*K*u*(|A|@|B| + |bias|) + 8*u*(|y| + |res|) of the plain version on the
    values the products see, at ragged M, N and K; two calls give the same
    bits."""
    from repro_torch.kernels.posit_gemm import ops as gemm_ops

    a, b, bvals, bias, res = _large_operands(dev, M, K, N, b_fmt, packed, M + K + N)
    es = (0, getattr(b_fmt, "es", 0), 0)
    kw = dict(a_fmt=F32, b_fmt=b_fmt, out_fmt=F32, bias=bias, residual=res, activation=act,
              compute_dtype=cd, b_packed=packed)
    tc = cd == torch.bfloat16 and b_fmt != F32
    key = "posit_gemm_large_tc" if tc else "posit_gemm_large_fma"
    assert M > gemm_ops.LARGE_M
    before = kernels.LAUNCHES[key]
    got = posit_gemm(a, b, es, **kw)
    assert kernels.LAUNCHES[key] == before + 1
    want = posit_gemm_ref(a, b, es, **kw)
    if cd == torch.bfloat16:
        bvals = bvals.to(torch.bfloat16).float()
    tol = 2 * K * U * (a.to(cd).float().abs() @ bvals.abs() + bias.abs()) \
        + 8 * U * (want.abs() + res.abs())
    assert ((got - want).abs() <= tol).all()
    again = posit_gemm(a, b, es, **kw)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("cd,b_fmt", [(torch.bfloat16, P8_0), (torch.float32, P16_1)])
def test_large_m_gemm_posit_out_within_one_ulp(dev, cd, b_fmt):
    """p8 activations and p8 output past LARGE_M (wgmma), p16 out under f32
    compute (the FMA tile): within one posit ulp of the plain version."""
    M, K, N = 257, 1024, 1008
    a, b, _, bias, res = _large_operands(dev, M, K, N, b_fmt, False, 5)
    out = P8_2 if cd == torch.bfloat16 else P16_1
    a_fmt = P8_0 if cd == torch.bfloat16 else F32
    if a_fmt == P8_0:
        a = codec_ops.encode(a, 0, nbits=8)
    kw = dict(a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=out, bias=bias, residual=res,
              activation="silu", compute_dtype=cd)
    es = (0, b_fmt.es, out.es)
    got = posit_gemm(a, b, es, **kw).to(torch.int32)
    want = posit_gemm_ref(a, b, es, **kw).to(torch.int32)
    n = out.nbits
    d = (got - want) & ((1 << n) - 1)
    assert int(torch.minimum(d, (1 << n) - d).max()) <= 1


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_float_linear_checkpoint_same_gradients(dev, cd):
    """``FloatLinear`` on the large-M kernels under ``torch.utils.checkpoint``
    (the train step's remat, which runs the forward twice) gives the same
    output and gradients, bit for bit, as without it."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.posit_gemm.ops import float_linear

    M, K, N = 1024, 512, 768
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((M, K), generator=g, device=dev)
    w = (torch.randn((K, N), generator=g, device=dev) * K ** -0.5).to(cd)
    bias, r, dy = (torch.randn(s, generator=g, device=dev) for s in ((N,), (M, N), (M, N)))

    def run(remat):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias, r)]
        fn = lambda *t: float_linear(t[0], t[1], compute_dtype=cd, bias=t[2],  # noqa: E731
                                     residual=t[3], activation="silu")
        y = checkpoint(fn, *leaves, use_reentrant=False) if remat else fn(*leaves)
        y.backward(dy)
        return [y.detach()] + [t.grad for t in leaves]

    for got, want in zip(run(True), run(False)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("M,K,N,packed", [(65, 1028, 1008, True), (130, 1024, 1000, False)])
def test_large_m_refused_shapes_take_the_64_row_tiles(dev, M, K, N, packed):
    """Past LARGE_M rows a shape the large-M kernels refuse (K not a multiple
    of 8, N not a multiple of 16) runs on the parent's
    tensor-core kernel, counted under its key, within the GEMM bound of the
    plain version."""
    a, b, bvals, bias, res = _large_operands(dev, M, K, N, P8_2, packed, M + K)
    kw = dict(a_fmt=F32, b_fmt=P8_2, out_fmt=F32, bias=bias, residual=res,
              activation="gelu", compute_dtype=torch.bfloat16, b_packed=packed)
    key = "posit_gemm_packed" if packed else "posit_gemm"
    before = dict(kernels.LAUNCHES)
    got = posit_gemm(a, b, (0, 2, 0), **kw)
    assert kernels.LAUNCHES[key] == before[key] + 1
    assert kernels.LAUNCHES["posit_gemm_large_tc"] == before["posit_gemm_large_tc"]
    want = posit_gemm_ref(a, b, (0, 2, 0), **kw)
    tol = 2 * K * U * (a.to(torch.bfloat16).float().abs() @ bvals.abs() + bias.abs()) \
        + 8 * U * (want.abs() + res.abs())
    assert ((got - want).abs() <= tol).all()


# the mid-M kernel's B kinds: (weight format, packed lanes)
MID_KINDS = [(P8_0, False), (P8_2, True), (P16_1, False), (BF16, False)]
MID_IDS = ["p8", "packed", "p16", "bf16"]


def _mid_operands(dev, M, K, N, b_fmt, packed, a_fmt, seed):
    """Operands as the layers pass them, B packed if asked, and the values
    the products see (A and B rounded to bf16)."""
    a, b, bias, res = _gemm_operands(dev, M, K, N, b_fmt, seed)
    bvals = b.float() if b_fmt == BF16 else codec_ref.decode_ref(b, b_fmt.es, nbits=b_fmt.nbits)
    if a_fmt == BF16:
        a = a.to(torch.bfloat16)
    elif a_fmt == P8_0:
        a = codec_ops.encode(a, 0, nbits=8)
    avals = codec_ref.decode_ref(a, 0, nbits=8) if a_fmt == P8_0 else a.float()
    return (a, pack_p8(b) if packed else b, bias, res, avals.to(torch.bfloat16).float(),
            bvals.to(torch.bfloat16).float())


@pytest.mark.parametrize("M", [9, 16, 33, 64])
@pytest.mark.parametrize("a_fmt", [F32, BF16, P8_0], ids=["f32", "bf16", "p8"])
@pytest.mark.parametrize("b_fmt,packed", MID_KINDS, ids=MID_IDS)
def test_mid_m_gemm_matches_plain(dev, b_fmt, packed, a_fmt, M):
    """9-64 rows under bf16 compute, every B kind and A kind, run on the mid-M
    kernel (csrc/posit_gemm_mid.cu, its own launch key) within the GEMM
    bound 2*K*u*(|A|@|B| + |bias|) + 8*u*(|y| + |res|) of the plain version
    on the values the products see, at a K off the 64-row step; two calls
    give the same bits."""
    K, N = 1000, 528
    a, b, bias, res, avals, bvals = _mid_operands(dev, M, K, N, b_fmt, packed, a_fmt, M + 7)
    es = (0, getattr(b_fmt, "es", 0), 0)
    kw = dict(a_fmt=a_fmt, b_fmt=b_fmt, out_fmt=F32, bias=bias, residual=res,
              activation="silu", compute_dtype=torch.bfloat16, b_packed=packed)
    before = dict(kernels.LAUNCHES)
    got = posit_gemm(a, b, es, **kw)
    assert kernels.LAUNCHES["posit_gemm_mid_tc"] == before["posit_gemm_mid_tc"] + 1
    assert all(kernels.LAUNCHES[k] == before[k] for k in before if k != "posit_gemm_mid_tc")
    want = posit_gemm_ref(a, b, es, **kw)
    tol = 2 * K * U * (avals.abs() @ bvals.abs() + bias.abs()) + 8 * U * (want.abs() + res.abs())
    assert ((got - want).abs() <= tol).all()
    again = posit_gemm(a, b, es, **kw)
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("K,N", [(5120, 5120), (1000, 528)])
@pytest.mark.parametrize("b_fmt,packed", MID_KINDS, ids=MID_IDS)
def test_mid_m_rows_do_not_depend_on_the_batch(dev, b_fmt, packed, K, N):
    """The mid-M plan depends on N, K and the B kind only, and each output
    sums the same k16 products in the same order whatever the wgmma's width
    (16, 32 or 64 rows): rows 0-8 of an M = 16 call are those of M = 9 and M
    = 64 calls bit for bit, epilogue included."""
    a, b, bias, res, _, _ = _mid_operands(dev, 64, K, N, b_fmt, packed, F32, 11)
    es = (0, getattr(b_fmt, "es", 0), 0)
    kw = dict(a_fmt=F32, b_fmt=b_fmt, out_fmt=F32, bias=bias, activation="gelu",
              compute_dtype=torch.bfloat16, b_packed=packed)
    rows = {m: posit_gemm(a[:m].contiguous(), b, es, residual=res[:m].contiguous(),
                          **kw).view(torch.int32) for m in (9, 16, 64)}
    assert torch.equal(rows[16][:9], rows[9]) and torch.equal(rows[16][:9], rows[64][:9])
    assert torch.equal(rows[16], rows[64][:16])


def test_mid_m_gemm_captured_in_a_cuda_graph(dev):
    """One mid-M GEMM captured in a CUDA graph (as the decode step is) gives
    its eager launch's bits, on the captured inputs and again after new
    activations are written into the captured buffer."""
    M, K, N = 16, 5120, 5120
    a, b, bias, res, _, _ = _mid_operands(dev, M, K, N, P8_0, False, F32, 12)
    kw = dict(a_fmt=F32, b_fmt=P8_0, out_fmt=F32, bias=bias, residual=res,
              activation="silu", compute_dtype=torch.bfloat16)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):   # warm up on the capturing stream (its counters)
        eager = posit_gemm(a, b, (0, 0, 0), **kw)
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=s):
        out = posit_gemm(a, b, (0, 0, 0), **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), eager.view(torch.int32))
    a.copy_(torch.randn((M, K), generator=torch.Generator(device=dev).manual_seed(13),
                        device=dev))
    want = posit_gemm(a, b, (0, 0, 0), **kw)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# ------------------------------------ the ISA entry points and the moe family ----

def _same(got, want):
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        return torch.equal(got.view(torch.int32), want.view(torch.int32))
    return got.dtype == want.dtype and torch.equal(got.to(torch.int64), want.to(torch.int64))


@pytest.mark.parametrize("nbits", [8, 16])
def test_alu_and_quire_ops_on_card_match_cpu(dev, nbits):
    """posit_add / sub / mul (every p8 pair, or 2^18 sampled p16 pairs) at es
    0-3 and a chain of qma / qms / qneg / qround: the card's bits the CPU's."""
    from repro_torch.core import alu

    dt = torch.uint8 if nbits == 8 else torch.uint16
    g = torch.Generator().manual_seed(nbits)
    if nbits == 8:
        a = torch.arange(256, dtype=torch.int32).repeat_interleave(256).to(dt)
        b = torch.arange(256, dtype=torch.int32).repeat(256).to(dt)
    else:
        a, b = (torch.randint(0, 1 << 16, (1 << 18,), generator=g).to(torch.int32).to(dt)
                for _ in range(2))
    for es in range(4):
        for op in ("posit_add", "posit_sub", "posit_mul"):
            fn = getattr(alu, op)
            assert _same(fn(a.to(dev), b.to(dev), nbits, es), fn(a, b, nbits, es)), (op, es)
    qa, qb = (torch.randint(0, 1 << nbits, (16, 512), generator=g).to(torch.int32).to(dt)
              for _ in range(2))
    qc, qg = alu.qclr((512,), nbits, device="cpu"), alu.qclr((512,), nbits, device=dev)
    for t in range(16):
        op = alu.qma if t % 3 else alu.qms
        qc, qg = op(qc, qa[t], qb[t], nbits, t % 4), op(qg, qa[t].to(dev), qb[t].to(dev),
                                                          nbits, t % 4)
        if t == 9:
            qc, qg = alu.qneg(qc, nbits), alu.qneg(qg, nbits)
    assert _same(qg, qc)
    for es in range(4):
        assert _same(alu.qround(qg, nbits, es), alu.qround(qc, nbits, es))


def test_fcvt_on_card_matches_cpu(dev):
    """The eight fcvt ops on every p8 and p16 code (and a float sweep) on the
    codec kernels: the card's bits the CPU's plain version's."""
    from repro_torch.core import convert

    before = dict(kernels.LAUNCHES)
    for name, n in (("fcvt_s_p8", 8), ("fcvt_s_p16", 16), ("fcvt_p8_p8", 8),
                    ("fcvt_p8_p16", 16), ("fcvt_p16_p8", 8), ("fcvt_p16_p16", 16)):
        codes = torch.arange(1 << n, dtype=torch.int32).to(torch.uint8 if n == 8
                                                            else torch.uint16)
        fn = getattr(convert, name)
        for es in range(4):
            args = (es,) if name.startswith("fcvt_s_") else (es, 3 - es)
            assert _same(fn(codes.to(dev), *args), fn(codes, *args)), (name, args)
    x = torch.cat([torch.randn(4096) * s for s in (1e-30, 1e-3, 1.0, 1e3, 1e30)]
                  + [torch.tensor([0.0, -0.0, float("inf"), float("nan")])])
    for name in ("fcvt_p8_s", "fcvt_p16_s"):
        for es in range(4):
            assert _same(getattr(convert, name)(x.to(dev), es), getattr(convert, name)(x, es))
    assert kernels.LAUNCHES["posit_decode"] > before["posit_decode"]
    assert kernels.LAUNCHES["posit_encode"] > before["posit_encode"]


@pytest.mark.parametrize("n", [4, 20, 256])
@pytest.mark.parametrize("fmt", [P8_0, P16_1, F32], ids=["p8", "p16", "f32"])
def test_posit_dot_dataflows_on_card(dev, fmt, n):
    """Table IV's GEMM and the GEMV, fused and unfused, on the card: an f32
    rd within the GEMM bound of the CPU's plain version, rd the operands'
    format each code the rounding of a value within that bound; fused
    launches no codec kernel, unfused two decodes."""
    from chip_smoke import U, gemm_bound_check, operand_values, posit_in_bound
    from repro_torch.core.dot import format_pair_plan, posit_dot, posit_gemv

    g = torch.Generator(device=dev).manual_seed(n)
    a, b = (torch.randn((n, n), generator=g, device=dev) for _ in range(2))
    posit = fmt != F32
    if posit:
        a, b = (codec_ops.encode(t, fmt.es, nbits=fmt.nbits) for t in (a, b))
    cd = format_pair_plan(fmt, fmt).compute_dtype
    av, bv = operand_values(a.cpu(), fmt), operand_values(b.cpu(), fmt)
    for impl in ("fused", "unfused") if posit else ("fused",):
        f32 = OperandSlots(rs1=fmt, rs2=fmt, rd=F32)
        kernels.reset_launches()
        got = posit_dot(a, b, f32, impl=impl).cpu()
        assert kernels.LAUNCHES["posit_decode"] == (2 if impl == "unfused" else 0)
        want = posit_dot(a.cpu(), b.cpu(), f32, impl=impl)
        gemm_bound_check(impl, got, want, av, lambda sl: bv[:, sl], cd, n)
        if posit:
            tol = 2 * n * U * torch.matmul(av.to(cd).float().abs(), bv.abs()) \
                + 8 * U * want.abs()
            posit_in_bound(impl, posit_dot(a, b, OperandSlots(rs1=fmt, rs2=fmt, rd=fmt),
                                           impl=impl), want, tol, fmt)
        x = b[:, :1].contiguous()
        gemm_bound_check(impl, posit_gemv(a, x[:, 0], f32, impl=impl).cpu()[:, None],
                         posit_gemv(a.cpu(), x[:, 0].cpu(), f32, impl=impl)[:, None], av,
                         lambda sl: bv[:, :1][:, sl], cd, n)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_reduced_on_card_matches_cpu(dev, arch):
    """A reduced moe model, P8_SERVE, prefill + 3 decode steps: the card's
    logits within 0.05 of the CPU's plain versions (bf16 activations and p8
    K/V: one flipped rounding moves a logit ~1e-2)."""
    cfg = get_arch(arch).reduced()
    cpu, gpu = build_model(cfg, device="cpu"), build_model(cfg)
    params = cpu.init(0, P8_SERVE)
    params_gpu = _tree_to(params, dev)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    lc, cc = cpu.prefill(params, toks, P8_SERVE, S_max=24)
    lg, cg = gpu.prefill(params_gpu, toks.to(dev), P8_SERVE, S_max=24)
    for _ in range(4):
        assert torch.isfinite(lg).all()
        assert float((lg.cpu() - lc).abs().max()) <= 0.05
        tok = lc.argmax(-1).to(torch.int32)
        lc, cc = cpu.decode_step(params, tok, cc, P8_SERVE)
        lg, cg = gpu.decode_step(params_gpu, tok.to(dev), cg, P8_SERVE)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def test_moe_paged_engine_on_card_matches_grid(dev):
    """Reduced olmoe, P8_SERVE, 6 requests at 4 slots: the paged engine's
    captured step serves the slot grid's tokens and every sampled logits row
    bit for bit."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    reqs = lambda: poisson_requests(6, arrival_rate=0.0, prompt_lens=(10, 17),  # noqa: E731
                                    max_new_tokens=6, vocab=cfg.vocab)
    runs = {}
    for name, cls, kw in (("grid", ContinuousBatchingEngine, {}),
                          ("paged", PagedContinuousBatchingEngine, {"page_bytes": 256})):
        eng = cls(model, params, P8_SERVE, max_slots=4, S_max=32, **kw)
        assert isinstance(eng._decode, CapturedStep)
        runs[name] = serve_recorded_timed(eng, reqs())
    assert runs["paged"]["tokens"] == runs["grid"]["tokens"]
    assert_bit_identical(runs["paged"]["seen"], runs["grid"]["seen"], "moe paged")



def test_whisper_reduced_on_card_matches_cpu(dev):
    """The reduced whisper-medium, P8_SERVE: the encoder, the cross K/V and
    8 teacher-forced + 4 greedy decode steps on the card within 0.05 of the
    CPU's plain versions (chip_smoke.py's ``check_small_whisper``)."""
    row = check_small_whisper()
    assert row["max_logit_err"] <= row["bound"] and row["init_cache_launches"]


def _static_runs(model, params, prompts, gen, frames=None) -> dict:
    """``generate_static`` twice on one set of params: the decode step
    captured (``bind_step``, as served) and run eagerly; each run's result,
    every decode step's logits and the bound step."""
    from repro_torch.launch.serve import generate_static

    runs = {}
    for name in ("graph", "eager"):
        seen, steps = [], {}
        with recorded_binds(seen, steps, eager=name == "eager"):
            run = generate_static(model, params, P8_SERVE, prompts, gen, frames=frames)
        assert (name == "graph") == isinstance(steps["step"], CapturedStep)
        runs[name] = (run, seen)
    return runs


def test_whisper_static_graph_matches_eager_on_card(dev):
    """Static mode on the reduced whisper: the decode step captured
    (``bind_step``) against the same step run eagerly, from the same
    frames and prompts: every step's logits, the tokens and both caches bit
    for bit."""
    cfg = get_arch("whisper-medium").reduced()
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    gen = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, cfg.vocab, (3, 6), generator=gen)
    frames = torch.randn((3, cfg.enc_frames, cfg.d_model), generator=gen)
    runs = _static_runs(model, params, prompts, 5, frames)
    (g, g_seen), (e, e_seen) = runs["graph"], runs["eager"]
    assert_bit_identical(g_seen, e_seen, "whisper static")
    assert torch.equal(g["tokens"], e["tokens"])
    for c in ("self", "cross"):
        for kv in ("k", "v", "len"):
            assert torch.equal(g["cache"][c][kv], e["cache"][c][kv]), (c, kv)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "olmoe-1b-7b", "gemma3-4b"])
def test_prefilled_static_graph_matches_eager_on_card(dev, arch):
    """Static mode on a family with a prefill (the reduced qwen2.5-14b,
    olmoe-1b-7b and gemma3-4b, P8_SERVE): the batch prefilled, then the decode step
    captured over the cache the prefill built, against the same step run
    eagerly: every step's logits, the tokens and the K/V cache bit for bit.
    qwen's tokens are also the continuous engine's on the same prompts, all
    at t = 0 (B = 1 prefills, the same slots)."""
    import numpy as np

    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, P8_SERVE)
    B, L, G = 3, 10, 6
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, L))
    runs = _static_runs(model, params, prompts, G)
    (g, g_seen), (e, e_seen) = runs["graph"], runs["eager"]
    assert len(g_seen) == G - 1
    assert_bit_identical(g_seen, e_seen, f"{arch} static")
    assert torch.equal(g["tokens"], e["tokens"])
    for name in ("kv", "kv_local"):
        for kv in ("k", "v", "len") if name in g["cache"] else ():
            assert torch.equal(g["cache"][name][kv], e["cache"][name][kv]), (name, kv)
    if arch == "qwen2.5-14b":
        eng = ContinuousBatchingEngine(model, params, P8_SERVE, max_slots=B, S_max=L + G)
        done = eng.run([Request(rid=i, prompt=prompts[i].astype(np.int32), max_new_tokens=G)
                        for i in range(B)])
        for c in done:
            assert c.tokens == g["tokens"][c.rid].tolist(), c.rid


def _observer_inputs(dev) -> list:
    """Zeros, subnormals, +-inf, NaN, powers of two and their neighbours at
    every binade edge in range and past it, and a wide log-uniform draw."""
    g = torch.Generator(device=dev).manual_seed(0)
    p = torch.exp2(torch.arange(-100, 70, dtype=torch.float32, device=dev))
    edges = torch.cat([p, torch.nextafter(p, torch.zeros_like(p)), -p])
    special = torch.tensor([0.0, -0.0, 1e-45, -2e-40, float("inf"), float("-inf"), float("nan"),
                            3e38], device=dev)
    n = 5 * ((1 << 20) + 1)
    wide = torch.randn(n, generator=g, device=dev) * torch.exp2(
        torch.randint(-40, 40, (n,), generator=g, device=dev).float())
    return [edges, special, wide.reshape(-1, 5)]


def _stats(arrays, device):
    obs = observe.Observer()
    with observe.observing(obs):
        for a in arrays:
            observe.record("s", "act", a.to(device))
    return obs.get("s", "act")


def test_observer_on_card_matches_cpu_without_a_host_sync(dev):
    arrays = _observer_inputs(dev)
    want = _stats(arrays, "cpu")
    torch.cuda.synchronize()
    obs = observe.Observer()
    torch.cuda.set_sync_debug_mode("error")      # a host sync in a record raises
    try:
        with observe.observing(obs):
            for a in arrays:
                observe.record("s", "act", a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = obs.get("s", "act")
    for f in ("n", "zeros", "nonfinite", "abs_max", "size", "shape"):
        assert getattr(got, f) == getattr(want, f), f
    assert (got.hist == want.hist).all()
    # 3e38 squared overflows f32: both sums are inf
    assert got.sum_sq == want.sum_sq == float("inf")
    finite = _stats(arrays[2:], "cpu"), _stats(arrays[2:], dev)
    assert abs(finite[1].sum_sq - finite[0].sum_sq) <= 1e-6 * finite[0].sum_sq


def test_observer_records_inside_a_cuda_graph(dev):
    """After one eager record (its accumulators made), a record captured in
    a CUDA graph adds to them at every replay."""
    x = _observer_inputs(dev)[2]
    obs = observe.Observer()
    with observe.observing(obs):
        observe.record("s", "weight", x)
        once = obs.get("s", "weight")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            observe.record("s", "weight", x)
        graph.replay()
        graph.replay()
    torch.cuda.synchronize()
    got = obs.get("s", "weight")
    assert got.n == 3 * once.n and (got.hist == 3 * once.hist).all()
    assert got.abs_max == once.abs_max


def test_moe_loss_on_card_matches_cpu(dev):
    res = check_small_moe_loss()
    assert res["hidden_err"] <= res["hidden_bound"]
