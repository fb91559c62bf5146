"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``cuda`` and
skips without one. It imports no JAX, so it runs on a machine that has only
PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_arch
from repro_torch.core.pcsr import P8_SERVE
from repro_torch.core.types import BF16, F32, P8_0, P16_1
from repro_torch.kernels.posit_attention import ops as attn_ops
from repro_torch.kernels.posit_attention.ref import posit_decode_attention_ref
from repro_torch.kernels.posit_codec import ops as codec_ops
from repro_torch.kernels.posit_codec import ref as codec_ref
from repro_torch.kernels.posit_gemm.ops import posit_gemm
from repro_torch.kernels.posit_gemm.ref import posit_gemm_ref
from repro_torch.launch.engine import ContinuousBatchingEngine, poisson_requests
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


def test_attention_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((4, 10, 64), generator=g, device=dev)
    k = codec_ops.encode(torch.randn((4, 2, 100, 64), generator=g, device=dev), 0, nbits=8)
    v = codec_ops.encode(torch.randn((4, 2, 100, 64), generator=g, device=dev), 0, nbits=8)
    lens = torch.tensor([0, 1, 33, 100], dtype=torch.int32, device=dev)
    got = attn_ops.decode_attention(q, k, v, lens, 0, kv_bits=8)
    want = posit_decode_attention_ref(q, k, v, lens, 0, kv_bits=8)
    vmax = float(codec_ref.decode_ref(v, 0, nbits=8).abs().max())
    assert float((got - want).abs().max()) <= 8 * (64 + 200) * U * vmax
    assert bool((got[0] == 0).all())


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
