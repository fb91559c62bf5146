"""Import hygiene and device defaults of the port.

* No module of ``src/repro_torch`` (nor ``chip_smoke.py``) imports jax or
  anything of the reference package ``repro``.
* The entry points default to ``device="cuda"``; without CUDA such a call
  raises instead of running on the CPU.
* ``chip_smoke.py`` refuses to run without CUDA and prints no result.
"""
import ast
import inspect
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.calib.errmodel import measured_sq_rel_err
from repro_torch.calib.search import calibration_batches
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core.device import resolve_device
from repro_torch.core.pack import pack_p8
from repro_torch.core.types import F32, P8_0
from repro_torch.kernels.posit_attention import ops as attn_ops
from repro_torch.kernels.posit_codec import ops as codec_ops
from repro_torch.kernels.posit_gemm.ops import posit_gemm
from repro_torch.kernels.posit_quire_gemm.ops import posit_quire_gemm
from repro_torch.kernels.posit_softmax import ops as softmax_ops
from repro_torch.launch import serve as serve_mod
from repro_torch.core.pcsr import P8_SERVE
from repro_torch.models import transformer
from repro_torch.models.registry import build_model

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_timings.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"codec.py", "quire.py", "ops.py", "engine.py", "serve.py", "chip_smoke.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"lut.py", "pack.py", "policy.py"} <= names
    assert {"src/repro_torch/core/paged_kv.py", "src/repro_torch/launch/paged_engine.py"} <= rel
    assert {f"src/repro_torch/calib/{m}.py" for m in ("__init__", "observe", "errmodel",
                                                      "search")} <= rel
    for kernel in ("posit_quire_gemm", "posit_softmax"):
        for mod in ("__init__.py", "ops.py", "ref.py"):
            assert f"src/repro_torch/kernels/{kernel}/{mod}" in rel


def test_entry_points_default_to_cuda():
    for fn in (build_model, serve_mod.serve, params_from_jax, resolve_device,
               calibration_batches, measured_sq_rel_err):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_cuda_default_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    cfg = get_arch("qwen2.5-14b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve("qwen2.5-14b", reduced=True, requests=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"blocks": {}}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        calibration_batches(cfg, np.random.default_rng(0), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        measured_sq_rel_err(8, 0, 0, n_samples=16)


@pytest.mark.parametrize("fn", ["init_lm", "init_cache"])
def test_model_inits_default_to_cuda(fn):
    """transformer.init_lm / init_cache without ``device`` go to the CUDA
    device through resolve_device: without CUDA they raise its error instead
    of quietly running on the CPU."""
    f = getattr(transformer, fn)
    assert inspect.signature(f).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    cfg = get_arch("qwen2.5-14b").reduced()
    args = (torch.Generator(), cfg) if fn == "init_lm" else (cfg, 2, 8, P8_SERVE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        f(*args)


def test_cpu_tensors_take_the_plain_version():
    before = dict(kernels.LAUNCHES)
    codes = codec_ops.encode(torch.randn(64), 0, nbits=8)
    codec_ops.decode(codes, 0, nbits=8)
    w = codes.reshape(8, 8).contiguous()
    posit_quire_gemm(w, w, (0, 0, 0), a_fmt=P8_0, b_fmt=P8_0, out_fmt=P8_0)
    softmax_ops.softmax(w, 0, nbits=8)
    for cd in (torch.bfloat16, torch.float32):   # both packed variants' routes
        posit_gemm(w.float(), pack_p8(w), (0, 0, 0), a_fmt=F32, b_fmt=P8_0, out_fmt=F32,
                   compute_dtype=cd, b_packed=True)
        # past LARGE_M rows, where a CUDA tensor takes the large-M kernels,
        # and at 9-64 rows, where it takes the mid-M kernel
        for m in (130, 16):
            posit_gemm(torch.randn(m, 8), w, (0, 0, 0), a_fmt=F32, b_fmt=P8_0, out_fmt=F32,
                       compute_dtype=cd)
    pool = codes.reshape(4, 1, 1, 16).contiguous()            # (N, Hkv, bt, d)
    table = torch.tensor([[0, 2], [4, 1]], dtype=torch.int32)
    q, lens = torch.randn(2, 2, 16), torch.tensor([1, 2], dtype=torch.int32)
    attn_ops.decode_attention_paged(q, pool, pool, table, lens, 0, kv_bits=8)
    attn_ops.decode_attention_append_paged(q, torch.randn(2, 1, 16), torch.randn(2, 1, 16),
                                           pool.clone(), pool.clone(), table, lens, lens + 1, 0,
                                           kv_bits=8)
    assert kernels.LAUNCHES == before
    assert set(kernels.LAUNCHES) == {"posit_decode", "posit_encode", "posit_gemm",
                                     "posit_gemm_packed", "posit_gemm_packed_fma",
                                     "posit_gemm_p16", "posit_gemm_large_tc",
                                     "posit_gemm_large_fma", "posit_gemm_mid_tc",
                                     "posit_attention",
                                     "posit_attention_paged", "posit_quire_gemm",
                                     "posit_softmax"}


def test_gemma3_entry_points_default_to_cuda():
    """gemma3-4b's model, cache and both serving modes go to the CUDA device
    unless told otherwise; without CUDA they raise."""
    assert inspect.signature(serve_mod.serve_static).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    cfg = get_arch("gemma3-4b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_cache(cfg, 2, 8, P8_SERVE)
    for fn in (serve_mod.serve, serve_mod.serve_static):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn("gemma3-4b", reduced=True, prompt_len=20, gen=2)


def test_paged_entry_points_default_to_cuda():
    """The paged cache and the paged serve default to the CUDA device; without
    CUDA they raise instead of running on the CPU."""
    assert inspect.signature(transformer.init_paged_cache).parameters["device"].default == "cuda"
    assert inspect.signature(serve_mod.serve).parameters["paged"].default is False
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    cfg = get_arch("qwen2.5-14b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_paged_cache(cfg, 2, 8, 16, 4, P8_SERVE)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.serve("qwen2.5-14b", reduced=True, requests=1, prompt_len=4, gen=2,
                        paged=True)


def test_wrappers_refuse_mixed_devices():
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError):
        codec_ops.decode(meta.to(torch.uint8), 0, nbits=8)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        for line in proc.stdout.splitlines():
            with pytest.raises(json.JSONDecodeError):
                json.loads(line)
