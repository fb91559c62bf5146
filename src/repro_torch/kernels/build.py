"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each source builds into its own shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). A library is named by a hash
of its sources and flags and is reused while they are unchanged. The build
directory is ``build/kernels`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("posit_codec", "posit_gemm", "posit_gemm_large", "posit_gemm_mid", "posit_attention",
           "posit_quire_gemm", "posit_softmax")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``name`` lives for the current sources (its own and
    every shared header) and flags."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build(names=SOURCES) -> dict[str, float]:
    """Build every library of ``names`` that is missing, all nvcc processes at
    once. Returns the wall seconds until each finished (0.0 when reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names if not library_path(n).exists()}
    seconds = {n: 0.0 for n in names}
    failures = []
    for n, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{n}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``name`` (built first if missing), with
    ``argtypes`` set from ``signatures`` and an int ``restype`` for each."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
