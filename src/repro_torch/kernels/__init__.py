"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each ``kernels/<name>/ops.py`` wrapper takes a CPU tensor to the plain torch
version in ``ref.py`` and a CUDA tensor to the CUDA kernel in ``csrc/``, and
nothing else: there is no fallback. ``LAUNCHES`` counts the kernel launches of
each wrapper (plain integers, added to where a wrapper calls its kernel).
"""
from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {
    "posit_decode": 0,
    "posit_encode": 0,
    "posit_gemm": 0,
    "posit_gemm_packed": 0,
    "posit_gemm_packed_fma": 0,
    "posit_gemm_p16": 0,
    "posit_attention": 0,
    "posit_quire_gemm": 0,
    "posit_softmax": 0,
}


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain-version route).

    A CUDA tensor means the kernel; tensors on mixed or other devices raise.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"kernel operands must all be on one CUDA device or all on "
                     f"the CPU, got {sorted(str(t.device) for t in tensors)}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_rc(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def zeroed_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters, zero, for a kernel whose last block of a
    group sums the group's parts (the GEMM's split tiles, attention's splits).
    One buffer per (device, stream), zeroed once and grown on demand; every
    kernel leaves its counters zero again. Kernels on one stream run one after
    another, so they never share a counter while both run; kernels in flight
    on different streams get different buffers."""
    key = (device.index or 0, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf
