"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each ``kernels/<name>/ops.py`` wrapper takes a CPU tensor to the plain torch
version in ``ref.py`` and a CUDA tensor to the CUDA kernel in ``csrc/``, and
nothing else: there is no fallback. ``LAUNCHES`` counts the kernel launches of
each wrapper (plain integers, added to where a wrapper calls its kernel). A
CUDA graph replays its kernels without running the wrappers, so
``CapturedLaunches`` adds a captured graph's counts once per replay.
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
    "posit_gemm_large_tc": 0,
    "posit_gemm_large_fma": 0,
    "posit_gemm_mid_tc": 0,
    "posit_attention": 0,
    "posit_attention_paged": 0,
    "posit_quire_gemm": 0,
    "posit_softmax": 0,
}


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class CapturedLaunches:
    """The launches a CUDA graph holds, counted once per replay.

    Used as a context manager around the capture: on exit it keeps what the
    wrappers added inside (``counts``) and takes it back out of ``LAUNCHES``,
    since a capture runs no kernel. ``replayed()`` adds ``counts`` once, as
    the wrappers would have for an eager run of the same calls."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def __enter__(self) -> "CapturedLaunches":
        self._before = dict(LAUNCHES)
        return self

    def __exit__(self, *exc) -> None:
        self.counts = {k: LAUNCHES[k] - n for k, n in self._before.items()}
        LAUNCHES.update(self._before)

    def replayed(self) -> None:
        for k, n in self.counts.items():
            LAUNCHES[k] += n


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
    on different streams get different buffers.

    A captured CUDA graph keeps the buffer's address, so it must not be
    allocated or grown during a capture (the allocation would come from the
    graph's pool, and a later growth would release the block the graph
    reads): warm up on the capturing stream first."""
    key = (device.index or 0, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"kernel counters of stream {stream:#x} allocated or grown during a CUDA "
                "graph capture: run the captured function once on that stream first")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf
