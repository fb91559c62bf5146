"""Calibration observers: streaming per-tensor statistics from a forward pass.

A calibration pass runs the model's ordinary forward code under
``observing(Observer())``; every linear call site (``models.layers
.apply_linear`` / ``effective_weight``, and the moe layer's expert
products, keyed by the same layer-path strings ``resolve_policy`` sees)
then streams reduced statistics of its weight and activation tensors to
the observer: ``abs_max``, a log2-magnitude histogram (the count of values
with ``floor(log2|x|) == s`` per binade ``s``, the quantity posit tapered
accuracy is parameterized by; ``calib.errmodel`` maps it to an expected
round-trip error per ``(nbits, es)`` candidate), ``sum_sq`` and the exact
zeros. The statistics, the binade range and the artifact's histogram form
are the reference package's (``calib/observe.py``).

On the device: each ``(path, kind)`` key owns one accumulator of tensors on
the recorded tensor's device, updated in place by every record (int64
counts of ``NBINS + 1`` slots, the last the nonfinite count; the running
``abs_max``; ``sum_sq`` summed in float64 over the per-record f32 sums, as
the reference's host-side merge sums them; the element count). A record
never waits on the host; ``Observer.sync`` (which ``get``/``paths`` call)
reads every accumulator back in one copy. Counts are integers: a float32
count saturates at 2^24 a binade, which one full-size linear exceeds.

Stats are keyed by ``(path, kind)`` with ``kind`` in ``("weight", "act")``;
every layer of a model shares one call-site path, so their statistics merge
into one histogram, the granularity at which ``PrecisionPolicy`` rules
resolve. The reference's ``"grad"`` kind (the gradient tap of its training
telemetry) is not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# Binade range covered by the histogram: floor(log2|x|) in [BIN_LO, BIN_HI].
# BIN_HI sits above p8 es3's saturation scale (48), so saturating mass never
# clamps into an in-range bin.
BIN_LO = -80
NBINS = 130
BIN_HI = BIN_LO + NBINS - 1

KINDS = ("weight", "act", "grad")

# histc counts in f32, exact up to 2^24 a bin: records are counted in chunks
# no larger, and the chunks' counts summed in int64
_HIST_CHUNK = 1 << 24


@dataclasses.dataclass
class TensorStats:
    """Mergeable streamed statistics of one tensor (or stream of tensors)."""

    n: float = 0.0                 # total elements seen (zeros included)
    zeros: float = 0.0             # exact zeros
    abs_max: float = 0.0
    sum_sq: float = 0.0
    nonfinite: float = 0.0         # NaN/inf elements (posit NaR witness)
    hist: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((NBINS,), np.float64))
    size: int = 0                  # per-record element count
    shape: Tuple[int, ...] = ()    # shape of one recorded tensor

    def merge_vec(self, size: int, shape: Tuple[int, ...],
                  head: np.ndarray, counts: np.ndarray) -> None:
        """Fold one record: head [abs_max, sum_sq], integer counts (the NBINS
        histogram with one trailing slot for the nonfinite count; a bare
        NBINS histogram means nonfinite 0)."""
        counts = np.asarray(counts, np.float64)
        self.n += float(size)
        self.abs_max = max(self.abs_max, float(head[0]))
        self.sum_sq += float(head[1])
        if counts.shape[0] == NBINS + 1:
            self.nonfinite += float(counts[-1])
            counts = counts[:-1]
        self.hist += counts
        self.zeros = self.n - float(self.hist.sum()) - self.nonfinite
        self.size = size
        self.shape = tuple(shape)

    @property
    def rms(self) -> float:
        return float(np.sqrt(self.sum_sq / self.n)) if self.n else 0.0

    @property
    def probs(self) -> np.ndarray:
        """Per-binade probability mass (zeros excluded from every bin; the
        zero fraction is ``zeros / n``)."""
        return self.hist / self.n if self.n else self.hist

    def nonzero_frac(self) -> float:
        return 1.0 - self.zeros / self.n if self.n else 0.0

    def hist_json(self) -> dict:
        """Compact JSON form of the binade histogram (the artifact's):
        leading and trailing zero bins trimmed, ``bin_lo`` anchors the rest."""
        nz = np.flatnonzero(self.hist)
        if nz.size == 0:
            return {"bin_lo": 0, "counts": [], "n": self.n}
        lo, hi = int(nz[0]), int(nz[-1])
        return {"bin_lo": BIN_LO + lo,
                "counts": [int(c) for c in self.hist[lo:hi + 1]],
                "n": self.n}

    @staticmethod
    def hist_from_json(d: dict) -> "TensorStats":
        """Inverse of ``hist_json``: a TensorStats holding just the
        distribution (n and hist)."""
        st = TensorStats()
        st.n = float(d.get("n", 0.0))
        for i, c in enumerate(d.get("counts", ())):
            b = int(d["bin_lo"]) + i - BIN_LO
            if 0 <= b < NBINS:
                st.hist[b] = float(c)
        st.zeros = st.n - float(st.hist.sum())
        return st


def _stat_vec(arr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-side reduction: (f32 [abs_max, sum_sq], int64 counts[NBINS + 1]).

    ``counts[:NBINS]`` is the binade histogram, ``counts[-1]`` the nonfinite
    count. ``frexp`` gives |x| = m * 2^e with m in [0.5, 1), so
    ``floor(log2|x|) == e - 1`` exactly. Subnormal values count as zeros, as
    the reference's platforms flush them (XLA on the CPU, the TPU). No host sync:
    the counts come from ``torch.histc`` over unit-width bins with a fixed
    range (``torch.bincount`` reads its input's min and max on the host).
    """
    x = arr.detach().to(torch.float32).abs().reshape(-1)
    finite = torch.isfinite(x)
    x = torch.where(finite, x, 0.0)
    _, e = torch.frexp(x)
    binade = torch.clamp(e - (BIN_LO + 1), 0, NBINS - 1)       # floor(log2|x|) - BIN_LO
    # slot NBINS: nonfinite; slot NBINS + 1: exact zeros (dropped)
    normal = x >= torch.finfo(torch.float32).tiny
    idx = torch.where(finite, torch.where(normal, binade, NBINS + 1), NBINS).to(torch.float32)
    counts = torch.zeros((NBINS + 2,), dtype=torch.int64, device=x.device)
    for chunk in idx.split(_HIST_CHUNK):
        counts += torch.histc(chunk, bins=NBINS + 2, min=0, max=NBINS + 2).to(torch.int64)
    if x.numel():
        head = torch.stack([x.max(), torch.sum(x * x)])
    else:
        head = torch.zeros((2,), dtype=torch.float32, device=x.device)
    return head, counts[:NBINS + 1]


class _Accum:
    """One key's running statistics on the device, updated in place."""

    def __init__(self, device: torch.device):
        self.counts = torch.zeros((NBINS + 1,), dtype=torch.int64, device=device)
        self.abs_max = torch.zeros((), dtype=torch.float32, device=device)
        self.sum_sq = torch.zeros((), dtype=torch.float64, device=device)
        self.n = torch.zeros((), dtype=torch.int64, device=device)
        self.size = 0
        self.shape: Tuple[int, ...] = ()

    def add(self, arr: torch.Tensor) -> None:
        head, counts = _stat_vec(arr)
        self.counts += counts
        torch.maximum(self.abs_max, head[0], out=self.abs_max)
        self.sum_sq += head[1].to(torch.float64)
        self.n += arr.numel()
        self.size, self.shape = arr.numel(), tuple(arr.shape)

    def row(self) -> torch.Tensor:
        """[n, abs_max, sum_sq, counts...] as float64 (exact: counts stay
        below 2^53)."""
        return torch.cat([torch.stack([self.n.to(torch.float64),
                                       self.abs_max.to(torch.float64), self.sum_sq]),
                          self.counts.to(torch.float64)])


class Observer:
    """Accumulates statistics per ``(path, kind)`` key on the recorded
    tensors' device; ``stats`` (read by ``get`` and ``paths``) holds them as
    ``TensorStats`` after one host copy.

    ``kinds`` restricts which tensor kinds stream: calibration wants weights
    and activations (the default); a numerics probe would pass ``("act",)``.
    """

    def __init__(self, kinds: Tuple[str, ...] = ("weight", "act")):
        assert all(k in KINDS for k in kinds), kinds
        if "grad" in kinds:
            raise NotImplementedError(
                "the 'grad' kind (the reference's grad_tap, its training telemetry) needs "
                "obs/train.py, which is not ported yet: ROADMAP Queue 1 item 6")
        self.kinds = tuple(kinds)
        self._acc: Dict[Tuple[str, str], _Accum] = {}
        self._stats: Dict[Tuple[str, str], TensorStats] = {}
        self._dirty = False

    def record(self, path: str, kind: str, arr: torch.Tensor) -> None:
        assert kind in KINDS, kind
        if kind not in self.kinds:
            return
        acc = self._acc.get((path, kind))
        if acc is None:
            acc = self._acc[(path, kind)] = _Accum(arr.device)
        acc.add(arr)
        self._dirty = True

    def sync(self) -> Dict[Tuple[str, str], TensorStats]:
        """Read every accumulator back to the host (one copy a device) into
        ``TensorStats``."""
        if self._dirty:
            by_dev: Dict[torch.device, list] = {}
            for k, acc in self._acc.items():
                by_dev.setdefault(acc.counts.device, []).append(k)
            rows = {}
            for keys in by_dev.values():
                block = torch.stack([self._acc[k].row() for k in keys]).cpu().numpy()
                rows.update(zip(keys, block))
            self._stats = {}
            for k, r in rows.items():
                # every record of the key folded at once: n is their total
                st = self._stats[k] = TensorStats()
                st.merge_vec(int(r[0]), self._acc[k].shape, r[1:3], r[3:])
                st.size = self._acc[k].size
            self._dirty = False
        return self._stats

    @property
    def stats(self) -> Dict[Tuple[str, str], TensorStats]:
        return self.sync()

    def paths(self) -> Tuple[str, ...]:
        return tuple(sorted({p for p, _ in self.stats}))

    def get(self, path: str, kind: str) -> Optional[TensorStats]:
        return self.stats.get((path, kind))


_ACTIVE: Optional[Observer] = None


def is_active() -> bool:
    return _ACTIVE is not None


def get_active() -> Optional[Observer]:
    return _ACTIVE


@contextlib.contextmanager
def observing(obs: Observer):
    """Install ``obs`` as the active observer for the block."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = obs
    try:
        yield obs
    finally:
        _ACTIVE = prev


def record(path: str, kind: str, arr: torch.Tensor) -> None:
    """Call-site hook: stream the statistics of ``arr`` if an observer is
    active (one global read when none is)."""
    if _ACTIVE is not None:
        _ACTIVE.record(path, kind, arr)


def collect_stats(forward_fn, batches) -> Observer:
    """Run ``forward_fn(batch)`` over ``batches`` under a fresh observer,
    with no gradient taken, and read its statistics back once."""
    obs = Observer()
    with observing(obs), torch.no_grad():
        for batch in batches:
            forward_fn(batch)
    obs.sync()
    return obs
