"""Slot-based continuous-batching serving engine over the ragged KV cache.

The decode batch is a fixed grid of ``max_slots`` slots sharing one model
cache. Requests wait in a FIFO queue, are prefilled into a free slot the
moment one exists (a B=1 prefill, then a copy of that row into the grid; no
other slot is touched), decode in lockstep as one batch while each row masks
by its own length, and leave on EOS or max length, freeing the slot.

Greedy decoding is ``temperature=0``; otherwise temperature / top-k sampling
from a ``torch.Generator`` seeded per engine. The reference's observability,
fault-tolerance, snapshot and streaming planes are not ported.

The decode step is one executable, as the reference's jit of it is: on a
CUDA model ``_build_executables`` captures one step of the fixed slot grid
in a CUDA graph and every ``step`` replays it. The graph reads and writes
the engine's persistent buffers (the token row, the cache and its lengths),
so nothing rebinds them: admission, slot writes and ``reset`` copy into
them in place. On a CPU model the step runs eagerly, the plain versions.
Prefill stays eager.

The hooks a subclass overrides to swap the cache layout (the paged engine,
``launch/paged_engine.py``) are the reference's: ``_init_cache``,
``_init_state``, ``_build_executables``, ``_can_admit``,
``_prefill_into_slot``, ``_prepare_decode``, ``_release_slot``,
``_quarantine`` and ``inject_nar_into``.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.models.transformer import kv_stacks


@dataclasses.dataclass
class Request:
    """One generation request."""
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32 token ids
    max_new_tokens: int = 16
    arrival_time: float = 0.0       # seconds since engine start

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass
class Completion:
    """Per-request serving record (tokens + latency breakdown)."""
    rid: int
    prompt_len: int
    tokens: list                    # generated token ids (includes EOS if hit)
    arrival_time: float
    admitted_time: float
    finished_time: float
    token_times: list               # absolute emission time of each token
    finish_reason: str = ""         # eos | max_new | cache_full

    @property
    def ttft_s(self) -> float:
        return self.token_times[0] - self.arrival_time

    def per_token_s(self) -> list:
        """Inter-token latencies (the first token measured from admission)."""
        starts = [self.admitted_time] + self.token_times[:-1]
        return [t - s for s, t in zip(starts, self.token_times)]


def poisson_requests(n: int, *, arrival_rate: float, prompt_lens=(16, 24, 32),
                     max_new_tokens: int = 16, vocab: int = 32000,
                     seed: int = 0) -> list:
    """n requests with exponential inter-arrival times (rate = req/s);
    ``arrival_rate <= 0`` means everything arrives at t=0. Prompt lengths
    cycle through ``prompt_lens``."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n):
        if arrival_rate > 0:
            t += float(rng.exponential(1.0 / arrival_rate))
        plen = int(prompt_lens[i % len(prompt_lens)])
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, vocab, (plen,)).astype(np.int32),
            max_new_tokens=max_new_tokens, arrival_time=t))
    return reqs


def _write_slot(full, one, slot: int) -> None:
    """Copy row 0 of the B=1 cache ``one`` into row ``slot`` of ``full``, in
    place. A leaf's batch axis is the one axis where the shapes differ;
    leaves of equal shape (the scalar step counter) are left alone."""
    if isinstance(full, dict):
        for k in full:
            _write_slot(full[k], one[k], slot)
        return
    if full.shape == one.shape:
        return
    axes = [i for i, (a, b) in enumerate(zip(full.shape, one.shape)) if a != b]
    if len(axes) != 1 or one.shape[axes[0]] != 1:
        raise ValueError(f"ambiguous batch axis for cache leaf {tuple(full.shape)} "
                         f"vs {tuple(one.shape)}")
    full.narrow(axes[0], slot, 1).copy_(one)


def _copy_into(full, one) -> None:
    """Copy every leaf of ``one`` into the same-shaped leaf of ``full``."""
    if isinstance(full, dict):
        for k in full:
            _copy_into(full[k], one[k])
        return
    full.copy_(one)


def _nar_code(t: torch.Tensor):
    """The value that decodes to NaR/NaN in a KV array of ``t``'s dtype: p8
    codes (uint8) 0x80, p16 codes (uint16) 0x8000, NaN in a float cache (the
    reference's ``_nar_code``, src/repro/ft/serving.py)."""
    if t.dtype == torch.uint8:
        return 0x80
    if t.dtype == torch.uint16:
        return 0x8000
    return float("nan")


def _zero(tree) -> None:
    """Zero every leaf in place (code 0 is exact 0.0 in every posit format)."""
    if isinstance(tree, dict):
        for v in tree.values():
            _zero(v)
        return
    tree.zero_()


class CapturedStep:
    """``fn(*args)`` captured once in a CUDA graph and replayed over the
    same tensors: the counterpart of the reference's jit of the decode step
    with the cache donated.

    A warm-up call on the capture stream builds the kernels and sizes every
    scratch and counter buffer there, with any host synchronisation an
    error (a step that waits on the card cannot be captured); the tensors of
    ``restore`` (the state the step advances) are then put back, and one
    call is captured. A call replays the graph on the current stream and
    returns the captured call's own outputs (the logits tensor is
    overwritten by the next replay). Each replay adds the captured launches
    to ``kernels.LAUNCHES`` once; neither the warm-up nor the capture
    counts. A failed capture raises: there is no eager fallback.

    Python's cyclic garbage collector is run before the capture and held off
    during it: an unreachable engine's graph freed by the collector in the
    middle of a capture (``cudaGraphExecDestroy`` is not permitted while a
    stream captures) would invalidate this one."""

    def __init__(self, fn: Callable, args: tuple, restore: tuple, stream):
        saved = [t.clone() for t in restore]
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with kernels.CapturedLaunches(), torch.cuda.stream(stream):
                fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        current.wait_stream(stream)
        for t, s in zip(restore, saved):
            t.copy_(s)
        self.graph = torch.cuda.CUDAGraph()
        self.launches = kernels.CapturedLaunches()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with self.launches, torch.cuda.graph(self.graph, stream=stream):
                self.out = fn(*args)
        finally:
            if collecting:
                gc.enable()
        self.args = args

    def __call__(self, *args):
        if len(args) != len(self.args) or any(a is not b for a, b in zip(args, self.args)):
            raise ValueError("a captured step replays only over the tensors it was "
                             "captured with")
        self.graph.replay()
        self.launches.replayed()
        return self.out


def require_prefill(model) -> None:
    """The engines admit a request by prefilling it: a family without a
    prefill entry point (whisper) is refused, with the reference's words."""
    if model.prefill is None:
        raise ValueError(f"family {model.cfg.family!r} has no prefill entry point")


def _sample(logits: torch.Tensor, gen: torch.Generator, temperature: float,
            top_k: int) -> torch.Tensor:
    """(B, V) logits -> (B,) tokens. temperature == 0 is greedy argmax."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class ContinuousBatchingEngine:
    """Admission + decode + eviction over a fixed slot grid.

    Drive it with :meth:`run` (wall-clock loop honoring arrival times) or by
    hand with :meth:`submit` / :meth:`admit` / :meth:`step`. ``policy`` is a
    ``TransPolicy`` or a per-layer ``PrecisionPolicy``: the engine hands it
    to the model as it is, and each linear resolves its own format.
    """

    def __init__(self, model, params, policy, *, max_slots: int, S_max: int,
                 eos_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
        require_prefill(model)
        self.model, self.params, self.policy = model, params, policy
        self.device = model.device
        self.max_slots, self.S_max = max_slots, S_max
        self.eos_id, self.temperature, self.top_k = eos_id, temperature, top_k
        self.cache = None
        self._stream = None
        self._init_state(seed)
        self._build_executables(policy)

    def _build_executables(self, policy) -> None:
        """(Re)build the decode program for ``policy``.

        Called at init and by :meth:`apply_policy`. On a CUDA model one
        decode step over the persistent token row and cache is captured in a
        CUDA graph (``CapturedStep``) and ``self._decode`` replays it; the
        old graph and its memory pool are dropped first. On a CPU model
        ``self._decode`` is the model's decode step, run eagerly. Sampling,
        the nonfinite check and the step's one device-to-host copy stay
        outside, as they stay outside the reference's jit.
        """
        model = self.model
        c = self.cache
        self._bind_decode(lambda p, t, cache: model.decode_step(p, t, cache, policy),
                          (c["lens"], c["pos"]) + tuple(kv["len"] for kv in kv_stacks(c)))

    def _bind_decode(self, decode: Callable, state: tuple) -> None:
        """``self._decode`` = ``decode(params, token_row, cache)``: run eagerly
        on a CPU model, captured in a CUDA graph on a CUDA model, where
        ``state`` are the tensors the step advances (put back after the
        warm-up). The old graph and its memory pool are dropped first."""
        self._decode = None
        if self.device.type != "cuda":
            self._decode = decode
            return
        if self._stream is None:
            # one capture stream an engine: its kernel counters keep their size
            self._stream = torch.cuda.Stream(self.device)
        self._decode = CapturedStep(decode, (self.params, self.last_token, self.cache), state,
                                    self._stream)

    def apply_policy(self, policy) -> None:
        """Swap the serving policy mid-flight (degradation ladder step).

        Only weight-format overlays are legal: the KV-cache format must be
        unchanged, or the live cache's code arrays would be reinterpreted
        under the wrong codec.
        """
        old_kv = getattr(self.policy, "kv_cache", None)
        new_kv = getattr(policy, "kv_cache", None)
        if (old_kv is None) != (new_kv is None) or \
                (old_kv is not None and old_kv.name != new_kv.name):
            raise ValueError(
                f"apply_policy may not change the KV-cache format "
                f"({old_kv} -> {new_kv}); only weight overlays are hot-"
                f"swappable")
        self.policy = policy
        self._build_executables(policy)

    def _init_cache(self) -> dict:
        """Device-cache construction hook (the slot grid's stacked cache)."""
        return self.model.init_cache(self.max_slots, self.S_max, self.policy)

    def _init_state(self, seed: int) -> None:
        """Fresh serving state. The cache and the token row are made once
        and zeroed in place after that: the captured decode step holds their
        addresses."""
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        if self.cache is None:
            self.cache = self._init_cache()
            self.last_token = torch.zeros((self.max_slots,), dtype=torch.int32,
                                          device=self.device)
        else:
            _zero(self.cache)
            self.last_token.zero_()
        self.lens = np.zeros((self.max_slots,), np.int32)
        self.active = np.zeros((self.max_slots,), bool)
        self.slot_req: list = [None] * self.max_slots
        self.slot_tokens: list = [[] for _ in range(self.max_slots)]
        self.slot_token_times: list = [[] for _ in range(self.max_slots)]
        self.slot_admitted = np.zeros((self.max_slots,), np.float64)
        self.queue: list = []
        self.completions: list = []
        self.steps = 0
        self.nonfinite_rows = 0   # active rows whose logits held NaN/inf

    def reset(self, seed: int = 0) -> None:
        """Clear all serving state but keep the compiled decode program
        (the captured graph and the buffers it reads)."""
        self._init_state(seed)

    # ---------------------------------------------------------- client API ----
    def submit(self, req: Request) -> int:
        self.queue.append(req)
        return req.rid

    def results(self) -> list:
        return list(self.completions)

    def result(self, rid: int):
        for c in self.completions:
            if c.rid == rid:
                return c
        return None

    # ------------------------------------------------------------- admission --
    def free_slots(self) -> list:
        return [i for i in range(self.max_slots) if not self.active[i]]

    def _can_admit(self, req: Request) -> bool:
        """Beyond a free slot, can the cache take this request right now?
        The slot grid always can (every slot owns S_max rows); the paged
        engine gates on block availability (queueing is the backpressure)."""
        return True

    def _prefill_into_slot(self, req: Request, slot: int):
        """Prefill ``req`` and install its KV into ``slot``; returns
        ``(logits, row_len)``. The paged engine overrides this with
        prefix-matched block admission."""
        tokens = torch.as_tensor(req.prompt, dtype=torch.int32, device=self.device)[None]
        logits, one = self.model.prefill(self.params, tokens, self.policy, S_max=self.S_max)
        row_len = int(one["lens"][0])
        if self.max_slots == 1:
            # every leaf has the B=1 cache's shape: the row is the whole cache
            _copy_into(self.cache, one)
        else:
            _write_slot(self.cache, one, slot)
        return logits, row_len

    def admit(self, now: float = 0.0, clock: Optional[Callable] = None) -> int:
        """Prefill queued requests into free slots; returns #admitted. The
        first token of each admitted request comes from its prefill logits."""
        admitted = 0
        for slot in self.free_slots():
            if not self.queue:
                break
            if not self._can_admit(self.queue[0]):
                break       # FIFO: later requests must not starve the head
            req = self.queue.pop(0)
            t_admit = clock() if clock else now
            if req.prompt_len + req.max_new_tokens > self.S_max:
                raise ValueError(
                    f"request {req.rid}: prompt {req.prompt_len} + "
                    f"max_new {req.max_new_tokens} exceeds S_max {self.S_max}")
            logits, row_len = self._prefill_into_slot(req, slot)
            tok = int(self._next_token(logits)[0])   # waits for the prefill
            t_first = clock() if clock else now
            self.lens[slot] = row_len
            self.last_token[slot] = tok
            self.active[slot] = True
            self.slot_req[slot] = req
            self.slot_tokens[slot] = [tok]
            self.slot_token_times[slot] = [t_first]
            self.slot_admitted[slot] = t_admit
            self._sync_lens()
            admitted += 1
            self._maybe_finish(slot, tok, t_first)
        return admitted

    def _next_token(self, logits: torch.Tensor) -> torch.Tensor:
        return _sample(logits, self._gen, self.temperature, self.top_k)

    def _sync_lens(self) -> None:
        """The engine's slot lengths are authoritative: push them into the
        cache's per-row positions (recycled slots restart), in place."""
        self.cache["lens"].copy_(torch.from_numpy(self.lens))

    # --------------------------------------------------------------- decode ---
    def step(self, now: float = 0.0) -> int:
        """One decode step over the whole slot grid; returns #tokens emitted."""
        if not self.active.any():
            return 0
        self._prepare_decode(now)
        if not self.active.any():   # pool pressure may have evicted the rest
            return 0
        logits, self.cache = self._decode(self.params, self.last_token, self.cache)
        self.steps += 1
        toks = self._next_token(logits).to(torch.int32)
        bad = (~torch.isfinite(logits)).any(dim=-1)
        toks_np, bad_np = torch.stack([toks, bad.to(torch.int32)]).cpu().numpy()
        self.lens += 1          # decode_step advanced every row
        self.last_token.copy_(toks)
        emitted = 0
        for slot in range(self.max_slots):
            if not self.active[slot]:
                continue
            self.nonfinite_rows += int(bad_np[slot])
            tok = int(toks_np[slot])
            self.slot_tokens[slot].append(tok)
            self.slot_token_times[slot].append(now)
            emitted += 1
            self._maybe_finish(slot, tok, now)
        return emitted

    def _maybe_finish(self, slot: int, tok: int, now: float) -> bool:
        req = self.slot_req[slot]
        reason = ""
        if self.eos_id is not None and tok == self.eos_id:
            reason = "eos"
        elif len(self.slot_tokens[slot]) >= req.max_new_tokens:
            reason = "max_new"
        elif self.lens[slot] + 1 >= self.S_max:
            reason = "cache_full"
        if reason:
            self._evict(slot, now, reason)
        return bool(reason)

    def _evict(self, slot: int, now: float, reason: str) -> None:
        req = self.slot_req[slot]
        self.completions.append(Completion(
            rid=req.rid, prompt_len=req.prompt_len,
            tokens=list(self.slot_tokens[slot]), arrival_time=req.arrival_time,
            admitted_time=float(self.slot_admitted[slot]), finished_time=now,
            token_times=list(self.slot_token_times[slot]), finish_reason=reason))
        self.active[slot] = False
        self.slot_req[slot] = None
        self._release_slot(slot)

    def _prepare_decode(self, now: float) -> None:
        """Pre-step cache maintenance hook. The slot grid needs none; the
        paged engine allocates block-boundary pages, runs copy-on-write on
        shared tails and refreshes the device block table here."""

    def _quarantine(self, slot: int, now: float) -> None:
        """Evict a nonfinite-logit slot and zero its K/V rows (code 0 is exact
        0.0), so the dead row cannot poison the shared grid. The reference's
        serving watchdog calls it; the port has no watchdog yet, so no
        serving path here does."""
        self._evict(slot, now, "numerics")
        for kv in kv_stacks(self.cache):
            for name in ("k", "v"):
                kv[name][:, slot].zero_()

    def _release_slot(self, slot: int) -> None:
        """Per-eviction cache cleanup hook (the slot grid reuses rows as they
        are; the paged engine drops the slot's block references)."""

    def inject_nar_into(self, slot: int, count: int) -> None:
        """Chaos hook: poison the first ``count`` occupied KV positions of
        ``slot`` with NaR codes (at least one), in every layer (a rolling
        buffer's first rows, at most all of them)."""
        n = max(1, min(count, max(int(self.lens[slot]), 1)))
        for kv in kv_stacks(self.cache):
            for name in ("k", "v"):
                kv[name][:, slot, :, :n].fill_(_nar_code(kv[name]))

    # ------------------------------------------------------------------ run ---
    def run(self, requests: list, *, clock: Optional[Callable] = None) -> list:
        """Serve ``requests`` to completion, honoring their arrival times
        against ``clock`` (default: wall seconds from the first call)."""
        pending = sorted(requests, key=lambda r: r.arrival_time)
        t0 = time.perf_counter()
        clock = clock or (lambda: time.perf_counter() - t0)
        while pending or self.queue or self.active.any():
            now = clock()
            while pending and pending[0].arrival_time <= now:
                self.submit(pending.pop(0))
            if self.queue and self.free_slots():
                self.admit(clock=clock)
            if self.active.any():
                self.step(now=clock())
            elif pending:
                time.sleep(min(0.001, pending[0].arrival_time - now))
        return list(self.completions)
