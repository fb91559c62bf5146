"""The engine's executable hooks on the CPU: ``_init_cache``, ``_init_state``,
``_build_executables``, ``apply_policy`` and ``reset``, the persistent
buffers a captured decode step reads, and the launch accounting of a
replayed graph.

On a CUDA model ``_build_executables`` captures the decode step in a CUDA
graph (``CapturedStep``); on the CPU it binds the model's step, run eagerly,
so these tests drive the same engine code around it. The graph itself runs
on the card (chip_smoke.py, and ``tests/test_torch_cuda.py -k graph``).

Against the reference engine (qwen2.5-14b ``--reduced``, P8_SERVE and
attn-p16-mlp-p8, the reference's params converted bit for bit) the contract
is ``tests/test_torch_model.py``'s: equal greedy token streams, and every
active row's logits within that test's bound for the policy (0.05 and 1e-4).
Logits are not compared bit for bit across the two frameworks (XLA:CPU
compiles are not bit-stable across program instances).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.core import policy as jpolicy
from repro.launch.engine import ContinuousBatchingEngine as RefEngine
from repro.launch.engine import Request as RefRequest
from repro.models.layers import quantize_params as jax_quantize
from repro.models.registry import build_model as jax_build
from repro_torch import kernels
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import pcsr, policy
from repro_torch.launch.engine import CapturedStep, ContinuousBatchingEngine, Request
from repro_torch.models.registry import build_model

ARCH = "qwen2.5-14b"
F32_P8 = pcsr.TransPolicy.from_names(weights="p8_0", kv_cache="p8_0", compute_dtype="f32")
POLICIES = {
    "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE, 0.05),
    "attn-p16-mlp-p8": (jpolicy.PRECISION_PRESETS["attn-p16-mlp-p8"],
                        policy.PRECISION_PRESETS["attn-p16-mlp-p8"], 1e-4),
}
# (prompt length, max new tokens): five requests through four slots, so one
# takes a recycled slot
SHAPES = ((8, 6), (12, 9), (5, 4), (10, 7), (6, 5))


@pytest.fixture(scope="module")
def p8():
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(0, pcsr.P8_SERVE)


def _engine(p8, max_slots=4):
    _, model, params = p8
    return ContinuousBatchingEngine(model, params, pcsr.P8_SERVE, max_slots=max_slots,
                                    S_max=24)


def _prompts(vocab, shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (plen,)).astype(np.int32), n) for plen, n in shapes]


def _staggered(eng, prompts, request=Request):
    """Admit the requests in three waves between steps, then run out."""
    reqs = [request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(prompts)]
    for wave in (reqs[:1], reqs[1:2], reqs[2:]):
        for r in wave:
            eng.submit(r)
        eng.admit()
        eng.step()
        eng.step()
    while eng.active.any() or eng.queue:
        eng.admit()
        eng.step()
    return {c.rid: c.tokens for c in eng.completions}


def _buffers(eng) -> dict:
    c = eng.cache
    return {"lens": c["lens"], "pos": c["pos"], "len": c["kv"]["len"], "k": c["kv"]["k"],
            "v": c["kv"]["v"], "last_token": eng.last_token}


def _ptrs(eng) -> dict:
    return {k: t.data_ptr() for k, t in _buffers(eng).items()}


@pytest.mark.parametrize("max_slots", [1, 4])
def test_persistent_buffers_keep_their_addresses(p8, max_slots):
    """Admission (the B=1 cache copied in when one slot is the grid), steps,
    slot recycling and reset write into the buffers the graph reads."""
    cfg = p8[0]
    eng = _engine(p8, max_slots=max_slots)
    want = _ptrs(eng)
    tensors = _buffers(eng)
    prompts = _prompts(cfg.vocab)
    for p, n in prompts:
        eng.submit(Request(rid=len(eng.queue), prompt=p, max_new_tokens=n))
    while eng.queue or eng.active.any():
        eng.admit()
        assert _ptrs(eng) == want
        eng.step()
        assert _ptrs(eng) == want
    assert len(eng.completions) == len(prompts)
    eng.reset()
    assert _ptrs(eng) == want
    assert all(t is _buffers(eng)[k] for k, t in tensors.items())
    assert not any(bool(t.any()) for t in _buffers(eng).values())


def test_reset_keeps_the_decode_program_and_equals_a_fresh_engine(p8):
    cfg = p8[0]
    prompts = _prompts(cfg.vocab)
    eng = _engine(p8)
    decode = eng._decode
    first = _staggered(eng, prompts)
    eng.reset()
    assert eng._decode is decode
    assert eng.steps == 0 and not eng.completions and not eng.active.any()
    again = _staggered(eng, prompts)
    fresh = _staggered(_engine(p8), prompts)
    assert first == again == fresh
    assert [len(fresh[i]) for i in range(len(SHAPES))] == [n for _, n in SHAPES]


def test_staggered_equals_isolated_through_build_executables(p8):
    """Temperature 0: every request gets, admitted between other requests'
    steps and into a recycled slot, the tokens it gets served alone."""
    cfg = p8[0]
    prompts = _prompts(cfg.vocab, seed=3)
    eng = _engine(p8)
    isolated = {}
    for i, (p, n) in enumerate(prompts):
        eng.reset()
        isolated[i] = eng.run([Request(rid=i, prompt=p, max_new_tokens=n)])[0].tokens
    eng.reset()
    assert _staggered(eng, prompts) == isolated


def test_decode_step_advances_lens_in_place(p8):
    cfg, model, params = p8
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (3, 7),
                                                               dtype=np.int64).astype(np.int32))
    _, cache = model.prefill(params, toks, pcsr.P8_SERVE, S_max=16)
    cache["lens"].copy_(torch.tensor([7, 3, 5], dtype=torch.int32))
    lens, pos, kv_len = cache["lens"], cache["pos"], cache["kv"]["len"]
    _, out = model.decode_step(params, toks[:, -1], cache, pcsr.P8_SERVE)
    assert out is cache
    assert out["lens"] is lens and out["pos"] is pos and out["kv"]["len"] is kv_len
    assert lens.tolist() == [8, 4, 6] and int(pos) == 8
    assert kv_len.tolist() == [[8, 8, 8]] * cfg.n_layers


def _ref_setup(jpol):
    """The reference's reduced model and params under ``jpol``, and the port's
    model with the same params converted bit for bit."""
    jcfg = jax_arch(ARCH).reduced()
    jm = jax_build(jcfg)
    jparams = jax_quantize(jax.jit(jm.init)(jax.random.key(0)), jpol)
    cfg = get_arch(ARCH).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return (jm, jparams), (build_model(cfg, device="cpu"), params)


def _recorded(eng, to_numpy):
    """Each decode step's logits of the rows active in it."""
    steps = []
    decode = eng._decode

    def recording(p, t, c):
        logits, cache = decode(p, t, c)
        steps.append(to_numpy(logits)[eng.active])
        return logits, cache

    eng._decode = recording
    return steps


def _assert_close(got_logits, ref_logits, bound):
    assert len(got_logits) == len(ref_logits)
    for g, r in zip(got_logits, ref_logits):
        assert g.shape == r.shape and np.isfinite(g).all()
        assert float(np.abs(g - r).max()) <= bound


@pytest.mark.parametrize("name", list(POLICIES))
def test_engine_matches_the_reference_engine(name):
    jpol, pol, bound = POLICIES[name]
    (jm, jparams), (model, params) = _ref_setup(jpol)
    prompts = _prompts(model.cfg.vocab, seed=1)
    ref = RefEngine(jm, jparams, jpol, max_slots=4, S_max=24)
    ref_logits = _recorded(ref, np.asarray)
    want = _staggered(ref, prompts, RefRequest)
    eng = ContinuousBatchingEngine(model, params, pol, max_slots=4, S_max=24)
    got_logits = _recorded(eng, lambda t: t.numpy())
    got = _staggered(eng, prompts)
    assert got == want
    assert eng.steps == ref.steps == len(got_logits)
    _assert_close(got_logits, ref_logits, bound)


def test_apply_policy_refuses_a_kv_format_change_like_the_reference(p8):
    (jm, jparams), _ = _ref_setup(jpcsr.P8_SERVE)
    ref = RefEngine(jm, jparams, jpcsr.P8_SERVE, max_slots=2, S_max=24)
    eng = _engine(p8, max_slots=2)
    decode = eng._decode
    for jnew, new in ((jpcsr.TransPolicy.from_names(weights="p8_0", kv_cache="p16_1"),
                       pcsr.TransPolicy.from_names(weights="p8_0", kv_cache="p16_1")),
                      (jpcsr.TransPolicy.from_names(weights="p8_0"),
                       pcsr.TransPolicy.from_names(weights="p8_0"))):
        with pytest.raises(ValueError) as want:
            ref.apply_policy(jnew)
        with pytest.raises(ValueError, match="only weight overlays are hot-swappable") as got:
            eng.apply_policy(new)
        assert str(got.value) == str(want.value)
    assert eng.policy is pcsr.P8_SERVE and eng._decode is decode


JF32_P8 = jpcsr.TransPolicy.from_names(weights="p8_0", kv_cache="p8_0", compute_dtype="f32")
# legal swaps: the KV format stays, and the params serve both policies;
# (reference old, reference new, port old, port new, logit bound)
SWAPS = {
    "chained": (jpcsr.P8_SERVE, dataclasses.replace(jpcsr.P8_SERVE, epilogue="chained"),
                pcsr.P8_SERVE, dataclasses.replace(pcsr.P8_SERVE, epilogue="chained"), 0.05),
    "f32-compute": (jpcsr.P8_SERVE, JF32_P8, pcsr.P8_SERVE, F32_P8, 0.05),
    "mixed-base": (jpolicy.get_precision_policy("attn-p16-mlp-p8", base=jpcsr.P8_SERVE),
                   jpolicy.get_precision_policy("attn-p16-mlp-p8", base=JF32_P8),
                   policy.get_precision_policy("attn-p16-mlp-p8", base=pcsr.P8_SERVE),
                   policy.get_precision_policy("attn-p16-mlp-p8", base=F32_P8), 0.05),
}


def _swap_mid_flight(eng, prompts, new, to_numpy, request=Request):
    """Four requests prefilled and stepped twice under the engine's policy,
    then finished under ``new``; returns the tokens and each step's logits
    of its active rows (recorded through the rebuilt decode program too)."""
    for i, (p, n) in enumerate(prompts[:4]):
        eng.submit(request(rid=i, prompt=p, max_new_tokens=n))
    eng.admit()
    logits = _recorded(eng, to_numpy)
    eng.step()
    eng.step()
    eng.apply_policy(new)
    after = _recorded(eng, to_numpy)
    while eng.active.any():
        eng.step()
    return {c.rid: c.tokens for c in eng.completions}, logits + after


@pytest.mark.parametrize("swap", list(SWAPS))
def test_apply_policy_swap_rebuilds_and_serves_like_a_fresh_engine(swap):
    """A legal swap rebuilds the decode program; the engine then serves
    what a fresh engine built under the new policy serves."""
    _, _, old, new, _ = SWAPS[swap]
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, old)
    prompts = _prompts(cfg.vocab, seed=2)
    eng = ContinuousBatchingEngine(model, params, old, max_slots=4, S_max=24)
    before = _staggered(eng, prompts)
    decode = eng._decode
    eng.apply_policy(new)
    assert eng.policy is new and eng._decode is not decode
    eng.reset()
    want = _staggered(ContinuousBatchingEngine(model, params, new, max_slots=4, S_max=24),
                      prompts)
    assert _staggered(eng, prompts) == want
    assert [len(t) for t in want.values()] == [len(t) for t in before.values()]


@pytest.mark.parametrize("swap", list(SWAPS))
def test_apply_policy_mid_flight_matches_the_reference_engine(swap):
    """The live cache stays valid across a swap: rows prefilled and stepped
    under the old policy finish under the new one as the reference's do."""
    jold, jnew, old, new, bound = SWAPS[swap]
    (jm, jparams), (model, params) = _ref_setup(jold)
    prompts = _prompts(model.cfg.vocab, seed=4)
    ref = RefEngine(jm, jparams, jold, max_slots=4, S_max=24)
    want, ref_logits = _swap_mid_flight(ref, prompts, jnew, np.asarray, RefRequest)
    eng = ContinuousBatchingEngine(model, params, old, max_slots=4, S_max=24)
    got, got_logits = _swap_mid_flight(eng, prompts, new, lambda t: t.numpy())
    assert got == want
    assert eng.policy is new and eng.steps == ref.steps == len(got_logits)
    _assert_close(got_logits, ref_logits, bound)


def test_captured_launches_are_taken_out_and_added_per_replay():
    kernels.reset_launches()
    kernels.LAUNCHES["posit_gemm"] = 5
    rec = kernels.CapturedLaunches()
    with rec:
        kernels.LAUNCHES["posit_gemm"] += 3
        kernels.LAUNCHES["posit_attention"] += 2
    assert kernels.LAUNCHES["posit_gemm"] == 5 and kernels.LAUNCHES["posit_attention"] == 0
    assert rec.counts["posit_gemm"] == 3 and rec.counts["posit_attention"] == 2
    assert sum(rec.counts.values()) == 5
    rec.replayed()
    rec.replayed()
    assert kernels.LAUNCHES["posit_gemm"] == 11 and kernels.LAUNCHES["posit_attention"] == 4
    kernels.reset_launches()


def test_captured_step_replays_once_a_call_over_its_own_tensors():
    """``CapturedStep.__call__`` with a stand-in graph (no card): one replay
    and one addition of the captured launches a call, the captured outputs
    returned, other tensors refused."""
    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    kernels.reset_launches()
    step = CapturedStep.__new__(CapturedStep)
    token, cache, logits = torch.zeros(4), {"lens": torch.zeros(4)}, torch.ones(4, 8)
    step.graph, step.args, step.out = Graph(), ({}, token, cache), (logits, cache)
    step.launches = kernels.CapturedLaunches()
    step.launches.counts = {"posit_gemm": 7, "posit_attention": 2}
    for n in (1, 2, 3):
        out = step(step.args[0], token, cache)
        assert out[0] is logits and out[1] is cache
        assert Graph.replays == n
        assert kernels.LAUNCHES["posit_gemm"] == 7 * n
        assert kernels.LAUNCHES["posit_attention"] == 2 * n
    with pytest.raises(ValueError, match="captured with"):
        step(step.args[0], token.clone(), cache)
    assert Graph.replays == 3
    kernels.reset_launches()


def test_counters_are_not_allocated_or_grown_during_a_capture(monkeypatch):
    dev, stream, capturing = torch.device("cpu"), 0x5eed, [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    try:
        buf = kernels.zeroed_counters(dev, stream, 100)
        capturing[0] = True
        assert kernels.zeroed_counters(dev, stream, buf.numel()) is buf
        with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
            kernels.zeroed_counters(dev, stream, buf.numel() + 1)
        with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
            kernels.zeroed_counters(dev, stream + 1, 1)
    finally:
        kernels._COUNTERS.pop((0, stream), None)
        kernels._COUNTERS.pop((0, stream + 1), None)
