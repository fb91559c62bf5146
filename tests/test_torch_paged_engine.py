"""The paged prefix-sharing engine (``launch/paged_engine.py``) on the CPU,
on yi-34b ``--reduced`` with p8_0 KV and bf16 compute (the reference's
``paged_setup``, tests/test_paged_kv.py), the reference's params converted
bit for bit.

* Against the reference's paged engine: the same token streams, every
  decode step's logits of the active rows within 0.05 (the P8_SERVE bound
  of tests/test_torch_engine_graph.py: bf16 activations and p8 K/V, where
  one flipped rounding moves a logit ~1e-2), the same prefix counters; a
  pool too small for every request at once queues them the same way and no
  stream ends ``cache_full``; a fork streams like the reference's.
* The port's own contracts: a prefix-hit (warm) admission decodes bit for
  bit like the cold one; paged serving equals the port's slot grid bit for
  bit (tokens and every step's logits; the CPU plain versions see the same
  cache shape when W * bt = S_max); a fork's two greedy streams are equal,
  through copy-on-write; ``inject_nar_into`` on a shared prefix stays in
  its slot; ``_quarantine`` scrubs private blocks only.
* The slot grid with its new hooks (``_can_admit``, ``_prepare_decode``,
  ``_release_slot``, ``_quarantine``, ``inject_nar_into``) serves the
  reference grid's tokens, and ``serve --paged`` the grid's.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.launch.engine import ContinuousBatchingEngine as RefEngine
from repro.launch.engine import Request as RefRequest
from repro.launch.paged_engine import PagedContinuousBatchingEngine as RefPaged
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import pcsr
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.engine import ContinuousBatchingEngine, Request
from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine
from repro_torch.models.registry import build_model

ARCH = "yi-34b"
BOUND = 0.05
JPOL = jpcsr.TransPolicy.from_names(kv_cache="p8_0", compute_dtype="bf16", attn_impl="kernel")
POL = pcsr.TransPolicy.from_names(kv_cache="p8_0", compute_dtype="bf16", attn_impl="kernel")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_arch(ARCH).reduced()
    jm = jax_build(jcfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    cfg = get_arch(ARCH).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return (jm, jparams), (cfg, build_model(cfg, device="cpu"), params)


def _prompts(vocab, n, prompt_len, overlap):
    """The reference test's prompts: a shared head of ``overlap`` of each."""
    rng = np.random.default_rng(1234)
    n_shared = int(round(overlap * prompt_len))
    shared = rng.integers(0, vocab, size=n_shared)
    rng = np.random.default_rng(7)
    return [np.concatenate([shared, rng.integers(0, vocab, size=prompt_len - n_shared)])
            .astype(np.int32) for _ in range(n)]


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


def _drain(eng):
    while eng.queue or eng.active.any():
        if eng.queue and eng.free_slots():
            eng.admit(now=0.0)
        if eng.active.any():
            eng.step(now=0.0)
    return {c.rid: (list(c.tokens), c.finish_reason) for c in eng.completions}


def _serve(eng, prompts, gen, request=Request):
    for i, p in enumerate(prompts):
        eng.submit(request(rid=i, prompt=p, max_new_tokens=gen))
    return _drain(eng)


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert float(np.abs(g - w).max()) <= BOUND


def _bits(steps):
    return [s.view(np.int32) for s in steps]


@pytest.mark.parametrize("n_blocks", [32, None])
def test_paged_engine_matches_the_reference_paged_engine(setup, n_blocks):
    (jm, jparams), (cfg, model, params) = setup
    kw = dict(max_slots=4, S_max=64, page_bytes=2048, n_blocks=n_blocks)
    ref = RefPaged(jm, jparams, JPOL, **kw)
    eng = PagedContinuousBatchingEngine(model, params, POL, **kw)
    assert eng.geom.describe() == ref.geom.describe() and eng.n_blocks == ref.n_blocks
    prompts = _prompts(cfg.vocab, 6, 2 * eng.geom.block_tokens + 2, 0.9)
    want_logits = _recorded(ref, np.asarray)
    want = _serve(ref, prompts, 5, RefRequest)
    got_logits = _recorded(eng, lambda t: t.numpy())
    got = _serve(eng, prompts, 5)
    assert got == want
    assert eng.steps == ref.steps
    _close(got_logits, want_logits)
    assert eng.prefix_stats() == ref.prefix_stats()
    assert eng.prefix_stats()["hits"] == 5
    eng.manager.check_invariants()


def test_warm_prefix_hit_decodes_bit_for_bit(setup):
    """A prefix-hit admission reads claimed blocks where the cold one wrote
    fresh ones: the same tokens and the same logits, bit for bit."""
    _, (cfg, model, params) = setup
    eng = PagedContinuousBatchingEngine(model, params, POL, max_slots=2, S_max=64,
                                        page_bytes=2048, n_blocks=24)
    bt = eng.geom.block_tokens
    prompt = _prompts(cfg.vocab, 1, 2 * bt + 3, 1.0)[0]
    cold_logits = _recorded(eng, lambda t: t.numpy())
    cold = _serve(eng, [prompt], 5)[0]
    assert eng.prefix_stats()["hits"] == 0
    n_cold = len(cold_logits)
    eng.submit(Request(rid=1, prompt=prompt.copy(), max_new_tokens=5))
    warm = _drain(eng)[1]
    st = eng.prefix_stats()
    assert st["hits"] == 1 and st["hit_tokens"] == 2 * bt
    assert warm == cold
    for c, w in zip(_bits(cold_logits[:n_cold]), _bits(cold_logits[n_cold:])):
        np.testing.assert_array_equal(c, w)
    eng.manager.check_invariants()


def test_lifetime_reservation_queues_like_the_reference(setup):
    """6 blocks, each lifetime 2: at most 3 requests at once, 4 submitted;
    the fourth queues, and no admitted stream ends ``cache_full``."""
    (jm, jparams), (cfg, model, params) = setup
    kw = dict(max_slots=4, S_max=64, page_bytes=2048, n_blocks=6)
    ref = RefPaged(jm, jparams, JPOL, **kw)
    eng = PagedContinuousBatchingEngine(model, params, POL, **kw)
    prompts = _prompts(cfg.vocab, 4, eng.geom.block_tokens + 2, 0.0)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
    assert eng.admit() == 3 and len(eng.queue) == 1
    done = _drain(eng)
    assert done == _serve(ref, prompts, 4, RefRequest)
    for rid, (toks, reason) in done.items():
        assert reason == "max_new" and len(toks) == 4, (rid, done[rid])
    eng.manager.check_invariants()
    assert int((eng.manager.refcount > 0).sum()) == 0


def test_fork_copy_on_write_streams(setup):
    """A mid-decode fork aliases every block; both greedy streams finish
    equal, through copy-on-write, and match the reference's fork."""
    (jm, jparams), (cfg, model, params) = setup
    kw = dict(max_slots=2, S_max=64, page_bytes=2048, n_blocks=24)
    runs = []
    for eng, request in ((RefPaged(jm, jparams, JPOL, **kw), RefRequest),
                         (PagedContinuousBatchingEngine(model, params, POL, **kw), Request)):
        prompt = _prompts(cfg.vocab, 1, eng.geom.block_tokens + 1, 1.0)[0]
        eng.submit(request(rid=0, prompt=prompt, max_new_tokens=6))
        eng.admit(now=0.0)
        eng.step(now=0.0)
        assert eng.fork(0, 1) == 1
        runs.append((_drain(eng), eng.prefix_stats()))
    (want, want_st), (got, st) = runs
    assert got == want and st == want_st
    assert got[0] == got[1] and got[0][1] == "max_new"
    assert st["cow_copies"] >= 1
    with pytest.raises(ValueError, match="not in flight"):
        PagedContinuousBatchingEngine(model, params, POL, **kw).fork(5, 6)


@pytest.mark.parametrize("prompt_len,max_slots", [(34, 4), (32, 4), (21, 1)])
def test_paged_equals_the_slot_grid_bit_for_bit(setup, prompt_len, max_slots):
    """Same params, requests and schedule: the paged engine (bt 16, W * bt =
    S_max) and the port's slot grid emit the same tokens, and every decode
    step's logits of the active rows are the same bits."""
    _, (cfg, model, params) = setup
    prompts = _prompts(cfg.vocab, 6, prompt_len, 0.9)
    runs = []
    for eng in (ContinuousBatchingEngine(model, params, POL, max_slots=max_slots, S_max=64),
                PagedContinuousBatchingEngine(model, params, POL, max_slots=max_slots,
                                              S_max=64, page_bytes=2048)):
        steps = _recorded(eng, lambda t: t.numpy())
        runs.append((_serve(eng, prompts, 6), _bits(steps), eng.steps))
    (want, want_steps, n), (got, got_steps, m) = runs
    assert got == want and n == m == len(got_steps)
    for g, w in zip(got_steps, want_steps):
        np.testing.assert_array_equal(g, w)


def test_grid_hooks_leave_its_tokens_unchanged(setup, monkeypatch):
    """The grid with the new hooks serves the reference grid's requests:
    every decode step's logits within the bound and its greedy tokens the
    reference's wherever the reference's top-2 margin is clear of twice the
    bound (chip_smoke.py's ``check_small_model`` rule: at a near tie, ~2e-3
    here, a bf16 rounding may pick the other token); it calls
    ``_prepare_decode`` once a step and ``_release_slot`` once an eviction,
    and ``_can_admit`` never holds it."""
    (jm, jparams), (cfg, model, params) = setup
    prompts = _prompts(cfg.vocab, 6, 20, 0.5)
    ref = RefEngine(jm, jparams, JPOL, max_slots=4, S_max=32)
    want_logits = _recorded(ref, np.asarray)
    want = _serve(ref, prompts, 5, RefRequest)
    eng = ContinuousBatchingEngine(model, params, POL, max_slots=4, S_max=32)
    calls = {"prepare": 0, "release": 0}
    monkeypatch.setattr(eng, "_prepare_decode",
                        lambda now: calls.__setitem__("prepare", calls["prepare"] + 1))
    monkeypatch.setattr(eng, "_release_slot",
                        lambda slot: calls.__setitem__("release", calls["release"] + 1))
    got_logits = _recorded(eng, lambda t: t.numpy())
    got = _serve(eng, prompts, 5)
    _close(got_logits, want_logits)
    for g, w in zip(got_logits, want_logits):
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BOUND
        assert (g.argmax(-1) == w.argmax(-1))[clear].all()
    assert {r: (len(t), why) for r, (t, why) in got.items()} == \
        {r: (len(t), why) for r, (t, why) in want.items()}
    assert calls == {"prepare": eng.steps, "release": 6}
    assert eng._can_admit(Request(rid=9, prompt=prompts[0]))
    eng.reset()
    with pytest.raises(ValueError, match="exceeds S_max"):
        eng.submit(Request(rid=9, prompt=prompts[0], max_new_tokens=20))
        eng.admit()


@pytest.mark.parametrize("paged", [False, True], ids=["grid", "paged"])
def test_inject_nar_into_stays_in_its_slot(setup, paged):
    """Two requests sharing a 2-block prefix; NaR injected into slot 0 before
    the first step: slot 0's logits go non-finite, slot 1 serves the tokens
    it serves without the fault (the paged engine copies the shared tail
    before poisoning it)."""
    _, (cfg, model, params) = setup
    kw = dict(max_slots=2, S_max=64)
    make = ((lambda: PagedContinuousBatchingEngine(model, params, POL, page_bytes=2048, **kw))
            if paged else (lambda: ContinuousBatchingEngine(model, params, POL, **kw)))
    prompts = _prompts(cfg.vocab, 2, 32, 1.0)
    prompts[1] = prompts[1].copy()
    prompts[1][-1] = (prompts[1][-1] + 1) % cfg.vocab
    clean = _serve(make(), prompts, 5)
    eng = make()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=5))
    eng.admit()
    if paged:
        assert eng.prefix_stats()["hits"] == 1
        shared = eng.manager.tables[0][0]
        assert eng.manager.tables[1][0] == shared
        before = eng.cache["kv"]["k"][:, shared].clone()
    eng.inject_nar_into(0, 3)
    if paged:   # the tail (block 1) was published: copied before it was poisoned
        assert eng.prefix_stats()["cow_copies"] == 1
        assert torch.equal(eng.cache["kv"]["k"][:, shared], before)
    done = _drain(eng)
    assert eng.nonfinite_rows > 0
    assert done[1] == clean[1]


def test_inject_nar_into_a_shared_tail_copies_it_first(setup):
    """A prompt of exactly two blocks: its tail is published and shared, so
    the injection copies it (copy-on-write) and the other slot's tail keeps
    its codes."""
    _, (cfg, model, params) = setup
    eng = PagedContinuousBatchingEngine(model, params, POL, max_slots=2, S_max=64,
                                        page_bytes=2048)
    prompt = _prompts(cfg.vocab, 1, 2 * eng.geom.block_tokens, 1.0)[0]
    for i in range(2):
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=4))
    eng.admit()
    tail = eng.manager.tables[1][-1]
    assert eng.manager.tables[0][-1] == tail
    before = eng.cache["kv"]["v"][:, tail].clone()
    eng.inject_nar_into(0, 2)
    assert eng.prefix_stats()["cow_copies"] == 1 and eng.manager.tables[0][-1] != tail
    assert torch.equal(eng.cache["kv"]["v"][:, tail], before)
    assert int(eng.cache["table"][0, 1]) == eng.manager.tables[0][-1]
    poisoned = eng.cache["kv"]["v"][:, eng.manager.tables[0][-1], :, :2]
    assert bool((poisoned == 0x80).all())
    eng.manager.check_invariants()


def test_quarantine_scrubs_private_blocks_only(setup):
    _, (cfg, model, params) = setup
    eng = PagedContinuousBatchingEngine(model, params, POL, max_slots=2, S_max=64,
                                        page_bytes=2048)
    prompt = _prompts(cfg.vocab, 1, 2 * eng.geom.block_tokens + 5, 1.0)[0]
    for i in range(2):
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=4))
    eng.admit()
    shared, private = eng.manager.tables[0][0], eng.manager.tables[0][-1]
    kept = eng.cache["kv"]["k"][:, shared].clone()
    eng._quarantine(0, 0.0)
    assert not eng.active[0] and eng.completions[-1].finish_reason == "numerics"
    assert bool((eng.cache["kv"]["k"][:, private] == 0).all())
    assert torch.equal(eng.cache["kv"]["k"][:, shared], kept)
    assert (eng.cache["table"][0] == eng.n_blocks).all()
    grid = ContinuousBatchingEngine(model, params, POL, max_slots=2, S_max=64)
    for i in range(2):
        grid.submit(Request(rid=i, prompt=prompt, max_new_tokens=4))
    grid.admit()
    grid._quarantine(1, 0.0)
    assert bool((grid.cache["kv"]["k"][:, 1] == 0).all())
    assert bool((grid.cache["kv"]["k"][:, 0] != 0).any())


def test_paged_rejects_a_family_without_a_paged_step(setup):
    _, (cfg, model, params) = setup
    bare = dataclasses.replace(model, decode_step_paged=None)
    with pytest.raises(ValueError, match="no paged decode path"):
        PagedContinuousBatchingEngine(bare, params, POL, max_slots=2, S_max=64)


def test_serve_paged_matches_the_grid_on_the_cpu(capsys):
    kw = dict(reduced=True, requests=5, prompt_len=20, gen=4, max_slots=2, device="cpu")
    grid = serve_mod.serve(ARCH, policy="p8-serve", **kw)
    paged = serve_mod.serve(ARCH, policy="p8-serve", paged=True, page_bytes=2048, **kw)
    assert paged["mode"] == "paged" and "prefix_cache" in paged and "prefix_cache" not in grid
    assert paged["sample_tokens"] == grid["sample_tokens"]
    assert paged["completion_tokens"] == grid["completion_tokens"]
    assert paged["prefix_cache"]["block_tokens"] == 2048 // (2 * 2 * 32)
    with pytest.raises(SystemExit):
        serve_mod.main(["--arch", ARCH, "--reduced", "--paged", "--device", "cpu"])
    assert "add --continuous" in capsys.readouterr().err
