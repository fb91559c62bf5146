"""The gemma3 family through the port's engines and serving CLI on the CPU
(plain versions): the reduced gemma3-4b widened to 6 layers (layer 5
global, five local layers with rolling buffers of 16 rows), and the CLI's
``--reduced`` (2 local layers).

* Staggered admission ≡ isolated decoding, greedy, over rolling caches
  that wrap at different steps in different rows (prompts of 14 and 9
  tokens, 8 steps, ``kv_cache="p8_0"``): the port's own invariance, the
  counterpart of tests/test_engine.py's gemma3 test (the reference's ragged
  logits are not held here: ROADMAP Queue 3).
* ``max_slots=1`` (the B=1 prefill cache copied in whole) ≡ 2 slots.
* The engine's hooks reach both KV stacks: the state a captured step
  advances holds every stack's ``len``; ``_quarantine`` and
  ``inject_nar_into`` write the slot's rows in both.
* ``serve.py --arch gemma3-4b --reduced``: continuous and static mode, a
  prompt past the window, every stdout line one JSON object; ``--calibrate``;
  ``--paged`` refused with the registry's message.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.pcsr import P8_SERVE, TransPolicy
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.engine import ContinuousBatchingEngine, Request
from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine
from repro_torch.models import transformer
from repro_torch.models.registry import build_model

ARCH = "gemma3-4b"
S_MAX = 64
KV_P8 = TransPolicy.from_names(kv_cache="p8_0", attn_impl="kernel")


@pytest.fixture(scope="module")
def gemma3():
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), n_layers=6)
    model = build_model(cfg, device="cpu")
    return cfg, model, model.init(1)


class Recording(ContinuousBatchingEngine):
    """The grid engine, keeping the state its decode step is bound with."""

    def _bind_decode(self, decode, state):
        self.state = state
        super()._bind_decode(decode, state)


def _isolated(eng, rid, prompt, n):
    eng.reset()
    eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    eng.admit()
    while eng.active.any():
        eng.step()
    return eng.completions[0].tokens


def test_staggered_equals_isolated_over_rolling_caches(gemma3):
    cfg, model, params = gemma3
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, cfg.vocab, (14,)).astype(np.int32)
    p2 = rng.integers(0, cfg.vocab, (9,)).astype(np.int32)
    eng = ContinuousBatchingEngine(model, params, KV_P8, max_slots=2, S_max=S_MAX)
    eng.submit(Request(rid=0, prompt=p1, max_new_tokens=8))
    eng.admit()
    eng.step()
    eng.step()
    eng.submit(Request(rid=1, prompt=p2, max_new_tokens=8))
    eng.admit()
    while eng.active.any():
        eng.step()
    staggered = {c.rid: c.tokens for c in eng.completions}
    # both rows wrapped their local buffers (16 rows) mid-decode
    assert min(14, 9) + 8 > cfg.window
    assert staggered[0] == _isolated(eng, 0, p1, 8)
    assert staggered[1] == _isolated(eng, 1, p2, 8)
    assert all(len(t) == 8 for t in staggered.values())


def test_single_slot_engine_matches_multislot(gemma3):
    cfg, model, params = gemma3
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, (19,)).astype(np.int32)
    one = ContinuousBatchingEngine(model, params, KV_P8, max_slots=1, S_max=S_MAX)
    two = ContinuousBatchingEngine(model, params, KV_P8, max_slots=2, S_max=S_MAX)
    assert _isolated(one, 0, prompt, 6) == _isolated(two, 0, prompt, 6)


def test_hooks_cover_both_kv_stacks(gemma3):
    cfg, model, params = gemma3
    eng = Recording(model, params, P8_SERVE, max_slots=2, S_max=24)
    kv, local = eng.cache["kv"], eng.cache["kv_local"]
    assert kv["k"].shape[3] == 24 and local["k"].shape[3] == cfg.window
    assert any(t is kv["len"] for t in eng.state)
    assert any(t is local["len"] for t in eng.state)
    prompt = np.arange(20, dtype=np.int32)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng.admit()
    eng.step()
    assert (local["len"][:, 0] == cfg.window).all() and (kv["len"][:, 0] == 21).all()
    eng.inject_nar_into(0, 3)
    for stack in (kv, local):
        assert bool((stack["k"][:, 0, :, :3] == 0x80).all())
        assert not bool((stack["k"][:, 1] == 0x80).any())
    eng._quarantine(0, 0.0)
    assert eng.completions[-1].finish_reason == "numerics"
    for stack in (kv, local):
        assert not bool(stack["k"][:, 0].any()) and not bool(stack["v"][:, 0].any())


def _run(argv, capsys) -> list:
    serve_mod.main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert lines and all("kind" in ln for ln in lines)
    return lines


COMMON = ["--arch", ARCH, "--reduced", "--prompt-len", "20", "--gen", "4", "--device", "cpu"]


def test_serve_cli_continuous_and_static(capsys):
    cfg = get_arch(ARCH).reduced()
    lines = _run([*COMMON, "--continuous", "--requests", "3", "--max-slots", "2"], capsys)
    report = lines[-1]
    assert [ln["kind"] for ln in lines] == ["serve/prefill"] * 3 + ["serve/report"]
    assert report["mode"] == "continuous" and report["requests"] == 3
    assert all(n == 4 for n in report["completion_tokens"].values())
    assert report["nonfinite_logit_rows"] == 0 and report["kv_nar_codes"] == 0
    # two local layers, K and V, 2 slots, 2 KV heads, 16 rows of 32 codes at 1 B
    assert report["kv_cache_bytes"] == 2 * 2 * 2 * cfg.n_kv * cfg.window * cfg.hd
    assert set(report["kernel_launches"].values()) == {0}      # plain versions
    lines = _run([*COMMON, "--batch", "2"], capsys)
    assert [ln["kind"] for ln in lines] == ["serve/prefill", "serve/report"]
    static = lines[-1]
    assert static["mode"] == "static" and static["decode_steps"] == 2
    assert len(static["sample_tokens"]) == 4 and static["nonfinite_logit_rows"] == 0
    assert static["kv_nar_codes"] == 0


def test_serve_cli_calibrates_gemma3(capsys):
    lines = _run(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "20",
                  "--gen", "2", "--device", "cpu", "--continuous", "--requests", "2",
                  "--calibrate", "1"], capsys)
    cal = [ln for ln in lines if ln["kind"] == "serve/calibration"]
    assert len(cal) == 1 and cal[0]["calibration"]["n_sites"] >= 4
    assert lines[-1]["kind"] == "serve/report" and lines[-1]["requests"] == 2


def test_paged_is_refused(gemma3):
    _, model, params = gemma3
    assert model.init_paged_cache is None and model.decode_step_paged is None
    with pytest.raises(ValueError, match="no paged decode path"):
        PagedContinuousBatchingEngine(model, params, KV_P8, max_slots=2, S_max=32)
    with pytest.raises(SystemExit, match="no paged decode path"):
        serve_mod.main([*COMMON, "--continuous", "--paged"])
    with pytest.raises(ValueError, match="slot grid"):
        transformer.init_paged_cache(model.cfg, 1, 4, 16, 2, KV_P8, device="cpu")


def test_rolling_step_needs_the_rope_tables(gemma3):
    """A rolling layer writes at its position modulo the buffer, so it takes
    RoPE from the caller's tables and refuses to make them from ``pos``."""
    from repro_torch.models import attention as attn

    cfg, model, params = gemma3
    acfg = transformer.layer_attn_cfgs(cfg)[0]
    cache = transformer.init_cache(cfg, 1, 24, KV_P8, device="cpu")
    x = torch.zeros((1, 1, cfg.d_model))
    with pytest.raises(ValueError, match="RoPE tables"):
        attn.decode_attention_step(params["blocks"][0]["attn"], acfg, x,
                                   attn.layer_cache(cache["kv_local"], 0),
                                   torch.zeros(1, dtype=torch.int32), KV_P8, rolling=True)


def test_training_refuses_gemma3(gemma3):
    """The family's forward and loss run (calibration); its gradient is not
    held to the reference's, so the train step refuses it."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig

    _, model, _ = gemma3
    with pytest.raises(NotImplementedError, match="gemma3"):
        make_train_step(model, P8_SERVE, AdamWConfig())
