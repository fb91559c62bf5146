"""``serve.py``'s static mode on the CPU (plain kernel versions): one lockstep
batch, prefilled (dense, moe) or encoded and teacher-forced (whisper), then
greedy decode steps, as the reference's ``_serve_static``; the refusals the
reference keeps (``--paged`` without ``--continuous``, ``--continuous`` on
a family without a prefill, an engine over such a family)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.pcsr import P8_SERVE
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.engine import ContinuousBatchingEngine, Request
from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine
from repro_torch.models.registry import build_model


def _lines(capsys) -> list:
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()]


def test_whisper_static_cli(capsys):
    serve_mod.main(["--arch", "whisper-medium", "--reduced", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "8", "--gen", "4"])
    prefill, report = _lines(capsys)
    assert prefill["kind"] == "serve/prefill" and prefill["mode"] == "static"
    assert prefill["prefill_s"] > 0
    assert report["kind"] == "serve/report" and report["mode"] == "static"
    assert report["arch"] == "whisper-medium-smoke" and report["batch"] == 2
    assert len(report["sample_tokens"]) == 4
    assert all(0 <= t < 512 for t in report["sample_tokens"])
    assert report["nonfinite_logit_rows"] == 0 and report["kv_nar_codes"] == 0
    assert report["decode_steps"] == 3 and report["decode_tok_per_s"] > 0
    assert report["compile_s"] > 0
    # K/V of the self caches (S_max = 12 rows) and the cross caches (24
    # frames): layers x K,V x B x Hkv x rows x hd at 1 B a code
    cfg = get_arch("whisper-medium").reduced()
    kv = cfg.n_layers * 2 * 2 * cfg.n_kv * cfg.hd
    assert report["kv_cache_bytes"] == kv * (12 + cfg.enc_frames)
    # plus every layer's two lengths, pos and lens
    assert report["cache_bytes_total"] == report["kv_cache_bytes"] + 4 * (
        2 * cfg.n_layers * 2 + 1 + 2)
    assert report["weight_bytes_policy"] * 4 == report["weight_bytes_f32"]
    assert set(report["kernel_launches"].values()) == {0}


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "olmoe-1b-7b", "whisper-medium"])
def test_static_serve_every_served_family(arch):
    events = []
    report = serve_mod.serve_static(arch, reduced=True, batch=3, prompt_len=6, gen=5,
                                    device="cpu", emit=events.append)
    assert [e["kind"] for e in events] == ["serve/prefill", "serve/report"]
    assert all(e["mode"] == "static" for e in events)
    assert report["decode_steps"] == (4 if arch == "whisper-medium" else 3)
    assert len(report["sample_tokens"]) == 5 and report["nonfinite_logit_rows"] == 0


def test_dense_static_matches_the_continuous_engine():
    """The same prompts (drawn as static mode draws them), all at t = 0,
    through static mode and through the port's continuous engine at as many
    slots: the same greedy tokens, row for row."""
    cfg = get_arch("qwen2.5-14b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, P8_SERVE)
    B, L, G = 3, 10, 6
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (B, L))
    run = serve_mod.generate_static(model, params, P8_SERVE, prompts, G)
    assert run["tokens"].shape == (B, G) and run["timed_steps"] == G - 2
    eng = ContinuousBatchingEngine(model, params, P8_SERVE, max_slots=B, S_max=L + G)
    done = eng.run([Request(rid=i, prompt=prompts[i].astype(np.int32), max_new_tokens=G)
                    for i in range(B)])
    for c in done:
        assert c.tokens == run["tokens"][c.rid].tolist(), c.rid


def test_whisper_static_is_the_teacher_forced_loop():
    """generate_static on whisper: init_cache on the frames, the prompt fed
    through decode_step token by token, then greedy steps, bit for bit a
    plain loop over the model's entry points."""
    cfg = get_arch("whisper-medium").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(1, P8_SERVE)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab, (2, 5))
    frames = torch.from_numpy(rng.normal(0, 1, (2, cfg.enc_frames, cfg.d_model))
                              .astype(np.float32))
    run = serve_mod.generate_static(model, params, P8_SERVE, prompts, 4, frames=frames)
    cache = model.init_cache(params, {"frames": frames}, P8_SERVE, 9)
    for i in range(5):
        logits, cache = model.decode_step(params, torch.as_tensor(prompts[:, i],
                                                                  dtype=torch.int32),
                                          cache, P8_SERVE)
    want = [torch.argmax(logits, -1).to(torch.int32)]
    for _ in range(3):
        logits, cache = model.decode_step(params, want[-1], cache, P8_SERVE)
        want.append(torch.argmax(logits, -1).to(torch.int32))
    assert torch.equal(run["tokens"], torch.stack(want, 1))
    assert run["timed_steps"] == 3
    assert run["cache"]["lens"].tolist() == [8, 8] and int(run["cache"]["pos"]) == 8
    for c in ("self", "cross"):
        for kv in ("k", "v", "len"):
            assert torch.equal(run["cache"][c][kv], cache[c][kv]), (c, kv)
    assert (run["cache"]["cross"]["len"] == cfg.enc_frames).all()


def test_bind_hook_sees_the_persistent_buffers(monkeypatch):
    """The step is bound once, over one token row and the cache it advances;
    every call passes those same tensors (what a captured graph needs)."""
    cfg = get_arch("whisper-medium").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, P8_SERVE)
    seen = {}

    def bind(decode, args, state, device):
        seen.update(args=args, state=state, calls=0)

        def step(*call):
            assert all(a is b for a, b in zip(call, args))
            seen["calls"] += 1
            return decode(*call)
        return step

    monkeypatch.setattr(serve_mod, "bind_step", bind)
    frames = np.zeros((2, cfg.enc_frames, cfg.d_model), np.float32)
    run = serve_mod.generate_static(model, params, P8_SERVE, np.ones((2, 3), np.int64), 3,
                                    frames=frames)
    assert seen["calls"] == 3 + 2
    cache = run["cache"]
    assert seen["args"][2] is cache and seen["args"][1].dtype == torch.int32
    assert {id(t) for t in seen["state"]} == {id(cache["lens"]), id(cache["pos"]),
                                              id(cache["self"]["len"]),
                                              id(cache["cross"]["len"])}


def test_continuous_whisper_exits_with_the_references_words():
    with pytest.raises(SystemExit, match="--continuous needs a prefill entry point"):
        serve_mod.main(["--arch", "whisper-medium", "--reduced", "--device", "cpu",
                        "--continuous"])


def test_paged_needs_continuous(capsys):
    with pytest.raises(SystemExit):
        serve_mod.main(["--arch", "whisper-medium", "--reduced", "--paged", "--device", "cpu"])
    assert "add --continuous" in capsys.readouterr().err


@pytest.mark.parametrize("engine", [ContinuousBatchingEngine, PagedContinuousBatchingEngine])
def test_engines_refuse_a_model_without_prefill(engine):
    model = build_model(get_arch("whisper-medium").reduced(), device="cpu")
    with pytest.raises(ValueError, match="family 'whisper' has no prefill entry point"):
        engine(model, {}, P8_SERVE, max_slots=2, S_max=16)


def test_kv_bytes_count_every_kv_container():
    """kv_cache_bytes counts the k/v leaves of "kv", "self" and "cross";
    cache_bytes every leaf."""
    def t(n, dtype=torch.uint8):
        return torch.zeros((n,), dtype=dtype)

    cache = {"self": {"k": t(10), "v": t(10), "len": t(2, torch.int32)},
             "cross": {"k": t(30), "v": t(30), "len": t(2, torch.int32)},
             "pos": t(1, torch.int32), "lens": t(2, torch.int32)}
    assert serve_mod.kv_cache_bytes(cache) == 80
    assert serve_mod.cache_bytes(cache) == 80 + 4 * 7
    assert serve_mod.kv_cache_bytes({"kv": {"k": t(5, torch.uint16), "v": t(5, torch.uint16)},
                                     "table": t(9, torch.int32)}) == 20
