"""Serving CLI: a static lockstep batch, or continuous batching over the
ragged posit KV cache.

    # static batch: prefill (dense, moe) or the encoder and a teacher-forced
    # decoder prompt (whisper), then greedy decode steps in lockstep
    python -m repro_torch.launch.serve --arch whisper-medium --batch 4 \
        --prompt-len 32 --gen 32 --policy p8-serve

    # continuous batching (launch/engine.py)
    python -m repro_torch.launch.serve --arch qwen2.5-14b --continuous \
        --max-slots 4 --requests 8 --prompt-len 64 --gen 16 --policy p8-serve \
        --precision-policy attn-p16-mlp-p8

Static mode (the default, as in the reference) serves ``--batch`` prompts
drawn from ``--seed``: the dense and moe families prefill them in one
batch; whisper runs its encoder once over seeded frames (B, 1,500, d) and
feeds the prompt through ``decode_step`` token by token. The decode step
replays one captured CUDA graph (``launch/engine.py`` ``CapturedStep``);
its first call, the capture, is timed as ``compile_s`` apart from
``decode_tok_per_s``. Decoding is greedy.

``--precision-policy`` schedules per-layer weight formats over the
``--policy`` base (which keeps every other role: KV cache, compute dtype):
a preset name, a ``pattern=fmt[@es][:packed],...`` spec, or
``@artifact.json`` (core/policy.py). Weights are random, drawn from
``--seed`` on the device, and quantized to each layer's format as they are
drawn (packed p8 lanes where the layer's rule packs). Every stdout line is one
JSON object with a ``"kind"`` key: ``serve/prefill`` (static mode: one line,
the batch's prefill time; continuous: one a request), then one
``serve/report`` (tokens/s, per-token latency percentiles in continuous
mode, KV bytes per token, linear-weight bytes under the policy and in f32,
kernel launches during the run, and the KV cache's decoded health). Runs on
the CUDA device unless ``--device cpu``.

``--calibrate N`` runs the calibration plane (``calib/``, DESIGN.md §11)
before serving, in either mode: the weights are drawn as floats from
``--seed`` on the device, the model's loss runs under the ``--policy`` base
over N seeded batches of ``--batch`` x ``--prompt-len`` tokens with an
observer streaming every linear's weight and activation histograms, the
byte-budgeted search (``--weight-byte-budget``: ``1.5x`` the p8 floor, or
bytes; default the floor, the ``p8-weights`` preset's bytes) picks each
site's format and es, the weights are quantized under the emitted policy
(the f32 masters freed) and served under it. It prints one
``serve/calibration`` line; ``--policy-out cal.json`` saves the artifact
(one ``serve/policy-out`` line), which ``--precision-policy @cal.json``
serves again::

    python -m repro_torch.launch.serve --arch phi3-mini-3.8b --continuous \
        --calibrate 4 --policy-out cal.json

Calibration needs the model's loss: the whisper family is refused.

``--paged`` serves through the paged prefix-sharing engine
(``launch/paged_engine.py``, with ``--continuous``): ``--page-bytes`` is a
layer's K+V bytes of one page (the default 2,048 is one token a page at
qwen2.5-14b's full width at p8; 32,768 is 16), ``--n-blocks`` the pool's
size (default: the slot grid's byte budget); the report then carries
``prefix_cache``. The reference's observability and fault-tolerance flags
are not ported.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import get_arch
from repro_torch.core.pcsr import TransPolicy, parse_policy
from repro_torch.core.policy import get_precision_policy
from repro_torch.kernels.posit_codec import ops as codec_ops
from repro_torch.launch.engine import (CapturedStep, ContinuousBatchingEngine, Request,
                                       poisson_requests)
from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine
from repro_torch.models import transformer
from repro_torch.models.layers import policy_weight_bytes, quantize_params
from repro_torch.models.registry import build_model


def percentile_ms(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q) * 1e3) if values else 0.0


# the cache containers whose "k"/"v" leaves are K/V arrays (the reference's
# launch/engine.py KV_CONTAINERS, less the families the port lacks, and
# gemma3's rolling buffers, which the reference keeps in "kv")
KV_CONTAINERS = transformer.KV_STACKS + ("self", "cross")


def _leaves(tree, keys=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + (k,))
    elif isinstance(tree, torch.Tensor):
        yield keys, tree


def _kv_arrays(cache: dict) -> list:
    """The K/V arrays of a cache: leaves named ``k``/``v`` inside a KV
    container (not the lengths, not the block table)."""
    return [t for keys, t in _leaves(cache)
            if keys and keys[-1] in ("k", "v") and any(k in KV_CONTAINERS for k in keys[:-1])]


def cache_bytes(cache: dict) -> int:
    """Bytes of every tensor in the cache (bookkeeping included)."""
    return sum(t.numel() * t.element_size() for _, t in _leaves(cache))


def kv_cache_bytes(cache: dict) -> int:
    """Bytes of the K/V arrays only (no length bookkeeping)."""
    return sum(t.numel() * t.element_size() for t in _kv_arrays(cache))


def kv_health(cache: dict, policy: TransPolicy) -> dict:
    """Decode the whole K/V cache through the codec kernel: NaR codes (which
    decode to NaN) and the largest magnitude held. Empty for a float cache."""
    fmt = policy.kv_cache
    if fmt is None:
        return {}
    nar = 0
    absmax = 0.0
    for codes in _kv_arrays(cache):
        if codes.numel() == 0:     # a stack with no layer (a reduced gemma3 has no global)
            continue
        vals = codec_ops.decode(codes, fmt.es, nbits=fmt.nbits)
        nar += int(torch.isnan(vals).sum())
        absmax = max(absmax, float(torch.nan_to_num(vals, nan=0.0).abs().max()))
    return {"kv_nar_codes": nar, "kv_absmax": absmax}


def build_policy(policy: str = "p8-serve", precision_policy: Optional[str] = None):
    """The serving policy: ``policy`` (parse_policy's grammar), with
    ``precision_policy`` (a preset, a spec or ``@artifact.json``) scheduling
    the weights over it when given."""
    pol = parse_policy(policy)
    return pol if not precision_policy else get_precision_policy(precision_policy, base=pol)


def calibrate(model, params, policy, *, n: int, batch: int, seq: int, seed: int,
              weight_byte_budget=None, policy_out: Optional[str] = None,
              emit: Callable[[dict], None]) -> tuple:
    """observe -> search -> (optionally) persist, the reference's
    ``_calibrate``: ``model.loss`` under ``policy``'s base over
    ``calibration_batches(cfg, default_rng(seed), n, batch, seq)`` on the
    float ``params``. Emits ``serve/calibration`` (and ``serve/policy-out``
    with ``policy_out``); returns (the calibrated PrecisionPolicy, report).
    Any per-layer rules of ``policy`` are superseded by the calibrated
    schedule."""
    from repro_torch.calib.search import calibrate_model, calibration_batches, save_artifact

    cfg = model.cfg
    base = policy.base if hasattr(policy, "base") else policy
    batches = calibration_batches(cfg, np.random.default_rng(seed), n, batch=batch, seq=seq,
                                  device=model.device)
    # the loss, not the forward: it reaches the lm_head projection, which
    # serving decodes through at every step
    cal_policy, report = calibrate_model(
        lambda b: model.loss(params, b, base)[0], batches, params, base=base,
        byte_budget=weight_byte_budget, name=f"calibrated-{cfg.name}")
    emit({"kind": "serve/calibration", "calibration": {
        k: report[k] for k in ("n_sites", "p8_floor_bytes", "byte_budget", "weight_bytes",
                               "predicted_err_score")}})
    if policy_out:
        save_artifact(policy_out, cal_policy, report)
        emit({"kind": "serve/policy-out", "policy_out": policy_out})
    return cal_policy, report


def init_params(model, policy, seed: int, calibration: Optional[dict] = None,
                emit: Callable[[dict], None] = None) -> tuple:
    """The served params and policy: drawn from ``seed`` and quantized layer
    by layer under ``policy``; with ``calibration`` (``calibrate``'s
    keywords ``n``, ``batch``, ``seq``, ``weight_byte_budget``,
    ``policy_out``) drawn as floats, calibrated, quantized under the
    calibrated policy, the f32 masters dropped."""
    if not calibration:
        return model.init(seed, policy), policy
    if model.cfg.family not in transformer.DECODER_FAMILIES:
        sys.exit(f"--calibrate drives the model's loss, which the {model.cfg.family} family "
                 "does not have in the port (ROADMAP Queue 1 item 5b)")
    params = model.init(seed)
    policy, _ = calibrate(model, params, policy, seed=seed, emit=emit, **calibration)
    return quantize_params(params, policy), policy


def serve(arch: str, *, policy: str = "p8-serve", precision_policy: Optional[str] = None,
          reduced: bool = False, max_slots: int = 4, requests: int = 8, prompt_len: int = 64, gen: int = 16,
          arrival_rate: float = 0.0, temperature: float = 0.0, top_k: int = 0,
          seed: int = 0, paged: bool = False, page_bytes: int = 2048,
          n_blocks: Optional[int] = None, calibration: Optional[dict] = None, device="cuda",
          emit: Callable[[dict], None] = None) -> dict:
    """Build ``arch`` from ``seed``, serve ``requests`` through the
    continuous-batching engine (the paged one with ``paged``) and return the
    report (also emitted). With ``calibration``, calibrate first
    (``init_params``)."""
    emit = emit or (lambda ev: print(json.dumps(ev), flush=True))
    cfg = get_arch(arch)
    cfg = cfg.reduced() if reduced else cfg
    pol = build_policy(policy, precision_policy)
    model = build_model(cfg, device=device)
    if model.prefill is None:
        sys.exit(f"--continuous needs a prefill entry point (family {cfg.family!r} has none)")
    if paged and model.decode_step_paged is None:
        sys.exit(f"--paged: {transformer.no_paged_path(cfg.family)}")
    t0 = time.perf_counter()
    params, pol = init_params(model, pol, seed, calibration, emit)
    weight_report = policy_weight_bytes(params, pol)
    S_max = prompt_len + gen
    common = dict(max_slots=max_slots, S_max=S_max, temperature=temperature, top_k=top_k,
                  seed=seed)
    if paged:
        eng = PagedContinuousBatchingEngine(model, params, pol, page_bytes=page_bytes,
                                            n_blocks=n_blocks, **common)
    else:
        eng = ContinuousBatchingEngine(model, params, pol, **common)
    # warm up (kernel builds and loads, allocator) before the serving clock
    eng.submit(Request(rid=-1, prompt=np.zeros((prompt_len,), np.int32),
                       max_new_tokens=min(3, gen)))
    eng.admit()
    eng.step()
    eng.reset(seed=seed)
    _sync(model.device)
    setup_s = time.perf_counter() - t0

    reqs = poisson_requests(requests, arrival_rate=arrival_rate, prompt_lens=(prompt_len,),
                            max_new_tokens=gen, vocab=cfg.vocab, seed=seed)
    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    completions = eng.run(reqs)
    _sync(model.device)
    makespan = max(time.perf_counter() - t0, 1e-9)
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}

    for c in sorted(completions, key=lambda c: c.rid):
        emit({"kind": "serve/prefill", "rid": c.rid, "prompt_len": c.prompt_len,
              "prefill_ms": (c.token_times[0] - c.admitted_time) * 1e3})
    n_tokens = sum(len(c.tokens) for c in completions)
    per_tok = [t for c in completions for t in c.per_token_s()[1:]]
    kv_b = kv_cache_bytes(eng.cache)
    report = {
        "kind": "serve/report",
        "arch": cfg.name,
        "policy": pol.describe(),
        "device": (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu"),
        "mode": "paged" if paged else "continuous",
        "requests": len(completions),
        "max_slots": max_slots,
        "arrival_rate": arrival_rate,
        "tokens": n_tokens,
        "decode_tok_per_s": n_tokens / makespan,
        "decode_steps": eng.steps,
        "makespan_s": makespan,
        "setup_s": setup_s,
        "p50_token_ms": percentile_ms(per_tok, 50),
        "p95_token_ms": percentile_ms(per_tok, 95),
        "p50_ttft_ms": percentile_ms([c.ttft_s for c in completions], 50),
        "kv_cache_bytes": kv_b,
        "kv_bytes_per_token": kv_b // (max_slots * eng.S_max),
        **weight_report,
        "kernel_launches": launches,
        "nonfinite_logit_rows": eng.nonfinite_rows,
        "completion_tokens": {c.rid: len(c.tokens) for c in completions},
        "sample_tokens": min(completions, key=lambda c: c.rid).tokens[:8] if completions else [],
        **kv_health(eng.cache, pol),
    }
    if hasattr(eng, "prefix_stats"):
        report["prefix_cache"] = eng.prefix_stats()
    emit(report)
    return report


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bind_step(decode: Callable, args: tuple, state: tuple, device: torch.device) -> Callable:
    """The static mode's decode program ``decode(*args)``: on a CUDA device
    captured in a CUDA graph over ``args`` (``CapturedStep``; ``state`` the
    tensors the step advances, put back after the warm-up), on the CPU the
    step itself, run eagerly."""
    if device.type != "cuda":
        return decode
    return CapturedStep(decode, args, state, torch.cuda.Stream(device))


def _advanced(cache: dict) -> tuple:
    """The tensors a decode step advances: the rows' positions, the step
    counter and every container's lengths."""
    return (cache["lens"], cache["pos"]) + tuple(
        t for keys, t in _leaves(cache) if keys[-1] == "len")


def generate_static(model, params, policy, tokens, gen: int, *, frames=None) -> dict:
    """The reference's static mode on ``model``: ``tokens`` (B, L) prompts in
    one lockstep batch, ``gen`` greedy tokens each. A family with a prefill
    entry point prefills the batch; whisper (no prefill) runs
    ``init_cache`` on ``frames`` (B, T, D), the encoder and the cross K/V,
    then feeds the prompt through ``decode_step``, teacher-forced. The
    decode step reads a persistent token row and the cache, and is bound
    once by ``bind_step`` (captured on the card); its first call is timed
    as ``compile_s``.

    Returns ``tokens`` (B, gen) int32, ``cache``, ``prefill_s`` (whisper:
    the encoder, the cross K/V and the prompt's steps but the first),
    ``compile_s``, ``decode_s`` and ``timed_steps`` (the steps after the
    first decoded token and the compile, as the reference counts them), and
    ``nonfinite_logit_rows`` (rows of any step whose logits held NaN/inf)."""
    dev = model.device
    tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.int32).to(dev)
    B, L = tokens.shape
    S_max = L + gen
    tok = torch.zeros((B,), dtype=torch.int32, device=dev)   # the step's token row
    bad = torch.zeros((), dtype=torch.int64, device=dev)

    def decode(p, t, cache):
        return model.decode_step(p, t, cache, policy)

    def run(step, cache, t):
        tok.copy_(t)
        logits, cache = step(params, tok, cache)
        bad.add_((~torch.isfinite(logits)).any(dim=-1).sum())
        return logits, cache

    step = None
    t0 = time.perf_counter()
    if model.prefill is None:
        cache = model.init_cache(params, {"frames": frames}, policy, S_max)
        tc = time.perf_counter()
        step = bind_step(decode, (params, tok, cache), _advanced(cache), dev)
        logits, cache = run(step, cache, tokens[:, 0])
        _sync(dev)
        compile_s = time.perf_counter() - tc
        for i in range(1, L):
            logits, cache = run(step, cache, tokens[:, i])
        _sync(dev)
        prefill_s = time.perf_counter() - t0 - compile_s
    else:
        logits, cache = model.prefill(params, tokens, policy, S_max=S_max)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        bad.add_((~torch.isfinite(logits)).any(dim=-1).sum())
    out = [torch.argmax(logits, dim=-1).to(torch.int32)]
    if step is None:
        tc = time.perf_counter()
        step = bind_step(decode, (params, tok, cache), _advanced(cache), dev)
        if gen > 1:
            logits, cache = run(step, cache, out[-1])
            out.append(torch.argmax(logits, dim=-1).to(torch.int32))
        _sync(dev)
        compile_s = time.perf_counter() - tc
    timed = max(gen - len(out), 0)
    t0 = time.perf_counter()
    for _ in range(timed):
        logits, cache = run(step, cache, out[-1])
        out.append(torch.argmax(logits, dim=-1).to(torch.int32))
    _sync(dev)
    return {"tokens": torch.stack(out[:gen], dim=1), "cache": cache, "prefill_s": prefill_s,
            "compile_s": compile_s, "decode_s": time.perf_counter() - t0,
            "timed_steps": timed, "nonfinite_logit_rows": int(bad)}


def serve_static(arch: str, *, policy: str = "p8-serve", precision_policy: Optional[str] = None,
                 reduced: bool = False, batch: int = 4, prompt_len: int = 32, gen: int = 16,
                 seed: int = 0, calibration: Optional[dict] = None, device="cuda",
                 emit: Callable[[dict], None] = None) -> dict:
    """Build ``arch`` from ``seed`` and serve one static batch of ``batch``
    prompts (``generate_static``): the prompts, then whisper's frames (B,
    enc_frames, d), drawn from ``np.random.default_rng(seed)`` in the
    reference's order. With ``calibration``, calibrate first
    (``init_params``). Emits one ``serve/prefill`` line and returns the
    report (also emitted)."""
    emit = emit or (lambda ev: print(json.dumps(ev), flush=True))
    cfg = get_arch(arch)
    cfg = cfg.reduced() if reduced else cfg
    pol = build_policy(policy, precision_policy)
    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params, pol = init_params(model, pol, seed, calibration, emit)
    weight_report = policy_weight_bytes(params, pol)
    _sync(model.device)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, prompt_len))
    frames = None
    if model.prefill is None:
        frames = torch.from_numpy(
            rng.normal(0, 1, (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    before = dict(kernels.LAUNCHES)
    run = generate_static(model, params, pol, tokens, gen, frames=frames)
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    emit({"kind": "serve/prefill", "mode": "static", "batch": batch, "prompt_len": prompt_len,
          "prefill_s": run["prefill_s"]})
    cache = run["cache"]
    kv_b = kv_cache_bytes(cache)
    report = {
        "kind": "serve/report",
        "arch": cfg.name,
        "policy": pol.describe(),
        "device": (torch.cuda.get_device_name(model.device)
                   if model.device.type == "cuda" else "cpu"),
        "mode": "static",
        "batch": batch,
        "prompt_len": prompt_len,
        "gen": gen,
        "decode_tok_per_s": batch * run["timed_steps"] / max(run["decode_s"], 1e-9),
        "decode_steps": run["timed_steps"],
        "compile_s": run["compile_s"],
        "prefill_s": run["prefill_s"],
        "setup_s": setup_s,
        "sample_tokens": run["tokens"][0, :8].tolist(),
        "kv_cache_bytes": kv_b,
        "cache_bytes_total": cache_bytes(cache),
        "kv_bytes_per_token": kv_b // (batch * (prompt_len + gen)),
        **weight_report,
        "kernel_launches": launches,
        "nonfinite_logit_rows": run["nonfinite_logit_rows"],
        **kv_health(cache, pol),
    }
    emit(report)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="the reduced (CI-sized) config")
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size (and the default --max-slots)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (launch/engine.py); static mode without it")
    ap.add_argument("--paged", action="store_true",
                    help="paged prefix-sharing KV cache (launch/paged_engine.py; "
                         "rides --continuous)")
    ap.add_argument("--page-bytes", type=int, default=2048,
                    help="a layer's K+V bytes of one KV page (paged mode; token "
                         "capacity follows the KV code width)")
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="KV pool size in blocks (paged mode; default: the slot "
                         "grid's byte budget)")
    ap.add_argument("--max-slots", type=int, default=None,
                    help="decode slots of the continuous engine (default: --batch)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="Poisson arrivals per second (0: all at t=0)")
    ap.add_argument("--policy", default="p8-serve",
                    help="none | p8-serve | role=fmt,...,compute=bf16")
    ap.add_argument("--precision-policy", default=None,
                    help="per-layer weight formats over --policy: a preset "
                         "(uniform-p16, p8-weights, p8-packed, attn-p16-mlp-p8), "
                         "a pattern=fmt[@es][:packed],... spec, or @artifact.json")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calibrate", type=int, default=0, metavar="N",
                    help="calibrate over N batches of --batch x --prompt-len tokens and "
                         "serve under the calibrated per-site policy")
    ap.add_argument("--weight-byte-budget", default=None,
                    help="calibration's weight-byte budget: a multiple of the p8 floor "
                         "('1.5x') or bytes (default: the floor)")
    ap.add_argument("--policy-out", default=None, metavar="CAL.json",
                    help="write the calibration artifact (--precision-policy @CAL.json "
                         "serves it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.paged and not args.continuous:
        ap.error("--paged rides the continuous-batching engine; add --continuous")
    if not args.calibrate and (args.policy_out or args.weight_byte_budget):
        ap.error("--policy-out / --weight-byte-budget require --calibrate N")
    common = dict(policy=args.policy, precision_policy=args.precision_policy,
                  reduced=args.reduced, prompt_len=args.prompt_len, gen=args.gen,
                  seed=args.seed, device=args.device,
                  calibration=dict(n=args.calibrate, batch=args.batch, seq=args.prompt_len,
                                   weight_byte_budget=args.weight_byte_budget,
                                   policy_out=args.policy_out) if args.calibrate else None)
    if not args.continuous:
        serve_static(args.arch, batch=args.batch, **common)
        return
    serve(args.arch, max_slots=args.max_slots or args.batch, requests=args.requests,
          arrival_rate=args.arrival_rate, temperature=args.temperature, top_k=args.top_k,
          paged=args.paged, page_bytes=args.page_bytes, n_blocks=args.n_blocks, **common)


if __name__ == "__main__":
    main()
