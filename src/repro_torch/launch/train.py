"""Training entry point: config -> model -> policy -> data pipeline -> AdamW
(posit moments optional) -> the train step, on one device.

    python -m repro_torch.launch.train --arch phi3-mini-3.8b --reduced \
        --steps 3 --batch 4 --seq 32 --policy p16-train --device cpu

Runs on the CUDA device unless ``--device cpu``. ``--layers N`` keeps the
config's first N layers (a depth cut, to fit a card's memory at full
width). Every stdout line is a JSON object: ``train/step`` (the step's
metrics) every ``--log-every`` steps and at the last, then ``train/done``.
The reference's checkpointing, fault-tolerance and observability flags are
not ported yet; given one, it exits with an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from repro_torch.configs import get_arch
from repro_torch.core.device import resolve_device
from repro_torch.core.pcsr import parse_policy
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, adamw_init

# the reference's flags that need modules the port does not have yet
NOT_PORTED = {
    "--ckpt-dir": "checkpoint/ckpt.py and ft/runtime.py",
    "--save-every": "checkpoint/ckpt.py and ft/runtime.py",
    "--metrics-out": "obs/metrics.py",
    "--trace-out": "obs/trace.py",
    "--profile-out": "obs/prof.py",
    "--telemetry-every": "obs/train.py",
    "--step-log": "obs/train.py",
    "--calibration": "obs/train.py",
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers of the config (0: all)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--policy", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    for flag, needs in NOT_PORTED.items():
        ap.add_argument(flag, default=None, help=f"not ported yet (needs {needs})")
    args = ap.parse_args(argv)
    for flag, needs in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag} is not ported yet: it needs {needs} "
                     "(ROADMAP Queue 1 items 5-6)")

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    device = resolve_device(args.device)
    policy = parse_policy(args.policy)
    model = build_model(cfg, device=device)
    opt_cfg = AdamWConfig(lr=args.lr, moment_fmt=policy.optimizer)
    pipe = SyntheticLMPipeline(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                               seed=args.seed, device=device)
    # first, so a family that does not train (moe) is refused before its draw
    train_step = make_train_step(model, policy, opt_cfg, warmup=max(args.steps // 10, 1),
                                 total_steps=args.steps)
    params = model.init(args.seed)
    opt_state = adamw_init(params, opt_cfg)

    t0 = time.perf_counter()
    for step in range(args.steps):
        params, opt_state, metrics = train_step(params, opt_state, pipe.batch_at(step), step)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            print(json.dumps({"kind": "train/step", **m}), flush=True)
    print(json.dumps({"kind": "train/done", "done": args.steps,
                      "wall_s": round(time.perf_counter() - t0, 1)}), flush=True)
    return {"params": params, "opt": opt_state}


if __name__ == "__main__":
    main()
