"""The train step: loss and gradients, global-norm clipping, the cosine
schedule and AdamW (posit moments optional), on one device.

``grad_sync="gspmd"`` is the reference's single-program step; on one
device it is the step itself. ``"posit_pod"`` (posit-compressed gradient
all-reduce across pods) needs ``distributed/collectives.py``, which is not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pcsr import TransPolicy
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWConfig, adamw_update, clip_by_global_norm, cosine_warmup

_NAR_INT = {torch.uint8: (torch.int8, -(1 << 7)), torch.uint16: (torch.int16, -(1 << 15))}


def _nonfinite_count(tree) -> torch.Tensor:
    """Elements that are NaN/inf (float leaves) or posit NaR (uint8/uint16
    code leaves: the encoded moments) across a tree, as one int32. The
    codes are read through signed views (NaR is the most negative), since
    torch lacks comparisons of uint16 on some devices."""
    leaves = tree_leaves(tree)
    tot = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    for x in leaves:
        if x.is_floating_point():
            tot += torch.sum(~torch.isfinite(x), dtype=torch.int32)
        elif x.dtype in _NAR_INT:
            view, nar = _NAR_INT[x.dtype]
            tot += torch.sum(x.view(view) == nar, dtype=torch.int32)
    return tot


def _sq_norm(tree) -> torch.Tensor:
    return sum(torch.sum(x.to(torch.float32) ** 2) for x in tree_leaves(tree))


@dataclasses.dataclass
class TrainStep:
    """``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)``, updating ``params`` and ``opt_state`` in place (the
    reference's step donates them). ``loss_and_grads`` and ``apply_update``
    are its two halves.

    ``microbatches > 1`` accumulates gradients over sequential microbatches
    (the batch split on its leading axis) in one extra params-sized f32
    buffer. ``telemetry=True`` adds ``update_ratio`` (||delta p|| / ||p||),
    ``param_norm`` and the non-finite counts of the raw gradients and of the
    new moments (NaR codes counted for encoded moments); it keeps a copy of
    the parameters across the update to measure it."""

    model: Model
    policy: TransPolicy
    opt_cfg: AdamWConfig
    warmup: int = 100
    total_steps: int = 10_000
    microbatches: int = 1
    telemetry: bool = False

    def loss_and_grads(self, params, batch: dict) -> tuple:
        """(loss, metrics, grads): the mean over microbatches, grads in
        ``params``' structure, all detached."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        def one(mb):
            loss, metrics = self.model.loss(params, mb, self.policy)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

        if self.microbatches == 1:
            loss, metrics, grads = one(batch)
            return loss, metrics, tree_unflatten(params, list(grads))
        n = self.microbatches
        mbs = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
        dev = leaves[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {"ce": torch.zeros_like(loss), "aux": torch.zeros_like(loss)}
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for p in leaves]
        for i in range(n):
            l_i, m_i, g_i = one({k: v[i] for k, v in mbs.items()})
            loss = loss + l_i
            metrics = {k: metrics[k] + m_i[k] for k in metrics}
            for a, g in zip(acc, g_i):
                a += g.to(torch.float32)
        inv = 1.0 / n
        return (loss * inv, {k: v * inv for k, v in metrics.items()},
                tree_unflatten(params, [a * inv for a in acc]))

    def apply_update(self, params, opt_state: dict, grads, step, loss, metrics) -> tuple:
        """Clip, schedule and AdamW, in place; returns (params, opt_state,
        metrics) with the step's ``loss`` and ``gnorm``."""
        grad_nonfinite = _nonfinite_count(grads) if self.telemetry else None
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        if not isinstance(step, torch.Tensor):
            step = torch.full((), step, dtype=torch.int32, device=gnorm.device)
        lr = cosine_warmup(step, warmup=self.warmup, total=self.total_steps)
        if self.telemetry:
            old = tree_map(lambda p: p.detach().clone(), params)
            p_norm = torch.sqrt(_sq_norm(old))
        params, opt_state = adamw_update(grads, opt_state, params, self.opt_cfg, lr_scale=lr)
        out = {"loss": loss, "gnorm": gnorm, **metrics}
        if self.telemetry:
            upd = tree_map(lambda a, b: a.detach().to(torch.float32) - b.to(torch.float32),
                           params, old)
            out["param_norm"] = p_norm
            out["update_ratio"] = torch.sqrt(_sq_norm(upd)) / (p_norm + 1e-12)
            out["grad_nonfinite"] = grad_nonfinite
            out["opt_nonfinite"] = _nonfinite_count(opt_state["mu"])
        return params, opt_state, out

    def __call__(self, params, opt_state: dict, batch: dict, step) -> tuple:
        loss, metrics, grads = self.loss_and_grads(params, batch)
        return self.apply_update(params, opt_state, grads, step, loss, metrics)


def make_train_step(model: Model, policy: TransPolicy, opt_cfg: AdamWConfig, *,
                    warmup: int = 100, total_steps: int = 10_000,
                    grad_sync: str = "gspmd", microbatches: int = 1,
                    telemetry: bool = False) -> TrainStep:
    """The train step (``TrainStep``) for one device, for the dense family:
    the moe family's forward and loss are ported, its gradient is not held
    to the reference's yet."""
    if model.cfg.family != "dense":
        raise NotImplementedError(
            f"training the {model.cfg.family} family is not ported yet: its gradient "
            "waits for ROADMAP Queue 1 item 5b")
    if grad_sync == "posit_pod":
        raise NotImplementedError(
            "grad_sync='posit_pod' needs distributed/collectives.py, which is not ported "
            "yet (ROADMAP Queue 1 item 5: training)")
    if grad_sync != "gspmd":
        raise ValueError(grad_sync)
    return TrainStep(model, policy, opt_cfg, warmup=warmup, total_steps=total_steps,
                     microbatches=microbatches, telemetry=telemetry)
