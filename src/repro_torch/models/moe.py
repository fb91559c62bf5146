"""Mixture-of-Experts with capacity-bounded dispatch (the reference's
``models/moe.py``: router, top-k, renormalized gates, the Switch-style aux
loss, capacity ``C``, dropped tokens past it).

Every expert product runs on the posit GEMM kernel, one call an expert and
projection, with the expert's (D, F) codes as B: the codes stay the only
copy of the expert stacks (one byte a weight at p8), decoded inside the
kernel at each call. The gate's silu rides in its GEMM's epilogue. The
dispatch is deterministic and never waits on the host (no ``.item()``, no
``nonzero``), so a decode step that holds it can be captured in a CUDA
graph: a stable argsort of the (token, choice) assignments by expert gives
each expert's rows in token order, and each of the (E, C) buffer slots
gathers its row (zeros past the expert's count), so a dropped assignment
writes nothing; the outputs gather back by each assignment's rank, zero
where it was dropped.
"""
from __future__ import annotations

import torch

from repro_torch.calib import observe
from repro_torch.core.dot import posit_matmul_wx
from repro_torch.kernels.posit_gemm.ops import float_linear
from repro_torch.models.layers import (EXPERT_KEYS, apply_linear, compute_dtype,
                                       effective_weight, init_linear, quantize_expert_stack,
                                       resolve_policy)


def init_moe(gen: torch.Generator, d: int, f: int, n_experts: int, *, device="cpu",
             policy=None, path: str = "moe") -> dict:
    """Router (d, E) and expert stacks (E, d, f) / (E, f, d), random normal
    scaled as the reference's. Under a ``policy`` each stack is quantized to
    its codes as soon as it is drawn (the format ``path/<name>`` resolves
    to), so one f32 stack at most exists at a time."""
    p = {"router": init_linear(gen, d, n_experts, device=device, policy=policy,
                               path=f"{path}/router")}
    for name, shape, scale in (("w_gate", (n_experts, d, f), d ** -0.5),
                               ("w_up", (n_experts, d, f), d ** -0.5),
                               ("w_down", (n_experts, f, d), f ** -0.5)):
        w = torch.randn(shape, generator=gen, device=device) * scale
        fmt = None if policy is None else resolve_policy(policy, f"{path}/{name}").weights
        p.update({name: w} if fmt is None else quantize_expert_stack(name, w, fmt))
    return p


def _expert_path(name: str) -> str:
    """The policy site key of a stacked expert tensor, the reference's."""
    return f"moe/{name}"


class _Experts:
    """The expert stacks of one layer as the GEMM kernel reads them: each
    expert's (K, N) codes (a view), or its float weight in the compute dtype
    (through ``effective_weight``: the straight-through quantization under a
    posit policy, as the reference's einsum sees it)."""

    def __init__(self, p: dict, policy, cd: torch.dtype):
        self.p, self.policy, self.cd = p, policy, cd
        self.float_w = {name: effective_weight({"w": p[name]}, policy,
                                               path=_expert_path(name)).to(cd)
                        for name in EXPERT_KEYS if name in p}

    def linear(self, x: torch.Tensor, name: str, e: int, activation: str = "none"):
        """act(x @ W_e) in f32, x (C, K)."""
        if name in self.float_w:
            return float_linear(x, self.float_w[name][e], compute_dtype=self.cd,
                                activation=activation)
        pol = resolve_policy(self.policy, _expert_path(name))
        return posit_matmul_wx(x, self.p[name + "_codes"][e], pol.weights, compute_dtype=self.cd,
                               out_dtype=torch.float32, activation=activation,
                               codec_impl=pol.codec_impl, epilogue=pol.epilogue)


def capacity(T: int, top_k: int, capacity_factor: float, n_experts: int) -> int:
    """Rows an expert takes, the reference's: ceil(T k cf / E), at least 8,
    rounded up to a multiple of 8."""
    C = int(-(-T * top_k * capacity_factor // n_experts))
    return max(8, -(-C // 8) * 8)


def top_k_stable(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (as ``jax.lax.top_k`` orders them;
    ``torch.topk`` leaves ties unordered)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float,
              policy, with_aux: bool = False):
    """x: (B, S, D) -> the same shape; with ``with_aux``, (that, the aux
    load-balancing loss), the reference's pair. Serving asks for no aux, so
    a captured decode step replays none of its kernels."""
    B, S, D = x.shape
    T = B * S
    E = (p["w_gate"] if "w_gate" in p else p["w_gate_codes"]).shape[0]
    xf = x.reshape(T, D)

    logits = apply_linear(p["router"], xf, policy, path="moe/router").to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                            # (T, E)
    top_p, top_e = top_k_stable(probs, top_k)                        # (T, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    flat_e = top_e.reshape(-1)                                       # (T*k,)
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    C = capacity(T, top_k, capacity_factor, E)
    # each expert's assignments in token order: a stable sort by expert, and
    # the group starts
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    n = flat_e.shape[0]
    rank = torch.arange(n, device=x.device) - starts[flat_e[order]]
    flat_pos = torch.empty_like(rank).scatter_(0, order, rank)
    keep = flat_pos < C

    # buffer slot (e, c) holds the c-th assignment of expert e (zeros past its count)
    slot = torch.arange(C, device=x.device)
    src = order[torch.clamp(starts[:, None] + slot, max=n - 1)]      # (E, C)
    filled = slot < counts[:, None]
    buffers = torch.where(filled[..., None], xf[src // top_k].to(torch.float32), 0.0)

    cd = compute_dtype(policy)
    experts = _Experts(p, policy, cd)
    observed = observe.is_active()
    if observed:
        # the expert products do not go through apply_linear: the dispatch
        # buffers, as the GEMM reads them, are the gate's and up's activation
        h = buffers.to(cd)
        observe.record(_expert_path("w_gate"), "act", h)
        observe.record(_expert_path("w_up"), "act", h)
    outs, acts = [], []
    for e in range(E):
        h = buffers[e]
        g = experts.linear(h, "w_gate", e, activation="silu")
        act = g * experts.linear(h, "w_up", e)
        if observed:
            acts.append(act)
        outs.append(experts.linear(act, "w_down", e))
    if observed:
        # silu(g) * u of every expert: the down projection's activation
        observe.record(_expert_path("w_down"), "act", torch.stack(acts))
    out_buf = torch.stack(outs)                                      # (E, C, D)

    gathered = out_buf[flat_e, torch.clamp(flat_pos, max=C - 1)]     # (T*k, D)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    weighted = gathered.reshape(T, top_k, D) * top_p[..., None]
    y = torch.sum(weighted, dim=1).to(x.dtype).reshape(B, S, D)
    if not with_aux:
        return y
    # Switch-style aux loss: E * sum_e fraction_tokens(e) * mean_prob(e)
    me = probs.mean(dim=0)
    ce = counts.to(torch.float32) / T / top_k
    return y, E * torch.sum(me * ce)
