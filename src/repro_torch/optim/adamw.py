"""AdamW with optional posit-compressed moments (+ error feedback).

Transprecision applied to optimizer state: the first and second moments can
be stored as p16/p8 codes, cutting optimizer memory by 2-4x. An f32
error-feedback residual per moment keeps the update unbiased over time.
The codes encode and decode through the codec kernels (their plain
versions for CPU tensors).

State layout per leaf, as in the reference:
  float moments:  {"m": f32, "v": f32}
  posit moments:  {"m": uintN, "v": uintN [, "em": f32, "ev": f32]}

The reference returns new trees and donates the old ones; the port updates
the parameters, the moments and the gradients (``clip_by_global_norm``) in
place, leaf by leaf, so no second copy of any of them is ever held.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.core.types import PositFmt
from repro_torch.kernels.posit_codec import ops as codec_ops


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_fmt: Optional[PositFmt] = None   # posit-compress m and v
    error_feedback: bool = True


def _enc(x: torch.Tensor, fmt: PositFmt) -> torch.Tensor:
    return codec_ops.encode(x.contiguous(), fmt.es, nbits=fmt.nbits)


def _dec(x: torch.Tensor, fmt: PositFmt) -> torch.Tensor:
    return codec_ops.decode(x.contiguous(), fmt.es, nbits=fmt.nbits)


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments for every leaf of ``params`` (on its device), and the
    step count."""
    def leaf(p):
        def z():
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.moment_fmt is None:
            return {"m": z(), "v": z()}
        st = {"m": _enc(z(), cfg.moment_fmt), "v": _enc(z(), cfg.moment_fmt)}
        if cfg.error_feedback:
            st["em"] = z()
            st["ev"] = z()
        return st
    return {"mu": tree_map(leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
                 lr_scale=1.0) -> tuple[Any, dict]:
    """One AdamW step, in place: every parameter leaf and its moments are
    overwritten leaf by leaf, ``state["count"]`` advances. Returns
    (params, state), the same objects."""
    count = state["count"] + 1
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)
    lr = cfg.lr * lr_scale
    fmt = cfg.moment_fmt

    def leaf(p, g, st):
        gf = g.to(torch.float32)
        if fmt is None:
            m_prev, v_prev = st["m"], st["v"]
        else:
            m_prev, v_prev = _dec(st["m"], fmt), _dec(st["v"], fmt)
            if cfg.error_feedback:
                m_prev = m_prev + st["em"]
                v_prev = v_prev + st["ev"]
        m = cfg.b1 * m_prev + (1 - cfg.b1) * gf
        v = cfg.b2 * v_prev + (1 - cfg.b2) * gf * gf
        mh = m / b1c
        vh = v / b2c
        pf = p.to(torch.float32)
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * upd).to(p.dtype))
        if fmt is None:
            st["m"], st["v"] = m, v
            return
        st["m"], st["v"] = _enc(m, fmt), _enc(v, fmt)
        if cfg.error_feedback:
            st["em"] = m - _dec(st["m"], fmt)
            st["ev"] = v - _dec(st["v"], fmt)

    tree_map(leaf, params, grads, state["mu"])
    state["count"] = count
    return params, state


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Scale every gradient leaf in place by ``min(1, max_norm / (norm +
    1e-9))``, the global L2 norm summed in f32 across leaves. Returns
    (grads, norm)."""
    leaves = tree_leaves(grads)
    if len({(g.device, g.data_ptr()) for g in leaves}) != len(leaves):
        raise ValueError("gradient leaves share storage; scaling them in place would "
                         "scale the shared values more than once")
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale.to(g.dtype))
    return grads, gn
