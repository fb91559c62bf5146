"""Reference parameter trees -> the port's parameters, bit for bit.

``params_from_jax`` takes the reference's parameter tree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``), float or after the
reference's ``quantize_params`` (per-layer precision policies included).
Codes stay codes and floats stay floats, with no rounding on the way: a
stacked ``w_packed`` of packed p8 lanes, (L, ceil(K/2), N) uint16, becomes
each layer's (ceil(K/2), N) uint16 bit for bit. The stacked ``blocks`` axis
becomes a list of per-layer dicts; a moe layer's stacked expert leaves,
(L, E, D, F) float or codes, become its (E, D, F). The whisper tree's
``enc_blocks`` and ``dec_blocks`` become per-layer lists the same way;
``frame_proj``, ``enc_ln``, ``embed``, ``pos_embed`` and ``dec_ln`` are
carried across as they are.

``opt_state_from_jax`` does the same for the reference's AdamW state (float
or posit-coded moments, the error-feedback residuals, the step count), and
``tree_to_jax`` walks back: a port tree (parameters, gradients or
optimizer moments) in the reference's stacked numpy layout, so the two
packages compare leaf by leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_leaves, tree_map


def _tensor(a, device: torch.device) -> torch.Tensor:
    # a copy: the port updates parameters and moments in place, and the
    # reference's arrays (read-only numpy views of its buffers) stay its own
    return torch.from_numpy(np.array(a, order="C")).to(device)


# the stacked layer trees of each family, with their depth
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def _stacked_depths(cfg: ModelCfg) -> dict:
    if cfg.family in ("dense", "moe", "gemma3"):
        return {"blocks": cfg.n_layers}
    if cfg.family == "whisper":
        return {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.n_layers}
    raise NotImplementedError(f"family {cfg.family!r} is not ported yet")


def params_from_jax(tree: dict, cfg: ModelCfg, device="cuda") -> dict:
    """The port's parameters for the reference tree ``tree`` of model ``cfg``."""
    depths = _stacked_depths(cfg)
    dev = resolve_device(device)
    out = {k: tree_map(lambda a: _tensor(a, dev), v) for k, v in tree.items()
           if k not in depths}
    for key, n in depths.items():
        blocks = tree[key]
        depth = {int(np.shape(a)[0]) for a in tree_leaves(blocks)}
        if depth != {n}:
            raise ValueError(f"stacked {key} have depth {sorted(depth)}, "
                             f"config {cfg.name} has {n} layers")
        out[key] = [tree_map(lambda a, i=i: _tensor(np.asarray(a)[i], dev), blocks)
                    for i in range(n)]
    return out


def opt_state_from_jax(state: dict, cfg: ModelCfg, device="cuda") -> dict:
    """The port's AdamW state for the reference's ``{"mu", "count"}`` (numpy
    leaves): each parameter's ``{"m", "v"[, "em", "ev"]}`` per layer, codes
    bit for bit."""
    return {"mu": params_from_jax(state["mu"], cfg, device=device),
            "count": torch.tensor(int(np.asarray(state["count"])), dtype=torch.int32,
                                  device=resolve_device(device))}


def tree_to_jax(tree: dict) -> dict:
    """A port tree (parameters, gradients or ``opt["mu"]``) as the reference
    lays it out: numpy leaves, each per-layer list (``blocks``,
    ``enc_blocks``, ``dec_blocks``) stacked on a leading axis. Codes stay
    codes."""
    def numpy(t):
        return t.detach().cpu().numpy()

    return {k: _stack([tree_map(numpy, b) for b in v]) if k in STACKED else tree_map(numpy, v)
            for k, v in tree.items()}


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)
