"""Reference parameter trees -> the port's parameters, bit for bit.

``params_from_jax`` takes the reference's parameter tree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``), float or after the
reference's ``quantize_params`` (per-layer precision policies included).
Codes stay codes and floats stay floats, with no rounding on the way: a
stacked ``w_packed`` of packed p8 lanes, (L, ceil(K/2), N) uint16, becomes
each layer's (ceil(K/2), N) uint16 bit for bit. The stacked ``blocks`` axis
becomes a list of per-layer dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelCfg, device="cuda") -> dict:
    """The port's parameters for the reference tree ``tree`` of model ``cfg``."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    dev = resolve_device(device)
    blocks = tree["blocks"]
    depth = {int(np.shape(a)[0]) for a in _leaves(blocks)}
    if depth != {cfg.n_layers}:
        raise ValueError(f"stacked blocks have depth {sorted(depth)}, "
                         f"config {cfg.name} has {cfg.n_layers} layers")
    out = {k: _tree(v, lambda a: _tensor(a, dev)) for k, v in tree.items() if k != "blocks"}
    out["blocks"] = [_tree(blocks, lambda a, i=i: _tensor(np.asarray(a)[i], dev))
                     for i in range(cfg.n_layers)]
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
