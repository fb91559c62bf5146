"""Architecture registry of the port: the dense- and moe-family configs,
gemma3-4b (local sliding-window layers over rolling KV caches, one global
layer in six) and whisper-medium (the encoder-decoder family, served in
``serve.py``'s static mode).

The other families of the reference (zamba, xlstm, vlm) are not ported yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelCfg

ARCH_IDS = ("gemma3-4b", "granite-moe-3b-a800m", "olmoe-1b-7b", "phi3-mini-3.8b",
            "qwen2.5-14b", "whisper-medium", "yi-34b")


def get_arch(name: str) -> ModelCfg:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown or unported architecture {name!r}; "
                       f"the port has {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + name.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS
