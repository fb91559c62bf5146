"""Model registry: one uniform interface over the ported families (dense,
moe, gemma3 and whisper; ``loss`` and ``forward`` for dense, moe and gemma3:
the dense family trains, all three calibrate; whisper's refuse).

  model = build_model(cfg)                 # device="cuda" unless told otherwise
  params = model.init(seed, policy)        # quantized layer by layer under a posit policy
  loss, metrics = model.loss(params, batch, policy)     # float params: training
  hidden = model.forward(params, batch, policy)
  logits, cache = model.prefill(params, tokens, policy, S_max=...)
  logits, cache = model.decode_step(params, tokens_t, cache, policy)
  cache = model.init_paged_cache(B, n_blocks, block_tokens, table_width, policy)
  logits, cache = model.decode_step_paged(params, tokens_t, cache, policy)

gemma3 has no paged entry points (``None``): as in the reference, only
dense and moe page their KV, and the paged engine refuses the rest
(``transformer.no_paged_path``). The whisper family has no prefill and no
paged entry points (``None``), as in the reference: ``init_cache(params,
{"frames": (B, T, D)}, policy, S_max)`` runs the encoder and prefills the
cross K/V, and the decoder prompt goes through ``decode_step`` token by
token.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.device import resolve_device
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelCfg
    device: torch.device
    init: Callable            # (seed, policy=None) -> params
    # (B, S_max, policy) -> cache; whisper: (params, {"frames"}, policy, S_max)
    init_cache: Callable
    prefill: Callable         # (params, tokens, policy, S_max=None) -> (logits, cache)
    decode_step: Callable     # (params, tokens_t, cache, policy) -> (logits, cache)
    # paged serving: (B, n_blocks, block_tokens, table_width, policy) -> cache
    init_paged_cache: Callable = None
    decode_step_paged: Callable = None    # decode_step over the paged cache
    loss: Callable = None       # (params, batch, policy) -> (loss, {"ce", "aux"})
    #                             (training: dense only, launch/steps.py)
    forward: Callable = None    # (params, batch, policy) -> hidden (B, S, D)


def _training_not_ported(family: str) -> Callable:
    def refuse(*_):
        raise NotImplementedError(
            f"the {family} family's forward and loss are not ported yet: Queue 1 item 5b")
    return refuse


def build_model(cfg: ModelCfg, device="cuda") -> Model:
    if cfg.family == "whisper":
        return _build_encdec(cfg, resolve_device(device))
    if cfg.family not in transformer.DECODER_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port serves "
            f"{transformer.DECODER_FAMILIES} and whisper")
    dev = resolve_device(device)
    paged = cfg.family in transformer.PAGED_FAMILIES

    def init(seed: int, policy=None) -> dict:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return transformer.init_lm(gen, cfg, device=dev, policy=policy)

    return Model(
        cfg=cfg,
        device=dev,
        init=init,
        init_cache=lambda B, S_max, pol: transformer.init_cache(cfg, B, S_max, pol,
                                                                device=dev),
        prefill=lambda p, tokens, pol, **kw: transformer.prefill(p, tokens, cfg, pol, **kw),
        decode_step=lambda p, tok, cache, pol: transformer.decode_step(p, tok, cache, cfg,
                                                                       pol),
        init_paged_cache=(lambda B, n_blocks, bt, width, pol: transformer.init_paged_cache(
            cfg, B, n_blocks, bt, width, pol, device=dev)) if paged else None,
        decode_step_paged=(lambda p, tok, cache, pol: transformer.decode_step_paged(
            p, tok, cache, cfg, pol)) if paged else None,
        loss=lambda p, batch, pol: transformer.lm_loss(p, batch, cfg, pol),
        forward=lambda p, batch, pol: transformer.forward(p, batch["tokens"], cfg, pol)[0],
    )


def _build_encdec(cfg: ModelCfg, dev: torch.device) -> Model:
    def init(seed: int, policy=None) -> dict:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return encdec.init_encdec(gen, cfg, device=dev, policy=policy)

    return Model(
        cfg=cfg,
        device=dev,
        init=init,
        init_cache=lambda p, batch, pol, S_max: encdec.init_dec_cache(p, batch["frames"], cfg,
                                                                      pol, S_max),
        prefill=None,
        decode_step=lambda p, tok, cache, pol: encdec.decode_step(p, tok, cache, cfg, pol),
        loss=_training_not_ported(cfg.family),
        forward=_training_not_ported(cfg.family),
    )
