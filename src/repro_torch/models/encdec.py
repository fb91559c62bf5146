"""Whisper-style encoder-decoder (the frontend stubbed: the caller gives
precomputed (B, frames, d_model) frame embeddings in place of the conv1d +
mel frontend), for serving.

Encoder: bidirectional attention + GELU MLP, pre-LayerNorm, sinusoidal
positions. Decoder: causal self-attention + cross-attention + GELU MLP,
learned positions, the tied embedding read-out. Serving: the encoder runs
once (``init_dec_cache``), each decoder layer keeps a self K/V cache and a
prefilled cross K/V cache, both posit codes under a posit KV policy.

Parameters: ``{"frame_proj", "enc_blocks": [per-layer dicts], "enc_ln",
"embed", "pos_embed", "dec_blocks": [...], "dec_ln"}``; the reference
stacks the layers on a leading axis instead (``convert.params_from_jax``
maps one onto the other). The cache keeps the reference's stacked layout,
``self`` / ``cross``: ``k``/``v`` (L, B, Hkv, S, hd), ``len`` (L, B), and is
updated in place. Training (the reference's ``encdec_loss`` and
``decode_train``) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.core.device import resolve_device
from repro_torch.core.pcsr import TransPolicy
from repro_torch.models import attention as attn
from repro_torch.models.attention import AttnCfg
from repro_torch.models.layers import (apply_embedding, apply_gelu_mlp, apply_layernorm,
                                       apply_linear, check_ported, embedding_logits,
                                       init_embedding, init_gelu_mlp, init_layernorm,
                                       init_linear, sinusoidal_positions)

MAX_TGT = 448  # whisper's architectural decoder length


def _enc_attn_cfg(cfg: ModelCfg) -> AttnCfg:
    return AttnCfg(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                   head_dim=cfg.hd, qkv_bias=True, causal=False, use_rope=False)


def _dec_self_cfg(cfg: ModelCfg) -> AttnCfg:
    return AttnCfg(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                   head_dim=cfg.hd, qkv_bias=True, causal=True, use_rope=False)


def _dec_cross_cfg(cfg: ModelCfg) -> AttnCfg:
    return AttnCfg(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                   head_dim=cfg.hd, qkv_bias=True, causal=False,
                   use_rope=False, is_cross=True)


def init_encdec(gen: torch.Generator, cfg: ModelCfg, *, device="cuda",
                policy: Optional[TransPolicy] = None) -> dict:
    """Random parameters from ``gen`` (a generator on ``device``), the
    reference's shapes and scales; under a posit policy every linear is
    quantized as it is drawn, to the format its path resolves to
    (``frame_proj``, ``enc_blocks/attn/wq``, ``dec_blocks/cross/wk``,
    ``dec_blocks/mlp/up``, ...). ``embed`` and ``pos_embed`` stay float."""
    device = resolve_device(device)
    kw = dict(device=device, policy=policy)
    d = cfg.d_model

    def enc_layer() -> dict:
        return {"ln1": init_layernorm(d, device=device),
                "attn": attn.init_attention(gen, _enc_attn_cfg(cfg), path="enc_blocks/attn",
                                            **kw),
                "ln2": init_layernorm(d, device=device),
                "mlp": init_gelu_mlp(gen, d, cfg.d_ff, path="enc_blocks/mlp", **kw)}

    def dec_layer() -> dict:
        return {"ln1": init_layernorm(d, device=device),
                "self": attn.init_attention(gen, _dec_self_cfg(cfg), path="dec_blocks/self",
                                            **kw),
                "ln2": init_layernorm(d, device=device),
                "cross": attn.init_attention(gen, _dec_cross_cfg(cfg),
                                             path="dec_blocks/cross", **kw),
                "ln3": init_layernorm(d, device=device),
                "mlp": init_gelu_mlp(gen, d, cfg.d_ff, path="dec_blocks/mlp", **kw)}

    return {
        "frame_proj": init_linear(gen, d, d, bias=True, path="frame_proj", **kw),
        "enc_blocks": [enc_layer() for _ in range(cfg.enc_layers)],
        "enc_ln": init_layernorm(d, device=device),
        "embed": init_embedding(gen, cfg.vocab, d, device=device),
        "pos_embed": torch.randn((MAX_TGT, d), generator=gen, device=device) * 0.01,
        "dec_blocks": [dec_layer() for _ in range(cfg.n_layers)],
        "dec_ln": init_layernorm(d, device=device),
    }


def encode(params: dict, frames: torch.Tensor, cfg: ModelCfg,
           policy: TransPolicy) -> torch.Tensor:
    """frames (B, T, D) stub embeddings -> encoder states (B, T, D). Every
    linear runs at B * T rows (the large-M GEMM route at full size), the
    residuals fused into wo's and the MLP down projection's epilogues."""
    check_ported(policy)
    T = frames.shape[1]
    x = apply_linear(params["frame_proj"], frames, policy, path="frame_proj")
    x = x + sinusoidal_positions(T, cfg.d_model, device=x.device)[None].to(x.dtype)
    ecfg = _enc_attn_cfg(cfg)
    for p in params["enc_blocks"]:
        h = apply_layernorm(p["ln1"], x)
        x = attn.apply_attention(p["attn"], ecfg, h, policy, residual=x, path="attn")
        h = apply_layernorm(p["ln2"], x)
        x = apply_gelu_mlp(p["mlp"], h, policy, residual=x, path="mlp")
    return apply_layernorm(params["enc_ln"], x)


def init_dec_cache(params: dict, frames: torch.Tensor, cfg: ModelCfg, policy: TransPolicy,
                   S_max: int) -> dict:
    """Run the encoder once and prefill every layer's cross K/V cache (its
    k/v linears over the encoder states, stored as posit codes under a posit
    KV policy, ``len`` = T); the self caches start empty. ``frames`` (B, T,
    D) float, or anything ``torch.as_tensor`` takes, moved to the params'
    device."""
    device = params["embed"]["table"].device
    frames = torch.as_tensor(frames, dtype=torch.float32).to(device)
    B = frames.shape[0]
    enc_out = encode(params, frames, cfg, policy)
    T = enc_out.shape[1]
    scfg, ccfg = _dec_self_cfg(cfg), _dec_cross_cfg(cfg)
    cross = attn.init_kv_cache(B, T, ccfg, policy, device=device, n_layers=cfg.n_layers)
    for i, p in enumerate(params["dec_blocks"]):
        for name in ("k", "v"):
            kv = apply_linear(p["cross"]["w" + name], enc_out, policy, path=f"cross/w{name}")
            attn._store(cross[name][i], kv.reshape(B, T, cfg.n_kv, cfg.hd).transpose(1, 2), 0,
                        policy)
    cross["len"].fill_(T)
    return {"cross": cross,
            "self": attn.init_kv_cache(B, S_max, scfg, policy, device=device,
                                       n_layers=cfg.n_layers),
            "pos": torch.zeros((), dtype=torch.int32, device=device),
            "lens": torch.zeros((B,), dtype=torch.int32, device=device)}


def decode_step(params: dict, token_t: torch.Tensor, cache: dict, cfg: ModelCfg,
                policy: TransPolicy) -> tuple:
    """One token for the whole batch. token_t: (B,) int -> logits (B, V).

    Each row's learned position is ``pos_embed[lens % MAX_TGT]`` (rows may
    sit at different depths); its self K/V row goes in at ``lens`` and its
    cross-attention reads the encoder cache. The cache is updated in place
    and returned: every tensor of it (the self K/V, ``lens``, ``pos``) stays
    the same tensor, so a CUDA graph of the step reads and writes the same
    buffers at each replay."""
    check_ported(policy)
    lens = cache["lens"]
    scfg, ccfg = _dec_self_cfg(cfg), _dec_cross_cfg(cfg)
    x = apply_embedding(params["embed"], token_t[:, None])
    x = x + params["pos_embed"][lens % MAX_TGT][:, None].to(x.dtype)
    for i, p in enumerate(params["dec_blocks"]):
        # the residuals fuse into the wo and down projections' epilogues
        h = apply_layernorm(p["ln1"], x)
        x = attn.decode_attention_step(p["self"], scfg, h, attn.layer_cache(cache["self"], i),
                                       lens, policy, residual=x, path="self")[0]
        h = apply_layernorm(p["ln2"], x)
        x = attn.decode_attention_step(p["cross"], ccfg, h, attn.layer_cache(cache["cross"], i),
                                       lens, policy, residual=x, path="cross")[0]
        h = apply_layernorm(p["ln3"], x)
        x = apply_gelu_mlp(p["mlp"], h, policy, residual=x, path="mlp")
    h = apply_layernorm(params["dec_ln"], x)
    logits = embedding_logits(params["embed"], h)[:, 0]
    cache["pos"] += 1
    lens.add_(1)          # in place, after its last use in the step
    return logits, cache
