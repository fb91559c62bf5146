"""Decoder-only LM assembly for the dense, moe and gemma3 families: init,
cache init, prefill and decode_step (the serving path), the paged serving
cache and step (``init_paged_cache``, ``decode_step_paged``; dense and moe
only, as in the reference), ``forward`` and the sequence-chunked loss
``lm_loss`` (training for the dense family; calibration for all three).
A moe block holds ``"moe"`` (``models/moe.py``) where a dense one holds
``"mlp"``. gemma3 is the dense block over a layer pattern
(``gemma3_layer_meta``): ``local_ratio`` sliding-window layers (``window``
keys, RoPE base ``rope_base``) then one global layer (full causal, base
``global_rope_base``), its embedding tied to the read-out.

Parameters: ``{"embed": {"table"}, "blocks": [per-layer dicts], "final_norm",
"lm_head"}``; the reference stacks the layers on a leading axis instead
(``convert.params_from_jax`` maps one onto the other). The KV cache is
updated in place and holds one stack a cache length (``KV_STACKS``):
``kv.k/v: (L, B, Hkv, S, hd)``, ``kv.len: (L, B)`` for the layers that keep
every position (all of a dense or moe model's, the reference's stacked
layout; gemma3's global layers), and for gemma3's local layers
``kv_local`` at ``min(S, window)`` rows, a rolling buffer each (the
reference keeps a list of per-layer caches of the two sizes instead).
``cache_slots`` says where layer i's cache lives.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelCfg
from repro_torch.core.device import resolve_device
from repro_torch.core.pcsr import TransPolicy
from repro_torch.models import attention as attn
from repro_torch.models.attention import AttnCfg
from repro_torch.models.layers import (apply_embedding, apply_linear, apply_rmsnorm,
                                       apply_swiglu, check_ported, embedding_logits,
                                       init_embedding, init_linear, init_rmsnorm,
                                       init_swiglu, rope_tables)
from repro_torch.models.moe import apply_moe, init_moe


LOSS_CHUNK = 1024  # sequence-chunked CE to bound peak logits memory


# the decoder-only families this module builds; the port serves whisper
# too, through models/encdec.py
DECODER_FAMILIES = ("dense", "moe", "gemma3")
# the families whose KV cache pages (the reference's init_paged_cache)
PAGED_FAMILIES = ("dense", "moe")
# the cache's stacked KV containers: full-length caches, then gemma3's
# window-sized rolling ones
KV_STACKS = ("kv", "kv_local")


def _require_served(cfg: ModelCfg) -> None:
    if cfg.family not in DECODER_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} has no decoder-only path (this module builds "
            f"{DECODER_FAMILIES}; whisper is served through models/encdec.py)")


def no_paged_path(family: str) -> str:
    """Why a family outside PAGED_FAMILIES cannot serve paged."""
    return (f"family {family!r} has no paged decode path (the paged KV serves the "
            f"uniform stacked-cache families {PAGED_FAMILIES}; it keeps the slot grid)")


def _require_paged(cfg: ModelCfg) -> None:
    _require_served(cfg)
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(no_paged_path(cfg.family))


def _ffn(p: dict, h: torch.Tensor, x: torch.Tensor, cfg: ModelCfg,
         policy: TransPolicy) -> torch.Tensor:
    """The block's feed-forward on ``h`` plus its residual ``x``: the dense
    MLP (the residual fused into the down projection) or the moe layer (the
    residual added after it, as in the reference)."""
    if "moe" in p:
        y = apply_moe(p["moe"], h, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                      policy=policy)
        return x + y
    return apply_swiglu(p["mlp"], h, policy, residual=x, path="mlp")


def attn_cfg(cfg: ModelCfg, *, window: int = 0, rope_base: Optional[float] = None) -> AttnCfg:
    return AttnCfg(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                   head_dim=cfg.hd, qkv_bias=cfg.qkv_bias,
                   rope_base=cfg.rope_base if rope_base is None else rope_base,
                   window=window)


def gemma3_layer_meta(cfg: ModelCfg) -> tuple:
    """Per-layer (windows, RoPE bases): ``local_ratio`` local layers (window
    ``cfg.window``, base ``cfg.rope_base``) per global one (window 0, base
    ``cfg.global_rope_base``), as python numbers."""
    is_global = [i % (cfg.local_ratio + 1) == cfg.local_ratio for i in range(cfg.n_layers)]
    return (tuple(0 if g else cfg.window for g in is_global),
            tuple(cfg.global_rope_base if g else cfg.rope_base for g in is_global))


def layer_attn_cfgs(cfg: ModelCfg) -> list:
    """Every layer's AttnCfg: one for all of a dense or moe model; gemma3's
    window and RoPE base by layer."""
    if cfg.family != "gemma3":
        return [attn_cfg(cfg)] * cfg.n_layers
    return [attn_cfg(cfg, window=w, rope_base=b) for w, b in zip(*gemma3_layer_meta(cfg))]


def cache_slots(cfg: ModelCfg) -> list:
    """Layer i's KV cache as (container, index in its stack): ``"kv"`` for a
    layer that keeps every position, ``"kv_local"`` for a sliding-window
    layer's rolling buffer (gemma3)."""
    slots, count = [], {name: 0 for name in KV_STACKS}
    for acfg in layer_attn_cfgs(cfg):
        name = "kv_local" if acfg.window else "kv"
        slots.append((name, count[name]))
        count[name] += 1
    return slots


def kv_stacks(cache: dict) -> list:
    """The cache's stacked KV containers (``{"k", "v", "len"}`` each)."""
    return [cache[name] for name in KV_STACKS if name in cache]


def _layer_cache(cache: dict, slot: tuple) -> dict:
    name, j = slot
    return attn.layer_cache(cache[name], j)


def _rope_by_base(positions: torch.Tensor, acfgs: list) -> dict:
    """``rope_tables`` of ``positions`` at each RoPE base the layers use (one
    for a dense or moe model, two for gemma3), shared by the layers."""
    return {b: rope_tables(positions, acfgs[0].head_dim, b)
            for b in dict.fromkeys(a.rope_base for a in acfgs)}


def init_lm(gen: torch.Generator, cfg: ModelCfg, *, device="cuda",
            policy: Optional[TransPolicy] = None) -> dict:
    """Random parameters from ``gen`` (a generator on ``device``). Under a
    posit policy every linear is quantized as soon as it is drawn, to the
    format its param-tree path resolves to (``blocks/attn/wq``, ...,
    ``lm_head``: a ``PrecisionPolicy`` may give each its own, packed lanes
    included), so the peak memory is one f32 linear above the codes (a
    full-size model never exists in f32; a moe layer's expert stacks are
    quantized one stack at a time)."""
    _require_served(cfg)
    device = resolve_device(device)
    acfg = attn_cfg(cfg)
    params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, device=device)}

    def block() -> dict:
        p = {"ln1": init_rmsnorm(cfg.d_model, device=device),
             "attn": attn.init_attention(gen, acfg, device=device, policy=policy,
                                         path="blocks/attn"),
             "ln2": init_rmsnorm(cfg.d_model, device=device)}
        if cfg.family == "moe":
            p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, device=device,
                                policy=policy, path="blocks/moe")
        else:
            p["mlp"] = init_swiglu(gen, cfg.d_model, cfg.d_ff, device=device, policy=policy,
                                   path="blocks/mlp")
        return p

    params["blocks"] = [block() for _ in range(cfg.n_layers)]
    params["final_norm"] = init_rmsnorm(cfg.d_model, device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab, device=device,
                                        policy=policy, path="lm_head")
    return params


def logits_fn(params: dict, h: torch.Tensor, cfg: ModelCfg,
              policy: TransPolicy) -> torch.Tensor:
    if cfg.tie_embeddings:
        return embedding_logits(params["embed"], h)
    return apply_linear(params["lm_head"], h, policy, path="lm_head").to(torch.float32)


# ---------------------------------------------------------------------------
# forward (train / no cache)
# ---------------------------------------------------------------------------

def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass (the
    reference's ``jax.checkpoint``) when a gradient is being taken. The
    forward draws no random numbers, so no RNG state is kept."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelCfg, policy: TransPolicy, *,
            remat: bool = True) -> tuple:
    """tokens (B, S) -> hidden (B, S, D) after the final norm, and the aux
    loss: the moe layers' load-balancing losses summed over the layers, as
    the reference's forward sums them (0.0 for the dense family). Every layer
    is checkpointed under ``remat`` when a gradient is taken, so its GEMM and
    codec launches run again in the backward pass (the moe family's
    gradient is not ported: training refuses it)."""
    _require_served(cfg)
    check_ported(policy)
    acfgs = layer_attn_cfgs(cfg)
    ropes = _rope_by_base(torch.arange(tokens.shape[1], device=tokens.device)[None], acfgs)

    def layer(x, p, acfg):
        h = apply_rmsnorm(p["ln1"], x, cfg.norm_eps)
        # the block residuals fuse into the wo and down projections' epilogues
        x = attn.apply_attention(p["attn"], acfg, h, policy, rope=ropes[acfg.rope_base],
                                 residual=x, path="attn")
        h = apply_rmsnorm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            y, aux_l = apply_moe(p["moe"], h, top_k=cfg.top_k,
                                 capacity_factor=cfg.capacity_factor, policy=policy,
                                 with_aux=True)
            return x + y, aux_l
        return apply_swiglu(p["mlp"], h, policy, residual=x, path="mlp"), None

    x = apply_embedding(params["embed"], tokens)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, acfg in zip(params["blocks"], acfgs):
        x, aux_l = _remat(layer, x, p, acfg) if remat else layer(x, p, acfg)
        if aux_l is not None:
            aux = aux + aux_l
    return apply_rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def lm_loss(params: dict, batch: dict, cfg: ModelCfg, policy: TransPolicy, *,
            aux_weight: float = 0.01) -> tuple:
    """Sequence-chunked cross-entropy, batch ``{"tokens", "labels"}`` (B, S)
    int: the positions split into ``max(1, S // LOSS_CHUNK)`` chunks of equal
    length (a remainder is dropped, as in the reference), each chunk's
    logits recomputed in the backward pass. Returns (loss, {"ce", "aux"})."""
    h, aux = forward(params, batch["tokens"], cfg, policy)
    labels = batch["labels"]
    B, S, _ = h.shape
    n_chunks = max(1, S // LOSS_CHUNK)
    Sc = S // n_chunks

    def chunk_ll(hc, lc):
        lp = torch.log_softmax(logits_fn(params, hc, cfg, policy), dim=-1)
        return torch.gather(lp, -1, lc[..., None].to(torch.int64))[..., 0].sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        cols = slice(c * Sc, (c + 1) * Sc)
        total = total + _remat(chunk_ll, h[:, cols], labels[:, cols])
    ce = -total / (B * n_chunks * Sc)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def init_cache(cfg: ModelCfg, B: int, S_max: int, policy: TransPolicy, *,
               device="cuda") -> dict:
    """The slot grid's cache: ``"kv"`` (S_max rows a layer) for the layers
    that keep every position, and for gemma3 ``"kv_local"``, its local
    layers' rolling buffers of ``min(S_max, window)`` rows (stacked; an
    empty stack where the model has no such layer), with ``lens``/``pos``."""
    _require_served(cfg)
    device = resolve_device(device)
    acfg = attn_cfg(cfg)
    depth = [name for name, _ in cache_slots(cfg)].count
    cache = {"kv": attn.init_kv_cache(B, S_max, acfg, policy, device=device,
                                      n_layers=depth("kv"))}
    if cfg.family == "gemma3":
        cache["kv_local"] = attn.init_kv_cache(B, min(S_max, cfg.window), acfg, policy,
                                               device=device, n_layers=depth("kv_local"))
    cache["pos"] = torch.zeros((), dtype=torch.int32, device=device)
    # per-row next-write positions (ragged continuous batching)
    cache["lens"] = torch.zeros((B,), dtype=torch.int32, device=device)
    return cache


def _decode_layers(params: dict, token_t: torch.Tensor, cache: dict, cfg: ModelCfg,
                   policy: TransPolicy, attend) -> tuple:
    """The decode step's body, shared by the slot grid and the paged pool:
    ``attend(layer_params, acfg, h, i, rope, residual)`` is layer i's
    attention with the residual fused into wo, ``rope`` the tables of the
    rows' positions ``lens`` at the layer's base (made on the device from
    ``lens`` at every call, so a captured step recomputes them at each
    replay)."""
    _require_served(cfg)
    check_ported(policy)
    lens = cache["lens"]
    acfgs = layer_attn_cfgs(cfg)
    x = apply_embedding(params["embed"], token_t[:, None])
    ropes = _rope_by_base(lens[:, None], acfgs)
    for i, (p, acfg) in enumerate(zip(params["blocks"], acfgs)):
        h = apply_rmsnorm(p["ln1"], x, cfg.norm_eps)
        # the residuals fuse into wo's epilogue (and a dense MLP's down projection's)
        x = attend(p["attn"], acfg, h, i, ropes[acfg.rope_base], x)
        h = apply_rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = _ffn(p, h, x, cfg, policy)
    h = apply_rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_fn(params, h, cfg, policy)[:, 0]
    cache["pos"] += 1
    lens.add_(1)          # in place, after its last use in the step
    return logits, cache


def decode_step(params: dict, token_t: torch.Tensor, cache: dict, cfg: ModelCfg,
                policy: TransPolicy) -> tuple:
    """One token for the whole batch. token_t: (B,) int -> logits (B, V).

    Every row writes at its own position ``cache["lens"]`` and masks by its
    layer's ``len``; a rolling (gemma3 local) layer writes at ``lens % rows``
    and attends to ``min(lens + 1, rows)`` rows, RoPE still at ``lens``. The
    cache is updated in place and returned: every tensor of it, ``lens`` and
    ``pos`` included, stays the same tensor, so a CUDA graph of the step
    reads and writes the same buffers at each replay (the write index is
    computed from ``lens`` on the device, at each replay).
    """
    lens = cache["lens"]
    slots = cache_slots(cfg)
    local = cache.get("kv_local")
    at_local = lens % local["k"].shape[3] if local is not None else None

    def attend(p, acfg, h, i, rope, residual):
        rolling = slots[i][0] == "kv_local"
        return attn.decode_attention_step(p, acfg, h, _layer_cache(cache, slots[i]),
                                          at_local if rolling else lens, policy,
                                          rolling=rolling, rope=rope, residual=residual,
                                          path="attn")[0]

    return _decode_layers(params, token_t, cache, cfg, policy, attend)


def init_paged_cache(cfg: ModelCfg, B: int, n_blocks: int, block_tokens: int,
                     table_width: int, policy: TransPolicy, *, device="cuda") -> dict:
    """Paged serving cache: one block pool a layer, stacked,
    ``kv.k/v: (L, n_blocks, Hkv, block_tokens, hd)``; a block table
    ``(B, table_width)`` int32 shared by every layer, sentinel-filled
    (``n_blocks``: every entry empty until the engine installs real tables,
    so writes drop and reads are zeros); and the slot grid's ``lens``/``pos``.
    Only the dense and moe families page their KV (``PAGED_FAMILIES``):
    gemma3's window-sized local buffers keep the slot grid, as in the
    reference."""
    _require_paged(cfg)
    device = resolve_device(device)
    return {
        "kv": attn.init_paged_kv_pool(n_blocks, block_tokens, attn_cfg(cfg), policy,
                                      device=device, n_layers=cfg.n_layers),
        "table": torch.full((B, table_width), n_blocks, dtype=torch.int32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
        "lens": torch.zeros((B,), dtype=torch.int32, device=device),
    }


def decode_step_paged(params: dict, token_t: torch.Tensor, cache: dict, cfg: ModelCfg,
                      policy: TransPolicy) -> tuple:
    """``decode_step`` over the paged pool: the same layer body (RoPE tables,
    fused residuals), each layer's attention through its pool and the shared
    block table: row b writes at ``table[b, lens[b] // bt]``, offset
    ``lens[b] % bt``, and attends to ``lens[b] + 1`` positions. Every tensor
    of the cache (the table, ``lens``, ``pos``, the pools) stays the same
    tensor, updated in place."""
    _require_paged(cfg)
    lens, table, kv = cache["lens"], cache["table"], cache["kv"]
    lengths = lens + 1

    def attend(p, acfg, h, i, rope, residual):
        return attn.decode_attention_step_paged(p, acfg, h, {"k": kv["k"][i], "v": kv["v"][i]},
                                                table, lens, policy, rope=rope,
                                                residual=residual, lengths=lengths,
                                                path="attn")[0]

    return _decode_layers(params, token_t, cache, cfg, policy, attend)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelCfg, policy: TransPolicy,
            *, S_max: Optional[int] = None) -> tuple:
    """Run the full prompt, build the cache, return last-position logits.
    A gemma3 local layer attends over its window and keeps the last
    ``min(S_max, window)`` positions in its rolling buffer."""
    _require_served(cfg)
    check_ported(policy)
    B, S = tokens.shape
    S_max = S_max or S
    device = params["embed"]["table"].device
    cache = init_cache(cfg, B, S_max, policy, device=device)
    acfgs = layer_attn_cfgs(cfg)
    slots = cache_slots(cfg)
    ropes = _rope_by_base(torch.arange(S, device=device)[None], acfgs)
    x = apply_embedding(params["embed"], tokens)
    for i, (p, acfg) in enumerate(zip(params["blocks"], acfgs)):
        h = apply_rmsnorm(p["ln1"], x, cfg.norm_eps)
        # the residuals fuse into wo's epilogue (and a dense MLP's down projection's)
        x, _ = attn.prefill_attention(p["attn"], acfg, h, _layer_cache(cache, slots[i]),
                                      policy, rope=ropes[acfg.rope_base], residual=x,
                                      path="attn")
        h = apply_rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = _ffn(p, h, x, cfg, policy)
    h = apply_rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    logits = logits_fn(params, h, cfg, policy)[:, 0]
    cache["pos"].fill_(S)
    cache["lens"].fill_(S)
    return logits, cache
