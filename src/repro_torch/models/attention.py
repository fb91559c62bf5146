"""Attention for the dense decoder and the encoder-decoder: training and
encoder self-attention (full-sequence SDPA, causal or not, sliding-window
where ``cfg.window`` is set, no cache), prefill (the same, filling the KV
cache; a window-sized rolling cache keeps the last positions at their
``pos % rows`` slots) and one decode step over a posit-coded KV cache:
self-attention, which writes its new K/V row, or cross-attention, which
reads a prefilled encoder cache as it is.

KV-cache transprecision: when ``policy.kv_cache`` is a posit format the cache
holds uint8/uint16 codes. Prefill encodes its K/V block on write (the encode
kernel); a decode step hands its new K/V row to the decode-attention kernel,
which encodes and writes it and attends over the codes, decoding tile by
tile. Cache layout ``(B, Hkv, S, hd)``; a paged pool is ``(N, Hkv, bt, hd)``
read through a block table (``decode_attention_step_paged``).

The port updates the cache in place (the reference returns new arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.pcsr import TransPolicy
from repro_torch.kernels.posit_attention import ops as attn_ops
from repro_torch.kernels.posit_codec import ops as codec_ops
from repro_torch.models.layers import apply_linear, apply_rope, init_linear, rope_tables

NEG_INF = -1e30
Q_CHUNK = 512  # query-block size of the full-sequence SDPA


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    rope_base: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    window: int = 0
    is_cross: bool = False


def init_attention(gen: torch.Generator, cfg: AttnCfg, *, device="cpu", policy=None,
                   path: str = "attn") -> dict:
    """The four projections; under ``policy`` each is quantized as it is
    drawn, to the format its path (``{path}/wq`` ...) resolves to."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    kw = dict(device=device, policy=policy)
    return {
        "wq": init_linear(gen, d, H * hd, bias=cfg.qkv_bias, path=f"{path}/wq", **kw),
        "wk": init_linear(gen, d, Hkv * hd, bias=cfg.qkv_bias, path=f"{path}/wk", **kw),
        "wv": init_linear(gen, d, Hkv * hd, bias=cfg.qkv_bias, path=f"{path}/wv", **kw),
        "wo": init_linear(gen, H * hd, d, scale=(H * hd) ** -0.5, path=f"{path}/wo", **kw),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _sdpa_block(qg, k, v, scale, *, offset: int, causal: bool, window: int = 0):
    """One query block. qg: (B,Lq,Hkv,g,hd); k/v: (B,T,Hkv,hd); offset: the
    absolute position of the block's first query; ``window`` > 0 keeps the
    keys ``kp > qp - window`` (0: unbounded). Returns (B,Lq,Hkv,g,hd)."""
    Lq = qg.shape[1]
    T = k.shape[1]
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32) * scale,
                          k.to(torch.float32))
    if causal or window > 0:
        qp = torch.arange(Lq, device=qg.device)[:, None] + offset
        kp = torch.arange(T, device=qg.device)[None, :]
        m = torch.ones((Lq, T), dtype=torch.bool, device=qg.device)
        if causal:
            m &= kp <= qp
        if window > 0:
            m &= kp > qp - window
        scores = torch.where(m[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))


def _sdpa(q, k, v, scale, *, causal: bool = True, window: int = 0,
          q_chunk: int = Q_CHUNK):
    """The full-sequence SDPA of training and prefill, in plain torch (the
    reference computes it outside any kernel too), one (B, H, q_chunk, T)
    score slab at a time; differentiable. ``window`` > 0 is a sliding
    window: a query sees itself and the ``window - 1`` keys before it.
    q: (B,S,H,hd), k/v: (B,T,Hkv,hd)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    outs = [_sdpa_block(qg[:, i:i + q_chunk], k, v, scale, offset=i, causal=causal,
                        window=window)
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


# ------------------------------------------------------------- KV cache -------

def _cache_dtype(policy: TransPolicy) -> torch.dtype:
    fmt = policy.kv_cache
    if fmt is not None:
        return fmt.storage_dtype
    return torch.float32 if policy.compute_dtype == "f32" else torch.bfloat16


def init_kv_cache(B: int, S_max: int, cfg: AttnCfg, policy: TransPolicy, *,
                  device="cpu", n_layers: Optional[int] = None) -> dict:
    """Cache layout (B, Hkv, S_max, hd), posit codes if policy.kv_cache is
    set; ``n_layers`` stacks one cache per layer on a leading axis."""
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (B, cfg.n_kv, S_max, cfg.head_dim)
    dt = _cache_dtype(policy)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "len": torch.zeros(lead + (B,), dtype=torch.int32, device=device)}


def layer_cache(kv: dict, i: int) -> dict:
    """Layer i's views into a stacked cache (writes land in the stack)."""
    return {"k": kv["k"][i], "v": kv["v"][i], "len": kv["len"][i]}


def _store(cache_arr: torch.Tensor, new: torch.Tensor, pos: int, policy: TransPolicy) -> None:
    """Write the (B, Hkv, s, hd) block ``new`` into ``cache_arr`` at sequence
    offset ``pos``, in place (encoded for a posit cache). A decode step's
    row goes in through ``decode_attention_append`` instead."""
    fmt = policy.kv_cache
    if fmt is not None:
        new = codec_ops.encode(new.to(torch.float32).contiguous(), fmt.es, nbits=fmt.nbits)
    else:
        new = new.to(cache_arr.dtype)
    cache_arr[:, :, pos:pos + new.shape[2]] = new


def _self_attention(params: dict, cfg: AttnCfg, x: torch.Tensor, policy: TransPolicy, *,
                    rope=None, residual: Optional[torch.Tensor] = None,
                    path: str = "attn") -> tuple:
    """Full-sequence self-attention without a cache, causal as ``cfg`` says:
    the q/k/v linears, RoPE at positions 0..S-1 where ``cfg.use_rope``
    (``rope`` their ``rope_tables`` at ``cfg.rope_base``, made here when
    None), the plain SDPA (over ``cfg.window`` where it is set) and wo with
    ``residual`` fused. Returns (y, k, v), k and v (B, S, Hkv,
    hd) after RoPE."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = _split_heads(apply_linear(params["wq"], x, policy, path=f"{path}/wq"), H, hd)
    k = _split_heads(apply_linear(params["wk"], x, policy, path=f"{path}/wk"), Hkv, hd)
    v = _split_heads(apply_linear(params["wv"], x, policy, path=f"{path}/wv"), Hkv, hd)
    if cfg.use_rope:
        if rope is None:
            rope = rope_tables(torch.arange(S, device=x.device)[None], hd, cfg.rope_base)
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
    out = _sdpa(q, k, v, hd ** -0.5, causal=cfg.causal,
                window=cfg.window if not cfg.is_cross else 0)
    y = apply_linear(params["wo"], out.reshape(B, S, H * hd), policy, residual=residual,
                     path=f"{path}/wo")
    return y, k, v


def apply_attention(params: dict, cfg: AttnCfg, x: torch.Tensor, policy: TransPolicy, *,
                    rope=None, residual: Optional[torch.Tensor] = None,
                    path: str = "attn") -> torch.Tensor:
    """Training attention (the reference's ``apply_attention_dynwin`` at
    the layer's window, ``cfg.window``, 0 for full causal, and its RoPE
    base), and the encoder's (``cfg.causal`` False, no RoPE): self-attention
    over the whole sequence, no cache, differentiable. x: (B, S, D);
    ``rope`` the tables of positions 0..S-1 at ``cfg.rope_base`` (shared by
    every layer of that base; made here when None); ``residual`` fuses into
    the wo epilogue (the reference adds it after wo: the same f32 sum)."""
    return _self_attention(params, cfg, x, policy, rope=rope, residual=residual, path=path)[0]


def prefill_attention(params: dict, cfg: AttnCfg, x: torch.Tensor, cache: dict,
                      policy: TransPolicy, *, rope=None,
                      residual: Optional[torch.Tensor] = None, path: str = "attn") -> tuple:
    """Full-sequence causal attention that also fills the KV cache (in place).
    x: (B, S, D); ``residual`` fuses into the wo epilogue; ``rope`` the
    tables of positions 0..S-1 at ``cfg.rope_base`` (made here when None);
    ``path`` names the projections for a per-layer policy. A sliding-window
    layer (``cfg.window``) may have fewer cache rows than the prompt: its
    rolling buffer keeps the last ``rows`` positions, position p at row
    ``p % rows``, so decode continues there, and ``len`` is ``min(S,
    rows)``, as in the reference. Returns (y, cache)."""
    S = x.shape[1]
    Sc = cache["k"].shape[2]
    if S > Sc and not cfg.window:
        raise ValueError(f"prompt of {S} tokens exceeds the cache's {Sc} rows")
    y, k, v = _self_attention(params, cfg, x, policy, rope=rope, residual=residual, path=path)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)             # (B, Hkv, S, hd)
    if S > Sc:
        kt, vt = (torch.roll(t[:, :, S - Sc:], shifts=S % Sc, dims=2) for t in (kt, vt))
    _store(cache["k"], kt, 0, policy)
    _store(cache["v"], vt, 0, policy)
    cache["len"].fill_(min(S, Sc))
    return y, cache


def resolve_attn_impl(policy: TransPolicy, cfg: AttnCfg, *, rolling: bool = False) -> str:
    """"kernel" wherever the decode-attention kernel's contract covers the
    layer (everything but a non-rolling sliding window), else "xla"."""
    impl = getattr(policy, "attn_impl", "auto")
    if impl == "xla":
        return "xla"
    if cfg.window > 0 and not rolling and not cfg.is_cross:
        if impl == "kernel":
            raise ValueError(
                "attn_impl='kernel' cannot serve a non-rolling "
                f"sliding-window layer (window={cfg.window}); use a "
                "window-sized rolling cache or attn_impl='auto'/'xla'")
        return "xla"
    return "kernel"


def _decode_attention(params: dict, cfg: AttnCfg, x_t: torch.Tensor, pos: torch.Tensor,
                      policy: TransPolicy, attend, *, rolling: bool = False, rope=None,
                      residual: Optional[torch.Tensor] = None,
                      path: str = "attn") -> torch.Tensor:
    """A decode step's attention around its kernel call: the q/k/v linears
    (q alone for cross-attention, whose K/V are the encoder's, already in
    the cache), RoPE at the rows' sequence positions (``rope`` the step's
    tables; made here from ``pos`` when None, which a rolling layer, whose
    write index is not its position, may not ask), then ``attend(q (B, H, hd), k_new (B, Hkv, hd), v_new, es,
    kv_bits)``, all float32 (k_new and v_new None for cross-attention), for
    the (B, H, hd) output, and wo with ``residual`` fused."""
    B = x_t.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    if resolve_attn_impl(policy, cfg, rolling=rolling) != "kernel":
        raise NotImplementedError("only the decode-attention kernel path is ported")
    q = _split_heads(apply_linear(params["wq"], x_t, policy, path=f"{path}/wq"), H, hd)
    kn = vn = None
    if not cfg.is_cross:
        kn = _split_heads(apply_linear(params["wk"], x_t, policy, path=f"{path}/wk"), Hkv, hd)
        vn = _split_heads(apply_linear(params["wv"], x_t, policy, path=f"{path}/wv"), Hkv, hd)
        if cfg.use_rope:
            if rope is None:
                if rolling:
                    raise ValueError("a rolling layer writes at its position modulo the "
                                     "buffer: pass the step's RoPE tables")
                rope = rope_tables(pos.reshape(B, 1), hd, cfg.rope_base)
            q, kn = apply_rope(q, *rope), apply_rope(kn, *rope)
        kn, vn = (t.reshape(B, Hkv, hd).to(torch.float32).contiguous() for t in (kn, vn))
    fmt = policy.kv_cache
    es, kv_bits = (fmt.es, fmt.nbits) if fmt is not None else (0, 0)
    out = attend(q.reshape(B, H, hd).to(torch.float32).contiguous(), kn, vn, es, kv_bits)
    return apply_linear(params["wo"], out.reshape(B, 1, H * hd).to(x_t.dtype), policy,
                        residual=residual, path=f"{path}/wo")


def decode_attention_step(params: dict, cfg: AttnCfg, x_t: torch.Tensor, cache: dict,
                          pos: torch.Tensor, policy: TransPolicy, *,
                          rolling: bool = False, rope=None,
                          residual: Optional[torch.Tensor] = None,
                          path: str = "attn") -> tuple:
    """One decode step. x_t: (B, 1, D); pos: (B,) int32 per-row cache write
    index (= the row's sequence position; a rolling cache's caller passes it
    modulo the buffer size, ``rolling=True``, and the RoPE tables of the
    sequence positions). Counts the new K/V row in ``cache["len"]``
    (clamped to the buffer size, which is all a rolling cache's validity
    needs), then writes it in place and attends in one call of the
    decode-attention kernel (``decode_attention_append``). Cross-attention
    (``cfg.is_cross``) reads the prefilled encoder cache instead: no k/v
    linears, no write, ``cache["len"]`` unchanged, one call of the kernel's
    no-append mode (``decode_attention``). ``rope`` is the step's
    ``rope_tables`` of the rows' positions at ``cfg.rope_base`` (shared by
    every layer of that base; made here from ``pos`` when None, except on a
    rolling call); ``residual`` fuses into the wo epilogue; ``path`` names the
    projections for a per-layer policy. Returns (y, cache)."""

    def attend(q, kn, vn, es, kv_bits):
        if cfg.is_cross:
            return attn_ops.decode_attention(q, cache["k"], cache["v"], cache["len"], es,
                                             kv_bits=kv_bits)
        # a slot never holds more than S_cache valid positions (recycled engine
        # slots would otherwise grow `len` between eviction and reuse)
        cache["len"].add_(1).clamp_(max=cache["k"].shape[2])
        # the row's encode, its cache write and attention in one launch
        return attn_ops.decode_attention_append(q, kn, vn, cache["k"], cache["v"], pos,
                                                cache["len"], es, kv_bits=kv_bits)

    y = _decode_attention(params, cfg, x_t, pos, policy, attend, rolling=rolling, rope=rope,
                          residual=residual, path=path)
    return y, cache


def init_paged_kv_pool(n_blocks: int, block_tokens: int, cfg: AttnCfg, policy: TransPolicy, *,
                       device="cpu", n_layers: Optional[int] = None) -> dict:
    """A paged KV pool ``(n_blocks, Hkv, block_tokens, hd)`` (stacked on a
    leading layer axis with ``n_layers``), zeros, with ``init_kv_cache``'s
    dtype rule. The per-slot lengths live with the engine (``cache["lens"]``)
    and the block table is shared by every layer."""
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (n_blocks, cfg.n_kv, block_tokens, cfg.head_dim)
    dt = _cache_dtype(policy)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention_step_paged(params: dict, cfg: AttnCfg, x_t: torch.Tensor, pool: dict,
                                block_table: torch.Tensor, lens: torch.Tensor,
                                policy: TransPolicy, *, lengths: torch.Tensor, rope=None,
                                residual: Optional[torch.Tensor] = None,
                                path: str = "attn") -> tuple:
    """One decode step over a paged KV pool: ``decode_attention_step`` with the
    layer's cache swapped for ``pool`` (``{"k", "v"}``, ``(N, Hkv, bt, hd)``)
    and the slot grid's block table ``(B, W)``. ``lens`` (B,) is each row's
    write index (its valid length before this token); the new K/V row goes to
    block ``block_table[b, lens[b] // bt]`` at offset ``lens[b] % bt`` and the
    row attends to ``lengths`` (``lens + 1``, made once a step) positions, in
    one launch of the paged kernel (``decode_attention_append_paged``). The
    engine makes the write target a private block before the step
    (copy-on-write), so no two rows write one page. ``rope``, ``residual`` and
    ``path`` are ``decode_attention_step``'s. Returns (y, pool)."""

    def attend(q, kn, vn, es, kv_bits):
        return attn_ops.decode_attention_append_paged(q, kn, vn, pool["k"], pool["v"],
                                                      block_table, lens, lengths, es,
                                                      kv_bits=kv_bits)

    y = _decode_attention(params, cfg, x_t, lens, policy, attend, rope=rope, residual=residual,
                          path=path)
    return y, pool
