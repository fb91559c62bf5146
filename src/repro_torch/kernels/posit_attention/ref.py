"""Plain-torch versions of posit-KV decode attention: the untiled full
softmax (``posit_decode_attention_ref``), the decode step's fused KV append
(``decode_attention_append_ref``), and a CPU emulation of the CUDA kernel's
split-and-combine order (``posit_decode_attention_split_ref``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codec import posit_decode
from repro_torch.kernels.posit_codec.ref import encode_ref

NEG_INF = -1e30
# the CUDA kernel's constants (csrc/posit_attention.cu): positions a split
# (ops.py hands it to the launch with the plan, and the launch refuses
# another), q-heads a block (the MMA's n), positions a warp step, shared
# bytes a block plans on
CHUNK, HEADS, STEP, BLOCK_SMEM = 512, 8, 16, 112640


def _decoded(k_codes, v_codes, es, kv_bits):
    if kv_bits:
        return posit_decode(k_codes, kv_bits, es), posit_decode(v_codes, kv_bits, es)
    return k_codes.to(torch.float32), v_codes.to(torch.float32)


def posit_decode_attention_ref(
    q: torch.Tensor, k_codes: torch.Tensor, v_codes: torch.Tensor,
    lengths: torch.Tensor, es: int, *, kv_bits: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Hq, d); k/v (B, Hkv, S, d) codes (float when kv_bits=0);
    lengths (B,). Rows attend to their first ``lengths[b]`` slots; masked
    slots get probability 0 and contribute a zero V (so stale codes, NaR
    included, cannot reach the output); a length-0 row returns zeros."""
    B, Hq, d = q.shape
    _, Hkv, S, _ = k_codes.shape
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    k, v = _decoded(k_codes, v_codes, es, kv_bits)
    valid = torch.arange(S, device=q.device)[None, :] < lengths.to(q.device)[:, None]
    v = torch.where(valid[:, None, :, None], v, 0.0)
    qg = q.to(torch.float32).reshape(B, Hkv, g, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k) * scale
    vmask = valid[:, None, None, :]
    scores = torch.where(vmask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(vmask, torch.exp(scores - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(denom == 0, 1.0, denom)
    out = torch.einsum("bkgs,bksd->bkgd", p, v)
    return out.reshape(B, Hq, d).to(q.dtype)


def store_row(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor, es: int, *,
              kv_bits: int) -> None:
    """Write the (B, Hkv, d) rows ``new`` into ``cache`` (B, Hkv, S, d) at
    sequence index ``pos[b]``, in place: posit-encoded without ftz for
    kv_bits 8/16 (the reference's ``_store``, src/repro/models/attention.py),
    cast for a float cache.
    Rows with ``pos[b]`` outside [0, S) are not written."""
    new = (encode_ref(new.to(torch.float32), es, nbits=kv_bits) if kv_bits
           else new.to(cache.dtype))
    if cache.dtype == torch.uint16:  # torch indexes uint16 through int16 views
        cache, new = cache.view(torch.int16), new.view(torch.int16)
    S = cache.shape[2]
    rows = torch.nonzero((pos >= 0) & (pos < S)).flatten()
    cache[rows, :, pos[rows].long()] = new[rows]


def decode_attention_append_ref(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, k_cache: torch.Tensor,
    v_cache: torch.Tensor, pos: torch.Tensor, lengths: torch.Tensor, es: int, *,
    kv_bits: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """The fused decode step's plain version: ``store_row`` of K and V, then
    ``posit_decode_attention_ref`` over the updated caches."""
    store_row(k_cache, k_new, pos, es, kv_bits=kv_bits)
    store_row(v_cache, v_new, pos, es, kv_bits=kv_bits)
    return posit_decode_attention_ref(q, k_cache, v_cache, lengths, es, kv_bits=kv_bits,
                                      scale=scale)


def kernel_warps(d: int, elem_bytes: int, kv_bits: int) -> int:
    """Warps a block of the CUDA kernel at head_dim ``d`` (``plan_warps``;
    chip_smoke.py holds this copy to ``ops.kernel_warps``):
    as many 2-stage rings of STEP K and STEP V rows as fit beside the decode
    table and q's MMA fragments (48 bytes a column) in BLOCK_SMEM, at most 8
    (4 above head_dim 128)."""
    table = {8: 256 * 32 * 4, 16: 257 * 128 + 256 * 4}.get(kv_bits, 0)
    free = BLOCK_SMEM - table - 48 * d
    return max(1, min(8 if d <= 128 else 4, free // (2 * 2 * STEP * d * elem_bytes)))


def posit_decode_attention_split_ref(
    q: torch.Tensor, k_codes: torch.Tensor, v_codes: torch.Tensor,
    lengths: torch.Tensor, es: int, *, kv_bits: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """The CUDA kernel's order of work on the CPU: splits of CHUNK positions,
    a row's split count from its own length; in a split, steps of STEP
    positions a warp (warp w takes positions t * STEP * NW + w * STEP .. of
    step t), an online softmax per warp (masked slots: score -1e30,
    probability 0, V zero-filled); the warps merged in warp order, then the
    row's splits combined in split order. The sums inside a step (the score
    dots, the fused multiply-adds) are torch's, so the bits are not the
    kernel's; the order of the softmax state's merges is. Same contract as
    ``posit_decode_attention_ref``."""
    B, Hq, d = q.shape
    _, Hkv, S, _ = k_codes.shape
    g = Hq // Hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    NW = kernel_warps(d, k_codes.element_size(), kv_bits)
    nsx, bstep = -(-S // CHUNK), STEP * NW
    nt = -(-CHUNK // bstep)
    k, v = _decoded(k_codes, v_codes, es, kv_bits)
    lens = torch.clamp(lengths.to(torch.int64), 0, S)
    # position of (split, step, warp, slot), valid below the row's length
    r = torch.arange(nt * bstep).reshape(nt, NW, STEP)
    pos = torch.arange(nsx)[:, None, None, None] * CHUNK + r                 # (nsx,nt,NW,STEP)
    valid = (r < CHUNK) & (pos[None] < lens[:, None, None, None, None])      # (B,nsx,nt,NW,STEP)
    idx = torch.clamp(pos, max=S - 1).flatten()
    k = torch.where(valid[:, None, ..., None],
                    k[:, :, idx].reshape(B, Hkv, nsx, nt, NW, STEP, d), 0.0)
    v = torch.where(valid[:, None, ..., None],
                    v[:, :, idx].reshape(B, Hkv, nsx, nt, NW, STEP, d), 0.0)
    valid = valid[:, None, :, :, :, None, :]                               # (B,1,nsx,nt,NW,1,STEP)
    qg = q.to(torch.float32).reshape(B, Hkv, 1, 1, g, 1, d)
    m = torch.full((B, Hkv, nsx, NW, g), NEG_INF)
    l = torch.zeros((B, Hkv, nsx, NW, g))
    acc = torch.zeros((B, Hkv, nsx, NW, g, d))
    for t in range(nt):
        kt, vt, ok = k[:, :, :, t], v[:, :, :, t], valid[:, :, :, t]
        s = torch.where(ok, (qg * kt[:, :, :, :, None]).sum(-1) * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)       # (B,Hkv,nsx,NW,g,STEP)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for i in range(STEP):
            acc = acc + p[..., i, None] * vt[:, :, :, :, None, i]
        m = m_new
    # the warps merge in warp order
    M = m.amax(dim=3)
    L = torch.zeros_like(M)
    A = torch.zeros((B, Hkv, nsx, g, d))
    for w in range(NW):
        e = torch.exp(m[:, :, :, w] - M)
        L = L + l[:, :, :, w] * e
        A = A + acc[:, :, :, w] * e[..., None]
    # a row's splits combine in split order
    n_split = torch.clamp(-(-lens // CHUNK), min=1)
    live = (torch.arange(nsx)[None, :] < n_split[:, None])[:, None, :, None]  # (B,1,nsx,1)
    M2 = torch.where(live, M, NEG_INF).amax(dim=2)
    L2 = torch.zeros_like(M2)
    A2 = torch.zeros((B, Hkv, g, d))
    for s in range(nsx):
        e = torch.where(live[:, :, s], torch.exp(M[:, :, s] - M2), 0.0)
        L2 = L2 + L[:, :, s] * e
        A2 = A2 + A[:, :, s] * e[..., None]
    out = A2 / torch.where(L2 == 0, 1.0, L2)[..., None]
    return out.reshape(B, Hq, d).to(q.dtype)
