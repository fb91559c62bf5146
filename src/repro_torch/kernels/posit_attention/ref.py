"""Plain-torch versions of posit-KV decode attention: the untiled full
softmax (``posit_decode_attention_ref``), the decode step's fused KV append
(``decode_attention_append_ref``), and a CPU emulation of the CUDA kernel's
split-and-combine order (``posit_decode_attention_split_ref``); and the same
three over a paged pool ``(N, Hkv, bt, d)`` read through a block table
``(B, W)`` (``posit_decode_attention_paged_ref``,
``decode_attention_append_paged_ref``,
``posit_decode_attention_paged_split_ref``), where an entry outside [0, N)
is empty and its rows read as zeros."""
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
    k, v = _decoded(k_codes, v_codes, es, kv_bits)
    return _split_attention(q, lambda idx: (k[:, :, idx], v[:, :, idx]), k_codes.shape[2],
                            lengths, k_codes.element_size(), kv_bits, scale)


def _table_rows(table: torch.Tensor, n_blocks: int, bt: int, idx: torch.Tensor):
    """Block and offset of positions ``idx`` (P,) in each row's table (B, W),
    as the kernel finds them: (block (B, P) with 0 for an empty entry,
    offset (P,), present (B, P)). Positions past W * bt read as empty."""
    W = table.shape[1]
    blk = table.to(torch.int64)[:, torch.clamp(idx // bt, max=W - 1)]
    present = (blk >= 0) & (blk < n_blocks) & (idx < W * bt)[None]
    return torch.where(present, blk, 0), idx % bt, present


def posit_decode_attention_paged_split_ref(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, block_table: torch.Tensor,
    lengths: torch.Tensor, es: int, *, kv_bits: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """``posit_decode_attention_split_ref`` with the kernel's paged
    addressing: each position of each (split, step, warp) slot is looked up
    in its row's table (block ``table[b, p // bt]``, offset ``p % bt``), an
    empty entry's K and V zero; S = W * bt. Same contract as
    ``posit_decode_attention_paged_ref``."""
    N, _, bt, _ = k_pool.shape
    k, v = _decoded(k_pool, v_pool, es, kv_bits)

    def gather(idx):
        blk, off, present = _table_rows(block_table, N, bt, idx)
        keep = present[:, None, :, None]
        # (B, P, Hkv, d) -> (B, Hkv, P, d)
        return tuple(torch.where(keep, t[blk, :, off].permute(0, 2, 1, 3), 0.0)
                     for t in (k, v))

    return _split_attention(q, gather, block_table.shape[1] * bt, lengths,
                            k_pool.element_size(), kv_bits, scale)


def _split_attention(q, gather, S, lengths, elem_size, kv_bits, scale):
    """The split emulation over S positions; ``gather(idx)`` returns the
    decoded K and V rows (B, Hkv, P, d) of the positions ``idx`` (P,)."""
    B, Hq, d = q.shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    NW = kernel_warps(d, elem_size, kv_bits)
    nsx, bstep = -(-S // CHUNK), STEP * NW
    nt = -(-CHUNK // bstep)
    lens = torch.clamp(lengths.to(torch.int64), 0, S)
    # position of (split, step, warp, slot), valid below the row's length
    r = torch.arange(nt * bstep).reshape(nt, NW, STEP)
    pos = torch.arange(nsx)[:, None, None, None] * CHUNK + r                 # (nsx,nt,NW,STEP)
    valid = (r < CHUNK) & (pos[None] < lens[:, None, None, None, None])      # (B,nsx,nt,NW,STEP)
    k, v = gather(torch.clamp(pos, max=S - 1).flatten())
    Hkv = k.shape[1]
    g = Hq // Hkv
    k = torch.where(valid[:, None, ..., None], k.reshape(B, Hkv, nsx, nt, NW, STEP, d), 0.0)
    v = torch.where(valid[:, None, ..., None], v.reshape(B, Hkv, nsx, nt, NW, STEP, d), 0.0)
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


def depage(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """The codes of a paged pool (N, Hkv, bt, d) as a dense cache
    (B, Hkv, W * bt, d) through the block table (B, W); an empty entry's
    rows are code 0 (exact 0.0)."""
    N, Hkv, bt, d = pool.shape
    B, W = block_table.shape
    blk, off, present = _table_rows(block_table, N, bt,
                                    torch.arange(W * bt, device=block_table.device))
    src = pool.view(torch.int16) if pool.dtype == torch.uint16 else pool
    rows = src[blk, :, off]                                       # (B, W*bt, Hkv, d)
    rows = torch.where(present[..., None, None], rows, torch.zeros((), dtype=rows.dtype))
    rows = rows.permute(0, 2, 1, 3).contiguous()
    return rows.view(torch.uint16) if pool.dtype == torch.uint16 else rows


def posit_decode_attention_paged_ref(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, block_table: torch.Tensor,
    lengths: torch.Tensor, es: int, *, kv_bits: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """q (B, Hq, d); k/v pools (N, Hkv, bt, d); block_table (B, W), an entry
    outside [0, N) empty; lengths (B,), clamped to W * bt. De-pages through
    the table (``depage``) and attends with ``posit_decode_attention_ref``."""
    S = block_table.shape[1] * k_pool.shape[2]
    return posit_decode_attention_ref(q, depage(k_pool, block_table),
                                      depage(v_pool, block_table),
                                      torch.clamp(lengths, max=S), es, kv_bits=kv_bits,
                                      scale=scale)


def store_row_paged(pool: torch.Tensor, new: torch.Tensor, block_table: torch.Tensor,
                    pos: torch.Tensor, es: int, *, kv_bits: int) -> None:
    """Write the (B, Hkv, d) rows ``new`` into ``pool`` (N, Hkv, bt, d) at
    block ``block_table[b, pos[b] // bt]``, offset ``pos[b] % bt``, in place,
    encoded as ``store_row`` encodes (the reference's ``_store_paged``). A row
    whose position is negative or at or past W * bt, or whose entry is empty,
    is not written."""
    N, _, bt, _ = pool.shape
    W = block_table.shape[1]
    new = (encode_ref(new.to(torch.float32), es, nbits=kv_bits) if kv_bits
           else new.to(pool.dtype))
    if pool.dtype == torch.uint16:  # torch indexes uint16 through int16 views
        pool, new = pool.view(torch.int16), new.view(torch.int16)
    p = pos.to(torch.int64)
    rows = torch.nonzero((p >= 0) & (p < W * bt)).flatten()
    blk = block_table.to(torch.int64)[rows, p[rows] // bt]
    keep = (blk >= 0) & (blk < N)
    rows, blk = rows[keep], blk[keep]
    pool[blk, :, p[rows] % bt] = new[rows]


def decode_attention_append_paged_ref(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, k_pool: torch.Tensor,
    v_pool: torch.Tensor, block_table: torch.Tensor, pos: torch.Tensor,
    lengths: torch.Tensor, es: int, *, kv_bits: int, scale: Optional[float] = None,
) -> torch.Tensor:
    """The paged append's plain version: ``store_row_paged`` of K and V, then
    ``posit_decode_attention_paged_ref`` over the updated pools."""
    store_row_paged(k_pool, k_new, block_table, pos, es, kv_bits=kv_bits)
    store_row_paged(v_pool, v_new, block_table, pos, es, kv_bits=kv_bits)
    return posit_decode_attention_paged_ref(q, k_pool, v_pool, block_table, lengths, es,
                                            kv_bits=kv_bits, scale=scale)
