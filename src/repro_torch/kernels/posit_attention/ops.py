"""Front door for posit-KV decode attention: the CUDA kernel for CUDA tensors,
the plain version (``ref.py``) for CPU tensors.

``kv_bits=0`` means a float KV cache (f32 or bf16): the codec is bypassed.
``rolling=True`` is circular-buffer validity: every slot written so far is
valid, so lengths clamp to the buffer size.

``decode_attention_append`` is the decode step's fused call: it writes the
step's new K/V row into the cache (encoded, for a posit cache) and attends
over the cache including it, in one launch.

``decode_attention_paged`` and ``decode_attention_append_paged`` are the same
two calls over a paged pool ``(N, Hkv, bt, d)`` and a block table ``(B, W)``
(the reference's ``posit_decode_attention_paged``): the kernel reads the
table itself, and a table entry ``>= N`` is empty.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels import build, check_rc, on_cpu, require, stream_handle
from repro_torch.kernels.posit_attention import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "posit_attention_launch": (_P,) * 10 + (_I,) * 10 + (ctypes.c_float, _P),
    "posit_attention_paged_launch": (_P,) * 11 + (_I,) * 12 + (ctypes.c_float, _P),
    "posit_attention_warps": (_I, _I),
}
_KV_KIND = {(8, torch.uint8): 2, (16, torch.uint16): 3,
            (0, torch.float32): 0, (0, torch.bfloat16): 1}
CHUNK = ref.CHUNK  # positions a split


def _lib():
    return build.load("posit_attention", _SIGNATURES)


def _plan(S: int, g: int) -> tuple[int, int]:
    """(splits, q-head groups) of the kernel's grid at g q-heads a KV head:
    the plan the scratch is sized by, handed to the launch, which refuses
    any plan but its own."""
    return -(-S // CHUNK), -(-g // ref.HEADS)


def kernel_warps(kv_bits: int, dtype: torch.dtype, d: int) -> int:
    """Warps a block of the CUDA kernel at head_dim ``d`` (needs the built
    library: ``ref.kernel_warps`` is its copy for the CPU emulation)."""
    return _lib().posit_attention_warps(_KV_KIND[(kv_bits, dtype)], d)


def _check(q, k_codes, v_codes, lengths):
    require(q.dim() == 3 and k_codes.dim() == 4 and k_codes.shape == v_codes.shape,
            f"shapes q {tuple(q.shape)}, k {tuple(k_codes.shape)}, v {tuple(v_codes.shape)}")
    B, Hq, d = q.shape
    Bk, Hkv, S, dk = k_codes.shape
    require((B, d) == (Bk, dk) and Hq % Hkv == 0,
            f"q {tuple(q.shape)} does not match KV {tuple(k_codes.shape)}")
    require(tuple(lengths.shape) == (B,), f"lengths must be ({B},)")


def _launch(q, k_codes, v_codes, lengths, es, kv_bits, scale, append=None, table=None):
    """The kernel on CUDA tensors; ``append`` = (k_new, v_new, pos) or None;
    ``table`` the (B, W) block table of a paged pool (N, Hkv, bt, d), or
    None for a dense cache (B, Hkv, S, d)."""
    B, Hq, d = q.shape
    if table is None:
        _, Hkv, S, _ = k_codes.shape
    else:
        N, Hkv, bt, _ = k_codes.shape
        W = table.shape[1]
        S = W * bt
        require(table.dtype == torch.int32, f"block_table must be int32, got {table.dtype}")
        require(N * Hkv * bt < 2 ** 31 and S <= 2 ** 30, "pool or table too large for the kernel")
    kind = _KV_KIND.get((kv_bits, k_codes.dtype))
    require(kind is not None and v_codes.dtype == k_codes.dtype,
            f"kv_bits={kv_bits} does not take a {k_codes.dtype} cache")
    require(q.dtype == torch.float32, f"q must be float32, got {q.dtype}")
    require(lengths.dtype == torch.int32, f"lengths must be int32, got {lengths.dtype}")
    # the widest head of src/repro/configs (gemma3-4b) is 256
    require(d <= 256, f"head_dim {d} > 256: the kernel holds at most 256 columns a row")
    require(d % 16 == 0, f"head_dim {d} is not a multiple of 16, the kernel's MMA tile")
    tensors = [("q", q), ("k", k_codes), ("v", v_codes), ("lengths", lengths)]
    if table is not None:
        tensors.append(("block_table", table))
    if append is not None:
        tensors += list(zip(("k_new", "v_new", "pos"), append))
    for name, t in tensors:
        require(t.is_contiguous(), f"{name} must be contiguous")
    require(all(t.data_ptr() % 16 == 0 for t in (q, k_codes, v_codes)),
            "q and the K/V caches must start on 16-byte boundaries")
    out = torch.empty((B, Hq, d), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    nsx, n_hg = _plan(S, Hq // Hkv)
    stream = stream_handle(q)
    part = counters = None
    if nsx > 1:  # (m, l, acc) of up to HEADS q-heads a split
        part = torch.empty(B * Hkv * n_hg * nsx * ref.HEADS * (d + 2), dtype=torch.float32,
                           device=q.device)
        counters = kernels.zeroed_counters(q.device, stream, B * Hkv * n_hg)
    k_new, v_new, pos = append if append is not None else (None, None, None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    if table is None:
        rc = _lib().posit_attention_launch(
            q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), ptr(k_new), ptr(v_new), ptr(pos), ptr(part), ptr(counters),
            B, Hq, Hkv, S, d, kind, int(es), CHUNK, nsx, n_hg, float(scale), stream)
        check_rc(rc, "posit_attention")
        kernels.LAUNCHES["posit_attention"] += 1
        return out
    rc = _lib().posit_attention_paged_launch(
        q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(), table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), ptr(k_new), ptr(v_new), ptr(pos), ptr(part),
        ptr(counters), B, Hq, Hkv, N, W, bt, d, kind, int(es), CHUNK, nsx, n_hg, float(scale),
        stream)
    check_rc(rc, "posit_attention_paged")
    kernels.LAUNCHES["posit_attention_paged"] += 1
    return out


def decode_attention(q: torch.Tensor, k_codes: torch.Tensor, v_codes: torch.Tensor,
                     lengths: torch.Tensor, es: int, *, kv_bits: int,
                     scale: Optional[float] = None, rolling: bool = False) -> torch.Tensor:
    """One decode-attention step. q (B, Hq, d) float32; k/v (B, Hkv, S, d);
    lengths (B,) int32 valid KV length per row. Returns (B, Hq, d)."""
    _check(q, k_codes, v_codes, lengths)
    d, S = q.shape[-1], k_codes.shape[2]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if rolling:
        lengths = torch.clamp(lengths, max=S)
    if on_cpu(q, k_codes, v_codes, lengths):
        return ref.posit_decode_attention_ref(q, k_codes, v_codes, lengths, es,
                                              kv_bits=kv_bits, scale=scale)
    return _launch(q, k_codes, v_codes, lengths, es, kv_bits, scale)


def decode_attention_append(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                            lengths: torch.Tensor, es: int, *, kv_bits: int,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The decode step's KV write and attention in one call. k_new/v_new
    (B, Hkv, d) float32 rows go into the caches (B, Hkv, S, d) at ``pos[b]``,
    in place: posit-encoded (no ftz) for kv_bits 8/16, cast for a float cache;
    rows with ``pos[b]`` outside [0, S) are not written. Then each row attends
    to its first ``lengths[b]`` slots, the new one through its written codes.
    ``lengths`` already counts the new row. Returns (B, Hq, d)."""
    _check(q, k_cache, v_cache, lengths)
    B, Hkv, _, d = k_cache.shape
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        require(tuple(t.shape) == (B, Hkv, d), f"{name} must be ({B}, {Hkv}, {d})")
    require(tuple(pos.shape) == (B,), f"pos must be ({B},)")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if on_cpu(q, k_new, v_new, k_cache, v_cache, pos, lengths):
        return ref.decode_attention_append_ref(q, k_new, v_new, k_cache, v_cache, pos,
                                               lengths, es, kv_bits=kv_bits, scale=scale)
    require(k_new.dtype == torch.float32 and v_new.dtype == torch.float32,
            "k_new and v_new must be float32")
    require(pos.dtype == torch.int32, f"pos must be int32, got {pos.dtype}")
    return _launch(q, k_cache, v_cache, lengths, es, kv_bits, scale, (k_new, v_new, pos))


def _check_paged(q, k_pool, v_pool, block_table, lengths):
    require(q.dim() == 3 and k_pool.dim() == 4 and k_pool.shape == v_pool.shape,
            f"shapes q {tuple(q.shape)}, k pool {tuple(k_pool.shape)}, "
            f"v pool {tuple(v_pool.shape)}")
    B, Hq, d = q.shape
    _, Hkv, _, dk = k_pool.shape
    require(d == dk and Hq % Hkv == 0,
            f"q {tuple(q.shape)} does not match the pool {tuple(k_pool.shape)}")
    require(block_table.dim() == 2 and block_table.shape[0] == B,
            f"block_table must be ({B}, W), got {tuple(block_table.shape)}")
    require(tuple(lengths.shape) == (B,), f"lengths must be ({B},)")


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           block_table: torch.Tensor, lengths: torch.Tensor, es: int, *,
                           kv_bits: int, scale: Optional[float] = None) -> torch.Tensor:
    """``decode_attention`` over a paged pool. q (B, Hq, d) float32; k/v pools
    (N, Hkv, bt, d); block_table (B, W) int32, position p of row b in block
    ``block_table[b, p // bt]`` at offset ``p % bt``, an entry >= N empty (its
    rows read as zeros); lengths (B,) int32, clamped to W * bt. Returns
    (B, Hq, d)."""
    _check_paged(q, k_pool, v_pool, block_table, lengths)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if on_cpu(q, k_pool, v_pool, block_table, lengths):
        return ref.posit_decode_attention_paged_ref(q, k_pool, v_pool, block_table, lengths,
                                                    es, kv_bits=kv_bits, scale=scale)
    return _launch(q, k_pool, v_pool, lengths, es, kv_bits, scale, table=block_table)


def decode_attention_append_paged(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                                  k_pool: torch.Tensor, v_pool: torch.Tensor,
                                  block_table: torch.Tensor, pos: torch.Tensor,
                                  lengths: torch.Tensor, es: int, *, kv_bits: int,
                                  scale: Optional[float] = None) -> torch.Tensor:
    """``decode_attention_append`` over a paged pool: k_new/v_new (B, Hkv, d)
    float32 rows go into block ``block_table[b, pos[b] // bt]`` at offset
    ``pos[b] % bt``, in place (encoded as the dense append encodes); a row
    whose ``pos[b]`` is negative, at or past W * bt, or whose entry is empty
    is not written. Then ``decode_attention_paged`` with ``lengths``, which
    already counts the new row. Returns (B, Hq, d)."""
    _check_paged(q, k_pool, v_pool, block_table, lengths)
    B, d = q.shape[0], q.shape[-1]
    Hkv = k_pool.shape[1]
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        require(tuple(t.shape) == (B, Hkv, d), f"{name} must be ({B}, {Hkv}, {d})")
    require(tuple(pos.shape) == (B,), f"pos must be ({B},)")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if on_cpu(q, k_new, v_new, k_pool, v_pool, block_table, pos, lengths):
        return ref.decode_attention_append_paged_ref(q, k_new, v_new, k_pool, v_pool,
                                                     block_table, pos, lengths, es,
                                                     kv_bits=kv_bits, scale=scale)
    require(k_new.dtype == torch.float32 and v_new.dtype == torch.float32,
            "k_new and v_new must be float32")
    require(pos.dtype == torch.int32, f"pos must be int32, got {pos.dtype}")
    return _launch(q, k_pool, v_pool, lengths, es, kv_bits, scale, (k_new, v_new, pos),
                   table=block_table)
