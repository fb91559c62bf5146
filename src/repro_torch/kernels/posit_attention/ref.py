"""Plain-torch version of posit-KV decode attention (untiled, full softmax)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.codec import posit_decode

NEG_INF = -1e30


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
    if kv_bits:
        k = posit_decode(k_codes, kv_bits, es)
        v = posit_decode(v_codes, kv_bits, es)
    else:
        k = k_codes.to(torch.float32)
        v = v_codes.to(torch.float32)
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
