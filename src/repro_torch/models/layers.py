"""Parameter init + core layer ops (linear, norm, rotary, MLP, embedding).

Parameter convention, as in the reference: nested dicts of tensors. Posit-
stored weights appear as ``{"w_codes": uint8/uint16 (K, N), "b": ...}`` after
``quantize_params``; float weights as ``{"w": (K, N)}``. The TransPolicy says
how to read them.

Every linear goes through a GEMM kernel wrapper: the posit GEMM
(``kernels.posit_gemm.ops.posit_gemm``), or under ``dataflow="quire"`` for
posit-coded weights the quire GEMM (``kernels.posit_quire_gemm``). On CUDA
tensors that is the hand-written kernel, on CPU tensors its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.dot import float_fmt, posit_dot, posit_matmul_wx
from repro_torch.core.pcsr import OperandSlots, TransPolicy
from repro_torch.core.types import F32, PositFmt
from repro_torch.kernels.posit_codec import ops as codec_ops
from repro_torch.kernels.posit_gemm.ops import posit_gemm


def compute_dtype(policy: TransPolicy) -> torch.dtype:
    return torch.float32 if policy.compute_dtype == "f32" else torch.bfloat16


def check_ported(policy: TransPolicy) -> None:
    """Raise on policy knobs whose code paths are not ported yet."""
    if policy.pack_weights:
        raise NotImplementedError("packed-p8 weights are not ported")
    if policy.codec_impl == "lut":
        raise NotImplementedError("codec_impl='lut' is not ported")
    if policy.epilogue != "fused":
        raise NotImplementedError(f"epilogue={policy.epilogue!r} is not ported")
    if policy.attn_impl == "xla":
        raise NotImplementedError("attn_impl='xla' (full-cache einsum) is not ported")


# ------------------------------------------------------------------ linear ----

def init_linear(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
                scale: Optional[float] = None, device="cpu",
                wfmt: Optional[PositFmt] = None) -> dict:
    """Random-normal (d_in, d_out) weight times ``scale`` (default d_in**-0.5),
    zero bias. ``wfmt`` quantizes it at once, so no f32 copy outlives the call."""
    if scale is None:
        scale = d_in ** -0.5
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p if wfmt is None else quantize_linear(p, wfmt)


def quantize_linear(p: dict, fmt: PositFmt, *, packed: bool = False) -> dict:
    """Convert a float linear param dict to posit storage (serving path).
    Biases stay float."""
    if packed:
        raise NotImplementedError("packed-p8 weight storage is not ported")
    q = {"w_codes": codec_ops.encode(p["w"].to(torch.float32).contiguous(), fmt.es,
                                     nbits=fmt.nbits)}
    if "b" in p:
        q["b"] = p["b"]
    return q


def effective_weight(p: dict, policy: TransPolicy, es: Optional[int] = None) -> torch.Tensor:
    """The weight as the matmul datapath sees it: posit codes decode; a float
    weight under a posit policy is quantized (the reference's straight-through
    form ``w + (q(w) - w)``); a float weight without one passes as it is."""
    fmt = policy.weights
    if "w_codes" in p:
        assert fmt is not None, "posit-coded params need policy.weights"
        return codec_ops.decode(p["w_codes"], fmt.es if es is None else es,
                                nbits=fmt.nbits)
    w = p["w"]
    if fmt is not None:
        e = fmt.es if es is None else es
        wf = w.to(torch.float32).contiguous()
        qw = codec_ops.decode(codec_ops.encode(wf, e, nbits=fmt.nbits), e, nbits=fmt.nbits)
        w = w + (qw - wf).to(w.dtype)
    return w


def apply_linear(p: dict, x: torch.Tensor, policy: TransPolicy, es: Optional[int] = None,
                 *, activation: str = "none",
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = act(x @ W + b) + residual, epilogue fused with the GEMM."""
    return _linear_resolved(p, x, policy, es, activation=activation, residual=residual)


def _linear_resolved(p: dict, x: torch.Tensor, policy: TransPolicy, es, *,
                     activation: str, residual: Optional[torch.Tensor]) -> torch.Tensor:
    """x is rounded to the compute dtype for the GEMM (inside the kernel); the
    f32 result comes back as x.dtype, as in the reference."""
    cd = compute_dtype(policy)
    if "w_codes" in p:
        fmt = policy.weights
        assert fmt is not None, "posit-coded params need policy.weights"
        if policy.dataflow == "quire":
            return _quire_linear(p, x, policy, fmt, es, activation=activation,
                                 residual=residual)
        return posit_matmul_wx(x, p["w_codes"], fmt, es=es, compute_dtype=cd,
                               bias=p.get("b"), activation=activation,
                               residual=residual, out_dtype=x.dtype)
    w = effective_weight(p, policy, es).to(cd).contiguous()
    K, N = w.shape
    lead = x.shape[:-1]
    y = posit_gemm(x.reshape(-1, K).contiguous(), w, (0, 0, 0),
                   a_fmt=float_fmt(x.dtype), b_fmt=float_fmt(cd), out_fmt=F32,
                   compute_dtype=cd,
                   bias=p.get("b"), activation=activation,
                   residual=None if residual is None else residual.reshape(-1, N).contiguous())
    return y.reshape(*lead, N).to(x.dtype)


def _quire_linear(p: dict, x: torch.Tensor, policy: TransPolicy, fmt: PositFmt, es, *,
                  activation: str, residual: Optional[torch.Tensor]) -> torch.Tensor:
    """dataflow="quire" lowering of a posit-coded linear.

    Activations encode once into ``policy.activations`` (the weight format
    when unset) through the encode kernel; every product lands exactly in a
    quire, and the single terminal rounding reads out into f32 for the fused
    bias/activation/residual epilogue: no float matmul anywhere.
    """
    afmt = policy.activations if policy.activations is not None else fmt
    slots = OperandSlots(rs1=afmt, rs2=fmt, rd=F32, dataflow="quire",
                         codec_impl=policy.codec_impl)
    K = x.shape[-1]
    N = p["w_codes"].shape[-1]
    res2 = None
    if residual is not None:
        res2 = residual.expand(*x.shape[:-1], N).reshape(-1, N).to(torch.float32).contiguous()
    a_codes = codec_ops.encode(x.reshape(-1, K).to(torch.float32).contiguous(), afmt.es,
                               nbits=afmt.nbits)
    y = posit_dot(a_codes, p["w_codes"], slots, es_b=es, bias=p.get("b"),
                  activation=activation, residual=res2)
    return y.reshape(*x.shape[:-1], N).to(x.dtype)


def _walk_linears(tree, path=""):
    """Yield (path, parent) for every linear-shaped param dict."""
    if isinstance(tree, dict):
        if "w" in tree and getattr(tree["w"], "ndim", 0) >= 2:
            yield path, tree
        for k, v in tree.items():
            if k != "w":
                yield from _walk_linears(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_linears(v, f"{path}/{i}" if path else str(i))


def quantize_params(params, policy: TransPolicy):
    """Quantize every linear weight to ``policy.weights`` (in place on a copy
    of the dict/list spine; leaves are shared, float masters untouched)."""
    out = _copy_dicts(params)
    fmt = policy.weights
    if fmt is None:
        return out
    for _, parent in _walk_linears(out):
        q = quantize_linear(parent, fmt, packed=policy.pack_weights)
        parent.pop("w")
        parent.update(q)
    return out


def _copy_dicts(tree):
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_dicts(v) for v in tree]
    return tree


# ------------------------------------------------------------------- norms ----

def init_rmsnorm(d: int, device="cpu") -> dict:
    return {"g": torch.ones((d,), device=device)}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * p["g"]).to(x.dtype)


# ----------------------------------------------------------------- rotary -----

def rope_freqs(head_dim: int, base: float = 10000.0, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (base ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, base: float = 10000.0):
    """(cos, sin) of the rotary angles, (..., S, 1, hd/2) for positions
    (..., S); every layer of a step shares them."""
    freqs = rope_freqs(head_dim, base, device=positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd) rotated by the ``rope_tables`` of its positions.
    Rotates the split halves (x1, x2), not interleaved pairs."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- MLPs ----

def init_swiglu(gen: torch.Generator, d: int, f: int, *, device="cpu",
                wfmt: Optional[PositFmt] = None) -> dict:
    return {
        "gate": init_linear(gen, d, f, device=device, wfmt=wfmt),
        "up": init_linear(gen, d, f, device=device, wfmt=wfmt),
        "down": init_linear(gen, f, d, scale=f ** -0.5, device=device, wfmt=wfmt),
    }


def apply_swiglu(p: dict, x: torch.Tensor, policy: TransPolicy, *,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu fuses into the gate GEMM's epilogue; an optional block residual
    fuses into the down projection."""
    g = apply_linear(p["gate"], x, policy, activation="silu")
    u = apply_linear(p["up"], x, policy)
    return apply_linear(p["down"], g * u, policy, residual=residual)


# -------------------------------------------------------------- embeddings ----

def init_embedding(gen: torch.Generator, vocab: int, d: int, device="cpu") -> dict:
    return {"table": torch.randn((vocab, d), generator=gen, device=device) * (d ** -0.5)}


def apply_embedding(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def embedding_logits(p: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied read-out: h @ table.T (a plain product, outside any kernel, as in
    the reference)."""
    return torch.matmul(h.to(torch.float32), p["table"].T)

