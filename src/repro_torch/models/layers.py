"""Parameter init + core layer ops (linear, norms, rotary and sinusoidal
positions, MLPs, embedding).

Parameter convention, as in the reference: nested dicts of tensors. Posit-
stored weights appear as ``{"w_codes": uint8/uint16 (K, N), "b": ...}`` after
``quantize_params``, packed p8 lanes as ``{"w_packed": uint16 (K/2, N)}``
(core/pack.py); float weights as ``{"w": (K, N)}``. The policy says how to
read them: a ``TransPolicy``, or a per-layer ``PrecisionPolicy``
(core/policy.py) that each linear resolves with its path.

Every linear goes through a GEMM kernel wrapper: the posit GEMM
(``kernels.posit_gemm.ops.posit_gemm``, its packed variant for packed
lanes), or under ``dataflow="quire"`` for posit-coded weights the quire GEMM
(``kernels.posit_quire_gemm``). On CUDA tensors that is the hand-written
kernel, on CPU tensors its plain version.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.calib import observe
from repro_torch.core.dot import apply_epilogue, posit_dot, posit_matmul_wx
from repro_torch.core.pack import pack_p8, unpack_p8
from repro_torch.core.pcsr import OperandSlots, TransPolicy
from repro_torch.core.tree import tree_map
from repro_torch.core.types import F32, PositFmt
from repro_torch.kernels.posit_codec import ops as codec_ops
from repro_torch.kernels.posit_gemm.ops import float_linear


def compute_dtype(policy: TransPolicy) -> torch.dtype:
    return torch.float32 if policy.compute_dtype == "f32" else torch.bfloat16


def check_ported(policy: TransPolicy) -> None:
    """Raise on policy knobs whose code paths are not ported yet."""
    if policy.attn_impl == "xla":
        raise NotImplementedError("attn_impl='xla' (full-cache einsum) is not ported")


def layer_path(path: str) -> str:
    """A param-tree path in the reference's spelling: the port keeps one dict
    per layer (``blocks/3/attn/wq``) where the reference stacks the layers
    (``blocks/attn/wq``), so the layer index is dropped."""
    return "/".join(part for part in path.split("/") if not part.isdigit())


def resolve_policy(policy, path: str = "") -> TransPolicy:
    """The TransPolicy of the layer at ``path``: a ``PrecisionPolicy``
    resolves through its rules (on the path without layer indices, so draw
    time, quantize time and call time agree), a ``TransPolicy`` passes as it
    is."""
    resolve = getattr(policy, "policy_for", None)
    return resolve(layer_path(path)) if resolve is not None else policy


# ------------------------------------------------------------------ linear ----

def init_linear(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
                scale: Optional[float] = None, device="cpu", policy=None,
                path: str = "") -> dict:
    """Random-normal (d_in, d_out) weight times ``scale`` (default d_in**-0.5),
    zero bias. Under a ``policy`` the weight is quantized at once to the
    layer's format (``path`` resolves it), so no f32 copy outlives the call."""
    if scale is None:
        scale = d_in ** -0.5
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p if policy is None else _quantize_resolved(p, resolve_policy(policy, path))


def quantize_linear(p: dict, fmt: PositFmt, *, packed: bool = False) -> dict:
    """Convert a float linear param dict to posit storage (serving path).
    ``packed=True`` stores p8 codes two to a uint16 lane (core/pack.py).
    Biases stay float."""
    if packed and fmt.nbits != 8:
        raise ValueError(f"packed weight storage requires p8, got {fmt}")
    codes = codec_ops.encode(p["w"].to(torch.float32).contiguous(), fmt.es, nbits=fmt.nbits)
    q = {"w_packed": pack_p8(codes)} if packed else {"w_codes": codes}
    if "b" in p:
        q["b"] = p["b"]
    return q


def _quantize_resolved(p: dict, pol: TransPolicy) -> dict:
    """``p`` in the layer's resolved format: packed lanes when the policy
    packs p8 weights and the contraction dim is even (an odd one keeps plain
    codes), untouched without a posit weight format."""
    fmt = pol.weights
    if fmt is None:
        return p
    packed = pol.pack_weights and fmt.nbits == 8 and p["w"].shape[-2] % 2 == 0
    return quantize_linear(p, fmt, packed=packed)


def effective_weight(p: dict, policy, es: Optional[int] = None, path: str = "") -> torch.Tensor:
    """The weight as the matmul datapath sees it (a linear's, or a whole MoE
    expert stack passed as ``{"w_codes": ...}`` or ``{"w": ...}``): posit
    codes (packed lanes included) decode; a float weight under a posit
    policy is quantized in the reference's straight-through form
    ``w + stop_gradient(q(w) - w)``, whose
    gradient with respect to ``w`` is the identity; a float weight without
    one passes as it is. The encode and decode run through the codec
    kernels. Under an active calibration observer a float weight's
    statistics stream to it (``calib.observe``) at ``path``, before the
    quantization."""
    policy = resolve_policy(policy, path)
    fmt = policy.weights
    coded = p.get("w_codes")
    if "w_packed" in p:
        assert fmt is not None and fmt.nbits == 8, "packed params need a p8 policy.weights"
        coded = unpack_p8(p["w_packed"]).contiguous()
    if coded is not None:
        assert fmt is not None, "posit-coded params need policy.weights"
        return codec_ops.decode(coded, fmt.es if es is None else es, nbits=fmt.nbits,
                                codec_impl=policy.codec_impl)
    w = p["w"]
    if observe.is_active():
        observe.record(path, "weight", w)
    if fmt is not None:
        e = fmt.es if es is None else es
        wf = w.detach().to(torch.float32).contiguous()
        qw = codec_ops.decode(codec_ops.encode(wf, e, nbits=fmt.nbits), e, nbits=fmt.nbits,
                              codec_impl=policy.codec_impl)
        # straight through: the forward sees q(w), the gradient reaches w as it is
        w = w + (qw - wf).detach().to(w.dtype)
    return w


def apply_linear(p: dict, x: torch.Tensor, policy, es: Optional[int] = None,
                 *, activation: str = "none",
                 residual: Optional[torch.Tensor] = None, path: str = "") -> torch.Tensor:
    """y = act(x @ W + b) + residual, epilogue fused with the GEMM (or
    chained after it under ``policy.epilogue == "chained"``). ``path`` names
    the layer for a per-layer ``PrecisionPolicy`` and for an active
    calibration observer, which records ``x`` as the layer's activation."""
    if observe.is_active():
        observe.record(path, "act", x)
    return _linear_resolved(p, x, resolve_policy(policy, path), es, activation=activation,
                            residual=residual, path=path)


def _linear_resolved(p: dict, x: torch.Tensor, policy: TransPolicy, es, *,
                     activation: str, residual: Optional[torch.Tensor],
                     path: str) -> torch.Tensor:
    """apply_linear past policy resolution. x is rounded to the compute dtype
    for the GEMM (inside the kernel); the f32 result comes back as x.dtype,
    as in the reference."""
    cd = compute_dtype(policy)
    packed = "w_packed" in p
    if packed or "w_codes" in p:
        fmt = policy.weights
        assert fmt is not None, "posit-coded params need policy.weights"
        if policy.dataflow == "quire":
            return _quire_linear(p, x, policy, fmt, es, activation=activation,
                                 residual=residual, packed=packed)
        return posit_matmul_wx(x, p["w_packed"] if packed else p["w_codes"], fmt, es=es,
                               compute_dtype=cd, bias=p.get("b"), activation=activation,
                               residual=residual, out_dtype=x.dtype,
                               codec_impl=policy.codec_impl, epilogue=policy.epilogue,
                               packed=packed)
    w = effective_weight(p, policy, es, path=path).to(cd).contiguous()
    K, N = w.shape
    lead = x.shape[:-1]
    res = None if residual is None else residual.reshape(-1, N).contiguous()
    chained = policy.epilogue == "chained"
    # the GEMM kernel in the forward, plain products in the backward
    y = float_linear(x.reshape(-1, K).contiguous(), w, compute_dtype=cd,
                     bias=None if chained else p.get("b"),
                     activation="none" if chained else activation,
                     residual=None if chained else res)
    if chained:
        y = apply_epilogue(y, p.get("b"), activation, res)
    return y.reshape(*lead, N).to(x.dtype)


def _quire_linear(p: dict, x: torch.Tensor, policy: TransPolicy, fmt: PositFmt, es, *,
                  activation: str, residual: Optional[torch.Tensor],
                  packed: bool) -> torch.Tensor:
    """dataflow="quire" lowering of a posit-coded linear.

    Activations encode once into ``policy.activations`` (the weight format
    when unset) through the encode kernel; every product lands exactly in a
    quire (packed lanes split into p8 codes first), and the single terminal
    rounding reads out into f32 for the bias/activation/residual epilogue:
    no float matmul anywhere.
    """
    afmt = policy.activations if policy.activations is not None else fmt
    slots = OperandSlots(rs1=afmt, rs2=fmt, rd=F32, dataflow="quire",
                         codec_impl=policy.codec_impl, rs2_packed=packed)
    w = p["w_packed"] if packed else p["w_codes"]
    K = x.shape[-1]
    N = w.shape[-1]
    res2 = None
    if residual is not None:
        res2 = residual.expand(*x.shape[:-1], N).reshape(-1, N).to(torch.float32).contiguous()
    a_codes = codec_ops.encode(x.reshape(-1, K).to(torch.float32).contiguous(), afmt.es,
                               nbits=afmt.nbits, codec_impl=policy.codec_impl)
    y = posit_dot(a_codes, w, slots, es_b=es, bias=p.get("b"), activation=activation,
                  residual=res2, epilogue=policy.epilogue)
    return y.reshape(*x.shape[:-1], N).to(x.dtype)


_WEIGHT_KEYS = ("w", "w_codes", "w_packed")
# linears whose weights stay float under every policy (the reference's
# convolution stems); calibration leaves them out
_RAW_WEIGHT_PATTERNS = ("*conv*",)
# MoE's stacked expert tensors (E, K, N): quantized to "<name>_codes", never
# packed (the expert GEMMs read each expert's codes whole)
EXPERT_KEYS = ("w_gate", "w_up", "w_down")
_EXPERT_LEAVES = EXPERT_KEYS + tuple(k + "_codes" for k in EXPERT_KEYS)


def quantize_expert_stack(name: str, w: torch.Tensor, fmt: PositFmt) -> dict:
    """An expert stack ``name`` (E, K, N) float as ``{name + "_codes": codes}``."""
    return {name + "_codes": codec_ops.encode(w.to(torch.float32).contiguous(), fmt.es,
                                              nbits=fmt.nbits)}


def _walk_linears(tree, path=""):
    """Yield (path, parent, key) for every linear weight, float or quantized:
    a linear dict's weight (``key`` "w", "w_codes" or "w_packed") at the
    dict's path, and each expert stack ("w_gate", ... or its "_codes") at
    ``path/<name>``, as the reference names them."""
    if isinstance(tree, dict):
        for k in _WEIGHT_KEYS:
            if getattr(tree.get(k), "ndim", 0) >= 2:
                yield path, tree, k
        for k in _EXPERT_LEAVES:
            if getattr(tree.get(k), "ndim", 0) >= 2:
                name = k.removesuffix("_codes")
                yield (f"{path}/{name}" if path else name), tree, k
        for k, v in tree.items():
            if k not in _WEIGHT_KEYS + _EXPERT_LEAVES:
                yield from _walk_linears(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_linears(v, f"{path}/{i}" if path else str(i))


def quantize_params(params, policy):
    """Quantize every float linear weight to its layer's format (per-layer
    under a ``PrecisionPolicy``): packed lanes where the resolved policy packs
    p8 weights and the contraction dim is even, plain codes otherwise, left
    float without a posit weight format; MoE expert stacks to
    "<name>_codes", unpacked. Works on a copy of the dict/list spine; leaves
    are shared, float masters untouched."""
    out = tree_map(lambda leaf: leaf, params)     # a new dict/list spine, leaves shared
    for path, parent, key in list(_walk_linears(out)):
        if key not in ("w",) + EXPERT_KEYS:
            continue
        pol = resolve_policy(policy, path)
        if key == "w":
            q = _quantize_resolved(parent, pol)
            if q is not parent:
                parent.pop("w")
                parent.update(q)
        elif pol.weights is not None:
            parent.update(quantize_expert_stack(key, parent.pop(key), pol.weights))
    return out


def policy_weight_bytes(params, policy) -> dict:
    """Linear-weight bytes at rest under ``policy`` against f32 (the paper's
    Table-IV saving at model scale); packed p8 counts one byte a value.
    ``params`` may be float or already quantized."""
    f32_b = policy_b = 0
    for path, parent, key in _walk_linears(params):
        n = parent[key].numel() * (2 if key == "w_packed" else 1)
        f32_b += 4 * n
        fmt = resolve_policy(policy, path).weights
        policy_b += n * (fmt.storage_bytes if fmt is not None else 4)
    return {"weight_bytes_f32": f32_b, "weight_bytes_policy": policy_b}


# ------------------------------------------------------------------- norms ----

def init_rmsnorm(d: int, device="cpu") -> dict:
    return {"g": torch.ones((d,), device=device)}


def apply_rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * p["g"]).to(x.dtype)


def init_layernorm(d: int, device="cpu") -> dict:
    return {"g": torch.ones((d,), device=device), "b": torch.zeros((d,), device=device)}


def apply_layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 over the last axis, the population variance, as the
    reference computes it."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(x.dtype)


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


def sinusoidal_positions(n: int, d: int, device="cpu") -> torch.Tensor:
    """(n, d) f32: sin at the even columns, cos at the odd ones."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    step = torch.tensor(-math.log(10000.0), dtype=torch.float32) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * step.to(device))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# -------------------------------------------------------------------- MLPs ----

def init_swiglu(gen: torch.Generator, d: int, f: int, *, device="cpu", policy=None,
                path: str = "mlp") -> dict:
    kw = dict(device=device, policy=policy)
    return {
        "gate": init_linear(gen, d, f, path=f"{path}/gate", **kw),
        "up": init_linear(gen, d, f, path=f"{path}/up", **kw),
        "down": init_linear(gen, f, d, scale=f ** -0.5, path=f"{path}/down", **kw),
    }


def apply_swiglu(p: dict, x: torch.Tensor, policy, *,
                 residual: Optional[torch.Tensor] = None, path: str = "mlp") -> torch.Tensor:
    """silu fuses into the gate GEMM's epilogue; an optional block residual
    fuses into the down projection."""
    g = apply_linear(p["gate"], x, policy, activation="silu", path=f"{path}/gate")
    u = apply_linear(p["up"], x, policy, path=f"{path}/up")
    return apply_linear(p["down"], g * u, policy, residual=residual, path=f"{path}/down")


def init_gelu_mlp(gen: torch.Generator, d: int, f: int, *, bias: bool = True, device="cpu",
                  policy=None, path: str = "mlp") -> dict:
    kw = dict(device=device, policy=policy)
    return {
        "up": init_linear(gen, d, f, bias=bias, path=f"{path}/up", **kw),
        "down": init_linear(gen, f, d, bias=bias, scale=f ** -0.5, path=f"{path}/down", **kw),
    }


def apply_gelu_mlp(p: dict, x: torch.Tensor, policy, *,
                   residual: Optional[torch.Tensor] = None, path: str = "mlp") -> torch.Tensor:
    """gelu (tanh form) fuses into the up projection's epilogue, after its
    bias; an optional block residual fuses into the down projection."""
    h = apply_linear(p["up"], x, policy, activation="gelu", path=f"{path}/up")
    return apply_linear(p["down"], h, policy, residual=residual, path=f"{path}/down")


# -------------------------------------------------------------- embeddings ----

def init_embedding(gen: torch.Generator, vocab: int, d: int, device="cpu") -> dict:
    return {"table": torch.randn((vocab, d), generator=gen, device=device) * (d ** -0.5)}


def apply_embedding(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens]


def embedding_logits(p: dict, h: torch.Tensor) -> torch.Tensor:
    """Tied read-out: h @ table.T (a plain product, outside any kernel, as in
    the reference)."""
    return torch.matmul(h.to(torch.float32), p["table"].T)

