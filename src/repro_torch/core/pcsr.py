"""PCSR: the framework analogue of the paper's posit control & status register.

* ``OperandSlots``: the literal pcsr, formats for (rs1, rs2, rs3, rd) of one op.
* ``TransPolicy``: which format each tensor role of a model uses (weights,
  KV cache, ...), plus the compute dtype of the float datapath.

The fields, names and JSON form match the reference package's, so a policy
document written by either loads in the other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.types import F32, Fmt, PositFmt, get_format

DATAFLOWS = ("fused", "unfused", "quire")
CODEC_IMPLS = ("auto", "lut", "bits")
EPILOGUES = ("fused", "chained")
ATTN_IMPLS = ("auto", "kernel", "xla")
POLICY_DATAFLOWS = ("fused", "quire")


@dataclasses.dataclass(frozen=True)
class OperandSlots:
    """Per-op format config: 3 input slots + 1 output slot (the literal pcsr)."""

    rs1: Fmt = F32
    rs2: Fmt = F32
    rs3: Fmt = F32
    rd: Fmt = F32
    dataflow: str = "fused"
    codec_impl: str = "auto"
    rs2_packed: bool = False

    def __post_init__(self):
        if self.dataflow not in DATAFLOWS:
            raise ValueError(
                f"dataflow must be one of {DATAFLOWS}, got {self.dataflow!r}")
        if self.codec_impl not in CODEC_IMPLS:
            raise ValueError(
                f"codec_impl must be one of {CODEC_IMPLS}, got {self.codec_impl!r}")
        if self.rs2_packed and not (
                isinstance(self.rs2, PositFmt) and self.rs2.nbits == 8):
            raise ValueError(
                f"rs2_packed requires a p8 rs2 (two codes per 16-bit lane), "
                f"got {self.rs2}")

    @classmethod
    def uniform(cls, fmt: Fmt, dataflow: str = "fused",
                codec_impl: str = "auto") -> "OperandSlots":
        return cls(rs1=fmt, rs2=fmt, rs3=fmt, rd=fmt, dataflow=dataflow,
                   codec_impl=codec_impl)

    def with_packed(self, rs2_packed: bool = True) -> "OperandSlots":
        return dataclasses.replace(self, rs2_packed=rs2_packed)


ROLES = (
    "weights", "activations", "gradients", "kv_cache", "optimizer",
    "collectives", "checkpoint", "state",
)


@dataclasses.dataclass(frozen=True)
class TransPolicy:
    """Which storage format each tensor role uses. ``None`` = native compute dtype."""

    weights: Optional[PositFmt] = None
    activations: Optional[PositFmt] = None
    gradients: Optional[PositFmt] = None
    kv_cache: Optional[PositFmt] = None
    optimizer: Optional[PositFmt] = None
    collectives: Optional[PositFmt] = None
    checkpoint: Optional[PositFmt] = None
    state: Optional[PositFmt] = None
    compute_dtype: str = "f32"  # "f32" | "bf16": the float datapath dtype
    exact_collectives: bool = False
    codec_impl: str = "auto"
    epilogue: str = "fused"
    pack_weights: bool = False
    attn_impl: str = "auto"
    dataflow: str = "fused"

    def __post_init__(self):
        if self.dataflow not in POLICY_DATAFLOWS:
            raise ValueError(
                f"policy dataflow must be one of {POLICY_DATAFLOWS}, "
                f"got {self.dataflow!r}")
        if self.pack_weights and not (
                self.weights is not None and self.weights.nbits == 8):
            raise ValueError(
                "pack_weights requires p8 weights (two codes per lane), "
                f"got weights={self.weights}")
        if self.codec_impl not in CODEC_IMPLS:
            raise ValueError(
                f"codec_impl must be one of {CODEC_IMPLS}, got {self.codec_impl!r}")
        if self.epilogue not in EPILOGUES:
            raise ValueError(
                f"epilogue must be one of {EPILOGUES}, got {self.epilogue!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be one of {ATTN_IMPLS}, got {self.attn_impl!r}")

    def fmt_for(self, role: str) -> Optional[PositFmt]:
        if role not in ROLES:
            raise KeyError(f"unknown tensor role {role!r}; known: {ROLES}")
        return getattr(self, role)

    @classmethod
    def from_names(cls, compute_dtype: str = "f32",
                   exact_collectives: bool = False,
                   codec_impl: str = "auto", epilogue: str = "fused",
                   pack_weights: bool = False, attn_impl: str = "auto",
                   dataflow: str = "fused",
                   **roles: Optional[str]) -> "TransPolicy":
        kw = {"exact_collectives": exact_collectives,
              "codec_impl": codec_impl, "epilogue": epilogue,
              "pack_weights": pack_weights, "attn_impl": attn_impl,
              "dataflow": dataflow}
        for role, name in roles.items():
            if name is None or name == "none":
                kw[role] = None
                continue
            fmt = get_format(name)
            if not isinstance(fmt, PositFmt):
                raise ValueError(f"role {role} must be a posit format or none, got {name}")
            kw[role] = fmt
        return cls(compute_dtype=compute_dtype, **kw)

    def to_json(self) -> dict:
        """JSON-ready dict: format roles by name, knobs verbatim."""
        d = {role: (f.name if (f := self.fmt_for(role)) is not None else None)
             for role in ROLES}
        d.update(compute_dtype=self.compute_dtype,
                 exact_collectives=self.exact_collectives,
                 codec_impl=self.codec_impl, epilogue=self.epilogue,
                 pack_weights=self.pack_weights, attn_impl=self.attn_impl,
                 dataflow=self.dataflow)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TransPolicy":
        """Inverse of ``to_json``; unknown keys are rejected loudly."""
        known = set(ROLES) | {"compute_dtype", "exact_collectives",
                              "codec_impl", "epilogue", "pack_weights",
                              "attn_impl", "dataflow"}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown TransPolicy fields {sorted(bad)}")
        kw = dict(d)
        for role in ROLES:
            if kw.get(role) is not None:
                fmt = get_format(kw[role])
                if not isinstance(fmt, PositFmt):
                    raise ValueError(
                        f"role {role} must be a posit format, got {kw[role]!r}")
                kw[role] = fmt
        return cls(**kw)

    def describe(self) -> str:
        parts = [f"compute={self.compute_dtype}"]
        for role in ROLES:
            f = self.fmt_for(role)
            parts.append(f"{role}={f.name if f else '-'}")
        if self.exact_collectives:
            parts.append("exact_collectives")
        if self.codec_impl != "auto":
            parts.append(f"codec={self.codec_impl}")
        if self.epilogue != "fused":
            parts.append(f"epilogue={self.epilogue}")
        if self.pack_weights:
            parts.append("packed_weights")
        if self.attn_impl != "auto":
            parts.append(f"attn={self.attn_impl}")
        if self.dataflow != "fused":
            parts.append(f"dataflow={self.dataflow}")
        return " ".join(parts)


FP32_POLICY = TransPolicy()
P16_WEIGHTS = TransPolicy.from_names(weights="p16_1")
P8_SERVE = TransPolicy.from_names(weights="p8_0", kv_cache="p8_0", compute_dtype="bf16")
P16_TRAIN = TransPolicy.from_names(
    weights="p16_1", gradients="p16_1", optimizer="p16_1", checkpoint="p16_1"
)


def parse_policy(spec: str) -> TransPolicy:
    """The CLIs' policy grammar: ``none`` | ``p8-serve`` | ``p16-train`` |
    ``role=fmt,...,compute=bf16`` (``kv`` abbreviates ``kv_cache``)."""
    if spec in ("none", ""):
        return TransPolicy()
    if spec == "p8-serve":
        return P8_SERVE
    if spec == "p16-train":
        return P16_TRAIN
    kw = {}
    cd = "f32"
    for part in spec.split(","):
        k, v = part.split("=")
        if k == "compute":
            cd = v
        else:
            kw[{"kv": "kv_cache"}.get(k, k)] = v
    return TransPolicy.from_names(compute_dtype=cd, **kw)
