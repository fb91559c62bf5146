"""Format descriptors for posit and IEEE-754 numbers (torch side).

The paper's pcsr fields map here:
  pfmt  -> Fmt.kind  ("posit" | "float")
  pprec -> Fmt.nbits (8 | 16 for posit; 16/32 for float)
  pes   -> es        (the static default; ops take es as a run-time int)

Posit P(n, es) value layout (MSB first):  sign | regime | exponent(es) | fraction
  - negation is two's complement of the whole n-bit word
  - 0b0..0 == 0, 0b10..0 == NaR (maps to NaN)
  - useed = 2**(2**es); maxpos = useed**(n-2); minpos = useed**-(n-2)

The reference's descriptors carry more derived constants; the port keeps
the ones its code reads.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

# es is clamped to this range: scale = k*2^es + e must stay in the fp32
# normal-exponent range for n<=16 ((n-2)*2^es <= 112 < 127).
ES_MIN = 0
ES_MAX = 3


@dataclasses.dataclass(frozen=True)
class PositFmt:
    """Static descriptor of a posit format P(nbits, es)."""

    nbits: int  # 8 or 16
    es: int     # 0..3 (static default; ops may override with a run-time int)

    def __post_init__(self):
        if self.nbits not in (8, 16):
            raise ValueError(f"posit nbits must be 8 or 16, got {self.nbits}")
        if not (ES_MIN <= self.es <= ES_MAX):
            raise ValueError(f"posit es must be in [{ES_MIN},{ES_MAX}], got {self.es}")

    @property
    def kind(self) -> str:
        return "posit"

    @property
    def name(self) -> str:
        return f"p{self.nbits}_{self.es}"

    @property
    def storage_dtype(self) -> torch.dtype:
        return torch.uint8 if self.nbits == 8 else torch.uint16

    @property
    def storage_bytes(self) -> int:
        return self.nbits // 8

    @property
    def max_scale(self) -> int:
        """Largest power-of-two scale: (n-2) * 2^es (maxpos = 2^max_scale)."""
        return (self.nbits - 2) << self.es

    def with_es(self, es: int) -> "PositFmt":
        return PositFmt(self.nbits, es)


@dataclasses.dataclass(frozen=True)
class FloatFmt:
    """IEEE-754 (or bfloat16) descriptor: the 'bypass codec' side of pcsr."""

    name: str  # "f32" | "bf16" | "f16"

    def __post_init__(self):
        if self.name not in ("f32", "bf16", "f16"):
            raise ValueError(f"unknown float format {self.name}")

    @property
    def kind(self) -> str:
        return "float"

    @property
    def nbits(self) -> int:
        return 32 if self.name == "f32" else 16

    @property
    def dtype(self) -> torch.dtype:
        return {"f32": torch.float32, "bf16": torch.bfloat16,
                "f16": torch.float16}[self.name]


Fmt = Union[PositFmt, FloatFmt]

P8_0 = PositFmt(8, 0)
P8_1 = PositFmt(8, 1)
P8_2 = PositFmt(8, 2)
P8_3 = PositFmt(8, 3)
P16_0 = PositFmt(16, 0)
P16_1 = PositFmt(16, 1)
P16_2 = PositFmt(16, 2)
P16_3 = PositFmt(16, 3)
F32 = FloatFmt("f32")
BF16 = FloatFmt("bf16")
F16 = FloatFmt("f16")

_REGISTRY: dict[str, Fmt] = {
    f.name: f
    for f in (P8_0, P8_1, P8_2, P8_3, P16_0, P16_1, P16_2, P16_3, F32, BF16, F16)
}


def get_format(name: str) -> Fmt:
    """Look up a format by name, e.g. 'p8_0', 'p16_1', 'f32', 'bf16'."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown format {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def compute_dtype_for(fmt: Fmt) -> torch.dtype:
    """The lossless-decode compute dtype for a storage format.

    P8 (<=5 fraction bits, |scale|<=48) decodes exactly into bfloat16; P16 (up
    to 13 fraction bits) needs float32. Floats compute as themselves (f16
    computes in f32).
    """
    if isinstance(fmt, PositFmt):
        return torch.bfloat16 if fmt.nbits == 8 else torch.float32
    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "f16": torch.float32}[fmt.name]
