"""Per-layer precision policies: the pcsr, scheduled over a model.

A ``TransPolicy`` gives every linear the same weight format. A
``PrecisionPolicy`` mixes them: an ordered rule list maps layer *paths*
(glob patterns over names like ``"blocks/attn/wq"`` or ``"mlp/gate"``) to a
weight format and a packed-lane flag, over a base ``TransPolicy`` that keeps
supplying every other role (kv_cache, compute dtype, ...). The rules, the
presets, the spec grammar and the JSON form are the reference package's
(``core/policy.py``), so an artifact written by either loads in the other.

Resolution: the first rule whose pattern matches the path (or a '/'-suffix
of it) wins and replaces only ``weights`` / ``pack_weights`` on the base; a
rule without a format pins the layer to the base format; ``bypass`` forces
float weights; no match leaves the base as it is. A ``PrecisionPolicy``
duck-types ``TransPolicy`` (attribute reads fall through to the base), so
the engine and cache init take one unchanged; only
``models.layers.resolve_policy`` sees the per-layer view.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import functools
import json
from typing import Optional, Tuple

from repro_torch.core.pcsr import TransPolicy
from repro_torch.core.types import ES_MAX, ES_MIN, PositFmt, get_format


@dataclasses.dataclass(frozen=True)
class LayerRule:
    """One per-layer override: glob pattern -> (weight format, packed flag).

    ``bypass=True`` runs the matching layer with float weights
    (``weights=None``) whatever the base format; ``weights=None`` without it
    pins the layer to the base format.
    """

    pattern: str
    weights: Optional[PositFmt] = None
    packed: bool = False
    bypass: bool = False

    def __post_init__(self):
        if self.packed and (self.weights is None or self.weights.nbits != 8):
            raise ValueError(
                f"packed rules require p8 weights, got {self.weights} "
                f"for pattern {self.pattern!r}")
        if self.bypass and self.weights is not None:
            raise ValueError(
                f"bypass rules take no weight format, got {self.weights} "
                f"for pattern {self.pattern!r}")


def _rule(pattern: str, fmt: Optional[str], packed: bool = False) -> LayerRule:
    f = get_format(fmt) if fmt is not None else None
    if f is not None and not isinstance(f, PositFmt):
        raise ValueError(f"layer rules take posit formats, got {fmt!r}")
    return LayerRule(pattern, f, packed)


def _pattern_matches(path: str, pattern: str) -> bool:
    """True when ``pattern`` matches ``path`` or any '/'-suffix of it, so an
    anchored rule like "mlp/gate=p8_0" resolves alike for the call-site path
    ("mlp/gate") and the param-tree path ("blocks/mlp/gate")."""
    if fnmatch.fnmatchcase(path, pattern):
        return True
    return fnmatch.fnmatchcase(path, "*/" + pattern)


@functools.lru_cache(maxsize=4096)
def _resolve(policy: "PrecisionPolicy", path: str) -> TransPolicy:
    rule = policy.rule_for(path)
    if rule is None or (rule.weights is None and not rule.bypass):
        return policy.base
    if rule.bypass:
        return dataclasses.replace(policy.base, weights=None, pack_weights=False)
    return dataclasses.replace(policy.base, weights=rule.weights, pack_weights=rule.packed)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Ordered per-layer weight-format rules over a base ``TransPolicy``."""

    base: TransPolicy = TransPolicy()
    rules: Tuple[LayerRule, ...] = ()
    name: str = "custom"

    def rule_for(self, path: str) -> Optional[LayerRule]:
        for rule in self.rules:
            if _pattern_matches(path, rule.pattern):
                return rule
        return None

    def policy_for(self, path: str) -> TransPolicy:
        """The concrete TransPolicy a layer at ``path`` runs under."""
        return _resolve(self, path)

    def with_base(self, base: TransPolicy) -> "PrecisionPolicy":
        """The same rules over another base (which supplies every non-weight role)."""
        return dataclasses.replace(self, base=base)

    def describe(self) -> str:
        parts = [f"precision={self.name}", self.base.describe()]
        for r in self.rules:
            fmt = "float" if r.bypass else r.weights.name if r.weights else "base"
            parts.append(f"{r.pattern}->{fmt}{'(packed)' if r.packed else ''}")
        return " ".join(parts)

    def to_json(self) -> dict:
        """JSON-ready dict: name, base TransPolicy, ordered rules."""
        return {
            "kind": "repro/precision-policy",
            "version": 1,
            "name": self.name,
            "base": self.base.to_json(),
            "rules": [{
                "pattern": r.pattern,
                "weights": r.weights.name if r.weights is not None else None,
                "packed": r.packed,
                **({"bypass": True} if r.bypass else {}),
            } for r in self.rules],
        }

    @classmethod
    def from_json(cls, d: dict) -> "PrecisionPolicy":
        """Inverse of ``to_json``; extra top-level keys (a calibration
        ``meta`` block) are ignored, unknown rule keys raise."""
        if d.get("kind", "repro/precision-policy") != "repro/precision-policy":
            raise ValueError(f"not a precision-policy document: {d.get('kind')!r}")
        for r in d.get("rules", ()):
            bad = set(r) - {"pattern", "weights", "packed", "bypass"}
            if bad or "pattern" not in r:
                raise ValueError(
                    f"malformed precision rule {r!r}: "
                    + (f"unknown keys {sorted(bad)}" if bad else "missing 'pattern'"))
        rules = tuple(
            LayerRule(r["pattern"], None, bypass=True) if r.get("bypass")
            else _rule(r["pattern"], r.get("weights"), packed=bool(r.get("packed", False)))
            for r in d.get("rules", ()))
        base = TransPolicy.from_json(d["base"]) if "base" in d else TransPolicy()
        return cls(base=base, rules=rules, name=d.get("name", "custom"))

    def __getattr__(self, item: str):
        # duck-type TransPolicy: reads the dataclass does not hold go to the base
        if item.startswith("__"):
            raise AttributeError(item)
        return getattr(object.__getattribute__(self, "base"), item)


# ------------------------------------------------------------------ presets ----

def _preset(name: str, base: TransPolicy, *rules: LayerRule) -> PrecisionPolicy:
    return PrecisionPolicy(base=base, rules=tuple(rules), name=name)


#: Named per-layer precision presets. Each keeps its weight schedule in its
#: rules (with a catch-all), never only in the base, because ``with_base``
#: replaces the base wholesale.
PRECISION_PRESETS = {
    "uniform-p16": _preset(
        "uniform-p16", TransPolicy.from_names(weights="p16_1"),
        _rule("*", "p16_1"),
    ),
    "p8-weights": _preset(
        "p8-weights", TransPolicy.from_names(weights="p8_0", compute_dtype="bf16"),
        _rule("*", "p8_0"),
    ),
    "p8-packed": _preset(
        "p8-packed",
        TransPolicy.from_names(weights="p8_0", compute_dtype="bf16", pack_weights=True),
        _rule("*", "p8_0", packed=True),
    ),
    # attention projections at p16, MLP/MoE/head weights at packed p8
    "attn-p16-mlp-p8": _preset(
        "attn-p16-mlp-p8", TransPolicy.from_names(weights="p16_1"),
        _rule("*attn*", "p16_1"),
        _rule("*self*", "p16_1"),
        _rule("*cross*", "p16_1"),
        _rule("*mlp*", "p8_0", packed=True),
        _rule("*moe*", "p8_0", packed=True),
        _rule("*ffn*", "p8_0", packed=True),
        _rule("lm_head*", "p8_0", packed=True),
        _rule("*", "p16_1"),
    ),
}


def parse_fmt_token(tok: str) -> PositFmt:
    """A rule's format token: ``p8_0`` | ``p16_1`` | ... with an optional
    exponent-size override ``@es`` (``p8@2``, ``p16_1@3`` -> p16_3). Bare
    ``p8``/``p16`` need the ``@es``; es outside [ES_MIN, ES_MAX] or not an
    integer raises ``ValueError``."""
    tok = tok.strip()
    name, _, es_s = tok.partition("@")
    name = name.strip()
    if es_s:
        try:
            es = int(es_s.strip())
        except ValueError:
            raise ValueError(f"es in {tok!r} must be an integer, got {es_s!r}")
        if not (ES_MIN <= es <= ES_MAX):
            raise ValueError(f"es {es} out of range [{ES_MIN}, {ES_MAX}] in {tok!r}")
        if name in ("p8", "p16"):
            return PositFmt(int(name[1:]), es)
        f = get_format(name)
        if not isinstance(f, PositFmt):
            raise ValueError(f"@es only applies to posit formats, got {name!r}")
        return f.with_es(es)
    if name in ("p8", "p16"):
        raise ValueError(f"bare {name!r} needs an exponent size: {name}@es or {name}_es")
    f = get_format(name)
    if not isinstance(f, PositFmt):
        raise ValueError(f"layer rules take posit formats, got {name!r}")
    return f


def _load_policy_file(path: str) -> PrecisionPolicy:
    with open(path) as f:
        return PrecisionPolicy.from_json(json.load(f))


def get_precision_policy(name_or_spec: str,
                         base: Optional[TransPolicy] = None) -> PrecisionPolicy:
    """A preset by name, a saved artifact, or a rule spec::

        "attn-p16-mlp-p8"                          # preset
        "@experiments/cal.json"                    # artifact (to_json)
        "*attn*=p16@2,*mlp*=p8@1:packed,*=p16_1"   # spec

    Spec grammar: comma-separated ``pattern=fmt[@es][:packed]`` entries in
    order (first match wins); ``pattern=float`` bypasses quantization for
    the layer. ``base``, when given, supplies every non-weight role.
    """
    if name_or_spec.startswith("@"):
        pol = _load_policy_file(name_or_spec[1:])
        return pol if base is None else pol.with_base(base)
    if name_or_spec in PRECISION_PRESETS:
        pol = PRECISION_PRESETS[name_or_spec]
        return pol if base is None else pol.with_base(base)
    if "=" not in name_or_spec:
        raise KeyError(
            f"unknown precision policy {name_or_spec!r}; presets: "
            f"{sorted(PRECISION_PRESETS)} (or @artifact.json, or a "
            f"pattern=fmt[@es][:packed],... spec)")
    rules = []
    for part in name_or_spec.split(","):
        pattern, _, fmt = part.partition("=")
        if not fmt:
            raise ValueError(f"malformed precision rule {part!r}")
        fmt, _, mod = fmt.partition(":")
        if mod not in ("", "packed"):
            raise ValueError(f"unknown rule modifier {mod!r} in {part!r}")
        if fmt.strip() == "float":
            if mod:
                raise ValueError(f"float bypass takes no modifier: {part!r}")
            rules.append(LayerRule(pattern.strip(), None, bypass=True))
        else:
            rules.append(LayerRule(pattern.strip(), parse_fmt_token(fmt),
                                   packed=mod == "packed"))
    return PrecisionPolicy(base=base if base is not None else TransPolicy(),
                           rules=tuple(rules), name=name_or_spec)
