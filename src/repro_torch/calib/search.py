"""Byte-budgeted precision search: observer stats -> PrecisionPolicy artifact.

The knapsack: each linear call site i (all depth-layers of a scanned stack
share one site, matching PrecisionPolicy rule granularity) must pick a weight
format c from ``errmodel.CANDIDATES``; minimize the predicted end-to-end
error subject to a weight-byte budget

    min  sum_i  S_i(c_i)      s.t.  sum_i n_i * bytes(c_i) <= B

where the per-site score is the propagated output perturbation of y = x @ W:

    S_i(c) = n_i * act_rms_i^2 * E[(dW)^2 | c]        (errmodel.tensor_abs_sq_err)

(E||x . dW||^2 ~= d_in * act_rms^2 * E[dW^2] per output element; summing over
outputs and depth layers gives n_i = total weight count at the site as the
multiplier).  With only two byte levels (p8 = 1 B/value, p16 = 2 B/value) the
knapsack is a classic marginal-utility greedy, which is optimal here up to
the last item: every site starts at its best-es p8 candidate (the 1-byte
floor — per-site es choice alone is what beats the uniform-es presets), then
sites are upgraded to their best-es p16 candidate in decreasing
error-reduction-per-byte order until the budget is exhausted.

The emitted ``PrecisionPolicy`` carries one anchored rule per site (resolved
by suffix matching both at quantize-time tree paths and decode-time call-site
paths, DESIGN.md §9) plus a final ``weights=None`` catch-all that pins
anything unobserved to the base policy, and serializes to the JSON artifact
schema in DESIGN.md §11.

The reference package's search (``calib/search.py``), on the port's types:
given the same statistics it makes the same choices, the same report and
the same artifact. ``build_site_plans`` walks the port's per-layer tree
(``blocks/<i>/attn/wq``), whose layers add up to the reference's stacked
tensors (``blocks/attn/wq``); ``calibration_batches`` draws the reference's
batches and hands them over as tensors on the device.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.calib import errmodel
from repro_torch.calib.observe import Observer, TensorStats, collect_stats
from repro_torch.core.device import resolve_device
from repro_torch.core.pcsr import TransPolicy
from repro_torch.core.policy import LayerRule, PrecisionPolicy
from repro_torch.core.types import PositFmt


@dataclasses.dataclass
class SitePlan:
    """One call site's slice of the knapsack."""

    path: str                     # observed call-site path (== rule pattern)
    n_weights: int                # total weight elements resolving to this site
    pack_ok: bool                 # plain "w" linears with even d_in everywhere
    w_stats: TensorStats
    act_rms: float                # importance weight (1.0 when unobserved)
    act_stats: Optional[TensorStats] = None  # full act distribution (drift
    #                               baseline persisted in the artifact, §12)

    def score(self, fmt: PositFmt) -> float:
        return (self.n_weights * self.act_rms ** 2
                * errmodel.tensor_abs_sq_err(self.w_stats, fmt))

    def bytes_at(self, fmt: PositFmt) -> int:
        return self.n_weights * fmt.storage_bytes

    def best(self, nbits: int) -> Tuple[PositFmt, float]:
        cands = [(self.score(c), c.es, c)
                 for c in errmodel.CANDIDATES if c.nbits == nbits]
        s, _, c = min(cands)
        return c, s


def _site_for(tree_path: str, sites: Iterable[str]) -> Optional[str]:
    """The observed site a quantize-time tree path resolves to — the same
    suffix match ``core.policy`` rules use, so plan and policy agree."""
    for site in sites:
        if fnmatch.fnmatchcase(tree_path, site) \
                or fnmatch.fnmatchcase(tree_path, "*/" + site):
            return site
    return None


def build_site_plans(params, observer: Observer) -> List[SitePlan]:
    """Join observer stats with the real param tree.

    Weight *sizes* come from the tree (every layer's linear at a site adds
    its count — byte accounting must match ``policy_weight_bytes``);
    weight/activation *statistics* come from the observer.  Tree linears with no observed site
    (e.g. params a forward pass never touches) are left out — the emitted
    catch-all pins them to the base policy.
    """
    # lazy import: models.layers imports calib.observe (the hook), so the
    # calib package must not import models at module scope
    from repro_torch.models.layers import _RAW_WEIGHT_PATTERNS, _walk_linears

    observed = [p for p in observer.paths()
                if observer.get(p, "weight") is not None]
    agg: Dict[str, dict] = {}
    for tree_path, parent, key in _walk_linears(params, ""):
        if any(fnmatch.fnmatchcase(tree_path, pat)
               for pat in _RAW_WEIGHT_PATTERNS):
            continue
        site = _site_for(tree_path, observed)
        if site is None:
            continue
        w = parent[key]
        a = agg.setdefault(site, {"n": 0, "pack_ok": True})
        a["n"] += int(np.prod(w.shape))
        # packed lanes need a plain {"w": ...} linear with even contraction
        # dim (quantize_params applies the same predicate)
        a["pack_ok"] &= (key == "w" and w.shape[-2] % 2 == 0)

    plans = []
    for site, a in sorted(agg.items()):
        act = observer.get(site, "act")
        plans.append(SitePlan(
            path=site, n_weights=a["n"], pack_ok=a["pack_ok"],
            w_stats=observer.get(site, "weight"),
            act_rms=act.rms if act is not None and act.rms > 0 else 1.0,
            act_stats=act))
    return plans


def p8_floor_bytes(plans: List[SitePlan]) -> int:
    """The 1-byte-per-weight floor — the ``p8-weights`` preset's budget."""
    return sum(p.n_weights for p in plans)


def resolve_budget(byte_budget, floor: int) -> int:
    """Budget spellings: None -> the p8 floor; ``"1.5x"`` -> multiple of the
    floor (so ``1x`` = p8-weights bytes, ``2x`` = p16 everywhere); an int (or
    digit string) -> absolute bytes."""
    if byte_budget is None:
        return floor
    if isinstance(byte_budget, str):
        s = byte_budget.strip().lower()
        if s.endswith("x"):
            return int(round(float(s[:-1]) * floor))
        return int(s)
    return int(byte_budget)


def search(plans: List[SitePlan], byte_budget=None
           ) -> Tuple[Dict[str, PositFmt], dict]:
    """Greedy knapsack over sites; returns ({site: fmt}, report).

    ``byte_budget=None`` means the p8 floor (every site stays 1 B/value and
    only es is allocated — the equal-bytes configuration the acceptance
    criterion compares against the ``p8-weights`` preset); see
    ``resolve_budget`` for the other spellings.
    """
    floor = p8_floor_bytes(plans)
    budget = resolve_budget(byte_budget, floor)
    if budget < floor:
        raise ValueError(
            f"weight byte budget {budget} is below the p8 floor {floor} "
            f"(1 byte per weight is the smallest storage this stack has)")

    choice: Dict[str, PositFmt] = {}
    scores: Dict[str, float] = {}
    upgrades = []
    for p in plans:
        c8, s8 = p.best(8)
        c16, s16 = p.best(16)
        choice[p.path], scores[p.path] = c8, s8
        if s16 < s8:
            # error reduction per extra byte if this site goes p16
            upgrades.append((-(s8 - s16) / p.n_weights, p.path, c16, s16))

    spent = floor
    for _, path, c16, s16 in sorted(upgrades):
        plan = next(p for p in plans if p.path == path)
        extra = plan.n_weights        # p16 doubles this site's bytes
        if spent + extra > budget:
            continue
        spent += extra
        choice[path], scores[path] = c16, s16

    total_score = sum(scores.values())
    report = {
        "byte_budget": budget,
        "p8_floor_bytes": floor,
        "weight_bytes": spent,
        "predicted_err_score": total_score,
        "sites": [{
            "path": p.path,
            "n_weights": p.n_weights,
            "fmt": choice[p.path].name,
            "packed": bool(choice[p.path].nbits == 8 and p.pack_ok),
            "act_rms": round(p.act_rms, 6),
            "w_rms": round(p.w_stats.rms, 6),
            "w_abs_max": p.w_stats.abs_max,
            "outlier_mass": errmodel.outlier_mass(p.w_stats, choice[p.path]),
            "predicted_sq_rel_err": errmodel.tensor_sq_rel_err(
                p.w_stats, choice[p.path]),
            # calibration-time activation binade histogram: the drift
            # baseline a numerics probe (the reference's obs/numerics.py) compares against
            **({"act_hist": p.act_stats.hist_json()}
               if p.act_stats is not None else {}),
        } for p in plans],
    }
    return choice, report


def emit_policy(plans: List[SitePlan], choice: Dict[str, PositFmt],
                base=None, name: str = "calibrated") -> PrecisionPolicy:
    """Materialize the search result as an ordered-rule PrecisionPolicy."""
    rules = [LayerRule(p.path, choice[p.path],
                       packed=choice[p.path].nbits == 8 and p.pack_ok)
             for p in plans]
    rules.append(LayerRule("*", None))   # pin unobserved layers to the base
    return PrecisionPolicy(base=base if base is not None else TransPolicy(),
                           rules=tuple(rules), name=name)


def calibration_batches(cfg, rng, n: int, *, batch: int = 2, seq: int = 64,
                        device="cuda") -> List[dict]:
    """``n`` random loss-shaped batches for ``cfg``'s model family, drawn
    from ``rng`` (a ``numpy.random.Generator``) in the reference's order, as
    tensors on ``device``.

    Tokens + labels (calibration drives ``model.loss`` so the lm_head site
    is observed). The one definition every calibration entry point shares
    (``serve --calibrate``, chip_smoke.py). The whisper family, whose loss
    is not ported (ROADMAP Queue 1 item 5b), is refused: its batches would
    also carry the reference's frames.
    """
    if cfg.family == "whisper":
        raise NotImplementedError(
            "calibration drives the model's loss; the whisper family's loss is not "
            "ported (ROADMAP Queue 1 item 5b)")
    dev = resolve_device(device)
    batches = []
    for _ in range(n):
        b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))).to(dev),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq))).to(dev)}
        batches.append(b)
    return batches


def calibrate_model(forward_fn, batches, params, *, base=None,
                    byte_budget=None, name: str = "calibrated"
                    ) -> Tuple[PrecisionPolicy, dict]:
    """observe -> search -> policy, end to end.

    ``forward_fn(batch)`` runs the model's forward code (any callable; it
    runs under ``torch.no_grad()``);
    ``batches`` is the calibration set; ``params`` the float param tree the
    byte accounting walks; ``base`` supplies every non-weight role of the
    emitted policy.  Returns ``(policy, report)`` where ``report`` is the
    JSON-ready calibration record (also embedded in saved artifacts as
    ``meta``).
    """
    observer = collect_stats(forward_fn, batches)
    plans = build_site_plans(params, observer)
    if not plans:
        raise ValueError(
            "calibration observed no linear call sites — did the forward "
            "pass run under float (unquantized) params?")
    choice, report = search(plans, byte_budget)
    policy = emit_policy(plans, choice, base=base, name=name)
    report["n_sites"] = len(plans)
    report["name"] = name
    return policy, report


def save_artifact(path: str, policy: PrecisionPolicy, report: dict) -> None:
    """Write the calibration artifact: the policy JSON plus the search
    report under ``meta`` (ignored on load — ``from_json`` reads only the
    policy fields, so hand-edited artifacts stay loadable)."""
    import json

    doc = policy.to_json()
    doc["meta"] = report
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
