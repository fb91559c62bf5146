"""repro_torch.calib — data-driven dynamic-es calibration (the reference
package's ``calib/``, DESIGN.md §11).

Three layers:

* ``observe``  — calibration-mode forward pass streaming per-tensor log2
                 histograms from every linear call site, accumulated on the
                 device,
* ``errmodel`` — analytic tapered-accuracy round-trip error model per
                 (p8|p16) x es candidate,
* ``search``   — byte-budgeted knapsack emitting a ``PrecisionPolicy``
                 artifact (observe -> search -> quantize).

``observe`` and ``errmodel`` are import-light (models.layers imports the
observe hook); ``search`` joins against the model layer walker and is
exported lazily to keep the import graph acyclic.
"""
from repro_torch.calib.errmodel import (CANDIDATES, expected_sq_rel_err,
                                        measured_sq_rel_err, outlier_mass,
                                        significand_bits, tensor_abs_sq_err,
                                        tensor_sq_rel_err)
from repro_torch.calib.observe import (Observer, TensorStats, collect_stats,
                                       is_active, observing, record)

__all__ = [
    "CANDIDATES", "Observer", "TensorStats", "calibrate_model",
    "collect_stats", "expected_sq_rel_err", "is_active",
    "measured_sq_rel_err", "observing", "outlier_mass", "record",
    "save_artifact", "significand_bits", "tensor_abs_sq_err",
    "tensor_sq_rel_err",
]


def __getattr__(name):
    # search imports models.layers (which imports calib.observe): load on
    # first use instead of at package import to keep the cycle one-way.
    # importlib, not ``from repro_torch.calib import search``: the
    # from-import re-enters this __getattr__ before the submodule binds.
    if name in ("calibrate_model", "save_artifact", "search"):
        import importlib

        search = importlib.import_module("repro_torch.calib.search")
        return getattr(search, name) if name != "search" else search
    raise AttributeError(name)
