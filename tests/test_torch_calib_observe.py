"""The calibration observer (``calib/observe.py``) on the CPU against the
reference's (``repro.calib.observe``).

* Crafted arrays (zeros of both signs, subnormals, +-inf, NaN, exact powers
  of two and their f32 neighbours on both sides of every binade edge from
  2^-90 to 2^59, values past ``BIN_HI`` and below ``BIN_LO``, a wide
  log-uniform sample) recorded in several records: ``n``, ``zeros``,
  ``nonfinite``, ``abs_max``, ``hist``, ``size`` and ``shape`` exactly the
  reference's, ``sum_sq`` within a relative 1e-6 (one f32 sum a record, in
  XLA's order there and torch's here). Subnormals count as zeros in both
  (XLA on the CPU flushes them; the port does so by rule).
* The reference's own observer tests, on the port: exact stats, inactive is
  a no-op, and integer counts past 2^24 in one binade (a float32 count
  would saturate there).
* An observed forward of reduced phi3-mini-3.8b and olmoe-1b-7b gives the
  unobserved forward's bits; the ``"grad"`` kind raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.calib import observe as jobserve
from repro_torch.calib import observe
from repro_torch.calib.observe import Observer, TensorStats, observing
from repro_torch.configs import get_arch
from repro_torch.core import pcsr
from repro_torch.models.registry import build_model

SUM_SQ_REL = 1e-6


def _crafted() -> list:
    f32 = np.float32
    edge = []
    for k in range(-90, 60):
        p = f32(2.0 ** k)
        edge += [p, np.nextafter(p, f32(0)), np.nextafter(p, f32(np.inf)), -p]
    special = np.array([0.0, -0.0, 1e-45, -2e-40, 1.1754942e-38, np.inf, -np.inf, np.nan,
                        2.0 ** -100, 2.0 ** 60, -2.0 ** 120, 3.0e38], f32)
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal(50_000) * 10.0 ** rng.integers(-35, 18, 50_000)).astype(f32)
    wide[::97] = 0.0
    return [np.asarray(edge, f32), special, wide.reshape(500, 100), wide[:777] * 2.0 ** 40]


def _both(arrays, path="site", kind="weight"):
    jobs, tobs = jobserve.Observer(), Observer()
    with jobserve.observing(jobs):
        for a in arrays:
            jobserve.record(path, kind, jnp.asarray(a))
    jax.effects_barrier()
    with observing(tobs):
        for a in arrays:
            observe.record(path, kind, torch.from_numpy(np.ascontiguousarray(a)))
    return jobs.get(path, kind), tobs.get(path, kind)


def _assert_stats_equal(want: jobserve.TensorStats, got: TensorStats) -> None:
    for f in ("n", "zeros", "nonfinite", "abs_max", "size", "shape"):
        assert getattr(got, f) == getattr(want, f), (f, getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.hist, want.hist)
    if np.isfinite(want.sum_sq):
        assert abs(got.sum_sq - want.sum_sq) <= SUM_SQ_REL * want.sum_sq
    else:
        assert got.sum_sq == want.sum_sq


@pytest.mark.parametrize("which", ["edges", "special", "wide", "shifted", "all"])
def test_observer_matches_reference_on_crafted_arrays(which):
    arrays = _crafted()
    pick = {"edges": arrays[:1], "special": arrays[1:2], "wide": arrays[2:3],
            "shifted": arrays[3:4], "all": arrays}[which]
    want, got = _both(pick)
    _assert_stats_equal(want, got)
    assert got.hist_json() == want.hist_json()
    assert got.rms == want.rms or abs(got.rms - want.rms) <= SUM_SQ_REL * want.rms


def test_observer_edges_land_in_their_binades():
    """2^k in binade k, its lower neighbour in k - 1; past the range the
    end bins; subnormals with the zeros; inf/NaN nonfinite."""
    for k in (-80, -79, -1, 0, 1, 48, 49):
        p = np.float32(2.0 ** k)
        _, st = _both([np.array([p, np.nextafter(p, np.float32(0))], np.float32)], path=str(k))
        s = np.clip(np.array([k, k - 1]), observe.BIN_LO, observe.BIN_HI) - observe.BIN_LO
        want = np.zeros(observe.NBINS)
        np.add.at(want, s, 1)
        np.testing.assert_array_equal(st.hist, want)
    _, st = _both([np.array([1e-45, 0.0, np.inf, np.nan, -np.inf], np.float32)], path="z")
    assert st.zeros == 2 and st.nonfinite == 3 and st.hist.sum() == 0


def test_observer_streams_exact_stats():
    obs = Observer()
    with observing(obs):
        observe.record("site", "weight", torch.tensor([0.0, 0.75, 3.0, -4.0]))
    st = obs.get("site", "weight")
    assert st.n == 4 and st.zeros == 1
    assert st.abs_max == 4.0
    assert st.sum_sq == pytest.approx(0.75 ** 2 + 9.0 + 16.0)
    assert st.hist[-1 - observe.BIN_LO] == 1
    assert st.hist[1 - observe.BIN_LO] == 1
    assert st.hist[2 - observe.BIN_LO] == 1
    assert st.hist.sum() == 3


def test_observer_inactive_is_noop():
    observe.record("nowhere", "act", torch.ones((4,)))
    assert not observe.is_active() and observe.get_active() is None


def test_observer_hist_counts_are_integer_exact():
    """One record of 2^24 + 3 equal values (past a float32 count's exact
    range, and past one histogram chunk), four times."""
    obs = Observer()
    n = (1 << 24) + 3
    ones = torch.ones((n,))
    with observing(obs):
        for _ in range(4):
            observe.record("big", "weight", ones)
    st = obs.get("big", "weight")
    assert st.hist[-observe.BIN_LO] == 4 * n
    assert st.n == 4 * n and st.zeros == 0


def test_observer_kinds_filter_and_grad_refused():
    obs = Observer(kinds=("act",))
    with observing(obs):
        observe.record("s", "weight", torch.ones(3))
        observe.record("s", "act", torch.ones(3))
    assert obs.paths() == ("s",) and obs.get("s", "weight") is None
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        Observer(kinds=("act", "grad"))


def test_hist_json_round_trip():
    _, st = _both(_crafted()[2:3])
    back = TensorStats.hist_from_json(st.hist_json())
    np.testing.assert_array_equal(back.hist, st.hist)
    assert back.n == st.n


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b"])
def test_observed_forward_is_bit_identical(arch):
    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = {"tokens": torch.arange(16).reshape(2, 8) % cfg.vocab}
    pol = pcsr.TransPolicy.from_names(weights="p8_0")
    with torch.no_grad():
        ref = model.forward(params, batch, pol)
        obs = Observer()
        with observing(obs):
            seen = model.forward(params, batch, pol)
    assert torch.equal(ref, seen)
    assert obs.get("attn/wq", "act") is not None and obs.get("attn/wq", "weight") is not None
