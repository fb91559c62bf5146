"""The byte-budgeted search (``calib/search.py``) against the reference's on
the CPU.

* Given identical statistics (the reference observer's, from a reduced
  phi3-mini-3.8b loss, converted to the port's ``TensorStats``),
  ``build_site_plans`` on the port's per-layer tree gives the reference's
  sites, ``n_weights`` and ``pack_ok`` from its stacked tree; ``search``,
  ``emit_policy`` and the report equal the reference's exactly at budgets
  None, 1.25x, 1.5x, 2x and an absolute byte count; a budget below the
  floor raises.
* ``calibration_batches`` draws the reference's batches for seeds 0-3, and
  refuses whisper (its loss is not ported).
* The reference's own search tests on toy plans, on the port.
"""
import jax
import numpy as np
import pytest

from repro.calib import observe as jobserve
from repro.calib import search as jsearch
from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.models.registry import build_model as jax_build
from repro_torch.calib import observe, search
from repro_torch.calib.search import SitePlan, emit_policy, p8_floor_bytes, resolve_budget
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import pcsr

ARCHS = ("phi3-mini-3.8b", "olmoe-1b-7b")


class _Stats:
    """An observer stand-in holding given statistics (what build_site_plans reads)."""

    def __init__(self, stats: dict):
        self.stats = stats

    def paths(self):
        return tuple(sorted({p for p, _ in self.stats}))

    def get(self, path, kind):
        return self.stats.get((path, kind))


def _port_stats(st: jobserve.TensorStats) -> observe.TensorStats:
    return observe.TensorStats(n=st.n, zeros=st.zeros, abs_max=st.abs_max, sum_sq=st.sum_sq,
                               nonfinite=st.nonfinite, hist=st.hist.copy(), size=st.size,
                               shape=st.shape)


@pytest.fixture(scope="module", params=ARCHS)
def observed(request):
    arch = request.param
    jcfg = jax_arch(arch).reduced()
    jm = jax_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(0))
    batches = jsearch.calibration_batches(jcfg, np.random.default_rng(0), 2, batch=2, seq=16)
    jobs = jobserve.collect_stats(lambda b: jm.loss(jp, b, jpcsr.P8_SERVE)[0], batches)
    params = params_from_jax(jax.tree.map(np.asarray, jp), get_arch(arch).reduced(),
                             device="cpu")
    tobs = _Stats({k: _port_stats(v) for k, v in jobs.stats.items()})
    return jp, jobs, params, tobs


def test_site_plans_match_reference(observed):
    jp, jobs, params, tobs = observed
    want = jsearch.build_site_plans(jp, jobs)
    got = search.build_site_plans(params, tobs)
    assert [(p.path, p.n_weights, p.pack_ok, p.act_rms) for p in got] == \
        [(p.path, p.n_weights, p.pack_ok, p.act_rms) for p in want]


@pytest.mark.parametrize("budget", [None, "1.25x", "1.5x", "2x", "absolute"])
def test_search_and_policy_match_reference(observed, budget):
    jp, jobs, params, tobs = observed
    jplans = jsearch.build_site_plans(jp, jobs)
    plans = search.build_site_plans(params, tobs)
    if budget == "absolute":
        budget = p8_floor_bytes(plans) + 3 * plans[0].n_weights // 2
    jchoice, jrep = jsearch.search(jplans, budget)
    choice, rep = search.search(plans, budget)
    assert {k: v.name for k, v in choice.items()} == {k: v.name for k, v in jchoice.items()}
    assert rep == jrep
    for base, jbase in ((pcsr.P8_SERVE, jpcsr.P8_SERVE), (None, None)):
        pol = emit_policy(plans, choice, base=base, name="c")
        assert pol.to_json() == jsearch.emit_policy(jplans, jchoice, base=jbase,
                                                    name="c").to_json()


def test_budget_below_floor_raises(observed):
    _, _, params, tobs = observed
    plans = search.build_site_plans(params, tobs)
    with pytest.raises(ValueError, match="below the p8 floor"):
        search.search(plans, p8_floor_bytes(plans) - 1)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_batches_match_reference(arch, seed):
    jcfg, cfg = jax_arch(arch).reduced(), get_arch(arch).reduced()
    want = jsearch.calibration_batches(jcfg, np.random.default_rng(seed), 3, batch=2, seq=8)
    got = search.calibration_batches(cfg, np.random.default_rng(seed), 3, batch=2, seq=8,
                                     device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def test_calibration_batches_refuse_whisper():
    """whisper's loss is not ported, so no calibration batch is drawn for it."""
    with pytest.raises(NotImplementedError, match="item 5b"):
        search.calibration_batches(get_arch("whisper-medium").reduced(),
                                   np.random.default_rng(0), 1, device="cpu")


# ------------------------------------------------ the reference's toy tests ----

def _stats_at(s: int, n: float = 1000.0) -> observe.TensorStats:
    st = observe.TensorStats()
    st.n = n
    st.hist = np.zeros((observe.NBINS,))
    st.hist[s - observe.BIN_LO] = n
    st.sum_sq = n * 4.0 ** s
    return st


def _toy_plans():
    return [SitePlan("attn/wq", 1000, True, _stats_at(-4), act_rms=4.0),
            SitePlan("mlp/up", 4000, True, _stats_at(-4), act_rms=0.25),
            SitePlan("moe/w_up", 2000, False, _stats_at(-4), act_rms=1.0)]


def test_resolve_budget_spellings():
    assert resolve_budget(None, 7000) == 7000
    assert resolve_budget("1.5x", 7000) == 10500
    assert resolve_budget("12345", 7000) == 12345
    assert resolve_budget(9000, 7000) == 9000


def test_search_respects_floor_and_budget():
    plans = _toy_plans()
    assert p8_floor_bytes(plans) == 7000
    with pytest.raises(ValueError, match="below the p8 floor"):
        search.search(plans, 6999)
    choice, report = search.search(plans, None)
    assert all(f.nbits == 8 for f in choice.values()) and report["weight_bytes"] == 7000
    choice, report = search.search(plans, "2x")
    assert all(f.nbits == 16 for f in choice.values()) and report["weight_bytes"] == 14000


def test_search_upgrades_best_error_per_byte_first():
    plans = _toy_plans()
    choice, _ = search.search(plans, 7000 + 1000 + 2000)
    assert choice["attn/wq"].nbits == 16 and choice["moe/w_up"].nbits == 16
    assert choice["mlp/up"].nbits == 8
    scores = [search.search(plans, b)[1]["predicted_err_score"]
              for b in (7000, 9000, 11000, 14000)]
    assert scores == sorted(scores, reverse=True)


def test_emit_policy_packed_and_pin():
    plans = _toy_plans()
    choice, _ = search.search(plans, None)
    pol = emit_policy(plans, choice, base=pcsr.TransPolicy(), name="t")
    attn = pol.policy_for("blocks/attn/wq")
    assert attn.weights.nbits == 8 and attn.pack_weights
    moe = pol.policy_for("moe/w_up")
    assert moe.weights.nbits == 8 and not moe.pack_weights
    assert pol.policy_for("never/observed").weights is None


def test_lazy_package_exports():
    import repro_torch.calib as calib

    assert calib.search is search
    assert calib.calibrate_model is search.calibrate_model
    assert calib.save_artifact is search.save_artifact
    with pytest.raises(AttributeError):
        calib.nothing_here
