"""The moe family on the CPU against the reference, from the same parameters
(the reference's init, converted bit for bit by ``convert.params_from_jax``).

* ``apply_moe`` on identical ``h``: the same top-k experts (the port's
  ``top_k_stable`` orders ties as ``jax.lax.top_k``), outputs within the
  policy's bound, aux within 1e-6, with and without tokens dropped for
  capacity. Bounds: f32 compute differs only in summation order (1e-5);
  P8_SERVE rounds the expert inputs and silu(g) * u to bf16, where a silu
  one ulp apart can flip one bf16 rounding (1e-3 at these widths).
* Reduced olmoe: the paged engine the slot grid bit for bit; ``serve
  --arch <moe> --continuous [--paged]`` on the CPU (whole-model parity with
  the reference: tests/test_torch_moe_model.py).
* ``quantize_params`` of the expert stacks, ``policy_weight_bytes``, the
  converter's round trip, and training refused for moe.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.core import policy as jpolicy
from repro.models import moe as jmoe
from repro.models.layers import policy_weight_bytes as jax_weight_bytes
from repro.models.layers import quantize_params as jax_quantize
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import pcsr, policy
from repro_torch.launch import steps
from repro_torch.launch.engine import ContinuousBatchingEngine, Request
from repro_torch.launch.paged_engine import PagedContinuousBatchingEngine
from repro_torch.models import moe
from repro_torch.models.layers import policy_weight_bytes, quantize_params
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig

D, F, E, K = 128, 256, 8, 2
POLICIES = {
    "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE, 1e-3),
    "f32": (jpcsr.FP32_POLICY, pcsr.FP32_POLICY, 1e-5),
}
MODEL_POLICIES = {
    "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE),
    "attn-p16-mlp-p8": (jpolicy.get_precision_policy("attn-p16-mlp-p8", base=jpcsr.P8_SERVE),
                        policy.get_precision_policy("attn-p16-mlp-p8", base=pcsr.P8_SERVE)),
}


def _moe_params(jpol):
    jp = jmoe.init_moe(jax.random.key(0), D, F, E)
    if jpol.weights is not None:
        jp = jax_quantize({"moe": jp}, jpol)["moe"]
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _ref_route(jp, h, jpol):
    """The reference's router top-k experts of ``h`` (B, S, D)."""
    from repro.models.layers import apply_linear

    logits = apply_linear(jp["router"], jnp.asarray(h).reshape(-1, D), jpol, path="moe/router")
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32), -1), K)[1])


def _port_route(tp, h, pol):
    from repro_torch.models.layers import apply_linear

    logits = apply_linear(tp["router"], torch.from_numpy(h).reshape(-1, D), pol,
                          path="moe/router")
    return moe.top_k_stable(torch.softmax(logits.to(torch.float32), -1), K)[1].numpy()


@pytest.mark.parametrize("shape", [(2, 12, 1.25), (4, 1, 1.25), (1, 64, 0.5)],
                         ids=["prefill", "decode", "dropped"])
@pytest.mark.parametrize("name", list(POLICIES))
def test_apply_moe_matches_reference(name, shape):
    jpol, pol, bound = POLICIES[name]
    B, S, cf = shape
    jp, tp = _moe_params(jpol)
    h = np.random.default_rng(1).normal(size=(B, S, D)).astype(np.float32)
    top = _ref_route(jp, h, jpol)
    np.testing.assert_array_equal(_port_route(tp, h, pol), top)
    C = moe.capacity(B * S, K, cf, E)
    dropped = int(np.maximum(np.bincount(top.ravel(), minlength=E) - C, 0).sum())
    if cf < 1:
        assert dropped > 0      # the case that drops tokens for capacity
    jy, jaux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, top_k=K, capacity_factor=cf,
                                                   policy=jpol))(jp, jnp.asarray(h))
    ty, taux = moe.apply_moe(tp, torch.from_numpy(h), top_k=K, capacity_factor=cf, policy=pol,
                             with_aux=True)
    assert ty.shape == (B, S, D) and ty.dtype == torch.float32
    assert float(np.abs(ty.numpy() - np.asarray(jy)).max()) <= bound
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_top_k_orders_ties_as_the_reference():
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = moe.top_k_stable(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(vals))


def test_capacity_is_the_reference_rule():
    # T = 4 decode slots of olmoe (top-8 of 64): 8 rows; a 64-token prefill
    # 16; a 4,032-token prefill 632
    assert moe.capacity(4, 8, 1.25, 64) == 8
    assert moe.capacity(64, 8, 1.25, 64) == 16
    assert moe.capacity(4032, 8, 1.25, 64) == 632
    assert moe.capacity(64, 2, 0.5, 8) == 8


def _reference_model(arch, jpol, seed=0):
    jcfg = jax_arch(arch).reduced()
    jm = jax_build(jcfg)
    jparams = jax.jit(jm.init)(jax.random.key(seed))
    if jpol.weights is not None:
        jparams = jax_quantize(jparams, jpol)
    return jcfg, jm, jparams


def _recorded(eng):
    steps = []
    decode = eng._decode

    def recording(p, t, c):
        logits, cache = decode(p, t, c)
        steps.append(logits.numpy()[eng.active].view(np.int32))
        return logits, cache

    eng._decode = recording
    return steps


def test_moe_paged_equals_grid_bit_for_bit():
    """Reduced olmoe, P8_SERVE, five requests at four slots (one waits for a
    slot): the paged engine and the slot grid emit the same tokens and
    every decode step's logits bit for bit (the moe dispatch sees the same
    batch in both)."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, pcsr.P8_SERVE)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (5, 8)).astype(np.int32)
    runs = []
    for eng in (ContinuousBatchingEngine(model, params, pcsr.P8_SERVE, max_slots=4, S_max=32),
                PagedContinuousBatchingEngine(model, params, pcsr.P8_SERVE, max_slots=4,
                                              S_max=32, page_bytes=256)):
        steps = _recorded(eng)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4))
        done = eng.run([])
        runs.append(({c.rid: c.tokens for c in done}, steps))
    (want, want_steps), (got, got_steps) = runs
    assert got == want and len(want) == 5 and len(got_steps) == len(want_steps) > 0
    for g, w in zip(got_steps, want_steps):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch,paged", [("olmoe-1b-7b", False), ("granite-moe-3b-a800m", True)])
def test_serve_cli_moe_on_cpu(arch, paged, capsys):
    import json

    from repro_torch.launch import serve as serve_mod

    argv = ["--arch", arch, "--reduced", "--continuous", "--requests", "3", "--prompt-len", "6",
            "--gen", "3", "--device", "cpu", "--precision-policy", "attn-p16-mlp-p8"]
    serve_mod.main(argv + (["--paged"] if paged else []))
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["kind"] == "serve/report" and report["requests"] == 3
    assert report["mode"] == ("paged" if paged else "continuous")
    assert all(n == 3 for n in report["completion_tokens"].values())
    assert report["nonfinite_logit_rows"] == 0
    cfg = get_arch(arch).reduced()
    experts = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    # the expert stacks at p8 (1 byte), against 4 in f32
    assert report["weight_bytes_f32"] - report["weight_bytes_policy"] >= 3 * experts


@pytest.mark.parametrize("name", ["p8-serve", "attn-p16-mlp-p8"])
def test_quantize_params_and_weight_bytes_match_reference(name):
    """The port's quantize_params on the converted floats gives the
    reference's expert codes (and router lanes) bit for bit; policy bytes
    over the float tree are the reference's; the converter round-trips the
    stacked expert leaves."""
    jpol, pol = MODEL_POLICIES[name]
    jcfg, _, jfloat = _reference_model("olmoe-1b-7b", jpcsr.FP32_POLICY)
    cfg = get_arch("olmoe-1b-7b").reduced()
    tree = jax.tree.map(np.asarray, jfloat)
    params = params_from_jax(tree, cfg, device="cpu")
    assert params["blocks"][1]["moe"]["w_up"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    np.testing.assert_array_equal(params["blocks"][1]["moe"]["w_down"].numpy(),
                                  tree["blocks"]["moe"]["w_down"][1])
    assert policy_weight_bytes(params, pol) == jax_weight_bytes(jfloat, jpol)
    jq = jax.tree.map(np.asarray, jax_quantize(jfloat, jpol))
    tq = quantize_params(params, pol)
    back = tree_to_jax(tq)
    assert jax.tree.structure(back) == jax.tree.structure(jq)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jq)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert "w_gate" in params["blocks"][0]["moe"]     # float masters untouched
    assert policy_weight_bytes(tq, pol) == jax_weight_bytes(jfloat, jpol)


def test_training_moe_is_refused():
    """The moe family's loss runs (forward only: tests/test_torch_moe_loss.py);
    its train step is refused, naming the queue item of its gradient."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5b"):
        steps.make_train_step(model, pcsr.FP32_POLICY, AdamWConfig())
