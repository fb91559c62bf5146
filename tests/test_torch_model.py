"""Whole-model parity on reduced dense configs: the reference's prefill + 8
decode steps against the port's, from the same parameters (the reference's
init, converted bit for bit by ``convert.params_from_jax``).

Both sides are fed the reference's greedy token at every step, so a flipped
near-tie cannot make the streams diverge. Contract per policy:
* logits within the stated bound (max |port - ref| over prefill + 8 steps);
* equal greedy tokens wherever the reference's top-2 margin exceeds twice
  that bound.
Bounds: f32 compute differs only in summation order and the last ulp of
exp/rsqrt/sin (1e-4); p16 weights + p16 KV can move a KV code by one ulp
(2e-3); P8_SERVE rounds activations to bf16 and K/V to p8, where one flipped
rounding moves a logit by ~1e-2 (0.05).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.models.layers import quantize_params as jax_quantize
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import pcsr
from repro_torch.models.registry import build_model
from repro_torch.models.layers import quantize_params

POLICIES = {
    "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE, 0.05),
    "p16": (jpcsr.TransPolicy.from_names(weights="p16_1", kv_cache="p16_1"),
            pcsr.TransPolicy.from_names(weights="p16_1", kv_cache="p16_1"), 2e-3),
    "f32": (jpcsr.FP32_POLICY, pcsr.FP32_POLICY, 1e-4),
}
ARCHS = ("qwen2.5-14b", "phi3-mini-3.8b")


def _reference(arch, jpol, seed=0):
    cfg = jax_arch(arch).reduced()
    model = jax_build(cfg)
    params = jax.jit(model.init)(jax.random.key(seed))
    if cfg.qkv_bias:  # non-zero biases, so the bias epilogue is exercised
        rng = np.random.default_rng(seed + 1)
        for w in ("wq", "wk", "wv"):
            b = params["blocks"]["attn"][w]["b"]
            params["blocks"]["attn"][w]["b"] = jnp.asarray(
                rng.normal(0, 0.1, b.shape).astype(np.float32))
    if jpol.weights is not None:
        params = jax_quantize(params, jpol)
    return cfg, model, params


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, policy):
    jpol, pol, bound = POLICIES[policy]
    jcfg, jm, jparams = _reference(arch, jpol)
    cfg = get_arch(arch).reduced()
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)

    jpre = jax.jit(lambda p, t: jm.prefill(p, t, jpol, S_max=24))
    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, jpol))
    jl, jc = jpre(jparams, jnp.asarray(tokens))
    tl, tc = model.prefill(params, torch.from_numpy(tokens), pol, S_max=24)
    worst, clear = 0.0, 0
    for step in range(9):
        ref, got = np.asarray(jl), tl.numpy()
        assert got.shape == ref.shape == (2, cfg.vocab) and np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - ref).max()))
        top2 = np.sort(ref, axis=-1)[:, -2:]
        margin_clear = top2[:, 1] - top2[:, 0] > 2 * bound
        assert (got.argmax(-1)[margin_clear] == ref.argmax(-1)[margin_clear]).all(), step
        clear += int(margin_clear.sum())
        if step == 8:
            break
        tok = ref.argmax(-1).astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(tok), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(tok), tc, pol)
    assert worst <= bound, worst
    assert clear >= 9          # the token check bit on at least half the rows
    np.testing.assert_array_equal(tc["lens"].numpy(), np.asarray(jc["lens"]))
    np.testing.assert_array_equal(tc["kv"]["len"].numpy(), np.asarray(jc["kv"]["len"]))


def test_convert_is_bit_exact_and_quantize_matches():
    jcfg, _, jfloat = _reference("qwen2.5-14b", jpcsr.FP32_POLICY)
    cfg = get_arch("qwen2.5-14b").reduced()
    tree = jax.tree.map(np.asarray, jfloat)
    params = params_from_jax(tree, cfg, device="cpu")
    assert len(params["blocks"]) == cfg.n_layers
    np.testing.assert_array_equal(params["blocks"][1]["mlp"]["up"]["w"].numpy(),
                                  tree["blocks"]["mlp"]["up"]["w"][1])
    # the port's quantize_params on converted floats == the reference's codes
    for jpol, pol in ((jpcsr.P8_SERVE, pcsr.P8_SERVE),
                      POLICIES["p16"][:2]):
        jq = jax.tree.map(np.asarray, jax_quantize(jfloat, jpol))
        tq = quantize_params(params, pol)
        for i in range(cfg.n_layers):
            for name in ("wq", "wk", "wv", "wo"):
                np.testing.assert_array_equal(
                    tq["blocks"][i]["attn"][name]["w_codes"].numpy(),
                    jq["blocks"]["attn"][name]["w_codes"][i])
        np.testing.assert_array_equal(tq["lm_head"]["w_codes"].numpy(),
                                      jq["lm_head"]["w_codes"])
        assert "w" in params["lm_head"]   # float masters untouched


def test_other_families_raise():
    cfg = dataclass_replace(get_arch("qwen2.5-14b").reduced(), family="moe")
    with pytest.raises(NotImplementedError, match="moe"):
        build_model(cfg, device="cpu")
    with pytest.raises(KeyError):
        get_arch("gemma3-4b")


def test_unported_policy_knobs_raise():
    cfg = get_arch("phi3-mini-3.8b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, pcsr.P8_SERVE)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for knob in (dict(codec_impl="lut"), dict(attn_impl="xla"), dict(epilogue="chained")):
        pol = dataclass_replace(pcsr.P8_SERVE, **knob)
        with pytest.raises(NotImplementedError):
            model.prefill(params, tokens, pol)


def dataclass_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)
