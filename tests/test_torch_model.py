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
rounding moves a logit by ~1e-2 (0.05). The per-layer presets: p8-packed
computes in bf16 over a bf16 KV cache (0.05, as P8_SERVE); attn-p16-mlp-p8
computes in f32 over an f32 cache, p16 attention and packed-p8 MLP/head
weights decoded exactly, so only the summation order differs (1e-4).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.core import policy as jpolicy
from repro.models.layers import quantize_params as jax_quantize
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import pcsr, policy
from repro_torch.models.registry import build_model
from repro_torch.models.layers import quantize_params

POLICIES = {
    "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE, 0.05),
    "p16": (jpcsr.TransPolicy.from_names(weights="p16_1", kv_cache="p16_1"),
            pcsr.TransPolicy.from_names(weights="p16_1", kv_cache="p16_1"), 2e-3),
    "f32": (jpcsr.FP32_POLICY, pcsr.FP32_POLICY, 1e-4),
    "p8-packed": (jpolicy.PRECISION_PRESETS["p8-packed"], policy.PRECISION_PRESETS["p8-packed"],
                  0.05),
    "attn-p16-mlp-p8": (jpolicy.PRECISION_PRESETS["attn-p16-mlp-p8"],
                        policy.PRECISION_PRESETS["attn-p16-mlp-p8"], 1e-4),
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


def _layer_leaves(tree, path=""):
    """(path, leaf) of every tensor leaf, the blocks' layer index kept."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _layer_leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _layer_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["p8-packed", "attn-p16-mlp-p8"])
def test_quantize_params_per_layer_matches_reference(name):
    """quantize_params under a per-layer preset, on the reference's floats
    converted bit for bit: every leaf equal to the reference's (``w_packed``
    lanes included, the stacked (L, Kh, N) uint16 carried into the port's
    per-layer dicts by ``params_from_jax``), and init_lm's draw-time
    quantization equal to quantizing its own float draw afterwards."""
    jpol, pol, _ = POLICIES[name]
    _, _, jfloat = _reference("qwen2.5-14b", jpcsr.FP32_POLICY)
    cfg = get_arch("qwen2.5-14b").reduced()
    jq = jax.tree.map(np.asarray, jax_quantize(jfloat, jpol))
    tq = quantize_params(params_from_jax(jax.tree.map(np.asarray, jfloat), cfg, device="cpu"),
                         pol)
    converted = params_from_jax(jq, cfg, device="cpu")
    leaves = dict(_layer_leaves(tq))
    assert leaves.keys() == dict(_layer_leaves(converted)).keys()
    for path, leaf in _layer_leaves(converted):
        assert leaves[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(leaves[path].numpy(), leaf.numpy(), err_msg=path)
    packed = [p for p in leaves if p.endswith("w_packed")]
    assert len(packed) == (3 * cfg.n_layers + 1 if name == "attn-p16-mlp-p8"
                           else 7 * cfg.n_layers + 1)
    assert leaves["blocks/0/mlp/gate/w_packed"].shape == (cfg.d_model // 2, cfg.d_ff)
    model = build_model(cfg, device="cpu")
    drawn = dict(_layer_leaves(model.init(3, pol)))
    later = dict(_layer_leaves(quantize_params(model.init(3), pol)))
    assert drawn.keys() == later.keys()
    for path, leaf in drawn.items():
        np.testing.assert_array_equal(leaf.numpy(), later[path].numpy(), err_msg=path)


def test_other_families_raise():
    cfg = dataclass_replace(get_arch("qwen2.5-14b").reduced(), family="zamba")
    with pytest.raises(NotImplementedError, match="zamba"):
        build_model(cfg, device="cpu")
    with pytest.raises(KeyError):
        get_arch("zamba2-7b")


def test_unported_policy_knobs_raise():
    """attn_impl="xla" (the full-cache einsum) stays unported and raises.
    codec_impl="lut" and epilogue="chained", once refused, are ported: the
    same model runs under each (held against the reference in
    test_ported_policy_knobs_match_reference)."""
    cfg = get_arch("phi3-mini-3.8b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, pcsr.P8_SERVE)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        model.prefill(params, tokens, dataclass_replace(pcsr.P8_SERVE, attn_impl="xla"))
    base, _ = model.prefill(params, tokens, pcsr.P8_SERVE)
    for knob in (dict(codec_impl="lut"), dict(epilogue="chained")):
        logits, _ = model.prefill(params, tokens, dataclass_replace(pcsr.P8_SERVE, **knob))
        np.testing.assert_array_equal(logits.numpy(), base.numpy())


@pytest.mark.parametrize("knob", [dict(codec_impl="lut"), dict(codec_impl="bits"),
                                  dict(epilogue="chained")], ids=str)
def test_ported_policy_knobs_match_reference(knob):
    """The reduced qwen2.5-14b under P8_SERVE and under the packed mixed
    preset with a codec or epilogue knob turned: prefill logits within the
    policy's bound of the reference with the same knob."""
    for name in ("p8-serve", "attn-p16-mlp-p8"):
        jpol, pol, bound = POLICIES[name]
        jpol, pol = _with_knob(jpol, knob), _with_knob(pol, knob)
        _, jm, jparams = _reference("qwen2.5-14b", jpol)
        cfg = get_arch("qwen2.5-14b").reduced()
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
        want, _ = jax.jit(lambda p, t: jm.prefill(p, t, jpol, S_max=12))(
            jparams, jnp.asarray(tokens))
        got, _ = build_model(cfg, device="cpu").prefill(params, torch.from_numpy(tokens), pol,
                                                         S_max=12)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= bound, (name, knob)


def _with_knob(pol, knob):
    """``pol`` with a TransPolicy knob set (on the base of a per-layer policy)."""
    if hasattr(pol, "with_base"):
        return pol.with_base(dataclass_replace(pol.base, **knob))
    return dataclass_replace(pol, **knob)


def test_serve_cli_precision_policy_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --precision-policy`` on the CPU,
    in each spelling: every request completes, the report names the per-layer
    schedule, and the policy's weight bytes follow the rules (attention p16 =
    2 bytes, MLP and head packed p8 = 1 byte, against 4 in f32)."""
    import json as _json

    from repro_torch.launch import serve as serve_mod

    cfg = get_arch("qwen2.5-14b").reduced()
    d, f, kv = cfg.d_model, cfg.d_ff, cfg.n_kv * cfg.hd
    attn_n = d * (2 * d + 2 * kv)
    mlp_n = 3 * d * f
    want_bytes = cfg.n_layers * (2 * attn_n + mlp_n) + d * cfg.vocab
    want_f32 = 4 * (cfg.n_layers * (attn_n + mlp_n) + d * cfg.vocab)
    for spec in ("attn-p16-mlp-p8", "*attn*=p16_1,*=p8_0:packed"):
        serve_mod.main(["--arch", "qwen2.5-14b", "--reduced", "--continuous", "--requests", "3",
                        "--prompt-len", "6", "--gen", "3", "--device", "cpu",
                        "--precision-policy", spec])
        lines = [_json.loads(x) for x in capsys.readouterr().out.splitlines()]
        report = lines[-1]
        assert report["kind"] == "serve/report" and report["requests"] == 3
        assert all(n == 3 for n in report["completion_tokens"].values())
        assert report["nonfinite_logit_rows"] == 0
        assert report["policy"].startswith(f"precision={spec}")
        assert "kv_cache=p8_0" in report["policy"]   # the --policy base's KV role
        assert report["weight_bytes_policy"] == want_bytes
        assert report["weight_bytes_f32"] == want_f32


def dataclass_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)
