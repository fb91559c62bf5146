"""Whole-model parity of the moe family on the CPU: reduced olmoe-1b-7b and
granite-moe-3b-a800m under P8_SERVE and attn-p16-mlp-p8, the reference's
params converted bit for bit. Prefill + 6 decode steps fed the reference's
greedy tokens: logits within 0.05 (bf16 activations and p8 K/V, where one
flipped rounding moves a logit ~1e-2), and the port's own greedy token the
reference's at every step (equal greedy streams)."""
import jax
import jax.numpy as jnp
import numpy as np
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

MODEL_POLICIES = {
    "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE),
    "attn-p16-mlp-p8": (jpolicy.get_precision_policy("attn-p16-mlp-p8", base=jpcsr.P8_SERVE),
                        policy.get_precision_policy("attn-p16-mlp-p8", base=pcsr.P8_SERVE)),
}
MODEL_BOUND = 0.05
ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")


def _reference_model(arch, jpol, seed=0):
    jcfg = jax_arch(arch).reduced()
    jm = jax_build(jcfg)
    jparams = jax.jit(jm.init)(jax.random.key(seed))
    if jpol.weights is not None:
        jparams = jax_quantize(jparams, jpol)
    return jcfg, jm, jparams


@pytest.mark.parametrize("name", list(MODEL_POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_model_matches_reference(arch, name):
    jpol, pol = MODEL_POLICIES[name]
    jcfg, jm, jparams = _reference_model(arch, jpol)
    cfg = get_arch(arch).reduced()
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, jpol, S_max=20))(jparams, jnp.asarray(tokens))
    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, jpol))
    tl, tc = model.prefill(params, torch.from_numpy(tokens), pol, S_max=20)
    worst = 0.0
    for step in range(7):
        ref, got = np.asarray(jl), tl.numpy()
        assert got.shape == ref.shape == (2, cfg.vocab) and np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - ref).max()))
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))   # equal greedy streams
        if step == 6:
            break
        tok = ref.argmax(-1).astype(np.int32)
        jl, jc = jdec(jparams, jnp.asarray(tok), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(tok), tc, pol)
    assert worst <= MODEL_BOUND, worst
    np.testing.assert_array_equal(tc["lens"].numpy(), np.asarray(jc["lens"]))
