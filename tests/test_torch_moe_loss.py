"""The moe family's ``forward`` and ``lm_loss`` (forward only) on the CPU
against the reference's: reduced olmoe-1b-7b, the reference's params
converted bit for bit, tokens and labels from numpy, under an f32 base, p16
P8_SERVE (bf16 compute, p8 straight-through weights). Training the
family stays refused.

Tolerances (``POLICIES``; readings at seeds 0-3, with p16 weights too:
hidden 1.2e-6, ce 1.4e-7, aux 1.0e-7 of their magnitudes under f32
compute; 2.1e-3, 1.4e-5 and 6.9e-6 under bf16): the final hidden state within ``h`` of its largest magnitude,
``ce`` and ``aux`` within ``loss`` relative. The dispatch (top-k, capacity,
dropped tokens) is the reference's; f32 sums differ in order, and under
bf16 compute one flipped activation rounding moves a hidden value by a
bf16 ulp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import pcsr
from repro_torch.launch import steps, train
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig

ARCH = "olmoe-1b-7b"
POLICIES = {"none": (jpcsr.FP32_POLICY, pcsr.FP32_POLICY, 1e-5, 1e-6, 0),
            "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE, 1e-2, 1e-4, 1)}


@pytest.mark.parametrize("name", list(POLICIES))
def test_moe_forward_and_loss_match_reference(name):
    jpol, pol, h_bound, loss_bound, seed = POLICIES[name]
    jcfg = jax_arch(ARCH).reduced()
    jm = jax_build(jcfg)
    jp = jax.jit(jm.init)(jax.random.key(seed))
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (2, 24)),
         "labels": rng.integers(0, cfg.vocab, (2, 24))}
    jmet, jh = jax.jit(lambda p, b: (jm.loss(p, b, jpol)[1],
                                     jm.forward(p, {"tokens": b["tokens"]}, jpol)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    jh = np.asarray(jh)
    with torch.no_grad():
        loss, met = model.loss(params, {k: torch.from_numpy(v) for k, v in b.items()}, pol)
        h = model.forward(params, {"tokens": torch.from_numpy(b["tokens"])}, pol).numpy()
    assert h.shape == jh.shape == (2, 24, cfg.d_model)
    assert np.abs(h - jh).max() <= h_bound * np.abs(jh).max()
    for k in ("ce", "aux"):
        want = float(jmet[k])
        assert want > 0 and abs(float(met[k]) - want) <= loss_bound * want, (k, met[k], want)
    assert float(loss) == pytest.approx(float(met["ce"]) + 0.01 * float(met["aux"]), rel=1e-6)


def test_make_train_step_refuses_moe():
    model = build_model(get_arch(ARCH).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 5b"):
        steps.make_train_step(model, pcsr.P16_TRAIN, AdamWConfig())


def test_train_cli_refuses_moe():
    with pytest.raises(NotImplementedError, match="item 5b"):
        train.main(["--arch", ARCH, "--reduced", "--steps", "1", "--batch", "2", "--seq", "8",
                    "--device", "cpu"])
