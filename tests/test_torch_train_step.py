"""Three steps of the port's train step (``launch.steps.make_train_step``)
against the reference's jitted step, from the same parameters and AdamW
state (the reference's, converted by ``convert``) on the same numpy
batches; and gradient accumulation over two microbatches against one batch.

Tolerances: each step's loss within 1e-6 relative and its global gradient
norm within 1e-5 relative; float moments within 1e-4 of their leaf's
largest magnitude (they carry the gradients' summation-order differences),
p16 moment codes within 1 code. Parameters after three steps: within 1e-5
of the leaf's largest magnitude (AdamW turns a gradient's last-bit
differences into update differences of ~1e-6 of a weight's scale at lr
3e-4), except where a gradient element is itself at the level of summation
noise (a sum that cancels): AdamW divides the first moment by the root of
the second, so noise there becomes a step of up to ~lr either way. Such
elements may be at most 0.1% of a leaf (at least one is allowed), each
within twice the sum of the three steps' learning rates. The key
projection's bias (qwen2.5-14b) holds several by construction: RoPE rotates
the bias with the key, and along its slowest frequencies (base 1e6) a key
turns by ~1e-5 rad over 16 positions, so those components shift every score
of a query alike, which softmax ignores, and their true gradient is ~0; the
leaf is held to the learning-rate bound alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pcsr as jpcsr
from repro.launch import steps as jsteps
from repro.optim import adamw as jadamw
from repro_torch.configs import get_arch
from repro_torch.convert import opt_state_from_jax, params_from_jax, tree_to_jax
from repro_torch.core import pcsr
from repro_torch.launch import steps
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, cosine_warmup

from test_torch_train_model import assert_trees_close, batch, reference

POLICIES = {"none": (jpcsr.FP32_POLICY, pcsr.FP32_POLICY),
            "p16-train": (jpcsr.P16_TRAIN, pcsr.P16_TRAIN)}


def assert_params_close(got, want, lr_sum: float, path: str = ""):
    if isinstance(want, dict):
        for k in want:
            assert_params_close(got[k], want[k], lr_sum, f"{path}/{k}")
        return
    diff = np.abs(got - want)
    assert np.isfinite(got).all() and diff.max() <= 2 * lr_sum, (path, diff.max())
    if path == "/blocks/attn/wk/b":
        return
    outliers = int((diff > 1e-5 * np.abs(want).max()).sum())
    assert outliers <= max(1, want.size // 1000), (path, outliers)


def _setup(arch, policy):
    jpol, pol = POLICIES[policy]
    jcfg, jm, jparams = reference(arch)
    cfg = get_arch(arch).reduced()
    jopt_cfg = jadamw.AdamWConfig(moment_fmt=jpol.optimizer)
    jopt = jax.jit(lambda p: jadamw.adamw_init(p, jopt_cfg))(jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    opt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), cfg, device="cpu")
    model = build_model(cfg, device="cpu")
    return (jm, jpol, jopt_cfg, jparams, jopt), (cfg, model, pol, params, opt)


@pytest.mark.parametrize("arch,policy", [("qwen2.5-14b", "p16-train"),
                                         ("phi3-mini-3.8b", "none")])
def test_three_steps_match_reference(arch, policy):
    (jm, jpol, jopt_cfg, jparams, jopt), (cfg, model, pol, params, opt) = _setup(arch, policy)
    jstep = jax.jit(jsteps.make_train_step(jm, jpol, jopt_cfg, warmup=1, total_steps=3))
    step = steps.make_train_step(model, pol, AdamWConfig(moment_fmt=pol.optimizer),
                                 warmup=1, total_steps=3)
    for i in range(3):
        b = batch(cfg.vocab, 2, 16, seed=20 + i)
        jparams, jopt, jmet = jstep(jparams, jopt, b, jnp.asarray(i))
        params, opt, met = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()}, i)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= 1e-6 * abs(float(jmet["loss"]))
        assert abs(float(met["gnorm"]) - float(jmet["gnorm"])) <= 1e-5 * float(jmet["gnorm"])
    assert int(opt["count"]) == 3
    lr_sum = 3e-4 * sum(float(cosine_warmup(i, warmup=1, total=3)) for i in range(3))
    assert_params_close(tree_to_jax(params), jax.tree.map(np.asarray, jparams), lr_sum)
    got, want = tree_to_jax(opt["mu"]), jax.tree.map(np.asarray, jopt["mu"])
    if pol.optimizer is None:
        assert_trees_close(got, want, 1e-4)
        return

    def codes_close(g, w):
        assert g.dtype == w.dtype == np.uint16
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 1

    for path, w in jax.tree_util.tree_flatten_with_path(want)[0]:
        g = got
        for k in path:
            g = g[k.key]
        if path[-1].key in ("m", "v"):
            codes_close(g, w)


def test_microbatches_match_one_batch():
    """``microbatches=2`` against one batch of the same rows, one step,
    p16-train; within the same bounds (a mean of two half-batch means sums
    in another order)."""
    runs = []
    for mb in (1, 2):
        _, (cfg, model, pol, params, opt) = _setup("phi3-mini-3.8b", "p16-train")
        step = steps.make_train_step(model, pol, AdamWConfig(moment_fmt=pol.optimizer),
                                     warmup=1, total_steps=3, microbatches=mb,
                                     telemetry=True)
        b = {k: torch.from_numpy(v) for k, v in batch(cfg.vocab, 4, 16, seed=31).items()}
        loss, metrics, grads = step.loss_and_grads(params, b)
        params, opt, met = step(params, opt, b, 1)
        runs.append((float(loss), tree_to_jax(grads), met, tree_to_jax(params)))
    (l1, g1, m1, p1), (l2, g2, m2, p2) = runs
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    assert_trees_close(g2, g1, 1e-5)
    assert_params_close(p2, p1, 3e-4 * float(cosine_warmup(1, warmup=1, total=3)))
    for m in (m1, m2):
        assert int(m["grad_nonfinite"]) == int(m["opt_nonfinite"]) == 0
        assert 0 < float(m["update_ratio"]) < 1e-2 and float(m["param_norm"]) > 0
