"""``forward`` and ``lm_loss`` of the port against the reference's, with
their gradients, on reduced dense configs (CPU, the kernels' plain
versions).

Parameters come from the reference's init (qwen2.5-14b's q/k/v biases made
non-zero), converted by ``convert.params_from_jax``; tokens and labels from
numpy. The reference's ``jax.value_and_grad`` of its loss is the oracle.
Contract, per (arch, policy): hidden states within 1e-5 of their largest
magnitude; the loss within 1e-6 relative; every gradient leaf (in the
reference's stacked layout, ``convert.tree_to_jax``) within 1e-4 of its
largest magnitude. Under a posit weight policy both packages quantize every
float weight bit for bit the same (the straight-through estimator's
forward), so only f32 summation order differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.models import transformer as jtransformer
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import pcsr
from repro_torch.core.tree import tree_leaves, tree_unflatten
from repro_torch.models import transformer
from repro_torch.models.registry import build_model

POLICIES = {
    "none": (jpcsr.FP32_POLICY, pcsr.FP32_POLICY),
    "p16-weights": (jpcsr.P16_WEIGHTS, pcsr.P16_WEIGHTS),
    "p16-train": (jpcsr.P16_TRAIN, pcsr.P16_TRAIN),
}
ARCHS = ("qwen2.5-14b", "phi3-mini-3.8b", "yi-34b")


def reference(arch: str, seed: int = 0):
    cfg = jax_arch(arch).reduced()
    model = jax_build(cfg)
    params = jax.jit(model.init)(jax.random.key(seed))
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 1)
        for w in ("wq", "wk", "wv"):
            b = params["blocks"]["attn"][w]["b"]
            params["blocks"]["attn"][w]["b"] = jnp.asarray(
                rng.normal(0, 0.1, b.shape).astype(np.float32))
    return cfg, model, params


def batch(vocab: int, B: int, S: int, seed: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def port_loss_and_grads(params, b, cfg, pol):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    loss, metrics = transformer.lm_loss(params, tb, cfg, pol)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_to_jax(tree_unflatten(params, list(grads)))


def assert_trees_close(got, want, rel: float, path: str = ""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_trees_close(got[k], want[k], rel, f"{path}/{k}")
        return
    want = np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all(), path
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()),
                               err_msg=path)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch, policy):
    jpol, pol = POLICIES[policy]
    jcfg, jm, jparams = reference(arch)
    cfg = get_arch(arch).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    b = batch(cfg.vocab, 2, 16)

    jh = jax.jit(lambda p: jm.forward(p, b, jpol))(jparams)
    with torch.no_grad():
        h = build_model(cfg, device="cpu").forward(
            params, {k: torch.from_numpy(v) for k, v in b.items()}, pol)
    assert h.shape == (2, 16, cfg.d_model)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jh)).max()))

    (jl, jmet), jg = jax.jit(jax.value_and_grad(lambda p: jm.loss(p, b, jpol), has_aux=True))(
        jparams)
    loss, metrics, grads = port_loss_and_grads(params, b, cfg, pol)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    ce, aux = (float(metrics[k].detach()) for k in ("ce", "aux"))
    assert abs(ce - float(jmet["ce"])) <= 1e-6 * abs(float(jmet["ce"]))
    assert aux == float(jmet["aux"]) == 0.0
    assert_trees_close(grads, jax.tree.map(np.asarray, jg), 1e-4)


def test_chunked_loss_matches_reference(monkeypatch):
    """The sequence-chunked cross-entropy with several chunks and a dropped
    remainder (LOSS_CHUNK 8 in both packages, S 20: two chunks of 10), under
    p16-train."""
    monkeypatch.setattr(jtransformer, "LOSS_CHUNK", 8)
    monkeypatch.setattr(transformer, "LOSS_CHUNK", 8)
    jcfg, jm, jparams = reference("phi3-mini-3.8b")
    cfg = get_arch("phi3-mini-3.8b").reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    b = batch(cfg.vocab, 2, 20, seed=9)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, b, jpcsr.P16_TRAIN), has_aux=True))(jparams)
    loss, _, grads = port_loss_and_grads(params, b, cfg, pcsr.P16_TRAIN)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    assert_trees_close(grads, jax.tree.map(np.asarray, jg), 1e-4)


def test_remat_does_not_change_the_gradients():
    """Per-layer checkpointing recomputes the same values: the gradients with
    and without it are bit for bit equal."""
    cfg = get_arch("phi3-mini-3.8b").reduced()
    params = build_model(cfg, device="cpu").init(3)
    tokens = torch.from_numpy(batch(cfg.vocab, 2, 12)["tokens"])
    leaves = tree_leaves({k: v for k, v in params.items() if k != "lm_head"})
    for p in leaves:
        p.requires_grad_(True)
    out = []
    for remat in (True, False):
        h, _ = transformer.forward(params, tokens, cfg, pcsr.P16_TRAIN, remat=remat)
        out.append(torch.autograd.grad((h * h).sum(), leaves))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_other_families_raise():
    """``forward`` takes the decoder-only families (dense and moe: the moe
    family's forward is tests/test_torch_moe_loss.py's); any other raises."""
    with pytest.raises(NotImplementedError):
        transformer.forward({}, torch.zeros((1, 4), dtype=torch.int32),
                            get_arch("phi3-mini-3.8b").reduced().__class__(
                                name="x", family="whisper", n_layers=1, d_model=8, n_heads=1,
                                n_kv=1, d_ff=8, vocab=8),
                            pcsr.FP32_POLICY)
