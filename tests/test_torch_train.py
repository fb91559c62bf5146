"""The training path's pieces against the reference, on the CPU.

The same numpy inputs, made from a seed, go through the reference (JAX) and
the port (the kernels' plain versions on CPU tensors). Tolerances, each
stated where it is used:
* the straight-through estimator: its gradient is exactly the identity;
* the float linear's gradients (``FloatLinear``) against ``jax.grad`` of the
  reference's float linear: f32 products in another summation order, so
  within 1e-5 of each gradient's largest magnitude;
* one AdamW step: float moments and parameters within 4 f32 ulps of their
  magnitude (1 ulp of ``b ** count`` and of sqrt/div between the two
  libraries, carried through the update); posit moment codes within 1 code
  and the value each stores (decoded code plus its error-feedback residual)
  within 4 f32 ulps of the moment;
* ``clip_by_global_norm``: the norm within 1e-6 relative (f32 sums over
  leaves in another order), the scaled gradients within 2 ulps;
* ``cosine_warmup``: within 2 f32 ulps of 1.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pcsr as jpcsr
from repro.core.codec import posit_decode as jax_decode
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro.launch import steps as jsteps
from repro_torch.configs import get_arch
from repro_torch.convert import opt_state_from_jax, params_from_jax, tree_to_jax
from repro_torch.core import pcsr
from repro_torch.core.types import P8_0, P16_1
from repro_torch.data.pipeline import SyntheticLMPipeline
from repro_torch.kernels.posit_codec import ref as codec_ref
from repro_torch.launch import steps, train
from repro_torch.models.layers import apply_linear, effective_weight
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from repro_torch.optim import cosine_warmup

ROOT = Path(__file__).resolve().parents[1]
F32_EPS = 2.0 ** -23


def test_ste_gradient_is_the_identity():
    """The fault this slice repairs: the straight-through estimator must pass
    the gradient through unchanged (the reference's ``w + stop_gradient(q(w)
    - w)``), not cancel it."""
    w = torch.randn(24, 40, generator=torch.Generator().manual_seed(0), requires_grad=True)
    dy = torch.randn(24, 40, generator=torch.Generator().manual_seed(1))
    for pol in (pcsr.P16_WEIGHTS, pcsr.P16_TRAIN, pcsr.parse_policy("weights=p8_0")):
        w.grad = None
        q = effective_weight({"w": w}, pol)
        (q * dy).sum().backward()
        assert torch.equal(w.grad, dy), pol.describe()
        # the forward is the quantized weight, bit for bit the codec's round trip
        fmt = pol.weights
        want = codec_ref.decode_ref(codec_ref.encode_ref(w.detach(), fmt.es, nbits=fmt.nbits),
                                    fmt.es, nbits=fmt.nbits)
        assert torch.equal(q.detach(), want)


@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("activation", ["none", "silu", "gelu", "relu"])
def test_float_linear_gradients_match_reference(activation, chained):
    """dx, dw, db and dresidual of the port's float linear (the kernel's
    forward, plain products backward) against ``jax.grad`` of the reference's
    float linear, f32 compute; within 1e-5 of each gradient's max."""
    rng = np.random.default_rng(3)
    M, K, N = 24, 48, 40
    x, w = rng.normal(size=(M, K)).astype(np.float32), rng.normal(size=(K, N)).astype(np.float32)
    b, r = rng.normal(size=(N,)).astype(np.float32), rng.normal(size=(M, N)).astype(np.float32)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    jpol = jpcsr.TransPolicy(epilogue="chained" if chained else "fused")
    pol = pcsr.TransPolicy(epilogue="chained" if chained else "fused")

    def jf(x, w, b, r):
        y = jlayers.apply_linear({"w": w, "b": b}, x, jpol, activation=activation, residual=r)
        return jnp.sum(y * dy)

    want = jax.grad(jf, argnums=(0, 1, 2, 3))(x, w, b, r)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in (x, w, b, r)]
    y = apply_linear({"w": ts[1], "b": ts[2]}, ts[0], pol, activation=activation,
                     residual=ts[3])
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(jlayers.apply_linear(
            {"w": w, "b": b}, x, jpol, activation=activation, residual=r)),
        rtol=0, atol=1e-5 * float(np.abs(y.detach().numpy()).max()))
    (y * torch.from_numpy(dy)).sum().backward()
    for name, t, g in zip(("dx", "dw", "db", "dresidual"), ts, want):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-5 * float(np.abs(g).max()), err_msg=name)


def _small_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(6, 10)).astype(np.float32)},
            "b": rng.normal(size=(7,)).astype(np.float32) * 0.1}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _ulps(x):
    return np.maximum(np.abs(x), np.finfo(np.float32).tiny) * F32_EPS


@pytest.mark.parametrize("moments", ["f32", "p16", "p16-no-ef", "p8"])
def test_adamw_update_matches_reference(moments):
    """One AdamW step from a non-zero state (the reference's state after one
    step, its numpy leaves as tensors), both packages on the same
    gradients."""
    fmt = {"f32": None, "p16": P16_1, "p16-no-ef": P16_1, "p8": P8_0}[moments]
    ef = moments != "p16-no-ef"
    jcfg = jadamw.AdamWConfig(lr=1e-2, moment_fmt=None if fmt is None else
                              jpcsr.TransPolicy.from_names(weights=fmt.name).weights,
                              error_feedback=ef)
    cfg = AdamWConfig(lr=1e-2, moment_fmt=fmt, error_feedback=ef)
    params, g0, g1 = _small_tree(0), _small_tree(1), _small_tree(2)
    jstate = jadamw.adamw_init(params, jcfg)
    jp1, jstate = jadamw.adamw_update(g0, jstate, params, jcfg, lr_scale=jnp.float32(0.5))
    jp2, jstate2 = jadamw.adamw_update(g1, jstate, jp1, jcfg, lr_scale=jnp.float32(0.7))

    p = _to_torch(jax.tree.map(np.asarray, jp1))
    st = {"mu": _to_torch(jax.tree.map(np.asarray, jstate["mu"])),
          "count": torch.tensor(int(jstate["count"]), dtype=torch.int32)}
    p2, st2 = adamw_update(_to_torch(g1), st, p, cfg, lr_scale=torch.tensor(0.7))
    assert p2 is p and st2 is st and int(st["count"]) == 2
    for path in (("a", "w"), ("b",)):
        got_p, want_p = p2, jp2
        got_s, want_s = st["mu"], jstate2["mu"]
        for k in path:
            got_p, want_p, got_s, want_s = got_p[k], want_p[k], got_s[k], want_s[k]
        want_p = np.asarray(want_p)
        np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=4 * _ulps(want_p).max())
        if fmt is None:
            for m in ("m", "v"):
                w = np.asarray(want_s[m])
                np.testing.assert_allclose(got_s[m].numpy(), w, rtol=0,
                                           atol=4 * _ulps(w).max())
            continue
        for m in ("m", "v"):
            gc = got_s[m].numpy().astype(np.int64)
            wc = np.asarray(want_s[m]).astype(np.int64)
            assert np.abs(gc - wc).max() <= 1, (m, path)
            if not ef:
                assert set(got_s) == {"m", "v"}
                continue
            # the moment each side stores: decode(code) + residual
            got_val = codec_ref.decode_ref(got_s[m], fmt.es, nbits=fmt.nbits).numpy() \
                + got_s["e" + m].numpy()
            want_val = np.asarray(jax_decode(want_s[m], fmt.nbits, fmt.es)) \
                + np.asarray(want_s["e" + m])
            np.testing.assert_allclose(got_val, want_val, rtol=0,
                                       atol=4 * _ulps(want_val).max())


def test_adamw_init_layout():
    params = _to_torch(_small_tree(0))
    st = adamw_init(params, AdamWConfig(moment_fmt=P16_1))
    assert st["mu"]["a"]["w"]["m"].dtype == torch.uint16
    assert set(st["mu"]["b"]) == {"m", "v", "em", "ev"} and int(st["count"]) == 0
    st = adamw_init(params, AdamWConfig(moment_fmt=P8_0, error_feedback=False))
    assert set(st["mu"]["b"]) == {"m", "v"} and st["mu"]["b"]["m"].dtype == torch.uint8
    assert set(adamw_init(params, AdamWConfig())["mu"]["b"]) == {"m", "v"}


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _small_tree(5)
    want, want_n = jadamw.clip_by_global_norm(grads, max_norm)
    got, got_n = clip_by_global_norm(_to_torch(grads), max_norm)
    assert abs(float(got_n) - float(want_n)) <= 1e-6 * float(want_n)
    for k in ("a", "b"):
        g, w = got[k], want[k]
        if k == "a":
            g, w = g["w"], w["w"]
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2 * _ulps(w).max())


def test_clip_refuses_shared_storage():
    g = torch.ones(4)
    with pytest.raises(ValueError, match="share storage"):
        clip_by_global_norm({"a": g, "b": g}, 1.0)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 99, 100, 150])
def test_cosine_warmup_matches_reference(step):
    want = float(jschedule.cosine_warmup(jnp.asarray(step), warmup=10, total=100))
    got = cosine_warmup(torch.tensor(step), warmup=10, total=100)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 2 * F32_EPS
    assert abs(float(cosine_warmup(step, warmup=10, total=100)) - want) <= 2 * F32_EPS


@pytest.mark.parametrize("dtype,nar", [(torch.uint16, 0x8000), (torch.uint8, 0x80)])
def test_nonfinite_count_reads_nar_codes(dtype, nar):
    codes = torch.tensor([0, 1, nar, nar, 3], dtype=torch.int32).to(dtype)
    tree = {"m": codes, "f": torch.tensor([1.0, float("nan"), float("inf"), 2.0])}
    assert int(steps._nonfinite_count(tree)) == 4
    ref_tree = {"m": np.asarray(codes.to(torch.int32).numpy(),
                                {torch.uint16: np.uint16, torch.uint8: np.uint8}[dtype]),
                "f": np.array([1.0, np.nan, np.inf, 2.0], np.float32)}
    assert int(jsteps._nonfinite_count(ref_tree)) == 4


def test_pipeline_is_deterministic_and_structured():
    pipe = SyntheticLMPipeline(vocab=64, seq_len=48, global_batch=4, seed=3, device="cpu")
    a, b = pipe.batch_at(7), pipe.batch_at(7)
    assert torch.equal(a["tokens"], b["tokens"]) and a["tokens"].dtype == torch.int32
    assert a["tokens"].shape == (4, 48) and not torch.equal(a["tokens"],
                                                            pipe.batch_at(8)["tokens"])
    assert torch.equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert torch.equal(a["labels"][:, -1], a["tokens"][:, 0])
    t = a["tokens"].to(torch.int64)
    follows = ((t[:, :-1] + pipe._shift) % 64 == t[:, 1:]).float().mean()
    assert 0.35 < float(follows) < 0.75       # ~half the positions follow the chain


def test_posit_pod_sync_is_not_ported():
    model = build_model(get_arch("phi3-mini-3.8b").reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
        steps.make_train_step(model, pcsr.P16_TRAIN, AdamWConfig(), grad_sync="posit_pod")
    with pytest.raises(ValueError):
        steps.make_train_step(model, pcsr.P16_TRAIN, AdamWConfig(), grad_sync="other")


def test_train_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "phi3-mini-3.8b",
         "--reduced", "--steps", "3", "--device", "cpu", "--batch", "2", "--seq", "16",
         "--log-every", "2", "--policy", "p16-train"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    assert [m["kind"] for m in lines] == ["train/step", "train/step", "train/done"]
    assert [m["step"] for m in lines[:2]] == [0, 2] and lines[2]["done"] == 3
    for m in lines[:2]:
        assert {"loss", "gnorm", "ce", "aux"} <= set(m) and np.isfinite(m["loss"])


@pytest.mark.parametrize("flag", sorted(train.NOT_PORTED))
def test_train_refuses_flags_not_ported(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "phi3-mini-3.8b", "--reduced", "--device", "cpu", flag, "x"])
    assert exc.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def test_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "phi3-mini-3.8b", "--reduced", "--steps", "1"])


def test_opt_state_and_tree_round_trip():
    """``opt_state_from_jax`` and ``tree_to_jax`` are inverse on the
    reference's AdamW state of a reduced model, codes bit for bit."""
    from repro.configs import get_arch as jax_arch
    from repro.models.registry import build_model as jax_build

    jcfg = jax_arch("qwen2.5-14b").reduced()
    jparams = jax.tree.map(np.asarray, jax.jit(jax_build(jcfg).init)(jax.random.key(0)))
    cfg = get_arch("qwen2.5-14b").reduced()
    jcfg_opt = jadamw.AdamWConfig(moment_fmt=jpcsr.P16_TRAIN.optimizer)
    jst = jax.tree.map(np.asarray, jax.jit(lambda p: jadamw.adamw_init(p, jcfg_opt))(jparams))
    st = opt_state_from_jax(jst, cfg, device="cpu")
    assert st["mu"]["blocks"][1]["attn"]["wq"]["w"]["m"].dtype == torch.uint16
    back = tree_to_jax(st["mu"])
    jax.tree.map(np.testing.assert_array_equal, back, jst["mu"])
    params = params_from_jax(jparams, cfg, device="cpu")
    jax.tree.map(np.testing.assert_array_equal, tree_to_jax(params), jparams)
    params["blocks"][0]["ln1"]["g"].add_(1.0)            # the port's copy, not the reference's
    assert not np.array_equal(jparams["blocks"]["ln1"]["g"][0],
                              params["blocks"][0]["ln1"]["g"].numpy())
