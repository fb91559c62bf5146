"""Parity of the port's whisper family against the reference on the CPU:
``whisper-medium``'s reduced config (2 encoder + 2 decoder layers, 24
frames, 4 heads over 2 K/V heads), the reference's init converted bit for
bit by ``convert.params_from_jax``, with every bias and norm parameter
redrawn non-zero so the bias epilogues and the LayerNorm affine are
exercised. Inputs come from a numpy seed.

Policies: ``none`` (f32 throughout), ``p8-serve`` (bf16 activations, p8
weights and K/V) and ``attn-p16-mlp-p8`` over p8-serve (p16 self / cross /
encoder attention and frame_proj, packed-p8 MLPs; the preset's
``*self*``, ``*cross*`` and ``*mlp*`` rules are written for this tree).

Bounds: under f32 only the summation order differs (1e-5 on the encoder's
states, 1e-4 on logits). Under bf16 compute a last-bit difference before an
activation's bf16 rounding can flip that rounding (2^-8 relative), and the
flip travels through the encoder's layers: its states are held within 0.02
(about one bf16 ulp at their largest magnitude, ~4), logits within 0.05.
The cross K/V codes: the store (the cross k/v linears and the encode) within
1 posit ulp in code space, the ROADMAP's contract, on the reference's
encoder states and, through the whole ``init_dec_cache``, on the port's
(measured: no code differs, at 2 parameter seeds x 8 frame seeds x both
posit presets). Against the reference's whole cache, whose encoder states
carry those bf16 flips, the contract is relaxed to 2 ulps on at most 10% of
the codes: every differing code is one the reference's own store gives
differently on the port's encoder states (measured: 0 to 7.0% of the codes,
largest distance 2, over the same 32 runs; ``python
tests/test_torch_whisper.py`` prints the readings).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.core import policy as jpolicy
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.layers import policy_weight_bytes as jax_weight_bytes
from repro.models.layers import quantize_params as jax_quantize
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, tree_to_jax
from repro_torch.core import pcsr, policy
from repro_torch.models import encdec, layers
from repro_torch.models.layers import policy_weight_bytes, quantize_params
from repro_torch.models.registry import build_model

ARCH = "whisper-medium"
POLICIES = {
    "none": (jpcsr.FP32_POLICY, pcsr.FP32_POLICY),
    "p8-serve": (jpcsr.P8_SERVE, pcsr.P8_SERVE),
    "attn-p16-mlp-p8": (jpolicy.get_precision_policy("attn-p16-mlp-p8", base=jpcsr.P8_SERVE),
                        policy.get_precision_policy("attn-p16-mlp-p8", base=pcsr.P8_SERVE)),
}
ENCODE_BOUND = {"none": 1e-5, "p8-serve": 0.02, "attn-p16-mlp-p8": 0.02}
LOGIT_BOUND = {"none": 1e-4, "p8-serve": 0.05, "attn-p16-mlp-p8": 0.05}
# (largest code distance, largest share of differing codes) of the whole
# init_dec_cache against the reference's
CACHE_CODES = (2, 0.10)
PROMPT, GREEDY, S_MAX = 8, 7, 16


def _redraw_affine(tree, seed=7):
    """Every bias and LayerNorm parameter redrawn: biases N(0, 0.1), gains
    1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        key = [p.key for p in path if hasattr(p, "key")][-1]
        if key not in ("b", "g"):
            return a
        base = 1.0 if key == "g" else 0.0
        return jnp.asarray((base + rng.normal(0, 0.1, a.shape)).astype(np.float32))

    return jax.tree_util.tree_map_with_path(redraw, tree)


def _reference(seed: int = 0):
    jcfg = jax_arch(ARCH).reduced()
    jm = jax_build(jcfg)
    jfloat = _redraw_affine(jax.jit(jm.init)(jax.random.key(seed)))
    return jcfg, jm, jfloat


@pytest.fixture(scope="module")
def reference():
    return _reference()


def _models(reference, name):
    jcfg, jm, jfloat = reference
    jpol, pol = POLICIES[name]
    jparams = jax_quantize(jfloat, jpol) if jpol.weights is not None else jfloat
    cfg = get_arch(ARCH).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jm, jparams, jpol, cfg, build_model(cfg, device="cpu"), params, pol


def _frames(cfg, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (2, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _code_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = 8 * a.itemsize
    d = (a.astype(np.int64) - b.astype(np.int64)) & ((1 << n) - 1)
    return np.minimum(d, (1 << n) - d)


def test_reduced_config_is_the_references():
    jcfg, cfg = jax_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in cfg.__dataclass_fields__})
    full = get_arch(ARCH)
    assert full == type(full)(**{f: getattr(jax_arch(ARCH), f) for f in full.__dataclass_fields__})
    # the reduced decoder is GQA, the full one MHA
    assert (cfg.n_heads, cfg.n_kv, cfg.enc_layers, cfg.enc_frames) == (4, 2, 2, 24)
    assert (full.n_heads, full.n_kv, full.hd, full.enc_frames) == (16, 16, 64, 1500)


@pytest.mark.parametrize("shape", [(3, 128), (2, 24, 1024)])
def test_layernorm_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(0, 3, shape) + 1.5).astype(np.float32)
    p = {"g": (1 + rng.normal(0, 0.1, shape[-1:])).astype(np.float32),
         "b": rng.normal(0, 0.1, shape[-1:]).astype(np.float32)}
    want = np.asarray(jlayers.apply_layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    got = layers.apply_layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)
    assert layers.init_layernorm(5)["g"].tolist() == [1.0] * 5


@pytest.mark.parametrize("n,d", [(24, 128), (448, 1024), (1500, 1024)])
def test_sinusoidal_positions_match_reference(n, d):
    """The same f32 products; sin and cos of arguments up to n - 1 agree to
    a few f32 ulps of the argument."""
    want = np.asarray(jlayers.sinusoidal_positions(n, d))
    got = layers.sinusoidal_positions(n, d).numpy()
    assert got.shape == want.shape == (n, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * n * 2.0 ** -24 + 1e-6)
    np.testing.assert_array_equal(got[0, 0::2], 0.0)
    np.testing.assert_array_equal(got[0, 1::2], 1.0)


@pytest.mark.parametrize("name", list(POLICIES))
def test_gelu_mlp_matches_reference(reference, name):
    """up (gelu after its bias, fused) and down (its bias and the residual
    fused) on the reference's first encoder MLP, quantized per the policy.
    f32: the summation order only; bf16 compute: the down projection's bf16
    rounding of the gelu output may flip (2^-8 of a value ~1, times a
    weight ~0.06)."""
    _, _, jparams, jpol, cfg, _, params, pol = _models(reference, name)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 24, cfg.d_model)).astype(np.float32)
    res = rng.normal(0, 1, x.shape).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["enc_blocks"])["mlp"]
    want = np.asarray(jlayers.apply_gelu_mlp(jp, jnp.asarray(x), jpol, residual=jnp.asarray(res),
                                             path="mlp"))
    got = layers.apply_gelu_mlp(params["enc_blocks"][0]["mlp"], torch.from_numpy(x), pol,
                                residual=torch.from_numpy(res), path="mlp").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 if name == "none" else 1e-3)


@pytest.mark.parametrize("name", list(POLICIES))
def test_encode_matches_reference(reference, name):
    jcfg, _, jparams, jpol, cfg, _, params, pol = _models(reference, name)
    frames = _frames(cfg)
    want = np.asarray(jax.jit(lambda p, f: jencdec.encode(p, f, jcfg, jpol, remat=False))(
        jparams, jnp.asarray(frames)))
    got = encdec.encode(params, torch.from_numpy(frames), cfg, pol).numpy()
    assert got.shape == want.shape == (2, cfg.enc_frames, cfg.d_model)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= ENCODE_BOUND[name], err


@pytest.mark.parametrize("name", ["p8-serve", "attn-p16-mlp-p8"])
def test_cross_cache_codes_match_reference(reference, name):
    """init_dec_cache's prefilled cross K/V as posit codes: the store on the
    reference's encoder states within 1 ulp, the whole cache within
    CACHE_CODES; ``len`` = T, the self caches empty."""
    jcfg, jm, jparams, jpol, cfg, model, params, pol = _models(reference, name)
    frames = _frames(cfg)
    jc = jax.jit(lambda p, f: jm.init_cache(p, {"frames": f}, jpol, S_MAX))(
        jparams, jnp.asarray(frames))
    tc = model.init_cache(params, {"frames": torch.from_numpy(frames)}, pol, S_MAX)
    most, share = CACHE_CODES
    for kv in ("k", "v"):
        want, got = np.asarray(jc["cross"][kv]), tc["cross"][kv].numpy()
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape == (cfg.n_layers, 2, cfg.n_kv, cfg.enc_frames, cfg.hd)
        d = _code_distance(got, want)
        assert d.max() <= most and (d > 0).mean() <= share, (kv, d.max(), (d > 0).mean())
    np.testing.assert_array_equal(tc["cross"]["len"].numpy(), np.asarray(jc["cross"]["len"]))
    assert (tc["cross"]["len"] == cfg.enc_frames).all()
    assert not tc["self"]["k"].any() and not tc["self"]["len"].any()
    assert tc["self"]["k"].shape[3] == S_MAX
    # the store alone: the port's cross k/v linears and encode kernel on the
    # reference's encoder states
    enc = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg, jpol, remat=False))(
        jparams, jnp.asarray(frames))
    enc_t = torch.from_numpy(np.array(enc))
    for i, p in enumerate(params["dec_blocks"]):
        for kv in ("k", "v"):
            y = layers.apply_linear(p["cross"]["w" + kv], enc_t, pol, path=f"cross/w{kv}")
            cache = torch.zeros_like(tc["cross"][kv][i])
            encdec.attn._store(cache, y.reshape(2, cfg.enc_frames, cfg.n_kv, cfg.hd)
                               .transpose(1, 2), 0, pol)
            want_i = np.asarray(jlayers.apply_linear(
                jax.tree.map(lambda a: a[i], jparams["dec_blocks"])["cross"]["w" + kv], enc, jpol,
                path=f"cross/w{kv}"))
            want_codes = np.asarray(jencdec.attn._store(
                jnp.zeros(cache.shape, jnp.uint8),
                jnp.asarray(want_i).reshape(2, cfg.enc_frames, cfg.n_kv, cfg.hd)
                .transpose(0, 2, 1, 3), 0, jpol))
            assert _code_distance(cache.numpy(), want_codes).max() <= 1, (i, kv)


@pytest.mark.parametrize("seed", [1, 4, 8])
@pytest.mark.parametrize("name", ["p8-serve", "attn-p16-mlp-p8"])
def test_cross_cache_differences_come_from_the_encoder(reference, name, seed):
    """The whole init_dec_cache within 1 ulp of the reference's store run on
    the port's own encoder states; against the reference's cache within
    CACHE_CODES, every difference one that the encoder states explain."""
    r = cross_cache_readings(reference, name, seed)
    most, share = CACHE_CODES
    assert r["store"]["max_codes"] <= 1, r
    assert r["whole"]["max_codes"] <= most and r["whole"]["share"] <= share, r
    assert r["whole"]["share"] <= r["encoder"]["share"] + r["store"]["share"], r


@pytest.mark.parametrize("name", list(POLICIES))
def test_teacher_forced_decode_matches_reference(reference, name):
    """An 8-token prompt teacher-forced through decode_step, then 7 greedy
    steps, on both packages from their own init_dec_cache: logits within the
    bound at every step, the same greedy token at every greedy step, and
    the positions and lengths the reference's."""
    jcfg, jm, jparams, jpol, cfg, model, params, pol = _models(reference, name)
    frames = _frames(cfg)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    jc = jax.jit(lambda p, f: jm.init_cache(p, {"frames": f}, jpol, S_MAX))(
        jparams, jnp.asarray(frames))
    tc = model.init_cache(params, {"frames": torch.from_numpy(frames)}, pol, S_MAX)
    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, jpol))
    worst, tok = 0.0, None
    for step in range(PROMPT + GREEDY):
        t = prompt[:, step] if step < PROMPT else tok
        jl, jc = jdec(jparams, jnp.asarray(t), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(t), tc, pol)
        ref, got = np.asarray(jl), tl.numpy()
        assert got.shape == ref.shape == (2, cfg.vocab) and np.isfinite(got).all()
        worst = max(worst, float(np.abs(got - ref).max()))
        if step >= PROMPT - 1:
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))  # equal greedy streams
        tok = ref.argmax(-1).astype(np.int32)
    assert worst <= LOGIT_BOUND[name], worst
    np.testing.assert_array_equal(tc["lens"].numpy(), np.asarray(jc["lens"]))
    assert int(tc["pos"]) == int(jc["pos"]) == PROMPT + GREEDY
    np.testing.assert_array_equal(tc["self"]["len"].numpy(), np.asarray(jc["self"]["len"]))
    np.testing.assert_array_equal(tc["cross"]["len"].numpy(), np.asarray(jc["cross"]["len"]))


@pytest.mark.parametrize("name", ["none", "p8-serve"])
def test_ragged_rows_match_reference(reference, name):
    """Rows at different depths (``lens`` 0 and 3, as a continuous batch
    would hold them): each row's learned position and self K/V write follow
    its own ``lens``, as in the reference, over three steps."""
    jcfg, jm, jparams, jpol, cfg, model, params, pol = _models(reference, name)
    frames = _frames(cfg)
    jc = jax.jit(lambda p, f: jm.init_cache(p, {"frames": f}, jpol, S_MAX))(
        jparams, jnp.asarray(frames))
    tc = model.init_cache(params, {"frames": torch.from_numpy(frames)}, pol, S_MAX)
    lens = np.array([0, 3], np.int32)
    jc = dict(jc, lens=jnp.asarray(lens))
    tc["lens"].copy_(torch.from_numpy(lens))
    jdec = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, jpol))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (3, 2)).astype(np.int32)
    worst = 0.0
    for t in toks:
        jl, jc = jdec(jparams, jnp.asarray(t), jc)
        tl, tc = model.decode_step(params, torch.from_numpy(t), tc, pol)
        worst = max(worst, float(np.abs(tl.numpy() - np.asarray(jl)).max()))
    assert worst <= LOGIT_BOUND[name], worst
    np.testing.assert_array_equal(tc["lens"].numpy(), lens + 3)
    for kv in ("k", "v"):
        got, want = tc["self"][kv].numpy(), np.asarray(jc["self"][kv])
        written = np.abs(got.astype(np.float32)).sum(axis=(0, 2, 4)) > 0   # (B, S)
        assert written[0].nonzero()[0].tolist() == [0, 1, 2]
        assert written[1].nonzero()[0].tolist() == [3, 4, 5]
        if name == "p8-serve":
            assert _code_distance(got, want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(POLICIES))
def test_params_round_trip_bit_for_bit(reference, name):
    """params_from_jax then tree_to_jax gives the reference's tree back, leaf
    for leaf and bit for bit: the stacked encoder and decoder blocks, packed
    lanes and codes, and the float leaves carried as they are."""
    _, _, jparams, _, cfg, _, params, _ = _models(reference, name)
    assert len(params["enc_blocks"]) == cfg.enc_layers
    assert len(params["dec_blocks"]) == cfg.n_layers
    for key in ("frame_proj", "enc_ln", "embed", "dec_ln"):
        assert isinstance(params[key], dict)
    assert params["pos_embed"].shape == (encdec.MAX_TGT, cfg.d_model)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jparams))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(tree_to_jax(params))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and got[path].shape == leaf.shape, path
        np.testing.assert_array_equal(got[path], leaf, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["p8-serve", "attn-p16-mlp-p8"])
def test_quantize_params_walks_the_whisper_tree(reference, name):
    """quantize_params on the converted floats gives the reference's codes and
    packed lanes for frame_proj and every self / cross / encoder / MLP
    linear; embed and pos_embed stay float; policy_weight_bytes is the
    reference's."""
    _, _, jfloat = reference
    jpol, pol = POLICIES[name]
    cfg = get_arch(ARCH).reduced()
    floats = params_from_jax(jax.tree.map(np.asarray, jfloat), cfg, device="cpu")
    got = tree_to_jax(quantize_params(floats, pol))
    want = jax.tree.map(np.asarray, jax_quantize(jfloat, jpol))
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_array_equal(got_leaves[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))
    assert "w" not in got["frame_proj"] and "table" in got["embed"]
    assert got["pos_embed"].dtype == np.float32
    packed = "w_packed" in got["dec_blocks"]["mlp"]["up"]
    assert packed == (name == "attn-p16-mlp-p8")
    assert policy_weight_bytes(floats, pol) == jax_weight_bytes(jfloat, jpol)


def test_model_surface_and_init():
    """The whisper Model: no prefill and no paged entry points, training
    refused naming its queue item; ``init`` draws the reference's tree,
    quantized per layer as drawn (embed and pos_embed float)."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    assert model.prefill is None and model.init_paged_cache is None
    assert model.decode_step_paged is None
    for fn in (model.loss, model.forward):
        with pytest.raises(NotImplementedError, match="item 5b"):
            fn({}, {}, pcsr.P8_SERVE)
    mixed = POLICIES["attn-p16-mlp-p8"][1]
    params = model.init(0, mixed)
    assert set(params) == {"frame_proj", "enc_blocks", "enc_ln", "embed", "pos_embed",
                           "dec_blocks", "dec_ln"}
    assert params["frame_proj"]["w_codes"].dtype == torch.uint16
    assert params["enc_blocks"][1]["attn"]["wq"]["w_codes"].dtype == torch.uint16
    assert "b" not in params["dec_blocks"][0]["cross"]["wo"]
    assert params["dec_blocks"][0]["mlp"]["down"]["w_packed"].shape == (cfg.d_ff // 2,
                                                                          cfg.d_model)
    assert params["embed"]["table"].dtype == params["pos_embed"].dtype == torch.float32
    floats = model.init(0)
    assert policy_weight_bytes(params, mixed) == policy_weight_bytes(floats, mixed)


def _buffer_ids(cache: dict) -> dict:
    return {(c, k): id(v) for c, sub in cache.items()
            for k, v in (sub.items() if isinstance(sub, dict) else [("", sub)])}


def test_decode_step_keeps_its_buffers():
    """decode_step updates the cache in place (the CUDA graph replays over
    the same tensors): the self K/V rows at ``lens``, ``lens``, ``pos`` and
    the self ``len`` advance, the cross cache and its ``len`` do not move;
    rows at different depths take their own positions."""
    cfg = get_arch(ARCH).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, pcsr.P8_SERVE)
    cache = model.init_cache(params, {"frames": _frames(cfg)}, pcsr.P8_SERVE, S_MAX)
    ids = _buffer_ids(cache)
    cross_k = cache["cross"]["k"].clone()
    cache["lens"].copy_(torch.tensor([0, 3], dtype=torch.int32))
    _, out = model.decode_step(params, torch.tensor([5, 9], dtype=torch.int32), cache,
                               pcsr.P8_SERVE)
    assert out is cache and _buffer_ids(out) == ids
    assert cache["lens"].tolist() == [1, 4] and int(cache["pos"]) == 1
    assert torch.equal(cache["cross"]["k"], cross_k)
    assert (cache["cross"]["len"] == cfg.enc_frames).all()
    assert (cache["self"]["len"] == 1).all()
    written = cache["self"]["k"].any(dim=(0, 2, 4))   # (B, S) rows written
    assert written[0].nonzero().flatten().tolist() == [0]
    assert written[1].nonzero().flatten().tolist() == [3]




def cross_cache_readings(reference, name, seed: int) -> dict:
    """Where the whole cross cache's code differences come from, on the
    frames of ``seed``: the port's ``init_dec_cache`` against the
    reference's (``whole``), against the reference's own store run on the
    port's encoder output (``store``: the same encoder states, so only the
    cross k/v linears and the encode differ), and that store against the
    reference's cache (``encoder``: the same store, the two encoders'
    states). Each: the largest code distance and the share of codes that
    differ."""
    jcfg, jm, jparams, jpol, cfg, model, params, pol = _models(reference, name)
    frames = _frames(cfg, seed)
    jc = jax.jit(lambda p, f: jm.init_cache(p, {"frames": f}, jpol, S_MAX))(
        jparams, jnp.asarray(frames))
    tc = model.init_cache(params, {"frames": torch.from_numpy(frames)}, pol, S_MAX)
    enc = jnp.asarray(encdec.encode(params, torch.from_numpy(frames), cfg, pol).numpy())
    out = {}
    for kv in ("k", "v"):
        ref_store = np.stack([np.asarray(jencdec.attn._store(
            jnp.zeros(jc["cross"][kv].shape[1:], jnp.uint8),
            jlayers.apply_linear(jax.tree.map(lambda a: a[i], jparams["dec_blocks"])
                                 ["cross"]["w" + kv], enc, jpol, path=f"cross/w{kv}")
            .reshape(2, cfg.enc_frames, cfg.n_kv, cfg.hd).transpose(0, 2, 1, 3), 0, jpol))
            for i in range(cfg.n_layers)])
        got, want = tc["cross"][kv].numpy(), np.asarray(jc["cross"][kv])
        for what, a, b in (("whole", got, want), ("store", got, ref_store),
                           ("encoder", ref_store, want)):
            d = _code_distance(a, b)
            prev = out.get(what, (0, 0.0, 0))
            out[what] = (max(prev[0], int(d.max())), prev[1] + float((d > 0).sum()),
                         prev[2] + d.size)
    return {k: {"max_codes": m, "share": n / size} for k, (m, n, size) in out.items()}


if __name__ == "__main__":
    # the readings behind CACHE_CODES: PYTHONPATH=src python tests/test_torch_whisper.py
    import json

    for param_seed in (0, 1):
        ref = _reference(param_seed)
        for name in ("p8-serve", "attn-p16-mlp-p8"):
            for seed in range(1, 9):
                print(json.dumps({"params": param_seed, "policy": name, "frames": seed,
                                  **cross_cache_readings(ref, name, seed)}), flush=True)
