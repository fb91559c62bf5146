"""Port per-layer precision policies: ``repro_torch.core.policy`` against
``repro.core.policy``.

Contract: every preset and rule spec resolves every layer path of the
reduced qwen2.5-14b to the same ``TransPolicy`` (compared through
``to_json``) in both spellings: the param-tree path at quantize time
(the reference's ``blocks/attn/wq``, the port's ``blocks/3/attn/wq``) and
the call-site path (``attn/wq``). Artifacts written by either package load
in the other and resolve alike; malformed rules raise the reference's
exception type.
"""
import json

import jax
import pytest

from repro.configs import get_arch as jax_arch
from repro.core import pcsr as jpcsr
from repro.core import policy as jpolicy
from repro.models import layers as jlayers
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_arch
from repro_torch.core import pcsr, policy
from repro_torch.models import layers
from repro_torch.models.registry import build_model

SPECS = [
    "*attn*=p16@2,*mlp*=p8@1:packed,*=p16_1",
    "mlp/gate=p8_0:packed,attn/wq=p16_3,*=p8_2",
    "*attn/w[qk]=float,lm_head=p8_3:packed,*=p8_0",
    "attn/wo=p16_0,*mlp*=p16_1@3",
    "lm_head*=float,*=p8@0:packed",
]
CALL_SITES = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/gate", "mlp/up", "mlp/down",
              "lm_head")


def _tree_paths():
    """(reference param-tree path, the port's spelling of the same linear)
    for every linear of the reduced qwen2.5-14b."""
    cfg = jax_arch("qwen2.5-14b").reduced()
    shapes = jax.eval_shape(jax_build(cfg).init, jax.random.key(0))
    ref = sorted(p for p, _, _ in jlayers._walk_linears(shapes, ""))
    port_params = build_model(get_arch("qwen2.5-14b").reduced(), device="cpu").init(0)
    port = sorted(p for p, _, _ in layers._walk_linears(port_params))
    assert len(port) == cfg.n_layers * 7 + 1 and len(ref) == 8
    return ref, port


REF_PATHS, PORT_PATHS = _tree_paths()


def _policies(name_or_spec):
    """(reference, port) precision policies over no base and over P8_SERVE."""
    yield jpolicy.get_precision_policy(name_or_spec), policy.get_precision_policy(name_or_spec)
    yield (jpolicy.get_precision_policy(name_or_spec, base=jpcsr.P8_SERVE),
           policy.get_precision_policy(name_or_spec, base=pcsr.P8_SERVE))


def _assert_same_resolution(jpol, pol):
    assert pol.describe() == jpol.describe()
    for path in REF_PATHS:
        want = jlayers.resolve_policy(jpol, path).to_json()
        assert layers.resolve_policy(pol, path).to_json() == want, path
    for path in PORT_PATHS:
        want = jlayers.resolve_policy(jpol, layers.layer_path(path)).to_json()
        assert layers.resolve_policy(pol, path).to_json() == want, path
    for path in CALL_SITES:
        got = layers.resolve_policy(pol, path).to_json()
        assert got == jlayers.resolve_policy(jpol, path).to_json(), path
        # quantize time and call time agree
        tree = "blocks/" + path if path != "lm_head" else path
        assert got == layers.resolve_policy(pol, tree).to_json(), path


@pytest.mark.parametrize("name", sorted(jpolicy.PRECISION_PRESETS))
def test_presets_resolve_like_the_reference(name):
    assert sorted(policy.PRECISION_PRESETS) == sorted(jpolicy.PRECISION_PRESETS)
    assert policy.PRECISION_PRESETS[name].to_json() == jpolicy.PRECISION_PRESETS[name].to_json()
    for jpol, pol in _policies(name):
        _assert_same_resolution(jpol, pol)


@pytest.mark.parametrize("spec", SPECS)
def test_specs_resolve_like_the_reference(spec):
    for jpol, pol in _policies(spec):
        assert pol.to_json() == jpol.to_json()
        _assert_same_resolution(jpol, pol)


@pytest.mark.parametrize("name", ["attn-p16-mlp-p8", SPECS[0], SPECS[2]])
def test_artifacts_load_across_packages(name, tmp_path):
    """A reference ``to_json()`` artifact (with a calibration ``meta`` block)
    loads in the port through ``@file`` and resolves alike, over a base and
    without; the port's artifact loads in the reference."""
    jpol = jpolicy.get_precision_policy(name, base=jpcsr.P8_SERVE)
    doc = dict(jpol.to_json(), meta={"calibrated_on": "reduced"})
    path = tmp_path / "cal.json"
    path.write_text(json.dumps(doc))
    pol = policy.get_precision_policy(f"@{path}")
    assert pol.to_json() == jpol.to_json()
    _assert_same_resolution(jpol, pol)
    _assert_same_resolution(jpolicy.get_precision_policy(f"@{path}", base=jpcsr.FP32_POLICY),
                            policy.get_precision_policy(f"@{path}", base=pcsr.FP32_POLICY))
    back = jpolicy.PrecisionPolicy.from_json(json.loads(json.dumps(pol.to_json())))
    assert back == jpol


def test_precision_policy_duck_types_trans_policy():
    pol = policy.get_precision_policy("attn-p16-mlp-p8", base=pcsr.P8_SERVE)
    assert pol.kv_cache == pcsr.P8_SERVE.kv_cache and pol.compute_dtype == "bf16"
    assert pol.attn_impl == "auto" and pol.dataflow == "fused"
    with pytest.raises(AttributeError):
        pol.__no_such_attribute__
    assert hash(pol) == hash(policy.get_precision_policy("attn-p16-mlp-p8",
                                                         base=pcsr.P8_SERVE))


BAD_SPECS = [
    "*=p8",            # bare p8 needs an es
    "*=p16@7",         # es out of range
    "*=p8@x",          # es not an integer
    "*=f32",           # not a posit format
    "*=bf16@1",        # @es on a float format
    "*=p16_1:packed",  # packed needs p8
    "*=float:packed",  # bypass takes no modifier
    "*=p8_0:zip",      # unknown modifier
    "*=",              # no format
    "*=p9_0",          # unknown format
    "no-such-preset",  # neither preset, artifact nor spec
]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_malformed_specs_raise_like_the_reference(spec):
    with pytest.raises(Exception) as want:
        jpolicy.get_precision_policy(spec)
    with pytest.raises(want.type):
        policy.get_precision_policy(spec)


@pytest.mark.parametrize("doc", [
    {"kind": "repro/serve-config", "rules": []},
    {"rules": [{"pattern": "*", "weight": "p8_0"}]},
    {"rules": [{"weights": "p8_0"}]},
    {"rules": [{"pattern": "*", "weights": "p16_1", "packed": True}]},
    {"rules": [{"pattern": "*", "weights": "f32"}]},
    {"base": {"weights": "p8_0", "kv": "p8_0"}, "rules": []},
])
def test_malformed_documents_raise_like_the_reference(doc):
    with pytest.raises(Exception) as want:
        jpolicy.PrecisionPolicy.from_json(doc)
    with pytest.raises(want.type):
        policy.PrecisionPolicy.from_json(doc)


def test_layer_rules_validate_like_the_reference():
    for kw in (dict(weights=policy.PositFmt(16, 1), packed=True),
               dict(weights=policy.PositFmt(8, 0), bypass=True), dict(packed=True)):
        jkw = {k: (jpolicy.PositFmt(v.nbits, v.es) if k == "weights" else v)
               for k, v in kw.items()}
        with pytest.raises(ValueError):
            jpolicy.LayerRule("*", **jkw)
        with pytest.raises(ValueError):
            policy.LayerRule("*", **kw)
    for tok in ("p8_0", "p8@3", "p16_1@0", " p16@2 "):
        got, want = policy.parse_fmt_token(tok), jpolicy.parse_fmt_token(tok)
        assert (got.nbits, got.es) == (want.nbits, want.es)
