"""``serve.main(["--calibrate", N, ...])`` on the CPU, the reference's
``tests/test_calib.py::test_serve_calibrate_cli`` on the port: reduced
phi3-mini-3.8b in continuous and static mode (the moe family's
calibration: tests/test_torch_calib_e2e.py);
every stdout line is JSON with a ``kind``, one ``serve/calibration`` line,
the artifact reloads as a serving policy, the report carries
``weight_bytes_policy`` and ``decode_tok_per_s``; serving the artifact
again with ``--precision-policy @cal.json`` gives the same weight bytes and
tokens (the same quantized weights); ``--weight-byte-budget 1.5x``; whisper
and a budget without ``--calibrate`` are refused."""
import json

import pytest

from repro_torch.core.policy import get_precision_policy
from repro_torch.launch import serve

COMMON = ["--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "4", "--policy",
          "p8-serve", "--device", "cpu"]
MODES = {"continuous": ["--continuous", "--requests", "2"], "static": []}


def _run(argv, capsys) -> list:
    serve.main(argv)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert lines and all("kind" in ln for ln in lines)
    return lines


def _one(lines, kind):
    found = [ln for ln in lines if ln["kind"] == kind]
    assert len(found) == 1, (kind, [ln["kind"] for ln in lines])
    return found[0]


@pytest.mark.parametrize("mode", list(MODES))
def test_serve_calibrate_cli(mode, tmp_path, capsys):
    arch = "phi3-mini-3.8b"
    out = tmp_path / "cal.json"
    lines = _run(["--arch", arch, *COMMON, *MODES[mode], "--calibrate", "2",
                  "--policy-out", str(out)], capsys)
    cal = _one(lines, "serve/calibration")["calibration"]
    assert cal["n_sites"] >= 4 and cal["weight_bytes"] == cal["byte_budget"] == \
        cal["p8_floor_bytes"]
    assert _one(lines, "serve/policy-out")["policy_out"] == str(out)
    pol = get_precision_policy("@" + str(out))
    assert pol.policy_for("blocks/attn/wq").weights.nbits == 8
    report = _one(lines, "serve/report")
    assert "weight_bytes_policy" in report and "decode_tok_per_s" in report
    assert report["weight_bytes_policy"] == cal["weight_bytes"]
    again = _one(_run(["--arch", arch, *COMMON, *MODES[mode], "--precision-policy",
                       "@" + str(out)], capsys), "serve/report")
    assert again["weight_bytes_policy"] == report["weight_bytes_policy"]
    assert again["sample_tokens"] == report["sample_tokens"]


def test_serve_calibrate_budget(tmp_path, capsys):
    lines = _run(["--arch", "phi3-mini-3.8b", *COMMON, *MODES["continuous"], "--calibrate",
                  "2", "--weight-byte-budget", "1.5x"], capsys)
    cal = _one(lines, "serve/calibration")["calibration"]
    assert cal["byte_budget"] == round(1.5 * cal["p8_floor_bytes"])
    assert cal["p8_floor_bytes"] < cal["weight_bytes"] <= cal["byte_budget"]
    assert _one(lines, "serve/report")["weight_bytes_policy"] == cal["weight_bytes"]
    assert not [ln for ln in lines if ln["kind"] == "serve/policy-out"]


def test_serve_calibrate_refusals(tmp_path):
    with pytest.raises(SystemExit, match="whisper"):
        serve.main(["--arch", "whisper-medium", *COMMON, "--calibrate", "2"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "phi3-mini-3.8b", *COMMON, "--policy-out",
                    str(tmp_path / "x.json")])
