"""Port serving engine: continuous batching over the ragged posit KV cache on
the reduced qwen2.5-14b (CPU, plain kernel versions).

* staggered admission gives every request the tokens it gets served alone
  (temperature 0; the decode grid always runs max_slots rows, and a row's
  GEMM/attention results do not depend on the other rows);
* slots recycle: more requests than slots all complete;
* sampling (temperature / top-k) keeps the structure and is seeded.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.pcsr import P8_SERVE
from repro_torch.launch.engine import (ContinuousBatchingEngine, Request, _sample,
                                       poisson_requests)
from repro_torch.launch.serve import serve
from repro_torch.models.registry import build_model


@pytest.fixture(scope="module")
def engine():
    cfg = get_arch("qwen2.5-14b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0, P8_SERVE)
    return ContinuousBatchingEngine(model, params, P8_SERVE, max_slots=4, S_max=24)


def _requests():
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 512, (plen,)).astype(np.int32),
                    max_new_tokens=6)
            for i, plen in enumerate((8, 12, 5, 10))]


def test_staggered_equals_isolated(engine):
    isolated = {}
    for req in _requests():
        engine.reset()
        isolated[req.rid] = engine.run([req])[0].tokens
    engine.reset()
    reqs = _requests()
    engine.submit(reqs[0])
    engine.admit()
    engine.step()
    engine.step()
    engine.submit(reqs[1])
    engine.admit()
    engine.step()
    engine.submit(reqs[2])
    engine.submit(reqs[3])
    engine.admit()
    while engine.active.any():
        engine.step()
    got = {c.rid: c.tokens for c in engine.results()}
    assert got == isolated
    assert all(len(t) == 6 for t in got.values())


def test_slots_recycle(engine):
    engine.reset()
    reqs = poisson_requests(9, arrival_rate=0.0, prompt_lens=(6, 9), max_new_tokens=5,
                            vocab=512, seed=1)
    done = engine.run(reqs)
    assert sorted(c.rid for c in done) == list(range(9))
    assert all(len(c.tokens) == 5 and c.finish_reason == "max_new" for c in done)
    # 9 requests through 4 slots: at least three admission waves
    assert engine.steps >= 3 * 4
    assert engine.nonfinite_rows == 0
    assert engine.result(8) is not None and engine.result(99) is None


def test_sampling_is_seeded_and_bounded():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 50), generator=gen)
    assert torch.equal(_sample(logits, gen, 0.0, 0), logits.argmax(-1))
    a = _sample(logits, torch.Generator().manual_seed(5), 0.7, 4)
    b = _sample(logits, torch.Generator().manual_seed(5), 0.7, 4)
    assert torch.equal(a, b)
    top4 = torch.topk(logits, 4, dim=-1).indices
    assert all(int(a[i]) in top4[i].tolist() for i in range(3))


def test_oversized_request_raises(engine):
    engine.reset()
    engine.submit(Request(rid=0, prompt=np.zeros((20,), np.int32), max_new_tokens=8))
    with pytest.raises(ValueError, match="S_max"):
        engine.admit()
    engine.reset()


def test_serve_report_cpu():
    events = []
    report = serve("qwen2.5-14b", reduced=True, max_slots=2, requests=3, prompt_len=6,
                   gen=4, device="cpu", temperature=0.8, top_k=5, emit=events.append)
    assert [e["kind"] for e in events] == ["serve/prefill"] * 3 + ["serve/report"]
    assert report["requests"] == 3 and report["tokens"] == 12
    assert report["kv_bytes_per_token"] == 2 * 2 * 2 * 32   # layers*K,V*Hkv*hd at 1 B
    assert report["kv_nar_codes"] == 0
    # CPU tensors take the plain versions: no kernel launches
    assert set(report["kernel_launches"].values()) == {0}
