"""The port's engine telemetry on its own, on the tiny float32 DALLE of
test_torch_dalle.py (pages of 4), split and fused paths:

- under a fault-injected overload (a small pool, a short queue,
  deadlines, priorities, ``page_exhaust`` and ``prefill_fail``) every
  submitted request has a closed ``serve.request`` span ending in its
  typed outcome, the outcomes tally the engine's results and
  ``serve.*`` counters, every prefill span is parented to its request's
  span, and ``serve.queue_wait_s`` saw every admission;
- with every flight-file write failing and a ring of 8, the engine
  completes with clean accounting and the failures are counted;
- decode spans count dispatches (one a split decode step or fused
  iteration), not tokens;
- telemetry on against off: the tokens are bitwise equal, and the
  dispatches, the counters and the histogram counts are equal (the
  spans add no device work); off records nothing and starts no thread;
- the post-decode stages record one span a batched dispatch."""

import json
import threading

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.postdecode import STAGE_RERANK, STAGE_VAE, StageSpec
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.testing import reset_registries
from dalle_pytorch_tpu_torch.utils.metrics import counters, histograms
from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY, validate_flight_file
from test_torch_dalle import PAGE, CONFIG
from test_torch_engine import _prompt

torch.set_num_threads(1)

PATHS = {"split": {}, "split_chunked": dict(prefill_chunk=2),
         "fused": dict(fused_iteration=True, prefill_chunk=2)}
ON_OFF = {**PATHS, "spec": dict(fused_iteration=True, prefill_chunk=3, spec_decode=True, spec_k=2),
          "prefix": dict(fused_iteration=True, prefill_chunk=2, prefix_cache=True)}


@pytest.fixture(scope="module")
def model():
    from dalle_pytorch_tpu_torch.models.dalle import DALLE

    return DALLE(**CONFIG, device="cpu").init_weights(torch.Generator().manual_seed(0))


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    yield
    reset_registries()


def engine(model, **cfg):
    cfg.setdefault("max_batch", 2)
    return Engine(model, EngineConfig(page_size=PAGE, filter_thres=0.5, **cfg),
                  clock=FakeClock(step_dt=1.0), device="cpu")


def req(i, n=4, **kw):
    kw.setdefault("seed", i)
    return Request(f"r{i}", _prompt(i % 3), n, **kw)


@pytest.mark.parametrize("path", PATHS)
def test_overload_every_request_has_a_typed_span_chain(model, path, tmp_path):
    TELEMETRY.configure(enabled=True, flight_dir=str(tmp_path / "fl"))
    eng = engine(model, page_budget=7, queue_limit=3, prefill_attempts=2, **PATHS[path])
    eng.faults.arm("page_exhaust", 1)
    eng.faults.arm("prefill_fail", 1)
    for i in range(8):
        eng.submit(req(i, deadline=None if i % 2 else 40.0, priority=i % 3))
    eng.run(max_steps=1000)
    s = validate_flight_file(TELEMETRY.drain("test"))
    assert s["unclosed"] == [], s["unclosed_records"]
    recs = list(flight_records(tmp_path))
    spans = {}
    prefills = []
    for rec in recs:
        if rec.get("name") == "serve.request":
            spans.setdefault(rec["id"], [None, None])[rec["ph"] == "E"] = rec
        elif rec.get("name") == "serve.prefill" and rec["ph"] == "B":
            prefills.append(rec)
    assert len(spans) == 8
    tally = {}
    for b, e in spans.values():
        assert b is not None and e is not None and e["outcome"]
        assert e["outcome"] == eng.results[b["request_id"]].outcome.value
        tally[e["outcome"]] = tally.get(e["outcome"], 0) + 1
    assert len(tally) >= 2, tally
    for outcome, n in tally.items():
        assert counters.get(f"serve.{outcome}") == n, outcome
    for p in prefills:
        assert spans[p["parent"]][0]["request_id"] == p["request_id"]
    assert histograms.get("serve.queue_wait_s").count == counters.get("serve.admitted") > 0
    assert histograms.get("serve.request_latency_s").count == 8
    eng.verify_invariants(idle=True)


def flight_records(tmp_path):
    for f in sorted((tmp_path / "fl").glob("flight-*.jsonl")):
        for line in f.read_text().splitlines():
            yield json.loads(line)


@pytest.mark.parametrize("path", PATHS)
def test_sink_faults_never_break_the_engine(model, path, tmp_path):
    TELEMETRY.configure(enabled=True, flight_dir=str(tmp_path / "fl"), ring_size=8)
    TELEMETRY.faults.arm("telemetry_sink_fail", 10_000)
    eng = engine(model, **PATHS[path])
    for i in range(3):
        assert eng.submit(req(i)) is None
    results = eng.run(max_steps=1000)
    eng.verify_invariants(idle=True)
    assert all(r.outcome is Outcome.COMPLETED for r in results.values())
    assert TELEMETRY.sink_errors > 0 and counters.get("telemetry.sink_errors") > 0


@pytest.mark.parametrize("path", PATHS)
def test_decode_spans_count_dispatches_not_tokens(model, path):
    TELEMETRY.configure(enabled=True)
    eng = engine(model, **PATHS[path])
    for i in range(2):
        eng.submit(req(i, n=8))
    eng.run(max_steps=1000)
    name = "serve.iteration" if PATHS[path].get("fused_iteration") else "serve.decode_step"
    n_spans = sum(1 for r in TELEMETRY.records() if r.get("name") == name and r["ph"] == "B")
    assert n_spans < 2 * 8  # both slots ride one dispatch
    if name == "serve.iteration":
        assert n_spans == eng.dispatches
    else:
        assert n_spans == counters.get("serve.decode_steps")
        assert eng.dispatches == n_spans + eng.prefill_dispatches


def _serve(model, cfg, telemetry: bool):
    reset_registries()
    if telemetry:
        TELEMETRY.configure(enabled=True)
    eng = engine(model, **cfg)
    for wave in ((0, 1, 2), (3, 4)):  # the second wave hits the prefix cache
        for i in wave:
            eng.submit(req(i, n=3 + 2 * i))
        eng.run(max_steps=1000)
    tokens = {rid: r.tokens.tolist() for rid, r in eng.results.items()}
    hist_counts = {k: v["count"] for k, v in histograms.snapshot().items()}
    return (tokens, eng.dispatches, eng.iterations, counters.snapshot(), hist_counts,
            TELEMETRY.records())


@pytest.mark.parametrize("config", ON_OFF)
def test_telemetry_on_and_off_serve_the_same_tokens_and_work(model, config):
    threads = threading.active_count()
    off = _serve(model, ON_OFF[config], telemetry=False)
    assert off[-1] == [] and threading.active_count() == threads
    on = _serve(model, ON_OFF[config], telemetry=True)
    assert on[0] == off[0]  # tokens, bitwise
    assert on[1:3] == off[1:3]  # dispatches, iterations
    assert on[3] == off[3]  # every counter
    # the histograms are off's plus one duration histogram a span name
    spans = {f"{r['name']}_s" for r in on[-1] if r["ph"] == "B"}
    assert "serve.request_s" in spans and set(on[4]) == set(off[4]) | spans
    assert {k: on[4][k] for k in off[4]} == off[4]


def test_stage_spans_one_a_batched_dispatch():
    from test_torch_postdecode import prompt, staged_models

    *_, dalle, vae, clip = staged_models()
    TELEMETRY.configure(enabled=True)
    eng = Engine(dalle, EngineConfig(max_batch=2, fused_iteration=True, prefill_chunk=2),
                 clock=FakeClock(step_dt=0.05), device="cpu", stages=StageSpec(vae, clip))
    for i in range(3):
        eng.submit(Request(f"s{i}", prompt(i), 4, seed=i))
    eng.run(max_steps=500)
    pipe = eng.postdecode
    for stage in (STAGE_VAE, STAGE_RERANK):
        spans = [r for r in TELEMETRY.records()
                 if r.get("name") == f"serve.stage.{stage}" and r["ph"] == "B"]
        assert len(spans) == pipe.dispatches[stage] > 0
        assert sum(r["n"] for r in spans) == 3
        assert histograms.get(f"serve.stage.{stage}_s").count == len(spans)
    assert counters.get("serve.stage.reranked") == pipe.counters.get("serve.stage.reranked") == 3
    assert np.isfinite([r.rerank_score for r in eng.results.values()]).all()
