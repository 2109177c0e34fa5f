"""The port's engine telemetry and metrics against the JAX package's
engine, on the tiny float32 DALLE of test_torch_dalle.py (pages of 4,
greedy: top-k keeps one logit, so neither framework's random bits
matter) under ``FakeClock(step_dt=1.0)``, both telemetry layers on that
clock: the same requests through both engines give

- the same sequence of span and event records: name, phase, parent link
  (ids mapped to the position of their ``B`` record), time and every
  attribute (both sides record the same keys);
- the same histograms (count, sum, min, max and percentiles), counter
  series and gauge series, and so a text-equal ``dump()``;

on the split path (monolithic and chunked prefill), the fused iteration,
the prefix cache (split and fused) and speculative decode. Every name
the port emits is registered under its kind in the port's
``telemetry_names``. The post-decode stages and an overload with faults
are held the same way in test_torch_telemetry_engine_stages.py. Port-only properties (span chains, sink faults,
spans a dispatch, telemetry off against on) are in
test_torch_telemetry_engine_port.py."""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.utils import metrics as jm
from dalle_pytorch_tpu.utils.faults import FAULTS as JFAULTS
from dalle_pytorch_tpu.utils.telemetry import TELEMETRY as JTELEMETRY
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Request
from dalle_pytorch_tpu_torch.testing import reset_registries
from dalle_pytorch_tpu_torch.utils import metrics as pm
from dalle_pytorch_tpu_torch.utils import telemetry_names
from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import GREEDY, _prompt

torch.set_num_threads(1)

CONFIGS = {
    "split": {},
    "split_chunked": dict(prefill_chunk=2),
    "fused": dict(fused_iteration=True, prefill_chunk=2),
    "split_prefix": dict(prefix_cache=True),
    "fused_prefix": dict(fused_iteration=True, prefill_chunk=2, prefix_cache=True),
    "spec": dict(fused_iteration=True, prefill_chunk=3, spec_decode=True, spec_k=2),
}
OVERLOAD = dict(max_batch=2, page_budget=9, queue_limit=4, prefill_attempts=2)
OVERLOAD_FAULTS = {"page_exhaust": 1, "prefill_fail": 1, "decode_stall": 1}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    reset_registries()
    yield
    reset_registries()


def requests(kind):
    """(request id, prompt, max_new, seed, priority, deadline) rows: a
    plain mix of budgets and a repeated prompt (a prefix hit once it is
    published), or the overload's eight."""
    if kind == "staged":
        from test_torch_postdecode import prompt

        return [(f"s{i}", prompt(i), 4, i, 0, None) for i in range(3)]
    if kind == "overload":
        return [(f"r{i}", _prompt(i % 3), 4 + i % 5, i, i % 3, None if i % 2 else 14.0 + i)
                for i in range(8)]
    return [("a", _prompt(0), 9, 0, 0, None), ("b", _prompt(1), 5, 1, 0, None),
            ("c", _prompt(0), 7, 2, 1, None), ("d", _prompt(2), 12, 3, 0, None)]


def run_engine(models, side, cfg, kind, faults, waves, stages=(None, None), step_dt=1.0):
    """Serve ``requests(kind)`` in ``waves`` (each run to idle) through
    ``side``'s engine (``stages``: JAX's and the port's ``StageSpec``)
    with its telemetry on the engine's clock; returns (results,
    records)."""
    jmodel, params, model = models
    rows = requests(kind)
    chunks = np.array_split(np.arange(len(rows)), waves)
    if side == "jax":
        clock = JFakeClock(step_dt=step_dt)
        JTELEMETRY.configure(enabled=True, clock=clock, ring_size=1 << 20)
        for site, n in faults.items():
            JFAULTS.arm(site, n)
        eng = JEngine(jmodel, params, JEngineConfig(**cfg, filter_thres=GREEDY), clock=clock,
                      stages=stages[0])
        req = JRequest
    else:
        clock = FakeClock(step_dt=step_dt)
        TELEMETRY.configure(enabled=True, clock=clock, ring_size=1 << 20)
        eng = Engine(model, EngineConfig(**cfg, filter_thres=GREEDY, page_size=PAGE),
                     clock=clock, device="cpu", stages=stages[1])
        for site, n in faults.items():
            eng.faults.arm(site, n)
        req = Request
    for chunk in chunks:
        for k in chunk:
            rid, prompt, n, seed, prio, deadline = rows[k]
            eng.submit(req(rid, prompt, n, seed=seed, priority=prio, deadline=deadline))
        eng.run(max_steps=2000)
    recs = list(JTELEMETRY._buf) if side == "jax" else TELEMETRY.records()
    results = {rid: (r.outcome.value, None if r.tokens is None else r.tokens.tolist())
               for rid, r in eng.results.items()}
    return results, recs


def normalized(recs):
    """Records with ids and parents replaced by the position of their
    span's ``B`` record."""
    where, out = {}, []
    for k, rec in enumerate(recs):
        rec = dict(rec)
        if rec["ph"] == "B":
            where[rec["id"]] = k
        if "id" in rec:
            rec["id"] = where.get(rec["id"], "?")
        if rec.get("parent") is not None:
            rec["parent"] = where.get(rec["parent"], "?")
        out.append(rec)
    return out


def registry_state(counters, gauges, histograms):
    return counters.snapshot(), gauges.snapshot(), histograms.snapshot()


def check_against_jax(models, cfg, kind="plain", faults=None, waves=1, **kw):
    faults = faults or {}
    theirs, jrecs = run_engine(models, "jax", cfg, kind, faults, waves, **kw)
    ours, recs = run_engine(models, "port", cfg, kind, faults, waves, **kw)
    assert ours == theirs
    got, want = normalized(recs), normalized(jrecs)
    assert [(r.get("name"), r["ph"]) for r in got] == [(r.get("name"), r["ph"]) for r in want]
    for k, (a, b) in enumerate(zip(got, want)):
        assert a == b, (k, a, b)
    assert registry_state(pm.counters, pm.gauges, pm.histograms) == registry_state(
        jm.counters, jm.gauges, jm.histograms)
    assert TELEMETRY.dump() == JTELEMETRY.dump()
    check_names_registered(recs)
    return got


def check_names_registered(recs):
    for rec in recs:
        if "name" in rec and rec["name"] != "telemetry.drain":
            kind = "event" if rec["ph"] == "I" else "span"
            assert telemetry_names.is_registered(rec["name"], kind), rec
    for kind, reg in (("counter", pm.counters), ("gauge", pm.gauges),
                      ("histogram", pm.histograms)):
        for name, _, _ in reg.series():
            assert telemetry_names.is_registered(name, kind), (kind, name)


@pytest.mark.parametrize("config", CONFIGS)
def test_records_and_metrics_equal_jax(models, config):
    cfg = dict(max_batch=2, **CONFIGS[config])
    recs = check_against_jax(models, cfg, waves=2 if "prefix" in config else 1)
    names = {r.get("name") for r in recs}
    assert {"serve.request", "serve.admit", "serve.first_token"} <= names
    assert ("serve.decode_step" if not cfg.get("fused_iteration") else "serve.iteration") in names
    if "prefix" in config:
        assert "serve.prefix_hit" in names
    if config == "spec":
        assert "serve.spec_verify" in names and pm.histograms.get("serve.spec_accepted_per_step")
