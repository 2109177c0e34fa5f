"""The port's router against the JAX package's on the CPU: JAX's
failover and drain cases (``tests/test_router.py``, ``TestFailover`` and
``TestDrain``) and the breaker's jittered backoff, run on both packages
with the same requests and fault schedule and compared whole (the
harness and its summary: test_torch_router.py). The failed-over tokens
are bitwise the uninterrupted run's on both sides, and the jitter is
drawn from ``random.Random(backoff_seed)`` in JAX's order (the breaker's
readmission times, hence the state trajectory, equal)."""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_prefix_snapshot import PAGE, recovery_models
from test_torch_router import accounting_holds, drive, prompt, run_case, summary

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return recovery_models()


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    reset_registries()
    FAULTS.reset()
    yield
    reset_registries()
    FAULTS.reset()


def clean_tokens(side, n_req=2):
    router = side.router(n=2)
    for i in range(n_req):
        assert router.submit(side.req(i)) is None
    drive(router, 500)
    return {rid: [int(t) for t in r.tokens] for rid, r in router.results.items()}


def case_cross_replica_replay_bit_identical(side):
    """A request prefilled and partly decoded on one replica, requeued
    when it dies, completes on the other bitwise as uninterrupted."""
    clean = clean_tokens(side)
    side.counters.reset()
    router = side.router(n=2)
    for i in range(2):
        assert router.submit(side.req(i)) is None
    traj = [(0, router.replica_states())]
    for _ in range(200):
        router.step()
        partial = [s for r in router._replicas for s in r.engine.slots
                   if s and len(s.entry.generated) >= 2]
        if partial:
            break
    assert partial, "no request reached partial decode"
    side.arm(router, "replica_crash", 1)
    drive(router, 500, trajectory=traj)
    assert accounting_holds(router)["completed"] == 2
    assert side.counters.get("router.replica_deaths") == 1
    assert side.counters.get("router.failovers") >= 1
    assert [r for r in router.results.values() if "failovers=1" in r.detail]
    for rid, r in router.results.items():
        assert [int(t) for t in r.tokens] == clean[rid], f"{rid} diverged across failover"
    assert side.histograms.get("router.failover_latency_s").count >= 1
    return summary(side, router, traj)


def case_deadline_expires_during_failover_shared_clock(side):
    clock = side.FakeClock(step_dt=1.0)
    router = side.router(n=2, clock=clock, router_kw=dict(breaker_backoff=side.policy(
        attempts=3, base_delay=100.0, max_delay=100.0)))
    side.arm(router, "health_flap", 1)
    traj = [(0, router.replica_states())]
    router.step()
    assert router.replica_states()[0] == "degraded"
    assert router.submit(side.Request(request_id="victim", prompt=prompt(0), max_new_tokens=4,
                                      seed=0, deadline=clock.now() + 8.0)) is None
    for _ in range(3):
        router.step()
    holder = router._replicas[1]
    assert "victim" in holder.inflight
    router.kill(holder.id, "crash")
    drive(router, 300, trajectory=traj)
    res = router.results["victim"]
    assert res.outcome is side.Outcome.DEADLINE_EXCEEDED and "router queue" in res.detail
    accounting_holds(router)
    return summary(side, router, traj)


def case_failover_cap_is_typed(side):
    router = side.router(n=2, router_kw=dict(max_failovers=0))
    assert router.submit(side.req(0)) is None
    for _ in range(2):
        router.step()
    assert any(r.inflight for r in router._replicas)
    side.arm(router, "replica_crash", 1)
    traj = drive(router, 300)
    res = router.results["r0"]
    assert res.outcome is side.Outcome.PREEMPT_CAP and "max_failovers" in res.detail
    accounting_holds(router)
    return summary(side, router, traj)


def case_fleet_death_flushes_typed_no_replica(side):
    router = side.router(n=1, max_batch=1)
    for i in range(2):
        assert router.submit(side.req(i)) is None
    for _ in range(2):
        router.step()
    router.kill(0, "crash")
    traj = drive(router, 50)
    assert accounting_holds(router)["rejected"] == 2
    for r in router.results.values():
        assert r.reject_reason is side.RejectReason.NO_REPLICA and r.retry_after_s is not None
    res = router.submit(side.req(5))
    assert res is not None and res.reject_reason is side.RejectReason.NO_REPLICA
    accounting_holds(router)
    return summary(side, router, traj)


def case_graceful_drain_finishes_inflight_routes_rest(side):
    router = side.router(n=2, max_batch=1)
    for i in range(3):
        assert router.submit(side.req(i)) is None
    for _ in range(2):
        router.step()
    drained = next(r for r in router._replicas if r.inflight)
    inflight_rid = next(iter(drained.inflight))
    admitted_before = drained.engine._submitted
    router.drain(drained.id)
    assert drained.state is side.ReplicaState.DRAINING
    traj = drive(router, 500)
    assert accounting_holds(router)["completed"] == 3
    assert "failovers" not in router.results[inflight_rid].detail
    assert drained.engine._submitted == admitted_before
    assert drained.state is side.ReplicaState.DEAD and drained.death_reason == "drained"
    assert side.counters.get("router.drained") == 1
    return summary(side, router, traj)


def case_breaker_jitter_draws_in_jax_order(side):
    """Health flaps with a jittered breaker ladder: readmission times come
    from the seeded RNG, so the trajectories equal only if the draws do."""
    router = side.router(n=2, clock=side.FakeClock(step_dt=0.25), router_kw=dict(
        backoff_seed=7, breaker_backoff=side.RetryPolicy(
            attempts=10, base_delay=1.0, max_delay=8.0, jitter=0.9, retry_on=())))
    side.arm(router, "health_flap", 5)
    for i in range(3):
        assert router.submit(side.req(i)) is None
    traj = drive(router, 800)
    assert accounting_holds(router)["completed"] == 3
    assert side.counters.get("router.breaker_opens") == 5
    return dict(summary(side, router, traj), next_draw=router._backoff_rng.random())


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_router_failover_case_matches_jax(models, name):
    port, jax_summary = run_case(models, CASES[name])
    assert port == jax_summary


def test_engine_stats_and_retry_hint_match_jax(models):
    """A lone engine's ``stats()`` and a queue_full reject's backoff hint
    (the occupancy-scaled ``retry_after_hint``) equal JAX's."""
    from test_torch_router import Side

    out = {}
    for kind in ("port", "jax"):
        side = Side(kind, models)
        eng = side.engine(queue_limit=1, max_batch=1)
        assert eng.submit(side.req(0)) is None
        eng.step()
        assert eng.submit(side.req(1)) is None
        res = eng.submit(side.req(2))
        out[kind] = (res.reject_reason.value, res.retry_after_s, eng.stats(),
                     [r.request_id for r in eng.live_requests()])
        eng.run(max_steps=300)
        out[kind] += (eng.stats(),)
    assert out["port"] == out["jax"]
    assert out["port"][1] > 0.5 and out["port"][3] == ["r1", "r0"]
    np.testing.assert_equal(out["port"][4]["outcomes"]["completed"], 2)


@pytest.mark.parametrize("scenario", ["crash", "chaos"])
def test_router_telemetry_and_metrics_equal_jax(models, scenario):
    """Both fleets with telemetry on their shared ``FakeClock``: the same
    span and event records (the ``router.request`` spans, the
    ``router.*`` events and every replica's ``serve.*`` records, ids
    mapped to their ``B`` record's position), the same counter, gauge and
    histogram series (``router.*`` and the replicas' labelled ones), a
    text-equal ``dump()``; every name the port emits is registered."""
    from dalle_pytorch_tpu.utils import metrics as jm
    from dalle_pytorch_tpu.utils.telemetry import TELEMETRY as JTELEMETRY
    from dalle_pytorch_tpu_torch.utils import metrics as pm
    from dalle_pytorch_tpu_torch.utils.telemetry import TELEMETRY
    from test_torch_router import Side
    from test_torch_telemetry_engine import check_names_registered, normalized, registry_state

    out = {}
    for kind in ("port", "jax"):
        FAULTS.reset()
        side = Side(kind, models)
        clock = side.FakeClock(step_dt=0.5)
        (JTELEMETRY if kind == "jax" else TELEMETRY).configure(enabled=True, clock=clock,
                                                                ring_size=1 << 20)
        if scenario == "crash":
            router = side.router(n=2, clock=clock, prefill_chunk=2)
            for i in range(3):
                assert router.submit(side.req(i)) is None
            for _ in range(4):
                router.step()
            side.arm(router, "replica_crash", 1)
        else:
            router = side.router(n=3, clock=clock, page_budget=7, router_kw=dict(queue_limit=6))
            for site in ("replica_crash", "health_flap", "prefill_fail", "page_exhaust"):
                side.arm(router, site, 1)
            for i in range(8):
                router.submit(side.req(i, deadline=None if i % 2 else 30.0, priority=i % 3))
        drive(router, 1000)
        recs = list(JTELEMETRY._buf) if kind == "jax" else TELEMETRY.records()
        mods = jm if kind == "jax" else pm
        out[kind] = (summary(side, router), normalized(recs),
                     registry_state(mods.counters, mods.gauges, mods.histograms),
                     (JTELEMETRY if kind == "jax" else TELEMETRY).dump())
        if kind == "port":
            check_names_registered(recs)
    assert out["port"][0] == out["jax"][0]
    got, want = out["port"][1], out["jax"][1]
    assert [(r.get("name"), r["ph"]) for r in got] == [(r.get("name"), r["ph"]) for r in want]
    for k, (a, b) in enumerate(zip(got, want)):
        assert a == b, (k, a, b)
    assert out["port"][2] == out["jax"][2]
    assert out["port"][3] == out["jax"][3]
    names = {r.get("name") for r in got}
    assert {"router.request", "router.failover"} <= names
    assert ("router.failover_dispatch" in names) == (scenario == "crash")
