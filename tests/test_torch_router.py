"""The port's replicated front door (``serving/router.py``) against the
JAX package's ``Router`` on the CPU: JAX's router cases
(``tests/test_router.py``: the health machine, global admission and the
engine's invariant surface; failover and drain are in
test_torch_router_failover.py, respawn and restart in
test_torch_router_respawn.py), each run on both packages with the same
requests and fault schedule and compared whole.

Both fleets serve the recovery tests' tiny DALLE
(``test_torch_prefix_snapshot.recovery_models``; pages of 2, so decode
crosses page boundaries mid-flight), converted, greedy, on the split path
with monolithic prefill (JAX's ``EngineConfig`` default), under a
``FakeClock``. JAX's faults arm its process-wide ``FAULTS``, the port's
the router's own registry (which every replica shares). A case's
summary holds every result (outcome, reject reason, tokens, detail,
clamp, retry hint, preempt count), the ``replica_states()`` trajectory
(each change, by step), the ``router.*`` counters, the faults fired and
the fleet's ``stats()``; the port's equals JAX's, and JAX's own
assertions hold on the port's run.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu import serving as jserving
from dalle_pytorch_tpu.utils import resilience as jresilience
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu.utils.metrics import counters as jcounters
from dalle_pytorch_tpu.utils.metrics import histograms as jhistograms
from dalle_pytorch_tpu_torch.serving import engine as pengine
from dalle_pytorch_tpu_torch.serving import router as prouter
from dalle_pytorch_tpu_torch.serving import types as ptypes
from dalle_pytorch_tpu_torch.utils import resilience as presilience
from dalle_pytorch_tpu_torch.utils.metrics import counters as pcounters
from dalle_pytorch_tpu_torch.utils.metrics import histograms as phistograms
from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_prefix_snapshot import GREEDY, PAGE, recovery_models

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


def prompt(i=0):
    return np.random.RandomState(100 + i).randint(1, 16, size=(4,)).astype(np.int32)


class Side:
    """One package's vocabulary for a case: its router, engine and
    request types, clock, retry policy, registries and fault arming."""

    def __init__(self, kind: str, models):
        self.kind = kind
        self.jdalle, self.params, self.dalle = models
        if kind == "jax":
            self.Router, self.RouterConfig = jserving.Router, jserving.RouterConfig
            self.Engine, self.EngineConfig = jserving.Engine, jserving.EngineConfig
            self.Request, self.FakeClock = jserving.Request, jserving.FakeClock
            self.Outcome, self.RejectReason = jserving.Outcome, jserving.RejectReason
            self.ReplicaState = jserving.ReplicaState
            self.RetryPolicy = jresilience.RetryPolicy
            self.counters, self.histograms = jcounters, jhistograms
        else:
            self.Router, self.RouterConfig = prouter.Router, prouter.RouterConfig
            self.Engine, self.EngineConfig = pengine.Engine, pengine.EngineConfig
            self.Request, self.FakeClock = ptypes.Request, ptypes.FakeClock
            self.Outcome, self.RejectReason = ptypes.Outcome, ptypes.RejectReason
            self.ReplicaState = prouter.ReplicaState
            self.RetryPolicy = presilience.RetryPolicy
            self.counters, self.histograms = pcounters, phistograms

    def req(self, i, max_new=4, rid=None, **kw):
        kw.setdefault("seed", i)
        return self.Request(request_id=rid or f"r{i}", prompt=prompt(i),
                            max_new_tokens=max_new, **kw)

    def policy(self, **kw):
        return self.RetryPolicy(jitter=0.0, retry_on=(), **kw)

    def engine_config(self, **kw):
        kw.setdefault("max_batch", 2)
        kw.setdefault("filter_thres", GREEDY)
        if self.kind == "port":
            kw["page_size"] = PAGE
        return self.EngineConfig(**kw)

    def router(self, n=2, clock=None, router_kw=None, journal=None, **eng_kw):
        cfg = self.RouterConfig(n_replicas=n, **(router_kw or {}))
        clock = clock or self.FakeClock(step_dt=0.1)
        if self.kind == "jax":
            return self.Router(self.jdalle, self.params, cfg, self.engine_config(**eng_kw),
                               clock=clock, journal=journal)
        return self.Router(self.dalle, cfg, self.engine_config(**eng_kw), clock=clock,
                           journal=journal, device="cpu")

    def engine(self, **eng_kw):
        clock = self.FakeClock(step_dt=0.1)
        if self.kind == "jax":
            return self.Engine(self.jdalle, self.params, self.engine_config(**eng_kw), clock=clock)
        return self.Engine(self.dalle, self.engine_config(**eng_kw), clock=clock, device="cpu")

    def arm(self, router, site: str, n: int) -> None:
        (FAULTS if self.kind == "jax" else router.faults).arm(site, n)

    def fired(self, router) -> dict:
        return dict((FAULTS if self.kind == "jax" else router.faults).fired)


def drive(router, max_steps, on_step=None, trajectory=None):
    """``router.run()`` step by step, recording each change of
    ``replica_states()`` as (step, states) into ``trajectory``;
    ``on_step(step)`` after each step."""
    trajectory = [] if trajectory is None else trajectory
    if not trajectory:
        trajectory.append((0, router.replica_states()))
    steps = 0
    while router.step():
        steps += 1
        states = router.replica_states()
        if states != trajectory[-1][1]:
            trajectory.append((steps, states))
        if on_step is not None:
            on_step(steps)
        assert steps < max_steps, f"router made no terminal progress in {max_steps} steps"
    return trajectory


def summary(side: Side, router, trajectory=None) -> dict:
    """Everything a case compares across the packages."""
    results = {
        rid: (r.outcome.value, None if r.reject_reason is None else r.reject_reason.value,
              None if r.tokens is None else [int(t) for t in r.tokens], r.detail,
              r.clamped_max_new_tokens, r.retry_after_s, r.preempt_count)
        for rid, r in router.results.items()
    }
    stats = router.stats()
    for rep in stats["replicas"].values():
        rep.pop("pool_occupancy")
    hist = side.histograms.get("router.failover_latency_s")
    return {"results": results, "trajectory": trajectory, "stats": stats,
            "router_counters": side.counters.snapshot("router."), "fired": side.fired(router),
            "failover_latency_count": 0 if hist is None else hist.count}


def accounting_holds(router):
    router.verify_invariants()
    outcomes = router.stats()["outcomes"]
    assert sum(outcomes.values()) == router.stats()["submitted"]
    return outcomes


# ------------------------------------------------------- health machine


def case_breaker_opens_backs_off_and_readmits(side):
    router = side.router(n=1, clock=side.FakeClock(step_dt=1.0), prefill_attempts=10,
                         router_kw=dict(breaker_threshold=2,
                                        breaker_backoff=side.policy(attempts=5, base_delay=4.0,
                                                                    max_delay=60.0)))
    side.arm(router, "prefill_fail", 3)
    assert router.submit(side.req(0)) is None and router.submit(side.req(1)) is None
    traj = drive(router, 300)
    assert accounting_holds(router)["completed"] == 2
    assert side.fired(router).get("prefill_fail") == 3
    assert side.counters.get("router.breaker_opens") == 1
    assert side.counters.get("router.readmits") == 1
    assert router.replica_states()[0] == "healthy"
    return summary(side, router, traj)


def case_second_router_does_not_inherit_breaker_deltas(side):
    router_kw = dict(breaker_threshold=2, breaker_backoff=side.policy(
        attempts=5, base_delay=2.0, max_delay=60.0))
    first = side.router(n=1, clock=side.FakeClock(step_dt=1.0), router_kw=router_kw,
                        prefill_attempts=10)
    side.arm(first, "prefill_fail", 3)
    assert first.submit(side.req(0)) is None
    drive(first, 300)
    assert first.results["r0"].outcome is side.Outcome.COMPLETED
    opens = side.counters.get("router.breaker_opens")
    assert opens >= 1
    second = side.router(n=1, clock=side.FakeClock(step_dt=1.0), router_kw=router_kw,
                         prefill_attempts=10)
    assert second.submit(side.req(1)) is None
    traj = drive(second, 300)
    assert second.results["r1"].outcome is side.Outcome.COMPLETED
    assert side.counters.get("router.breaker_opens") == opens
    assert second.replica_states()[0] == "healthy"
    # the port's registry is the first router's own, JAX's process-wide
    return dict(summary(side, second, traj), fired=side.fired(first),
                first=summary(side, first))


def case_health_flap_backoff_prevents_admission_livelock(side):
    router = side.router(n=2, clock=side.FakeClock(step_dt=1.0), router_kw=dict(
        breaker_backoff=side.policy(attempts=10, base_delay=1.0, max_delay=8.0)))
    side.arm(router, "health_flap", 4)
    for i in range(3):
        assert router.submit(side.req(i)) is None
    traj = drive(router, 500)
    assert accounting_holds(router)["completed"] == 3
    assert side.fired(router).get("health_flap") == 4
    assert side.counters.get("router.breaker_opens") == 4
    return summary(side, router, traj)


def case_stall_heartbeat_declares_dead_and_fails_over(side):
    router = side.router(n=2, clock=side.FakeClock(step_dt=1.0),
                         router_kw=dict(stall_timeout_s=2.5))
    assert router.submit(side.req(0)) is None
    traj = [(0, router.replica_states())]
    for _ in range(2):
        router.step()
    holder = next(r for r in router._replicas if r.inflight)
    side.arm(router, "replica_stall", 5)
    drive(router, 300, trajectory=traj)
    assert accounting_holds(router)["completed"] == 1
    assert holder.state is side.ReplicaState.DEAD and holder.death_reason == "stall_timeout"
    assert any(r.state is not side.ReplicaState.DEAD for r in router._replicas)
    return summary(side, router, traj)


def case_invariant_violation_quarantines_replica(side):
    router = side.router(n=2)
    assert router.submit(side.req(0)) is None
    for _ in range(2):
        router.step()
    holder = next(r for r in router._replicas if r.inflight)
    holder.engine._submitted += 1  # a request "lost"
    traj = drive(router, 300)
    assert holder.state is side.ReplicaState.DEAD
    assert holder.death_reason == "invariant_violation"
    res = router.results["r0"]
    assert res.outcome is side.Outcome.COMPLETED and "failovers=1" in res.detail
    return summary(side, router, traj)


# ---------------------------------------------------- global admission


def case_router_queue_full_typed(side):
    router = side.router(n=1, router_kw=dict(queue_limit=1))
    assert router.submit(side.req(0)) is None
    res = router.submit(side.req(1))
    assert res is not None and res.reject_reason is side.RejectReason.QUEUE_FULL
    assert res.retry_after_s is not None
    assert side.counters.get("router.shed") == 1
    traj = drive(router, 300)
    outcomes = accounting_holds(router)
    assert outcomes["completed"] == 1 and outcomes["rejected"] == 1
    return summary(side, router, traj)


def case_demand_exceeds_every_pool_typed(side):
    router = side.router(n=2, page_budget=2)
    res = router.submit(side.req(0))
    assert res is not None and res.reject_reason is side.RejectReason.DEMAND_EXCEEDS_POOL
    assert res.retry_after_s is None
    accounting_holds(router)
    return summary(side, router)


def case_duplicate_and_bounds_raise(side):
    router = side.router(n=1)
    assert router.submit(side.req(0)) is None
    with pytest.raises(ValueError, match="duplicate"):
        router.submit(side.req(0))
    with pytest.raises(ValueError, match="max_new_tokens"):
        router.submit(side.req(1, max_new=99))
    traj = drive(router, 300)
    accounting_holds(router)
    return summary(side, router, traj)


def case_watermark_degradation_spans_fleet(side):
    router = side.router(n=2, max_batch=1, high_watermark=0.25, degraded_max_new_tokens=2)
    assert router.submit(side.req(0, max_new=4)) is None
    for _ in range(2):
        router.step()
    assert router.fleet_occupancy() > 0.25
    empty = [r for r in router._replicas if not r.inflight]
    assert empty and empty[0].engine.pool.occupancy == 0.0
    assert router.submit(side.req(1, max_new=4)) is None
    traj = drive(router, 500)
    assert accounting_holds(router)["completed"] == 2
    r0, r1 = router.results["r0"], router.results["r1"]
    assert r0.clamped_max_new_tokens is None and len(r0.tokens) == 4
    assert r1.clamped_max_new_tokens == 2 and len(r1.tokens) == 2
    return summary(side, router, traj)


def case_combined_chaos_all_typed(side):
    router = side.router(n=3, clock=side.FakeClock(step_dt=0.5), max_batch=2, page_budget=7,
                         router_kw=dict(queue_limit=6))
    for site in ("replica_crash", "health_flap", "prefill_fail", "page_exhaust"):
        side.arm(router, site, 1)
    immediate = []
    for i in range(8):
        r = router.submit(side.req(i, max_new=4, deadline=None if i % 2 else 60.0,
                                   priority=i % 3))
        if r is not None:
            immediate.append(r)
    traj = [(0, router.replica_states())]
    router.step()
    router.cancel("r3")
    drive(router, 1000, trajectory=traj)
    outcomes = accounting_holds(router)
    assert sum(outcomes.values()) == 8
    assert outcomes["rejected"] == len(immediate)
    assert outcomes["cancelled"] >= 1
    assert side.counters.get("router.replica_deaths") == 1
    assert side.fired(router).get("replica_crash") == 1
    for rep in router._replicas:
        if rep.state is not side.ReplicaState.DEAD:
            rep.engine.verify_invariants(idle=True)
    return summary(side, router, traj)


# ----------------------------------------------- the engine's invariants


def case_verify_invariants_mid_flight_and_idle(side):
    eng = side.engine()
    assert eng.submit(side.req(0)) is None
    eng.step()
    eng.verify_invariants()
    with pytest.raises(AssertionError, match="not idle"):
        eng.verify_invariants(idle=True)
    eng.run(max_steps=200)
    eng.verify_invariants(idle=True)
    return {"tokens": [int(t) for t in eng.results["r0"].tokens], "stats": eng.stats()}


def case_verify_invariants_detects_corruption(side):
    eng = side.engine()
    assert eng.submit(side.req(0)) is None
    eng.run(max_steps=200)
    eng._submitted += 1
    with pytest.raises(AssertionError, match="submitted"):
        eng.verify_invariants()
    return {"stats": eng.stats()}


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


def run_case(models, fn):
    """The case on the port, then on JAX (registries and faults reset
    between); both summaries."""
    port = fn(Side("port", models))
    FAULTS.reset()
    return port, fn(Side("jax", models))


@pytest.mark.parametrize("name", sorted(CASES))
def test_router_case_matches_jax(models, name):
    port, jax_summary = run_case(models, CASES[name])
    assert port == jax_summary
