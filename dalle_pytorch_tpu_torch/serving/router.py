"""Replicated serving front door: N engines behind one ``submit()`` /
``run()`` (counterpart of ``dalle_pytorch_tpu/serving/router.py``).

A ``Router`` owns N in-process ``Engine`` replicas of one model (the
module and its weights shared, one clock, per-replica metric labels
``{"replica": "<i>"}``, one fault registry) and presents the engine's own
API. Every replica serves through the card's kernels as a lone engine
does: the ragged paged-attention kernel for its decode, prefill and
verify rows, and with stages the packed-qkv kernel in its CLIP rerank.
The policy is host-side and runs on the CPU as well.

**Health.** Each replica is HEALTHY -> DEGRADED -> DRAINING -> DEAD (and
RESPAWNING), driven by two signals the engines already give:

* heartbeats, the replica's labelled counters (``serve.decode_steps``,
  ``serve.prefill_chunks``, ``serve.admitted``) and its harvested
  results: a replica holding work whose tally does not move for
  ``stall_timeout_s`` on the shared clock is declared DEAD (the
  ``replica_stall`` fault skips its steps);
* ``Engine.verify_invariants()``, probed every iteration: an engine that
  lost or duplicated a request is DEAD at once.

**Circuit breaker.** ``breaker_threshold`` consecutive prefill failures
(the ``serve.prefill_retries`` delta, reset by any admission) open the
breaker: the replica is DEGRADED (no new admissions, its work goes on)
until a ``RetryPolicy`` backoff readmits it; attempt i waits
``min(max_delay, base * 2**i)``, jittered from the one
``random.Random(backoff_seed)`` in the JAX router's draw order.
``breaker_backoff.attempts`` trips without a success in between make it
DEAD. The ``health_flap`` fault opens a healthy replica's breaker.

**Routing.** Least-loaded: the head of the router's queue (priority,
then FIFO; strict head-of-line) goes to the HEALTHY replica with the most
free pages whose ``Engine.can_admit`` gate passes (``can_admit_staged``
for a request whose token work is done), so no replica's own queue ever
holds work the router would have to claw back.

**Failover.** A dead replica (crash, stall, invariant violation, breaker
exhaustion; the ``replica_crash`` fault kills the busiest) is abandoned
like a dead host: its unharvested results are lost and its in-flight
requests requeued to siblings, where the sampling contract replays them
bit-identically; a request past its post-decode stages' boundary resumes
at the next stage. ``max_failovers`` deaths end a request
``preempt_cap``. A deadline is an instant on the one shared clock.

**Respawn and durability.** With ``respawn`` a DEAD replica (but a
drained one) is rebuilt after a backoff (DEAD -> RESPAWNING -> HEALTHY;
``replica_respawn_fail`` fails an attempt, ``max_respawns`` failures
retire it); a pending respawn holds the no-replica flush. With a
``RequestJournal`` every admission, completed stage and outcome is
logged, so a restarted process replays the unfinished requests
(``serving/journal.py``); ``shutdown(snapshot_dir=)`` drains the fleet,
seals the journal and writes the prefix snapshot.

**Admission and shedding.** The router's bounded queue rejects
``queue_full`` (a ``router.shed`` event), a demand no live pool can
hold ``demand_exceeds_pool``, a fleet without a live replica
``no_replica``; the load-typed ones carry ``retry_after_s``. Every
engine's watermark clamp reads the fleet's aggregate occupancy
(``fleet_occupancy``), so pressure anywhere, a dead sibling's lost
capacity included, clamps admissions everywhere.

Observability: the replicas' ``serve.*{replica=i}`` series, the
``router.*`` counters and gauges, a ``router.request`` span a request
ended with its typed outcome, the events ``router.failover``,
``router.drain``, ``router.shed``, ``router.breaker_open``,
``router.readmit`` and others, and the ``router.failover_latency_s``
histogram (replica death to failover dispatch).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from ..utils.faults import FaultRegistry
from ..utils.metrics import counters, gauges, histograms
from ..utils.resilience import RetryPolicy, retry_after_hint
from ..utils.telemetry import TELEMETRY
from .engine import Engine, EngineConfig
from .journal import RequestJournal
from .postdecode import StageSpec
from .types import Clock, Outcome, RejectReason, Request, RequestResult


class ReplicaState(str, Enum):
    """Health of one replica (str-valued, like ``Outcome``)."""

    HEALTHY = "healthy"      # admitting and serving
    DEGRADED = "degraded"    # breaker open: no new admissions, serving
    DRAINING = "draining"    # operator drain: no new admissions, finishing
    DEAD = "dead"            # crashed / stalled / corrupt / retired
    # awaiting its scheduled rebuild (RouterConfig.respawn): a fresh
    # Engine of the same model and config; the stale engine is abandoned
    RESPAWNING = "respawning"


_STATE_CODE = {
    ReplicaState.HEALTHY: 0,
    ReplicaState.DEGRADED: 1,
    ReplicaState.DRAINING: 2,
    ReplicaState.DEAD: 3,
    ReplicaState.RESPAWNING: 4,
}

# states without a live engine: not stepped, harvested, counted in the
# fleet's occupancy or checked
_ENGINE_DOWN = (ReplicaState.DEAD, ReplicaState.RESPAWNING)


@dataclass(frozen=True)
class RouterConfig:
    """Fleet knobs; each replica's stay in ``EngineConfig``."""

    n_replicas: int = 2
    # the router's bounded admission queue (the fleet's)
    queue_limit: int = 256
    # circuit breaker: consecutive prefill failures before DEGRADED
    breaker_threshold: int = 3
    # readmission schedule; .attempts consecutive trips escalate to DEAD
    # (retry_on unused; jitter drawn from the router's seeded RNG)
    breaker_backoff: RetryPolicy = RetryPolicy(
        attempts=5, base_delay=1.0, max_delay=60.0, jitter=0.0,
        retry_on=(),
    )
    # heartbeat: busy without step progress this long (shared clock) and
    # the replica is declared DEAD, its work failed over
    stall_timeout_s: float = 30.0
    # replica deaths one request survives before the typed preempt_cap
    max_failovers: int = 3
    # respawn a DEAD replica (but a drained one) as a fresh Engine after a
    # respawn_backoff delay; failed attempts back off further and
    # max_respawns consecutive failures retire it
    respawn: bool = False
    max_respawns: int = 3
    respawn_backoff: RetryPolicy = RetryPolicy(
        attempts=3, base_delay=1.0, max_delay=60.0, jitter=0.0,
        retry_on=(),
    )
    # seed of the one RNG that draws both ladders' jitter, in the JAX
    # router's order (unused at jitter 0.0, the defaults)
    backoff_seed: int = 0


@dataclass
class _RouterEntry:
    """A request's fleet-level state, from router submit to its result;
    it rides the router's queue, then one replica at a time."""

    request: Request
    seq: int
    submit_time: float
    failovers: int = 0
    # set when a replica death requeued the entry; observed into
    # router.failover_latency_s at its failover dispatch
    crash_t0: Optional[float] = None
    # completed stage payloads (stage -> {"tokens": ids} | {"image":
    # ndarray}) from the pipeline's on_stage hook: a failover resumes the
    # request at its next stage (engine.submit_staged)
    staged: Dict[str, dict] = field(default_factory=dict)

    @property
    def request_id(self) -> str:
        return self.request.request_id


class _Replica:
    """One engine plus its health bookkeeping."""

    def __init__(self, rid: int, engine: Engine, now: float):
        self.id = rid
        self.engine = engine
        self.state = ReplicaState.HEALTHY
        self.inflight: Dict[str, _RouterEntry] = {}
        self.death_reason: Optional[str] = None
        self.skip_steps = 0          # injected stall: steps to skip
        # respawn bookkeeping (RouterConfig.respawn)
        self.respawns = 0            # consecutive scheduled respawns
        self.respawn_at: Optional[float] = None
        self.death_t: Optional[float] = None
        self._reset_health(now)

    def _reset_health(self, now: float) -> None:
        """Baseline every health signal, at construction and at respawn,
        on the current process-wide labelled counters: a second Router in
        the process, or a respawned engine under this replica's label,
        must not read earlier retries as a first-check delta."""
        # heartbeat
        self.last_progress_t = now
        self.last_progress_val = self.progress_value()
        self.seen_retries = counters.get(
            "serve.prefill_retries", labels=self.labels
        )
        self.seen_admits = counters.get("serve.admitted", labels=self.labels)
        # circuit breaker
        self.breaker_consec = 0      # consecutive prefill failures
        self.breaker_trips = 0       # consecutive openings w/o a success
        self.retry_at: Optional[float] = None

    def rebind(self, engine: Engine, now: float) -> None:
        """Complete a respawn: the fresh engine, HEALTHY, the respawn
        ladder closed."""
        self.engine = engine
        self.state = ReplicaState.HEALTHY
        self.death_reason = None
        self.respawns = 0
        self.respawn_at = None
        self.skip_steps = 0
        self._reset_health(now)

    @property
    def labels(self) -> dict:
        return {"replica": str(self.id)}

    def progress_value(self) -> int:
        """Monotone work tally of the replica's labelled counters: the
        heartbeat."""
        c = counters
        return (
            c.get("serve.decode_steps", labels=self.labels)
            + c.get("serve.prefill_chunks", labels=self.labels)
            + c.get("serve.admitted", labels=self.labels)
            + len(self.engine.results)
        )


class Router:
    """See the module docstring. Thread safety: ``submit`` and ``cancel``
    may come from serving threads while another drives ``run()``; every
    fleet structure is guarded by one ``RLock`` (reentrant because an
    engine's ``fleet_occupancy`` hook calls back mid-``step``). Engines
    stay single-threaded: only ``step()``, under the lock, touches them.

    ``dalle``: the model every replica serves (one module, its weights
    shared); ``engine_config`` each replica's; ``stages`` the post-decode
    stages every replica runs (None: none); ``faults`` the registry of the
    router's sites, handed to every replica built or rebuilt (None: a
    fresh one); ``device`` the replicas' (the model's)."""

    def __init__(self, dalle, config: RouterConfig = RouterConfig(),
                 engine_config: EngineConfig = EngineConfig(),
                 clock: Optional[Clock] = None,
                 journal: Optional[RequestJournal] = None,
                 stages: Optional[StageSpec] = None, device="cuda",
                 faults: Optional[FaultRegistry] = None):
        assert config.n_replicas >= 1, config.n_replicas
        self.config = config
        self._lock = threading.RLock()
        self.clock = clock or Clock()
        self.faults = faults if faults is not None else FaultRegistry()
        self._dalle = dalle
        self._engine_config = engine_config
        self._stages = stages
        self._device = device
        # one RNG draws every backoff's jitter, seeded so schedules replay
        self._backoff_rng = random.Random(config.backoff_seed)
        self._journal = journal
        now = self.clock.now()
        self._replicas: List[_Replica] = [
            _Replica(i, self._build_engine(i), now) for i in range(config.n_replicas)
        ]
        self._queue: List[_RouterEntry] = []
        self.results: Dict[str, RequestResult] = {}
        self._outcome_counts: Dict[Outcome, int] = {o: 0 for o in Outcome}
        self._spans: Dict[str, Optional[int]] = {}
        self._live: set = set()
        self._seq = 0
        self._submitted = 0
        self._draining_fleet = False

    def _build_engine(self, rid: int) -> Engine:
        """One replica's engine, at construction and at every respawn: the
        same model, config, clock, fault registry and labels."""
        eng = Engine(self._dalle, self._engine_config, clock=self.clock, device=self._device,
                     stages=self._stages, faults=self.faults,
                     metric_labels={"replica": str(rid)},
                     fleet_occupancy=self.fleet_occupancy)
        if eng.postdecode is not None:
            # stage boundaries go to the journal and the failover state;
            # the pipeline steps inside engine.step(), under the lock
            eng.postdecode.on_stage = self._on_stage
        return eng

    # ------------------------------------------------------------ public

    def submit(self, request: Request) -> Optional[RequestResult]:
        """Queue a request with the fleet; same contract as
        ``Engine.submit`` — an immediate typed reject returns the result,
        otherwise None and the result lands in ``self.results``.
        Thread-safe: callable from serving threads while another thread
        drives ``run()``."""
        proto = self._replicas[0].engine
        if not (0 < request.max_new_tokens <= proto.dalle.image_seq_len):
            raise ValueError(
                f"max_new_tokens must be in [1, {proto.dalle.image_seq_len}], "
                f"got {request.max_new_tokens}"
            )
        with self._lock:
            if request.request_id in self.results or request.request_id in self._live:
                raise ValueError(f"duplicate request_id {request.request_id!r}")
            self._submitted += 1
            counters.inc("router.submitted")
            now = self.clock.now()
            self._spans[request.request_id] = TELEMETRY.begin(
                "router.request", request_id=request.request_id,
                priority=request.priority,
            )
            entry = _RouterEntry(request=request, seq=self._seq, submit_time=now)
            self._seq += 1
            live = [
                r for r in self._replicas if r.state is not ReplicaState.DEAD
            ]
            if not live:
                return self._reject_locked(entry, RejectReason.NO_REPLICA)
            # worst-case demand vs the LARGEST live pool: a request no
            # replica could ever hold is dead on arrival, fleet-wide
            worst = proto._worst_case_pages(request.max_new_tokens)
            if worst > max(r.engine.pool.total for r in live):
                return self._reject_locked(
                    entry, RejectReason.DEMAND_EXCEEDS_POOL
                )
            if len(self._queue) >= self.config.queue_limit:
                TELEMETRY.event(
                    "router.shed", request_id=request.request_id,
                    queued=len(self._queue),
                )
                counters.inc("router.shed")
                return self._reject_locked(entry, RejectReason.QUEUE_FULL)
            if self._journal is not None:
                # journal AFTER every typed-reject gate: the WAL holds
                # exactly the requests the fleet owes a terminal outcome
                self._journal.append_admitted(request, now)
            self._queue.append(entry)
            self._live.add(request.request_id)
            return None

    def submit_staged(self, request: Request, tokens,
                      image=None) -> Optional[RequestResult]:
        """Queue a request whose token work is already done — the crash
        replay resume path (``replay_unfinished(submit_staged=...)``): it
        dispatches straight into a replica's post-decode pipeline at the
        stage after its last journaled boundary. Same typed contract as
        ``submit``."""
        if self._stages is None:
            raise ValueError("router built without stages=StageSpec(...)")
        with self._lock:
            if request.request_id in self.results or request.request_id in self._live:
                raise ValueError(f"duplicate request_id {request.request_id!r}")
            self._submitted += 1
            counters.inc("router.submitted")
            now = self.clock.now()
            self._spans[request.request_id] = TELEMETRY.begin(
                "router.request", request_id=request.request_id,
                priority=request.priority,
            )
            entry = _RouterEntry(request=request, seq=self._seq,
                                 submit_time=now)
            self._seq += 1
            entry.staged["tokens"] = {
                "tokens": [int(t) for t in np.asarray(tokens).reshape(-1)]
            }
            if image is not None:
                entry.staged["vae_decode"] = {"image": image}
            live = [
                r for r in self._replicas if r.state is not ReplicaState.DEAD
            ]
            if not live:
                return self._reject_locked(entry, RejectReason.NO_REPLICA)
            # no page demand gate: staged work holds no kv pages
            if len(self._queue) >= self.config.queue_limit:
                TELEMETRY.event(
                    "router.shed", request_id=request.request_id,
                    queued=len(self._queue),
                )
                counters.inc("router.shed")
                return self._reject_locked(entry, RejectReason.QUEUE_FULL)
            if self._journal is not None:
                self._journal.append_admitted(request, now)
                # re-append the stage boundaries so THIS journal is
                # self-contained (idempotent: the loader keeps the last
                # record per stage)
                for stage, payload in entry.staged.items():
                    self._journal.append_stage(
                        request.request_id, stage, payload, now
                    )
            self._queue.append(entry)
            self._live.add(request.request_id)
            return None

    def cancel(self, request_id: str) -> None:
        """Cancel wherever the request currently lives: still queued at
        the router => terminal here next sweep; in flight on a replica =>
        forwarded to that engine (takes effect between its iterations)."""
        with self._lock:
            for entry in self._queue:
                if entry.request_id == request_id:
                    self._queue.remove(entry)
                    self._finish_locked(entry, RequestResult(
                        request_id=request_id, outcome=Outcome.CANCELLED,
                        total_latency_s=self.clock.now() - entry.submit_time,
                    ))
                    return
            for r in self._replicas:
                if r.state is not ReplicaState.DEAD and request_id in r.inflight:
                    r.engine.cancel(request_id)
                    return

    def drain(self, replica_id: int) -> None:
        """Graceful drain: stop admitting to the replica, let in-flight
        work finish, then retire it. Requests still queued at the router
        simply route to siblings (the ``can_admit`` dispatch gate means a
        replica's internal queue is already empty). Draining a
        RESPAWNING replica retires it immediately — its stale engine is
        already abandoned (nothing to finish) and a drain is operator
        retirement, so the pending respawn is cancelled rather than the
        dead engine re-activated."""
        with self._lock:
            r = self._replicas[replica_id]
            if r.state in (ReplicaState.DEAD, ReplicaState.DRAINING):
                return
            if r.state is ReplicaState.RESPAWNING:
                r.state = ReplicaState.DEAD
                r.respawn_at = None
                r.death_reason = "drained"
                counters.inc("router.drains")
                counters.inc("router.drained")
                TELEMETRY.event("router.drain", replica=r.id, inflight=0)
                TELEMETRY.event("router.drained", replica=r.id)
                return
            r.state = ReplicaState.DRAINING
            counters.inc("router.drains")
            TELEMETRY.event(
                "router.drain", replica=r.id, inflight=len(r.inflight),
            )

    def kill(self, replica_id: int, reason: str = "operator") -> None:
        """Declare a replica DEAD *now* and fail its in-flight work over
        to siblings — the abrupt form of ``drain`` (operator action or a
        test simulating a crash the fault registry didn't inject)."""
        with self._lock:
            r = self._replicas[replica_id]
            if r.state is not ReplicaState.DEAD:
                self._kill_locked(r, reason)

    def shutdown(self, snapshot_dir: Optional[str] = None,
                 max_steps: int = 10_000) -> None:
        """Graceful shutdown (the SIGTERM path): stop admissions fleet-wide,
        drive until the in-flight work finishes, then seal the journal
        and snapshot the richest prefix index to ``snapshot_dir``.
        Requests still queued are not flushed: they stay journaled
        unfinished, for the next process to replay."""
        with self._lock:
            self._draining_fleet = True
            for r in self._replicas:
                if r.state in (ReplicaState.HEALTHY, ReplicaState.DEGRADED):
                    r.state = ReplicaState.DRAINING
                    counters.inc("router.drains")
                    TELEMETRY.event(
                        "router.drain", replica=r.id,
                        inflight=len(r.inflight),
                    )
        steps = 0
        while True:
            with self._lock:
                busy = any(r.inflight for r in self._replicas)
            if not busy:
                break
            self.step()
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"shutdown drain made no progress in {max_steps} steps"
                )
        with self._lock:
            if snapshot_dir is not None:
                # snapshot the RICHEST non-empty index. A replica the
                # drain above just retired is eligible — "drained" means
                # its engine finished cleanly and its index is intact —
                # but crashed/corrupt engines are not, and an empty
                # index never overwrites an existing warm snapshot.
                candidates = [
                    r for r in self._replicas
                    if (
                        r.state not in _ENGINE_DOWN
                        or r.death_reason == "drained"
                    )
                    and r.engine.prefix is not None
                    and len(r.engine.prefix)
                ]
                if candidates:
                    best = max(
                        candidates, key=lambda r: len(r.engine.prefix)
                    )
                    best.engine.save_prefix_snapshot(snapshot_dir)
            if self._journal is not None:
                self._journal.seal()

    def live_requests(self) -> List[Request]:
        """Restorable descriptors of everything the fleet still owes a
        terminal outcome: router-queued requests (submission order) then
        per-replica in-flight ones — the crash-recovery export surface
        (journaled admissions already cover these; this is the
        journal-free export path and the invariant tests' oracle)."""
        with self._lock:
            queued = [
                e.request
                for e in sorted(self._queue, key=lambda e: e.seq)
            ]
            inflight = [
                entry.request
                for r in self._replicas
                for entry in sorted(
                    r.inflight.values(), key=lambda e: e.seq
                )
            ]
            return queued + inflight

    def step(self) -> bool:
        """One fleet scheduling iteration: fault injections -> router
        deadline sweep -> drive + harvest every live replica -> health
        checks -> retire finished drains -> dispatch -> all-dead flush.
        Returns False when the fleet is fully idle. The whole iteration
        runs under the router lock: concurrent ``submit``/``cancel``
        land between iterations, never inside one."""
        with self._lock:
            self._inject_faults_locked()
            self._sweep_queue_deadlines_locked()
            stepped = 0
            for r in self._replicas:
                if r.state in _ENGINE_DOWN:
                    continue
                if r.skip_steps > 0:
                    r.skip_steps -= 1   # injected stall: the engine hangs
                else:
                    r.engine.step()
                    stepped += 1
                self._harvest_locked(r)
            for r in self._replicas:
                if r.state not in _ENGINE_DOWN:
                    self._health_check_locked(r)
            self._respawn_sweep_locked()
            for r in self._replicas:
                if (
                    r.state is ReplicaState.DRAINING
                    and not r.inflight
                    and not any(r.engine.slots)
                    and not len(r.engine.sched)
                    and not getattr(r.engine, "postdecode", None)
                ):
                    r.state = ReplicaState.DEAD
                    r.death_reason = "drained"
                    counters.inc("router.drained")
                    TELEMETRY.event("router.drained", replica=r.id)
            self._dispatch_locked()
            # RESPAWNING replicas hold the flush: the fleet will come
            # back, so queued work WAITS instead of flushing typed (a
            # shutdown drain also holds it — queued work stays journaled
            # for the next incarnation to replay)
            if (
                all(r.state is ReplicaState.DEAD for r in self._replicas)
                and not self._draining_fleet
            ):
                self._flush_no_replica_locked()
            if stepped == 0:
                # every replica dead/stalled: time must still advance
                # (engine steps normally tick the shared clock) or
                # deadline sweeps and the stall heartbeat itself would
                # freeze with it
                self.clock.tick()
            self._publish_gauges_locked()
            return bool(self._queue) or any(
                r.inflight for r in self._replicas
            )

    def run(self, max_steps: Optional[int] = None) -> Dict[str, RequestResult]:
        """Drive until idle; ``max_steps`` is the same loud safety valve
        as ``Engine.run``."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                with self._lock:
                    raise RuntimeError(
                        f"router made no terminal progress in {max_steps} "
                        f"steps: {len(self._queue)} queued, "
                        f"{sum(len(r.inflight) for r in self._replicas)} "
                        f"in flight"
                    )
        with self._lock:
            return self.results

    def fleet_occupancy(self) -> float:
        """Aggregate page occupancy over LIVE replicas — capacity lost to
        a dead sibling raises the remaining fleet's pressure, which is
        what lets the watermark clamp degrade admissions fleet-wide.
        Locked: a monitoring thread must never read replica states and
        pool tallies mid-``step`` (reentrant for the engine's own
        mid-step callback — the RLock)."""
        with self._lock:
            live = [
                r for r in self._replicas if r.state not in _ENGINE_DOWN
            ]
            total = sum(r.engine.pool.total for r in live)
            if total == 0:
                return 1.0
            return sum(r.engine.pool.used for r in live) / total

    def replica_states(self) -> Dict[int, str]:
        with self._lock:
            return {r.id: r.state.value for r in self._replicas}

    def stats(self) -> dict:
        with self._lock:
            return {
                "submitted": self._submitted,
                "queued": len(self._queue),
                "fleet_occupancy": self.fleet_occupancy(),
                "outcomes": {
                    o.value: n for o, n in self._outcome_counts.items()
                },
                "replicas": {
                    r.id: {
                        "state": r.state.value,
                        "death_reason": r.death_reason,
                        "inflight": len(r.inflight),
                        "pool_occupancy": r.engine.pool.occupancy,
                        "breaker_trips": r.breaker_trips,
                        "respawns": r.respawns,
                    }
                    for r in self._replicas
                },
            }

    def verify_invariants(self) -> None:
        """Fleet-level accounting: every submitted request is live XOR has
        exactly one router result (none lost, none duplicated), the live
        set is exactly queue + in-flight, every live engine's own
        invariants hold, and every live engine's live requests are tracked
        by the router."""
        with self._lock:
            inflight_ids = set()
            for r in self._replicas:
                assert not (inflight_ids & set(r.inflight)), \
                    "request on two replicas"
                inflight_ids |= set(r.inflight)
            queued_ids = {e.request_id for e in self._queue}
            both = [rid for rid in self._live if rid in self.results]
            assert not both, f"request both live and finished: {sorted(both)}"
            assert len(self.results) + len(self._live) == self._submitted, (
                f"{self._submitted} submitted but {len(self.results)} results "
                f"+ {len(self._live)} live"
            )
            assert self._live == queued_ids | inflight_ids, (
                f"live {sorted(self._live)} != queued {sorted(queued_ids)} | "
                f"inflight {sorted(inflight_ids)}"
            )
            outcomes = self.stats()["outcomes"]
            assert sum(outcomes.values()) == len(self.results), outcomes
            for r in self._replicas:
                if r.state not in _ENGINE_DOWN:
                    r.engine.verify_invariants()
                    assert r.engine._live <= set(r.inflight), (
                        f"replica {r.id} serving untracked requests "
                        f"{sorted(r.engine._live - set(r.inflight))}"
                    )
                else:
                    assert not r.inflight, (
                        f"replica {r.id} is {r.state.value} but still "
                        f"tracks in-flight work {sorted(r.inflight)}"
                    )

    # ---------------------------------------------------------- injections

    def _inject_faults_locked(self) -> None:
        # eligibility is checked BEFORE take(): an armed fault with no
        # eligible victim stays armed for the next iteration instead of
        # being silently swallowed
        victim = self._busiest_live()
        if victim is not None and self.faults.take("replica_crash"):
            counters.inc("router.fault_replica_crash")
            self._kill_locked(victim, "crash")
            victim = self._busiest_live()
        if victim is not None and self.faults.take("replica_stall"):
            counters.inc("router.fault_replica_stall")
            victim.skip_steps += 1
        healthy = [
            r for r in self._replicas if r.state is ReplicaState.HEALTHY
        ]
        if healthy and self.faults.take("health_flap"):
            counters.inc("router.fault_health_flap")
            self._open_breaker_locked(healthy[0], "health_flap")

    def _busiest_live(self) -> Optional[_Replica]:
        live = [r for r in self._replicas if r.state not in _ENGINE_DOWN]
        if not live:
            return None
        return max(live, key=lambda r: (len(r.inflight), -r.id))

    # ------------------------------------------------------------- health

    def _health_check_locked(self, r: _Replica) -> None:
        # accounting invariant: a corrupt engine is dead NOW — routing
        # more work into it can only lose or duplicate requests
        try:
            r.engine.verify_invariants()
        except AssertionError as e:
            TELEMETRY.event(
                "router.invariant_violation", replica=r.id, detail=str(e)[:200]
            )
            self._kill_locked(r, "invariant_violation")
            return
        now = self.clock.now()
        # circuit breaker: consecutive prefill failures via counter deltas
        retries = counters.get("serve.prefill_retries", labels=r.labels)
        admits = counters.get("serve.admitted", labels=r.labels)
        d_retry = retries - r.seen_retries
        d_admit = admits - r.seen_admits
        r.seen_retries, r.seen_admits = retries, admits
        if d_admit > 0:
            r.breaker_consec = 0
            r.breaker_trips = 0  # a success closes the escalation ladder
        r.breaker_consec += d_retry
        if (
            r.state is ReplicaState.HEALTHY
            and r.breaker_consec >= self.config.breaker_threshold
        ):
            self._open_breaker_locked(r, "prefill_failures")
        # breaker readmission after backoff
        if (
            r.state is ReplicaState.DEGRADED
            and r.retry_at is not None
            and now >= r.retry_at
        ):
            r.state = ReplicaState.HEALTHY
            r.retry_at = None
            counters.inc("router.readmits")
            TELEMETRY.event(
                "router.readmit", replica=r.id, trips=r.breaker_trips
            )
        # step-progress heartbeat
        progress = r.progress_value()
        if progress != r.last_progress_val or not r.inflight:
            r.last_progress_val = progress
            r.last_progress_t = now
        elif now - r.last_progress_t > self.config.stall_timeout_s:
            self._kill_locked(r, "stall_timeout")

    def _open_breaker_locked(self, r: _Replica, reason: str) -> None:
        policy = self.config.breaker_backoff
        r.breaker_trips += 1
        r.breaker_consec = 0
        if r.breaker_trips > max(1, policy.attempts):
            self._kill_locked(r, "breaker_exhausted")
            return
        delay = policy.delay(r.breaker_trips - 1, self._backoff_rng)
        r.retry_at = self.clock.now() + delay
        r.state = ReplicaState.DEGRADED
        counters.inc("router.breaker_opens")
        TELEMETRY.event(
            "router.breaker_open", replica=r.id, reason=reason,
            trips=r.breaker_trips, retry_in_s=delay,
        )

    # ----------------------------------------------------------- failover

    def _kill_locked(self, r: _Replica, reason: str) -> None:
        """Declare a replica dead and fail its in-flight work over. The
        engine is abandoned like a dead host: unharvested results are
        lost; requeued requests replay from scratch on a sibling —
        bit-identically, by the (seed, position) sampling contract."""
        r.state = ReplicaState.DEAD
        r.death_reason = reason
        counters.inc("router.replica_deaths")
        now = self.clock.now()
        r.death_t = now
        if self.config.respawn:
            self._schedule_respawn_locked(r)
        TELEMETRY.event(
            "router.failover", replica=r.id, reason=reason,
            inflight=len(r.inflight),
        )
        for rid, entry in sorted(r.inflight.items(), key=lambda kv: kv[1].seq):
            entry.failovers += 1
            entry.crash_t0 = now
            if entry.failovers > self.config.max_failovers:
                self._finish_locked(entry, RequestResult(
                    request_id=rid, outcome=Outcome.PREEMPT_CAP,
                    preempt_count=entry.failovers,
                    total_latency_s=now - entry.submit_time,
                    detail=f"lost {entry.failovers} replicas "
                           f"(max_failovers {self.config.max_failovers})",
                ))
            else:
                self._queue.append(entry)
        r.inflight.clear()

    # ----------------------------------------------------------- respawn

    def _schedule_respawn_locked(self, r: _Replica) -> None:
        """DEAD -> RESPAWNING with an exponential-backoff rebuild time —
        or permanently DEAD once the ladder is exhausted. Jittered like
        the breaker (the shared seeded RNG): a correlated outage that
        kills N replicas at once must NOT schedule N rebuilds for the
        same instant, or the herd re-collides on respawn — with the
        default ``jitter=0.0`` the schedule is the historical
        deterministic one."""
        if r.respawns >= self.config.max_respawns:
            r.respawn_at = None
            r.death_reason = f"{r.death_reason} (respawns exhausted)"
            TELEMETRY.event(
                "router.respawn_fail", replica=r.id,
                attempts=r.respawns, exhausted=True,
            )
            return
        policy = self.config.respawn_backoff
        delay = policy.delay(r.respawns, self._backoff_rng)
        r.respawns += 1
        r.respawn_at = self.clock.now() + delay
        r.state = ReplicaState.RESPAWNING

    def _respawn_sweep_locked(self) -> None:
        """Attempt every due respawn: rebuild the engine from the same
        model and config and readmit the replica HEALTHY, re-baselining
        every health signal. The ``replica_respawn_fail`` fault fails
        the attempt — back to the backoff ladder (further out each
        time), permanently DEAD once exhausted."""
        if self._draining_fleet:
            return  # a draining fleet resurrects nobody
        now = self.clock.now()
        for r in self._replicas:
            if r.state is not ReplicaState.RESPAWNING:
                continue
            if r.respawn_at is None or now < r.respawn_at:
                continue
            if self.faults.take("replica_respawn_fail"):
                counters.inc("router.fault_replica_respawn_fail")
                TELEMETRY.event(
                    "router.respawn_fail", replica=r.id,
                    attempts=r.respawns, exhausted=False,
                )
                r.state = ReplicaState.DEAD
                self._schedule_respawn_locked(r)
                continue
            r.rebind(self._build_engine(r.id), now)
            counters.inc("router.respawns")
            recovery = None if r.death_t is None else now - r.death_t
            if recovery is not None:
                # kill -> healthy time to recover, per replica
                histograms.observe(
                    "serve.recovery_s", recovery, labels=r.labels
                )
            TELEMETRY.event(
                "router.respawn", replica=r.id, recovery_s=recovery,
            )

    def _flush_no_replica_locked(self) -> None:
        """Fleet fully dead: every queued request ends typed rather than
        hanging — the none-lost half of the accounting invariant."""
        hint = self._retry_after_locked(RejectReason.NO_REPLICA)
        for entry in list(self._queue):
            self._queue.remove(entry)
            counters.inc("router.no_replica")
            if hint is not None:
                histograms.observe("router.retry_after_s", hint)
            self._finish_locked(entry, RequestResult(
                request_id=entry.request_id, outcome=Outcome.REJECTED,
                reject_reason=RejectReason.NO_REPLICA,
                total_latency_s=self.clock.now() - entry.submit_time,
                retry_after_s=hint,
                detail="fleet has no live replica",
            ))

    def _retry_after_locked(
        self, reason: RejectReason,
    ) -> Optional[float]:
        """Backoff hint for a load-typed rejection
        (``RequestResult.retry_after_s``).
        QUEUE_FULL scales the breaker ladder's base delay by fleet
        occupancy (``retry_after_hint``); NO_REPLICA answers with the
        fleet's ACTUAL comeback time — the earliest pending respawn —
        falling back to one respawn-ladder rung when nothing is
        scheduled. DEMAND_EXCEEDS_POOL gets None: the demand can never
        fit, retrying is futile and hinting otherwise would invite a
        permanent retry loop."""
        if reason is RejectReason.QUEUE_FULL:
            policy = self.config.breaker_backoff
            return retry_after_hint(
                self.fleet_occupancy(),
                base_delay=policy.base_delay, max_delay=policy.max_delay,
            )
        if reason is RejectReason.NO_REPLICA:
            now = self.clock.now()
            pending = [
                r.respawn_at - now
                for r in self._replicas
                if r.state is ReplicaState.RESPAWNING
                and r.respawn_at is not None
            ]
            if pending:
                return max(0.0, min(pending))
            return self.config.respawn_backoff.base_delay
        return None

    # ----------------------------------------------------------- dispatch

    def _sweep_queue_deadlines_locked(self) -> None:
        now = self.clock.now()
        for entry in list(self._queue):
            d = entry.request.deadline
            if d is not None and now > d:
                self._queue.remove(entry)
                self._finish_locked(entry, RequestResult(
                    request_id=entry.request_id,
                    outcome=Outcome.DEADLINE_EXCEEDED,
                    total_latency_s=now - entry.submit_time,
                    detail="deadline passed in router queue",
                ))

    def _dispatch_locked(self) -> None:
        """Route queued work: head-of-line in (priority, FIFO) order to
        the least-loaded admittable HEALTHY replica. Strict head-of-line
        (nothing behind a stuck head goes first) for the scheduler's
        anti-starvation reason."""
        # one sort per pass: nothing is appended to the queue while this
        # loop runs (submits and failover requeues happen between steps)
        self._queue.sort(key=lambda e: (-e.request.priority, e.seq))
        while self._queue:
            entry = self._queue[0]
            # a staged entry (completed stage payloads from the journal or
            # a dead replica) resumes INSIDE a pipeline, not a slot — its
            # admission gate and submit path differ
            staged = "tokens" in entry.staged
            candidates = [
                r for r in self._replicas
                if r.state is ReplicaState.HEALTHY
                and (
                    r.engine.can_admit_staged(entry.request) if staged
                    else r.engine.can_admit(entry.request)
                )
            ]
            if not candidates:
                return
            r = max(candidates, key=lambda c: (c.engine.pool.free, -c.id))
            self._queue.pop(0)
            now = self.clock.now()
            if entry.crash_t0 is not None:
                latency = now - entry.crash_t0
                histograms.observe("router.failover_latency_s", latency)
                counters.inc("router.failovers")
                TELEMETRY.event(
                    "router.failover_dispatch",
                    request_id=entry.request_id, replica=r.id,
                    latency_s=latency, failovers=entry.failovers,
                )
                entry.crash_t0 = None
            if staged:
                img = entry.staged.get("vae_decode")
                rejected = r.engine.submit_staged(
                    entry.request,
                    np.asarray(entry.staged["tokens"]["tokens"], np.int32),
                    image=None if img is None else img["image"],
                )
            else:
                rejected = r.engine.submit(entry.request)
            if rejected is not None:
                # can_admit said yes but the engine refused — surface the
                # engine's typed reason rather than hiding a router bug
                self._finish_locked(entry, rejected)
                continue
            r.inflight[entry.request_id] = entry

    # ------------------------------------------------------------ harvest

    def _harvest_locked(self, r: _Replica) -> None:
        for rid in list(r.inflight):
            res = r.engine.results.get(rid)
            if res is None:
                continue
            entry = r.inflight.pop(rid)
            if entry.failovers:
                res.detail = (
                    f"{res.detail} (failovers={entry.failovers})".strip()
                )
            self._finish_locked(entry, res)

    # ----------------------------------------------------------- plumbing

    def _reject_locked(self, entry: _RouterEntry, reason: RejectReason) -> RequestResult:
        hint = self._retry_after_locked(reason)
        if hint is not None:
            histograms.observe("router.retry_after_s", hint)
        result = RequestResult(
            request_id=entry.request_id,
            outcome=Outcome.REJECTED,
            reject_reason=reason,
            total_latency_s=0.0,
            retry_after_s=hint,
        )
        self._finish_locked(entry, result)
        return result

    def _on_stage(self, request_id: str, stage: str, payload: dict) -> None:
        """Stage-boundary sink for every replica pipeline: journal the
        record durably (crash replay) and mirror it onto the in-flight
        entry (replica failover). Called from inside ``engine.step()``,
        which already holds the router lock — the RLock re-entry is
        free."""
        with self._lock:
            if self._journal is not None:
                self._journal.append_stage(
                    request_id, stage, payload, self.clock.now()
                )
            for r in self._replicas:
                entry = r.inflight.get(request_id)
                if entry is not None:
                    entry.staged[stage] = payload
                    break

    def _finish_locked(self, entry: _RouterEntry, result: RequestResult) -> None:
        assert entry.request_id not in self.results, (
            f"duplicate terminal result for {entry.request_id!r}"
        )
        self._live.discard(entry.request_id)
        self.results[entry.request_id] = result
        if self._journal is not None:
            # the completion record that makes crash replay idempotent
            self._journal.append_outcome(
                entry.request_id, result.outcome.value, self.clock.now()
            )
        self._outcome_counts[result.outcome] += 1
        counters.inc(f"router.{result.outcome.value}")
        TELEMETRY.end(
            self._spans.pop(entry.request_id, None),
            outcome=result.outcome.value,
            reject_reason=(
                None if result.reject_reason is None
                else result.reject_reason.value
            ),
            failovers=entry.failovers,
        )

    def _publish_gauges_locked(self) -> None:
        gauges.set("router.queued", len(self._queue))
        gauges.set("router.fleet_occupancy", self.fleet_occupancy())
        gauges.set("router.replicas_live", sum(
            r.state not in _ENGINE_DOWN for r in self._replicas
        ))
        for r in self._replicas:
            gauges.set(
                "router.replica_state_code", _STATE_CODE[r.state],
                labels=r.labels,
            )
