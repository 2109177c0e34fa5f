"""The port's router against the JAX package's on the CPU: JAX's respawn,
restart and export cases (``tests/test_recovery.py``, ``TestRespawn``
and ``TestRestartReplay``), run on both packages with the same requests
and fault schedule and compared whole (the harness and its summary:
test_torch_router.py), on JAX's recovery configuration: respawn on,
chunks of 2.

Also: a process "crash" (the journal closed unsealed) whose journal the
other package's router replays (the restart crosses packages both ways),
and a staged fleet (VAE and CLIP stages) that loses a replica after a
request's tokens completed: the request fails over into the sibling's
pipeline (``submit_staged``) and decodes nothing again, its tokens and
image bitwise the clean run's."""

import json

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import journal as jjournal
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu_torch.serving import journal as pjournal
from dalle_pytorch_tpu_torch.serving.engine import EngineConfig
from dalle_pytorch_tpu_torch.serving.postdecode import StageSpec
from dalle_pytorch_tpu_torch.serving.router import Router, RouterConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_postdecode import GREEDY as STAGED_GREEDY
from test_torch_postdecode import staged_models
from test_torch_prefix_snapshot import PAGE, recovery_models
from test_torch_router import Side, accounting_holds, drive, prompt, run_case, summary

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


def journal_mod(side):
    return jjournal if side.kind == "jax" else pjournal


def make_router(side, n=2, journal=None, router_kw=None, **eng_kw):
    eng_kw.setdefault("prefill_chunk", 2)
    return side.router(n=n, journal=journal, router_kw=dict(respawn=True, **(router_kw or {})),
                       **eng_kw)


def reference_tokens(side, requests):
    eng = side.engine(prefill_chunk=2)
    for r in requests:
        assert eng.submit(r) is None
    return {rid: [int(t) for t in res.tokens] for rid, res in eng.run(max_steps=2000).items()}


# ---------------------------------------------------------------- respawn


def case_killed_replica_respawns_and_serves_bit_identical(side):
    requests = [side.req(i, seed=40 + i) for i in range(4)]
    ref = reference_tokens(side, requests)
    router = make_router(side)
    for r in requests:
        assert router.submit(r) is None
    traj = drive(router, 3000, on_step=lambda s: s == 3 and side.arm(router, "replica_crash", 1))
    for _ in range(40):
        router.step()
    router.verify_invariants()
    assert side.counters.get("router.respawns") == 1
    assert set(router.replica_states().values()) == {"healthy"}
    for r in requests:
        res = router.results[r.request_id]
        assert res.outcome is side.Outcome.COMPLETED
        assert [int(t) for t in res.tokens] == ref[r.request_id]
    assert router.submit(side.req(9, seed=99)) is None
    drive(router, 2000, trajectory=traj)
    assert router.results["r9"].outcome is side.Outcome.COMPLETED
    router.verify_invariants()
    return summary(side, router, traj)


def case_respawning_holds_queue_until_fleet_returns(side):
    router = make_router(side, n=1)
    router.kill(0, reason="test_crash")
    assert router.replica_states()[0] == "respawning"
    assert router.submit(side.req(0, seed=5)) is None
    traj = drive(router, 3000)
    assert router.results["r0"].outcome is side.Outcome.COMPLETED
    assert side.counters.get("router.respawns") >= 1
    router.verify_invariants()
    return summary(side, router, traj)


def case_respawn_fail_backs_off_then_exhausts_typed(side):
    router = make_router(side, n=1, router_kw=dict(
        max_respawns=2, respawn_backoff=side.policy(attempts=3, base_delay=0.2, max_delay=5.0)))
    side.arm(router, "replica_respawn_fail", 5)
    router.kill(0, reason="test_crash")
    traj = [(0, router.replica_states())]
    for i in range(200):
        router.step()
        if router.replica_states() != traj[-1][1]:
            traj.append((i + 1, router.replica_states()))
    assert router.replica_states()[0] == "dead"
    assert side.counters.get("router.fault_replica_respawn_fail") == 2
    assert "respawns exhausted" in router.stats()["replicas"][0]["death_reason"]
    result = router.submit(side.req(0))
    assert result is not None and result.outcome is side.Outcome.REJECTED
    return summary(side, router, traj)


def case_drain_of_respawning_replica_retires_it(side):
    router = make_router(side)
    for i in range(2):
        assert router.submit(side.req(i, seed=80 + i)) is None
    router.step()
    victim = max(router._replicas, key=lambda r: len(r.inflight)).id
    router.kill(victim, reason="test_crash")
    assert router.replica_states()[victim] == "respawning"
    router.drain(victim)
    assert router.replica_states()[victim] == "dead"
    assert router.stats()["replicas"][victim]["death_reason"] == "drained"
    traj = drive(router, 3000)
    for _ in range(40):
        router.step()
    router.verify_invariants()
    assert router.replica_states()[victim] == "dead"
    assert all(res.outcome is side.Outcome.COMPLETED for res in router.results.values())
    return summary(side, router, traj)


def case_drained_replica_is_retired_not_respawned(side):
    router = make_router(side)
    router.drain(0)
    for _ in range(90):
        router.step()
    assert router.replica_states()[0] == "dead"
    assert router.stats()["replicas"][0]["death_reason"] == "drained"
    return summary(side, router)


# -------------------------------------------------- restart and export


def case_restart_replays_unfinished_with_warm_hit(side, tmp_path):
    mod = journal_mod(side)
    jpath, snap = str(tmp_path / f"{side.kind}.jsonl"), str(tmp_path / f"{side.kind}_snap")
    crash = side.req(0, rid="crash", seed=61)
    ref = reference_tokens(side, [side.req(0, rid="crash", seed=61)])
    router = make_router(side, n=1, journal=mod.RequestJournal(jpath), prefix_cache=True)
    assert router.submit(side.req(0, seed=60)) is None
    drive(router, 2000)
    router._replicas[0].engine.save_prefix_snapshot(snap)
    assert router.submit(crash) is None
    router.step()
    router._journal.close()
    router2 = make_router(side, n=1, journal=mod.RequestJournal(jpath), prefix_cache=True)
    eng2 = router2._replicas[0].engine
    assert eng2.load_prefix_snapshot(snap)
    assert mod.replay_unfinished(jpath, router2.submit) == ["crash"]
    traj = drive(router2, 2000)
    router2.verify_invariants()
    res = router2.results["crash"]
    assert res.outcome is side.Outcome.COMPLETED
    assert [int(t) for t in res.tokens] == ref["crash"]
    assert eng2.prefix.stats.hits >= 1
    router2._journal.seal()
    assert mod.RequestJournal.unfinished(jpath) == []
    return dict(summary(side, router2, traj), first=summary(side, router))


def case_shutdown_flushes_snapshot_and_leaves_queue_journaled(side, tmp_path):
    mod = journal_mod(side)
    jpath, snap = str(tmp_path / f"{side.kind}.jsonl"), tmp_path / f"{side.kind}_snap"
    router = make_router(side, n=1, journal=mod.RequestJournal(jpath), prefix_cache=True,
                         max_batch=1)
    for i in range(3):
        assert router.submit(side.req(i, seed=70 + i)) is None
    router.step()
    router.shutdown(snapshot_dir=str(snap))
    assert router.results["r0"].outcome is side.Outcome.COMPLETED
    assert (snap / "COMMITTED").exists()
    nodes = json.loads((snap / "index.json").read_text())["nodes"]
    assert len(nodes) >= 1
    assert mod.RequestJournal.verify(jpath) == (True, "ok")
    assert sorted(r.request_id for r in mod.RequestJournal.unfinished(jpath)) == ["r1", "r2"]
    assert "r1" not in router.results and "r2" not in router.results
    router2 = make_router(side, n=1, journal=mod.RequestJournal(jpath), prefix_cache=True)
    assert router2._replicas[0].engine.load_prefix_snapshot(str(snap))
    assert sorted(mod.replay_unfinished(jpath, router2.submit)) == ["r1", "r2"]
    traj = drive(router2, 2000)
    assert all(router2.results[rid].outcome is side.Outcome.COMPLETED for rid in ("r1", "r2"))
    router2.verify_invariants()
    return dict(summary(side, router2, traj), first=summary(side, router),
                snapshot=[{k: v for k, v in n.items() if k != "content_sha256"} for n in nodes])


def case_live_requests_export(side):
    eng = side.engine(max_batch=1, prefill_chunk=2, queue_limit=4)
    for i in range(3):
        assert eng.submit(side.req(i)) is None
    eng.step()
    assert [r.request_id for r in eng.live_requests()] == ["r1", "r2", "r0"]
    router = make_router(side, n=1, max_batch=1)
    for i in range(3):
        assert router.submit(side.req(i)) is None
    router.step()
    live = [r.request_id for r in router.live_requests()]
    assert set(live) == {"r0", "r1", "r2"}
    traj = drive(router, 2000)
    assert router.live_requests() == []
    return dict(summary(side, router, traj), live=live)


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_router_respawn_case_matches_jax(models, name, tmp_path):
    fn = CASES[name]
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        port, jax_summary = run_case(models, lambda side: fn(side, tmp_path))
    else:
        port, jax_summary = run_case(models, fn)
    assert port == jax_summary


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restart_crosses_packages(models, tmp_path, writer):
    """One package's router admits two requests and dies mid-flight with
    one completed; the other package's router replays its journal: the
    finished request is reconciled, not rerun, and the unfinished one
    completes with the tokens of an uninterrupted run on either side."""
    sides = {k: Side(k, models) for k in ("port", "jax")}
    first, second = sides[writer], sides["port" if writer == "jax" else "jax"]
    jpath = str(tmp_path / "journal.jsonl")
    router = make_router(first, n=1, journal=journal_mod(first).RequestJournal(jpath),
                         max_batch=1)
    for i in range(2):
        assert router.submit(first.req(i, seed=30 + i)) is None
    while "r0" not in router.results:
        router.step()
    router._journal.close()
    assert "r1" not in router.results
    router2 = make_router(second, n=1, journal=journal_mod(second).RequestJournal(jpath))
    seen = {}
    replayed = journal_mod(second).replay_unfinished(jpath, router2.submit,
                                                     reconcile=seen.__setitem__)
    assert replayed == ["r1"] and seen == {"r0": "completed"}
    res = router2.run(max_steps=2000)["r1"]
    assert res.outcome.value == "completed"
    for side in sides.values():
        want = reference_tokens(side, [side.req(1, seed=31)])["r1"]
        assert [int(t) for t in res.tokens] == want
    assert [int(t) for t in router.results["r0"].tokens] == reference_tokens(
        second, [second.req(0, seed=30)])["r0"]
    router2._journal.seal()
    assert jjournal.RequestJournal.unfinished(jpath) == pjournal.RequestJournal.unfinished(jpath)
    assert pjournal.RequestJournal.unfinished(jpath) == []


@pytest.fixture(scope="module")
def stage_models():
    return staged_models()


def test_staged_failover_resumes_in_sibling_pipeline(stage_models):
    """A replica dies holding a request whose tokens are done (parked in
    its pipeline): the sibling takes it through ``submit_staged``, decodes
    nothing for it, and every result is bitwise the clean fleet's."""
    *_, dalle, vae, clip = stage_models

    def fleet():
        return Router(dalle, RouterConfig(n_replicas=2),
                      EngineConfig(max_batch=2, prefill_chunk=2, filter_thres=STAGED_GREEDY),
                      clock=FakeClock(step_dt=0.05), stages=StageSpec(vae, clip), device="cpu")

    reqs = [Request(f"r{i}", prompt(i), 4, seed=i) for i in range(3)]
    clean = fleet()
    for r in reqs:
        assert clean.submit(r) is None
    clean_res = clean.run(max_steps=2000)
    router = fleet()
    for r in reqs:
        assert router.submit(r) is None
    victim = None
    for _ in range(500):
        router.step()
        victim = next((rep for rep in router._replicas
                       if any("tokens" in e.staged for e in rep.inflight.values())), None)
        if victim is not None:
            break
    assert victim is not None, "no request reached the post-decode pipeline"
    staged_ids = [rid for rid, e in victim.inflight.items() if "tokens" in e.staged]
    sibling = router._replicas[1 - victim.id]
    calls = {"submit": [], "submit_staged": []}
    for name in calls:
        real = getattr(sibling.engine, name)

        def spy(request, *a, _real=real, _name=name, **kw):
            calls[_name].append(request.request_id)
            return _real(request, *a, **kw)

        setattr(sibling.engine, name, spy)
    router.kill(victim.id, "crash")
    res = router.run(max_steps=2000)
    accounting_holds(router)
    assert sorted(calls["submit_staged"]) == sorted(staged_ids)
    assert not set(calls["submit"]) & set(staged_ids)
    for rid in staged_ids:
        assert "failovers=1" in res[rid].detail
    for rid, r in res.items():
        assert r.outcome is Outcome.COMPLETED
        np.testing.assert_array_equal(r.tokens, clean_res[rid].tokens)
        assert np.array_equal(r.image, clean_res[rid].image)
        assert r.rerank_score == clean_res[rid].rerank_score
