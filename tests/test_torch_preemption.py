"""The port's fused engine under page pressure (``serving/engine.py``:
``_alloc_or_preempt``, ``_pick_victim``, ``_preempt``, the watermark
clamp; ``serving/scheduler.py``: preemption aging) against the JAX
package's fused engine on the CPU, on the tiny float32 DALLE of
test_torch_dalle.py (prompt 7 positions, 16 image tokens, page 4, so a
slot's whole sequence takes 6 pages), max_batch 2, prefill chunk 2.

- Natural exhaustion (JAX's ``test_natural_exhaustion_under_tight_pool``):
  a page budget of 8 admits two requests whose decode growth then wants
  12 pages; the port preempts the same requests as many times as JAX,
  every outcome and greedy token list is JAX's, unquantized and int8.
- Replay: a preempted request re-prefills from scratch and its tokens
  are BITWISE equal to the same requests served without pressure (top-k
  sampling with the seeded noise, so the draw matters), unquantized and
  int8.
- Victim order: lowest effective priority first, then the youngest
  admission; the queue ages a preempted request by its boost (pop order
  equal to JAX's ``Scheduler``).
- ``max_preemptions=0`` ends the first victim ``PREEMPT_CAP`` with its
  read-back tokens, as JAX does; the watermark clamp reports the same
  ``clamped_max_new_tokens`` as JAX.
- Every page is back in the pool at the end.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.serving import Scheduler as JScheduler
from dalle_pytorch_tpu.serving.scheduler import Entry as JEntry
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.scheduler import Entry, Scheduler
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import GREEDY, _prompt

torch.set_num_threads(1)

TIGHT = 8  # pages: two admitted requests' growth to 12 pages collides
MAX_NEW = (16, 16, 9)


@pytest.fixture
def models(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    return tiny_models()


def _config(**kw):
    return {"max_batch": 2, "prefill_chunk": 2, "filter_thres": GREEDY, **kw}


def _port(model, requests, **kw):
    eng = Engine(model, EngineConfig(page_size=PAGE, fused_iteration=True, **_config(**kw)),
                 clock=FakeClock(step_dt=1.0), device="cpu")
    for rid, n, prio in requests:
        assert eng.submit(Request(rid, _prompt(int(rid[1:])), n, priority=prio,
                                  seed=int(rid[1:]))) is None
    return eng


def _jax(jmodel, params, requests, **kw):
    eng = JEngine(jmodel, params, JEngineConfig(fused_iteration=True, **_config(**kw)),
                  clock=JFakeClock(step_dt=1.0))
    for rid, n, prio in requests:
        assert eng.submit(JRequest(rid, _prompt(int(rid[1:])), n, priority=prio,
                                   seed=int(rid[1:]))) is None
    return eng


def _summary(results):
    """{request: (outcome, preempt count, clamp, tokens)} comparable
    across the two packages."""
    return {
        rid: (r.outcome.value, r.preempt_count, r.clamped_max_new_tokens,
              None if r.tokens is None else [int(t) for t in r.tokens])
        for rid, r in results.items()
    }


def _requests(max_new=MAX_NEW, prio=(0, 0, 0)):
    return [(f"r{i}", n, p) for i, (n, p) in enumerate(zip(max_new, prio))]


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["none", "int8"])
def test_natural_exhaustion_matches_jax(models, kv_quant):
    jmodel, params, model = models
    eng = _port(model, _requests(), page_budget=TIGHT, kv_quant=kv_quant)
    got = _summary(eng.run(max_steps=1000))
    ref = _summary(_jax(jmodel, params, _requests(), page_budget=TIGHT,
                        kv_quant=kv_quant).run(max_steps=1000))
    assert got == ref
    assert sum(p for _, p, _, _ in got.values()) >= 1
    assert all(o == Outcome.COMPLETED.value for o, *_ in got.values())
    assert eng.pool.used == 0 and not any(eng.slots)


@pytest.mark.parametrize("kv_quant", [None, "int8"], ids=["none", "int8"])
def test_preempted_replay_bitwise_equal_unpressured(models, kv_quant):
    _, _, model = models
    runs = {}
    for budget in (None, TIGHT):
        eng = _port(model, _requests(), page_budget=budget, kv_quant=kv_quant,
                    filter_thres=0.5)
        runs[budget] = eng.run(max_steps=1000)
        assert eng.pool.used == 0
    assert sum(r.preempt_count for r in runs[TIGHT].values()) >= 1
    assert all(r.preempt_count == 0 for r in runs[None].values())
    for rid, r in runs[TIGHT].items():
        assert r.outcome is Outcome.COMPLETED
        np.testing.assert_array_equal(r.tokens, runs[None][rid].tokens, err_msg=rid)


@pytest.mark.parametrize("prio,victim", [((0, 1), "r0"), ((0, 0), "r1")],
                         ids=["low_priority_first", "then_youngest"])
def test_victim_order_matches_jax(models, prio, victim):
    """r0 is admitted first, r1 one iteration later; when their growth
    collides, r0 dies if its priority is lower, else r1, the younger."""
    jmodel, params, model = models
    summaries = []
    for build in (lambda r, **kw: _port(model, r, **kw),
                  lambda r, **kw: _jax(jmodel, params, r, **kw)):
        reqs = _requests((16, 16), prio)
        eng = build(reqs[:1], page_budget=TIGHT)
        eng.step()  # r0 holds a slot before r1 arrives
        req = reqs[1]
        if isinstance(eng, Engine):
            eng.submit(Request(req[0], _prompt(1), req[1], priority=req[2], seed=1))
        else:
            eng.submit(JRequest(req[0], _prompt(1), req[1], priority=req[2], seed=1))
        summaries.append(_summary(eng.run(max_steps=1000)))
    got, ref = summaries
    assert got == ref
    assert got[victim][1] >= 1
    assert all(p == 0 for rid, (_, p, _, _) in got.items() if rid != victim)


def test_preemption_ages_priority_like_jax():
    """e0 (priority 2) is popped, evicted once and requeued: with a boost
    of 2 it goes ahead of e3 (priority 3). Requeued entries do not count
    against the queue bound of 3 fresh entries. Pop order equals JAX's."""
    order = {}
    for sched_cls, entry_cls, req_cls, key in ((Scheduler, Entry, Request, "port"),
                                               (JScheduler, JEntry, JRequest, "jax")):
        sched = sched_cls(queue_limit=3, preempt_priority_boost=2)
        entries = [entry_cls(request=req_cls(f"e{i}", _prompt(0), 4, priority=p),
                             submit_time=0.0, seq=i)
                   for i, p in enumerate((2, 3, 1, 3, 0, 0))]
        for e in entries[:3]:
            assert sched.submit(e)
        assert [sched.pop().request_id for _ in range(2)] == ["e1", "e0"]
        entries[0].preempt_count = 1
        sched.requeue(entries[0])
        assert sched.effective_priority(entries[0]) == 4
        assert sched.submit(entries[3]) and sched.submit(entries[4])
        assert not sched.submit(entries[5])
        order[key] = [sched.pop().request_id for _ in range(len(sched))]
    assert order["port"] == order["jax"] == ["e0", "e3", "e2", "e4"]


def test_preempt_cap_at_zero_matches_jax(models):
    jmodel, params, model = models
    eng = _port(model, _requests(), page_budget=TIGHT, max_preemptions=0)
    got = _summary(eng.run(max_steps=1000))
    ref = _summary(_jax(jmodel, params, _requests(), page_budget=TIGHT,
                        max_preemptions=0).run(max_steps=1000))
    assert got == ref
    capped = [rid for rid, (o, *_) in got.items() if o == Outcome.PREEMPT_CAP.value]
    assert len(capped) >= 1 and all(got[r][1] == 1 for r in capped)
    assert eng.pool.used == 0


def test_watermark_clamp_matches_jax(models):
    """Any occupancy counts as pressure: the first request is admitted
    into an empty pool unclamped, the second sees the first's pages and is
    clamped to 2 tokens, and says so."""
    jmodel, params, model = models
    reqs = _requests((4, 4), (0, 0))
    kw = dict(high_watermark=0.0, degraded_max_new_tokens=2)
    eng = _port(model, reqs, **kw)
    got = _summary(eng.run(max_steps=1000))
    assert got == _summary(_jax(jmodel, params, reqs, **kw).run(max_steps=1000))
    assert sorted(c for _, _, c, _ in got.values() if c is not None) == [2]
    assert sorted(len(t) for *_, t in got.values()) == [2, 4]
    assert eng.pool.used == 0
