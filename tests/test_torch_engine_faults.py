"""Prefill retries and the engine's fault sites (``utils/faults.py``:
``prefill_fail``, ``page_exhaust``, ``decode_stall``, ``request_cancel``)
on both of the port's engine paths, against the JAX package's engine
with its process-wide ``FAULTS`` armed the same way (reset around every
test), on the CPU, on the tiny float32 DALLE of test_torch_dalle.py,
greedy sampling. Paths: split with monolithic prefill, split with chunks
of 2, fused with chunks of 2. Each case's outcomes, preempt counts,
prefill attempts and tokens equal JAX's, and:

- ``prefill_fail`` once: the request is retried, its tokens are those of
  the unfaulted run, ``prefill_attempts == 1``;
- ``prefill_fail`` past ``prefill_attempts``: ``PREFILL_FAILED``, no
  tokens, the pool empty and every slot free;
- a chunk that fails mid-prompt is retried from the last completed
  chunk: no completed chunk runs again (the same dispatches as the
  unfaulted run), the tokens are the unfaulted run's (as JAX's
  ``tests/test_chunked_prefill.py`` holds);
- ``page_exhaust`` preempts a request, whose replay gives the unfaulted
  tokens;
- ``decode_stall`` pushes a request past its deadline;
- ``request_cancel`` cancels the youngest running request.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.utils.faults import FaultRegistry
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import GREEDY, _prompt

torch.set_num_threads(1)

PATHS = {
    "split": dict(fused_iteration=False, prefill_chunk=None),
    "split_chunked": dict(fused_iteration=False, prefill_chunk=2),
    "fused": dict(fused_iteration=True, prefill_chunk=2),
}


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(autouse=True)
def jax_faults(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    FAULTS.reset()
    yield
    FAULTS.reset()


def _summary(results):
    return {
        rid: (r.outcome.value, r.preempt_count, r.prefill_attempts,
              None if r.tokens is None else [int(t) for t in r.tokens])
        for rid, r in results.items()
    }


def _run(engine, requests, req_cls, steps=None):
    for i, (n, deadline) in enumerate(requests):
        assert engine.submit(req_cls(f"r{i}", _prompt(i), n, deadline=deadline, seed=i)) is None
    for _ in range(steps or 0):
        engine.step()
    return engine.run(max_steps=1000)


def port(model, path, requests, arm=(), clock=None, **kw):
    """(summary, engine) of a port run with ``arm`` ((site, count), ...)
    on its own registry."""
    faults = FaultRegistry()
    for site, count in arm:
        faults.arm(site, count)
    eng = Engine(model, EngineConfig(max_batch=2, page_size=PAGE, filter_thres=GREEDY,
                                     **PATHS[path], **kw),
                 clock=clock or FakeClock(step_dt=1.0), device="cpu", faults=faults)
    return _summary(_run(eng, requests, Request)), eng


def jax(jmodel, params, path, requests, arm=(), clock=None, **kw):
    FAULTS.reset()
    for site, count in arm:
        FAULTS.arm(site, count)
    eng = JEngine(jmodel, params, JEngineConfig(max_batch=2, filter_thres=GREEDY,
                                                **PATHS[path], **kw),
                  clock=clock or JFakeClock(step_dt=1.0))
    return _summary(_run(eng, requests, JRequest))


def both(models, path, requests, arm=(), clock=None, jclock=None, **kw):
    jmodel, params, model = models
    got, eng = port(model, path, requests, arm, clock, **kw)
    fired = dict(eng.faults.fired)
    assert got == jax(jmodel, params, path, requests, arm, jclock, **kw)
    assert fired == dict(FAULTS.fired)
    return got, eng


REQUESTS = [(6, None), (9, None)]


@pytest.mark.parametrize("path", PATHS)
def test_prefill_fail_once_is_retried(models, path):
    clean, _ = port(models[2], path, REQUESTS)
    got, eng = both(models, path, REQUESTS, arm=[("prefill_fail", 1)])
    assert eng.faults.fired == {"prefill_fail": 1}
    assert got["r0"][2] == 1 and got["r1"][2] == 0
    for rid, (outcome, preempts, attempts, tokens) in got.items():
        assert outcome == Outcome.COMPLETED.value
        assert tokens == clean[rid][3]
    assert eng.pool.used == 0 and not any(eng.slots)


@pytest.mark.parametrize("path", PATHS)
def test_prefill_fail_exhausts_attempts_typed(models, path):
    got, eng = both(models, path, REQUESTS[:1], arm=[("prefill_fail", 5)],
                    prefill_attempts=2)
    outcome, _, attempts, tokens = got["r0"]
    assert outcome == Outcome.PREFILL_FAILED.value and attempts == 2 and tokens is None
    assert eng.faults.fired == {"prefill_fail": 2}
    assert eng.pool.used == 0 and not any(eng.slots)


@pytest.mark.parametrize("path", ["split_chunked", "fused"])
def test_chunk_fault_resumes_from_last_completed_chunk(models, path):
    """token_budget=1: one chunk an iteration (the forward-progress floor);
    the 7-position prompt runs as 2-2-3 (split) or 2-2-2-1 (fused)."""
    model = models[2]
    clean, clean_eng = port(model, path, REQUESTS[:1], token_budget=1)
    faults = FaultRegistry()
    eng = Engine(model, EngineConfig(max_batch=2, page_size=PAGE, filter_thres=GREEDY,
                                     token_budget=1, **PATHS[path]),
                 clock=FakeClock(step_dt=1.0), device="cpu", faults=faults)
    assert eng.submit(Request("r0", _prompt(0), 6, seed=0)) is None
    eng.step()
    eng.step()
    slot = next(s for s in eng.slots if s)
    assert slot.phase == "prefill" and slot.filled == 4
    faults.arm("prefill_fail", 1)
    eng.step()  # the chunk at 4 fails
    assert faults.fired == {"prefill_fail": 1} and slot.filled == 4
    res = eng.run(max_steps=200)["r0"]
    assert res.outcome is Outcome.COMPLETED and res.prefill_attempts == 1
    np.testing.assert_array_equal(res.tokens, clean["r0"][3])
    # resumed, not restarted: no completed chunk ran again
    assert eng.dispatches == clean_eng.dispatches
    assert eng.pool.used == 0 and not any(eng.slots)


@pytest.mark.parametrize("path", PATHS)
def test_page_exhaust_forces_a_preemption(models, path):
    requests = [(16, None), (16, None)]
    clean, _ = port(models[2], path, requests)
    got, eng = both(models, path, requests, arm=[("page_exhaust", 1)])
    assert eng.faults.fired == {"page_exhaust": 1}
    assert sum(p for _, p, _, _ in got.values()) == 1
    for rid, (outcome, _, _, tokens) in got.items():
        assert outcome == Outcome.COMPLETED.value and tokens == clean[rid][3]
    assert eng.pool.used == 0


@pytest.mark.parametrize("path", PATHS)
def test_decode_stall_pushes_past_deadline(models, path):
    """Only the stall moves the clock (step_dt 0)."""
    got, eng = both(models, path, [(16, 5.0)], arm=[("decode_stall", 1)],
                    clock=FakeClock(step_dt=0.0), jclock=JFakeClock(step_dt=0.0),
                    stall_penalty_s=10.0)
    assert got["r0"][0] == Outcome.DEADLINE_EXCEEDED.value
    assert eng.clock.now() == 10.0 and eng.pool.used == 0


@pytest.mark.parametrize("path", PATHS)
def test_request_cancel_cancels_youngest_running(models, path):
    got, eng = both(models, path, REQUESTS, arm=[("request_cancel", 1)])
    assert [rid for rid, (o, *_) in got.items() if o == Outcome.CANCELLED.value] == ["r1"]
    assert got["r0"][0] == Outcome.COMPLETED.value
    assert eng.pool.used == 0 and not any(eng.slots)


def test_registry_counts_down_and_refuses_unknown_sites():
    faults = FaultRegistry()
    assert faults.value("page_exhaust") is None and not faults.take("page_exhaust")
    faults.arm("page_exhaust", 2)
    assert [faults.take("page_exhaust") for _ in range(3)] == [True, True, False]
    assert faults.fired == {"page_exhaust": 2} and faults.value("page_exhaust") == 0
    faults.reset()
    assert faults.fired == {} and faults.value("page_exhaust") is None
    with pytest.raises(ValueError):  # JAX's download site: the port fetches nothing
        faults.arm("download")
