"""The port's fused serving engine against the JAX package's fused engine
on the CPU: the tiny DALLE of test_torch_dalle.py on converted weights,
EngineConfig(fused_iteration=True, prefill_chunk=2, max_batch=2), three
requests with different budgets (one queues behind the other two). With
``filter_thres`` set so that top-k keeps one logit, sampling is greedy and
no longer depends on either framework's random bits, so the token lists
must be IDENTICAL. Port-only checks: the same seeds replay the same
tokens, deadlines and cancellation end typed, the JAX engine's options
that have no field here are a TypeError, and the fused iteration without
chunks is a ValueError, as in JAX. Int8 pages, page pressure and the
sparse configuration are held by test_torch_kv_quant.py,
test_torch_preemption.py and test_torch_sparse_serve.py; the split path
by test_torch_split_engine.py, faults and retries by
test_torch_engine_faults.py."""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Outcome as JOutcome
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from test_torch_dalle import PAGE, tiny_models

torch.set_num_threads(1)

GREEDY = 0.99  # k = max(int(0.01 * 42 total tokens), 1) = 1
BUDGETS = (5, 16, 9)


def _prompt(i):
    p = np.random.RandomState(100 + i).randint(1, 16, size=(6,)).astype(np.int32)
    p[4 + i % 2:] = 0  # padded tails: per-position pad ids
    return p


def _run_port(model, filter_thres, lookahead=True, seeds=(0, 1, 2)):
    eng = Engine(model, EngineConfig(
        max_batch=2, fused_iteration=True, prefill_chunk=2, page_size=PAGE,
        filter_thres=filter_thres, decode_lookahead=lookahead,
    ), clock=FakeClock(step_dt=1.0), device="cpu")
    for i, n in enumerate(BUDGETS):
        assert eng.submit(Request(f"r{i}", _prompt(i), n, seed=seeds[i])) is None
    return eng.run(max_steps=500)


@pytest.mark.parametrize("lookahead", [True, False], ids=["lookahead", "sync"])
def test_greedy_tokens_identical_to_jax_engine(monkeypatch, lookahead):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    jmodel, params, model = tiny_models()
    jeng = JEngine(jmodel, params, JEngineConfig(
        max_batch=2, fused_iteration=True, prefill_chunk=2,
        filter_thres=GREEDY, decode_lookahead=lookahead,
    ), clock=JFakeClock(step_dt=1.0))
    for i, n in enumerate(BUDGETS):
        assert jeng.submit(JRequest(f"r{i}", _prompt(i), n, seed=i)) is None
    ref = jeng.run(max_steps=500)
    got = _run_port(model, GREEDY, lookahead)
    for i, n in enumerate(BUDGETS):
        r = f"r{i}"
        assert ref[r].outcome is JOutcome.COMPLETED
        assert got[r].outcome is Outcome.COMPLETED
        assert len(got[r].tokens) == n
        np.testing.assert_array_equal(got[r].tokens, ref[r].tokens, err_msg=r)


def test_same_seeds_replay_same_tokens():
    _, _, model = tiny_models()
    a = _run_port(model, filter_thres=0.5)
    b = _run_port(model, filter_thres=0.5)
    c = _run_port(model, filter_thres=0.5, seeds=(7, 8, 9))
    for r in a:
        assert a[r].outcome is Outcome.COMPLETED
        np.testing.assert_array_equal(a[r].tokens, b[r].tokens)
        assert ((0 <= a[r].tokens) & (a[r].tokens < model.num_image_tokens)).all()
    assert any(not np.array_equal(a[r].tokens, c[r].tokens) for r in a)


def test_deadline_and_cancel_end_typed():
    _, _, model = tiny_models()
    eng = Engine(model, EngineConfig(
        max_batch=2, fused_iteration=True, prefill_chunk=2, page_size=PAGE,
    ), clock=FakeClock(step_dt=1.0), device="cpu")
    eng.submit(Request("late", _prompt(0), 16, deadline=6.0))
    eng.submit(Request("gone", _prompt(1), 16))
    eng.submit(Request("queued", _prompt(2), 16))
    eng.submit(Request("ok", _prompt(0), 3))
    for _ in range(3):
        eng.step()
    eng.cancel("gone")
    eng.cancel("queued")
    res = eng.run(max_steps=500)
    assert res["late"].outcome is Outcome.DEADLINE_EXCEEDED
    assert res["gone"].outcome is Outcome.CANCELLED
    assert res["queued"].outcome is Outcome.CANCELLED and res["queued"].tokens is None
    assert res["ok"].outcome is Outcome.COMPLETED and len(res["ok"].tokens) == 3
    assert not any(eng.slots) and eng.pool.used == 0


@pytest.mark.parametrize("kwargs,error", [
    (dict(cost_ledger=True), NotImplementedError), (dict(spec_decode=True, spec_k=0), ValueError),
    # the prefix cache, vitals and the controller are ported; the cost
    # ledger stays refused whatever comes with it
    (dict(prefix_cache=True, controller=True, cost_ledger=True), NotImplementedError),
    (dict(vitals=True, cost_ledger=True), NotImplementedError),
    (dict(prefill_chunk=None), ValueError), (dict(prefill_chunk=1), ValueError),
], ids=["cost_ledger", "spec_decode", "prefix_cache", "vitals", "fused_unchunked",
        "chunk_of_one"])
def test_unported_engine_options_raise(kwargs, error):
    _, _, model = tiny_models()
    with pytest.raises(error):
        Engine(model, EngineConfig(**{"fused_iteration": True, "prefill_chunk": 2,
                                      "page_size": PAGE, **kwargs}), device="cpu")
