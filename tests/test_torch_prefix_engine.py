"""The port's engine with the prefix cache (``EngineConfig(prefix_cache=
True)``, ``serving/engine.py``), full hits, against itself cold and
against the JAX package's engine, on the tiny float32 DALLE of
test_torch_dalle.py (prompt T = 7 internal positions, page 4: a prompt
fills one page and 3 rows of a second, so a full hit copies its partial
terminal page), max_batch 2, in three modes (split monolithic, split
chunked, fused; chunk 2) with unquantized and int8 pages:

- a full hit's tokens are BITWISE the cold run's (top-k 0.5 with the
  seeded noise, so the draw matters): its first token is drawn from the
  cold run's own terminal logits with the request's (seed, T) draw, and
  its decode runs over the mapped pages;
- a full hit runs no prefill (the model's prefill entry points are
  poisoned for the warm run), and costs no more dispatches than the cold
  run (fewer when chunked);
- the index survives the drain, charged to the pool under
  ``PREFIX_HOLDER``;
- with greedy sampling (top-k 1), the outcomes, tokens and every
  ``serve.prefix.*`` counter equal JAX's engine's over a publish round
  and a warm round mixing a full hit, a cold request and a partial hit.

Partial hits, copy-on-write and divergence: test_torch_prefix_engine_
partial.py; pressure, faults and invariants: test_torch_prefix_engine_
pressure.py.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.utils.metrics import counters as jcounters
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.serving.engine import PREFIX_HOLDER, Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import GREEDY, _prompt

torch.set_num_threads(1)

MODES = {
    "split_mono": {},
    "split_chunked": dict(prefill_chunk=2),
    "fused": dict(prefill_chunk=2, fused_iteration=True),
}
QUANTS = {"none": None, "int8": "int8"}
MAX_NEW = 16
PREFIX_COUNTERS = ("hits", "misses", "pages_hit", "cow_copies", "published", "pages_deduped",
                   "publish_skips", "evictions")


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(autouse=True)
def jax_pages(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))


def diverge_at(base, j):
    """A copy of ``base`` differing exactly at prompt index ``j``."""
    p = np.asarray(base).copy()
    p[j] = p[j] % 15 + 1
    return p


def req(i, rid=None, p=None, max_new=MAX_NEW, seed=None, cls=Request, **kw):
    return cls(rid or f"r{i}", _prompt(i) if p is None else p, max_new,
               seed=i if seed is None else seed, **kw)


def port_engine(model, filter_thres=0.5, **cfg):
    cfg = {"max_batch": 2, **cfg}
    return Engine(model, EngineConfig(page_size=PAGE, filter_thres=filter_thres, **cfg),
                  clock=FakeClock(step_dt=1.0), device="cpu")


def jax_engine(jmodel, params, **cfg):
    cfg = {"max_batch": 2, **cfg}
    return JEngine(jmodel, params, JEngineConfig(filter_thres=GREEDY, **cfg),
                   clock=JFakeClock(step_dt=1.0))


def run_all(eng, reqs, steps=2000):
    for r in reqs:
        assert eng.submit(r) is None
    eng.run(max_steps=steps)
    return {k: None if v.tokens is None else [int(t) for t in v.tokens]
            for k, v in eng.results.items()}


def summary(results):
    return {rid: (r.outcome.value, r.preempt_count,
                  None if r.tokens is None else [int(t) for t in r.tokens])
            for rid, r in results.items()}


def arena_bytes(eng):
    """A copy of every pool's arena rows (content and scales)."""
    start = eng.config.max_batch * eng.n_pages_slot
    return [pool[start:-1].clone() for kv in eng.cache.kv for pool in kv.pools()]


def warm_rounds(cls=Request):
    """A publish round, then a full hit, a cold request and a partial hit
    (the prompt diverging inside the second page) together."""
    pB = diverge_at(_prompt(0), 4)
    return [[req(0, cls=cls)],
            [req(0, rid="r0w", cls=cls), req(1, cls=cls), req(7, rid="rB", p=pB, cls=cls)]]


def counters_of(get):
    return {name: get(f"serve.prefix.{name}") for name in PREFIX_COUNTERS}


def check_against_jax(models, mode, kv_quant, **extra):
    """Greedy outcomes, tokens and prefix counters of the port's engine
    equal JAX's over ``warm_rounds``."""
    jmodel, params, model = models
    cfg = dict(MODES[mode], prefix_cache=True, kv_quant=kv_quant, **extra)
    ours = port_engine(model, filter_thres=GREEDY, **cfg)
    jcounters.reset()
    theirs = jax_engine(jmodel, params, **cfg)
    for port_round, jax_round in zip(warm_rounds(), warm_rounds(JRequest)):
        run_all(ours, port_round)
        run_all(theirs, jax_round)
    assert summary(ours.results) == summary(theirs.results)
    assert counters_of(ours.counters.get) == counters_of(jcounters.get)
    # monolithic prefill takes full hits only
    assert ours.counters.get("serve.prefix.hits") == (2 if MODES[mode] else 1)
    ours.verify_invariants(idle=True)
    return ours


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
@pytest.mark.parametrize("mode", MODES)
def test_warm_tokens_bitwise_cold(models, mode, kv_quant):
    _, _, model = models
    cold = run_all(port_engine(model, kv_quant=kv_quant, **MODES[mode]), [req(0), req(1)])
    eng = port_engine(model, kv_quant=kv_quant, prefix_cache=True, **MODES[mode])
    run_all(eng, [req(0)])
    assert eng.counters.get("serve.prefix.misses") == 1
    warm = run_all(eng, [req(0, rid="r0w"), req(1)])
    assert warm["r0w"] == cold["r0"], "full-hit tokens diverged"
    assert warm["r1"] == cold["r1"], "cold sibling diverged"
    assert eng.counters.get("serve.prefix.hits") == 1 == eng.prefix.stats.hits
    assert eng.cached_draws == 1
    eng.verify_invariants(idle=True)


@pytest.mark.parametrize("mode", MODES)
def test_full_hit_skips_prefill(models, mode, monkeypatch):
    _, _, model = models
    eng = port_engine(model, prefix_cache=True, **MODES[mode])
    run_all(eng, [req(0)])
    d_cold = eng.dispatches

    def poisoned(*a, **k):
        raise AssertionError("a full hit ran a prefill")

    for name in ("prefill_step", "prefill_chunk"):
        monkeypatch.setattr(DALLE, name, poisoned)
    prefill_rows = []
    fused_step = DALLE.fused_step

    def spy(self, tokens, start, length, *a, **k):
        prefill_rows.append(int(((start < self.text_len_internal) & (length > 0)).sum()))
        return fused_step(self, tokens, start, length, *a, **k)

    monkeypatch.setattr(DALLE, "fused_step", spy)
    run_all(eng, [req(0, rid="r0w")])
    d_warm = eng.dispatches - d_cold
    assert eng.results["r0w"].outcome is Outcome.COMPLETED
    assert sum(prefill_rows) == 0
    if MODES[mode]:
        assert d_warm < d_cold, (d_warm, d_cold)
    else:
        assert d_warm <= d_cold, (d_warm, d_cold)
    assert eng.counters.get("serve.prefix.hits") == 1


def test_index_survives_drain_and_accounts_pages(models):
    _, _, model = models
    eng = port_engine(model, prefix_cache=True)
    run_all(eng, [req(0)])
    eng.verify_invariants(idle=True)
    assert len(eng.prefix) == 2  # T 7 over pages of 4: two chain pages
    assert eng.pool.held(PREFIX_HOLDER) == 2 == eng.pool.used
    run_all(eng, [req(0, rid="r0w")])
    assert eng.counters.get("serve.prefix.hits") == 1
    eng.verify_invariants(idle=True)


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
@pytest.mark.parametrize("mode", ["split_mono", "fused"])
def test_matches_jax_engine(models, mode, kv_quant):
    check_against_jax(models, mode, kv_quant)
