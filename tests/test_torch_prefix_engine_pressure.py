"""The port's prefix cache under pressure and faults (see
test_torch_prefix_engine.py for the model and modes):

- preempting a request that maps shared pages drops references only: its
  replay and its cold sibling stay bitwise, and a later request still
  hits the untouched pages;
- a release may only name a slot row;
- the index is the first eviction tier: admission reclaims unreferenced
  LRU pages before anything is preempted, and a publish into a full
  arena evicts or fails open (counters equal JAX's engine's in both);
- the ``prefix_hash_collide`` drill falls back cold with bitwise tokens,
  the ``prefix_publish_fail`` drill completes the request unpublished
  (fault counters equal JAX's);
- ``verify_invariants`` holds at every step of a warm run (references
  equal live shared mappings) and at the drain; the cache off is inert;
  arena rows round up and the default budget includes them;
  ``can_admit`` counts reclaimable index pages;
- with both features off, the tokens and dispatch counts are the ones
  the engine gave before them (recorded from the previous tree).
"""

import zlib

import pytest
import torch

from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.utils.faults import FAULTS as JFAULTS
from dalle_pytorch_tpu.utils.metrics import counters as jcounters
from dalle_pytorch_tpu_torch.serving.engine import PREFIX_HOLDER
from dalle_pytorch_tpu_torch.serving.types import Outcome
from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_prefix_engine import (MODES, counters_of, diverge_at, jax_engine,  # noqa: F401
                                      jax_pages, models, port_engine, req, run_all, summary)
from test_torch_engine import GREEDY, _prompt

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_registries():
    """Each test's engines count from zero in the port's registries."""
    reset_registries()
    yield
    reset_registries()


@pytest.mark.parametrize("mode", MODES)
def test_preempted_hit_replays_and_sibling_survives(models, mode):
    _, _, model = models
    cold = run_all(port_engine(model, **MODES[mode]), [req(0), req(1)])
    eng = port_engine(model, prefix_cache=True, **MODES[mode])
    run_all(eng, [req(0)])
    eng.faults.arm("page_exhaust", 1)
    warm = run_all(eng, [req(0, rid="r0w"), req(1)])
    assert eng.faults.fired["page_exhaust"] == 1
    assert sum(r.preempt_count for r in eng.results.values()) >= 1
    assert warm["r0w"] == cold["r0"], "replayed hit diverged"
    assert warm["r1"] == cold["r1"], "sibling diverged after the eviction"
    eng.verify_invariants(idle=True)
    later = run_all(eng, [req(0, rid="r0x")])
    assert later["r0x"] == cold["r0"], "arena pages corrupted by the eviction reset"
    eng.verify_invariants(idle=True)


def test_release_asserts_slot_row_bound(models):
    _, _, model = models
    eng = port_engine(model, prefix_cache=True)
    run_all(eng, [req(0)])
    assert eng.submit(req(0, rid="r0w")) is None
    eng.step()
    slot = next(s for s in eng.slots if s is not None)
    slot.index = eng.config.max_batch  # an arena row
    with pytest.raises(AssertionError, match="arena rows"):
        eng._release_slot(slot)


def _both(models, rounds, **cfg):
    """Run ``rounds`` of request indices through the port's engine and
    JAX's (greedy); returns (port engine, JAX engine)."""
    jmodel, params, model = models
    cfg = dict(cfg, prefix_cache=True)
    ours = port_engine(model, filter_thres=GREEDY, **cfg)
    jcounters.reset()
    theirs = jax_engine(jmodel, params, **cfg)
    for rnd in rounds:
        run_all(ours, [req(i, rid=f"q{i}") for i in rnd])
        run_all(theirs, [req(i, rid=f"q{i}", cls=JRequest) for i in rnd])
    assert summary(ours.results) == summary(theirs.results)
    assert counters_of(ours.counters.get) == counters_of(jcounters.get)
    return ours, theirs


def test_admission_reclaims_index_before_preempting(models):
    """One slot, a budget of its worst case (6 pages) plus 3: after two
    published prompts (4 index pages) a third needs 6 of 5 free pages;
    admission evicts an index page and preempts nothing."""
    ours, _ = _both(models, [[0], [1], [2]], page_budget=6 + 3, prefix_cache_pages=6,
                    max_batch=1)
    assert ours.counters.get("serve.prefix.evictions") >= 1
    assert all(r.preempt_count == 0 for r in ours.results.values())
    assert all(r.outcome is Outcome.COMPLETED for r in ours.results.values())
    ours.verify_invariants(idle=True)


def test_publish_fails_open_when_arena_full(models):
    """An arena of one storage row (6 pages) over three prompts of two
    pages each and a fourth: publishes evict or skip, every request
    completes, the accounting holds."""
    ours, _ = _both(models, [[0], [1], [2], [3]], prefix_cache_pages=1)
    total = (ours.counters.get("serve.prefix.evictions")
             + ours.counters.get("serve.prefix.publish_skips"))
    assert total >= 1
    assert all(r.outcome is Outcome.COMPLETED for r in ours.results.values())
    ours.verify_invariants(idle=True)


def test_prefix_hash_collide_falls_back_cold(models):
    jmodel, params, model = models
    cold = run_all(port_engine(model, filter_thres=GREEDY), [req(0)])
    eng = port_engine(model, filter_thres=GREEDY, prefix_cache=True)
    jeng = jax_engine(jmodel, params, prefix_cache=True)
    run_all(eng, [req(0)])
    run_all(jeng, [req(0, cls=JRequest)])
    eng.faults.arm("prefix_hash_collide", 1)
    JFAULTS.arm("prefix_hash_collide", 1)
    warm = run_all(eng, [req(0, rid="r0c")])
    jwarm = run_all(jeng, [req(0, rid="r0c", cls=JRequest)])
    assert eng.faults.fired["prefix_hash_collide"] == 1
    assert eng.counters.get("serve.fault_prefix_hash_collide") == 1 == \
        jcounters.get("serve.fault_prefix_hash_collide")
    assert eng.prefix.stats.collisions == 1
    assert warm["r0c"] == cold["r0"] == jwarm["r0c"], "the fallback served other K/V"
    eng.verify_invariants(idle=True)


def test_prefix_publish_fail_is_fail_open(models):
    _, _, model = models
    eng = port_engine(model, prefix_cache=True)
    eng.faults.arm("prefix_publish_fail", 1)
    toks = run_all(eng, [req(0)])
    assert eng.counters.get("serve.fault_prefix_publish_fail") == 1
    assert eng.counters.get("serve.prefix.publish_skips") == 1
    assert eng.results["r0"].outcome is Outcome.COMPLETED
    assert len(eng.prefix) == 0 and eng.pool.used == 0
    warm = run_all(eng, [req(0, rid="r0b")])
    assert warm["r0b"] == toks["r0"]
    assert len(eng.prefix) == 2
    eng.verify_invariants(idle=True)


@pytest.mark.parametrize("mode", ["split_chunked", "fused"])
def test_midflight_refcount_accounting(models, mode):
    _, _, model = models
    eng = port_engine(model, prefix_cache=True, **MODES[mode])
    run_all(eng, [req(0)])
    assert eng.submit(req(0, rid="rA")) is None
    assert eng.submit(req(7, rid="rB", p=diverge_at(_prompt(0), 4))) is None
    shared_seen = 0
    for _ in range(500):
        eng.verify_invariants()
        shared_seen = max(shared_seen, eng.prefix.total_refs())
        if not eng.step():
            break
    eng.verify_invariants(idle=True)
    assert shared_seen >= 1 and eng.prefix.total_refs() == 0


def test_prefix_cache_off_is_inert(models):
    _, _, model = models
    eng = port_engine(model)
    assert eng.prefix is None and eng._arena_rows == 0
    assert eng.pool.total == 2 * eng.n_pages_slot
    assert all(pool.shape[0] == 2 * eng.n_pages_slot + 1
               for kv in eng.cache.kv for pool in kv.pools())
    run_all(eng, [req(0), req(0, rid="again")])
    # the engine's lifecycle tallies run; nothing of the prefix cache does
    assert eng.counters.get("serve.completed") == 2
    assert not [k for k in (*eng.counters.snapshot(), *eng.gauges.snapshot()) if "prefix" in k]
    eng.verify_invariants(idle=True)


def test_arena_rows_round_up_and_budget_includes_arena(models):
    _, _, model = models
    eng = port_engine(model, prefix_cache=True, prefix_cache_pages=7)
    n_p = eng.n_pages_slot
    assert n_p == 6 and eng._arena_rows == 2  # 7 pages over rows of 6
    assert eng.prefix.arena_total == 12
    assert eng.pool.total == 2 * 6 + 12
    assert min(eng.prefix._free_pages) == 2 * 6
    default = port_engine(model, prefix_cache=True)
    assert default._arena_rows == 2  # four prompts of 2 pages: 8 of rows of 6


def test_can_admit_counts_reclaimable_index_pages(models):
    _, _, model = models
    eng = port_engine(model, prefix_cache=True, page_budget=6 + 2, max_batch=1)
    run_all(eng, [req(0)])
    assert len(eng.prefix) == 2 and eng.pool.free == 6
    eng.pool.alloc("elsewhere", 1)
    assert eng.can_admit(req(1))  # 6 pages: 5 free + 2 reclaimable
    eng.prefix.acquire(eng.prefix.nodes(), 0.0)
    assert not eng.can_admit(req(1))
    eng.prefix.release(eng.prefix.nodes())
    eng.pool.free_all("elsewhere")
    eng.verify_invariants(idle=True)


# the previous tree's tokens (crc32 of the sorted token lists, one value:
# every path draws the same tokens) and dispatches, both features off,
# three requests at top-k 0.5
BEFORE = {"split_mono": (1110242055, 33), "split_chunked": (1110242055, 42),
          "fused": (1110242055, 38), "fused_int8": (1110242055, 38)}


@pytest.mark.parametrize("case", BEFORE)
def test_features_off_unchanged(models, case):
    _, _, model = models
    cfg = dict(MODES[case.replace("_int8", "")], kv_quant="int8" if "int8" in case else None)
    eng = port_engine(model, **cfg)
    toks = run_all(eng, [req(i) for i in range(3)])
    digest = zlib.crc32(repr(sorted(toks.items())).encode())
    assert (digest, eng.dispatches) == BEFORE[case]
    assert eng.cached_draws == 0 and eng.draft_steps == 0
    assert PREFIX_HOLDER not in eng.pool.holders()
