"""The port's prefix cache, partial hits and copy-on-write (see
test_torch_prefix_engine.py for the model and modes):

- a prompt sharing its first page with a published chain resumes chunked
  prefill at the miss boundary (fused: the page mapped read-only; split:
  copied into the private batch-1 cache), and its tokens are BITWISE the
  cold run's; so are its terminal logits, since the resumed chunks run
  the products of the cold run's row counts (a boundary is resumable
  only where the chunk schedule lands, so the schedule from it is the
  cold one);
- monolithic prefill cannot resume: a partial match is a miss, no
  reference leaks, and the request runs cold, bitwise;
- a full hit copies the partial terminal page into the slot's own page
  before its first decode write (``serve.prefix.cow_copies``), the arena
  pages are bitwise unchanged by the warm runs, and a third request
  still hits them;
- a full hit and a request diverging mid-page, concurrent, both match
  their cold runs;
- the split chunked path's greedy tokens and counters equal JAX's.
"""

import pytest
import torch

from test_torch_prefix_engine import (MODES, QUANTS, arena_bytes, check_against_jax,  # noqa: F401
                                      diverge_at, jax_pages, models, port_engine, req, run_all)
from test_torch_engine import _prompt

torch.set_num_threads(1)

CHUNKED = ["split_chunked", "fused"]


def _terminal_logits(eng, p):
    """The published terminal node's logits of prompt ``p``."""
    toks = eng.dalle.remap_text(torch.as_tensor(p, dtype=torch.int32)[None])[0].numpy()
    return eng.prefix.match(toks)[-1].logits


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
@pytest.mark.parametrize("mode", CHUNKED)
def test_shared_page_resume_bitwise(models, mode, kv_quant):
    _, _, model = models
    pB = diverge_at(_prompt(0), 4)  # internal positions 0..4 shared: page 0
    cold_eng = port_engine(model, kv_quant=kv_quant, prefix_cache=True, **MODES[mode])
    cold = run_all(cold_eng, [req(7, rid="rB", p=pB)])
    eng = port_engine(model, kv_quant=kv_quant, prefix_cache=True, **MODES[mode])
    run_all(eng, [req(0)])
    warm = run_all(eng, [req(7, rid="rB", p=pB)])
    assert warm["rB"] == cold["rB"], "partial-hit tokens diverged"
    assert eng.counters.get("serve.prefix.hits") == 1
    assert eng.counters.get("serve.prefix.pages_hit") == 1
    assert torch.equal(_terminal_logits(eng, pB), _terminal_logits(cold_eng, pB))
    eng.verify_invariants(idle=True)


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
def test_monolithic_partial_falls_back_cold(models, kv_quant):
    _, _, model = models
    pB = diverge_at(_prompt(0), 4)
    cold = run_all(port_engine(model, kv_quant=kv_quant), [req(7, rid="rB", p=pB)])
    eng = port_engine(model, kv_quant=kv_quant, prefix_cache=True)
    run_all(eng, [req(0)])
    warm = run_all(eng, [req(7, rid="rB", p=pB)])
    assert warm["rB"] == cold["rB"]
    assert eng.counters.get("serve.prefix.hits") == 0
    assert eng.counters.get("serve.prefix.misses") == 2
    assert eng.prefix.total_refs() == 0
    eng.verify_invariants(idle=True)


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
@pytest.mark.parametrize("mode", MODES)
def test_partial_terminal_page_is_privatized(models, mode, kv_quant):
    _, _, model = models
    cold = run_all(port_engine(model, kv_quant=kv_quant, **MODES[mode]), [req(0)])
    eng = port_engine(model, kv_quant=kv_quant, prefix_cache=True, **MODES[mode])
    run_all(eng, [req(0)])
    arena = arena_bytes(eng)
    warm1 = run_all(eng, [req(0, rid="w1")])
    assert eng.counters.get("serve.prefix.cow_copies") == 1
    warm2 = run_all(eng, [req(0, rid="w2")])
    assert eng.counters.get("serve.prefix.cow_copies") == 2
    assert warm1["w1"] == cold["r0"] == warm2["w2"]
    assert all(torch.equal(a, b) for a, b in zip(arena, arena_bytes(eng))), (
        "a warm run wrote into the shared pages"
    )
    eng.verify_invariants(idle=True)


@pytest.mark.parametrize("mode", CHUNKED)
def test_concurrent_divergence_mid_page(models, mode):
    _, _, model = models
    pB = diverge_at(_prompt(0), 4)

    def reqs():
        return [req(0, rid="rA"), req(7, rid="rB", p=pB)]

    cold = run_all(port_engine(model, **MODES[mode]), reqs())
    eng = port_engine(model, prefix_cache=True, **MODES[mode])
    run_all(eng, [req(0)])
    warm = run_all(eng, reqs())
    assert warm["rA"] == cold["rA"], "full-hit request diverged"
    assert warm["rB"] == cold["rB"], "diverging request diverged"
    assert eng.counters.get("serve.prefix.hits") == 2
    eng.verify_invariants(idle=True)


@pytest.mark.parametrize("kv_quant", QUANTS.values(), ids=QUANTS.keys())
def test_split_chunked_matches_jax_engine(models, kv_quant):
    check_against_jax(models, "split_chunked", kv_quant)
