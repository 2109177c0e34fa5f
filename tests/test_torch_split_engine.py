"""The port's split serving path (``EngineConfig(fused_iteration=False)``:
batch-1 prefills landed in the batched cache, the vector decode step)
against the JAX package's split engine on the CPU, on the tiny float32
DALLE of test_torch_dalle.py (T = 7, 16 image tokens, page 4), max_batch
2, three requests of test_torch_engine.py (one queues behind the others):

- greedy sampling (top-k keeps one logit, so neither framework's random
  bits matter): tokens and outcomes IDENTICAL to JAX's split engine with
  monolithic prefill and with chunks of 2 (2-2-3, the 1-token tail
  merged) and 3 (3-4), lookahead on and off, unquantized and int8
  pages; and on the tiny four-type sparse model;
- the port's split path against its fused path (chunk 2) under the
  default top-k sampling with the seeded noise: identical tokens
  (the two paths compute the logits with products of other shapes, so
  the logits are not bitwise equal: the last test holds them within
  1e-5);
- page pressure: a preempted request's replay is bitwise equal to the
  unpressured run (seeded sampling), unquantized and int8, monolithic
  and chunked; preempt counts, outcomes and tokens under natural
  exhaustion, the victim order, the preemption cap and the watermark
  clamp equal JAX's split engine;
- the post-decode stages on the split path: the staged engine of
  test_torch_postdecode.py, tokens identical to JAX's staged split
  engine, images and rerank scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Outcome as JOutcome
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu_torch.models.sampling import init_decode_cache, insert_decode_cache
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import BUDGETS, GREEDY, _prompt
from test_torch_postdecode import BUDGETS as STAGED_BUDGETS
from test_torch_postdecode import GREEDY as STAGED_GREEDY
from test_torch_postdecode import port_engine, staged_models
from test_torch_postdecode import prompt as staged_prompt
from test_torch_preemption import TIGHT, _requests, _summary

torch.set_num_threads(1)

CHUNKS = [None, 2, 3]
CHUNK_IDS = ["monolithic", "chunk2", "chunk3"]
QUANTS = [None, "int8"]
TYPES = ("full", "axial_row", "axial_col", "conv_like")


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(autouse=True)
def jax_pages(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))


def _config(kw):
    return {"max_batch": 2, "filter_thres": GREEDY, **kw}


def port_engine_of(model, requests, **kw):
    eng = Engine(model, EngineConfig(page_size=PAGE, **_config(kw)),
                 clock=FakeClock(step_dt=1.0), device="cpu")
    for rid, n, prio in requests:
        i = int(rid[1:])
        assert eng.submit(Request(rid, _prompt(i), n, priority=prio, seed=i)) is None
    return eng


def jax_engine_of(jmodel, params, requests, **kw):
    eng = JEngine(jmodel, params, JEngineConfig(**_config(kw)),
                  clock=JFakeClock(step_dt=1.0))
    for rid, n, prio in requests:
        i = int(rid[1:])
        assert eng.submit(JRequest(rid, _prompt(i), n, priority=prio, seed=i)) is None
    return eng


def both(jmodel, params, model, requests, **kw):
    """(port summary, JAX summary, port engine) of the same requests."""
    eng = port_engine_of(model, requests, **kw)
    got = _summary(eng.run(max_steps=1000))
    ref = _summary(jax_engine_of(jmodel, params, requests, **kw).run(max_steps=1000))
    return got, ref, eng


@pytest.mark.parametrize("kv_quant", QUANTS, ids=["none", "int8"])
@pytest.mark.parametrize("lookahead", [True, False], ids=["lookahead", "sync"])
@pytest.mark.parametrize("chunk", CHUNKS, ids=CHUNK_IDS)
def test_greedy_tokens_identical_to_jax_split_engine(models, chunk, lookahead, kv_quant):
    got, ref, eng = both(*models, _requests(BUDGETS), prefill_chunk=chunk,
                         decode_lookahead=lookahead, kv_quant=kv_quant)
    assert got == ref
    for rid, n, _ in _requests(BUDGETS):
        outcome, _, _, tokens = got[rid]
        assert outcome == Outcome.COMPLETED.value and len(tokens) == n
    assert eng.pool.used == 0 and not any(eng.slots)


def test_sparse_model_greedy_tokens_identical_to_jax_split_engine():
    jmodel, params, model = tiny_models(depth=4, attn_types=TYPES)
    got, ref, _ = both(jmodel, params, model, _requests(BUDGETS), prefill_chunk=2)
    assert got == ref
    assert all(o == Outcome.COMPLETED.value for o, *_ in got.values())


@pytest.mark.parametrize("kv_quant", QUANTS, ids=["none", "int8"])
@pytest.mark.parametrize("chunk", CHUNKS, ids=CHUNK_IDS)
def test_split_tokens_equal_fused_tokens(models, chunk, kv_quant):
    """Default sampling (top-k 4 of 42 with the seeded noise)."""
    model = models[2]
    runs = {}
    for fused in (False, True):
        eng = port_engine_of(model, _requests(BUDGETS), filter_thres=0.9, kv_quant=kv_quant,
                             fused_iteration=fused,
                             prefill_chunk=2 if fused else chunk)
        runs[fused] = _summary(eng.run(max_steps=1000))
    assert runs[False] == runs[True]


def test_split_logits_near_fused_logits(models):
    """Why the tokens above agree without bitwise logits: a prompt's first
    image logits and the next decode step's, through the split path's
    shapes (batch-1 chunk 2-2-3, then a 2-row vector decode step) and
    the fused path's (2 x 2 ragged blocks), within 1e-5.
    test_torch_split_bits.py shows where the two part and why they cannot
    be bitwise equal on torch's CPU GEMM."""
    model = models[2]
    prompts = torch.from_numpy(np.stack([model.remap_text(torch.from_numpy(_prompt(i))[None])[0]
                                         .numpy() for i in range(2)]))
    T = model.text_len_internal
    split, rows = [], []
    for r in range(2):
        c1 = init_decode_cache(model, 1, "paged", page_size=PAGE)
        for s, c in ((0, 2), (2, 2)):
            model.prefill_chunk(prompts[r:r + 1, s:s + c], s, c1, return_logits=False)
        split.append(model.prefill_chunk(prompts[r:r + 1, 4:], 4, c1, image_only=True))
        rows.append(c1)
    cache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    for r, c1 in enumerate(rows):
        insert_decode_cache(cache, c1, r)
    tok = torch.tensor([3, 11], dtype=torch.int32)
    split_dec = model.decode_step(tok, torch.full((2,), T, dtype=torch.int32), cache,
                                  image_only=True)
    fcache = init_decode_cache(model, 2, "paged", page_size=PAGE)
    i32 = lambda v: torch.full((2,), v, dtype=torch.int32)  # noqa: E731
    for s in range(0, T, 2):
        c = min(2, T - s)
        block = torch.nn.functional.pad(prompts[:, s:s + c], (0, 2 - c))
        fused = model.fused_step(block, i32(s), i32(c), torch.full((2,), s + c >= T), fcache)
    fused_dec = model.fused_step(torch.nn.functional.pad(tok[:, None], (0, 1)), i32(T), i32(1),
                                 torch.zeros(2, dtype=torch.bool), fcache)
    torch.testing.assert_close(torch.cat(split), fused, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(split_dec, fused_dec, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_quant", QUANTS, ids=["none", "int8"])
@pytest.mark.parametrize("chunk", CHUNKS[:2], ids=CHUNK_IDS[:2])
def test_preempted_replay_bitwise_equal_unpressured(models, chunk, kv_quant):
    model = models[2]
    runs = {}
    for budget in (None, TIGHT):
        eng = port_engine_of(model, _requests(), page_budget=budget, kv_quant=kv_quant,
                             filter_thres=0.5, prefill_chunk=chunk)
        runs[budget] = eng.run(max_steps=1000)
        assert eng.pool.used == 0 and not any(eng.slots)
    assert sum(r.preempt_count for r in runs[TIGHT].values()) >= 1
    assert all(r.preempt_count == 0 for r in runs[None].values())
    for rid, r in runs[TIGHT].items():
        assert r.outcome is Outcome.COMPLETED
        np.testing.assert_array_equal(r.tokens, runs[None][rid].tokens, err_msg=rid)


@pytest.mark.parametrize("chunk", CHUNKS[:2], ids=CHUNK_IDS[:2])
def test_natural_exhaustion_matches_jax_split_engine(models, chunk):
    got, ref, eng = both(*models, _requests(), page_budget=TIGHT, prefill_chunk=chunk)
    assert got == ref
    assert sum(p for _, p, _, _ in got.values()) >= 1
    assert eng.pool.used == 0


@pytest.mark.parametrize("prio,victim", [((0, 1), "r0"), ((0, 0), "r1")],
                         ids=["low_priority_first", "then_youngest"])
def test_victim_order_matches_jax_split_engine(models, prio, victim):
    """r0 is admitted first, r1 one iteration later; when their growth
    collides, r0 dies if its priority is lower, else r1, the younger."""
    jmodel, params, model = models
    summaries = []
    for build, req_cls in ((lambda r: port_engine_of(model, r, page_budget=TIGHT), Request),
                           (lambda r: jax_engine_of(jmodel, params, r, page_budget=TIGHT),
                            JRequest)):
        reqs = _requests((16, 16), prio)
        eng = build(reqs[:1])
        eng.step()  # r0 holds a slot before r1 arrives
        rid, n, p = reqs[1]
        assert eng.submit(req_cls(rid, _prompt(1), n, priority=p, seed=1)) is None
        summaries.append(_summary(eng.run(max_steps=1000)))
    got, ref = summaries
    assert got == ref
    assert got[victim][1] >= 1
    assert all(p == 0 for rid, (_, p, _, _) in got.items() if rid != victim)


def test_preempt_cap_and_watermark_clamp_match_jax_split_engine(models):
    got, ref, eng = both(*models, _requests(), page_budget=TIGHT, max_preemptions=0)
    assert got == ref
    assert any(o == Outcome.PREEMPT_CAP.value for o, *_ in got.values())
    assert eng.pool.used == 0
    kw = dict(high_watermark=0.0, degraded_max_new_tokens=2, prefill_chunk=2)
    got, ref, _ = both(*models, _requests((4, 4), (0, 0)), **kw)
    assert got == ref
    assert sorted(c for _, _, c, _ in got.values() if c is not None) == [2]


def test_staged_split_engine_matches_jax():
    jdalle, params, jstages, *_ = staged = staged_models()
    jeng = JEngine(jdalle, params, JEngineConfig(max_batch=2, filter_thres=STAGED_GREEDY),
                   clock=JFakeClock(step_dt=0.05), stages=jstages)
    eng = port_engine(staged, filter_thres=STAGED_GREEDY, fused_iteration=False,
                      prefill_chunk=None)
    for i, n in enumerate(STAGED_BUDGETS):
        assert jeng.submit(JRequest(f"r{i}", staged_prompt(i), n, seed=i)) is None
        assert eng.submit(Request(f"r{i}", staged_prompt(i), n, seed=i)) is None
    ref, got = jeng.run(max_steps=500), eng.run(max_steps=500)
    for i in range(len(STAGED_BUDGETS)):
        r, g = ref[f"r{i}"], got[f"r{i}"]
        assert r.outcome is JOutcome.COMPLETED and g.outcome is Outcome.COMPLETED
        np.testing.assert_array_equal(g.tokens, r.tokens)
        np.testing.assert_allclose(g.image, r.image, atol=1e-5, rtol=0)
        assert abs(g.rerank_score - r.rerank_score) <= 1e-5
    assert eng.postdecode.counters["serve.stage.reranked"] == len(STAGED_BUDGETS)
    assert not eng.postdecode and not any(eng.slots) and eng.pool.used == 0
