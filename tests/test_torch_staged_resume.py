"""The post-decode pipeline's stage hooks, staged resume and stage faults
against the JAX package's on the CPU (``tests/test_postdecode.py``'s
boundary, resume and degradation cases), on the canonical tiny DALLE, VAE
and CLIP of tools/serve_smoke.py converted to the port
(``test_torch_postdecode.staged_models``), greedy, on the split path with
chunks of 2 (JAX's ``staged_engine``).

- ``on_stage`` announces the tokens boundary (``{"tokens": [ids]}``) and
  the VAE boundary (``{"image": ndarray}``) in JAX's order: token
  payloads equal, images within 1e-5 (the two frameworks' VAE decodes);
- ``submit_staged`` from the tokens (resuming at VAE decode) and from the
  tokens and the image (resuming at the rerank) is bitwise the
  uninterrupted run, and announces only the boundaries it completes;
- a router with a journal leaves a record of each boundary, and the
  replay of that clean journal re-admits nothing;
- ``vae_decode_fail``, ``rerank_fail`` and ``stage_timeout`` on the
  engine's registry give JAX's outcomes and ``serve.stage.*`` counters.
"""

import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu.serving import Router as JRouter
from dalle_pytorch_tpu.serving import RouterConfig as JRouterConfig
from dalle_pytorch_tpu.serving.journal import RequestJournal as JRequestJournal
from dalle_pytorch_tpu.utils.faults import FAULTS
from dalle_pytorch_tpu.utils.metrics import counters as jcounters
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.journal import (
    RequestJournal,
    image_from_payload,
    replay_unfinished,
)
from dalle_pytorch_tpu_torch.serving.postdecode import (
    STAGE_RERANK,
    STAGE_TOKENS,
    STAGE_VAE,
    PostDecodePipeline,
    StageConfig,
    StageSpec,
)
from dalle_pytorch_tpu_torch.serving.router import Router, RouterConfig
from dalle_pytorch_tpu_torch.serving.scheduler import Entry
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.utils.metrics import counters
from dalle_pytorch_tpu_torch.testing import reset_registries
from test_torch_postdecode import GREEDY, staged_models

torch.set_num_threads(1)

IMAGE_ATOL = 1e-5
STAGE_COUNTERS = ("enqueued", "vae_images", "reranked", "retries", "timeouts", "degraded")


@pytest.fixture(scope="module")
def models():
    return staged_models()


@pytest.fixture(autouse=True)
def _registries():
    reset_registries()
    FAULTS.reset()
    yield
    reset_registries()
    FAULTS.reset()


def req(i, cls=Request, max_new=4, **kw):
    kw.setdefault("seed", i)
    rng = np.random.RandomState(100 + i)
    return cls(request_id=f"r{i}", prompt=rng.randint(1, 16, size=(4,)).astype(np.int32),
               max_new_tokens=max_new, **kw)


def port_engine(models, spec=None, faults=None):
    _, _, _, dalle, vae, clip = models
    return Engine(dalle, EngineConfig(max_batch=2, prefill_chunk=2, filter_thres=GREEDY),
                  clock=FakeClock(step_dt=0.05), device="cpu",
                  stages=spec or StageSpec(vae, clip), faults=faults)


def jax_engine(models):
    jdalle, params, jstages, *_ = models
    return JEngine(jdalle, params, JEngineConfig(max_batch=2, prefill_chunk=2,
                                                 filter_thres=GREEDY),
                   clock=JFakeClock(step_dt=0.05), stages=jstages)


def record_stages(engine):
    seen = []
    engine.postdecode.on_stage = lambda rid, stage, payload: seen.append((rid, stage, payload))
    return seen


def run(engine, reqs):
    for r in reqs:
        assert engine.submit(r) is None
    return engine.run(max_steps=2000)


def stage_counts(registry, labels=None):
    return {k: registry.get(f"serve.stage.{k}", labels=labels) for k in STAGE_COUNTERS}


def test_on_stage_payloads_equal_jax(models):
    eng, jeng = port_engine(models), jax_engine(models)
    seen, jseen = record_stages(eng), record_stages(jeng)
    res = run(eng, [req(i) for i in range(3)])
    jres = run(jeng, [req(i, JRequest) for i in range(3)])
    assert [(rid, stage) for rid, stage, _ in seen] == [(rid, stage) for rid, stage, _ in jseen]
    assert {stage for _, stage, _ in seen} == {STAGE_TOKENS, STAGE_VAE}
    for (rid, stage, p), (_, _, q) in zip(seen, jseen):
        assert sorted(p) == sorted(q)
        if stage == STAGE_TOKENS:
            assert p["tokens"] == q["tokens"] == [int(t) for t in res[rid].tokens]
        else:
            assert p["image"] is res[rid].image
            np.testing.assert_allclose(p["image"], q["image"], atol=IMAGE_ATOL, rtol=0)
    for rid, r in res.items():
        np.testing.assert_array_equal(r.tokens, jres[rid].tokens)


@pytest.mark.parametrize("resume_at", [STAGE_VAE, STAGE_RERANK])
def test_submit_staged_bit_identical(models, resume_at):
    """Resumed at VAE decode (tokens) or at the rerank (tokens and image):
    bitwise the uninterrupted run, without a decode dispatch, announcing
    only the boundaries it newly completes (the image when resumed at
    VAE); JAX's resume of the same request agrees."""
    ref = run(port_engine(models), [req(0)])["r0"]
    image = ref.image if resume_at == STAGE_RERANK else None
    eng = port_engine(models)
    seen = record_stages(eng)
    vae0 = eng.counters.get("serve.stage.vae_images")  # the unlabelled series: ref's too
    assert eng.submit_staged(req(0), ref.tokens, image=image) is None
    assert eng.live_requests()[0].request_id == "r0" and eng.stats()["staged"] == 1
    got = eng.run(max_steps=200)["r0"]
    assert got.outcome is Outcome.COMPLETED and eng.dispatches == 0
    assert [(rid, stage) for rid, stage, _ in seen] == (
        [("r0", STAGE_VAE)] if resume_at == STAGE_VAE else [])
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert np.array_equal(got.image, ref.image) and got.rerank_score == ref.rerank_score
    assert eng.counters.get("serve.stage.vae_images") - vae0 == (resume_at == STAGE_VAE)
    jeng = jax_engine(models)
    assert jeng.submit_staged(req(0, JRequest), ref.tokens,
                              image=None if image is None else np.asarray(image)) is None
    jgot = jeng.run(max_steps=200)["r0"]
    np.testing.assert_allclose(got.image, jgot.image, atol=IMAGE_ATOL, rtol=0)
    assert abs(got.rerank_score - jgot.rerank_score) <= IMAGE_ATOL


def test_journal_records_stages_and_clean_replay_readmits_nothing(models, tmp_path):
    _, _, jstages, dalle, vae, clip = models
    jdalle, params = models[0], models[1]
    paths = {name: str(tmp_path / f"{name}.jsonl") for name in ("port", "jax")}
    router = Router(dalle, RouterConfig(n_replicas=1),
                    EngineConfig(max_batch=2, prefill_chunk=2, filter_thres=GREEDY),
                    clock=FakeClock(step_dt=0.05), journal=RequestJournal(paths["port"]),
                    stages=StageSpec(vae, clip), device="cpu")
    jrouter = JRouter(jdalle, params, JRouterConfig(n_replicas=1),
                      JEngineConfig(max_batch=2, prefill_chunk=2, filter_thres=GREEDY),
                      clock=JFakeClock(step_dt=0.05), journal=JRequestJournal(paths["jax"]),
                      stages=jstages)
    assert router.submit(req(0)) is None and jrouter.submit(req(0, JRequest)) is None
    res, jres = router.run(max_steps=2000)["r0"], jrouter.run(max_steps=2000)["r0"]
    router._journal.close()
    jrouter._journal.close()
    assert res.outcome is Outcome.COMPLETED
    recorded = RequestJournal.stages(paths["port"])["r0"]
    jrecorded = RequestJournal.stages(paths["jax"])["r0"]
    assert sorted(recorded) == sorted(jrecorded) == sorted([STAGE_TOKENS, STAGE_VAE])
    assert recorded[STAGE_TOKENS] == jrecorded[STAGE_TOKENS]
    assert recorded[STAGE_TOKENS]["tokens"] == [int(t) for t in res.tokens]
    assert np.array_equal(image_from_payload(recorded[STAGE_VAE]["image"]), res.image)
    np.testing.assert_allclose(image_from_payload(jrecorded[STAGE_VAE]["image"]), res.image,
                               atol=IMAGE_ATOL, rtol=0)
    assert RequestJournal.outcomes(paths["port"]) == RequestJournal.outcomes(paths["jax"])

    def refuse(*a, **kw):
        raise AssertionError("a finished request was replayed")

    for p in paths.values():
        assert replay_unfinished(p, submit=refuse, submit_staged=refuse) == []
    assert counters.get("serve.stage.journal_records") == 2
    assert counters.get("router.completed") == 1 == jcounters.get("router.completed")


@pytest.mark.parametrize("site,count,outcome", [
    ("vae_decode_fail", 1, Outcome.COMPLETED),
    ("vae_decode_fail", 3, Outcome.COMPLETED_TOKENS_ONLY),
    ("rerank_fail", 3, Outcome.COMPLETED_UNRANKED),
    ("stage_timeout", 6, Outcome.COMPLETED_TOKENS_ONLY),
], ids=["vae_retry", "vae_exhausted", "rerank_exhausted", "timeout_exhausted"])
def test_stage_fault_drills_match_jax(models, site, count, outcome):
    eng = port_engine(models)
    eng.faults.arm(site, count)
    res = run(eng, [req(0)])["r0"]
    FAULTS.arm(site, count)
    jres = run(jax_engine(models), [req(0, JRequest)])["r0"]
    assert res.outcome is outcome and jres.outcome.value == outcome.value
    assert res.detail == jres.detail
    assert stage_counts(counters) == stage_counts(jcounters)
    assert counters.get(f"serve.fault_{site}") == jcounters.get(f"serve.fault_{site}") == (
        count if site != "stage_timeout" else 3)
    assert eng.faults.fired.get(site) == FAULTS.fired.get(site)
    assert (res.image is None) == (jres.image is None)
    assert (res.rerank_score is None) == (jres.rerank_score is None)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    eng.verify_invariants(idle=True)


def test_pipeline_resume_paths_and_previews(models):
    """The pipeline alone: a request resumed past VAE with rerank off
    completes at once; one resumed with its image under the watermark
    degrades UNRANKED keeping it; previews stream the image, then the
    score; a resumed enqueue announces nothing."""
    _, _, _, _, vae, clip = models
    done, seen, previews = [], [], []

    def pipe(config, occupancy=None):
        p = PostDecodePipeline(StageSpec(vae, clip, config=config), FakeClock(step_dt=0.05),
                               lambda entry, outcome, tokens, **kw: done.append(
                                   (entry.request_id, outcome, kw.get("image"))),
                               occupancy=occupancy)
        p.on_stage = lambda rid, stage, payload: seen.append((rid, stage))
        p.stream_preview = lambda rid, stage, value: previews.append((rid, stage))
        return p

    img = np.zeros((4, 4, 3), np.float32)
    toks = np.arange(4, dtype=np.int32)
    pipe(StageConfig(rerank=False)).enqueue(Entry(req(0), 0.0, 0), toks, image=img,
                                            announce=False)
    pipe(StageConfig(high_watermark=0.5), occupancy=lambda: 0.9).enqueue(
        Entry(req(1), 0.0, 1), toks, image=img, announce=False)
    assert [(rid, o) for rid, o, _ in done] == [("r0", Outcome.COMPLETED),
                                               ("r1", Outcome.COMPLETED_UNRANKED)]
    assert done[1][2] is img and seen == [] and previews == []
    p = pipe(StageConfig())
    p.enqueue(Entry(req(2), 0.0, 2), toks)
    while len(done) < 3:
        assert p.step()
    assert seen == [("r2", STAGE_TOKENS), ("r2", STAGE_VAE)]
    assert previews == [("r2", STAGE_VAE), ("r2", STAGE_RERANK)]
    assert not p and done[2][1] is Outcome.COMPLETED
