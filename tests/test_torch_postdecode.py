"""The port's engine with post-decode stages (VAE decode, then CLIP
rerank) against the JAX package's staged engine on the CPU: the canonical
tiny DALLE, VAE and CLIP of tools/serve_smoke.py, converted, served greedy
(top-k keeps one logit, so sampling no longer depends on either
framework's random bits) by the fused engine
(``EngineConfig(fused_iteration=True, prefill_chunk=2, max_batch=2)``)
with ``stages`` (the split path's: test_torch_split_engine.py). Tokens
are identical; images and rerank scores agree to atol 1e-5; every
outcome is COMPLETED.

Port-only, mirroring tests/test_postdecode.py where the port has the
feature: rerank off completes unscored, backlog and watermark degrade at
entry, a timeout on every dispatch exhausts the retries, cancel and
deadline reach staged requests, the stage budget bounds a dispatch, and
rerank dispatches before VAE."""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.serving import Engine as JEngine
from dalle_pytorch_tpu.serving import EngineConfig as JEngineConfig
from dalle_pytorch_tpu.serving import FakeClock as JFakeClock
from dalle_pytorch_tpu.serving import Outcome as JOutcome
from dalle_pytorch_tpu.serving import Request as JRequest
from dalle_pytorch_tpu_torch.convert import clip_state_dict, dalle_state_dict, vae_state_dict
from dalle_pytorch_tpu_torch.models.clip import CLIP
from dalle_pytorch_tpu_torch.models.dalle import DALLE
from dalle_pytorch_tpu_torch.models.vae import DiscreteVAE
from dalle_pytorch_tpu_torch.serving.engine import Engine, EngineConfig
from dalle_pytorch_tpu_torch.serving.postdecode import (
    STAGE_RERANK,
    STAGE_VAE,
    PostDecodePipeline,
    RetryPolicy,
    StageConfig,
    StageSpec,
)
from dalle_pytorch_tpu_torch.serving.scheduler import Entry
from dalle_pytorch_tpu_torch.serving.types import FakeClock, Outcome, Request
from dalle_pytorch_tpu_torch.testing import reset_registries

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

from lint.trace.registry import CANON_CLIP, CANON_MODEL, CANON_VAE  # noqa: E402
from serve_smoke import build_tiny_model, build_tiny_stages  # noqa: E402

torch.set_num_threads(1)

GREEDY = 0.99  # k = max(int(0.01 * 32 total tokens), 1) = 1
BUDGETS = (4, 4, 4)


@pytest.fixture(scope="module")
def models():
    return staged_models()


@pytest.fixture(autouse=True)
def _port_registries():
    """Each test's engine counts from zero in the port's registries."""
    reset_registries()
    yield
    reset_registries()


def staged_models():
    """(JAX dalle, params, JAX StageSpec, port DALLE, port VAE, port CLIP)."""
    jdalle, params = build_tiny_model()
    jstages = build_tiny_stages()
    dalle = DALLE(**CANON_MODEL, device="cpu")
    dalle.load_state_dict(dalle_state_dict(jax.device_get(params)))
    vae = DiscreteVAE(**CANON_VAE, device="cpu")
    # the stage's VAE tree is initialised for decoding only: no encoder
    missing, unexpected = vae.load_state_dict(
        vae_state_dict(jax.device_get(jstages.vae_params)), strict=False)
    assert not unexpected and missing and all(k.startswith("enc_") for k in missing)
    clip = CLIP(**CANON_CLIP, device="cpu")
    clip.load_state_dict(clip_state_dict(jax.device_get(jstages.clip_params)))
    return jdalle, params, jstages, dalle, vae, clip


def prompt(i):
    p = np.random.RandomState(100 + i).randint(1, 16, size=(4,)).astype(np.int32)
    p[4 - i % 3:] = 0  # zero tails: the rerank's key mask matters
    return p


def port_engine(models, config=None, **cfg):
    _, _, _, dalle, vae, clip = models
    spec = StageSpec(vae, clip, **({} if config is None else {"config": config}))
    cfg.setdefault("max_batch", 2)
    cfg.setdefault("fused_iteration", True)
    cfg.setdefault("prefill_chunk", 2)
    return Engine(dalle, EngineConfig(**cfg), clock=FakeClock(step_dt=0.05),
                  device="cpu", stages=spec)


def test_staged_engine_matches_jax(models):
    jdalle, params, jstages, *_ = models
    jeng = JEngine(jdalle, params, JEngineConfig(
        max_batch=2, fused_iteration=True, prefill_chunk=2, filter_thres=GREEDY,
    ), clock=JFakeClock(step_dt=0.05), stages=jstages)
    eng = port_engine(models, filter_thres=GREEDY)
    for i, n in enumerate(BUDGETS):
        assert jeng.submit(JRequest(f"r{i}", prompt(i), n, seed=i)) is None
        assert eng.submit(Request(f"r{i}", prompt(i), n, seed=i)) is None
    ref, got = jeng.run(max_steps=500), eng.run(max_steps=500)
    for i, n in enumerate(BUDGETS):
        r, g = ref[f"r{i}"], got[f"r{i}"]
        assert r.outcome is JOutcome.COMPLETED and g.outcome is Outcome.COMPLETED
        np.testing.assert_array_equal(g.tokens, r.tokens)
        assert g.image.shape == r.image.shape == (4, 4, 3)
        np.testing.assert_allclose(g.image, r.image, atol=1e-5, rtol=0)
        assert abs(g.rerank_score - r.rerank_score) <= 1e-5
    pipe = eng.postdecode
    assert eng.counters.get("serve.stage.vae_images") == 3
    assert eng.counters.get("serve.stage.reranked") == 3
    assert not pipe and not any(eng.slots) and eng.pool.used == 0


def test_rerank_off_completes_unscored(models):
    eng = port_engine(models, config=StageConfig(rerank=False))
    eng.submit(Request("r0", prompt(0), 4))
    res = eng.run(max_steps=200)["r0"]
    assert res.outcome is Outcome.COMPLETED
    assert res.image is not None and res.rerank_score is None
    assert eng.counters.get("serve.stage.reranked") == 0


def test_timeout_exhausts_retries_to_tokens_only(models):
    eng = port_engine(models, config=StageConfig(timeout_s=0.0))
    eng.submit(Request("r0", prompt(0), 4))
    res = eng.run(max_steps=500)["r0"]
    assert res.outcome is Outcome.COMPLETED_TOKENS_ONLY
    assert res.tokens is not None and len(res.tokens) == 4 and res.image is None
    assert res.detail == "stage_timeout"
    c = eng.counters
    assert c.get("serve.stage.timeouts") == 3 and c.get("serve.stage.retries") == 2
    assert c.get("serve.stage.degraded") == 1


# ------------------------------------------- pipeline-direct (no engine)


def make_pipeline(models, config=StageConfig(), occupancy=None):
    *_, vae, clip = models
    done = []
    pipe = PostDecodePipeline(
        StageSpec(vae, clip, config=config), FakeClock(step_dt=0.05),
        lambda entry, outcome, tokens, image=None, rerank_score=None, detail="":
        done.append((entry.request_id, outcome, image, rerank_score, detail)),
        occupancy=occupancy,
    )
    return pipe, done


def entry(i, **kw):
    return Entry(request=Request(f"r{i}", prompt(i), 4, **kw), submit_time=0.0, seq=i)


def toks(i):
    return np.full((4,), i % 12, np.int32)


def test_backlog_degrades_at_entry(models):
    pipe, done = make_pipeline(models, StageConfig(queue_limit=1))
    pipe.enqueue(entry(0), toks(0))
    pipe.enqueue(entry(1), toks(1))
    assert len(pipe) == 1
    assert done == [("r1", Outcome.COMPLETED_TOKENS_ONLY, None, None, "stage_backlog")]
    assert pipe.counters.get("serve.stage.degraded") == 1


def test_watermark_degrades_at_entry(models):
    occupancy = [0.9]
    pipe, done = make_pipeline(models, StageConfig(high_watermark=0.5),
                               occupancy=lambda: occupancy[0])
    pipe.enqueue(entry(0), toks(0))
    pipe.enqueue(entry(1), toks(1))
    assert [d[1] for d in done] == [Outcome.COMPLETED_TOKENS_ONLY] * 2
    assert all(d[2] is None and d[4] == "stage_watermark" for d in done)
    assert not pipe
    occupancy[0] = 0.4  # back under the watermark: staged again
    pipe.enqueue(entry(2), toks(2))
    assert len(pipe) == 1 and len(done) == 2
    assert pipe.counters.get("serve.stage.degraded") == 2


def at_rerank(pipe, i, **kw):
    """Stage request ``i`` and run its VAE dispatch, so that it waits at
    CLIP_RERANK with an image."""
    pipe.enqueue(entry(i, **kw), toks(i))
    assert pipe.step()
    assert pipe.counters.get("serve.stage.vae_images") >= 1


def test_cancel_and_deadline_mid_stage(models):
    pipe, done = make_pipeline(models)
    at_rerank(pipe, 1, deadline=1e-9)
    pipe.enqueue(entry(0), toks(0))
    assert pipe.sweep({"r0"}, now=1.0) == ["r0"]
    assert not pipe
    by_rid = {d[0]: d for d in done}
    assert by_rid["r0"][1] is Outcome.CANCELLED and by_rid["r0"][2] is None
    assert by_rid["r0"][4] == f"cancelled in {STAGE_VAE}"
    assert by_rid["r1"][1] is Outcome.DEADLINE_EXCEEDED
    assert by_rid["r1"][2] is not None
    assert by_rid["r1"][4] == f"deadline in {STAGE_RERANK}"


def test_stage_budget_bounds_dispatch(models):
    pipe, done = make_pipeline(models, StageConfig(
        budget=1, retry=RetryPolicy(attempts=1, base_delay=0.0, max_delay=0.0)))
    for i in range(3):
        pipe.enqueue(entry(i), toks(i))
    assert pipe.step()
    assert pipe.counters.get("serve.stage.vae_images") == 1
    assert len(pipe) == 3 and not done  # r0 moved on to rerank


def test_rerank_dispatches_before_vae(models):
    pipe, done = make_pipeline(models, StageConfig(budget=1))
    at_rerank(pipe, 1)
    pipe.enqueue(entry(0), toks(0))  # r0 (earlier seq) waits at VAE
    assert pipe.step()
    assert [d[0] for d in done] == ["r1"]
    assert done[0][1] is Outcome.COMPLETED and done[0][3] is not None
    assert pipe.counters.get("serve.stage.vae_images") == 1 and len(pipe) == 1
