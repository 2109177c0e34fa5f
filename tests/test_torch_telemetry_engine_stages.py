"""The port's engine telemetry and metrics against the JAX package's
(the helpers of test_torch_telemetry_engine.py: records, histograms,
counters, gauges and ``dump()`` equal under ``FakeClock``, greedy), on
the post-decode stages (the canonical tiny DALLE, VAE and CLIP of
test_torch_postdecode.py, split and fused: one ``serve.stage.*`` span a
batched dispatch, ``serve.stage.request_to_image_s`` a completion) and
on an overload of the tiny DALLE of test_torch_dalle.py mixing a small
pool, a short queue, deadlines, priorities and the ``page_exhaust``,
``prefill_fail`` and ``decode_stall`` faults (split monolithic, split
chunked, fused)."""

import pytest
import torch

from dalle_pytorch_tpu_torch.serving.postdecode import StageSpec
from dalle_pytorch_tpu_torch.utils import metrics as pm
from test_torch_postdecode import staged_models
from test_torch_telemetry_engine import (CONFIGS, OVERLOAD, OVERLOAD_FAULTS,  # noqa: F401
                                         _registries, check_against_jax, models)

torch.set_num_threads(1)


@pytest.mark.parametrize("config", ["split", "split_chunked", "fused"])
def test_overload_records_equal_jax(models, config):
    recs = check_against_jax(models, {**OVERLOAD, **CONFIGS[config]}, "overload", OVERLOAD_FAULTS)
    outcomes = {r["outcome"] for r in recs if r.get("name") == "serve.request" and r["ph"] == "E"}
    assert len(outcomes) >= 2, outcomes  # the overload ends requests more than one way
    names = {r.get("name") for r in recs}
    assert {"serve.evict", "serve.prefill_retry", "serve.decode_stall"} <= names


@pytest.mark.parametrize("config", ["split", "fused"])
def test_staged_records_equal_jax(config):
    jdalle, params, jstages, dalle, vae, clip = staged_models()
    recs = check_against_jax((jdalle, params, dalle), dict(max_batch=2, **CONFIGS[config]),
                             "staged", stages=(jstages, StageSpec(vae, clip)), step_dt=0.05)
    stage_spans = [r for r in recs if r["ph"] == "B" and r["name"].startswith("serve.stage.")]
    assert {r["name"] for r in stage_spans} == {"serve.stage.vae_decode", "serve.stage.clip_rerank"}
    assert sum(r["n"] for r in stage_spans) == 2 * 3
    assert pm.histograms.get("serve.stage.request_to_image_s").count == 3
    assert pm.counters.get("serve.stage.reranked") == pm.counters.get("serve.completed") == 3
