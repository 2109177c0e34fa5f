"""Serving and generation of a reversible DALLE against the JAX package
on the CPU, float32, on the tiny converted DALLE of test_torch_dalle.py
(every leaf perturbed) with ``reversible=True``, rotary and token shift
(test_torch_dalle.py's defaults) and with learned positions: the decode
form runs the direct reversible wiring (``x1 += attn(x2)``,
``x2 += ff(x1)``, ``(x1 + x2) / 2``) over the caches and rings that the
sequential model keeps, in every model call the engines and generation
make.

- greedy tokens and outcomes of the port's split engine (monolithic
  prefill, and chunks of 2) and of its fused iteration (chunk 2)
  identical to JAX's engine in the same configuration, three requests of
  test_torch_engine.py, max_batch 2;
- (test_torch_reversible_generate.py) greedy tokens of
  ``generate_image_tokens`` on "4d", "flat" and "paged" identical to
  JAX's.
"""

import pytest
import torch

from dalle_pytorch_tpu_torch.serving.types import Outcome
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import BUDGETS
from test_torch_learned_pos_serve import PATHS
from test_torch_preemption import _requests
from test_torch_split_engine import both

torch.set_num_threads(1)

CASES = {"rotary": dict(reversible=True),
         "learned_pos": dict(reversible=True, rotary_emb=False)}


@pytest.fixture(scope="module", params=list(CASES))
def models(request):
    jmodel, params, model = tiny_models(**CASES[request.param])
    assert model.reversible and model.transformer.reversible
    return jmodel, params, model


@pytest.fixture(autouse=True)
def jax_pages(monkeypatch):
    monkeypatch.setenv("DALLE_TPU_KV_PAGE_SIZE", str(PAGE))
    monkeypatch.delenv("DALLE_TPU_KV_FORMAT", raising=False)
    monkeypatch.delenv("DALLE_TPU_FLAT_KV", raising=False)


@pytest.mark.parametrize("path", list(PATHS))
def test_engine_greedy_tokens_identical_to_jax(models, path):
    got, ref, eng = both(*models, _requests(BUDGETS), **PATHS[path])
    assert got == ref
    for rid, n, _ in _requests(BUDGETS):
        outcome, _, _, tokens = got[rid]
        assert outcome == Outcome.COMPLETED.value and len(tokens) == n
    assert eng.pool.used == 0 and not any(eng.slots)
