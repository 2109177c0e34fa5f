"""Serving and generation of a DALLE with learned positions
(``rotary_emb=False``) and of a ``stable`` one ("conv_like",
"axial_col") against the JAX package on the CPU, on the tiny converted
DALLE of test_torch_dalle.py (every leaf perturbed), float32:

- greedy tokens and outcomes of the port's split engine (monolithic
  prefill, and chunks of 2: 2-2-3) and of its fused iteration (chunk 2)
  identical to JAX's engine in the same configuration, three requests of
  test_torch_engine.py, max_batch 2 (one queues behind the others);
- greedy tokens of ``generate_image_tokens`` on "4d", "flat" and "paged"
  identical to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu.models import sampling as jsampling
from dalle_pytorch_tpu_torch.models import sampling
from dalle_pytorch_tpu_torch.serving.types import Outcome
from test_torch_dalle import PAGE, tiny_models
from test_torch_engine import BUDGETS
from test_torch_generate import prompts
from test_torch_learned_pos import CASES
from test_torch_preemption import _requests
from test_torch_split_engine import both

torch.set_num_threads(1)

PATHS = {"split_monolithic": dict(prefill_chunk=None),
         "split_chunk2": dict(prefill_chunk=2),
         "fused": dict(fused_iteration=True, prefill_chunk=2)}


@pytest.fixture(scope="module", params=list(CASES))
def models(request):
    return tiny_models(**CASES[request.param])


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


@pytest.mark.parametrize("fmt", ["4d", "flat", "paged"])
def test_generate_image_tokens_identical_to_jax(models, fmt):
    jmodel, params, model = models
    text, _ = prompts(model)
    got = sampling.generate_image_tokens(model, torch.from_numpy(text), 0, filter_thres=1.0,
                                         cache_format=fmt, window_seg=0, page_size=PAGE)
    ref = jsampling.generate_image_tokens(jmodel, params, jnp.asarray(text), jax.random.key(0),
                                          filter_thres=1.0, cache_format=fmt)
    assert got.shape == (2, model.image_seq_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
